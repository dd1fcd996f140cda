// The mapping step's pose tail in two launches, for Hopper (sm_90a):
// - `pose_update`: what pipeline/lio.py's lio_step does between the
//   registration and the keyframe save: the pose where the scan has a map
//   (the registered pose, else the initial guess), transformUpdate (ops/
//   registration.py transform_update, mapOptmization.cpp:1867-1897: roll
//   and pitch slerped toward the IMU attitude where the IMU is available,
//   then roll, pitch and z clamped) and the keyframe gate against the last
//   keyframe (pipeline/keyframes.py should_add_keyframe, :1909-1928);
// - `pose_between`: the incremental odometry, utils/se3.py pose6_between.
//
// It replaces no TPU kernel: the JAX forms are plain jnp, and so is the
// plain version here (the functions named above, which stay the CPU path):
// about 800 torch operations a scan on 6-vectors and 3x3 matrices, each a
// dispatch on the host, a few hundred FLOP in all.
//
// What bounds it: latency.  A launch reads some 30 words and writes 7; the
// work is a chain of dependent scalar operations (two slerps, each behind
// two rotations from rpy, two quaternions and a rotation back; then a
// pose6_between behind three rotations from rpy, a transpose, two rpy, a
// 3x3 product).  So one thread does it all in registers; nothing is split
// across threads.
//
// What it computes, and how faithfully:
// - The plain chain's expressions in its order, float32 throughout, built
//   with --fmad=false (no product is fused into a sum), IEEE division and
//   square root, the C library's sinf, cosf, acosf, asinf and atan2f, as
//   torch's CUDA kernels call them.  The constants are the float32
//   roundings of the Python floats the plain chain passes (matrix_to_quat's
//   1e-8, slerp's 1e-5); the config's scalars come as float32 from the
//   wrapper, 1 - imu_rpy_weight formed in float64 first, as slerp forms it.
// - torch.where computes both sides and keeps one; here only the kept side
//   is computed, which gives the same words: Shepperd's four candidates
//   are picked by the same tests in the same order, the slerp's small-angle
//   weights where sin(theta) < 1e-5, the blend only where the IMU is
//   available.  Sums of 3 or 4 terms run in index order; torch's
//   reductions and its 3x3 products (a BLAS call) may take another order,
//   so the gate's delta and the incremental agree with the plain chain to
//   rounding.  The blend's quaternions are rotations about x, whose y and z
//   are zeros, so its dot and norms are exact sums: the pose itself
//   rounds as the plain chain does wherever sin, cos, acos and atan2 do.
// - torch.clamp hands a NaN back as it is; a comparison with a NaN is
//   false, so a non-finite delta fails both thresholds, as in the plain
//   gate.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float QUAT_EPS = (float)1e-8;      // matrix_to_quat's clamp (se3._EPS)
constexpr float SLERP_SMALL = (float)1e-5;   // slerp's small-angle test

struct Params {
  float weight;              // imu_rpy_weight, slerp's t
  float keep;                // 1 - imu_rpy_weight, formed in float64
  float rotation_tolerance;  // |roll|, |pitch| clamp
  float z_tolerance;         // |z| clamp
  float angle_threshold;     // the gate: |delta rpy| at or above this
  float dist_threshold;      // the gate: |delta t| at or above this
};

// torch.clamp(x, lo, hi): a NaN comes back as it is
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  if (x != x) return x;
  const float up = x < lo ? lo : x;
  return hi < up ? hi : up;
}

// se3.rpy_to_matrix: R = Rz(yaw) Ry(pitch) Rx(roll), row-major
__device__ void rpy_to_matrix(float roll, float pitch, float yaw, float* R) {
  const float cr = cosf(roll), sr = sinf(roll);
  const float cp = cosf(pitch), sp = sinf(pitch);
  const float cy = cosf(yaw), sy = sinf(yaw);
  R[0] = cy * cp;
  R[1] = cy * sp * sr - sy * cr;
  R[2] = cy * sp * cr + sy * sr;
  R[3] = sy * cp;
  R[4] = sy * sp * sr + cy * cr;
  R[5] = sy * sp * cr - cy * sr;
  R[6] = -sp;
  R[7] = cp * sr;
  R[8] = cp * cr;
}

// se3.matrix_to_rpy (tf::Matrix3x3::getRPY)
__device__ void matrix_to_rpy(const float* R, float* rpy) {
  rpy[1] = asinf(clampf(-R[6], -1.0f, 1.0f));
  rpy[0] = atan2f(R[7], R[8]);
  rpy[2] = atan2f(R[3], R[0]);
}

// se3.matrix_to_quat: Shepperd's method, (w, x, y, z), normalized
__device__ void matrix_to_quat(const float* R, float* q) {
  const float m00 = R[0], m01 = R[1], m02 = R[2];
  const float m10 = R[3], m11 = R[4], m12 = R[5];
  const float m20 = R[6], m21 = R[7], m22 = R[8];
  const float tr = m00 + m11 + m22;
  if (tr > 0.0f) {
    const float a = tr + 1.0f;
    const float s = sqrtf(a < QUAT_EPS ? QUAT_EPS : a) * 2.0f;
    q[0] = 0.25f * s;
    q[1] = (m21 - m12) / s;
    q[2] = (m02 - m20) / s;
    q[3] = (m10 - m01) / s;
  } else if (m00 >= m11 && m00 >= m22) {
    const float a = 1.0f + m00 - m11 - m22;
    const float s = sqrtf(a < QUAT_EPS ? QUAT_EPS : a) * 2.0f;
    q[0] = (m21 - m12) / s;
    q[1] = 0.25f * s;
    q[2] = (m01 + m10) / s;
    q[3] = (m02 + m20) / s;
  } else if (m11 >= m22) {
    const float a = 1.0f + m11 - m00 - m22;
    const float s = sqrtf(a < QUAT_EPS ? QUAT_EPS : a) * 2.0f;
    q[0] = (m02 - m20) / s;
    q[1] = (m01 + m10) / s;
    q[2] = 0.25f * s;
    q[3] = (m12 + m21) / s;
  } else {
    const float a = 1.0f + m22 - m00 - m11;
    const float s = sqrtf(a < QUAT_EPS ? QUAT_EPS : a) * 2.0f;
    q[0] = (m10 - m01) / s;
    q[1] = (m02 + m20) / s;
    q[2] = (m12 + m21) / s;
    q[3] = 0.25f * s;
  }
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
}

// se3.slerp(q0, q1, t) into q, normalized
__device__ void slerp(const float* q0, const float* q1_in, const Params& p,
                      float* q) {
  float dot = q0[0] * q1_in[0] + q0[1] * q1_in[1] + q0[2] * q1_in[2] +
              q0[3] * q1_in[3];
  float q1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q1[i] = dot < 0.0f ? -q1_in[i] : q1_in[i];
  dot = clampf(fabsf(dot), -1.0f, 1.0f);
  const float theta = acosf(dot);
  const float sin_theta = sinf(theta);
  float w0, w1;
  if (sin_theta < SLERP_SMALL) {
    w0 = p.keep;
    w1 = p.weight;
  } else {
    w0 = sinf(p.keep * theta) / sin_theta;
    w1 = sinf(p.weight * theta) / sin_theta;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = w0 * q0[i] + w1 * q1[i];
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
}

// transform_update's blend: the roll of the slerp from the rotation about
// x by `angle` toward the one by `target` (of quat_to_matrix's entries,
// matrix_to_rpy's roll reads (2, 1) and (2, 2) alone)
__device__ float blend(float angle, float target, const Params& p) {
  float R[9], q0[4], q1[4], q[4];
  rpy_to_matrix(angle, 0.0f, 0.0f, R);
  matrix_to_quat(R, q0);
  rpy_to_matrix(target, 0.0f, 0.0f, R);
  matrix_to_quat(R, q1);
  slerp(q0, q1, p, q);
  // quat_to_matrix normalizes again
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float w = q[0] / n, x = q[1] / n, y = q[2] / n, z = q[3] / n;
  const float r21 = 2.0f * (y * z + w * x);
  const float r22 = 1.0f - 2.0f * (x * x + y * y);
  return atan2f(r21, r22);
}

// se3.pose6_between(a, b) = pose6_compose(pose6_inverse(a), b): a's
// inverse goes through rpy, as the plain chain's does
__device__ void pose6_between(const float* a, const float* b, float* out) {
  float R[9], Rt[9], inv[3], ti[3];
  rpy_to_matrix(a[0], a[1], a[2], R);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Rt[3 * i + j] = R[3 * j + i];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    ti[i] = -(Rt[3 * i] * a[3] + Rt[3 * i + 1] * a[4] + Rt[3 * i + 2] * a[5]);
  matrix_to_rpy(Rt, inv);
  float Ra[9], Rb[9], Rc[9];
  rpy_to_matrix(inv[0], inv[1], inv[2], Ra);
  rpy_to_matrix(b[0], b[1], b[2], Rb);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Rc[3 * i + j] = Ra[3 * i] * Rb[j] + Ra[3 * i + 1] * Rb[3 + j] +
                      Ra[3 * i + 2] * Rb[6 + j];
  matrix_to_rpy(Rc, out);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[3 + i] = (Ra[3 * i] * b[3] + Ra[3 * i + 1] * b[4] +
                  Ra[3 * i + 2] * b[5]) + ti[i];
}

// out[0:6] = the pose; the first byte of out[6] the keyframe flag, the
// word's other bytes zero
__global__ void __launch_bounds__(1)
pose_update(const float* __restrict__ reg_pose,
            const float* __restrict__ guess,
            const unsigned char* __restrict__ has_map,
            const float* __restrict__ imu_rpy,
            const unsigned char* __restrict__ imu_available,
            const float* __restrict__ poses, const int* __restrict__ count,
            int K, Params p, float* __restrict__ out) {
  const bool mapped = has_map[0] != 0;
  float pose[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) pose[i] = mapped ? reg_pose[i] : guess[i];
  if (imu_available[0] != 0) {
    const float roll = blend(pose[0], imu_rpy[0], p);
    pose[1] = blend(pose[1], imu_rpy[1], p);
    pose[0] = roll;
  }
  pose[0] = clampf(pose[0], -p.rotation_tolerance, p.rotation_tolerance);
  pose[1] = clampf(pose[1], -p.rotation_tolerance, p.rotation_tolerance);
  pose[5] = clampf(pose[5], -p.z_tolerance, p.z_tolerance);

  // the gate against keyframe max(count - 1, 0)
  const int n = count[0];
  int row = n - 1 > 0 ? n - 1 : 0;
  row = row < K - 1 ? row : K - 1;
  float delta[6];
  pose6_between(poses + 6 * row, pose, delta);
  const bool big_angle = fabsf(delta[0]) >= p.angle_threshold ||
                         fabsf(delta[1]) >= p.angle_threshold ||
                         fabsf(delta[2]) >= p.angle_threshold;
  const float dist = sqrtf(delta[3] * delta[3] + delta[4] * delta[4] +
                           delta[5] * delta[5]);
  const bool is_kf = n == 0 || big_angle || dist >= p.dist_threshold;

#pragma unroll
  for (int i = 0; i < 6; ++i) out[i] = pose[i];
  reinterpret_cast<unsigned int*>(out)[6] = is_kf ? 1u : 0u;
}

__global__ void __launch_bounds__(1)
pose_between(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ out) {
  pose6_between(a, b, out);
}

}  // namespace

// The pose tail on `stream`: the registered pose and the initial guess (6
// float32 each), has_map (one byte), the IMU attitude (3 float32) and
// imu_available (one byte), the keyframe store's poses (K, 6) and count
// (int32), the config's six scalars, and `out` of 7 words: the pose, then
// the keyframe flag in the last word's first byte.  Reads nothing on the
// host, allocates nothing and does not synchronise; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a K below 1.
extern "C" int lio_pose_update(const float* reg_pose, const float* guess,
                               const unsigned char* has_map,
                               const float* imu_rpy,
                               const unsigned char* imu_available,
                               const float* poses, const int* count, int K,
                               float weight, float keep,
                               float rotation_tolerance, float z_tolerance,
                               float angle_threshold, float dist_threshold,
                               float* out, void* stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  const Params p{weight,      keep,           rotation_tolerance,
                 z_tolerance, angle_threshold, dist_threshold};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  pose_update<<<1, 1, 0, s>>>(reg_pose, guess, has_map, imu_rpy,
                              imu_available, poses, count, K, p, out);
  return (int)cudaGetLastError();
}

// pose6_between(a, b) on `stream`: 6 float32 each, `out` of 6 words;
// returns as the pose tail.
extern "C" int lio_pose_between(const float* a, const float* b, float* out,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  pose_between<<<1, 1, 0, s>>>(a, b, out);
  return (int)cudaGetLastError();
}
