// Fused correspondence + normal-equation kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lio_slam_tpu/ops/fused_corr.py:_make_kernel
// (launched by fused_ne_from_candidates).  Per scan point at pose6: squared
// distances to the candidates of the 9 buckets around the point (halo "z",
// C slots each), duplicate buckets skipped, 5-NN, covariance plane fit with
// the closed-form trigonometric 3x3 eigensolver, the gates of
// registration.find_correspondences, the Jacobian row [n.(dR/dth_k p), n],
// and the 6x6 normal-equation sums.
//
// Design (simple and right first):
// - One thread per scan point.  It reads each bucket's row (C x 12 B) from
//   the (T, C, 3) table itself; the TPU's planar candidate copy
//   (gather_planar) exists only to fill VMEM lanes and has no counterpart.
// - A bucket already seen at an earlier offset is skipped.  The TPU kernel
//   adds 1e30 to its candidates instead; either way they never reach the
//   5-NN, because the offset-0 bucket alone holds C >= 5 candidates.  An id
//   outside [0, T) is skipped the same way (the plain version does too), so
//   a bad id never reads outside the table.
// - The top 5 live in registers, kept sorted by insertion; a candidate
//   replaces the 5th only if strictly nearer, and rows are visited in
//   order o*C + c, so ties go to the lowest row as with jnp.argmin.
// - acosf form of registration._eigpair_3x3 (the TPU kernel's Newton
//   iteration only works around Mosaic's missing acos).
// - R, t and dR/dth come from pose6 on the device: the wrapper never syncs.
// - Deterministic reduction: warp shuffles, then warps in order in shared
//   memory, give 30 per-block partials; a second kernel sums the blocks in
//   order.  No float atomics: repeated runs are bit-identical.
// - Built without --use_fast_math and with --fmad=false so the arithmetic
//   rounds like the plain PyTorch version's separate ops.
//
// What bounds it: scattered bucket-row reads.  At N = 8192 and R = 216 a
// point reads 9 rows of 288 B, about 2.6 KB, so a call reads about 21 MB,
// mostly from L2.  Making it fast (a warp per point, shared-memory staging
// of buckets, cp.async) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KNN = 5;
constexpr int MAX_O = 9;
constexpr int N_OUT = 30;        // AtA upper triangle (21), Atb (6), 3 sums
constexpr int THREADS = 128;     // must match fused_corr.THREADS
constexpr float BIG_D2 = 3.0e38f;
constexpr float VALID_MAX = 1e10f;
constexpr float TWO_PI_3 = 2.0943951023931953f;

// R = Rz(yaw) Ry(pitch) Rx(roll) and dR/dth as [i][j][k] (row-major 27).
__device__ void pose_tables(const float* pose6, float* R, float* t,
                            float* dR) {
  const float r = pose6[0], p = pose6[1], y = pose6[2];
  const float cr = cosf(r), sr = sinf(r);
  const float cp = cosf(p), sp = sinf(p);
  const float cy = cosf(y), sy = sinf(y);
  R[0] = cy * cp; R[1] = cy * sp * sr - sy * cr; R[2] = cy * sp * cr + sy * sr;
  R[3] = sy * cp; R[4] = sy * sp * sr + cy * cr; R[5] = sy * sp * cr - cy * sr;
  R[6] = -sp;     R[7] = cp * sr;                R[8] = cp * cr;
  t[0] = pose6[3]; t[1] = pose6[4]; t[2] = pose6[5];
  const float d_roll[9] = {0.f, cy * sp * cr + sy * sr, -cy * sp * sr + sy * cr,
                           0.f, sy * sp * cr - cy * sr, -sy * sp * sr - cy * cr,
                           0.f, cp * cr, -cp * sr};
  const float d_pitch[9] = {-cy * sp, cy * cp * sr, cy * cp * cr,
                            -sy * sp, sy * cp * sr, sy * cp * cr,
                            -cp, -sp * sr, -sp * cr};
  const float d_yaw[9] = {-sy * cp, -sy * sp * sr - cy * cr, -sy * sp * cr + cy * sr,
                          cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
                          0.f, 0.f, 0.f};
  for (int ij = 0; ij < 9; ++ij) {
    dR[ij * 3 + 0] = d_roll[ij];
    dR[ij * 3 + 1] = d_pitch[ij];
    dR[ij * 3 + 2] = d_yaw[ij];
  }
}

__device__ __forceinline__ float sq(float v) { return v * v; }

// One point's contribution to the 30 sums (zeros unless it is an inlier).
__device__ void point_terms(const float* __restrict__ table, int T, int C,
                            const int* __restrict__ hh, int O,
                            const float* __restrict__ scan,
                            const unsigned char* __restrict__ mask, int N,
                            int n, const float* R, const float* t,
                            const float* dR, float nn_radius,
                            float plane_dist_thresh, float weight_floor,
                            float* acc) {
  const float px = scan[3 * n + 0], py = scan[3 * n + 1], pz = scan[3 * n + 2];
  const float qx = (R[0] * px + R[1] * py) + R[2] * pz + t[0];
  const float qy = (R[3] * px + R[4] * py) + R[5] * pz + t[1];
  const float qz = (R[6] * px + R[7] * py) + R[8] * pz + t[2];

  int h[MAX_O];
#pragma unroll
  for (int o = 0; o < MAX_O; ++o) h[o] = (o < O) ? hh[o * N + n] : -1;

  float bd[KNN], bx[KNN], by[KNN], bz[KNN];
#pragma unroll
  for (int j = 0; j < KNN; ++j) { bd[j] = BIG_D2; bx[j] = by[j] = bz[j] = 0.f; }

#pragma unroll
  for (int o = 0; o < MAX_O; ++o) {
    if (o >= O) break;
    // an id outside [0, T) reads as an empty bucket, never out of bounds
    bool dup = h[o] < 0 || h[o] >= T;
#pragma unroll
    for (int p = 0; p < MAX_O; ++p)
      if (p < o && h[p] == h[o]) dup = true;
    if (dup) continue;
    const float* row = table + (size_t)h[o] * C * 3;
    for (int c = 0; c < C; ++c) {
      const float x = row[3 * c + 0], y = row[3 * c + 1], z = row[3 * c + 2];
      const float d = (sq(x - qx) + sq(y - qy)) + sq(z - qz);
      if (d < bd[KNN - 1]) {
        bd[KNN - 1] = d; bx[KNN - 1] = x; by[KNN - 1] = y; bz[KNN - 1] = z;
#pragma unroll
        for (int j = KNN - 1; j > 0; --j) {
          if (bd[j] < bd[j - 1]) {
            float tmp;
            tmp = bd[j]; bd[j] = bd[j - 1]; bd[j - 1] = tmp;
            tmp = bx[j]; bx[j] = bx[j - 1]; bx[j - 1] = tmp;
            tmp = by[j]; by[j] = by[j - 1]; by[j - 1] = tmp;
            tmp = bz[j]; bz[j] = bz[j - 1]; bz[j - 1] = tmp;
          }
        }
      }
    }
  }

  const bool all_valid = bd[KNN - 1] < VALID_MAX;
  const bool nn_ok = all_valid && bd[KNN - 1] < nn_radius * nn_radius;

  const float inv_k = 1.0f / KNN;
  float mx = bx[0], my = by[0], mz = bz[0];
#pragma unroll
  for (int j = 1; j < KNN; ++j) { mx = mx + bx[j]; my = my + by[j]; mz = mz + bz[j]; }
  mx = mx * inv_k; my = my * inv_k; mz = mz * inv_k;
  float cxx = sq(bx[0] - mx), cyy = sq(by[0] - my), czz = sq(bz[0] - mz);
  float cxy = (bx[0] - mx) * (by[0] - my);
  float cxz = (bx[0] - mx) * (bz[0] - mz);
  float cyz = (by[0] - my) * (bz[0] - mz);
#pragma unroll
  for (int j = 1; j < KNN; ++j) {
    cxx = cxx + sq(bx[j] - mx);
    cyy = cyy + sq(by[j] - my);
    czz = czz + sq(bz[j] - mz);
    cxy = cxy + (bx[j] - mx) * (by[j] - my);
    cxz = cxz + (bx[j] - mx) * (bz[j] - mz);
    cyz = cyz + (by[j] - my) * (bz[j] - mz);
  }
  cxx *= inv_k; cyy *= inv_k; czz *= inv_k;
  cxy *= inv_k; cxz *= inv_k; cyz *= inv_k;

  // Smith's trigonometric eigensolver (registration._eigpair_3x3)
  const float p1 = (cxy * cxy + cxz * cxz) + cyz * cyz;
  const float q = ((cxx + cyy) + czz) / 3.0f;
  const float b00 = cxx - q, b11 = cyy - q, b22 = czz - q;
  const float p2 = ((b00 * b00 + b11 * b11) + b22 * b22) + 2.0f * p1;
  const float pp = sqrtf(fmaxf(p2, 1e-20f) / 6.0f);
  const float inv_p = 1.0f / pp;
  const float detB = (((b00 * (b11 * b22 - cyz * cyz)
                        - cxy * (cxy * b22 - cyz * cxz))
                       + cxz * (cxy * cyz - b11 * cxz)) * inv_p) * inv_p * inv_p;
  const float r = fminf(fmaxf(detB / 2.0f, -1.0f), 1.0f);
  const float phi = acosf(r) / 3.0f;
  const float lam_max = q + 2.0f * pp * cosf(phi);
  const float lam_min = q + 2.0f * pp * cosf(phi + TWO_PI_3);
  const float lam_mid = (3.0f * q - lam_max) - lam_min;
  const float m00 = cxx - lam_min, m11 = cyy - lam_min, m22 = czz - lam_min;
  const float c01x = cxy * cyz - cxz * m11, c01y = cxz * cxy - m00 * cyz,
              c01z = m00 * m11 - cxy * cxy;
  const float c02x = cxy * m22 - cxz * cyz, c02y = cxz * cxz - m00 * m22,
              c02z = m00 * cyz - cxy * cxz;
  const float c12x = m11 * m22 - cyz * cyz, c12y = cyz * cxz - cxy * m22,
              c12z = cxy * cyz - m11 * cxz;
  const float n01 = (c01x * c01x + c01y * c01y) + c01z * c01z;
  const float n02 = (c02x * c02x + c02y * c02y) + c02z * c02z;
  const float n12 = (c12x * c12x + c12y * c12y) + c12z * c12z;
  const bool use01 = (n01 >= n02) && (n01 >= n12);
  const bool use02 = !use01 && (n02 >= n12);
  float vx = use01 ? c01x : (use02 ? c02x : c12x);
  float vy = use01 ? c01y : (use02 ? c02y : c12y);
  float vz = use01 ? c01z : (use02 ? c02z : c12z);
  const float inv_n = 1.0f / fmaxf(sqrtf((vx * vx + vy * vy) + vz * vz), 1e-12f);
  vx *= inv_n; vy *= inv_n; vz *= inv_n;
  if (p2 < 1e-12f) { vx = 0.f; vy = 0.f; vz = 1.f; }

  const float off = -((vx * mx + vy * my) + vz * mz);
  const bool safe = lam_mid > 1e-3f;
  bool plane_ok = true;
#pragma unroll
  for (int j = 0; j < KNN; ++j) {
    const float dist = fabsf(((vx * bx[j] + vy * by[j]) + vz * bz[j]) + off);
    plane_ok = plane_ok && (dist <= plane_dist_thresh);
  }
  const float pd2 = ((vx * qx + vy * qy) + vz * qz) + off;
  const float rng = sqrtf((px * px + py * py) + pz * pz);
  const float s = 1.0f - 0.9f * fabsf(pd2) / sqrtf(sqrtf(fmaxf(rng, 1e-6f)));
  const bool valid = mask[n] != 0 && nn_ok && plane_ok && safe && all_valid &&
                     s > weight_floor;
  if (!valid) return;

  float J[6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a0 = (dR[0 * 9 + 0 * 3 + k] * px + dR[0 * 9 + 1 * 3 + k] * py)
                     + dR[0 * 9 + 2 * 3 + k] * pz;
    const float a1 = (dR[1 * 9 + 0 * 3 + k] * px + dR[1 * 9 + 1 * 3 + k] * py)
                     + dR[1 * 9 + 2 * 3 + k] * pz;
    const float a2 = (dR[2 * 9 + 0 * 3 + k] * px + dR[2 * 9 + 1 * 3 + k] * py)
                     + dR[2 * 9 + 2 * 3 + k] * pz;
    J[k] = (vx * a0 + vy * a1) + vz * a2;
  }
  J[3] = vx; J[4] = vy; J[5] = vz;
  const float w = s * s;
  int idx = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) acc[idx++] = (J[i] * w) * J[j];
  }
  const float wp = w * pd2;
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] = -(J[i] * wp);
  acc[27] = 1.0f;
  acc[28] = s;
  acc[29] = s * fabsf(pd2);
}

__global__ void __launch_bounds__(THREADS)
fused_corr_points(const float* __restrict__ table, int T, int C,
                  const int* __restrict__ hh, int O,
                  const float* __restrict__ scan,
                  const unsigned char* __restrict__ mask, int N,
                  const float* __restrict__ pose6, float nn_radius,
                  float plane_dist_thresh, float weight_floor,
                  float* __restrict__ partials) {
  __shared__ float sR[9], st[3], sdR[27];
  __shared__ float warp_sums[THREADS / 32][N_OUT];
  if (threadIdx.x == 0) pose_tables(pose6, sR, st, sdR);
  __syncthreads();

  float acc[N_OUT];
#pragma unroll
  for (int i = 0; i < N_OUT; ++i) acc[i] = 0.f;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n < N)
    point_terms(table, T, C, hh, O, scan, mask, N, n, sR, st, sdR, nn_radius,
                plane_dist_thresh, weight_floor, acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N_OUT; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < N_OUT) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) v += warp_sums[w][threadIdx.x];
    partials[blockIdx.x * N_OUT + threadIdx.x] = v;
  }
}

__global__ void fused_corr_finalize(const float* __restrict__ partials,
                                    int blocks, float* __restrict__ out) {
  const int i = threadIdx.x;
  if (i >= N_OUT) return;
  float v = 0.f;
  for (int b = 0; b < blocks; ++b) v += partials[b * N_OUT + i];
  out[i] = v;
}

}  // namespace

// Launches both kernels on `stream`; returns the first cudaError_t (0 = ok).
extern "C" int lio_fused_corr(const float* table, int T, int C, const int* hh,
                              int O, const float* scan,
                              const unsigned char* mask, int N,
                              const float* pose6, float nn_radius,
                              float plane_dist_thresh, float weight_floor,
                              float* partials, int blocks, float* out,
                              void* stream) {
  if (O < 1 || O > MAX_O || T < 1 || C < 1 || N < 1 ||
      blocks != (N + THREADS - 1) / THREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_corr_points<<<blocks, THREADS, 0, s>>>(table, T, C, hh, O, scan, mask, N,
                                               pose6, nn_radius,
                                               plane_dist_thresh, weight_floor,
                                               partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_corr_finalize<<<1, 32, 0, s>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}
