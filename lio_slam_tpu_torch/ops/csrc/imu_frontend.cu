// The IMU front end's three functions, one launch each, for Hopper (sm_90a):
// the correction (pipeline/imu_frontend.py, make_frontend's `correct`), the
// rate prediction (`predict_rate`) and TransformFusion (`transform_fusion`).
//
// It replaces no TPU kernel: the JAX front end is plain jnp
// (lio_slam_tpu/pipeline/imu_frontend.py, lio_slam_tpu/ops/
// preintegration.py), and so is the plain version here
// (make_frontend_plain): several hundred torch operations a call on 3x3,
// 9x9 and 15x15 matrices of a few hundred bytes, each a dispatch on the
// host.
//
// What bounds it: latency.  A call reads at most some tens of kilobytes (a
// 512-slot window) and does some hundred thousand FLOP, so the bound is the
// dependent chain: the scans over the window's valid samples (the
// cumulative rotation; in the correction the 9x9 covariance and the bias
// Jacobians, two 9-term dots a sample) and the correction's float64 15x15
// algebra (five 15x15 products, a 6x6 solve with 15 right-hand sides), at
// 1.98 GHz.  So each launch is one block:
// - a chunk of 256 slots at a time, a thread a slot, gates its sample,
//   computes what depends on that sample alone (Exp and the right Jacobian
//   of w dt) and compacts the valid samples into shared memory in slot
//   order (a ballot a warp); a window of any width runs, chunk by chunk;
// - the scans then walk the chunk's valid samples only: a masked slot is an
//   exact identity of the plain version (dt = 0 gives dRk = I, A = I, Q = 0,
//   a zero increment), so skipping it changes nothing, also where the mask
//   is not a prefix.  The correction's step is two barriers, each entry a
//   thread of its own: the sample's transition A, noise Q and bias input C
//   beside the last sample's (A P) A^T + Q; then A P and A J + C.  The
//   prediction's rotation chain is one thread's 3x3 products in registers;
// - the correction's 15x15 algebra is a block's: an entry of a product a
//   thread; the 6x6 solve eliminates a column a step, an entry of
//   [S | H P] a thread, and back-substitutes a right-hand side a thread.
//
// What it computes, and how faithfully:
// - The plain version's expressions, term for term, in its dtypes: the
//   preintegration and the state in float32, the 15x15 covariance algebra
//   in float64 (its first update after initialization cancels about 8
//   digits), no TF32, built with --fmad=false.  Every noise term, the bias
//   Jacobians, both symmetrizations, the Joseph form, the failure reset and
//   the anchor of an uninitialized state are kept; the selects are branches
//   on device values, and nothing is read back.
// - The order of the sums differs from the plain version's, so the results
//   agree to rounding, not bit for bit.  The plain version integrates in log
//   depth (preintegrate_parallel): cumulative rotations by the pairing of
//   jax.lax.associative_scan, the covariance as S_0 P_0 S_0^T +
//   sum_j S_j Q_j S_j^T over suffix products S_j, the bias Jacobians as
//   sum_j S_j C_j.  Here the same quantities come from one pass over the
//   samples in slot order, as the sequential form (preintegrate) takes them:
//   D <- D dRk, P <- A P A^T + Q, J <- A J + C.  dv, dp, the velocities and
//   positions of the pose train are running sums in slot order, as torch's
//   cumsum; a dot of 3, 9 or 15 terms sums in index order.  The 6x6 solve
//   is Gaussian elimination with partial pivoting, the method of
//   torch.linalg.solve's LU, in its own order.  sin, cos, acos, asin, atan2
//   and sqrt are the card's, torch's CPU versions may differ by an ulp.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;            // a block: eight warps; a chunk of slots
constexpr int WARPS = THREADS / 32;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float SMALL_ANGLE2 = (float)1e-8;      // utils/se3.py _EPS
// the prior variances of an anchored state (imu_frontend._init_cov): the
// float32 roundings of the Python doubles 1e-2 ** 2, 1e4 ** 2, 1e-3 ** 2
constexpr float VAR_ROT = (float)(1e-2 * 1e-2);
constexpr float VAR_VEL = (float)(1e4 * 1e4);
constexpr float VAR_BIAS = (float)(1e-3 * 1e-3);
constexpr float VEL_LIMIT = 30.0f;      // preintegration.failure_detected
constexpr float BIAS_LIMIT = 1.0f;
// the correction's output words: R (9), p, v, bias_gyr, bias_acc (3 each),
// the covariance (225), then a word whose first two bytes are the
// `initialized` and `failure` flags
constexpr int COV_AT = 21;
constexpr int FLAGS_AT = COV_AT + 225;

struct Params {
  float gravity;        // world gravity is (0, 0, -gravity)
  float pileup_dt;      // a sample closer than this integrates as the placeholder
  float fallback_dt;    // a non-positive dt becomes this
  float acc_noise;
  float gyr_noise;
  float init_cov;       // the preintegrated covariance starts as init_cov I
  double acc_bias_var;  // acc_bias_noise ** 2, as the 15x15 algebra takes it
  double gyr_bias_var;
};

struct State {          // the front end's state, a leaf a pointer
  const float* R;       // (3, 3)
  const float* p;
  const float* v;
  const float* bias_gyr;
  const float* bias_acc;
  const float* cov;     // (15, 15)
  const unsigned char* initialized;
};

struct Window {         // the IMU window: W slots
  const float* acc;     // (W, 3)
  const float* gyr;     // (W, 3)
  const float* dt;      // (W,)
  const unsigned char* mask;
  int W;
};

// ---------------------------------------------------------------------------
// utils/se3.py on float32, row-major 3x3
// ---------------------------------------------------------------------------

__device__ __forceinline__ float eye(int e) { return e % 4 == 0 ? 1.0f : 0.0f; }

__device__ void skew(const float* w, float* S) {
  S[0] = 0.0f;  S[1] = -w[2]; S[2] = w[1];
  S[3] = w[2];  S[4] = 0.0f;  S[5] = -w[0];
  S[6] = -w[1]; S[7] = w[0];  S[8] = 0.0f;
}

__device__ void mm3(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                     A[3 * i + 2] * B[6 + j];
}

__device__ void mv3(const float* A, const float* x, float* y) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y[i] = A[3 * i] * x[0] + A[3 * i + 1] * x[1] + A[3 * i + 2] * x[2];
}

// so3_exp(w) into R and, where J is given, so3_right_jacobian(w) =
// so3_left_jacobian(-w) into J: skew(-w) = -W and skew(-w)^2 = W^2 exactly
__device__ void so3_exp_jr(const float* w, float* R, float* J) {
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = theta2 < SMALL_ANGLE2;
  const float safe = small ? 1.0f : theta2;
  const float theta = sqrtf(safe);
  float a, b, c;
  if (small) {
    a = 1.0f - theta2 / 6.0f;
    b = 0.5f - theta2 / 24.0f;
    c = (float)(1.0 / 6.0) - theta2 / 120.0f;
  } else {
    const float s = sinf(theta);
    a = s / theta;
    b = (1.0f - cosf(theta)) / safe;
    c = (theta - s) / (safe * theta);
  }
  float W[9], W2[9];
  skew(w, W);
  mm3(W, W, W2);
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = eye(e) + a * W[e] + b * W2[e];
  if (J) {
#pragma unroll
    for (int e = 0; e < 9; ++e) J[e] = eye(e) + b * -W[e] + c * W2[e];
  }
}

// torch.clamp(x, lo, hi): a NaN comes back as it is
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// so3_log(R): the near-zero series, the generic form and the near-pi
// diagonal form, selected as torch.where selects them
__device__ void so3_log(const float* R, float* w) {
  const float trace = R[0] + R[4] + R[8];
  const float cos_t = clampf((trace - 1.0f) / 2.0f, -1.0f, 1.0f);
  const bool near_zero = cos_t > (float)(1.0 - 1e-6);
  const bool near_pi_c = cos_t < (float)(-1.0 + 1e-6);
  const float theta = near_zero ? 0.0f : (near_pi_c ? PI_F : acosf(cos_t));
  const float v[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  if (PI_F - theta < 1e-3f) {
    const float den = clamp_min(1.0f - cos_t, SMALL_ANGLE2);
    const float off[3] = {R[3] + R[1], R[7] + R[5], R[2] + R[6]};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float axis2 = clamp_min((R[4 * i] - cos_t) / den, 0.0f);
      const float axis = sqrtf(clamp_min(axis2, SMALL_ANGLE2));
      const float pick = fabsf(v[i]) > 1e-6f ? v[i] : off[i];
      const float sg = pick > 0.0f ? 1.0f : (pick < 0.0f ? -1.0f : 1.0f);
      w[i] = theta * axis * sg;
    }
    return;
  }
  const float scale =
      near_zero ? 0.5f + (v[0] * v[0] + v[1] * v[1] + v[2] * v[2]) / 4.0f / 12.0f
                : theta / (2.0f * sinf(theta));
#pragma unroll
  for (int i = 0; i < 3; ++i) w[i] = scale * v[i];
}

// rpy_to_matrix: R = Rz(yaw) Ry(pitch) Rx(roll)
__device__ void rpy_to_matrix(const float* rpy, float* R) {
  const float cr = cosf(rpy[0]), sr = sinf(rpy[0]);
  const float cp = cosf(rpy[1]), sp = sinf(rpy[1]);
  const float cy = cosf(rpy[2]), sy = sinf(rpy[2]);
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

// matrix_to_rpy (tf::Matrix3x3::getRPY)
__device__ void matrix_to_rpy(const float* R, float* rpy) {
  rpy[0] = atan2f(R[7], R[8]);
  rpy[1] = asinf(clampf(-R[6], -1.0f, 1.0f));
  rpy[2] = atan2f(R[3], R[0]);
}

// pose6_compose(a, b): x -> Ra (Rb x + tb) + ta, back to [rpy, t]
__device__ void pose6_compose(const float* a, const float* b, float* out) {
  float Ra[9], Rb[9], R[9], t[3];
  rpy_to_matrix(a, Ra);
  rpy_to_matrix(b, Rb);
  mm3(Ra, Rb, R);
  mv3(Ra, b + 3, t);
  matrix_to_rpy(R, out);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[3 + i] = t[i] + a[3 + i];
}

// pose6_inverse(a): (R^T, -(R^T t)), back to [rpy, t]
__device__ void pose6_inverse(const float* a, float* out) {
  float R[9], Rt[9], t[3];
  rpy_to_matrix(a, R);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Rt[3 * i + j] = R[3 * j + i];
  mv3(Rt, a + 3, t);
  matrix_to_rpy(Rt, out);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[3 + i] = -t[i];
}

// ---------------------------------------------------------------------------
// the window, a chunk of THREADS slots at a time
// ---------------------------------------------------------------------------

// preintegration.apply_pileup_gate at slot k: the acc, gyr and dt the sample
// integrates with; returns the slot's mask
__device__ bool gated(const Window& win, const Params& q, int k, float* a,
                      float* w, float* d) {
  const float dt = win.dt[k];
  const bool piled = dt < q.pileup_dt;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a[i] = piled ? (i == 2 ? q.gravity : 0.0f) : win.acc[3 * k + i];
    w[i] = piled ? 0.0f : win.gyr[3 * k + i];
  }
  *d = dt <= 0.0f ? q.fallback_dt : dt;
  return win.mask[k] != 0;
}

// The rank of this thread's slot among the chunk's slots that `hit`, in slot
// order, and (`n`) their number; every thread of the block calls it
__device__ int compact(bool hit, int* warp_count, int* n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, hit);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  int pos = __popc(ballot & ((1u << lane) - 1u));
  *n = 0;
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) pos += warp_count[w];
    *n += warp_count[w];
  }
  __syncthreads();      // warp_count is the next chunk's after this
  return pos;
}

// ---------------------------------------------------------------------------
// the correction
// ---------------------------------------------------------------------------

struct Samples {        // a chunk's valid samples, in slot order
  float a[THREADS][3];  // acc - bias_acc
  float dt[THREADS];
  float inv_dt[THREADS];  // 1 / dt as the noise takes it, 0 where dt <= 0
  float dR[THREADS][9]; // Exp(w dt)
  float Jr[THREADS][9]; // its right Jacobian
};

struct Preint {         // the preintegration's running state
  float D[2][9];        // the cumulative rotation (a pair: before, after)
  float dv[3], dp[3], dt;
  float P[81];          // the 9x9 covariance of [dtheta, dv, dp]
  float M[81];          // A P
  float A[2][81];       // a sample's transition and noise (a pair: this
  float Q[2][81];       // sample's, the last one's)
  float C[54];          // its bias input: Cg (9x3), then Ca (9x3)
  float J[2][54];       // the bias Jacobians Jg, Ja (a pair: before, after)
};

struct Update {         // the 15x15 algebra, float64
  double F[225];
  double X[225], Y[225], Z[225];
  double aug[6][21];    // [S | H P], then its elimination
  double K[90];         // the gain, (15, 6)
  double r[6];
  double rn[6];         // the diagonal of the correction noise
  float R[9], p[3], v[3];     // the predicted navigation state
  float dx[15];
  float cov[225];       // the update's covariance, float32
  float out[21];        // R, p, v, biases of the updated state
  int failed;
};

// The step's roles, a set of whole warps each: threads [0, 81) own the
// entries of P and of A P, threads [AQ_AT, AQ_AT + 81) those of A and Q and
// then of J, threads [C_AT, C_AT + 54) those of C and then D, dv, dp, dt.
constexpr int AQ_AT = 96;
constexpr int C_AT = 192;

// P = (A P) A^T + Q of the sample whose A and Q are pair `b`: entry e
__device__ void finish_covariance(Preint& pr, int e, int b) {
  const int i = e / 9, j = e % 9;
  float acc = 0.0f;
#pragma unroll
  for (int m = 0; m < 9; ++m) acc = acc + pr.M[9 * i + m] * pr.A[b][9 * j + m];
  pr.P[e] = acc + pr.Q[b][e];
}

// The first half of a valid sample's step: the last sample's covariance
// (where `last`), and this sample's transition A, noise Q and bias input C
// into pair `b` (preintegrate_parallel: A = [[dRk^T, 0, 0], [-Ahat dt, I,
// 0], [-0.5 Ahat dt^2, I dt, I]], Ahat = D [a]x, Bg = [Jr dt; 0; 0], Ba =
// [0; D dt; 0.5 D dt^2], Q = Bg Bg^T sig_g^2 / dt + Ba Ba^T sig_a^2 / dt,
// Cg = -Bg, Ca = -Ba)
__device__ void step_transition(Preint& pr, const Samples& sm, int s, int cur,
                                int b, bool last, float sig_g2,
                                float sig_a2) {
  const int tid = threadIdx.x;
  const float* D = pr.D[cur];
  const float* Jr = sm.Jr[s];
  const float dt = sm.dt[s], dt2 = dt * dt;
  if (tid < 81) {
    if (last) finish_covariance(pr, tid, b ^ 1);
  } else if (tid >= AQ_AT && tid < AQ_AT + 81) {
    const int e = tid - AQ_AT;
    const int i = e / 9, j = e % 9, bi = i / 3, bj = j / 3;
    const int ii = i % 3, jj = j % 3;
    float A = 0.0f;
    if (bi == bj) {
      A = bi == 0 ? sm.dR[s][3 * jj + ii] : (ii == jj ? 1.0f : 0.0f);
    } else if (bj == 0) {
      float ax[9];
      skew(sm.a[s], ax);
      const float Ahat = D[3 * ii] * ax[jj] + D[3 * ii + 1] * ax[3 + jj] +
                         D[3 * ii + 2] * ax[6 + jj];
      A = bi == 1 ? -Ahat * dt : -0.5f * Ahat * dt2;
    } else if (bi == 2 && bj == 1) {
      A = (ii == jj ? 1.0f : 0.0f) * dt;
    }
    pr.A[b][e] = A;
    float g = 0.0f, ac = 0.0f;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const float gi = bi == 0 ? Jr[3 * ii + m] * dt : 0.0f;
      const float gj = bj == 0 ? Jr[3 * jj + m] * dt : 0.0f;
      const float ai = bi == 0 ? 0.0f
                     : bi == 1 ? D[3 * ii + m] * dt : 0.5f * D[3 * ii + m] * dt2;
      const float aj = bj == 0 ? 0.0f
                     : bj == 1 ? D[3 * jj + m] * dt : 0.5f * D[3 * jj + m] * dt2;
      g = g + gi * gj;
      ac = ac + ai * aj;
    }
    const float inv_dt = sm.inv_dt[s];
    pr.Q[b][e] = g * (sig_g2 * inv_dt) + ac * (sig_a2 * inv_dt);
  } else if (tid >= C_AT && tid < C_AT + 54) {
    const int f = tid - C_AT, ga = f / 27, i = (f % 27) / 3, m = f % 3;
    const int bi = i / 3, ii = i % 3;
    pr.C[f] = ga == 0 ? (bi == 0 ? -Jr[3 * ii + m] * dt : 0.0f)
            : bi == 0 ? 0.0f
            : bi == 1 ? -D[3 * ii + m] * dt : -0.5f * D[3 * ii + m] * dt2;
  }
}

// The second half: A P; J <- A J + C; D <- D dRk; dp += dv dt + 0.5 Ra
// dt^2, dv += Ra dt (Ra = D a); the window's dt
__device__ void step_propagate(Preint& pr, const Samples& sm, int s, int cur,
                               int b) {
  const int tid = threadIdx.x;
  const float* A = pr.A[b];
  const float* D = pr.D[cur];
  const float dt = sm.dt[s];
  if (tid < 81) {
    const int i = tid / 9, j = tid % 9;
    float acc = 0.0f;
#pragma unroll
    for (int m = 0; m < 9; ++m) acc = acc + A[9 * i + m] * pr.P[9 * m + j];
    pr.M[tid] = acc;
  } else if (tid >= AQ_AT && tid < AQ_AT + 54) {
    const int f = tid - AQ_AT, half = f / 27, i = (f % 27) / 3, c = f % 3;
    const float* J = pr.J[cur];
    float acc = 0.0f;
#pragma unroll
    for (int m = 0; m < 9; ++m)
      acc = acc + A[9 * i + m] * J[27 * half + 3 * m + c];
    pr.J[cur ^ 1][f] = acc + pr.C[f];
  } else if (tid >= C_AT && tid < C_AT + 9) {
    const int e = tid - C_AT, i = e / 3, j = e % 3;
    const float* dR = sm.dR[s];
    pr.D[cur ^ 1][e] = D[3 * i] * dR[j] + D[3 * i + 1] * dR[3 + j] +
                       D[3 * i + 2] * dR[6 + j];
  } else if (tid >= C_AT + 9 && tid < C_AT + 12) {
    const int c = tid - C_AT - 9;
    const float* a = sm.a[s];
    const float Ra = D[3 * c] * a[0] + D[3 * c + 1] * a[1] + D[3 * c + 2] * a[2];
    pr.dp[c] = pr.dp[c] + (pr.dv[c] * dt + 0.5f * Ra * (dt * dt));
    pr.dv[c] = pr.dv[c] + Ra * dt;
  } else if (tid == C_AT + 12) {
    pr.dt = pr.dt + dt;
  }
}

// The anchored state (imu_frontend._anchored with zero biases): the pose's
// rotation and position, zero velocity, the prior covariance
__device__ void write_anchor(const float* pose6, bool failure, float* out) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    rpy_to_matrix(pose6, out);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      out[9 + i] = pose6[3 + i];
      out[12 + i] = 0.0f;
      out[15 + i] = 0.0f;
      out[18 + i] = 0.0f;
    }
    unsigned char* flags = reinterpret_cast<unsigned char*>(out + FLAGS_AT);
    flags[0] = 1;
    flags[1] = failure;
  }
  for (int e = tid; e < 225; e += THREADS) {
    const int i = e / 15, j = e % 15;
    out[COV_AT + e] = i != j ? 0.0f
                    : i < 3 || (i >= 6 && i < 9) ? VAR_ROT
                    : i < 6 ? VAR_VEL : VAR_BIAS;
  }
}

// H's rows pick these of the 15 error-state components (rotation, position)
__device__ __forceinline__ int picked(int m) { return m < 3 ? m : m + 3; }

__global__ void __launch_bounds__(THREADS)
imu_correct(State st, Window win, const float* __restrict__ pose6,
            const unsigned char* __restrict__ degenerate, Params q,
            float* __restrict__ out) {
  __shared__ Samples sm;
  __shared__ Preint pr;
  __shared__ Update up;
  __shared__ int warp_count[WARPS];
  const int tid = threadIdx.x;
  if (!*st.initialized) {        // not yet initialized: anchor at the pose
    write_anchor(pose6, false, out);
    return;
  }

  // ---- preintegration (float32) ----
  if (tid < 9) pr.D[0][tid] = eye(tid);
  if (tid < 3) pr.dv[tid] = pr.dp[tid] = 0.0f;
  if (tid == 0) pr.dt = 0.0f;
  for (int e = tid; e < 81; e += THREADS)
    pr.P[e] = (e % 10 == 0 ? 1.0f : 0.0f) * q.init_cov;
  for (int e = tid; e < 54; e += THREADS) pr.J[0][e] = 0.0f;
  const float sig_g2 = q.gyr_noise * q.gyr_noise;
  const float sig_a2 = q.acc_noise * q.acc_noise;
  int cur = 0, b = 0;           // the pairs' parities: D and J; A and Q
  for (int base = 0; base < win.W; base += THREADS) {
    const int k = base + tid;
    float a[3], w[3], d = 0.0f;
    const bool hit = k < win.W && gated(win, q, k, a, w, &d);
    int n;
    const int pos = compact(hit, warp_count, &n);
    if (hit) {
      float th[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        sm.a[pos][i] = a[i] - st.bias_acc[i];
        th[i] = (w[i] - st.bias_gyr[i]) * d;
      }
      sm.dt[pos] = d;
      sm.inv_dt[pos] = d > 0.0f ? 1.0f / clamp_min(d, 1e-6f) : 0.0f;
      so3_exp_jr(th, sm.dR[pos], sm.Jr[pos]);
    }
    __syncthreads();
    // a valid sample a step of two barriers; a sample's covariance is
    // finished in the next one's first half, the chunk's last one here
    for (int s = 0; s < n; ++s, cur ^= 1, b ^= 1) {
      step_transition(pr, sm, s, cur, b, s > 0, sig_g2, sig_a2);
      __syncthreads();
      step_propagate(pr, sm, s, cur, b);
      __syncthreads();
    }
    if (n > 0) {
      if (tid < 81) finish_covariance(pr, tid, b ^ 1);
      __syncthreads();
    }
  }
  const float* dRw = pr.D[cur];
  const float* Jg = pr.J[cur];
  const float* Ja = pr.J[cur] + 27;

  // ---- predict (float32): R0 dR, p + v t + 0.5 g t^2 + R0 dp, v + g t + R0 dv
  const float* R0 = st.R;
  const float T = pr.dt;
  if (tid < 9) {
    const int i = tid / 3, j = tid % 3;
    up.R[tid] = R0[3 * i] * dRw[j] + R0[3 * i + 1] * dRw[3 + j] +
                R0[3 * i + 2] * dRw[6 + j];
  } else if (tid < 12) {
    const int c = tid - 9;
    const float g = c == 2 ? -q.gravity : 0.0f;
    float Rdp[3], Rdv[3];
    mv3(R0, pr.dp, Rdp);
    mv3(R0, pr.dv, Rdv);
    up.p[c] = st.p[c] + st.v[c] * T + 0.5f * g * T * T + Rdp[c];
    up.v[c] = st.v[c] + g * T + Rdv[c];
  }

  // ---- the 15x15 algebra (float64) ----
  // F, and X = G cov9 (G = blockdiag(I, R0, R0))
  for (int e = tid; e < 225; e += THREADS) {
    const int i = e / 15, j = e % 15, bi = i / 3, bj = j / 3;
    const int ii = i % 3, jj = j % 3;
    double f = i == j ? 1.0 : 0.0;
    double s = 0.0;
    if (bi == 0 && bj == 0) {
      f = dRw[3 * jj + ii];
    } else if ((bi == 1 || bi == 2) && bj == 0) {   // -R0 [dv]x, -R0 [dp]x
      float x[9];
      skew(bi == 1 ? pr.dv : pr.dp, x);
      for (int m = 0; m < 3; ++m)
        s = s + (double)-R0[3 * ii + m] * (double)x[3 * m + jj];
      f = s;
    } else if (bi == 2 && bj == 1) {
      f = (ii == jj ? 1.0 : 0.0) * (double)T;
    } else if (bi == 0 && bj == 3) {
      f = Jg[3 * ii + jj];
    } else if ((bi == 1 || bi == 2) && (bj == 3 || bj == 4)) {
      const float* src = (bj == 3 ? Jg : Ja) + 9 * bi;   // rows 3 bi ..
      for (int m = 0; m < 3; ++m)
        s = s + (double)R0[3 * ii + m] * (double)src[3 * m + jj];
      f = s;
    }
    up.F[e] = f;
    if (e < 81) {
      const int r = e / 9, c = e % 9, br = r / 3, rr = r % 3;
      double g = 0.0;
      if (br == 0) {
        g = pr.P[e];
      } else {
        for (int m = 0; m < 3; ++m)
          g = g + (double)R0[3 * rr + m] * (double)pr.P[9 * (3 * br + m) + c];
      }
      up.X[e] = g;
    }
  }
  __syncthreads();
  // Y = F cov15; Z = Q15 = [[X G^T, 0, 0], [0, gyr_bias_var T I, 0],
  // [0, 0, acc_bias_var T I]]
  for (int e = tid; e < 225; e += THREADS) {
    const int i = e / 15, j = e % 15;
    double s = 0.0;
    for (int m = 0; m < 15; ++m)
      s = s + up.F[15 * i + m] * (double)st.cov[15 * m + j];
    up.Y[e] = s;
    double z = 0.0;
    if (i < 9 && j < 9) {
      const int bj = j / 3, jj = j % 3;
      if (bj == 0) {
        z = up.X[9 * i + j];
      } else {
        for (int m = 0; m < 3; ++m)
          z = z + up.X[9 * i + 3 * bj + m] * (double)R0[3 * jj + m];
      }
    } else if (i >= 9 && j >= 9 && i / 3 == j / 3) {
      z = (i == j ? 1.0 : 0.0) * (i < 12 ? q.gyr_bias_var : q.acc_bias_var) *
          (double)T;
    }
    up.Z[e] = z;
  }
  __syncthreads();
  // X = Y F^T + Z
  for (int e = tid; e < 225; e += THREADS) {
    const int i = e / 15, j = e % 15;
    double s = 0.0;
    for (int m = 0; m < 15; ++m) s = s + up.Y[15 * i + m] * up.F[15 * j + m];
    up.X[e] = s + up.Z[e];
  }
  __syncthreads();
  // Y = P = 0.5 (X + X^T)
  for (int e = tid; e < 225; e += THREADS) {
    const int i = e / 15, j = e % 15;
    up.Y[e] = 0.5 * (up.X[e] + up.X[15 * j + i]);
  }
  // correctionNoise 0.05 rad / 0.1 m, 1 where degenerate (float32, squared
  // in float64)
  if (tid < 6) {
    const double sd = *degenerate ? 1.0f : (tid < 3 ? 0.05f : 0.1f);
    up.rn[tid] = sd * sd;
  }
  __syncthreads();
  // [S | H P], S = 0.5 (H P H^T + Rn + its transpose)
  for (int e = tid; e < 6 * 21; e += THREADS) {
    const int i = e / 21, j = e % 21;
    if (j < 6) {
      const double sij = up.Y[15 * picked(i) + picked(j)] + (i == j ? up.rn[i] : 0.0);
      const double sji = up.Y[15 * picked(j) + picked(i)] + (i == j ? up.rn[j] : 0.0);
      up.aug[i][j] = 0.5 * (sij + sji);
    } else {
      up.aug[i][j] = up.Y[15 * picked(i) + (j - 6)];
    }
  }
  __syncthreads();
  // S K^T = H P: elimination with partial pivoting, then back substitution
  for (int k = 0; k < 6; ++k) {
    if (tid == 0) {
      int piv = k;
      double big = fabs(up.aug[k][k]);
      for (int i = k + 1; i < 6; ++i)
        if (fabs(up.aug[i][k]) > big) {
          big = fabs(up.aug[i][k]);
          piv = i;
        }
      if (piv != k)
        for (int j = 0; j < 21; ++j) {
          const double t = up.aug[k][j];
          up.aug[k][j] = up.aug[piv][j];
          up.aug[piv][j] = t;
        }
    }
    __syncthreads();
    const int cols = 20 - k;
    for (int e = tid; e < (5 - k) * cols; e += THREADS) {
      const int i = k + 1 + e / cols, j = k + 1 + e % cols;
      up.aug[i][j] = up.aug[i][j] - up.aug[i][k] / up.aug[k][k] * up.aug[k][j];
    }
    __syncthreads();
  }
  if (tid < 15) {
    double x[6];
    for (int i = 5; i >= 0; --i) {
      double s = up.aug[i][6 + tid];
      for (int j = i + 1; j < 6; ++j) s = s - up.aug[i][j] * x[j];
      x[i] = s / up.aug[i][i];
      up.K[6 * tid + i] = x[i];
    }
  } else if (tid == 32) {
    // r = [Log(R^T Rm), pm - p] (float32)
    float Rm[9], Rt[9], Rrel[9], w[3];
    rpy_to_matrix(pose6, Rm);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) Rt[3 * i + j] = up.R[3 * j + i];
    mm3(Rt, Rm, Rrel);
    so3_log(Rrel, w);
    for (int i = 0; i < 3; ++i) {
      up.r[i] = w[i];
      up.r[3 + i] = pose6[3 + i] - up.p[i];
    }
  }
  __syncthreads();
  // dx = K r (float32); Z = I - K H
  if (tid < 15) {
    double s = 0.0;
    for (int m = 0; m < 6; ++m) s = s + up.K[6 * tid + m] * up.r[m];
    up.dx[tid] = (float)s;
  }
  for (int e = tid; e < 225; e += THREADS) {
    const int i = e / 15, j = e % 15;
    const int m = j < 3 ? j : (j >= 6 && j < 9 ? j - 3 : -1);
    up.Z[e] = (i == j ? 1.0 : 0.0) - (m < 0 ? 0.0 : up.K[6 * i + m]);
  }
  __syncthreads();
  // X = (I - K H) P
  for (int e = tid; e < 225; e += THREADS) {
    const int i = e / 15, j = e % 15;
    double s = 0.0;
    for (int m = 0; m < 15; ++m) s = s + up.Z[15 * i + m] * up.Y[15 * m + j];
    up.X[e] = s;
  }
  __syncthreads();
  // cov = float32(X (I - K H)^T + (K Rn) K^T)
  for (int e = tid; e < 225; e += THREADS) {
    const int i = e / 15, j = e % 15;
    double s = 0.0, t = 0.0;
    for (int m = 0; m < 15; ++m) s = s + up.X[15 * i + m] * up.Z[15 * j + m];
    for (int m = 0; m < 6; ++m)
      t = t + up.K[6 * i + m] * up.rn[m] * up.K[6 * j + m];
    up.cov[e] = (float)(s + t);
  }
  // the updated state, and the divergence check
  if (tid == 0) {
    float E[9], Rn[9];
    so3_exp_jr(up.dx, E, nullptr);
    mm3(up.R, E, Rn);
    float vv = 0.0f, gg = 0.0f, aa = 0.0f;
    for (int e = 0; e < 9; ++e) up.out[e] = Rn[e];
    for (int i = 0; i < 3; ++i) {
      const float p = up.p[i] + up.dx[6 + i];
      const float v = up.v[i] + up.dx[3 + i];
      const float bg = st.bias_gyr[i] + up.dx[9 + i];
      const float ba = st.bias_acc[i] + up.dx[12 + i];
      up.out[9 + i] = p;
      up.out[12 + i] = v;
      up.out[15 + i] = bg;
      up.out[18 + i] = ba;
      vv = vv + v * v;
      gg = gg + bg * bg;
      aa = aa + ba * ba;
    }
    up.failed = sqrtf(vv) > VEL_LIMIT || sqrtf(aa) > BIAS_LIMIT ||
                sqrtf(gg) > BIAS_LIMIT;
  }
  __syncthreads();
  if (up.failed) {              // diverged: reset to the pose, flagged
    write_anchor(pose6, true, out);
    return;
  }
  for (int e = tid; e < 225; e += THREADS) {
    const int i = e / 15, j = e % 15;
    out[COV_AT + e] = 0.5f * (up.cov[e] + up.cov[15 * j + i]);
  }
  if (tid < 21) out[tid] = up.out[tid];
  if (tid == 0) {
    unsigned char* flags = reinterpret_cast<unsigned char*>(out + FLAGS_AT);
    flags[0] = 1;
    flags[1] = 0;
  }
}

// ---------------------------------------------------------------------------
// the rate prediction
// ---------------------------------------------------------------------------

struct Train {          // a chunk's valid samples and their running sums
  float dR[THREADS][9]; // Exp(w dt)
  float a[THREADS][3];  // acc - bias_acc
  float dt[THREADS];
  float D[THREADS][9];  // the cumulative rotation after the sample
  float acc_w[THREADS][3];  // R0 D_prev a + g
  float p[THREADS][3];  // the position after the sample
  float D0[9], p0[3];   // the same before the chunk
};

// integrate_pose_train on the gated, bias-corrected window: out (W, 6) the
// pose at every slot
__global__ void __launch_bounds__(THREADS)
imu_predict(State st, Window win, Params q, float* __restrict__ out) {
  __shared__ Train tr;
  __shared__ int warp_count[WARPS];
  const int tid = threadIdx.x;
  const float* R0 = st.R;
  const float g[3] = {0.0f, 0.0f, -q.gravity};
  if (tid < 9) tr.D0[tid] = eye(tid);
  if (tid < 3) tr.p0[tid] = st.p[tid] + 0.0f;
  // the running sums of the velocity and position increments, and the last
  // velocity (threads 0-2, a component each)
  float sv = 0.0f, sp = 0.0f, v_prev = tid < 3 ? st.v[tid] : 0.0f;
  for (int base = 0; base < win.W; base += THREADS) {
    const int k = base + tid;
    float a[3], w[3], d = 0.0f;
    const bool hit = k < win.W && gated(win, q, k, a, w, &d);
    int n;
    const int pos = compact(hit, warp_count, &n);
    if (hit) {
      float th[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        tr.a[pos][i] = a[i] - st.bias_acc[i];
        th[i] = (w[i] - st.bias_gyr[i]) * d;
      }
      tr.dt[pos] = d;
      so3_exp_jr(th, tr.dR[pos], nullptr);
    }
    __syncthreads();
    if (tid == 0) {             // the cumulative rotation, in registers
      float D[9], Dn[9];
#pragma unroll
      for (int e = 0; e < 9; ++e) D[e] = tr.D0[e];
      for (int s = 0; s < n; ++s) {
        mm3(D, tr.dR[s], Dn);
#pragma unroll
        for (int e = 0; e < 9; ++e) tr.D[s][e] = D[e] = Dn[e];
      }
    }
    __syncthreads();
    for (int s = tid; s < n; s += THREADS) {    // acc_w = (R0 D_prev) a + g
      float Rp[9], x[3];
      mm3(R0, s > 0 ? tr.D[s - 1] : tr.D0, Rp);
      mv3(Rp, tr.a[s], x);
#pragma unroll
      for (int i = 0; i < 3; ++i) tr.acc_w[s][i] = x[i] + g[i];
    }
    __syncthreads();
    if (tid < 3) {              // v = v0 + cumsum(acc_w dt), p likewise
      for (int s = 0; s < n; ++s) {
        const float dt = tr.dt[s], aw = tr.acc_w[s][tid];
        sv = sv + aw * dt;
        const float v = st.v[tid] + sv;
        sp = sp + (v_prev * dt + 0.5f * aw * dt * dt);
        tr.p[s][tid] = st.p[tid] + sp;
        v_prev = v;
      }
    }
    __syncthreads();
    if (k < win.W) {            // the slot's pose: that of its last valid sample
      const int last = hit ? pos : pos - 1;
      const float* D = last >= 0 ? tr.D[last] : tr.D0;
      const float* p = last >= 0 ? tr.p[last] : tr.p0;
      float R[9];
      mm3(R0, D, R);
      matrix_to_rpy(R, out + 6 * k);
#pragma unroll
      for (int i = 0; i < 3; ++i) out[6 * k + 3 + i] = p[i];
    }
    __syncthreads();
    if (n > 0) {
      if (tid < 9) tr.D0[tid] = tr.D[n - 1][tid];
      if (tid < 3) tr.p0[tid] = tr.p[n - 1][tid];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// TransformFusion
// ---------------------------------------------------------------------------

// lidar ∘ (front^-1 ∘ back[r]), a row a thread
__global__ void __launch_bounds__(THREADS)
imu_fusion(const float* __restrict__ lidar, const float* __restrict__ front,
           const float* __restrict__ back, int N, float* __restrict__ out) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= N) return;
  float inv[6], inc[6];
  pose6_inverse(front, inv);
  pose6_compose(inv, back + 6 * r, inc);
  pose6_compose(lidar, inc, out + 6 * r);
}

}  // namespace

// The correction on `stream`: the state's leaves (float32; `initialized` one
// byte), the IMU window of W slots (float32; the mask one byte a slot), the
// lidar pose (6 float32) and the degenerate flag (one byte); `out` of
// 247 words: R, p, v, bias_gyr, bias_acc, the covariance, and the flags
// `initialized`, `failure` in the first two bytes of the last word.  Reads
// nothing on the host, allocates nothing and does not synchronise; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a W below 1.
extern "C" int lio_imu_correct(
    const float* R, const float* p, const float* v, const float* bias_gyr,
    const float* bias_acc, const float* cov, const unsigned char* initialized,
    const float* acc, const float* gyr, const float* dt,
    const unsigned char* mask, int W, const float* pose6,
    const unsigned char* degenerate, float gravity, float pileup_dt,
    float fallback_dt, float acc_noise, float gyr_noise, float init_cov,
    double acc_bias_var, double gyr_bias_var, float* out, void* stream) {
  if (W < 1) return (int)cudaErrorInvalidValue;
  const State st{R, p, v, bias_gyr, bias_acc, cov, initialized};
  const Window win{acc, gyr, dt, mask, W};
  const Params q{gravity,   pileup_dt, fallback_dt,  acc_noise,
                 gyr_noise, init_cov,  acc_bias_var, gyr_bias_var};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  imu_correct<<<1, THREADS, 0, s>>>(st, win, pose6, degenerate, q, out);
  return (int)cudaGetLastError();
}

// The rate prediction on `stream`: the state's R, p, v and biases, the IMU
// window of W slots, and `out` of (W, 6) words; returns as the correction.
extern "C" int lio_imu_predict(
    const float* R, const float* p, const float* v, const float* bias_gyr,
    const float* bias_acc, const float* acc, const float* gyr,
    const float* dt, const unsigned char* mask, int W, float gravity,
    float pileup_dt, float fallback_dt, float* out, void* stream) {
  if (W < 1) return (int)cudaErrorInvalidValue;
  const State st{R, p, v, bias_gyr, bias_acc, nullptr, nullptr};
  const Window win{acc, gyr, dt, mask, W};
  const Params q{gravity, pileup_dt, fallback_dt, 0.0f, 0.0f, 0.0f, 0.0, 0.0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  imu_predict<<<1, THREADS, 0, s>>>(st, win, q, out);
  return (int)cudaGetLastError();
}

// TransformFusion on `stream`: the lidar odometry and the first IMU pose (6
// words each), N IMU poses (N, 6), `out` (N, 6); returns as the correction.
extern "C" int lio_imu_fusion(const float* lidar, const float* front,
                              const float* back, int N, float* out,
                              void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (N + THREADS - 1) / THREADS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  imu_fusion<<<blocks, THREADS, 0, s>>>(lidar, front, back, N, out);
  return (int)cudaGetLastError();
}
