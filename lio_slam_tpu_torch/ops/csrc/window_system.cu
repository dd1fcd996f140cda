// The keyframe save's fixed-lag window system in one launch, for Hopper
// (sm_90a): every factor that touches the window is linearized at delta = 0
// and its J^T Lambda J and -J^T Lambda e blocks are summed into the dense
// (6W)^2 H and 6W b that graph/solver.py:solve_window_compact solves.
//
// It replaces no TPU kernel.  The JAX package linearizes with jax.jacfwd
// over every factor slot and scatters the blocks (lio_slam_tpu/graph/
// solver.py), and the plain version does the same with torch.func
// (ops/window_system.py:assemble_plain): tens of thousands of small
// operations an iteration whatever the window holds, and a scatter that
// sends every slot outside the window to one dump block, which the card's
// sort-based accumulate serialises.  Here a slot that touches no window
// pose costs a load and a compare.
//
// What it computes, and how faithfully:
// - The errors are graph/factors.py's prior_error, between_error and
//   gps_error, written over utils/se3.py's functions (rpy_to_matrix,
//   se3_exp with so3_exp and so3_left_jacobian, compose, inverse, se3_log
//   with so3_log and the inverse of the left Jacobian), each branch as
//   there (the small-angle series, the near-zero and near-pi forms of the
//   log, the clamps).  The Jacobians come by forward-mode differentiation
//   of those same functions: 6-wide dual numbers seeded with the unit
//   tangents of delta, as jacfwd does; an unselected branch's tangent is
//   dropped, as torch.where drops it.  Nothing is derived in closed form.
// - float32 throughout, built with --fmad=false; the transcendental
//   functions are the card's, so values agree with torch's to rounding, not
//   bit for bit.
// - Each output block sums its contributions in slot order (the prior, the
//   between slots, the GPS slots), with no atomics, so the same inputs give
//   the same bits on every run.  A term is w * (J_p * J_q), whose two
//   products commute, so block (c, a) is block (a, c) transposed bit for
//   bit.
// - Window slots past `count` get an identity diagonal block, zero rows and
//   columns and a zero b, as the plain version's masking gives.
//
// The dual-number functions called more than once (retract, se3_log,
// between_error) are kept out of line: inlined, their copies made the
// library's build several times longer for no gain in a launch that is
// latency-bound anyway.
//
// What bounds it: latency.  At the default preset (K = 2048, B = 2175,
// G = 520, W = 64) the window holds about 64 odometry factors, so the work
// is some hundred thousand FLOP and the 590 KB of H written once.  So the
// grid is one block a window pose, i.e. a block row of H: each block scans
// every slot (coalesced loads of the indices and masks, a ballot a warp
// and one compaction a chunk of 64 slots), linearizes the few factors that
// touch its pose, one a thread, and writes its contiguous 36W + 6 words.
// A factor between two window poses is linearized by both of their
// blocks, the same code on the same inputs, which keeps the blocks
// independent: there is no grid-wide step and no scratch in device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 64;        // a block: two warps; a chunk is 64 slots
constexpr int MAX_WINDOW = 128;    // the accumulators are in shared memory
constexpr float PI_F = 3.14159265358979323846f;

// ---------------------------------------------------------------------------
// 6-wide dual numbers: a value and its derivative along each of the six
// components of delta
// ---------------------------------------------------------------------------

struct Dual {
  float v;
  float d[6];
};

__device__ __forceinline__ Dual lift(float x) {
  Dual r;
  r.v = x;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = 0.0f;
  return r;
}

__device__ __forceinline__ Dual operator+(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}

__device__ __forceinline__ Dual operator-(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}

__device__ __forceinline__ Dual operator-(const Dual& a) {
  Dual r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = -a.d[k];
  return r;
}

__device__ __forceinline__ Dual operator*(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}

__device__ __forceinline__ Dual operator/(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v / b.v;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) / b.v;
  return r;
}

__device__ __forceinline__ Dual operator+(const Dual& a, float b) {
  Dual r = a;
  r.v = a.v + b;
  return r;
}

__device__ __forceinline__ Dual operator+(float a, const Dual& b) {
  return b + a;
}

__device__ __forceinline__ Dual operator-(const Dual& a, float b) {
  Dual r = a;
  r.v = a.v - b;
  return r;
}

__device__ __forceinline__ Dual operator-(float a, const Dual& b) {
  Dual r = -b;
  r.v = a - b.v;
  return r;
}

__device__ __forceinline__ Dual operator*(const Dual& a, float b) {
  Dual r;
  r.v = a.v * b;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] * b;
  return r;
}

__device__ __forceinline__ Dual operator*(float a, const Dual& b) {
  return b * a;
}

__device__ __forceinline__ Dual operator/(const Dual& a, float b) {
  Dual r;
  r.v = a.v / b;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] / b;
  return r;
}

__device__ __forceinline__ Dual chain(const Dual& a, float value, float slope) {
  Dual r;
  r.v = value;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] * slope;
  return r;
}

__device__ __forceinline__ Dual dsqrt(const Dual& a) {
  const float s = sqrtf(a.v);
  return chain(a, s, 1.0f / (2.0f * s));
}

__device__ __forceinline__ Dual dsin(const Dual& a) {
  return chain(a, sinf(a.v), cosf(a.v));
}

__device__ __forceinline__ Dual dcos(const Dual& a) {
  return chain(a, cosf(a.v), -sinf(a.v));
}

__device__ __forceinline__ Dual dacos(const Dual& a) {
  return chain(a, acosf(a.v), -1.0f / sqrtf(1.0f - a.v * a.v));
}

// torch.clamp(x, lo, hi): the tangent passes where lo <= x <= hi
__device__ __forceinline__ Dual dclamp(const Dual& a, float lo, float hi) {
  if (a.v < lo) return lift(lo);
  if (a.v > hi) return lift(hi);
  return a;
}

__device__ __forceinline__ Dual dclamp_min(const Dual& a, float lo) {
  return a.v < lo ? lift(lo) : a;
}

// torch.sign: no tangent
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

struct M3 {
  Dual m[3][3];
};

struct V3 {
  Dual v[3];
};

// ---------------------------------------------------------------------------
// utils/se3.py on dual numbers
// ---------------------------------------------------------------------------

__device__ void matmul(const M3& A, const M3& B, M3& C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C.m[i][j] = A.m[i][0] * B.m[0][j] + A.m[i][1] * B.m[1][j] +
                  A.m[i][2] * B.m[2][j];
}

__device__ void matvec(const M3& A, const V3& x, V3& y) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y.v[i] = A.m[i][0] * x.v[0] + A.m[i][1] * x.v[1] + A.m[i][2] * x.v[2];
}

// rpy_to_matrix of a stored pose (no tangent): R = Rz(yaw) Ry(pitch) Rx(roll)
__device__ void rpy_to_matrix(const float* rpy, M3& R) {
  const float cr = cosf(rpy[0]), sr = sinf(rpy[0]);
  const float cp = cosf(rpy[1]), sp = sinf(rpy[1]);
  const float cy = cosf(rpy[2]), sy = sinf(rpy[2]);
  R.m[0][0] = lift(cy * cp);
  R.m[0][1] = lift(cy * sp * sr - sy * cr);
  R.m[0][2] = lift(cy * sp * cr + sy * sr);
  R.m[1][0] = lift(sy * cp);
  R.m[1][1] = lift(sy * sp * sr + cy * cr);
  R.m[1][2] = lift(sy * sp * cr - cy * sr);
  R.m[2][0] = lift(-sp);
  R.m[2][1] = lift(cp * sr);
  R.m[2][2] = lift(cp * cr);
}

__device__ void skew(const V3& w, M3& S) {
  const Dual z = lift(0.0f);
  S.m[0][0] = z;       S.m[0][1] = -w.v[2]; S.m[0][2] = w.v[1];
  S.m[1][0] = w.v[2];  S.m[1][1] = z;       S.m[1][2] = -w.v[0];
  S.m[2][0] = -w.v[1]; S.m[2][1] = w.v[0];  S.m[2][2] = z;
}

// I + p W + q W^2, the form of so3_exp and so3_left_jacobian
__device__ void series(const M3& W, const M3& W2, const Dual& p, const Dual& q,
                       M3& out) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out.m[i][j] = (i == j ? 1.0f : 0.0f) + p * W.m[i][j] + q * W2.m[i][j];
}

// so3_left_jacobian(w) and, with `R`, so3_exp(w): the same theta2 and
// small-angle test (theta2 < 1e-8)
__device__ void so3_exp_jl(const V3& w, M3* R, M3& J) {
  const Dual theta2 = w.v[0] * w.v[0] + w.v[1] * w.v[1] + w.v[2] * w.v[2];
  const bool small = theta2.v < 1e-8f;
  M3 W, W2;
  skew(w, W);
  matmul(W, W, W2);
  Dual a, b, c;
  if (small) {
    a = 1.0f - theta2 / 6.0f;
    b = 0.5f - theta2 / 24.0f;
    c = (float)(1.0 / 6.0) - theta2 / 120.0f;
  } else {
    const Dual theta = dsqrt(theta2);
    const Dual s = dsin(theta);
    a = s / theta;
    b = (1.0f - dcos(theta)) / theta2;
    c = (theta - s) / (theta2 * theta);
  }
  if (R) series(W, W2, a, b, *R);
  series(W, W2, b, c, J);
}

// se3_exp(xi) -> (R, t): t = J_l(w) v
__device__ void se3_exp(const Dual* xi, M3& R, V3& t) {
  V3 w, v;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    w.v[i] = xi[i];
    v.v[i] = xi[3 + i];
  }
  M3 J;
  so3_exp_jl(w, &R, J);
  matvec(J, v, t);
}

__device__ void compose(const M3& Ra, const V3& ta, const M3& Rb,
                        const V3& tb, M3& R, V3& t) {
  matmul(Ra, Rb, R);
  matvec(Ra, tb, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) t.v[i] = t.v[i] + ta.v[i];
}

__device__ void inverse(const M3& R, const V3& t, M3& Ri, V3& ti) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Ri.m[i][j] = R.m[j][i];
  matvec(Ri, t, ti);
#pragma unroll
  for (int i = 0; i < 3; ++i) ti.v[i] = -ti.v[i];
}

// torch.linalg.inv of a 3x3: the value by cofactors, the tangent as torch's
// forward rule, -A^-1 dA A^-1
__device__ void inv3(const M3& A, M3& Ai) {
  float a[3][3], v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) a[i][j] = A.m[i][j].v;
  v[0][0] = a[1][1] * a[2][2] - a[1][2] * a[2][1];
  v[0][1] = a[0][2] * a[2][1] - a[0][1] * a[2][2];
  v[0][2] = a[0][1] * a[1][2] - a[0][2] * a[1][1];
  v[1][0] = a[1][2] * a[2][0] - a[1][0] * a[2][2];
  v[1][1] = a[0][0] * a[2][2] - a[0][2] * a[2][0];
  v[1][2] = a[0][2] * a[1][0] - a[0][0] * a[1][2];
  v[2][0] = a[1][0] * a[2][1] - a[1][1] * a[2][0];
  v[2][1] = a[0][1] * a[2][0] - a[0][0] * a[2][1];
  v[2][2] = a[0][0] * a[1][1] - a[0][1] * a[1][0];
  const float det = a[0][0] * v[0][0] + a[0][1] * v[1][0] + a[0][2] * v[2][0];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      v[i][j] = v[i][j] / det;
      Ai.m[i][j].v = v[i][j];
    }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float t[3][3];          // dA A^-1
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        t[i][j] = A.m[i][0].d[k] * v[0][j] + A.m[i][1].d[k] * v[1][j] +
                  A.m[i][2].d[k] * v[2][j];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Ai.m[i][j].d[k] = -(v[i][0] * t[0][j] + v[i][1] * t[1][j] +
                            v[i][2] * t[2][j]);
  }
}

// so3_log(R): the near-zero series, the generic form and the near-pi
// diagonal form, selected as torch.where selects them
__device__ void so3_log(const M3& R, V3& w) {
  const Dual trace = R.m[0][0] + R.m[1][1] + R.m[2][2];
  const Dual cos_t = dclamp((trace - 1.0f) / 2.0f, -1.0f, 1.0f);
  const bool near_zero = cos_t.v > (float)(1.0 - 1e-6);
  const bool near_pi_c = cos_t.v < (float)(-1.0 + 1e-6);
  Dual theta;
  if (near_zero)
    theta = lift(0.0f);
  else if (near_pi_c)
    theta = lift(PI_F);
  else
    theta = dacos(cos_t);
  V3 v;
  v.v[0] = R.m[2][1] - R.m[1][2];
  v.v[1] = R.m[0][2] - R.m[2][0];
  v.v[2] = R.m[1][0] - R.m[0][1];
  const bool near_pi = PI_F - theta.v < 1e-3f;
  if (near_pi) {
    // theta * axis * sign, axis^2 = clamp((diag - cos) / clamp(1 - cos,
    // 1e-8), 0), clamped to 1e-8 before the root
    const Dual den = dclamp_min(1.0f - cos_t, 1e-8f);
    const Dual off[3] = {R.m[1][0] + R.m[0][1], R.m[2][1] + R.m[1][2],
                         R.m[0][2] + R.m[2][0]};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const Dual axis2 = dclamp_min((R.m[i][i] - cos_t) / den, 0.0f);
      const Dual axis = dsqrt(dclamp_min(axis2, 1e-8f));
      float sg = sign_of(fabsf(v.v[i].v) > 1e-6f ? v.v[i].v : off[i].v);
      sg = sg == 0.0f ? 1.0f : sg;
      w.v[i] = theta * axis * sg;
    }
    return;
  }
  Dual scale;
  if (near_zero) {
    const Dual t2 =
        (v.v[0] * v.v[0] + v.v[1] * v.v[1] + v.v[2] * v.v[2]) / 4.0f;
    scale = 0.5f + t2 / 12.0f;
  } else {
    scale = theta / (2.0f * dsin(theta));
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) w.v[i] = scale * v.v[i];
}

// se3_log(R, t) = [w, J_l(w)^-1 t]
__device__ __noinline__ void se3_log(const M3& R, const V3& t, Dual* e) {
  V3 w, u;
  so3_log(R, w);
  M3 J, Ji;
  so3_exp_jl(w, nullptr, J);
  inv3(J, Ji);
  matvec(Ji, t, u);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    e[i] = w.v[i];
    e[3 + i] = u.v[i];
  }
}

// factors._retract: X Exp(delta) at delta = 0, delta's tangents seeded where
// `seeded` (the argument jacfwd differentiates)
__device__ __noinline__ void retract(const float* pose6, bool seeded, M3& R,
                                     V3& t) {
  Dual xi[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    xi[i] = lift(0.0f);
    if (seeded) xi[i].d[i] = 1.0f;
  }
  M3 R0, dR;
  V3 t0, dt;
  rpy_to_matrix(pose6, R0);
#pragma unroll
  for (int i = 0; i < 3; ++i) t0.v[i] = lift(pose6[3 + i]);
  se3_exp(xi, dR, dt);
  compose(R0, t0, dR, dt, R, t);
}

__device__ void meas_inverse(const float* meas6, M3& Rmi, V3& tmi) {
  M3 Rm;
  V3 tm;
  rpy_to_matrix(meas6, Rm);
#pragma unroll
  for (int i = 0; i < 3; ++i) tm.v[i] = lift(meas6[3 + i]);
  inverse(Rm, tm, Rmi, tmi);
}

// factors.prior_error: Log(M^-1 X Exp(d))
__device__ void prior_error(const float* pose6, const float* meas6, Dual* e) {
  M3 R, Rmi, Re;
  V3 t, tmi, te;
  retract(pose6, true, R, t);
  meas_inverse(meas6, Rmi, tmi);
  compose(Rmi, tmi, R, t, Re, te);
  se3_log(Re, te, e);
}

// factors.between_error: Log(M^-1 (X_i Exp(d_i))^-1 (X_j Exp(d_j))), d_i's
// tangents seeded where `wrt_i`, else d_j's
__device__ __noinline__ void between_error(const float* pi, const float* pj,
                              const float* meas6, bool wrt_i, Dual* e) {
  M3 Ri, Rj, Rii, Rij, Rmi, Re;
  V3 ti, tj, tii, tij, tmi, te;
  retract(pi, wrt_i, Ri, ti);
  retract(pj, !wrt_i, Rj, tj);
  inverse(Ri, ti, Rii, tii);
  compose(Rii, tii, Rj, tj, Rij, tij);
  meas_inverse(meas6, Rmi, tmi);
  compose(Rmi, tmi, Rij, tij, Re, te);
  se3_log(Re, te, e);
}

// factors.gps_error: the retracted translation minus the ENU position
__device__ void gps_error(const float* pose6, const float* meas3, Dual* e) {
  M3 R;
  V3 t;
  retract(pose6, true, R, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) e[i] = t.v[i] - meas3[i];
}

struct Graph {
  const float* poses;          // (K, 6)
  int K;
  const int* count;            // () the keyframes in the store
  const float* prior_pose;     // (6)
  const float* prior_info;     // (6)
  const int* bt_i;             // (B)
  const int* bt_j;
  const float* bt_meas;        // (B, 6)
  const float* bt_info;        // (B, 6)
  const unsigned char* bt_mask;
  int B;
  const int* gps_i;            // (G)
  const float* gps_meas;       // (G, 3)
  const float* gps_info;       // (G, 3)
  const unsigned char* gps_mask;
  int G;
};

__device__ __forceinline__ const float* pose_row(const Graph& g, int k) {
  return g.poses + 6 * min(max(k, 0), g.K - 1);
}

// Slot f of the factor order (0 the prior, then the B between slots, then
// the G GPS slots) touches local pose `a` of the window starting at `start`
__device__ __forceinline__ bool touches(const Graph& g, int f, int a,
                                        int start) {
  if (f == 0) return start == 0 && a == 0;
  if (f <= g.B) {
    const int s = f - 1;
    return g.bt_mask[s] &&
           (g.bt_i[s] - start == a || g.bt_j[s] - start == a);
  }
  const int s = f - 1 - g.B;
  return g.gps_mask[s] && g.gps_i[s] - start == a;
}

// One chunk's linearized factors, as block row `a` needs them: J of the
// row's pose, J of the factor's other window pose (`other`, or -1), the
// information diagonal and the error, over `rows` residual rows
struct Chunk {
  float J[THREADS][2][36];
  float w[THREADS][6];
  float e[THREADS][6];
  int other[THREADS];
  int rows[THREADS];
  int slot[THREADS];
  int warp_count[THREADS / 32];
};

__device__ void store_jacobian(const Dual* e, int rows, float* J) {
  for (int r = 0; r < rows; ++r)
#pragma unroll
    for (int k = 0; k < 6; ++k) J[r * 6 + k] = e[r].d[k];
}

// Linearize slot `f` for block row `a` into the chunk's entry `n`
__device__ void linearize(const Graph& g, int f, int a, int start, int W,
                          Chunk& c, int n) {
  Dual e[6], e2[6];
  c.other[n] = -1;
  if (f == 0) {
    prior_error(pose_row(g, 0), g.prior_pose, e);
    c.rows[n] = 6;
    store_jacobian(e, 6, c.J[n][0]);
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      c.w[n][r] = g.prior_info[r];
      c.e[n][r] = e[r].v;
    }
    return;
  }
  if (f <= g.B) {
    const int s = f - 1;
    const int li = g.bt_i[s] - start, lj = g.bt_j[s] - start;
    const bool side_i = li == a, side_j = lj == a;
    const int lo = side_i ? lj : li;
    const bool pair = side_i != side_j && lo >= 0 && lo < W;
    const float* pi = pose_row(g, g.bt_i[s]);
    const float* pj = pose_row(g, g.bt_j[s]);
    const float* meas = g.bt_meas + 6 * s;
    // J_i where the row is pose i or pairs with it, J_j likewise
    const bool need_i = side_i || pair, need_j = side_j || pair;
    if (need_i) between_error(pi, pj, meas, true, e);
    if (need_j) between_error(pi, pj, meas, false, need_i ? e2 : e);
    float* Ja = c.J[n][0];
    float* Jo = c.J[n][1];
    if (need_i && need_j) {
      // e: d/d delta_i, e2: d/d delta_j
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const float di = e[r].d[k], dj = e2[r].d[k];
          if (side_i && side_j) {
            Ja[r * 6 + k] = di + dj;        // both ends at this pose
          } else {
            Ja[r * 6 + k] = side_i ? di : dj;
            Jo[r * 6 + k] = side_i ? dj : di;
          }
        }
    } else {
      store_jacobian(e, 6, Ja);
    }
    if (pair) c.other[n] = lo;
    c.rows[n] = 6;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      c.w[n][r] = g.bt_info[6 * s + r];
      c.e[n][r] = e[r].v;
    }
    return;
  }
  const int s = f - 1 - g.B;
  gps_error(pose_row(g, g.gps_i[s]), g.gps_meas + 3 * s, e);
  c.rows[n] = 3;
  store_jacobian(e, 3, c.J[n][0]);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    c.w[n][r] = g.gps_info[3 * s + r];
    c.e[n][r] = e[r].v;
  }
}

// Block row `a` of H ((6 rows) x (6W)) and its 6 words of b.  The block's
// accumulators: q < 36W is H[6a + q / 6W][q % 6W], then b.
__global__ void __launch_bounds__(THREADS)
window_system(Graph g, int W, float* __restrict__ H, float* __restrict__ b) {
  __shared__ float acc[36 * MAX_WINDOW + 6];
  __shared__ Chunk c;
  const int a = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int count = *g.count;
  const int start = max(count - W, 0);
  const int cols = 6 * W, n_acc = 36 * W + 6;
  for (int q = tid; q < n_acc; q += THREADS) acc[q] = 0.0f;

  if (start + a < count) {       // an active window pose: sum its factors
    const int F = 1 + g.B + g.G;
    for (int base = 0; base < F; base += THREADS) {
      const int f = base + tid;
      const bool hit = f < F && touches(g, f, a, start);
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) c.warp_count[warp] = __popc(ballot);
      __syncthreads();
      int n = 0, pos = __popc(ballot & ((1u << lane) - 1u));
      for (int w = 0; w < THREADS / 32; ++w) {
        if (w < warp) pos += c.warp_count[w];
        n += c.warp_count[w];
      }
      if (hit) c.slot[pos] = f;      // the chunk's hits in slot order
      __syncthreads();
      if (n == 0) continue;
      if (tid < n) linearize(g, c.slot[tid], a, start, W, c, tid);
      __syncthreads();
      for (int q = tid; q < n_acc; q += THREADS) {
        float sum = acc[q];
        if (q < 36 * W) {
          const int i = q / cols, col = q - i * cols;
          const int cb = col / 6, j = col - 6 * cb;
          for (int k = 0; k < n; ++k) {
            const int o = cb == a ? 0 : (c.other[k] == cb ? 1 : -1);
            if (o < 0) continue;
            const float* Jp = c.J[k][0];
            const float* Jq = c.J[k][o];
            float s = 0.0f;
            for (int r = 0; r < c.rows[k]; ++r)
              s = s + c.w[k][r] * (Jp[r * 6 + i] * Jq[r * 6 + j]);
            sum = sum + s;
          }
        } else {
          const int i = q - 36 * W;
          for (int k = 0; k < n; ++k) {
            const float* Jp = c.J[k][0];
            float s = 0.0f;
            for (int r = 0; r < c.rows[k]; ++r)
              s = s + Jp[r * 6 + i] * (c.w[k][r] * c.e[k][r]);
            sum = sum - s;
          }
        }
        acc[q] = sum;
      }
      __syncthreads();
    }
    // the columns of window slots past `count` stay zero
    for (int q = tid; q < 36 * W; q += THREADS) {
      const int i = q / cols, cb = (q - i * cols) / 6;
      H[(size_t)(6 * a + i) * cols + (q - i * cols)] =
          start + cb < count ? acc[q] : 0.0f;
    }
    if (tid < 6) b[6 * a + tid] = acc[36 * W + tid];
  } else {                       // an idle slot: identity diagonal, zero b
    for (int q = tid; q < 36 * W; q += THREADS) {
      const int i = q / cols, col = q - i * cols;
      H[(size_t)(6 * a + i) * cols + col] = col == 6 * a + i ? 1.0f : 0.0f;
    }
    if (tid < 6) b[6 * a + tid] = 0.0f;
  }
}

}  // namespace

// One GN iteration's window system on `stream`: the graph's leaves (float32,
// int32 indices, one-byte masks; `count` a device int32), the window W
// (1..MAX_WINDOW), H of (6W)^2 words and b of 6W.  Reads nothing on the
// host, allocates nothing and does not synchronise; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a W or K it does not take.
extern "C" int lio_window_system(
    const float* poses, int K, const int* count, const float* prior_pose,
    const float* prior_info, const int* bt_i, const int* bt_j,
    const float* bt_meas, const float* bt_info, const unsigned char* bt_mask,
    int B, const int* gps_i, const float* gps_meas, const float* gps_info,
    const unsigned char* gps_mask, int G, int W, float* H, float* b,
    void* stream) {
  if (W < 1 || W > MAX_WINDOW || K < 1 || B < 0 || G < 0)
    return (int)cudaErrorInvalidValue;
  const Graph g{poses,   K,       count,   prior_pose, prior_info, bt_i,
                bt_j,    bt_meas, bt_info, bt_mask,    B,          gps_i,
                gps_meas, gps_info, gps_mask, G};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  window_system<<<W, THREADS, 0, s>>>(g, W, H, b);
  return (int)cudaGetLastError();
}
