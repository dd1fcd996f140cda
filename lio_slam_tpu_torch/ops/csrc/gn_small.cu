// The Gauss-Newton step's 6x6 linear algebra in one launch, for Hopper
// (sm_90a).
//
// Every pass of ops/registration.py:_gn_pass solves (AtA + 1e-6 I) dx = Atb,
// and its first pass also eigendecomposes AtA for the degeneracy projection
// (mapOptmization.cpp:1781-1808).  The plain version is utils/smallmat.py's
// cholesky_solve and eigh_jacobi, unrolled into scalar torch operations:
// about 6,400 launches on a first pass and 173 on every other one, each a
// dispatch on the host.  This kernel does the same operations in the same
// order in one launch, so its results are theirs bit for bit:
// - float32 throughout, built with --fmad=false (no product is fused into a
//   sum), IEEE division and square root; 1 / x is torch's reciprocal.  The
//   constants are the float32 roundings of the Python floats the torch
//   version passes (1e-6, 1e-30).  A + eps I adds +0 off the diagonal, as
//   the torch sum does (-0 becomes +0 there).
// - clamp(min=1e-30) hands a NaN back as it is, as torch.clamp does.
// - A Jacobi rotation updates rows p and q, then columns p and q of the
//   result, then V's columns.  The two halves of the matrix need not stay
//   symmetric in float32, so the whole matrix is kept.
// - The eigenvalues are placed as torch.argsort(stable=True) places them:
//   ascending, a NaN after every number, equal values (-0 with +0) in their
//   order.  Each value's place is counted from the others, so the thread
//   indexes no array at run time.
//
// What bounds it: latency, not bytes (42 words in, at most 48 out) or FLOP
// (about 15,000 on a first pass).  The eigensolve is a chain of 8 x 15
// dependent rotations, each behind two divisions and two square roots; the
// solve a chain of 6 square roots and 27 divisions.  So one thread does a
// system: the matrix, V and L sit in registers (every index is a
// compile-time constant once the loops over p, q, i and j unroll; the loop
// over the 8 sweeps stays a loop, which keeps the code 8 times shorter),
// and nothing goes through local, shared or device memory between two
// rotations.  The card sees one system at a time, and the order of the
// operations is what fixes the bits, so nothing is split across threads.

#include <cuda_runtime.h>

namespace {

constexpr int N = 6;
constexpr int SWEEPS = 8;                  // smallmat.eigh_jacobi's sweeps
constexpr float EPS = (float)1e-6;         // _gn_pass's Levenberg damping
constexpr float TINY = (float)1e-30;       // the clamp and the |apq| test

// torch.clamp(x, min=lo): a NaN comes back as it is (fmaxf would drop it)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// torch's ascending order: a NaN after every number
__device__ __forceinline__ bool sorts_before(float a, float b) {
  return a < b || (b != b && a == a);
}

// out[0:6] = dx; with EIGH also out[6:12] the eigenvalues ascending and
// out[12:48] the eigenvectors as columns, row-major.
template <bool EIGH>
__global__ void __launch_bounds__(1)
gn_small(const float* __restrict__ AtA, const float* __restrict__ Atb,
         float* __restrict__ out) {
  float A[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) A[i][j] = AtA[i * N + j];

  // cholesky_solve(AtA, Atb, eps=1e-6): L of A + eps I, then the forward
  // and the backward substitution
  float L[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[i][j] + (i == j ? EPS : 0.0f);
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      if (i == j)
        L[i][i] = sqrtf(clamp_min(s, TINY));
      else
        L[i][j] = s / L[j][j];
    }
  }
  float y[N], x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = Atb[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = x[i];
  if (!EIGH) return;

  // eigh_jacobi(AtA): cyclic Jacobi sweeps over the (p, q) pairs in order
  float V[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) V[i][j] = i == j ? 1.0f : 0.0f;
#pragma unroll 1
  for (int sweep = 0; sweep < SWEEPS; ++sweep) {
#pragma unroll
    for (int p = 0; p < N; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const float app = A[p][p], aqq = A[q][q], apq = A[p][q];
        const bool small = fabsf(apq) < TINY;
        const float theta = (aqq - app) / (2.0f * (small ? 1.0f : apq));
        const float sign = theta >= 0.0f ? 1.0f : -1.0f;
        float t = sign / (fabsf(theta) + sqrtf(theta * theta + 1.0f));
        t = small ? 0.0f : t;
        const float c = 1.0f / sqrtf(t * t + 1.0f);
        const float s = t * c;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float rp = A[p][j], rq = A[q][j];
          A[p][j] = c * rp - s * rq;
          A[q][j] = s * rp + c * rq;
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float cp = A[i][p], cq = A[i][q];
          A[i][p] = c * cp - s * cq;
          A[i][q] = s * cp + c * cq;
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float vp = V[i][p], vq = V[i][q];
          V[i][p] = c * vp - s * vq;
          V[i][q] = s * vp + c * vq;
        }
      }
    }
  }
  // the stable ascending sort: value i goes where the values before it in
  // the order, and its equals at smaller indices, end
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int place = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < i) place += !sorts_before(A[i][i], A[j][j]);
      if (j > i) place += sorts_before(A[j][j], A[i][i]);
    }
    out[N + place] = A[i][i];
#pragma unroll
    for (int r = 0; r < N; ++r) out[2 * N + r * N + place] = V[r][i];
  }
}

// The launch floor chip_smoke.py measures; the main path never runs it: the
// same one-thread launch, the 42 words read and written back where a first
// pass writes (Atb to dx's words, AtA to the eigenvectors'), no arithmetic.
__global__ void __launch_bounds__(1)
gn_small_floor(const float* __restrict__ AtA, const float* __restrict__ Atb,
               float* __restrict__ out) {
#pragma unroll
  for (int i = 0; i < N * N; ++i) out[2 * N + i] = AtA[i];
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = Atb[i];
}

}  // namespace

// One GN pass's linear algebra on `stream`: AtA (6x6 row-major) and Atb (6)
// in; out of 6 words, or 2 * 6 + 36 with the eigensolve (`eigh`).
// Allocates nothing and does not synchronise; returns cudaGetLastError().
extern "C" int lio_gn_small(const float* AtA, const float* Atb, int eigh,
                            float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (eigh)
    gn_small<true><<<1, 1, 0, s>>>(AtA, Atb, out);
  else
    gn_small<false><<<1, 1, 0, s>>>(AtA, Atb, out);
  return (int)cudaGetLastError();
}

// The launch floor on `stream`: out of 2 * 6 + 36 words, of which the
// floor writes dx's and the eigenvectors'.
extern "C" int lio_gn_small_floor(const float* AtA, const float* Atb,
                                  float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  gn_small_floor<<<1, 1, 0, s>>>(AtA, Atb, out);
  return (int)cudaGetLastError();
}
