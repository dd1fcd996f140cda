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
// What bounds it on this card: bytes, on paper.  At the main path's shapes
// (8192 points, 9 ids a point, a 32768 x 24 table of 12-byte slots) every
// input read once and every output written once is at most 9.8 MB, 2.9 us
// at 3.35 TB/s; the arithmetic (216 distances of 8 FLOP and a plane fit of
// about 300 FLOP a point, 17 MFLOP) is 0.25 us at 67 TFLOP/s.  What the
// kernel really waits for is latency: a chain of dependent trips to device
// memory (ids, then rows, then partials, ticket and the last block's reads),
// 21 MB of rows through L2 (each point reads its own nine), and a selection
// whose work is compares and selects, not FLOP.  So the design is about
// having every point's chain in flight at once on all 132 SMs, rows moved
// whole and coalesced, and few operations a candidate.
//
// lio_fused_corr (the kernel of the main path):
// - A group of LANES lanes works on one point, so a warp works on
//   32 / LANES points at a time and a block of WARPS warps on
//   BP = WARPS * 32 / LANES; a block walks batches of BP points.  At
//   LANES = 8, WARPS = 16 that is 128 blocks of 64 points for a scan of
//   8192: one block on each SM (a point in flight holds a 2.6 KB stage of
//   shared memory, 170 KB a block), every point of the scan in flight.
// - Every lane of a group loads the point, its mask bit and its 9 bucket
//   ids (one transaction a group, one round trip for all of them) and marks
//   a bucket skipped if it repeats an earlier offset's id or lies outside
//   [0, T), so a bad id never reads outside the table.  The TPU kernel adds
//   1e30 to a repeated bucket's candidates instead; either way they never
//   reach the 5-NN, because the offset-0 bucket alone holds C >= 5 slots.
//   A point that is masked out is not staged or ranked at all: it
//   contributes nothing whatever its neighbours are.
// - Rows come in whole.  The group copies the 9 rows of its point (C x 12 B
//   each, 288 B at C = 24) into the point's stage in shared memory with
//   16-byte cp.async (4-byte where C is not a multiple of 4), neighbouring
//   lanes on neighbouring addresses.  A skipped bucket is not copied: its
//   stage row is filled with empty slots.  The TPU's planar candidate copy
//   (gather_planar) exists only to fill VMEM lanes and has no counterpart.
// - Lane l of the group takes rows l, l + LANES, ... of the R = O*C (a
//   3-float stride in shared memory; the stages' stride is chosen so that a
//   warp's 32 lanes fall on 32 banks) and keeps its best 5 by (d, row).  A
//   candidate enters a lane's list only if strictly nearer than the lane's
//   fifth, and moves up only past strictly farther ones: a lane meets its
//   rows in ascending order, so ties go to the lowest row as with
//   jnp.argmin.  Most slots of a row are empty, so most candidates cost the
//   distance and that one comparison.  d is the expression of the plain
//   version, so the five neighbours are the same five.  An empty slot
//   (d = inf) and a non-finite query (d = NaN) never enter, as in the first
//   version of this kernel.
// - Five rounds of a group-wide minimum over the lanes' heads merge the
//   lists: xor shuffles of a 64-bit key (bits of d, then the row; d >= 0, so
//   the float's bits order like the float).  The group's first lane keeps
//   each winner's distance and coordinates in registers.
// - That lane then runs the plane fit, the gates and the Jacobian row
//   (plane_terms, the arithmetic of registration.find_correspondences with
//   acosf in place of the TPU kernel's Newton iteration, which only works
//   around Mosaic's missing acos) and adds the point's 30 terms to its
//   registers.  Only 32 / LANES lanes of a warp are busy in the fit, but no
//   barrier stands between ranking and fit, and the warps' fits overlap
//   other warps' copies and ranking.
// - One launch, a deterministic sum, outputs written whole: the groups'
//   first lanes are summed by shuffles in a fixed tree, warps in order in
//   shared memory, and each block writes 30 partials.  The last block to
//   finish (an integer ticket after __threadfence; no float atomics
//   anywhere) sums the partials in a fixed order and writes the final
//   outputs: the full symmetric 6x6 AtA, Atb, the two weight sums and
//   n_inliers as int32.  It then resets the ticket, so the scratch buffer
//   serves the next call on the same stream.  A second launch would add its
//   own launch latency to a kernel of some 15 us; the ticket needs the
//   scratch buffer to be private to a stream, which the wrapper sees to.
//   Repeated launches are bit-identical.
// - R, t and dR/dth come from pose6 on the device (one warp of a block, its
//   six sines and cosines on six lanes, while the other warps load ids): the
//   wrapper never syncs.
// - Built without --use_fast_math and with --fmad=false so the arithmetic
//   rounds like the plain PyTorch version's separate ops.
//
// Tried on the card and left (NVIDIA H100 80GB HBM3, 700 W; device ms a call
// of builds of this source with the variant in place, the first version
// 0.045 in the same runs; PERF.md has the table):
// - The whole warp ranking one point after another (4, 8 or 16 points a
//   warp, the next point's rows prefetched through a ring of 2 stages, every
//   candidate through a five-step 64-bit min/max insertion, two redux.sync
//   minima a merge round, the fit on one lane a point): 0.025 / 0.035
//   / 0.063 ms.  A warp's points are a serial chain.
// - Thread t of a block as the owner of point t (ids through shared memory,
//   a block barrier, ranking, a barrier, then the fit with all lanes of one
//   or two warps busy): 0.017 ms.  The two barriers and the fit of two
//   warps while fourteen wait cost more than the idle lanes save.
// - A ring of 2 or 4 points a group (the later points' rows travel while the
//   first is ranked): slower at equal points in flight (0.018 against 0.017
//   ms), because it halves the warps that rank.  One commit group a bucket
//   row, ranking a row as it lands: no gain (0.015 ms either way).
// - The merge as two redux.sync minima a round on the group's mask: slower
//   than shuffles for groups under a warp (0.0160 against 0.0143 ms).
// - Loading point and ids before the mask bit is known (one round trip
//   instead of two for an unmasked point): 0.0148 against 0.0145 ms.
// - A run-time stride in the last block's loop over the partials: 0.0160
//   against 0.0144 ms (0.0206 against 0.0151 at 8 warps).  Those loads are
//   the kernel's last trip to device memory and must be in flight together.
// - LANES 4 / 8 / 16 / 32 (at 8, 16, 16, 16 warps): 0.0175 / 0.0145 /
//   0.0219 / 0.0362 ms; WARPS 4 / 8 / 16 at LANES 8: 0.0205 / 0.0157 /
//   0.0145 ms.
//
// lio_fused_corr_v1 is the first version of this kernel (one thread a
// point, 4-byte loads scattered over 32 rows a warp, a second launch that
// sums 64 blocks serially).  It stays as the yardstick the redesign is
// timed against, in turns in one run, and is not on the main path.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int KNN = 5;
constexpr int MAX_O = 9;
constexpr int N_OUT = 30;        // AtA upper triangle (21), Atb (6), 3 sums
constexpr int THREADS_V1 = 128;  // must match fused_corr.THREADS_V1
constexpr float BIG_D2 = 3.0e38f;
constexpr float VALID_MAX = 1e10f;
constexpr float EMPTY_SLOT = 1e30f;  // as voxel_grid fills an empty slot
constexpr float TWO_PI_3 = 2.0943951023931953f;

constexpr int LANES = 8;         // lanes that rank one point together
constexpr int WARPS = 16;        // warps a block
constexpr int PPW = 32 / LANES;              // points a warp ranks at a time
constexpr int MAX_BLOCKS = 1024;
constexpr size_t MAX_STAGE_BYTES = 200 * 1024;   // of an SM's 227 KB
constexpr int SCRATCH_HEAD = 4;  // floats before the partials: the ticket
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NO_KEY = ~0ull;

// R = Rz(yaw) Ry(pitch) Rx(roll) and dR/dth as [i][j][k] (row-major 27), from
// the sines and cosines of roll, pitch and yaw.
__device__ void pose_tables_from(float sr, float sp, float sy, float cr, float cp,
                                 float cy, const float* pose6, float* R,
                                 float* t, float* dR) {
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

__device__ void pose_tables(const float* pose6, float* R, float* t,
                            float* dR) {
  const float r = pose6[0], p = pose6[1], y = pose6[2];
  pose_tables_from(sinf(r), sinf(p), sinf(y), cosf(r), cosf(p), cosf(y), pose6,
                   R, t, dR);
}

// The same by one warp: the six sines and cosines on six lanes at once.
__device__ __forceinline__ void pose_tables_warp(const float* pose6, float* R,
                                                 float* t, float* dR, int lane) {
  const float angle = pose6[lane % 3];
  const float v = (lane % 6) < 3 ? sinf(angle) : cosf(angle);
  const float sr = __shfl_sync(FULL, v, 0), sp = __shfl_sync(FULL, v, 1),
              sy = __shfl_sync(FULL, v, 2), cr = __shfl_sync(FULL, v, 3),
              cp = __shfl_sync(FULL, v, 4), cy = __shfl_sync(FULL, v, 5);
  if (lane == 0) pose_tables_from(sr, sp, sy, cr, cp, cy, pose6, R, t, dR);
}

__device__ __forceinline__ float sq(float v) { return v * v; }

// Plane fit, gates and Jacobian row of one point from its five neighbours
// (nearest first; BIG_D2 and zeros where there is none).  Adds the point's
// 30 terms to acc if it is an inlier.
__device__ __forceinline__ void plane_terms(
    const float* bd, const float* bx, const float* by, const float* bz,
    float px, float py, float pz, float qx, float qy, float qz, bool in_mask,
    const float* dR, float nn_radius, float plane_dist_thresh,
    float weight_floor, float* acc) {
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
  const bool valid = in_mask && nn_ok && plane_ok && safe && all_valid &&
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
    for (int j = i; j < 6; ++j) acc[idx++] += (J[i] * w) * J[j];
  }
  const float wp = w * pd2;
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += -(J[i] * wp);
  acc[27] += 1.0f;
  acc[28] += s;
  acc[29] += s * fabsf(pd2);
}

// ---------------------------------------------------------------------------
// the kernel of the main path
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The group's LANES lanes rank the staged candidates of one point (R rows of
// 3 floats at `rows`); lane 0 of the group gets the five nearest, nearest
// first, in bd / bx / by / bz, which the caller set to (BIG_D2, 0, 0, 0).
__device__ __forceinline__ void rank_point(const float* rows, int R, float ux,
                                           float uy, float uz, int l,
                                           unsigned gmask, float* bd, float* bx,
                                           float* by, float* bz) {
  // this lane's best 5 of rows l, l + LANES, ..., ascending by (d, row).  A
  // candidate enters only if strictly nearer than the lane's fifth and moves
  // up only past strictly farther ones: rows come in ascending order, so at
  // equal d the earlier row stays ahead.  An empty slot (d = inf) or a
  // non-finite query (d = NaN) fails the first comparison.
  float d0 = BIG_D2, d1 = BIG_D2, d2 = BIG_D2, d3 = BIG_D2, d4 = BIG_D2;
  int r0 = -1, r1 = -1, r2 = -1, r3 = -1, r4 = -1;
  const float* p = rows + 3 * l;
#pragma unroll 3
  for (int r = l; r < R; r += LANES, p += 3 * LANES) {
    const float d = (sq(p[0] - ux) + sq(p[1] - uy)) + sq(p[2] - uz);
    if (d < d4) {
      d4 = d; r4 = r;
      bool up;
      float td; int tr;
      up = d4 < d3; td = d3; tr = r3;
      d3 = up ? d4 : d3; r3 = up ? r4 : r3; d4 = up ? td : d4; r4 = up ? tr : r4;
      up = d3 < d2; td = d2; tr = r2;
      d2 = up ? d3 : d2; r2 = up ? r3 : r2; d3 = up ? td : d3; r3 = up ? tr : r3;
      up = d2 < d1; td = d1; tr = r1;
      d1 = up ? d2 : d1; r1 = up ? r2 : r1; d2 = up ? td : d2; r2 = up ? tr : r2;
      up = d1 < d0; td = d0; tr = r0;
      d0 = up ? d1 : d0; r0 = up ? r1 : r0; d1 = up ? td : d1; r1 = up ? tr : r1;
    }
  }

  // merge: five times the group's least (d, row) among the lanes' heads, as
  // a 64-bit key (d >= 0, so the float's bits order like the float)
#pragma unroll
  for (int j = 0; j < KNN; ++j) {
    const unsigned long long head =
        r0 < 0 ? NO_KEY
               : (((unsigned long long)__float_as_uint(d0) << 32) | (unsigned)r0);
    unsigned long long m = head;
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1)
      m = min(m, __shfl_xor_sync(gmask, m, off));
    if (head == m) {
      d0 = d1; d1 = d2; d2 = d3; d3 = d4; d4 = BIG_D2;
      r0 = r1; r1 = r2; r2 = r3; r3 = r4; r4 = -1;
    }
    if (l == 0 && m != NO_KEY) {
      const float* w = rows + 3 * (unsigned)m;
      bd[j] = __uint_as_float((unsigned)(m >> 32));
      bx[j] = w[0]; by[j] = w[1]; bz[j] = w[2];
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
fused_corr_groups(const float* __restrict__ table, int T, int C,
                  const int* __restrict__ hh, int O,
                  const float* __restrict__ scan,
                  const unsigned char* __restrict__ mask, int N,
                  const float* __restrict__ pose6, float nn_radius,
                  float plane_dist_thresh, float weight_floor,
                  int stage_floats, int vec16_flag, unsigned* ticket,
                  float* partials, float* __restrict__ out) {
  extern __shared__ __align__(16) float stage_mem[];   // a stage a group
  __shared__ float sR[9], st[3], sdR[27];
  __shared__ float sums[WARPS][32];
  __shared__ bool is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;           // WARPS, or fewer for wide rows
  const int BP = warps * PPW;                  // points the block ranks at a time
  const int l = lane % LANES;                  // lane in its group
  const int group = warp * PPW + lane / LANES; // the block point it ranks
  const unsigned gmask = ((1u << LANES) - 1u) << (lane / LANES * LANES);
  const bool vec16 = vec16_flag != 0;
  const int R = O * C, row_floats = 3 * C;
  float* rows = stage_mem + (size_t)group * stage_floats;

  // the last warp makes the pose tables while the others load ids and start
  // their copies
  if (warp == warps - 1) pose_tables_warp(pose6, sR, st, sdR, lane);

  float acc[N_OUT];
#pragma unroll
  for (int i = 0; i < N_OUT; ++i) acc[i] = 0.f;

  const int n_batches = (N + BP - 1) / BP;
  bool first = true;
  for (int batch = blockIdx.x; batch < n_batches; batch += gridDim.x) {
    // every lane of the group loads the point and its ids (one transaction a
    // group) and marks the skipped buckets; a masked-out point is dead
    const int n = batch * BP + group;
    float px = 0.f, py = 0.f, pz = 0.f;
    unsigned live = 0;            // bit o: bucket o is copied and ranked
    if (n < N && mask[n] != 0) {
      px = scan[3 * n + 0]; py = scan[3 * n + 1]; pz = scan[3 * n + 2];
      int h[MAX_O];
#pragma unroll
      for (int o = 0; o < MAX_O; ++o) h[o] = (o < O) ? hh[(size_t)o * N + n] : -1;
#pragma unroll
      for (int o = 0; o < MAX_O; ++o) {
        // an id outside [0, T) reads as an empty bucket, never out of bounds
        bool dup = h[o] < 0 || h[o] >= T;
#pragma unroll
        for (int p = 0; p < MAX_O; ++p)
          if (p < o && h[p] == h[o]) dup = true;
        if (!dup) live |= 1u << o;
      }
      if (live != 0) {
#pragma unroll
        for (int o = 0; o < MAX_O; ++o) {
          if (o >= O) break;
          float* dst = rows + o * row_floats;
          if (!((live >> o) & 1u)) {
            // a skipped bucket ranks as an empty one: slots no query is near
            for (int j = l; j < row_floats; j += LANES) dst[j] = EMPTY_SLOT;
            continue;
          }
          const float* src = table + (size_t)h[o] * row_floats;
          if (vec16) {
            for (int j = 4 * l; j < row_floats; j += 4 * LANES)
              cp_async16(dst + j, src + j);
          } else {
            for (int j = l; j < row_floats; j += LANES) cp_async4(dst + j, src + j);
          }
        }
      }
    }
    if (first) {
      __syncthreads();            // the pose tables
      first = false;
    }
    if (live != 0) {
      const float qx = (sR[0] * px + sR[1] * py) + sR[2] * pz + st[0];
      const float qy = (sR[3] * px + sR[4] * py) + sR[5] * pz + st[1];
      const float qz = (sR[6] * px + sR[7] * py) + sR[8] * pz + st[2];
      float bd[KNN], bx[KNN], by[KNN], bz[KNN];
#pragma unroll
      for (int j = 0; j < KNN; ++j) { bd[j] = BIG_D2; bx[j] = by[j] = bz[j] = 0.f; }
      cp_async_wait_all();        // this lane's copies have landed
      __syncwarp(gmask);          // ... and those of the group's other lanes
      rank_point(rows, R, qx, qy, qz, l, gmask, bd, bx, by, bz);
      __syncwarp(gmask);          // the stage is free for the next batch
      if (l == 0)
        plane_terms(bd, bx, by, bz, px, py, pz, qx, qy, qz, true, sdR, nn_radius,
                    plane_dist_thresh, weight_floor, acc);
    }
  }

  // the groups' first lanes in a fixed tree, the warps in order
#pragma unroll
  for (int i = 0; i < N_OUT; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off >= LANES; off >>= 1)
      v += __shfl_down_sync(FULL, v, off);
    if (lane == 0) sums[warp][i] = v;
  }
  __syncthreads();
  if (tid < N_OUT) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (w < warps) v += sums[w][tid];
    partials[blockIdx.x * N_OUT + tid] = v;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;

  // the last block: every block's partials are visible.  Blocks w,
  // w + WARPS, ... are summed in order into row w of `sums` (by warp w; where
  // the block has fewer warps than WARPS, a warp takes several rows), then
  // the rows are summed in order.  The stride is a constant so that the
  // loads unroll: they are the kernel's last trip to device memory.
  __threadfence();
  for (int w = warp; w < WARPS; w += warps) {
    float v = 0.f;
    if (lane < N_OUT) {
#pragma unroll 8
      for (int b = w; b < (int)gridDim.x; b += WARPS)
        v += __ldcg(partials + b * N_OUT + lane);
    }
    sums[w][lane] = v;
  }
  __syncthreads();
  if (tid < N_OUT) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += sums[w][tid];
    if (tid < 21) {
      // packed upper triangle, row-major: index tid is (a, b) with a <= b
      int a = 0, rest = tid;
      while (rest >= 6 - a) { rest -= 6 - a; ++a; }
      const int b = a + rest;
      out[a * 6 + b] = total;
      out[b * 6 + a] = total;
    } else if (tid < 27) {
      out[36 + (tid - 21)] = total;
    } else if (tid == 27) {
      reinterpret_cast<int*>(out)[44] = (int)total;   // a count, exact to 2^24
    } else {
      out[42 + (tid - 28)] = total;
    }
  }
  if (tid == 0) *ticket = 0u;
}

// ---------------------------------------------------------------------------
// the first version, kept as the yardstick
// ---------------------------------------------------------------------------

// One thread a point: the top 5 live in registers, kept sorted by insertion;
// a candidate replaces the 5th only if strictly nearer, and rows are visited
// in order o*C + c.
__device__ void point_terms_v1(const float* __restrict__ table, int T, int C,
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
  plane_terms(bd, bx, by, bz, px, py, pz, qx, qy, qz, mask[n] != 0, dR,
              nn_radius, plane_dist_thresh, weight_floor, acc);
}

__global__ void __launch_bounds__(THREADS_V1)
fused_corr_points_v1(const float* __restrict__ table, int T, int C,
                     const int* __restrict__ hh, int O,
                     const float* __restrict__ scan,
                     const unsigned char* __restrict__ mask, int N,
                     const float* __restrict__ pose6, float nn_radius,
                     float plane_dist_thresh, float weight_floor,
                     float* __restrict__ partials) {
  __shared__ float sR[9], st[3], sdR[27];
  __shared__ float warp_sums[THREADS_V1 / 32][N_OUT];
  if (threadIdx.x == 0) pose_tables(pose6, sR, st, sdR);
  __syncthreads();

  float acc[N_OUT];
#pragma unroll
  for (int i = 0; i < N_OUT; ++i) acc[i] = 0.f;
  const int n = blockIdx.x * THREADS_V1 + threadIdx.x;
  if (n < N)
    point_terms_v1(table, T, C, hh, O, scan, mask, N, n, sR, st, sdR, nn_radius,
                   plane_dist_thresh, weight_floor, acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N_OUT; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(FULL, v, off);
    if (lane == 0) warp_sums[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < N_OUT) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS_V1 / 32; ++w) v += warp_sums[w][threadIdx.x];
    partials[blockIdx.x * N_OUT + threadIdx.x] = v;
  }
}

__global__ void fused_corr_finalize_v1(const float* __restrict__ partials,
                                       int blocks, float* __restrict__ out) {
  const int i = threadIdx.x;
  if (i >= N_OUT) return;
  float v = 0.f;
  for (int b = 0; b < blocks; ++b) v += partials[b * N_OUT + i];
  out[i] = v;
}

}  // namespace

// Floats of scratch lio_fused_corr needs: the ticket, then the blocks'
// partials.  The buffer starts zeroed and belongs to one stream.
extern "C" int lio_fused_corr_scratch_floats() {
  return SCRATCH_HEAD + MAX_BLOCKS * N_OUT;
}

// Launches the kernel on `stream`; returns the cudaError_t (0 = ok).  `out`
// takes 45 words: AtA (6x6, symmetric), Atb (6), sum s, sum s|pd2| as
// floats, then n_inliers as an int32.
extern "C" int lio_fused_corr(const float* table, int T, int C, const int* hh,
                              int O, const float* scan,
                              const unsigned char* mask, int N,
                              const float* pose6, float nn_radius,
                              float plane_dist_thresh, float weight_floor,
                              float* scratch, int scratch_floats, float* out,
                              void* stream) {
  if (O < 1 || O > MAX_O || T < 1 || C < 1 || N < 1 || N > (1 << 24) ||
      scratch_floats < SCRATCH_HEAD + MAX_BLOCKS * N_OUT ||
      (reinterpret_cast<uintptr_t>(table) & 15u) != 0 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  // a point's stage: its O rows, 16-byte aligned, at a stride of 3 * LANES
  // banks so that the 32 lanes of a warp, 3 floats apart within a group,
  // read 32 different banks
  int stage_floats = (O * C * 3 + 3) & ~3;
  while (stage_floats % 32 != (3 * LANES) % 32) stage_floats += 4;
  // WARPS warps a block, fewer where the rows are so wide that their stages
  // would not fit an SM's shared memory
  int warps = WARPS;
  while (warps > 1 &&
         (size_t)warps * PPW * stage_floats * sizeof(float) > MAX_STAGE_BYTES)
    warps /= 2;
  const size_t smem = (size_t)warps * PPW * stage_floats * sizeof(float);
  if (smem > MAX_STAGE_BYTES) return (int)cudaErrorInvalidValue;
  const int n_batches = (N + warps * PPW - 1) / (warps * PPW);
  const int blocks = n_batches < MAX_BLOCKS ? n_batches : MAX_BLOCKS;
  // above 48 KB a kernel has to be granted its dynamic shared memory, once a
  // device: the current one, which the wrapper makes the table's.  Host
  // threads take turns from the grant to the launch.
  static std::mutex launching;
  static size_t granted[64] = {0};
  std::lock_guard<std::mutex> turn(launching);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidValue;
  if (smem > granted[device]) {
    err = cudaFuncSetAttribute(fused_corr_groups,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted[device] = smem;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_corr_groups<<<blocks, warps * 32, smem, s>>>(
      table, T, C, hh, O, scan, mask, N, pose6, nn_radius, plane_dist_thresh,
      weight_floor, stage_floats, C % 4 == 0, reinterpret_cast<unsigned*>(scratch),
      scratch + SCRATCH_HEAD, out);
  return (int)cudaGetLastError();
}

// The first version: two launches on `stream`; `out` takes the 30 packed sums
// (AtA upper triangle row-major, Atb, n_inliers, sum s, sum s|pd2|).
extern "C" int lio_fused_corr_v1(const float* table, int T, int C, const int* hh,
                                 int O, const float* scan,
                                 const unsigned char* mask, int N,
                                 const float* pose6, float nn_radius,
                                 float plane_dist_thresh, float weight_floor,
                                 float* partials, int blocks, float* out,
                                 void* stream) {
  if (O < 1 || O > MAX_O || T < 1 || C < 1 || N < 1 ||
      blocks != (N + THREADS_V1 - 1) / THREADS_V1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_corr_points_v1<<<blocks, THREADS_V1, 0, s>>>(
      table, T, C, hh, O, scan, mask, N, pose6, nn_radius, plane_dist_thresh,
      weight_floor, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_corr_finalize_v1<<<1, 32, 0, s>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}
