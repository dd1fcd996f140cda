// Fused correspondence + normal-equation kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lio_slam_tpu/ops/fused_corr.py:_make_kernel
// (launched by fused_ne_from_candidates).  Per scan point at pose6: squared
// distances to the candidates of the O buckets the grid's halo layout has a
// point scan (C slots each; O = 27 for "none", 9 for "z", 3 for "xy", 1 for
// "full"), duplicate buckets skipped, 5-NN, covariance plane fit with
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
// - The kernel is a template on O, one instantiation a layout (O = 1, 3, 9,
//   27); the launcher refuses any other O.  At O <= 9 a point's ids live in
//   registers (h[O]), the duplicate check is unrolled whole (O(O-1)/2
//   compares, 36 at O = 9) and the point's O rows are staged whole: O * C * 3
//   floats, 2.6 KB at z/24 and xy/72, 1.5 KB at full/128.
// - At O = 27 (halo "none") the whole stage would be 7.8 KB a point at
//   C = 24: the launcher's halving of the warps left 4 warps, 16 points a
//   block and one block an SM, so 512 blocks ran in four waves on a quarter
//   of the lanes (0.105 ms a call against z's 0.014 on an H100, PERF.md).
//   So the rows stream through a stage of CHUNK_O = 9 offsets, the stage of
//   z: three chunks, each staged, ranked into the lanes' best 5 (which
//   carry over, rows keeping their global index, a lane meeting its rows in
//   ascending order across the chunks) and freed; the five merge rounds
//   run once, after the last chunk, and lane 0 reads the winners'
//   coordinates back from the table (row o * C + slot, bucket id of offset
//   o), all five loads in flight together.  The 27 ids go to shared memory
//   behind the stage (27 registers less than h[27]): lane l loads offsets
//   l, l + LANES, ..., checks them against the earlier ids there and the
//   group ORs the live bits.  That gives 16 warps and 64 points a block
//   (178 KB at C = 24), 128 blocks, every point of an 8192 scan in flight in
//   one wave, as at z.  The other instantiations keep their code path (a
//   compile-time branch on O).
// - At O <= 3 (halo "xy" and "full", rows of 72 and 128 slots) a row is
//   wide and the grid fills it as a prefix: voxel_grid._insert_core writes
//   slot (counts + rank) % C and caps counts at C, so every slot at or past
//   counts[h] holds SENTINEL.  The wrapper passes the grid's counts; the
//   lanes read counts[h] with the ids, copy only each row's filled prefix
//   (16-byte cp.async rounded up to whole 16-byte units; the floats past
//   the prefix are empty slots and are never ranked) and rank only that
//   prefix, row by row in ascending order.  The five nearest by (d, row)
//   are then those of the whole rows, bit for bit: a SENTINEL is above
//   VALID_MAX from any query of the map's extent, so where one would have
//   been among the five the point fails all_valid either way.  A skipped
//   bucket is neither copied nor ranked, a point with no filled slot is
//   dead, and without counts (a table made by hand) every slot of a live
//   row is filled.  At O = 9 and 27 counts is not read.
// - What bounds it, measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6,
//   tools/fused_corr_study.py and chip_smoke.py phase 20 (a)-(b)): the
//   launch floor,
//   the same grid, block, dynamic shared memory and scratch running only
//   the fixed chain (pose tables, point, mask bit and ids, partials,
//   ticket, the last block's sum; lio_fused_corr_floor), is 0.0045 ms warm
//   at xy/72 and full/128 (0.0046 at z/24, 0.0053 at none/24), a third of
//   each call.  Past it the time follows the bytes a point stages (2.6 KB
//   at xy and z, 1.5 KB at full, 7.8 KB at none): a dependent chain of
//   trips each point of the one wave waits on, not the card's bandwidth.
//   On phase 2's scene the rows a point reads are 84 % (xy) and 92 %
//   (full) filled, so the prefix saves what the counts trip costs: the
//   design times 0.0137 / 0.0108 ms warm against 0.0133-0.0135 / 0.0109
//   for whole rows copied and ranked (the earlier design) in the same
//   call.  On the layout missions' maps (phase 20 (b), the first launch of
//   scans 1-39) a point's rows are 25-67 % filled at xy and 41-90 % at
//   full, and a launch with counts takes 0.84-0.97 (xy) and 0.92-0.995
//   (full) of the same build's on whole rows, the least on the sparse
//   maps of the first scans.
// - Every lane of a group loads the point, its mask bit and its O bucket
//   ids (one transaction a group, one round trip for all of them) and marks
//   a bucket skipped if it repeats an earlier offset's id or lies outside
//   [0, T), so a bad id never reads outside the table.  The TPU kernel adds
//   1e30 to a repeated bucket's candidates instead; either way they never
//   reach the 5-NN, because the offset-0 bucket alone holds C >= 5 slots
//   (the launcher refuses C < 5).
//   A point that is masked out is not staged or ranked at all: it
//   contributes nothing whatever its neighbours are.
// - Rows come in whole.  The group copies the O rows of its point (C x 12 B
//   each, 288 B at C = 24; at O = 27 a chunk's 9) into the point's stage in
//   shared memory with 16-byte cp.async (4-byte where C is not a multiple
//   of 4), neighbouring lanes on neighbouring addresses; at O <= 3 only the
//   filled prefix.  A skipped bucket is not copied: its stage row is filled
//   with empty slots (at O <= 3 it is not ranked either).  The TPU's planar candidate copy
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
//   (d = inf) and a non-finite query (d = NaN) never enter.
// - Five rounds of a group-wide minimum over the lanes' heads merge the
//   lists: xor shuffles of a 64-bit key (bits of d, then the row; d >= 0, so
//   the float's bits order like the float).  The group's first lane keeps
//   each winner's distance and row, and reads its coordinates from the
//   stage (at O = 27 from the table) into registers.
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
// of builds of this source with the variant in place, 0.0145 as it stands
// in the same runs; PERF.md has the table):
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
// - O = 27 (none/24) staged whole, 4 warps a block, four waves of blocks:
//   0.1044-0.1051 ms warm, 0.1211-0.1216 with a cold L2; streamed in three
//   9-offset chunks at 16 warps, one wave: 0.0262-0.0263 / 0.0283-0.0285 ms
//   in the same call, where z/24, xy/72 and full/128 kept their times
//   within 2 % (PERF.md).  A ring of two chunk stages (the next chunk in
//   flight while one is ranked) was not tried: two 2.6 KB stages a point
//   halve the warps again, which the ring of points above showed to lose
//   on z.
// - At O <= 3 (xy/72 / full/128, device ms warm; the earlier whole-row
//   design 0.0133-0.0137 / 0.0109 in the same calls;
//   tools/fused_corr_study.py, PERF.md):
//   * One bulk async copy a row (cp.async.bulk.shared::cluster.global.
//     mbarrier::complete_tx::bytes, issued by the group's first lane onto
//     the group's mbarrier, expect_tx of the group's bytes, every lane
//     waiting on the phase parity): 0.0205-0.0214 / 0.0171-0.0176.  The
//     same without the async-proxy fence, without the barrier-init fence,
//     with a 32 ns back-off between polls: 0.0205-0.0210 / 0.0171-0.0174;
//     the first lane polling alone, the others at a group barrier: 0.0271
//     / 0.0231; whole rows copied in bulk before the counts are read:
//     0.0144-0.0160 / 0.0133-0.0139, and 0.0211-0.0215 / 0.0171-0.0177
//     without counts (a group polls its barrier as soon as the copy is
//     issued).  The copy engine's latency for copies of 0.3-1.5 KB loses to
//     the lanes' cp.async, which has every lane's loads in flight at once.
//   * Whole rows copied by the lanes before the counts are read (the
//     counts' trip hidden behind the copies), ranked to the prefix: 0.0146
//     / 0.0113-0.0116.
//   * The filled slots walked as one flat index across the rows (a row
//     found by two compares a candidate) and copied the same way: 0.0143 /
//     0.0110, against 0.0137-0.0138 / 0.0108 row by row.
//   * LANES / WARPS 4/8, 4/16, 8/8, 16/8, 16/16: 0.0162 / 0.0121, 0.0161 /
//     0.0150, 0.0149 / 0.0116, 0.0204 / 0.0172, 0.0191 / 0.0159 against
//     8/16's 0.0137 / 0.0108 (4 lanes halve the warps where the stages do
//     not fit; 16 lanes double the merge rounds' shuffles and the lanes idle
//     in the fit).
//   * Sharing rows between a block's points (each row copied once for all
//     the points of the block that read it) was not built: staging fewer
//     bytes (the prefix, 8-16 % fewer on phase 2's scene) moved the time
//     by under 1 % there, and 75 % fewer (xy, the missions' first scans)
//     by 10-16 %.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int KNN = 5;
constexpr int N_OUT = 30;        // AtA upper triangle (21), Atb (6), 3 sums
constexpr float BIG_D2 = 3.0e38f;
constexpr float VALID_MAX = 1e10f;
constexpr float EMPTY_SLOT = 1e30f;  // as voxel_grid fills an empty slot
constexpr float TWO_PI_3 = 2.0943951023931953f;

constexpr int LANES = 8;         // lanes that rank one point together
constexpr int WARPS = 16;        // warps a block
constexpr int PPW = 32 / LANES;              // points a warp ranks at a time
// at O <= WIDE_O (halo "xy" and "full") each row's filled prefix is copied
// and ranked
constexpr int WIDE_O = 3;
// offsets a point's stage holds: above it (O = 27) the rows stream through
// the stage in chunks of CHUNK_O offsets
constexpr int CHUNK_O = 9;
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

// By one warp: the six sines and cosines on six lanes at once.
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

// One bucket row of a point into its stage: C slots of 3 floats, copied
// with cp.async by the group's lanes (16 bytes each where C is a multiple
// of 4), or, for a skipped bucket, filled with empty slots.
__device__ __forceinline__ void stage_row(float* dst, const float* table,
                                          int h, bool live, int row_floats,
                                          int l, bool vec16) {
  if (!live) {
    // a skipped bucket ranks as an empty one: slots no query is near
    for (int j = l; j < row_floats; j += LANES) dst[j] = EMPTY_SLOT;
    return;
  }
  const float* src = table + (size_t)h * row_floats;
  if (vec16) {
    for (int j = 4 * l; j < row_floats; j += 4 * LANES) cp_async16(dst + j, src + j);
  } else {
    for (int j = l; j < row_floats; j += LANES) cp_async4(dst + j, src + j);
  }
}

// The filled prefixes of a point's O <= WIDE_O rows into its stage (row o
// at o * row_floats): fill[o] slots of bucket h[o], none for a skipped
// bucket (fill 0), copied by the group's lanes with cp.async, 16 bytes
// each where rows are 16-byte aligned (vec16: the prefix rounded up to
// 16 bytes; the slots past it are empty ones and are never ranked), else
// 4.
template <int O>
__device__ __forceinline__ void stage_filled(float* rows, const float* table,
                                             const int* h, const int* fill,
                                             int row_floats, int l, bool vec16) {
#pragma unroll
  for (int o = 0; o < O; ++o) {
    const float* src = table + (size_t)h[o] * row_floats;
    float* dst = rows + o * row_floats;
    if (vec16) {
      const int floats = 4 * ((3 * fill[o] + 3) / 4);
      for (int j = 4 * l; j < floats; j += 4 * LANES) cp_async16(dst + j, src + j);
    } else {
      for (int j = l; j < 3 * fill[o]; j += LANES) cp_async4(dst + j, src + j);
    }
  }
}

// A lane's best 5 candidates, ascending by (d, row); row -1 is none.
struct Best5 {
  float d0, d1, d2, d3, d4;
  int r0, r1, r2, r3, r4;
};

__device__ __forceinline__ void best5_init(Best5& b) {
  b.d0 = b.d1 = b.d2 = b.d3 = b.d4 = BIG_D2;
  b.r0 = b.r1 = b.r2 = b.r3 = b.r4 = -1;
}

// This lane's share of `n` staged rows (3 floats each at `rows`, row r of
// the stage being candidate row0 + r of the point): rows l, l + LANES, ...
// into its best 5.  A candidate enters only if strictly nearer than the
// lane's fifth and moves up only past strictly farther ones: a lane meets
// its rows in ascending order (across the chunks of a streamed stage too),
// so at equal d the earlier row stays ahead.  An empty slot (d = inf) or a
// non-finite query (d = NaN) fails the first comparison.
__device__ __forceinline__ void rank_rows(const float* rows, int n, int row0,
                                          float ux, float uy, float uz, int l,
                                          Best5& b) {
  const float* p = rows + 3 * l;
#pragma unroll 3
  for (int r = l; r < n; r += LANES, p += 3 * LANES) {
    const float d = (sq(p[0] - ux) + sq(p[1] - uy)) + sq(p[2] - uz);
    if (d < b.d4) {
      b.d4 = d; b.r4 = row0 + r;
      bool up;
      float td; int tr;
      up = b.d4 < b.d3; td = b.d3; tr = b.r3;
      b.d3 = up ? b.d4 : b.d3; b.r3 = up ? b.r4 : b.r3;
      b.d4 = up ? td : b.d4; b.r4 = up ? tr : b.r4;
      up = b.d3 < b.d2; td = b.d2; tr = b.r2;
      b.d2 = up ? b.d3 : b.d2; b.r2 = up ? b.r3 : b.r2;
      b.d3 = up ? td : b.d3; b.r3 = up ? tr : b.r3;
      up = b.d2 < b.d1; td = b.d1; tr = b.r1;
      b.d1 = up ? b.d2 : b.d1; b.r1 = up ? b.r2 : b.r1;
      b.d2 = up ? td : b.d2; b.r2 = up ? tr : b.r2;
      up = b.d1 < b.d0; td = b.d0; tr = b.r0;
      b.d0 = up ? b.d1 : b.d0; b.r0 = up ? b.r1 : b.r0;
      b.d1 = up ? td : b.d1; b.r1 = up ? tr : b.r1;
    }
  }
}

// The merge, once a point: five times the group's least (d, row) among the
// lanes' heads, as a 64-bit key (d >= 0, so the float's bits order like
// the float).  Lane 0 of the group gets the five nearest, nearest first, in
// bd / br, which the caller set to (BIG_D2, -1).
__device__ __forceinline__ void merge_best5(Best5& b, int l, unsigned gmask,
                                            float* bd, int* br) {
#pragma unroll
  for (int j = 0; j < KNN; ++j) {
    const unsigned long long head =
        b.r0 < 0 ? NO_KEY
                 : (((unsigned long long)__float_as_uint(b.d0) << 32) | (unsigned)b.r0);
    unsigned long long m = head;
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1)
      m = min(m, __shfl_xor_sync(gmask, m, off));
    if (head == m) {
      b.d0 = b.d1; b.d1 = b.d2; b.d2 = b.d3; b.d3 = b.d4; b.d4 = BIG_D2;
      b.r0 = b.r1; b.r1 = b.r2; b.r2 = b.r3; b.r3 = b.r4; b.r4 = -1;
    }
    if (l == 0 && m != NO_KEY) {
      bd[j] = __uint_as_float((unsigned)(m >> 32));
      br[j] = (int)(unsigned)m;
    }
  }
}

// FLOOR: the launch's fixed chain alone (pose tables, point, mask bit and
// ids loaded, the partials written, the ticket, the last block's sum), for
// the launch floor chip_smoke.py measures; the main path never runs it.
template <int O, bool FLOOR>
__global__ void __launch_bounds__(WARPS * 32)
fused_corr_groups(const float* __restrict__ table, int T, int C,
                  const int* __restrict__ hh, const int* __restrict__ counts,
                  const float* __restrict__ scan,
                  const unsigned char* __restrict__ mask, int N,
                  const float* __restrict__ pose6, float nn_radius,
                  float plane_dist_thresh, float weight_floor,
                  int stage_floats, int vec16_flag, unsigned* ticket,
                  float* partials, float* __restrict__ out) {
  constexpr bool WIDE = O <= WIDE_O;
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
  const int row_floats = 3 * C;
  float* rows = stage_mem + (size_t)group * stage_floats;

  // the last warp makes the pose tables while the others load ids and start
  // their copies
  if (warp == warps - 1) pose_tables_warp(pose6, sR, st, sdR, lane);

  float acc[N_OUT];
#pragma unroll
  for (int i = 0; i < N_OUT; ++i) acc[i] = 0.f;

  const int n_batches = (N + BP - 1) / BP;
  bool first = true;
  // O = 27: the point's ids in shared memory behind its stage
  int* ids = O > CHUNK_O ? reinterpret_cast<int*>(rows + CHUNK_O * row_floats)
                         : nullptr;
  for (int batch = blockIdx.x; batch < n_batches; batch += gridDim.x) {
    // every lane of the group loads the point and marks the skipped
    // buckets, then the group stages its rows; a masked-out point is dead
    const int n = batch * BP + group;
    float px = 0.f, py = 0.f, pz = 0.f;
    unsigned live = 0;            // bit o: bucket o is copied and ranked
    int fill[WIDE ? O : 1];       // O <= WIDE_O: slots of bucket o ranked
    if (n < N && mask[n] != 0) {
      px = scan[3 * n + 0]; py = scan[3 * n + 1]; pz = scan[3 * n + 2];
      if constexpr (O <= CHUNK_O) {
        // the ids in registers (one transaction a group), the duplicate
        // check unrolled whole, the O rows staged whole
        int h[O];
#pragma unroll
        for (int o = 0; o < O; ++o) h[o] = hh[(size_t)o * N + n];
#pragma unroll
        for (int o = 0; o < O; ++o) {
          // an id outside [0, T) reads as an empty bucket, never out of bounds
          bool dup = h[o] < 0 || h[o] >= T;
#pragma unroll
          for (int p = 0; p < o; ++p) dup = dup || h[p] == h[o];
          if (!dup) live |= 1u << o;
        }
        if constexpr (FLOOR) {
        } else if constexpr (WIDE) {
          // the filled prefix of each live row (counts[h], all C slots
          // without counts), read with the ids; only those slots are
          // copied and ranked
          int total = 0;
#pragma unroll
          for (int o = 0; o < O; ++o) {
            fill[o] = 0;
            if ((live >> o) & 1u)
              fill[o] = counts == nullptr ? C : min(max(counts[h[o]], 0), C);
            total += fill[o];
          }
          if (total == 0) live = 0;     // no candidate: no neighbour, no terms
          else stage_filled<O>(rows, table, h, fill, row_floats, l, vec16);
        } else if (live != 0) {
#pragma unroll
          for (int o = 0; o < O; ++o)
            stage_row(rows + o * row_floats, table, h[o], (live >> o) & 1u,
                      row_floats, l, vec16);
        }
      } else {
        // lane l loads offsets l, l + LANES, ... into shared memory and
        // checks them against the earlier ids there; the group ORs the live
        // bits and stages the first chunk
        static_assert(O % CHUNK_O == 0, "a streamed stage takes whole chunks");
        constexpr int IDS_A_LANE = (O + LANES - 1) / LANES;
        int own[IDS_A_LANE];
        bool dup[IDS_A_LANE];
#pragma unroll
        for (int k = 0; k < IDS_A_LANE; ++k) {
          const int o = l + k * LANES;
          own[k] = o < O ? hh[(size_t)o * N + n] : 0;
          if (o < O) ids[o] = own[k];
          // an id outside [0, T) reads as an empty bucket, never out of bounds
          dup[k] = own[k] < 0 || own[k] >= T;
        }
        __syncwarp(gmask);          // the group's ids are in shared memory
#pragma unroll
        for (int p = 0; p < O - 1; ++p) {
          const int v = ids[p];
#pragma unroll
          for (int k = 0; k < IDS_A_LANE; ++k)
            dup[k] = dup[k] || (p < l + k * LANES && v == own[k]);
        }
#pragma unroll
        for (int k = 0; k < IDS_A_LANE; ++k)
          if (l + k * LANES < O && !dup[k]) live |= 1u << (l + k * LANES);
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1)
          live |= __shfl_xor_sync(gmask, live, off);
        if (!FLOOR && live != 0) {
#pragma unroll
          for (int o = 0; o < CHUNK_O; ++o)
            stage_row(rows + o * row_floats, table, ids[o], (live >> o) & 1u,
                      row_floats, l, vec16);
        }
      }
    }
    if (first) {
      __syncthreads();            // the pose tables
      first = false;
    }
    if constexpr (FLOOR) {
      // the loads stay live through two terms; nothing is staged or ranked
      if (l == 0 && live != 0) {
        acc[27] += 1.0f;
        acc[28] += (px + py) + pz;
      }
      continue;
    }
    if (live != 0) {
      const float qx = (sR[0] * px + sR[1] * py) + sR[2] * pz + st[0];
      const float qy = (sR[3] * px + sR[4] * py) + sR[5] * pz + st[1];
      const float qz = (sR[6] * px + sR[7] * py) + sR[8] * pz + st[2];
      float bd[KNN], bx[KNN], by[KNN], bz[KNN];
      int br[KNN];
#pragma unroll
      for (int j = 0; j < KNN; ++j) {
        bd[j] = BIG_D2; br[j] = -1; bx[j] = by[j] = bz[j] = 0.f;
      }
      Best5 b;
      best5_init(b);
      if constexpr (O <= CHUNK_O) {
        cp_async_wait_all();        // this lane's copies have landed
        __syncwarp(gmask);          // ... and those of the group's other lanes
        if constexpr (WIDE) {
          // the filled prefix of each row, rows in ascending order: the
          // five nearest by (d, row) are those of the whole rows, since
          // every slot past a prefix holds SENTINEL, at a squared distance
          // above VALID_MAX from any query of the map's extent (where one
          // would have been among the five the point fails all_valid
          // either way)
#pragma unroll
          for (int o = 0; o < O; ++o)
            rank_rows(rows + o * row_floats, fill[o], o * C, qx, qy, qz, l, b);
        } else {
          rank_rows(rows, O * C, 0, qx, qy, qz, l, b);
        }
        merge_best5(b, l, gmask, bd, br);
        if (l == 0) {
#pragma unroll
          for (int j = 0; j < KNN; ++j) {
            if (br[j] >= 0) {
              const float* w = rows + 3 * br[j];
              bx[j] = w[0]; by[j] = w[1]; bz[j] = w[2];
            }
          }
        }
        __syncwarp(gmask);          // the stage is free for the next batch
      } else {
        // chunk by chunk: ranked into the lanes' best 5, which carry over;
        // one merge after the last; the winners' coordinates from the table
        // (row o * C + slot of the bucket of offset o)
        const int chunk_rows = CHUNK_O * C;
#pragma unroll 1
        for (int c = 0; c < O / CHUNK_O; ++c) {
          if (c > 0) {
#pragma unroll
            for (int o = 0; o < CHUNK_O; ++o) {
              const int og = c * CHUNK_O + o;
              stage_row(rows + o * row_floats, table, ids[og], (live >> og) & 1u,
                        row_floats, l, vec16);
            }
          }
          cp_async_wait_all();      // this lane's copies have landed
          __syncwarp(gmask);        // ... and those of the group's other lanes
          rank_rows(rows, chunk_rows, c * chunk_rows, qx, qy, qz, l, b);
          __syncwarp(gmask);        // the stage is free for the next chunk
        }
        merge_best5(b, l, gmask, bd, br);
        int wh[KNN];
        if (l == 0) {
#pragma unroll
          for (int j = 0; j < KNN; ++j) wh[j] = br[j] >= 0 ? ids[br[j] / C] : 0;
        }
        __syncwarp(gmask);          // the ids are free for the next batch
        if (l == 0) {
#pragma unroll
          for (int j = 0; j < KNN; ++j) {
            if (br[j] >= 0) {
              const float* w =
                  table + ((size_t)wh[j] * C + (size_t)(br[j] % C)) * 3;
              bx[j] = w[0]; by[j] = w[1]; bz[j] = w[2];
            }
          }
        }
      }
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

}  // namespace

// Floats of scratch lio_fused_corr needs: the ticket, then the blocks'
// partials.  The buffer starts zeroed and belongs to one stream.
extern "C" int lio_fused_corr_scratch_floats() {
  return SCRATCH_HEAD + MAX_BLOCKS * N_OUT;
}

// The instantiation for O ids a point (O = 1, 3, 9 or 27), the full kernel
// or its fixed chain alone (`floor`), and its slot in the launcher's grant
// table, or nullptr for any other O.
using KernelFn = void (*)(const float*, int, int, const int*, const int*,
                          const float*, const unsigned char*, int, const float*,
                          float, float, float, int, int, unsigned*, float*,
                          float*);

static KernelFn kernel_for(int O, bool floor, int* which) {
  switch (O) {
    case 1: *which = 0; break;
    case 3: *which = 1; break;
    case 9: *which = 2; break;
    case 27: *which = 3; break;
    default: return nullptr;
  }
  if (floor) *which += 4;
  static const KernelFn kernels[8] = {
      fused_corr_groups<1, false>, fused_corr_groups<3, false>,
      fused_corr_groups<9, false>, fused_corr_groups<27, false>,
      fused_corr_groups<1, true>, fused_corr_groups<3, true>,
      fused_corr_groups<9, true>, fused_corr_groups<27, true>};
  return kernels[*which];
}

// The warps of a block and the floats of a point's stage for O ids a point
// and C slots a bucket.  A point's stage: its O rows (CHUNK_O rows and the
// O bucket ids behind them where the rows stream through it), 16-byte
// aligned, at a stride of 3 * LANES banks so that the 32 lanes of a warp, 3
// floats apart within a group, read 32 different banks.  WARPS warps a
// block, fewer where the rows are so wide that their stages would not fit
// an SM's shared memory.
static int block_shape(int O, int C, int* stage_floats_out) {
  const int staged = O > CHUNK_O ? CHUNK_O : O;
  int stage_floats = (staged * C * 3 + (O > CHUNK_O ? O : 0) + 3) & ~3;
  while (stage_floats % 32 != (3 * LANES) % 32) stage_floats += 4;
  int warps = WARPS;
  while (warps > 1 &&
         (size_t)warps * PPW * stage_floats * sizeof(float) > MAX_STAGE_BYTES)
    warps /= 2;
  *stage_floats_out = stage_floats;
  return warps;
}

// The warps a block of lio_fused_corr holds at O ids a point and C slots a
// bucket (what a caller prints beside the kernel's time).
extern "C" int lio_fused_corr_block_warps(int O, int C) {
  int stage_floats = 0;
  return block_shape(O, C, &stage_floats);
}

static int launch(bool floor, const float* table, int T, int C, const int* hh,
                  int O, const int* counts, const float* scan,
                  const unsigned char* mask, int N, const float* pose6,
                  float nn_radius, float plane_dist_thresh, float weight_floor,
                  float* scratch, int scratch_floats, float* out, void* stream) {
  int which = 0;
  const KernelFn kernel = kernel_for(O, floor, &which);
  if (kernel == nullptr || T < 1 || C < KNN || N < 1 || N > (1 << 24) ||
      scratch_floats < SCRATCH_HEAD + MAX_BLOCKS * N_OUT ||
      (reinterpret_cast<uintptr_t>(table) & 15u) != 0 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  int stage_floats = 0;
  const int warps = block_shape(O, C, &stage_floats);
  const size_t smem = (size_t)warps * PPW * stage_floats * sizeof(float);
  if (smem > MAX_STAGE_BYTES) return (int)cudaErrorInvalidValue;
  const int n_batches = (N + warps * PPW - 1) / (warps * PPW);
  const int blocks = n_batches < MAX_BLOCKS ? n_batches : MAX_BLOCKS;
  // above 48 KB a kernel has to be granted its dynamic shared memory, once an
  // instantiation a device: the current one, which the wrapper makes the
  // table's.  Host threads take turns from the grant to the launch.
  static std::mutex launching;
  static size_t granted[8][64] = {};
  std::lock_guard<std::mutex> turn(launching);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidValue;
  if (smem > granted[which][device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted[which][device] = smem;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<blocks, warps * 32, smem, s>>>(
      table, T, C, hh, counts, scan, mask, N, pose6, nn_radius,
      plane_dist_thresh, weight_floor, stage_floats, C % 4 == 0,
      reinterpret_cast<unsigned*>(scratch), scratch + SCRATCH_HEAD, out);
  return (int)cudaGetLastError();
}

// Launches the kernel on `stream`; returns the cudaError_t (0 = ok).
// `counts` (T int32, the grid's filled slots a bucket, or null for whole
// rows) is read at O = 1 and 3 and ignored at O = 9 and 27.  `out` takes 45
// words: AtA (6x6, symmetric), Atb (6), sum s, sum s|pd2| as floats, then
// n_inliers as an int32.
extern "C" int lio_fused_corr(const float* table, int T, int C, const int* hh,
                              int O, const int* counts, const float* scan,
                              const unsigned char* mask, int N,
                              const float* pose6, float nn_radius,
                              float plane_dist_thresh, float weight_floor,
                              float* scratch, int scratch_floats, float* out,
                              void* stream) {
  return launch(false, table, T, C, hh, O, counts, scan, mask, N, pose6,
                nn_radius, plane_dist_thresh, weight_floor, scratch,
                scratch_floats, out, stream);
}

// The same launch (grid, block, dynamic shared memory, scratch) of the
// kernel's fixed chain alone: the launch floor that chip_smoke.py times
// beside the kernel.  Its outputs mean nothing; the main path never calls
// it.
extern "C" int lio_fused_corr_floor(const float* table, int T, int C,
                                    const int* hh, int O, const int* counts,
                                    const float* scan,
                                    const unsigned char* mask, int N,
                                    const float* pose6, float nn_radius,
                                    float plane_dist_thresh, float weight_floor,
                                    float* scratch, int scratch_floats,
                                    float* out, void* stream) {
  return launch(true, table, T, C, hh, O, counts, scan, mask, N, pose6,
                nn_radius, plane_dist_thresh, weight_floor, scratch,
                scratch_floats, out, stream);
}
