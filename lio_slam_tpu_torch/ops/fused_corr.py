"""Fused correspondence + normal-equation pass: the CUDA kernel's wrapper and
its plain PyTorch version.

Port of `lio_slam_tpu/ops/fused_corr.py`, the one Pallas kernel of the JAX
package.  Per scan point at pose6: squared distances to the R = O*C
candidates of the O buckets the grid's halo layout has a point scan (27
for "none", 9 for "z", 3 for "xy", 1 for "full"), duplicate buckets
suppressed, 5-NN, a covariance plane fit with the closed-form 3x3
eigensolver, every gate of `registration.find_correspondences`, the
Jacobian row [n·(∂R/∂θ_k p), n], and the 6x6 normal-equation sums.

Returns (AtA (6,6), Atb (6,), n_inliers () int32, Σs (), Σs·|pd2| ()), all
on the input's device; nothing here waits for the device.

- `fused_ne_from_bucket_ids` / `fused_normal_equations` are the entry
  points.  On CUDA tensors they launch the kernel in
  `csrc/fused_corr.cu` (built by `ops/_build.py`) or raise; on CPU tensors
  they run the plain version.  There is no fallback between the two.
- `counts`, the grid's filled slots a bucket (`HashGrid.counts`), lets the
  kernel copy and rank only each row's filled prefix at 1 and 3 ids a
  point (halo "full", "xy"); every slot past it holds SENTINEL
  (`voxel_grid._insert_core` fills a bucket as a prefix), so the five
  neighbours and the sums are those of whole rows, bit for bit.
  `fused_normal_equations` and the GN loop pass the grid's own buffer;
  `counts=None` means whole rows (a table made by hand).  The plain
  version ranks every slot whatever `counts` says.
- `fused_ne_from_bucket_ids_ref` / `fused_normal_equations_ref` are the
  plain version in torch: `gather_planar` + `_make_kernel` of the JAX
  package (iterative argmin, first index on ties), except that the
  eigensolver is the trigonometric form of `registration._eigpair_3x3`
  (the JAX kernel's Newton iteration only works around Mosaic's missing
  acos).
- A scan point whose world image is not finite (a NaN or an infinity in
  the point) contributes nothing, whatever its mask bit, in the kernel and
  in the plain version alike.  This departs from the JAX package, where
  such a point's zero weight multiplies a non-finite Jacobian row and the
  sums come out NaN; its loaders (the vendor adapters of `io/formats.py`,
  not ported yet) remove such points before they get here.  `pose6` must
  be finite.
- `KERNEL_LAUNCHES` counts launches of the kernel and nothing else.  A
  launch recorded into a CUDA graph is not one: it counts in
  `CAPTURED_LAUNCHES` instead, and the graph's owner adds its captured
  count to `KERNEL_LAUNCHES` at each replay, where the kernel runs
  (`pipeline/replay._ScanProgram`).
- Under capture the launch must find its scratch made: `prepare_stream`
  on the capture stream, before the capture, makes it outside the graph's
  memory pool.

The (O, N) bucket ids stay plain torch (`voxel_grid.bucket_ids`), as the
JAX package computes them in XLA outside its kernel.  The kernel reads the
bucket rows from the (T, C, 3) table itself, so `corr_refresh_every > 1`
holds only the ids: the table does not change inside one registration.
"""

from __future__ import annotations

import ctypes
import math

import torch

from lio_slam_tpu_torch.ops import voxel_grid as vg
from lio_slam_tpu_torch.utils import se3

KNN = 5
# bucket ids a point, one kernel instantiation each: the halo layouts
# "full", "xy", "z" and "none"
KERNEL_OFFSETS = (1, 3, 9, 27)
# the kernel's output words: AtA (6x6, symmetric), Atb (6), Σs, Σs·|pd2| as
# float32, then n_inliers as an int32
OUT_WORDS = 45
KERNEL_LAUNCHES = 0
CAPTURED_LAUNCHES = 0         # launches recorded into CUDA graphs
# zeroed scratch (ticket + per-block partials) per (device index, stream):
# the kernel's last block resets the ticket, so a buffer serves every call
# on its stream.  Calls on one stream run in order, so one host thread
# launches on a stream at a time; a launch that is aborted part-way (a
# device fault) leaves the ticket unusable, like the rest of the context.
_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def _views(out: torch.Tensor):
    """The kernel's 45 output words as (AtA, Atb, n_inliers, Σs, Σs·|pd2|),
    all views of `out`."""
    return (out[:36].view(6, 6), out[36:42], out[44:].view(torch.int32)[0],
            out[42], out[43])


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def smallest_eig_trig(cxx, cxy, cxz, cyy, cyz, czz):
    """Smallest eigenpair + middle eigenvalue of a symmetric 3x3 given as
    coefficient tensors (Smith's trigonometric method, the arithmetic of
    `registration._eigpair_3x3`; the eigenvector is the most independent
    row cross product of A - lam_min I, picked first-max like jnp.argmax)."""
    p1 = cxy * cxy + cxz * cxz + cyz * cyz
    q = (cxx + cyy + czz) / 3.0
    b00, b11, b22 = cxx - q, cyy - q, czz - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2, min=1e-20) / 6.0)
    inv_p = 1.0 / p
    detB = (b00 * (b11 * b22 - cyz * cyz)
            - cxy * (cxy * b22 - cyz * cxz)
            + cxz * (cxy * cyz - b11 * cxz)) * inv_p * inv_p * inv_p
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    lam_max = q + 2.0 * p * torch.cos(phi)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min
    m00, m11, m22 = cxx - lam_min, cyy - lam_min, czz - lam_min
    c01 = (cxy * cyz - cxz * m11, cxz * cxy - m00 * cyz, m00 * m11 - cxy * cxy)
    c02 = (cxy * m22 - cxz * cyz, cxz * cxz - m00 * m22, m00 * cyz - cxy * cxz)
    c12 = (m11 * m22 - cyz * cyz, cyz * cxz - cxy * m22, cxy * cyz - m11 * cxz)
    n01 = c01[0] * c01[0] + c01[1] * c01[1] + c01[2] * c01[2]
    n02 = c02[0] * c02[0] + c02[1] * c02[1] + c02[2] * c02[2]
    n12 = c12[0] * c12[0] + c12[1] * c12[1] + c12[2] * c12[2]
    use01 = (n01 >= n02) & (n01 >= n12)
    use02 = (~use01) & (n02 >= n12)
    v = [torch.where(use01, a, torch.where(use02, b, c))
         for a, b, c in zip(c01, c02, c12)]
    inv_n = 1.0 / torch.clamp(torch.sqrt(v[0] * v[0] + v[1] * v[1]
                                         + v[2] * v[2]), min=1e-12)
    iso = p2 < 1e-12
    vx = torch.where(iso, torch.zeros_like(p2), v[0] * inv_n)
    vy = torch.where(iso, torch.zeros_like(p2), v[1] * inv_n)
    vz = torch.where(iso, torch.ones_like(p2), v[2] * inv_n)
    return lam_min, lam_mid, vx, vy, vz


def fused_ne_from_bucket_ids_ref(table: torch.Tensor, hh: torch.Tensor,
                                 scan: torch.Tensor, scan_mask: torch.Tensor,
                                 pose6: torch.Tensor, k: int = KNN,
                                 nn_radius: float = 1.0,
                                 plane_dist_thresh: float = 0.2,
                                 robust_weight_floor: float = 0.1,
                                 counts: torch.Tensor | None = None):
    """Plain torch version of the kernel on held bucket ids `hh` (O, N).
    It ranks every slot of every row: `counts` is taken, so that a launch's
    arguments run through it as they are, and not read."""
    T, C, _ = table.shape
    O, N = hh.shape
    R = O * C
    dev = scan.device
    Rm, t = se3.pose6_to_Rt(pose6)
    scan_w = se3.transform_points(Rm, t, scan)
    # a point with no finite world image is dropped (the kernel finds it no
    # neighbour): zeroed, so that its zero weight meets finite terms
    finite = torch.isfinite(scan_w).all(dim=1)
    scan = torch.where(finite[:, None], scan, torch.zeros_like(scan))
    scan_w = torch.where(finite[:, None], scan_w, torch.zeros_like(scan_w))
    scan_mask = scan_mask & finite
    in_table = (hh >= 0) & (hh < T)
    cand = table[torch.where(in_table, hh, 0).to(torch.int64)]    # (O, N, C, 3)
    cx, cy, cz = cand.permute(3, 0, 2, 1).reshape(3, R, N)        # row o*C + c
    qx, qy, qz = scan_w[:, 0], scan_w[:, 1], scan_w[:, 2]
    d2 = (cx - qx) ** 2 + (cy - qy) ** 2 + (cz - qz) ** 2         # (R, N)
    # distinct offset cells hash-colliding into one bucket: its candidates
    # would appear twice; an id outside the table reads as an empty bucket
    ar = torch.arange(O, device=dev)
    dup = torch.any((hh[:, None, :] == hh[None, :, :])
                    & (ar[:, None, None] > ar[None, :, None]), dim=1)
    skip = dup | ~in_table
    d2 = d2 + (skip.to(torch.float32) * vg._BIG).repeat_interleave(C, dim=0)

    cols = torch.arange(N, device=dev)
    nbx, nby, nbz, nnd = [], [], [], []
    dd = d2
    for _ in range(k):
        am = torch.argmin(dd, dim=0)
        nnd.append(dd[am, cols])
        nbx.append(cx[am, cols])
        nby.append(cy[am, cols])
        nbz.append(cz[am, cols])
        dd = dd.clone()
        dd[am, cols] = torch.full_like(nnd[-1], vg._BIG)

    all_valid = nnd[k - 1] < vg._VALID_MAX
    nn_ok = all_valid & (nnd[k - 1] < nn_radius * nn_radius)

    def ssum(terms):
        acc = terms[0]
        for x in terms[1:]:
            acc = acc + x
        return acc

    inv_k = 1.0 / k
    mx, my, mz = ssum(nbx) * inv_k, ssum(nby) * inv_k, ssum(nbz) * inv_k
    cxx = ssum([(x - mx) * (x - mx) for x in nbx]) * inv_k
    cyy = ssum([(y - my) * (y - my) for y in nby]) * inv_k
    czz = ssum([(z - mz) * (z - mz) for z in nbz]) * inv_k
    cxy = ssum([(x - mx) * (y - my) for x, y in zip(nbx, nby)]) * inv_k
    cxz = ssum([(x - mx) * (z - mz) for x, z in zip(nbx, nbz)]) * inv_k
    cyz = ssum([(y - my) * (z - mz) for y, z in zip(nby, nbz)]) * inv_k
    _, lam_mid, nx, ny, nz = smallest_eig_trig(cxx, cxy, cxz, cyy, cyz, czz)
    off = -(nx * mx + ny * my + nz * mz)
    safe = lam_mid > 1e-3
    plane_ok = torch.ones_like(safe)
    for j in range(k):
        dist_j = torch.abs(nx * nbx[j] + ny * nby[j] + nz * nbz[j] + off)
        plane_ok = plane_ok & (dist_j <= plane_dist_thresh)

    px, py, pz = scan[:, 0], scan[:, 1], scan[:, 2]
    pd2 = nx * qx + ny * qy + nz * qz + off
    rng = torch.sqrt(px * px + py * py + pz * pz)
    s = 1.0 - 0.9 * torch.abs(pd2) / torch.sqrt(torch.sqrt(
        torch.clamp(rng, min=1e-6)))
    valid = (scan_mask & nn_ok & plane_ok & safe & all_valid
             & (s > robust_weight_floor))
    w_s = torch.where(valid, s, torch.zeros_like(s))
    w = w_s * w_s

    dR = se3.rpy_to_matrix_jacobian(pose6[:3])                    # [i, j, k]
    jrows = []
    for kk in range(3):
        jrows.append(
            nx * (dR[0, 0, kk] * px + dR[0, 1, kk] * py + dR[0, 2, kk] * pz)
            + ny * (dR[1, 0, kk] * px + dR[1, 1, kk] * py + dR[1, 2, kk] * pz)
            + nz * (dR[2, 0, kk] * px + dR[2, 1, kk] * py + dR[2, 2, kk] * pz))
    J = torch.stack(jrows + [nx, ny, nz], dim=0)                  # (6, N)
    AtA = (J * w[None, :]) @ J.T
    Atb = -torch.sum(J * (w * pd2)[None, :], dim=1)
    return (AtA, Atb, torch.sum(valid).to(torch.int32), torch.sum(w_s),
            torch.sum(w_s * torch.abs(pd2)))


def fused_normal_equations_ref(grid: vg.HashGrid, scan: torch.Tensor,
                               scan_mask: torch.Tensor, pose6: torch.Tensor,
                               halo: str = "z", **kw):
    """Plain version of `fused_normal_equations`."""
    hh = _bucket_ids_at(grid, scan, pose6, halo)
    return fused_ne_from_bucket_ids_ref(grid.table, hh, scan, scan_mask,
                                        pose6, **kw)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _bucket_ids_at(grid: vg.HashGrid, scan: torch.Tensor, pose6: torch.Tensor,
                   halo: str) -> torch.Tensor:
    Rm, t = se3.pose6_to_Rt(pose6)
    return vg.bucket_ids(se3.transform_points(Rm, t, scan), grid.cell_size,
                         grid.table.shape[0], halo)


def _check_cuda_inputs(table, hh, scan, scan_mask, pose6, counts=None):
    dev = table.device
    specs = (("table", table, torch.float32, 3), ("hh", hh, torch.int32, 2),
             ("scan", scan, torch.float32, 2),
             ("scan_mask", scan_mask, torch.bool, 1),
             ("pose6", pose6, torch.float32, 1))
    for name, x, dtype, ndim in specs:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, table on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != ndim:
            raise ValueError(f"{name} must have {ndim} dims, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    N = scan.shape[0]
    if table.shape[2] != 3 or scan.shape[1] != 3 or pose6.shape[0] != 6:
        raise ValueError("table must be (T, C, 3), scan (N, 3), pose6 (6,)")
    if hh.shape[1] != N or scan_mask.shape[0] != N or N == 0:
        raise ValueError(f"hh {tuple(hh.shape)} / scan_mask "
                         f"{tuple(scan_mask.shape)} do not match N={N}")
    if hh.shape[0] not in KERNEL_OFFSETS:
        raise ValueError(f"the kernel scans {KERNEL_OFFSETS} buckets per "
                         f"point, hh has {hh.shape[0]} rows")
    if table.shape[1] < KNN:
        raise ValueError(f"the kernel needs {KNN} slots a bucket, the table "
                         f"has {table.shape[1]}")
    if N > 2 ** 24:
        raise ValueError(f"the kernel counts inliers in float32: N={N} > 2^24")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned: the kernel copies "
                         "its rows 16 bytes at a time")
    if counts is not None:
        if counts.device != dev:
            raise ValueError(f"counts is on {counts.device}, table on {dev}")
        if counts.dtype != torch.int32:
            raise TypeError(f"counts must be torch.int32, got {counts.dtype}")
        if tuple(counts.shape) != (table.shape[0],):
            raise ValueError(f"counts must be ({table.shape[0]},), one a "
                             f"bucket, got {tuple(counts.shape)}")
        if not counts.is_contiguous():
            raise ValueError("counts must be contiguous")


def _kernel_args(table, hh, scan, scan_mask, pose6, nn_radius,
                 plane_dist_thresh, robust_weight_floor, counts=None):
    T, C, _ = table.shape
    O, N = hh.shape
    return (table.data_ptr(), T, C, hh.data_ptr(), O,
            None if counts is None else counts.data_ptr(), scan.data_ptr(),
            scan_mask.data_ptr(), N, pose6.data_ptr(),
            ctypes.c_float(nn_radius), ctypes.c_float(plane_dist_thresh),
            ctypes.c_float(robust_weight_floor))


def fused_ne_from_bucket_ids(table: torch.Tensor, hh: torch.Tensor,
                             scan: torch.Tensor, scan_mask: torch.Tensor,
                             pose6: torch.Tensor, k: int = KNN,
                             nn_radius: float = 1.0,
                             plane_dist_thresh: float = 0.2,
                             robust_weight_floor: float = 0.1,
                             counts: torch.Tensor | None = None):
    """The fused pass on bucket ids `hh` (O, N) from `voxel_grid.bucket_ids`
    — held across GN iterations when corr_refresh_every > 1.  An id outside
    [0, T) reads as an empty bucket.  `counts` (T,) int32, where given, is
    the grid's filled slots a bucket: at 1 and 3 ids a point the kernel
    ranks only those (every slot past them must hold SENTINEL); None ranks
    whole rows.  CUDA tensors launch the kernel; CPU tensors run the plain
    version.  On CUDA the five results are views of one buffer the kernel
    wrote whole."""
    if table.device.type == "cpu":
        return fused_ne_from_bucket_ids_ref(
            table, hh, scan, scan_mask, pose6, k=k, nn_radius=nn_radius,
            plane_dist_thresh=plane_dist_thresh,
            robust_weight_floor=robust_weight_floor)
    if table.device.type != "cuda":
        raise ValueError(f"fused_corr runs on cpu or cuda, not {table.device}")
    if k != KNN:
        raise ValueError(f"the kernel selects {KNN} neighbours, got k={k}")
    _check_cuda_inputs(table, hh, scan, scan_mask, pose6, counts)
    from lio_slam_tpu_torch.ops import _build

    lib = _build.load_fused_corr()
    dev = table.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    capturing = torch.cuda.is_current_stream_capturing()
    scratch = _SCRATCH.get((dev.index, stream))
    if scratch is None:
        if capturing:
            raise RuntimeError("fused_corr: no scratch on the capturing "
                               "stream; call prepare_stream() on it before "
                               "the capture")
        scratch = prepare_stream(dev)
    out = torch.empty(OUT_WORDS, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):      # the launcher works on the current device
        err = lib.lio_fused_corr(
            *_kernel_args(table, hh, scan, scan_mask, pose6, nn_radius,
                          plane_dist_thresh, robust_weight_floor, counts),
            scratch.data_ptr(), scratch.numel(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_corr kernel launch failed: cudaError_t {err}")
    global KERNEL_LAUNCHES, CAPTURED_LAUNCHES
    if capturing:
        CAPTURED_LAUNCHES += 1
    else:
        KERNEL_LAUNCHES += 1
    return _views(out)


def prepare_stream(device) -> torch.Tensor:
    """The zeroed scratch of the kernel on `device`'s current stream, made
    where there is none yet (never while that stream captures)."""
    from lio_slam_tpu_torch.ops import _build

    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _SCRATCH:
        n = _build.load_fused_corr().lio_fused_corr_scratch_floats()
        _SCRATCH[key] = torch.zeros(n, dtype=torch.float32, device=dev)
    return _SCRATCH[key]


def fused_normal_equations(grid: vg.HashGrid, scan: torch.Tensor,
                           scan_mask: torch.Tensor, pose6: torch.Tensor,
                           halo: str = "z", k: int = KNN,
                           nn_radius: float = 1.0,
                           plane_dist_thresh: float = 0.2,
                           robust_weight_floor: float = 0.1):
    """One fused surfOptimization + normal-equation pass at `pose6`:
    bucket ids at the pose, then `fused_ne_from_bucket_ids` with the grid's
    counts."""
    hh = _bucket_ids_at(grid, scan, pose6, halo)
    return fused_ne_from_bucket_ids(
        grid.table, hh, scan, scan_mask, pose6, k=k, nn_radius=nn_radius,
        plane_dist_thresh=plane_dist_thresh,
        robust_weight_floor=robust_weight_floor, counts=grid.counts)
