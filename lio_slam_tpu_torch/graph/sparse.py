"""Sparse full-graph solve: block-tridiagonal chain + Woodbury loop fill-in
(port of `lio_slam_tpu/graph/sparse.py`).

The replacement for `solver.solve` / `solver.marginal_covariance` at
production capacities: the dense path assembles a (K*6)^2 system, about
600 MB of H at the default `max_keyframes=2048`, per linearization; iSAM2
in the reference stays O(active) as the graph grows
(mapOptmization.cpp:2082-2134).

The pose graph has the structure that makes a direct sparse solve cheap
(`pipeline/lio.py` layout):

- between slots [0, K-1) are the odometry chain (slot i: keyframe i -> i+1),
- the prior on keyframe 0 and GPS unaries touch single diagonal blocks,
- loop closures (slots >= K-1) are the only off-tridiagonal fill-in, and
  there are few of them (capacity L = max_loop_queue * 8).

So H = T + A^T W A with T block-tridiagonal (6x6 blocks) and A the stacked
loop-factor Jacobians (6L rows).  T is factored once per linearization with
a block-LDL^T (Thomas) recursion, and the Woodbury identity gives the loop
correction:

    H^-1 b = T^-1 b - Y S^-1 (A T^-1 b),   Y = T^-1 A^T,  S = W^-1 + A Y.

The marginal covariance of pose k (GPS gating) reads the same factorization:

    Cov_k = (T^-1 E_k)_k - Y_k S^-1 Y_k^T.

Everything is float32 with Jacobi equilibration (the reference's noise
models span 14 orders of magnitude).

The JAX package's three `lax.scan`s over the K blocks are Python loops
here, a handful of tiny device launches a block.  Inactive poses have
D = I, Loff = 0, b = 0 and couple to nothing, so the recursion runs over
the blocks up to the last active pose only (`n_active`) and the tail is
factored and solved in one batched call with the same arithmetic; the
result equals the full-length recursion.  The scatters with repeated
indices (several GPS factors on one pose, masked slots that all name
pose 0) are one-hot products, so the order of the sums is fixed and two
runs give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lio_slam_tpu_torch.graph import factors as F
from lio_slam_tpu_torch.graph.solver import (SolveResult, _scaled_cholesky,
                                             _equilibrated_cholesky_solve,
                                             backtrack_step)

_DAMP = 1e-5
_BIG = 1e8          # W^-1 diagonal of masked loop rows (correction -> 0)


class TridiagFactor(NamedTuple):
    """Block-LDL^T factorization of the equilibrated tridiagonal system."""

    chols: torch.Tensor   # (K, 6, 6) lower Cholesky of the Schur-reduced diag
    Lm: torch.Tensor      # (K, 6, 6) subdiagonal blocks, shifted: Lm[i]=T[i,i-1]
    scale: torch.Tensor   # (K, 6) Jacobi equilibration diag (applied symmetric)
    n_active: int         # blocks [n_active, K) are coupled to nothing


def _cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where a block is not positive definite
    (as `jnp.linalg.cholesky` answers), without waiting for the device."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info > 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def active_prefix_len(pose_mask: torch.Tensor) -> torch.Tensor:
    """() int64: one past the last active pose (0 when none is)."""
    idx = torch.arange(1, pose_mask.shape[0] + 1, device=pose_mask.device)
    return torch.max(torch.where(pose_mask, idx, torch.zeros_like(idx)))


def tridiag_factor(D: torch.Tensor, Loff: torch.Tensor,
                   n_active: Optional[int] = None) -> TridiagFactor:
    """Factor the SPD block-tridiagonal T given diagonal blocks D (K,6,6) and
    subdiagonal blocks Loff (K,6,6) with Loff[i] = T[i+1, i] (Loff[K-1]
    ignored).  `n_active` (default K: the full-length recursion) promises
    that Loff[i] = 0 for every i >= n_active - 1, as `_assemble` leaves the
    poses past the last active one."""
    K = D.shape[0]
    n = K if n_active is None else max(0, min(int(n_active), K))
    dtype, dev = D.dtype, D.device
    eye = torch.eye(6, dtype=dtype, device=dev)
    damp = eye * _DAMP
    diag = torch.diagonal(D, dim1=-2, dim2=-1)                   # (K, 6)
    s = 1.0 / torch.sqrt(torch.clamp(diag, min=1e-12))
    Ds = D * s[:, :, None] * s[:, None, :] + damp[None]
    # Lm[i] = T[i, i-1] scaled by s_i (rows) and s_{i-1} (cols)
    Lm = torch.cat([torch.zeros((1, 6, 6), dtype=dtype, device=dev),
                    Loff[:-1]], dim=0)
    Lm = Lm * s[:, :, None] * torch.cat(
        [torch.ones((1, 6), dtype=dtype, device=dev), s[:-1]],
        dim=0)[:, None, :]

    chols = []
    c_prev = eye                      # the first block has no coupling
    for i in range(n):
        Li = Lm[i]
        Z = torch.cholesky_solve(Li.T, c_prev)                   # c^-1 L^T
        Ci = Ds[i] - Li @ Z
        Ci = 0.5 * (Ci + Ci.T) + damp
        c_prev = _cholesky_or_nan(Ci)
        chols.append(c_prev)
    chols = torch.stack(chols) if n else Ds[:0]
    if n < K:
        tail = Ds[n:]                 # L = 0: the recursion's Ds - L Z is Ds
        chols = torch.cat(
            [chols, _cholesky_or_nan(0.5 * (tail + tail.mT) + damp[None])])
    return TridiagFactor(chols=chols, Lm=Lm, scale=s, n_active=n)


def tridiag_solve(f: TridiagFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve T x = b for b of shape (K, 6) or (K, 6, M)."""
    squeeze = b.dim() == 2
    if squeeze:
        b = b[..., None]
    bs = b * f.scale[..., None]
    K, n = bs.shape[0], f.n_active
    eye = torch.eye(6, dtype=b.dtype, device=b.device)

    # forward: y_i = b_i - L_i c_{i-1}^-1 y_{i-1} (the PREVIOUS block's chol)
    ys = []
    y_prev, c_prev = torch.zeros_like(bs[0]), eye
    for i in range(n):
        y_prev = bs[i] - f.Lm[i] @ torch.cholesky_solve(y_prev, c_prev)
        ys.append(y_prev)
        c_prev = f.chols[i]

    # backward: x_i = c_i^-1 (y_i - L_{i+1}^T x_{i+1}); past n_active L = 0
    xs = [None] * n
    x_next = torch.zeros_like(bs[0])
    if n < K:
        tail = torch.cholesky_solve(bs[n:], f.chols[n:])
        x_next = tail[0]
    for i in range(n - 1, -1, -1):
        rhs = ys[i] if i == K - 1 else ys[i] - f.Lm[i + 1].T @ x_next
        x_next = torch.cholesky_solve(rhs, f.chols[i])
        xs[i] = x_next
    x = torch.stack(xs) if n else bs[:0]
    if n < K:
        x = torch.cat([x, tail], dim=0)
    x = x * f.scale[..., None]
    return x[..., 0] if squeeze else x


# ---------------------------------------------------------------------------
# assembly: chain/unary part (T) + gradient b + loop low-rank part (A, W)
# ---------------------------------------------------------------------------

def _one_hot(idx: torch.Tensor, K: int, dtype) -> torch.Tensor:
    """(n, K) rows with a 1 at idx."""
    return (idx.long()[:, None]
            == torch.arange(K, device=idx.device)[None, :]).to(dtype)


def _assemble(graph: F.PoseGraph):
    """Linearize all factors; return (D, Loff, b, chi2, loop terms)."""
    K = graph.poses.shape[0]
    B = graph.bt_i.shape[0]
    nL = B - (K - 1)                       # loop-slot capacity
    dtype, dev = graph.poses.dtype, graph.poses.device

    D = torch.zeros((K, 6, 6), dtype=dtype, device=dev)
    b = torch.zeros((K, 6), dtype=dtype, device=dev)

    e0, J0 = F.linearize_prior(graph)
    w0 = graph.prior_info
    D[0] += torch.einsum("ri,r,rj->ij", J0, w0, J0)
    b[0] += -J0.T @ (w0 * e0)

    eb, Ji, Jj = F.linearize_between(graph)
    wb = graph.bt_info * graph.bt_mask[:, None]

    # chain part: slots [0, K-1), slot i couples poses (i, i+1).  The blocks
    # below go to FIXED positions (slot i -> poses i, i+1), so a factor
    # routed through this region with (bt_i, bt_j) != (i, i+1) would land on
    # the wrong poses: it is dropped instead of corrupting the solve
    # (non-chain topology belongs in the loop region)
    c = K - 1
    slots = torch.arange(c, device=dev)
    chain_ok = (graph.bt_i[:c] == slots) & (graph.bt_j[:c] == slots + 1)
    wc = wb[:c] * chain_ok[:, None]
    D[:c] += torch.einsum("bri,br,brj->bij", Ji[:c], wc, Ji[:c])
    D[1:K] += torch.einsum("bri,br,brj->bij", Jj[:c], wc, Jj[:c])
    # T[i+1, i] = Jj^T W Ji
    Loff = torch.cat(
        [torch.einsum("bri,br,brj->bij", Jj[:c], wc, Ji[:c]),
         torch.zeros((1, 6, 6), dtype=dtype, device=dev)], dim=0)
    b[:c] += -torch.einsum("bri,br,br->bi", Ji[:c], wc, eb[:c])
    b[1:K] += -torch.einsum("bri,br,br->bi", Jj[:c], wc, eb[:c])

    # gps unaries (several may share a pose; masked slots all name pose 0)
    eg, Jg = F.linearize_gps(graph)
    wg = graph.gps_info * graph.gps_mask[:, None]
    oh_g = _one_hot(graph.gps_i, K, dtype)
    D = D + torch.einsum("gk,gij->kij", oh_g,
                         torch.einsum("gri,gr,grj->gij", Jg, wg, Jg))
    b = b + oh_g.T @ (-torch.einsum("gri,gr,gr->gi", Jg, wg, eg))

    # loop factors: gradient contribution + low-rank terms
    el, Jli, Jlj = eb[c:], Ji[c:], Jj[c:]
    wl = wb[c:]                                    # (L, 6)
    li, lj = graph.bt_i[c:].long(), graph.bt_j[c:].long()
    lmask = graph.bt_mask[c:]
    if nL:
        b = b + _one_hot(li, K, dtype).T @ (
            -torch.einsum("lri,lr,lr->li", Jli, wl, el))
        b = b + _one_hot(lj, K, dtype).T @ (
            -torch.einsum("lri,lr,lr->li", Jlj, wl, el))

    # inactive poses: identity diagonal (keeps T SPD); no off-diagonal
    # coupling touches an inactive pose
    act = graph.pose_mask.to(dtype)
    D = D * act[:, None, None]
    D = D + torch.eye(6, dtype=dtype, device=dev)[None] \
        * (1.0 - act)[:, None, None]
    act_next = torch.cat([act[1:], torch.zeros(1, dtype=dtype, device=dev)])
    Loff = Loff * (act * act_next)[:, None, None]
    b = b * act[:, None]

    chi2 = (torch.sum(wb * eb * eb) + torch.sum(wg * eg * eg)
            + torch.sum(w0 * e0 * e0))
    loops = (li, lj, Jli, Jlj, wl, lmask, nL)
    return D, Loff, b, chi2, loops


def _chol_solve_multi(S: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Equilibrated Cholesky solve with several right-hand sides."""
    L, Dinv = _scaled_cholesky(S)
    return torch.cholesky_solve(B * Dinv[:, None], L) * Dinv[:, None]


def _woodbury_apply(f: TridiagFactor, loops, rhs: torch.Tensor,
                    any_loop: bool, y_solve=tridiag_solve) -> torch.Tensor:
    """H^-1 rhs from the factored chain + the loop low-rank correction.
    rhs: (K, 6) or (K, 6, M).  `any_loop` (a host value: whether a loop
    factor is active) skips the correction, so a mission before its first
    loop pays the chain solve only.  `y_solve(f, At)` computes Y = T^-1 A^T
    over the 6L loop columns (the sharded solver splits them over ranks)."""
    li, lj, Jli, Jlj, wl, lmask, nL = loops
    tb = tridiag_solve(f, rhs)                       # T^-1 rhs
    if nL == 0 or not any_loop:
        return tb
    K = f.chols.shape[0]
    dtype = rhs.dtype
    lm = lmask.to(dtype)

    # A^T as a dense (K, 6, 6L): At[k, s, l, r] = J_l[r, s] at k = the
    # factor's pose
    At = (torch.einsum("lk,lrs->kslr", _one_hot(li, K, dtype) * lm[:, None], Jli)
          + torch.einsum("lk,lrs->kslr", _one_hot(lj, K, dtype) * lm[:, None], Jlj))
    Y = y_solve(f, At.reshape(K, 6, nL * 6))         # (K, 6, 6L)

    def a_apply(x):
        """A x for x (K, 6, ...): gather + Jacobian apply -> (6L, ...)."""
        rows = (torch.einsum("lrs,ls...->lr...", Jli, x[li])
                + torch.einsum("lrs,ls...->lr...", Jlj, x[lj]))
        rows = rows * (lm[:, None, None] if rows.dim() == 3 else lm[:, None])
        return rows.reshape((nL * 6,) + rows.shape[2:])

    AY = a_apply(Y)                                  # (6L, 6L)
    winv = torch.where(lmask[:, None], 1.0 / torch.clamp(wl, min=1e-12),
                       torch.full_like(wl, _BIG))
    S = AY + torch.diag(winv.reshape(-1))
    Atb = a_apply(tb)                                # (6L,) or (6L, M)
    corr = (_equilibrated_cholesky_solve(S, Atb) if Atb.dim() == 1
            else _chol_solve_multi(S, Atb))
    return tb - torch.einsum("ksl,l...->ks...", Y, corr)


def _host_flags(graph: F.PoseGraph, n_active: Optional[int]):
    """(n_active, any active loop factor) in one device-to-host read."""
    K = graph.poses.shape[0]
    any_loop = graph.bt_mask[K - 1:].any().to(torch.int64)
    if n_active is not None:
        return int(n_active), bool(any_loop)
    n, a = torch.stack([active_prefix_len(graph.pose_mask), any_loop]).tolist()
    return n, bool(a)


# ---------------------------------------------------------------------------
# public API: mirrors solver.solve / solver.marginal_covariance
# ---------------------------------------------------------------------------

def solve_sparse(graph: F.PoseGraph, iterations: int = 5,
                 n_active: Optional[int] = None,
                 y_solve=tridiag_solve) -> SolveResult:
    """Full-graph GN over all active poses, O(K) memory, with backtracking
    step control (monotone descent).  Drop-in for
    `solver.solve(graph, pose_mask, n)`.  `n_active`: one past the last
    active pose if the caller knows it (K runs the full-length recursion);
    by default it is read from the mask, one device-to-host read a solve.
    `y_solve`: the Woodbury column solve (`_woodbury_apply`)."""
    n_active, any_loop = _host_flags(graph, n_active)
    g = graph
    dtype, dev = graph.poses.dtype, graph.poses.device
    dn = torch.zeros((), dtype=dtype, device=dev)
    chi2 = torch.zeros((), dtype=dtype, device=dev)
    for _ in range(iterations):
        D, Loff, b, chi2, loops = _assemble(g)
        f = tridiag_factor(D, Loff, n_active)
        delta = _woodbury_apply(f, loops, b, any_loop, y_solve)  # (K, 6)
        delta = torch.where(g.pose_mask[:, None], delta,
                            torch.zeros_like(delta))
        new_poses, scale = backtrack_step(g, delta, chi2)
        g = g._replace(poses=new_poses)
        dn = torch.linalg.norm(delta) * scale
    return SolveResult(graph=g, delta_norm=dn, chi2=chi2)


def marginal_covariance_sparse(graph: F.PoseGraph, idx: torch.Tensor,
                               n_active: Optional[int] = None) -> torch.Tensor:
    """(6, 6) marginal covariance of pose `idx` from the sparse
    factorization (isam->marginalCovariance for GPS gating, :2128-2133)."""
    n_active, any_loop = _host_flags(graph, n_active)
    K = graph.poses.shape[0]
    dtype, dev = graph.poses.dtype, graph.poses.device
    D, Loff, _, _, loops = _assemble(graph)
    f = tridiag_factor(D, Loff, n_active)
    idx = torch.as_tensor(idx, device=dev).long()
    E = torch.zeros((K, 6, 6), dtype=dtype, device=dev)     # one-hot block rhs
    E[idx] = torch.eye(6, dtype=dtype, device=dev)
    return _woodbury_apply(f, loops, E, any_loop)[idx]
