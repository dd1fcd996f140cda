"""Tiny fixed-size linear algebra, unrolled (port of
`lio_slam_tpu/utils/smallmat.py`).

The GN step solves a 6x6 system per iteration and eigendecomposes it once
per scan (mapOptmization.cpp:1781-1808).  These unrolled forms do exactly
the arithmetic of the JAX versions, so the GN stopping rule sees the same
step sizes on both sides.  All functions are batch-generic over leading
dims.
"""

from __future__ import annotations

import torch


def _cholesky(A: torch.Tensor, n: int):
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                L[i][j] = s / L[j][j]
    return L


def _substitute(L, b_cols, n: int) -> torch.Tensor:
    y = [None] * n
    for i in range(n):
        s = b_cols[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def cholesky_solve(A: torch.Tensor, b: torch.Tensor,
                   eps: float = 0.0) -> torch.Tensor:
    """Solve A x = b for symmetric positive-definite A (n x n, small);
    `eps` adds Tikhonov damping to the diagonal."""
    n = A.shape[-1]
    A = A + eps * torch.eye(n, dtype=A.dtype, device=A.device)
    L = _cholesky(A, n)
    return _substitute(L, [b[..., i] for i in range(n)], n)


def cholesky_solve_mat(A: torch.Tensor, B: torch.Tensor,
                       eps: float = 0.0) -> torch.Tensor:
    """Solve A X = B for SPD A (n x n) with matrix RHS B (n x m)."""
    n = A.shape[-1]
    m = B.shape[-1]
    A = A + eps * torch.eye(n, dtype=A.dtype, device=A.device)
    L = _cholesky(A, n)
    cols = [_substitute(L, [B[..., i, c] for i in range(n)], n)
            for c in range(m)]
    return torch.stack(cols, dim=-1)


def eigh_jacobi(A: torch.Tensor, sweeps: int = 8):
    """Symmetric eigendecomposition by cyclic Jacobi rotations.

    Returns (eigenvalues ascending, eigenvectors as columns), the
    `jnp.linalg.eigh` convention (mapOptmization.cpp:1786-1808 `cv::eigen`).
    """
    n = A.shape[-1]
    A = A.clone()
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    for _ in range(sweeps):
        for p in range(n):
            for q in range(p + 1, n):
                app = A[..., p, p]
                aqq = A[..., q, q]
                apq = A[..., p, q]
                small = torch.abs(apq) < 1e-30
                theta = (aqq - app) / (2.0 * torch.where(
                    small, torch.ones_like(apq), apq))
                sign = torch.where(theta >= 0.0, 1.0, -1.0).to(A.dtype)
                t = sign / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
                t = torch.where(small, torch.zeros_like(t), t)
                c = (1.0 / torch.sqrt(t * t + 1.0))[..., None]
                s = t[..., None] * c
                # A <- G^T A G, V <- V G with G[pp,pq;qp,qq] = [c,s;-s,c]
                rp = A[..., p, :].clone()
                rq = A[..., q, :].clone()
                A[..., p, :] = c * rp - s * rq
                A[..., q, :] = s * rp + c * rq
                cp = A[..., :, p].clone()
                cq = A[..., :, q].clone()
                A[..., :, p] = c * cp - s * cq
                A[..., :, q] = s * cp + c * cq
                vp = V[..., :, p].clone()
                vq = V[..., :, q].clone()
                V[..., :, p] = c * vp - s * vq
                V[..., :, q] = s * vp + c * vq
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, V
