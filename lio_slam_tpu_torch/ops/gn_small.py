"""The Gauss-Newton step's 6x6 linear algebra: the CUDA kernel's wrapper and
its plain version.

Every pass of `registration._gn_pass` solves (AtA + 1e-6 I) dx = Atb, and
its first pass also eigendecomposes AtA for the degeneracy projection
(mapOptmization.cpp:1781-1808).  The plain version is
`smallmat.cholesky_solve(AtA, Atb, eps=1e-6)` and `smallmat.eigh_jacobi(AtA)`,
unrolled into scalar torch operations: on the card about 6,400 launches on
a first pass and 173 on every other one.  `csrc/gn_small.cu` does a pass's
work in one launch of one thread, the same operations in the same order,
so its results are the plain version's bit for bit.

- `solve(AtA, Atb)` -> dx; `solve_eigh(AtA, Atb)` -> (dx, eigenvalues
  ascending, eigenvectors as columns).  The device decides: CPU tensors
  run the plain version, CUDA tensors launch the kernel, and a CUDA input
  it does not take (not float32 (6, 6) / (6,) on one device) raises
  `ValueError`.  There is no fallback between the two.
- On the card the results are views of one buffer the kernel wrote whole,
  allocated with `torch.empty`, so the launch can be captured in a CUDA
  graph; nothing here waits for the device.
- A launch counts in `_build.LAUNCHES` (`ops/_build.launch`) under
  "gn_small", or "gn_small_eigh" with the eigensolve (first passes).
"""

from __future__ import annotations

import torch

from lio_slam_tpu_torch.ops import _build
from lio_slam_tpu_torch.utils import smallmat

EPS = 1e-6                # the Levenberg damping of the solve
# the kernel's output words: dx, then with the eigensolve the eigenvalues
# and the eigenvectors (row-major, one a column)
OUT_WORDS = {False: 6, True: 6 + 6 + 36}


def _on_card(AtA: torch.Tensor, Atb: torch.Tensor) -> bool:
    """True where the kernel runs: on CUDA tensors, which must be a float32
    (6, 6) / (6,) system on one device."""
    if AtA.device.type != "cuda" and Atb.device.type != "cuda":
        return False
    if not (Atb.device == AtA.device
            and AtA.dtype == Atb.dtype == torch.float32
            and tuple(AtA.shape) == (6, 6) and tuple(Atb.shape) == (6,)):
        raise ValueError(
            "gn_small takes one float32 (6, 6) / (6,) system on one device, "
            f"got {AtA.dtype} {tuple(AtA.shape)} on {AtA.device} and "
            f"{Atb.dtype} {tuple(Atb.shape)} on {Atb.device}")
    return True


def kernel_launch(lib, AtA: torch.Tensor, Atb: torch.Tensor, eigh: bool,
                  stream):
    """One launch of the kernel through `lib` on `stream` (the card's
    build, or the tests' emulated one with CPU tensors and no stream):
    (cudaError_t, the output words)."""
    AtA, Atb = AtA.contiguous(), Atb.contiguous()
    out = torch.empty(OUT_WORDS[eigh], dtype=torch.float32, device=AtA.device)
    return lib.lio_gn_small(AtA.data_ptr(), Atb.data_ptr(), int(eigh),
                            out.data_ptr(), stream), out


def _launch(AtA: torch.Tensor, Atb: torch.Tensor, eigh: bool) -> torch.Tensor:
    return _build.launch("gn_small_eigh" if eigh else "gn_small", AtA.device,
                         kernel_launch, _build.load_kernels(), AtA, Atb, eigh)


def solve(AtA: torch.Tensor, Atb: torch.Tensor) -> torch.Tensor:
    """dx of (AtA + 1e-6 I) dx = Atb, `smallmat.cholesky_solve`'s bits."""
    if not _on_card(AtA, Atb):
        return smallmat.cholesky_solve(AtA, Atb, eps=EPS)
    return _launch(AtA, Atb, False)


def solve_eigh(AtA: torch.Tensor, Atb: torch.Tensor):
    """(dx, eigenvalues ascending, eigenvectors as columns) of a first GN
    pass: `solve` and `smallmat.eigh_jacobi(AtA)` in one launch."""
    if not _on_card(AtA, Atb):
        return (smallmat.cholesky_solve(AtA, Atb, eps=EPS),
                *smallmat.eigh_jacobi(AtA))
    out = _launch(AtA, Atb, True)
    return out[:6], out[6:12], out[12:].view(6, 6)
