"""The GN step's kernel (`lio_slam_tpu_torch/ops/csrc/gn_small.cu`) run on
the CPU: compiled with g++ against `tests/cuda_emulator.h`
(`tests/torch_port_cuda_emulator.py`) and held bit for bit to its plain
version, `smallmat.cholesky_solve(AtA, Atb, eps=1e-6)` and
`smallmat.eigh_jacobi(AtA)`, on the systems of
`torch_port_helpers.GN_SMALL_CASES`: random SPD, a real GN system,
rank-deficient, diagonal (every rotation takes the |apq| < 1e-30 branch),
equal eigenvalues and -0 beside +0 (the stable sort's ties), all zero
(+0 and -0 words), a NaN off and on the diagonal.  The card holds the compiled kernel to the torch version on
CUDA tensors (tests/test_torch_cuda.py).

One CPU torch op rounds differently from the card: `torch.sqrt` of float32
(its vectorised CPU path) is off by one ulp on some inputs (4815.9414 ->
69.39698, where the correctly rounded root, the card's, is 69.39699).  So
the plain version runs here with `torch.sqrt` correctly rounded (through
float64), and every root it takes is held within 1 ulp of torch's own.
"""

import numpy as np
import pytest
import torch

import torch_port_cuda_emulator as E
from torch_port_helpers import (GN_SMALL_CASES, assert_same_bits,
                                gn_small_case, planar_scene, t)
from lio_slam_tpu_torch.config import RegistrationConfig
from lio_slam_tpu_torch.ops import _build
from lio_slam_tpu_torch.ops import gn_small
from lio_slam_tpu_torch.ops import registration as reg
from lio_slam_tpu_torch.utils import smallmat


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return E.build_gn_small(tmp_path_factory.mktemp("emulated_gn_small"))


class CardSqrt:
    """`torch.sqrt` correctly rounded (through float64), as on the card,
    recording the inputs it takes."""

    def __init__(self):
        self.real = torch.sqrt
        self.taken = []

    def __call__(self, x):
        self.taken.append(x.detach().clone().reshape(-1))
        return self.real(x.to(torch.float64)).to(x.dtype)

    def assert_cpu_within_one_ulp(self):
        """torch's own CPU root of every input taken is within 1 ulp."""
        x = torch.cat(self.taken)
        cpu = self.real(x)
        card = self.real(x.to(torch.float64)).to(torch.float32)
        nan = torch.isnan(card)
        assert torch.equal(nan, torch.isnan(cpu))
        ulps = (cpu.view(torch.int32) - card.view(torch.int32))[~nan].abs()
        assert int(ulps.max()) <= 1


@pytest.fixture
def card_sqrt(monkeypatch):
    sqrt = CardSqrt()
    monkeypatch.setattr(torch, "sqrt", sqrt)
    return sqrt


@pytest.mark.parametrize("case", GN_SMALL_CASES)
def test_kernel_matches_smallmat(lib, card_sqrt, case):
    """Both instantiations (solve; solve and eigensolve) against the plain
    version, word for word."""
    AtA, Atb = (t(x) for x in gn_small_case(case))
    card_sqrt.taken.clear()             # the roots the case's making took
    dx = smallmat.cholesky_solve(AtA, Atb, eps=1e-6)
    w, V = smallmat.eigh_jacobi(AtA)
    assert_same_bits(E.gn_small_emulated(lib, AtA, Atb, eigh=False), dx)
    got = E.gn_small_emulated(lib, AtA, Atb, eigh=True)
    for a, b in zip(got, (dx, w, V)):
        assert_same_bits(a, b)
    assert len(card_sqrt.taken) == 6 + 2 * 8 * 15
    card_sqrt.assert_cpu_within_one_ulp()
    if not case.startswith("nan"):
        assert torch.isfinite(dx).all() and torch.isfinite(V).all()
        assert (w[1:] >= w[:-1]).all()


def test_ties_keep_their_order(lib):
    """Equal eigenvalues (and -0 with +0) keep the order of their columns:
    on a diagonal system V is the permutation the stable sort gives."""
    for case, order in (("repeated_diagonal", [1, 3, 5, 0, 2, 4]),
                        ("signed_zeros", [0, 1, 3, 4, 5, 2])):
        AtA, Atb = (t(x) for x in gn_small_case(case))
        _, w, V = E.gn_small_emulated(lib, AtA, Atb, eigh=True)
        assert torch.equal(w, torch.diagonal(AtA)[order])
        assert torch.equal(V, torch.eye(6)[:, order])
    assert torch.signbit(w).tolist() == [True] + [False] * 5


def test_the_launch_floor_moves_the_words(lib):
    """The launch floor (`lio_gn_small_floor`, which chip_smoke.py times)
    writes Atb where dx goes and AtA where the eigenvectors go, and leaves
    the eigenvalues' words alone."""
    AtA, Atb = (t(x) for x in gn_small_case("gn_plane"))
    out = torch.full((gn_small.OUT_WORDS[True],), float("nan"))
    assert lib.lio_gn_small_floor(AtA.data_ptr(), Atb.data_ptr(),
                                  out.data_ptr(), None) == 0
    assert_same_bits(out[:6], Atb)
    assert_same_bits(out[12:].view(6, 6), AtA)
    assert torch.isnan(out[6:12]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_inputs_run_the_plain_version(dtype):
    """The wrapper launches nothing for CPU tensors: its results are the
    smallmat functions' own, in the input's dtype."""
    AtA, Atb = (t(x, dtype) for x in gn_small_case("gn_plane"))
    before = _build.LAUNCHES.copy(), _build.CAPTURED.copy()
    dx = gn_small.solve(AtA, Atb)
    dx2, w, V = gn_small.solve_eigh(AtA, Atb)
    assert (_build.LAUNCHES, _build.CAPTURED) == before
    assert torch.equal(dx, smallmat.cholesky_solve(AtA, Atb, eps=1e-6))
    assert torch.equal(dx2, dx) and dx.dtype == dtype
    w_ref, V_ref = smallmat.eigh_jacobi(AtA)
    assert torch.equal(w, w_ref) and torch.equal(V, V_ref)


@pytest.mark.parametrize("resident", [False, True])
def test_every_gn_pass_takes_one_step(monkeypatch, resident):
    """`register` calls the wrapper once a GN pass, with the eigensolve on
    the first pass only: on the host loop as many passes as iterations, on
    the resident one all `max_iterations`."""
    calls = []
    for name in ("solve", "solve_eigh"):
        real = getattr(gn_small, name)
        monkeypatch.setattr(gn_small, name,
                            lambda *a, _n=name, _f=real: calls.append(_n)
                            or _f(*a))
    map_pts, scan = planar_scene(4, n_map=4096, n_scan=300)
    cfg = RegistrationConfig()
    init = t(np.array([0.0, 0.0, 0.01, 0.1, 0.0, 0.02], np.float32))
    r = reg.register(t(scan), torch.ones(len(scan), dtype=torch.bool),
                     t(map_pts), torch.ones(len(map_pts), dtype=torch.bool),
                     init, cfg, resident=resident)
    passes = cfg.max_iterations if resident else r.iterations
    assert int(r.iterations) > 1
    assert calls == ["solve_eigh"] + ["solve"] * (passes - 1)
