"""The 5-NN selection scheme of the CUDA kernel (a group of lanes a point,
lane-strided best 5 a lane with a strict early-out against the lane's fifth,
then five merges by (d, row)) against the selection of the JAX package's
kernel: `jnp.argmin` five times, first index on ties, 1e30 added to the
candidates of a repeated bucket (`lio_slam_tpu/ops/fused_corr.py`,
`_make_kernel`).

The scheme is `select_lanes_ref` below, a torch model of what
`rank_point` in `csrc/fused_corr.cu` does; these tests hold the scheme, not
the CUDA source.  The kernel itself is held to the plain version only on a
GPU, by the `cuda` tests of tests/test_torch_cuda.py and by chip_smoke.py.

The contract: wherever the argmin's pick is a real neighbour (d below the
validity bound) the scheme picks the same row with the same distance, in the
same order; where it is not, the scheme's pick is no neighbour either.  The
plane fit only ever sees picks of the first kind: a point whose fifth pick
is no neighbour is gated out.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lio_slam_tpu.ops import fused_corr as jax_fc
from lio_slam_tpu_torch.ops import fused_corr as fc

K = KNN = fc.KNN
# a candidate the kernel never selects carries this distance (BIG_D2 there)
NO_NEIGHBOUR_D2 = 3.0e38


def select_lanes_ref(d2: torch.Tensor, skip: torch.Tensor, k: int = KNN,
                     lanes: int = 8):
    """The kernel's selection scheme in torch, for the tests.  `d2` (R, N)
    squared distances of the rows o*C + c, `skip` (O, N) buckets the kernel
    does not rank.  Lane l of a point's group of `lanes` walks rows l,
    l + lanes, ... and keeps its best k as keys (bits of d, then the row); a
    candidate enters only if strictly nearer than the lane's k-th.  Then k
    merges take the least key over the lanes' heads.  Returns (rows (k, N)
    int64, -1 where nothing was selected; d (k, N), NO_NEIGHBOUR_D2 there)."""
    R, N = d2.shape
    C = R // skip.shape[0]
    none = torch.iinfo(torch.int64).max
    d2 = d2.to(torch.float32).contiguous()
    key_d = lambda key: (key >> 32).to(torch.int32).view(torch.float32)
    keys = (d2.view(torch.int32).to(torch.int64) << 32) | torch.arange(R)[:, None]
    live = ~skip.repeat_interleave(C, dim=0)
    rounds = -(-R // lanes)
    pad = rounds * lanes - R
    keys = torch.cat([keys, torch.full((pad, N), none)]).view(rounds, lanes, N)
    live = torch.cat([live, torch.zeros((pad, N), dtype=torch.bool)]
                     ).view(rounds, lanes, N)
    d2 = torch.cat([d2, torch.zeros((pad, N))]).view(rounds, lanes, N)
    best = [torch.full((lanes, N), none) for _ in range(k)]
    for key, ok, d in zip(keys, live, d2):
        fifth = torch.where(best[k - 1] == none,
                            torch.full((lanes, N), NO_NEIGHBOUR_D2),
                            key_d(best[k - 1]))
        key = torch.where(ok & (d < fifth), key, torch.full_like(key, none))
        for j in range(k):
            best[j], key = torch.minimum(best[j], key), torch.maximum(best[j], key)
    rows, dist = [], []
    for _ in range(k):
        m = best[0].min(dim=0).values
        won = best[0] == m
        for j in range(k - 1):
            best[j] = torch.where(won, best[j + 1], best[j])
        best[k - 1] = torch.where(won, torch.full_like(m, none), best[k - 1])
        found = m != none
        rows.append(torch.where(found, m & 0xFFFFFFFF, torch.full_like(m, -1)))
        dist.append(torch.where(found, key_d(m),
                                torch.full((N,), NO_NEIGHBOUR_D2)))
    return torch.stack(rows), torch.stack(dist)


def argmin_picks(d2, skip):
    """The selection of the JAX kernel, in its own jnp operations."""
    C = d2.shape[0] // skip.shape[0]
    dd = jnp.asarray(d2.numpy()) + jnp.repeat(
        jnp.where(jnp.asarray(skip.numpy()), jax_fc._BIG, 0.0), C, axis=0)
    rows_iota = jnp.arange(dd.shape[0])[:, None]
    rows, dist = [], []
    for _ in range(K):
        am = jnp.argmin(dd, axis=0)
        rows.append(np.asarray(am))
        dist.append(np.asarray(jnp.min(dd, axis=0)))
        dd = jnp.where(rows_iota == am[None, :], jax_fc._BIG, dd)
    return (torch.from_numpy(np.stack(rows).astype(np.int64)),
            torch.from_numpy(np.stack(dist)))


def assert_same_selection(d2, skip, lanes=8):
    want_rows, want_d = argmin_picks(d2, skip)
    got_rows, got_d = select_lanes_ref(d2, skip, lanes=lanes)
    real = want_d < jax_fc._VALID_MAX
    np.testing.assert_array_equal(got_rows[real].numpy(), want_rows[real].numpy())
    np.testing.assert_array_equal(got_d[real].numpy(), want_d[real].numpy())
    assert bool((got_d[~real] >= jax_fc._VALID_MAX).all())
    # a skipped bucket's rows are never selected
    C = d2.shape[0] // skip.shape[0]
    picked = got_rows >= 0
    bucket = torch.where(picked, got_rows // C, 0)
    assert not bool((skip.gather(0, bucket) & picked).any())
    return int(real.sum())


@st.composite
def cases(draw):
    O = draw(st.integers(1, 9))
    C = draw(st.sampled_from([1, 3, 5, 8, 24]))
    N = draw(st.integers(1, 6))
    rs = np.random.RandomState(draw(st.integers(0, 2 ** 31 - 1)))
    levels = draw(st.integers(1, 12))          # few distinct values: many ties
    d2 = rs.randint(0, levels, (O * C, N)).astype(np.float32) * 0.25
    d2[rs.rand(O * C, N) < draw(st.sampled_from([0.0, 0.3, 0.9]))] = np.inf
    skip = rs.rand(O, N) < draw(st.sampled_from([0.0, 0.3, 1.0]))
    return (torch.from_numpy(d2), torch.from_numpy(skip),
            draw(st.sampled_from([4, 8, 16, 32])))


@settings(max_examples=150, deadline=None)
@given(cases())
def test_scheme_picks_what_argmin_picks(case):
    assert_same_selection(*case)


@pytest.mark.parametrize("lanes", [4, 8, 16, 32])
def test_main_path_shape_with_ties_and_duplicates(lanes):
    """216 rows a point as on the main path (27 rounds of 8 lanes; 7 of 32,
    the last one ragged); distances from a lattice, so equal distances
    abound."""
    rs = np.random.RandomState(0)
    O, C, N = 9, 24, 64
    d2 = (rs.randint(0, 40, (O * C, N)) * 0.01).astype(np.float32)
    d2[rs.rand(O * C, N) < 0.4] = np.inf              # empty slots
    skip = rs.rand(O, N) < 0.2                        # duplicate / bad ids
    skip[:, :4] = True                                # points with no bucket
    n_real = assert_same_selection(torch.from_numpy(d2), torch.from_numpy(skip),
                                   lanes)
    assert n_real > K * N // 2


def test_all_invalid_points_select_nothing():
    d2 = torch.full((216, 3), float("nan"))            # a non-finite query
    d2[:, 1] = float("inf")                            # an empty neighbourhood
    d2[:, 2] = 5.0
    skip = torch.zeros((9, 3), dtype=torch.bool)
    skip[:, 2] = True                                  # every bucket skipped
    rows, dist = select_lanes_ref(d2, skip)
    assert bool((rows == -1).all())
    assert bool((dist == NO_NEIGHBOUR_D2).all())


@pytest.mark.parametrize("lanes", [4, 32])
def test_first_row_wins_a_tie_across_lanes(lanes):
    d2 = torch.ones((40, 1))
    d2[[37, 11, 6]] = 0.5
    rows, dist = select_lanes_ref(d2, torch.zeros((5, 1), dtype=torch.bool),
                                     lanes=lanes)
    assert rows[:, 0].tolist() == [6, 11, 37, 0, 1]
    assert dist[:, 0].tolist() == [0.5, 0.5, 0.5, 1.0, 1.0]


@pytest.mark.parametrize("lanes", [4, 8, 16, 32])
def test_one_lane_may_hold_all_five(lanes):
    """The five nearest all on one lane's rows: its list must hold five."""
    R = 9 * 24
    d2 = torch.full((R, 1), 2.0)
    mine = [3 + lanes * t for t in (0, 1, 2, 4, 5)]
    d2[mine, 0] = torch.tensor([0.5, 0.4, 0.3, 0.2, 0.1])
    rows, dist = select_lanes_ref(d2, torch.zeros((9, 1), dtype=torch.bool),
                                     lanes=lanes)
    assert rows[:, 0].tolist() == mine[::-1]
    assert_same_selection(d2, torch.zeros((9, 1), dtype=torch.bool), lanes)
