"""`lio_slam_tpu_torch.ops.features` against `lio_slam_tpu.ops.features`:
the projection and extraction cases of tests/test_features_formats.py,
pixels shared by two and three points at one range, and the square-room
scan of tests/test_corner_pipeline.py.

Tolerances: ranges and index image exact on scans whose beams sit at
column centres (elsewhere atan2 may move a point across a column edge by
an ulp); curvature, edge, surface and usable masks exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_helpers as H  # noqa: F401  (single-threaded torch)
from torch_port_helpers import n, t
from lio_slam_tpu.ops import features as jfeat
from lio_slam_tpu_torch.ops import features as tfeat


def room_scan(n_scan=16, horizon=360, half=8.0):
    """tests/test_corner_pipeline.py's square room, beams at column
    centres: (xyz, ring)."""
    rows, cols = np.meshgrid(np.arange(n_scan), np.arange(horizon),
                             indexing="ij")
    az = (cols + 0.5) / horizon * 2 * np.pi - np.pi
    elev = (rows / (n_scan - 1) - 0.2) * np.deg2rad(30.0)
    ca, sa = np.cos(az), np.sin(az)
    r_wall = half / np.maximum(np.abs(ca), np.abs(sa))
    xyz = np.stack([(r_wall * ca).astype(np.float32),
                    (r_wall * sa).astype(np.float32),
                    (r_wall * np.tan(elev)).astype(np.float32) + 1.0],
                   -1).reshape(-1, 3)
    return xyz, rows.reshape(-1).astype(np.int32)


def project_both(xyz, mask, ring, n_scan, horizon):
    j = jfeat.project_range_image(jnp.asarray(xyz), jnp.asarray(mask),
                                  jnp.asarray(ring), n_scan=n_scan,
                                  horizon=horizon)
    p = tfeat.project_range_image(t(xyz), t(mask), t(ring), n_scan, horizon)
    for a, b in zip(p, j):
        np.testing.assert_array_equal(n(a), n(b))
    return p


def test_projection_basic():
    xyz = np.array([[1, 0, 0], [0, 2, 0]], np.float32)
    ranges, valid, idx = project_both(xyz, np.ones(2, bool),
                                      np.array([0, 3], np.int32), 4, 8)
    assert int(n(valid).sum()) == 2
    assert float(ranges[0, 4]) == 1.0 and int(idx[3, 6]) == 1


def test_closest_point_wins():
    xyz = np.array([[1, 0, 0], [3, 0.0001, 0]], np.float32)
    ranges, _, idx = project_both(xyz, np.ones(2, bool), np.zeros(2, np.int32),
                                  1, 4)
    assert float(ranges[0, 2]) == 1.0 and int(idx[0, 2]) == 0


@pytest.mark.parametrize("order", [(0, 1), (1, 0), (0, 1, 2), (2, 0, 1),
                                   (1, 2, 0)])
def test_equal_ranges_in_one_pixel_pick_as_jax(order):
    """Two or three points at one range in one pixel, with a farther one
    and a masked one beside them: the index JAX's last write leaves (the
    highest index among the closest) is the port's."""
    same = np.array([[2, 0, 0], [0.0, 0, 2], [2, 0, 0]], np.float32)[:len(order)]
    same[:, 1] = [1e-4 * k for k in order]
    # all of them at range 2 (to float32), one pixel
    same = same / np.linalg.norm(same, axis=1, keepdims=True) * 2
    same[:, 2] = 0.0
    same[:, 0] = np.sqrt(4.0 - same[:, 1] ** 2)
    far = np.array([[5, 0.0002, 0], [1.0, 0.0003, 0]], np.float32)
    xyz = np.concatenate([far[:1], same, far[1:]]).astype(np.float32)
    mask = np.ones(len(xyz), bool)
    mask[-1] = False                  # the masked point would have won
    rng = np.linalg.norm(xyz, axis=1)
    _, _, idx = project_both(xyz, mask, np.zeros(len(xyz), np.int32), 1, 4)
    closest = np.flatnonzero(mask & (rng == rng[mask].min()))
    assert int(idx[0, 2]) == closest.max()


def test_projection_room_scan_exact():
    xyz, ring = room_scan()
    rs = np.random.RandomState(0)
    perm = rs.permutation(len(xyz))
    mask = rs.rand(len(xyz)) > 0.05
    _, valid, _ = project_both(xyz[perm], mask[perm], ring[perm], 16, 360)
    assert int(n(valid).sum()) == int(mask.sum())


def extract_both(ranges, valid, **kw):
    j = jfeat.extract_features(jnp.asarray(ranges), jnp.asarray(valid), **kw)
    p = tfeat.extract_features(t(ranges), t(valid), **kw)
    for name in ("edge_mask", "surf_mask", "valid"):
        np.testing.assert_array_equal(n(getattr(p, name)), n(getattr(j, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(n(p.curvature), n(j.curvature))
    return p


def step_scene(H=120):
    r = np.full(H, 10.0, np.float32)
    r[50:] = 5.0
    return r[None, :], np.ones((1, H), bool)


def test_corner_detected_surfaces_flat():
    f = extract_both(*step_scene(), num_sectors=2, edge_threshold=1.0,
                     surf_threshold=0.1)
    s = n(f.surf_mask[0])
    assert s[10:40].sum() > 20 and s[70:110].sum() > 20
    assert not s[46:54].any()


def test_flat_ring_has_no_edges():
    f = extract_both(np.full((1, 120), 10.0, np.float32), np.ones((1, 120), bool))
    assert int(n(f.edge_mask).sum()) == 0


def test_room_scan_features_exact():
    """The square room through the projection and the extraction: edges
    at the four wall intersections, every mask JAX's."""
    xyz, ring = room_scan()
    ranges, valid, _ = tfeat.project_range_image(
        t(xyz), t(np.ones(len(xyz), bool)), t(ring), 16, 360)
    f = extract_both(n(ranges), n(valid))
    assert int(n(f.edge_mask).sum()) > 8


def test_many_candidates_tie_and_suppress_as_jax():
    """Rings of walls with spikes close together (the +-5 suppression) and
    runs of equal curvature (ties decided by index), with holes."""
    rs = np.random.RandomState(1)
    ranges = np.full((4, 240), 8.0, np.float32)
    for row in range(4):
        spikes = rs.choice(np.arange(8, 232), 40, replace=False)
        ranges[row, spikes] += 0.25      # below the occlusion jump of 0.3
    valid = rs.rand(4, 240) > 0.05
    f = extract_both(ranges, valid, edge_threshold=0.5)
    assert int(n(f.edge_mask).sum()) > 10
