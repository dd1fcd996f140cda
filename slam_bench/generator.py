"""The benchmark's traffic generator: a world, a route, a spinning lidar and
an IMU, all made on the device from `--seed`.

A frozen copy, rewritten in plain torch, of the sweep model of the port's
synthetic missions (`make_world`, `make_sweep_trajectory`, `observe_sweep`
and the IMU windows of `make_imu_windows`): each return is a world point
seen through a discrete beam, drawn with weight 1/d^2, and expressed in
the body frame the platform had at the instant the beam swept its azimuth.
What differs from that model, so that a cell is a deployment:

- the world is laid out along the route (ground, and box buildings kept
  off the route), dense enough that every scan holds the sensor's full
  count of returns, and wider than the sensor's range on every side;
- every point carries its exact time within the sweep (no time bins);
- the IMU is one stream at the configuration's rate with the noise its
  densities state, and each scan's window is a slice of it: the samples
  since the previous scan and those that cover the sweep.

A traffic mix (a JSON file under `traffic/`) gives the route and the
world's densities; a configuration (under `configs/`) gives the sensor and
the IMU.  The same seed gives the same inputs; every seed gives the same
sizes (scans, returns a scan, IMU samples a window) and the same route.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

SCAN_PERIOD = 0.1          # s between scans (10 Hz), also the sweep time
FINE_DT = 1e-3             # s, the trajectory's sampling for interpolation
POINT_NOISE = 0.01         # m, each coordinate of a return


class Inputs(NamedTuple):
    """A mission's inputs, on the device.  Scan i is stamped `i * 0.1` s;
    its IMU window holds the samples in (t_{i-1}, t_i + 0.1]."""

    xyz: torch.Tensor       # (N, P, 3) float32 body-frame returns
    ptime: torch.Tensor     # (N, P) float32 seconds since the sweep start
    ring: torch.Tensor      # (N, P) int32 beam index
    pmask: torch.Tensor     # (N, P) bool (all true: full count)
    acc: torch.Tensor       # (N, W, 3) float32 specific force, body frame
    gyr: torch.Tensor       # (N, W, 3) float32 body rate
    quat: torch.Tensor      # (N, W, 4) float32 orientation (x, y, z, w)
    dts: torch.Tensor       # (N, W) float32
    rel_t: torch.Tensor     # (N, W) float32 sample time - scan stamp
    imask: torch.Tensor     # (N, W) bool
    stamps: torch.Tensor    # (N,) float64
    truth: torch.Tensor     # (N, 4, 4) float64 body-to-world at each stamp


def rpy_matrix(rpy: torch.Tensor) -> torch.Tensor:
    """R = Rz(yaw) Ry(pitch) Rx(roll), (..., 3) -> (..., 3, 3)."""
    r, p, y = rpy.unbind(-1)
    cr, sr, cp, sp, cy, sy = (torch.cos(r), torch.sin(r), torch.cos(p),
                              torch.sin(p), torch.cos(y), torch.sin(y))
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        torch.stack([-sp, cp * sr, cp * cr], -1)], -2)


def _so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation vector of small rotations (..., 3, 3) -> (..., 3)."""
    cos = ((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5).clamp(-1, 1)
    theta = torch.acos(cos)
    k = torch.where(theta < 1e-9, torch.full_like(theta, 0.5),
                    theta / (2.0 * torch.sin(theta).clamp(min=1e-30)))
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    return v * k[..., None]


def _quat_xyzw(R: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) of rotation matrices with w > 0."""
    w = 0.5 * torch.sqrt((1.0 + R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]).clamp(min=1e-12))
    x = (R[..., 2, 1] - R[..., 1, 2]) / (4.0 * w)
    y = (R[..., 0, 2] - R[..., 2, 0]) / (4.0 * w)
    z = (R[..., 1, 0] - R[..., 0, 1]) / (4.0 * w)
    return torch.stack([x, y, z, w], -1)


class Route(NamedTuple):
    """The platform's trajectory sampled every FINE_DT seconds."""

    rpy: torch.Tensor       # (F, 3) float64
    pos: torch.Tensor       # (F, 3) float64
    vel: torch.Tensor       # (F, 3) float64 world velocity


def make_route(traffic: dict, duration: float, device) -> Route:
    """The route of a traffic mix: `"open"`, a weave whose heading swings
    by `weave_rad` over `weave_period_s` and never turns back, or
    `"circuit"`, a circle of `radius_m`.  The platform starts at rest at
    the origin, heading +x, and reaches `speed_mps` over `ramp_s`; its
    height, roll and pitch oscillate gently."""
    f64 = dict(dtype=torch.float64, device=device)
    n = int(math.ceil(duration / FINE_DT)) + 2
    t = torch.arange(n, **f64) * FINE_DT
    s = torch.clamp(t / traffic["ramp_s"], 0.0, 1.0)
    v = traffic["speed_mps"] * s
    if traffic["route"] == "open":
        yaw = traffic["weave_rad"] * torch.sin(2 * math.pi * t / traffic["weave_period_s"])
    elif traffic["route"] == "circuit":
        yaw = torch.cumsum(v / traffic["radius_m"], 0) * FINE_DT
    else:
        raise ValueError(f"unknown route {traffic['route']!r}")
    x = torch.cumsum(v * torch.cos(yaw), 0) * FINE_DT
    y = torch.cumsum(v * torch.sin(yaw), 0) * FINE_DT
    z = traffic["height_m"] + 0.1 * torch.sin(0.5 * t) * s
    roll = 0.02 * torch.sin(0.7 * t) * s
    pitch = 0.02 * torch.sin(0.9 * t) * s
    pos = torch.stack([x, y, z], 1)
    vel = torch.gradient(pos, spacing=FINE_DT, dim=0)[0]
    return Route(rpy=torch.stack([roll, pitch, yaw], 1), pos=pos, vel=vel)


def route_at(route: Route, t: torch.Tensor):
    """(R (..., 3, 3), p (..., 3)) at times t (...,), float64, by linear
    interpolation of the sampled route."""
    u = (t / FINE_DT).clamp(0, route.pos.shape[0] - 2)
    i = torch.floor(u).long()
    a = (u - i)[..., None]
    rpy = route.rpy[i] * (1 - a) + route.rpy[i + 1] * a
    pos = route.pos[i] * (1 - a) + route.pos[i + 1] * a
    return rpy_matrix(rpy), pos


def make_world(route: Route, traffic: dict, sensor: dict, gen: torch.Generator,
               device) -> torch.Tensor:
    """(M, 3) float32 world points: a ground plane over the route's extent
    and `sensor["max_range_m"]` beyond it, and box buildings
    (`box_per_km2`) whose walls keep `clear_m` from the route."""
    f64 = dict(dtype=torch.float64, device=device)
    margin = sensor["max_range_m"] + 5.0
    lo = route.pos[:, :2].min(0).values - margin
    hi = route.pos[:, :2].max(0).values + margin
    area = float(torch.prod(hi - lo))

    def uniform(n, a, b):
        return a + (b - a) * torch.rand(n, generator=gen, **f64)

    n_ground = int(area * traffic["ground_per_m2"])
    ground = torch.stack([uniform(n_ground, float(lo[0]), float(hi[0])),
                          uniform(n_ground, float(lo[1]), float(hi[1])),
                          torch.zeros(n_ground, **f64)], 1)
    n_box = int(area * traffic["box_per_km2"] * 1e-6)
    cx = uniform(n_box, float(lo[0]), float(hi[0]))
    cy = uniform(n_box, float(lo[1]), float(hi[1]))
    half = 0.5 * uniform(n_box, traffic["box_size_m"][0], traffic["box_size_m"][1])
    height = uniform(n_box, traffic["box_height_m"][0], traffic["box_height_m"][1])
    turn = uniform(n_box, 0.0, math.pi / 2)
    track = route.pos[::1000, :2]                       # a sample a second
    gap = torch.cdist(torch.stack([cx, cy], 1), track).min(1).values
    keep = gap > traffic["clear_m"] + half * math.sqrt(2.0)
    cx, cy, half, height, turn = (a[keep] for a in (cx, cy, half, height, turn))
    # each wall: a face of the box, its points by its area
    faces = []
    per = traffic["wall_per_m2"]
    for k in range(4):
        ang = turn + k * math.pi / 2
        n_face = (2 * half * height * per).long().clamp(min=1)
        owner = torch.repeat_interleave(torch.arange(len(cx), device=device), n_face)
        m = int(n_face.sum())
        along = uniform(m, -1.0, 1.0) * half[owner]
        up = uniform(m, 0.0, 1.0) * height[owner]
        c, s = torch.cos(ang[owner]), torch.sin(ang[owner])
        # the face's centre is `half` out along its normal (c, s)
        px = cx[owner] + half[owner] * c - along * s
        py = cy[owner] + half[owner] * s + along * c
        faces.append(torch.stack([px, py, up], 1))
    world = torch.cat([ground, *faces])
    world = world + POINT_NOISE * torch.randn(world.shape, generator=gen, **f64)
    return world.to(torch.float32)


def observe(world: torch.Tensor, route: Route, t0: float, sensor: dict,
            gen: torch.Generator):
    """One sweep from stamp `t0`: (xyz (P, 3) float32, ptime (P,) float32,
    ring (P,) int32) of P = `sensor["returns"]` points.  Raises when the
    world holds fewer visible on-beam points than that."""
    dev = world.device
    P = sensor["returns"]
    n_beam = sensor["beams"]
    R0, p0 = route_at(route, torch.tensor(t0, dtype=torch.float64, device=dev))
    w64 = world.to(torch.float64)
    b0 = (w64 - p0) @ R0                                 # R0^T (w - p0), rows
    d = torch.linalg.norm(b0, dim=1)
    elev = torch.rad2deg(torch.asin((b0[:, 2] / d.clamp(min=1e-6)).clamp(-1, 1)))
    spacing = (sensor["fov_up_deg"] - sensor["fov_down_deg"]) / (n_beam - 1)
    ring = torch.round((elev - sensor["fov_down_deg"]) / spacing)
    tol = min(0.35, 0.5 * spacing)
    on_beam = torch.abs(elev - (sensor["fov_down_deg"] + ring * spacing)) < tol
    vis = ((d < sensor["max_range_m"]) & (d > 0.8) & (ring >= 0)
           & (ring < n_beam) & on_beam)
    idx = torch.nonzero(vis).squeeze(1)
    if idx.numel() < P:
        raise RuntimeError(f"the world shows {idx.numel()} on-beam points at "
                           f"t={t0:.1f} s, fewer than the sensor's {P} returns")
    u = torch.rand(idx.numel(), generator=gen, dtype=torch.float64, device=dev)
    keys = -2.0 * torch.log(d[idx]) - torch.log(-torch.log(u.clamp(1e-300, 1.0)))
    sel = idx[torch.topk(keys, P).indices]
    az = torch.remainder(torch.atan2(b0[sel, 1], b0[sel, 0]), 2 * math.pi)
    ptime = az / (2 * math.pi) * SCAN_PERIOD
    R, p = route_at(route, t0 + ptime)
    body = ((w64[sel] - p)[:, None, :] @ R)[:, 0, :]     # R(t)^T (w - p(t))
    body = body + POINT_NOISE * torch.randn(body.shape, generator=gen,
                                            dtype=torch.float64, device=dev)
    return (body.to(torch.float32), ptime.to(torch.float32),
            ring[sel].to(torch.int32))


def imu_stream(route: Route, n_samples: int, imu: dict, gen: torch.Generator):
    """Samples k = 1..n_samples at k / rate: (gyr, acc, quat), float64.
    The gyro reads the mean body rate over the sample's interval, the
    accelerometer the mean specific force, each with white noise of the
    configuration's density times sqrt(rate)."""
    dev = route.pos.device
    rate = imu["rate_hz"]
    tk = torch.arange(n_samples + 1, dtype=torch.float64, device=dev) / rate
    R, _ = route_at(route, tk)
    u = (tk / FINE_DT).clamp(0, route.pos.shape[0] - 2)
    i = torch.floor(u).long()
    a = (u - i)[:, None]
    vel = route.vel[i] * (1 - a) + route.vel[i + 1] * a
    gyr = _so3_log(R[:-1].transpose(-1, -2) @ R[1:]) * rate
    Rm, _ = route_at(route, tk[1:] - 0.5 / rate)
    a_w = (vel[1:] - vel[:-1]) * rate
    a_w[:, 2] += imu["gravity"]
    acc = (a_w[:, None, :] @ Rm)[:, 0, :]               # Rm^T a_w
    sq = math.sqrt(rate)
    gyr = gyr + imu["gyr_noise"] * sq * torch.randn(gyr.shape, generator=gen,
                                                    dtype=torch.float64, device=dev)
    acc = acc + imu["acc_noise"] * sq * torch.randn(acc.shape, generator=gen,
                                                    dtype=torch.float64, device=dev)
    return gyr, acc, _quat_xyzw(R[1:])


def make_inputs(config: dict, traffic: dict, seed: int, n_scans: int,
                device) -> Inputs:
    """`n_scans` scans of the traffic mix's route for the configuration's
    sensor and IMU, made on `device` from `seed`."""
    sensor, imu = config["sensor"], config["imu"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    duration = (n_scans + 2) * SCAN_PERIOD
    route = make_route(traffic, duration, device)
    world = make_world(route, traffic, sensor, gen, device)
    scans = [observe(world, route, i * SCAN_PERIOD, sensor, gen)
             for i in range(n_scans)]
    xyz, ptime, ring = (torch.stack(c) for c in zip(*scans))
    del world
    T = int(round(imu["rate_hz"] * SCAN_PERIOD))        # samples a scan
    gyr, acc, quat = imu_stream(route, (n_scans + 1) * T, imu, gen)
    W = config["imu_window"]
    if 2 * T > W:
        raise ValueError(f"{2 * T} IMU samples a window exceed its {W} slots")
    f32 = dict(dtype=torch.float32, device=device)
    win = lambda shape: torch.zeros((n_scans, W) + shape, **f32)
    wa, wg, wq = win((3,)), win((3,)), win((4,))
    dts, rel = win(()), win(())
    imask = torch.zeros((n_scans, W), dtype=torch.bool, device=device)
    # scan i (>= 1): samples (i-1)*T+1 .. (i+1)*T, the last T cover its sweep
    k = torch.arange(2 * T, device=device)
    for i in range(1, n_scans):
        src = (i - 1) * T + k                            # 0-based sample index
        wg[i, :2 * T] = gyr[src].float()
        wa[i, :2 * T] = acc[src].float()
        wq[i, :2 * T] = quat[src].float()
        dts[i, :2 * T] = 1.0 / imu["rate_hz"]
        rel[i, :2 * T] = ((src + 1).double() / imu["rate_hz"]
                          - i * SCAN_PERIOD).float()
        imask[i, :2 * T] = True
    stamps = torch.arange(n_scans, dtype=torch.float64, device=device) * SCAN_PERIOD
    R, p = route_at(route, stamps)
    truth = torch.eye(4, dtype=torch.float64, device=device).repeat(n_scans, 1, 1)
    truth[:, :3, :3], truth[:, :3, 3] = R, p
    return Inputs(xyz=xyz, ptime=ptime, ring=ring,
                  pmask=torch.ones(xyz.shape[:2], dtype=torch.bool, device=device),
                  acc=wa, gyr=wg, quat=wq, dts=dts, rel_t=rel, imask=imask,
                  stamps=stamps, truth=truth)


def revisits(positions: torch.Tensor, stamps: torch.Tensor, radius: float,
             time_diff: float) -> torch.Tensor:
    """(N,) bool: scan i comes within `radius` of a place passed more than
    `time_diff` seconds before it (the loop detector's candidate rule)."""
    d = torch.cdist(positions[:, :2], positions[:, :2])
    old = (stamps[:, None] - stamps[None, :]) > time_diff
    return ((d < radius) & old).any(1)
