"""Carry mission state between the JAX package and the port.

`from_numpy(tree, device)` takes the JAX package's `LioState` or
`ImuFrontendState` with numpy leaves (for example
`jax.tree.map(np.asarray, state)`) and returns the port's NamedTuple of
the same name on `device`.  Fields are matched by name, so any object with
the right attributes works.  `to_numpy(state)` returns the port's
NamedTuple with numpy leaves.  A sharded mission's state converts in its
global layout (the JAX Runner with a mesh holds it so; the port's
`Runner.global_state()` gathers it), and the sharded `MapOps.shard`
(`parallel/mission.py`) cuts a converted state to a rank's slice.
"""

from __future__ import annotations

import numpy as np
import torch

from lio_slam_tpu_torch.graph import factors as F
from lio_slam_tpu_torch.ops import preintegration as pre
from lio_slam_tpu_torch.ops import scancontext as sc_mod
from lio_slam_tpu_torch.ops import voxel_grid as vg
from lio_slam_tpu_torch.pipeline import imu_frontend as fe
from lio_slam_tpu_torch.pipeline import keyframes as kf
from lio_slam_tpu_torch.pipeline import lio

_NESTED = {
    lio.LioState: {"store": kf.KeyframeStore, "graph": F.PoseGraph,
                   "map_grid": vg.HashGrid, "sc_db": sc_mod.ScanContextDB},
    fe.ImuFrontendState: {"nav": pre.NavState},
}


def _build(cls, tree, device):
    nested = _NESTED.get(cls, {})
    kw = {}
    for name in cls._fields:
        leaf = getattr(tree, name)
        if name in nested:
            kw[name] = _build(nested[name], leaf, device)
        else:
            kw[name] = torch.from_numpy(np.array(leaf)).to(device)
    return cls(**kw)


def from_numpy(tree, device=None):
    """The port's `LioState` / `ImuFrontendState` from numpy leaves."""
    if hasattr(tree, "store") and hasattr(tree, "map_grid"):
        return _build(lio.LioState, tree, device)
    if hasattr(tree, "nav") and hasattr(tree, "bias_gyr"):
        return _build(fe.ImuFrontendState, tree, device)
    raise TypeError(f"not a LioState or ImuFrontendState: {type(tree)!r}")


def to_numpy(state):
    """The same NamedTuple with every tensor leaf as a numpy array."""
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(to_numpy(x) for x in state))
    return state
