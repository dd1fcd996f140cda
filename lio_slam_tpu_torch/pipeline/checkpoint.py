"""Checkpoint / resume of the full SLAM state (port of
`lio_slam_tpu/pipeline/checkpoint.py`).

The reference has no mid-run checkpoint: persistence is the PCD export
service, and resume is a stub (`common_lib::remapping` returns -1,
`lib/common_lib.cpp:38-43`).  Here `LioState` and the IMU front-end state
are NamedTuples of fixed-shape tensors, so a checkpoint is a flat save and
restore.

Format (the JAX package's format 2, so a checkpoint written by either
package loads in the other): one .npz holding `__manifest__` (JSON: format
version, leaf counts, metadata) and the leaves in NamedTuple field order,
depth first, as `leaf_%04d` for the `LioState` and `imu_leaf_%04d` for the
`ImuFrontendState`.  The field order of every NamedTuple in those trees
equals the JAX package's, which is what makes the positional leaves line
up.  No pickle.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from lio_slam_tpu_torch.config import Config
from lio_slam_tpu_torch.pipeline import imu_frontend as fe
from lio_slam_tpu_torch.pipeline import lio

# v2: LioState grew `evict_count`; leaves are positional, so the layout is
# versioned
FORMAT_VERSION = 2


def _leaves(tree) -> list:
    """The tensors of a NamedTuple tree in field order, depth first (the
    order of `jax.tree_util.tree_flatten`)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree]


def _rebuild(template, leaves):
    """`template`'s NamedTuple tree with its tensors replaced, in order, by
    the next items of the iterator `leaves`."""
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(x, leaves) for x in template))
    return next(leaves)


def save_checkpoint(path: str, state: lio.LioState,
                    imu_state: fe.ImuFrontendState | None = None,
                    metadata: dict | None = None) -> None:
    """Write `state` (and `imu_state`) to `path` atomically: a temporary
    file, then `os.replace`."""
    host = lambda x: x.detach().cpu().numpy()
    leaves = _leaves(state)
    arrays = {f"leaf_{i:04d}": host(x) for i, x in enumerate(leaves)}
    n_imu = 0
    if imu_state is not None:
        ileaves = _leaves(imu_state)
        arrays.update({f"imu_leaf_{i:04d}": host(x)
                       for i, x in enumerate(ileaves)})
        n_imu = len(ileaves)
    manifest = {"format_version": FORMAT_VERSION, "n_lio_leaves": len(leaves),
                "n_imu_leaves": n_imu, "metadata": metadata or {}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, __manifest__=json.dumps(manifest), **arrays)
    os.replace(tmp, path)          # atomic


def load_checkpoint(path: str, cfg: Config, device=None, ops=None):
    """(lio_state, imu_state or None, metadata) on `device`.

    The leaves are grafted onto states freshly built for `cfg`, so shapes
    are checked leaf by leaf: a capacity mismatch raises a ValueError that
    names the leaf.  With a sharded `ops` (`parallel/mission.py`) the file
    holds the global layout, as the JAX Runner with a mesh writes it, and
    each rank keeps its slice (building the template gathers: every rank
    calls this)."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["__manifest__"]))
        if manifest["format_version"] != FORMAT_VERSION:
            raise ValueError(f"checkpoint format {manifest['format_version']} "
                             f"!= supported {FORMAT_VERSION}")

        def restored(template, prefix):
            new = []
            for i, tmpl in enumerate(_leaves(template)):
                arr = z[f"{prefix}{i:04d}"]
                if arr.shape != tuple(tmpl.shape):
                    raise ValueError(
                        f"checkpoint leaf {i} shape {arr.shape} != config "
                        f"shape {tuple(tmpl.shape)}: was the checkpoint "
                        "written with a different StaticConfig?")
                new.append(torch.from_numpy(np.array(arr)).to(
                    device=tmpl.device, dtype=tmpl.dtype))
            return _rebuild(template, iter(new))

        if ops is None:
            state = restored(lio.init_state(cfg, device=device), "leaf_")
        else:
            state = ops.shard(restored(
                ops.gather(lio.init_state(cfg, device=device, ops=ops)),
                "leaf_"))
        imu_state = None
        if manifest["n_imu_leaves"]:
            imu_state = restored(fe.init_state(device=device), "imu_leaf_")
    return state, imu_state, manifest["metadata"]
