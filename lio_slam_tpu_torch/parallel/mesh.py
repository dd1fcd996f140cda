"""Device mesh and collectives (port of `lio_slam_tpu/parallel/mesh.py`).

The JAX package runs one controller over a `jax.sharding.Mesh`: a sharded
array is one global value and `shard_map` bodies reduce with `psum` /
`all_gather` over a named axis.  The port runs one process per device (SPMD
over `torch.distributed`), each holding only its own slice of a sharded
value, on a `torch.distributed.device_mesh.DeviceMesh`:

    jax.lax.psum        -> `psum`        (dist.all_reduce)
    jax.lax.all_gather  -> `all_gather`  (the list form of dist.all_gather)
    jax.lax.axis_index  -> `axis_index`  (the rank along the mesh dim)
    P(axis) placement   -> `shard_points` (rank d keeps rows [d N/D, (d+1) N/D))
    the global view     -> `gather_sharded` (the JAX layout of a sharded leaf)

The process group's backend is the caller's choice
(`dist.init_process_group("gloo" | "nccl")`); nothing here picks or
switches one.  Both take CUDA tensors for every collective used here
(gloo stages them through host memory inside the collective); all
computation stays on the tensors' device.

Each collective runs inside a `torch.profiler.record_function` range
("collective:psum", "collective:all_gather"), so a profiled run reads the
time spent in them; outside a profile a range costs about a microsecond.

A value that comes out of `psum` / `all_gather` is bit-identical on every
rank, which is what keeps the ranks' host branches (GN convergence, the
keyframe gate, the solver's loop flag) in step: a rank that branched on a
value of its own would issue different collectives and hang the others.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _init_from_env(device_type: str):
    """Initialize the default process group from torchrun's environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT): NCCL for CUDA meshes,
    gloo for CPU ones.  A CUDA rank first makes its LOCAL_RANK card the
    current one, which `mesh_device` and NCCL then use."""
    if "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            "make_mesh needs an initialized process group: call "
            "torch.distributed.init_process_group first, or launch under "
            "torchrun")
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo")


def make_mesh(n_devices: int | None = None, axis: str = "data",
              device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh named `axis` over every rank of the default process group
    (initialized from torchrun's environment when it is not yet).
    `n_devices` other than the world size raises: each rank is one
    device."""
    if not dist.is_initialized():
        _init_from_env(device_type)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh(n_devices={n_devices}): the process "
                         f"group has {world} ranks, one a device")
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


def make_mesh_2d(n_slices: int, n_data: int, axes=("slice", "data"),
                 device_type: str = "cuda") -> DeviceMesh:
    """An (n_slices, n_data) mesh over the whole process group, rank
    s * n_data + d at (s, d): the 2-D mesh the sparse solver's Woodbury
    columns can be split over."""
    if not dist.is_initialized():
        _init_from_env(device_type)
    if n_slices * n_data != dist.get_world_size():
        raise ValueError(f"a ({n_slices}, {n_data}) mesh needs "
                         f"{n_slices * n_data} ranks, the group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, (n_slices, n_data),
                            mesh_dim_names=tuple(axes))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device in `mesh`: for CUDA the current card (the
    LOCAL_RANK one when `make_mesh` initialized the group; else the caller
    sets it with `torch.cuda.set_device` before building the mesh)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str = "data") -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str = "data") -> int:
    """This rank's coordinate along `axis` (jax.lax.axis_index)."""
    return mesh.get_local_rank(axis)


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def flat_size(mesh: DeviceMesh, axes) -> int:
    n = 1
    for ax in _axes(axes):
        n *= axis_size(mesh, ax)
    return n


def flat_index(mesh: DeviceMesh, axes) -> int:
    """This rank's index over several axes, the first the slowest (the
    order of JAX's P(("slice", "data")))."""
    i = 0
    for ax in _axes(axes):
        i = i * axis_size(mesh, ax) + axis_index(mesh, ax)
    return i


def shard_points(mesh: DeviceMesh, arr: torch.Tensor, axis: str = "data",
                 dim: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of `arr` along `dim`: the rows JAX's
    P(axis) places on device d.  The size must divide by the mesh's."""
    n = axis_size(mesh, axis)
    size = arr.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not divide by the "
                         f"mesh size {n}")
    chunk = size // n
    return arr.narrow(dim, axis_index(mesh, axis) * chunk, chunk)


def replicate(mesh: DeviceMesh, tree):
    """`tree` (tensors, NamedTuples or tuples of them) on this rank's device:
    a replicated value is held whole by every rank."""
    dev = mesh_device(mesh)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, tuple):
        vals = [replicate(mesh, x) for x in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def psum(x: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """The sum of `x` over the ranks of `axis` (jax.lax.psum); `x` is not
    modified."""
    x = x.clone()
    with torch.profiler.record_function("collective:psum"):
        dist.all_reduce(x, group=mesh.get_group(axis))
    return x


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis="data") -> torch.Tensor:
    """(D, *x.shape): every rank's `x` stacked in rank order along `axis`
    (jax.lax.all_gather).  With several axes the stack is over their
    flattened index, the first axis the slowest."""
    shape = tuple(x.shape)
    x = x.contiguous()
    with torch.profiler.record_function("collective:all_gather"):
        for ax in reversed(_axes(axis)):
            parts = [torch.empty_like(x) for _ in range(axis_size(mesh, ax))]
            dist.all_gather(parts, x, group=mesh.get_group(ax))
            x = torch.stack(parts)
    return x.reshape((-1,) + shape)


def gather_sharded(x: torch.Tensor, mesh: DeviceMesh, dim: int = 0,
                   axis: str = "data") -> torch.Tensor:
    """The global view of a leaf sharded along `dim` (the JAX package's
    layout): every rank's slice, concatenated in rank order."""
    parts = all_gather(x, mesh, axis)
    return torch.cat(list(parts.unbind(0)), dim=dim)
