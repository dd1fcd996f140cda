"""Multi-process rendezvous and placement (port of
`lio_slam_tpu/parallel/distributed.py`).

The JAX package joins its host processes with `jax.distributed`, after
which `jax.devices()` spans every host and one global ("slice", "data")
mesh is programmed as on one host.  The port runs one process per device
over `torch.distributed`: `initialize` joins them through torch's TCP store
(process 0 serves it), and `global_mesh` builds the same two-level mesh
over the group (`parallel/multislice.py`).

Settled departure: in the JAX package one host process holds several
devices, so its default mesh is one slice a process with "data" over the
process's devices.  Here a process is one device, so a slice is the ranks
of one host: `devices_per_slice` defaults to torchrun's LOCAL_WORLD_SIZE
when that is set, else to 1 (one slice a process, as the JAX default reads
on one-device hosts), and `n_slices` to the world size divided by it.

Nothing here picks a backend on failure or falls back to fewer processes:
a rendezvous that fails raises.  The port has no autodetection of a
cluster, where the JAX package autodetects on TPU pods.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from lio_slam_tpu_torch.parallel import mesh as mesh_mod
from lio_slam_tpu_torch.parallel import multislice

ENV = ("LIO_COORDINATOR", "LIO_NUM_PROCESSES", "LIO_PROCESS_ID")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               device_type: str = "cuda", backend: str | None = None,
               timeout_s: float | None = None) -> None:
    """Join the default process group at `coordinator_address` (host:port;
    process 0 serves the TCP store there) as process `process_id` of
    `num_processes`.  Each argument left None is read from LIO_COORDINATOR,
    LIO_NUM_PROCESSES and LIO_PROCESS_ID; one that is still missing raises
    RuntimeError with the names of the variables.

    The backend is NCCL for `device_type="cuda"` and gloo for "cpu", unless
    `backend` names one (gloo on CUDA tensors, for several ranks on one
    card).  A CUDA rank first makes its LOCAL_RANK card current.
    `timeout_s` bounds the rendezvous and each collective (torch's default
    when None)."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("LIO_COORDINATOR")
    if num_processes is None and "LIO_NUM_PROCESSES" in env:
        num_processes = int(env["LIO_NUM_PROCESSES"])
    if process_id is None and "LIO_PROCESS_ID" in env:
        process_id = int(env["LIO_PROCESS_ID"])
    missing = [name for name, v in zip(ENV, (coordinator_address,
                                             num_processes, process_id))
               if v is None]
    if missing:
        raise RuntimeError(
            "initialize needs the coordinator's host:port, the number of "
            "processes and this process's id: pass them or set "
            + ", ".join(missing))
    if device_type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    kwargs = ({} if timeout_s is None
              else {"timeout": timedelta(seconds=timeout_s)})
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            **kwargs)


def global_mesh(n_slices: int | None = None,
                devices_per_slice: int | None = None,
                device_type: str = "cuda"):
    """The ("slice", "data") mesh over every rank of the group `initialize`
    joined.  By default a slice is the ranks of one host (LOCAL_WORLD_SIZE,
    else 1: one slice a process); given `n_slices` alone, the ranks split
    evenly over them.  The mesh covers the whole group, so
    n_slices x devices_per_slice must be the world size."""
    if not dist.is_initialized():
        raise RuntimeError("global_mesh needs the process group: call "
                           "distributed.initialize first")
    world = dist.get_world_size()
    if devices_per_slice is None:
        devices_per_slice = (world // n_slices if n_slices is not None else
                             int(os.environ.get("LOCAL_WORLD_SIZE", 1)))
    if n_slices is None:
        n_slices = world // devices_per_slice
    return multislice.make_multislice_mesh(n_slices, devices_per_slice,
                                           device_type=device_type)


def replicated(mesh, x) -> torch.Tensor:
    """A host value, whole, on this rank's device.  Every rank passes the
    same value (the replicated-input contract; not checked, as in the JAX
    package)."""
    return torch.from_numpy(np.array(x)).to(mesh_mod.mesh_device(mesh))


def factor_sharded(mesh, x) -> torch.Tensor:
    """This rank's block of axis 0 of a full host copy, over the flattened
    ("slice", "data") index, on the rank's device: the factor layout of
    `multislice.shard_factors`, each rank taking only its own rows."""
    return multislice.shard_factors(mesh, torch.from_numpy(np.array(x)))
