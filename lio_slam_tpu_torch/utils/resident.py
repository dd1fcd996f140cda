"""Helpers of the device-resident path, which reads nothing back from the
card while it runs (the replay programs of `pipeline/replay.py`, captured
as CUDA graphs).

- `constant`: a tensor built from host numbers on the card is a
  host-to-device copy, which waits for the card and which a CUDA graph
  cannot capture.  The per-scan path takes such constants from here: each
  is made at its first use (an eager call, before any capture) and the
  same tensor is handed back afterwards.  Callers never write them.
- `select`: the counterpart of `lax.cond` over a state: both branches
  computed, one kept leaf by leaf on a device bool.
"""

from __future__ import annotations

import functools

import torch


def _frozen(values):
    if isinstance(values, (list, tuple)):
        return tuple(_frozen(v) for v in values)
    return values


@functools.lru_cache(maxsize=None)
def _made(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype, device) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype, device=device)` for a number or a
    nested sequence of numbers, made once per (values, dtype, device)."""
    return _made(_frozen(values), dtype, torch.device(device or "cpu"))


def select(cond: torch.Tensor, a, b):
    """`a` where the () bool tensor `cond` holds, else `b`: tensors through
    `torch.where`, NamedTuples and tuples leaf by leaf, anything else
    (None, host numbers) taken from `a`, where both must agree."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    if isinstance(a, tuple):
        leaves = [select(cond, x, y) for x, y in zip(a, b)]
        return type(a)(*leaves) if hasattr(a, "_fields") else tuple(leaves)
    if a != b:
        raise ValueError(f"select: the branches differ in a host value, "
                         f"{a!r} and {b!r}")
    return a


def at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """`x[i]` for a 0-dim integer tensor `i`, as a gather: `x[i]` itself
    turns `i` into a host integer (`item`), which waits for the card."""
    return x[i.reshape(1)][0]


def set_at_(x: torch.Tensor, i: torch.Tensor, value) -> None:
    """`x[i] = value` in place for a 0-dim integer tensor `i`, as a scatter
    (see `at`); a host number `value` is made on `x`'s device first (a host
    number assigned into a slot is a copy from a CPU tensor)."""
    if not isinstance(value, torch.Tensor):
        value = torch.full((), value, dtype=x.dtype, device=x.device)
    x[i.reshape(1)] = value
