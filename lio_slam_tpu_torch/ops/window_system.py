"""The keyframe save's window system on the card: the wrapper of
`csrc/window_system.cu`.

Each GN iteration of `graph/solver.solve_window_compact` solves H dx = b
over the last `window` keyframes: every factor touching them enters a
dense (6W)^2 system, poses outside the window are held fixed (their side
contributes error but no Jacobian block), and window slots past `count`
get an identity diagonal block.  `graph/solver.assemble_window` chooses:
a graph on the card comes here, a CPU graph runs the plain version
(`solver.assemble_window_plain`: every slot linearized with
`torch.func.jacfwd`, its blocks scattered).

- `assemble(graph, count, window)` -> (H (6W, 6W), b (6W,)) of a
  `graph.factors.PoseGraph` on the card.  A graph the kernel does not take
  (not float32 leaves, int32 indices and bool masks on one CUDA device, or
  a window over `MAX_WINDOW`) raises `ValueError`.
- The kernel linearizes only the factors that touch the window, by
  forward-mode dual numbers through the same error functions, and sums each
  output block in slot order with no atomics: the same inputs give the same
  bits on every run.  Its results equal the plain version's to float32
  rounding, not bit for bit (the card's transcendental functions and sum
  orders differ from torch's).
- The launch reads `count` on the device, reads nothing on the host and
  writes into `torch.empty` outputs, so it can be captured in a CUDA
  graph; nothing here waits for the device.
- A launch counts in `_build.LAUNCHES["window_system"]`
  (`ops/_build.launch`).
"""

from __future__ import annotations

import torch

from lio_slam_tpu_torch.ops import _build

# the kernel keeps a block row in shared memory (MAX_WINDOW in the source,
# which refuses a wider window itself)
MAX_WINDOW = 128

_FLOATS = ("poses", "prior_pose", "prior_info", "bt_meas", "bt_info",
           "gps_meas", "gps_info")
_INDICES = ("bt_i", "bt_j", "gps_i")      # the masks are the other leaves


def _check(graph, count: torch.Tensor, window: int):
    """Raise `ValueError` unless the kernel takes the graph: float32 leaves,
    int32 indices, bool masks and a 0-dim integer count on one CUDA device,
    and a window of 1 to MAX_WINDOW keyframes."""
    leaves = graph._asdict()
    dev = graph.poses.device
    bad = [f"{k} {x.dtype} on {x.device}" for k, x in leaves.items()
           if x.device != dev
           or x.dtype != (torch.float32 if k in _FLOATS else torch.int32
                          if k in _INDICES else torch.bool)]
    if dev.type != "cuda":
        bad.append(f"the graph on {dev}")
    if count.device != dev or count.dtype.is_floating_point \
            or count.dim() != 0:
        bad.append(f"count {count.dtype} {tuple(count.shape)} on "
                   f"{count.device}")
    if not 1 <= window <= MAX_WINDOW:
        bad.append(f"window {window}")
    if bad:
        raise ValueError("window_system takes float32 leaves, int32 indices, "
                         "bool masks and an integer count on one CUDA device "
                         f"and a window of 1 to {MAX_WINDOW}, got "
                         + ", ".join(bad))


def kernel_launch(lib, graph, count: torch.Tensor, window: int, stream):
    """One launch of the kernel through `lib` on `stream` (the card's
    build, or the tests' emulated one with CPU tensors and no stream):
    (cudaError_t, (H, b))."""
    g = type(graph)(*(x.contiguous() for x in graph))
    count = count.to(torch.int32)
    W = window
    dev = g.poses.device
    H = torch.empty((6 * W, 6 * W), dtype=torch.float32, device=dev)
    b = torch.empty(6 * W, dtype=torch.float32, device=dev)
    err = lib.lio_window_system(
        g.poses.data_ptr(), g.poses.shape[0], count.data_ptr(),
        g.prior_pose.data_ptr(), g.prior_info.data_ptr(), g.bt_i.data_ptr(),
        g.bt_j.data_ptr(), g.bt_meas.data_ptr(), g.bt_info.data_ptr(),
        g.bt_mask.data_ptr(), g.bt_i.shape[0], g.gps_i.data_ptr(),
        g.gps_meas.data_ptr(), g.gps_info.data_ptr(), g.gps_mask.data_ptr(),
        g.gps_i.shape[0], W, H.data_ptr(), b.data_ptr(), stream)
    return err, (H, b)


def assemble(graph, count: torch.Tensor, window: int):
    """(H (6W, 6W), b (6W,)) of the window solve's GN iteration at
    `graph.poses`, the window being the last `window` of `count` keyframes:
    one kernel launch on the graph's device."""
    _check(graph, count, window)
    return _build.launch("window_system", graph.poses.device, kernel_launch,
                         _build.load_kernels(), graph, count, window)
