"""lio_slam_tpu_torch — the PyTorch + CUDA port of lio_slam_tpu.

The package mirrors `lio_slam_tpu`'s module paths and function names; the
JAX package stays the reference every module here is tested against
(`tests/test_torch_*.py`).  It imports torch and never jax.

Conventions:
- plain functions on tensors, `NamedTuple` state, an explicit `device`
  argument wherever a tensor is created;
- float32 geometry, int32 hashes that wrap like jnp's;
- the one TPU Pallas kernel (`lio_slam_tpu/ops/fused_corr.py`) is a CUDA C++
  kernel here (`ops/csrc/fused_corr.cu`), built with nvcc at first use and
  bound through ctypes; on CPU tensors its plain PyTorch version runs.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry needs full float32: TF32 keeps ~3 decimal digits, which breaks
# the GN normal equations and the 15x15 filter covariance exactly as bf16
# matmuls broke them on the TPU (lio_slam_tpu/__init__.py pins the JAX side,
# pipeline/imu_frontend.py the covariance algebra).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
