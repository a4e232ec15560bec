"""lis_slam_torch — the PyTorch + CUDA port of lis_slam_tpu.

Mirrors `lis_slam_tpu/`'s module layout so each counterpart is easy to
find. Plain tensor code is PyTorch; the two Pallas TPU kernels of the
front-end odometry step are hand-written CUDA C++ for Hopper under
`csrc/` (built with nvcc at first use, loaded through ctypes). Nothing
here imports JAX: the host-side numpy modules the port needs (`config`,
`labels`, `io/synthetic`, `utils/se3_np`) are copies, pinned to the
originals by tests/test_torch_host.py.
"""

import torch

# Geometry is float32 throughout and correctness-critical (transforms,
# Jacobians, 6x6 normal equations). TF32 keeps ~3 decimal digits, which
# breaks ICP convergence — the counterpart of the JAX package forcing
# "highest" matmul precision (lis_slam_tpu/__init__.py).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
