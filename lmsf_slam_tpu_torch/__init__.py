"""lmsf_slam_tpu_torch — the lifelong LiDAR SLAM engine in PyTorch, for CUDA.

A port of :mod:`lmsf_slam_tpu` (the JAX reference, which stays in the
repository unchanged) to PyTorch on an NVIDIA Hopper card. Module layout and
names mirror the reference so each counterpart is easy to find:
``common`` (SE(3) algebra, point batches), ``ops`` (preprocess, voxel,
features, neighbour search, registration and alignment evaluation, scan
context), ``tracker``, ``backend`` (keyframe database with its device mirror,
pose graph, loop closure, the lifelong mode machine), ``system``
(``MultiLidarSystem``, the fused per-frame step, the keyframe gate, the YAML
config loader), ``datasets`` (ray-cast simulator), ``evaluation`` (ATE) and
``utils`` (stage timers).

The public entry point::

    from lmsf_slam_tpu_torch.system import MultiLidarSystem, SystemConfig
    system = MultiLidarSystem(SystemConfig())      # device="cuda"
    result = system.process(scan, timestamp)       # a FrameResult every frame

The one TPU kernel of the reference, the fused k-NN of
``lmsf_slam_tpu/ops/pallas_knn.py``, is a pair of hand-written CUDA kernels
here (``csrc/knn.cu``: a scan over reference slices and a merge), built with
``nvcc`` on first use and bound with ``ctypes`` (:mod:`.ops.knn`). Everything
else is plain torch.

Entry points take ``device=`` and default to ``"cuda"``; tests pass
``device="cpu"``, where each kernel wrapper takes its plain torch version.

This package never imports ``jax`` or ``lmsf_slam_tpu``.
"""

__version__ = "0.1.0"

import torch as _torch

# SLAM is geometry: SE(3) products, 3×3 covariances and 6×6 normal equations
# must be true float32 (the counterpart of the reference's
# ``jax_default_matmul_precision = "float32"``). TF32 keeps ~3 decimal digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
