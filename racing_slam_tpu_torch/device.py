"""Device and float32-precision settings of the port.

The port takes its device from the tensors it is handed; nothing here picks
a device. What this module fixes is precision: the JAX package runs its
geometry at HIGHEST matmul precision (racing_slam_tpu/ops/precision.py),
because sub-pixel thresholds are meaningless at a few decimal digits.
"""

from __future__ import annotations

import torch


def use_full_fp32() -> None:
    """Run float32 matmuls and convolutions in full float32, never TF32.

    PyTorch already keeps CUDA float32 matmuls in float32 by default, but
    cuDNN runs float32 convolutions in TF32 (about three decimal digits)
    unless told otherwise. Both switches are set here, at package import.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

