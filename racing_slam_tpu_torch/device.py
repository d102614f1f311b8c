"""Device and float32-precision settings of the port.

Functions take their device from the tensors they are handed. The entry
points that create state or weights (``Slam``, ``SuperPointFrontend``,
``LightGlueMatcher``, the weight loaders) default to the card and resolve
their ``device`` argument through `resolve_device`, which raises when no
card is there: running on the CPU is asked for with ``device="cpu"``.

The module also fixes precision: the JAX package runs its geometry at
HIGHEST matmul precision (racing_slam_tpu/ops/precision.py), because
sub-pixel thresholds are meaningless at a few decimal digits.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """`device` as a torch.device; raises for a CUDA device when no card is
    visible, so that an entry point never carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} asked for, but no CUDA card is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def use_full_fp32() -> None:
    """Run float32 matmuls and convolutions in full float32, never TF32.

    PyTorch already keeps CUDA float32 matmuls in float32 by default, but
    cuDNN runs float32 convolutions in TF32 (about three decimal digits)
    unless told otherwise. Both switches are set here, at package import.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

