"""racing_slam_tpu_torch — the SLAM engine in PyTorch, with CUDA kernels for Hopper.

A port of ``racing_slam_tpu`` (JAX/Pallas), which stays beside it as the
reference. The module layout mirrors the JAX package so that every module
has a counterpart of the same name:

- ``ops``          : geometry, image stack, matching, bundle adjustment,
                     two-view geometry, as plain PyTorch on tensors.
- ``ops.kernels``  : the hand-written CUDA kernels (sources in ``csrc/``),
                     each with a plain-PyTorch twin that the CPU runs.
- ``models``       : the learned path, SuperPoint and LightGlue.
- ``slam``         : world state, frontends and the tracking pipeline.
- ``utils``        : synthetic sequences, JAX-state conversion, checkpoints,
                     video and mask readers, timers, trajectory and map dumps.
- ``run``          : the command line, ``python -m racing_slam_tpu_torch``.

Functions take their device from the tensors they are given; the entry
points that create state or weights default to the card and raise without
one unless given ``device="cpu"``. Importing the package turns TF32 off for
float32 matmuls and convolutions (see ``device``).
"""

from .device import use_full_fp32

use_full_fp32()

__version__ = "0.1.0"
