"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain twins.

Each module holds one kernel's wrapper, its plain-PyTorch twin
(``<fn>_reference``, same signature), an integer ``launches`` counter, and a
note on what it replaces and what bounds it. A wrapper sends CPU tensors to
the twin and CUDA tensors to the kernel; it never falls back from one to the
other. The CUDA sources live in ``racing_slam_tpu_torch/csrc`` and are built
on first use by ``_build``.
"""
