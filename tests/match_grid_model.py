"""A numpy model of kernel K2's cell grid (csrc/match_kernel.cu `cell_grid`
and `cell_of`), in float32 as the kernel computes it on the device.

The kernel takes no grid from the host: it computes the keypoints' extent
and the grid in each CTA. This model is what the CPU tests
(tests/test_torch_match_grid.py) check the rule with, and what the card
tests (tests/test_torch_kernels.py) use to plant keypoints and points on
the kernel's cell borders, where the kernel must still agree with its twin;
a change of the rule in the .cu has to be made here too.
"""

import numpy as np

CELL_CAP = 64  # cells per side at most (csrc/match_kernel.cu CAP)


def cell_grid(kp_uv: np.ndarray, kp_ok: np.ndarray, radius_px: float, cap: int = CELL_CAP):
    """The kernel's cell grid over the gated keypoints: (lo_u, lo_v, side,
    nx, ny), or None when no keypoint passes its gate. The side is at least
    the radius (with a 1/256 margin against rounding) and at least the
    extent over `cap`, so every keypoint within the radius of a point lies
    in the point's 3 x 3 cells (`cell_of` clamps both to the grid)."""
    f = np.float32
    uv = np.asarray(kp_uv, f)[np.asarray(kp_ok, bool)]
    if len(uv) == 0:
        return None
    lo_u, lo_v = np.nanmin(uv[:, 0]), np.nanmin(uv[:, 1])
    eu, ev = np.nanmax(uv[:, 0]) - lo_u, np.nanmax(uv[:, 1]) - lo_v
    radius = np.sqrt(max(f(radius_px * radius_px), f(0)))
    side = max(radius * f(1 + 1 / 256), eu / f(cap), ev / f(cap), f(1e-6))
    n = [int(min(f(cap), np.floor(e / side) + f(1))) for e in (eu, ev)]
    return lo_u, lo_v, side, n[0], n[1]


def cell_of(x: np.ndarray, lo: np.float32, side: np.float32, n: int) -> np.ndarray:
    """Cell coordinate of float32 positions x, clamped to [0, n - 1]: the
    kernel's floor((x - lo) * (1 / side)), in float32."""
    inv = np.float32(1) / np.float32(side)
    with np.errstate(invalid="ignore"):
        q = np.floor((np.asarray(x, np.float32) - np.float32(lo)) * inv)
    return np.fmin(np.fmax(q, np.float32(0)), np.float32(n - 1)).astype(np.int64)
