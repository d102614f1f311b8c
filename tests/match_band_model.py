"""A numpy model of kernel K5's candidate run (csrc/match_banded_kernel.cu
`lower_bound_warp` and the walk after it), in float32 as the kernel
computes it on the device.

The band is sorted so that key(k) = kp_ok[k] ? v_k : +inf does not
decrease. For a point at (u, v) the kernel searches the first key >=
v - reach with 32 probes a round, then walks 32 keypoints at a time until
a round holds a key > v + reach, testing the full pixel gate on the way.
The CPU tests (tests/test_torch_matching.py) check with this model that
the run holds every keypoint the gate passes; a change of the rule in the
.cu has to be made here too.
"""

import numpy as np

f32 = np.float32


def band_keys(kp_uv: np.ndarray, kp_ok: np.ndarray) -> np.ndarray:
    """The kernel's staged keys: v of a gated keypoint, +inf otherwise."""
    return np.where(np.asarray(kp_ok, bool), np.asarray(kp_uv, f32)[:, 1], f32(np.inf)).astype(f32)


def reach(radius_sq: float) -> np.float32:
    """The half-height of the run: the radius with a margin of 1/256 and
    1e-3 px, so that float rounding cannot leave a passing pair outside."""
    return np.sqrt(max(f32(radius_sq), f32(0))) * f32(1 + 1 / 256) + f32(1e-3)


def lower_bound_warp(keys: np.ndarray, x: np.float32) -> int:
    """The first index whose key is >= x: each round 32 probes at the ends of
    32 equal blocks of the remaining range, as the kernel's warp does."""
    lo, hi = 0, len(keys)
    while lo < hi:
        step = (hi - lo + 31) >> 5
        probes = lo + (np.arange(32) + 1) * step - 1
        below = (probes < hi) & (keys[np.minimum(probes, len(keys) - 1)] < x)
        lo += int(below.sum()) * step
        hi = min(lo + step - 1, hi)
    return lo


def run(keys: np.ndarray, kp_uv: np.ndarray, uv: np.ndarray, radius_sq: float):
    """(indices the kernel walks, indices whose pair passes the pixel gate)
    for one point; the gate is the kernel's du * du + dv * dv <= r^2."""
    r = reach(radius_sq)
    pu, pv = f32(uv[0]), f32(uv[1])
    top = pv + r
    walked, passed = [], []
    i0 = lower_bound_warp(keys, pv - r)
    while i0 < len(keys):
        idx = np.arange(i0, min(i0 + 32, len(keys)))
        past = keys[idx] > top
        du = pu - np.asarray(kp_uv, f32)[idx, 0]
        dv = pv - keys[idx]
        with np.errstate(invalid="ignore", over="ignore"):
            ok = ~past & (du * du + dv * dv <= f32(radius_sq))
        walked.extend(idx.tolist())
        passed.extend(idx[ok].tolist())
        if past.any() or len(idx) < 32:
            break
        i0 += 32
    return walked, passed
