#!/usr/bin/env python3
"""Drive the PyTorch port (racing_slam_tpu_torch) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     no CUDA device is a failure, there is no CPU fallback;
  2. build the six CUDA kernels from racing_slam_tpu_torch/csrc (one nvcc
     process per source, all started together);
  3. each kernel against its plain-PyTorch twin on the card, at the shapes
     of the main paths (640x480 frame; P=4096 map points x O=8
     observations x K=2400 keypoints at D=128 and D=256; the banded search
     at P=16384 (8192 sorted rows, 2560 padded keypoints), with a case
     whose band does not fit; commit BA over 2432 points and 32 cameras,
     and at 7296 and 16384 points, each run twice for identical bits;
     attention at [2400, 4, 32]), with device times (cuda_ms: CUDA
     events around 25 back-to-back calls queued behind a sleep kernel),
     the least time
     the card could take for the same work (bound_ms) and, for attention,
     one PyTorch call computing the same function (library_ms);
     SuperPoint on the card against the same network on the CPU;
  4. five paths, each Slam.initialize() + run_batched(batch=48) with the
     launch counters set to 0 just before and read just after. On the
     304-frame bench world of seed 3 (640x480), with local_ba_window=1 and
     no refinement: the classical slice (kernels K1-K4), the learned path
     (SuperPoint + LightGlue, K2-K4 and K6) and the `lightglue` variant
     (classical frontend + LightGlue, K1-K4 and K6); at bench.py's headline
     configuration (local_ba_window=4, refine_every_frames=48), `headline`
     (K1-K3, window BA and refinement). On the 150-frame world of seed 3
     (bench.py --frames 150), `scale`: bench.py --map-capacity 16384
     --match-backend banded (K1, K3, K5, with K2 as the device-side dense
     fallback). Each is held to ATE <= 10 % and coverage >= 0.85 and one
     host read per tracked frame, and every kernel of the path must have
     run; `scale` prints how often the band did not fit.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.

Options (the defaults are the check above): --seeds 3,8 runs every path on
each listed seed's world (the kernel table reads the first seed's runs);
--profile 96 replays each path of the first seed and profiles its first 96
tracked frames.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from collections import Counter

import numpy as np

SEED = 3
N_FRAMES = 304
SCALE_FRAMES = 150  # bench.py --frames 150, the scale rows' world
BATCH = 48

# Peak rates of one H100 SXM (NVIDIA's data sheet), and the
# special-function units' exp rate: 16 results per SM per
# clock (CUDA programming guide, compute capability 9.0) x 132 SMs x 1.98 GHz.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "f32": 67e12, "exp": 16 * 132 * 1.98e9}


def bound(n_bytes: float, ops: dict) -> dict:
    """The least time in ms for moving `n_bytes` (each input read once, each
    output written once) and doing `ops` ({type: count}) on units that run
    side by side: the larger of the memory time and the slowest unit."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = max(n / PEAK_OPS_S[kind] for kind, n in ops.items())
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, n: int = 25, rounds: int = 5, warmup: int = 3) -> float:
    """Device time of one fn() in ms: after `warmup` calls, one CUDA event
    pair around `n` back-to-back calls, divided by `n`; the median of
    `rounds` such runs. Before each run the stream is held by a sleep
    kernel long enough for the host to enqueue all `n` calls (twice one
    call's measured enqueue time, at most 0.2 s), so the device runs them
    back to back and the host's dispatch does not enter the time (one
    event pair around one call would time the wrapper instead). Used alike
    for a kernel, its twin and the library call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    hold_cycles = int(min(2.0 * n * enqueue_s, 0.2) * 2e9)
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold_cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# Phase 3: kernels against their twins at the main-path shapes
# ---------------------------------------------------------------------------


def check_frontend(frame: np.ndarray, dev) -> dict:
    """K1 on a rendered 640x480 bench frame, with and without the bench's
    okayama-shape mask (bottom fifth + top twelfth blocked).

    Tolerances (tests/test_frontend_fused.py): response and peaks atol 2e-5,
    rtol 1e-4; descriptor blur atol 1e-5. NMS peaks may flip at near-tie
    pixels, where the kernel's fused multiply-adds and tap order round
    differently from the twin: at most 1e-4 of the pixels may differ in
    peak status, and peaks present in both must agree to the tolerance."""
    import torch

    from racing_slam_tpu_torch.ops.kernels import frontend as k

    img = torch.from_numpy(frame.astype(np.float32) / 255.0).to(dev)
    H, W = img.shape
    m = np.ones((H, W), np.float32)
    m[-H // 5:, :] = 0
    m[: H // 12, :] = 0
    mask = torch.from_numpy(m).to(dev)
    err = 0.0
    for msk in (None, mask):
        got = k.corner_frontend_fused(img, msk)
        want = k.corner_frontend_fused_reference(img, msk)
        torch.cuda.synchronize()
        r, p, b = [x.cpu().numpy() for x in got]
        r0, p0, b0 = [x.cpu().numpy() for x in want]
        np.testing.assert_allclose(r, r0, atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(b, b0, atol=1e-5)
        flips = np.mean((p > 0) != (p0 > 0))
        both = (p > 0) & (p0 > 0)
        assert flips <= 1e-4, f"K1 peak status differs at {flips:.2e} of pixels"
        np.testing.assert_allclose(p[both], p0[both], atol=2e-5, rtol=1e-4)
        if msk is not None:
            assert r[m == 0].max() == 0.0, "K1 response inside the mask"
        err = max(err, float(np.abs(r - r0).max()), float(np.abs(b - b0).max()),
                  float(np.abs(p[both] - p0[both]).max()))
        log(f"K1 frontend mask={msk is not None}: |resp| err {np.abs(r - r0).max():.3e}, "
            f"|blur2| err {np.abs(b - b0).max():.3e}, peak flips {flips:.2e}")
    ms = cuda_ms(lambda: k.corner_frontend_fused(img, mask))
    plain = cuda_ms(lambda: k.corner_frontend_fused_reference(img, mask), rounds=1)
    # Per pixel: blur sigma 1.2 (2 x 9 taps) 36, Sobel 24, tensor products
    # 3, 3x3 box sums 18, min eigenvalue ~10, gating 2, 15x15 NMS max 28,
    # descriptor blur sigma 2 (2 x 13 taps) 52: ~173 float32 operations.
    return dict(name="corner_frontend_fused", module=k, max_abs_err=err, ms=ms, plain_ms=plain,
                library_ms=None, **bound(nbytes(img, mask) + 3 * nbytes(img),
                                         {"f32": 173 * H * W}),
                source="racing_slam_tpu_torch/csrc/frontend_kernel.cu",
                replaces="racing_slam_tpu/ops/pallas/frontend_kernel.py:167")


def _k2_data(rng, P: int, D: int, gate_rate: float):
    """check_match's synthetic frame: K=2400 keypoints over 640x480, P map
    points near random keypoints with O=8 noisy observations, planted exact
    ties (keypoint 2i+1 duplicates 2i, 1 px away, for i < 200)."""
    O, K = 8, 2400
    kp_uv = np.stack([rng.uniform(0, 640, K), rng.uniform(0, 480, K)], -1).astype(np.float32)
    kp_desc = rng.standard_normal((K, D)).astype(np.float32)
    kp_desc /= np.linalg.norm(kp_desc, axis=-1, keepdims=True)
    src = rng.integers(0, K, P)
    uv_p = (kp_uv[src] + rng.uniform(-6, 6, (P, 2))).astype(np.float32)
    obs = kp_desc[src][:, None, :] + 0.15 * rng.standard_normal((P, O, D)).astype(np.float32)
    obs /= np.linalg.norm(obs, axis=-1, keepdims=True)
    obs_valid = rng.uniform(size=(P, O)) < 0.7
    gate = rng.uniform(size=P) < gate_rate
    kp_ok = rng.uniform(size=K) < 0.95
    for i in range(0, 200, 2):
        kp_desc[i + 1] = kp_desc[i]
        kp_uv[i + 1] = kp_uv[i] + 1.0
        kp_ok[i] = kp_ok[i + 1] = True
    return uv_p, gate, obs, obs_valid, kp_uv, kp_desc, kp_ok


def check_match(dev, D: int = 128) -> dict:
    """K2 at P=4096, O=8, K=2400 on a 640x480 frame, radius 28 px, with
    planted exact ties (duplicate keypoints within the radius); D=128 for
    the classical descriptors, D=256 for SuperPoint's.

    Tolerances: the kernel and the twin sum the D bf16 products in a
    different order, so squared distances agree to 1e-5 (a few hundred
    terms of float32 rounding) and a keypoint choice may flip only at a
    near-tie: >= 99.9 % of the points must pick the same keypoint, every
    planted tie must go to the lower index, and distances must agree where
    both pick the same keypoint."""
    import torch

    from racing_slam_tpu_torch.ops.kernels import match as k

    P, K = 4096, 2400
    uv_p, gate, obs, obs_valid, kp_uv, kp_desc, kp_ok = _k2_data(np.random.default_rng(7), P, D,
                                                                 gate_rate=0.6)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    args = (t(uv_p), t(gate), t(obs).to(torch.bfloat16), t(obs_valid), t(kp_uv), t(kp_desc),
            t(kp_ok))
    bk, bd = k.guided_match_stage1(*args, radius_px=28.0)
    rk, rd = k.guided_match_stage1_reference(*args, radius_px=28.0)
    torch.cuda.synchronize()
    bk, bd, rk, rd = [x.cpu().numpy() for x in (bk, bd, rk, rd)]
    same = bk == rk
    agree = same.mean()
    assert agree >= 0.999, f"K2 D={D} keypoint agreement {agree}"
    # Where the twin picked a planted pair's lower index, the pair tied
    # exactly: the kernel must pick that same (lower) index.
    tie_pts = np.isin(rk, np.arange(0, 200, 2)) & (rd < 1e9)
    assert (bk[tie_pts] == rk[tie_pts]).all(), "K2 planted tie not resolved to the lower index"
    err = float(np.abs(bd[same] - rd[same]).max())
    assert err <= 1e-5, f"K2 D={D} distance error {err}"
    log(f"K2 guided match D={D}: keypoint agreement {agree:.5f}, |d2| err {err:.3e}, "
        f"gated points matched {(bd < 1e9).sum()}")
    ms = cuda_ms(lambda: k.guided_match_stage1(*args, radius_px=28.0))
    plain = cuda_ms(lambda: k.guided_match_stage1_reference(*args, radius_px=28.0), rounds=1)
    # The work this data needs: a pixel-gate test per (point, keypoint)
    # (~5 float32 operations) and, for the pairs that pass every gate, a
    # D-long bf16 dot product (2D operations) per valid observation.
    d2 = ((uv_p[:, None, :] - kp_uv[None, :, :]) ** 2).sum(-1)
    passing = (d2 <= 28.0 ** 2) & gate[:, None] & kp_ok[None, :]
    dots = int((passing.sum(1) * obs_valid.sum(1)).sum())
    return dict(name="guided_match_stage1", module=k, max_abs_err=err, ms=ms, plain_ms=plain,
                library_ms=None,
                **bound(nbytes(*args) + P * 8, {"f32": 5 * P * K, "bf16": 2 * D * dots}),
                source="racing_slam_tpu_torch/csrc/match_kernel.cu",
                replaces="racing_slam_tpu/ops/pallas/match_kernel.py:115")


def check_match_banded(dev) -> dict:
    """K5 at the scale path's shape: check_match's data grown to P=16384
    map points, about 2000 of them gated (the gated count of a large map's
    view), sorted and banded by the port's own planning
    (ops/matching.py band_plan): 8192 sorted rows x O=8 x D=128 bf16, 2560
    padded keypoints, 32 point tiles, radius 28 px.

    Tolerances as check_match's (the same sums in another order): best_d
    agrees everywhere to 1e-5, best_k where best_d < 1e9 on >= 99.9 % of
    the points, and a planted tie goes to the lower sorted index. Then the
    whole banded stage 1 on data whose gated points overflow the 8192
    sorted rows (60 % of 16384 gated): it must report the fallback, K5 must
    do no work and K2's answer must match its twin's.

    Bound: a pixel-gate test (~5 float32 operations) for each of the
    n_act * 256 x 1024 (point, band keypoint) pairs, 2D bf16 operations per
    passing pair and valid observation, against the bytes of the active
    rows, the keypoints, starts and the [8192] outputs. No library call
    computes a gated argmin."""
    import torch

    from racing_slam_tpu_torch.ops import matching
    from racing_slam_tpu_torch.ops.kernels import match as k2
    from racing_slam_tpu_torch.ops.kernels import match_banded as k

    P, D, r = 16384, 128, 28.0
    tiles = dict(radius_px=r, tile_p=256, tile_k=512, band_tiles=2)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    data = _k2_data(np.random.default_rng(17), P, D, gate_rate=2000 / P)
    args = [t(a) for a in data]
    args[2] = args[2].to(torch.bfloat16)
    plan = matching.band_plan(*args, **tiles)
    n_act = plan.n_act.to(torch.int32)
    kargs = (*plan.k5_args, n_act)
    bk, bd = k.guided_match_stage1_banded(*kargs, **tiles)
    rk, rd = k.guided_match_stage1_banded_reference(*kargs, **tiles)
    torch.cuda.synchronize()
    bk, bd, rk, rd = [x.cpu().numpy() for x in (bk, bd, rk, rd)]
    err = float(np.abs(bd - rd).max())
    assert err <= 1e-5, f"K5 distance error {err}"
    hit = rd < 1e9
    agree = float((bk[hit] == rk[hit]).mean())
    assert agree >= 0.999, f"K5 keypoint agreement {agree}"
    order = plan.kp_order.cpu().numpy()
    pos = np.empty(len(order), np.int64)
    pos[order[: len(data[4])]] = np.arange(len(data[4]))  # original -> sorted index
    lower = np.minimum(pos[0:200:2], pos[1:200:2])
    ties = np.isin(rk, lower) & hit
    assert ties.sum() > 0 and (bk[ties] == rk[ties]).all(), "K5 planted tie not to the lower index"
    n_act_h, fits = int(plan.n_act), bool(plan.fits)
    log(f"K5 banded match: {hit.sum()} of {int(data[1].sum())} gated points matched, "
        f"{n_act_h} active tiles, band fits {fits}, keypoint agreement {agree:.5f}, "
        f"|d2| err {err:.3e}, planted ties {int(ties.sum())}")

    # The band does not fit: 60 % of the map gated overflows the 8192 rows.
    over = [t(a) for a in _k2_data(np.random.default_rng(18), P, D, gate_rate=0.6)]
    over[2] = over[2].to(torch.bfloat16)
    before = k.launches
    fk, fd, fell_back = matching._banded_stage1(*over, radius_px=r)
    dk, dd = k2.guided_match_stage1_reference(*over, radius_px=r)
    assert bool(fell_back), "K5 no-fit case did not fall back"
    assert k.launches == before + (dev.type == "cuda"), "K5 not launched in the no-fit case"
    fk, fd, dk, dd = [x.cpu().numpy() for x in (fk, fd, dk, dd)]
    fhit = dd < 1e9
    assert np.array_equal(fd >= 1e9, ~fhit) and np.abs(fd - dd).max() <= 1e-5
    fagree = float((fk[fhit] == dk[fhit]).mean())
    assert fagree >= 0.999, f"banded fallback keypoint agreement {fagree}"
    log(f"K5 no-fit case: fell back to K2 on the device, agreement with K2's twin {fagree:.5f}")

    ms = cuda_ms(lambda: k.guided_match_stage1_banded(*kargs, **tiles))
    plain = cuda_ms(lambda: k.guided_match_stage1_banded_reference(*kargs, **tiles), rounds=1)
    # The pairs this data needs: each active row against its tile's band.
    uv, gate, _, ov, kuv, _, kok, starts = [x.float().cpu().numpy() if x.dtype == torch.bfloat16
                                            else x.cpu().numpy() for x in plan.k5_args]
    rows = n_act_h * 256
    dots = 0
    for i in range(n_act_h):
        s0 = int(starts[i]) * 512
        d2 = ((uv[i * 256:(i + 1) * 256, None] - kuv[None, s0:s0 + 1024]) ** 2).sum(-1)
        ok = (d2 <= r * r) & gate[i * 256:(i + 1) * 256, None] & kok[None, s0:s0 + 1024]
        dots += int((ok.sum(1) * ov[i * 256:(i + 1) * 256].sum(1)).sum())
    row_bytes = 8 + 1 + 8 * D * 2 + 8
    n_bytes = rows * row_bytes + nbytes(*plan.k5_args[4:]) + nbytes(n_act) + len(bk) * 8
    return dict(name="guided_match_stage1_banded", module=k, max_abs_err=err, ms=ms,
                plain_ms=plain, library_ms=None,
                **bound(n_bytes, {"f32": 5 * rows * 1024, "bf16": 2 * D * dots}),
                source="racing_slam_tpu_torch/csrc/match_banded_kernel.cu",
                replaces="racing_slam_tpu/ops/pallas/match_kernel.py:305")


def _rotvec_matrix(w):
    th = np.linalg.norm(w)
    Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / max(th, 1e-12)
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def check_motion_ba(dev) -> dict:
    """K3 at K=2400 rows (70 % valid, 10 % gross outliers), 10 iterations,
    pixel Huber scale. Tolerances (tests/test_ba_kernels.py): rvec atol
    1e-5, t atol 1e-4, cost within 1 % of the twin's either way."""
    import torch

    from racing_slam_tpu_torch.ops.kernels import motion_ba as k

    rng = np.random.default_rng(11)
    K = 2400
    fx, cx, cy = 480.0, 320.0, 240.0
    X = np.stack([rng.uniform(-6, 6, K), rng.uniform(-4, 4, K), rng.uniform(4, 14, K)], -1)
    w_gt = np.array([0.02, -0.05, 0.01])
    t_gt = np.array([0.3, -0.1, 0.2])
    Xc = X @ _rotvec_matrix(w_gt).T + t_gt
    uv = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx, fx * Xc[:, 1] / Xc[:, 2] + cy], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    uv[: K // 10] += rng.uniform(40, 120, (K // 10, 2))
    valid = rng.uniform(size=K) < 0.7
    pose0 = np.concatenate([w_gt + [0.01, -0.01, 0.005], t_gt + [0.05, -0.04, 0.06]])
    t = lambda a, d=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(dev).to(d)  # noqa
    args = (t(pose0), t(uv), t(X), t(valid, torch.bool))
    kw = dict(fx=fx, cx=cx, cy=cy, max_iters=10, huber_delta=float(np.sqrt(5.991)) / fx)
    out = k.motion_ba_lm(*args, **kw).cpu().numpy()
    ref = k.motion_ba_lm_reference(*args, **kw).cpu().numpy()
    np.testing.assert_allclose(out[:3], ref[:3], atol=1e-5)
    np.testing.assert_allclose(out[3:6], ref[3:6], atol=1e-4)
    assert abs(out[6] - ref[6]) <= 0.01 * ref[6] + 1e-10, (out[6], ref[6])
    err = float(np.abs(out[:6] - ref[:6]).max())
    log(f"K3 motion BA: |pose| err {err:.3e}, cost {out[6]:.6e} vs {ref[6]:.6e}, "
        f"iters {out[7]:.0f} vs {ref[7]:.0f}")
    ms = cuda_ms(lambda: k.motion_ba_lm(*args, **kw))
    plain = cuda_ms(lambda: k.motion_ba_lm_reference(*args, **kw), rounds=1)
    # Per valid row and iteration: transform and project (~24), residual
    # and 2x6 Jacobian (~42), Huber weight (~5), 21 H + 6 g sums over two
    # rows (~108), trial cost (~30): ~210 float32 operations.
    ops = 210 * int(valid.sum()) * int(out[7])
    return dict(name="motion_ba_lm", module=k, max_abs_err=err, ms=ms, plain_ms=plain,
                library_ms=None, **bound(nbytes(*args) + 8 * 4, {"f32": ops}),
                source="racing_slam_tpu_torch/csrc/motion_ba_kernel.cu",
                replaces="racing_slam_tpu/ops/pallas/motion_ba_kernel.py:309")


def _k4_data(dev, P: int = 2432, seed: int = 13):
    """The commit problem: P points x O=8 observations of the 8 newest of
    F=32 cameras along the bench dolly, the newest camera free and
    perturbed, 0.5 px noise, 80 % of observations kept, the first 100
    points frozen, 10 iterations, pixel Huber scale."""
    import torch

    rng = np.random.default_rng(seed)
    F, O = 32, 8
    fx, cx, cy = 480.0, 320.0, 240.0
    rv = np.stack([np.array([0.0, 0.002 * f, 0.0]) for f in range(F)])
    tv = np.stack([-np.array([0.05, 0.005, 0.10]) * f for f in range(F)])
    X = np.stack([rng.uniform(-5, 5, P), rng.uniform(-3, 3, P), rng.uniform(8, 16, P)], -1)
    obs_cam = np.stack([F - 1 - np.arange(O)] * P).astype(np.int64)
    obs_uv = np.zeros((P, O, 2))
    for o in range(O):
        f = F - 1 - o
        Xc = X @ _rotvec_matrix(rv[f]).T + tv[f]
        obs_uv[:, o] = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx,
                                 fx * Xc[:, 1] / Xc[:, 2] + cy], -1)
    obs_uv += rng.normal(0, 0.5, obs_uv.shape)
    include = rng.uniform(size=(P, O)) < 0.8
    include[:, 0] |= True
    free = np.ones(P, bool)
    free[:100] = False
    rv0, tv0 = rv.copy(), tv.copy()
    rv0[F - 1] += [0.004, -0.003, 0.002]
    tv0[F - 1] += [0.03, -0.02, 0.04]
    Xn = X + rng.normal(0, 0.02, X.shape)
    t = lambda a, d=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(dev).to(d)  # noqa
    args = (t(rv0), t(tv0), t(Xn), t(obs_cam, torch.int64), t(obs_uv), t(include, torch.bool),
            t(free, torch.bool), torch.full((), F - 1, dtype=torch.int64, device=dev))
    kw = dict(fx=fx, cx=cx, cy=cy, max_iters=10, huber_delta=float(np.sqrt(5.991)) / fx)
    return args, kw, dict(rv0=rv0, tv0=tv0, Xn=Xn, obs_cam=obs_cam, include=include)


def _twin_order_spread(k, args, kw) -> float:
    """Largest point difference between K4's twin and the twin on the same
    problem with its points reordered (reversed, and two seeded
    permutations): how far float32 summation order alone moves the points."""
    import torch

    _, pts = k.structure_ba_lm_reference(*args, **kw, ftol=0.0)
    P = pts.shape[0]
    gen = torch.Generator().manual_seed(0)
    spread = 0.0
    for perm in (torch.arange(P - 1, -1, -1), torch.randperm(P, generator=gen),
                 torch.randperm(P, generator=gen)):
        perm = perm.to(pts.device)
        moved = list(args)
        for i in (2, 3, 4, 5, 6):  # points, obs_cam, obs_uv, include, point_free
            moved[i] = args[i][perm]
        _, p2 = k.structure_ba_lm_reference(*moved, **kw, ftol=0.0)
        back = torch.empty_like(perm)
        back[perm] = torch.arange(P, device=pts.device)
        spread = max(spread, float((p2[back] - pts).norm(dim=-1).max()))
    return spread


def check_structure_ba(dev) -> dict:
    """K4 at the commit shape: Pc=2432 points x O=8 observations, F=32
    cameras, the newest camera free, 10 iterations, pixel Huber scale; and
    the same problem at P=7296 (the 720p commit) and P=16384 (map_capacity
    with ba_commit_budget set).

    Parity runs with the function-tolerance exit off, so both sides take
    all 10 iterations: with it on, a step that improves the cost by about
    the tolerance stops one side one iteration before the other, and the
    extra step moves the weakest-constrained points (depth along the short
    baseline) by up to tenths of a unit. Tolerances (tests/test_ba_kernels.py):
    rvec atol 1e-5, t atol 1e-4, cost within 1 %, median point difference
    < 1e-4. Every point within 5e-2: the reduced system sums 2432 x 8
    observations in another order, and the float32 difference in the camera
    step is amplified along the same weak depth directions (0.5 px noise on
    a 0.7-unit baseline at depth 8-16 leaves ~0.4 units of depth
    uncertainty; the first card run differed by up to 1.5e-2). The
    reprojections of the points, which those directions do not move, are
    held to 1e-2 px. A second kernel run on the same inputs must give the
    same bits (the cluster sums its partials in a fixed rank order).

    At 7296 and 16384 points the dolly leaves a few points' depths so
    weakly determined that the twin itself, on the same problem with its
    points in another order, moves them by tenths of a unit (on the CPU
    0.30 and 0.21, 2 and 6 points past 5e-2, reprojections within 1.6e-3
    px). There every point is held to the larger of 5e-2 and twice the
    twin's own spread over three reorderings of its points (measured in the
    same run); every other tolerance is the commit shape's.

    Then, at the commit shape, with the exit on, as the main path runs it:
    the same pose tolerances, cost within 1 % either way, and iteration
    counts within 1 of each other (one side may stop an iteration early,
    see above)."""
    from racing_slam_tpu_torch.ops.kernels import structure_ba as k

    for P in (2432, 7296, 16384):
        args, kw, d = _k4_data(dev, P)
        rv0, tv0, Xn, obs_cam, include = (d[key] for key in ("rv0", "tv0", "Xn", "obs_cam",
                                                             "include"))
        F = rv0.shape[0]
        out, pts = k.structure_ba_lm(*args, **kw, ftol=0.0)
        again = k.structure_ba_lm(*args, **kw, ftol=0.0)
        ref, rpts = k.structure_ba_lm_reference(*args, **kw, ftol=0.0)
        same = all(bool((a == b).all()) for a, b in zip((out, pts), again))
        assert same, f"K4 P={P}: two runs on the same inputs differ"
        out, pts, ref, rpts = [x.cpu().numpy() for x in (out, pts, ref, rpts)]
        np.testing.assert_allclose(out[:3], ref[:3], atol=1e-5)
        np.testing.assert_allclose(out[3:6], ref[3:6], atol=1e-4)
        assert abs(out[6] - ref[6]) <= 0.01 * ref[6] + 1e-10, (out[6], ref[6])
        assert out[7] == ref[7], (out[7], ref[7])
        perr = np.linalg.norm(pts - rpts, axis=-1)
        assert np.median(perr) < 1e-4, np.median(perr)
        spread = _twin_order_spread(k, args, kw) if P != 2432 else None
        point_tol = 5e-2 if spread is None else max(5e-2, 2 * spread)
        assert perr.max() < point_tol, (perr.max(), point_tol)
        assert np.array_equal(pts[:100], Xn[:100].astype(np.float32)), "frozen points moved"

        # What the data can see: each side's points in each side's cameras, at
        # every included observation. A move along a weak depth direction does
        # not show here; 1e-2 px is 30x what the twin alone gives between two
        # orders of the points on the CPU (3e-4 px, with 9e-3 in coordinates).
        def pixels(pose, P3):
            r, tt = rv0.copy(), tv0.copy()
            r[F - 1], tt[F - 1] = pose[:3], pose[3:6]
            R = np.stack([_rotvec_matrix(w) for w in r])[obs_cam]
            Xc = np.einsum("poij,pj->poi", R, P3.astype(np.float64)) + tt[obs_cam]
            return 480.0 * Xc[..., :2] / Xc[..., 2:3]

        px = np.abs(pixels(out, pts) - pixels(ref, rpts)).max(-1)[include].max()
        assert px < 1e-2, f"K4 P={P}: reprojections differ by {px} px"
        if P == 2432:  # the main path's shape: the kernel table's error
            err = float(max(np.abs(out[:6] - ref[:6]).max(), perr.max()))
        log(f"K4 structure BA P={P} (10 iterations each): |pose| err "
            f"{np.abs(out[:6] - ref[:6]).max():.3e}, point err median {np.median(perr):.3e} "
            f"max {perr.max():.3e}, reprojection err max {px:.3e} px, cost {out[6]:.6e} vs "
            f"{ref[6]:.6e}, repeat bit-identical {same}"
            + ("" if spread is None else f", twin's own reorder spread {spread:.3e}"))

    args, kw, d = _k4_data(dev)
    out2, pts2 = k.structure_ba_lm(*args, **kw)
    ref2, _ = k.structure_ba_lm_reference(*args, **kw)
    out2, pts2, ref2 = [x.cpu().numpy() for x in (out2, pts2, ref2)]
    log(f"K4 with the tolerance exit: |pose| err {np.abs(out2[:6] - ref2[:6]).max():.3e}, "
        f"iterations {out2[7]:.0f} vs {ref2[7]:.0f}, cost {out2[6]:.6e} vs {ref2[6]:.6e}")
    np.testing.assert_allclose(out2[:3], ref2[:3], atol=1e-5)
    np.testing.assert_allclose(out2[3:6], ref2[3:6], atol=1e-4)
    assert abs(out2[6] - ref2[6]) <= 0.01 * ref2[6] + 1e-10, (out2[6], ref2[6])
    assert abs(out2[7] - ref2[7]) <= 1, (out2[7], ref2[7])
    assert np.isfinite(pts2).all() and np.array_equal(pts2[:100], d["Xn"][:100].astype(np.float32))
    ms = cuda_ms(lambda: k.structure_ba_lm(*args, **kw))
    plain = cuda_ms(lambda: k.structure_ba_lm_reference(*args, **kw), rounds=1)
    # Per included observation and iteration: transform, project, camera
    # and point Jacobians, and the Hpp, Y, Hcc, g sums (~300 float32
    # operations); per point: damped 3x3 inverse, Schur terms and back
    # substitution (~150). Iterations as the main path runs them (exit on).
    P = args[2].shape[0]
    ops = int(out2[7]) * (300 * int(d["include"].sum()) + 150 * P)
    return dict(name="structure_ba_lm", module=k, max_abs_err=err, ms=ms, plain_ms=plain,
                library_ms=None,
                **bound(nbytes(*args) + 8 * 4 + P * 12, {"f32": ops}),
                source="racing_slam_tpu_torch/csrc/structure_ba_kernel.cu",
                replaces="racing_slam_tpu/ops/pallas/structure_ba_kernel.py:336")


def check_attention(dev) -> dict:
    """K6 at LightGlue's main-path shape: q, k, v [2400, 4, 32], about 80 %
    of the keys valid; then every key masked (uniform attention), a
    ragged key count (2333, not a multiple of either side's key tile), and
    the keys split into 20 chunks of 128, the last of which holds only
    padding (the combine must add nothing for it).

    Tolerance: max abs error <= 5 % of the twin's output RMS (about 0.038
    at 80 % of 2400 keys valid, so about 1.9e-3; 0.023, so 1.2e-3, when
    every key is masked). Both round q, k, v and p to bf16 and sum in
    float32, but the kernel rounds p against the running max of 64-key
    tiles and the twin of 512-key tiles, so a p may round to the
    neighbouring bf16 value (2^-8 relative) on one side only. On these
    shapes the twin at 64-key tiles stays within 1 % of the RMS of itself
    at 512, and a kernel that dropped the last partial key tile (32 keys of
    2400, 29 of 2333) would exceed the limit at least 5x; the kernel's split
    of the keys into chunks and their combine (modelled by the twin's
    `chunks`) stays within 0.22 of the limit, and a dropped chunk exceeds
    it at least 5x (tests/test_torch_models.py checks all of these on the
    CPU). library_ms is one call of
    torch's scaled_dot_product_attention on the same inputs in bf16 with an
    additive -1e9 float mask (the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from racing_slam_tpu_torch.ops.kernels import attention as k

    rng = np.random.default_rng(9)
    H, dh = 4, 32
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    err = 0.0
    for name, Kq, Kk, valid, chunks in (
            ("80 % valid", 2400, 2400, 0.8, None), ("all masked", 2400, 2400, 0.0, None),
            ("ragged", 2400, 2333, 0.8, None),
            # 38 key tiles in 20 chunks of 2 tiles: the last chunk all padding
            ("one chunk all padding", 2400, 2400, 0.8, 20)):
        q, kk, v = [t(rng.normal(size=(n, H, dh)).astype(np.float32)) for n in (Kq, Kk, Kk)]
        mask = t(rng.random(Kk) < valid)
        got = k.flash_mha(q, kk, v, mask, chunks=chunks)
        want = k.flash_mha_reference(q, kk, v, mask)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        tol = 0.05 * float(want.pow(2).mean().sqrt())
        assert torch.isfinite(got).all() and e <= tol, f"K6 {name}: max abs err {e} > {tol}"
        n_chunks = chunks or k.default_chunks(Kq, Kk, H)
        log(f"K6 flash attention {name} [{Kq}, {Kk}], {n_chunks} key chunks: max abs err "
            f"{e:.3e} (limit {tol:.3e})")
        err = max(err, e)
        if name == "80 % valid":
            args = (q, kk, v, mask)
    q, kk, v, mask = args
    ms = cuda_ms(lambda: k.flash_mha(*args))
    plain = cuda_ms(lambda: k.flash_mha_reference(*args), rounds=1)
    qb, kb, vb = [x.to(torch.bfloat16).permute(1, 0, 2)[None] for x in (q, kk, v)]
    add = torch.where(mask, 0.0, -1e9).to(torch.bfloat16)[None, None, None, :]
    lib = F.scaled_dot_product_attention(qb, kb, vb, attn_mask=add)[0].permute(1, 0, 2)
    log(f"K6 vs scaled_dot_product_attention (bf16): max abs diff "
        f"{float((lib.float() - k.flash_mha(*args)).abs().max()):.3e}")
    library = cuda_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb, attn_mask=add))
    Kq, Kk = q.shape[0], kk.shape[0]
    return dict(name="flash_mha", module=k, max_abs_err=err, ms=ms, plain_ms=plain,
                library_ms=library,
                **bound(nbytes(q, kk, v, mask) + nbytes(q),  # inputs + the f32 output
                        {"bf16": 4 * Kq * Kk * H * dh, "exp": Kq * Kk * H}),
                source="racing_slam_tpu_torch/csrc/attention_kernel.cu",
                replaces="racing_slam_tpu/ops/pallas/attention_kernel.py:88")


def time_schur_solvers(dev) -> dict:
    """The headline and scale paths' plain-PyTorch solvers (no Pallas
    kernel in the JAX package, so no kernel here): window_ba at the commit
    shape (window_ba_budget 1024 points x O=8, F=32, W=4) and full_ba at
    the refinement shape (refine_budget 2048 points), 10 iterations each
    as the main path runs them. Host wall per call (they are launch-bound)
    and device launches per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from racing_slam_tpu_torch.ops import ba
    from racing_slam_tpu_torch.ops.camera import Camera

    rng = np.random.default_rng(21)
    cam = Camera(480.0, 480.0, 320.0, 240.0, 640, 480)
    F, O = 32, 8

    def problem(P):
        rv = np.zeros((F, 3), np.float32)
        rv[:, 1] = 0.002 * np.arange(F)
        X = np.stack([rng.uniform(-5, 5, P), rng.uniform(-3, 3, P), rng.uniform(8, 16, P)], -1)
        obs_cam = (F - 1 - (np.arange(O)[None] + rng.integers(0, 4, (P, 1))) % F)
        Xc = X[:, None] + np.outer(np.arange(F), [-0.05, -0.005, -0.1])[obs_cam]
        uv = 480.0 * Xc[..., :2] / Xc[..., 2:] + [320.0, 240.0] + rng.normal(0, 0.5, (P, O, 2))
        t = lambda a, d=torch.float32: torch.from_numpy(np.asarray(a)).to(dev, d)  # noqa: E731
        ones = torch.ones(P, dtype=torch.bool, device=dev)
        return ba.BAProblem(t(rv), t(-np.outer(np.arange(F), [0.05, 0.005, 0.1])), t(X),
                            t(obs_cam, torch.int64), t(uv),
                            t(rng.uniform(size=(P, O)) < 0.8, torch.bool),
                            torch.arange(F, device=dev) >= 2,
                            torch.ones(F, dtype=torch.bool, device=dev), ones, ones)

    calls = {"window_ba": (lambda p=problem(1024), s=torch.tensor([31, 30, 29, 28], device=dev):
                           ba.window_ba(cam, p, s, max_iters=10, huber_delta=0.005)),
             "full_ba": (lambda p=problem(2048):
                         ba.full_ba(cam, p, max_iters=10, huber_delta=0.005))}
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        out[name] = dict(wall_ms=float(np.median(walls)), device_launches=n)
    log("schur solvers: " + json.dumps(out))
    return out


def superpoint_frontend(dev):
    from racing_slam_tpu_torch.models import WEIGHTS_DIR, superpoint

    params = superpoint.load_params(WEIGHTS_DIR / "superpoint.npz", device=dev)
    return superpoint.SuperPointFrontend(params=params, device=dev)


def check_superpoint(frame: np.ndarray, dev) -> dict:
    """SuperPoint (committed weights) on a 640x480 bench frame: the card
    (cuDNN, TF32 on bf16-rounded operands) against the same network on the
    CPU (float32). Both sum exact bf16 products in float32, in another
    order, so tolerances are tests/test_torch_models.py's against JAX:
    keypoints at the same position (0.05 px) on >= 99 %, heatmap within
    1.5e-2. Times the convolution stack and the whole extraction."""
    import torch

    from racing_slam_tpu_torch.models import WEIGHTS_DIR, superpoint

    fe = superpoint_frontend(dev)
    cpu = superpoint.SuperPointFrontend(
        params=superpoint.load_params(WEIGHTS_DIR / "superpoint.npz", device="cpu"), device="cpu")
    img = torch.from_numpy(frame.astype(np.float32) / 255.0)
    got = fe.extract(img.to(dev))
    want = cpu.extract(img)
    heat = superpoint.heads(fe.params, superpoint.backbone(fe.params, img.to(dev)))[0].cpu()
    heat0 = superpoint.heads(cpu.params, superpoint.backbone(cpu.params, img))[0]
    herr = float((heat - heat0).abs().max())
    same = float(((got.xy.cpu() - want.xy).abs() < 0.05).all(-1).float().mean())
    log(f"SuperPoint card vs CPU: keypoints at the same position {same:.4f}, "
        f"heatmap max abs err {herr:.3e}")
    assert same >= 0.99 and herr < 1.5e-2, (same, herr)
    H, W = frame.shape
    # Convolution multiply-adds x 2 at 640x480 (encoder, both heads).
    flops, cin, hw = 0, 1, H * W
    for stage, c in enumerate(superpoint.ENCODER_CHANNELS):
        flops += 2 * 9 * (cin * c + c * c) * hw
        cin = c
        if stage < 3:
            hw //= 4
    flops += 2 * hw * (9 * cin * 256 * 2 + 256 * 65 + 256 * 256)
    x = img.to(dev)
    conv_ms = cuda_ms(lambda: superpoint.heads(fe.params, superpoint.backbone(fe.params, x)))
    extract_ms = cuda_ms(lambda: fe.extract(x))
    res = dict(gflop=flops / 1e9, conv_ms=conv_ms, extract_ms=extract_ms,
               bound_ms_bf16=1e3 * flops / PEAK_OPS_S["bf16"], bound_ms_tf32=1e3 * flops / 495e12)
    log("superpoint: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# Phase 4: the slice
# ---------------------------------------------------------------------------


def render_bench_world(seed: int, cam, n_frames: int) -> tuple[list, np.ndarray]:
    """The bench world (bench.py render): 260 sprites, dolly step
    [0.05, 0.005, 0.10], yaw 0.002 rad/frame; frames as uint8."""
    from racing_slam_tpu_torch.utils.synthetic import make_sequence

    seq = make_sequence(np.random.default_rng(seed), n_frames=n_frames, cam=cam,
                        n_sprites=260, step_t=np.array([0.05, 0.005, 0.10], np.float32),
                        yaw_per_frame=0.002)
    frames = [np.clip(f * 255.0, 0, 255).astype(np.uint8) for f in seq.frames]
    return frames, seq.poses


def full_trajectory_ate(slam, gt_poses: np.ndarray, n_frames: int) -> dict:
    """Sim(3) ATE over every trajectory segment (archive + live keyframes),
    length-weighted; coverage = fraction of frames inside some segment
    (bench.py full_trajectory_ate)."""
    from racing_slam_tpu_torch.utils.metrics import ate_rmse, camera_centers

    segs = list(slam.segments) + [dict(poses=slam.poses(include_archived=True),
                                       frame_indices=slam.keyframe_indices(include_archived=True))]
    tot_ate, tot_len, covered, n_kf = 0.0, 0.0, 0, 0
    for s in segs:
        idx = np.asarray(s["frame_indices"])
        est = np.asarray(s["poses"])
        if len(idx) < 3:
            continue
        assert np.isfinite(est).all(), "non-finite keyframe pose"
        gt = gt_poses[idx]
        tot_ate += float(ate_rmse(est, gt))
        c = camera_centers(gt)
        tot_len += float(np.linalg.norm(c[-1] - c[0]))
        covered += int(idx[-1]) - int(idx[0]) + 1
        n_kf += len(idx)
    return dict(ate=tot_ate, length=max(tot_len, 1e-9), coverage=covered / n_frames, n_kf=n_kf)


CLASSICAL = ("corner_frontend_fused", "guided_match_stage1", "motion_ba_lm", "structure_ba_lm")
# bench.py's headline configuration (bench.py:387,456) and its scale rows
# (tools/run_matrix.py:28-32 with --match-backend banded, tools/profile_scale.py:54-62).
HEADLINE = dict(local_ba_window=4, refine_every_frames=48)
SCALE = dict(HEADLINE, map_capacity=16384, matching_backend="banded")
PATHS = {
    # name: (frontend, matcher, world frames, SlamConfig overrides, kernels it must launch)
    "classical": ("classical", "classical", N_FRAMES, {}, CLASSICAL),
    "learned": ("superpoint", "lightglue", N_FRAMES, {}, CLASSICAL[1:] + ("flash_mha",)),
    "lightglue": ("classical", "lightglue", N_FRAMES, {}, CLASSICAL + ("flash_mha",)),
    "headline": ("classical", "classical", N_FRAMES, HEADLINE, CLASSICAL),
    "scale": ("classical", "classical", SCALE_FRAMES, SCALE,
              CLASSICAL + ("guided_match_stage1_banded",)),
}


# The port's kernels by the name of their __global__ functions (K6 is
# three launches a call).
OUR_KERNELS = {"K1": "frontend_kernel", "K2": "guided_match_kernel", "K3": "motion_ba_kernel",
               "K4": "structure_ba_cluster", "K5": "banded_match_kernel",
               "K6 prepass": "flash_prepass", "K6 main": "flash_main",
               "K6 combine": "flash_combine"}


def profile_path(slam, frames: list, n: int) -> dict:
    """Replay the path (same seed, same draws) and profile its first `n`
    tracked frames after the bootstrap with torch.profiler: wall time, the
    device time of every kernel and copy (each device event counted once),
    the busy share, the kernels taking the most device time, and the
    device time and launches of each of the port's own kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from racing_slam_tpu_torch.utils.video import ArraySource

    slam.reset_run(ArraySource(frames))
    assert slam.initialize()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        slam.run_batched(max_frames=n, batch=BATCH)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    by_name: Counter = Counter()
    ours: Counter = Counter()  # device ms and launches of the port's kernels
    n_events = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            by_name[e.name[:60]] += ms
            n_events += 1
            for kern, fn in OUR_KERNELS.items():
                if fn in e.name:
                    ours[kern + " ms"] += ms
                    ours[kern + " launches"] += 1
    busy_ms = sum(by_name.values())
    return dict(frames=n, wall_ms=wall_ms, device_busy_ms=busy_ms, busy_share=busy_ms / wall_ms,
                device_events=n_events,
                top_ms={k: round(v, 3) for k, v in by_name.most_common(10)},
                kernels={k: round(v, 3) for k, v in sorted(ours.items())})


def run_path(path: str, dev, kernels: list, cam, frames: list, gt: np.ndarray,
             profile_frames: int = 0) -> dict:
    import torch

    from racing_slam_tpu_torch.slam.config import SlamConfig
    from racing_slam_tpu_torch.slam.pipeline import Slam
    from racing_slam_tpu_torch.utils.video import ArraySource

    frontend_kind, matcher, _, overrides, needed = PATHS[path]
    # bench.py's configuration, by default with local_ba_window=1 and
    # refine_every_frames=0; bench.py --variant learned|lightglue set
    # matcher="lightglue" (threshold 0.35).
    cfg = SlamConfig(**{**dict(
        match_radius_px=28.0, ransac_threshold_px=0.4, cull_reproj_px=3.0, inlier_px=3.0,
        triangulation_reproj_px=2.0, pose_prediction="constant_velocity",
        triangulate_points=True, bundle_adjust=True, optimize_pose=True, cull_points=True,
        max_keyframes=32, map_capacity=4096, max_observations=8, archive_capacity=512,
        reproj_monitor_every=0, refine_every_frames=0, local_ba_window=1,
        keyframe_match_ratio=0.8, matcher=matcher,
    ), **overrides})
    frontend = superpoint_frontend(dev) if frontend_kind == "superpoint" else None
    slam = Slam(cam, ArraySource(frames), cfg, frontend=frontend, device=dev)
    for kern in kernels:
        kern["module"].launches = 0
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.time()
        assert slam.initialize(), f"{path}: bootstrap failed"
        t_init = time.time() - t0
        t1 = time.time()
        n = slam.run_batched(batch=BATCH)
        torch.cuda.synchronize()
        t_track = time.time() - t1
        torch.cuda.set_sync_debug_mode("default")
    launches = {kern["name"]: kern["module"].launches for kern in kernels}
    fallbacks = slam.banded_fallbacks() if cfg.matching_backend == "banded" else None
    kfs = slam.state.kfs
    kp_valid = kfs.kp_valid.sum(dim=1)[kfs.valid].cpu().numpy()  # valid keypoints a keyframe
    flagged = [w for w in caught if "synchroniz" in str(w.message)]
    sources = Counter(f"{w.filename.split('/')[-1]}:{w.lineno}" for w in flagged)
    log(f"{path}: synchronising calls flagged by torch.cuda sync debug mode: {len(flagged)}, "
        f"by source line: {dict(sources.most_common(8))}")
    acc = full_trajectory_ate(slam, gt, len(frames))
    n_commits = sum(i.is_keyframe for b in slam.batch_infos for i in b)
    tracked = slam.frames_tracked
    res = dict(
        frames=n, tracked=tracked, init_s=t_init, track_s=t_track, fps=n / t_track,
        keyframes=acc["n_kf"], points=int(slam.state.map.num_points()),
        reinits=slam.n_reinits, eof_on_reinit=slam.eof_on_reinit,
        ate_pct=100 * acc["ate"] / acc["length"],
        coverage=acc["coverage"], commits=n_commits, host_syncs=slam.host_syncs,
        syncs_per_tracked_frame=slam.host_syncs["track"] / max(tracked, 1),
        sync_debug_flagged=len(flagged),
        launches=launches,
        refines=len(slam.refine_costs), banded_fallbacks=fallbacks,
        keyframe_keypoints=[int(kp_valid.min()), int(kp_valid.max())],
    )
    log(f"{path}: " + json.dumps(res))
    assert res["ate_pct"] <= 10.0, f"{path}: ATE {res['ate_pct']:.2f} % > 10 %"
    assert res["coverage"] >= 0.85, f"{path}: coverage {res['coverage']:.3f} < 0.85"
    assert res["syncs_per_tracked_frame"] <= 1.0, res["host_syncs"]
    bootstraps = 1 + slam.n_reinits
    single = cfg.local_ba_window <= 1  # otherwise the window BA solves every commit
    want = {"corner_frontend_fused": tracked, "guided_match_stage1": 2 * tracked,
            "guided_match_stage1_banded": 2 * tracked, "motion_ba_lm": 2 * tracked,
            "structure_ba_lm": n_commits * single + bootstraps,
            "flash_mha": 8 * (n_commits + bootstraps)}  # 2 layers x 4 attention sites
    for name in needed:
        assert launches[name] >= want[name], f"{path}: {name} launched {launches[name]} < {want[name]}"
    if cfg.refine_every_frames:
        assert res["refines"] >= n // cfg.refine_every_frames, res["refines"]
    if fallbacks is not None:
        log(f"{path}: the band did not fit in {fallbacks} of "
            f"{launches['guided_match_stage1_banded']} banded searches (K2 answered those)")
    if profile_frames:
        log(f"{path} profile: " + json.dumps(profile_path(slam, frames, profile_frames)))
    return res


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default=str(SEED))
    ap.add_argument("--profile", type=int, default=0,
                    help="profile this many tracked frames of each path (a replay)")
    args = ap.parse_args()
    seeds = [int(x) for x in args.seeds.split(",")]

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU fallback here", file=sys.stderr)
        return 1
    import racing_slam_tpu_torch  # noqa: F401  (fails outside the repository)
    from racing_slam_tpu_torch.ops.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)

    t0 = time.time()
    _build.build(verbose=True)
    _build.lib()
    log(f"kernel build: {time.time() - t0:.1f} s")

    from racing_slam_tpu_torch.ops.camera import Camera

    cam = Camera(fx=480.0, fy=480.0, cx=320.0, cy=240.0, width=640, height=480)

    def worlds(seed: int) -> dict:
        """The seed's bench worlds by length (a world depends on its length)."""
        out = {}
        for n in sorted({p[2] for p in PATHS.values()}, reverse=True):
            t0 = time.time()
            out[n] = render_bench_world(seed, cam, n)
            log(f"rendered {n} frames of seed {seed} in {time.time() - t0:.1f} s")
        return out

    world = worlds(seeds[0])
    frames = world[N_FRAMES][0]

    kernels = [check_frontend(frames[1], dev), check_match(dev), check_motion_ba(dev),
               check_structure_ba(dev), check_match_banded(dev), check_attention(dev)]
    d256 = check_match(dev, D=256)
    kernels[1]["d256"] = {key: d256[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms")}
    for kern in kernels:
        log(f"{kern['name']}: kernel {kern['ms']:.4f} ms, plain PyTorch {kern['plain_ms']:.4f} ms, "
            f"bound {kern['bound_ms']:.4f} ms ({kern['bound_by']}), library {kern['library_ms']}")
    check_superpoint(frames[1], dev)
    time_schur_solvers(dev)

    runs = {path: run_path(path, dev, kernels, cam, *world[PATHS[path][2]], args.profile)
            for path in PATHS}
    for seed in seeds[1:]:
        world_s = worlds(seed)
        for path in PATHS:
            log(f"seed {seed}:")
            run_path(path, dev, kernels, cam, *world_s[PATHS[path][2]])
    table = []
    for kern in kernels:
        by_path = {path: r["launches"][kern["name"]] for path, r in runs.items()}
        row = dict(name=kern["name"], route="cuda", source=kern["source"],
                   replaces=kern["replaces"], launches=sum(by_path.values()),
                   launches_by_path=by_path)
        row.update({key: kern[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")})
        if "d256" in kern:
            row["d256"] = kern["d256"]
        table.append(row)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
