#!/usr/bin/env python3
"""Drive the PyTorch port (racing_slam_tpu_torch) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     no CUDA device is a failure, there is no CPU fallback;
  2. build the four CUDA kernels from racing_slam_tpu_torch/csrc;
  3. each kernel against its plain-PyTorch twin on the card, at the shapes
     of the main path (640x480 frame, P=4096 map points x O=8 observations,
     K=2400 keypoints, commit BA over 2432 points and 32 cameras), with
     CUDA-event times (median of 25 runs after warm-up);
  4. the slice on the card: the 304-frame bench world of seed 3 (640x480),
     Slam.initialize() + run_batched(batch=48) with the launch counters set
     to 0 just before; accuracy (full-trajectory Sim(3) ATE, coverage) is
     held to ATE <= 10 % and coverage >= 0.85, every kernel must have run.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from collections import Counter

import numpy as np

SEED = 3
N_FRAMES = 304
BATCH = 48


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of fn() in ms (CUDA events around each run)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
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
    plain = cuda_ms(lambda: k.corner_frontend_fused_reference(img, mask))
    return dict(name="corner_frontend_fused", module=k, max_abs_err=err, ms=ms, plain_ms=plain,
                source="racing_slam_tpu_torch/csrc/frontend_kernel.cu",
                replaces="racing_slam_tpu/ops/pallas/frontend_kernel.py:167")


def check_match(dev) -> dict:
    """K2 at P=4096, O=8, D=128, K=2400 on a 640x480 frame, radius 28 px,
    with planted exact ties (duplicate keypoints within the radius).

    Tolerances: the kernel and the twin sum the 128 bf16 products in a
    different order, so squared distances agree to 1e-5 (128 terms of
    float32 rounding) and a keypoint choice may flip only at a near-tie:
    >= 99.9 % of the points must pick the same keypoint, every planted tie
    must go to the lower index, and distances must agree where both pick
    the same keypoint."""
    import torch

    from racing_slam_tpu_torch.ops.kernels import match as k

    rng = np.random.default_rng(7)
    P, O, D, K = 4096, 8, 128, 2400
    kp_uv = np.stack([rng.uniform(0, 640, K), rng.uniform(0, 480, K)], -1).astype(np.float32)
    kp_desc = rng.standard_normal((K, D)).astype(np.float32)
    kp_desc /= np.linalg.norm(kp_desc, axis=-1, keepdims=True)
    src = rng.integers(0, K, P)
    uv_p = (kp_uv[src] + rng.uniform(-6, 6, (P, 2))).astype(np.float32)
    obs = kp_desc[src][:, None, :] + 0.15 * rng.standard_normal((P, O, D)).astype(np.float32)
    obs /= np.linalg.norm(obs, axis=-1, keepdims=True)
    obs_valid = rng.uniform(size=(P, O)) < 0.7
    gate = rng.uniform(size=P) < 0.6
    kp_ok = rng.uniform(size=K) < 0.95
    # Planted ties: keypoint 2*i+1 duplicates 2*i (position 1 px away).
    for i in range(0, 200, 2):
        kp_desc[i + 1] = kp_desc[i]
        kp_uv[i + 1] = kp_uv[i] + 1.0
        kp_ok[i] = kp_ok[i + 1] = True
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    args = (t(uv_p), t(gate), t(obs).to(torch.bfloat16), t(obs_valid), t(kp_uv), t(kp_desc),
            t(kp_ok))
    bk, bd = k.guided_match_stage1(*args, radius_px=28.0)
    rk, rd = k.guided_match_stage1_reference(*args, radius_px=28.0)
    torch.cuda.synchronize()
    bk, bd, rk, rd = [x.cpu().numpy() for x in (bk, bd, rk, rd)]
    same = bk == rk
    agree = same.mean()
    assert agree >= 0.999, f"K2 keypoint agreement {agree}"
    # Where the twin picked a planted pair's lower index, the pair tied
    # exactly: the kernel must pick that same (lower) index.
    tie_pts = np.isin(rk, np.arange(0, 200, 2)) & (rd < 1e9)
    assert (bk[tie_pts] == rk[tie_pts]).all(), "K2 planted tie not resolved to the lower index"
    err = float(np.abs(bd[same] - rd[same]).max())
    assert err <= 1e-5, f"K2 distance error {err}"
    log(f"K2 guided match: keypoint agreement {agree:.5f}, |d2| err {err:.3e}, "
        f"gated points matched {(bd < 1e9).sum()}")
    ms = cuda_ms(lambda: k.guided_match_stage1(*args, radius_px=28.0))
    plain = cuda_ms(lambda: k.guided_match_stage1_reference(*args, radius_px=28.0))
    return dict(name="guided_match_stage1", module=k, max_abs_err=err, ms=ms, plain_ms=plain,
                source="racing_slam_tpu_torch/csrc/match_kernel.cu",
                replaces="racing_slam_tpu/ops/pallas/match_kernel.py:115")


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
    plain = cuda_ms(lambda: k.motion_ba_lm_reference(*args, **kw))
    return dict(name="motion_ba_lm", module=k, max_abs_err=err, ms=ms, plain_ms=plain,
                source="racing_slam_tpu_torch/csrc/motion_ba_kernel.cu",
                replaces="racing_slam_tpu/ops/pallas/motion_ba_kernel.py:309")


def check_structure_ba(dev) -> dict:
    """K4 at the commit shape: Pc=2432 points x O=8 observations, F=32
    cameras, the newest camera free, 10 iterations, pixel Huber scale.

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
    held to 1e-2 px.

    Then with the exit on, as the main path runs it: the same pose
    tolerances, cost within 1 % either way, and iteration counts within 1
    of each other (one side may stop an iteration early, see above)."""
    import torch

    from racing_slam_tpu_torch.ops.kernels import structure_ba as k

    rng = np.random.default_rng(13)
    F, P, O = 32, 2432, 8
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
    out, pts = k.structure_ba_lm(*args, **kw, ftol=0.0)
    ref, rpts = k.structure_ba_lm_reference(*args, **kw, ftol=0.0)
    out, pts, ref, rpts = [x.cpu().numpy() for x in (out, pts, ref, rpts)]
    np.testing.assert_allclose(out[:3], ref[:3], atol=1e-5)
    np.testing.assert_allclose(out[3:6], ref[3:6], atol=1e-4)
    assert abs(out[6] - ref[6]) <= 0.01 * ref[6] + 1e-10, (out[6], ref[6])
    assert out[7] == ref[7], (out[7], ref[7])
    perr = np.linalg.norm(pts - rpts, axis=-1)
    assert np.median(perr) < 1e-4, np.median(perr)
    assert perr.max() < 5e-2, perr.max()
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
        return fx * Xc[..., :2] / Xc[..., 2:3]

    px = np.abs(pixels(out, pts) - pixels(ref, rpts)).max(-1)[include].max()
    assert px < 1e-2, f"K4 reprojections differ by {px} px"
    err = float(max(np.abs(out[:6] - ref[:6]).max(), perr.max()))
    log(f"K4 structure BA (10 iterations each): |pose| err {np.abs(out[:6] - ref[:6]).max():.3e}, "
        f"point err median {np.median(perr):.3e} max {perr.max():.3e}, "
        f"reprojection err max {px:.3e} px, cost {out[6]:.6e} vs {ref[6]:.6e}")
    out2, pts2 = k.structure_ba_lm(*args, **kw)
    ref2, _ = k.structure_ba_lm_reference(*args, **kw)
    out2, pts2, ref2 = [x.cpu().numpy() for x in (out2, pts2, ref2)]
    log(f"K4 with the tolerance exit: |pose| err {np.abs(out2[:6] - ref2[:6]).max():.3e}, "
        f"iterations {out2[7]:.0f} vs {ref2[7]:.0f}, cost {out2[6]:.6e} vs {ref2[6]:.6e}")
    np.testing.assert_allclose(out2[:3], ref2[:3], atol=1e-5)
    np.testing.assert_allclose(out2[3:6], ref2[3:6], atol=1e-4)
    assert abs(out2[6] - ref2[6]) <= 0.01 * ref2[6] + 1e-10, (out2[6], ref2[6])
    assert abs(out2[7] - ref2[7]) <= 1, (out2[7], ref2[7])
    assert np.isfinite(pts2).all() and np.array_equal(pts2[:100], Xn[:100].astype(np.float32))
    ms = cuda_ms(lambda: k.structure_ba_lm(*args, **kw))
    plain = cuda_ms(lambda: k.structure_ba_lm_reference(*args, **kw))
    return dict(name="structure_ba_lm", module=k, max_abs_err=err, ms=ms, plain_ms=plain,
                source="racing_slam_tpu_torch/csrc/structure_ba_kernel.cu",
                replaces="racing_slam_tpu/ops/pallas/structure_ba_kernel.py:336")


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


def run_slice(dev, kernels: list, cam, frames: list, gt: np.ndarray) -> dict:
    import torch

    from racing_slam_tpu_torch.slam.config import SlamConfig
    from racing_slam_tpu_torch.slam.pipeline import Slam
    from racing_slam_tpu_torch.utils.video import ArraySource

    # bench.py headline config with local_ba_window=1 and refine_every_frames=0.
    cfg = SlamConfig(
        match_radius_px=28.0, ransac_threshold_px=0.4, cull_reproj_px=3.0, inlier_px=3.0,
        triangulation_reproj_px=2.0, pose_prediction="constant_velocity",
        triangulate_points=True, bundle_adjust=True, optimize_pose=True, cull_points=True,
        max_keyframes=32, map_capacity=4096, max_observations=8, archive_capacity=512,
        reproj_monitor_every=0, refine_every_frames=0, local_ba_window=1,
        keyframe_match_ratio=0.8,
    )
    slam = Slam(cam, ArraySource(frames), cfg, device=dev)
    for kern in kernels:
        kern["module"].launches = 0
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.time()
        assert slam.initialize(), "bootstrap failed"
        t_init = time.time() - t0
        t1 = time.time()
        n = slam.run_batched(batch=BATCH)
        torch.cuda.synchronize()
        t_track = time.time() - t1
        torch.cuda.set_sync_debug_mode("default")
    launches = {kern["name"]: kern["module"].launches for kern in kernels}
    flagged = [w for w in caught if "synchroniz" in str(w.message)]
    sources = Counter(f"{w.filename.split('/')[-1]}:{w.lineno}" for w in flagged)
    log(f"synchronising calls flagged by torch.cuda sync debug mode: {len(flagged)}, "
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
    )
    log("slice: " + json.dumps(res))
    assert res["ate_pct"] <= 10.0, f"ATE {res['ate_pct']:.2f} % > 10 %"
    assert res["coverage"] >= 0.85, f"coverage {res['coverage']:.3f} < 0.85"
    bootstraps = 1 + slam.n_reinits
    assert launches["corner_frontend_fused"] >= tracked, launches
    assert launches["guided_match_stage1"] >= 2 * tracked, launches
    assert launches["motion_ba_lm"] >= 2 * tracked, launches
    assert launches["structure_ba_lm"] >= n_commits + bootstraps, launches
    return res


def main() -> int:
    import torch

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
    t0 = time.time()
    frames, gt = render_bench_world(SEED, cam, N_FRAMES)
    log(f"rendered {len(frames)} frames of seed {SEED} in {time.time() - t0:.1f} s")

    kernels = [check_frontend(frames[1], dev), check_match(dev), check_motion_ba(dev),
               check_structure_ba(dev)]
    for kern in kernels:
        log(f"{kern['name']}: kernel {kern['ms']:.4f} ms, plain PyTorch {kern['plain_ms']:.4f} ms")

    res = run_slice(dev, kernels, cam, frames, gt)
    table = [dict(name=kern["name"], route="cuda", source=kern["source"],
                  replaces=kern["replaces"], launches=res["launches"][kern["name"]],
                  max_abs_err=kern["max_abs_err"], ms=kern["ms"], plain_ms=kern["plain_ms"])
             for kern in kernels]
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
