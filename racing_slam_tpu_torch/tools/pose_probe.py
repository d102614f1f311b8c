"""The essential-matrix pose prediction on the card: how accurate the
frame-to-frame relative pose is, and how the prediction paths' readings
spread over worlds and bootstrap draws.

Run from the root of a checkout on one CUDA card:

    python3 -m racing_slam_tpu_torch.tools.pose_probe --accuracy 3 \\
        --paths essential,adaptive --seeds 3,5,7,8,9 --slam-seeds 0,1,2 \\
        [--worlds build/worlds] [--frames 304] [--dump-flips FILE]

``--accuracy S`` takes every 6th pair of consecutive frames of seed S's
bench world, matches them with the classical frontend on the card, and
estimates their relative pose (``ops.ransac.estimate_relative_pose``, 512
hypotheses drawn by a generator seeded with the frame index) four ways:
the 8-point algebra and decomposition (``ops.essential.SOLVE_DTYPE``) in
float32 and in float64, each on the card and on the CPU from the same
matches and uniforms. It prints the angle of the estimated translation
direction and of the rotation against the ground truth (median, 90th
percentile, maximum), and the host wall time of one estimate on the card.

``--dump-flips FILE`` writes the pairs whose rotation comes out more than
90 degrees off on the card in float64 (a cheirality choice of the wrong
decomposition) to an .npz: each pair's matched pixels, mask, uniforms and
ground-truth relative pose, for a comparison with the JAX package's
decomposition on the CPU (tests/decompose_probe.py).

``--paths P,...`` runs each ``chip_smoke.py`` path on each seed's world
(``--seeds``) for each seed of the port's bootstrap generator
(``--slam-seeds``) and prints ATE, coverage, re-initialisations, fps, the
frames that took the essential prediction and each trajectory segment's
first and last keyframe and keyframe count, one ``pose_probe {json}`` line
a run. Unlike ``chip_smoke.py`` it holds no run to a limit: it measures
the spread. The path ``cli`` is the command line's synthetic run
(``run.py``: its 96-frame world of seed 0 as ``chip_smoke.py`` phase 5
runs it, its default configuration, ``Slam.step`` frame by frame) and
ignores ``--seeds``. ``--worlds DIR`` caches the rendered worlds
(``path_seeds``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np


def _angle(a: np.ndarray, b: np.ndarray) -> float:
    c = abs(float(np.dot(a, b))) / (np.linalg.norm(a) * np.linalg.norm(b))
    return float(np.degrees(np.arccos(min(c, 1.0))))


def accuracy(frames: list, gt: np.ndarray, cam, dump: Path | None = None) -> None:
    import torch

    from racing_slam_tpu_torch.ops import essential, ransac
    from racing_slam_tpu_torch.slam.frontend import ClassicalFrontend

    fe = ClassicalFrontend()
    modes = [(dev, dt) for dev in ("cuda", "cpu") for dt in (torch.float32, torch.float64)]
    t_err = {m: [] for m in modes}
    r_err = {m: [] for m in modes}
    flips = []
    for i in range(2, len(frames) - 1, 6):
        f0, f1 = [fe.extract(torch.from_numpy(frames[j].astype(np.float32) / 255.0).cuda())
                  for j in (i, i + 1)]
        fm = fe.matcher(f0.desc, f0.xy, f0.valid, f1.desc, f1.xy, f1.valid)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(i)
        args = (f0.xy[fm.train_idx], f1.xy, fm.valid,
                torch.rand((512, f1.xy.shape[0]), generator=gen, device="cuda"))
        T = gt[i + 1] @ np.linalg.inv(gt[i])
        for dev, dt in modes:
            essential.SOLVE_DTYPE = dt
            a = [x.to(dev) for x in args]
            P = ransac.estimate_relative_pose(cam, *a[:3], None, uniforms=a[3]).pose.cpu().numpy()
            t_err[dev, dt].append(_angle(P[:3, 3], T[:3, 3]))
            c = (np.trace(P[:3, :3].T @ T[:3, :3]) - 1.0) / 2.0
            r_err[dev, dt].append(float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))))
            if (dev, dt) == ("cuda", torch.float64) and r_err[dev, dt][-1] > 90.0:
                flips.append((i, [x.cpu().numpy() for x in args], T))
    for dev, dt in modes:
        essential.SOLVE_DTYPE = dt
        wall = None
        if dev == "cuda":
            for _ in range(3):
                ransac.estimate_relative_pose(cam, *args[:3], None, uniforms=args[3])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                ransac.estimate_relative_pose(cam, *args[:3], None, uniforms=args[3])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 20 * 1e3
        t, r = np.array(t_err[dev, dt]), np.array(r_err[dev, dt])
        print("pose_probe " + json.dumps(dict(
            probe="accuracy", device=dev, solve_dtype=str(dt).split(".")[-1], pairs=len(t),
            t_deg_median=float(np.median(t)), t_deg_p90=float(np.percentile(t, 90)),
            t_deg_max=float(t.max()), R_deg_median=float(np.median(r)),
            R_deg_max=float(r.max()), estimate_wall_ms=wall)), flush=True)
    essential.SOLVE_DTYPE = torch.float64
    print("pose_probe " + json.dumps(dict(probe="flips", pairs=[i for i, _, _ in flips],
                                          R_deg=[r_err["cuda", torch.float64][(i - 2) // 6]
                                                 for i, _, _ in flips])), flush=True)
    if dump is not None and flips:
        dump.parent.mkdir(parents=True, exist_ok=True)
        np.savez(dump, frame=np.array([i for i, _, _ in flips]),
                 **{f"{k}_{n}": a[j] for n, (_, a, _) in enumerate(flips)
                    for j, k in enumerate(("uv1", "uv2", "mask", "uniforms"))},
                 **{f"T_{n}": T for n, (_, _, T) in enumerate(flips)},
                 cam=np.array(tuple(cam), np.float64))


def cli_world(cam) -> tuple[list, np.ndarray]:
    """The command line's synthetic world at chip_smoke.py's length."""
    import chip_smoke as cs
    from racing_slam_tpu_torch.utils.synthetic import make_sequence

    seq = make_sequence(np.random.default_rng(0), n_frames=cs.CLI_FRAMES, cam=cam, n_sprites=260,
                        step_t=np.array([0.05, 0.005, 0.10], np.float32))
    return seq.frames, seq.poses


def spread(path: str, seed: int, slam_seed: int, frames: list, gt: np.ndarray, cam) -> None:
    import torch

    import chip_smoke as cs
    from racing_slam_tpu_torch.slam.config import SlamConfig
    from racing_slam_tpu_torch.slam.pipeline import Slam
    from racing_slam_tpu_torch.utils.video import ArraySource

    cfg = SlamConfig(triangulate_points=True, bundle_adjust=True, optimize_pose=True,
                     cull_points=True) if path == "cli" else cs.path_config(path)
    slam = Slam(cam, ArraySource(frames), cfg, device="cuda", seed=slam_seed)
    assert slam.initialize(), f"{path} seed {seed}: bootstrap failed"
    t0 = time.time()
    if path == "cli":
        n = len(slam.run())
    else:
        n = slam.run_batched(batch=cs.BATCH)
    torch.cuda.synchronize()
    fps = n / (time.time() - t0)
    acc = cs.full_trajectory_ate(slam, gt, len(frames))
    segs = [s["frame_indices"] for s in slam.segments] + [slam.keyframe_indices(True)]
    print("pose_probe " + json.dumps(dict(
        probe="spread", path=path, seed=seed, slam_seed=slam_seed,
        ate_pct=100 * acc["ate"] / acc["length"], coverage=acc["coverage"],
        reinits=slam.n_reinits, eof_on_reinit=slam.eof_on_reinit, fps=fps,
        essential_predictions=slam.essential_predictions, tracked=slam.frames_tracked,
        segments=[[int(s[0]), int(s[-1]), len(s)] for s in segs if len(s)])), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--accuracy", type=int, default=None, help="world seed of the pose probe")
    ap.add_argument("--paths", default="", help="chip_smoke.py paths to spread over draws")
    ap.add_argument("--seeds", default="3")
    ap.add_argument("--slam-seeds", default="0")
    ap.add_argument("--worlds", type=Path, default=None)
    ap.add_argument("--frames", type=int, default=304, help="length of the bench worlds")
    ap.add_argument("--dump-flips", type=Path, default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())  # this checkout's chip_smoke and port

    import torch

    if not torch.cuda.is_available():
        print("pose_probe: no CUDA device", file=sys.stderr)
        return 1
    from racing_slam_tpu_torch.ops.kernels import _build
    from racing_slam_tpu_torch.tools.path_seeds import _camera, worlds

    seeds = [int(x) for x in args.seeds.split(",")]
    need = sorted(({args.accuracy} if args.accuracy is not None else set())
                  | (set(seeds) if set(args.paths.split(",")) - {"", "cli"} else set()))
    world = worlds(need, args.frames, args.worlds)
    _build.build()
    _build.lib()
    cam = _camera()
    if args.accuracy is not None:
        accuracy(*world[args.accuracy], cam, args.dump_flips)
    for path in filter(None, args.paths.split(",")):
        for s in seeds if path != "cli" else [0]:
            for g in [int(x) for x in args.slam_seeds.split(",")]:
                spread(path, s, g, *(world[s] if path != "cli" else cli_world(cam)), cam)
    return 0


if __name__ == "__main__":
    sys.exit(main())
