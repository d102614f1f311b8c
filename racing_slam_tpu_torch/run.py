"""Command line: run the SLAM engine on a sequence, on the card.

Usage:
    python -m racing_slam_tpu_torch <sequence.yaml> [options]
    python -m racing_slam_tpu_torch --synthetic [options]
    (add --device cpu to run on the CPU; without a card the default raises)

The port of racing_slam_tpu/run.py, with its flags, defaults, per-frame
print and artifacts: it loads the sequence YAML (video, mask, fx, fy; cx
and cy default to the image centre) or renders a synthetic sprite world,
bootstraps, steps frame by frame printing the reprojection error and the
match, keyframe and point counts, and writes metrics.jsonl, overlays,
trajectory.png, map.ply, trajectory.tum and state.npz under --out. The
figures need matplotlib; without it they are skipped with a note.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import time
from pathlib import Path


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="racing_slam_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("sequence", nargs="?", help="sequence YAML (video/mask/fx/fy/cx/cy)")
    p.add_argument("--synthetic", action="store_true",
                   help="run on a generated sprite-world sequence")
    p.add_argument("--synthetic-frames", type=int, default=48)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--out", type=Path, default=None, help="output dir for artifacts")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save state every N keyframes (0=off)")
    p.add_argument("--overlay-every", type=int, default=0,
                   help="save a keypoint/match overlay image every N frames (0=off; needs --out)")
    p.add_argument("--resume", type=Path, default=None, help="resume from a state checkpoint")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the state and kernels (default: the card; "
                        "'cpu' runs the kernels' plain PyTorch versions)")
    # The reference's five feature flags.
    for flag, default in [("triangulate-points", True), ("bundle-adjust", True),
                          ("optimize-pose", True), ("cull-points", True),
                          ("essential-matrix-estimation", False)]:
        p.add_argument(f"--{flag}", dest=flag.replace("-", "_"),
                       action=argparse.BooleanOptionalAction, default=default)
    p.add_argument("--max-keyframes", type=int, default=32)
    p.add_argument("--map-capacity", type=int, default=4096)
    p.add_argument("--frontend", choices=["classical", "learned"], default="classical",
                   help="classical = Shi-Tomasi + patch descriptors (default); "
                        "learned = SuperPoint")
    p.add_argument("--weights", type=Path, default=None,
                   help="superpoint .npz weights for --frontend learned (default: "
                        "racing_slam_tpu/weights/superpoint.npz, else random weights)")
    p.add_argument("--matcher", choices=["classical", "lightglue"], default="classical",
                   help="frame<->frame matcher: mutual-1NN or LightGlue")
    p.add_argument("--lightglue-weights", type=Path, default=None,
                   help="lightglue .npz (default: the committed weights)")
    p.add_argument("--prediction", default="constant_position",
                   choices=("constant_position", "constant_velocity", "adaptive"),
                   help="initial-pose model; 'adaptive' switches to essential-matrix "
                        "prediction with a constant-speed scale prior while tracking is "
                        "starved (a host branch on the inliers each frame reads anyway)")
    p.add_argument("--min-commit-inliers", type=int, default=0,
                   help="absolute keyframe-commit floor (0 = the purely relative 0.9 rule)")
    p.add_argument("--match-backend", default="auto", choices=("auto", "banded"),
                   help="guided matcher: 'auto' = dense (kernel K2); 'banded' = y-sorted "
                        "bands (kernel K5) for large map capacities")
    p.add_argument("--local-ba-window", type=int, default=1,
                   help="keyframes freed by the commit-time local BA: 1 = newest only; "
                        "W>1 re-solves the W newest poses at each commit")
    p.add_argument("--refine-every", type=int, default=0,
                   help="run a full bundle adjustment over all live keyframes and points "
                        "every N frames (0=off)")
    p.add_argument("--monitor-every", type=int, default=1,
                   help="recompute the reprojection-error monitor every N frames "
                        "(1=every frame, 0=only at keyframe commits)")
    p.add_argument("--interactive", action="store_true",
                   help="step manually: wait for Enter between frames (q+Enter quits); "
                        "combine with --overlay-every 1 --out DIR for a per-frame view")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    import numpy as np

    from .ops.camera import Camera
    from .slam.config import SlamConfig, load_sequence_yaml
    from .slam.pipeline import Slam
    from .utils import viz
    from .utils.checkpoint import load_state, save_state
    from .utils.timing import MetricsSink, StageTimer
    from .utils.video import ArraySource, load_mask, open_video

    cfg = SlamConfig(
        triangulate_points=args.triangulate_points,
        bundle_adjust=args.bundle_adjust,
        optimize_pose=args.optimize_pose,
        cull_points=args.cull_points,
        essential_matrix_estimation=args.essential_matrix_estimation,
        max_keyframes=args.max_keyframes,
        map_capacity=args.map_capacity,
        matcher=args.matcher,
        lightglue_weights=str(args.lightglue_weights or ""),
        refine_every_frames=args.refine_every,
        reproj_monitor_every=args.monitor_every,
        local_ba_window=args.local_ba_window,
        pose_prediction=args.prediction,
        min_commit_inliers=args.min_commit_inliers,
        matching_backend=args.match_backend,
    )

    gt_poses = None
    if args.synthetic:
        from .utils.synthetic import make_sequence

        cam = Camera(fx=480.0, fy=480.0, cx=320.0, cy=240.0, width=640, height=480)
        seq = make_sequence(np.random.default_rng(args.seed), n_frames=args.synthetic_frames,
                            cam=cam, n_sprites=260,
                            step_t=np.array([0.05, 0.005, 0.10], np.float32))
        source = ArraySource(seq.frames)
        gt_poses = seq.poses
        mask = None
    elif args.sequence:
        sc = load_sequence_yaml(args.sequence)
        source = open_video(sc.video)
        print(f"decoder: {source.decoder}")
        cx = sc.cx if sc.cx is not None else source.width / 2
        cy = sc.cy if sc.cy is not None else source.height / 2
        cam = Camera(fx=sc.fx, fy=sc.fy, cx=cx, cy=cy, width=source.width, height=source.height)
        mask = load_mask(sc.mask) if sc.mask else None
    else:
        print("error: provide a sequence YAML or --synthetic", file=sys.stderr)
        return 2

    frontend = None
    if args.frontend == "learned":
        from .models import WEIGHTS_DIR
        from .models.superpoint import SuperPointFrontend, load_params

        wpath = args.weights
        if wpath is None:
            packaged = WEIGHTS_DIR / "superpoint.npz"
            wpath = packaged if packaged.exists() else None
        elif not Path(wpath).exists():
            print(f"error: --frontend learned needs trained weights; {wpath} does not exist",
                  file=sys.stderr)
            return 2
        params = load_params(wpath, device=args.device) if wpath else None
        if params is None:
            print("note: --frontend learned with RANDOM weights "
                  "(train via python -m racing_slam_tpu_torch.models.train)")
        frontend = SuperPointFrontend(params=params, cell=cfg.cell, n_per_cell=cfg.n_per_cell,
                                      device=args.device)
    slam = Slam(cam, source, cfg, static_mask=mask, seed=args.seed, frontend=frontend,
                device=args.device)
    if args.resume:
        slam.resume(load_state(args.resume, archive_capacity=cfg.archive_capacity,
                               device=slam.device))
        print(f"resumed from {args.resume} (kf={int(slam.state.num_kf)})")

    timer = StageTimer()
    out = args.out
    if out:
        out.mkdir(parents=True, exist_ok=True)
    sink = MetricsSink(out / "metrics.jsonl") if out else None
    figures = importlib.util.find_spec("matplotlib") is not None
    if out and not figures:
        print("note: matplotlib is not installed; trajectory.png and overlays are skipped")
    if args.overlay_every and out and figures:
        slam.keep_last_image = True

    if int(slam.state.num_kf) < 2:
        with timer.stage("initialize"):
            if not slam.initialize():
                print("Initialization failed")
                return 1
        print(f"Initialized with keyframes {slam.keyframe_indices().tolist()}, "
              f"{int(slam.state.map.num_points())} points")

    n = 0
    last_kf_count = int(slam.state.num_kf)
    t_start = time.time()
    try:
        while args.max_frames is None or n < args.max_frames:
            if args.interactive and n > 0:
                try:
                    if input("[Enter]=step  q=quit > ").strip().lower() == "q":
                        break
                except EOFError:
                    break
            with timer.stage("step", block_on=None):
                info = slam.step()
            if info is None:
                break
            n += 1
            if not args.quiet:
                print(f"frame {n}: reprojection error: {float(info.reproj_error_px):.3f} | "
                      f"matches {int(info.n_matches_total)} | "
                      f"keyframes {int(info.n_keyframes)} | "
                      f"points {int(info.n_points)}"
                      + ("  [new keyframe]" if info.is_keyframe else ""))
            if sink:
                sink.write(dict(frame=n, reproj_px=float(info.reproj_error_px),
                                n_matches=int(info.n_matches_total),
                                n_keyframes=int(info.n_keyframes), n_points=int(info.n_points),
                                is_keyframe=info.is_keyframe))
            if args.overlay_every and out and figures and n % args.overlay_every == 0:
                viz.save_overlay(out / f"overlay_{n:05d}.png", **slam.overlay_data())
            if (args.checkpoint_every and out
                    and int(slam.state.num_kf) >= last_kf_count + args.checkpoint_every):
                save_state(out / "state.npz", slam.state)
                last_kf_count = int(slam.state.num_kf)
    finally:
        if sink:
            sink.close()

    dt = time.time() - t_start
    print(f"\nprocessed {n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.1f} fps)")
    print(f"final reprojection error: {slam.reprojection_error():.3f} px")
    if slam.essential_predictions:
        print(f"essential-matrix predictions: {slam.essential_predictions} frames")
    print(timer.report())

    # After --resume the frame counter continues from the checkpoint while the
    # synthetic sequence restarts, so keyframe indices no longer name its frames.
    if gt_poses is not None and not args.resume and int(slam.state.num_kf) >= 2:
        from .utils.metrics import ate_rmse

        kf_idx = slam.keyframe_indices(include_archived=True)
        ate = ate_rmse(slam.poses(include_archived=True), gt_poses[kf_idx])
        print(f"ATE vs ground truth: {ate:.4f}")

    if out:
        # The full trajectory: archived (evicted) keyframes, then the live ones.
        poses = slam.poses(include_archived=True)
        pts = slam.points()
        colors = slam.state.map.color.cpu().numpy()[slam.state.map.valid.cpu().numpy()]
        if figures:
            viz.save_trajectory_plot(out / "trajectory.png", poses, pts, colors)
        viz.export_ply(out / "map.ply", pts, colors, poses)
        viz.save_trajectory_tum(out / "trajectory.tum", poses,
                                stamps=slam.keyframe_indices(include_archived=True).astype(float))
        save_state(out / "state.npz", slam.state)
        print(f"artifacts written to {out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
