"""A/B frames a second and device events of chip_smoke.py's paths, run
through several source trees of the port on one CUDA card.

Run from the repository root:

    python3 racing_slam_tpu_torch/tools/path_ab.py --tree NAME=DIR [--tree NAME=DIR ...]
        [--paths classical,learned,lightglue,headline,scale,adaptive,essential,multi]
        [--rounds 1] [--profile-frames 32] [--out FILE]

Each DIR is the root of a checkout (it holds ``racing_slam_tpu_torch/``);
the paths' configurations and frontends come from this checkout's
``chip_smoke.py`` (``path_config`` and ``superpoint_frontend`` for the
learned path, ``multi_config`` and ``multi_frontend``). The bench worlds of the
``multi`` path (seeds 3, 5, 7, 8, 9, 10, 11, 12; 98 frames, 640x480) are
rendered once, by worker processes, into ``build/path_ab/`` (and read
from there by later runs);
every single-sequence path runs on the first of them (seed 3, 96 tracked
frames), the multi paths (``multi``, ``multi_essential``, ``multi_adaptive``,
``multi_scale``, ``multi_learned``, ``multi_lightglue_essential``) on all
eight (MultiSlam, S=8; a tree whose MultiSlam refuses the configuration
prints ``refused``).

Each round runs the trees in order and then in reverse (A B B A for two
trees), each in a process of its own whose import path starts at its DIR,
so that it runs that tree's package and builds that tree's kernels into
DIR/build/kernels (every tree's build is made first, all at once). A
process warms the card up on 16 classical frames, then, for each path:
bootstrap, ``run_batched`` to the end of the world with the card
synchronised at both ends (frames a second; total over the eight rows on
``multi``; no sync debug mode), then a replay of the first
``--profile-frames`` frames under ``torch.profiler``
(``chip_smoke.profile_run``): device events, device busy ms and wall ms a
frame, with the window's largest device items and the port's kernels
(none with ``--profile-frames 0``; the profiler's own processing
takes minutes for a few hundred thousand events). Prints one JSON line per tree, path and round, then per path each
tree's median over its rounds and the ratio of each tree's to the first
tree's; ``--out`` also writes that summary as JSON.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SEEDS = (3, 5, 7, 8, 9, 10, 11, 12)
FRAMES = 98
PATHS = ("classical", "learned", "lightglue", "headline", "scale", "adaptive", "essential",
         "multi")
MARK = "PATH_AB "


def _chip_smoke():
    """This checkout's chip_smoke.py as a module (its port imports are made
    inside its functions, so they resolve to the tree on the import path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _camera():
    from racing_slam_tpu_torch.ops.camera import Camera

    return Camera(fx=480.0, fy=480.0, cx=320.0, cy=240.0, width=640, height=480)


def _sync(device: str) -> None:
    import torch

    if device != "cpu":
        torch.cuda.synchronize()


def _timed(fn, device: str) -> tuple:
    _sync(device)
    t0 = time.time()
    out = fn()
    _sync(device)
    return out, time.time() - t0


def _profile(cs, fn, frames: int, device: str) -> dict:
    """chip_smoke.profile_run of fn on the card, as numbers a frame; none
    when `frames` is 0 (fn is not run) or on the CPU (a dry run)."""
    if not frames or device == "cpu":
        if frames:
            fn()
        return {}
    prof = cs.profile_run(fn)
    return dict(device_events_per_frame=prof["device_events"] / frames,
                device_busy_ms_per_frame=prof["device_busy_ms"] / frames,
                profiled_wall_ms_per_frame=prof["wall_ms"] / frames,
                busy_share=prof["busy_share"], top_ms=prof["top_ms"], kernels=prof["kernels"])


def run_single(cs, path: str, cam, frames: list, profile_frames: int, device: str) -> dict:
    from racing_slam_tpu_torch.slam.pipeline import Slam
    from racing_slam_tpu_torch.utils.video import ArraySource

    frontend = cs.superpoint_frontend(device) if cs.PATHS[path][0] == "superpoint" else None
    slam = Slam(cam, ArraySource(frames), cs.path_config(path), frontend=frontend, device=device,
                seed=0)
    assert slam.initialize(), f"{path}: bootstrap failed"
    n, wall = _timed(lambda: slam.run_batched(batch=cs.BATCH), device)
    res = dict(frames=n, fps=n / wall, keyframes=int(slam.state.num_kf))
    if profile_frames:
        slam.reset_run(ArraySource(frames))
        assert slam.initialize()
        _sync(device)
    return dict(res, **_profile(
        cs, lambda: slam.run_batched(max_frames=profile_frames, batch=cs.BATCH), profile_frames,
        device))


def run_multi(cs, path: str, cam, worlds: list, profile_frames: int, device: str) -> dict:
    from racing_slam_tpu_torch.parallel.multi_seq import MultiSlam
    from racing_slam_tpu_torch.utils.video import ArraySource

    def fleet():
        ms = MultiSlam(cam, [ArraySource(f) for f in worlds], None, cs.multi_config(path),
                       frontend=cs.multi_frontend(path, device), device=device)
        assert ms.initialize(), f"{path}: bootstrap failed"
        _sync(device)
        return ms

    ms = fleet()
    n, wall = _timed(lambda: ms.run_batched(batch=cs.BATCH), device)
    res = dict(frames=n, fps=len(worlds) * n / wall, per_sequence_fps=n / wall)
    if profile_frames:
        ms = fleet()
    return dict(res, **_profile(
        cs, lambda: ms.run_batched(max_frames=profile_frames, batch=cs.BATCH), profile_frames,
        device))


def worker(args) -> None:
    """Run the paths through the tree at args.tree_dir (first on the import
    path) and print one marked JSON line per path."""
    sys.path.insert(0, str(Path(args.tree_dir).resolve()))
    from racing_slam_tpu_torch.slam.pipeline import Slam
    from racing_slam_tpu_torch.utils.video import ArraySource

    cs = _chip_smoke()
    cam = _camera()
    with np.load(args.worlds) as z:
        worlds = [list(z[f"w{i}"]) for i in range(len(SEEDS))]
    warm = Slam(cam, ArraySource(worlds[0][:18]), cs.path_config("classical"),
                device=args.device)
    assert warm.initialize()
    warm.run_batched(batch=cs.BATCH)
    _sync(args.device)
    for path in args.paths.split(","):
        try:
            if path.startswith("multi"):
                res = run_multi(cs, path, cam, worlds, args.profile_frames, args.device)
            else:
                res = run_single(cs, path, cam, worlds[0], args.profile_frames, args.device)
        except NotImplementedError as e:  # a tree whose MultiSlam refuses the configuration
            res = dict(refused=str(e))
        print(MARK + json.dumps(dict(tree=args.name, path=path, round=args.round, **res)),
              flush=True)


def _build(trees: dict) -> None:
    """Build every tree's kernels, all trees at once."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from racing_slam_tpu_torch.ops.kernels import _build; _build.build()")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(d)]) for d in trees.values()]
    for p in procs:
        if p.wait(timeout=600):
            raise SystemExit(f"a kernel build failed (exit {p.returncode})")


def _render(path: Path, frames: int) -> None:
    sys.path.insert(0, str(REPO))
    from racing_slam_tpu_torch.tools.scaling import render_worlds

    pool, res = render_worlds(_camera(), [(s, frames) for s in SEEDS])
    try:
        worlds = res.get()
    finally:
        pool.close()
        pool.join()
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{f"w{i}": np.stack(f) for i, (f, _) in enumerate(worlds)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], help="NAME=DIR (repeat)")
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="chip_smoke.py's single paths and multi paths (multi_essential, ...)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--profile-frames", type=int, default=32, help="0: fps only")
    ap.add_argument("--out", default=None)
    ap.add_argument("--frames", type=int, default=FRAMES, help="world length (frames)")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a dry run")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--tree-dir", help=argparse.SUPPRESS)
    ap.add_argument("--name", help=argparse.SUPPRESS)
    ap.add_argument("--round", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--worlds", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    if not trees:
        ap.error("give at least one --tree NAME=DIR")
    t0 = time.time()
    worlds = REPO / "build" / "path_ab" / f"worlds_{args.frames}.npz"  # kept for later runs
    if args.device != "cpu":
        _build(trees)
    if not worlds.exists():
        _render(worlds, args.frames)
    print(f"built {len(trees)} trees and rendered {len(SEEDS)} worlds in "
          f"{time.time() - t0:.1f} s", flush=True)
    order = list(trees) + list(reversed(trees))
    rows = []
    for r in range(args.rounds):
        for name in order:
            run = subprocess.run(
                [sys.executable, __file__, "--worker", "--tree-dir", trees[name], "--name", name,
                 "--round", str(r), "--worlds", str(worlds), "--paths", args.paths,
                 "--profile-frames", str(args.profile_frames), "--device", args.device],
                capture_output=True, text=True, timeout=1800, env=dict(os.environ))
            sys.stderr.write(run.stderr[-4000:])
            if run.returncode:
                raise SystemExit(f"{name}: worker exited {run.returncode}")
            for line in run.stdout.splitlines():
                if line.startswith(MARK):
                    rows.append(json.loads(line[len(MARK):]))
                    print(line[len(MARK):], flush=True)
    first = next(iter(trees))
    keys = ("fps", "device_events_per_frame", "device_busy_ms_per_frame",
            "profiled_wall_ms_per_frame")
    summary = {}
    for path in args.paths.split(","):
        ran = {name: [x for x in rows if x["tree"] == name and x["path"] == path
                      and "refused" not in x] for name in trees}
        med = {name: {k: statistics.median(x[k] for x in ran[name]) for k in keys
                      if k in ran[name][0]} for name in trees if ran[name]}
        base = med.get(first)
        summary[path] = dict(median=med, ratio_to_first={
            name: {k: m[k] / base[k] if base and base.get(k) else None for k in m}
            for name, m in med.items()})
        print(f"summary {path}: " + json.dumps(summary[path]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(rows=rows, summary=summary), indent=1))
    print(f"path_ab wall time: {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
