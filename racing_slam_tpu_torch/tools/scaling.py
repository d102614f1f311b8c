"""Frames per second of MultiSlam at S=1 and S=N sequences on one device, in
one call (the port's counterpart of bench_scaling.py), and a dry run of the
landmark-sharded BA over n ranks (of __graft_entry__.dryrun_multichip).

On one card this measures the intra-card batching curve
(bench_scaling.py:8-9): S sequences share each kernel launch of the
lockstep step, so the host's launches are spent on S frames at once.
Multi-card scaling is not measured here. Runs alternate S=1, S=N, S=N,
S=1, after one warm-up run at S=1, so that both sizes see the same
clocks; each run reports its total and per-sequence fps.

Run from the repository root:

    python3 -m racing_slam_tpu_torch.tools.scaling [--sequences 8] [--frames 96]
        [--batch 16] [--device cuda]

The world is bench_scaling.py:95-115's (640x480, 260 sprites, seeds 7+i,
map_capacity=4096, max_keyframes=32, max_observations=8), rendered by
worker processes. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

BENCH_STEP = (0.05, 0.005, 0.10)  # bench.py's dolly step a frame


def render_world(args) -> tuple[list, np.ndarray]:
    """One bench world, args = (seed, n_frames, camera fields): (uint8
    frames, ground-truth poses)."""
    from ..ops.camera import Camera
    from ..utils.synthetic import make_sequence

    seed, n_frames, cam = args
    seq = make_sequence(np.random.default_rng(seed), n_frames=n_frames, cam=Camera(*cam),
                        n_sprites=260, step_t=np.array(BENCH_STEP, np.float32),
                        yaw_per_frame=0.002)
    return [np.clip(f * 255.0, 0, 255).astype(np.uint8) for f in seq.frames], seq.poses


def render_worlds(cam, worlds: list):
    """Render [(seed, n_frames)] bench worlds in spawned worker processes,
    one fewer than the host's cores (a world is rendered in order, frame
    by frame); (pool, an AsyncResult whose .get() is the list of (frames,
    poses) in order). The caller closes the pool after .get()."""
    import multiprocessing as mp

    n = min(len(worlds), max(1, (os.cpu_count() or 2) - 1))
    pool = mp.get_context("spawn").Pool(n)
    return pool, pool.map_async(render_world, [(s, f, tuple(cam)) for s, f in worlds], chunksize=1)


def bench_scaling_config():
    """bench_scaling.py's SlamConfig (its :104-112)."""
    from ..slam.config import SlamConfig

    return SlamConfig(triangulate_points=True, bundle_adjust=True, optimize_pose=True,
                      cull_points=True, max_keyframes=32, map_capacity=4096, max_observations=8)


def fleet_fps(cam, frames: list, cfg, device, batch: int = 16,
              max_frames: int | None = None) -> dict:
    """One MultiSlam run over `frames` (a list of S uint8 frame lists):
    bootstrap, then `run_batched`; the tracking wall (synchronised) gives
    total fps (S frames a lockstep frame) and per-sequence fps."""
    from ..parallel.multi_seq import MultiSlam
    from ..utils.video import ArraySource

    ms = MultiSlam(cam, [ArraySource(f) for f in frames], None, cfg, device=device)
    t0 = time.perf_counter()
    assert ms.initialize(), "bootstrap failed"
    if ms.device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    n = ms.run_batched(max_frames=max_frames, batch=batch)
    if ms.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    S = len(frames)
    return dict(sequences=S, frames=n, init_s=t1 - t0, track_s=wall, total_fps=S * n / wall,
                per_sequence_fps=n / wall)


def alternate(cam, worlds: list, cfg, device, n_seq: int, batch: int, max_frames: int) -> dict:
    """A warm-up run at S=1, then S=1, S=N, S=N, S=1 over the first 1 and
    first N worlds; every run and the medians by S."""
    fleet_fps(cam, [worlds[0]], cfg, device, batch, max_frames=min(16, max_frames))
    runs = [fleet_fps(cam, worlds[:S], cfg, device, batch, max_frames)
            for S in (1, n_seq, n_seq, 1)]
    med = {S: {k: float(np.median([r[k] for r in runs if r["sequences"] == S]))
               for k in ("total_fps", "per_sequence_fps")} for S in (1, n_seq)}
    return dict(runs=runs, median=med,
                total_fps_ratio=med[n_seq]["total_fps"] / med[1]["total_fps"])


def _dryrun_rank(rank: int, world: int, store: str, device: str, out: str) -> None:
    """One rank of dryrun_multichip."""
    from ..ops.ba import full_ba
    from ..parallel.dist_ba import distributed_full_ba
    from ..parallel.mesh import initialize_distributed, make_mesh

    initialize_distributed(num_processes=world, process_id=rank, store_path=store,
                           device=device, timeout_s=120.0)
    dev = torch.device(device, rank) if device == "cuda" else torch.device(device)
    mesh = make_mesh({"lm": world}, device=dev.type)
    cam, prob = dryrun_problem(dev)
    res = distributed_full_ba(cam, prob, mesh)
    if rank == 0:
        want = full_ba(cam, prob)
        diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(res, want))
        with open(out, "w") as f:
            json.dump(dict(ranks=world, device=device, max_abs_diff_vs_full_ba=diff,
                           cost=float(res.cost)), f)
    torch.distributed.destroy_process_group()


def dryrun_problem(dev, F: int = 4, P: int = 64, O: int = 4):
    """__graft_entry__.dryrun_multichip's problem: P points seen by O of F
    cameras on a short baseline, the newest camera free, points noisy."""
    from ..ops.ba import BAProblem
    from ..ops.camera import Camera

    rng = np.random.default_rng(0)
    cam = Camera(fx=100.0, fy=100.0, cx=32.0, cy=32.0, width=64, height=64)
    X = np.stack([rng.uniform(-1, 1, P), rng.uniform(-1, 1, P), rng.uniform(3, 6, P)], -1)
    ts = np.linspace(0, 0.5, F)[:, None] * np.array([1.0, 0.1, 0.0])
    obs_cam = np.tile(np.arange(O)[None, :], (P, 1)) % F
    uv = np.zeros((P, O, 2))
    for o in range(O):
        Xc = X + ts[obs_cam[:, o]]
        uv[:, o] = np.stack([cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx,
                             cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy], -1)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    return cam, BAProblem(
        cam_rvec=torch.zeros((F, 3), device=dev), cam_t=f32(ts),
        points=f32(X + 0.01 * rng.standard_normal((P, 3))),
        obs_cam=torch.from_numpy(obs_cam).to(dev), obs_uv=f32(uv),
        obs_valid=torch.ones((P, O), dtype=torch.bool, device=dev),
        cam_free=torch.arange(F, device=dev) == F - 1,
        cam_in_problem=torch.ones((F,), dtype=torch.bool, device=dev),
        point_free=torch.ones((P,), dtype=torch.bool, device=dev),
        point_in_problem=torch.ones((P,), dtype=torch.bool, device=dev))


def dryrun_multichip(n: int, device: str = "cpu", workdir: str | None = None,
                     timeout_s: float = 300.0) -> dict:
    """One distributed-BA solve over an {"lm": n} mesh of n spawned ranks
    (gloo on the CPU; NCCL with device="cuda", one card a rank), held
    against full_ba on rank 0. Returns rank 0's report; raises if a rank
    fails or outlives `timeout_s`."""
    import tempfile

    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun over {n} cards, {torch.cuda.device_count()} visible")
    if workdir is None:
        with tempfile.TemporaryDirectory(prefix="slam_dryrun_") as tmp:
            return dryrun_multichip(n, device, tmp, timeout_s)
    store, out = os.path.join(workdir, "store"), os.path.join(workdir, "rank0.json")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_dryrun_rank, args=(r, n, store, device, out)) for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout_s)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * n:
        raise RuntimeError(f"dryrun ranks exited {codes}")
    with open(out) as f:
        return json.load(f)


def main() -> None:
    from ..ops.camera import Camera

    ap = argparse.ArgumentParser()
    ap.add_argument("--sequences", type=int, default=8)
    ap.add_argument("--frames", type=int, default=96, help="lockstep frames tracked a run")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cam = Camera(fx=480.0, fy=480.0, cx=320.0, cy=240.0, width=640, height=480)
    t0 = time.time()
    pool, pending = render_worlds(cam, [(7 + i, args.frames + 4) for i in range(args.sequences)])
    worlds = [w[0] for w in pending.get()]
    pool.close()
    pool.join()
    render_s = time.time() - t0
    res = alternate(cam, worlds, bench_scaling_config(), args.device, args.sequences, args.batch,
                    args.frames)
    dev = torch.device(args.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps(dict(metric="multi_sequence_fps", device=kind, render_s=render_s, **res)))


if __name__ == "__main__":
    main()
