"""Worker processes of the port's multi-process tests (test_torch_dist_ba.py,
test_torch_multiprocess.py), started with torch.multiprocessing's spawn
context: each joins a gloo process group through a FileStore (no port),
does its part and writes its results under `outdir`. Imports the port
only, never JAX."""

import os

import numpy as np
import torch


def _join(rank: int, world: int, store: str):
    from racing_slam_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(2)
    n = initialize_distributed(num_processes=world, process_id=rank, store_path=store,
                               device="cpu", timeout_s=120.0)
    assert n == world, n


def stacked_points(points: torch.Tensor) -> torch.Tensor:
    """The points of ba_worker's second stacked problem: moved by 2 cm
    along a fixed pattern."""
    return points + 0.02 * torch.tensor([1.0, -1.0, 0.5])


def ba_worker(rank: int, world: int, store: str, outdir: str) -> None:
    """distributed_full_ba over an {"lm": world} mesh on the problem the
    parent wrote (problem.npz), and batched_distributed_full_ba over it
    stacked with a copy whose points are moved (stacked_points); the
    results to ba<rank>.npz (the stacked one's fields prefixed "b_"). An
    odd point capacity must raise before any collective."""
    import torch.distributed as dist

    from racing_slam_tpu_torch.ops.ba import BAProblem
    from racing_slam_tpu_torch.ops.camera import Camera
    from racing_slam_tpu_torch.parallel.dist_ba import (
        batched_distributed_full_ba,
        distributed_full_ba,
    )
    from racing_slam_tpu_torch.parallel.mesh import make_mesh

    _join(rank, world, store)
    mesh = make_mesh({"lm": world}, device="cpu")
    with np.load(os.path.join(outdir, "problem.npz")) as d:
        cam = Camera(*[float(x) for x in d["cam"][:4]], int(d["cam"][4]), int(d["cam"][5]))
        prob = BAProblem(*[torch.from_numpy(d[f]) for f in BAProblem._fields])
    res = distributed_full_ba(cam, prob, mesh)
    moved = prob._replace(points=stacked_points(prob.points))
    batched = batched_distributed_full_ba(
        cam, BAProblem(*[torch.stack(x) for x in zip(prob, moved)]), mesh)
    odd = prob._replace(**{f: getattr(prob, f)[1:] for f in (
        "points", "obs_cam", "obs_uv", "obs_valid", "point_free", "point_in_problem")})
    try:
        distributed_full_ba(cam, odd, mesh)
        raised = False
    except ValueError:
        raised = True
    np.savez(os.path.join(outdir, f"ba{rank}.npz"), raised=raised,
             **{f: getattr(res, f).numpy() for f in res._fields},
             **{"b_" + f: getattr(batched, f).numpy() for f in batched._fields})
    dist.destroy_process_group()


def multi_worker(rank: int, world: int, store: str, outdir: str) -> None:
    """MultiSlam over a {"seq": world, "lm": 1} mesh with this rank's one
    sequence of the tiny world (tests/test_torch_multi_seq.py); writes its
    row's state as npz (state<rank>.npz) and every rank's rows into one
    torch.distributed.checkpoint directory (ckpt/)."""
    import torch.distributed as dist

    from racing_slam_tpu_torch.parallel.mesh import make_mesh
    from racing_slam_tpu_torch.parallel.multi_seq import MultiSlam
    from racing_slam_tpu_torch.utils.checkpoint import save_state, save_state_sharded
    from racing_slam_tpu_torch.utils.video import ArraySource
    from torch_multi_world import tiny_cfg, tiny_world

    _join(rank, world, store)
    mesh = make_mesh({"seq": world, "lm": 1}, device="cpu")
    cam, seqs = tiny_world()
    ms = MultiSlam(cam, [ArraySource(seqs[rank].frames)], mesh, tiny_cfg(), device="cpu")
    assert ms.local_rows == [rank], ms.local_rows
    assert ms.initialize()
    assert ms.run_batched(max_frames=6, batch=3) == 6
    save_state(os.path.join(outdir, f"state{rank}.npz"), ms.states_per_sequence()[0])
    save_state_sharded(os.path.join(outdir, "ckpt"), ms.states, ms.local_rows)
    dist.destroy_process_group()


def run_ranks(target, world: int, outdir: str, timeout_s: float = 240.0) -> list:
    """Start `target(rank, world, store, outdir)` in `world` spawned
    processes, join each with its own timeout, kill what is still alive;
    the exit codes (None never stays: a killed rank reports its signal)."""
    ctx = torch.multiprocessing.get_context("spawn")
    store = os.path.join(outdir, "store")
    procs = [ctx.Process(target=target, args=(r, world, store, outdir)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout_s)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    return [p.exitcode for p in procs]
