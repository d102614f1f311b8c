"""Distributed Schur-complement bundle adjustment over landmark shards
(port of racing_slam_tpu/parallel/dist_ba.py).

The factor graph is split landmark-wise: the points and their observation
rows go to the ranks of the mesh's 'lm' axis, the camera parameters are
held by all (cameras are few, points are many). Each rank eliminates its
own landmarks into a contribution to the reduced camera system (S, g);
one all-reduce over the 'lm' group sums them; every rank solves the same
dense [6F, 6F] system; the point updates back-substitute on each rank
with no further communication. An LM iteration moves one all-reduce of
F*F*36 + F*6 floats and one of the trial cost, whatever the number of
points.

The loop is ops/ba.full_ba's (`allreduce` over the group), so the single
device and the distributed solvers are one implementation: with no mesh
the solve is full_ba itself, and over a group of one it gives full_ba's
bits. As in full_ba, the loop stops at Ceres' function tolerance (a
device-side flag); the JAX package's sharded loop runs every iteration.
Each rank hands back the whole problem's points (an all-gather after the
solve), as the JAX package's sharded result reads.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.ba import HUBER_DELTA, MAX_ITERS, BAProblem, BAResult, full_ba
from ..ops.camera import Camera
from .mesh import axis_group, axis_rank, axis_size

# Point-major fields of a BAProblem: split over the landmark shards.
_POINT_FIELDS = ("points", "obs_cam", "obs_uv", "obs_valid", "point_free", "point_in_problem")


def _group_allreduce(group):
    """Sum a list of tensors over `group` in one all-reduce (same dtype)."""

    def allreduce(xs: list) -> list:
        flat = torch.cat([x.reshape(-1) for x in xs])
        dist.all_reduce(flat, group=group)
        out, at = [], 0
        for x in xs:
            out.append(flat[at:at + x.numel()].reshape(x.shape))
            at += x.numel()
        return out

    return allreduce


def shard_problem(prob: BAProblem, n: int, r: int) -> BAProblem:
    """Shard r of n of the problem's points (a contiguous block); of each
    problem's points for stacked problems."""
    stacked = prob.points.dim() == 3
    P = prob.points.shape[-2]
    if P % n != 0:
        raise ValueError(f"point capacity {P} not divisible by {n} shards")
    lo, hi = r * P // n, (r + 1) * P // n
    return prob._replace(**{f: getattr(prob, f)[:, lo:hi] if stacked else getattr(prob, f)[lo:hi]
                            for f in _POINT_FIELDS})


def distributed_full_ba(
    cam: Camera,
    prob: BAProblem,
    mesh=None,
    axis: str = "lm",
    max_iters: int = MAX_ITERS,
    init_lambda: float = 1e-4,
    huber_delta: float = HUBER_DELTA,
) -> BAResult:
    """Full BA with the points of `prob` (the whole problem, the same on
    every rank of the group) split over `mesh`'s `axis`. The point capacity
    must be divisible by the axis size (pad with obs_valid=False rows:
    padding contributes nothing); ValueError otherwise. Returns the whole
    problem's result on every rank. Stacked problems (a leading B on every
    field) are one solve, their systems and costs in one all-reduce an
    iteration."""
    n = axis_size(mesh, axis)
    group = axis_group(mesh, axis)
    shard = shard_problem(prob, n, axis_rank(mesh, axis))
    if group is None:
        return full_ba(cam, shard, max_iters=max_iters, init_lambda=init_lambda,
                       huber_delta=huber_delta)
    res = full_ba(cam, shard, max_iters=max_iters, init_lambda=init_lambda,
                  huber_delta=huber_delta, allreduce=_group_allreduce(group))
    if n == 1:
        return res
    parts = [torch.empty_like(res.points) for _ in range(n)]
    dist.all_gather(parts, res.points.contiguous(), group=group)
    return res._replace(points=torch.cat(parts, dim=-2))


def batched_distributed_full_ba(
    cam: Camera,
    prob_batch: BAProblem,
    mesh=None,
    lm_axis: str = "lm",
    max_iters: int = MAX_ITERS,
    init_lambda: float = 1e-4,
    huber_delta: float = HUBER_DELTA,
) -> BAResult:
    """Independent BA problems, each with its landmarks split over
    `lm_axis`: the multi-sequence shape. Every leaf of `prob_batch` has a
    leading B, this rank's sequence rows (the 'seq' axis is data parallel:
    the other seq coordinates solve their own rows, with no communication
    between them). The B rows are one full_ba call (ops/ba.py's stacked
    solve) over the lm group: one all-reduce an iteration of the stacked
    [B, F, F, 6, 6] and [B, F, 6] systems and one of the [B] costs, the
    counterpart of the JAX package's psum under vmap. Each row is its
    distributed_full_ba alone, to the bit. Returns a BAResult with the
    leading B."""
    P = prob_batch.points.shape[1]
    n_lm = axis_size(mesh, lm_axis)
    if P % n_lm != 0:
        raise ValueError(f"point capacity {P} not divisible by {n_lm}")
    return distributed_full_ba(cam, prob_batch, mesh, lm_axis, max_iters, init_lambda,
                               huber_delta)
