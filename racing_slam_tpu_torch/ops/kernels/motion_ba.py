"""Kernel K3: motion-only bundle adjustment (the whole LM loop).

Replaces racing_slam_tpu/ops/pallas/motion_ba_kernel.py:motion_ba_planes.
Source: racing_slam_tpu_torch/csrc/motion_ba_kernel.cu.

What it computes: one free 6-DoF pose against K fixed points, Huber IRLS,
damped 6x6 normal equations solved by 3x3 blocks, accept lambda/3 or reject
lambda*2, Ceres' function-tolerance exit. Damping is H + lambda (diag H +
1e-9 I) as in the plain solver (ops/ba.py), not the TPU kernel's flat 1e-9.

What bounds it on an H100: latency. A solve is <= 10 iterations over K =
2400 rows (~100 KB) and a 28-value reduction; as plain PyTorch each
iteration is ~100 small kernel launches, and the early exit needs either a
host read per iteration or, as the twin does, every iteration run under a
mask. The kernel runs the whole loop in one thread-block cluster of 8 CTAs
on 8 SMs: one launch per solve, a real early exit, no host
synchronisation. Each CTA compacts the valid rows of its eighth of the K
rows into its shared memory once; an iteration is one fused pass at the
trial pose (cost, weights, H and g together), the partial sums stored
into every CTA's shared memory by stores that count themselves on a
barrier there (st.async), and the same totals, decision and 6x6 solve in
every thread. K is limited by a CTA's shared
memory to about 89000 rows (a larger K raises).

Batched: S solves (the lockstep step of S sequences) take leading-S
operands, pose0 [S, 6], kp_uv [S, K, 2], point_xyz [S, K, 3], valid [S, K],
and return [S, 8], in one launch of S clusters; each row equals the solve of
that row alone to the bit, since every launch takes the same cluster and
sums in the same order. One launch is one count, whatever S is.
"""

from __future__ import annotations

import torch

from ..ba import (
    FUNCTION_TOLERANCE,
    huber_cost,
    huber_weight,
    residual_and_jacobians,
    solve6_spd,
)
from . import _build

launches = 0


def motion_ba_lm_reference(
    pose0: torch.Tensor,  # [6] f32: rvec, t
    kp_uv: torch.Tensor,  # [K, 2]
    point_xyz: torch.Tensor,  # [K, 3]
    valid: torch.Tensor,  # [K] bool
    *,
    fx: float,
    cx: float,
    cy: float,
    max_iters: int,
    huber_delta: float,
    ftol: float = FUNCTION_TOLERANCE,
    init_lambda: float = 1e-4,
) -> torch.Tensor:
    """Plain-PyTorch twin: returns [8] (rvec, t, cost, iterations), or [S, 8]
    for leading-S operands, row by row.

    The data-dependent exit is a `done` mask that freezes the state, so the
    loop runs max_iters times without reading anything back.
    """
    if pose0.dim() == 2:
        return torch.stack([
            motion_ba_lm_reference(*row, fx=fx, cx=cx, cy=cy, max_iters=max_iters,
                                   huber_delta=huber_delta, ftol=ftol, init_lambda=init_lambda)
            for row in zip(pose0, kp_uv, point_xyz, valid)])
    K = kp_uv.shape[0]
    dev = pose0.device

    def terms(pose):
        rv = pose[:3].expand(K, 3)
        tt = pose[3:6].expand(K, 3)
        return residual_and_jacobians(rv, tt, point_xyz, kp_uv, fx, cx, cy)

    def robust_cost(pose):
        r, _, _ = terms(pose)
        s = torch.sum(r * r, dim=-1)
        return torch.sum(torch.where(valid, huber_cost(s, huber_delta), torch.zeros_like(s)))

    pose = pose0.to(torch.float32)
    lam = torch.tensor(init_lambda, dtype=torch.float32, device=dev)
    cost = robust_cost(pose)
    it = torch.zeros((), dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    eye = torch.eye(6, dtype=torch.float32, device=dev)
    for _ in range(max_iters):
        r, J, _ = terms(pose)
        s = torch.sum(r * r, dim=-1)
        w = torch.where(valid, huber_weight(s, huber_delta), torch.zeros_like(s))
        Jw = J * w[:, None, None]
        H = torch.einsum("kri,krj->ij", Jw, J)
        g = torch.einsum("kri,kr->i", Jw, r)
        D = torch.diag(torch.diagonal(H)) + 1e-9 * eye
        new_pose = pose - solve6_spd(H + lam * D, g)
        new_cost = robust_cost(new_pose)
        accept = new_cost < cost
        stop = (accept & (cost - new_cost <= ftol * cost)) | (lam > 1e8)
        live = ~done
        take = live & accept
        pose = torch.where(take, new_pose, pose)
        lam = torch.where(
            live, torch.where(accept, torch.clamp(lam / 3.0, min=1e-9), lam * 2.0), lam
        )
        cost = torch.where(take, new_cost, cost)
        it = it + live.float()
        done = done | stop
    return torch.cat([pose, cost[None], it[None]])


def motion_ba_lm(
    pose0: torch.Tensor,
    kp_uv: torch.Tensor,
    point_xyz: torch.Tensor,
    valid: torch.Tensor,
    *,
    fx: float,
    cx: float,
    cy: float,
    max_iters: int,
    huber_delta: float,
    ftol: float = FUNCTION_TOLERANCE,
    init_lambda: float = 1e-4,
) -> torch.Tensor:
    """Fused LM solve; returns [8] f32 (rvec, t, cost, iterations), or [S, 8]
    for S solves given leading-S operands (one launch)."""
    kwargs = dict(fx=fx, cx=cx, cy=cy, max_iters=max_iters, huber_delta=huber_delta,
                  ftol=ftol, init_lambda=init_lambda)
    if _build.device_kind(pose0, kp_uv, point_xyz, valid) == "cpu":
        return motion_ba_lm_reference(pose0, kp_uv, point_xyz, valid, **kwargs)
    lead = tuple(pose0.shape[:-1])  # () or (S,)
    if len(lead) > 1:
        raise ValueError(f"pose0: expected [6] or [S, 6], got {tuple(pose0.shape)}")
    S = lead[0] if lead else 1
    K = kp_uv.shape[-2]
    _build.expect(pose0, "pose0", torch.float32, (*lead, 6))
    _build.expect(kp_uv, "kp_uv", torch.float32, (*lead, K, 2))
    _build.expect(point_xyz, "point_xyz", torch.float32, (*lead, K, 3))
    _build.expect(valid, "valid", torch.bool, (*lead, K))
    out = torch.empty((*lead, 8), dtype=torch.float32, device=pose0.device)
    err = _build.lib().slam_motion_ba(
        _build.ptr(pose0), _build.ptr(kp_uv), _build.ptr(point_xyz), _build.ptr(valid),
        _build.ptr(out), S, K, float(fx), float(cx), float(cy), float(init_lambda),
        float(huber_delta), float(ftol), int(max_iters), _build.stream(pose0.device),
    )
    _build.check(err, "motion_ba_lm")
    global launches
    launches += 1
    return out


def max_active_clusters(K: int) -> int:
    """How many of the solve's clusters for K rows the card holds at once
    (cudaOccupancyMaxActiveClusters); the solves of a batched launch past
    that wait for a free cluster."""
    n = _build.lib().slam_motion_ba_max_clusters(K)
    if n < 0:
        _build.check(-n, "motion_ba max_active_clusters")
    return n
