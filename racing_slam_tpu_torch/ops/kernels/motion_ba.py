"""Kernel K3: motion-only bundle adjustment (the whole LM loop).

Replaces racing_slam_tpu/ops/pallas/motion_ba_kernel.py:motion_ba_planes.
Source: racing_slam_tpu_torch/csrc/motion_ba_kernel.cu.

What it computes: one free 6-DoF pose against K fixed points, Huber IRLS,
damped 6x6 normal equations solved by 3x3 blocks, accept lambda/3 or reject
lambda*2, Ceres' function-tolerance exit. Damping is H + lambda (diag H +
1e-9 I) as in the plain solver (ops/ba.py), not the TPU kernel's flat 1e-9.

What bounds it on an H100: latency. A solve is <= 10 iterations of two
passes over K = 2400 rows (~100 KB) and a 27-value reduction; as plain
PyTorch each iteration is ~100 small kernel launches, and the early exit
needs either a host read per iteration or, as the twin does, every
iteration run under a mask. The kernel runs the whole loop in one block:
one launch per solve, a real early exit, no host synchronisation, and the
rows stay in L1/L2 across the iterations.
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
    """Plain-PyTorch twin: returns [8] (rvec, t, cost, iterations).

    The data-dependent exit is a `done` mask that freezes the state, so the
    loop runs max_iters times without reading anything back.
    """
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
    """Fused LM solve; returns [8] f32 (rvec, t, cost, iterations)."""
    kwargs = dict(fx=fx, cx=cx, cy=cy, max_iters=max_iters, huber_delta=huber_delta,
                  ftol=ftol, init_lambda=init_lambda)
    if _build.device_kind(pose0, kp_uv, point_xyz, valid) == "cpu":
        return motion_ba_lm_reference(pose0, kp_uv, point_xyz, valid, **kwargs)
    K = kp_uv.shape[0]
    _build.expect(pose0, "pose0", torch.float32, (6,))
    _build.expect(kp_uv, "kp_uv", torch.float32, (K, 2))
    _build.expect(point_xyz, "point_xyz", torch.float32, (K, 3))
    _build.expect(valid, "valid", torch.bool, (K,))
    out = torch.empty((8,), dtype=torch.float32, device=pose0.device)
    err = _build.lib().slam_motion_ba(
        _build.ptr(pose0), _build.ptr(kp_uv), _build.ptr(point_xyz), _build.ptr(valid),
        _build.ptr(out), K, float(fx), float(cx), float(cy), float(init_lambda),
        float(huber_delta), float(ftol), int(max_iters), _build.stream(pose0.device),
    )
    _build.check(err, "motion_ba_lm")
    global launches
    launches += 1
    return out
