"""Kernel K4: single-free-camera Schur bundle adjustment (the whole LM loop).

Replaces racing_slam_tpu/ops/pallas/structure_ba_kernel.py:structure_ba_planes.
Source: racing_slam_tpu_torch/csrc/structure_ba_kernel.cu.

What it computes: one free camera + free points, every other camera
frozen; per point the 3x3 Hpp, g_p and the 6x3 coupling Y with the free
camera; the free camera's Hcc, g_c; damped per-point inverses (zero for
frozen points); the reduced 6x6 system and its solve; back-substitution;
accept lambda/3 or reject lambda*2.5 with the function-tolerance exit.

What bounds it on an H100: latency. At the commit shape (Pc = 2432
points x O = 8 observations, F = 32 cameras) an iteration is ~20k
observation updates and two sums over all points (the 54 values of the
reduced system, then the trial cost) that every point waits for. The
kernel runs the whole solve as one thread-block cluster of `CLUSTER` CTAs
(16, non-portable) of 160 threads, one point a thread up to 2560 points:
each CTA keeps its share of the points' state and observations in shared
memory (up to 1024 points a CTA at O = 8, P <= 16384; beyond, in a global
scratch buffer), and the sums go through distributed shared memory (each
CTA's partials into its rank's slot in rank 0, one cluster barrier, every
CTA sums the slots in rank order), so every CTA takes the same decisions
and two runs give the same bits. One
launch per solve, no atomics, no host read; two cluster barriers an
iteration. A refused cluster launch raises; there is no other path on the
card. 16 CTAs measured faster than 8 (PERF.md).

Batched: C solves of one shape (the keyframe commits of the rows that
commit on one lockstep frame) take a leading C on every operand,
cam_rvec [C, F, 3], ..., free_slot [C], and return [C, 8] and [C, P, 3],
in one launch of C clusters; each problem equals its solve alone to the
bit, since every launch takes the same cluster, whatever C is. Two
160-thread CTAs fit an SM, so the H100 holds 14 clusters at once: a
lockstep frame's 8 commits run in one wave. `launches` counts every
launch, `batched_launches` the launches with a leading C (one each,
whatever C is).
"""

from __future__ import annotations

import torch

from ..ba import (
    FUNCTION_TOLERANCE,
    huber_cost,
    huber_weight,
    inv3x3,
    residual_and_jacobians,
    solve6_spd,
)
from . import _build

launches = 0
batched_launches = 0  # the launches of `launches` that solved C problems at once
CLUSTER = 16  # CTAs of the cluster, the only size the kernel accepts


def structure_ba_lm_reference(
    cam_rvec: torch.Tensor,  # [F, 3]
    cam_t: torch.Tensor,  # [F, 3]
    points: torch.Tensor,  # [P, 3]
    obs_cam: torch.Tensor,  # [P, O] int64
    obs_uv: torch.Tensor,  # [P, O, 2]
    include: torch.Tensor,  # [P, O] bool: residual counts
    point_free: torch.Tensor,  # [P] bool
    free_slot: torch.Tensor,  # 0-d int64
    *,
    fx: float,
    cx: float,
    cy: float,
    max_iters: int,
    huber_delta: float,
    ftol: float = FUNCTION_TOLERANCE,
    init_lambda: float = 1e-4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch twin: ([8] free pose + cost + iterations, [P, 3] points),
    or ([C, 8], [C, P, 3]) for leading-C operands, problem by problem."""
    if points.dim() == 3:
        outs = [structure_ba_lm_reference(*row, fx=fx, cx=cx, cy=cy, max_iters=max_iters,
                                          huber_delta=huber_delta, ftol=ftol,
                                          init_lambda=init_lambda)
                for row in zip(cam_rvec, cam_t, points, obs_cam, obs_uv, include, point_free,
                               free_slot)]
        return torch.stack([o for o, _ in outs]), torch.stack([x for _, x in outs])
    P, O = obs_cam.shape
    F = cam_rvec.shape[0]
    dev = points.device
    safe_cam = torch.clamp(obs_cam, 0, F - 1).long()
    free_obs_mask = (safe_cam == free_slot).float()
    pf = point_free.float()
    idx = free_slot.reshape(1).long()
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def terms(cr, ct, X):
        rv = cr[safe_cam]
        tt = ct[safe_cam]
        r, Jc, Jp = residual_and_jacobians(rv, tt, X[:, None, :].expand(P, O, 3), obs_uv,
                                           fx, cx, cy)
        return r, torch.sum(r * r, dim=-1), Jc, Jp

    def cost_of(cr, ct, X):
        _, s, _, _ = terms(cr, ct, X)
        return torch.sum(torch.where(include, huber_cost(s, huber_delta), torch.zeros_like(s)))

    cr, ct, X = cam_rvec.float(), cam_t.float(), points.float()
    lam = torch.tensor(init_lambda, dtype=torch.float32, device=dev)
    cost = cost_of(cr, ct, X)
    it = torch.zeros((), dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        r, s, Jc, Jp = terms(cr, ct, X)
        w = torch.where(include, huber_weight(s, huber_delta), torch.zeros_like(s))
        Jc_f = Jc * (free_obs_mask * w)[..., None, None]
        Hcc = torch.einsum("porj,pork->jk", Jc_f, Jc)
        g_c = torch.einsum("porj,por->j", Jc_f, r)
        Jp_w = Jp * w[..., None, None]
        Hpp = torch.einsum("pori,porj->pij", Jp_w, Jp)
        g_p = torch.einsum("pori,por->pi", Jp_w, r)
        Y = torch.einsum("porj,pori->pji", Jc_f, Jp)  # [P, 6, 3]
        dpp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
        Hpp_d = Hpp + lam * dpp[..., :, None] * eye3 + 1e-9 * eye3
        Hpp_inv = inv3x3(Hpp_d) * pf[:, None, None]
        Z = Y @ Hpp_inv
        S = Hcc + lam * torch.diag(torch.diagonal(Hcc)) + 1e-9 * eye6 - torch.einsum(
            "pil,pjl->ij", Z, Y
        )
        g_red = g_c - torch.einsum("pik,pk->i", Z, g_p)
        delta_c = -solve6_spd(S, g_red)
        delta_p = -torch.einsum(
            "pij,pj->pi", Hpp_inv, g_p + torch.einsum("pji,j->pi", Y, delta_c)
        )
        cr_new = cr.index_put((idx,), delta_c[None, :3], accumulate=True)
        ct_new = ct.index_put((idx,), delta_c[None, 3:], accumulate=True)
        X_new = X + delta_p * pf[:, None]
        new_cost = cost_of(cr_new, ct_new, X_new)
        accept = new_cost < cost
        stop = (accept & (cost - new_cost <= ftol * cost)) | (lam > 1e8)
        live = ~done
        take = live & accept
        cr = torch.where(take, cr_new, cr)
        ct = torch.where(take, ct_new, ct)
        X = torch.where(take, X_new, X)
        lam = torch.where(
            live, torch.where(accept, torch.clamp(lam / 3.0, min=1e-9), lam * 2.5), lam
        )
        cost = torch.where(take, new_cost, cost)
        it = it + live.float()
        done = done | stop
    out = torch.cat([cr[idx][0], ct[idx][0], cost[None], it[None]])
    return out, X


def structure_ba_lm(
    cam_rvec: torch.Tensor,
    cam_t: torch.Tensor,
    points: torch.Tensor,
    obs_cam: torch.Tensor,
    obs_uv: torch.Tensor,
    include: torch.Tensor,
    point_free: torch.Tensor,
    free_slot: torch.Tensor,
    *,
    fx: float,
    cx: float,
    cy: float,
    max_iters: int,
    huber_delta: float,
    ftol: float = FUNCTION_TOLERANCE,
    init_lambda: float = 1e-4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Schur LM solve: ([8] pose + cost + iterations, [P, 3] points),
    or ([C, 8], [C, P, 3]) for C problems given leading-C operands (one
    launch)."""
    kwargs = dict(fx=fx, cx=cx, cy=cy, max_iters=max_iters, huber_delta=huber_delta,
                  ftol=ftol, init_lambda=init_lambda)
    tensors = (cam_rvec, cam_t, points, obs_cam, obs_uv, include, point_free, free_slot)
    if _build.device_kind(*tensors) == "cpu":
        return structure_ba_lm_reference(*tensors, **kwargs)
    lead = tuple(free_slot.shape)  # () or (C,)
    if len(lead) > 1:
        raise ValueError(f"free_slot: expected [] or [C], got {lead}")
    C = lead[0] if lead else 1
    F = cam_rvec.shape[-2]
    P, O = obs_cam.shape[-2:]
    if F > 64:
        raise ValueError(f"structure_ba kernel takes at most 64 cameras, got {F}")
    obs_cam = torch.clamp(obs_cam, 0, F - 1)
    _build.expect(cam_rvec, "cam_rvec", torch.float32, (*lead, F, 3))
    _build.expect(cam_t, "cam_t", torch.float32, (*lead, F, 3))
    _build.expect(points, "points", torch.float32, (*lead, P, 3))
    _build.expect(obs_cam, "obs_cam", torch.int64, (*lead, P, O))
    _build.expect(obs_uv, "obs_uv", torch.float32, (*lead, P, O, 2))
    _build.expect(include, "include", torch.bool, (*lead, P, O))
    _build.expect(point_free, "point_free", torch.bool, (*lead, P))
    _build.expect(free_slot, "free_slot", torch.int64, lead)
    dev = points.device
    out = torch.empty((*lead, 8), dtype=torch.float32, device=dev)
    points_out = torch.empty((*lead, P, 3), dtype=torch.float32, device=dev)
    lib = _build.lib()
    n_scratch = C * lib.slam_structure_ba_scratch_bytes(P, O, CLUSTER)
    scratch = torch.empty((n_scratch // 4,), dtype=torch.float32, device=dev) if n_scratch else None
    err = lib.slam_structure_ba(
        _build.ptr(cam_rvec), _build.ptr(cam_t), _build.ptr(free_slot), _build.ptr(points),
        _build.ptr(obs_cam), _build.ptr(obs_uv), _build.ptr(include), _build.ptr(point_free),
        _build.ptr(out), _build.ptr(points_out), _build.ptr(scratch), C, F, P, O, float(fx),
        float(cx), float(cy), float(init_lambda), float(huber_delta), float(ftol),
        int(max_iters), CLUSTER, _build.stream(dev),
    )
    _build.check(err, "structure_ba_lm")
    global launches, batched_launches
    launches += 1
    batched_launches += bool(lead)
    return out, points_out


def max_active_clusters(P: int, O: int) -> int:
    """How many of the solve's CLUSTER-CTA clusters for P points x O
    observations the card holds at once (cudaOccupancyMaxActiveClusters);
    the problems of a batched launch past that wait for a free cluster."""
    n = _build.lib().slam_structure_ba_max_clusters(P, O, CLUSTER)
    if n < 0:
        _build.check(-n, "structure_ba max_active_clusters")
    return n
