"""Levenberg-Marquardt bundle adjustment (port of racing_slam_tpu/ops/ba.py).

Residual identical to the reference: normalized-plane error with fx only,
Huber loss via IRLS weights, Ceres' function tolerance as the early exit.
Two solvers are on the slice's path, each with its whole LM loop in one
CUDA kernel:

- ``motion_ba``: one free pose against fixed points (kernel K3,
  ops/kernels/motion_ba.py), twice per tracked frame;
- ``structure_ba``: one free camera + free points by Schur complement
  (kernel K4, ops/kernels/structure_ba.py), at the bootstrap and at every
  keyframe commit.

Each kernel's wrapper runs the kernel for CUDA tensors and its plain twin
for CPU tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .camera import Camera

HUBER_DELTA = math.sqrt(5.991)
MAX_ITERS = 10
FUNCTION_TOLERANCE = 1e-6


def huber_weight(sq_norm: torch.Tensor, delta: float = HUBER_DELTA) -> torch.Tensor:
    """IRLS weight rho'(s) for Ceres HuberLoss: 1 inside, delta/|r| outside."""
    norm = torch.sqrt(sq_norm + 1e-18)
    return torch.where(sq_norm <= delta * delta, torch.ones_like(norm), delta / norm)


def huber_cost(sq_norm: torch.Tensor, delta: float = HUBER_DELTA) -> torch.Tensor:
    """Ceres HuberLoss rho(s): s inside, 2 delta sqrt(s) - delta^2 outside."""
    b = delta * delta
    return torch.where(sq_norm <= b, sq_norm, 2.0 * delta * torch.sqrt(sq_norm + 1e-18) - b)


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form (adjugate) 3x3 inverse; [..., 3, 3]."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def solve6_spd(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve the damped SPD 6x6 system H x = g by two 3x3 block inverses."""
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    C = H[..., 3:, 3:]
    g1 = g[..., :3]
    g2 = g[..., 3:]
    Ainv = inv3x3(A)
    AinvB = Ainv @ B
    S = C - B.transpose(-1, -2) @ AinvB
    Sinv = inv3x3(S)
    rhs2 = g2 - torch.einsum("...ij,...i->...j", AinvB, g1)
    x2 = torch.einsum("...ij,...j->...i", Sinv, rhs2)
    x1 = torch.einsum("...ij,...j->...i", Ainv, g1) - torch.einsum(
        "...ij,...j->...i", AinvB, x2
    )
    return torch.cat([x1, x2], dim=-1)


def right_jacobian_so3(v: torch.Tensor) -> torch.Tensor:
    """Right Jacobian J_r of SO(3) at v [..., 3] -> [..., 3, 3], Taylor-safe."""
    from .se3 import hat

    theta2 = torch.sum(v * v, dim=-1)
    theta = torch.sqrt(theta2 + 1e-24)
    small = theta2 < 1e-8
    A = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + 1e-24))
    B = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta + 1e-24)
    )
    V = hat(v)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return eye - A[..., None, None] * V + B[..., None, None] * (V @ V)


def rodrigues_coeffs(rv: torch.Tensor):
    """(a, b, B) with R = I + a W + b W^2 and J_r = I - b W + B W^2."""
    wx, wy, wz = rv[..., 0], rv[..., 1], rv[..., 2]
    theta2 = wx * wx + wy * wy + wz * wz
    theta = torch.sqrt(theta2 + 1e-24)
    small = theta2 < 1e-8
    one = torch.ones_like(theta)
    safe1 = torch.where(small, one, theta)
    safe2 = torch.where(small, one, theta2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / safe1)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe2)
    B = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (safe2 * safe1))
    return a, b, B


def residual_and_jacobians(rv, tt, X, uv, fx, cx, cy):
    """Analytic residual + Jacobians, batched over leading dims.

    rv, tt, X: [..., 3]; uv: [..., 2]. Returns r [..., 2], J_c [..., 2, 6]
    (d r / d[rvec, t]) and J_p [..., 2, 3], expanded to scalar arithmetic
    exactly as the JAX package does.
    """
    wx, wy, wz = rv[..., 0], rv[..., 1], rv[..., 2]
    Xx, Xy, Xz = X[..., 0], X[..., 1], X[..., 2]
    a, b, B = rodrigues_coeffs(rv)
    A = b

    R00 = 1.0 - b * (wy * wy + wz * wz)
    R01 = b * wx * wy - a * wz
    R02 = b * wx * wz + a * wy
    R10 = b * wx * wy + a * wz
    R11 = 1.0 - b * (wx * wx + wz * wz)
    R12 = b * wy * wz - a * wx
    R20 = b * wx * wz - a * wy
    R21 = b * wy * wz + a * wx
    R22 = 1.0 - b * (wx * wx + wy * wy)

    px = R00 * Xx + R01 * Xy + R02 * Xz + tt[..., 0]
    py = R10 * Xx + R11 * Xy + R12 * Xz + tt[..., 1]
    pz = R20 * Xx + R21 * Xy + R22 * Xz + tt[..., 2]
    z_safe = torch.where(torch.abs(pz) < 1e-9, torch.full_like(pz, 1e-9), pz)
    inv_z = 1.0 / z_safe
    gx = px * inv_z
    gy = py * inv_z
    nx = (uv[..., 0] - cx) / fx
    ny = (uv[..., 1] - cy) / fx
    r = torch.stack([gx - nx, gy - ny], dim=-1)

    M00 = R01 * Xz - R02 * Xy
    M01 = R02 * Xx - R00 * Xz
    M02 = R00 * Xy - R01 * Xx
    M10 = R11 * Xz - R12 * Xy
    M11 = R12 * Xx - R10 * Xz
    M12 = R10 * Xy - R11 * Xx
    M20 = R21 * Xz - R22 * Xy
    M21 = R22 * Xx - R20 * Xz
    M22 = R20 * Xy - R21 * Xx

    Jr00 = 1.0 - B * (wy * wy + wz * wz)
    Jr01 = A * wz + B * wx * wy
    Jr02 = -A * wy + B * wx * wz
    Jr10 = -A * wz + B * wx * wy
    Jr11 = 1.0 - B * (wx * wx + wz * wz)
    Jr12 = A * wx + B * wy * wz
    Jr20 = A * wy + B * wx * wz
    Jr21 = -A * wx + B * wy * wz
    Jr22 = 1.0 - B * (wx * wx + wy * wy)

    D00 = -(M00 * Jr00 + M01 * Jr10 + M02 * Jr20)
    D01 = -(M00 * Jr01 + M01 * Jr11 + M02 * Jr21)
    D02 = -(M00 * Jr02 + M01 * Jr12 + M02 * Jr22)
    D10 = -(M10 * Jr00 + M11 * Jr10 + M12 * Jr20)
    D11 = -(M10 * Jr01 + M11 * Jr11 + M12 * Jr21)
    D12 = -(M10 * Jr02 + M11 * Jr12 + M12 * Jr22)
    D20 = -(M20 * Jr00 + M21 * Jr10 + M22 * Jr20)
    D21 = -(M20 * Jr01 + M21 * Jr11 + M22 * Jr21)
    D22 = -(M20 * Jr02 + M21 * Jr12 + M22 * Jr22)

    zero = torch.zeros_like(inv_z)
    J_c = torch.stack(
        [
            torch.stack(
                [
                    inv_z * (D00 - gx * D20),
                    inv_z * (D01 - gx * D21),
                    inv_z * (D02 - gx * D22),
                    inv_z,
                    zero,
                    -gx * inv_z,
                ],
                dim=-1,
            ),
            torch.stack(
                [
                    inv_z * (D10 - gy * D20),
                    inv_z * (D11 - gy * D21),
                    inv_z * (D12 - gy * D22),
                    zero,
                    inv_z,
                    -gy * inv_z,
                ],
                dim=-1,
            ),
        ],
        dim=-2,
    )
    J_p = torch.stack(
        [
            torch.stack(
                [inv_z * (R00 - gx * R20), inv_z * (R01 - gx * R21), inv_z * (R02 - gx * R22)],
                dim=-1,
            ),
            torch.stack(
                [inv_z * (R10 - gy * R20), inv_z * (R11 - gy * R21), inv_z * (R12 - gy * R22)],
                dim=-1,
            ),
        ],
        dim=-2,
    )
    return r, J_c, J_p


# ---------------------------------------------------------------------------
# Motion-only BA: one free pose, all points constant
# ---------------------------------------------------------------------------


class MotionBAResult(NamedTuple):
    rvec: torch.Tensor  # [3]
    t: torch.Tensor  # [3]
    cost: torch.Tensor  # final robust cost
    num_residuals: torch.Tensor


def motion_ba(
    cam: Camera,
    rvec: torch.Tensor,
    t: torch.Tensor,
    kp_uv: torch.Tensor,
    point_xyz: torch.Tensor,
    valid: torch.Tensor,
    max_iters: int = MAX_ITERS,
    huber_delta: float = HUBER_DELTA,
) -> MotionBAResult:
    """Optimise a single pose against fixed 3D points (kernel K3)."""
    from .kernels.motion_ba import motion_ba_lm

    pose0 = torch.cat([rvec, t]).to(torch.float32)
    out = motion_ba_lm(
        pose0, kp_uv.contiguous(), point_xyz.contiguous(), valid.contiguous(),
        fx=cam.fx, cx=cam.cx, cy=cam.cy, max_iters=max_iters, huber_delta=huber_delta,
    )
    return MotionBAResult(rvec=out[:3], t=out[3:6], cost=out[6], num_residuals=valid.sum())


# ---------------------------------------------------------------------------
# Structure BA: one free camera + free points (Schur complement)
# ---------------------------------------------------------------------------


class BAProblem(NamedTuple):
    """Static-shape bundle adjustment problem (F cameras, P points, O obs)."""

    cam_rvec: torch.Tensor  # [F, 3]
    cam_t: torch.Tensor  # [F, 3]
    points: torch.Tensor  # [P, 3]
    obs_cam: torch.Tensor  # [P, O] int camera index per observation
    obs_uv: torch.Tensor  # [P, O, 2]
    obs_valid: torch.Tensor  # [P, O] bool
    cam_free: torch.Tensor  # [F] bool
    cam_in_problem: torch.Tensor  # [F] bool
    point_free: torch.Tensor  # [P] bool
    point_in_problem: torch.Tensor  # [P] bool


class BAResult(NamedTuple):
    cam_rvec: torch.Tensor
    cam_t: torch.Tensor
    points: torch.Tensor
    cost: torch.Tensor
    num_residuals: torch.Tensor


def obs_include(prob: BAProblem) -> tuple[torch.Tensor, torch.Tensor]:
    """(include [P, O], safe_cam [P, O]): observations whose residuals count."""
    safe_cam = torch.clamp(prob.obs_cam, 0, prob.cam_rvec.shape[0] - 1).long()
    include = prob.obs_valid & prob.cam_in_problem[safe_cam] & prob.point_in_problem[:, None]
    return include, safe_cam


def _obs_terms(cam: Camera, prob: BAProblem, huber_delta: float = HUBER_DELTA):
    """Per-observation residuals, weights, Jacobians. Shapes [P, O, ...]."""
    P, O = prob.obs_cam.shape
    include, safe_cam = obs_include(prob)
    rv = prob.cam_rvec[safe_cam]
    tt = prob.cam_t[safe_cam]
    X = prob.points[:, None, :].expand(P, O, 3)
    r, Jc, Jp = residual_and_jacobians(rv, tt, X, prob.obs_uv, cam.fx, cam.cx, cam.cy)
    s = torch.sum(r * r, dim=-1)
    w = torch.where(include, huber_weight(s, huber_delta), torch.zeros_like(s))
    return r, s, w, Jc, Jp, include, safe_cam


def _problem_cost(cam: Camera, prob: BAProblem, huber_delta: float = HUBER_DELTA) -> torch.Tensor:
    _, s, _, _, _, include, _ = _obs_terms(cam, prob, huber_delta)
    return torch.sum(torch.where(include, huber_cost(s, huber_delta), torch.zeros_like(s)))


def structure_ba(
    cam: Camera,
    prob: BAProblem,
    free_slot: torch.Tensor,
    max_iters: int = MAX_ITERS,
    init_lambda: float = 1e-4,
    huber_delta: float = HUBER_DELTA,
) -> BAResult:
    """Schur LM with ONE free camera (`free_slot`, a 0-d index tensor) and
    free points (kernel K4). `prob.cam_free` is ignored."""
    from .kernels.structure_ba import structure_ba_lm

    include, _ = obs_include(prob)
    free_slot = torch.as_tensor(free_slot, device=prob.points.device).long().reshape(())
    out, points = structure_ba_lm(
        prob.cam_rvec.float().contiguous(), prob.cam_t.float().contiguous(),
        prob.points.float().contiguous(), prob.obs_cam.long().contiguous(),
        prob.obs_uv.float().contiguous(), include.contiguous(),
        prob.point_free.contiguous(), free_slot,
        fx=cam.fx, cx=cam.cx, cy=cam.cy, max_iters=max_iters,
        huber_delta=huber_delta, init_lambda=init_lambda,
    )
    idx = free_slot.reshape(1)
    return BAResult(
        cam_rvec=prob.cam_rvec.index_put((idx,), out[None, :3]),
        cam_t=prob.cam_t.index_put((idx,), out[None, 3:6]),
        points=points,
        cost=out[6],
        num_residuals=include.sum(),
    )
