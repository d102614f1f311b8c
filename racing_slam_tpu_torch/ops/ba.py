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

The Schur solvers of the scale and headline paths, ``window_ba`` (the
commit's local BA with W newest keyframes free) and ``full_ba`` (periodic
refinement), have no Pallas kernel in the JAX package and are plain
PyTorch here: one point elimination (``build_reduced_system`` over all
cameras, the window's W slots for ``window_ba``), ``solve_camera_system``
and ``back_substitute_points``. Their LM loops run a fixed number of
iterations with a device-side stop flag instead of reading the JAX
while_loop's exit condition back to the host. Both take C problems of one
shape stacked on a leading axis (MultiSlam's commits of the rows that
commit on one lockstep frame, its refinement of every row), as the JAX
package vmaps them: the elementwise work runs once over the stack, the
library calls a problem at a time (se3.per_problem), and each problem
stops on its own iteration, so that it gets the bits of its solve alone;
an unstacked call runs the operations it always did.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .camera import Camera
from .se3 import exp_so3, per_problem

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
    """Optimise a single pose against fixed 3D points (kernel K3); with a
    leading S on every operand (rvec [S, 3], kp_uv [S, K, 2], ...), S poses
    in one launch."""
    from .kernels.motion_ba import motion_ba_lm

    pose0 = torch.cat([rvec, t], dim=-1).to(torch.float32).contiguous()
    out = motion_ba_lm(
        pose0, kp_uv.contiguous(), point_xyz.contiguous(), valid.contiguous(),
        fx=cam.fx, cx=cam.cx, cy=cam.cy, max_iters=max_iters, huber_delta=huber_delta,
    )
    return MotionBAResult(rvec=out[..., :3], t=out[..., 3:6], cost=out[..., 6],
                          num_residuals=valid.sum(-1))


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


def _take(x: torch.Tensor, idx: torch.Tensor, stacked: bool) -> torch.Tensor:
    """x[idx] over x's first dim; with `stacked`, within each problem
    (x [C, N, ...], idx [C, ...])."""
    if not stacked:
        return x[idx]
    C = x.shape[0]
    return x[torch.arange(C, device=x.device).reshape(C, *[1] * (idx.dim() - 1)), idx]


def _bcast(m: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-problem value m ([C], or 0-d for one problem) shaped to
    broadcast over the trailing dims of `like`."""
    return m.reshape(*m.shape, *[1] * (like.dim() - m.dim())) if m.dim() else m


def obs_include(prob: BAProblem) -> tuple[torch.Tensor, torch.Tensor]:
    """(include [P, O], safe_cam [P, O]): observations whose residuals
    count ([C, P, O] each for C stacked problems)."""
    safe_cam = torch.clamp(prob.obs_cam, 0, prob.cam_rvec.shape[-2] - 1).long()
    if prob.points.dim() == 3:
        in_cam = torch.gather(prob.cam_in_problem, 1, safe_cam.flatten(1)).reshape(safe_cam.shape)
        return prob.obs_valid & in_cam & prob.point_in_problem[..., None], safe_cam
    include = prob.obs_valid & prob.cam_in_problem[safe_cam] & prob.point_in_problem[:, None]
    return include, safe_cam


def _camera_points(cam: Camera, prob: BAProblem):
    """(R [P, O, 3, 3], points in each observing camera [P, O, 3], the
    normalised observations [P, O, 2]) with one rotation matrix per camera."""
    stacked = prob.points.dim() == 3
    _, safe_cam = obs_include(prob)
    R = _take(exp_so3(prob.cam_rvec), safe_cam, stacked)
    Xc = per_problem(stacked, lambda r, x: torch.einsum("poij,pj->poi", r, x), R, prob.points) \
        + _take(prob.cam_t, safe_cam, stacked)
    n = torch.stack([(prob.obs_uv[..., 0] - cam.cx) / cam.fx,
                     (prob.obs_uv[..., 1] - cam.cy) / cam.fx], dim=-1)
    return R, Xc, n


def _problem_cost(cam: Camera, prob: BAProblem, huber_delta: float = HUBER_DELTA) -> torch.Tensor:
    """The robust cost of the included observations, from the residuals
    alone: a dozen tensor operations (the LM loops evaluate a trial cost
    every iteration)."""
    include, _ = obs_include(prob)
    _, Xc, n = _camera_points(cam, prob)
    z = Xc[..., 2:]
    r = Xc[..., :2] / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z) - n
    s = torch.sum(r * r, dim=-1)
    return per_problem(prob.points.dim() == 3, torch.sum,
                       torch.where(include, huber_cost(s, huber_delta), torch.zeros_like(s)))


def _obs_terms(cam: Camera, prob: BAProblem, huber_delta: float = HUBER_DELTA):
    """Per-observation residuals, weights and Jacobians, shapes [P, O, ...],
    in 3x3 matrix form: per camera R and J_r, per observation J_p = A R and
    J_c = [A (-R [X]x J_r), A] with A = d r / d p_cam. About 40 tensor
    operations, where the JAX package's scalar expansion (kept in
    residual_and_jacobians for the K3/K4 twins) would be some 150 launches
    on the card; the values agree to float32 rounding."""
    from .se3 import hat

    stacked = prob.points.dim() == 3
    include, safe_cam = obs_include(prob)
    R, Xc, n = _camera_points(cam, prob)
    z = Xc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    g = Xc[..., :2] * inv_z[..., None]
    r = g - n
    eye2 = torch.eye(2, dtype=g.dtype, device=g.device).expand(*g.shape[:-1], 2, 2)
    A = inv_z[..., None, None] * torch.cat([eye2, -g[..., None]], dim=-1)  # [P, O, 2, 3]
    Jr = _take(right_jacobian_so3(prob.cam_rvec), safe_cam, stacked)

    def products(R, hX, Jr, A):
        dpdv = -(R @ hX) @ Jr
        return A @ dpdv, A @ R

    A_dpdv, Jp = per_problem(stacked, products, R, hat(prob.points)[..., None, :, :], Jr, A)
    Jc = torch.cat([A_dpdv, A], dim=-1)
    s = torch.sum(r * r, dim=-1)
    w = torch.where(include, huber_weight(s, huber_delta), torch.zeros_like(s))
    return r, s, w, Jc, Jp, include, safe_cam


def _damped(H: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Ceres-style scaled-diagonal damping H + lam diag(H) + 1e-9 I (lam
    [C] for C stacked problems)."""
    n = H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    return H + _bcast(lam, H) * d[..., :, None] * eye + 1e-9 * eye


def _add_block_diag(S: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """S[a, a] += blocks[a] for S [..., n, n, k, k], blocks [..., n, k, k]."""
    n = S.shape[-4]
    on_diag = torch.eye(n, dtype=torch.bool, device=S.device)[:, :, None, None]
    return torch.where(on_diag, S + blocks[..., :, None, :, :], S)


def _add_drop(x: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
              stacked: bool = False) -> torch.Tensor:
    """x.at[idx].add(vals, mode="drop"): rows with idx outside [0, N) go to a
    sentinel row N that is sliced off. With `stacked`, within each problem
    of x [C, N, ...] by idx [C, n]: the problems laid end to end, so that no
    two share a target."""
    if stacked:
        C, N = x.shape[:2]
        ok = (idx >= 0) & (idx < N)
        at = torch.where(ok, idx + N * torch.arange(C, device=idx.device)[:, None],
                         torch.full_like(idx, C * N))
        return _add_drop(x.reshape(C * N, *x.shape[2:]), at.reshape(-1),
                         vals.reshape(-1, *vals.shape[2:])).reshape(x.shape)
    N = x.shape[0]
    tgt = torch.where((idx >= 0) & (idx < N), idx, torch.full_like(idx, N)).long()
    ext = torch.cat([x, torch.zeros_like(x[:1])], dim=0)
    return ext.index_add(0, tgt, vals.to(x.dtype))[:N]


class ReducedSystem(NamedTuple):
    """Output of landmark elimination (summable over landmark shards); each
    field with a leading problem axis for stacked problems."""

    S: torch.Tensor  # [C, C, 6, 6] reduced camera Hessian (C cameras or window slots)
    g_red: torch.Tensor  # [C, 6] reduced gradient
    Hpp_inv: torch.Tensor  # [P, 3, 3] damped inverse (zero for frozen points)
    g_p: torch.Tensor  # [P, 3]
    W: torch.Tensor  # [P, O, 6, 3] camera-point coupling blocks


def _eliminate_points(
    cam: Camera, prob: BAProblem, lam: torch.Tensor, onehot: torch.Tensor, huber_delta: float,
) -> tuple[ReducedSystem, torch.Tensor]:
    """Landmark elimination against the C camera blocks that `onehot`
    [P, O, C] assigns each observation to (none: an anchor through the
    point blocks only); the reduced system and the robust cost.

    The camera blocks are staged as per-observation outer products times the
    one-hot (two matrix products, every intermediate [P*O, 36]), as the JAX
    package does; damping is H + lam diag(H) + 1e-9 I. For stacked problems
    the products and sums run a problem at a time (se3.per_problem), the
    rest over the stack."""
    stacked = prob.points.dim() == 3
    P, O, C = onehot.shape[-3:]
    r, s, w, Jc, Jp, include, _ = _obs_terms(cam, prob, huber_delta)
    Jc_w = Jc * w[..., None, None]  # [P, O, 2, 6]
    Jp_w = Jp * w[..., None, None]
    terms = torch.where(include, huber_cost(s, huber_delta), torch.zeros_like(s))

    def blocks(terms, Jc_w, Jc, Jp_w, Jp, r, onehot):
        N = P * O
        oh_n = onehot.reshape(N, C)
        G = torch.einsum("nri,nrj->nij", Jc_w.reshape(N, 2, 6), Jc.reshape(N, 2, 6))
        Hcc = (oh_n.T @ G.reshape(N, 36)).reshape(C, 6, 6)
        g_cn = torch.einsum("nri,nr->ni", Jc_w.reshape(N, 2, 6), r.reshape(N, 2))
        g_c = oh_n.T @ g_cn  # [C, 6]
        Hpp = torch.einsum("pori,porj->pij", Jp_w, Jp)
        g_p = torch.einsum("pori,por->pi", Jp_w, r)
        W = torch.einsum("pori,porj->poij", Jc_w, Jp)  # [P, O, 6, 3]
        Y = torch.einsum("poc,poik->pcik", onehot, W)  # [P, C, 6, 3]
        return torch.sum(terms), Hcc, g_c, Hpp, g_p, W, Y

    cost, Hcc, g_c, Hpp, g_p, W, Y = per_problem(stacked, blocks, terms, Jc_w, Jc, Jp_w, Jp, r,
                                                 onehot)
    Hpp_inv = inv3x3(_damped(Hpp, lam)) * prob.point_free[..., None, None]

    def reduce(Y, Hpp_inv, g_p):
        Z = torch.einsum("pcik,pkl->pcil", Y, Hpp_inv)
        return torch.einsum("pail,pbjl->abij", Z, Y), torch.einsum("pcik,pk->ci", Z, g_p)

    ZY, Zg = per_problem(stacked, reduce, Y, Hpp_inv, g_p)
    S = _add_block_diag(-ZY, _damped(Hcc, lam))
    return ReducedSystem(S=S, g_red=g_c - Zg, Hpp_inv=Hpp_inv, g_p=g_p, W=W), cost


def build_reduced_system(
    cam: Camera, prob: BAProblem, lam: torch.Tensor, huber_delta: float = HUBER_DELTA,
) -> tuple[ReducedSystem, torch.Tensor]:
    """Eliminate the points: the reduced camera system over all F cameras
    of one landmark set and the robust cost of the current parameters."""
    F = prob.cam_rvec.shape[-2]
    _, safe_cam = obs_include(prob)
    onehot = (safe_cam[..., None] == torch.arange(F, device=safe_cam.device))
    return _eliminate_points(cam, prob, lam, onehot.to(prob.points.dtype), huber_delta)


def solve_camera_system(S: torch.Tensor, g_red: torch.Tensor,
                        cam_free: torch.Tensor) -> torch.Tensor:
    """Solve the dense reduced camera system; frozen cameras get zeroed rows
    and columns and an identity block, so their step is exactly zero.
    `solve_ex` reports a singular system in its info tensor instead of
    reading it back to the host. Stacked systems ([C, F, F, 6, 6]) are
    solved one problem a call."""
    F = S.shape[-4]
    m = cam_free.to(S.dtype)
    S = S * (m[..., :, None, None, None] * m[..., None, :, None, None])
    eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
    S = _add_block_diag(S, (1.0 - m)[..., None, None] * eye6)
    g = g_red * m[..., None]
    lead = g.shape[:-2]
    S_dense = S.transpose(-3, -2).reshape(*lead, F * 6, F * 6)
    delta = per_problem(S.dim() == 5, lambda a, b: torch.linalg.solve_ex(a, b)[0], S_dense,
                        g.reshape(*lead, F * 6, 1))
    return -delta.reshape(*lead, F, 6)


def back_substitute_points(rs: ReducedSystem, delta_c: torch.Tensor,
                           safe_cam: torch.Tensor) -> torch.Tensor:
    """delta_p = -Hpp_inv (g_p + sum_o W_o^T delta_c[cam_o]); [P, 3]."""
    stacked = rs.W.dim() == 5
    dc = _take(delta_c, safe_cam, stacked)  # [P, O, 6]
    Wt_dc = per_problem(stacked, lambda W, d: torch.einsum("poij,poi->pj", W, d), rs.W, dc)
    return -per_problem(stacked, lambda H, v: torch.einsum("pij,pj->pi", H, v), rs.Hpp_inv,
                        rs.g_p + Wt_dc)


def _no_reduce(xs: list) -> list:
    return xs


def _lm(cam: Camera, prob: BAProblem, trial, max_iters: int, init_lambda: float,
        huber_delta: float, allreduce=_no_reduce) -> BAResult:
    """The accept/reject LM loop of window_ba and full_ba without a host
    read: `max_iters` iterations run, and a device-side `done` flag freezes
    the state from the iteration at which the JAX while_loop would have
    exited (function tolerance or lambda > 1e8). `trial(cr, ct, X, lam)`
    returns the trial parameters. `allreduce` sums a list of tensors over
    the landmark shards of a distributed solve (parallel/dist_ba.py); the
    costs and the residual count go through it. For C stacked problems
    cost, lam and the flags are [C] and each problem stops on its own
    iteration, as it does alone."""
    dev = prob.points.device
    lead = prob.points.shape[:-2]
    cr, ct, X = prob.cam_rvec, prob.cam_t, prob.points
    cost = allreduce([_problem_cost(cam, prob, huber_delta)])[0]
    lam = torch.full(lead, init_lambda, dtype=torch.float32, device=dev)
    done = torch.zeros(lead, dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        cr_n, ct_n, X_n = trial(cr, ct, X, lam)
        new_cost = allreduce([_problem_cost(
            cam, prob._replace(cam_rvec=cr_n, cam_t=ct_n, points=X_n), huber_delta)])[0]
        accept = new_cost < cost
        stop = (accept & (cost - new_cost <= FUNCTION_TOLERANCE * cost)) | (lam > 1e8)
        take = accept & ~done
        cr = torch.where(_bcast(take, cr), cr_n, cr)
        ct = torch.where(_bcast(take, ct), ct_n, ct)
        X = torch.where(_bcast(take, X), X_n, X)
        lam = torch.where(done, lam, torch.where(accept, torch.clamp(lam / 3.0, min=1e-9),
                                                 lam * 2.5))
        cost = torch.where(take, new_cost, cost)
        done = done | stop
    include, _ = obs_include(prob)
    return BAResult(cam_rvec=cr, cam_t=ct, points=X, cost=cost,
                    num_residuals=allreduce([include.sum(dim=(-2, -1))])[0])


def window_ba(
    cam: Camera,
    prob: BAProblem,
    free_slots: torch.Tensor,  # [W] camera slots to optimise (-1 = unused)
    max_iters: int = MAX_ITERS,
    init_lambda: float = 1e-4,
    huber_delta: float = HUBER_DELTA,
) -> BAResult:
    """Schur LM with a small window of free cameras (local BA at a commit).

    Every coupling tensor is [P, W, ...]; `prob.cam_free` is ignored, the
    free set is the valid entries of `free_slots`. Frozen cameras anchor
    through the point blocks. Plain PyTorch: the JAX package has no Pallas
    kernel here. C problems of one shape, stacked on a leading axis of
    every field with [C, W] `free_slots`, are one call; each problem's
    result is its solve alone, to the bit."""
    stacked = prob.points.dim() == 3
    W = free_slots.shape[-1]
    slot_ok = free_slots >= 0
    in_slot = prob.obs_cam[..., None] == torch.where(slot_ok, free_slots,
                                                     -2)[..., None, None, :]  # [P, O, W]
    onehot = in_slot.to(prob.points.dtype)
    # Each observation's window slot, W (a zero camera step) outside it.
    slot = torch.where(in_slot.any(-1), in_slot.to(torch.uint8).argmax(-1), W)
    zero_step = torch.zeros((*free_slots.shape[:-1], 1, 6), dtype=prob.points.dtype,
                            device=prob.points.device)
    pf = prob.point_free[..., None]

    def trial(cr, ct, X, lam):
        rs, _ = _eliminate_points(cam, prob._replace(cam_rvec=cr, cam_t=ct, points=X), lam,
                                  onehot, huber_delta)
        delta_c = solve_camera_system(rs.S, rs.g_red, slot_ok)  # [W, 6]
        delta_p = back_substitute_points(rs, torch.cat([delta_c, zero_step], dim=-2), slot)
        return (_add_drop(cr, free_slots, delta_c[..., :3], stacked),
                _add_drop(ct, free_slots, delta_c[..., 3:], stacked), X + delta_p * pf)

    return _lm(cam, prob, trial, max_iters, init_lambda, huber_delta)


def full_ba(
    cam: Camera,
    prob: BAProblem,
    max_iters: int = MAX_ITERS,
    init_lambda: float = 1e-4,
    huber_delta: float = HUBER_DELTA,
    allreduce=_no_reduce,
) -> BAResult:
    """Schur-complement LM over keyframes and points (the periodic
    refinement's solver): reduced camera system, dense solve, point
    back-substitution, accept/reject. Plain PyTorch: the JAX package has
    no Pallas kernel here. C problems of one shape, stacked on a leading
    axis of every field, are one call, each problem's result its solve
    alone to the bit.

    The distributed solver (parallel/dist_ba.py) is this loop over a
    landmark shard: `prob` then holds the shard's points, and `allreduce`
    sums the shards' reduced systems (S, g_red), in one call an iteration,
    and their costs; the camera solve is the same on every shard and the
    back-substitution stays local. By default nothing is reduced: the
    single-device solver."""
    F = prob.cam_rvec.shape[-2]
    safe_cam = torch.clamp(prob.obs_cam, 0, F - 1).long()
    cf = prob.cam_free[..., None]
    pf = prob.point_free[..., None]

    def trial(cr, ct, X, lam):
        rs, _ = build_reduced_system(cam, prob._replace(cam_rvec=cr, cam_t=ct, points=X), lam,
                                     huber_delta)
        S, g_red = allreduce([rs.S, rs.g_red])
        delta_c = solve_camera_system(S, g_red, prob.cam_free)
        delta_p = back_substitute_points(rs, delta_c, safe_cam)
        return cr + delta_c[..., :3] * cf, ct + delta_c[..., 3:] * cf, X + delta_p * pf

    return _lm(cam, prob, trial, max_iters, init_lambda, huber_delta, allreduce)


def structure_ba(
    cam: Camera,
    prob: BAProblem,
    free_slot: torch.Tensor,
    max_iters: int = MAX_ITERS,
    init_lambda: float = 1e-4,
    huber_delta: float = HUBER_DELTA,
) -> BAResult:
    """Schur LM with ONE free camera (`free_slot`, a 0-d index tensor) and
    free points (kernel K4). `prob.cam_free` is ignored. C problems of one
    shape, stacked on a leading axis of every field with a [C] `free_slot`,
    are one K4 launch; each problem's result is its solve alone, to the
    bit."""
    from .kernels.structure_ba import structure_ba_lm

    include, _ = obs_include(prob)
    if prob.points.dim() == 3:
        C = prob.points.shape[0]
        free_slot = free_slot.long().reshape(C)
        idx = (torch.arange(C, device=free_slot.device), free_slot)
    else:
        free_slot = torch.as_tensor(free_slot, device=prob.points.device).long().reshape(())
        idx = (free_slot.reshape(1),)
    out, points = structure_ba_lm(
        prob.cam_rvec.float().contiguous(), prob.cam_t.float().contiguous(),
        prob.points.float().contiguous(), prob.obs_cam.long().contiguous(),
        prob.obs_uv.float().contiguous(), include.contiguous(),
        prob.point_free.contiguous(), free_slot,
        fx=cam.fx, cx=cam.cx, cy=cam.cy, max_iters=max_iters,
        huber_delta=huber_delta, init_lambda=init_lambda,
    )
    return BAResult(
        cam_rvec=prob.cam_rvec.index_put(idx, out[..., :3].reshape(-1, 3)),
        cam_t=prob.cam_t.index_put(idx, out[..., 3:6].reshape(-1, 3)),
        points=points,
        cost=out[..., 6],
        num_residuals=include.sum(dim=(-2, -1)),
    )
