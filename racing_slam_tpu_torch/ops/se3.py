"""SE(3) / SO(3) utilities on tensors (port of racing_slam_tpu/ops/se3.py).

A pose is a 4x4 float32 world->camera transform; optimisation uses the
(rvec, t) angle-axis + translation packing. All functions broadcast over
leading dims and branch on small angles with torch.where, never on the host.
Their small matrix products, point transforms included, are summed in a
fixed order (matmul_in_order), so that a pose or a point of a stack gives
the same bits as it does alone: the lockstep step of S sequences must
project, predict and commit each row as the single step does.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def matmul_in_order(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for small matrices ([..., n, k] x [..., k, m], broadcasting):
    each product rounded alone and the k terms added in index order, by
    elementwise ops whose rounding does not depend on the batch. A library
    product does not promise that: on the CPU, bmm over a stack of 4x4
    poses and mm over one of them differ in the last bit."""
    p = a[..., :, :, None] * b[..., None, :, :]
    out = p[..., 0, :]
    for k in range(1, p.shape[-2]):
        out = out + p[..., k, :]
    return out


def per_problem(stacked: bool, fn, *xs: torch.Tensor):
    """fn(*xs) for one problem; for C stacked problems (a leading C on every
    x), fn of each problem's operands, the outputs stacked (one tensor or a
    tuple of them). A library call (a product, a sum over many terms, a
    solve) may pick its kernel, and so its order of summing, by its
    operands' shapes: at one problem's shapes each problem gets the bits it
    gets alone. Elementwise work runs over the stack outside fn."""
    if not stacked:
        return fn(*xs)
    outs = [fn(*row) for row in zip(*xs)]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(torch.stack(o) for o in zip(*outs))


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]_x for w[..., 3] -> [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: [..., 3, 3] skew -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def exp_so3(rvec: torch.Tensor) -> torch.Tensor:
    """Rodrigues: angle-axis [..., 3] -> rotation [..., 3, 3], Taylor-safe."""
    theta2 = torch.sum(rvec * rvec, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    W = hat(rvec)
    WW = matmul_in_order(W, W)
    return _eye3(rvec) + a[..., None, None] * W + b[..., None, None] * WW


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> angle-axis [..., 3]; robust near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_skew = vee(R - R.transpose(-1, -2))  # = 2 sin(theta) * axis
    sin_theta = 0.5 * torch.linalg.norm(w_skew, dim=-1)
    theta = torch.atan2(sin_theta, cos_theta)

    small = theta < 1e-4
    scale = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / torch.where(small, torch.ones_like(sin_theta), 2.0 * sin_theta + _EPS),
    )
    w_generic = scale[..., None] * w_skew

    # Near pi the skew part vanishes: the axis is the best-conditioned column
    # of (R + R^T)/2 - cos(theta) I, its sign aligned with the skew part.
    near_pi = sin_theta < 1e-2
    S = 0.5 * (R + R.transpose(-1, -2))
    M = S - cos_theta[..., None, None] * _eye3(R)
    diag = torch.stack([M[..., 0, 0], M[..., 1, 1], M[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    idx = k[..., None, None].expand(*M.shape[:-1], 1)
    col = torch.gather(M, -1, idx)[..., 0]
    axis = col / (torch.linalg.norm(col, dim=-1, keepdim=True) + _EPS)
    align = torch.sum(axis * w_skew, dim=-1)
    sign = torch.where(align < 0.0, -1.0, 1.0)
    w_pi = theta[..., None] * axis * sign[..., None]

    use_pi = near_pi & (cos_theta < 0.0)
    return torch.where(use_pi[..., None], w_pi, w_generic)


def pose_matrix(rvec: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(rvec[..., 3], t[..., 3]) -> 4x4 world->camera transform [..., 4, 4]."""
    R = exp_so3(rvec)
    top = torch.cat([R, t[..., :, None].to(R.dtype)], dim=-1)  # [..., 3, 4]
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def rt_from_matrix(T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """4x4 [..., 4, 4] -> (rvec[..., 3], t[..., 3])."""
    return log_so3(T[..., :3, :3]), T[..., :3, 3]


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid 4x4 transform (R^T, -R^T t)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3]
    ti = -matmul_in_order(Rt, t[..., :, None])[..., 0]
    top = torch.cat([Rt, ti[..., :, None]], dim=-1)
    bottom = torch.zeros(T.shape[:-2] + (1, 4), dtype=T.dtype, device=T.device)
    bottom[..., 0, 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def compose(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """Ta @ Tb with broadcasting (applies Tb first), in a fixed order."""
    return matmul_in_order(Ta, Tb)


def transform_points(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] transform to points [..., N, 3]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return matmul_in_order(X, R.transpose(-1, -2)) + t[..., None, :]


def transform_point(T: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] transform to a single point [..., 3]."""
    return matmul_in_order(T[..., :3, :3], X[..., :, None])[..., 0] + T[..., :3, 3]


def camera_center(T: torch.Tensor) -> torch.Tensor:
    """World-space camera center of a world->camera pose: -R^T t."""
    return -matmul_in_order(T[..., :3, :3].transpose(-1, -2), T[..., :3, 3, None])[..., 0]
