"""Essential-matrix estimation and decomposition (port of
racing_slam_tpu/ops/essential.py), batched over leading dims.

Inputs are normalized image-plane coordinates; E satisfies x2^T E x1 = 0
with X2 = R X1 + t. SVD signs are arbitrary, so E is defined up to sign and
scale and decompose() enumerates all four (R, t) candidates.

The 8-point algebra and the decomposition run in SOLVE_DTYPE (float64)
and return the caller's dtype. The normal matrix A^T A squares the
condition number, and on the card cuSOLVER's float32 eigen and SVD solvers
lose more of the tail than LAPACK's float32 on the CPU, where the JAX
package solves it (measured by tools/pose_probe.py; PERF.md section 6).
"""

from __future__ import annotations

import functools
import math

import torch


SOLVE_DTYPE = torch.float64


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The singular values (1, 1, 0) and decompose()'s W on `device`, copied
    there once (torch.tensor from host values is a synchronising copy)."""
    sing = torch.tensor([1.0, 1.0, 0.0], dtype=dtype)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=dtype)
    return sing.to(device), W.to(device)


def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def eight_point(x1: torch.Tensor, x2: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted normalized 8-point E from [..., N, 2] correspondences and
    [..., N] weights; singular values projected to (1, 1, 0)."""
    dtype = x1.dtype
    x1, x2, weights = x1.to(SOLVE_DTYPE), x2.to(SOLVE_DTYPE), weights.to(SOLVE_DTYPE)
    wsum = torch.sum(weights, dim=-1) + 1e-12  # [...]
    w = weights[..., None]
    m1 = torch.sum(w * x1, dim=-2) / wsum[..., None]
    m2 = torch.sum(w * x2, dim=-2) / wsum[..., None]
    d1 = torch.sum(weights * torch.linalg.norm(x1 - m1[..., None, :], dim=-1), dim=-1) / wsum
    d2 = torch.sum(weights * torch.linalg.norm(x2 - m2[..., None, :], dim=-1), dim=-1) / wsum
    s1 = math.sqrt(2.0) / (d1 + 1e-12)
    s2 = math.sqrt(2.0) / (d2 + 1e-12)
    n1 = (x1 - m1[..., None, :]) * s1[..., None, None]
    n2 = (x2 - m2[..., None, :]) * s2[..., None, None]
    h1 = _homogeneous(n1)
    h2 = _homogeneous(n2)
    A = (h2[..., :, :, None] * h1[..., :, None, :]).reshape(*h1.shape[:-1], 9)
    AtA = torch.einsum("...ni,...nj->...ij", A * w, A)
    _, vecs = torch.linalg.eigh(AtA)
    En = vecs[..., :, 0].reshape(*vecs.shape[:-2], 3, 3)

    def cond(s, m):
        T = torch.zeros(s.shape + (3, 3), dtype=s.dtype, device=s.device)
        T[..., 0, 0] = s
        T[..., 1, 1] = s
        T[..., 0, 2] = -s * m[..., 0]
        T[..., 1, 2] = -s * m[..., 1]
        T[..., 2, 2].fill_(1.0)
        return T

    T1 = cond(s1, m1)
    T2 = cond(s2, m2)
    E = T2.transpose(-1, -2) @ En @ T1
    U, _, Vh = torch.linalg.svd(E)
    sing = _constants(E.device, E.dtype)[0]
    return ((U * sing) @ Vh).to(dtype)


def sampson_error_sq(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance [..., N] (E [..., 3, 3], x [N, 2])."""
    h1 = _homogeneous(x1)
    h2 = _homogeneous(x2)
    Ex1 = h1 @ E.transpose(-1, -2)  # [..., N, 3]
    Etx2 = h2 @ E
    num = torch.sum(h2 * Ex1, dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / (den + 1e-18)


def decompose(E: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """E -> four (R, t) candidates: ({R1, R1, R2, R2}, {t, -t, t, -t})."""
    dtype = E.dtype
    U, _, Vh = torch.linalg.svd(E.to(SOLVE_DTYPE))
    U = U * torch.sign(torch.linalg.det(U))
    Vh = Vh * torch.sign(torch.linalg.det(Vh))
    W = _constants(E.device, SOLVE_DTYPE)[1]
    R1 = U @ W @ Vh
    R2 = U @ W.T @ Vh
    t = U[:, 2]
    return torch.stack([R1, R1, R2, R2]).to(dtype), torch.stack([t, -t, t, -t]).to(dtype)
