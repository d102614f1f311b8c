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

Leading dims may hold independent problems of several sequences (the
lockstep step's rows): `rows` counts those leading dims. A row's bits do
not depend on how many rows there are. The sums over correspondences and
the small products run in a fixed order by elementwise ops
(sum_in_order, se3.matmul_in_order), and the eigen and SVD solvers see
one row's matrices a call, the shape a single sequence's call has: on the
card, cuSOLVER takes another routine for a batch than for one matrix, and
a library reduction splits its sum by the number of outputs.
"""

from __future__ import annotations

import functools
import math

import torch

from .se3 import matmul_in_order

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


def sum_in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x summed over `dim` by pairwise halving (the first half plus the
    second, an odd last term carried), each step one elementwise add: the
    same order for every other index of x, whatever its shape."""
    n = x.shape[dim]
    while n > 1:
        h = n // 2
        head = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
        x = head if n % 2 == 0 else torch.cat([head, x.narrow(dim, 2 * h, 1)], dim=dim)
        n = h + n % 2
    return x.squeeze(dim)


def _per_row(fn, x: torch.Tensor, rows: int):
    """fn(x) with the first `rows` dims of x split off: one call a row, the
    outputs stacked back (a tuple of tensors or one tensor)."""
    if rows == 0:
        return fn(x)
    lead = x.shape[:rows]
    outs = [fn(r) for r in x.reshape(-1, *x.shape[rows:])]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs).reshape(*lead, *outs[0].shape)
    return tuple(torch.stack(o).reshape(*lead, *o[0].shape) for o in zip(*outs))


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactors (no library call, no host check)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def eight_point(x1: torch.Tensor, x2: torch.Tensor, weights: torch.Tensor,
                rows: int = 0) -> torch.Tensor:
    """Weighted normalized 8-point E from [..., N, 2] correspondences and
    [..., N] weights; singular values projected to (1, 1, 0). The first
    `rows` leading dims are the rows of several sequences (see the module
    docstring); the solvers take the rest of the leading dims at once."""
    dtype = x1.dtype
    x1, x2, weights = x1.to(SOLVE_DTYPE), x2.to(SOLVE_DTYPE), weights.to(SOLVE_DTYPE)
    w = weights[..., None]
    # The weight sum and both weighted centroids in one fixed-order sum, then
    # both mean distances from them in another (each column summed alone).
    first = sum_in_order(torch.cat([w, w * x1, w * x2], dim=-1), -2)  # [..., 5]
    wsum = first[..., 0] + 1e-12  # [...]
    m1 = first[..., 1:3] / wsum[..., None]
    m2 = first[..., 3:5] / wsum[..., None]
    spread = sum_in_order(torch.stack([weights * torch.linalg.norm(x1 - m1[..., None, :], dim=-1),
                                       weights * torch.linalg.norm(x2 - m2[..., None, :], dim=-1)],
                                      dim=-1), -2)  # [..., 2]
    d1 = spread[..., 0] / wsum
    d2 = spread[..., 1] / wsum
    s1 = math.sqrt(2.0) / (d1 + 1e-12)
    s2 = math.sqrt(2.0) / (d2 + 1e-12)
    n1 = (x1 - m1[..., None, :]) * s1[..., None, None]
    n2 = (x2 - m2[..., None, :]) * s2[..., None, None]
    h1 = _homogeneous(n1)
    h2 = _homogeneous(n2)
    A = (h2[..., :, :, None] * h1[..., :, None, :]).reshape(*h1.shape[:-1], 9)
    AtA = sum_in_order((A * w)[..., :, :, None] * A[..., :, None, :], -3)
    _, vecs = _per_row(torch.linalg.eigh, AtA, rows)
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
    E = matmul_in_order(matmul_in_order(T2.transpose(-1, -2), En), T1)
    U, _, Vh = _per_row(torch.linalg.svd, E, rows)
    sing = _constants(E.device, E.dtype)[0]
    return matmul_in_order(U * sing, Vh).to(dtype)


def sampson_error_sq(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance [..., N] (E [..., 3, 3], x [..., N, 2],
    their leading dims broadcasting)."""
    h1 = _homogeneous(x1)
    h2 = _homogeneous(x2)
    Ex1 = matmul_in_order(h1, E.transpose(-1, -2))  # [..., N, 3]
    Etx2 = matmul_in_order(h2, E)
    num = (h2[..., 0] * Ex1[..., 0] + h2[..., 1] * Ex1[..., 1] + h2[..., 2] * Ex1[..., 2]) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / (den + 1e-18)


def decompose(E: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """E [..., 3, 3] -> four (R, t) candidates on the axis before the 3x3:
    R [..., 4, 3, 3] = {R1, R1, R2, R2}, t [..., 4, 3] = {t, -t, t, -t}.
    The SVD sees one matrix a call (see the module docstring)."""
    dtype = E.dtype
    U, _, Vh = _per_row(torch.linalg.svd, E.to(SOLVE_DTYPE), E.dim() - 2)
    U = U * torch.sign(_det3(U))[..., None, None]
    Vh = Vh * torch.sign(_det3(Vh))[..., None, None]
    W = _constants(E.device, SOLVE_DTYPE)[1]
    R1 = matmul_in_order(matmul_in_order(U, W), Vh)
    R2 = matmul_in_order(matmul_in_order(U, W.T), Vh)
    t = U[..., :, 2]
    return (torch.stack([R1, R1, R2, R2], dim=-3).to(dtype),
            torch.stack([t, -t, t, -t], dim=-2).to(dtype))
