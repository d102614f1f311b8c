"""Batched two-view DLT triangulation with validity filters (port of
racing_slam_tpu/ops/triangulation.py).

Filters as the reference: in front of both cameras, parallax cos <= 0.9999,
reprojection <= max_reproj_px in both views.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3
from .ba import inv3x3
from .camera import Camera, project_camera_points, projection_matrix

MAX_PARALLAX_COS = 0.9999
MAX_REPROJ_ERR_PX = 2.0


class Triangulated(NamedTuple):
    points: torch.Tensor  # [N, 3] (garbage where ~valid)
    valid: torch.Tensor  # [N] bool


def _dlt_inhomogeneous(P1, P2, uv1, uv2) -> torch.Tensor:
    """Linear triangulation with w = 1 by closed-form 3x3 normal equations."""
    rows = []
    for P, uv in ((P1, uv1), (P2, uv2)):
        u = uv[..., 0:1]
        v = uv[..., 1:2]
        rows.append(u * P[2] - P[0])
        rows.append(v * P[2] - P[1])
    A = torch.stack(rows, dim=-2)  # [N, 4, 4]
    A = A / (torch.linalg.norm(A, dim=-1, keepdim=True) + 1e-12)
    B = A[..., :, :3]
    b = -A[..., :, 3]
    BtB = torch.einsum("...ki,...kj->...ij", B, B)
    Btb = torch.einsum("...ki,...k->...i", B, b)
    return torch.einsum("...ij,...j->...i", inv3x3(BtB), Btb)


def triangulate_points(
    cam: Camera,
    pose1: torch.Tensor,
    pose2: torch.Tensor,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    mask: torch.Tensor | None = None,
    max_reproj_px: float = MAX_REPROJ_ERR_PX,
) -> Triangulated:
    """Triangulate N pixel correspondences between two posed views."""
    X = _dlt_inhomogeneous(projection_matrix(cam, pose1), projection_matrix(cam, pose2), uv1, uv2)
    Xc1 = se3.transform_points(pose1, X)
    Xc2 = se3.transform_points(pose2, X)
    in_front = (Xc1[..., 2] > 0.0) & (Xc2[..., 2] > 0.0)
    d1 = se3.camera_center(pose1) - X
    d2 = se3.camera_center(pose2) - X
    d1n = d1 / (torch.linalg.norm(d1, dim=-1, keepdim=True) + 1e-12)
    d2n = d2 / (torch.linalg.norm(d2, dim=-1, keepdim=True) + 1e-12)
    has_parallax = torch.sum(d1n * d2n, dim=-1) <= MAX_PARALLAX_COS
    r1 = torch.linalg.norm(project_camera_points(cam, Xc1) - uv1, dim=-1)
    r2 = torch.linalg.norm(project_camera_points(cam, Xc2) - uv2, dim=-1)
    reproj_ok = (r1 <= max_reproj_px) & (r2 <= max_reproj_px)
    valid = in_front & has_parallax & reproj_ok
    if mask is not None:
        valid = valid & mask
    return Triangulated(points=X, valid=valid)
