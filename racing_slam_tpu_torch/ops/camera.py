"""Pinhole camera model (port of racing_slam_tpu/ops/camera.py).

``Camera`` holds plain Python floats, so it carries no device; every function
takes its device from the tensors it is given.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3


class Camera(NamedTuple):
    """Pinhole intrinsics (same fields as the JAX package's Camera)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def K(self, like: torch.Tensor) -> torch.Tensor:
        """[3, 3] intrinsics on the device and dtype of `like` (filled there,
        not copied from host memory)."""
        K = torch.zeros((3, 3), dtype=like.dtype, device=like.device)
        for (i, j), v in (((0, 0), self.fx), ((1, 1), self.fy), ((0, 2), self.cx),
                          ((1, 2), self.cy), ((2, 2), 1.0)):
            K[i, j].fill_(v)
        return K


def project_camera_points(cam: Camera, Xc: torch.Tensor) -> torch.Tensor:
    """Camera-space points [..., 3] -> pixel coords [..., 2] (no cheirality)."""
    z = Xc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    u = cam.fx * Xc[..., 0] * inv_z + cam.cx
    v = cam.fy * Xc[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1)


def project(cam: Camera, pose: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """World points [..., N, 3] through world->camera pose [..., 4, 4] -> pixels."""
    return project_camera_points(cam, se3.transform_points(pose, X))


def project_with_depth(
    cam: Camera, pose: torch.Tensor, X: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Like project, but also returns camera-space depth [..., N]."""
    Xc = se3.transform_points(pose, X)
    return project_camera_points(cam, Xc), Xc[..., 2]


def is_in_image(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """0 <= u < width and 0 <= v < height, for pixel coords [..., 2]."""
    u, v = uv[..., 0], uv[..., 1]
    return (u >= 0.0) & (u < cam.width) & (v >= 0.0) & (v < cam.height)


def normalize_pixels(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] -> normalized image plane ((u-cx)/fx, (v-cy)/fy)."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x, y], dim=-1)


def projection_matrix(cam: Camera, pose: torch.Tensor) -> torch.Tensor:
    """3x4 projection matrix K [R|t] (summed in a fixed order, as se3's products)."""
    return se3.matmul_in_order(cam.K(pose), pose[..., :3, :4])
