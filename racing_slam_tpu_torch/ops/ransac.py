"""Hypothesis-batch RANSAC for relative pose (port of
racing_slam_tpu/ops/ransac.py).

H minimal 8-point hypotheses are drawn at once (Gumbel-top-8 over uniforms
restricted to valid matches), estimated and scored by Sampson error in one
batch; the winner is refit by 4 Cauchy-IRLS steps and the four (R, t)
decompositions are disambiguated by triangulation cheirality counts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .camera import Camera, normalize_pixels
from .essential import decompose, eight_point, sampson_error_sq
from .triangulation import triangulate_points

DEFAULT_NUM_HYPOTHESES = 512
DEFAULT_THRESHOLD_PX = 0.4
MIN_SAMPLE = 8


class PoseEstimate(NamedTuple):
    pose: torch.Tensor  # [4, 4] relative transform cam1 -> cam2
    essential: torch.Tensor  # [3, 3]
    inliers: torch.Tensor  # [N] bool
    num_inliers: torch.Tensor


def sample_minimal_sets(uniforms: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[H, N] uniforms -> [H, 8] indices of a uniform random valid 8-subset
    per row (top-8 of the uniforms over valid entries)."""
    u = torch.where(mask[None, :], uniforms, torch.full_like(uniforms, -float("inf")))
    return torch.topk(u, MIN_SAMPLE, dim=-1).indices


def estimate_relative_pose(
    cam: Camera,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    mask: torch.Tensor,
    generator: torch.Generator | None = None,
    num_hypotheses: int = DEFAULT_NUM_HYPOTHESES,
    threshold_px: float = DEFAULT_THRESHOLD_PX,
    uniforms: torch.Tensor | None = None,
) -> PoseEstimate:
    """Relative pose between two views from pixel matches [N, 2].

    The [H, N] sampling uniforms come from `generator` (on the tensors'
    device), or are given directly as `uniforms` so tests can fix the draws.
    """
    n = uv1.shape[0]
    if uniforms is None:
        uniforms = torch.rand(
            (num_hypotheses, n), generator=generator, device=uv1.device, dtype=torch.float32
        )
    x1 = normalize_pixels(cam, uv1)
    x2 = normalize_pixels(cam, uv2)
    thresh = threshold_px / (0.5 * (cam.fx + cam.fy))
    thresh_sq = thresh * thresh

    # Each hypothesis sees only its 8 sampled rows (unit weights): the same
    # estimate as one-hot weights over all N rows, without the [H, N, 9] stack.
    idx = sample_minimal_sets(uniforms, mask)  # [H, 8]
    ones = torch.ones(idx.shape, dtype=x1.dtype, device=x1.device)
    Es = eight_point(x1[idx], x2[idx], ones)  # [H, 3, 3]
    errs = sampson_error_sq(Es, x1, x2)  # [H, N]
    inl = (errs < thresh_sq) & mask[None, :]
    best = torch.argmax(torch.sum(inl, dim=-1))

    E = Es[best]
    for _ in range(4):
        err = sampson_error_sq(E, x1, x2)
        w = torch.where(mask, thresh_sq / (thresh_sq + err), torch.zeros_like(err))
        E = eight_point(x1, x2, w)
    inliers = (sampson_error_sq(E, x1, x2) < thresh_sq) & mask

    Rs, ts = decompose(E)
    eye = torch.eye(4, dtype=torch.float32, device=uv1.device)
    rels = eye.repeat(4, 1, 1)
    rels[:, :3, :3] = Rs
    rels[:, :3, 3] = ts
    counts = torch.stack([
        torch.sum(triangulate_points(cam, eye, rels[i], uv1, uv2, mask=inliers).valid)
        for i in range(4)
    ])
    pose = rels[torch.argmax(counts)]
    return PoseEstimate(pose=pose, essential=E, inliers=inliers, num_inliers=inliers.sum())
