"""Hypothesis-batch RANSAC for relative pose (port of
racing_slam_tpu/ops/ransac.py).

H minimal 8-point hypotheses are drawn at once (Gumbel-top-8 over uniforms
restricted to valid matches), estimated and scored by Sampson error in one
batch; the winner is refit by 4 Cauchy-IRLS steps and the four (R, t)
decompositions are disambiguated by triangulation cheirality counts. The
lockstep step of S sequences estimates S pairs in one call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3
from .camera import Camera, normalize_pixels
from .essential import decompose, eight_point, sampson_error_sq
from .matching import gather_rows
from .triangulation import triangulate_points

DEFAULT_NUM_HYPOTHESES = 512
DEFAULT_THRESHOLD_PX = 0.4
MIN_SAMPLE = 8


class PoseEstimate(NamedTuple):
    pose: torch.Tensor  # [..., 4, 4] relative transform cam1 -> cam2
    essential: torch.Tensor  # [..., 3, 3]
    inliers: torch.Tensor  # [..., N] bool
    num_inliers: torch.Tensor  # [...]


def sample_minimal_sets(uniforms: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[..., H, N] uniforms -> [..., H, 8] indices of a uniform random valid
    8-subset per row (top-8 of the uniforms over valid entries, mask
    [..., N])."""
    u = torch.where(mask[..., None, :], uniforms, torch.full_like(uniforms, -float("inf")))
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
    """Relative pose between two views from pixel matches [N, 2], or of S
    independent view pairs given [S, N, 2] matches and [S, N] masks (the
    lockstep step's rows): each row's estimate has the bits its pair alone
    gives (ops/essential.py), and its winning hypothesis and decomposition
    are picked on the device.

    The [..., H, N] sampling uniforms come from `generator` (on the
    tensors' device), or are given directly as `uniforms`, as the lockstep
    step does with each row's own generator's draw.
    """
    lead = uv1.shape[:-2]
    rows = len(lead)
    n = uv1.shape[-2]
    if uniforms is None:
        uniforms = torch.rand(
            (*lead, num_hypotheses, n), generator=generator, device=uv1.device,
            dtype=torch.float32
        )
    x1 = normalize_pixels(cam, uv1)
    x2 = normalize_pixels(cam, uv2)
    thresh = threshold_px / (0.5 * (cam.fx + cam.fy))
    thresh_sq = thresh * thresh

    # Each hypothesis sees only its 8 sampled rows (unit weights): the same
    # estimate as one-hot weights over all N rows, without the [H, N, 9] stack.
    idx = sample_minimal_sets(uniforms, mask)  # [..., H, 8]
    ones = torch.ones(idx.shape, dtype=x1.dtype, device=x1.device)
    flat = idx.flatten(-2)  # [..., H * 8]
    Es = eight_point(gather_rows(x1, flat).unflatten(-2, idx.shape[-2:]),
                     gather_rows(x2, flat).unflatten(-2, idx.shape[-2:]), ones,
                     rows=rows)  # [..., H, 3, 3]
    errs = sampson_error_sq(Es, x1[..., None, :, :], x2[..., None, :, :])  # [..., H, N]
    inl = (errs < thresh_sq) & mask[..., None, :]
    E = gather_rows(Es, torch.argmax(torch.sum(inl, dim=-1), dim=-1, keepdim=True))[..., 0, :, :]
    for _ in range(4):
        err = sampson_error_sq(E, x1, x2)
        w = torch.where(mask, thresh_sq / (thresh_sq + err), torch.zeros_like(err))
        E = eight_point(x1, x2, w, rows=rows)
    inliers = (sampson_error_sq(E, x1, x2) < thresh_sq) & mask

    # The four decompositions, disambiguated by the count of points that
    # triangulate in front of both cameras.
    Rs, ts = decompose(E)  # [..., 4, 3, 3], [..., 4, 3]
    eye = torch.eye(4, dtype=torch.float32, device=uv1.device)
    rels = eye.expand(*lead, 4, 4, 4).clone()
    rels[..., :3, :3] = Rs
    rels[..., :3, 3] = ts
    tri = triangulate_points(cam, eye, rels, uv1[..., None, :, :], uv2[..., None, :, :],
                             mask=inliers[..., None, :])
    best = torch.argmax(torch.sum(tri.valid, dim=-1), dim=-1, keepdim=True)
    pose = gather_rows(rels, best)[..., 0, :, :]
    return PoseEstimate(pose=pose, essential=E, inliers=inliers,
                        num_inliers=inliers.sum(dim=-1))


def compose_with_previous(rel_pose: torch.Tensor, prev_pose: torch.Tensor) -> torch.Tensor:
    """frame pose = rel * previous pose (se3.compose, for [..., 4, 4])."""
    return se3.compose(rel_pose, prev_pose)
