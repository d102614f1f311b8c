"""Dense masked feature matching (port of racing_slam_tpu/ops/matching.py).

- frame<->frame: mutual 1-NN over one [K1, K2] distance matrix with a gate.
- map->frame: a masked [P, K] min reduction. Stage 1 (best keypoint per
  point) is kernel K2 (ops/kernels/match.py); stage 2 (best point per
  keypoint, lowest point index on ties) is a scatter-min here.

Only the dense path is ported; the banded scale path comes in a later PR.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .camera import Camera, is_in_image, project_with_depth
from .kernels.match import guided_match_stage1

SEARCH_RADIUS_PX = 20.0
_BIG = 1e9


class FrameMatches(NamedTuple):
    train_idx: torch.Tensor  # [K2] int64 index into frame-1 keypoints
    distance: torch.Tensor  # [K2] f32
    valid: torch.Tensor  # [K2] bool


class MapMatches(NamedTuple):
    point_idx: torch.Tensor  # [K] int64 map slot (-1 where ~valid)
    distance: torch.Tensor  # [K] f32
    valid: torch.Tensor  # [K] bool


def _pairwise_sq_dists(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """[N1, D], [N2, D] -> [N1, N2] squared L2 distances.

    The cross term is taken on bf16-rounded descriptors with float32
    products and sums (bf16 x bf16 is exact in float32; a bf16 matmul in
    PyTorch would round its result to bf16), norms of the rounded vectors.
    """
    f1 = d1.to(torch.bfloat16).float()
    f2 = d2.to(torch.bfloat16).float()
    n1 = torch.sum(f1 * f1, dim=-1)
    n2 = torch.sum(f2 * f2, dim=-1)
    return torch.clamp(n1[:, None] + n2[None, :] - 2.0 * (f1 @ f2.T), min=0.0)


def match_frames(
    desc1: torch.Tensor,
    valid1: torch.Tensor,
    desc2: torch.Tensor,
    valid2: torch.Tensor,
    max_distance: float,
) -> FrameMatches:
    """Mutual 1-NN (queries: frame 2, trains: frame 1) with a distance gate."""
    d2 = _pairwise_sq_dists(desc1, desc2)
    d2 = torch.where(valid1[:, None] & valid2[None, :], d2, torch.full_like(d2, _BIG))
    best1_for_2 = torch.argmin(d2, dim=0)
    best2_for_1 = torch.argmin(d2, dim=1)
    mutual = best2_for_1[best1_for_2] == torch.arange(d2.shape[1], device=d2.device)
    dist = torch.sqrt(torch.gather(d2, 0, best1_for_2[None, :])[0])
    ok = mutual & (dist < max_distance) & valid2
    return FrameMatches(train_idx=best1_for_2, distance=dist, valid=ok)


def match_map_to_frame(
    cam: Camera,
    pose: torch.Tensor,
    point_xyz: torch.Tensor,
    point_mask: torch.Tensor,
    obs_desc: torch.Tensor,
    obs_valid: torch.Tensor,
    kp_uv: torch.Tensor,
    kp_desc: torch.Tensor,
    kp_valid: torch.Tensor,
    kp_already_matched: torch.Tensor,
    point_already_matched: torch.Tensor,
    max_distance: float,
    radius_px: float = SEARCH_RADIUS_PX,
) -> MapMatches:
    """Guided projection search of map points into a frame.

    Stage 1 is kernel K2 for CUDA tensors and its plain twin for CPU tensors.
    """
    P = point_xyz.shape[0]
    K = kp_uv.shape[0]
    uv_p, depth = project_with_depth(cam, pose, point_xyz)
    gate_p = point_mask & ~point_already_matched & is_in_image(cam, uv_p) & (depth > 0.0)
    kp_ok = kp_valid & ~kp_already_matched
    best_k, best_d = guided_match_stage1(
        uv_p.contiguous(), gate_p, obs_desc, obs_valid, kp_uv, kp_desc, kp_ok,
        radius_px=radius_px,
    )
    best_d = torch.sqrt(torch.clamp(best_d, max=_BIG))
    best_d = torch.where(best_d < max_distance, best_d, torch.full_like(best_d, _BIG))
    return _stage2(best_k.long(), best_d, P, K)


def _stage2(best_k: torch.Tensor, best_d: torch.Tensor, P: int, K: int) -> MapMatches:
    """Best point per keypoint by scatter-min; lowest point index wins ties."""
    dev = best_d.device
    kp_best_d = torch.full((K,), _BIG, dtype=best_d.dtype, device=dev).scatter_reduce(
        0, best_k, best_d, reduce="amin"
    )
    pid = torch.arange(P, device=dev)
    is_winner = best_d <= kp_best_d[best_k]
    cand = torch.where(is_winner & (best_d < _BIG), pid, torch.full_like(pid, P))
    kp_point = torch.full((K,), P, dtype=pid.dtype, device=dev).scatter_reduce(
        0, best_k, cand, reduce="amin"
    )
    valid = (kp_best_d < _BIG) & (kp_point < P)
    return MapMatches(
        point_idx=torch.where(valid, kp_point, torch.full_like(kp_point, -1)),
        distance=kp_best_d,
        valid=valid,
    )


def unmatched_mask(
    matches: FrameMatches, kp1_matched: torch.Tensor, kp2_matched: torch.Tensor
) -> torch.Tensor:
    """Frame matches whose two keypoints both lack a map association."""
    return matches.valid & ~kp1_matched[matches.train_idx] & ~kp2_matched
