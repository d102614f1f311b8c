"""Shi-Tomasi grid corners (port of racing_slam_tpu/ops/corners.py).

Keypoints are the top-n peaks of the NMS'd response in each cell of a
regular grid, so K = n_per_cell * ceil(H/cell) * ceil(W/cell) is static,
with a quality gate relative to the best peak and parabola sub-pixel
refinement on the raw response.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .image import box_filter, gaussian_blur, max_pool_same, sobel_gradients

DEFAULT_QUALITY = 0.005
DEFAULT_MIN_DISTANCE = 7
DEFAULT_BLOCK_SIZE = 3


class Corners(NamedTuple):
    xy: torch.Tensor  # [K, 2] sub-pixel (x, y)
    score: torch.Tensor  # [K] Shi-Tomasi response
    valid: torch.Tensor  # [K] bool


def shi_tomasi_response(
    img: torch.Tensor,
    block_size: int = DEFAULT_BLOCK_SIZE,
    pre_blur_sigma: float = 1.2,
) -> torch.Tensor:
    """Min eigenvalue of the structure tensor per pixel: [..., H, W]."""
    if pre_blur_sigma > 0:
        img = gaussian_blur(img, pre_blur_sigma)
    Ix, Iy = sobel_gradients(img)
    Sxx = box_filter(Ix * Ix, block_size)
    Syy = box_filter(Iy * Iy, block_size)
    Sxy = box_filter(Ix * Iy, block_size)
    half_tr = 0.5 * (Sxx + Syy)
    rad = torch.sqrt(torch.clamp((0.5 * (Sxx - Syy)) ** 2 + Sxy * Sxy, min=0.0))
    return half_tr - rad


def gated_response_maps(
    img: torch.Tensor,
    mask: torch.Tensor | None = None,
    border: int = 8,
    nms_radius: int = DEFAULT_MIN_DISTANCE,
    pre_blur_sigma: float = 1.2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mask/border-gated response, NMS peaks) of [..., H, W] images.

    Gating comes before NMS, so suppressed corners cannot shadow real peaks.
    """
    H, W = img.shape[-2:]
    score = shi_tomasi_response(img, pre_blur_sigma=pre_blur_sigma)
    if mask is not None:
        score = torch.where(mask > 0, score, torch.zeros_like(score))
    if border > 0:
        ys = torch.arange(H, device=img.device)[:, None]
        xs = torch.arange(W, device=img.device)[None, :]
        inb = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
        score = torch.where(inb, score, torch.zeros_like(score))
    is_peak = score >= max_pool_same(score, 2 * nms_radius + 1)
    return score, torch.where(is_peak, score, torch.zeros_like(score))


def detect_corners(
    img: torch.Tensor,
    mask: torch.Tensor | None = None,
    cell: int = 16,
    quality: float = DEFAULT_QUALITY,
    min_distance: int = DEFAULT_MIN_DISTANCE,
    border: int = 8,
    n_per_cell: int = 2,
) -> Corners:
    """Detect corners on a grayscale [H, W] image (plain conv-stack path)."""
    score, peaks = gated_response_maps(img, mask, border, min_distance)
    return select_corners_from_maps(
        score, peaks, cell=cell, quality=quality, n_per_cell=n_per_cell
    )


def select_corners_from_maps(
    score: torch.Tensor,
    peak_score: torch.Tensor,
    *,
    cell: int,
    quality: float = DEFAULT_QUALITY,
    n_per_cell: int = 2,
) -> Corners:
    """Grid-cell top-n + quality gate + sub-pixel refinement on [H, W] maps."""
    H, W = score.shape
    Hp = -(-H // cell) * cell
    Wp = -(-W // cell) * cell
    gh, gw = Hp // cell, Wp // cell
    padded = torch.zeros((Hp, Wp), dtype=peak_score.dtype, device=peak_score.device)
    padded[:H, :W] = peak_score
    cells = padded.reshape(gh, cell, gw, cell).permute(0, 2, 1, 3).reshape(
        gh * gw, cell * cell
    )
    bests, best_scores = [], []
    for _ in range(n_per_cell):
        b = torch.argmax(cells, dim=-1)  # first maximum, as jnp.argmax
        sc = torch.gather(cells, 1, b[:, None])[:, 0]
        bests.append(b)
        best_scores.append(sc)
        cells = cells.scatter(1, b[:, None], 0.0)
    best = torch.cat(bests)
    best_score = torch.cat(best_scores)

    cell_ids = torch.arange(gh * gw, device=score.device).repeat(n_per_cell)
    cy = (cell_ids // gw) * cell + best // cell
    cx = (cell_ids % gw) * cell + best % cell

    thresh = quality * torch.max(best_score)
    valid = best_score > torch.clamp(thresh, min=1e-12)

    cyc = torch.clamp(cy, 1, H - 2)
    cxc = torch.clamp(cx, 1, W - 2)
    flat = score.reshape(-1)

    def s(dy, dx):
        return flat[(cyc + dy) * W + (cxc + dx)]

    c0, xm, xp, ym, yp = s(0, 0), s(0, -1), s(0, 1), s(-1, 0), s(1, 0)
    denom_x = xm - 2.0 * c0 + xp
    denom_y = ym - 2.0 * c0 + yp
    zero = torch.zeros_like(denom_x)
    dx = torch.where(torch.abs(denom_x) > 1e-12, 0.5 * (xm - xp) / denom_x, zero)
    dy = torch.where(torch.abs(denom_y) > 1e-12, 0.5 * (ym - yp) / denom_y, zero)
    dx = torch.clamp(dx, -0.5, 0.5)
    dy = torch.clamp(dy, -0.5, 0.5)
    xy = torch.stack([cxc.to(torch.float32) + dx, cyc.to(torch.float32) + dy], dim=-1)
    return Corners(xy=xy, score=best_score, valid=valid)
