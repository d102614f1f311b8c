"""Patch descriptors (port of racing_slam_tpu/ops/descriptors.py).

A sigma=2 blurred 16x16 patch at 1.5 px spacing around each keypoint,
mean/variance normalised, projected to 128-d by a fixed seeded orthonormal
matrix and L2 normalised. The projection is built by the same numpy code as
the JAX package (seed 1234 QR), so the two are bit-identical; it is the
classical path's only fixed weight.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .image import gaussian_blur

PATCH_SIZE = 16
PATCH_SPACING = 1.5
DESCRIPTOR_DIM = 128
BLUR_SIGMA = 2.0
MAX_DISTANCE = 0.8
# Margin of the static per-cell window: a keypoint sits anywhere in its cell
# and its sampling grid spans +-11.25 px (+1 for bilinear).
CELL_MARGIN = 16


def _projection_matrix() -> np.ndarray:
    """Fixed random orthonormal [S^2, D] projection (seeded, reproducible)."""
    rng = np.random.default_rng(1234)
    A = rng.standard_normal((PATCH_SIZE * PATCH_SIZE, PATCH_SIZE * PATCH_SIZE))
    Q, _ = np.linalg.qr(A)
    return Q[:, :DESCRIPTOR_DIM].astype(np.float32)


_PROJ = _projection_matrix()


@functools.lru_cache(maxsize=None)
def _proj_on(device: torch.device) -> torch.Tensor:
    """The projection on `device`, copied there once."""
    return torch.from_numpy(_PROJ).to(device)


def _finalize(patches_flat: torch.Tensor) -> torch.Tensor:
    """Normalise flat patches and project to D: [..., S^2] -> [..., D] unit."""
    mean = torch.mean(patches_flat, dim=-1, keepdim=True)
    std = torch.std(patches_flat, dim=-1, keepdim=True, unbiased=False) + 1e-6
    normed = (patches_flat - mean) / std
    desc = normed @ _proj_on(patches_flat.device)
    return desc / (torch.linalg.norm(desc, dim=-1, keepdim=True) + 1e-8)


# Side of the window cut around each keypoint by extract_descriptors: the
# sampling support (PATCH_SIZE * PATCH_SPACING = 24 px) + 1 px for bilinear.
PATCH_T = 32


def extract_descriptors(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Descriptors for keypoints anywhere in the frame (the gather form).

    img: [H, W] float32, unblurred; xy: [K, 2] pixel coordinates. One
    [T, T] window of the blurred image is gathered per keypoint, and the
    sampling grid is two bilinear-interpolation matmuls over it. Returns
    [K, D] unit descriptors. The frontend uses extract_descriptors_cells,
    which cuts the windows of grid-ordered keypoints by strided views.
    """
    H, W = img.shape
    S, T = PATCH_SIZE, PATCH_T
    blurred = gaussian_blur(img, BLUR_SIGMA)
    dev = img.device
    lin = (torch.arange(S, device=dev, dtype=torch.float32) - (S - 1) / 2.0) * PATCH_SPACING
    x = torch.clamp(xy[:, 0], 0.0, W - 1.001)
    y = torch.clamp(xy[:, 1], 0.0, H - 1.001)
    ox = torch.clamp(torch.floor(x).long() - T // 2 + 1, 0, W - T)
    oy = torch.clamp(torch.floor(y).long() - T // 2 + 1, 0, H - T)
    span = torch.arange(T, device=dev)
    patches = blurred[(oy[:, None] + span)[:, :, None], (ox[:, None] + span)[:, None, :]]

    def interp(coord, origin):
        """[K, S, T] bilinear weights of the S samples over the window."""
        s = coord[:, None] + lin[None, :] - origin[:, None].to(torch.float32)
        s = torch.clamp(s, 0.0, T - 1.001)
        s0 = torch.floor(s)
        f = (s - s0)[..., None]
        s0i = s0.long()[..., None]
        return (span == s0i) * (1.0 - f) + (span == s0i + 1) * f

    rows = interp(y, oy) @ patches  # [K, S, T]
    sampled = rows @ interp(x, ox).transpose(-1, -2)  # [K, S(y), S(x)]
    return _finalize(sampled.reshape(xy.shape[0], S * S))


def extract_descriptors_cells(
    img: torch.Tensor,
    xy: torch.Tensor,
    cell: int,
    n_per_cell: int,
    blurred: torch.Tensor | None = None,
) -> torch.Tensor:
    """Descriptors for grid-ordered keypoints of a frame batch.

    img: [B, H, W] (or one [H, W] frame); xy: [B, K, 2] (or [K, 2]) in
    detect_corners' layout, K = n_per_cell * gh * gw with keypoint i in cell
    i % (gh * gw). Each cell's (cell + 2*margin)^2 window is cut from the
    edge-padded blurred image by static strided views; the per-keypoint work
    is two separable bilinear-interpolation matmuls. `blurred` skips the
    internal sigma-2 blur when the caller already has it (kernel K1 makes it).
    Returns [B, K, D] (or [K, D]). The windows and the interpolation
    weights are cut for the whole batch by elementwise ops; the matrix
    products and the normalisation run frame by frame, at one frame's
    shapes, so that a frame gets the bits it gets alone (on the card, a
    library product's rounding follows its batch shape).
    """
    single = img.dim() == 2
    if single:
        img, xy = img[None], xy[None]
        blurred = None if blurred is None else blurred[None]
    B, H, W = img.shape
    S = PATCH_SIZE
    M = CELL_MARGIN
    if M > cell:
        raise ValueError("CELL_MARGIN must fit in one neighbouring cell")
    T = cell + 2 * M
    if blurred is None:
        blurred = gaussian_blur(img, BLUR_SIGMA)
    gh = -(-H // cell)
    gw = -(-W // cell)
    K = xy.shape[1]
    if K != n_per_cell * gh * gw:
        raise ValueError("xy must be grid-ordered")
    Hp, Wp = gh * cell, gw * cell
    padded = F.pad(
        blurred, (M, Wp - W + M + cell, M, Hp - H + M + cell), mode="replicate"
    )

    # Window rows [0, T) = chunks [0, M), [M, M+cell), [M+cell, T); for a
    # fixed chunk the rows of all windows form one strided view.
    chunks = [(0, M), (M, cell), (M + cell, M)]
    rows_built = []
    for rs, rn in chunks:
        cols_built = []
        for cs, cn in chunks:
            block = padded[:, rs : rs + gh * cell, cs : cs + gw * cell]
            block = block.reshape(B, gh, cell, gw, cell)[:, :, :rn, :, :cn]
            cols_built.append(block)
        rows_built.append(torch.cat(cols_built, dim=-1))  # [B, gh, rn, gw, T]
    windows = torch.cat(rows_built, dim=2)  # [B, gh, T, gw, T]
    windows = windows.permute(0, 1, 3, 2, 4).reshape(B, gh * gw, T, T)

    # Sampling offsets and cell origins, made on the device (all exact).
    dev = img.device
    lin = (torch.arange(S, device=dev, dtype=torch.float32) - (S - 1) / 2.0) * PATCH_SPACING
    C = gh * gw
    ids = torch.arange(C, device=dev)
    origin_x = ((ids % gw) * cell - M).to(torch.float32)
    origin_y = ((ids // gw) * cell - M).to(torch.float32)
    cols = torch.arange(T, device=dev)

    def interp(coord, origin):
        """[B, C] coord, [C] window origin -> [B, C, S, T] bilinear weights."""
        s = coord[..., None] + lin - origin[:, None]
        s = torch.clamp(s, 0.0, T - 1.001)
        s0 = torch.floor(s)
        f = (s - s0)[..., None]
        s0i = s0.long()[..., None]
        return (cols == s0i) * (1.0 - f) + (cols == s0i + 1) * f

    # [B, C, S, T] row and [B, C, T, S] column weights of each keypoint group.
    weights = [(interp(xy[:, g * C : (g + 1) * C, 1], origin_y),
                interp(xy[:, g * C : (g + 1) * C, 0], origin_x).transpose(-1, -2))
               for g in range(n_per_cell)]
    desc = torch.stack([
        _finalize(torch.cat([(Ry[b] @ windows[b] @ Cx[b]).reshape(C, S * S)  # [C, S(y) S(x)]
                             for Ry, Cx in weights]))
        for b in range(B)])
    return desc[0] if single else desc
