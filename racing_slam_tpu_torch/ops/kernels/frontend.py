"""Kernel K1: the classical frontend's fused image stack.

Replaces racing_slam_tpu/ops/pallas/frontend_kernel.py:corner_frontend_fused.
Source: racing_slam_tpu_torch/csrc/frontend_kernel.cu.

What it computes, per frame: the sigma=1.2 pre-blur, Sobel, 3x3 structure
tensor box sums, Shi-Tomasi min eigenvalue, border and mask gating, and 15x15
NMS peaks; plus an independent sigma=2 descriptor blur. Zero padding outside
the frame, as the plain stack (ops/image.py).

What bounds it on an H100: at 640x480 the whole stack is ~120 flops and
~16 bytes of frame traffic per pixel (~35 MFLOP, ~5 MB), microseconds at
the card's peaks, so neither flops nor bandwidth bound it; the plain stack
pays instead for ~35 separate passes, each a launch and a round trip of a
full-frame intermediate through device memory. The kernel makes one pass:
each 32x32 output tile gets one block that stages its 13 px halo in shared
memory and keeps every intermediate there, writing only the three output
maps. What is left is latency: six barrier-separated phases in 300 small
blocks, and a 3.3x recompute of the halo region.
"""

from __future__ import annotations

import numpy as np
import torch

from ..corners import gated_response_maps
from ..image import gaussian_blur, gaussian_kernel1d
from . import _build

launches = 0


def corner_frontend_fused_reference(
    img: torch.Tensor,
    mask: torch.Tensor | None = None,
    pre_blur_sigma: float = 1.2,
    desc_blur_sigma: float = 2.0,
    nms_radius: int = 7,
    border: int = 8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-PyTorch twin: (gated response, NMS peaks, descriptor blur)."""
    score, peaks = gated_response_maps(
        img, mask, border=border, nms_radius=nms_radius, pre_blur_sigma=pre_blur_sigma
    )
    return score, peaks, gaussian_blur(img, desc_blur_sigma)


def corner_frontend_fused(
    img: torch.Tensor,
    mask: torch.Tensor | None = None,
    pre_blur_sigma: float = 1.2,
    desc_blur_sigma: float = 2.0,
    nms_radius: int = 7,
    border: int = 8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gated response, NMS peaks, descriptor blur) of [H, W] or [B, H, W]
    float32 frames; `mask` is [H, W] float32, nonzero = detection allowed."""
    if _build.device_kind(img, mask) == "cpu":
        return corner_frontend_fused_reference(
            img, mask, pre_blur_sigma, desc_blur_sigma, nms_radius, border
        )
    k1 = gaussian_kernel1d(pre_blur_sigma).astype(np.float32)
    k2 = gaussian_kernel1d(desc_blur_sigma).astype(np.float32)
    if nms_radius != 7 or len(k1) != 9 or len(k2) != 13:
        raise ValueError("the CUDA frontend is built for radii 4 / 6 and NMS radius 7")
    single = img.dim() == 2
    frames = img[None] if single else img
    if frames.dim() != 3:
        raise ValueError(f"img: expected [H, W] or [B, H, W], got {tuple(img.shape)}")
    B, H, W = frames.shape
    _build.expect(frames, "img", torch.float32, (B, H, W))
    if mask is not None:
        _build.expect(mask, "mask", torch.float32, (H, W))
    resp = torch.empty_like(frames)
    peaks = torch.empty_like(frames)
    blur2 = torch.empty_like(frames)
    err = _build.lib().slam_frontend(
        _build.ptr(frames), _build.ptr(mask), _build.ptr(resp), _build.ptr(peaks),
        _build.ptr(blur2), B, H, W, k1.ctypes.data, 4, k2.ctypes.data, 6, border,
        _build.stream(frames.device),
    )
    _build.check(err, "corner_frontend_fused")
    global launches
    launches += 1
    if single:
        return resp[0], peaks[0], blur2[0]
    return resp, peaks, blur2
