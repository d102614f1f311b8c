"""Image primitives (port of racing_slam_tpu/ops/image.py).

Images are float32 [..., H, W]. The separable 'same' convolutions use zero
padding and the same shift-and-add tap order as the JAX package, so the
plain versions here agree with it to float32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _conv2d(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """'same' convolution of [..., H, W] with a [kh, kw] kernel, zero padded."""
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    H, W = img.shape[-2:]
    padded = F.pad(img, (pw, kw - 1 - pw, ph, kh - 1 - ph))
    out = torch.zeros_like(img)
    for dy in range(kh):
        for dx in range(kw):
            k = float(kernel[kh - 1 - dy, kw - 1 - dx])  # conv = correlate(flipped)
            out = out + k * padded[..., dy : dy + H, dx : dx + W]
    return out


def _sep_conv(img: torch.Tensor, krow: np.ndarray, kcol: np.ndarray) -> torch.Tensor:
    """Separable 'same' conv: 1-D kernel along W (krow) then along H (kcol)."""
    krow = np.asarray(krow, np.float32)
    kcol = np.asarray(kcol, np.float32)
    tmp = _conv2d(img, krow[None, :])
    return _conv2d(tmp, kcol[:, None])


def sobel_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Ix, Iy via separable 3x3 Sobel: smooth [1,2,1] x diff [-1,0,1]."""
    smooth = np.array([1.0, 2.0, 1.0], np.float32)
    diff = np.array([-1.0, 0.0, 1.0], np.float32)
    return _sep_conv(img, diff, smooth), _sep_conv(img, smooth, diff)


def box_filter(img: torch.Tensor, size: int) -> torch.Tensor:
    """size x size box sum (not mean)."""
    k = np.ones((size,), np.float32)
    return _sep_conv(img, k, k)


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = int(3.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    k = gaussian_kernel1d(sigma)
    return _sep_conv(img, k, k)


def max_pool_same(img: torch.Tensor, size: int) -> torch.Tensor:
    """size x size max filter, 'same', -inf padding (for NMS)."""
    H, W = img.shape[-2:]
    p = size // 2

    def pool_rows(x):  # along W
        padded = F.pad(x, (p, size - 1 - p), value=-float("inf"))
        out = padded[..., :, 0:W]
        for d in range(1, size):
            out = torch.maximum(out, padded[..., :, d : d + W])
        return out

    def pool_cols(x):  # along H
        padded = F.pad(x, (0, 0, p, size - 1 - p), value=-float("inf"))
        out = padded[..., 0:H, :]
        for d in range(1, size):
            out = torch.maximum(out, padded[..., d : d + H, :])
        return out

    return pool_cols(pool_rows(img))


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample [H, W] image at continuous (x, y) [..., 2]; coords clamped."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.long()
    y0i = y0.long()
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=H - 1)
    flat = img.reshape(-1)

    def g(yy, xx):
        return flat[yy * W + xx]

    return (
        g(y0i, x0i) * (1 - fx) * (1 - fy)
        + g(y0i, x1i) * fx * (1 - fy)
        + g(y1i, x0i) * (1 - fx) * fy
        + g(y1i, x1i) * fx * fy
    )
