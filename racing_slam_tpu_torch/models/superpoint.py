"""SuperPoint-style keypoint detector and descriptor (port of
racing_slam_tpu/models/superpoint.py).

A VGG-style encoder (64-64-128-128, two 3x3 convs per stage, 2x2 max pool
between stages) to 1/8 resolution; a detector head giving a 65-way (8x8
cell + dustbin) distribution per cell and a descriptor head giving 256-d
descriptors per cell, sampled bilinearly at the keypoints.

Precision contract. `compute_dtype` is the JAX package's argument of the
same name (superpoint.py:82-100). None, the default and the training route,
is float32 throughout: cuDNN with TF32 off, as the package sets it at
import (`device.use_full_fp32`). `torch.bfloat16` is the inference route
(`SuperPointFrontend.extract`, superpoint.py:267-279): conv operands in
bf16, sums in float32, biases in float32; keypoint selection and
normalisation in float32. Every convolution then runs in float32 on
bf16-rounded operands (cuDNN on the card, TF32 allowed: it holds bf16
values exactly), so each layer's output is float32 and rounds to bf16
once, at the next layer's input, as in JAX. (A bf16 convolution would
round its output to bf16 before the bias as well, and that double
rounding moves keypoints by a pixel against JAX far more often.) The
heads' final 1x1 convolutions are float32 matmuls of (on the inference
route) bf16-rounded operands. They are plain convolutions, computed
outside any Pallas kernel in the JAX package too. The rounding is a cast,
which autograd passes straight through, so only the float32 route is fit
for gradients.

Gradients differ from JAX's in two rare cases. The 2x2 max pool
(`F.max_pool2d`; JAX's reshape-max, superpoint.py:103, has the same
forward) sends a window's gradient to one of its tied maxima, where JAX
splits it among them; after the ReLU a tie carries gradient only when it
is positive. And a descriptor of norm 0 has a gradient of 0 here, NaN in
JAX.

Public functions keep the JAX layouts: images [H, W], features [Hc, Wc, C],
heatmaps [H, W], descriptor maps [Hc, Wc, D]; each also takes S frames
with a leading S ([S, H, W], ...), and `SuperPointFrontend.extract` of
[S, H, W] returns Features with a leading S. Each frame's result equals
its own call's to the bit: the network (every convolution and the heads'
1x1 products) runs a frame at a time, since cuDNN picks its algorithm,
and so its order of summing, by batch shape; the softmax, the keypoint
selection, the sampling and the normalisations run over the stack
(chip_smoke.py's check_superpoint_batched holds the result to per-frame
extraction on the card). Parameters keep the JAX
pytree's fields, with convolution kernels in PyTorch's OIHW layout
(`utils.convert.superpoint_params_from_numpy` converts from HWIO).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.image import bilinear_sample
from ..slam.state import Features

ENCODER_CHANNELS = (64, 64, 128, 128)
DESC_DIM = 256
CELL = 8  # detection cell (fixed by the 65-way head)


class SuperPointParams(NamedTuple):
    conv_w: tuple  # encoder kernels, OIHW
    conv_b: tuple
    det_w: tuple  # detector head: 3x3 then 1x1
    det_b: tuple
    desc_w: tuple  # descriptor head: 3x3 then 1x1
    desc_b: tuple


def init_params(generator: torch.Generator, desc_dim: int = DESC_DIM,
                device: str | torch.device = "cuda") -> SuperPointParams:
    """Random weights, as the JAX package's `init_params` (superpoint.py:47):
    He-normal kernels, std sqrt(2 / (k * k * cin)), and zero biases, in the
    same tree and leaf order, drawn from `generator` (a CPU generator: the
    same seed gives the same weights on every device) in the order the
    layers run: the 8 encoder convs, then the detector and descriptor
    heads' 3x3 and 1x1 convs. Kernels are OIHW."""
    dev = resolve_device(device)

    def conv(cin, cout, k=3):
        w = torch.randn((cout, cin, k, k), generator=generator) * (2.0 / (k * k * cin)) ** 0.5
        return w.to(dev), torch.zeros((cout,), device=dev)

    encoder, cin = [], 1
    for cout in ENCODER_CHANNELS:
        for _ in range(2):
            encoder.append(conv(cin, cout))
            cin = cout
    det = [conv(cin, 256), conv(256, 65, k=1)]
    desc = [conv(cin, 256), conv(256, desc_dim, k=1)]
    return SuperPointParams(
        conv_w=tuple(w for w, _ in encoder), conv_b=tuple(b for _, b in encoder),
        det_w=tuple(w for w, _ in det), det_b=tuple(b for _, b in det),
        desc_w=tuple(w for w, _ in desc), desc_b=tuple(b for _, b in desc))


def _round(t: torch.Tensor, compute_dtype) -> torch.Tensor:
    """float32 tensor holding the `compute_dtype` rounding of `t` (None: `t`)."""
    return t if compute_dtype is None else t.to(compute_dtype).to(torch.float32)


def _conv3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """SAME 3x3 conv of [1, C, H, W] with float32 sums and bias and float32
    output, on `compute_dtype`-rounded operands. A product of two bf16
    values is exact in TF32 as in float32, so on the bf16 route cuDNN may
    take its TF32 tensor-core path; the float32 route keeps TF32 off. The
    cuDNN switches are process-wide: these are the port's only cuDNN
    convolutions, and its frame-prefetch thread runs none."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=compute_dtype is not None):
        return F.conv2d(_round(x, compute_dtype), _round(w, compute_dtype), b, padding=1)


def _conv1(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """1x1 conv of [1, C, Hc, Wc] -> [Hc, Wc, Cout] as a float32 matmul of
    `compute_dtype`-rounded operands (float32 output, as the JAX conv)."""
    xt = _round(x[0], compute_dtype).permute(1, 2, 0)  # [Hc, Wc, C]
    return xt @ _round(w[:, :, 0, 0], compute_dtype).T + b


def _per_frame(fn, x: torch.Tensor):
    """fn on each frame of a leading-S stack, stacked (tuples field by
    field): the network at one frame's shapes."""
    outs = [fn(xi) for xi in x]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def backbone(params: SuperPointParams, img: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """[H, W] grayscale -> [H/8, W/8, 128] features ([S, ...] for S frames,
    a frame at a time)."""
    if img.dim() == 3:
        return _per_frame(lambda im: backbone(params, im, compute_dtype), img)
    x = img[None, None].to(torch.float32)
    i = 0
    for stage in range(len(ENCODER_CHANNELS)):
        for _ in range(2):
            x = torch.relu(_conv3(x, params.conv_w[i], params.conv_b[i], compute_dtype))
            i += 1
        if stage < len(ENCODER_CHANNELS) - 1:
            x = F.max_pool2d(x, 2)  # floors odd sizes, as the JAX reshape pool
    return x[0].permute(1, 2, 0)


def heads_logits(params: SuperPointParams, feat: torch.Tensor, compute_dtype=None):
    """[Hc, Wc, C] features -> (detector logits [Hc, Wc, 65], unit-norm dense
    descriptors [Hc, Wc, D]), both float32 ([S, ...] for S frames, a frame
    at a time). The logits are the training surface (a cell-wise
    cross-entropy against corner labels)."""
    if feat.dim() == 4:
        return _per_frame(lambda f: heads_logits(params, f, compute_dtype), feat)
    x = feat.permute(2, 0, 1)[None]
    d = torch.relu(_conv3(x, params.det_w[0], params.det_b[0], compute_dtype))
    logits = _conv1(d, params.det_w[1], params.det_b[1], compute_dtype)
    e = torch.relu(_conv3(x, params.desc_w[0], params.desc_b[0], compute_dtype))
    desc = _conv1(e, params.desc_w[1], params.desc_b[1], compute_dtype)
    return logits, desc / (torch.linalg.norm(desc, dim=-1, keepdim=True) + 1e-8)


def heads(params: SuperPointParams, feat: torch.Tensor, compute_dtype=None):
    """-> (heatmap [H, W], dense descriptors [Hc, Wc, D]), or [S, ...] each."""
    logits, desc = heads_logits(params, feat, compute_dtype)
    prob = torch.softmax(logits, dim=-1)[..., :64]  # drop the dustbin
    if prob.dim() == 3:
        return F.pixel_shuffle(prob.permute(2, 0, 1)[None], CELL)[0, 0], desc
    return F.pixel_shuffle(prob.permute(0, 3, 1, 2), CELL)[:, 0], desc


def select_keypoints(
    heat: torch.Tensor,
    mask: torch.Tensor | None,
    cell: int,
    n_per_cell: int,
    threshold: float,
    border: int = 4,
):
    """Grid-cell argmax selection on the heatmap (static K), then a
    parabola sub-pixel fit. Returns (xy [K, 2], score [K], valid [K]), or
    [S, K, ...] each for an [S, H, W] stack (argmaxes, gathers and
    elementwise work: each frame's answer is its own call's)."""
    H, W = heat.shape[-2:]
    lead = heat.shape[:-2]
    dev = heat.device
    score = heat
    if mask is not None:
        score = torch.where(mask > 0, score, 0.0)
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    inb = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    score = torch.where(inb, score, 0.0)

    gh, gw = -(-H // cell), -(-W // cell)
    padded = F.pad(score, (0, gw * cell - W, 0, gh * cell - H))
    cells = padded.reshape(*lead, gh, cell, gw, cell).transpose(-3, -2).reshape(
        *lead, gh * gw, cell * cell)
    rows = torch.arange(gh * gw, device=dev)
    bests, scores = [], []
    for _ in range(n_per_cell):
        b = torch.argmax(cells, dim=-1)
        bests.append(b)
        if lead:
            scores.append(torch.gather(cells, -1, b[..., None])[..., 0])
            cells = cells.scatter(-1, b[..., None], 0.0)
        else:
            scores.append(cells[rows, b])
            cells = cells.index_put((rows, b), torch.zeros((), device=dev))
    best = torch.cat(bests, dim=-1)
    sc = torch.cat(scores, dim=-1)
    cell_ids = rows.repeat(n_per_cell)
    cy = (cell_ids // gw) * cell + best // cell
    cx = (cell_ids % gw) * cell + best % cell

    cyc = torch.clamp(cy, 1, H - 2)
    cxc = torch.clamp(cx, 1, W - 2)
    frame = torch.arange(lead[0], device=dev)[:, None] if lead else None

    def s(dy, dx):
        return heat[cyc + dy, cxc + dx] if frame is None else heat[frame, cyc + dy, cxc + dx]

    denom_x = s(0, -1) - 2.0 * s(0, 0) + s(0, 1)
    denom_y = s(-1, 0) - 2.0 * s(0, 0) + s(1, 0)
    dx = torch.where(torch.abs(denom_x) > 1e-12, 0.5 * (s(0, -1) - s(0, 1)) / denom_x, 0.0)
    dy = torch.where(torch.abs(denom_y) > 1e-12, 0.5 * (s(-1, 0) - s(1, 0)) / denom_y, 0.0)
    dx = torch.clamp(dx, -0.5, 0.5)
    dy = torch.clamp(dy, -0.5, 0.5)
    xy = torch.stack([cxc.to(torch.float32) + dx, cyc.to(torch.float32) + dy], dim=-1)
    return xy, sc, sc > threshold


def sample_descriptors(desc_map: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear descriptor sampling at pixel coords: [Hc, Wc, D], [K, 2] -> [K, D]
    (or [S, ...] each: sampled a frame at a time, normalised over the stack)."""
    if desc_map.dim() == 4:
        out = torch.stack([bilinear_sample(d, c / CELL - 0.5) for d, c in zip(desc_map, xy)])
    else:
        out = bilinear_sample(desc_map, xy / CELL - 0.5)
    return out / (torch.linalg.norm(out, dim=-1, keepdim=True) + 1e-8)


class SuperPointFrontend:
    """Learned frontend behind the same interface as ClassicalFrontend.

    `params` (from `load_params`; None draws random weights from
    `init_params` with `seed`, as the JAX frontend does) are placed on
    `device`, the card unless the caller asks for the CPU; the convolution
    kernels are kept in bf16 (their inference rounding) so that a frame
    converts each only once. max_distance is the reference deep path's L2
    gate (0.7)."""

    def __init__(
        self,
        params: SuperPointParams | None = None,
        cell: int = 16,
        n_per_cell: int = 2,
        threshold: float = 0.0005,
        max_distance: float = 0.7,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        from ..slam.frontend import ClassicalMatcher

        self.device = resolve_device(device)
        if params is None:
            params = init_params(torch.Generator().manual_seed(seed), device=self.device)
        self.params = SuperPointParams(*[
            tuple(w.to(self.device, torch.bfloat16) if w.dim() == 4 else w.to(self.device)
                  for w in group)
            for group in params
        ])
        self.descriptor_dim = params.desc_w[1].shape[0]
        self.cell = cell
        self.n_per_cell = n_per_cell
        self.threshold = threshold
        self.max_distance = max_distance
        # Frame<->frame matcher slot; Slam puts a LightGlueMatcher here when
        # cfg.matcher == "lightglue".
        self.matcher = ClassicalMatcher(max_distance)

    def num_keypoints(self, height: int, width: int) -> int:
        return self.n_per_cell * (-(-height // self.cell)) * (-(-width // self.cell))

    def extract(self, img: torch.Tensor, mask: torch.Tensor | None = None) -> Features:
        """Features of one float32 [H, W] frame, or of S frames [S, H, W]
        (Features with a leading S, each frame's equal to its own call's);
        `mask` [H, W], nonzero = allowed."""
        bf16 = torch.bfloat16
        heat, desc_map = heads(self.params, backbone(self.params, img, bf16), bf16)
        xy, score, valid = select_keypoints(heat, mask, self.cell, self.n_per_cell,
                                            self.threshold)
        return Features(xy=xy, desc=sample_descriptors(desc_map, xy), valid=valid, score=score)


def load_params(path, device: str | torch.device = "cuda") -> SuperPointParams:
    """Weights from a JAX-package .npz (24 leaves in pytree order) onto `device`."""
    from ..utils.convert import superpoint_params_from_numpy

    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    return superpoint_params_from_numpy(leaves, device=device)


def save_params(path, params: SuperPointParams) -> None:
    """Write the JAX package's .npz format (superpoint.py:282): `leaf_i` in
    pytree order, float32, kernels HWIO; its `load_params` reads the file."""
    from ..utils.convert import superpoint_params_to_numpy

    np.savez(path, **{f"leaf_{i}": a for i, a in enumerate(superpoint_params_to_numpy(params))})
