"""LightGlue-style attention matcher (port of racing_slam_tpu/models/lightglue.py).

Tokens are projected descriptors of both images; each of the L layers runs
rotary self-attention within an image and cross-attention between the
images, each followed by a GELU MLP update of the tokens; a double-softmax
assignment with per-token matchability scores the pairs, and `match` takes
mutual argmaxes above a threshold.

Every attention site goes through kernel K6 (`ops.kernels.attention`): the
CUDA kernel for CUDA tensors, its plain twin for CPU tensors.

S frame pairs (the lockstep step of S sequences) take a leading S on every
input, and K6 runs once for all S at each attention site. Each pair's
result equals its own call's to the bit: every library product, the two
log-softmaxes, GELU and the sigmoid run one pair at a time, at one pair's
shapes (`_per_pair`), on every device, and the rest of the elementwise
work over the stack. A library call's rounding may follow its batch
shape (cuBLAS picks its kernel by shape; PyTorch's CPU GELU and sigmoid
round an element by its place in their vector loop), and the port does
not rely on it for any S. One pair takes exactly the single call's
route. K6 has no
backward and raises on operands that require grad; the training losses
(`models.train`) pass `attn_backend="xla_flash"`, the JAX package's
training route (its "auto"): float32 attention in plain PyTorch, which
autograd differentiates. Weights keep
the JAX package's [in, out] orientation (``x @ W``) and its pytree layout
(`LightGlueParams`, `LayerParams`), so a JAX parameter tree converts leaf by
leaf (`utils.convert.lightglue_params_from_numpy`).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.kernels.attention import NEG, flash_mha
from ..ops.matching import FrameMatches
from . import WEIGHTS_DIR

HEADS = 4
ATTN_BACKENDS = ("kernel", "xla_flash")


class LayerParams(NamedTuple):
    self_qkv_w: torch.Tensor  # [D, 3D]
    self_out_w: torch.Tensor  # [D, D]
    self_mlp_w: torch.Tensor  # [2D, D]
    self_mlp_b: torch.Tensor  # [D]
    cross_qk_w: torch.Tensor  # [D, D]
    cross_v_w: torch.Tensor  # [D, D]
    cross_mlp_w: torch.Tensor  # [2D, D]
    cross_mlp_b: torch.Tensor  # [D]


class LightGlueParams(NamedTuple):
    in_proj_w: torch.Tensor  # [Din, D]
    layers: tuple  # of LayerParams
    match_proj_w: torch.Tensor  # [D, D]
    matchability_w: torch.Tensor  # [D, 1]
    matchability_b: torch.Tensor  # [1]


def init_params(generator: torch.Generator, in_dim: int = 256, dim: int = 256,
                n_layers: int = 4, device: str | torch.device = "cuda") -> LightGlueParams:
    """Random weights, as the JAX package's `init_params` (lightglue.py:56):
    each [a, b] matrix normal / sqrt(a), biases zero, in the same tree,
    drawn from `generator` (a CPU generator: the same seed gives the same
    weights on every device) in the JAX function's order, the layers first."""
    dev = resolve_device(device)

    def lin(a, b):
        return (torch.randn((a, b), generator=generator) / a ** 0.5).to(dev)

    def zeros(n):
        return torch.zeros((n,), device=dev)

    layers = tuple(
        LayerParams(self_qkv_w=lin(dim, 3 * dim), self_out_w=lin(dim, dim),
                    self_mlp_w=lin(2 * dim, dim), self_mlp_b=zeros(dim),
                    cross_qk_w=lin(dim, dim), cross_v_w=lin(dim, dim),
                    cross_mlp_w=lin(2 * dim, dim), cross_mlp_b=zeros(dim))
        for _ in range(n_layers))
    return LightGlueParams(in_proj_w=lin(in_dim, dim), layers=layers, match_proj_w=lin(dim, dim),
                           matchability_w=lin(dim, 1), matchability_b=zeros(1))


def _per_pair(fn, *xs: torch.Tensor) -> torch.Tensor:
    """fn of one pair's [K, ...] operands, or pair by pair over [S, K, ...]
    operands, stacked: a library call at one pair's shapes, which gives
    each pair the bits it gets alone."""
    if xs[0].dim() == 2:
        return fn(*xs)
    return torch.stack([fn(*row) for row in zip(*xs)])


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for one pair's [K, Din], or pair by pair for [S, K, Din]."""
    return _per_pair(lambda xi: xi @ w, x)


def _rotary_2d(xy: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [..., K, dim/2] of the 2-D rotary angles of normalised coords
    [..., K, 2]: dim/4 frequencies exp(linspace(0, 4)) * pi on x, the same
    on y."""
    freqs = torch.exp(torch.linspace(0.0, 4.0, dim // 4, device=xy.device)) * math.pi
    ang = torch.cat([xy[..., 0:1] * freqs, xy[..., 1:2] * freqs], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved feature pairs (0::2, 1::2) of x [..., K, H, dh]."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).reshape(x.shape)


def _ln(x: torch.Tensor) -> torch.Tensor:
    """Parameter-free LayerNorm (population variance, as jnp.var)."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + 1e-6)


def _attention_f32(q, k, v, mask_k):
    """softmax(q k^T / sqrt(dh)) v per head in float32, masked keys at the
    logit -1e9: the function of the JAX package's `_flash_mha_xla`, whose
    online softmax over key tiles only saves memory, as one dense softmax."""
    s = torch.einsum("qhd,khd->hqk", q, k) * (1.0 / math.sqrt(q.shape[-1]))
    s = torch.where(mask_k[None, None, :], s, NEG)
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)


def _mha(q, k, v, mask_q, mask_k, backend: str = "kernel"):
    """Multi-head attention, masked query rows zeroed: kernel K6 (one call
    for S pairs), or the differentiable float32 route for
    `backend="xla_flash"` (one pair)."""
    msg = flash_mha(q, k, v, mask_k) if backend == "kernel" else _attention_f32(q, k, v, mask_k)
    return torch.where(mask_q[..., None, None], msg, 0.0)


def _split_heads(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], HEADS, x.shape[-1] // HEADS)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return _per_pair(lambda t: F.gelu(t, approximate="tanh"), x)  # jax.nn.gelu's default


def _layer(p: LayerParams, t0, t1, rope0, rope1, m0, m1, backend: str = "kernel"):
    """Rotary self-attention in each image, then cross-attention both ways;
    each updates tokens by t + GELU([t_norm | LN(msg)] @ W + b)."""

    def self_attn(t, cos, sin, m):
        tn = _ln(t)
        q, k, v = torch.chunk(_mm(tn, p.self_qkv_w), 3, dim=-1)
        q = _apply_rope(_split_heads(q), cos, sin)
        k = _apply_rope(_split_heads(k), cos, sin)
        msg = _mm(_merge_heads(_mha(q, k, _split_heads(v), m, m, backend)), p.self_out_w)
        return t + _gelu(_mm(torch.cat([tn, _ln(msg)], dim=-1), p.self_mlp_w) + p.self_mlp_b)

    t0 = self_attn(t0, *rope0, m0)
    t1 = self_attn(t1, *rope1, m1)

    def cross(ta, tb, ma, mb):
        tan, tbn = _ln(ta), _ln(tb)
        qa = _split_heads(_mm(tan, p.cross_qk_w))
        kb = _split_heads(_mm(tbn, p.cross_qk_w))
        vb = _split_heads(_mm(tbn, p.cross_v_w))
        msg = _merge_heads(_mha(qa, kb, vb, ma, mb, backend))
        return ta + _gelu(_mm(torch.cat([tan, _ln(msg)], dim=-1), p.cross_mlp_w) + p.cross_mlp_b)

    return cross(t0, t1, m0, m1), cross(t1, t0, m1, m0)


def _normalise(xy: torch.Tensor, image_size: tuple[float, float]) -> torch.Tensor:
    w, h = image_size
    s = max(w, h)
    return torch.stack([(xy[..., 0] - w / 2) / s, (xy[..., 1] - h / 2) / s], dim=-1)


def _log_softmaxes(sim: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The row and the column log-softmax of one pair's [K0, K1] scores.
    The column one as a row softmax of a contiguous transpose: on the card
    the strided dim-0 softmax of [2400, 2400] took longer than all 8
    attention sites together."""
    return torch.log_softmax(sim, dim=1), torch.log_softmax(sim.T.contiguous(), dim=1).T


def assignment_scores(
    params: LightGlueParams,
    desc0: torch.Tensor,
    xy0: torch.Tensor,
    valid0: torch.Tensor,
    desc1: torch.Tensor,
    xy1: torch.Tensor,
    valid1: torch.Tensor,
    image_size: tuple[float, float],
    attn_backend: str = "kernel",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward pass -> (scores [K0, K1], matchability0 [K0], matchability1 [K1]),
    or [S, ...] each for S pairs given a leading S on every input.

    attn_backend: "kernel" (K6, inference: `match` and the pipeline) or
    "xla_flash" (float32 plain PyTorch with gradients, one pair: training)."""
    if attn_backend not in ATTN_BACKENDS:
        raise ValueError(f"attn_backend must be one of {ATTN_BACKENDS}, got {attn_backend!r}")
    if desc0.dim() == 3 and attn_backend != "kernel":
        raise ValueError("S pairs at once take attn_backend='kernel'")
    t0 = _mm(desc0, params.in_proj_w)
    t1 = _mm(desc1, params.in_proj_w)
    if params.layers:
        dh = t0.shape[-1] // HEADS
        rope0 = _rotary_2d(_normalise(xy0, image_size), dh)
        rope1 = _rotary_2d(_normalise(xy1, image_size), dh)
        for p in params.layers:
            t0, t1 = _layer(p, t0, t1, rope0, rope1, valid0, valid1, attn_backend)
        t0, t1 = _ln(t0), _ln(t1)
    z0 = _mm(t0, params.match_proj_w)
    z1 = _mm(t1, params.match_proj_w)
    sim = _per_pair(lambda a, b: a @ b.T, z0, z1) / math.sqrt(z0.shape[-1])
    sim = torch.where(valid0[..., :, None] & valid1[..., None, :], sim, -1e9)
    if sim.dim() == 2:
        s01, s10 = _log_softmaxes(sim)
    else:
        s01, s10 = _per_pair(lambda x: torch.stack(_log_softmaxes(x)), sim).unbind(1)
    m0 = _per_pair(torch.sigmoid, _mm(t0, params.matchability_w) + params.matchability_b)[..., 0]
    m1 = _per_pair(torch.sigmoid, _mm(t1, params.matchability_w) + params.matchability_b)[..., 0]
    return torch.exp(s01 + s10) * m0[..., :, None] * m1[..., None, :], m0, m1


def match(
    params: LightGlueParams,
    desc0: torch.Tensor,
    xy0: torch.Tensor,
    valid0: torch.Tensor,
    desc1: torch.Tensor,
    xy1: torch.Tensor,
    valid1: torch.Tensor,
    image_size: tuple[float, float],
    threshold: float = 0.1,
) -> FrameMatches:
    """Mutual-argmax matches above `threshold`, indexed by image-1 keypoints
    (train_idx -> image 0), like ops.matching.match_frames; for S pairs
    (a leading S on every input) each pair's, with a leading S. Ties go
    to the first index, as with jnp.argmax (an argmax's answer does not
    depend on its order of comparison, so it runs over the stack)."""
    scores, _, _ = assignment_scores(params, desc0, xy0, valid0, desc1, xy1, valid1, image_size)
    best0_for_1 = torch.argmax(scores, dim=-2)  # [..., K1]
    best1_for_0 = torch.argmax(scores, dim=-1)  # [..., K0]
    cols = torch.arange(scores.shape[-1], device=scores.device)
    if scores.dim() == 2:
        mutual = best1_for_0[best0_for_1] == cols
        sc = scores[best0_for_1, cols]
    else:
        mutual = torch.gather(best1_for_0, -1, best0_for_1) == cols
        sc = torch.gather(scores, -2, best0_for_1[..., None, :])[..., 0, :]
    return FrameMatches(train_idx=best0_for_1, distance=1.0 - sc,
                        valid=mutual & (sc > threshold) & valid1)


def default_weights(descriptor_dim: int) -> Path:
    """The committed weight file for a descriptor space, as the JAX Slam
    picks it: 128-d (classical) -> lightglue.npz, otherwise the jointly
    trained lightglue_superpoint.npz (the 256-d SuperPoint path)."""
    return WEIGHTS_DIR / ("lightglue.npz" if descriptor_dim == 128 else "lightglue_superpoint.npz")


def load_params(path, device: str | torch.device = "cuda") -> LightGlueParams:
    """Weights from a JAX-package .npz (leaves in pytree order plus in_dim,
    dim and n_layers) onto `device`."""
    from ..utils.convert import lightglue_params_from_numpy

    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(int(data["n_leaves"]))]
        dims = int(data["in_dim"]), int(data["dim"]), int(data["n_layers"])
    return lightglue_params_from_numpy(leaves, *dims, device=device)


def save_params(path, params: LightGlueParams) -> None:
    """Write the JAX package's .npz format (lightglue.py:326): n_leaves,
    in_dim, dim, n_layers and `leaf_i` in pytree order, float32; its
    `load_params` reads the file."""
    from ..utils.convert import lightglue_params_to_numpy

    leaves = lightglue_params_to_numpy(params)
    in_dim, dim = params.in_proj_w.shape
    np.savez(path, n_leaves=len(leaves), in_dim=in_dim, dim=dim, n_layers=len(params.layers),
             **{f"leaf_{i}": a for i, a in enumerate(leaves)})
