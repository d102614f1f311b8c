"""Self-supervised training of the learned frontend, no external data (port of
racing_slam_tpu/models/train.py).

Both networks train from scratch on supervision synthesized from a seed:

- SuperPoint: homography-warped pairs of procedural textures and sprite
  renders. The detector head learns a cell-wise 65-way cross-entropy
  against the classical Shi-Tomasi detector's peaks (the MagicPoint
  stage with the classical detector as the corner oracle); the
  descriptor head an InfoNCE loss over the homography's correspondences,
  with hard negatives from the warped image.
- LightGlue: the negative log-likelihood of the ground-truth assignment
  under the partial-assignment scores, on synthetic descriptor clouds
  (`train_lightglue`) or on a real frontend's features of homography pairs
  (`train_lightglue_on_frontend`: the weights the pipeline loads).

The host code (homographies, warps, photometric jitter, the image pool,
correspondence sites) is the JAX package's numpy code and draws from the
numpy Generator in the same order. The networks train in float32 with
autograd: SuperPoint on its float32 route (`compute_dtype=None`),
LightGlue's attention on `attn_backend="xla_flash"`, as the JAX package
trains. The classical frontend of the LightGlue pairs runs kernel K1 on
the card, and the evaluators' `lightglue.match` kernel K6 (forward only).
The optimizer is Adam (0.9 / 0.999, eps 1e-8, as `optax.adam`), for
SuperPoint on a cosine decay to 2 % stepped after each update, so that the
first update uses count 0, as optax does. Each trainer reads its loss to
the host only at `log_every`.

Every trainer runs on `device`, the card unless the caller asks for the
CPU; an evaluator on the device of the parameters it is given. Run:
python -m racing_slam_tpu_torch.models.train --steps 500 --out weights/
(``--cpu`` for the CPU); the weight files are the JAX package's format.
"""

from __future__ import annotations

import argparse
import math
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..ops.corners import shi_tomasi_response
from ..ops.image import max_pool_same
from ..slam.state import tree_map
from ..utils.convert import tree_leaves
from ..utils.synthetic import random_texture
from . import lightglue, superpoint

# ---------------------------------------------------------------------------
# Homography pair generation (host side)
# ---------------------------------------------------------------------------


def random_homography(rng: np.random.Generator, h: int, w: int, mag=0.15):
    """Random perspective warp mapping image 0 coords -> image 1 coords."""
    src = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
    jitter = rng.uniform(-mag, mag, (4, 2)).astype(np.float32) * [w, h]
    dst = src + jitter
    # DLT for the 3x3 homography.
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    _, _, Vt = np.linalg.svd(np.asarray(A, np.float64))
    H = Vt[-1].reshape(3, 3)
    return (H / H[2, 2]).astype(np.float32)


def warp_image(img: np.ndarray, H: np.ndarray) -> np.ndarray:
    """Inverse-warp img through H (output pixel <- H^-1 @ pixel)."""
    h, w = img.shape
    Hi = np.linalg.inv(H)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    ones = np.ones_like(xs)
    pts = np.stack([xs, ys, ones], -1).reshape(-1, 3) @ Hi.T
    uv = pts[:, :2] / pts[:, 2:3]
    x = np.clip(uv[:, 0], 0, w - 1.001)
    y = np.clip(uv[:, 1], 0, h - 1.001)
    x0, y0 = x.astype(np.int32), y.astype(np.int32)
    fx, fy = x - x0, y - y0
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    out = (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x1] * fx * (1 - fy)
        + img[y1, x0] * (1 - fx) * fy
        + img[y1, x1] * fx * fy
    )
    return out.reshape(h, w).astype(np.float32)


def apply_h(H: np.ndarray, xy: np.ndarray) -> np.ndarray:
    p = np.concatenate([xy, np.ones_like(xy[:, :1])], -1) @ H.T
    return p[:, :2] / p[:, 2:3]


def _f32(a, device) -> torch.Tensor:
    """A host array as a float32 tensor on `device` (numpy promotes the
    pipeline's clipped coordinates to float64; JAX reads them as float32)."""
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


# ---------------------------------------------------------------------------
# Optimisation
# ---------------------------------------------------------------------------


def _trainable(params):
    return tree_map(lambda t: t.detach().to(torch.float32).requires_grad_(True), params)


def _frozen(params):
    return tree_map(lambda t: t.detach(), params)


def _cosine_decay(count: int, decay_steps: int, alpha: float = 0.02) -> float:
    """optax.cosine_decay_schedule's factor of the initial rate at `count`."""
    c = min(count, decay_steps)
    return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps)) + alpha


def _adam(params, lr: float, decay_steps: int | None = None):
    """Adam over a parameter tree (optax.adam's constants) and, with
    `decay_steps`, optax's cosine decay as a LambdaLR: its count is 0 at
    the first update, and `_step` advances it after each update."""
    opt = torch.optim.Adam(list(tree_leaves(params)), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    sched = None
    if decay_steps is not None:
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda c: _cosine_decay(c, decay_steps))
    return opt, sched


def _step(opt, sched, loss: torch.Tensor) -> None:
    """One update from `loss`."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    if sched is not None:
        sched.step()


def _log_loss(stats: dict | None, name: str, i: int, loss: torch.Tensor) -> None:
    """Reads the loss to the host (a step's only read), prints it and, with
    `stats`, appends it to stats["losses"]."""
    value = loss.item()
    print(f"{name} step {i}: loss {value:.4f}", flush=True)
    if stats is not None:
        stats.setdefault("losses", []).append(value)


def _log_rate(stats: dict | None, name: str, steps: int, t0: float,
              device: torch.device) -> None:
    """Prints the steps a second since `t0` and, with `stats`, keeps them
    as stats["steps_per_s"]."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    rate = steps / max(dt, 1e-9)
    print(f"{name}: {steps} steps in {dt:.3f} s, {rate:.3f} steps/s", flush=True)
    if stats is not None:
        stats["steps_per_s"] = rate


# ---------------------------------------------------------------------------
# SuperPoint training
# ---------------------------------------------------------------------------


def _detector_labels(img: torch.Tensor, nms: int = 4, quality: float = 0.01) -> torch.Tensor:
    """Cell-wise 65-way corner labels [H/8, W/8] from the classical detector:
    per 8x8 cell, the flat index of the strongest NMS'd Shi-Tomasi peak, or
    64 (dustbin) for a cell with no peak. Ties go to the first index, as in
    JAX; a near-tie can still flip with the float order of the response."""
    score = shi_tomasi_response(img)
    is_peak = score >= max_pool_same(score, 2 * nms + 1)
    peak = torch.where(is_peak & (score > quality * torch.max(score)), score, 0.0)
    H, W = img.shape
    C = superpoint.CELL
    Hc, Wc = H // C, W // C
    cells = (peak[: Hc * C, : Wc * C].reshape(Hc, C, Wc, C).permute(0, 2, 1, 3)
             .reshape(Hc, Wc, C * C))
    best = torch.argmax(cells, dim=-1)
    has = torch.amax(cells, dim=-1) > 0.0
    return torch.where(has, best, C * C)


def superpoint_loss(params, img0, img1, xy0, xy1, corr_valid, xy_neg, compute_dtype=None):
    """Detector cell cross-entropy (both images) + descriptor InfoNCE across
    the homography correspondence (xy0[i] <-> xy1[i]), in float32.

    xy_neg [M, 2]: extra distractor sites in image 1 (corners that are not
    the correspondence of any xy0): hard negatives from the same image force
    local distinctiveness, which mutual-1NN and LightGlue scoring need.
    `compute_dtype`: the network's (None, float32, trains as the JAX
    package does; torch.bfloat16 is the inference rounding, whose
    gradients pass the casts straight through)."""
    lg0, dmap0 = superpoint.heads_logits(
        params, superpoint.backbone(params, img0, compute_dtype), compute_dtype)
    lg1, dmap1 = superpoint.heads_logits(
        params, superpoint.backbone(params, img1, compute_dtype), compute_dtype)

    def det_ce(logits, img):
        labels = _detector_labels(img)
        lp = torch.log_softmax(logits, dim=-1)
        return -torch.mean(torch.gather(lp, -1, labels[..., None]))

    det_loss = det_ce(lg0, img0) + det_ce(lg1, img1)

    d0 = superpoint.sample_descriptors(dmap0, xy0)  # [N, D]
    d1 = superpoint.sample_descriptors(dmap1, xy1)
    dn = superpoint.sample_descriptors(dmap1, xy_neg)  # [M, D] distractors
    sim = (d0 @ torch.cat([d1, dn], dim=0).T) * 10.0  # [N, N+M]
    n = d0.shape[0]
    idx = torch.arange(n, device=sim.device)
    ce = -torch.log_softmax(sim, dim=1)[idx, idx]
    ce_t = -torch.log_softmax(sim[:, :n], dim=0)[idx, idx]
    desc_loss = torch.sum(torch.where(corr_valid, ce + ce_t, 0.0)) / (torch.sum(corr_valid) + 1e-6)
    return det_loss + desc_loss


def _corner_correspondences(img0, rng, n_corr, h, w, device):
    """Correspondence sample sites at classical-detector corners of img0
    (uniform sites land mostly on featureless background in the sprite half
    of the training images), filled with uniform sites when an image has
    few corners, plus sub-pixel jitter. The count of corners with a positive
    response sets how many numbers the shuffle draws."""
    score = shi_tomasi_response(torch.as_tensor(img0, device=device)).cpu().numpy()
    score[:8, :] = score[-8:, :] = 0.0
    score[:, :8] = score[:, -8:] = 0.0
    flat = np.argpartition(score.ravel(), -4 * n_corr)[-4 * n_corr:]
    flat = flat[score.ravel()[flat] > 0.0]
    rng.shuffle(flat)
    ys, xs = np.unravel_index(flat[:n_corr], score.shape)
    xy = np.stack([xs, ys], -1).astype(np.float32)
    if len(xy) < n_corr:
        pad = rng.uniform([8, 8], [w - 8, h - 8], (n_corr - len(xy), 2)).astype(np.float32)
        xy = np.concatenate([xy, pad], axis=0)
    return xy + rng.uniform(-0.5, 0.5, xy.shape).astype(np.float32)


def _photometric(img, rng):
    """Gain/bias/noise jitter: the pipeline matches across exposure drift
    and sensor noise that clean warps never show."""
    g = rng.uniform(0.7, 1.3)
    b = rng.uniform(-0.1, 0.1)
    n = rng.normal(0.0, rng.uniform(0.0, 0.03), img.shape)
    return np.clip(img * g + b + n, 0.0, 1.0).astype(np.float32)


def _superpoint_batch(rng, pool, h: int, w: int, n_corr: int, device) -> tuple:
    """One SuperPoint training example, the arguments of `superpoint_loss`
    after the parameters, drawn as the JAX trainer draws them."""
    img0 = pool.sample()
    H = random_homography(rng, h, w)
    img1 = warp_image(img0, H)
    xy0 = _corner_correspondences(img0, rng, n_corr, h, w, device)
    xy1 = apply_h(H, xy0)
    cv = (xy1[:, 0] >= 8) & (xy1[:, 0] < w - 8) & (xy1[:, 1] >= 8) & (xy1[:, 1] < h - 8)
    img1 = _photometric(img1, rng)
    # Hard negatives: corner sites of the warped image, nudged off the true
    # correspondences by the >= 3 px jitter below.
    xyn = _corner_correspondences(img1, rng, n_corr // 2, h, w, device)
    xyn = xyn + rng.uniform(3.0, 6.0, xyn.shape) * rng.choice([-1.0, 1.0], xyn.shape)
    return (_f32(img0, device), _f32(img1, device), _f32(xy0, device),
            _f32(np.clip(xy1, 0, [w - 1, h - 1]), device), torch.as_tensor(cv, device=device),
            _f32(np.clip(xyn, 0, [w - 1, h - 1]), device))


def train_superpoint(
    steps: int = 200,
    img_size: tuple = (120, 160),
    n_corr: int = 256,
    lr: float = 1e-3,
    seed: int = 0,
    log_every: int = 20,
    resume: str | None = None,
    device: str | torch.device = "cuda",
    stats: dict | None = None,
) -> superpoint.SuperPointParams:
    """SuperPoint from `init_params` (or `resume`) on `_superpoint_batch`
    examples. `stats`, when given, receives the logged losses and the steps
    a second (`_log_loss`, `_log_rate`), as every trainer's does."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    params = (superpoint.load_params(resume, device=dev) if resume
              else superpoint.init_params(torch.Generator().manual_seed(seed), device=dev))
    params = _trainable(params)
    # Cosine decay: from-scratch InfoNCE plateaus noisily at a fixed step
    # size; the tail of the schedule is where match precision converges.
    opt, sched = _adam(params, lr, decay_steps=steps)
    h, w = img_size
    pool = _ImagePool(rng, h, w)
    t0 = time.perf_counter()
    for i in range(steps):
        loss = superpoint_loss(params, *_superpoint_batch(rng, pool, h, w, n_corr, dev))
        _step(opt, sched, loss)
        if log_every and i % log_every == 0:
            _log_loss(stats, "superpoint", i, loss)
    if log_every:
        _log_rate(stats, "superpoint", steps, t0, dev)
    return _frozen(params)


# ---------------------------------------------------------------------------
# LightGlue training
# ---------------------------------------------------------------------------


def lightglue_loss(params, d0, xy0, d1, xy1, gt_idx, gt_valid, image_size):
    """NLL of the ground-truth assignment under the partial-assignment scores."""
    K = d0.shape[0]
    ones = torch.ones(K, dtype=torch.bool, device=d0.device)
    scores, m0, _ = lightglue.assignment_scores(params, d0, xy0, ones, d1, xy1, ones, image_size,
                                                attn_backend="xla_flash")
    picked = scores[torch.arange(K, device=d0.device), torch.clamp(gt_idx, min=0)]
    nll = -torch.log(picked + 1e-9)
    # Unmatched tokens should have low matchability.
    unmatched_pen = -torch.log(1.0 - m0 + 1e-9)
    return torch.sum(torch.where(gt_valid, nll, unmatched_pen)) / K


def _toy_batch(rng, K: int, dim: int, noise: float, device) -> tuple:
    """One synthetic descriptor cloud, the arguments of `lightglue_loss`
    between the parameters and the image size: image-1 tokens are noisy
    copies of a permuted subset of image-0 tokens, a quarter unmatched."""
    d0 = rng.standard_normal((K, dim)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    xy0 = rng.uniform(0, 128, (K, 2)).astype(np.float32)
    perm = rng.permutation(K)
    drop = rng.random(K) < 0.25  # 25 % unmatched
    d1 = d0[perm] + noise * rng.standard_normal((K, dim)).astype(np.float32)
    d1[drop[perm]] = rng.standard_normal((drop[perm].sum(), dim))
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    shift = rng.uniform(-10, 10, (1, 2)).astype(np.float32)
    xy1 = np.clip(xy0[perm] + shift, 0, 127).astype(np.float32)
    gt_idx = np.argsort(perm)  # token i of image 0 -> position gt_idx[i] in image 1
    return (_f32(d0, device), _f32(xy0, device), _f32(d1, device), _f32(xy1, device),
            torch.as_tensor(gt_idx, device=device), torch.as_tensor(~drop, device=device))


def train_lightglue(
    steps: int = 200,
    K: int = 96,
    dim: int = 64,
    n_layers: int = 2,
    lr: float = 1e-3,
    noise: float = 0.25,
    seed: int = 0,
    log_every: int = 20,
    device: str | torch.device = "cuda",
    stats: dict | None = None,
) -> lightglue.LightGlueParams:
    """Train on synthetic descriptor clouds (`_toy_batch`): the
    matcher must recover the permutation from descriptors and geometry."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    params = _trainable(lightglue.init_params(torch.Generator().manual_seed(seed), dim, dim,
                                              n_layers, device=dev))
    opt, sched = _adam(params, lr)
    size = (128.0, 128.0)
    t0 = time.perf_counter()
    for i in range(steps):
        loss = lightglue_loss(params, *_toy_batch(rng, K, dim, noise, dev), size)
        _step(opt, sched, loss)
        if log_every and i % log_every == 0:
            _log_loss(stats, "lightglue", i, loss)
    if log_every:
        _log_rate(stats, "lightglue", steps, t0, dev)
    return _frozen(params)


def lightglue_frontend_loss(params, d0, xy0, v0, d1, xy1, v1, gt_idx, gt_valid, image_size):
    """Masked NLL of the homography ground-truth assignment: matched tokens
    maximise their ground-truth score; unmatched but valid tokens minimise
    matchability."""
    K = d0.shape[0]
    scores, m0, _ = lightglue.assignment_scores(params, d0, xy0, v0, d1, xy1, v1, image_size,
                                                attn_backend="xla_flash")
    picked = scores[torch.arange(K, device=d0.device), torch.clamp(gt_idx, min=0)]
    nll = -torch.log(picked + 1e-9)
    unmatched_pen = -torch.log(1.0 - m0 + 1e-9)
    matched = gt_valid & v0
    unmatched = v0 & ~gt_valid
    n = torch.sum(v0) + 1e-6
    return (torch.sum(torch.where(matched, nll, 0.0))
            + 0.3 * torch.sum(torch.where(unmatched, unmatched_pen, 0.0))) / n


def _train_image(rng, h, w):
    """Training image sampler: half multi-octave noise textures, half
    sprite-world renders (textured quads on a dark background), the content
    the SLAM pipeline matches on. Trained only on dense textures, the
    matcher's double-softmax scores collapse on sparse scenes."""
    if rng.random() < 0.5:
        return random_texture(h, w, rng)
    from ..ops.camera import Camera
    from ..utils.synthetic import SpriteWorld

    cam = Camera(fx=float(w) * 0.75, fy=float(w) * 0.75, cx=w / 2.0, cy=h / 2.0, width=w, height=h)
    world = SpriteWorld.generate(rng, n_sprites=60, tex_size=32)
    return world.render(cam, np.eye(4, dtype=np.float32))


class _ImagePool:
    """Pre-rendered training images (a sprite render is ~1 s of host time at
    240x320, so per-step rendering would leave the device idle). The
    homography, photometric jitter and correspondence sites stay fresh per
    step; reusing base images across steps is the standard synthetic
    pretraining trade (epochs)."""

    def __init__(self, rng, h, w, size: int = 300):
        self.images = [_train_image(rng, h, w) for _ in range(size)]
        self.rng = rng

    def sample(self):
        return self.images[self.rng.integers(len(self.images))]


def _homography_pair(rng, frontend, h, w, device, mag=0.12, pool=None):
    """One example: frontend features of an image and of its homography warp
    (on `device`), and the ground-truth assignment (the nearest warped
    keypoint within 3 px) as numpy."""
    img0 = pool.sample() if pool is not None else _train_image(rng, h, w)
    H = random_homography(rng, h, w, mag=mag)
    img1 = warp_image(img0, H)
    with torch.no_grad():
        f0 = frontend.extract(_f32(img0, device))
        f1 = frontend.extract(_f32(img1, device))
    xy0 = f0.xy.cpu().numpy()
    xy1 = f1.xy.cpu().numpy()
    v0 = f0.valid.cpu().numpy()
    v1 = f1.valid.cpu().numpy()
    warped = apply_h(H, xy0)  # where image-0 keypoints land in image 1
    d2 = np.sum((warped[:, None, :] - xy1[None, :, :]) ** 2, axis=-1)
    d2[:, ~v1] = np.inf
    gt_idx = np.argmin(d2, axis=1).astype(np.int64)
    gt_valid = (
        v0
        & (d2[np.arange(len(xy0)), gt_idx] < 9.0)
        & (warped[:, 0] >= 0) & (warped[:, 0] < w)
        & (warped[:, 1] >= 0) & (warped[:, 1] < h)
    )
    return f0, f1, gt_idx, gt_valid


def train_lightglue_on_frontend(
    frontend,
    steps: int = 400,
    img_size: tuple = (160, 224),
    dim: int = 128,
    n_layers: int = 2,
    lr: float = 2e-4,
    seed: int = 0,
    log_every: int = 25,
    device: str | torch.device = "cuda",
    stats: dict | None = None,
) -> lightglue.LightGlueParams:
    """Train LightGlue on a frontend's real descriptors of homography-warped
    image pairs: the weights the pipeline's `matcher: lightglue` path loads.
    Works for any frontend with extract() / descriptor_dim (classical
    128-d, SuperPoint 256-d) whose features land on `device`. The
    homography gives the ground truth (LightGlue's homography pretraining,
    Lindenberger et al. 2023)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    h, w = img_size
    params = _trainable(lightglue.init_params(torch.Generator().manual_seed(seed),
                                              frontend.descriptor_dim, dim, n_layers, device=dev))
    opt, sched = _adam(params, lr)
    size = (float(w), float(h))
    pool = _ImagePool(rng, h, w)
    t0 = time.perf_counter()
    for i in range(steps):
        f0, f1, gt_idx, gt_valid = _homography_pair(rng, frontend, h, w, dev, pool=pool)
        loss = lightglue_frontend_loss(
            params, f0.desc, f0.xy, f0.valid, f1.desc, f1.xy, f1.valid,
            torch.as_tensor(gt_idx, device=dev), torch.as_tensor(gt_valid, device=dev), size)
        _step(opt, sched, loss)
        if log_every and i % log_every == 0:
            _log_loss(stats, "lightglue-frontend", i, loss)
    if log_every:
        _log_rate(stats, f"lightglue-frontend {frontend.descriptor_dim}-d", steps, t0, dev)
    return _frozen(params)


def train_lightglue_frontend(steps: int = 400, device: str | torch.device = "cuda",
                             **kw) -> lightglue.LightGlueParams:
    """LightGlue on the classical frontend's 128-d descriptors (the recipe of
    the committed weights/lightglue.npz)."""
    from ..slam.frontend import ClassicalFrontend

    return train_lightglue_on_frontend(ClassicalFrontend(), steps=steps, device=device, **kw)


def _superpoint_frontend(superpoint_weights=None, device: str | torch.device = "cuda"):
    params = (superpoint.load_params(superpoint_weights, device=device) if superpoint_weights
              else None)
    return superpoint.SuperPointFrontend(params=params, device=device)


def train_lightglue_superpoint(steps: int = 400, superpoint_weights=None,
                               device: str | torch.device = "cuda",
                               **kw) -> lightglue.LightGlueParams:
    """LightGlue on the SuperPoint frontend's 256-d descriptors (random
    SuperPoint weights without `superpoint_weights`): the committed
    weights/lightglue_superpoint.npz, which the pipeline loads for
    `--frontend learned --matcher lightglue`."""
    return train_lightglue_on_frontend(_superpoint_frontend(superpoint_weights, device),
                                       steps=steps, device=device, **kw)


def eval_lightglue_on_frontend(
    params, frontend, n_pairs: int = 8, img_size: tuple = (160, 224),
    seed: int = 1, threshold: float = 0.1,
):
    """Precision / recall of LightGlue's mutual-argmax matches (kernel K6 on
    the card) against the homography ground truth on held-out pairs, beside
    the frontend's mutual-1NN matcher on the same pairs; on the device of
    `params`, where the frontend's features must land."""
    from ..ops.matching import match_frames

    dev = params.in_proj_w.device
    rng = np.random.default_rng(seed)
    h, w = img_size
    stats = {"lg": [0, 0, 0], "classical": [0, 0, 0]}  # correct, proposed, gt
    for _ in range(n_pairs):
        f0, f1, gt_idx, gt_valid = _homography_pair(rng, frontend, h, w, dev)
        # Ground truth indexed by image-1 keypoints (both matchers return that way).
        gt1 = -np.ones(len(gt_idx), np.int64)
        for i0 in np.nonzero(gt_valid)[0]:
            gt1[gt_idx[i0]] = i0
        with torch.no_grad():
            lg = lightglue.match(params, f0.desc, f0.xy, f0.valid, f1.desc, f1.xy, f1.valid,
                                 (float(w), float(h)), threshold)
            cl = match_frames(f0.desc, f0.valid, f1.desc, f1.valid, frontend.max_distance)
        for name, fm in (("lg", lg), ("classical", cl)):
            v = fm.valid.cpu().numpy()
            ti = fm.train_idx.cpu().numpy()
            stats[name][0] += int(np.sum(v & (ti == gt1)))
            stats[name][1] += int(np.sum(v))
            stats[name][2] += int(np.sum(gt1 >= 0))
    return {name: {"precision": c / max(p, 1), "recall": c / max(g, 1), "proposed": p, "gt": g}
            for name, (c, p, g) in stats.items()}


def eval_lightglue_frontend(params, **kw):
    from ..slam.frontend import ClassicalFrontend

    return eval_lightglue_on_frontend(params, ClassicalFrontend(), **kw)


def eval_lightglue_superpoint(params, superpoint_weights=None, **kw):
    frontend = _superpoint_frontend(superpoint_weights, params.in_proj_w.device)
    return eval_lightglue_on_frontend(params, frontend, **kw)


def main(argv=None) -> dict:
    """The command line; returns what it printed, by saved file stem:
    {"superpoint": {"losses": [...], "steps_per_s": x}, "lightglue": {...,
    "eval": eval_lightglue_frontend's dict}, ...}."""
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--sp-steps", type=int, default=None,
                   help="SuperPoint step count override (default: --steps)")
    p.add_argument("--sp-resume", type=str, default="",
                   help="resume SuperPoint training from this .npz")
    p.add_argument("--sp-lr", type=float, default=1e-3)
    p.add_argument("--sp-size", type=str, default="120x160",
                   help="SuperPoint training image size HxW; larger sizes give more detector "
                        "cells per example and transfer better to the 480x640 pipeline")
    p.add_argument("--lg-size", type=str, default="160x224",
                   help="LightGlue-on-frontend training image size HxW")
    p.add_argument("--out", type=Path, default=Path("weights"))
    p.add_argument(
        "--which",
        # "lightglue" (and "both") trains the pipeline's recipe: LightGlue on
        # the classical frontend's 128-d descriptors. "lightglue-toy" is the
        # synthetic descriptor-cloud exercise (dim 64, not loadable by the
        # pipeline), saved under its own name so that it never shadows the
        # real weights. "lightglue-superpoint" trains a 256-d-input LightGlue
        # on SuperPoint descriptors (the --out superpoint.npz if it exists,
        # else random SuperPoint weights).
        choices=["superpoint", "lightglue", "lightglue-frontend", "lightglue-superpoint",
                 "lightglue-toy", "both"],
        default="both",
    )
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU (the default is the CUDA card)")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    args.out.mkdir(parents=True, exist_ok=True)
    sp_hw = tuple(int(v) for v in args.sp_size.split("x"))
    lg_hw = tuple(int(v) for v in args.lg_size.split("x"))
    report = {}
    if args.which in ("superpoint", "both"):
        sp = train_superpoint(args.sp_steps or args.steps, img_size=sp_hw, lr=args.sp_lr,
                              resume=args.sp_resume or None, device=device,
                              stats=report.setdefault("superpoint", {}))
        superpoint.save_params(args.out / "superpoint.npz", sp)
        print(f"saved {args.out}/superpoint.npz")
    if args.which in ("lightglue", "lightglue-frontend", "both"):
        stats = report.setdefault("lightglue", {})
        lg = train_lightglue_frontend(args.steps, img_size=lg_hw, device=device, stats=stats)
        stats["eval"] = eval_lightglue_frontend(lg)
        print(stats["eval"])
        lightglue.save_params(args.out / "lightglue.npz", lg)
        print(f"saved {args.out}/lightglue.npz")
    if args.which in ("lightglue-superpoint", "both"):
        sp_path = args.out / "superpoint.npz"
        sp_weights = sp_path if sp_path.exists() else None
        stats = report.setdefault("lightglue_superpoint", {})
        lg = train_lightglue_superpoint(args.steps, img_size=lg_hw, superpoint_weights=sp_weights,
                                        device=device, stats=stats)
        stats["eval"] = eval_lightglue_superpoint(lg, superpoint_weights=sp_weights)
        print(stats["eval"])
        lightglue.save_params(args.out / "lightglue_superpoint.npz", lg)
        print(f"saved {args.out}/lightglue_superpoint.npz")
    if args.which == "lightglue-toy":
        lg = train_lightglue(args.steps, device=device, stats=report.setdefault("lightglue_toy", {}))
        lightglue.save_params(args.out / "lightglue_toy.npz", lg)
        print(f"saved {args.out}/lightglue_toy.npz (synthetic descriptor-cloud exercise; "
              "not loadable by the pipeline)")
    return report


if __name__ == "__main__":
    main()
