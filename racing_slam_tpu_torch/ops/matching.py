"""Dense masked feature matching (port of racing_slam_tpu/ops/matching.py).

- frame<->frame: mutual 1-NN over one [K1, K2] distance matrix with a gate.
- map->frame: a masked [P, K] min reduction. Stage 1 (best keypoint per
  point) is kernel K2 (ops/kernels/match.py) on the dense path, or, with
  backend="banded" (the large-map scale path), kernel K5
  (ops/kernels/match_banded.py) over y-sorted points and keypoints, each
  256-point tile searching only the two 512-keypoint tiles around its
  y-range; stage 2 (best point per keypoint, lowest point index on ties) is
  a scatter-min here.

Where the band does not fit, the JAX package falls back to the dense kernel
under lax.cond. Here both kernels are launched and a device flag decides
which one works (K5 with no active tile, or K2 with `skip`), so the choice
costs no host read; `MapMatches.fell_back` carries the flag.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .camera import Camera, is_in_image, project_with_depth
from .kernels.match import guided_match_stage1
from .kernels.match_banded import guided_match_stage1_banded

SEARCH_RADIUS_PX = 20.0
_BIG = 1e9


class FrameMatches(NamedTuple):
    train_idx: torch.Tensor  # [..., K2] int64 index into frame-1 keypoints
    distance: torch.Tensor  # [..., K2] f32
    valid: torch.Tensor  # [..., K2] bool


class MapMatches(NamedTuple):
    point_idx: torch.Tensor  # [..., K] int64 map slot (-1 where ~valid)
    distance: torch.Tensor  # [..., K] f32
    valid: torch.Tensor  # [..., K] bool
    fell_back: torch.Tensor | None = None  # [...] bool (banded: the dense kernel ran)


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
    """Mutual 1-NN (queries: frame 2, trains: frame 1) with a distance gate;
    [K, D] descriptors, or S frame pairs [S, K, D] matched row by row (each
    row's distance matrix is its own product, the one a single pair gets:
    a batched product may sum the D terms in another order)."""
    if desc1.dim() == 3:
        d2 = torch.stack([_pairwise_sq_dists(a, b) for a, b in zip(desc1, desc2)])
    else:
        d2 = _pairwise_sq_dists(desc1, desc2)
    d2 = torch.where(valid1[..., :, None] & valid2[..., None, :], d2, torch.full_like(d2, _BIG))
    best1_for_2 = torch.argmin(d2, dim=-2)
    best2_for_1 = torch.argmin(d2, dim=-1)
    mutual = torch.gather(best2_for_1, -1, best1_for_2) == torch.arange(d2.shape[-1],
                                                                        device=d2.device)
    dist = torch.sqrt(torch.gather(d2, -2, best1_for_2[..., None, :])[..., 0, :])
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
    backend: str = "auto",
) -> MapMatches:
    """Guided projection search of map points into a frame.

    Stage 1 is kernel K2 ("auto") or the banded search with kernel K5
    ("banded") for CUDA tensors, and their plain twins for CPU tensors.
    With a leading S on every operand (pose [S, 4, 4], point_xyz [S, P, 3],
    kp_uv [S, K, 2], ...) it matches S independent frames, each kernel once
    for all; the outputs take the leading S.
    """
    if backend not in ("auto", "banded"):
        raise ValueError(f"backend={backend!r}: 'auto' or 'banded'")
    P = point_xyz.shape[-2]
    K = kp_uv.shape[-2]
    uv_p, depth = project_with_depth(cam, pose, point_xyz)
    gate_p = point_mask & ~point_already_matched & is_in_image(cam, uv_p) & (depth > 0.0)
    kp_ok = kp_valid & ~kp_already_matched
    fell_back = None
    if backend == "banded":
        best_k, best_d, fell_back = _banded_stage1(
            uv_p.contiguous(), gate_p, obs_desc, obs_valid, kp_uv, kp_desc, kp_ok,
            radius_px=radius_px,
        )
    else:
        best_k, best_d = guided_match_stage1(
            uv_p.contiguous(), gate_p, obs_desc, obs_valid, kp_uv, kp_desc, kp_ok,
            radius_px=radius_px,
        )
    best_d = torch.sqrt(torch.clamp(best_d, max=_BIG))
    best_d = torch.where(best_d < max_distance, best_d, torch.full_like(best_d, _BIG))
    return _stage2(best_k.long(), best_d, P, K)._replace(fell_back=fell_back)


def _pad(x: torch.Tensor, n: int, fill, dim: int) -> torch.Tensor:
    """x with n entries of `fill` appended along `dim`."""
    if not n:
        return x
    shape = list(x.shape)
    shape[dim] = n
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=dim)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along the axis after idx's leading dims (idx clamped to >= 0):
    [P, 3] by [K] -> [K, 3], or row by row [S, P, 3] by [S, K] -> [S, K, 3]."""
    axis = idx.dim() - 1
    idx = torch.clamp(idx, min=0)
    tail = x.shape[axis + 1:]
    return torch.gather(x, axis, idx.reshape(*idx.shape, *[1] * len(tail)).expand(
        *idx.shape, *tail))


class BandPlan(NamedTuple):
    """The banded search's inputs to kernel K5 and what maps them back; a
    leading S on each for S frames."""

    k5_args: tuple  # uv_p, gate_p, obs_desc, obs_valid, p_sel, kp_uv, kp_desc, kp_ok, starts
    n_act: torch.Tensor  # [...] int64: point tiles holding gated points
    fits: torch.Tensor  # [...] bool: every band fits and the gated points fit in G rows
    p_sel: torch.Tensor  # [..., G] sorted row -> padded point slot (>= P: padding)
    kp_order: torch.Tensor  # [..., Kp] sorted keypoint -> original index (0 for padding)


def band_plan(uv_p, gate_p, obs_desc, obs_valid, kp_uv, kp_desc, kp_ok, *, radius_px: float,
              tile_p: int = 256, tile_k: int = 512, band_tiles: int = 2) -> BandPlan:
    """Sort and band the inputs of the banded stage 1 (see _banded_stage1),
    for one frame or for S frames (a leading S on every operand, each row
    planned alone).

    Points sort gated-first by projected y, keypoints by y (stable sorts, as
    jnp.argsort: the sorted order decides ties). Only the first G sorted
    rows can be active (G = P/2 at P >= 8192); K5 reads the point rows
    through p_sel, so none are gathered here.
    Each point tile's band starts at the keypoint tile holding its lowest y
    minus the radius; it fits when `band_tiles` tiles reach its highest y
    plus the radius."""
    P = obs_desc.shape[-3]
    K = kp_uv.shape[-2]
    lead = kp_uv.shape[:-2]
    far = 1e8
    pad_p = (-P) % tile_p
    Pp = P + pad_p
    G = Pp if Pp < 8192 else max(tile_p, (Pp // 2 // tile_p) * tile_p)
    n_tiles = G // tile_p
    n_k = max(-(-K // tile_k), band_tiles)
    pad_k = n_k * tile_k - K

    # Keypoints sorted by y (invalid ones last), padded to the tile grid.
    kp_y = torch.where(kp_ok, kp_uv[..., 1], torch.full_like(kp_uv[..., 1], far))
    kp_order = torch.argsort(kp_y, dim=-1, stable=True)
    kp_y_s = _pad(torch.gather(kp_y, -1, kp_order), pad_k, far, -1)

    # Points sorted gated-first by projected y; padding rows (>= P) are
    # ungated.
    p_y = _pad(torch.where(gate_p, uv_p[..., 1], torch.full_like(uv_p[..., 1], far)), pad_p, far,
               -1)
    p_sel = torch.argsort(p_y, dim=-1, stable=True)[..., :G]

    # Per point tile: the keypoint band covering its y-range +- the radius.
    y_t = torch.gather(p_y, -1, p_sel).reshape(*lead, n_tiles, tile_p)
    g_t = y_t < far
    lo = torch.where(g_t, y_t, torch.full_like(y_t, float("inf"))).amin(dim=-1) - radius_px
    hi = torch.where(g_t, y_t, torch.full_like(y_t, float("-inf"))).amax(dim=-1) + radius_px
    lo_idx = torch.searchsorted(kp_y_s, lo)
    hi_idx = torch.searchsorted(kp_y_s, hi, right=True)
    start = lo_idx // tile_k
    end = torch.maximum(hi_idx - 1, lo_idx) // tile_k
    needed = torch.where(g_t.any(dim=-1), end - start + 1, torch.ones_like(start))
    start = torch.clamp(start, 0, n_k - band_tiles).to(torch.int32)
    n_gated = gate_p.sum(dim=-1)
    return BandPlan(
        k5_args=(uv_p, gate_p, obs_desc, obs_valid, p_sel.to(torch.int32),
                 _pad(gather_rows(kp_uv, kp_order), pad_k, 1e7, -2),
                 _pad(gather_rows(kp_desc, kp_order), pad_k, 0, -2),
                 _pad(torch.gather(kp_ok, -1, kp_order), pad_k, False, -1), start),
        n_act=(n_gated + tile_p - 1) // tile_p,
        fits=(needed <= band_tiles).all(dim=-1) & (n_gated <= G),
        p_sel=p_sel,
        kp_order=_pad(kp_order, pad_k, 0, -1),
    )


def _banded_stage1(
    uv_p: torch.Tensor,
    gate_p: torch.Tensor,
    obs_desc: torch.Tensor,
    obs_valid: torch.Tensor,
    kp_uv: torch.Tensor,
    kp_desc: torch.Tensor,
    kp_ok: torch.Tensor,
    *,
    radius_px: float,
    tile_p: int = 256,
    tile_k: int = 512,
    band_tiles: int = 2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grid-hash stage 1: (best_k [P] int64, best_d_sq [P], fell_back 0-d
    bool), or [S, P], [S, P], [S] for S frames (one K5 and one K2 launch
    for all).

    Each point tile searches only the keypoint tiles covering its y-range
    (band_plan). Visiting a superset of the needed band is exact, because
    the pixel gate still rejects far pairs. When a band is wider than
    `band_tiles` tiles, or gated points overflow G, the band does not fit:
    K5 then sees no active tile and K2, launched beside it, does the dense
    search; for S frames, row by row (K5's `n_active_tiles` and K2's `skip`
    per row). Ties go to the lowest y-sorted keypoint, which may differ
    from the dense path's lowest original index.
    """
    P = obs_desc.shape[-3]
    lead = obs_desc.shape[:-3]
    tiles = dict(radius_px=radius_px, tile_p=tile_p, tile_k=tile_k, band_tiles=band_tiles)
    plan = band_plan(uv_p, gate_p, obs_desc, obs_valid, kp_uv, kp_desc, kp_ok, **tiles)
    n_act = torch.where(plan.fits, plan.n_act, torch.zeros_like(plan.n_act)).to(torch.int32)
    bk_s, bd_s = guided_match_stage1_banded(*plan.k5_args, n_act, **tiles)
    # Back to the original keypoint and point numbering.
    Pp = P + (-P) % tile_p
    dev = bk_s.device
    bk = torch.gather(plan.kp_order, -1, bk_s.long())
    out_k = torch.zeros((*lead, Pp), dtype=torch.int64, device=dev).scatter(-1, plan.p_sel, bk)
    out_d = torch.full((*lead, Pp), _BIG, device=dev).scatter(-1, plan.p_sel, bd_s)

    dk, dd = guided_match_stage1(uv_p, gate_p, obs_desc, obs_valid, kp_uv, kp_desc, kp_ok,
                                 radius_px=radius_px, skip=plan.fits)
    fits = plan.fits[..., None]
    return (torch.where(fits, out_k[..., :P], dk.long()),
            torch.where(fits, out_d[..., :P], dd), ~plan.fits)


def _stage2(best_k: torch.Tensor, best_d: torch.Tensor, P: int, K: int) -> MapMatches:
    """Best point per keypoint by scatter-min; lowest point index wins ties.
    [P] -> [K], or [S, P] -> [S, K] row by row."""
    dev = best_d.device
    lead = best_d.shape[:-1]
    kp_best_d = torch.full((*lead, K), _BIG, dtype=best_d.dtype, device=dev).scatter_reduce(
        -1, best_k, best_d, reduce="amin"
    )
    pid = torch.arange(P, device=dev).expand(*lead, P)
    is_winner = best_d <= torch.gather(kp_best_d, -1, best_k)
    cand = torch.where(is_winner & (best_d < _BIG), pid, torch.full_like(pid, P))
    kp_point = torch.full((*lead, K), P, dtype=pid.dtype, device=dev).scatter_reduce(
        -1, best_k, cand, reduce="amin"
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
    """Frame matches whose two keypoints both lack a map association; for
    one pair, or S pairs with a leading S."""
    if kp1_matched.dim() == 2:
        return matches.valid & ~gather_rows(kp1_matched, matches.train_idx) & ~kp2_matched
    return matches.valid & ~kp1_matched[matches.train_idx] & ~kp2_matched
