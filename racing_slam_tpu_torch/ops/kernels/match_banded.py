"""Kernel K5: banded guided map->frame matching, stage 1 (the scale path).

Replaces racing_slam_tpu/ops/pallas/match_kernel.py:guided_match_stage1_banded.
Source: racing_slam_tpu_torch/csrc/match_banded_kernel.cu.

What it computes: K2's contract over y-sorted inputs. Sorted row g is the
map point p_sel[g] (rows sorted gated-first by projected y; p_sel[g] >= P
is a padding row, never gated), read through p_sel, so that the caller
gathers nothing; keypoints come sorted so that kp_ok ? v : +inf does not
decrease, padded to a multiple of `tile_k`. Point tile i (`tile_p` rows)
looks only at the keypoint band [starts[i] * tile_k, (starts[i] +
band_tiles) * tile_k). Tiles i >= n_active_tiles hold no gated point and
give (0, 1e9). Returns (best_k into the SORTED keypoint order, best_d_sq)
per sorted row, ties to the lowest sorted index. The sorting, the bands
and the fallback decision are ops/matching.py's `_banded_stage1`.

What bounds it on an H100: at the scale path's shape (8192 sorted rows of
8 bf16 128-d observations, 2560 padded keypoints, 32 point tiles) the
bytes of the active rows, ~2 KB a point, read once. The kernel searches
each point's run of keypoints within the radius in y (the band is sorted
by y) instead of scanning the band, and scores the pairs that pass on the
tensor cores (see the source). `starts` and `n_active_tiles` stay on the
device, so the call makes no host read.

Batched: S problems of equal sizes (the lockstep step of S sequences) take
a leading S on every operand (n_active_tiles [S]) and return [S, G]
best_k and best_d, in one launch whose grid splits the resident blocks
over the S problems (blockIdx.y = problem); a row's answer is computed by
one warp over that row's units, so each row equals the call on that row
alone to the bit. One launch is one count.
"""

from __future__ import annotations

import torch

from . import _build
from .match import BIG, _aligned

launches = 0
MAX_BAND = 2048  # csrc/match_banded_kernel.cu


def guided_match_stage1_banded_reference(
    uv_p: torch.Tensor,
    gate_p: torch.Tensor,
    obs_desc: torch.Tensor,
    obs_valid: torch.Tensor,
    p_sel: torch.Tensor,
    kp_uv: torch.Tensor,
    kp_desc: torch.Tensor,
    kp_ok: torch.Tensor,
    starts: torch.Tensor,
    n_active_tiles: torch.Tensor,
    radius_px: float = 20.0,
    tile_p: int = 256,
    tile_k: int = 512,
    band_tiles: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch twin: the rows p_sel gathered, then per point tile the
    dense masked reduction over its keypoint band (gathered), inactive
    tiles masked out on the device; for leading-S operands, row by row."""
    tiles = dict(radius_px=radius_px, tile_p=tile_p, tile_k=tile_k, band_tiles=band_tiles)
    if obs_desc.dim() == 4:
        rows = [guided_match_stage1_banded_reference(*row, **tiles)
                for row in zip(uv_p, gate_p, obs_desc, obs_valid, p_sel, kp_uv, kp_desc, kp_ok,
                               starts, n_active_tiles)]
        return torch.stack([r[0] for r in rows]), torch.stack([r[1] for r in rows])
    P, O, D = obs_desc.shape
    G = p_sel.shape[0]
    dev = uv_p.device
    src = torch.clamp(p_sel.long(), 0, P - 1)
    uv_p, obs_desc, obs_valid = uv_p[src], obs_desc[src], obs_valid[src]
    gate_p = (p_sel < P) & gate_p[src]
    width = band_tiles * tile_k
    r2 = radius_px * radius_px
    kb = kp_desc.to(torch.bfloat16).float()
    kn = torch.sum(kb * kb, dim=-1)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    lane = torch.arange(width, device=dev)
    best_k, best_d = [], []
    for i in range(G // tile_p):
        s, e = i * tile_p, (i + 1) * tile_p
        kidx = starts[i].long() * tile_k + lane  # the tile's band, [width]
        duv = uv_p[s:e, None, :] - kp_uv[kidx][None, :, :]
        px_ok = torch.sum(duv * duv, dim=-1) <= r2
        ob = obs_desc[s:e].reshape(tile_p * O, D).to(torch.bfloat16).float()
        on = torch.sum(ob * ob, dim=-1)
        dd = torch.clamp(on[:, None] + kn[kidx][None, :] - 2.0 * (ob @ kb[kidx].T), min=0.0)
        dd = torch.where(obs_valid[s:e].reshape(tile_p * O, 1), dd, big)
        dd = torch.min(dd.reshape(tile_p, O, width), dim=1).values
        ok = px_ok & gate_p[s:e, None] & kp_ok[kidx][None, :] & (n_active_tiles > i)
        dd = torch.where(ok, dd, big)
        d = torch.min(dd, dim=-1).values
        k = kidx[torch.argmin(dd, dim=-1)]  # first minimum: the lowest sorted index
        best_k.append(torch.where(d < BIG, k, torch.zeros_like(k)).to(torch.int32))
        best_d.append(d)
    return torch.cat(best_k), torch.cat(best_d)


def guided_match_stage1_banded(
    uv_p: torch.Tensor,  # [P, 2] f32
    gate_p: torch.Tensor,  # [P] bool
    obs_desc: torch.Tensor,  # [P, O, D] bf16 (f32 is rounded)
    obs_valid: torch.Tensor,  # [P, O] bool
    p_sel: torch.Tensor,  # [G] int32: sorted row -> point (>= P: padding)
    kp_uv: torch.Tensor,  # [K, 2] f32, sorted by kp_ok ? y : inf, K a multiple of tile_k
    kp_desc: torch.Tensor,  # [K, D] f32 or bf16
    kp_ok: torch.Tensor,  # [K] bool
    starts: torch.Tensor,  # [G / tile_p] int32 first keypoint tile of each band
    n_active_tiles: torch.Tensor,  # 0-d int32 ([S] for S problems)
    radius_px: float = 20.0,
    tile_p: int = 256,
    tile_k: int = 512,
    band_tiles: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(best_k [G] i32 into the sorted keypoints, best_d_sq [G] f32), or
    [S, G] each for S problems given a leading S on every operand."""
    tensors = (uv_p, gate_p, obs_desc, obs_valid, p_sel, kp_uv, kp_desc, kp_ok, starts,
               n_active_tiles)
    tiles = dict(radius_px=radius_px, tile_p=tile_p, tile_k=tile_k, band_tiles=band_tiles)
    if _build.device_kind(*tensors) == "cpu":
        return guided_match_stage1_banded_reference(*tensors, **tiles)
    lead = tuple(obs_desc.shape[:-3])  # () or (S,)
    if len(lead) > 1:
        raise ValueError(f"obs_desc: expected [P, O, D] or [S, P, O, D], "
                         f"got {tuple(obs_desc.shape)}")
    S = lead[0] if lead else 1
    P, O, D = obs_desc.shape[-3:]
    G = p_sel.shape[-1]
    K = kp_uv.shape[-2]
    obs_desc = _aligned(obs_desc.to(torch.bfloat16), 4)  # no-op for the state's bf16 cache
    kp_desc = _aligned(kp_desc.to(torch.float32), 8)
    kp_uv = _aligned(kp_uv, 8)
    if O > 8 or D % 32 != 0 or D > 256:
        raise ValueError(f"guided_match_stage1_banded kernel takes O <= 8, D in 32..256 in "
                         f"steps of 32; got {O}, {D}")
    if (G % tile_p or tile_p % 8 or K % tile_k or band_tiles * tile_k > MAX_BAND
            or K < band_tiles * tile_k):
        raise ValueError(f"banded tiling: G={G} (tile {tile_p}, a multiple of 8), K={K} "
                         f"(tile {tile_k}), band {band_tiles} tiles <= {MAX_BAND} keypoints")
    _build.expect(uv_p, "uv_p", torch.float32, (*lead, P, 2))
    _build.expect(gate_p, "gate_p", torch.bool, (*lead, P))
    _build.expect(obs_desc, "obs_desc", torch.bfloat16, (*lead, P, O, D))
    _build.expect(obs_valid, "obs_valid", torch.bool, (*lead, P, O))
    _build.expect(p_sel, "p_sel", torch.int32, (*lead, G))
    _build.expect(kp_uv, "kp_uv", torch.float32, (*lead, K, 2))
    _build.expect(kp_desc, "kp_desc", torch.float32, (*lead, K, D))
    _build.expect(kp_ok, "kp_ok", torch.bool, (*lead, K))
    _build.expect(starts, "starts", torch.int32, (*lead, G // tile_p))
    _build.expect(n_active_tiles, "n_active_tiles", torch.int32, lead)
    best_k = torch.empty((*lead, G), dtype=torch.int32, device=uv_p.device)
    best_d = torch.empty((*lead, G), dtype=torch.float32, device=uv_p.device)
    err = _build.lib().slam_guided_match_banded(
        _build.ptr(uv_p), _build.ptr(gate_p), _build.ptr(obs_desc), _build.ptr(obs_valid),
        _build.ptr(p_sel), _build.ptr(kp_uv), _build.ptr(kp_desc), _build.ptr(kp_ok),
        _build.ptr(starts), _build.ptr(n_active_tiles), _build.ptr(best_k), _build.ptr(best_d),
        S, P, G, O, D, K, tile_p, tile_k, band_tiles, float(radius_px * radius_px),
        _build.stream(uv_p.device),
    )
    _build.check(err, "guided_match_stage1_banded")
    global launches
    launches += 1
    return best_k, best_d
