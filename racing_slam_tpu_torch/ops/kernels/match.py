"""Kernel K2: guided map->frame matching, stage 1.

Replaces racing_slam_tpu/ops/pallas/match_kernel.py:guided_match_stage1.
Source: racing_slam_tpu_torch/csrc/match_kernel.cu.

What it computes: for every map point, the keypoint within the pixel radius
of its projection (passing the point and keypoint gates) at the least
squared descriptor distance, the minimum over the point's valid observation
descriptors; bf16-rounded descriptors, float32 sums, ties to the lowest
keypoint index, (0, 1e9) where nothing passes.

What bounds it on an H100: evaluated densely, as the TPU kernel does on its
matrix unit, it is P*O*K*D = 4096*8*2400*128 multiply-adds (~20 GFLOP)
per call, twice a frame, for a result that keeps about 20 keypoints per
point: the pixel gate rejects ~99% of pairs at radius 28 px on 640x480.
The kernel tests the cheap pixel gate first, one warp per point over
keypoint tiles in shared memory, and computes descriptor distances only for
the pairs that pass, so it is bound by the gate scan (P*K position tests)
and the latency of the per-pair warp reductions, not by arithmetic.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0
BIG = 1e9


def guided_match_stage1_reference(
    uv_p: torch.Tensor,
    gate_p: torch.Tensor,
    obs_desc: torch.Tensor,
    obs_valid: torch.Tensor,
    kp_uv: torch.Tensor,
    kp_desc: torch.Tensor,
    kp_ok: torch.Tensor,
    radius_px: float = 20.0,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch twin (the dense masked reduction, chunked over points)."""
    P, O, D = obs_desc.shape
    K = kp_uv.shape[0]
    r2 = radius_px * radius_px
    kb = kp_desc.to(torch.bfloat16).float()
    kn = torch.sum(kb * kb, dim=-1)
    big = torch.tensor(BIG, dtype=torch.float32, device=uv_p.device)
    best_k, best_d = [], []
    for s in range(0, P, chunk):
        e = min(P, s + chunk)
        n = e - s
        duv = uv_p[s:e, None, :] - kp_uv[None, :, :]
        px_ok = torch.sum(duv * duv, dim=-1) <= r2
        ob = obs_desc[s:e].reshape(n * O, D).to(torch.bfloat16).float()
        on = torch.sum(ob * ob, dim=-1)
        # bf16 x bf16 products are exact in float32; the sum is float32.
        dd = torch.clamp(on[:, None] + kn[None, :] - 2.0 * (ob @ kb.T), min=0.0)
        dd = torch.where(obs_valid[s:e].reshape(n * O, 1), dd, big)
        dd = torch.min(dd.reshape(n, O, K), dim=1).values
        dd = torch.where(px_ok & gate_p[s:e, None] & kp_ok[None, :], dd, big)
        best_k.append(torch.argmin(dd, dim=-1).to(torch.int32))
        best_d.append(torch.min(dd, dim=-1).values)
    return torch.cat(best_k), torch.cat(best_d)


def guided_match_stage1(
    uv_p: torch.Tensor,  # [P, 2] f32 projected points
    gate_p: torch.Tensor,  # [P] bool
    obs_desc: torch.Tensor,  # [P, O, D] bf16 (f32 is rounded)
    obs_valid: torch.Tensor,  # [P, O] bool
    kp_uv: torch.Tensor,  # [K, 2] f32
    kp_desc: torch.Tensor,  # [K, D] f32 or bf16
    kp_ok: torch.Tensor,  # [K] bool
    radius_px: float = 20.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(best_k [P] i32, best_d_sq [P] f32; 1e9 where nothing passed)."""
    if _build.device_kind(uv_p, gate_p, obs_desc, obs_valid, kp_uv, kp_desc, kp_ok) == "cpu":
        return guided_match_stage1_reference(
            uv_p, gate_p, obs_desc, obs_valid, kp_uv, kp_desc, kp_ok, radius_px
        )
    P, O, D = obs_desc.shape
    K = kp_uv.shape[0]
    obs_desc = obs_desc.to(torch.bfloat16)  # no-op for the state's bf16 cache
    kp_desc = kp_desc.to(torch.float32)  # rounded to bf16 inside the kernel
    if O > 8 or D % 32 != 0 or D > 128:
        raise ValueError(f"guided_match_stage1 kernel takes O <= 8, D in 32..128; got {O}, {D}")
    _build.expect(uv_p, "uv_p", torch.float32, (P, 2))
    _build.expect(gate_p, "gate_p", torch.bool, (P,))
    _build.expect(obs_desc, "obs_desc", torch.bfloat16, (P, O, D))
    _build.expect(obs_valid, "obs_valid", torch.bool, (P, O))
    _build.expect(kp_uv, "kp_uv", torch.float32, (K, 2))
    _build.expect(kp_desc, "kp_desc", torch.float32, (K, D))
    _build.expect(kp_ok, "kp_ok", torch.bool, (K,))
    best_k = torch.empty((P,), dtype=torch.int32, device=uv_p.device)
    best_d = torch.empty((P,), dtype=torch.float32, device=uv_p.device)
    err = _build.lib().slam_guided_match(
        _build.ptr(uv_p), _build.ptr(gate_p), _build.ptr(obs_desc), _build.ptr(obs_valid),
        _build.ptr(kp_uv), _build.ptr(kp_desc), _build.ptr(kp_ok), _build.ptr(best_k),
        _build.ptr(best_d), P, O, D, K, float(radius_px * radius_px),
        _build.stream(uv_p.device),
    )
    _build.check(err, "guided_match_stage1")
    global launches
    launches += 1
    return best_k, best_d
