"""Kernel K6: flash (online-softmax) multi-head attention for LightGlue.

Replaces racing_slam_tpu/ops/pallas/attention_kernel.py:flash_mha.
Source: racing_slam_tpu_torch/csrc/attention_kernel.cu.

What it computes: softmax(q k^T / sqrt(dh)) v per head, with q, k and v
rounded to bf16 and float32 sums; a masked key gets the logit -1e9, so a
query whose keys are all masked attends uniformly to them; f32 output in
the [Kq, H, dh] layout. Query masking is left to the caller, as in the
JAX package. LightGlue runs it at 8 sites per matcher call (2 layers x
self0, self1, cross01, cross10) at [2400, 4, 32] on the 640x480 path.

What bounds it on an H100: per call 2 * 2 * Kq * Kk * H * dh = 2.95 GFLOP
of bf16 products (~3 us on the tensor cores) and Kq * Kk * H = 23 M
exponentials (~5.5 us on the special-function units); 4.9 MB of f32
operands (~1.5 us). At [2400, 4, 32] there are only 152 tiles of 64
queries for 132 SMs, so the call is three launches (see the source): a
pre-pass that rounds q, k and v to bf16 once into tiles laid out as the
main kernel's shared memory wants them, plus the additive mask row; the
main kernel, one CTA per (query tile, head, key chunk), a producer warp
feeding a ring of key tiles by bulk asynchronous copies and a consumer
warpgroup on wgmma, exp2 of logits pre-scaled in one FFMA; and a combine
of the chunks' unnormalised (o, l, m). `default_chunks` splits the keys so
that every SM holds several CTAs. `flash_mha_reference(..., tile_k=64,
chunks=S)` is the same recurrence, split and combine.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0
NEG = -1e9
KEY_TILE = 64  # keys per tile of the kernel (csrc/attention_kernel.cu TK)
QUERY_TILE = 64


def flash_mha_reference(
    q: torch.Tensor,  # [Kq, H, dh]
    k: torch.Tensor,  # [Kk, H, dh]
    v: torch.Tensor,  # [Kk, H, dh]
    mask_k: torch.Tensor,  # [Kk] bool
    tile_k: int = 512,
    chunks: int = 1,
) -> torch.Tensor:
    """Plain-PyTorch twin: the TPU kernel's recurrence at its default key
    tile (512), with its rounding points. bf16 q, k, v; f32 logits times
    1/sqrt(dh); masked keys -1e9, tile padding -2e9; running max from -1e9;
    p rounded to bf16 for p.v, unrounded in the denominator. The bf16
    products are exact in float32, so it agrees with the JAX kernel up to
    the order of float32 sums.

    `chunks` > 1 models the CUDA kernel's split of the keys: the keys are
    padded to `chunks` equal runs of whole tiles (ceil(Kk / (chunks *
    tile_k)) tiles each; a run past the last key is all padding), each run
    does the recurrence from m = -1e9, l = 0 on its own, and the runs'
    unnormalised (acc, den, m) are merged in run order: m = max m_c,
    den = sum exp(m_c - m) den_c, acc likewise, out = acc / den. An
    all-padding run ends with den = 0 and adds nothing."""
    Kq, H, dh = q.shape
    Kk = k.shape[0]
    scale = 1.0 / float(dh) ** 0.5
    run = -(-Kk // (chunks * tile_k)) * tile_k  # keys a run
    pad = chunks * run - Kk
    bf = lambda x: x.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    qh = bf(q).permute(1, 0, 2)  # [H, Kq, dh]
    kh = torch.nn.functional.pad(bf(k), (0, 0, 0, 0, 0, pad)).permute(1, 2, 0)  # [H, dh, Kp]
    vh = torch.nn.functional.pad(bf(v), (0, 0, 0, 0, 0, pad)).permute(1, 0, 2)  # [H, Kp, dh]
    mk = torch.nn.functional.pad(mask_k.to(torch.float32), (0, pad), value=-1.0)
    parts = []
    for c in range(chunks):
        m = torch.full((H, Kq, 1), NEG, dtype=torch.float32, device=q.device)
        den = torch.zeros((H, Kq, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((H, Kq, dh), dtype=torch.float32, device=q.device)
        for j in range(c * run, (c + 1) * run, tile_k):
            sl = slice(j, j + tile_k)
            s = torch.matmul(qh, kh[:, :, sl]) * scale  # [H, Kq, T]
            mt = mk[sl]
            s = torch.where(mt > 0.0, s, torch.where(mt < 0.0, 2.0 * NEG, NEG))
            m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            den = den * alpha + torch.sum(p, dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(bf(p), vh[:, sl])
            m = m_new
        parts.append((m, den, acc))
    if chunks == 1:
        _, den, acc = parts[0]
    else:
        m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        den = torch.zeros_like(parts[0][1])
        acc = torch.zeros_like(parts[0][2])
        for m, d, a in parts:
            w = torch.exp(m - m_all)
            den = den + w * d
            acc = acc + w * a
    return (acc / den).permute(1, 0, 2).contiguous()


def default_chunks(Kq: int, Kk: int, H: int) -> int:
    """Key chunks of the kernel: enough CTAs for about four on each of the
    H100's 132 SMs (one consumer warpgroup each), at most one chunk per
    key tile."""
    ctas = -(-Kq // QUERY_TILE) * H
    return max(1, min(-(-Kk // KEY_TILE), -(-4 * 132 // ctas)))


def _operand(t: torch.Tensor) -> torch.Tensor:
    """float32, contiguous and 16-byte aligned (the pre-pass loads float4)."""
    t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_mha(
    q: torch.Tensor,  # [Kq, H, dh] f32 (bf16 is accepted; rounded to bf16 inside)
    k: torch.Tensor,  # [Kk, H, dh]
    v: torch.Tensor,  # [Kk, H, dh]
    mask_k: torch.Tensor,  # [Kk] bool
    chunks: int | None = None,
) -> torch.Tensor:
    """[Kq, H, dh] f32 attention output; query rows are not masked.
    `chunks`: the kernel's split of the keys (default `default_chunks`);
    the twin on the CPU runs unsplit."""
    if _build.device_kind(q, k, v, mask_k) == "cpu":
        return flash_mha_reference(q, k, v, mask_k)
    Kq, H, dh = q.shape
    Kk = k.shape[0]
    if dh not in (16, 32, 64) or Kq < 1 or Kk < 1:
        raise ValueError(f"flash_mha kernel takes dh in (16, 32, 64) and Kq, Kk >= 1; "
                         f"got dh={dh}, Kq={Kq}, Kk={Kk}")
    q, k, v, mask_k = _operand(q), _operand(k), _operand(v), mask_k.contiguous()
    _build.expect(q, "q", torch.float32, (Kq, H, dh))
    _build.expect(k, "k", torch.float32, (Kk, H, dh))
    _build.expect(v, "v", torch.float32, (Kk, H, dh))
    _build.expect(mask_k, "mask_k", torch.bool, (Kk,))
    if chunks is None:
        chunks = default_chunks(Kq, Kk, H)
    lib = _build.lib()
    n_ws = lib.slam_flash_mha_workspace_bytes(Kq, Kk, H, dh, chunks)
    if n_ws == 0:
        raise ValueError(f"flash_mha kernel: no plan for Kq={Kq}, Kk={Kk}, H={H}, "
                         f"chunks={chunks}")
    workspace = torch.empty((n_ws,), dtype=torch.uint8, device=q.device)
    out = torch.empty((Kq, H, dh), dtype=torch.float32, device=q.device)
    err = lib.slam_flash_mha(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(mask_k), _build.ptr(out),
        _build.ptr(workspace), Kq, Kk, H, dh, chunks, 1.0 / float(dh) ** 0.5,
        _build.stream(q.device),
    )
    _build.check(err, "flash_mha")
    global launches
    launches += 1
    return out
