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
operands (~1.5 us). The kernel keeps every score tile in registers (no
[Kq, Kk] logits in memory) and runs both products on mma.sync; see the
source for its design.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0
NEG = -1e9


def flash_mha_reference(
    q: torch.Tensor,  # [Kq, H, dh]
    k: torch.Tensor,  # [Kk, H, dh]
    v: torch.Tensor,  # [Kk, H, dh]
    mask_k: torch.Tensor,  # [Kk] bool
    tile_k: int = 512,
) -> torch.Tensor:
    """Plain-PyTorch twin: the TPU kernel's recurrence at its default key
    tile (512), with its rounding points. bf16 q, k, v; f32 logits times
    1/sqrt(dh); masked keys -1e9, tile padding -2e9; running max from -1e9;
    p rounded to bf16 for p.v, unrounded in the denominator. The bf16
    products are exact in float32, so it agrees with the JAX kernel up to
    the order of float32 sums."""
    Kq, H, dh = q.shape
    Kk = k.shape[0]
    scale = 1.0 / float(dh) ** 0.5
    nk = -(-Kk // tile_k)
    pad = nk * tile_k - Kk
    bf = lambda x: x.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    qh = bf(q).permute(1, 0, 2)  # [H, Kq, dh]
    kh = torch.nn.functional.pad(bf(k), (0, 0, 0, 0, 0, pad)).permute(1, 2, 0)  # [H, dh, Kp]
    vh = torch.nn.functional.pad(bf(v), (0, 0, 0, 0, 0, pad)).permute(1, 0, 2)  # [H, Kp, dh]
    mk = torch.nn.functional.pad(mask_k.to(torch.float32), (0, pad), value=-1.0)
    m = torch.full((H, Kq, 1), NEG, dtype=torch.float32, device=q.device)
    den = torch.zeros((H, Kq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((H, Kq, dh), dtype=torch.float32, device=q.device)
    for j in range(nk):
        sl = slice(j * tile_k, (j + 1) * tile_k)
        s = torch.matmul(qh, kh[:, :, sl]) * scale  # [H, Kq, T]
        mt = mk[sl]
        s = torch.where(mt > 0.0, s, torch.where(mt < 0.0, 2.0 * NEG, NEG))
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        den = den * alpha + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(bf(p), vh[:, sl])
        m = m_new
    return (acc / den).permute(1, 0, 2).contiguous()


def _operand(t: torch.Tensor) -> torch.Tensor:
    """float32, contiguous and 16-byte aligned (the kernel loads float2)."""
    t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_mha(
    q: torch.Tensor,  # [Kq, H, dh] f32 (bf16 is accepted; rounded to bf16 inside)
    k: torch.Tensor,  # [Kk, H, dh]
    v: torch.Tensor,  # [Kk, H, dh]
    mask_k: torch.Tensor,  # [Kk] bool
) -> torch.Tensor:
    """[Kq, H, dh] f32 attention output; query rows are not masked."""
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
    out = torch.empty((Kq, H, dh), dtype=torch.float32, device=q.device)
    err = _build.lib().slam_flash_mha(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(mask_k), _build.ptr(out),
        Kq, Kk, H, dh, 1.0 / float(dh) ** 0.5, _build.stream(q.device),
    )
    _build.check(err, "flash_mha")
    global launches
    launches += 1
    return out
