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
queries for 132 SMs, so the keys are split into chunks (see the source):
a pre-pass rounds q, k and v to bf16 once into tiles laid out as the
main kernel's shared memory wants them, plus the mask row; the main
kernel, one CTA per (query tile, head, key chunk), one
warpgroup on wgmma whose thread 0 feeds a ring of key tiles by bulk
asynchronous copies, exp2 of logits scaled and masked in one FFMA, each
chunk's recurrence from m = -1e9, l = 0; and a combine of the
chunks' unnormalised (o, l, m) in chunk order. `default_chunks` splits
one problem's keys so that every SM holds several CTAs.
`flash_mha_reference(..., tile_k=64, chunks=n)` is the same recurrence,
split and combine.

Batched: S problems of one shape (LightGlue over the S frame pairs of a
lockstep frame) take a leading S on every operand ([S, Kq, H, dh],
[S, Kk, H, dh], [S, Kk]) and share each launch, the problem a coordinate
of every grid. The chunks are one problem's (`default_chunks` of one row,
however many rows run), since they set the order of the combine's sums:
so each row equals the call on that row alone to the bit. What S changes
is whether the CTAs fold: `launch_plan` gives one CTA all of a tile's
chunks where the S rows' tiles fill most of their last wave on the card
(at [2400, 4, 32]: 4, 7 or 8 rows), and that CTA runs them one after the
other, each as a CTA of one chunk would, then merges them itself, the
combine's operations in the combine's order: the call is two launches. One call is one count of
`launches`, batched or not; `batched_launches` counts the calls that had
a leading S.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build

launches = 0
batched_launches = 0  # the calls of `launches` that ran S problems at once
NEG = -1e9
KEY_TILE = 64  # keys per tile of the kernel (csrc/attention_kernel.cu TK)
QUERY_TILE = 64
SMS = 132  # streaming multiprocessors of the H100
SPLIT_PER_SM = 4  # CTAs of one chunk that one problem's split aims at on each SM
CTAS_PER_SM = 5  # CTAs of the main kernel an SM holds (csrc MIN_CTAS)
FOLD_FILL = 0.75  # least share of their last wave that folding CTAs must fill


def flash_mha_reference(
    q: torch.Tensor,  # [Kq, H, dh] ([S, Kq, H, dh] for S problems)
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
    all-padding run ends with den = 0 and adds nothing. For leading-S
    operands, row by row."""
    if q.dim() == 4:
        return torch.stack([flash_mha_reference(*row, tile_k=tile_k, chunks=chunks)
                            for row in zip(q, k, v, mask_k)])
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
    """Key chunks of one problem: enough CTAs of one chunk for about
    SPLIT_PER_SM on each of the SMS SMs, at most one chunk per key tile. A
    batched call takes one problem's chunks."""
    ctas = -(-Kq // QUERY_TILE) * H
    return max(1, min(-(-Kk // KEY_TILE), -(-SPLIT_PER_SM * SMS // ctas)))


class LaunchPlan(NamedTuple):
    chunks: int  # key chunks of a problem (its combine's order)
    tiles_per_chunk: int  # key tiles of a chunk
    units: int  # (query tile, head) pairs of a problem
    fold: bool  # one CTA a unit runs every chunk and merges them: no combine
    ctas: int  # CTAs of the main kernel
    launches: int  # kernel launches of the call


def launch_plan(S: int, Kq: int, Kk: int, H: int, chunks: int | None = None) -> LaunchPlan:
    """The kernel's geometry for S problems. The chunks (and so each
    problem's bits) do not depend on S. The CTAs fold (one CTA a (problem,
    query tile, head) runs every chunk and merges them, and no combine is
    launched) where a problem has one chunk, or where those CTAs fill at
    least FOLD_FILL of their last wave of CTAS_PER_SM x SMS: a folded CTA
    is `chunks` times as long, so a thin last wave costs more than the
    combine saves. At [2400, 4, 32] they fold at S = 4, 7 and 8, and run
    one chunk a CTA, as a single call does, at S = 1-3, 5 and 6 (PERF.md,
    measured both ways at every S)."""
    chunks = chunks or default_chunks(Kq, Kk, H)
    units = -(-Kq // QUERY_TILE) * H
    slots = CTAS_PER_SM * SMS
    fold = chunks == 1 or S * units >= FOLD_FILL * -(-S * units // slots) * slots
    tiles = -(-Kk // KEY_TILE)
    return LaunchPlan(chunks=chunks, tiles_per_chunk=-(-tiles // chunks), units=units, fold=fold,
                      ctas=S * units * (1 if fold else chunks), launches=2 if fold else 3)


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
    """[Kq, H, dh] f32 attention output, or [S, Kq, H, dh] for S problems
    given a leading S on every operand; query rows are not masked.
    `chunks`: the kernel's split of the keys (default `default_chunks` of
    one problem; the CTAs fold as `launch_plan` says); the twin on the CPU
    runs unsplit. The kernel has no
    backward (nor has the TPU kernel), and the twin's bf16 casts would pass
    gradients straight through, so an operand that requires grad raises, on
    either device: a loss takes `models.lightglue`'s float32 route."""
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_mha has no backward: an operand requires grad; "
                           "differentiate LightGlue with attn_backend='xla_flash'")
    if _build.device_kind(q, k, v, mask_k) == "cpu":
        return flash_mha_reference(q, k, v, mask_k)
    lead = tuple(q.shape[:-3])  # () or (S,)
    if len(lead) > 1:
        raise ValueError(f"q: expected [Kq, H, dh] or [S, Kq, H, dh], got {tuple(q.shape)}")
    S = lead[0] if lead else 1
    Kq, H, dh = q.shape[-3:]
    Kk = k.shape[-3]
    if dh not in (16, 32, 64) or Kq < 1 or Kk < 1 or S < 1:
        raise ValueError(f"flash_mha kernel takes dh in (16, 32, 64) and S, Kq, Kk >= 1; "
                         f"got dh={dh}, S={S}, Kq={Kq}, Kk={Kk}")
    q, k, v, mask_k = _operand(q), _operand(k), _operand(v), mask_k.contiguous()
    _build.expect(q, "q", torch.float32, (*lead, Kq, H, dh))
    _build.expect(k, "k", torch.float32, (*lead, Kk, H, dh))
    _build.expect(v, "v", torch.float32, (*lead, Kk, H, dh))
    _build.expect(mask_k, "mask_k", torch.bool, (*lead, Kk))
    plan = launch_plan(S, Kq, Kk, H, chunks)
    lib = _build.lib()
    n_ws = lib.slam_flash_mha_seq_workspace_bytes(S, Kq, Kk, H, dh, plan.chunks)
    if n_ws == 0:
        raise ValueError(f"flash_mha kernel: no plan for S={S}, Kq={Kq}, Kk={Kk}, H={H}, "
                         f"{plan}")
    workspace = torch.empty((n_ws,), dtype=torch.uint8, device=q.device)
    out = torch.empty((*lead, Kq, H, dh), dtype=torch.float32, device=q.device)
    err = lib.slam_flash_mha_seq(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(mask_k), _build.ptr(out),
        _build.ptr(workspace), S, Kq, Kk, H, dh, plan.chunks, int(plan.fold),
        1.0 / float(dh) ** 0.5, _build.stream(q.device),
    )
    _build.check(err, "flash_mha")
    global launches, batched_launches
    launches += 1
    batched_launches += bool(lead)
    return out
