// Kernel K6: flash (online-softmax) multi-head attention for LightGlue.
//
// Replaces racing_slam_tpu/ops/pallas/attention_kernel.py:flash_mha.
// out[q, h] = sum_k softmax_k(s[q, h, k]) v[k, h] with s = (q . k) / sqrt(dh),
// where q, k and v are rounded to bf16, the products are summed in float32,
// a masked key's logit is -1e9 (uniform attention when every key is masked)
// and the padding past the last key -2e9. The running max starts at -1e9
// as in the TPU kernel. The running max, denominator and accumulator are
// float32; p is rounded to bf16 before the p.v product, the denominator
// sums the unrounded p. Query masking is the caller's.
//
// Layout: q [Kq, H, dh], k and v [Kk, H, dh] float32, mask [Kk] uint8,
// out [Kq, H, dh] float32.
//
// One block per (64-query tile, head), four warps of 16 queries each. A
// warp keeps its 16 query rows as bf16 mma.sync A fragments in registers.
// Key/value tiles of 64 keys stream through shared memory: K row-major, V
// transposed, both bf16 with padded rows so that the fragment loads hit 32
// distinct banks. Per tile a warp computes S = Q K^T with mma.sync
// m16n8k16 (bf16 in, f32 accumulate), scales and masks it, updates the
// running max and denominator, and feeds exp(S - max), packed to bf16
// straight from the S accumulators (the FlashAttention-2 register reuse),
// into O += P V. No [Kq, Kk] plane leaves registers.
//
// What bounds it on an H100 at the main path's [2400, 4, 32]: the exp of
// every logit, 23 M per call on the special-function units (~5.5 us),
// above the 2.95 GFLOP of the two products on the tensor cores (~3 us)
// and the 4.9 MB of f32 operands (~1.5 us). This first version is single-
// buffered (no copy/compute overlap) and runs 152 blocks of 4 warps, so
// it is bound by latency well above that.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TQ = 16 * WARPS;  // queries per block
constexpr int TK = 64;          // keys per tile
constexpr float NEG = -1e9f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row-major) * b (16x8, column-major); bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_mha_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask_k,
                 float* __restrict__ out, int Kq, int Kk, int H, float scale) {
  constexpr int KS = DH / 16;   // k-steps of q.k
  constexpr int NO = DH / 8;    // 8-wide column blocks of the output
  constexpr int NS = TK / 8;    // 8-wide key blocks of a score tile
  constexpr int KPAD = DH + 8;  // row stride of sK (bf16)
  constexpr int VPAD = TK + 8;  // row stride of sVt (bf16)
  __shared__ __align__(16) __nv_bfloat16 sK[TK * KPAD];
  __shared__ __align__(16) __nv_bfloat16 sVt[DH * VPAD];
  __shared__ float sM[TK];

  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // fragment row group
  const int tg = lane & 3;  // thread within the group
  const size_t stride = (size_t)H * DH;  // floats between tokens
  const int r0 = blockIdx.x * TQ + warp * 16 + g;
  const int r1 = r0 + 8;

  // This warp's 16 query rows as A fragments, rounded to bf16.
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + tg * 2;
    float2 x00 = make_float2(0.f, 0.f), x01 = x00, x10 = x00, x11 = x00;
    if (r0 < Kq) {
      const float* row = q + r0 * stride + h * DH;
      x00 = *reinterpret_cast<const float2*>(row + c);
      x01 = *reinterpret_cast<const float2*>(row + c + 8);
    }
    if (r1 < Kq) {
      const float* row = q + r1 * stride + h * DH;
      x10 = *reinterpret_cast<const float2*>(row + c);
      x11 = *reinterpret_cast<const float2*>(row + c + 8);
    }
    qa[ks][0] = pack_bf16(x00.x, x00.y);
    qa[ks][1] = pack_bf16(x10.x, x10.y);
    qa[ks][2] = pack_bf16(x01.x, x01.y);
    qa[ks][3] = pack_bf16(x11.x, x11.y);
  }

  float m_run[2] = {NEG, NEG};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int k0 = 0; k0 < Kk; k0 += TK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < TK * DH / 2; i += THREADS) {
      const int key = i / (DH / 2);
      const int c = (i % (DH / 2)) * 2;
      const int kk = k0 + key;
      float2 kv = make_float2(0.f, 0.f), vv = kv;
      if (kk < Kk) {
        kv = *reinterpret_cast<const float2*>(k + kk * stride + h * DH + c);
        vv = *reinterpret_cast<const float2*>(v + kk * stride + h * DH + c);
      }
      *reinterpret_cast<__nv_bfloat162*>(&sK[key * KPAD + c]) = __floats2bfloat162_rn(kv.x, kv.y);
      sVt[c * VPAD + key] = __float2bfloat16_rn(vv.x);
      sVt[(c + 1) * VPAD + key] = __float2bfloat16_rn(vv.y);
    }
    for (int i = threadIdx.x; i < TK; i += THREADS) {
      const int kk = k0 + i;
      sM[i] = kk < Kk ? (mask_k[kk] ? 1.f : 0.f) : -1.f;
    }
    __syncthreads();

    // S = Q K^T (16 x TK per warp).
    float s[NS][4];
#pragma unroll
    for (int nb = 0; nb < NS; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      const __nv_bfloat16* krow = sK + (nb * 8 + g) * KPAD + tg * 2;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) mma_bf16(s[nb], qa[ks], ld32(krow + ks * 16), ld32(krow + ks * 16 + 8));
    }

    // Scale, mask, and the tile's row maxima.
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nb = 0; nb < NS; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mk = sM[nb * 8 + tg * 2 + (e & 1)];
        const float x = s[nb][e] * scale;
        s[nb][e] = mk > 0.f ? x : (mk < 0.f ? 2.f * NEG : NEG);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = __expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < NS; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = __expf(s[nb][e] - m_run[e >> 1]);
        rsum[e >> 1] += s[nb][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rsum[r];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V, P packed to bf16 from the S accumulators: key block pair
    // (2kk, 2kk + 1) is the A fragment of k-step kk.
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const __nv_bfloat16* vrow = sVt + (j * 8 + g) * VPAD + kk * 16 + tg * 2;
        mma_bf16(o[j], pa, ld32(vrow), ld32(vrow + 8));
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = j * 8 + tg * 2;
    if (r0 < Kq)
      *reinterpret_cast<float2*>(out + r0 * stride + h * DH + c) =
          make_float2(o[j][0] / l_run[0], o[j][1] / l_run[0]);
    if (r1 < Kq)
      *reinterpret_cast<float2*>(out + r1 * stride + h * DH + c) =
          make_float2(o[j][2] / l_run[1], o[j][3] / l_run[1]);
  }
}

template <int DH>
void launch(const float* q, const float* k, const float* v, const uint8_t* mask_k, float* out,
            int Kq, int Kk, int H, float scale, cudaStream_t stream) {
  const dim3 grid((Kq + TQ - 1) / TQ, H);
  flash_mha_kernel<DH><<<grid, THREADS, 0, stream>>>(q, k, v, mask_k, out, Kq, Kk, H, scale);
}

}  // namespace

SLAM_API int slam_flash_mha(const float* q, const float* k, const float* v, const uint8_t* mask_k,
                            float* out, int Kq, int Kk, int H, int dh, float scale,
                            cudaStream_t stream) {
  if (Kq < 1 || Kk < 1 || H < 1 || H > 65535) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 16: launch<16>(q, k, v, mask_k, out, Kq, Kk, H, scale, stream); break;
    case 32: launch<32>(q, k, v, mask_k, out, Kq, Kk, H, scale, stream); break;
    case 64: launch<64>(q, k, v, mask_k, out, Kq, Kk, H, scale, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
