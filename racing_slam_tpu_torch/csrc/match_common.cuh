// Pieces of the guided matchers K2 (match_kernel.cu) and K5
// (match_banded_kernel.cu). Both use the constants and warp_sum; K5 holds
// its map point in PointDescs: one warp keeps the point's O bf16
// observation descriptors in registers, DPL values per lane (descriptor
// element d = lane + 32 j), and evaluates the squared descriptor distance to
// one keypoint as warp-shuffle reductions. K2 keeps the same code inline
// (match_kernel.cu says why).
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace slam_match {

constexpr int MAX_O = 8;
constexpr float BIG = 1e9f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The pixel gate |du, dv|^2 <= r^2: one multiply and one fused multiply-add,
// the cheapest form of the test that ~99 % of pairs fail. The plain versions
// round both products, so a pair within an ulp of the radius may pass on one
// side only; the kernel checks allow such a flip.
__device__ __forceinline__ bool in_radius(float du, float dv, float radius_sq) {
  return du * du + dv * dv <= radius_sq;
}

template <int DPL>  // descriptor values per lane: D <= 32 * DPL
struct PointDescs {
  float od[MAX_O][DPL];
  float on[MAX_O];
  bool ov[MAX_O];

  // Point p's O observation descriptors (bf16) and the norms of the rounded
  // vectors; unused observation slots stay invalid.
  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ obs_desc,
                                       const uint8_t* __restrict__ obs_valid, size_t p, int O,
                                       int D, int lane) {
    const int dpl = D / 32;
#pragma unroll
    for (int o = 0; o < MAX_O; ++o) {
      on[o] = 0.0f;
      ov[o] = false;
#pragma unroll
      for (int j = 0; j < DPL; ++j) od[o][j] = 0.0f;
      if (o < O) {
        ov[o] = obs_valid[p * O + o] != 0;
        float n = 0.0f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          if (j < dpl) {
            const float x = __bfloat162float(obs_desc[(p * O + o) * D + lane + 32 * j]);
            od[o][j] = x;
            n += x * x;
          }
        }
        on[o] = warp_sum(n);
      }
    }
  }

  // min over valid observations of max(n_o + n_k - 2 <o, k>, 0) against the
  // float32 keypoint descriptor `kp` (rounded to bf16 here); BIG if none.
  __device__ __forceinline__ float distance(const float* __restrict__ kp, int O, int D,
                                            int lane) const {
    const int dpl = D / 32;
    float kd[DPL];
    float kn = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      kd[j] = 0.0f;
      if (j < dpl) {
        kd[j] = __bfloat162float(__float2bfloat16_rn(kp[lane + 32 * j]));
        kn += kd[j] * kd[j];
      }
    }
    kn = warp_sum(kn);
    float d = BIG;
#pragma unroll
    for (int o = 0; o < MAX_O; ++o) {
      if (o < O) {
        float c = 0.0f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) c += od[o][j] * kd[j];
        c = warp_sum(c);
        const float dd = fmaxf(on[o] + kn - 2.0f * c, 0.0f);
        if (ov[o]) d = fminf(d, dd);
      }
    }
    return d;
  }
};

}  // namespace slam_match
