// The descriptor stage shared by the guided matchers K2 (match_kernel.cu)
// and K5 (match_banded_kernel.cu): one warp scores the keypoints that
// passed a map point's gates on the tensor cores.
//
// The pairs go to mma.m16n8k16 (bf16 in, float32 sums) 8 keypoints at a
// time, one mma per 16 descriptor elements, with A = the point's 8
// observations (rows 0-7) over the 8 keypoints (rows 8-15) and B = the 8
// keypoints. Rows 0-7 of the product are <o, k>; the diagonal of rows
// 8-15 is each keypoint's norm n_k. The keypoint rows are rounded to bf16
// as they are loaded; the point's observation fragments and norms stay in
// registers for the point. Lane l works on observation / keypoint slot
// l >> 2 and descriptor pairs (l & 3) and (l & 3) + 4 of each 16-element
// chunk (the mma fragment layout). A 3-step min across the lanes of a
// column takes the minimum over observations. The tensor cores sum in a
// fixed order, so equal descriptors give equal distances wherever they sit
// in a batch; the running best is lexicographic in (distance, keypoint
// index), so the lowest index wins a tie whatever order the candidates
// arrive in.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace slam_match {

constexpr int MAX_O = 8;
constexpr float BIG = 1e9f;

// Two float32 values rounded to a bf16 pair (x in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float2 x) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The squares of a bf16 pair, summed in float32.
__device__ __forceinline__ float sq_bf16(uint32_t w) {
  const float lo = __uint_as_float(w << 16), hi = __uint_as_float(w & 0xffff0000u);
  return lo * lo + hi * hi;
}

// c += A B for one 16 x 8 x 16 tile: bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The lexicographic running best: (d, k) replaces (best, bk) if it is less.
__device__ __forceinline__ void take_best(float d, int k, float& best, int& bk) {
  if (k >= 0 && (d < best || (d == best && k < bk))) {
    best = d;
    bk = k;
  }
}

// A map point's observations in the mma layout: the fragments of
// observation `slot` and its norm (the 4 lanes of the slot each hold a
// quarter of it), and whether it is valid.
template <int NCH>  // 16-element descriptor chunks: D <= 16 * NCH
struct PointObs {
  uint32_t of[NCH][2];
  float on;
  bool ov;

  // Point p's O observation rows (bf16) and flags; every load is issued,
  // from a clamped address, before any is used.
  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ obs_desc,
                                       const uint8_t* __restrict__ obs_valid, size_t p, int O,
                                       int D, int lane) {
    const int slot = lane >> 2, quad = lane & 3, nch = D / 16;
    const bool has_o = slot < O;
    const int o = has_o ? slot : 0;
    ov = has_o && obs_valid[p * O + o] != 0;
    const uint32_t* orow = reinterpret_cast<const uint32_t*>(obs_desc + (p * O + o) * D);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int cc = c < nch ? c : 0;
      of[c][0] = __ldg(orow + 8 * cc + quad);
      of[c][1] = __ldg(orow + 8 * cc + 4 + quad);
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      if (!(c < nch && has_o)) of[c][0] = of[c][1] = 0u;
    on = 0.0f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) on += sq_bf16(of[c][0]) + sq_bf16(of[c][1]);
    on += __shfl_xor_sync(0xffffffffu, on, 1);
    on += __shfl_xor_sync(0xffffffffu, on, 2);
  }

  // Scores the `n` keypoints of `list` (indices into kp_desc, float32 rows
  // of D) against the point: min over valid observations of
  // max(n_o + n_k - 2 <o, k>, 0), folded into the lexicographic running
  // best. Lanes 0-3 end with the best of columns (2l, 2l + 1); reduce()
  // gives it to every lane.
  __device__ __forceinline__ void score(const float* __restrict__ kp_desc,
                                        const int* __restrict__ list, int n, int D, int lane,
                                        float& best, int& bk) const {
    const int slot = lane >> 2, quad = lane & 3, nch = D / 16;
    for (int b0 = 0; b0 < n; b0 += 8) {
      const int kk = b0 + slot < n ? list[b0 + slot] : -1;  // this slot's keypoint
      // Every load is issued, from a clamped address, before any is used
      // (a guarded load would wait for the one before it).
      const float* krow = kp_desc + (size_t)(kk < 0 ? list[0] : kk) * D + 2 * quad;
      // Two accumulators (even and odd chunks) halve the chain of
      // dependent mma; their sum is taken in one fixed order.
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, acc2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int c0 = 0; c0 < NCH; c0 += 8) {  // 8 chunks' loads in flight at a time
        if (c0 < nch) {
          float2 x[8][2];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int cc = c0 + c < nch ? c0 + c : 0;
            x[c][0] = __ldg(reinterpret_cast<const float2*>(krow + 16 * cc));
            x[c][1] = __ldg(reinterpret_cast<const float2*>(krow + 16 * cc + 8));
          }
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            if (c0 + c < nch) {
              const uint32_t k0 = kk < 0 ? 0u : pack_bf16(x[c][0]);
              const uint32_t k1 = kk < 0 ? 0u : pack_bf16(x[c][1]);
              if (c % 2 == 0)
                mma_bf16(acc, of[c0 + c][0], k0, of[c0 + c][1], k1, k0, k1);
              else
                mma_bf16(acc2, of[c0 + c][0], k0, of[c0 + c][1], k1, k0, k1);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += acc2[i];
      // acc: <o_slot, k_2quad>, <o_slot, k_2quad+1>, and the same two
      // columns against keypoint `slot`; n_k of column j sits in lane
      // 4 j + j / 2 (row 8 + j).
      const float kn0 = __shfl_sync(0xffffffffu, acc[2], 9 * quad);
      const float kn1 = __shfl_sync(0xffffffffu, acc[3], 9 * quad + 4);
      const int k0 = __shfl_sync(0xffffffffu, kk, 8 * quad);
      const int k1 = __shfl_sync(0xffffffffu, kk, 8 * quad + 4);
      float d0 = ov ? fmaxf(on + kn0 - 2.0f * acc[0], 0.0f) : BIG;
      float d1 = ov ? fmaxf(on + kn1 - 2.0f * acc[1], 0.0f) : BIG;
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        d0 = fminf(d0, __shfl_xor_sync(0xffffffffu, d0, m));
        d1 = fminf(d1, __shfl_xor_sync(0xffffffffu, d1, m));
      }
      take_best(d0, k0, best, bk);
      take_best(d1, k1, best, bk);
    }
  }
};

// After score(): the least (distance, index) of lanes 0-3, in every lane.
__device__ __forceinline__ void reduce_best(float& best, int& bk) {
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, best, m);
    const int ok = __shfl_xor_sync(0xffffffffu, bk, m);
    take_best(od, ok, best, bk);
  }
}

// Appends this lane's candidate `k` (where `pass`) to the warp's `list` in
// lane order and prefetches its descriptor row into L1, where score()
// finds it; returns how many lanes passed. `list` holds 32 ints.
__device__ __forceinline__ int collect(bool pass, int k, int* list, const float* kp_desc, int D,
                                       int lane) {
  const unsigned bits = __ballot_sync(0xffffffffu, pass);
  if (pass) {
    list[__popc(bits & ((1u << lane) - 1u))] = k;
    const char* rp = reinterpret_cast<const char*>(kp_desc + (size_t)k * D);
    for (int l = 0; l < D / 32; ++l) asm volatile("prefetch.global.L1 [%0];" ::"l"(rp + 128 * l));
  }
  __syncwarp();
  return __popc(bits);
}

}  // namespace slam_match
