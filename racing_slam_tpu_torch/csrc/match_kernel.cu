// Kernel K2: guided map->frame matching, stage 1 (best keypoint per point).
//
// Replaces racing_slam_tpu/ops/pallas/match_kernel.py:guided_match_stage1.
// For every map point: among keypoints within the pixel radius of its
// projection that pass the point and keypoint gates, the one with the least
// squared descriptor distance min_o (n_o + n_k - 2 <o, k>) over the point's
// valid observations o, where descriptors are rounded to bf16, products and
// sums are float32, and the result is clamped at 0. Ties go to the lowest
// keypoint index; a point with no passing pair gets (k = 0, d = 1e9).
//
// One warp per map point. A block stages a tile of keypoint positions and
// gates in shared memory; each warp tests 32 keypoints per step against its
// point's pixel gate and evaluates the descriptor distance only for the
// pairs that pass (a ballot, walked in keypoint order so the running strict
// minimum keeps the lowest index). The point's O bf16 observation
// descriptors stay in registers, D/32 values per lane; a pair's O dot
// products and the keypoint norm are warp-shuffle reductions.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KT = 256;      // keypoints staged per tile
constexpr int MAX_O = 8;
constexpr int MAX_DPL = 4;   // descriptor values per lane: D <= 128
constexpr float BIG = 1e9f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS)
guided_match_kernel(const float* __restrict__ uv_p, const uint8_t* __restrict__ gate_p,
                    const __nv_bfloat16* __restrict__ obs_desc,
                    const uint8_t* __restrict__ obs_valid, const float* __restrict__ kp_uv,
                    const float* __restrict__ kp_desc, const uint8_t* __restrict__ kp_ok,
                    int* __restrict__ best_k, float* __restrict__ best_d, int P, int O, int D,
                    int K, float radius_sq) {
  __shared__ float s_u[KT];
  __shared__ float s_v[KT];
  __shared__ uint8_t s_ok[KT];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * WARPS + warp;
  const bool active = p < P && gate_p[p] != 0;  // uniform within the warp
  const int dpl = D / 32;

  float od[MAX_O][MAX_DPL];
  float on[MAX_O];
  bool ov[MAX_O];
  float pu = 0.0f, pv = 0.0f;
#pragma unroll
  for (int o = 0; o < MAX_O; ++o) {
    on[o] = 0.0f;
    ov[o] = false;
#pragma unroll
    for (int j = 0; j < MAX_DPL; ++j) od[o][j] = 0.0f;
  }
  if (active) {
    pu = uv_p[2 * p];
    pv = uv_p[2 * p + 1];
#pragma unroll
    for (int o = 0; o < MAX_O; ++o) {
      if (o < O) {
        ov[o] = obs_valid[p * O + o] != 0;
        float n = 0.0f;
#pragma unroll
        for (int j = 0; j < MAX_DPL; ++j) {
          if (j < dpl) {
            const float x = __bfloat162float(obs_desc[((size_t)p * O + o) * D + lane + 32 * j]);
            od[o][j] = x;
            n += x * x;
          }
        }
        on[o] = warp_sum(n);
      }
    }
  }

  float best = BIG;
  int bk = 0;
  for (int k0 = 0; k0 < K; k0 += KT) {
    __syncthreads();
    for (int i = threadIdx.x; i < KT; i += THREADS) {
      const int k = k0 + i;
      const bool in = k < K;
      s_u[i] = in ? kp_uv[2 * k] : 0.0f;
      s_v[i] = in ? kp_uv[2 * k + 1] : 0.0f;
      s_ok[i] = in ? kp_ok[k] : 0;
    }
    __syncthreads();
    if (!active) continue;
    for (int i0 = 0; i0 < KT; i0 += 32) {
      const int i = i0 + lane;
      const float du = pu - s_u[i];
      const float dv = pv - s_v[i];
      const bool pass = s_ok[i] != 0 && du * du + dv * dv <= radius_sq;
      unsigned bits = __ballot_sync(0xffffffffu, pass);
      while (bits) {
        const int src = __ffs(bits) - 1;
        bits &= bits - 1;
        const int kk = k0 + i0 + src;
        float kd[MAX_DPL];
        float kn = 0.0f;
#pragma unroll
        for (int j = 0; j < MAX_DPL; ++j) {
          kd[j] = 0.0f;
          if (j < dpl) {
            kd[j] = __bfloat162float(__float2bfloat16_rn(kp_desc[(size_t)kk * D + lane + 32 * j]));
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
            for (int j = 0; j < MAX_DPL; ++j) c += od[o][j] * kd[j];
            c = warp_sum(c);
            const float dd = fmaxf(on[o] + kn - 2.0f * c, 0.0f);
            if (ov[o]) d = fminf(d, dd);
          }
        }
        if (d < best) {
          best = d;
          bk = kk;
        }
      }
    }
  }
  if (p < P && lane == 0) {
    best_k[p] = bk;
    best_d[p] = best;
  }
}

}  // namespace

SLAM_API int slam_guided_match(const float* uv_p, const uint8_t* gate_p,
                               const __nv_bfloat16* obs_desc, const uint8_t* obs_valid,
                               const float* kp_uv, const float* kp_desc, const uint8_t* kp_ok,
                               int* best_k, float* best_d, int P, int O, int D, int K,
                               float radius_sq, cudaStream_t stream) {
  if (P < 1 || O < 1 || O > MAX_O || D < 32 || D % 32 != 0 || D > 32 * MAX_DPL || K < 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (P + WARPS - 1) / WARPS;
  guided_match_kernel<<<blocks, THREADS, 0, stream>>>(uv_p, gate_p, obs_desc, obs_valid, kp_uv,
                                                      kp_desc, kp_ok, best_k, best_d, P, O, D,
                                                      K, radius_sq);
  return (int)cudaGetLastError();
}
