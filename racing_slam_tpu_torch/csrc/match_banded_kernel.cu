// Kernel K5: banded guided map->frame matching, stage 1 (the scale path).
//
// Replaces racing_slam_tpu/ops/pallas/match_kernel.py:guided_match_stage1_banded.
// K2's contract over y-sorted inputs: map points sorted gated-first by
// projected y, keypoints sorted by y and padded to a multiple of tile_k.
// Point tile i (tile_p points) visits only the keypoints
// [starts[i] * tile_k, (starts[i] + band) * tile_k), the band that covers
// its y-range +- the radius; tiles with i >= *n_act hold no gated point and
// write (0, 1e9) without touching a descriptor. Within the band: pixel,
// point and keypoint gates, then the least squared bf16-product descriptor
// distance over the point's valid observations (float32 sums, norms of the
// rounded vectors, clamped at 0); the argmin keeps the lowest sorted index.
// starts and n_act stay in device memory: the wrapper sets n_act to 0 when
// the band does not fit, and K2 (launched beside this kernel with the same
// flag) does the work instead, so the choice costs no host read.
//
// What bounds it on an H100: the gate scan, n_act * tile_p * band * tile_k
// position tests (8 M at the scale shape), and the latency of the per-pair
// warp reductions for the ~1 % of pairs that pass; the descriptor bytes of
// the active rows (~2 KB a point) are read once. Design: one warp per
// sorted point (eight to a block, all in one point tile); the block stages
// its tile's whole band of keypoint positions and gates in shared memory
// once, and each warp walks it 32 keypoints at a time with a ballot, as K2
// does over all keypoints.
#include "match_common.cuh"

namespace {

using namespace slam_match;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_BAND = 2048;  // keypoints of one band staged in shared memory

template <int DPL>
__global__ void __launch_bounds__(THREADS)
banded_match_kernel(const float* __restrict__ uv_p, const uint8_t* __restrict__ gate_p,
                    const __nv_bfloat16* __restrict__ obs_desc,
                    const uint8_t* __restrict__ obs_valid, const float* __restrict__ kp_uv,
                    const float* __restrict__ kp_desc, const uint8_t* __restrict__ kp_ok,
                    const int* __restrict__ starts, const int* __restrict__ n_act,
                    int* __restrict__ best_k, float* __restrict__ best_d, int P, int O, int D,
                    int K, int tile_p, int tile_k, int band, float radius_sq) {
  __shared__ float s_u[MAX_BAND];
  __shared__ float s_v[MAX_BAND];
  __shared__ uint8_t s_ok[MAX_BAND];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * WARPS + warp;
  const int tile = (blockIdx.x * WARPS) / tile_p;  // the same for the whole block
  float best = BIG;
  int bk = 0;
  if (tile < *n_act) {
    const int k_begin = starts[tile] * tile_k;
    const int width = band * tile_k;
    for (int i = threadIdx.x; i < width; i += THREADS) {
      const int k = k_begin + i;
      const bool in = k >= 0 && k < K;
      s_u[i] = in ? kp_uv[2 * k] : 0.0f;
      s_v[i] = in ? kp_uv[2 * k + 1] : 0.0f;
      s_ok[i] = in ? kp_ok[k] : 0;
    }
    __syncthreads();
    if (p < P && gate_p[p] != 0) {  // uniform within the warp
      const float pu = uv_p[2 * p];
      const float pv = uv_p[2 * p + 1];
      PointDescs<DPL> pt;
      pt.load(obs_desc, obs_valid, p, O, D, lane);
      for (int i0 = 0; i0 < width; i0 += 32) {
        const int i = i0 + lane;
        const bool pass =
            i < width && s_ok[i] != 0 && in_radius(pu - s_u[i], pv - s_v[i], radius_sq);
        unsigned bits = __ballot_sync(0xffffffffu, pass);
        while (bits) {
          const int src = __ffs(bits) - 1;
          bits &= bits - 1;
          const int kk = k_begin + i0 + src;
          const float d = pt.distance(kp_desc + (size_t)kk * D, O, D, lane);
          if (d < best) {
            best = d;
            bk = kk;
          }
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

SLAM_API int slam_guided_match_banded(const float* uv_p, const uint8_t* gate_p,
                                      const __nv_bfloat16* obs_desc, const uint8_t* obs_valid,
                                      const float* kp_uv, const float* kp_desc,
                                      const uint8_t* kp_ok, const int* starts, const int* n_act,
                                      int* best_k, float* best_d, int P, int O, int D, int K,
                                      int tile_p, int tile_k, int band, float radius_sq,
                                      cudaStream_t stream) {
  if (P < 1 || O < 1 || O > MAX_O || D < 32 || D % 32 != 0 || D > 256 || tile_p < WARPS ||
      tile_p % WARPS != 0 || P % tile_p != 0 || tile_k < 1 || band < 1 ||
      band * tile_k > MAX_BAND || K % tile_k != 0 || K < band * tile_k)
    return (int)cudaErrorInvalidValue;
  const int blocks = P / WARPS;
  if (D <= 128)
    banded_match_kernel<4><<<blocks, THREADS, 0, stream>>>(
        uv_p, gate_p, obs_desc, obs_valid, kp_uv, kp_desc, kp_ok, starts, n_act, best_k, best_d,
        P, O, D, K, tile_p, tile_k, band, radius_sq);
  else
    banded_match_kernel<8><<<blocks, THREADS, 0, stream>>>(
        uv_p, gate_p, obs_desc, obs_valid, kp_uv, kp_desc, kp_ok, starts, n_act, best_k, best_d,
        P, O, D, K, tile_p, tile_k, band, radius_sq);
  return (int)cudaGetLastError();
}
