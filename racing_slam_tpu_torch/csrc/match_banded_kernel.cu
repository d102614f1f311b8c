// Kernel K5: banded guided map->frame matching, stage 1 (the scale path).
//
// Replaces racing_slam_tpu/ops/pallas/match_kernel.py:guided_match_stage1_banded.
// K2's contract over y-sorted inputs. Sorted row g is the map point
// p_sel[g] (rows sort gated-first by projected y; p_sel[g] >= P is a
// padding row, never gated); the point rows (uv_p, gate_p, obs_desc,
// obs_valid) are read through p_sel, so only the rows of active tiles are
// read. Keypoints come sorted so that key(k) = kp_ok[k] ? v_k : +inf does
// not decrease, padded to a multiple of tile_k. Point tile i (tile_p
// rows) visits only the keypoints [starts[i] * tile_k, (starts[i] + band)
// * tile_k), the band that covers its y-range +- the radius; tiles with
// i >= *n_act hold no gated point and write (0, 1e9) without touching a
// descriptor. Within the band: pixel, point and keypoint gates, then the
// least squared bf16-product descriptor distance over the point's valid
// observations (float32 sums, norms of the rounded vectors, clamped at 0);
// ties go to the lowest sorted index. starts and n_act stay in device
// memory: the wrapper sets n_act to 0 when the band does not fit, and K2
// (launched beside this kernel with the same flag) does the work instead,
// so the choice costs no host read.
//
// Batched over sequences: S independent problems of the same sizes (the
// lockstep tracking step of S sequences) are one launch, blockIdx.y =
// sequence, each problem with its own n_act[s] and starts. The resident
// blocks are split over the S problems (at least one each). A row's answer
// is computed by one warp over that row's units whatever the grid, so each
// row equals a launch of that problem alone to the bit.
//
// What bounds it on an H100: the bytes of the active rows (a point's 8
// bf16 observations are 2 KB at D=128), read once; a full scan of the band
// would test n_act * tile_p * band * tile_k positions (8 M at the scale
// shape), of which ~1 % pass. The design:
//
// - As many blocks as are resident at once, striding over units of eight
//   sorted rows, one row a warp; a unit's rows lie in one point tile. The
//   active tiles are known on the device only, so a grid of a block per
//   unit would be mostly blocks that write (0, 1e9) and leave, in waves
//   behind the working ones; instead the grid writes the inactive rows
//   first, striding over them. Each warp issues its point's loads (the
//   p_sel entry, then the gate, position and observation fragments from
//   clamped indices) before the block stages its unit's band, so their
//   latency overlaps the staging.
// - The block stages its band as (u, key) pairs in shared memory, every
//   load issued before any is stored.
// - The band is sorted by key, so the keypoints within +-r of the point's y
//   are one contiguous run: a warp-wide search (32 probes a round, 3 rounds
//   for 2048 keys) finds the first key >= y - r', and the warp walks from
//   there 32 keypoints at a time, testing the full pixel gate, until a key
//   passes y + r' (r' is the radius plus a margin, so that the run holds
//   every keypoint the gate can pass).
// - The pairs that pass go to the tensor cores, 8 keypoints at a time
//   (match_common.cuh, shared with K2), with the lexicographic (distance,
//   sorted index) best. Candidates are held over rounds of the walk until
//   8 have passed (or the run ends), so that a point's few candidates
//   wait one descriptor round trip, not one a round.
#include <math_constants.h>

#include "match_common.cuh"

namespace {

using namespace slam_match;

constexpr int WARPS = 8;  // = sorted rows a block
constexpr int THREADS = WARPS * 32;
constexpr int MAX_BAND = 2048;  // keypoints of one band staged in shared memory
constexpr int STAGE = MAX_BAND / THREADS;

// The first index in [0, n) whose key (the .y of s[i]) is >= x, or n; the
// keys do not decrease. Each round the 32 lanes probe the ends of 32 equal
// blocks of the remaining range, and the count of keys below x picks the
// block.
__device__ __forceinline__ int lower_bound_warp(const float2* s, int n, float x, int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int i = lo + (lane + 1) * step - 1;
    const bool below = i < hi && s[i].y < x;
    lo += __popc(__ballot_sync(0xffffffffu, below)) * step;
    hi = min(lo + step - 1, hi);
  }
  return lo;
}

template <int NCH>  // 16-element descriptor chunks: D <= 16 * NCH
__global__ void __launch_bounds__(THREADS)
banded_match_kernel(const float* __restrict__ uv_p, const uint8_t* __restrict__ gate_p,
                    const __nv_bfloat16* __restrict__ obs_desc,
                    const uint8_t* __restrict__ obs_valid, const int* __restrict__ p_sel,
                    const float* __restrict__ kp_uv, const float* __restrict__ kp_desc,
                    const uint8_t* __restrict__ kp_ok, const int* __restrict__ starts,
                    const int* __restrict__ n_act, int* __restrict__ best_k,
                    float* __restrict__ best_d, int P, int G, int O, int D, int K, int tile_p,
                    int tile_k, int band, float radius_sq) {
  {  // this block's problem (sequence)
    const size_t s = blockIdx.y;
    uv_p += 2 * (size_t)P * s;
    gate_p += (size_t)P * s;
    obs_desc += (size_t)P * O * D * s;
    obs_valid += (size_t)P * O * s;
    p_sel += (size_t)G * s;
    kp_uv += 2 * (size_t)K * s;
    kp_desc += (size_t)K * D * s;
    kp_ok += (size_t)K * s;
    starts += (size_t)(G / tile_p) * s;
    n_act += s;
    best_k += (size_t)G * s;
    best_d += (size_t)G * s;
  }
  __shared__ float2 s_kp[MAX_BAND];  // (u, key) of the band's keypoints
  __shared__ int s_list[WARPS][64];  // up to 7 held + 32 new candidates

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int active = min(max(*n_act, 0) * tile_p, G);  // rows of the active tiles
  // The inactive tiles' rows: (0, 1e9), the grid striding over them.
  for (int g = active + blockIdx.x * THREADS + threadIdx.x; g < G; g += gridDim.x * THREADS) {
    best_k[g] = 0;
    best_d[g] = BIG;
  }
  const float reach = sqrtf(fmaxf(radius_sq, 0.0f)) * (1.0f + 1.0f / 256.0f) + 1e-3f;
  int* list = s_list[warp];
  // Units of WARPS rows, one row a warp; a unit's rows lie in one tile.
  for (int unit = blockIdx.x; unit < active / WARPS; unit += gridDim.x) {
    const int g = unit * WARPS + warp, tile = unit * WARPS / tile_p;
    // The point's loads first, from clamped indices.
    const int p = __ldg(p_sel + g);
    const int pc = min(max(p, 0), P - 1);
    const bool gated = p >= 0 && p < P && __ldg(gate_p + pc) != 0;
    const float pu = __ldg(uv_p + 2 * pc), pv = __ldg(uv_p + 2 * pc + 1);
    PointObs<NCH> obs;
    obs.load(obs_desc, obs_valid, pc, O, D, lane);

    // The band: (u, key), key = v for a gated keypoint and +inf otherwise.
    const int k_begin = __ldg(starts + tile) * tile_k, width = band * tile_k;
    float2 q[STAGE];
    uint8_t ok[STAGE];
#pragma unroll
    for (int j = 0; j < STAGE; ++j) {
      const int k = min(max(k_begin + (int)threadIdx.x + j * THREADS, 0), K - 1);
      q[j] = __ldg(reinterpret_cast<const float2*>(kp_uv) + k);
      ok[j] = __ldg(kp_ok + k);
    }
    __syncthreads();  // the previous unit is done with the band
#pragma unroll
    for (int j = 0; j < STAGE; ++j) {
      const int i = threadIdx.x + j * THREADS, k = k_begin + i;
      if (i < width)
        s_kp[i] = make_float2(q[j].x, k >= 0 && k < K && ok[j] != 0 ? q[j].y : CUDART_INF_F);
    }
    __syncthreads();

    float best = BIG;
    int bk = 0;
    if (gated) {  // uniform within the warp
      const float top = pv + reach;
      int held = 0;  // candidates in `list`, fewer than 8 between rounds
      for (int i0 = lower_bound_warp(s_kp, width, pv - reach, lane); i0 < width; i0 += 32) {
        const int i = i0 + lane;
        bool pass = false, past = true;
        if (i < width) {
          const float2 kq = s_kp[i];
          const float du = pu - kq.x, dv = pv - kq.y;
          past = kq.y > top;
          pass = !past && du * du + dv * dv <= radius_sq;
        }
        held += collect(pass, k_begin + i, list + held, kp_desc, D, lane);
        const bool last = __any_sync(0xffffffffu, past) || i0 + 32 >= width;
        // Whole batches of 8 now, the rest after the last round: a batch's
        // loads wait a round trip, so fewer, fuller batches.
        const int n = last ? held : held & ~7;
        obs.score(kp_desc, list, n, D, lane, best, bk);
        const int keep = lane < held - n ? list[n + lane] : 0;
        __syncwarp();
        if (lane < held - n) list[lane] = keep;
        __syncwarp();
        held -= n;
        if (last) break;  // the keys beyond are all past the run
      }
      reduce_best(best, bk);
    }
    if (lane == 0) {
      best_k[g] = bk;
      best_d[g] = best;
    }
  }
}

template <int NCH>
cudaError_t launch(cudaStream_t stream, const float* uv_p, const uint8_t* gate_p,
                   const __nv_bfloat16* obs_desc, const uint8_t* obs_valid, const int* p_sel,
                   const float* kp_uv, const float* kp_desc, const uint8_t* kp_ok,
                   const int* starts, const int* n_act, int* best_k, float* best_d, int S,
                   int P, int G, int O, int D, int K, int tile_p, int tile_k, int band,
                   float radius_sq) {
  // As many blocks as are resident at once (the active tiles are known on
  // the device only), split over the S problems: they stride over the
  // rows. Asked once per instance.
  const auto kernel = banded_match_kernel<NCH>;
  struct Resident {
    cudaError_t err;
    int blocks;
  };
  static const Resident resident = [kernel] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    return Resident{e, sms * per_sm};
  }();
  if (resident.err != cudaSuccess) return resident.err;
  const dim3 grid(max(1, min(G / WARPS, resident.blocks / S)), S);
  kernel<<<grid, THREADS, 0, stream>>>(uv_p, gate_p, obs_desc, obs_valid, p_sel, kp_uv,
                                         kp_desc, kp_ok, starts, n_act, best_k, best_d, P, G, O,
                                         D, K, tile_p, tile_k, band, radius_sq);
  return cudaGetLastError();
}

}  // namespace

// S problems: uv_p [S, P, 2], gate_p [S, P], obs_desc [S, P, O, D],
// obs_valid [S, P, O], p_sel [S, G], kp_uv [S, K, 2], kp_desc [S, K, D],
// kp_ok [S, K], starts [S, G / tile_p], n_act [S], best_k and best_d [S, G].
SLAM_API int slam_guided_match_banded(const float* uv_p, const uint8_t* gate_p,
                                      const __nv_bfloat16* obs_desc, const uint8_t* obs_valid,
                                      const int* p_sel, const float* kp_uv, const float* kp_desc,
                                      const uint8_t* kp_ok, const int* starts, const int* n_act,
                                      int* best_k, float* best_d, int S, int P, int G, int O,
                                      int D, int K, int tile_p, int tile_k, int band,
                                      float radius_sq, cudaStream_t stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(kp_desc) % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(kp_uv) % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(obs_desc) % 4 == 0;  // word loads
  if (S < 1 || S > 65535 || P < 1 || G < 1 || O < 1 || O > MAX_O || D < 32 || D % 32 != 0 || D > 256 ||
      tile_p < WARPS || tile_p % WARPS != 0 || G % tile_p != 0 || tile_k < 1 || band < 1 ||
      band * tile_k > MAX_BAND || K % tile_k != 0 || K < band * tile_k || !aligned)
    return (int)cudaErrorInvalidValue;
  return (int)(D <= 128 ? launch<8> : launch<16>)(
      stream, uv_p, gate_p, obs_desc, obs_valid, p_sel, kp_uv, kp_desc, kp_ok, starts, n_act,
      best_k, best_d, S, P, G, O, D, K, tile_p, tile_k, band, radius_sq);
}
