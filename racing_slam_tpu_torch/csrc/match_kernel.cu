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
// What bounds it on an H100: the gate, if it is a scan. At radius 28 px on
// 640x480 about 19 of K = 2400 keypoints pass for each point, so a P x K
// scan of positions is ~99 % waste, and the descriptor work that remains
// (~50k pairs of 8 x D products) is a few microseconds of the card's issue
// rate as float32 FMAs and far less on its tensor cores. The design:
//
// - One launch of persistent CTAs of 512 threads, one per SM (the
//   registers of the descriptor stage allow no more, 128 a thread), so
//   that an SM bins the keypoints once. Each CTA bins the frame's
//   keypoints (those that pass the keypoint gate) into a cell grid in its
//   shared memory: their extent by a block min / max, the grid by
//   cell_grid below (tests/match_grid_model.py models it for the tests),
//   per-cell counts by shared-memory atomics, a block prefix sum, and a
//   scatter of (u, v) and the keypoint index into cell order. The cell
//   side is at least the radius, so a point's disc lies in its 3 x 3
//   cells; a point or keypoint outside the grid is clamped to an
//   edge cell, which keeps that true. Each thread holds 8 keypoints in
//   registers while binning, so a CTA bins up to 4096 keypoints at a time;
//   a larger K is taken in chunks of 4096, the running best carried in the
//   outputs.
// - Each warp reads the gates of 32 of its map points at once and walks
//   the gated ones. It tests only the candidates of the point's 3 x 3 cells
//   (three contiguous runs of the cell-ordered arrays, one per cell row), 32
//   at a time, by a ballot, and prefetches the passing keypoints'
//   descriptor rows into L1.
// - The pairs that pass every gate go to the tensor cores, 8 keypoints at
//   a time (match_common.cuh, shared with K5). Candidates arrive in cell
//   order, not index order, so the running best is lexicographic in
//   (distance, keypoint index): the lowest index wins a tie, as in the
//   dense scan.
//
// Batched over sequences: S independent problems of the same sizes (the
// lockstep tracking step of S sequences) are one launch, blockIdx.y =
// sequence. Each problem gets sms / S persistent CTAs (at least one), so
// the grid stays one resident wave whatever S is; each CTA bins its own
// problem's keypoints and strides over its own problem's points. A point's
// answer depends only on its problem's data (the lexicographic best over
// candidates in cell order), not on the CTA count, so each problem's
// result equals a launch of that problem alone to the bit.
//
// `skip` (may be null) is a device flag per problem: when it is set, the call writes
// (0, 1e9) everywhere and returns. The banded matcher launches this kernel
// as its dense fallback with skip = "the band fit", so that the choice
// between K5 and K2 is made on the device, without a host read. Only the
// SKIP instance reads the flag; the dense path runs the instance without it.
#include "match_common.cuh"

namespace {

using namespace slam_match;

constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int KPT = 8;                  // keypoints a thread holds while binning
constexpr int KC = KPT * THREADS;       // keypoints binned at a time
constexpr int CAP = 64;                 // cells per side at most
constexpr int CELL_INTS = CAP * CAP + 1;  // cell starts + the end sentinel
constexpr int FIXED_BYTES = (CELL_INTS * 4 + 4 * WARPS * 4 + WARPS * 32 * 4 + 15) / 16 * 16;
constexpr int SMEM_MAX = 232448;        // dynamic shared memory a block can use

struct Grid {
  float lo_u, lo_v, side, inv_side;
  int nx, ny;
};

// The cell grid over the keypoints' extent [lo, hi]: side at least the
// radius (with a margin of 1/256 against float rounding) and at least the
// extent over CAP, cells per side capped at CAP. tests/match_grid_model.py
// is the same rule in numpy float32: change both together.
__device__ __forceinline__ Grid cell_grid(float lo_u, float lo_v, float hi_u, float hi_v,
                                          float radius) {
  const float eu = hi_u - lo_u, ev = hi_v - lo_v;
  const float side = fmaxf(fmaxf(radius * (1.0f + 1.0f / 256.0f), eu / CAP),
                           fmaxf(ev / CAP, 1e-6f));
  Grid g;
  g.lo_u = lo_u;
  g.lo_v = lo_v;
  g.side = side;
  g.inv_side = 1.0f / side;
  g.nx = (int)fminf((float)CAP, floorf(eu / side) + 1.0f);
  g.ny = (int)fminf((float)CAP, floorf(ev / side) + 1.0f);
  return g;
}

// Cell coordinate of x, clamped to [0, n - 1] (NaN goes to 0).
__device__ __forceinline__ int cell_of(float x, float lo, float inv_side, int n) {
  return (int)fminf(fmaxf(floorf((x - lo) * inv_side), 0.0f), (float)(n - 1));
}

template <int NCH, bool SKIP>  // 16-element descriptor chunks: D <= 16 * NCH
__global__ void __launch_bounds__(THREADS)
guided_match_kernel(const float* __restrict__ uv_p, const uint8_t* __restrict__ gate_p,
                    const __nv_bfloat16* __restrict__ obs_desc,
                    const uint8_t* __restrict__ obs_valid, const float* __restrict__ kp_uv,
                    const float* __restrict__ kp_desc, const uint8_t* __restrict__ kp_ok,
                    const uint8_t* __restrict__ skip, int* __restrict__ best_k,
                    float* __restrict__ best_d, int P, int O, int D, int K, float radius_sq) {
  {  // this CTA's problem (sequence)
    const size_t s = blockIdx.y;
    uv_p += 2 * (size_t)P * s;
    gate_p += (size_t)P * s;
    obs_desc += (size_t)P * O * D * s;
    obs_valid += (size_t)P * O * s;
    kp_uv += 2 * (size_t)K * s;
    kp_desc += (size_t)K * D * s;
    kp_ok += (size_t)K * s;
    if (SKIP) skip += s;
    best_k += (size_t)P * s;
    best_d += (size_t)P * s;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_cell = reinterpret_cast<int*>(smem);                       // [CELL_INTS]
  float* s_red = reinterpret_cast<float*>(s_cell + CELL_INTS);      // [4 * WARPS]
  int* s_list = reinterpret_cast<int*>(s_red + 4 * WARPS);          // [WARPS][32]
  const int kc = K < KC ? K : KC;
  float2* s_kuv = reinterpret_cast<float2*>(smem + FIXED_BYTES);    // [kc], cell order
  int* s_ki = reinterpret_cast<int*>(s_kuv + kc);                   // [kc]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gw = blockIdx.x * WARPS + warp, nw = gridDim.x * WARPS;
  if (SKIP && *skip != 0) {
    for (int p = blockIdx.x * THREADS + tid; p < P; p += gridDim.x * THREADS) {
      best_k[p] = 0;
      best_d[p] = BIG;
    }
    return;
  }
  const float radius = sqrtf(fmaxf(radius_sq, 0.0f));
  const int n_chunks = K == 0 ? 1 : (K + KC - 1) / KC;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int k0 = ch * KC;
    const int kn = min(K - k0, KC);
    // Bin this chunk's gated keypoints: extent, grid, counts, starts, scatter.
    float ku[KPT], kv[KPT];
    int cr[KPT];  // cell << 16 | rank within the cell; -1 for no keypoint
    const float inf = __int_as_float(0x7f800000);
    float lo_u = inf, lo_v = inf, hi_u = -inf, hi_v = -inf;
    uint8_t okb[KPT] = {};
    if (kn > 0) {  // every load from a clamped index, before any is used
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int i = min(tid + j * THREADS, kn - 1);
        const float2 q = __ldg(reinterpret_cast<const float2*>(kp_uv) + k0 + i);
        ku[j] = q.x;
        kv[j] = q.y;
        okb[j] = __ldg(kp_ok + k0 + i);
      }
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      cr[j] = kn > 0 && tid + j * THREADS < kn && okb[j] != 0 ? 0 : -1;
      if (cr[j] == 0) {
        lo_u = fminf(lo_u, ku[j]);
        lo_v = fminf(lo_v, kv[j]);
        hi_u = fmaxf(hi_u, ku[j]);
        hi_v = fmaxf(hi_v, kv[j]);
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      lo_u = fminf(lo_u, __shfl_xor_sync(0xffffffffu, lo_u, m));
      lo_v = fminf(lo_v, __shfl_xor_sync(0xffffffffu, lo_v, m));
      hi_u = fmaxf(hi_u, __shfl_xor_sync(0xffffffffu, hi_u, m));
      hi_v = fmaxf(hi_v, __shfl_xor_sync(0xffffffffu, hi_v, m));
    }
    __syncthreads();  // the previous chunk's readers are done with shared memory
    if (lane == 0) {
      s_red[4 * warp] = lo_u;
      s_red[4 * warp + 1] = lo_v;
      s_red[4 * warp + 2] = hi_u;
      s_red[4 * warp + 3] = hi_v;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      lo_u = fminf(lo_u, s_red[4 * w]);
      lo_v = fminf(lo_v, s_red[4 * w + 1]);
      hi_u = fmaxf(hi_u, s_red[4 * w + 2]);
      hi_v = fmaxf(hi_v, s_red[4 * w + 3]);
    }
    const bool any = lo_u <= hi_u;  // some keypoint passed its gate
    const Grid g = cell_grid(lo_u, lo_v, any ? hi_u : lo_u, any ? hi_v : lo_v, radius);
    const int ncell = any ? g.nx * g.ny : 0;
    for (int c = tid; c <= ncell; c += THREADS) s_cell[c] = 0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      if (cr[j] == 0) {
        const int c = cell_of(kv[j], g.lo_v, g.inv_side, g.ny) * g.nx +
                      cell_of(ku[j], g.lo_u, g.inv_side, g.nx);
        cr[j] = (c << 16) | atomicAdd(&s_cell[c], 1);
      }
    }
    __syncthreads();
    // Exclusive prefix sum of the counts, in place: each thread a run of
    // up to CAP * CAP / THREADS consecutive cells, then a scan over the
    // threads.
    const int per = (ncell + THREADS - 1) / THREADS;
    int cnt[CAP * CAP / THREADS];
    int run = 0;
#pragma unroll
    for (int i = 0; i < CAP * CAP / THREADS; ++i) {
      const int c = tid * per + i;
      cnt[i] = (i < per && c < ncell) ? s_cell[c] : 0;
      run += cnt[i];
    }
    int incl = run;
#pragma unroll
    for (int m = 1; m < 32; m <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, m);
      if (lane >= m) incl += y;
    }
    if (lane == 31) s_red[warp] = __int_as_float(incl);
    __syncthreads();
    int before = incl - run, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int t = __float_as_int(s_red[w]);
      before += w < warp ? t : 0;
      total += t;
    }
#pragma unroll
    for (int i = 0; i < CAP * CAP / THREADS; ++i) {
      const int c = tid * per + i;
      if (i < per && c < ncell) s_cell[c] = before;
      before += cnt[i];
    }
    if (tid == 0) s_cell[ncell] = total;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      if (cr[j] >= 0) {
        const int pos = s_cell[cr[j] >> 16] + (cr[j] & 0xffff);
        s_kuv[pos] = make_float2(ku[j], kv[j]);
        s_ki[pos] = k0 + tid + j * THREADS;
      }
    }
    __syncthreads();

    // Each warp's map points against their 3 x 3 cells. The warp reads the
    // gates of its next 32 points at once (lane i: point p0 + i * nw),
    // writes (0, 1e9) for those not gated and walks the gated ones.
    int* list = s_list + warp * 32;
    for (int p0 = gw; p0 < P; p0 += 32 * nw) {
      const int pl = p0 + lane * nw;
      const bool gl = pl < P && any && gate_p[pl] != 0;
      if (ch == 0 && pl < P && !gl) {
        best_k[pl] = 0;
        best_d[pl] = BIG;
      }
      unsigned gbits = __ballot_sync(0xffffffffu, gl);
      while (gbits) {
        const int p = p0 + (__ffs(gbits) - 1) * nw;
        gbits &= gbits - 1;
        float best = BIG;
        int bk = 0;
        if (ch > 0) {
          best = best_d[p];
          bk = best_k[p];
        }
        const float pu = uv_p[2 * p], pv = uv_p[2 * p + 1];
        PointObs<NCH> obs;
        obs.load(obs_desc, obs_valid, p, O, D, lane);

        const int cx = cell_of(pu, g.lo_u, g.inv_side, g.nx);
        const int cy = cell_of(pv, g.lo_v, g.inv_side, g.ny);
        const int xa = max(cx - 1, 0), xb = min(cx + 1, g.nx - 1);
        const int ya = max(cy - 1, 0), yb = min(cy + 1, g.ny - 1);
        int st[3], len[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const int y = ya + r;
          st[r] = y <= yb ? s_cell[y * g.nx + xa] : 0;
          len[r] = y <= yb ? s_cell[y * g.nx + xb + 1] - st[r] : 0;
        }
        const int T = len[0] + len[1] + len[2];
        for (int base = 0; base < T; base += 32) {
          const int t = base + lane;
          bool pass = false;
          int mk = 0;
          if (t < T) {
            const int at = t < len[0]            ? st[0] + t
                           : t < len[0] + len[1] ? st[1] + t - len[0]
                                                 : st[2] + t - len[0] - len[1];
            const float2 q = s_kuv[at];
            const float du = pu - q.x, dv = pv - q.y;
            pass = du * du + dv * dv <= radius_sq;
            mk = s_ki[at];
          }
          const int npass = collect(pass, mk, list, kp_desc, D, lane);
          obs.score(kp_desc, list, npass, D, lane, best, bk);
          __syncwarp();  // `list` is rewritten by the next round
        }
        reduce_best(best, bk);
        if (lane == 0) {
          best_k[p] = bk;
          best_d[p] = best;
        }
      }
    }
  }
}

template <int NCH, bool SKIP>
cudaError_t launch(cudaStream_t stream, const float* uv_p, const uint8_t* gate_p,
                   const __nv_bfloat16* obs_desc, const uint8_t* obs_valid, const float* kp_uv,
                   const float* kp_desc, const uint8_t* kp_ok, const uint8_t* skip, int* best_k,
                   float* best_d, int S, int P, int O, int D, int K, float radius_sq) {
  const auto kernel = guided_match_kernel<NCH, SKIP>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  const size_t smem = FIXED_BYTES + (size_t)(K < KC ? K : KC) * (sizeof(float2) + sizeof(int));
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int need = (P + WARPS - 1) / WARPS;  // no more CTAs than a warp a point
  const int per_seq = sms / S > 1 ? sms / S : 1;  // one resident wave over all S problems
  const dim3 grid(per_seq < need ? per_seq : need, S);
  kernel<<<grid, THREADS, smem, stream>>>(uv_p, gate_p, obs_desc, obs_valid, kp_uv, kp_desc,
                                            kp_ok, skip, best_k, best_d, P, O, D, K, radius_sq);
  return cudaGetLastError();
}

template <int NCH>
cudaError_t dispatch(cudaStream_t stream, const float* uv_p, const uint8_t* gate_p,
                     const __nv_bfloat16* obs_desc, const uint8_t* obs_valid, const float* kp_uv,
                     const float* kp_desc, const uint8_t* kp_ok, const uint8_t* skip,
                     int* best_k, float* best_d, int S, int P, int O, int D, int K,
                     float radius_sq) {
  return (skip != nullptr ? launch<NCH, true> : launch<NCH, false>)(
      stream, uv_p, gate_p, obs_desc, obs_valid, kp_uv, kp_desc, kp_ok, skip, best_k, best_d, S,
      P, O, D, K, radius_sq);
}

}  // namespace

// S problems: uv_p [S, P, 2], gate_p [S, P], obs_desc [S, P, O, D],
// obs_valid [S, P, O], kp_uv [S, K, 2], kp_desc [S, K, D], kp_ok [S, K],
// skip [S] or null, best_k and best_d [S, P].
SLAM_API int slam_guided_match(const float* uv_p, const uint8_t* gate_p,
                               const __nv_bfloat16* obs_desc, const uint8_t* obs_valid,
                               const float* kp_uv, const float* kp_desc, const uint8_t* kp_ok,
                               const uint8_t* skip, int* best_k, float* best_d, int S, int P,
                               int O, int D, int K, float radius_sq, cudaStream_t stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(kp_desc) % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(kp_uv) % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(obs_desc) % 4 == 0;  // word loads
  if (S < 1 || S > 65535 || P < 1 || O < 1 || O > MAX_O || D < 32 || D % 32 != 0 || D > 256 ||
      K < 0 || !aligned)
    return (int)cudaErrorInvalidValue;
  return (int)(D <= 128 ? dispatch<8> : dispatch<16>)(stream, uv_p, gate_p, obs_desc, obs_valid,
                                                      kp_uv, kp_desc, kp_ok, skip, best_k, best_d,
                                                      S, P, O, D, K, radius_sq);
}
