// Kernel K3: motion-only bundle adjustment, the whole LM loop in one block.
//
// Replaces racing_slam_tpu/ops/pallas/motion_ba_kernel.py:motion_ba_planes.
// One free 6-DoF pose (angle-axis + translation) against K fixed points:
// normalized-plane residual with fx only, Huber IRLS weights, 21 + 6 normal
// equation sums, the damped 6x6 solve by two 3x3 blocks, accept (lambda/3)
// or reject (lambda*2), and Ceres' function-tolerance exit. Damping follows
// the plain solver, H + lambda * (diag H + 1e-9 I) (ops/ba.py motion_ba),
// not the TPU kernel's flat +1e-9 on the diagonal.
//
// What bounds it on an H100: latency. A solve is a handful of iterations,
// each ~150 float32 operations on each of ~1700 valid rows, a sum over
// all rows, and a 6x6 solve that every row waits for; one CTA on one SM
// runs it, and the design keeps that SM's iteration short:
//
// - One fused pass an iteration. The pass at a pose yields its robust cost,
//   its Huber weights and the 21 H + 6 g sums: 28 sums in one reduction.
//   The trial pose's pass decides accept or reject by its cost; on accept
//   its H and g are the next iteration's linearisation (the same numbers
//   the next iteration would compute), on reject the previous H and g stay
//   and lambda grows. The first pass, at the initial pose, yields the
//   initial cost and the first H and g. One pass and one block reduction an
//   iteration.
// - The rows are read from global memory once. Invalid rows are dropped by
//   a block-wide scan (warp ballots, 8 rows a thread loaded at once), and
//   the kept rows are stored compacted and pre-normalised (X, (u - cx) / fx,
//   (v - cy) / fx: 20 bytes) in dynamic shared memory, which holds them up
//   to K = 11000 or so (720p's K = 7200 takes 144 KB); above that the
//   rows are streamed from global memory every pass. Rows held in
//   registers instead (up to 5 a thread) were not faster on an H100.
// - The 28 partials are reduced by a reduce-scatter across each warp's
//   lanes (31 shuffles a thread in place of 28 x 5, lane l ends with the
//   warp's sum l); warp 0 sums the warps' values in warp
//   order and keeps sum l of the current linearisation in lane l.
// - Warp 0 alone takes the accept / exit decision, solves the damped 6x6
//   system (two 3x3 blocks) and computes the next trial pose's rotation,
//   R Jr and translation into shared memory; a barrier hands them to the
//   other warps. Two barriers an iteration. (Every warp solving
//   redundantly from the totals, one barrier an iteration, was slower on
//   an H100, tools/match_ab.py: sixteen warps issuing the same serial
//   solve keep the SM's four schedulers busy four times as long as one.)
//
// Batched over sequences: S independent solves of K rows each (the
// lockstep tracking step of S sequences) are one launch of S CTAs,
// blockIdx.x = sequence, each on its own rows, pose and [8] output. A
// CTA's work is the single solve's, so each sequence's result equals a
// launch of that sequence alone to the bit; S = 1 is the single solve.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int NSUM = 28;  // H 21, g 6, cost 1
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block can use
constexpr int CH = 8;     // rows a thread loads at once while compacting
constexpr int FIXED_BYTES = (WARPS * 32 + 24 + CH * WARPS + 4) * 4;  // red, xf, counts

// One row's terms at the pose (R, t), with A = R Jr: acc[0..20] += w J^T J
// (upper triangle), acc[21..26] += w J^T r, acc[27] += the Huber cost.
// The rotation block of the Jacobian, -R [X]x Jr in camera_jacobian
// (common.cuh), is taken as -[R X]x A (R [X]x = [R X]x R): column j is
// A[:, j] x (R X), 18 operations a row in place of 45.
__device__ __forceinline__ void add_row(const float R[9], const float A[9], const float t[3],
                                        float x0, float x1, float x2, float un, float vn,
                                        float huber, float (&acc)[NSUM]) {
  const float y0 = R[0] * x0 + R[1] * x1 + R[2] * x2;
  const float y1 = R[3] * x0 + R[4] * x1 + R[5] * x2;
  const float y2 = R[6] * x0 + R[7] * x1 + R[8] * x2;
  const float pz = y2 + t[2];
  const float z_safe = fabsf(pz) < 1e-9f ? 1e-9f : pz;
  const float inv_z = __frcp_rn(z_safe);  // the correctly rounded 1 / z_safe
  const float gx = (y0 + t[0]) * inv_z;
  const float gy = (y1 + t[1]) * inv_z;
  const float r0 = gx - un;
  const float r1 = gy - vn;
  const float s = r0 * r0 + r1 * r1;
  acc[27] += huber_cost(s, huber);
  const float w = huber_weight(s, huber);
  float J0[6], J1[6];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float d0 = A[3 + j] * y2 - A[6 + j] * y1;
    const float d1 = A[6 + j] * y0 - A[j] * y2;
    const float d2 = A[j] * y1 - A[3 + j] * y0;
    J0[j] = inv_z * (d0 - gx * d2);
    J1[j] = inv_z * (d1 - gy * d2);
  }
  J0[3] = inv_z;
  J0[4] = 0.0f;
  J0[5] = -gx * inv_z;
  J1[3] = 0.0f;
  J1[4] = inv_z;
  J1[5] = -gy * inv_z;
  // J0[4] and J1[3] are 0: their products are left out.
  float wJ0[6], wJ1[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    wJ0[i] = w * J0[i];
    wJ1[i] = w * J1[i];
  }
  int n = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) {
      if (i != 4 && j != 4) acc[n] = fmaf(wJ0[i], J0[j], acc[n]);
      if (i != 3 && j != 3) acc[n] = fmaf(wJ1[i], J1[j], acc[n]);
      ++n;
    }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    if (i != 4) acc[21 + i] = fmaf(wJ0[i], r0, acc[21 + i]);
    if (i != 3) acc[21 + i] = fmaf(wJ1[i], r1, acc[21 + i]);
  }
}

// One halving step of the warp reduce-scatter: lanes with `M` set keep the
// upper HALF values and send the lower ones to lane ^ M, the others the
// reverse (every index a compile-time constant, so `v` stays in registers).
template <int HALF, int M>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[32], int lane) {
  const bool hi = lane & M;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float keep = hi ? v[i + HALF] : v[i];
    const float give = hi ? v[i] : v[i + HALF];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, give, M);
  }
}

// Block total of the 28 partials, for warp 0: lane l of warp 0 gets total
// l (l < 28), the warps' values summed in warp order. The other warps
// return after the barrier; `red` is rewritten only after the next
// barrier that warp 0 reaches once it has read it.
__device__ __forceinline__ float block_total(float (&acc)[NSUM], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) v[i] = i < NSUM ? acc[i] : 0.0f;
  reduce_scatter_step<16, 16>(v, lane);  // after five halvings lane l holds the warp's sum l
  reduce_scatter_step<8, 8>(v, lane);
  reduce_scatter_step<4, 4>(v, lane);
  reduce_scatter_step<2, 2>(v, lane);
  reduce_scatter_step<1, 1>(v, lane);
  red[warp * 32 + lane] = v[0];
  __syncthreads();
  float total = 0.0f;
  if (warp == 0) {
    total = red[lane];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) total += red[w * 32 + lane];
  }
  return total;
}

// The transform of pose w that every row needs: R, A = R Jr, t (21 floats).
__device__ __forceinline__ void pose_transform(const float w[6], float* xf) {
  float R[9], Jr[9];
  rodrigues(w, R, Jr);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      xf[3 * i + j] = R[3 * i + j];
      xf[9 + 3 * i + j] = R[3 * i] * Jr[j] + R[3 * i + 1] * Jr[3 + j] + R[3 * i + 2] * Jr[6 + j];
    }
#pragma unroll
  for (int i = 0; i < 3; ++i) xf[18 + i] = w[3 + i];
}

template <bool IN_SHARED>  // rows compacted in shared memory, else streamed
__global__ void __launch_bounds__(THREADS)
motion_ba_kernel(const float* __restrict__ pose0, const float* __restrict__ kp_uv,
                 const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
                 float* __restrict__ out, int K, float fx, float cx, float cy, float lam0,
                 float huber, float ftol, int max_iters) {
  extern __shared__ __align__(16) float smem[];
  float* red = smem;                                            // [WARPS][32]
  float* s_xf = red + WARPS * 32;                               // [21] + go flag
  int* s_go = reinterpret_cast<int*>(s_xf + 21);
  int* s_cnt = reinterpret_cast<int*>(s_xf + 24);               // [CH][WARPS] + total
  float* s_rows = s_xf + 24 + CH * WARPS + 4;                   // [5][K]: x, y, z, u, v
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  {  // this CTA's sequence
    const size_t s = blockIdx.x;
    pose0 += 6 * s;
    kp_uv += 2 * (size_t)K * s;
    xyz += 3 * (size_t)K * s;
    valid += (size_t)K * s;
    out += 8 * s;
  }

  // Compact the valid rows into shared memory, pre-normalised: CH rows a
  // thread loaded together, a ballot per row, the warps' counts scanned by
  // warp 0, three barriers a group of CH x THREADS rows.
  int n = 0;
  if (IN_SHARED) {
    for (int g0 = 0; g0 < K; g0 += CH * THREADS) {
      float x0[CH], x1[CH], x2[CH], u[CH], v[CH];
      uint8_t okv[CH];
      unsigned bits[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        // Every load from a clamped index, before any is used (a guarded
        // load would wait for the one before it).
        const int k = min(g0 + j * THREADS + tid, K - 1);
        okv[j] = valid[k];
        x0[j] = xyz[3 * k];
        x1[j] = xyz[3 * k + 1];
        x2[j] = xyz[3 * k + 2];
        u[j] = kp_uv[2 * k];
        v[j] = kp_uv[2 * k + 1];
      }
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        bits[j] = __ballot_sync(0xffffffffu, g0 + j * THREADS + tid < K && okv[j] != 0);
        if (lane == 0) s_cnt[j * WARPS + warp] = __popc(bits[j]);
      }
      __syncthreads();
      if (warp == 0) {  // exclusive prefix of the counts in (row, warp) order, in place
        static_assert(CH * WARPS == 4 * 32, "four counts a lane");
        int c[4], run = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          c[i] = s_cnt[4 * lane + i];
          run += c[i];
        }
        int incl = run;
#pragma unroll
        for (int m = 1; m < 32; m <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, m);
          if (lane >= m) incl += y;
        }
        int before = incl - run;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s_cnt[4 * lane + i] = before;
          before += c[i];
        }
        if (lane == 31) s_cnt[CH * WARPS] = incl;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        if (bits[j] & (1u << lane)) {
          const int pos = n + s_cnt[j * WARPS + warp] + __popc(bits[j] & ((1u << lane) - 1u));
          s_rows[pos] = x0[j];
          s_rows[K + pos] = x1[j];
          s_rows[2 * K + pos] = x2[j];
          s_rows[3 * K + pos] = (u[j] - cx) / fx;
          s_rows[4 * K + pos] = (v[j] - cy) / fx;
        }
      }
      n += s_cnt[CH * WARPS];
      __syncthreads();  // s_cnt is rewritten by the next group; rows are complete
    }
  }
  // The fused pass at the pose whose transform is in s_xf: the block
  // totals of the 28 sums, total l in lane l of warp 0.
  auto pass = [&]() -> float {
    float xf[21];
#pragma unroll
    for (int i = 0; i < 21; ++i) xf[i] = s_xf[i];
    const float* R = xf;
    const float* A = xf + 9;
    const float* t = xf + 18;
    float acc[NSUM];
#pragma unroll
    for (int i = 0; i < NSUM; ++i) acc[i] = 0.0f;
    if (IN_SHARED) {
      for (int i = tid; i < n; i += THREADS)
        add_row(R, A, t, s_rows[i], s_rows[K + i], s_rows[2 * K + i], s_rows[3 * K + i],
                s_rows[4 * K + i], huber, acc);
    } else {
      for (int k = tid; k < K; k += THREADS) {
        if (!valid[k]) continue;
        add_row(R, A, t, xyz[3 * k], xyz[3 * k + 1], xyz[3 * k + 2], (kp_uv[2 * k] - cx) / fx,
                (kp_uv[2 * k + 1] - cy) / fx, huber, acc);
      }
    }
    return block_total(acc, red);
  };

  // Warp 0 holds the LM state (pose, lambda, cost, and sum `lane` of the
  // linearisation at the pose), decides, solves and writes the next trial
  // pose's transform; the other warps take the rows of each pass.
  float pose[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) pose[i] = pose0[i];
  if (tid == 0) pose_transform(pose, s_xf);
  __syncthreads();
  float lin = pass();
  float cost = __shfl_sync(0xffffffffu, lin, 27);
  float lam = lam0;
  int it = 0;
  bool done = false;
  float trial[6];
  while (true) {
    if (warp == 0) {
      const bool go = it < max_iters && !done;
      if (go) {
        float H[36], g[6], x[6];
        int m = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int j = i; j < 6; ++j) {
            const float h = __shfl_sync(0xffffffffu, lin, m++);
            H[i * 6 + j] = h;
            H[j * 6 + i] = h;
          }
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          g[i] = __shfl_sync(0xffffffffu, lin, 21 + i);
          H[i * 6 + i] += lam * (H[i * 6 + i] + 1e-9f);
        }
        solve6(H, g, x);
#pragma unroll
        for (int i = 0; i < 6; ++i) trial[i] = pose[i] - x[i];
        if (lane == 0) pose_transform(trial, s_xf);
      }
      if (lane == 0) *s_go = go;
    }
    __syncthreads();
    if (!*s_go) break;
    const float tot = pass();
    if (warp == 0) {
      const float new_cost = __shfl_sync(0xffffffffu, tot, 27);
      const bool accept = new_cost < cost;
      done = (accept && (cost - new_cost <= ftol * cost)) || (lam > 1e8f);
      if (accept) {
#pragma unroll
        for (int i = 0; i < 6; ++i) pose[i] = trial[i];
        cost = new_cost;
        lin = tot;
        lam = fmaxf(lam / 3.0f, 1e-9f);
      } else {
        lam = lam * 2.0f;
      }
      ++it;
    }
  }
  if (tid == 0) {
    for (int i = 0; i < 6; ++i) out[i] = pose[i];
    out[6] = cost;
    out[7] = (float)it;
  }
}

template <bool IN_SHARED>
cudaError_t launch(size_t smem, cudaStream_t stream, const float* pose0, const float* kp_uv,
                   const float* xyz, const uint8_t* valid, float* out, int S, int K, float fx,
                   float cx, float cy, float lam0, float huber, float ftol, int max_iters) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      motion_ba_kernel<IN_SHARED>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  motion_ba_kernel<IN_SHARED><<<S, THREADS, smem, stream>>>(
      pose0, kp_uv, xyz, valid, out, K, fx, cx, cy, lam0, huber, ftol, max_iters);
  return cudaGetLastError();
}

}  // namespace

// S solves of K rows each: pose0 [S, 6], kp_uv [S, K, 2], xyz [S, K, 3],
// valid [S, K], out [S, 8].
SLAM_API int slam_motion_ba(const float* pose0, const float* kp_uv, const float* xyz,
                            const uint8_t* valid, float* out, int S, int K, float fx, float cx,
                            float cy, float lam0, float huber, float ftol, int max_iters,
                            cudaStream_t stream) {
  if (S < 1 || S > 65535 || K < 0 || max_iters < 0) return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)K * 5 * sizeof(float);
  const bool in_shared = FIXED_BYTES + rows <= SMEM_MAX;
  return (int)(in_shared ? launch<true> : launch<false>)(FIXED_BYTES + (in_shared ? rows : 0),
                                                         stream, pose0, kp_uv, xyz, valid, out,
                                                         S, K, fx, cx, cy, lam0, huber, ftol,
                                                         max_iters);
}
