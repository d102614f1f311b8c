// Kernel K3: motion-only bundle adjustment, the whole LM loop in one
// thread-block cluster.
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
// all rows, and a 6x6 solve that every row waits for. The design spreads
// each iteration's rows over eight SMs, and a CTA waits in an iteration
// only for the other CTAs' sums:
//
// - One cluster of CLUSTER = 8 CTAs (portable) of THREADS = 128 threads a
//   solve, launched with cudaLaunchKernelEx. CTA r compacts the valid rows
//   of its fixed, contiguous slice of the K rows, [r * slice, (r + 1) *
//   slice) with slice = ceil(K / 8), into its own shared memory once,
//   pre-normalised (X, (u - cx) / fx, (v - cy) / fx: 20 bytes a row):
//   CH rows a thread loaded at once, a ballot a row, the warps' counts
//   scanned by warp 0. Shared memory holds a slice of up to ~11000 rows,
//   so K up to 8 x that; a larger K is refused (no caller passes one:
//   720p's K = 7200 is 900 rows a CTA).
// - One fused pass an iteration. The pass at a pose yields its robust
//   cost, its Huber weights and the 21 H + 6 g sums: 28 sums. The trial
//   pose's pass decides accept or reject by its cost; on accept its H and
//   g are the next iteration's linearisation, on reject the previous ones
//   stay and lambda grows. The first pass, at the initial pose, yields the
//   initial cost and the first H and g.
// - The 28 partials of a warp are reduced by a reduce-scatter across its
//   lanes (31 shuffles a thread; lane l ends with the warp's sum l), and
//   lane l stores sum l into slot (rank, warp) of every CTA of the cluster
//   with st.async: a store into distributed shared memory that counts its
//   4 bytes on a barrier (mbarrier) in the CTA it lands in. A CTA's barrier
//   for a pass completes when all 8 x 4 x 28 values of the pass have
//   landed there, so each CTA waits for its own data only, and no cluster
//   barrier runs in the loop (one, cluster.sync, after the compaction;
//   PERF.md has the cost of a cluster.sync an iteration). Then lane l of every warp of every CTA sums the
//   8 x 4 slots of its value from its own shared memory, pairwise in
//   (rank, warp) order (a tree five additions deep), so all hold
//   bit-identical totals, take the same accept / exit decision, solve the
//   damped 6x6 system (two 3x3 blocks) and compute the trial pose's
//   rotation (one sincosf), R Jr and translation themselves, in registers.
//   No CTA or warp waits for another's solve. (On one SM every warp
//   solving was slower than one warp solving and a barrier; here a CTA's
//   four warps are one a scheduler.)
// - Two slot arrays and their two barriers alternate between passes. A CTA
//   stores pass p + 2's values only once it has all of pass p + 1's, which
//   every CTA stores only after it has read pass p's: no slot is
//   overwritten before it is read, and no store lands in a barrier phase
//   but its own. Thread 0 re-arms a barrier for pass p + 2 as soon as it
//   has seen pass p's phase complete.
//
// Batched over sequences: S independent solves of K rows each (the
// lockstep tracking step of S sequences) are one launch of S clusters,
// grid (8, S), blockIdx.y = sequence, each on its own rows, pose and [8]
// output. Every launch takes the same cluster, whatever S is, so every
// sum keeps its order and each sequence's result equals a launch of that
// sequence alone to the bit; S = 1 is the single solve. The card holds
// slam_motion_ba_max_clusters such clusters at once; the rest queue.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;  // CTAs a solve
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int NSUM = 28;  // H 21, g 6, cost 1
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block can use
constexpr int CH = 8;     // rows a thread loads at once while compacting
constexpr int NCNT = CH * WARPS;  // ballot counts of one group of CH x THREADS rows
static_assert(NCNT % 32 == 0, "whole counts a lane of warp 0");
// Fixed part of the dynamic shared memory, in floats: two slot arrays
// [CLUSTER][WARPS][32], the compaction counts (+ total) padded to a
// multiple of 4, and the slot arrays' two barriers (8 bytes each).
constexpr int SLOTS = CLUSTER * WARPS * 32;
constexpr int BAR_AT = (2 * SLOTS + NCNT + 1 + 3) / 4 * 4;
constexpr int FIXED_FLOATS = BAR_AT + 4;
constexpr unsigned PASS_BYTES = CLUSTER * WARPS * NSUM * sizeof(float);  // a pass's slots

// Shared memory of a CTA whose slice holds `slice` rows.
__host__ __device__ inline size_t smem_bytes(int slice) {
  return (FIXED_FLOATS + 5 * (size_t)slice) * sizeof(float);
}

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

// The warp's sum of partial `lane` (lane < NSUM).
__device__ __forceinline__ float warp_sums(const float (&acc)[NSUM], int lane) {
  float v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) v[i] = i < NSUM ? acc[i] : 0.0f;
  reduce_scatter_step<16, 16>(v, lane);  // after five halvings lane l holds the warp's sum l
  reduce_scatter_step<8, 8>(v, lane);
  reduce_scatter_step<4, 4>(v, lane);
  reduce_scatter_step<2, 2>(v, lane);
  reduce_scatter_step<1, 1>(v, lane);
  return v[0];
}

// Shared-window address of a pointer into this CTA's shared memory, and the
// same offset in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned cluster_addr(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// Barrier `bar` (one arrival a phase) expects `bytes` bytes of stores in
// its current phase; the arrival is this call.
__device__ __forceinline__ void expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// v stored at cluster address `at`, its 4 bytes counted on the barrier at
// cluster address `bar` of the same CTA.
__device__ __forceinline__ void store_counted(unsigned at, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                   at),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// Wait for the phase of barrier `bar` with parity `parity` to complete (its
// stores, from every CTA of the cluster, are then visible); a wait of
// ~2^26 polls traps instead of hanging.
__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  unsigned done = 0;
  for (long long polls = 0; !done; ++polls) {
    asm volatile(
        "{\n .reg .pred P;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P, [%1], %2;\n"
        " selp.u32 %0, 1, 0, P;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls > (1ll << 26)) __trap();
  }
}

// The transform of pose w that every row needs: R, A = R Jr, t (21 floats).
__device__ __forceinline__ void pose_transform(const float w[6], float (&xf)[21]) {
  float R[9], Jr[9];
  rodrigues<true>(w, R, Jr);
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

__global__ void __launch_bounds__(THREADS)
motion_ba_kernel(const float* __restrict__ pose0, const float* __restrict__ kp_uv,
                  const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
                  float* __restrict__ out, int K, int slice, float fx, float cx, float cy,
                  float lam0, float huber, float ftol, int max_iters) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  float* slots = smem;                                          // [2][CLUSTER][WARPS][32]
  int* s_cnt = reinterpret_cast<int*>(smem + 2 * SLOTS);        // [CH][WARPS] + total
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem + BAR_AT);  // [2]
  float* s_rows = smem + FIXED_FLOATS;                          // [5][slice]: x, y, z, u, v
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  {  // this cluster's sequence
    const size_t s = blockIdx.y;
    pose0 += 6 * s;
    kp_uv += 2 * (size_t)K * s;
    xyz += 3 * (size_t)K * s;
    valid += (size_t)K * s;
    out += 8 * s;
  }

  // Compact the valid rows of this CTA's slice into shared memory,
  // pre-normalised: CH rows a thread loaded together, a ballot per row,
  // the warps' counts scanned by warp 0, in row order.
  const int k0 = min(K, rank * slice), m = min(K, k0 + slice) - k0;
  int n = 0;
  for (int g0 = 0; g0 < m; g0 += CH * THREADS) {
    float x0[CH], x1[CH], x2[CH], u[CH], v[CH];
    uint8_t okv[CH];
    unsigned bits[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      // Every load from a clamped index, before any is used (a guarded
      // load would wait for the one before it).
      const int k = k0 + min(g0 + j * THREADS + tid, m - 1);
      okv[j] = valid[k];
      x0[j] = xyz[3 * k];
      x1[j] = xyz[3 * k + 1];
      x2[j] = xyz[3 * k + 2];
      u[j] = kp_uv[2 * k];
      v[j] = kp_uv[2 * k + 1];
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      bits[j] = __ballot_sync(0xffffffffu, g0 + j * THREADS + tid < m && okv[j] != 0);
      if (lane == 0) s_cnt[j * WARPS + warp] = __popc(bits[j]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive prefix of the counts in (row, warp) order, in place
      constexpr int PER = NCNT / 32;
      int c[PER], run = 0;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        c[i] = s_cnt[PER * lane + i];
        run += c[i];
      }
      int incl = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      int before = incl - run;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        s_cnt[PER * lane + i] = before;
        before += c[i];
      }
      if (lane == 31) s_cnt[NCNT] = incl;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (bits[j] & (1u << lane)) {
        const int pos = n + s_cnt[j * WARPS + warp] + __popc(bits[j] & ((1u << lane) - 1u));
        s_rows[pos] = x0[j];
        s_rows[slice + pos] = x1[j];
        s_rows[2 * slice + pos] = x2[j];
        s_rows[3 * slice + pos] = (u[j] - cx) / fx;
        s_rows[4 * slice + pos] = (v[j] - cy) / fx;
      }
    }
    n += s_cnt[NCNT];
    __syncthreads();  // s_cnt is rewritten by the next group; rows are complete
  }
  if (tid == 0) {  // the slot arrays' barriers, armed for passes 0 and 1
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(s_bar + b))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int b = 0; b < 2; ++b) expect_bytes(smem_addr(s_bar + b), PASS_BYTES);
  }
  cluster.sync();  // every CTA has started and armed its barriers

  // The fused pass at the pose whose transform is xf, as pass number p:
  // the cluster's total of sum `lane` (lane < NSUM), in every thread.
  auto pass = [&](const float (&xf)[21], int p) -> float {
    const float* R = xf;
    const float* A = xf + 9;
    const float* t = xf + 18;
    float acc[NSUM];
#pragma unroll
    for (int i = 0; i < NSUM; ++i) acc[i] = 0.0f;
    for (int i = tid; i < n; i += THREADS)
      add_row(R, A, t, s_rows[i], s_rows[slice + i], s_rows[2 * slice + i],
              s_rows[3 * slice + i], s_rows[4 * slice + i], huber, acc);
    const float mine = warp_sums(acc, lane);
    float* slot = slots + (p & 1) * SLOTS;
    const unsigned bar = smem_addr(s_bar + (p & 1));
    if (lane < NSUM) {
      const unsigned at = smem_addr(slot + (rank * WARPS + warp) * 32 + lane);
#pragma unroll
      for (int c = 0; c < CLUSTER; ++c)
        store_counted(cluster_addr(at, c), mine, cluster_addr(bar, c));
    }
    wait_phase(bar, (p >> 1) & 1);  // pass p is the (p / 2)-th phase of its barrier
    if (tid == 0) expect_bytes(bar, PASS_BYTES);  // armed for pass p + 2
    float total = 0.0f;
    if (lane < NSUM) {  // the slots summed pairwise in (rank, warp) order
      float v[CLUSTER * WARPS];
#pragma unroll
      for (int i = 0; i < CLUSTER * WARPS; ++i) v[i] = slot[i * 32 + lane];
#pragma unroll
      for (int w = 1; w < CLUSTER * WARPS; w *= 2)
#pragma unroll
        for (int i = 0; i < CLUSTER * WARPS; i += 2 * w) v[i] += v[i + w];
      total = v[0];
    }
    return total;
  };

  // Every thread holds the LM state (pose, lambda, cost, and sum `lane` of
  // the linearisation at the pose), the same in every thread of the
  // cluster, and takes every decision itself.
  float pose[6], xf[21];
#pragma unroll
  for (int i = 0; i < 6; ++i) pose[i] = pose0[i];
  pose_transform(pose, xf);
  int p = 0;
  float lin = pass(xf, p++);
  float cost = __shfl_sync(0xffffffffu, lin, 27);
  float lam = lam0;
  int it = 0;
  bool done = false;
  while (it < max_iters && !done) {
    float H[36], g[6], x[6], trial[6];
    int q = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = i; j < 6; ++j) {
        const float h = __shfl_sync(0xffffffffu, lin, q++);
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
    pose_transform(trial, xf);
    const float tot = pass(xf, p++);
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
  // Every store into this CTA's shared memory has landed (its last pass's
  // barrier phase completed); the armed phases that never complete are left.
  if (rank == 0 && tid == 0) {
    for (int i = 0; i < 6; ++i) out[i] = pose[i];
    out[6] = cost;
    out[7] = (float)it;
  }
}

// The launch of S solves of K rows as S clusters of CLUSTER CTAs.
cudaLaunchConfig_t launch_config(int S, int K, cudaStream_t stream, cudaLaunchAttribute* attr) {
  const int slice = (K + CLUSTER - 1) / CLUSTER;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, S, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(slice);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t set_attributes() {
  static const cudaError_t err = cudaFuncSetAttribute(
      motion_ba_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  return err;
}

bool fits(int K) { return K >= 0 && smem_bytes((K + CLUSTER - 1) / CLUSTER) <= SMEM_MAX; }

}  // namespace

// How many clusters of the launch for K rows the card holds at once
// (cudaOccupancyMaxActiveClusters); a negative CUDA error code on failure.
SLAM_API int slam_motion_ba_max_clusters(int K) {
  if (!fits(K)) return -(int)cudaErrorInvalidValue;
  cudaError_t err = set_attributes();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(1, K, nullptr, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, motion_ba_kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// S solves of K rows each: pose0 [S, 6], kp_uv [S, K, 2], xyz [S, K, 3],
// valid [S, K], out [S, 8]. K is refused where a CTA's slice of the rows
// does not fit in its shared memory.
SLAM_API int slam_motion_ba(const float* pose0, const float* kp_uv, const float* xyz,
                            const uint8_t* valid, float* out, int S, int K, float fx, float cx,
                            float cy, float lam0, float huber, float ftol, int max_iters,
                            cudaStream_t stream) {
  if (S < 1 || S > 65535 || !fits(K) || max_iters < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t attr_err = set_attributes();
  if (attr_err != cudaSuccess) return (int)attr_err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(S, K, stream, attr);
  const int slice = (K + CLUSTER - 1) / CLUSTER;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, motion_ba_kernel, pose0, kp_uv, xyz, valid,
                                             out, K, slice, fx, cx, cy, lam0, huber, ftol,
                                             max_iters);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
