// Kernel K4: single-free-camera Schur bundle adjustment, the whole LM loop
// in one thread-block cluster.
//
// Replaces racing_slam_tpu/ops/pallas/structure_ba_kernel.py:structure_ba_planes.
// One free camera (`free_slot`) + free points, every other camera frozen.
// Per LM iteration: per point, the 3x3 Hessian Hpp, gradient g_p and the
// 6x3 coupling Y with the free camera over the point's O observations; the
// free camera's Hcc and g_c; damped per-point inverses (zero for frozen
// points); the reduced 6x6 system S = Hcc_d - sum Y Hpp^-1 Y^T and
// g_red = g_c - sum Y Hpp^-1 g_p; the 6x6 solve; back-substitution for the
// points; the trial cost; accept (lambda/3) or reject (lambda*2.5) with
// Ceres' function-tolerance exit. Damping is H + lambda diag(H) + 1e-9 I
// on both blocks, as ops/ba.py structure_ba.
//
// What bounds it on an H100: latency. At the commit shape (2432 points x 8
// observations, F = 32) an iteration is ~20k observation updates, a few
// microseconds of arithmetic spread over the card, and two sums over all
// points (54 values for S and g_red, then the trial cost) that every point
// must wait for. The design (its times in PERF.md, from
// tools/kernel_ab.py):
//
// - One cluster of C CTAs (16 by default, non-portable; 8 is accepted) of
//   256 threads, launched with cudaLaunchKernelEx. CTA r owns the points
//   [r * share, (r + 1) * share), share = ceil(P / C), one thread a point
//   at a time.
// - Each CTA keeps in shared memory the frozen cameras' rotation table
//   (F <= 64), its points' state (X, trial X, Y, Hpp^-1, g_p: 36 floats a
//   point, component-major so that neighbouring threads hit neighbouring
//   banks) and its observations narrowed to a byte (camera index, 0xFF for
//   an excluded observation) and a float2 (uv on the normalised plane,
//   divided by fx once), for the whole solve. That
//   is 36 * 4 + 9 * O + 1 bytes a point: at O = 8 the whole state stays in
//   shared memory up to share = 1024, i.e. P <= 16384 at C = 16 and
//   P <= 8192 at C = 8. Above that, the same layout lives in the global
//   `scratch` (this CTA's slice, read and written only by this CTA; the
//   code is the same, through generic pointers).
// - Reductions without atomics or a grid barrier: each CTA sums its
//   partials over its threads (the 54 of the reduced system by a
//   reduce-scatter across each warp's lanes, 62 shuffles a thread in
//   place of 270 for a shuffle tree per value, then the warps in warp
//   order), writes them into its rank's slot of a partials array in
//   rank 0's shared memory (distributed shared memory, map_shared_rank),
//   and after cluster.sync() every CTA reads all C slots and sums them in
//   rank order. So every CTA holds bit-identical S, g_red and costs, takes
//   the same accept / exit decisions (no CTA leaves the loop while another
//   waits at a barrier) and the result is identical from run to run. The
//   54 normal-equation partials and the one trial-cost partial use two
//   slot arrays, so two cluster barriers an iteration suffice: a slot
//   array is rewritten only after a barrier that every CTA passed after
//   reading it.
// - The back-substitution and the trial cost are one pass over the points.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int F_MAX = 64;
constexpr int C_MAX = 16;
constexpr int NSUM = 54;   // Hcc 21 + g_c 6 + coupling 21 + Z g_p 6
constexpr int NPAD = 64;   // NSUM padded for the warp reduce-scatter
constexpr int NSTATE = 36;  // X 3, trial X 3, Y 18, Hpp^-1 9, g_p 3
constexpr int ST_X = 0, ST_XT = 3, ST_Y = 6, ST_HINV = 24, ST_GP = 33;
constexpr uint8_t EXCLUDED = 0xFF;

// Fixed part of the dynamic shared memory, in floats: rotation and
// translation table, the block reductions' scratch, the two slot arrays,
// the summed partials and the step; a multiple of 4 (16-byte alignment).
constexpr int FIXED_FLOATS = (12 * F_MAX + NPAD * WARPS + C_MAX * NSUM + C_MAX + NSUM + 13 + 3) /
                             4 * 4;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block can use

// Bytes of per-point state and staged observations for `share` points.
__host__ __device__ inline size_t point_bytes(int share, int O) {
  const size_t floats = (size_t)share * (NSTATE + 2 * O);
  const size_t bytes = (size_t)share * (O + 1);
  return floats * 4 + ((bytes + 15) / 16) * 16;
}

struct Problem {
  const long long* obs_cam;
  const float* obs_uv;
  const uint8_t* include;
  const uint8_t* point_free;
  int P, O, free;
  float fx, cx, cy, huber;
};

// Where a CTA keeps its points: component-major state [NSTATE][share],
// uv [O][share] float2, camera byte [O][share], free byte [share].
struct Local {
  float* st;
  float2* uv;
  uint8_t* cam;
  uint8_t* fr;
  int share;
};

// uv is the observation on the normalised plane, ((u - cx) / fx, (v - cy) / fx).
__device__ __forceinline__ void project(const float R[9], const float t[3], const float X[3],
                                        float2 uv, float& gx, float& gy, float& inv_z, float& r0,
                                        float& r1) {
  const float px = R[0] * X[0] + R[1] * X[1] + R[2] * X[2] + t[0];
  const float py = R[3] * X[0] + R[4] * X[1] + R[5] * X[2] + t[1];
  const float pz = R[6] * X[0] + R[7] * X[1] + R[8] * X[2] + t[2];
  const float z_safe = fabsf(pz) < 1e-9f ? 1e-9f : pz;
  inv_z = 1.0f / z_safe;
  gx = px * inv_z;
  gy = py * inv_z;
  r0 = gx - uv.x;
  r1 = gy - uv.y;
}

// Huber cost of point lp at X under camera table / free pose (Rf, tf).
__device__ __forceinline__ float point_cost(const Problem& pb, const Local& L, int lp,
                                            const float X[3], const float* s_R, const float* s_t,
                                            const float Rf[9], const float tf[3]) {
  float acc = 0.0f;
  for (int o = 0; o < pb.O; ++o) {
    const int c = L.cam[o * L.share + lp];
    if (c == EXCLUDED) continue;
    const bool is_free = c == pb.free;
    float gx, gy, inv_z, r0, r1;
    project(is_free ? Rf : s_R + 9 * c, is_free ? tf : s_t + 3 * c, X, L.uv[o * L.share + lp], gx,
            gy, inv_z, r0, r1);
    acc += huber_cost(r0 * r0 + r1 * r1, pb.huber);
  }
  return acc;
}

// Block sum of each thread's NPAD partials (those past NSUM are zero), in a
// fixed order: within each warp a reduce-scatter over the lanes (the
// partials halved five times, half kept, half sent to the partner lane),
// after which lane l holds values 2l and 2l + 1; then thread k < NSUM
// adds the warps' values k in warp order and gets the total back.
__device__ __forceinline__ float block_reduce(float (&v)[NPAD], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int step = 0; step < 5; ++step) {
    const int m = 16 >> step, half = 32 >> step;
    const bool hi = lane & m;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float keep = hi ? v[i + half] : v[i];
      const float give = hi ? v[i] : v[i + half];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, give, m);
    }
  }
  __syncthreads();  // `red` may still be read from a previous call
  *reinterpret_cast<float2*>(red + warp * NPAD + 2 * lane) = make_float2(v[0], v[1]);
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x < NSUM) {
    total = red[threadIdx.x];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) total += red[w * NPAD + threadIdx.x];
  }
  return total;
}

// Sum over the cluster of one value per rank, in rank order, read from
// rank 0's slot array; the same bits in every CTA.
__device__ __forceinline__ float rank_sum(const float* slots0, int C, int stride, int k) {
  float v[C_MAX];
#pragma unroll
  for (int r = 0; r < C_MAX; ++r) v[r] = r < C ? slots0[r * stride + k] : 0.0f;
  float s = v[0];
#pragma unroll
  for (int r = 1; r < C_MAX; ++r)
    if (r < C) s += v[r];
  return s;
}

__global__ void __launch_bounds__(THREADS)
structure_ba_cluster(const float* __restrict__ cam_rvec, const float* __restrict__ cam_t,
                     const long long* __restrict__ free_slot, const float* __restrict__ points,
                     Problem pb, float* __restrict__ out, float* __restrict__ points_out,
                     float* __restrict__ scratch, int F, int share, int in_smem, float lam0,
                     float ftol, int max_iters) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  float* s_R = smem;
  float* s_t = s_R + 9 * F_MAX;
  float* red = s_t + 3 * F_MAX;
  float* slots_a = red + NPAD * WARPS;   // [C_MAX][NSUM], read in rank 0
  float* slots_b = slots_a + C_MAX * NSUM;  // [C_MAX]
  float* s_tot = slots_b + C_MAX;         // [NSUM]
  float* s_step = s_tot + NSUM;           // delta_c 6, trial pose 6, cost 1
  const size_t per_cta = point_bytes(share, pb.O);
  char* base = in_smem ? reinterpret_cast<char*>(smem + FIXED_FLOATS)
                       : reinterpret_cast<char*>(scratch) + (size_t)rank * per_cta;
  Local L;
  L.share = share;
  L.st = reinterpret_cast<float*>(base);
  L.uv = reinterpret_cast<float2*>(L.st + (size_t)NSTATE * share);
  L.cam = reinterpret_cast<uint8_t*>(L.uv + (size_t)pb.O * share);
  L.fr = L.cam + (size_t)pb.O * share;
  float* rslots_a = cluster.map_shared_rank(slots_a, 0);
  float* rslots_b = cluster.map_shared_rank(slots_b, 0);

  pb.free = (int)*free_slot;
  for (int f = threadIdx.x; f < F; f += THREADS) {
    const float w[3] = {cam_rvec[3 * f], cam_rvec[3 * f + 1], cam_rvec[3 * f + 2]};
    rodrigues(w, s_R + 9 * f, nullptr);
    for (int i = 0; i < 3; ++i) s_t[3 * f + i] = cam_t[3 * f + i];
  }
  const int p0 = rank * share;
  const int n_local = max(0, min(share, pb.P - p0));
  for (int lp = threadIdx.x; lp < n_local; lp += THREADS) {
    const int p = p0 + lp;
    for (int i = 0; i < 3; ++i) L.st[(ST_X + i) * share + lp] = points[3 * p + i];
    for (int o = 0; o < pb.O; ++o) {
      const int idx = p * pb.O + o;
      L.cam[o * share + lp] = pb.include[idx] ? (uint8_t)pb.obs_cam[idx] : EXCLUDED;
      L.uv[o * share + lp] = make_float2((pb.obs_uv[2 * idx] - pb.cx) / pb.fx,
                                         (pb.obs_uv[2 * idx + 1] - pb.cy) / pb.fx);
    }
    L.fr[lp] = pb.point_free[p];
  }
  float pose[6];
  for (int i = 0; i < 3; ++i) {
    pose[i] = cam_rvec[3 * pb.free + i];
    pose[3 + i] = cam_t[3 * pb.free + i];
  }
  cluster.sync();  // every CTA has started and staged its points

  // Initial cost: partials in slot array b.
  float c1[1] = {0.0f};
  {
    float Rf[9];
    rodrigues(pose, Rf, nullptr);
    for (int lp = threadIdx.x; lp < n_local; lp += THREADS) {
      const float X[3] = {L.st[(ST_X + 0) * share + lp], L.st[(ST_X + 1) * share + lp],
                          L.st[(ST_X + 2) * share + lp]};
      c1[0] += point_cost(pb, L, lp, X, s_R, s_t, Rf, pose + 3);
    }
  }
  block_sum<1>(c1, red);
  if (threadIdx.x == 0) rslots_b[rank] = c1[0];
  cluster.sync();
  if (threadIdx.x == 0) s_step[12] = rank_sum(rslots_b, C, 1, 0);
  __syncthreads();
  float cost = s_step[12];
  float lam = lam0;
  int it = 0;
  bool done = false;

  while (it < max_iters && !done) {
    // Normal equations and the Schur terms, per point.
    float Rf[9], Jr[9];
    rodrigues(pose, Rf, Jr);
    float acc[NPAD];
#pragma unroll
    for (int i = 0; i < NPAD; ++i) acc[i] = 0.0f;
    for (int lp = threadIdx.x; lp < n_local; lp += THREADS) {
      const float X[3] = {L.st[(ST_X + 0) * share + lp], L.st[(ST_X + 1) * share + lp],
                          L.st[(ST_X + 2) * share + lp]};
      float hpp[6] = {0, 0, 0, 0, 0, 0};  // 00 01 02 11 12 22
      float gp[3] = {0, 0, 0};
      float Y[18];
#pragma unroll
      for (int i = 0; i < 18; ++i) Y[i] = 0.0f;
      for (int o = 0; o < pb.O; ++o) {
        const int c = L.cam[o * share + lp];
        if (c == EXCLUDED) continue;
        const bool is_free = c == pb.free;
        const float* R = is_free ? Rf : s_R + 9 * c;
        float gx, gy, inv_z, r0, r1;
        project(R, is_free ? pose + 3 : s_t + 3 * c, X, L.uv[o * share + lp], gx, gy, inv_z, r0,
                r1);
        const float w = huber_weight(r0 * r0 + r1 * r1, pb.huber);
        float Jp0[3], Jp1[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          Jp0[j] = inv_z * (R[j] - gx * R[6 + j]);
          Jp1[j] = inv_z * (R[3 + j] - gy * R[6 + j]);
        }
        int n = 0;
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = i; j < 3; ++j) hpp[n++] += w * (Jp0[i] * Jp0[j] + Jp1[i] * Jp1[j]);
#pragma unroll
        for (int i = 0; i < 3; ++i) gp[i] += w * (Jp0[i] * r0 + Jp1[i] * r1);
        if (is_free) {
          float Jc0[6], Jc1[6];
          camera_jacobian(Rf, Jr, X, gx, gy, inv_z, Jc0, Jc1);
          n = 0;
#pragma unroll
          for (int i = 0; i < 6; ++i) {
#pragma unroll
            for (int j = i; j < 6; ++j) acc[n++] += w * (Jc0[i] * Jc0[j] + Jc1[i] * Jc1[j]);
            acc[21 + i] += w * (Jc0[i] * r0 + Jc1[i] * r1);
#pragma unroll
            for (int j = 0; j < 3; ++j) Y[3 * i + j] += w * (Jc0[i] * Jp0[j] + Jc1[i] * Jp1[j]);
          }
        }
      }
      // Damped inverse, zero for a frozen point.
      const float m[9] = {hpp[0] + lam * hpp[0] + 1e-9f, hpp[1], hpp[2],
                          hpp[1], hpp[3] + lam * hpp[3] + 1e-9f, hpp[4],
                          hpp[2], hpp[4], hpp[5] + lam * hpp[5] + 1e-9f};
      float Hinv[9];
      inv3(m, Hinv);
      const float fr = L.fr[lp] ? 1.0f : 0.0f;
#pragma unroll
      for (int i = 0; i < 9; ++i) Hinv[i] *= fr;
      float Z[18];
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int l = 0; l < 3; ++l)
          Z[3 * i + l] = Y[3 * i + 0] * Hinv[0 * 3 + l] + Y[3 * i + 1] * Hinv[1 * 3 + l] +
                         Y[3 * i + 2] * Hinv[2 * 3 + l];
      int n = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = i; j < 6; ++j)
          acc[27 + n++] += Z[3 * i] * Y[3 * j] + Z[3 * i + 1] * Y[3 * j + 1] +
                           Z[3 * i + 2] * Y[3 * j + 2];
        acc[48 + i] += Z[3 * i] * gp[0] + Z[3 * i + 1] * gp[1] + Z[3 * i + 2] * gp[2];
      }
#pragma unroll
      for (int i = 0; i < 18; ++i) L.st[(ST_Y + i) * share + lp] = Y[i];
#pragma unroll
      for (int i = 0; i < 9; ++i) L.st[(ST_HINV + i) * share + lp] = Hinv[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) L.st[(ST_GP + i) * share + lp] = gp[i];
    }
    const float total = block_reduce(acc, red);
    if (threadIdx.x < NSUM) rslots_a[rank * NSUM + threadIdx.x] = total;
    cluster.sync();
    if (threadIdx.x < NSUM) s_tot[threadIdx.x] = rank_sum(rslots_a, C, NSUM, threadIdx.x);
    __syncthreads();
    if (threadIdx.x == 0) {
      float S[36], g[6], x[6];
      int n = 0;
      for (int i = 0; i < 6; ++i)
        for (int j = i; j < 6; ++j) {
          float v = s_tot[n] - s_tot[27 + n];
          if (i == j) v = s_tot[n] + lam * s_tot[n] + 1e-9f - s_tot[27 + n];
          S[i * 6 + j] = v;
          S[j * 6 + i] = v;
          ++n;
        }
      for (int i = 0; i < 6; ++i) g[i] = s_tot[21 + i] - s_tot[48 + i];
      solve6(S, g, x);
      for (int i = 0; i < 6; ++i) {
        s_step[i] = -x[i];  // delta_c
        s_step[6 + i] = pose[i] - x[i];
      }
    }
    __syncthreads();
    float trial[6], dc[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      dc[i] = s_step[i];
      trial[i] = s_step[6 + i];
    }

    // Back-substitution, delta_p = -Hpp^-1 (g_p + Y^T delta_c), and the
    // trial cost, in one pass; each thread keeps to its own points.
    float c2[1] = {0.0f};
    {
      float Rt[9];
      rodrigues(trial, Rt, nullptr);
      for (int lp = threadIdx.x; lp < n_local; lp += THREADS) {
        float rhs[3];
#pragma unroll
        for (int l = 0; l < 3; ++l) {
          float v = L.st[(ST_GP + l) * share + lp];
#pragma unroll
          for (int i = 0; i < 6; ++i) v += L.st[(ST_Y + 3 * i + l) * share + lp] * dc[i];
          rhs[l] = v;
        }
        float Xt[3];
#pragma unroll
        for (int l = 0; l < 3; ++l) {
          const float* h = L.st + (ST_HINV + 3 * l) * share + lp;
          const float d = -(h[0] * rhs[0] + h[share] * rhs[1] + h[2 * share] * rhs[2]);
          Xt[l] = L.st[(ST_X + l) * share + lp] + d;
          L.st[(ST_XT + l) * share + lp] = Xt[l];
        }
        c2[0] += point_cost(pb, L, lp, Xt, s_R, s_t, Rt, trial + 3);
      }
    }
    block_sum<1>(c2, red);
    if (threadIdx.x == 0) rslots_b[rank] = c2[0];
    cluster.sync();
    if (threadIdx.x == 0) s_step[12] = rank_sum(rslots_b, C, 1, 0);
    __syncthreads();
    const float new_cost = s_step[12];
    const bool accept = new_cost < cost;
    done = (accept && (cost - new_cost <= ftol * cost)) || (lam > 1e8f);
    if (accept) {
#pragma unroll
      for (int i = 0; i < 6; ++i) pose[i] = trial[i];
      cost = new_cost;
      lam = fmaxf(lam / 3.0f, 1e-9f);
      for (int lp = threadIdx.x; lp < n_local; lp += THREADS)
#pragma unroll
        for (int l = 0; l < 3; ++l)
          L.st[(ST_X + l) * share + lp] = L.st[(ST_XT + l) * share + lp];
    } else {
      lam = lam * 2.5f;
    }
    ++it;
  }
  for (int lp = threadIdx.x; lp < n_local; lp += THREADS)
    for (int l = 0; l < 3; ++l) points_out[3 * (p0 + lp) + l] = L.st[(ST_X + l) * share + lp];
  if (rank == 0 && threadIdx.x == 0) {
    for (int i = 0; i < 6; ++i) out[i] = pose[i];
    out[6] = cost;
    out[7] = (float)it;
  }
  cluster.sync();  // rank 0's slots stay alive until every CTA has read them
}

}  // namespace

// Bytes of global scratch the solve needs when its points' state does not
// fit in shared memory (0 when it does).
SLAM_API size_t slam_structure_ba_scratch_bytes(int P, int O, int cluster) {
  if (cluster < 1 || O < 1 || P < 0) return 0;
  const int share = (P + cluster - 1) / cluster;
  const size_t dyn = FIXED_FLOATS * 4 + point_bytes(share, O);
  return dyn <= SMEM_MAX ? 0 : (size_t)cluster * point_bytes(share, O);
}

SLAM_API int slam_structure_ba(const float* cam_rvec, const float* cam_t,
                               const long long* free_slot, const float* points,
                               const long long* obs_cam, const float* obs_uv,
                               const uint8_t* include, const uint8_t* point_free, float* out,
                               float* points_out, float* scratch, int F, int P, int O, float fx,
                               float cx, float cy, float lam0, float huber, float ftol,
                               int max_iters, int cluster, cudaStream_t stream) {
  if (F < 1 || F > F_MAX || P < 0 || O < 1 || max_iters < 0 || cluster < 1 ||
      cluster > C_MAX)
    return (int)cudaErrorInvalidValue;
  Problem pb;
  pb.obs_cam = obs_cam;
  pb.obs_uv = obs_uv;
  pb.include = include;
  pb.point_free = point_free;
  pb.P = P;
  pb.O = O;
  pb.free = 0;
  pb.fx = fx;
  pb.cx = cx;
  pb.cy = cy;
  pb.huber = huber;
  const int share = (P + cluster - 1) / cluster;
  const int in_smem = slam_structure_ba_scratch_bytes(P, O, cluster) == 0;
  if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t dyn = FIXED_FLOATS * 4 + (in_smem ? point_bytes(share, O) : 0);
  static const cudaError_t attr_err = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        structure_ba_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(structure_ba_cluster,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   SMEM_MAX);
  }();
  if (attr_err != cudaSuccess) return (int)attr_err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, structure_ba_cluster, cam_rvec, cam_t, free_slot, points, pb, out,
                         points_out, scratch, F, share, in_smem, lam0, ftol, max_iters);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
