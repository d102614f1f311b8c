// Kernel K4: single-free-camera Schur bundle adjustment, the whole LM loop
// in one persistent block.
//
// Replaces racing_slam_tpu/ops/pallas/structure_ba_kernel.py:structure_ba_planes.
// One free camera (`free_slot`) + free points, every other camera frozen.
// Per LM iteration: per point, the 3x3 Hessian Hpp, gradient g_p and the
// 6x3 coupling Y with the free camera over the point's O observations; the
// free camera's Hcc and g_c; damped per-point inverses (zero for frozen
// points); the reduced 6x6 system S = Hcc_d - sum Y Hpp^-1 Y^T and
// g_red = g_c - sum Y Hpp^-1 g_p; one thread's 6x6 solve; back-substitution
// for the points; the trial cost; accept (lambda/3) or reject (lambda*2.5)
// with Ceres' function-tolerance exit. Damping is H + lambda diag(H) + 1e-9 I
// on both blocks, as ops/ba.py structure_ba.
//
// S and g_red sum over all points, so one block walks all of them each
// iteration and reduces once. The frozen cameras' rotations are expanded
// once into a per-camera table in shared memory; the free camera's comes
// from the current (or trial) pose. Per-point Y, Hpp^-1 and g_p go to a
// scratch buffer between the reduction and the back-substitution.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int F_MAX = 64;
constexpr int NSUM = 54;  // Hcc 21 + g_c 6 + coupling 21 + Z g_p 6
constexpr int SCRATCH_PER_POINT = 33;  // Y 18 + Hinv 9 + g_p 3 + trial X 3

struct Problem {
  const long long* obs_cam;
  const float* obs_uv;
  const uint8_t* include;
  const uint8_t* point_free;
  int P, O, free;
  float fx, cx, cy, huber;
};

// Residual of observation (p, o) of point X; camera from the table or the
// free pose. Returns false for an excluded observation.
__device__ __forceinline__ bool obs_residual(const Problem& pb, int p, int o, const float X[3],
                                             const float* s_R, const float* s_t,
                                             const float Rf[9], const float tf[3], bool& is_free,
                                             const float*& R, float& gx, float& gy,
                                             float& inv_z, float& r0, float& r1) {
  const int idx = p * pb.O + o;
  if (!pb.include[idx]) return false;
  const int c = (int)pb.obs_cam[idx];
  is_free = c == pb.free;
  R = is_free ? Rf : s_R + 9 * c;
  const float* t = is_free ? tf : s_t + 3 * c;
  const float px = R[0] * X[0] + R[1] * X[1] + R[2] * X[2] + t[0];
  const float py = R[3] * X[0] + R[4] * X[1] + R[5] * X[2] + t[1];
  const float pz = R[6] * X[0] + R[7] * X[1] + R[8] * X[2] + t[2];
  const float z_safe = fabsf(pz) < 1e-9f ? 1e-9f : pz;
  inv_z = 1.0f / z_safe;
  gx = px * inv_z;
  gy = py * inv_z;
  r0 = gx - (pb.obs_uv[2 * idx] - pb.cx) / pb.fx;
  r1 = gy - (pb.obs_uv[2 * idx + 1] - pb.cy) / pb.fx;
  return true;
}

__device__ float cost_partial(const Problem& pb, const float* X, const float* s_R,
                              const float* s_t, const float pose[6]) {
  float Rf[9];
  rodrigues(pose, Rf, nullptr);
  float acc = 0.0f;
  for (int p = threadIdx.x; p < pb.P; p += THREADS) {
    const float Xp[3] = {X[3 * p], X[3 * p + 1], X[3 * p + 2]};
    for (int o = 0; o < pb.O; ++o) {
      bool is_free;
      const float* R;
      float gx, gy, inv_z, r0, r1;
      if (obs_residual(pb, p, o, Xp, s_R, s_t, Rf, pose + 3, is_free, R, gx, gy, inv_z, r0, r1))
        acc += huber_cost(r0 * r0 + r1 * r1, pb.huber);
    }
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
structure_ba_kernel(const float* __restrict__ cam_rvec, const float* __restrict__ cam_t,
                    const long long* __restrict__ free_slot, const float* __restrict__ points,
                    Problem pb, float* __restrict__ out, float* __restrict__ X,
                    float* __restrict__ scratch, int F, float lam0, float ftol, int max_iters) {
  __shared__ float s_R[9 * F_MAX];
  __shared__ float s_t[3 * F_MAX];
  __shared__ float red[NSUM * (THREADS / 32)];
  __shared__ float s_trial[6];
  __shared__ float s_delta[6];

  pb.free = (int)*free_slot;
  for (int f = threadIdx.x; f < F; f += THREADS) {
    const float w[3] = {cam_rvec[3 * f], cam_rvec[3 * f + 1], cam_rvec[3 * f + 2]};
    rodrigues(w, s_R + 9 * f, nullptr);
    for (int i = 0; i < 3; ++i) s_t[3 * f + i] = cam_t[3 * f + i];
  }
  for (int i = threadIdx.x; i < 3 * pb.P; i += THREADS) X[i] = points[i];
  float pose[6];
  for (int i = 0; i < 3; ++i) {
    pose[i] = cam_rvec[3 * pb.free + i];
    pose[3 + i] = cam_t[3 * pb.free + i];
  }
  __syncthreads();

  float lam = lam0;
  float c1[1] = {cost_partial(pb, X, s_R, s_t, pose)};
  block_sum<1>(c1, red);
  float cost = c1[0];
  int it = 0;
  bool done = false;

  while (it < max_iters && !done) {
    float Rf[9], Jr[9];
    rodrigues(pose, Rf, Jr);
    float acc[NSUM];
#pragma unroll
    for (int i = 0; i < NSUM; ++i) acc[i] = 0.0f;

    for (int p = threadIdx.x; p < pb.P; p += THREADS) {
      const float Xp[3] = {X[3 * p], X[3 * p + 1], X[3 * p + 2]};
      float hpp[6] = {0, 0, 0, 0, 0, 0};  // 00 01 02 11 12 22
      float gp[3] = {0, 0, 0};
      float Y[18];
#pragma unroll
      for (int i = 0; i < 18; ++i) Y[i] = 0.0f;
      for (int o = 0; o < pb.O; ++o) {
        bool is_free;
        const float* R;
        float gx, gy, inv_z, r0, r1;
        if (!obs_residual(pb, p, o, Xp, s_R, s_t, Rf, pose + 3, is_free, R, gx, gy, inv_z, r0,
                          r1))
          continue;
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
          camera_jacobian(Rf, Jr, Xp, gx, gy, inv_z, Jc0, Jc1);
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
      const float fr = pb.point_free[p] ? 1.0f : 0.0f;
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
      float* sc = scratch + (size_t)p * SCRATCH_PER_POINT;
#pragma unroll
      for (int i = 0; i < 18; ++i) sc[i] = Y[i];
#pragma unroll
      for (int i = 0; i < 9; ++i) sc[18 + i] = Hinv[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) sc[27 + i] = gp[i];
    }
    block_sum<NSUM>(acc, red);

    if (threadIdx.x == 0) {
      float S[36], g[6], x[6];
      int n = 0;
      for (int i = 0; i < 6; ++i)
        for (int j = i; j < 6; ++j) {
          float v = acc[n] - acc[27 + n];
          if (i == j) v = acc[n] + lam * acc[n] + 1e-9f - acc[27 + n];
          S[i * 6 + j] = v;
          S[j * 6 + i] = v;
          ++n;
        }
      for (int i = 0; i < 6; ++i) g[i] = acc[21 + i] - acc[48 + i];
      solve6(S, g, x);
      for (int i = 0; i < 6; ++i) {
        s_delta[i] = -x[i];  // delta_c
        s_trial[i] = pose[i] - x[i];
      }
    }
    __syncthreads();
    float trial[6], dc[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      trial[i] = s_trial[i];
      dc[i] = s_delta[i];
    }

    // Back-substitution: delta_p = -Hpp^-1 (g_p + Y^T delta_c).
    for (int p = threadIdx.x; p < pb.P; p += THREADS) {
      float* sc = scratch + (size_t)p * SCRATCH_PER_POINT;
      float rhs[3];
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        float v = sc[27 + l];
#pragma unroll
        for (int i = 0; i < 6; ++i) v += sc[3 * i + l] * dc[i];
        rhs[l] = v;
      }
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        const float d = -(sc[18 + 3 * l] * rhs[0] + sc[18 + 3 * l + 1] * rhs[1] +
                          sc[18 + 3 * l + 2] * rhs[2]);
        sc[30 + l] = X[3 * p + l] + d;
      }
    }
    // The trial points of point p are written and read by the same thread.
    float c2[1] = {0.0f};
    {
      float Rt[9];
      rodrigues(trial, Rt, nullptr);
      for (int p = threadIdx.x; p < pb.P; p += THREADS) {
        const float* sc = scratch + (size_t)p * SCRATCH_PER_POINT;
        const float Xp[3] = {sc[30], sc[31], sc[32]};
        for (int o = 0; o < pb.O; ++o) {
          bool is_free;
          const float* R;
          float gx, gy, inv_z, r0, r1;
          if (obs_residual(pb, p, o, Xp, s_R, s_t, Rt, trial + 3, is_free, R, gx, gy, inv_z, r0,
                           r1))
            c2[0] += huber_cost(r0 * r0 + r1 * r1, pb.huber);
        }
      }
    }
    block_sum<1>(c2, red);
    const float new_cost = c2[0];
    const bool accept = new_cost < cost;
    done = (accept && (cost - new_cost <= ftol * cost)) || (lam > 1e8f);
    if (accept) {
#pragma unroll
      for (int i = 0; i < 6; ++i) pose[i] = trial[i];
      cost = new_cost;
      lam = fmaxf(lam / 3.0f, 1e-9f);
      for (int p = threadIdx.x; p < pb.P; p += THREADS) {
        const float* sc = scratch + (size_t)p * SCRATCH_PER_POINT;
        X[3 * p] = sc[30];
        X[3 * p + 1] = sc[31];
        X[3 * p + 2] = sc[32];
      }
    } else {
      lam = lam * 2.5f;
    }
    ++it;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < 6; ++i) out[i] = pose[i];
    out[6] = cost;
    out[7] = (float)it;
  }
}

}  // namespace

SLAM_API int slam_structure_ba(const float* cam_rvec, const float* cam_t,
                               const long long* free_slot, const float* points,
                               const long long* obs_cam, const float* obs_uv,
                               const uint8_t* include, const uint8_t* point_free, float* out,
                               float* points_out, float* scratch, int F, int P, int O, float fx,
                               float cx, float cy, float lam0, float huber, float ftol,
                               int max_iters, cudaStream_t stream) {
  if (F < 1 || F > F_MAX || P < 0 || O < 1 || max_iters < 0) return (int)cudaErrorInvalidValue;
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
  structure_ba_kernel<<<1, THREADS, 0, stream>>>(cam_rvec, cam_t, free_slot, points, pb, out,
                                                 points_out, scratch, F, lam0, ftol, max_iters);
  return (int)cudaGetLastError();
}
