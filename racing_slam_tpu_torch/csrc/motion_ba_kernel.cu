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
// Each iteration is a block-strided pass over the K rows, a block reduction
// (warp shuffles, then shared memory) of the 27 sums, one thread's solve
// broadcast through shared memory, and a second pass for the trial cost.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void project_row(const float R[9], const float t[3], const float X[3],
                                            float& gx, float& gy, float& inv_z) {
  const float px = R[0] * X[0] + R[1] * X[1] + R[2] * X[2] + t[0];
  const float py = R[3] * X[0] + R[4] * X[1] + R[5] * X[2] + t[1];
  const float pz = R[6] * X[0] + R[7] * X[1] + R[8] * X[2] + t[2];
  const float z_safe = fabsf(pz) < 1e-9f ? 1e-9f : pz;
  inv_z = 1.0f / z_safe;
  gx = px * inv_z;
  gy = py * inv_z;
}

__device__ float robust_cost_partial(const float pose[6], const float* kp_uv, const float* xyz,
                                     const uint8_t* valid, int K, float fx, float cx, float cy,
                                     float huber) {
  float R[9];
  rodrigues(pose, R, nullptr);
  float acc = 0.0f;
  for (int k = threadIdx.x; k < K; k += THREADS) {
    if (!valid[k]) continue;
    const float X[3] = {xyz[3 * k], xyz[3 * k + 1], xyz[3 * k + 2]};
    float gx, gy, inv_z;
    project_row(R, pose + 3, X, gx, gy, inv_z);
    const float r0 = gx - (kp_uv[2 * k] - cx) / fx;
    const float r1 = gy - (kp_uv[2 * k + 1] - cy) / fx;
    acc += huber_cost(r0 * r0 + r1 * r1, huber);
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
motion_ba_kernel(const float* __restrict__ pose0, const float* __restrict__ kp_uv,
                 const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
                 float* __restrict__ out, int K, float fx, float cx, float cy, float lam0,
                 float huber, float ftol, int max_iters) {
  __shared__ float red[27 * (THREADS / 32)];
  __shared__ float s_trial[6];

  float pose[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) pose[i] = pose0[i];
  float lam = lam0;
  float c1[1] = {robust_cost_partial(pose, kp_uv, xyz, valid, K, fx, cx, cy, huber)};
  block_sum<1>(c1, red);
  float cost = c1[0];
  int it = 0;
  bool done = false;

  while (it < max_iters && !done) {
    float R[9], Jr[9];
    rodrigues(pose, R, Jr);
    float acc[27];
#pragma unroll
    for (int i = 0; i < 27; ++i) acc[i] = 0.0f;
    for (int k = threadIdx.x; k < K; k += THREADS) {
      if (!valid[k]) continue;
      const float X[3] = {xyz[3 * k], xyz[3 * k + 1], xyz[3 * k + 2]};
      float gx, gy, inv_z;
      project_row(R, pose + 3, X, gx, gy, inv_z);
      const float r0 = gx - (kp_uv[2 * k] - cx) / fx;
      const float r1 = gy - (kp_uv[2 * k + 1] - cy) / fx;
      const float w = huber_weight(r0 * r0 + r1 * r1, huber);
      float J0[6], J1[6];
      camera_jacobian(R, Jr, X, gx, gy, inv_z, J0, J1);
      int n = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = i; j < 6; ++j) acc[n++] += w * (J0[i] * J0[j] + J1[i] * J1[j]);
#pragma unroll
      for (int i = 0; i < 6; ++i) acc[21 + i] += w * (J0[i] * r0 + J1[i] * r1);
    }
    block_sum<27>(acc, red);
    if (threadIdx.x == 0) {
      float H[36], g[6], x[6];
      int n = 0;
      for (int i = 0; i < 6; ++i)
        for (int j = i; j < 6; ++j) {
          H[i * 6 + j] = acc[n];
          H[j * 6 + i] = acc[n];
          ++n;
        }
      for (int i = 0; i < 6; ++i) {
        g[i] = acc[21 + i];
        H[i * 6 + i] += lam * (H[i * 6 + i] + 1e-9f);
      }
      solve6(H, g, x);
      for (int i = 0; i < 6; ++i) s_trial[i] = pose[i] - x[i];
    }
    __syncthreads();
    float trial[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) trial[i] = s_trial[i];
    float c2[1] = {robust_cost_partial(trial, kp_uv, xyz, valid, K, fx, cx, cy, huber)};
    block_sum<1>(c2, red);
    const float new_cost = c2[0];
    const bool accept = new_cost < cost;
    done = (accept && (cost - new_cost <= ftol * cost)) || (lam > 1e8f);
    if (accept) {
#pragma unroll
      for (int i = 0; i < 6; ++i) pose[i] = trial[i];
      cost = new_cost;
      lam = fmaxf(lam / 3.0f, 1e-9f);
    } else {
      lam = lam * 2.0f;
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

SLAM_API int slam_motion_ba(const float* pose0, const float* kp_uv, const float* xyz,
                            const uint8_t* valid, float* out, int K, float fx, float cx,
                            float cy, float lam0, float huber, float ftol, int max_iters,
                            cudaStream_t stream) {
  if (K < 0 || max_iters < 0) return (int)cudaErrorInvalidValue;
  motion_ba_kernel<<<1, THREADS, 0, stream>>>(pose0, kp_uv, xyz, valid, out, K, fx, cx, cy, lam0,
                                              huber, ftol, max_iters);
  return (int)cudaGetLastError();
}
