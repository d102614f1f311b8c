// Shared helpers of the SLAM kernels: C linkage, block reductions, small
// dense algebra. Header-only; every kernel source includes it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SLAM_API extern "C" __attribute__((visibility("default")))

// Sum of `n` per-thread partials over the whole block. `red` is shared
// scratch of at least n * (blockDim.x / 32) floats; every thread gets the
// totals back in `vals`. blockDim.x must be a multiple of 32.
template <int N>
__device__ __forceinline__ void block_sum(float (&vals)[N], float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float v = vals[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    vals[k] = v;
  }
  __syncthreads();  // `red` may still be read from a previous call
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[k * nwarps + warp] = vals[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float v = lane < nwarps ? red[k * nwarps + lane] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[k * nwarps] = v;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) vals[k] = red[k * nwarps];
}

// Rodrigues coefficients, as ops/ba.py residual_and_jacobians: R = I + a W +
// b W^2, right Jacobian J_r = I - b W + B W^2. SINCOS takes the sine and
// cosine from one sincosf (one argument reduction) in place of sinf and
// cosf.
template <bool SINCOS = false>
__device__ __forceinline__ void rodrigues(const float w[3], float R[9], float Jr[9]) {
  const float wx = w[0], wy = w[1], wz = w[2];
  const float theta2 = wx * wx + wy * wy + wz * wz;
  const float theta = sqrtf(theta2 + 1e-24f);
  const bool small = theta2 < 1e-8f;
  const float safe1 = small ? 1.0f : theta;
  const float safe2 = small ? 1.0f : theta2;
  float sn, cs;
  if constexpr (SINCOS) {
    sincosf(theta, &sn, &cs);
  } else {
    sn = sinf(theta);
    cs = cosf(theta);
  }
  const float a = small ? 1.0f - theta2 / 6.0f : sn / safe1;
  const float b = small ? 0.5f - theta2 / 24.0f : (1.0f - cs) / safe2;
  const float B = small ? 1.0f / 6.0f - theta2 / 120.0f : (theta - sn) / (safe2 * safe1);
  R[0] = 1.0f - b * (wy * wy + wz * wz);
  R[1] = b * wx * wy - a * wz;
  R[2] = b * wx * wz + a * wy;
  R[3] = b * wx * wy + a * wz;
  R[4] = 1.0f - b * (wx * wx + wz * wz);
  R[5] = b * wy * wz - a * wx;
  R[6] = b * wx * wz - a * wy;
  R[7] = b * wy * wz + a * wx;
  R[8] = 1.0f - b * (wx * wx + wy * wy);
  if (Jr != nullptr) {
    const float A = b;
    Jr[0] = 1.0f - B * (wy * wy + wz * wz);
    Jr[1] = A * wz + B * wx * wy;
    Jr[2] = -A * wy + B * wx * wz;
    Jr[3] = -A * wz + B * wx * wy;
    Jr[4] = 1.0f - B * (wx * wx + wz * wz);
    Jr[5] = A * wx + B * wy * wz;
    Jr[6] = A * wy + B * wx * wz;
    Jr[7] = -A * wx + B * wy * wz;
    Jr[8] = 1.0f - B * (wx * wx + wy * wy);
  }
}

// Camera-Jacobian rows (2x6) of the normalized-plane residual for the point
// X seen by a camera with rotation R / right Jacobian Jr; gx, gy, inv_z from
// the projection (ops/ba.py residual_and_jacobians).
__device__ __forceinline__ void camera_jacobian(const float R[9], const float Jr[9],
                                                const float X[3], float gx, float gy,
                                                float inv_z, float J0[6], float J1[6]) {
  float M[9];
  M[0] = R[1] * X[2] - R[2] * X[1];
  M[1] = R[2] * X[0] - R[0] * X[2];
  M[2] = R[0] * X[1] - R[1] * X[0];
  M[3] = R[4] * X[2] - R[5] * X[1];
  M[4] = R[5] * X[0] - R[3] * X[2];
  M[5] = R[3] * X[1] - R[4] * X[0];
  M[6] = R[7] * X[2] - R[8] * X[1];
  M[7] = R[8] * X[0] - R[6] * X[2];
  M[8] = R[6] * X[1] - R[7] * X[0];
  float D[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      D[i * 3 + j] = -(M[i * 3 + 0] * Jr[0 * 3 + j] + M[i * 3 + 1] * Jr[1 * 3 + j] +
                       M[i * 3 + 2] * Jr[2 * 3 + j]);
  J0[0] = inv_z * (D[0] - gx * D[6]);
  J0[1] = inv_z * (D[1] - gx * D[7]);
  J0[2] = inv_z * (D[2] - gx * D[8]);
  J0[3] = inv_z;
  J0[4] = 0.0f;
  J0[5] = -gx * inv_z;
  J1[0] = inv_z * (D[3] - gy * D[6]);
  J1[1] = inv_z * (D[4] - gy * D[7]);
  J1[2] = inv_z * (D[5] - gy * D[8]);
  J1[3] = 0.0f;
  J1[4] = inv_z;
  J1[5] = -gy * inv_z;
}

__device__ __forceinline__ float huber_weight(float s, float delta) {
  return s <= delta * delta ? 1.0f : delta / sqrtf(s + 1e-18f);
}

__device__ __forceinline__ float huber_cost(float s, float delta) {
  const float b = delta * delta;
  return s <= b ? s : 2.0f * delta * sqrtf(s + 1e-18f) - b;
}

// Closed-form (adjugate) 3x3 inverse, as ops/ba.py inv3x3.
__device__ __forceinline__ void inv3(const float m[9], float out[9]) {
  const float a = m[0], b = m[1], c = m[2];
  const float d = m[3], e = m[4], f = m[5];
  const float g = m[6], h = m[7], i = m[8];
  const float A = e * i - f * h;
  const float B = -(d * i - f * g);
  const float C = d * h - e * g;
  const float det = a * A + b * B + c * C;
  const float inv_det = 1.0f / (fabsf(det) < 1e-12f ? 1e-12f : det);
  out[0] = A * inv_det;
  out[1] = -(b * i - c * h) * inv_det;
  out[2] = (b * f - c * e) * inv_det;
  out[3] = B * inv_det;
  out[4] = (a * i - c * g) * inv_det;
  out[5] = -(a * f - c * d) * inv_det;
  out[6] = C * inv_det;
  out[7] = -(a * h - b * g) * inv_det;
  out[8] = (a * e - b * d) * inv_det;
}

// Solve the damped SPD 6x6 system H x = g by two 3x3 block inverses, as
// ops/ba.py solve6_spd. H is row-major 36 floats.
__device__ __forceinline__ void solve6(const float H[36], const float g[6], float x[6]) {
  float A[9], Bm[9], C[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[i * 3 + j] = H[i * 6 + j];
      Bm[i * 3 + j] = H[i * 6 + j + 3];
      C[i * 3 + j] = H[(i + 3) * 6 + j + 3];
    }
  float Ainv[9], AinvB[9], S[9], Sinv[9];
  inv3(A, Ainv);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      AinvB[i * 3 + j] = Ainv[i * 3 + 0] * Bm[0 * 3 + j] + Ainv[i * 3 + 1] * Bm[1 * 3 + j] +
                         Ainv[i * 3 + 2] * Bm[2 * 3 + j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      S[i * 3 + j] = C[i * 3 + j] - (Bm[0 * 3 + i] * AinvB[0 * 3 + j] +
                                     Bm[1 * 3 + i] * AinvB[1 * 3 + j] +
                                     Bm[2 * 3 + i] * AinvB[2 * 3 + j]);
  inv3(S, Sinv);
  float rhs2[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    rhs2[j] = g[3 + j] - (AinvB[0 * 3 + j] * g[0] + AinvB[1 * 3 + j] * g[1] +
                          AinvB[2 * 3 + j] * g[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    x[3 + i] = Sinv[i * 3 + 0] * rhs2[0] + Sinv[i * 3 + 1] * rhs2[1] + Sinv[i * 3 + 2] * rhs2[2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    x[i] = (Ainv[i * 3 + 0] * g[0] + Ainv[i * 3 + 1] * g[1] + Ainv[i * 3 + 2] * g[2]) -
           (AinvB[i * 3 + 0] * x[3] + AinvB[i * 3 + 1] * x[4] + AinvB[i * 3 + 2] * x[5]);
}
