// Kernel K1: the classical frontend's image stack in one pass per tile.
//
// Replaces racing_slam_tpu/ops/pallas/frontend_kernel.py:corner_frontend_fused.
// For one 32x32 output tile a block stages its own halo of the frame in
// shared memory and runs, all in shared memory: the sigma=2 descriptor blur
// (radius 6), the sigma=1.2 pre-blur (radius 4), Sobel, 3x3 structure-tensor
// box sums, the Shi-Tomasi min eigenvalue, border + mask gating, and the
// 15x15 NMS. Only the three [H, W] maps are written back. Every stage treats
// pixels outside the frame as zero, as the zero-padded plain stack does
// (ops/image.py _conv2d), and the NMS treats them as -inf.
//
// Halo of the response chain: NMS 7 + box 1 + Sobel 1 + blur 4 = 13 px.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int R1 = 4;    // pre-blur radius (sigma 1.2)
constexpr int R2 = 6;    // descriptor-blur radius (sigma 2.0)
constexpr int NMS = 7;   // NMS radius (15x15 window)
constexpr int RS = TILE + 2 * NMS;  // response region   46
constexpr int GS = RS + 2;          // gradient region   48
constexpr int BS = GS + 2;          // blur region       50
constexpr int IS = BS + 2 * R1;     // image region      58
constexpr int HALO = (IS - TILE) / 2;  // 13
constexpr int THREADS = 256;

struct Taps {
  float k1[2 * R1 + 1];
  float k2[2 * R2 + 1];
};

// Buffer A: image (IS*IS) + horizontal-pass scratch (IS*BS) in the blur
// phases; Ix, Iy (2*GS*GS) in the gradient phase; NMS row maxima (RS*TILE).
constexpr int A_SIZE = IS * IS + IS * BS;
// Buffer B: blurred image (BS*BS), then the gated response (RS*RS).
constexpr int B_SIZE = BS * BS;
static_assert(2 * GS * GS <= A_SIZE, "gradient planes must fit in buffer A");
static_assert(RS * RS <= B_SIZE, "response must fit in buffer B");

__global__ void __launch_bounds__(THREADS)
frontend_kernel(const float* __restrict__ img, const float* __restrict__ mask,
                float* __restrict__ resp_out, float* __restrict__ peaks_out,
                float* __restrict__ blur2_out, int H, int W, Taps taps, int border) {
  __shared__ float A[A_SIZE];
  __shared__ float Bbuf[B_SIZE];
  float* s_img = A;
  float* s_tmp = A + IS * IS;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const float* im = img + (size_t)b * H * W;
  const size_t plane = (size_t)b * H * W;
  const int tid = threadIdx.x;

  // Phase 0: image region [y0-13, y0+45) x [x0-13, x0+45), zero outside.
  for (int i = tid; i < IS * IS; i += THREADS) {
    const int r = i / IS, c = i % IS;
    const int gy = y0 - HALO + r, gx = x0 - HALO + c;
    s_img[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? im[gy * W + gx] : 0.0f;
  }
  __syncthreads();

  // Phase 1a: descriptor blur of the tile. Rows [-6, 38) x cols [0, 32).
  constexpr int D2R = TILE + 2 * R2;
  for (int i = tid; i < D2R * TILE; i += THREADS) {
    const int r = i / TILE, c = i % TILE;
    const float* row = s_img + (r + HALO - R2) * IS + (c + HALO);
    float acc = 0.0f;
#pragma unroll
    for (int d = -R2; d <= R2; ++d) acc += taps.k2[d + R2] * row[d];
    s_tmp[r * TILE + c] = acc;
  }
  __syncthreads();
  for (int i = tid; i < TILE * TILE; i += THREADS) {
    const int y = i / TILE, x = i % TILE;
    float acc = 0.0f;
#pragma unroll
    for (int d = -R2; d <= R2; ++d) acc += taps.k2[d + R2] * s_tmp[(y + R2 + d) * TILE + x];
    const int gy = y0 + y, gx = x0 + x;
    if (gy < H && gx < W) blur2_out[plane + gy * W + gx] = acc;
  }
  __syncthreads();

  // Phase 1b: pre-blur over the blur region [-9, 41)^2; zero outside frame.
  for (int i = tid; i < IS * BS; i += THREADS) {
    const int r = i / BS, c = i % BS;
    const float* row = s_img + r * IS + (c + R1);
    float acc = 0.0f;
#pragma unroll
    for (int d = -R1; d <= R1; ++d) acc += taps.k1[d + R1] * row[d];
    s_tmp[r * BS + c] = acc;
  }
  __syncthreads();
  for (int i = tid; i < BS * BS; i += THREADS) {
    const int r = i / BS, c = i % BS;
    float acc = 0.0f;
#pragma unroll
    for (int d = -R1; d <= R1; ++d) acc += taps.k1[d + R1] * s_tmp[(r + R1 + d) * BS + c];
    const int gy = y0 - (BS - TILE) / 2 + r, gx = x0 - (BS - TILE) / 2 + c;
    Bbuf[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? acc : 0.0f;
  }
  __syncthreads();

  // Phase 2: Sobel over the gradient region [-8, 40)^2; zero outside frame.
  float* s_ix = A;
  float* s_iy = A + GS * GS;
  for (int i = tid; i < GS * GS; i += THREADS) {
    const int r = i / GS, c = i % GS;
    const float* p = Bbuf + (r + 1) * BS + (c + 1);  // center in blur coords
    // ix = smooth_y(b[x-1] - b[x+1]); iy = diff_y(b[x-1] + 2 b[x] + b[x+1]).
    const float hm = p[-BS - 1] - p[-BS + 1];
    const float h0 = p[-1] - p[1];
    const float hp = p[BS - 1] - p[BS + 1];
    const float sm = p[-BS - 1] + 2.0f * p[-BS] + p[-BS + 1];
    const float sp = p[BS - 1] + 2.0f * p[BS] + p[BS + 1];
    const int gy = y0 - (GS - TILE) / 2 + r, gx = x0 - (GS - TILE) / 2 + c;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    s_ix[i] = in ? (hm + 2.0f * h0) + hp : 0.0f;
    s_iy[i] = in ? sm - sp : 0.0f;
  }
  __syncthreads();

  // Phase 3: box sums + min eigenvalue + gating over [-7, 39)^2. Outside the
  // frame the response is -inf (the NMS padding value).
  float* s_resp = Bbuf;
  for (int i = tid; i < RS * RS; i += THREADS) {
    const int r = i / RS, c = i % RS;
    float sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      float hxx = 0.0f, hyy = 0.0f, hxy = 0.0f;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int j = (r + dy) * GS + (c + dx);
        const float ix = s_ix[j], iy = s_iy[j];
        hxx += ix * ix;
        hyy += iy * iy;
        hxy += ix * iy;
      }
      sxx += hxx;
      syy += hyy;
      sxy += hxy;
    }
    const float half_tr = 0.5f * (sxx + syy);
    const float hd = 0.5f * (sxx - syy);
    const float rad = sqrtf(fmaxf(hd * hd + sxy * sxy, 0.0f));
    float v = half_tr - rad;
    const int gy = y0 - NMS + r, gx = x0 - NMS + c;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
      v = -CUDART_INF_F;
    } else {
      const bool inb = gy >= border && gy < H - border && gx >= border && gx < W - border;
      if (!inb) v = 0.0f;
      if (mask != nullptr && !(mask[gy * W + gx] > 0.0f)) v = 0.0f;
    }
    s_resp[i] = v;
  }
  __syncthreads();

  // Phase 4: 15x15 NMS, rows then columns.
  float* s_rmax = A;
  for (int i = tid; i < RS * TILE; i += THREADS) {
    const int r = i / TILE, c = i % TILE;
    float m = -CUDART_INF_F;
#pragma unroll
    for (int d = 0; d <= 2 * NMS; ++d) m = fmaxf(m, s_resp[r * RS + c + d]);
    s_rmax[i] = m;
  }
  __syncthreads();
  for (int i = tid; i < TILE * TILE; i += THREADS) {
    const int y = i / TILE, x = i % TILE;
    const int gy = y0 + y, gx = x0 + x;
    if (gy >= H || gx >= W) continue;
    float m = -CUDART_INF_F;
#pragma unroll
    for (int d = 0; d <= 2 * NMS; ++d) m = fmaxf(m, s_rmax[(y + d) * TILE + x]);
    const float v = s_resp[(y + NMS) * RS + (x + NMS)];
    resp_out[plane + gy * W + gx] = v;
    peaks_out[plane + gy * W + gx] = v >= m ? v : 0.0f;
  }
}

}  // namespace

SLAM_API int slam_frontend(const float* img, const float* mask, float* resp, float* peaks,
                           float* blur2, int B, int H, int W, const float* taps1, int r1,
                           const float* taps2, int r2, int border, cudaStream_t stream) {
  if (r1 != R1 || r2 != R2 || B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int i = 0; i < 2 * R1 + 1; ++i) taps.k1[i] = taps1[i];
  for (int i = 0; i < 2 * R2 + 1; ++i) taps.k2[i] = taps2[i];
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  frontend_kernel<<<grid, THREADS, 0, stream>>>(img, mask, resp, peaks, blur2, H, W, taps,
                                                border);
  return (int)cudaGetLastError();
}

SLAM_API const char* slam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
