// Kernel K1: the classical frontend's image stack in one pass per tile.
//
// Replaces racing_slam_tpu/ops/pallas/frontend_kernel.py:corner_frontend_fused.
// For one TW x TH output tile a block stages its halo of the frame in
// shared memory and computes, there and in registers: the sigma=2
// descriptor blur (radius 6), the sigma=1.2 pre-blur (radius 4), Sobel,
// 3x3 structure-tensor box sums, the Shi-Tomasi min eigenvalue, border +
// mask gating and the 15x15 NMS. Only the three [H, W] maps are written
// back. Every stage treats pixels outside the frame as zero, as the
// zero-padded plain stack does (ops/image.py _conv2d), and the NMS treats
// them as -inf. Halo of the response chain: NMS 7 + box 1 + Sobel 1 +
// blur 4 = 13 px.
//
// What bounds it on an H100: not the card's rates. At 640x480 the stack
// is ~170 float32 operations and 20 bytes of device memory a pixel (one
// frame read, three maps written), 1.8 us of bandwidth. A frame is only
// ~120 tiles, one block to an SM, so the time is one block's critical
// path: a round trip to device memory for the image, then seven passes
// separated by barriers, each as long as its slowest thread. The design
// shortens that path:
//
// - Every pass is a separable 1-D pass in which a thread computes a run of
//   8 outputs from a window held in registers (8 + taps - 1 values read
//   once from shared memory), so a 13-tap pass reads 2.5 values an output
//   instead of 13. Vertical passes run a thread down a column (consecutive
//   threads on neighbouring columns); horizontal passes run a thread along
//   a row (consecutive threads on neighbouring rows, every plane's row
//   stride odd, so that 32 rows fall in 32 banks).
// - Seven passes, six barriers: load | horizontal blurs | vertical blurs
//   (the descriptor blur written out) | Sobel, products and their vertical
//   3-sums | horizontal 3-sums, min eigenvalue and gating | NMS along rows
//   | NMS down columns (response and peaks written out). The two output
//   passes run down columns, so their stores are coalesced.
// - 1024 threads a block, and each pass's runs dealt out one a thread in a
//   flat index (split by compile-time division, once a run): every pass
//   but the horizontal blurs is one round of the block.
// - An 80 x 32 tile stages (80 + 26) x (32 + 26) pixels, 2.4x its outputs;
//   at 640x480 that is 8 x 15 = 120 blocks, one wave on 132 SMs (64 x 32
//   tiles are 150 blocks, and the 18 of the second wave double the time).
// - The min eigenvalue's square root is the hardware's (sqrt.approx).
//
// Over B > 1 frames (the lockstep step of B sequences) the single frame's
// tiles run wave after wave: 960 CTAs at B = 8 on 132 SMs, 7.3 waves, each
// as long as one CTA's critical path, and each CTA stages 2.4x its
// outputs. That launch takes 80 x 120 tiles instead (BATCH_TH; 218 KB of
// shared memory, of the 227 KB a CTA may have): 4 x 8 = 32 CTAs a 640x480
// frame, 256 at B = 8, 1.9 waves, staging 1.6x their outputs, and with
// more runs a pass the 1024 threads stand idle less often (PERF.md has the
// shapes tried: persistent CTAs that load the next tile during the
// current one, and two 512-thread CTAs an SM, were slower). Tile geometry
// never enters a pixel's arithmetic, so every frame of a B-frame launch
// equals the single launch on that frame to the bit.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int R1 = 4;   // pre-blur radius (sigma 1.2)
constexpr int R2 = 6;   // descriptor-blur radius (sigma 2.0)
constexpr int NMS = 7;  // NMS radius (15x15 window)
constexpr int HALO = NMS + 1 + 1 + R1;  // 13
constexpr int RUN = 8;  // outputs a thread computes from one register window

constexpr int TW = 80, TH = 32;  // output tile
constexpr int THREADS = 1024;
constexpr int BATCH_TH = 120;  // tile height of the launch over B > 1 frames

struct Taps {
  float k1[2 * R1 + 1];
  float k2[2 * R2 + 1];
};

__host__ __device__ constexpr int odd(int n) { return n | 1; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The planes of one TW x TH tile, as offsets (floats) into dynamic shared
// memory. Region origins relative to the tile's top-left pixel: image -13,
// pre-blur -9, gradients -8, response -7 (in rows and in columns).
template <int TH>
struct Layout {
  static constexpr int IH = TH + 2 * HALO, IW = TW + 2 * HALO, IS = odd(IW);  // image
  static constexpr int BW = TW + 18, H1S = odd(BW);                // horizontal pre-blur
  static constexpr int H2H = TH + 2 * R2, H2S = odd(TW);           // horizontal desc blur
  static constexpr int BH = TH + 18, BS = odd(BW);                 // pre-blurred image
  static constexpr int RH = TH + 2 * NMS, GW = TW + 16, VS = odd(GW);  // vertical 3-sums
  static constexpr int RW = TW + 2 * NMS, RS = odd(RW);            // gated response
  static constexpr int MS = odd(TW);                               // NMS row maxima
  static constexpr int I = 0;
  static constexpr int H1 = I + IH * IS;
  static constexpr int H2 = H1 + IH * H1S;
  static constexpr int B = H2 + H2H * H2S;   // written while H1, H2 are read
  static constexpr int V = 0;                // 3 planes; written while B is read
  static constexpr int R = B;                // written while V is read
  static constexpr int M = 0;                // written while R is read
  static constexpr int FLOATS = B + BH * BS + 64;  // + slack for runs read past a row's end
  static_assert(3 * RH * VS <= B, "vertical 3-sums must not overlap the pre-blurred image");
  static_assert(RH * RS <= BH * BS, "response must fit where the pre-blurred image was");
  static_assert(RH * MS <= B, "row maxima must not overlap the response");
  static_assert(TW % RUN == 0 && TH % RUN == 0, "tile sides are whole runs");
};

__device__ __forceinline__ bool in_frame(int y, int x, int H, int W) {
  return y >= 0 && y < H && x >= 0 && x < W;
}

// The hardware square root (one MUFU instruction, relative error ~2^-22);
// sqrtf's correctly rounded sequence is several times longer.
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// m[j] = max(x[j .. j + 14]) for j < RUN: the maximum of the 8 values all
// windows share, and running maxima of the parts on either side.
__device__ __forceinline__ void window_max15(const float (&x)[RUN + 2 * NMS], float (&m)[RUN]) {
  float core = x[RUN - 1];
#pragma unroll
  for (int e = RUN; e <= 2 * NMS; ++e) core = fmaxf(core, x[e]);
  float left = -CUDART_INF_F;  // max(x[j .. RUN - 2])
#pragma unroll
  for (int j = RUN - 1; j >= 0; --j) {
    m[j] = core;
    if (j < RUN - 1) {
      left = fmaxf(left, x[j]);
      m[j] = fmaxf(m[j], left);
    }
  }
  float right = -CUDART_INF_F;  // max(x[2 * NMS + 1 .. j + 2 * NMS])
#pragma unroll
  for (int j = 1; j < RUN; ++j) {
    right = fmaxf(right, x[j + 2 * NMS]);
    m[j] = fmaxf(m[j], right);
  }
}

// One CTA a TW x TH tile: grid (tiles in x, tiles in y, B).
template <int TH>
__global__ void __launch_bounds__(THREADS)
frontend_kernel(const float* __restrict__ img, const float* __restrict__ mask,
                float* __restrict__ resp_out, float* __restrict__ peaks_out,
                float* __restrict__ blur2_out, int H, int W, Taps taps, int border) {
  using L = Layout<TH>;
  extern __shared__ float smem[];
  float* s_img = smem + L::I;
  float* s_h1 = smem + L::H1;
  float* s_h2 = smem + L::H2;
  float* s_b = smem + L::B;
  float* s_v = smem + L::V;
  float* s_r = smem + L::R;
  float* s_m = smem + L::M;

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t plane = (size_t)blockIdx.z * H * W;
  const float* im = img + plane;

  // 1. The image region, zero outside the frame, every load of the thread
  //    issued before any is stored.
  {
    constexpr int N = L::IH * L::IW, NL = cdiv(N, THREADS);
    float v[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int t = tid + i * THREADS, r = t / L::IW, c = t - r * L::IW;
      const int gy = y0 - HALO + r, gx = x0 - HALO + c;
      v[i] = t < N && in_frame(gy, gx, H, W) ? __ldg(im + (size_t)gy * W + gx) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int t = tid + i * THREADS, r = t / L::IW, c = t - r * L::IW;
      if (t < N) s_img[r * L::IS + c] = v[i];
    }
  }
  __syncthreads();

  // 2. Horizontal passes, a thread along a run of 8 columns of one row
  //    (consecutive threads on consecutive rows): the pre-blur over every
  //    image row (columns -9 .. TW + 9) and the descriptor blur over rows
  //    -6 .. TH + 6 of the tile's columns.
  {
    constexpr int N1 = L::IH * cdiv(L::BW, RUN), N = N1 + L::H2H * (TW / RUN);
    for (int t = tid; t < N; t += THREADS) {
      if (t < N1) {
        const int s = t / L::IH, r = t - s * L::IH;
        float x[RUN + 2 * R1];
        const float* row = s_img + r * L::IS + RUN * s;
#pragma unroll
        for (int e = 0; e < RUN + 2 * R1; ++e) x[e] = row[e];
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          float acc = 0.0f;
#pragma unroll
          for (int e = 0; e <= 2 * R1; ++e) acc = fmaf(taps.k1[e], x[j + e], acc);
          if (RUN * s + j < L::BW) s_h1[r * L::H1S + RUN * s + j] = acc;
        }
      } else {
        const int s = (t - N1) / L::H2H, r = t - N1 - s * L::H2H;
        float x[RUN + 2 * R2];
        const float* row = s_img + (r + HALO - R2) * L::IS + RUN * s + HALO - R2;
#pragma unroll
        for (int e = 0; e < RUN + 2 * R2; ++e) x[e] = row[e];
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          float acc = 0.0f;
#pragma unroll
          for (int e = 0; e <= 2 * R2; ++e) acc = fmaf(taps.k2[e], x[j + e], acc);
          s_h2[r * L::H2S + RUN * s + j] = acc;
        }
      }
    }
  }
  __syncthreads();

  // 3. Vertical passes, a thread down a run of 8 rows of one column
  //    (consecutive threads on consecutive columns): the pre-blurred image
  //    (rows and columns -9 .. +9, zero outside the frame) and the
  //    descriptor blur of the tile, written out.
  {
    constexpr int N1 = cdiv(L::BH, RUN) * L::BW, N = N1 + (TH / RUN) * TW;
    for (int t = tid; t < N; t += THREADS) {
      if (t < N1) {
        const int s = t / L::BW, c = t - s * L::BW;
        float x[RUN + 2 * R1];
#pragma unroll
        for (int e = 0; e < RUN + 2 * R1; ++e)
          x[e] = s_h1[min(RUN * s + e, L::IH - 1) * L::H1S + c];
        const int gx = x0 - 9 + c;
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          float acc = 0.0f;
#pragma unroll
          for (int e = 0; e <= 2 * R1; ++e) acc = fmaf(taps.k1[e], x[j + e], acc);
          const int r = RUN * s + j;
          if (r < L::BH) s_b[r * L::BS + c] = in_frame(y0 - 9 + r, gx, H, W) ? acc : 0.0f;
        }
      } else {
        const int s = (t - N1) / TW, c = t - N1 - s * TW;
        float x[RUN + 2 * R2];
#pragma unroll
        for (int e = 0; e < RUN + 2 * R2; ++e) x[e] = s_h2[(RUN * s + e) * L::H2S + c];
        const int gx = x0 + c;
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          float acc = 0.0f;
#pragma unroll
          for (int e = 0; e <= 2 * R2; ++e) acc = fmaf(taps.k2[e], x[j + e], acc);
          const int gy = y0 + RUN * s + j;
          if (gy < H && gx < W) blur2_out[plane + (size_t)gy * W + gx] = acc;
        }
      }
    }
  }
  __syncthreads();

  // 4. Sobel, the tensor products (zero outside the frame) and their
  //    vertical 3-sums, a thread down a run of 8 rows of one gradient
  //    column: ix = smooth_y(b[x-1] - b[x+1]), iy = diff_y(b[x-1] + 2 b[x] +
  //    b[x+1]).
  {
    constexpr int N = cdiv(L::RH, RUN) * L::GW;
    constexpr int NB = RUN + 4;  // pre-blurred rows a run reads
    for (int t = tid; t < N; t += THREADS) {
      const int s = t / L::GW, g = t - s * L::GW;
      float dx[NB], sx[NB];
#pragma unroll
      for (int e = 0; e < NB; ++e) {
        const float* p = s_b + min(RUN * s + e, L::BH - 1) * L::BS + g;
        const float l = p[0], m = p[1], r = p[2];
        dx[e] = l - r;
        sx[e] = (l + 2.0f * m) + r;
      }
      const int gx = x0 - 8 + g;
      float pxx[RUN + 2], pyy[RUN + 2], pxy[RUN + 2];
#pragma unroll
      for (int q = 0; q < RUN + 2; ++q) {
        const bool in = in_frame(y0 - 8 + RUN * s + q, gx, H, W);
        const float ix = in ? (dx[q] + 2.0f * dx[q + 1]) + dx[q + 2] : 0.0f;
        const float iy = in ? sx[q] - sx[q + 2] : 0.0f;
        pxx[q] = ix * ix;
        pyy[q] = iy * iy;
        pxy[q] = ix * iy;
      }
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        const int r = RUN * s + j;
        if (r < L::RH) {
          float* v = s_v + r * L::VS + g;
          v[0] = (pxx[j] + pxx[j + 1]) + pxx[j + 2];
          v[L::RH * L::VS] = (pyy[j] + pyy[j + 1]) + pyy[j + 2];
          v[2 * L::RH * L::VS] = (pxy[j] + pxy[j + 1]) + pxy[j + 2];
        }
      }
    }
  }
  __syncthreads();

  // 5. Horizontal 3-sums, the min eigenvalue and gating, a thread along a
  //    run of 8 response columns of one row. Outside the frame the response
  //    is -inf (the NMS padding value); outside the border or the mask it
  //    is 0.
  {
    constexpr int N = cdiv(L::RW, RUN) * L::RH;
    for (int t = tid; t < N; t += THREADS) {
      const int s = t / L::RH, r = t - s * L::RH;
      float a[3][RUN + 2];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float* v = s_v + (k * L::RH + r) * L::VS + RUN * s;
#pragma unroll
        for (int e = 0; e < RUN + 2; ++e) a[k][e] = v[e];
      }
      const int gy = y0 - NMS + r;
      const bool row_in = gy >= 0 && gy < H;
      const bool row_inb = gy >= border && gy < H - border;
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        const float sxx = (a[0][j] + a[0][j + 1]) + a[0][j + 2];
        const float syy = (a[1][j] + a[1][j + 1]) + a[1][j + 2];
        const float sxy = (a[2][j] + a[2][j + 1]) + a[2][j + 2];
        const float hd = 0.5f * (sxx - syy);
        float v = 0.5f * (sxx + syy) - sqrt_approx(fmaxf(hd * hd + sxy * sxy, 0.0f));
        const int c = RUN * s + j, gx = x0 - NMS + c;
        const bool in = row_in && (unsigned)gx < (unsigned)W;
        const bool inb = row_inb && gx >= border && gx < W - border;
        if (in && inb && mask != nullptr && !(__ldg(mask + (size_t)gy * W + gx) > 0.0f)) v = 0.0f;
        v = in ? (inb ? v : 0.0f) : -CUDART_INF_F;
        if (c < L::RW) s_r[r * L::RS + c] = v;
      }
    }
  }
  __syncthreads();

  // 6. NMS along rows: the 15-wide maxima of the tile's columns.
  {
    constexpr int N = (TW / RUN) * L::RH;
    for (int t = tid; t < N; t += THREADS) {
      const int s = t / L::RH, r = t - s * L::RH;
      float x[RUN + 2 * NMS], m[RUN];
      const float* row = s_r + r * L::RS + RUN * s;
#pragma unroll
      for (int e = 0; e < RUN + 2 * NMS; ++e) x[e] = row[e];
      window_max15(x, m);
#pragma unroll
      for (int j = 0; j < RUN; ++j) s_m[r * L::MS + RUN * s + j] = m[j];
    }
  }
  __syncthreads();

  // 7. NMS down columns, and the response and peaks of the tile written out.
  {
    constexpr int N = (TH / RUN) * TW;
    for (int t = tid; t < N; t += THREADS) {
      const int s = t / TW, c = t - s * TW, gx = x0 + c;
      if (gx >= W) continue;
      float x[RUN + 2 * NMS], m[RUN];
#pragma unroll
      for (int e = 0; e < RUN + 2 * NMS; ++e) x[e] = s_m[(RUN * s + e) * L::MS + c];
      window_max15(x, m);
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        const int gy = y0 + RUN * s + j;
        if (gy < H) {
          const float v = s_r[(RUN * s + j + NMS) * L::RS + c + NMS];
          resp_out[plane + (size_t)gy * W + gx] = v;
          peaks_out[plane + (size_t)gy * W + gx] = v >= m[j] ? v : 0.0f;
        }
      }
    }
  }
}

// The kernel for tiles of height TH over the B frames.
template <int TH>
cudaError_t launch(const float* img, const float* mask, float* resp, float* peaks, float* blur2,
                   int B, int H, int W, const Taps& taps, int border, cudaStream_t stream) {
  constexpr size_t smem = Layout<TH>::FLOATS * sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      frontend_kernel<TH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  frontend_kernel<TH><<<grid, THREADS, smem, stream>>>(img, mask, resp, peaks, blur2, H, W,
                                                        taps, border);
  return cudaGetLastError();
}

}  // namespace

SLAM_API int slam_frontend(const float* img, const float* mask, float* resp, float* peaks,
                           float* blur2, int B, int H, int W, const float* taps1, int r1,
                           const float* taps2, int r2, int border, cudaStream_t stream) {
  if (r1 != R1 || r2 != R2 || B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int i = 0; i < 2 * R1 + 1; ++i) taps.k1[i] = taps1[i];
  for (int i = 0; i < 2 * R2 + 1; ++i) taps.k2[i] = taps2[i];
  return (int)(B == 1 ? launch<TH> : launch<BATCH_TH>)(img, mask, resp, peaks, blur2, B, H, W,
                                                       taps, border, stream);
}

SLAM_API const char* slam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
