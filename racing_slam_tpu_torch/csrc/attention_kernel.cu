// Kernel K6: flash (online-softmax) multi-head attention for LightGlue.
//
// Replaces racing_slam_tpu/ops/pallas/attention_kernel.py:flash_mha.
// out[q, h] = sum_k softmax_k(s[q, h, k]) v[k, h] with s = (q . k) / sqrt(dh),
// where q, k and v are rounded to bf16, the products are summed in float32,
// a masked key's logit is -1e9 (uniform attention when every key is masked)
// and the padding past the last key -2e9. The running max starts at -1e9
// as in the TPU kernel. The running max, denominator and accumulator are
// float32; p is rounded to bf16 before the p.v product, the denominator
// sums the unrounded p. Query masking is the caller's.
//
// Layout: q [Kq, H, dh], k and v [Kk, H, dh] float32, mask [Kk] uint8,
// out [Kq, H, dh] float32; dh in {16, 32, 64}.
//
// What bounds it on an H100 at the main path's [2400, 4, 32]: the exp of
// every logit, 23 M per call on the special-function units (~5.5 us),
// above the 2.95 GFLOP of the two products on the tensor cores (~3 us)
// and the 4.9 MB of f32 operands (~1.5 us). At that shape there are only
// 38 x 4 = 152 tiles of 64 queries for 132 SMs, so latency, not a unit,
// sets the pace unless the keys are split too. Three launches a call:
//
// 1. flash_prepass: q, k and v rounded to bf16 once, head-major, in 64-row
//    tiles laid out exactly as the main kernel's shared memory wants them
//    (q and k tiles 64 x dh, v transposed to dh x 64 keys, each row
//    swizzled as the wgmma descriptors below say), k and v padded with
//    zeros to `chunks` x `tiles_per_chunk` key tiles; the key mask as an
//    additive float32 row: 0, -1e9 for a masked key, -2e9 for padding.
// 2. flash_main: one CTA per (64-query tile, head, key chunk): one
//    producer warp keeps a ring of STAGES key tiles (k, v^T, mask row)
//    in flight with bulk asynchronous copies (cp.async.bulk, the TMA's
//    contiguous form) completing on mbarriers; one consumer warpgroup
//    runs S = Q K^T with wgmma m64n64k16 (both operands in shared memory,
//    bf16 in, f32 accumulate), masks and scales each logit with one FFMA
//    into log2 units (x = s * scale * log2 e, or the mask row's -1e9 /
//    -2e9), updates the running max and denominator, and feeds exp2(x - m)
//    packed to bf16 from the S accumulators as wgmma's register A operand
//    into O += P V (m64n{dh}k16). It writes the chunk's unnormalised O and
//    its (m, l) to a partial buffer; a chunk that holds only padding ends
//    with m = -1e9, l = 0 and O = 0.
// 3. flash_combine: per (query, head) the chunks' (m, l, O) merged in
//    chunk order, O / l written in the [Kq, H, dh] layout.
//
// The split is the wrapper's choice (ops/kernels/attention.py): enough
// chunks that every SM holds several CTAs at once. A consumer on ldmatrix
// + mma.sync over the same ring, tiles and split measured slower than
// wgmma at dh = 32 (PERF.md) and was not kept.
#include <cuda_bf16.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int TQ = 64;  // queries per CTA (one consumer warpgroup)
constexpr int TK = 64;  // keys per tile
constexpr int STAGES = 3;
constexpr int CONSUMER_THREADS = 128;
constexpr int THREADS = CONSUMER_THREADS + 32;  // + the producer warp
constexpr float NEG = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

// Byte offset of 16-byte chunk `off` of a tile whose rows are W bytes long
// (W = 32, 64 or 128), swizzled as the TMA and wgmma swizzle modes of the
// same width do: address bits [4, 4 + log2(W / 16)) ^= bits [7, ...).
// Tiles start 1024-byte aligned, so tile offsets and addresses agree.
__host__ __device__ constexpr uint32_t swizzle(uint32_t off, uint32_t W) {
  return off ^ (((off >> 7) & (W / 16 - 1)) << 4);
}

// wgmma shared-memory descriptor of a K-major tile with W-byte swizzled
// rows: start address, leading offset 1 (unused when the 16-element step
// stays inside a row), stride 8 rows x W bytes, swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t W) {
  const uint64_t mode = W == 128 ? 1 : (W == 64 ? 2 : 3);
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * W) >> 4) << 32) | (mode << 62);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Contiguous global -> shared copy by the TMA, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) = A (64 x 16, smem) * B (64 x 16, smem, K-major) (+ d if acc).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 16, f32) = A (64 x 16, registers) * B (16 x 16, smem, K-major) (+ d if acc).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (64 x 32, f32) = A (64 x 16, registers) * B (32 x 16, smem, K-major) (+ d if acc).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (64 x 64, f32) = A (64 x 16, registers) * B (64 x 16, smem, K-major) (+ d if acc).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&d)[DH / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DH == 16) wgmma_rs_n16(d, a, db, 1);
  else if constexpr (DH == 32) wgmma_rs_n32(d, a, db, 1);
  else wgmma_rs_n64(d, a, db, 1);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Sizes of one call's buffers, in the order the workspace holds them.
struct Plan {
  int qt, kt, tpc, chunks;
  size_t qb, kb, vt, madd, o_part, ml;  // bytes
  __host__ Plan(int Kq, int Kk, int H, int dh, int S) {
    qt = (Kq + TQ - 1) / TQ;
    const int n_tiles = (Kk + TK - 1) / TK;
    tpc = (n_tiles + S - 1) / S;
    chunks = S;
    kt = S * tpc;
    qb = round_up((size_t)H * qt * TQ * dh * 2, 1024);
    kb = round_up((size_t)H * kt * TK * dh * 2, 1024);
    vt = kb;
    madd = round_up((size_t)kt * TK * 4, 1024);
    o_part = round_up((size_t)S * H * qt * TQ * dh * 4, 1024);
    ml = round_up((size_t)S * H * qt * TQ * 8, 1024);
  }
  size_t total() const { return qb + kb + vt + madd + o_part + ml; }
};

// 1. bf16 tiles of q, k and v^T in the main kernel's shared-memory layout,
// and the additive mask row. One thread writes one 16-byte chunk.
template <int DH>
__global__ void __launch_bounds__(256)
flash_prepass(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const uint8_t* __restrict__ mask_k,
              uint8_t* __restrict__ qb, uint8_t* __restrict__ kb, uint8_t* __restrict__ vt,
              float* __restrict__ madd, int Kq, int Kk, int H, int qt, int kt) {
  constexpr int W = DH * 2;  // bytes of a q / k tile row
  constexpr int CH = DH / 8;  // 16-byte chunks of a row
  const long long nq = (long long)qt * TQ * H * CH;
  const long long nk = (long long)kt * TK * H * CH;
  const long long nv = (long long)kt * (TK / 8) * H * DH;
  const long long nm = (long long)kt * TK;
  const size_t stride = (size_t)H * DH;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < nq + nk + nv + nm;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < nq + nk) {  // q or k: row-major 64 x dh tiles
      const bool is_q = i < nq;
      const long long j = is_q ? i : i - nq;
      const int c = (int)(j % CH);
      const int h = (int)((j / CH) % H);
      const int row = (int)(j / CH / H);
      const int n = is_q ? Kq : Kk;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (row < n) {
        const float* src = (is_q ? q : k) + row * stride + h * DH + 8 * c;
        a = *reinterpret_cast<const float4*>(src);
        b = *reinterpret_cast<const float4*>(src + 4);
      }
      const uint4 w = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                                 pack_bf16(b.z, b.w));
      const int tiles = is_q ? qt : kt;
      uint8_t* tile = (is_q ? qb : kb) + ((size_t)h * tiles + row / TQ) * TQ * W;
      *reinterpret_cast<uint4*>(tile + swizzle((row % TQ) * W + 16 * c, W)) = w;
    } else if (i < nq + nk + nv) {  // v^T: dh x 64-key tiles, 128-byte rows
      const long long j = i - nq - nk;
      const int d = (int)(j % DH);
      const int h = (int)((j / DH) % H);
      const int kg = (int)(j / DH / H);  // group of 8 keys
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int key = 8 * kg + e;
        x[e] = key < Kk ? v[key * stride + h * DH + d] : 0.f;
      }
      const uint4 w = make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                                 pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
      uint8_t* tile = vt + ((size_t)h * kt + kg / (TK / 8)) * DH * TK * 2;
      *reinterpret_cast<uint4*>(tile + swizzle(d * TK * 2 + 16 * (kg % (TK / 8)), TK * 2)) = w;
    } else {
      const int key = (int)(i - nq - nk - nv);
      madd[key] = key < Kk ? (mask_k[key] ? 0.f : NEG) : 2.f * NEG;
    }
  }
}

// 2. One (64-query tile, head, key chunk): the producer warp streams the
// chunk's key tiles through the ring; the consumer warpgroup does the
// online softmax, both products on wgmma.
template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_main(const uint8_t* __restrict__ qb, const uint8_t* __restrict__ kb,
           const uint8_t* __restrict__ vt, const float* __restrict__ madd,
           float* __restrict__ o_part, float2* __restrict__ ml_part, int qt, int kt, int tpc,
           int H, float c) {
  constexpr int W = DH * 2;
  constexpr uint32_t Q_BYTES = TQ * W, K_BYTES = TK * W, V_BYTES = DH * TK * 2, M_BYTES = TK * 4;
  constexpr uint32_t Q_OFF = 0;
  constexpr uint32_t K_OFF = round_up(Q_BYTES, 1024);
  constexpr uint32_t V_OFF = K_OFF + STAGES * round_up(K_BYTES, 1024);
  constexpr uint32_t M_OFF = V_OFF + STAGES * round_up(V_BYTES, 1024);
  constexpr uint32_t BAR_OFF = M_OFF + STAGES * M_BYTES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // Swizzled tiles need 1024-byte aligned addresses: the wrapper adds 1 KB.
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + BAR_OFF;               // STAGES barriers
  const uint32_t empty = full + 8 * STAGES;           // STAGES barriers
  const uint32_t q_full = empty + 8 * STAGES;
  const int qtile = blockIdx.x, h = blockIdx.y, chunk = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_THREADS / 32);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_THREADS / 32) {  // producer
    if (lane == 0) {
      mbar_expect_tx(q_full, Q_BYTES);
      bulk_load(base + Q_OFF, qb + ((size_t)h * qt + qtile) * Q_BYTES, Q_BYTES, q_full);
      for (int i = 0; i < tpc; ++i) {
        const int s = i % STAGES;
        mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, K_BYTES + V_BYTES + M_BYTES);
        const size_t t = (size_t)h * kt + chunk * tpc + i;
        bulk_load(base + K_OFF + s * round_up(K_BYTES, 1024), kb + t * K_BYTES, K_BYTES,
                  full + 8 * s);
        bulk_load(base + V_OFF + s * round_up(V_BYTES, 1024), vt + t * V_BYTES, V_BYTES,
                  full + 8 * s);
        bulk_load(base + M_OFF + s * M_BYTES, madd + (size_t)(chunk * tpc + i) * TK, M_BYTES,
                  full + 8 * s);
      }
    }
    return;
  }

  const int g = lane >> 2, tg = lane & 3;  // accumulator row group, column pair
  const uint64_t dq = make_desc(base + Q_OFF, W);
  float m_run[2] = {NEG, NEG};  // rows g and g + 8 of this warp, log2 units
  float l_run[2] = {0.f, 0.f};
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  mbar_wait(q_full, 0);

  for (int i = 0; i < tpc; ++i) {
    const int s = i % STAGES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    const uint64_t dk = make_desc(base + K_OFF + s * round_up(K_BYTES, 1024), W);
    const uint64_t dv = make_desc(base + V_OFF + s * round_up(V_BYTES, 1024), TK * 2);
    const float* mrow = reinterpret_cast<const float*>(smem + M_OFF + s * M_BYTES);

    // S = Q K^T (64 x 64), k-steps of 16 along dh (32 bytes = 2 descriptor units).
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) wgmma_ss_n64(sc, dq + 2 * ks, dk + 2 * ks, ks > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);

    // x = s * scale * log2 e for a valid key, the mask row's value
    // otherwise: one FFMA; then the tile's row maxima.
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 mm = *reinterpret_cast<const float2*>(mrow + 8 * j + 2 * tg);
      const float c0 = mm.x == 0.f ? c : 0.f, c1 = mm.y == 0.f ? c : 0.f;
      sc[4 * j + 0] = fmaf(sc[4 * j + 0], c0, mm.x);
      sc[4 * j + 1] = fmaf(sc[4 * j + 1], c1, mm.y);
      sc[4 * j + 2] = fmaf(sc[4 * j + 2], c0, mm.x);
      sc[4 * j + 3] = fmaf(sc[4 * j + 3], c1, mm.y);
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j + 0], sc[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = ex2(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      sc[e] = ex2(sc[e] - m_run[(e >> 1) & 1]);
      rsum[(e >> 1) & 1] += sc[e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rsum[r];
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }

    // O += P V: key blocks (2kk, 2kk + 1) of S are the A fragment of
    // k-step kk; v^T rows are 128 bytes, a k-step is 32 of them.
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_pv<DH>(o, pa[kk], dv + 2 * kk);
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // Unnormalised partials of this chunk.
  const size_t row0 = ((size_t)chunk * H + h) * qt * TQ + qtile * TQ + warp * 16 + g;
  const size_t row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = 8 * j + 2 * tg;
    *reinterpret_cast<float2*>(o_part + row0 * DH + col) = make_float2(o[4 * j], o[4 * j + 1]);
    *reinterpret_cast<float2*>(o_part + row1 * DH + col) =
        make_float2(o[4 * j + 2], o[4 * j + 3]);
  }
  if (tg == 0) {
    ml_part[row0] = make_float2(m_run[0], l_run[0]);
    ml_part[row1] = make_float2(m_run[1], l_run[1]);
  }
}

// 3. Merge the chunks' (m, l, O) in chunk order; one thread per 4 outputs.
template <int DH>
__global__ void __launch_bounds__(256)
flash_combine(const float* __restrict__ o_part, const float2* __restrict__ ml_part,
              float* __restrict__ out, int Kq, int H, int qt, int chunks) {
  const long long n = (long long)Kq * H * (DH / 4);
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c4 = (int)(i % (DH / 4));
  const int h = (int)((i / (DH / 4)) % H);
  const int qi = (int)(i / (DH / 4) / H);
  const size_t plane = (size_t)H * qt * TQ;
  const size_t row = (size_t)h * qt * TQ + qi;
  float m = NEG;
  for (int s = 0; s < chunks; ++s) m = fmaxf(m, ml_part[s * plane + row].x);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < chunks; ++s) {
    const float2 ml = ml_part[s * plane + row];
    const float w = ex2(ml.x - m);
    const float4 x = *reinterpret_cast<const float4*>(o_part + (s * plane + row) * DH + 4 * c4);
    l += w * ml.y;
    acc.x += w * x.x;
    acc.y += w * x.y;
    acc.z += w * x.z;
    acc.w += w * x.w;
  }
  *reinterpret_cast<float4*>(out + ((size_t)qi * H + h) * DH + 4 * c4) =
      make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
}

template <int DH>
constexpr uint32_t main_smem_bytes() {
  return round_up(TQ * DH * 2, 1024) + STAGES * round_up(TK * DH * 2, 1024) +
         STAGES * round_up(DH * TK * 2, 1024) + STAGES * TK * 4 + 8 * (2 * STAGES + 1) + 1024;
}

template <int DH>
int launch(const float* q, const float* k, const float* v, const uint8_t* mask_k, float* out,
           uint8_t* ws, int Kq, int Kk, int H, int chunks, float scale, cudaStream_t stream) {
  const Plan pl(Kq, Kk, H, DH, chunks);
  uint8_t* qb = ws;
  uint8_t* kb = qb + pl.qb;
  uint8_t* vt = kb + pl.kb;
  float* madd = reinterpret_cast<float*>(vt + pl.vt);
  float* o_part = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(madd) + pl.madd);
  float2* ml = reinterpret_cast<float2*>(reinterpret_cast<uint8_t*>(o_part) + pl.o_part);
  constexpr uint32_t smem = main_smem_bytes<DH>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_main<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const long long jobs = (long long)pl.qt * TQ * H * (DH / 8) +
                         2LL * pl.kt * TK * H * (DH / 8) + (long long)pl.kt * TK;
  const int pre_blocks = (int)std::min<long long>((jobs + 255) / 256, 4096);
  flash_prepass<DH><<<pre_blocks, 256, 0, stream>>>(q, k, v, mask_k, qb, kb, vt, madd, Kq, Kk,
                                                     H, pl.qt, pl.kt);
  flash_main<DH><<<dim3(pl.qt, H, chunks), THREADS, smem, stream>>>(
      qb, kb, vt, madd, o_part, ml, pl.qt, pl.kt, pl.tpc, H, scale * LOG2E);
  const long long n = (long long)Kq * H * (DH / 4);
  flash_combine<DH><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(o_part, ml, out, Kq, H,
                                                                     pl.qt, chunks);
  return (int)cudaGetLastError();
}

bool valid_args(int Kq, int Kk, int H, int dh, int chunks) {
  return Kq >= 1 && Kk >= 1 && H >= 1 && H <= 65535 && chunks >= 1 && chunks <= 65535 &&
         (dh == 16 || dh == 32 || dh == 64);
}

}  // namespace

// Bytes of the workspace a call needs (bf16 tiles, mask row, partials).
SLAM_API size_t slam_flash_mha_workspace_bytes(int Kq, int Kk, int H, int dh, int chunks) {
  return valid_args(Kq, Kk, H, dh, chunks) ? Plan(Kq, Kk, H, dh, chunks).total() : 0;
}

SLAM_API int slam_flash_mha(const float* q, const float* k, const float* v, const uint8_t* mask_k,
                            float* out, void* workspace, int Kq, int Kk, int H, int dh,
                            int chunks, float scale, cudaStream_t stream) {
  if (!valid_args(Kq, Kk, H, dh, chunks) || workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  uint8_t* ws = static_cast<uint8_t*>(workspace);
  switch (dh) {
    case 16: return launch<16>(q, k, v, mask_k, out, ws, Kq, Kk, H, chunks, scale, stream);
    case 32: return launch<32>(q, k, v, mask_k, out, ws, Kq, Kk, H, chunks, scale, stream);
    default: return launch<64>(q, k, v, mask_k, out, ws, Kq, Kk, H, chunks, scale, stream);
  }
}
