// The front's k5/s5 patchify for Hopper (sm_90a): K1's last step
// (front_fused.cu) and the dense path's patchify (voxactb_front_patchify).
//
//   out[b, o, co] = sum_{tap, ci} d0[b, max(5 o + tap - 2, 0), ci] * wp[tap, ci, co]
//
// per axis, on d0 [B, N, N, N, 64] bf16 (N = 5 s) and wp [125, 64, 64] bf16
// (tap = 25 kz + 5 ky + kx; ci; co); out [B, s, s, s, 64] f32, without bias:
// ops/cuda/front_fused.py::patchify_pre, the edge-padded conv of the TPU
// kernel (voxactb_tpu/ops/pallas/front_fused.py::front_fused). The back
// padding is never read, so only the front edge is clamped.
//
// What bounds it on an H100: bytes. Stride equals kernel size, so the
// product reads d0 exactly once and no A row is used twice: at N = 100, B = 1
// it is 8.2 GFLOP against 128 MB of d0 (0.038 ms at the memory rate, 0.008 at
// the bf16 tensor-core peak). Keeping 3.35 TB/s flowing needs about 25 KB of
// loads in flight on every SM.
//
// Numerics: bf16 operands, f32 accumulation; each output's sum runs over the
// taps in order within a CTA's segment (below), the segments then summed in
// CTA order by a second pass. No atomics: two launches give the same bits.
//
// Design:
//  - A GEMM of M = B s^3 patch rows, K = 125 x 64, N = 64, in tiles of 128
//    rows (two consumer warpgroups of 64 rows sharing one weight tile),
//    rows numbered (b, oz, oy, ox) with x fastest; the last tile's rows past
//    M compute on the last row's data and are not stored.
//  - The work is split stream-K: the W = tiles x 125 (tile, tap) steps are
//    numbered tile-major and each of the G persistent CTAs (one per SM) takes
//    a contiguous run of W / G of them, so the card fills whatever M is (50^3
//    b1 has 8 tiles, 1000 steps: 7-8 per CTA; 100^3 b1 63 tiles, about 60
//    steps per CTA). A CTA that holds a whole tile stores it; one that holds
//    part of a tile (at most its first and its last) stores that partial
//    sum in one of its two slots, and patchify_reduce adds the partials of
//    each split tile in CTA order.
//  - A through an 8-stage ring: for each (tile, tap) step every thread
//    copies 4 of the 128 rows' 16-byte chunks by cp.async with the clamped
//    source address (the clamp is the front edge padding), into a 128-byte
//    swizzled tile that a shared-memory wgmma descriptor reads as K-major A
//    (chunk c of row r at c ^ (r % 8), TMA's 128B swizzle). The tap's [64 ci,
//    64 co] weight tile comes by TMA into the same stage (MN-major B,
//    mbarrier per stage). Seven steps (112 KB of d0) are in flight while
//    one is multiplied: 4 m64n64k16 products per warpgroup.
//  - Epilogue from the accumulator fragment as f32 pairs; no shared slab.

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace vx {
namespace patchify {

using vx::bf16;
using namespace vx::hopper;

constexpr int kC = 64;
constexpr int kTaps = 125;
constexpr int kRows = 128;                 // patch rows per tile
constexpr int kThreads = 256;              // two warpgroups, 64 rows each
constexpr int kATile = 64 * kC * 2;        // a warpgroup's A: 64 rows of 128 bytes
constexpr int kWTile = kC * kC * 2;        // a tap's weights
constexpr int kStageBytes = 2 * kATile + kWTile;
constexpr int kRing = 8;
constexpr int kBarOff = kRing * kStageBytes;
constexpr int kSmemBytes = kBarOff + kRing * 8 + 1024;
constexpr int kSlots = 2;                  // partial tiles per CTA: its first and last
constexpr int kReduceSplit = 8;            // reduce blocks per tile (16 rows each)
constexpr int kRowsPerThread = kRows * 8 / kThreads;  // 16-byte chunks: 8 per row
static_assert(kSmemBytes <= 232448, "shared memory of one CTA");
static_assert(kStageBytes % 1024 == 0, "stages stay 1024-aligned");

// The cp.async side of the ring: thread t copies chunk t % 8 of rows t / 8 +
// 32 i, i < 4, of every step; the rows' front corners (5 o - 2 per axis) are
// kept for the tile being loaded.
struct Loader {
  const bf16* d0;
  int N, M, s, tile;
  int z[kRowsPerThread], y[kRowsPerThread], x[kRowsPerThread];
  const bf16* src[kRowsPerThread];

  __device__ __forceinline__ void rows_of(int t) {
    tile = t;
    const int lr = threadIdx.x >> 3, lc = threadIdx.x & 7;
    const int s3 = s * s * s;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int m = min(t * kRows + lr + 32 * i, M - 1);
      const int b = m / s3, r = m - b * s3;
      z[i] = r / (s * s) * 5 - 2;
      y[i] = r / s % s * 5 - 2;
      x[i] = r % s * 5 - 2;
      src[i] = d0 + (size_t)b * N * N * N * kC + lc * 8;
    }
  }

  // A of step w (tile w / 125, tap w % 125) into the stage at `st`
  __device__ __forceinline__ void copy_a(uint32_t st, long long w) {
    const int t = (int)(w / kTaps), tap = (int)(w % kTaps);
    if (t != tile) rows_of(t);
    const int kz = tap / 25, ky = tap / 5 % 5, kx = tap % 5;
    const int lr = threadIdx.x >> 3, lc = threadIdx.x & 7;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = lr + 32 * i;
      const int iz = max(z[i] + kz, 0), iy = max(y[i] + ky, 0), ix = max(x[i] + kx, 0);
      cp_async_16(st + r * 128 + ((lc ^ (r & 7)) << 4),
                  src[i] + (((size_t)iz * N + iy) * N + ix) * kC);
    }
  }
};

__global__ void __launch_bounds__(kThreads, 1)
patchify_gemm(const __grid_constant__ CUtensorMap tm_w, const bf16* __restrict__ d0, int N,
              int M, long long W, float* __restrict__ out, float* __restrict__ part) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = align1024(smem_u32(smem_raw));
  const auto full = [&](int i) { return base + kBarOff + 8 * i; };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) mbar_init(full(i), 1);
    mbar_fence_init();
  }
  __syncthreads();
  const long long w_begin = W * blockIdx.x / gridDim.x;
  const int steps = (int)(W * (blockIdx.x + 1) / gridDim.x - w_begin);
  const int first_tile = (int)(w_begin / kTaps);

  Loader ld;
  ld.d0 = d0;
  ld.N = N;
  ld.M = M;
  ld.s = N / 5;
  ld.tile = -1;
  // step j's A and weights into stage j % kRing (one commit group per step,
  // empty past the last)
  const auto load = [&](int j) {
    if (j < steps) {
      const int stg = j % kRing;
      const uint32_t st = base + stg * kStageBytes;
      ld.copy_a(st, w_begin + j);
      if (tid == 0) {
        mbar_arrive_expect_tx(full(stg), kWTile);
        tma_load_rows(st + 2 * kATile, &tm_w, full(stg), (int)((w_begin + j) % kTaps) * kC, 0);
      }
    }
    cp_async_commit();
  };
  for (int j = 0; j < kRing - 1; ++j) load(j);

  const int wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32;
  float acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.f;
  long long seg_begin = w_begin;
  for (int j = 0; j < steps; ++j) {
    // step j's copies have landed (this thread's), are visible to wgmma, and
    // every thread is past step j - 1's products: its stage may be refilled
    cp_async_wait_group<kRing - 2>();
    fence_proxy_async();
    __syncthreads();
    load(j + kRing - 1);
    const int stg = j % kRing;
    const uint32_t st = base + stg * kStageBytes;
    mbar_wait(full(stg), (j / kRing) & 1);
    const uint64_t da = desc_sw128(st + wg * kATile), db = desc_sw128(st + 2 * kATile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk)
      wgmma_ss_n64_bmn(acc, da + kk * kDescKStepKMajor, db + kk * kDescKStepMnMajor, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    const long long w = w_begin + j;
    if (w % kTaps != kTaps - 1 && j != steps - 1) continue;
    // the end of a segment: a whole tile to out, a part of one to a slot
    const int t = (int)(w / kTaps);
    const bool whole = seg_begin % kTaps == 0 && w % kTaps == kTaps - 1;
    float* dst = whole ? out + (size_t)t * kRows * kC
                       : part + ((size_t)blockIdx.x * kSlots + (t == first_tile ? 0 : 1)) *
                                    kRows * kC;
    const int valid = whole ? M - t * kRows : kRows;
    // row 64 wg + 16 warp + lane / 4 + 8 h, columns 8 i + 2 (lane % 4) + e
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + 16 * warp + lane / 4 + 8 * h;
      if (r >= valid) continue;
      float* row = dst + (size_t)r * kC + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float2*>(row + 8 * i) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.f;
    seg_begin = w + 1;
  }
  cp_async_wait_group<0>();
}

// first step of CTA c of G over W steps
__device__ __forceinline__ long long segment_begin(long long W, int G, long long c) {
  return W * c / G;
}

// out of every tile that no single CTA held whole: the partials of the CTAs
// that hold a part of it, summed in CTA order. Block (tile, q) sums rows 16 q
// .. 16 q + 15, a float4 per thread.
__global__ void __launch_bounds__(256)
patchify_reduce(const float* __restrict__ part, int M, long long W, int G,
                float* __restrict__ out) {
  const int t = blockIdx.x;
  const long long lo = (long long)t * kTaps, hi = lo + kTaps;
  long long c = lo * G / W;  // the CTA whose steps hold lo
  while (c + 1 < G && segment_begin(W, G, c + 1) <= lo) ++c;
  while (c > 0 && segment_begin(W, G, c) > lo) --c;
  if (segment_begin(W, G, c + 1) >= hi) return;  // stored whole by CTA c
  const int e = blockIdx.y * 256 + threadIdx.x;   // float4 of the tile
  if (t * kRows + e / (kC / 4) >= M) return;
  // CTA c holds the tile's first steps, in its slot 1 if it began in an
  // earlier tile; every later one began in this tile (slot 0)
  long long c_end = c + 1;
  while (c_end < G && segment_begin(W, G, c_end) < hi) ++c_end;
  const float4* src = reinterpret_cast<const float4*>(part) + e;
  constexpr size_t kSlot = (size_t)kRows * kC / 4;  // float4 per slot
  const int first = segment_begin(W, G, c) < lo ? 1 : 0;
  float4 sum = src[((size_t)c * kSlots + first) * kSlot];
  // unrolled so that several partials' loads are in flight at once
#pragma unroll 4
  for (++c; c < c_end; ++c) {
    const float4 p = src[(size_t)c * kSlots * kSlot];
    sum.x += p.x;
    sum.y += p.y;
    sum.z += p.z;
    sum.w += p.w;
  }
  reinterpret_cast<float4*>(out + (size_t)t * kRows * kC)[e] = sum;
}

// out = patchify_pre(d0, wp) on G persistent CTAs (1 <= G <= tiles x 125);
// part [G, 2, 128, 64] f32 scratch; wp 16-byte aligned. Internal linkage, as
// tail_conv.cuh's launch_tail_conv.
static cudaError_t launch_front_patchify(const bf16* d0, const bf16* wp, int B, int N, int G,
                                         float* part, float* out, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        patchify_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const long long s = N / 5;
  const long long M = (long long)B * s * s * s;
  const long long tiles = (M + kRows - 1) / kRows;
  const long long W = tiles * kTaps;
  if (N % 5 != 0 || M < 1 || M > (1ll << 31) - 1 || G < 1 || G > W) return cudaErrorInvalidValue;
  CUtensorMap tm_w;
  cudaError_t err = rows_map(&tm_w, wp, 1, kTaps * kC, kC);
  if (err != cudaSuccess) return err;
  patchify_gemm<<<G, kThreads, kSmemBytes, stream>>>(tm_w, d0, N, (int)M, W, out, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  patchify_reduce<<<dim3((unsigned)tiles, kReduceSplit), 256, 0, stream>>>(part, (int)M, W, G,
                                                                          out);
  return cudaGetLastError();
}

}  // namespace patchify
}  // namespace vx
