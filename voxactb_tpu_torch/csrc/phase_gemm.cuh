// K8's phase GEMM for Hopper (sm_90a): the x5 upsample that decoder_head_v3.cu
// runs before the decoder tail.
//
//   u0[b, 5 qz + rz, 5 qy + ry, 5 qx + rx, co] = lrelu_f32slope(bf16(
//       sum_{dz, dy, dx, ci} hp[b, qz + dz, qy + dy, qx + dx, ci]
//                            * table[dz, dy, dx][(rz, ry, rx, co)][ci] + up_bias[co]))
//
// on hp [B, s + 2, s + 2, s + 2, 64] bf16 (the post-conv_in slab h edge-padded
// by one on every axis), the phase-weight table [27, 125 * 64, 64] bf16 (tap
// 9 dz + 3 dy + dx; output column (phase 25 rz + 5 ry + rx, co); ci) and
// up_bias [64] f32; u0 [B, 5 s, 5 s, 5 s, 64] bf16. A GEMM of M = B s^3 cells,
// K = 27 x 64, N = 125 x 64. Replaces the u0 synthesis of
// voxactb_tpu/ops/pallas/decoder_head_v3.py (`_kernel`).
//
// What bounds it on an H100: operations. At s = 20, B = 1 it is 221 GFLOP
// (0.224 ms at the bf16 tensor-core peak) against 157 MB of compulsory
// traffic (hp, the 27.6 MB table, u0 written: 0.047 ms). The table fits in L2
// but every M tile streams all of it: 27.6 MB x (M / tile rows) of L2 traffic,
// 3.5 GB at 64 rows.
//
// Numerics: bf16 operands, f32 accumulation, acc + up_bias in f32, one
// rounding to bf16, the lrelu with the f32 slope (0.02) and one more rounding,
// as decoder_head_v3 and upsample_from_table; the sum runs over the taps, then
// the channels, in another order than the plain version's. No atomics: two
// launches give the same bits.
//
// Design:
//  - Bricks of 4 x 4 x 4 cells (a 64-row m tile), numbered x fastest, then y,
//    z, sample; partial bricks at the far edges compute on clamped data and
//    store only their cells. Work items are (quad of 4 bricks, block of 2
//    phases = 128 output columns), the 63rd block holding phase 124 alone;
//    each persistent CTA (one per SM) takes a contiguous run of items, so it
//    restages its bricks only when the quad changes.
//  - A from registers: each of the two consumer warpgroups owns two bricks of
//    the quad, whose 6 x 6 x 6 halos of hp (27 KB each) sit in shared memory,
//    16-byte chunk c of halo voxel (hz, hy, hx) at position c ^ ((hx + 4 hy)
//    % 8), so the 8 rows of an ldmatrix (4 x of 2 y) hit 8 bank groups. For
//    tap (dz, dy, dx) a row is the halo voxel shifted by it, so the gather is
//    ldmatrix with a per-lane row address.
//  - B by TMA: the tap's [128 columns, 64 ci] K-major tile of the table (16
//    KB, 128-byte swizzle; columns past 125 x 64 are zero-filled) goes into a
//    6-stage mbarrier ring, item after item. A stage serves the quad's four
//    bricks: 256 rows per B tile, so the table streams from L2 M / 256 times
//    (0.86 GB at s = 20). Thread 0 refills a stage as soon as both
//    warpgroups have released it, kRing - 1 taps ahead of its own use.
//  - Per tap and warpgroup 8 products m64n128k16 (two bricks x four k16
//    steps), issued as two batches on two register buffers of A fragments,
//    a batch's fragments loaded while the one before runs.
//  - Epilogue from the accumulator fragment: + up_bias, bf16, lrelu, stored
//    as bf16 pairs straight to the phase's voxel of u0; no shared f32 slab.
//  - 256 threads, no producer warp: an SM sub-partition's 16 K registers
//    hold two warps of up to 255 registers (128 of accumulators, 32 of A),
//    but a third warp on any of them (a ninth in the CTA) would cap every
//    thread at 168.

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace vx {
namespace phase {

using vx::bf16;
using namespace vx::hopper;

constexpr int kC = 64;
constexpr int kQ = 4;                  // brick edge, cells
constexpr int kH = kQ + 2;             // halo edge
constexpr int kHaloBytes = kH * kH * kH * kC * 2;
constexpr int kConsumers = 2;          // warpgroups, two bricks each
constexpr int kBricksPerItem = 2 * kConsumers;
constexpr int kPhases = 125;
constexpr int kPhasesPerItem = 2;
constexpr int kPhaseBlocks = (kPhases + kPhasesPerItem - 1) / kPhasesPerItem;
constexpr int kCols = kPhasesPerItem * kC;  // B tile rows (output columns)
constexpr int kTaps = 27;
constexpr int kStageBytes = kCols * kC * 2;
constexpr int kRing = 6;
constexpr int kThreads = kConsumers * 128;
// shared memory: the ring (1024-aligned), the four halos, the barriers
constexpr int kHaloOff = kRing * kStageBytes;
constexpr int kBarOff = kHaloOff + kBricksPerItem * kHaloBytes;
constexpr int kSmemBytes = kBarOff + 2 * kRing * 8 + 1024;
static_assert(kSmemBytes <= 232448, "shared memory of one CTA");
static_assert(kCols == 128, "the products are m64n128k16");

// The lrelu of decoder_head_v3's u0: taken in f32 (u0 * 0.02) on the value
// already rounded to bf16, then rounded once.
__device__ __forceinline__ bf16 lrelu_rounded_f32slope(bf16 v) {
  float f = __bfloat162float(v);
  return f >= 0.f ? v : __float2bfloat16_rn(f * 0.02f);
}

struct Cells {
  int b, z, y, x;  // sample and first cell of a brick
};

__device__ __forceinline__ Cells brick_cells(int i, int s) {
  const int ne = (s + kQ - 1) / kQ;
  Cells c;
  c.x = i % ne * kQ;
  i /= ne;
  c.y = i % ne * kQ;
  i /= ne;
  c.z = i % ne * kQ;
  c.b = i / ne;
  return c;
}

__device__ __forceinline__ uint32_t halo_addr(uint32_t halo, int hz, int hy, int hx, int c) {
  return halo + ((hz * kH + hy) * kH + hx) * 128 + ((c ^ ((hx + 4 * hy) & 7)) << 4);
}

// a brick's halo of hp, indices clamped to the padded slab, by the 128
// threads of a warpgroup (t its thread; the caller commits)
__device__ __forceinline__ void stage_brick(uint32_t halo, const bf16* __restrict__ hp,
                                            const Cells& q, int s, int t) {
  const int sp = s + 2;
  const bf16* src = hp + (size_t)q.b * sp * sp * sp * kC;
  for (int j = t; j < kH * kH * kH * 8; j += 128) {
    const int v = j >> 3, c = j & 7;
    const int hz = v / (kH * kH), hy = v / kH % kH, hx = v % kH;
    const int gz = min(q.z + hz, sp - 1), gy = min(q.y + hy, sp - 1), gx = min(q.x + hx, sp - 1);
    cp_async_16(halo_addr(halo, hz, hy, hx, c),
                src + (((size_t)gz * sp + gy) * sp + gx) * kC + c * 8);
  }
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// the A fragments of k16 steps kk0, kk0 + 1 of `tap` for the warpgroup's two
// bricks; this lane's row is cell (warp, lcy, lcx) of a brick
__device__ __forceinline__ void load_a(uint32_t (&a)[2][2][4], uint32_t halo, int warp,
                                       int lcy, int lcx, int lchunk, int tap, int kk0) {
  const int hz = warp + tap / 9, hy = lcy + tap / 3 % 3, hx = lcx + tap % 3;
#pragma unroll
  for (int br = 0; br < 2; ++br)
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2)
      ldmatrix_x4(a[br][k2],
                  halo_addr(halo + br * kHaloBytes, hz, hy, hx, 2 * (kk0 + k2) + lchunk));
}

// one batch of four products (k16 steps kk0, kk0 + 1 of both bricks) on the
// stage at `st`; committed, not waited for
__device__ __forceinline__ void issue(float (&acc)[2][64], const uint32_t (&a)[2][2][4],
                                      uint32_t st, int kk0) {
  const uint64_t db = desc_sw128(st);
  wgmma_fence();
#pragma unroll
  for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
    for (int br = 0; br < 2; ++br)
      wgmma_rs_n128_kmajor(acc[br], a[br][k2], db + (kk0 + k2) * kDescKStepKMajor);
  wgmma_commit();
}

__global__ void __launch_bounds__(kThreads, 1)
phase_gemm(const __grid_constant__ CUtensorMap tm_t, const bf16* __restrict__ hp,
           const float* __restrict__ bias, int s, int nb, bf16* __restrict__ u0) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = align1024(smem_u32(smem_raw));
  const auto full = [&](int i) { return base + kBarOff + 8 * i; };
  const auto empty = [&](int i) { return base + kBarOff + 8 * (kRing + i); };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const long long items = (long long)((nb + kBricksPerItem - 1) / kBricksPerItem) * kPhaseBlocks;
  const int i0 = (int)(items * blockIdx.x / gridDim.x);
  const int i1 = (int)(items * (blockIdx.x + 1) / gridDim.x);
  const int uses = (i1 - i0) * kTaps;  // of the ring: tap j % 27 of item i0 + j / 27
  const bool producer = threadIdx.x == 0;
  const auto load = [&](int j) {
    const int st = Ring<kRing>::stage(j);
    mbar_arrive_expect_tx(full(st), kStageBytes);
    tma_load_rows(base + st * kStageBytes, &tm_t, full(st),
                  (i0 + j / kTaps) % kPhaseBlocks * kCols, j % kTaps);
  };
  // use j's stage was released by both warpgroups: refill it with use j + kRing
  const auto refill = [&](int j) {
    if (producer && j + kRing < uses) {
      mbar_wait(empty(Ring<kRing>::stage(j)), Ring<kRing>::parity(j));
      load(j + kRing);
    }
    __syncwarp();
  };
  if (producer)
    for (int j = 0; j < kRing && j < uses; ++j) load(j);

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  // ldmatrix row of this lane: row 8 (lane / 8 % 2) + lane % 8 of the warp's
  // 16 (cells z = warp, y = 2 (lane / 8 % 2) + lane / 4 % 2, x = lane % 4),
  // channel chunk lane / 16 of each k16 step
  const int lcy = 2 * (lane >> 3 & 1) + (lane >> 2 & 1), lcx = lane & 3, lchunk = lane >> 4;
  const uint32_t halo = base + kHaloOff + wg * 2 * kHaloBytes;
  const long long n = 5LL * s;
  int quad = -1, it = 0;
  for (int item = i0; item < i1; ++item) {
    const int q = item / kPhaseBlocks, pb = item % kPhaseBlocks;
    if (q != quad) {
      // every warp of the warpgroup is past its last ldmatrix of the old
      // halos; a brick past the last computes on the last one's, unstored
      warpgroup_sync(wg);
      for (int k = 0; k < 2; ++k)
        stage_brick(halo + k * kHaloBytes, hp,
                    brick_cells(min(kBricksPerItem * q + 2 * wg + k, nb - 1), s), s, t);
      cp_async_commit();
      cp_async_wait_group<0>();
      warpgroup_sync(wg);
      quad = q;
    }
    float acc[2][64];
#pragma unroll
    for (int br = 0; br < 2; ++br)
#pragma unroll
      for (int k = 0; k < 64; ++k) acc[br][k] = 0.f;
    uint32_t a0[2][2][4], a1[2][2][4];  // [brick][k16 step of the batch][frag]
    load_a(a0, halo, warp, lcy, lcx, lchunk, 0, 0);
    for (int tap = 0; tap < kTaps; ++tap, ++it) {
      const int st = Ring<kRing>::stage(it);
      const uint32_t sa = base + st * kStageBytes;
      mbar_wait(full(st), Ring<kRing>::parity(it));
      // batch 0 (k16 steps 0, 1) on a0, batch 1 (steps 2, 3) on a1; after
      // each commit the batch before it is done, so its register buffer may
      // be loaded again, and after batch 0 the previous tap's stage is free
      issue(acc, a0, sa, 0);
      wgmma_wait_1();
      fence_regs(a1[0]);
      fence_regs(a1[1]);
      if (tap > 0) {
        if (lane == 0) mbar_arrive(empty(Ring<kRing>::stage(it - 1)));
        refill(it - 1);
      }
      load_a(a1, halo, warp, lcy, lcx, lchunk, tap, 2);
      issue(acc, a1, sa, 2);
      wgmma_wait_1();
      fence_regs(a0[0]);
      fence_regs(a0[1]);
      if (tap + 1 < kTaps) load_a(a0, halo, warp, lcy, lcx, lchunk, tap + 1, 0);
    }
    wgmma_wait_all();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    fence_regs(a1[0]);
    fence_regs(a1[1]);
    if (lane == 0) mbar_arrive(empty(Ring<kRing>::stage(it - 1)));
    refill(it - 1);

    // epilogue: row 16 warp + lane / 4 + 8 h of a brick is cell (warp, lane /
    // 16 + 2 h, lane / 4 % 4); column 8 j + 2 (lane % 4) + e is phase 2 pb +
    // j / 8, channel 8 (j % 8) + 2 (lane % 4) + e
    float2 bq[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bq[j] = make_float2(bias[8 * j + 2 * (lane & 3)], bias[8 * j + 2 * (lane & 3) + 1]);
#pragma unroll
    for (int br = 0; br < 2; ++br) {
      const int bi = kBricksPerItem * q + 2 * wg + br;
      if (bi >= nb) continue;
      const Cells o = brick_cells(bi, s);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qz = o.z + warp, qy = o.y + (lane >> 4) + 2 * h, qx = o.x + (lane >> 2 & 3);
        if (qz >= s || qy >= s || qx >= s) continue;
#pragma unroll
        for (int ph = 0; ph < kPhasesPerItem; ++ph) {
          const int p = kPhasesPerItem * pb + ph;
          if (p >= kPhases) continue;
          const int rz = p / 25, ry = p / 5 % 5, rx = p % 5;
          bf16* row = u0 + ((((size_t)o.b * n + 5 * qz + rz) * n + 5 * qy + ry) * n +
                            5 * qx + rx) * kC + 2 * (lane & 3);
#pragma unroll
          for (int j8 = 0; j8 < 8; ++j8) {
            const int j = 8 * ph + j8;
            __nv_bfloat162 pair;
            pair.x = lrelu_rounded_f32slope(
                __float2bfloat16_rn(acc[br][4 * j + 2 * h] + bq[j8].x));
            pair.y = lrelu_rounded_f32slope(
                __float2bfloat16_rn(acc[br][4 * j + 2 * h + 1] + bq[j8].y));
            *reinterpret_cast<__nv_bfloat162*>(row + 8 * j8) = pair;
          }
        }
      }
    }
  }
}

// Internal linkage, as tail_conv.cuh's launch_tail_conv.
static cudaError_t launch_phase_gemm(const bf16* hp, const bf16* table, const float* bias,
                                     int B, int s, bf16* u0, cudaStream_t stream) {
  static int sms = 0;
  if (!sms) {
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(phase_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBytes);
    if (err != cudaSuccess) {
      sms = 0;
      return err;
    }
  }
  const long long ne = (s + kQ - 1) / kQ;
  const long long nb = (long long)B * ne * ne * ne;
  const long long items = (nb + kBricksPerItem - 1) / kBricksPerItem * kPhaseBlocks;
  if (s < 1 || items > (1ll << 31) - 1) return cudaErrorInvalidValue;
  CUtensorMap tm_t;
  cudaError_t err = rows_map(&tm_t, table, kTaps, kPhases * kC, kCols);
  if (err != cudaSuccess) return err;
  const int grid = (int)(items < sms ? items : sms);
  phase_gemm<<<grid, kThreads, kSmemBytes, stream>>>(tm_t, hp, bias, s, (int)nb, u0);
  return cudaGetLastError();
}

}  // namespace phase
}  // namespace vx
