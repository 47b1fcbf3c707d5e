// The decoder tail's skip-concat k3 conv for Hopper (sm_90a): step 1 of
// decoder_tail.cuh, shared by K3 (decoder_head.cu) and K8 (decoder_head_v3.cu).
//
//   u[b, z, y, x, co] = lrelu(bf16(sum_{tap, ci} cat[d0, u0][b, clamp(z + dz - 1),
//                       clamp(y + dy - 1), clamp(x + dx - 1), ci] * wf[tap, ci, co]
//                       + bf[co]))
//
// on d0, u0 [B, N, N, N, 64] bf16, wf [27, 128, 64] bf16 (tap = 9 dz + 3 dy +
// dx), bf [64] f32; u [B, N^3, 64] bf16. Replicate padding is the clamp of
// every source index to [0, N - 1] (the TPU ring clamps plane -1 to 0 and N to
// N - 1). Replaces the u conv of voxactb_tpu/ops/pallas/decoder_head_v2.py
// (`_kernel_with_bias`), which the act path's K3 and the dense path's K8 run.
//
// What bounds it on an H100: operations. At N = 100, B = 1 it is 442 GFLOP
// (10^6 voxels x 27 taps x 128 x 64 x 2) against 384 MB of compulsory traffic
// (d0, u0 read, u written): 0.447 ms at the bf16 tensor-core peak, 0.115 ms
// at the memory rate.
//
// Numerics: bf16 operands, f32 accumulation, acc + bf[co] in f32, one
// rounding to bf16, then lrelu_rounded (common.cuh). The sum of each output
// runs over the source (d0's 64 channels, then u0's), then the taps in the
// order (dy, dx) with dz innermost per k16 step of 16 channels: another
// order than the plain version's, so a sum on a bf16 rounding boundary may
// round the other way. No atomics: two launches give the same bits.
//
// Design (what holds the work back, and what this does about it):
//  - Output bricks. A CTA computes a brick of kBz x kBy x kBx = 4 x 8 x 8
//    output voxels x 64 channels; bricks at the grid's far edges are partial
//    and their extra rows compute on clamped data and are not stored. The
//    bricks of all samples are numbered x fastest, then y, z, sample
//    (brick_grid in ops/cuda/decoder_head.py), and a persistent CTA per SM
//    takes every gridDim.x-th.
//  - The halo staged once per brick and source, with the clamp. The
//    6 x 10 x 10 halo voxels (76.8 KB per source) go to shared memory by
//    16-byte cp.async chunks, chunk c of halo voxel v at v * 128 + 16 (c ^
//    v % 8), so that ldmatrix over 8 consecutive-x voxels hits 8 distinct
//    bank groups. Both sources have a buffer: while one source's 27 taps
//    run, the other's halo is in flight (the next brick's d0 while this
//    brick's u0 is computed, the next brick's u0 during the epilogue and
//    the next brick's d0 taps), so only a CTA's first halo is waited for.
//  - A from registers, B from shared memory. The rows of an m64 tile are
//    one z plane of the brick (8 y x 8 x); for tap (dz, dy, dx) they are the
//    halo voxels shifted by it, and each lane of ldmatrix.x4 gives its own
//    row address, so the gather costs nothing. A fragment of halo plane hz
//    serves the output planes hz - dz for dz = 0, 1, 2: each of the two
//    consumer warpgroups owns two planes and loads four halo planes per
//    (dy, dx) and k16 step for its six products, 2 / 3 of the ldmatrix
//    traffic of one load per product. The weights per (source, dz, dy, dx)
//    are a [64 ci, 64 co] tile of 128-byte rows, the MN-major B operand of
//    wgmma_rs_n64 (as V in P v); the three dz tiles of a (source, dy, dx)
//    group are one stage of a 3-stage mbarrier ring that the producer
//    warp fills by TMA (128-byte swizzle) across bricks.
//  - Software pipeline: a group's four k16 steps go out as two batches of
//    12 products on two register buffers of A fragments, and a batch's
//    fragments are loaded while the batch before runs (wgmma.wait_group 1).
//  - Epilogue from the accumulator fragment: acc + bf, bf16, lrelu, stored
//    as bf16 pairs from registers; no shared f32 slab.

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace vx {
namespace tailconv {

using vx::bf16;
using namespace vx::hopper;

constexpr int kC = 64;                  // channels per source, and output channels
constexpr int kBz = 4, kBy = 8, kBx = 8;  // output brick
constexpr int kHz = kBz + 2, kHy = kBy + 2, kHx = kBx + 2;  // its halo
constexpr int kHaloVox = kHz * kHy * kHx;
constexpr int kHaloBytes = kHaloVox * kC * 2;
constexpr int kWTile = kC * kC * 2;     // one [64 ci, 64 co] weight tile
constexpr int kStageBytes = 3 * kWTile;  // the dz = 0, 1, 2 tiles of a group
constexpr int kRing = 3;
constexpr int kGroups = 2 * 9;          // (source, dy, dx)
constexpr int kConsumers = 2;           // warpgroups, kBz / 2 planes each
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kConsumerRegs = 240;
// shared memory: the ring (1024-aligned), the two halos, the barriers
constexpr int kHaloOff = kRing * kStageBytes;
constexpr int kBarOff = kHaloOff + 2 * kHaloBytes;
constexpr int kSmemBytes = kBarOff + 2 * kRing * 8 + 1024;
static_assert(kBz == 2 * kConsumers, "two planes per consumer warpgroup");
static_assert(kSmemBytes <= 232448, "shared memory of one CTA");

struct Brick {
  int b, z0, y0, x0;
};

// brick i, numbered x fastest, then y, z, sample
__device__ __forceinline__ Brick brick_at(int i, int N) {
  const int nbx = (N + kBx - 1) / kBx, nby = (N + kBy - 1) / kBy, nbz = (N + kBz - 1) / kBz;
  Brick r;
  r.x0 = i % nbx * kBx;
  i /= nbx;
  r.y0 = i % nby * kBy;
  i /= nby;
  r.z0 = i % nbz * kBz;
  r.b = i / nbz;
  return r;
}

// the clamped halo of one source around a brick, issued by the 256 consumer
// threads as 16-byte cp.async chunks (the caller commits)
__device__ __forceinline__ void stage_halo(uint32_t halo, const bf16* __restrict__ src,
                                           const Brick& br, int N, int tid) {
  const bf16* sb = src + (size_t)br.b * N * N * N * kC;
  for (int j = tid; j < kHaloVox * 8; j += kConsumers * 128) {
    const int v = j >> 3, c = j & 7;
    const int hz = v / (kHy * kHx), hy = v / kHx % kHy, hx = v % kHx;
    const int gz = min(max(br.z0 + hz - 1, 0), N - 1);
    const int gy = min(max(br.y0 + hy - 1, 0), N - 1);
    const int gx = min(max(br.x0 + hx - 1, 0), N - 1);
    cp_async_16(halo + v * 128 + ((c ^ (v & 7)) << 4),
                sb + (((size_t)gz * N + gy) * N + gx) * kC + c * 8);
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
}

// one batch: the A fragments of k16 steps kk0, kk0 + 1 of the warpgroup's
// four halo planes (halo voxel v0 of this lane's row at plane 0 of the
// warpgroup), then their 12 products into the two output planes, dz tile
// of the stage `st` by dz; committed, not waited for
__device__ __forceinline__ void issue_batch(float (&acc)[2][32], uint32_t (&a)[2][4][4],
                                            uint32_t halo, int v0, int lchunk, uint32_t st,
                                            int kk0) {
#pragma unroll
  for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int v = v0 + p * kHy * kHx;
      const int chunk = 2 * (kk0 + k2) + lchunk;
      ldmatrix_x4(a[k2][p], halo + v * 128 + ((chunk ^ (v & 7)) << 4));
    }
  wgmma_fence();
#pragma unroll
  for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int dz = 0; dz < 3; ++dz)
        wgmma_rs_n64(acc[t], a[k2][t + dz],
                     desc_sw128(st + dz * kWTile) + (kk0 + k2) * kDescKStepMnMajor);
  wgmma_commit();
}

__global__ void __launch_bounds__(kThreads, 1)
tail_conv(const __grid_constant__ CUtensorMap tm_w, const bf16* __restrict__ d0,
          const bf16* __restrict__ u0, const float* __restrict__ bias, int nb, int N,
          bf16* __restrict__ u) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = align1024(smem_u32(smem_raw));
  const auto full = [&](int s) { return base + kBarOff + 8 * s; };
  const auto empty = [&](int s) { return base + kBarOff + 8 * (kRing + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // producer: the three dz tiles of every (source, dy, dx) group, brick
    // after brick
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      int it = 0;
      for (int i = blockIdx.x; i < nb; i += gridDim.x)
        for (int g = 0; g < kGroups; ++g, ++it) {
          const int s = Ring<kRing>::stage(it);
          const int half = g / 9, dy = g % 9 / 3, dx = g % 3;
          mbar_wait(empty(s), Ring<kRing>::parity(it) ^ 1);
          mbar_arrive_expect_tx(full(s), kStageBytes);
#pragma unroll
          for (int dz = 0; dz < 3; ++dz)
            tma_load_rows(base + s * kStageBytes + dz * kWTile, &tm_w, full(s),
                          (9 * dz + 3 * dy + dx) * 2 * kC + half * kC, 0);
        }
    }
    __syncwarp();
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x, warp = tid / 32 % 4, lane = tid % 32;
  const uint32_t halo0 = base + kHaloOff, halo1 = halo0 + kHaloBytes;
  // ldmatrix.x4 rows of this lane: matrix lane / 8 of the warp's 16 rows
  // (y = 2 warp + (lane / 8) % 2, x = lane % 8), channel chunk lane / 16 of
  // each k16 step; the warpgroup's output planes 2 wg, 2 wg + 1 read halo
  // planes 2 wg .. 2 wg + 3
  const int lv = (2 * wg * kHy + 2 * warp + (lane >> 3 & 1)) * kHx + (lane & 7);
  const int lchunk = lane >> 4;
  int it = 0;  // ring uses so far
  int i = blockIdx.x;
  if (i < nb) {
    const Brick br = brick_at(i, N);
    stage_halo(halo0, d0, br, N, tid);
    cp_async_commit();
    stage_halo(halo1, u0, br, N, tid);
    cp_async_commit();
  }
  for (; i < nb; i += gridDim.x) {
    const Brick br = brick_at(i, N);
    const int next = i + gridDim.x;
    float acc[2][32];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[t][k] = 0.f;
    uint32_t a0[2][4][4], a1[2][4][4];  // [k16 step of the batch][halo plane][frag]

    for (int half = 0; half < 2; ++half) {
      cp_async_wait_group<1>();  // this source's halo has landed
      consumers_sync();
      const uint32_t halo = half ? halo1 : halo0;
      for (int g9 = 0; g9 < 9; ++g9, ++it) {
        const int dy = g9 / 3, dx = g9 % 3;
        const int s = Ring<kRing>::stage(it);
        const uint32_t st = base + s * kStageBytes;
        const int v0 = lv + dy * kHx + dx;
        mbar_wait(full(s), Ring<kRing>::parity(it));
        // batch 0 (k16 steps 0, 1) on a0, batch 1 (steps 2, 3) on a1; after
        // each commit the batch before it is done, so its register buffer
        // may be loaded again, and after batch 0 the previous group's stage
        // is free
        issue_batch(acc, a0, halo, v0, lchunk, st, 0);
        wgmma_wait_1();
        fence_regs(a1[0]);
        fence_regs(a1[1]);
        if ((g9 > 0 || half > 0) && lane == 0) mbar_arrive(empty(Ring<kRing>::stage(it - 1)));
        issue_batch(acc, a1, halo, v0, lchunk, st, 2);
        wgmma_wait_1();
        fence_regs(a0[0]);
        fence_regs(a0[1]);
      }
      // every warp is past its last ldmatrix of this halo: refill it with
      // the next brick's (an empty group after the last brick keeps the
      // wait_group counts)
      consumers_sync();
      if (next < nb) stage_halo(half ? halo1 : halo0, half ? u0 : d0, brick_at(next, N), N, tid);
      cp_async_commit();
    }
    wgmma_wait_all();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    fence_regs(a1[0]);
    fence_regs(a1[1]);
    if (lane == 0) mbar_arrive(empty(Ring<kRing>::stage(it - 1)));

    // epilogue: row 16 warp + lane / 4 + 8 h of plane t is voxel (z0 + 2 wg +
    // t, y0 + 2 warp + h, x0 + lane / 4)
    const int x = br.x0 + lane / 4;
    const float* bq = bias + 2 * (lane % 4);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int z = br.z0 + 2 * wg + t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = br.y0 + 2 * warp + h;
        if (z >= N || y >= N || x >= N) continue;
        bf16* row = u + ((((size_t)br.b * N + z) * N + y) * N + x) * kC + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          __nv_bfloat162 pair;
          pair.x = lrelu_rounded(__float2bfloat16_rn(acc[t][4 * j + 2 * h] + bq[8 * j]));
          pair.y = lrelu_rounded(__float2bfloat16_rn(acc[t][4 * j + 2 * h + 1] + bq[8 * j + 1]));
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = pair;
        }
      }
    }
  }
  cp_async_wait_group<0>();
}

// bricks of a [B, N^3] grid
inline long long brick_count(int B, int N) {
  return (long long)B * ((N + kBz - 1) / kBz) * ((N + kBy - 1) / kBy) * ((N + kBx - 1) / kBx);
}

// u = lrelu(bf16(conv3d_k3_replicate(cat[d0, u0]) + bf)); wf 16-byte aligned.
// Internal linkage: K3's and K8's libraries each hold a copy of the kernel,
// and a static local of an inline function would be one object shared by
// both, so that the second library would skip its kernel's attribute.
static cudaError_t launch_tail_conv(const bf16* d0, const bf16* u0, const bf16* wf,
                                    const float* bf, int B, int N, bf16* u,
                                    cudaStream_t stream) {
  static int sms = 0;
  if (!sms) {
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(tail_conv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBytes);
    if (err != cudaSuccess) {
      sms = 0;
      return err;
    }
  }
  const long long nb = brick_count(B, N);
  if (nb > (1ll << 31) - 1) return cudaErrorInvalidValue;
  CUtensorMap tm_w;
  cudaError_t err = rows_map(&tm_w, wf, 1, 27 * 2 * kC, kC);
  if (err != cudaSuccess) return err;
  const int grid = (int)(nb < sms ? nb : sms);
  tail_conv<<<grid, kThreads, kSmemBytes, stream>>>(tm_w, d0, u0, bf, (int)nb, N, u);
  return cudaGetLastError();
}

}  // namespace tailconv
}  // namespace vx
