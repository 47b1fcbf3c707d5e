// The voxel pass of the act path's fronts for Hopper (sm_90a): the 1x1x1
// preprocess conv, leaky relu and soft-argmax partials of d0, shared by K1's
// ff_voxel (front_fused.cu, rows from the scatter accumulator) and K5's
// es_voxel (encoder_stats.cu, rows from the dense grid).
//
//   d0[b, v, c] = lrelu(bf16(sum_k row[b, v, k] w1[k, c] + b1[c]))
//
// with the 10-channel row rounded to bf16, the f32 products summed over
// k = 0..9 in order and the leaky relu on the rounded value (lrelu_rounded):
// the arithmetic of both plain versions. The statistics per channel are the
// online soft-argmax at T = 0.01 over positions (lin[dim1], lin[dim0],
// lin[dim2]), one partial [5, 64] per CTA, merged by stats_combine.
//
// What bounds it on an H100: bytes. At N = 100, B = 1 it writes 128 MB of d0
// and reads 32-40 MB of rows (0.048-0.050 ms at the memory rate); but its 64
// M elements cost about 25 instructions each (10 FMAs, the rounding and
// relu, one exponential and four accumulations), more than that time on the
// SMs' issue slots, so the instruction count per element is what the design
// cuts.
//
// Design:
//  - Persistent CTAs of 128 threads, G per sample (voxel_pass_grid in
//    ops/cuda/encoder_stats.py: kCtasPerSm per SM over the batch), each taking
//    every G-th tile of 64 voxels of its sample and keeping one statistics
//    partial: stats_combine merges a few hundred partials per sample.
//  - The tile's rows are staged in shared memory with what each voxel needs
//    once, not per channel: the 10 bf16-rounded values and the three lin
//    positions of its indices. Rows are triple-buffered: the next tile's
//    row loads are issued before this tile's compute and stored after it,
//    and a tile's positions are read again after the barrier, so one
//    barrier per tile suffices.
//  - Thread (voxel row r = tid / 8, channel group g = tid % 8) computes 8
//    channels of voxels r, r + 16, r + 32, r + 48 with its 80 weights in
//    registers (the bias and the unscaled running max wait in shared memory,
//    so that two CTAs per SM fit without spills) and stores each voxel's 8
//    channels as one 16-byte vector. An empty voxel (no point: zero means
//    and occupancy) takes only the three products of its index / N values,
//    which give the same bits: most of a voxelized cloud's grid is empty.
//  - Statistics per tile: the tile's channel max first (a max over the
//    thread's four voxels, the warp's lanes, then the four warps through
//    shared memory), a rescale of the running sums where that max raises
//    the running max, then one exponential per element by ex2 with 1 / T and
//    log2(e) folded into one constant. Every thread of a CTA applies the same tile maxima, so its
//    partial sums share one running max and merge by plain sums at the end.
//  - No atomics: two launches give the same bits.

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace vx {
namespace voxel {

using vx::bf16;

constexpr int kC = kPreC;
constexpr int kTile = 64;       // voxels per tile
constexpr int kThreads = 128;   // 16 voxel rows x 8 channel groups
constexpr int kPerThread = kTile / (kThreads / 8);  // voxels per thread and tile
constexpr int kWarps = kThreads / 32;
static_assert(kThreads == 2 * kTile, "rows on threads 0-63, positions on 64-127");
constexpr int kRow = 16;        // floats per staged row: values 0-9, positions 12-14
constexpr int kPos = 12;
constexpr int kCtasPerSm = 2;   // resident CTAs per SM (read by voxel_pass_grid)

constexpr int kRowBufs = 3;    // a tile's rows stay until the tile after next

struct Smem {
  float rows[kRowBufs][kTile][kRow];
  float tmax[2][kWarps][kC];     // per warp channel maxima of a tile
  float sums[kWarps][4][kC];     // per warp s, wx, wd, wz at the end
  float bias[kC];
  float m[kC];                   // the running max per channel
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the positions (lin[i1], lin[i0], lin[i2]) of voxel v0 + t beside its row
// (zero past the grid), by threads t + kTile, whose share of the row
// source's staging is the lighter (K1's means and divisions run on the
// first kTile)
__device__ __forceinline__ void stage_positions(float (*rows)[kRow], long long v0, long long n3,
                                                int N, const float* __restrict__ lin) {
  const int tid = threadIdx.x - kTile;
  if (tid < 0) return;
  const long long v = v0 + tid;
  float px = 0.f, pd = 0.f, pz = 0.f;
  if (v < n3) {
    const unsigned u = (unsigned)v, nn = (unsigned)N * N;
    px = lin[u / N % N];
    pd = lin[u / nn];
    pz = lin[u % N];
  }
  rows[tid][kPos + 0] = px;
  rows[tid][kPos + 1] = pd;
  rows[tid][kPos + 2] = pz;
}

// the 1x1 conv of one row for 8 output channels: the f32 products of the
// row's channels K0 .. K1 - 1, summed in order from +0
template <int K0, int K1>
__device__ __forceinline__ void conv_row(const float (&row)[10], const float (&w)[10][8],
                                         float (&pre)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pre[j] = 0.f;
#pragma unroll
    for (int k = K0; k < K1; ++k) pre[j] += row[k] * w[k][j];
  }
}

// The pass over the tiles of sample blockIdx.y that CTA blockIdx.x of G
// takes; `src` fetches a tile's rows into registers and puts them into a
// row buffer (the rows rounded to bf16). part is [B, G, 5, 64].
template <class Src>
__device__ __forceinline__ void voxel_pass(Src& src, Smem& sh, const bf16* __restrict__ w1,
                                           const float* __restrict__ b1,
                                           const float* __restrict__ lin, int N, int G,
                                           bf16* __restrict__ d0, float* __restrict__ part) {
  const int b = blockIdx.y, tid = threadIdx.x;
  const int g = tid & 7, vr = tid >> 3, warp = tid >> 5, lane = tid & 31;
  const long long n3 = (long long)N * N * N;
  const int tiles = (int)((n3 + kTile - 1) / kTile);

  float w[10][8];
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const uint4 q = *reinterpret_cast<const uint4*>(w1 + k * kC + 8 * g);
    const bf16* h = reinterpret_cast<const bf16*>(&q);
#pragma unroll
    for (int j = 0; j < 8; ++j) w[k][j] = __bfloat162float(h[j]);
  }
  if (tid < kC) {
    sh.bias[tid] = b1[tid];
    sh.m[tid] = -INFINITY;
  }
  // the leaky relu's slope as a bf16 pair (bf16(0.02), as lrelu_rounded)
  const __nv_bfloat162 slope2 = __float2bfloat162_rn(kLreluSlopeBf16);
  // the running max times k = log2(e) / T (every thread of the CTA holds the
  // same; the max itself is kept in sh.m), and the running sums
  float mk[8], s[8], wx[8], wd[8], wz[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mk[j] = -INFINITY;
    s[j] = wx[j] = wd[j] = wz[j] = 0.f;
  }

  if ((int)blockIdx.x < tiles) {
    src.fetch(b, (long long)blockIdx.x * kTile);
    src.put(sh.rows[0], (long long)blockIdx.x * kTile);
    stage_positions(sh.rows[0], (long long)blockIdx.x * kTile, n3, N, lin);
  }
  __syncthreads();
  for (int i = blockIdx.x, it = 0; i < tiles; i += G, ++it) {
    const int rb = it % kRowBufs, tb = it & 1;  // row and tile-max buffers
    const long long v0 = (long long)i * kTile;
    const int next = i + G;
    if (next < tiles) src.fetch(b, (long long)next * kTile);

    uint32_t dv[kPerThread][4];  // this thread's d0 values as bf16 pairs
    __nv_bfloat162 lmax[4];      // channel pairs' max over this thread's voxels
#pragma unroll
    for (int j = 0; j < 4; ++j) lmax[j] = __float2bfloat162_rn(-INFINITY);
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int r = vr + 16 * q;
      const float4* rp = reinterpret_cast<const float4*>(sh.rows[rb][r]);
      const float4 r0 = rp[0], r1 = rp[1], r2 = rp[2];
      const float row[10] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w, r2.x, r2.y};
      const bool valid = v0 + r < n3;
      // An empty voxel's row is +-0 but for its index / N values (k = 6-8):
      // its other products are +-0, and adding them to the sum (which starts
      // at +0) changes no bit of it, so only those three are taken.
      const bool empty = ((__float_as_uint(r0.x) | __float_as_uint(r0.y) | __float_as_uint(r0.z) |
                           __float_as_uint(r0.w) | __float_as_uint(r1.x) | __float_as_uint(r1.y) |
                           __float_as_uint(r2.y)) << 1) == 0;
      float pre[8];
      const float4 bias0 = reinterpret_cast<const float4*>(&sh.bias[8 * g])[0];
      const float4 bias1 = reinterpret_cast<const float4*>(&sh.bias[8 * g])[1];
      const float bias[8] = {bias0.x, bias0.y, bias0.z, bias0.w,
                             bias1.x, bias1.y, bias1.z, bias1.w};
      if (empty)
        conv_row<6, 9>(row, w, pre);
      else
        conv_row<0, 10>(row, w, pre);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        // one rounding each, then lrelu_rounded on the pair: max(v, bf16(v
        // * slope)) is v where v >= 0 and the rounded product below
        const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(pre[j] + bias[j],
                                                                   pre[j + 1] + bias[j + 1]));
        const __nv_bfloat162 d = __hmax2(v, __hmul2(v, slope2));
        dv[q][j / 2] = *reinterpret_cast<const uint32_t*>(&d);
        if (valid) lmax[j / 2] = __hmax2(lmax[j / 2], d);
      }
      if (valid)
        *reinterpret_cast<uint4*>(d0 + ((size_t)b * n3 + v0 + r) * kC + 8 * g) =
            make_uint4(dv[q][0], dv[q][1], dv[q][2], dv[q][3]);
    }
    // the tile's channel max: over the warp's four voxel rows (lane bits 3,
    // 4), then over the warps after the barrier
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int o = 8; o <= 16; o *= 2) {
        uint32_t u = *reinterpret_cast<const uint32_t*>(&lmax[j]);
        u = __shfl_xor_sync(0xffffffffu, u, o);
        lmax[j] = __hmax2(lmax[j], *reinterpret_cast<const __nv_bfloat162*>(&u));
      }
    }
    if (lane < 8) {
      float4* t = reinterpret_cast<float4*>(&sh.tmax[tb][warp][8 * g]);
      const float2 m0 = __bfloat1622float2(lmax[0]), m1 = __bfloat1622float2(lmax[1]);
      const float2 m2 = __bfloat1622float2(lmax[2]), m3 = __bfloat1622float2(lmax[3]);
      t[0] = make_float4(m0.x, m0.y, m1.x, m1.y);
      t[1] = make_float4(m2.x, m2.y, m3.x, m3.y);
    }
    if (next < tiles) {
      const int nb = (it + 1) % kRowBufs;
      src.put(sh.rows[nb], (long long)next * kTile);
      stage_positions(sh.rows[nb], (long long)next * kTile, n3, N, lin);
    }
    __syncthreads();

    float mt[8];  // the tile's channel max: the four warps' maxima
    {
      const float4* t = reinterpret_cast<const float4*>(&sh.tmax[tb][0][8 * g]);
      float4 a = t[0], c = t[1];
#pragma unroll
      for (int ww = 1; ww < kWarps; ++ww) {
        const float4 a2 = t[ww * kC / 4], c2 = t[ww * kC / 4 + 1];
        a = make_float4(fmaxf(a.x, a2.x), fmaxf(a.y, a2.y), fmaxf(a.z, a2.z), fmaxf(a.w, a2.w));
        c = make_float4(fmaxf(c.x, c2.x), fmaxf(c.y, c2.y), fmaxf(c.z, c2.z), fmaxf(c.w, c2.w));
      }
      mt[0] = a.x, mt[1] = a.y, mt[2] = a.z, mt[3] = a.w;
      mt[4] = c.x, mt[5] = c.y, mt[6] = c.z, mt[7] = c.w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // where the tile raises the running max, the sums rescaled to it by
      // exp((m - mt) / T) = 2^(m k - mt k): 0 on the first tile (m k = -inf)
      stat_raise(mt[j] * kExp2Scale, mk[j], s[j], wx[j], wd[j], wz[j]);
    }
    if (vr == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) sh.m[8 * g + j] = fmaxf(sh.m[8 * g + j], mt[j]);
    }
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      if (v0 + vr + 16 * q >= n3) continue;
      const float4 pos = reinterpret_cast<const float4*>(sh.rows[rb][vr + 16 * q])[3];
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const uint32_t u = dv[q][j / 2];
        // exp((d - m) / T) = 2^(d k - m k), k = log2(e) / T
        const float e0 = hopper::exp2_approx(fmaf(__uint_as_float(u << 16), kExp2Scale, -mk[j]));
        const float e1 =
            hopper::exp2_approx(fmaf(__uint_as_float(u & 0xffff0000u), kExp2Scale, -mk[j + 1]));
        s[j] += e0;
        wx[j] += e0 * pos.x;
        wd[j] += e0 * pos.y;
        wz[j] += e0 * pos.z;
        s[j + 1] += e1;
        wx[j + 1] += e1 * pos.x;
        wd[j + 1] += e1 * pos.y;
        wz[j + 1] += e1 * pos.z;
      }
    }
  }

  // one partial per CTA: every thread holds the same running max per
  // channel, so the sums merge by addition (lanes, then warps in order)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int o = 8; o <= 16; o *= 2) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
      wx[j] += __shfl_xor_sync(0xffffffffu, wx[j], o);
      wd[j] += __shfl_xor_sync(0xffffffffu, wd[j], o);
      wz[j] += __shfl_xor_sync(0xffffffffu, wz[j], o);
    }
  }
  if (lane < 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sh.sums[warp][0][8 * g + j] = s[j];
      sh.sums[warp][1][8 * g + j] = wx[j];
      sh.sums[warp][2][8 * g + j] = wd[j];
      sh.sums[warp][3][8 * g + j] = wz[j];
    }
  }
  __syncthreads();
  if (tid < kC) {
    Stat st;
    st.m = sh.m[tid];
    st.s = sh.sums[0][0][tid];
    st.wx = sh.sums[0][1][tid];
    st.wd = sh.sums[0][2][tid];
    st.wz = sh.sums[0][3][tid];
#pragma unroll
    for (int ww = 1; ww < kWarps; ++ww) {
      st.s += sh.sums[ww][0][tid];
      st.wx += sh.sums[ww][1][tid];
      st.wd += sh.sums[ww][2][tid];
      st.wz += sh.sums[ww][3][tid];
    }
    stat_store(part + ((size_t)b * G + blockIdx.x) * kStatFields * kC, kC, tid, st);
  }
}

}  // namespace voxel
}  // namespace vx
