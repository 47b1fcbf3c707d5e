// The decoder tail shared by the decoder kernels (sm_90a): skip-concat k3
// conv + lrelu, the k3 trans head(s) and the soft-argmax / global-max stats
// over u. decoder_head.cu (K3) runs it on d0 and a given u0;
// decoder_head_v3.cu (K8) on d0 and the u0 it synthesises first.
//
//   1. tail_conv (tail_conv.cuh) - u = lrelu(bf16(conv(cat[d0, u0]) + bf))
//      on wgmma over staged halo bricks, replicate padding as an index clamp
//      in all three axes (the TPU ring clamps plane -1 to 0 and N to N-1);
//      u is written to a bf16 scratch grid.
//   2. tail_trans_stats - trans = sum over the 27 clamped neighbours of
//      u . wt + bt, kept in f32 (not rounded to bf16, as the TPU kernel), and
//      a soft-argmax partial per channel of u, from staged halo bricks (below).
//   3. stats_combine (common.cuh) - merge the partials into kp / gmax.
//
// Step 2 in detail. What bounds it on an H100: bytes. At N = 100, B = 1 it
// reads u (128 MB) and writes trans (4-8 MB): about 0.04 ms at the memory
// rate; its 3.5 GFLOP are nothing to the tensor cores.
//  - A CTA of 8 warps walks the output bricks of tail_conv.cuh's geometry
//    (4 x 8 x 8 voxels; brick_grid in ops/cuda/decoder_head.py) of one
//    sample, every G-th: G CTAs per sample, two per SM. Each brick's
//    6 x 10 x 10 halo of u is staged once by cp.async with every index
//    clamped (tail_conv.cuh's swizzle), so u leaves L2 about 600 / 256 = 2.3
//    times, not once per tap.
//  - The halo goes out as three cp.async groups of two planes, and the
//    products of a pair start as soon as it has landed. Once the products
//    and the statistics are in, the next brick's halo is issued, and this
//    brick's trans stores run while it loads.
//  - trans on the tensor cores, as mma.sync m16n8k16 (bf16 operands, f32
//    accumulation; bf16 x bf16 products are exact in f32, so the function
//    is the plain version's, summed in another order). Warp w owns the rows
//    y = 2 (w % 4), + 1 (x = 0..7) and the k16 steps 2 (w / 4), + 1. For
//    each halo plane and (dy, dx, k16 step) it gathers the A fragment by
//    ldmatrix with per-lane row addresses and multiplies it by a B tile
//    whose eight columns are the taps dz = 0, 1, 2 times the T heads (zero
//    past 3 T), held in registers for the whole launch: plane hz's product
//    holds what it gives output plane hz - dz through tap dz, so one
//    product serves all three dz. The products go to shared memory per (k
//    half, plane); each output voxel then sums its 3 dz x 2 halves in a
//    fixed order, and trans is stored coalesced. Not wgmma: an n8 product leaves a 64-row
//    warpgroup tile per plane and nothing to overlap.
//  - Statistics from the staged halo's interior: warp w folds the half
//    y = 4 (w / 4) .. + 3 of plane z = w % 4 of each brick, two channels per
//    lane, in two passes (the max by bf16 pairs, then exp((u - max) / T) by
//    ex2 and the position-weighted sums) and merges that into its running
//    Stat; the eight warps' Stats merge into one partial per CTA: part [B,
//    G, 5, 64].
//  - No atomics: two launches give the same bits.

#pragma once

#include "common.cuh"
#include "tail_conv.cuh"

namespace vx {
namespace tail {

using namespace vx::hopper;
using tailconv::Brick;
using tailconv::brick_at;
using tailconv::kBx;
using tailconv::kBy;
using tailconv::kBz;
using tailconv::kHaloBytes;
using tailconv::kHx;
using tailconv::kHy;

constexpr int kC = 64;
constexpr int kTsWarps = 8;
constexpr int kTsThreads = kTsWarps * 32;
constexpr int kHalves = 2;  // of the 4 k16 steps
// the products: [k half][halo plane][y][x][8 columns] f32
constexpr int kProdBytes = kHalves * (kBz + 2) * kBy * kBx * 8 * 4;
constexpr int kStatBytes = kTsWarps * kStatFields * kC * 4;
constexpr int kScratchBytes = kProdBytes > kStatBytes ? kProdBytes : kStatBytes;
constexpr int kTsSmemBytes = kHaloBytes + kScratchBytes;
static_assert(kBz == 4 && kBy == 2 * 4 && kBx == 8, "warp w owns rows y = 2 (w % 4), + 1");
static_assert(kTsThreads == kBz * kBy * kBx, "one thread per output voxel");

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ uint32_t pack_bf16x2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// halo planes hz0, hz0 + 1 of u around a brick, clamped and swizzled as
// tail_conv.cuh's stage_halo stages its halo, by the CTA's threads (the
// caller commits)
__device__ __forceinline__ void stage_planes(uint32_t halo, const bf16* __restrict__ src,
                                             const Brick& br, int N, int hz0, int tid) {
  const bf16* sb = src + (size_t)br.b * N * N * N * kC;
  constexpr int kPlane = kHy * kHx;
  for (int j = tid; j < 2 * kPlane * 8; j += kTsThreads) {
    const int v = hz0 * kPlane + (j >> 3), c = j & 7;
    const int hz = v / kPlane, hy = v / kHx % kHy, hx = v % kHx;
    const int gz = min(max(br.z0 + hz - 1, 0), N - 1);
    const int gy = min(max(br.y0 + hy - 1, 0), N - 1);
    const int gx = min(max(br.x0 + hx - 1, 0), N - 1);
    cp_async_16(halo + v * 128 + ((c ^ (v & 7)) << 4),
                sb + (((size_t)gz * N + gy) * N + gx) * kC + c * 8);
  }
}

// u [B, N^3, 64] bf16; wt [27, 64, T] bf16; bt [T], lin [N] f32. Grid (G, B).
template <int T>
__global__ void __launch_bounds__(kTsThreads, 2)
tail_trans_stats(const bf16* __restrict__ u, const bf16* __restrict__ wt,
                 const float* __restrict__ bt, const float* __restrict__ lin, int N,
                 float* __restrict__ trans, float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t halo = smem_u32(smem);
  float* scratch = reinterpret_cast<float*>(smem + kHaloBytes);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wy = warp % 4, kh = warp / 4;
  const int b = blockIdx.y, G = gridDim.x;
  const int per = ((N + kBz - 1) / kBz) * ((N + kBy - 1) / kBy) * ((N + kBx - 1) / kBx);

  // this lane's B fragments of ((dy, dx) = g9, k16 step 2 kh + k2): rows k =
  // 2t, 2t + 1 and 2t + 8, 2t + 9 (t = lane % 4) of column g = lane / 4 =
  // dz T + head (zero for g >= 3 T)
  uint2 bw[9][2];
  {
    const int g = lane >> 2, t = lane & 3;
    const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
    for (int g9 = 0; g9 < 9; ++g9)
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const bf16* w = wt + ((size_t)(9 * (g / T) + g9) * kC + 16 * (2 * kh + k2)) * T + g % T;
        const auto at = [&](int k) { return g < 3 * T ? w[k * T] : zero; };
        bw[g9][k2] = make_uint2(pack_bf16x2(at(2 * t), at(2 * t + 1)),
                                pack_bf16x2(at(2 * t + 8), at(2 * t + 9)));
      }
  }

  // ldmatrix row of this lane at halo plane 0 and tap (0, 0): row 8 (lane /
  // 8 % 2) + lane % 8 of the warp's 16 (y = 2 wy + lane / 8 % 2, x = lane %
  // 8); channel chunk lane / 16 of each k16 step
  const int lv = (2 * wy + (lane >> 3 & 1)) * kHx + (lane & 7);
  const int lchunk = lane >> 4;
  Stat st0 = stat_empty(), st1 = stat_empty();  // channels 2 lane, 2 lane + 1

  if (blockIdx.x < per) {
    const Brick br = brick_at(b * per + blockIdx.x, N);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      stage_planes(halo, u, br, N, 2 * s, tid);
      cp_async_commit();
    }
  }
  for (int p = blockIdx.x; p < per; p += G) {
    const Brick br = brick_at(b * per + p, N);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (s == 0) cp_async_wait_group<2>();
      if (s == 1) cp_async_wait_group<1>();
      if (s == 2) cp_async_wait_group<0>();
      __syncthreads();  // halo planes 2 s, 2 s + 1 have landed
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int hz = 2 * s + h2;
        float acc[2][4];  // by k2, added at the end
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[k2][e] = 0.f;
#pragma unroll
        for (int g9 = 0; g9 < 9; ++g9)
#pragma unroll
          for (int k2 = 0; k2 < 2; ++k2) {
            const int v = lv + (hz * kHy + g9 / 3) * kHx + g9 % 3;
            const int chunk = 2 * (2 * kh + k2) + lchunk;
            uint32_t a[4];
            ldmatrix_x4(a, halo + v * 128 + ((chunk ^ (v & 7)) << 4));
            mma_16816(acc[k2], a, bw[g9][k2]);
          }
        // rows g (y = 2 wy), g + 8 (y = 2 wy + 1), x = g; columns 2 q, 2 q + 1
        float* prod = scratch + (((kh * (kBz + 2) + hz) * kBy + 2 * wy) * kBx + lane / 4) * 8
                      + 2 * (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(prod + h * kBx * 8) =
              make_float2(acc[0][2 * h] + acc[1][2 * h], acc[0][2 * h + 1] + acc[1][2 * h + 1]);
      }
    }
    // statistics of half kh of plane z0 + wy of the brick, channels 2 lane,
    // 2 lane + 1, from the halo: its 32 values loaded at once, then the max,
    // then the sums (voxels past the grid left out)
    const int z = br.z0 + wy, y0 = br.y0 + 4 * kh;
    const int ny = min(4, N - y0), nx = min(kBx, N - br.x0);
    if (z < N && ny > 0) {
      const int c = lane >> 2;  // the 16-byte chunk of the two channels
      __nv_bfloat162 raw[4][kBx];
#pragma unroll
      for (int yy = 0; yy < 4; ++yy)
#pragma unroll
        for (int xx = 0; xx < kBx; ++xx) {
          const int v = ((wy + 1) * kHy + 4 * kh + yy + 1) * kHx + xx + 1;
          raw[yy][xx] = *reinterpret_cast<const __nv_bfloat162*>(
              smem + v * 128 + ((c ^ (v & 7)) << 4) + (lane & 3) * 4);
        }
      __nv_bfloat162 mx = raw[0][0];
#pragma unroll
      for (int yy = 0; yy < 4; ++yy)
#pragma unroll
        for (int xx = 0; xx < kBx; ++xx)
          if (yy < ny && xx < nx) mx = __hmax2(mx, raw[yy][xx]);
      const float m0 = __low2float(mx), m1 = __high2float(mx);
      // exp((u - m) / T) = 2^(u k - m k), k = log2(e) / T
      const float o0 = m0 * kExp2Scale, o1 = m1 * kExp2Scale;
      Stat s0, s1;  // position sums: wx by lin[y], wd by lin[z], wz by lin[x]
      s0.m = m0;
      s1.m = m1;
      s0.s = s0.wx = s0.wz = s1.s = s1.wx = s1.wz = 0.f;
#pragma unroll
      for (int yy = 0; yy < 4; ++yy) {
        if (yy >= ny) break;
        float r0 = 0.f, r1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
        for (int xx = 0; xx < kBx; ++xx)
          if (xx < nx) {
            const float px = lin[br.x0 + xx];
            const float2 f = __bfloat1622float2(raw[yy][xx]);
            const float e0 = exp2_approx(fmaf(f.x, kExp2Scale, -o0));
            const float e1 = exp2_approx(fmaf(f.y, kExp2Scale, -o1));
            r0 += e0;
            r1 += e1;
            q0 += e0 * px;
            q1 += e1 * px;
          }
        const float py = lin[y0 + yy];
        s0.s += r0;
        s1.s += r1;
        s0.wx += r0 * py;
        s1.wx += r1 * py;
        s0.wz += q0;
        s1.wz += q1;
      }
      s0.wd = s0.s * lin[z];
      s1.wd = s1.s * lin[z];
      stat_merge(st0, s0);
      stat_merge(st1, s1);
    }

    // every warp is done with the halo: the next brick's (empty groups after
    // the last brick keep the wait_group counts) loads under this brick's
    // trans stores
    __syncthreads();
    const bool more = p + G < per;
    const Brick nbr = brick_at(b * per + (more ? p + G : p), N);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (more) stage_planes(halo, u, nbr, N, 2 * s, tid);
      cp_async_commit();
    }

    // trans of this thread's voxel (z, y, x): column dz T + t of halo plane
    // z + dz, over the k halves and dz
    {
      const int vz = tid / (kBy * kBx), vy = tid / kBx % kBy, vx = tid % kBx;
      const int gz = br.z0 + vz, gy = br.y0 + vy, gx = br.x0 + vx;
      if (gz < N && gy < N && gx < N) {
#pragma unroll
        for (int t = 0; t < T; ++t) {
          float v = 0.f;
#pragma unroll
          for (int h = 0; h < kHalves; ++h)
#pragma unroll
            for (int dz = 0; dz < 3; ++dz)
              v += scratch[(((h * (kBz + 2) + vz + dz) * kBy + vy) * kBx + vx) * 8 + dz * T + t];
          trans[((((size_t)b * N + gz) * N + gy) * N + gx) * T + t] = v + bt[t];
        }
      }
    }
    __syncthreads();  // every thread is done with the products
  }
  cp_async_wait_group<0>();

  // the eight warps' partials, merged in warp order
  float* mine = scratch + warp * kStatFields * kC;
  stat_store(mine, kC, 2 * lane, st0);
  stat_store(mine, kC, 2 * lane + 1, st1);
  __syncthreads();
  if (tid < kC) {
    Stat st = stat_load(scratch, kC, tid);
    for (int w = 1; w < kTsWarps; ++w)
      stat_merge(st, stat_load(scratch + w * kStatFields * kC, kC, tid));
    stat_store(part + ((size_t)b * G + blockIdx.x) * kStatFields * kC, kC, tid, st);
  }
}

// Internal linkage: K3's and K8's libraries each hold a copy (tail_conv.cuh's
// launch_tail_conv says why).
template <int T>
static cudaError_t launch_trans_stats_t(const bf16* u, const bf16* wt, const float* bt,
                                        const float* lin, int B, int N, int G, float* trans,
                                        float* part, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        tail_trans_stats<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTsSmemBytes);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  tail_trans_stats<T><<<dim3(G, B), kTsThreads, kTsSmemBytes, stream>>>(u, wt, bt, lin, N,
                                                                         trans, part);
  return cudaGetLastError();
}

// Steps 2-3 on u [B, N, N, N, 64] bf16: G CTAs per sample (at most the
// sample's bricks), part [B, G, 5, 64] f32 scratch.
static int run_trans_stats(const void* u, const void* wt, const float* bt, const float* lin,
                           int B, int N, int T, int G, float* part, float* trans, float* kp,
                           float* gmax, cudaStream_t stream) {
  const long long per = tailconv::brick_count(1, N);
  if (G < 1 || G > per || B > 65535) return (int)cudaErrorInvalidValue;
  const bf16* ub = static_cast<const bf16*>(u);
  const bf16* wb = static_cast<const bf16*>(wt);
  if (T == 1) {
    VX_CHECK(launch_trans_stats_t<1>(ub, wb, bt, lin, B, N, G, trans, part, stream));
  } else if (T == 2) {
    VX_CHECK(launch_trans_stats_t<2>(ub, wb, bt, lin, B, N, G, trans, part, stream));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  VX_CHECK(launch_stats_combine<kC>(part, B, G, kp, gmax, stream));
  return 0;
}

// Steps 1-3 on d0, u0 [B, N, N, N, 64] bf16 (arguments as voxactb_decoder_head).
static int run_decoder_tail(const void* d0, const void* u0, const void* wf, const float* bf,
                            const void* wt, const float* bt, const float* lin, int B, int N,
                            int T, int G, void* u, float* part, float* trans, float* kp,
                            float* gmax, cudaStream_t stream) {
  VX_CHECK(tailconv::launch_tail_conv(
      static_cast<const bf16*>(d0), static_cast<const bf16*>(u0),
      static_cast<const bf16*>(wf), bf, B, N, static_cast<bf16*>(u), stream));
  return run_trans_stats(u, wt, bt, lin, B, N, T, G, part, trans, kp, gmax, stream);
}

}  // namespace tail
}  // namespace vx
