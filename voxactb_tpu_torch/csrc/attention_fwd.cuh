// The inference attention forward for Hopper (sm_90a), instantiated by the act
// path's attention (flash_attention.cu, head dim 64 or 128) and by SAM's rel-pos
// attention (sam_attention.cu, head dim 64 or 80, with the rel_h / rel_w
// bias): out = softmax(q k^T [+ rel_h + rel_w], keys past Tk masked) v.
//
// Numerics follow the TPU kernels: f32 logits of bf16 operands (q arrives
// pre-scaled in bf16), + rel_h, then + rel_w, in f32; the row max m and sum s
// of exp(l - m) over the whole key axis; P = bf16(exp(l - m) / s),
// normalised BEFORE its cast; P v accumulated in f32 and rounded to bf16
// once. Hence two passes over the key tiles, as in the trainable attention's
// forward (flash_attention_train.cu): pass 1 folds m and s, pass 2 forms P
// and P v. exp is exp2 with log2(e) and the normalisation folded into one
// FMA: exp(l - m) / s = 2^(l log2(e) - (m log2(e) + log2 s)).
//
// Structure (hopper.cuh): NC consumer warpgroups of 64 query rows, then one
// producer warpgroup whose first thread issues TMA loads of 128-key tiles
// (K in pass 1, K and V in pass 2) into a 3-stage mbarrier ring. q k^T runs
// on wgmma from 128-byte-swizzled tiles; the softmax stays in the accumulator
// fragment (row max and sum by quad shuffles); P is the register A operand of
// P v. At NC = 2 the warpgroups take turns at issuing (PingPong) and pass 2
// issues P v of a tile with the next tile's q k^T.
//
// Head dim 80 (SAM ViT-H): a 160-byte row is wider than one 128-byte swizzle
// box, so q, k and v each have a second tensor map over columns 64-79 (32-byte
// rows, 32-byte swizzle). q k^T takes four k16 steps on the first box and one
// on the second; P v is an n64 wgmma on V's first box plus an n16 on the
// second. Nothing is padded to 128 columns.
//
// Head dim 128 (the act path's heads of 65-128, zero-padded by the wrapper):
// each operand is two 64-column boxes of one map (128-byte swizzle), loaded
// at columns 0 and 64. q k^T sums both boxes' k16 steps into one
// accumulator; P v is two n64 products, one per box of V. It runs at 64 rows
// per block without a key split (its 64 KB stages leave no room for more)
// and without the register hand-over: the consumers' two output halves need
// more than the 128 registers of two blocks per SM, so it is built for one.
//
// Rel-pos bias (kBias): each block stages the rel_h [rows, kh] and rel_w
// [rows, kw] f32 rows of its queries in shared memory once; the bias is added
// to the f32 accumulator in registers. On a 64-wide grid (SAM's global
// blocks) a 64-key half-tile is one grid row: one rel_h per row and half-tile,
// rel_w by the column's offset in it. Elsewhere (14 x 14 windows) the grid
// position of each key is computed and both terms looked up.
//
// Key split (splits S > 1; head dim 64, no bias): where the row blocks cannot
// fill the card, the key tiles of a row block go to the S CTAs of one thread
// block cluster. Pass 1 folds each CTA's (m, s); every CTA then reads all S
// partials through distributed shared memory in rank order and merges them
// (with the -inf guard) into the whole row's m and s, so P is normalised with
// the whole row. Pass 2 forms P and a partial P v over the CTA's keys; the S
// partials are summed in rank order, each CTA summing a share of the rows,
// and rounded to bf16 once. No atomics: two launches give the same bits.

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace vx {
namespace attn_fwd {

using vx::bf16;
using namespace vx::hopper;

constexpr int kBn = 128;   // keys per tile
constexpr int kExLd = 72;  // f32 row stride of the partial outputs a key split exchanges

// per-head-dim tile sizes: the 64-column box, and at head dim 80 the 16-column one
template <int HD>
struct Geo {
  static_assert(HD == 64 || HD == 80 || HD == 128, "head dim 64, 80 or 128");
  static constexpr bool kNarrow = HD == 80;
  static constexpr bool kWide = HD == 128;  // two 64-column boxes per operand
  static constexpr int kBoxes = kWide ? 2 : 1;
  static constexpr int kQBox = 64 * 128;    // a 64-column box of 64 query rows
  static constexpr int kKBox = kBn * 128;   // of a key tile
  static constexpr int kQ0Bytes = kBoxes * kQBox;
  static constexpr int kQ1Bytes = kNarrow ? 64 * 32 : 0;
  static constexpr int kK0Bytes = kBoxes * kKBox;
  static constexpr int kK1Bytes = kNarrow ? kBn * 32 : 0;
  // accumulator floats per thread of the output columns past 64
  static constexpr int kOut1 = kWide ? 32 : 8;
  // a ring stage: K box 0, V box 0, K box 1, V box 1
  static constexpr int kV0 = kK0Bytes;
  static constexpr int kK1 = 2 * kK0Bytes;
  static constexpr int kV1 = kK1 + kK1Bytes;
  static constexpr int kStageBytes = 2 * (kK0Bytes + kK1Bytes);
};

// shared memory: the NC q tiles (box 0, then box 1), the ring, the barriers
// (q-full, full[S], empty[S]), then the bias rows or the split's exchange
template <int HD, int NC>
struct Plan {
  using G = Geo<HD>;
  static constexpr int kQ1 = NC * G::kQ0Bytes;
  static constexpr int kResident = (int)align1024(NC * (G::kQ0Bytes + G::kQ1Bytes));
  static constexpr int kExtra = kResident + kStages * G::kStageBytes + 64;
  __host__ __device__ static constexpr int stage(int s) {
    return kResident + s * G::kStageBytes;
  }
  __host__ __device__ static constexpr int bar(int i) { return stage(kStages) + 8 * i; }
  __host__ __device__ static constexpr int bytes(int extra_bytes) {
    return kExtra + extra_bytes + 1024;
  }
};

// f32 row stride of staged bias rows of n values: a row of 64 is padded to 72,
// so that the 8 rows a warp reads lie in distinct banks
__host__ __device__ constexpr int bias_ld(int n) { return n % 32 == 0 ? n + 8 : n; }

// bytes of the extra region: the bias rows of `rows` queries, or the
// exchange of a key split (per row (m, s), then the f32 partial output)
__host__ __device__ constexpr int bias_bytes(int rows, int kh, int kw) {
  return 4 * rows * (bias_ld(kh) + bias_ld(kw));
}
__host__ __device__ constexpr int exchange_bytes(int rows) { return 8 * rows + 4 * rows * kExLd; }

struct Args {
  bf16* o;
  const float* rel_h;  // [BH, Tq, kh] f32 (kBias)
  const float* rel_w;  // [BH, Tq, kw] f32 (kBias)
  int BH, Tq, Tk, kh, kw, splits;
  int bias_bufs;       // 1, or 2 where two items' bias rows fit (kBias)
};

// issue S[64 x 128] = q k^T over the head dim; the caller commits and waits
template <int HD>
__device__ __forceinline__ void qk(float (&acc)[kBn / 2], uint32_t q0_tile, uint32_t q1_tile,
                                   uint32_t stage) {
  gemm_nt<kBn>(acc, q0_tile, stage);
  if constexpr (Geo<HD>::kWide)
    gemm_nt<kBn>(acc, q0_tile + Geo<HD>::kQBox, stage + Geo<HD>::kKBox, true);
  if constexpr (Geo<HD>::kNarrow)
    wgmma_ss<kBn>(acc, desc_sw32(q1_tile), desc_sw32(stage + Geo<HD>::kK1), 1);
}

// issue out += P v over a tile: P as register fragments; the caller fences
// before and commits and waits
template <int HD>
__device__ __forceinline__ void pv(float (&out0)[32], float (&out1)[Geo<HD>::kOut1],
                                   const uint32_t (&a)[kBn / 16][4], uint32_t stage) {
  gemm_rs<kBn>(out0, a, stage + Geo<HD>::kV0);
  if constexpr (Geo<HD>::kWide) gemm_rs<kBn>(out1, a, stage + Geo<HD>::kV0 + Geo<HD>::kKBox);
  if constexpr (Geo<HD>::kNarrow) {
    const uint64_t db = desc_sw32(stage + Geo<HD>::kV1);
#pragma unroll
    for (int kk = 0; kk < kBn / 16; ++kk) wgmma_rs_n16(out1, a[kk], db + kk * kDescKStepMnMajor32);
  }
}

// l = (l + rel_h[row, c / kw]) + rel_w[row, c % kw] for this thread's columns
// c = k0 + 8 j + 2 qd + e < Tk of its two rows (bias rows bh[h], bw[h]).
// c / kw is floor((c + 1/2) / kw) in f32: exact for c < 2^16, whose quotient
// lies at least 1 / (2 kw) from an integer
__device__ __forceinline__ void add_rel_bias(float (&acc)[kBn / 2], const float* const* bh,
                                             const float* const* bw, int k0, int qd, int Tk,
                                             int kw, float inv_kw) {
  if (kw == 64) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float b0 = bh[h][k0 / 64];
      const float b1 = k0 + 64 < Tk ? bh[h][k0 / 64 + 1] : 0.f;
#pragma unroll
      for (int j = 0; j < kBn / 8; ++j) {
        const float2 w = *reinterpret_cast<const float2*>(bw[h] + 8 * (j % 8) + 2 * qd);
        const float b = j < 8 ? b0 : b1;
        acc[4 * j + 2 * h] = (acc[4 * j + 2 * h] + b) + w.x;
        acc[4 * j + 2 * h + 1] = (acc[4 * j + 2 * h + 1] + b) + w.y;
      }
    }
    return;
  }
  if (kw % 2 == 0) {
    // the thread's column pairs (c, c + 1) start at even c, so with kw even
    // they share a grid row, and their rel_w pair is one 8-byte load
#pragma unroll
    for (int j = 0; j < kBn / 8; ++j) {
      const int c = k0 + 8 * j + 2 * qd;
      if (c >= Tk) continue;  // then so is c + 1: Tk = kh kw is even
      const int hh = (int)(((float)c + 0.5f) * inv_kw), ww = c - hh * kw;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float b = bh[h][hh];
        const float2 w = *reinterpret_cast<const float2*>(bw[h] + ww);
        acc[4 * j + 2 * h] = (acc[4 * j + 2 * h] + b) + w.x;
        acc[4 * j + 2 * h + 1] = (acc[4 * j + 2 * h + 1] + b) + w.y;
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kBn / 8; ++j) {
    const int c = k0 + 8 * j + 2 * qd;
    int hh = (int)(((float)c + 0.5f) * inv_kw), ww = c - hh * kw;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (e == 1 && ++ww == kw) ww = 0, ++hh;  // column c + 1
      if (c + e >= Tk) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        acc[4 * j + 2 * h + e] = (acc[4 * j + 2 * h + e] + bh[h][hh]) + bw[h][ww];
    }
  }
}

template <int HD, int NC, bool kBias>
__global__ void __launch_bounds__(Roles<NC>::kThreads, HD == 128 ? 1 : Roles<NC>::kMinBlocks)
attention_fwd(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_q1,
              const __grid_constant__ CUtensorMap tm_k1,
              const __grid_constant__ CUtensorMap tm_v1, const Args args) {
  using G = Geo<HD>;
  using P = Plan<HD, NC>;
  constexpr int R = NC * 64;  // query rows per item
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = align1024(raw);
  unsigned char* smem = smem_raw + (base - raw);
  // barriers: q full, the ring's full[kStages] and empty[kStages], q empty
  const uint32_t q_full = base + P::bar(0), q_empty = base + P::bar(1 + 2 * kStages);
  const auto full = [&](int s) { return base + P::bar(1 + s); };
  const auto empty = [&](int s) { return base + P::bar(1 + kStages + s); };
  const int S = kBias || G::kWide ? 1 : args.splits;
  const int split = blockIdx.x % S;  // the CTA's rank in its cluster
  const int Tq = args.Tq, Tk = args.Tk;
  const int n_rb = (Tq + R - 1) / R, n_items = args.BH * n_rb;
  const int n_all = (Tk + kBn - 1) / kBn;
  const int t0 = split * n_all / S, t1 = (split + 1) * n_all / S;  // this CTA's key tiles
  const int stride = gridDim.x / S;  // the items this CTA takes: every stride-th
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, NC * 4);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NC * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == NC) {
    // producer: per item q, then K tiles (pass 1) and K, V tiles (pass 2)
    if constexpr (!G::kWide) setmaxnreg_dec<kProducerRegs>();
    int it = 0, n = 0;
    for (int item = blockIdx.x / S; item < n_items; item += stride, ++n) {
      const int bh = item / n_rb, q0 = item % n_rb * R;
      // it has nothing to publish at the merge: it arrives at once, so that
      // it can go on filling the ring while the consumers wait there
      if (S > 1) cluster_arrive();
      if (threadIdx.x / 32 == NC * 4 && threadIdx.x % 32 == 0) {
        mbar_wait(q_empty, (n & 1) ^ 1);
        mbar_arrive_expect_tx(q_full, NC * (G::kQ0Bytes + G::kQ1Bytes));
        for (int c = 0; c < NC; ++c) {
          tma_load_rows(base + c * G::kQ0Bytes, &tm_q, q_full, q0 + 64 * c, bh);
          if constexpr (G::kWide)
            tma_load_rows(base + c * G::kQ0Bytes + G::kQBox, &tm_q, q_full, q0 + 64 * c, bh,
                          64);
          if constexpr (G::kNarrow)
            tma_load_rows(base + P::kQ1 + c * G::kQ1Bytes, &tm_q1, q_full, q0 + 64 * c, bh,
                          64);
        }
        for (int pass = 0; pass < 2; ++pass)
          for (int t = t0; t < t1; ++t, ++it) {
            const int s = Ring<kStages>::stage(it);
            const uint32_t st = base + P::stage(s);
            mbar_wait(empty(s), Ring<kStages>::parity(it) ^ 1);
            mbar_arrive_expect_tx(full(s), (pass ? 2 : 1) * (G::kK0Bytes + G::kK1Bytes));
            tma_load_rows(st, &tm_k, full(s), t * kBn, bh);
            if constexpr (G::kWide) tma_load_rows(st + G::kKBox, &tm_k, full(s), t * kBn, bh, 64);
            if constexpr (G::kNarrow)
              tma_load_rows(st + G::kK1, &tm_k1, full(s), t * kBn, bh, 64);
            if (pass) {
              tma_load_rows(st + G::kV0, &tm_v, full(s), t * kBn, bh);
              if constexpr (G::kWide)
                tma_load_rows(st + G::kV0 + G::kKBox, &tm_v, full(s), t * kBn, bh, 64);
              if constexpr (G::kNarrow)
                tma_load_rows(st + G::kV1, &tm_v1, full(s), t * kBn, bh, 64);
            }
          }
      }
      // the loading lane's warp reconverges before it waits at the cluster
      // barrier, which would otherwise hold the loading lane back
      __syncwarp();
      if (S > 1) {
        cluster_wait();  // the merge
        cluster_sync();  // the partial outputs written
        cluster_sync();  // the partial outputs read
      }
    }
    return;
  }

  if constexpr (!G::kWide) setmaxnreg_inc<Roles<NC>::kConsumerRegs>();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int lr = 64 * wg + 16 * warp + g;  // the thread's rows in the item: lr, lr + 8
  const uint32_t q0_tile = base + wg * G::kQ0Bytes;
  const uint32_t q1_tile = base + P::kQ1 + wg * G::kQ1Bytes;
  const float inv_kw = kBias ? 1.f / args.kw : 0.f;
  const PingPong turns{NC == 2, wg};
  // the consumer warpgroups' barrier
  const auto consumers_sync = [] {
    asm volatile("bar.sync 3, %0;\n" ::"n"(NC * 128) : "memory");
  };
  // the rel_h [R, kh] and rel_w [R, kw] rows of an item, in rows of ldh and
  // ldw floats, in each of bias_bufs buffers
  const int kh = args.kh, kw = args.kw, ldh = bias_ld(kh), ldw = bias_ld(kw);
  const int bias_floats = R * (ldh + ldw);
  float* bias_buf = reinterpret_cast<float*>(smem + P::kExtra);
  const auto stage_bias = [&](int item_s, int buf) {
    const int bh_s = item_s / n_rb, q0_s = item_s % n_rb * R;
    const int valid = min(R, Tq - q0_s);
    const float* gh = args.rel_h + ((size_t)bh_s * Tq + q0_s) * kh;
    const float* gw = args.rel_w + ((size_t)bh_s * Tq + q0_s) * kw;
    float* sh = bias_buf + buf * bias_floats;
    float* sw = sh + R * ldh;
    for (int i = threadIdx.x; i < R * kh; i += NC * 128)
      cp_async_4(smem_u32(sh + i / kh * ldh + i % kh), i < valid * kh ? gh + i : gh,
                 i < valid * kh);
    for (int i = threadIdx.x; i < R * kw; i += NC * 128)
      cp_async_4(smem_u32(sw + i / kw * ldw + i % kw), i < valid * kw ? gw + i : gw,
                 i < valid * kw);
  };
  int it = 0, n = 0;
  for (int item = blockIdx.x / S; item < n_items; item += stride, ++n) {
    const int bh = item / n_rb, q0 = item % n_rb * R;
    const int row = q0 + lr;

    const float* bias_h[2] = {nullptr, nullptr};
    const float* bias_w[2] = {nullptr, nullptr};
    if constexpr (kBias) {
      // the item's rel_h and rel_w rows (zero past Tq), staged once, all
      // copies of an item in flight at once. With two buffers the next
      // item's copies are issued here too, so that they land while this one
      // is processed; a buffer is refilled once both warpgroups are done
      // with the item before.
      if (n > 0) consumers_sync();
      if (n == 0 || args.bias_bufs == 1) {
        stage_bias(item, n % args.bias_bufs);
        cp_async_commit();
      }
      if (args.bias_bufs == 2) {
        if (item + stride < n_items) stage_bias(item + stride, (n + 1) % 2);
        cp_async_commit();  // a group per item, empty after the last
        cp_async_wait_group<1>();
      } else {
        cp_async_wait_group<0>();
      }
      consumers_sync();
      const float* sh = bias_buf + n % args.bias_bufs * bias_floats;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bias_h[h] = sh + (lr + 8 * h) * ldh;
        bias_w[h] = sh + R * ldh + (lr + 8 * h) * ldw;
      }
    }
    mbar_wait(q_full, n & 1);
    turns.start();

    // pass 1: row max and sum of exp(l - max), folded over the key tiles
    float m[2] = {-INFINITY, -INFINITY}, s[2] = {0.f, 0.f};
    float acc[kBn / 2];
    for (int t = t0; t < t1; ++t, ++it) {
      const int st = Ring<kStages>::stage(it);
      mbar_wait(full(st), Ring<kStages>::parity(it));
      turns.take_turn();
      qk<HD>(acc, q0_tile, q1_tile, base + P::stage(st));
      wgmma_commit();
      turns.hand_over(false);
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty(st));
      const int k0 = t * kBn;
      if constexpr (kBias) add_rel_bias(acc, bias_h, bias_w, k0, qd, Tk, args.kw, inv_kw);
      if (k0 + kBn > Tk) mask_columns(acc, k0 + 2 * qd, Tk);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBn / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) mx = fmaxf(mx, acc[4 * j + 2 * h + e]);
        const float m_new = fmaxf(m[h], quad_max(mx));
        const float mb = m_new * kLog2e;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kBn / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sum += exp2_approx(fmaf(acc[4 * j + 2 * h + e], kLog2e, -mb));
        s[h] = s[h] * exp2_approx((m[h] - m_new) * kLog2e) + sum;
        m[h] = m_new;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) s[h] = quad_sum(s[h]);

    if (S > 1) {
      // the whole row's m and s from the S CTAs' partials, merged in rank
      // order by every CTA alike
      const uint32_t ms = base + P::kExtra;
      if (qd == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          reinterpret_cast<float2*>(smem + P::kExtra)[lr + 8 * h] = make_float2(m[h], s[h]);
      }
      cluster_sync();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t mine = ms + 8 * (lr + 8 * h);
        float mm = -INFINITY;
        for (int r = 0; r < S; ++r) mm = fmaxf(mm, ld_cluster_f32x2(cluster_map(mine, r)).x);
        float ss = 0.f;
        for (int r = 0; r < S; ++r) {
          const float2 part = ld_cluster_f32x2(cluster_map(mine, r));
          ss += part.x == -INFINITY ? 0.f : part.y * exp2_approx((part.x - mm) * kLog2e);
        }
        m[h] = mm;
        s[h] = ss;
      }
    }
    float mb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) mb[h] = fmaf(m[h], kLog2e, log2f(s[h]));

    // pass 2: P = bf16(exp(l - m) / s); O += P v. With two consumer
    // warpgroups, P v of a tile is issued in the next tile's turn, with its
    // q k^T, so its stage is released one tile later (hence three stages);
    // with one it follows at once (as in the trainable attention's forward).
    constexpr bool kPipelined = NC == 2;
    float out[32], out1[G::kOut1];
#pragma unroll
    for (int i = 0; i < 32; ++i) out[i] = 0.f;
#pragma unroll
    for (int i = 0; i < G::kOut1; ++i) out1[i] = 0.f;
    uint32_t a[kBn / 16][4];
    for (int t = t0; t < t1; ++t, ++it) {
      const int st = Ring<kStages>::stage(it), prev = Ring<kStages>::stage(it - 1);
      mbar_wait(full(st), Ring<kStages>::parity(it));
      turns.take_turn();
      if (kPipelined && t > t0) {
        wgmma_fence();
        pv<HD>(out, out1, a, base + P::stage(prev));
      }
      qk<HD>(acc, q0_tile, q1_tile, base + P::stage(st));
      wgmma_commit();
      turns.hand_over(t == t1 - 1);
      wgmma_wait_all();
      fence_regs(acc);
      if (kPipelined) {
        fence_regs(out);
        fence_regs(out1);
        fence_regs(a);
        if (t > t0 && lane == 0) mbar_arrive(empty(prev));
      }
      const int k0 = t * kBn;
      if constexpr (kBias) add_rel_bias(acc, bias_h, bias_w, k0, qd, Tk, args.kw, inv_kw);
      if (k0 + kBn > Tk) mask_columns(acc, k0 + 2 * qd, Tk);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < kBn / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& l = acc[4 * j + 2 * h + e];
            l = exp2_approx(fmaf(l, kLog2e, -mb[h]));
          }
      a_fragments<kBn>(acc, a);
      if (!kPipelined) {
        wgmma_fence();
        pv<HD>(out, out1, a, base + P::stage(st));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(out);
        fence_regs(out1);
        fence_regs(a);
        if (lane == 0) mbar_arrive(empty(st));
      }
    }
    // the last q k^T has been read: the producer may load the next item's q
    if (lane == 0) mbar_arrive(q_empty);
    if (kPipelined) {
      const int last = Ring<kStages>::stage(it - 1);
      wgmma_fence();
      pv<HD>(out, out1, a, base + P::stage(last));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(out);
      fence_regs(out1);
      fence_regs(a);
      if (lane == 0) mbar_arrive(empty(last));
    }

    bf16* ob = args.o + (size_t)bh * Tq * HD;
    if (S == 1) {
      store_rows_bf16(out, ob, row, Tq, qd, HD);
      if constexpr (G::kNarrow || G::kWide) store_rows_bf16(out1, ob + 64, row, Tq, qd, HD);
      continue;
    }
    // key split: the partial outputs, summed in rank order over the cluster,
    // each CTA taking a share of the rows
    float* po = reinterpret_cast<float*>(smem + P::kExtra + 8 * R);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(po + (lr + 8 * h) * kExLd + 8 * j + 2 * qd) =
            make_float2(out[4 * j + 2 * h], out[4 * j + 2 * h + 1]);
    cluster_sync();
    const uint32_t po_s = base + P::kExtra + 8 * R;
    const int r0 = split * R / S, r1 = (split + 1) * R / S;
    for (int i = threadIdx.x; i < (r1 - r0) * 16; i += NC * 128) {
      const int r = r0 + i / 16, c = 4 * (i % 16);
      if (q0 + r >= Tq) continue;
      const uint32_t mine = po_s + 4 * (r * kExLd + c);
      float4 v = ld_cluster_f32x4(cluster_map(mine, 0));
      for (int p = 1; p < S; ++p) {
        const float4 w = ld_cluster_f32x4(cluster_map(mine, p));
        v.x += w.x;
        v.y += w.y;
        v.z += w.z;
        v.w += w.w;
      }
      *reinterpret_cast<uint2*>(ob + (size_t)(q0 + r) * HD + c) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
    cluster_sync();  // no CTA goes on (or leaves) while another reads its partials
  }
}

}  // namespace attn_fwd
}  // namespace vx
