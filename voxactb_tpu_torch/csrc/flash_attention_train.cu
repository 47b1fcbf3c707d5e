// Trainable attention for Hopper (sm_90a): forward with saved row
// log-sum-exp and in-kernel hash dropout whose keep mask it also saves as
// bits, and the backward that recomputes the probabilities from lse and
// reads the mask back from those bits.
//
// Replaces voxactb_tpu/ops/pallas/flash_attention.py::flash_attention_train
// (TPU kernels `_train_fwd_kernel` and `_train_bwd_kernel`, mask `_hash_keep`),
// the Perceiver trunk's cross, self and decoder attention of the BC train step
// at bf16 with head dim 64, or 128 (the wrapper zero-pads heads of up to 64 to
// 64 and of 65-128 to 128, which is exact: zero columns add nothing to q k^T
// and give zero columns of O, dQ, dK and dV, and lse, the row term and the
// keep mask do not depend on the head dim, as in the TPU kernel, which pads
// to 128). q arrives pre-scaled by hd^-1/2 of the true head dim (in bf16).
//
// What bounds it on an H100: operations. One self attention of the train step
// at batch 8 (64 heads of 2048 x 2048) is 69 GFLOP forward and 172 GFLOP
// backward (the bound's counts) against 50 MB of q/k/v/o/lse traffic.
//
// Numerics follow the TPU kernels' rounding points.
//   forward:  l = q k^T in f32 (keys past Tk masked), m = rowmax l,
//             s = rowsum exp(l - m), lse = m + log s,
//             A = bf16((exp(l - m) / s) * keep / (1 - dropout)),
//             O = bf16(A v) with f32 accumulation.
//   backward: P = exp(l - lse), dA = dO v^T, dP = dA * keep / (1 - dropout),
//             dS = bf16(P * (dP - r)), dQ = dS k, dK = dS^T q,
//             dV = bf16(P * keep / (1 - dropout))^T dO, each accumulated in
//             f32 and rounded to bf16 once.
//
// Why two passes in the forward. Pass 1 folds the row max and sum over the
// key tiles; pass 2 forms A, already normalised, and A v. A one-pass online
// softmax would round unnormalised probabilities to bf16 and rescale the sum
// afterwards: another rounding point than the TPU kernel's, whose error the
// 2^-7 check (sized for summation order) would have to absorb. The second
// q k^T costs half again the forward's tensor work.
//
// Why the backward keeps its row-term pass. r = sum_j P dP is summed from P
// and dP themselves, as on the TPU, in a pass of its own. The shortcut
// delta = rowsum(dO * O) equals it in exact arithmetic, but carries the bf16
// rounding of O into every dS of the row: where k has a common component
// that cancels in dS k, that error does not cancel (measured on an H100: 24%
// of the largest dq on such inputs).
//
// The dropout mask is the TPU kernel's: the murmur3 finalizer of
// seed ^ index, kept where the hash >= thr, with
// index = ((bh * tq_pad) + row) * tk_pad + col in the TPU kernel's padded
// extents (passed in by the wrapper), so the mask is the same bit for bit
// whatever the tiling here. The index is formed in 64 bits; its high word,
// zero for every shape below 2^32 elements, is mixed into the hash instead
// of wrapping. Only the forward hashes (in its pass 2). It writes the mask as
// keep_bits [BH, Tq, W] uint32, W = ceil(Tk / 32): bit j of word w is column
// 32 w + j, bits of columns past Tk are 0. The dQ kernel reads a row's words
// from device memory; the dK/dV kernel has its producer warp stage the words
// of a query tile in shared memory, [key word][query] (read transposed). At
// dropout 0 no bits are written or read.
//
// Structure (hopper.cuh). Every kernel is warp-specialised: NC consumer
// warpgroups of 64 rows each, then one producer warpgroup whose first warp
// issues TMA loads into a 3-stage ring of shared-memory tiles guarded by
// full/empty mbarriers, and which hands its registers to the consumers with
// setmaxnreg (24 for the producer; 240 for the consumers at NC = 2, 384
// threads and one block per SM; 232 at NC = 1, 256 threads and two blocks per
// SM). ptxas still compiles the whole kernel within the launch bound, 168
// registers at NC = 2 and 128 at NC = 1, and spills a little beyond it.
// NC = 2 (128 rows per block) where that gives at least 7/8 of the SMs a
// block, else NC = 1 (the dK/dV kernel: always 2). Products run on wgmma
// (m64nNk16, bf16 in, f32 out): q k^T and its kin from shared memory, and
// P v and its kin with the probabilities (or dS) as the register A operand,
// so the softmax never leaves registers; row max and sum use the two
// shuffles within a quad of lanes. exp is exp2 on the special-function unit
// with log2(e) folded into one FMA (and in the forward's pass 2 the
// normalisation too: exp(l - m) / (s (1 - dropout)) = 2^(l log2(e) - mb)).
//  - forward: per block NC * 64 query rows; key tiles of 128 (K alone in
//    pass 1, K and V in pass 2). At NC = 2 the two warpgroups take turns at
//    issuing their products (PingPong), and pass 2 issues A v of a tile with
//    the next tile's q k^T, so that one warpgroup's softmax and hash overlap
//    the other's products (measured on an H100: 416 against 470 us at the
//    self shape with dropout). The same schedule made the dQ kernel slower
//    (548 against 528 us), so the backward keeps issue-and-wait.
//  - backward, dQ kernel: per block NC * 64 query rows, key tiles of 64, two
//    passes: the row term (written out for the dK/dV kernel), then dS and dQ.
//  - backward, dK/dV kernel: per block 128 keys, one pass over query tiles of
//    64 with the transposed products (k q^T and v dO^T), so dK and dV are
//    whole sums of one block; lse, r and the mask words of a query tile are
//    staged in shared memory with it.
// The forward's hash is bound by the integer pipe: about ten operations per
// element (see row_key); at 64 x 2048 x 2048 it adds half to the forward's
// time (measured on an H100: 416 us at dropout 0.1, 287 us at 0).
// No float atomics: a step is reproducible.
//
// Head dim 128 (C = 2 boxes): every operand tile is two 64-column boxes of one
// map (128-byte swizzle), loaded at columns 0 and 64, stored side by side. A
// product over the head dim sums both boxes' k16 steps in one accumulator; a
// product into the head dim is two n64 products, one per box. Every kernel
// runs at NC = 1 there (the dK/dV kernel at 64 keys per block) and is built
// for one block per SM without the register hand-over, so that its two output
// halves fit in registers. These variants are made to be right, not fast.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using vx::bf16;
using namespace vx::hopper;

constexpr int kMaxDevices = 64;
constexpr int kFwdBn = 128;  // keys per forward tile
constexpr int kBwdBn = 64;   // keys (dQ) or queries (dK/dV) per backward tile

// shared-memory plan: operand tiles resident for the whole block (NC 64-row
// tiles each), then the ring's stages, then the barriers (operands-full,
// full[S], empty[S])
struct Plan {
  int resident, stage_bytes;
  __host__ __device__ constexpr int stage(int s) const { return resident + s * stage_bytes; }
  __host__ __device__ constexpr int bar(int i) const {
    return resident + kStages * stage_bytes + 8 * i;
  }
  __host__ __device__ constexpr int bytes() const { return bar(1 + 2 * kStages) + 1024; }
};

// (C: 64-column boxes per operand row, 1 or 2)
template <int NC, int C>
__host__ __device__ constexpr Plan fwd_plan() {
  return Plan{NC * C * kTile64Bytes, 2 * C * kFwdBn * kRowBytes};
}
template <int NC, int C>
__host__ __device__ constexpr Plan dq_plan() {
  return Plan{2 * NC * C * kTile64Bytes, 2 * C * kBwdBn * kRowBytes};
}
// dK/dV (NC * 64 keys): k and v resident; a stage holds the q and dO tiles,
// then lse * log2(e) and r of the 64 queries, then the mask words [2 NC key
// words][64 queries]
template <int NC, int C>
__host__ __device__ constexpr Plan dkv_plan() {
  return Plan{2 * NC * C * kTile64Bytes, 2 * C * kBwdBn * kRowBytes + 3072};
}

// no register hand-over at C = 2, whose kernels are built for one block per
// SM (see the top)
template <int C>
__device__ __forceinline__ void producer_regs() {
  if constexpr (C == 1) setmaxnreg_dec<kProducerRegs>();
}
template <int NC, int C>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (C == 1) setmaxnreg_inc<Roles<NC>::kConsumerRegs>();
}

// issue d[64 x N] = A B^T over C 64-column boxes: box b of A at a_tile + b *
// a_box, of B at b_tile + b * b_box
template <int N, int C>
__device__ __forceinline__ void gemm_nt_boxes(float (&d)[N / 2], uint32_t a_tile, uint32_t a_box,
                                              uint32_t b_tile, uint32_t b_box) {
#pragma unroll
  for (int b = 0; b < C; ++b) gemm_nt<N>(d, a_tile + b * a_box, b_tile + b * b_box, b > 0);
}
// issue acc[b] += P B_b for the C boxes of B (box b at b_tile + b * b_box)
template <int N, int C>
__device__ __forceinline__ void gemm_rs_boxes(float (&acc)[C][32], const uint32_t (&a)[N / 16][4],
                                              uint32_t b_tile, uint32_t b_box) {
#pragma unroll
  for (int b = 0; b < C; ++b) gemm_rs<N>(acc[b], a, b_tile + b * b_box);
}
template <int C>
__device__ __forceinline__ void fence_boxes(float (&acc)[C][32]) {
#pragma unroll
  for (int b = 0; b < C; ++b) fence_regs(acc[b]);
}
template <int C>
__device__ __forceinline__ void zero_boxes(float (&acc)[C][32]) {
#pragma unroll
  for (int b = 0; b < C; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
}
// rows of 64 C values
template <int C>
__device__ __forceinline__ void store_boxes(const float (&acc)[C][32], bf16* dst, int row,
                                            int rows_valid, int qd) {
#pragma unroll
  for (int b = 0; b < C; ++b) store_rows_bf16(acc[b], dst + 64 * b, row, rows_valid, qd, 64 * C);
}

// The TPU kernel's mask: keep element `index` where
// fmix(lo(index) ^ seed ^ hi(index) * 0x9E3779B9) >= thr, fmix the murmur3
// finalizer. A forward tile's 128 columns start at a multiple of 128
// (tk_pad and the tile are multiples of 128), so their indices share the
// high word, and the index of column offset c < 128 from a base b with
// b % 128 == 0 is b ^ c: with y = (b + 2 qd) ^ seed ^ hi * 0x9E3779B9 the
// input is y ^ c, and its first step x ^= x >> 16 is (y ^ (y >> 16)) ^ c.
// `row_key` gives that y ^ (y >> 16) of a row and tile, `keep_after_mix` the
// rest of the finalizer.
__device__ __forceinline__ uint32_t row_key(uint32_t seed, unsigned long long base) {
  const uint32_t y = (uint32_t)base ^ seed ^ ((uint32_t)(base >> 32) * 0x9E3779B9u);
  return y ^ (y >> 16);
}
__device__ __forceinline__ bool keep_after_mix(uint32_t x, uint32_t thr) {
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return (x ^ (x >> 16)) >= thr;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int NC, int C>
__global__ void __launch_bounds__(Roles<NC>::kThreads, C == 1 ? Roles<NC>::kMinBlocks : 1)
train_fwd(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v, const long long* __restrict__ seed_ptr,
          bf16* __restrict__ o, float* __restrict__ lse, uint32_t* __restrict__ bits, int Tq,
          int Tk, uint32_t thr, float scale, int tq_pad, int tk_pad, int heads_local,
          int heads_global, long long head_base) {
  constexpr Plan P = fwd_plan<NC, C>();
  constexpr uint32_t kKBytes = kFwdBn * kRowBytes;  // a box of a key tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = align1024(smem_u32(smem_raw));
  const int bh = blockIdx.y, q0 = blockIdx.x * NC * 64;
  const int n_tiles = (Tk + kFwdBn - 1) / kFwdBn;
  if (threadIdx.x == 0) {
    mbar_init(base + P.bar(0), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(base + P.bar(1 + s), 1);
      mbar_init(base + P.bar(1 + kStages + s), NC * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == NC) {
    // producer: Q once, then K tiles (pass 1) and K, V tiles (pass 2)
    producer_regs<C>();
    if (threadIdx.x == NC * 128) {
      mbar_arrive_expect_tx(base + P.bar(0), NC * C * kTile64Bytes);
      for (int c = 0; c < NC; ++c)
        for (int b = 0; b < C; ++b)
          tma_load_rows(base + (c * C + b) * kTile64Bytes, &tm_q, base + P.bar(0), q0 + 64 * c,
                        bh, 64 * b);
      int it = 0;
      for (int pass = 0; pass < 2; ++pass)
        for (int t = 0; t < n_tiles; ++t, ++it) {
          const int s = Ring<kStages>::stage(it);
          const uint32_t full = base + P.bar(1 + s);
          mbar_wait(base + P.bar(1 + kStages + s), Ring<kStages>::parity(it) ^ 1);
          mbar_arrive_expect_tx(full, (pass ? 2 : 1) * C * kKBytes);
          for (int b = 0; b < C; ++b) {
            tma_load_rows(base + P.stage(s) + b * kKBytes, &tm_k, full, t * kFwdBn, bh, 64 * b);
            if (pass)
              tma_load_rows(base + P.stage(s) + (C + b) * kKBytes, &tm_v, full, t * kFwdBn, bh,
                            64 * b);
          }
        }
    }
  } else {
    consumer_regs<NC, C>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, qd = lane % 4;
    const int row = q0 + 64 * wg + 16 * warp + g;  // and row + 8
    const uint32_t q_tile = base + wg * C * kTile64Bytes;
    const bool drop = thr != 0u;
    const int W = (Tk + 31) / 32;
    mbar_wait(base + P.bar(0), 0);

    const PingPong turns{NC == 2, wg};
    turns.start();

    // pass 1: row max and sum of exp(l - max), folded over the key tiles
    float m[2] = {-INFINITY, -INFINITY}, s[2] = {0.f, 0.f};
    float acc[kFwdBn / 2];
    int it = 0;
    for (int t = 0; t < n_tiles; ++t, ++it) {
      const int st = Ring<kStages>::stage(it);
      mbar_wait(base + P.bar(1 + st), Ring<kStages>::parity(it));
      turns.take_turn();
      gemm_nt_boxes<kFwdBn, C>(acc, q_tile, kTile64Bytes, base + P.stage(st), kKBytes);
      wgmma_commit();
      turns.hand_over(false);
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(base + P.bar(1 + kStages + st));
      if (t * kFwdBn + kFwdBn > Tk) mask_columns(acc, t * kFwdBn + 2 * qd, Tk);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kFwdBn / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) mx = fmaxf(mx, acc[4 * j + 2 * h + e]);
        const float m_new = fmaxf(m[h], quad_max(mx));
        const float mb = m_new * kLog2e;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kFwdBn / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sum += exp2_approx(fmaf(acc[4 * j + 2 * h + e], kLog2e, -mb));
        s[h] = s[h] * exp2_approx((m[h] - m_new) * kLog2e) + sum;
        m[h] = m_new;
      }
    }
    float mb[2];
    unsigned long long index_row[2];
    // the mask's head: this block's row of heads in the global [B, H] batch
    const unsigned long long gbh = (unsigned long long)(
        head_base + (long long)(bh / heads_local) * heads_global + bh % heads_local);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h] = quad_sum(s[h]);
      const int r = row + 8 * h;
      if (qd == 0 && r < Tq) lse[(size_t)bh * Tq + r] = m[h] + logf(s[h]);
      mb[h] = fmaf(m[h], kLog2e, log2f(s[h] / scale));
      index_row[h] = (gbh * tq_pad + r) * (unsigned long long)tk_pad;
    }
    const uint32_t seed = drop ? (uint32_t)(*seed_ptr) : 0u;

    // pass 2: A = bf16(exp(l - m) / s * keep / (1 - dropout)); O += A v.
    // With two consumer warpgroups, A v of a tile is issued in the next tile's
    // turn, with its q k^T, so its stage is released one tile later (hence
    // three stages). With one, A v follows at once: under the 128 registers of
    // two blocks per SM, holding A across the next q k^T serialises the wgmma
    // (measured on an H100: 37 against 33 us at the decoder shape).
    constexpr bool kPipelined = NC == 2;
    float out[C][32];
    zero_boxes(out);
    uint32_t a[kFwdBn / 16][4];
    for (int t = 0; t < n_tiles; ++t, ++it) {
      const int st = Ring<kStages>::stage(it), prev = Ring<kStages>::stage(it - 1);
      mbar_wait(base + P.bar(1 + st), Ring<kStages>::parity(it));
      turns.take_turn();
      if (kPipelined && t > 0) {
        wgmma_fence();
        gemm_rs_boxes<kFwdBn, C>(out, a, base + P.stage(prev) + C * kKBytes, kKBytes);
      }
      gemm_nt_boxes<kFwdBn, C>(acc, q_tile, kTile64Bytes, base + P.stage(st), kKBytes);
      wgmma_commit();
      turns.hand_over(t == n_tiles - 1);
      wgmma_wait_all();
      fence_regs(acc);
      if (kPipelined) {
        fence_boxes(out);
        fence_regs(a);
        if (t > 0 && lane == 0) mbar_arrive(base + P.bar(1 + kStages + prev));
      }
      const int k0 = t * kFwdBn;
      if (k0 + kFwdBn > Tk) mask_columns(acc, k0 + 2 * qd, Tk);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!drop) {
#pragma unroll
          for (int j = 0; j < kFwdBn / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& l = acc[4 * j + 2 * h + e];
              l = exp2_approx(fmaf(l, kLog2e, -mb[h]));
            }
          continue;
        }
        // bit 8 (j % 4) + e of word[j / 4], shifted by 2 qd below, is column
        // k0 + 8 j + 2 qd + e
        uint32_t word[kFwdBn / 32];
#pragma unroll
        for (int w = 0; w < kFwdBn / 32; ++w) word[w] = 0u;
        const uint32_t key = row_key(seed, index_row[h] + k0 + 2 * qd);
#pragma unroll
        for (int j = 0; j < kFwdBn / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& l = acc[4 * j + 2 * h + e];
            const float p = exp2_approx(fmaf(l, kLog2e, -mb[h]));
            const bool keep = keep_after_mix(key ^ (8 * j + e), thr);
            l = keep ? p : 0.f;
            if (keep) word[j / 4] |= 1u << (8 * (j % 4) + e);
          }
        const int r = row + 8 * h;
#pragma unroll
        for (int w = 0; w < kFwdBn / 32; ++w) {
          word[w] <<= 2 * qd;
          word[w] |= __shfl_xor_sync(0xffffffffu, word[w], 1);
          word[w] |= __shfl_xor_sync(0xffffffffu, word[w], 2);
          // columns past Tk: no bit
          const int valid = Tk - (k0 + 32 * w);
          if (valid < 32) word[w] &= valid > 0 ? (1u << valid) - 1u : 0u;
          const int wi = k0 / 32 + w;
          if (qd == w % 4 && r < Tq && wi < W) bits[((size_t)bh * Tq + r) * W + wi] = word[w];
        }
      }
      a_fragments<kFwdBn>(acc, a);
      if (!kPipelined) {
        wgmma_fence();
        gemm_rs_boxes<kFwdBn, C>(out, a, base + P.stage(st) + C * kKBytes, kKBytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_boxes(out);
        fence_regs(a);
        if (lane == 0) mbar_arrive(base + P.bar(1 + kStages + st));
      }
    }
    if (kPipelined) {
      wgmma_fence();
      gemm_rs_boxes<kFwdBn, C>(out, a, base + P.stage(Ring<kStages>::stage(it - 1)) + C * kKBytes,
                               kKBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_boxes(out);
      fence_regs(a);
    }
    store_boxes(out, o + (size_t)bh * Tq * 64 * C, row, Tq, qd);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// dQ for NC * 64 query rows; also writes their row term r = sum_j P dP (`delta`)
template <int NC, int C>
__global__ void __launch_bounds__(Roles<NC>::kThreads, C == 1 ? Roles<NC>::kMinBlocks : 1)
train_bwd_dq(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
             const float* __restrict__ lse, const uint32_t* __restrict__ bits,
             bf16* __restrict__ dq, float* __restrict__ delta, int Tq, int Tk, float scale) {
  constexpr Plan P = dq_plan<NC, C>();
  constexpr uint32_t kKBytes = kBwdBn * kRowBytes;  // a box of a key tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = align1024(smem_u32(smem_raw));
  const int bh = blockIdx.y, q0 = blockIdx.x * NC * 64;
  const int n_tiles = (Tk + kBwdBn - 1) / kBwdBn;
  if (threadIdx.x == 0) {
    mbar_init(base + P.bar(0), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(base + P.bar(1 + s), 1);
      mbar_init(base + P.bar(1 + kStages + s), NC * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == NC) {
    // producer: Q and dO once, then K, V tiles twice over
    producer_regs<C>();
    if (threadIdx.x == NC * 128) {
      mbar_arrive_expect_tx(base + P.bar(0), 2 * NC * C * kTile64Bytes);
      for (int c = 0; c < NC; ++c)
        for (int b = 0; b < C; ++b) {
          tma_load_rows(base + (c * C + b) * kTile64Bytes, &tm_q, base + P.bar(0), q0 + 64 * c,
                        bh, 64 * b);
          tma_load_rows(base + ((NC + c) * C + b) * kTile64Bytes, &tm_do, base + P.bar(0),
                        q0 + 64 * c, bh, 64 * b);
        }
      for (int it = 0; it < 2 * n_tiles; ++it) {
        const int s = Ring<kStages>::stage(it), t = it % n_tiles;
        const uint32_t full = base + P.bar(1 + s);
        mbar_wait(base + P.bar(1 + kStages + s), Ring<kStages>::parity(it) ^ 1);
        mbar_arrive_expect_tx(full, 2 * C * kKBytes);
        for (int b = 0; b < C; ++b) {
          tma_load_rows(base + P.stage(s) + b * kKBytes, &tm_k, full, t * kBwdBn, bh, 64 * b);
          tma_load_rows(base + P.stage(s) + (C + b) * kKBytes, &tm_v, full, t * kBwdBn, bh,
                        64 * b);
        }
      }
    }
  } else {
    consumer_regs<NC, C>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, qd = lane % 4;
    const int row = q0 + 64 * wg + 16 * warp + g;  // and row + 8
    const uint32_t q_tile = base + wg * C * kTile64Bytes;
    const uint32_t do_tile = base + (NC + wg) * C * kTile64Bytes;
    const bool drop = bits != nullptr;
    const int W = (Tk + 31) / 32;
    float lb[2];
    const uint32_t* bits_row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      lb[h] = r < Tq ? lse[(size_t)bh * Tq + r] * kLog2e : 0.f;
      bits_row[h] = drop && r < Tq ? bits + ((size_t)bh * Tq + r) * W : nullptr;
    }
    mbar_wait(base + P.bar(0), 0);

    float sacc[32], da[32], dqacc[C][32];
    float rterm[2] = {0.f, 0.f};
    zero_boxes(dqacc);
    uint32_t a[kBwdBn / 16][4];
    for (int it = 0; it < 2 * n_tiles; ++it) {
      const bool pass2 = it >= n_tiles;
      const int k0 = (it % n_tiles) * kBwdBn;
      // this thread's mask words of the tile: 2 rows x 2 words, shifted so
      // that bit 8 (j % 4) + e is column k0 + 32 (j / 4) + 8 (j % 4) + 2 qd + e
      uint32_t word[2][2] = {{0u, 0u}, {0u, 0u}};
      if (drop) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int w = 0; w < 2; ++w)
            if (bits_row[h] && k0 / 32 + w < W) word[h][w] = bits_row[h][k0 / 32 + w] >> (2 * qd);
      }
      const int st = Ring<kStages>::stage(it);
      mbar_wait(base + P.bar(1 + st), Ring<kStages>::parity(it));
      // l = q k^T, dA = dO v^T
      gemm_nt_boxes<kBwdBn, C>(sacc, q_tile, kTile64Bytes, base + P.stage(st), kKBytes);
      gemm_nt_boxes<kBwdBn, C>(da, do_tile, kTile64Bytes, base + P.stage(st) + C * kKBytes,
                               kKBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);
      fence_regs(da);
      if (k0 + kBwdBn > Tk) mask_columns(sacc, k0 + 2 * qd, Tk);
      if (!pass2) {
        if (lane == 0) mbar_arrive(base + P.bar(1 + kStages + st));
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < kBwdBn / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * h + e;
              const float p = exp2_approx(fmaf(sacc[i], kLog2e, -lb[h]));
              const float ks =
                  !drop || ((word[h][j / 4] >> (8 * (j % 4) + e)) & 1u) ? scale : 0.f;
              rterm[h] += p * (da[i] * ks);
            }
        if (it == n_tiles - 1) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            rterm[h] = quad_sum(rterm[h]);
            const int r = row + 8 * h;
            if (qd == 0 && r < Tq) delta[(size_t)bh * Tq + r] = rterm[h];
          }
        }
        continue;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < kBwdBn / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const float p = exp2_approx(fmaf(sacc[i], kLog2e, -lb[h]));
            const float ks =
                !drop || ((word[h][j / 4] >> (8 * (j % 4) + e)) & 1u) ? scale : 0.f;
            sacc[i] = p * (da[i] * ks - rterm[h]);
          }
      a_fragments<kBwdBn>(sacc, a);
      wgmma_fence();
      gemm_rs_boxes<kBwdBn, C>(dqacc, a, base + P.stage(st), kKBytes);  // dQ += dS k
      wgmma_commit();
      wgmma_wait_all();
      fence_boxes(dqacc);
      fence_regs(a);
      if (lane == 0) mbar_arrive(base + P.bar(1 + kStages + st));
    }
    store_boxes(dqacc, dq + (size_t)bh * Tq * 64 * C, row, Tq, qd);
  }
}

// dK and dV for NC * 64 keys (NC consumer warpgroups): one pass over the query
// tiles with the transposed products
template <int NC, int C>
__global__ void __launch_bounds__(Roles<NC>::kThreads, C == 1 ? Roles<NC>::kMinBlocks : 1)
train_bwd_dkv(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const uint32_t* __restrict__ bits, bf16* __restrict__ dk, bf16* __restrict__ dv,
              int Tq, int Tk, float scale) {
  constexpr Plan P = dkv_plan<NC, C>();
  constexpr uint32_t kQBytes = kBwdBn * kRowBytes;  // a box of a query tile
  constexpr int kWords = 2 * NC;  // key words of the block
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = align1024(raw);
  unsigned char* smem = smem_raw + (base - raw);
  const int bh = blockIdx.y, k0 = blockIdx.x * NC * 64;
  const int n_tiles = (Tq + kBwdBn - 1) / kBwdBn;
  const bool drop = bits != nullptr;
  if (threadIdx.x == 0) {
    mbar_init(base + P.bar(0), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(base + P.bar(1 + s), 1 + 32);  // TMA arrival + the producer warp's lanes
      mbar_init(base + P.bar(1 + kStages + s), NC * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == NC) {
    // producer warp: K and V once, then per query tile q and dO (TMA) and
    // lse * log2(e), r and the mask words (lanes, plain loads)
    producer_regs<C>();
    if (threadIdx.x / 32 == NC * 4) {
      const int lane = threadIdx.x % 32;
      const int W = (Tk + 31) / 32;
      if (lane == 0) {
        mbar_arrive_expect_tx(base + P.bar(0), 2 * NC * C * kTile64Bytes);
        for (int c = 0; c < NC; ++c)
          for (int b = 0; b < C; ++b) {
            tma_load_rows(base + (c * C + b) * kTile64Bytes, &tm_k, base + P.bar(0), k0 + 64 * c,
                          bh, 64 * b);
            tma_load_rows(base + ((NC + c) * C + b) * kTile64Bytes, &tm_v, base + P.bar(0),
                          k0 + 64 * c, bh, 64 * b);
          }
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = Ring<kStages>::stage(t);
        const uint32_t full = base + P.bar(1 + s);
        mbar_wait(base + P.bar(1 + kStages + s), Ring<kStages>::parity(t) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(full, 2 * C * kQBytes);
          for (int b = 0; b < C; ++b) {
            tma_load_rows(base + P.stage(s) + b * kQBytes, &tm_q, full, t * kBwdBn, bh, 64 * b);
            tma_load_rows(base + P.stage(s) + (C + b) * kQBytes, &tm_do, full, t * kBwdBn, bh,
                          64 * b);
          }
        }
        float* side = reinterpret_cast<float*>(smem + P.stage(s) + 2 * C * kQBytes);
        uint32_t* words = reinterpret_cast<uint32_t*>(side + 2 * kBwdBn);
        for (int c = lane; c < kBwdBn; c += 32) {
          const int col = t * kBwdBn + c;
          const bool ok = col < Tq;
          side[c] = ok ? lse[(size_t)bh * Tq + col] * kLog2e : 0.f;
          side[kBwdBn + c] = ok ? delta[(size_t)bh * Tq + col] : 0.f;
          if (drop) {
#pragma unroll
            for (int w = 0; w < kWords; ++w) {
              const int wi = k0 / 32 + w;
              words[w * kBwdBn + c] = ok && wi < W ? bits[((size_t)bh * Tq + col) * W + wi] : 0u;
            }
          }
        }
        mbar_arrive(full);
      }
    }
  } else {
    consumer_regs<NC, C>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, qd = lane % 4;
    const int key = k0 + 64 * wg + 16 * warp + g;  // and key + 8
    const uint32_t k_tile = base + wg * C * kTile64Bytes;
    const uint32_t v_tile = base + (NC + wg) * C * kTile64Bytes;
    // the block's key word of this warp's 16 keys, and their bits in it
    const int word_of_warp = 2 * wg + warp / 2;
    const int bit0 = 16 * (warp % 2) + g;  // key + 8: bit0 + 8
    mbar_wait(base + P.bar(0), 0);

    float sacc[32], da[32], dkacc[C][32], dvacc[C][32];
    zero_boxes(dkacc);
    zero_boxes(dvacc);
    uint32_t a_ds[kBwdBn / 16][4], a_p[kBwdBn / 16][4];
    for (int t = 0; t < n_tiles; ++t) {
      const int st = Ring<kStages>::stage(t);
      const int q0 = t * kBwdBn;
      const uint32_t q_tile = base + P.stage(st), do_tile = q_tile + C * kQBytes;
      mbar_wait(base + P.bar(1 + st), Ring<kStages>::parity(t));
      gemm_nt_boxes<kBwdBn, C>(sacc, k_tile, kTile64Bytes, q_tile, kQBytes);  // l^T = k q^T
      gemm_nt_boxes<kBwdBn, C>(da, v_tile, kTile64Bytes, do_tile, kQBytes);   // dA^T = v dO^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);
      fence_regs(da);
      if (q0 + kBwdBn > Tq) mask_columns(sacc, q0 + 2 * qd, Tq);
      const float* side =
          reinterpret_cast<const float*>(smem + P.stage(st) + 2 * C * kQBytes);
      const uint32_t* words = reinterpret_cast<const uint32_t*>(side + 2 * kBwdBn);
#pragma unroll
      for (int j = 0; j < kBwdBn / 8; ++j) {
        const int c = 8 * j + 2 * qd;
        const float2 lb = *reinterpret_cast<const float2*>(side + c);
        const float2 rt = *reinterpret_cast<const float2*>(side + kBwdBn + c);
        uint2 wd = make_uint2(0u, 0u);
        if (drop) wd = *reinterpret_cast<const uint2*>(words + word_of_warp * kBwdBn + c);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const float p = exp2_approx(fmaf(sacc[i], kLog2e, -(e ? lb.y : lb.x)));
            const uint32_t w = e ? wd.y : wd.x;
            const float ks = !drop || ((w >> (bit0 + 8 * h)) & 1u) ? scale : 0.f;
            sacc[i] = p * (da[i] * ks - (e ? rt.y : rt.x));  // dS^T
            da[i] = p * ks;                                   // A^T
          }
      }
      a_fragments<kBwdBn>(sacc, a_ds);
      a_fragments<kBwdBn>(da, a_p);
      wgmma_fence();
      gemm_rs_boxes<kBwdBn, C>(dvacc, a_p, do_tile, kQBytes);  // dV += A^T dO
      gemm_rs_boxes<kBwdBn, C>(dkacc, a_ds, q_tile, kQBytes);  // dK += dS^T q
      wgmma_commit();
      wgmma_wait_all();
      fence_boxes(dkacc);
      fence_boxes(dvacc);
      fence_regs(a_ds);
      fence_regs(a_p);
      if (lane == 0) mbar_arrive(base + P.bar(1 + kStages + st));
    }
    store_boxes(dkacc, dk + (size_t)bh * Tk * 64 * C, key, Tk, qd);
    store_boxes(dvacc, dv + (size_t)bh * Tk * 64 * C, key, Tk, qd);
  }
}

// Once per device: the shared-memory opt-in of the kernels (cudaFuncSetAttribute
// is per device) and the SM count that picks NC.
cudaError_t device_setup(int* sms) {
  static bool done[kMaxDevices] = {};
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    const void* kernels[8] = {
        (const void*)train_fwd<1, 1>,     (const void*)train_fwd<2, 1>,
        (const void*)train_fwd<1, 2>,     (const void*)train_bwd_dq<1, 1>,
        (const void*)train_bwd_dq<2, 1>,  (const void*)train_bwd_dq<1, 2>,
        (const void*)train_bwd_dkv<2, 1>, (const void*)train_bwd_dkv<1, 2>};
    const int bytes[8] = {fwd_plan<1, 1>().bytes(),    fwd_plan<2, 1>().bytes(),
                          fwd_plan<1, 2>().bytes(),    dq_plan<1, 1>().bytes(),
                          dq_plan<2, 1>().bytes(),     dq_plan<1, 2>().bytes(),
                          dkv_plan<2, 1>().bytes(),    dkv_plan<1, 2>().bytes()};
    for (int i = 0; i < 8; ++i) {
      err = cudaFuncSetAttribute(kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes[i]);
      if (err != cudaSuccess) return err;
    }
    err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  *sms = sm_count[dev];
  return cudaSuccess;
}

// 128 rows per block where that gives at least 7/8 of the SMs a block, else
// 64 (measured on an H100: the decoder forward, 72 blocks of 128 rows, runs
// 12% faster as 136 blocks of 64; the cross forward, 128 blocks of 128, 13%
// faster than as 256 blocks of 64)
int consumer_groups(int BH, int T, int sms) {
  return 8ll * BH * ((T + 127) / 128) >= 7ll * sms ? 2 : 1;
}

}  // namespace

VX_EXPORT_ERROR_STRING(voxactb_flash_attention_train_error_string)

// q [BH, Tq, hd], k, v [BH, Tk, hd] bf16 contiguous and 16-byte aligned, hd 64
// or 128; seed: one int64 on the device holding a value below 2^32; o [BH, Tq,
// hd] bf16 and
// lse [BH, Tq] f32 are written, and with thr != 0 the keep mask as bits
// [BH, Tq, ceil(Tk / 32)] uint32 (else `bits` may be null).
// thr = round(dropout * 2^32) or 0 without dropout, scale = 1 / (1 - dropout);
// tq_pad, tk_pad: the padded extents of the mask index; row bh of the call is
// head head_base + (bh / heads_local) * heads_global + bh % heads_local of
// the mask (1, 1, 0: bh itself). Returns a cudaError_t.
extern "C" int voxactb_flash_attention_train_fwd(
    const void* q, const void* k, const void* v, const void* seed, void* o, void* lse,
    void* bits, int BH, int Tq, int Tk, unsigned int thr, float scale, int tq_pad,
    int tk_pad, int heads_local, int heads_global, long long head_base, int hd,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (tk_pad % kFwdBn != 0 || (hd != 64 && hd != 128))  // tk_pad: see row_key
    return (int)cudaErrorInvalidValue;
  if (heads_local < 1 || heads_global < heads_local || head_base < 0)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  VX_CHECK(device_setup(&sms));
  CUtensorMap tq, tk, tv;
  VX_CHECK(rows_map(&tq, q, BH, Tq, 64, hd));
  VX_CHECK(rows_map(&tk, k, BH, Tk, kFwdBn, hd));
  VX_CHECK(rows_map(&tv, v, BH, Tk, kFwdBn, hd));
  const long long* seedp = static_cast<const long long*>(seed);
  bf16* op = static_cast<bf16*>(o);
  float* lsep = static_cast<float*>(lse);
  uint32_t* bitsp = static_cast<uint32_t*>(bits);
  if (hd == 128) {
    dim3 grid((Tq + 63) / 64, BH);
    train_fwd<1, 2><<<grid, Roles<1>::kThreads, fwd_plan<1, 2>().bytes(), stream>>>(
        tq, tk, tv, seedp, op, lsep, bitsp, Tq, Tk, thr, scale, tq_pad, tk_pad, heads_local,
        heads_global, head_base);
  } else if (consumer_groups(BH, Tq, sms) == 2) {
    dim3 grid((Tq + 127) / 128, BH);
    train_fwd<2, 1><<<grid, Roles<2>::kThreads, fwd_plan<2, 1>().bytes(), stream>>>(
        tq, tk, tv, seedp, op, lsep, bitsp, Tq, Tk, thr, scale, tq_pad, tk_pad, heads_local,
        heads_global, head_base);
  } else {
    dim3 grid((Tq + 63) / 64, BH);
    train_fwd<1, 1><<<grid, Roles<1>::kThreads, fwd_plan<1, 1>().bytes(), stream>>>(
        tq, tk, tv, seedp, op, lsep, bitsp, Tq, Tk, thr, scale, tq_pad, tk_pad, heads_local,
        heads_global, head_base);
  }
  return (int)cudaGetLastError();
}

// The backward of the call above: lse is its output, d_o the cotangent of o
// (bf16), bits its keep mask (null without dropout). dq [BH, Tq, hd], dk, dv
// [BH, Tk, hd] bf16 and the scratch delta [BH, Tq] f32 (the row term) are
// written. Two launches: dQ (which also forms delta), then dK/dV.
extern "C" int voxactb_flash_attention_train_bwd(
    const void* q, const void* k, const void* v, const void* d_o, const void* lse,
    const void* bits, void* dq, void* dk, void* dv, void* delta, int BH, int Tq, int Tk,
    float scale, int hd, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  int sms = 0;
  VX_CHECK(device_setup(&sms));
  CUtensorMap tq, tk, tv, tdo;
  const float* lsep = static_cast<const float*>(lse);
  const uint32_t* bitsp = static_cast<const uint32_t*>(bits);
  float* deltap = static_cast<float*>(delta);
  // dQ: q and dO in 64-row boxes, k and v in key tiles
  VX_CHECK(rows_map(&tq, q, BH, Tq, 64, hd));
  VX_CHECK(rows_map(&tdo, d_o, BH, Tq, 64, hd));
  VX_CHECK(rows_map(&tk, k, BH, Tk, kBwdBn, hd));
  VX_CHECK(rows_map(&tv, v, BH, Tk, kBwdBn, hd));
  bf16* dqp = static_cast<bf16*>(dq);
  if (hd == 128) {
    dim3 grid((Tq + 63) / 64, BH);
    train_bwd_dq<1, 2><<<grid, Roles<1>::kThreads, dq_plan<1, 2>().bytes(), stream>>>(
        tq, tk, tv, tdo, lsep, bitsp, dqp, deltap, Tq, Tk, scale);
  } else if (consumer_groups(BH, Tq, sms) == 2) {
    dim3 grid((Tq + 127) / 128, BH);
    train_bwd_dq<2, 1><<<grid, Roles<2>::kThreads, dq_plan<2, 1>().bytes(), stream>>>(
        tq, tk, tv, tdo, lsep, bitsp, dqp, deltap, Tq, Tk, scale);
  } else {
    dim3 grid((Tq + 63) / 64, BH);
    train_bwd_dq<1, 1><<<grid, Roles<1>::kThreads, dq_plan<1, 1>().bytes(), stream>>>(
        tq, tk, tv, tdo, lsep, bitsp, dqp, deltap, Tq, Tk, scale);
  }
  VX_CHECK(cudaGetLastError());
  // dK/dV: k and v in 64-row boxes, q and dO in query tiles (all 64 rows);
  // 128 keys per block at head dim 64: at 64, under the 128 registers of two
  // blocks per SM, the kernel spills and its wgmma serialise (measured on an
  // H100: 68 us against 41 us at the cross shape). Head dim 128: 64 keys per
  // block, one block per SM.
  bf16 *dkp = static_cast<bf16*>(dk), *dvp = static_cast<bf16*>(dv);
  if (hd == 128) {
    dim3 grid_kv((Tk + 63) / 64, BH);
    train_bwd_dkv<1, 2><<<grid_kv, Roles<1>::kThreads, dkv_plan<1, 2>().bytes(), stream>>>(
        tq, tk, tv, tdo, lsep, deltap, bitsp, dkp, dvp, Tq, Tk, scale);
  } else {
    dim3 grid_kv((Tk + 127) / 128, BH);
    train_bwd_dkv<2, 1><<<grid_kv, Roles<2>::kThreads, dkv_plan<2, 1>().bytes(), stream>>>(
        tq, tk, tv, tdo, lsep, deltap, bitsp, dkp, dvp, Tq, Tk, scale);
  }
  return (int)cudaGetLastError();
}
