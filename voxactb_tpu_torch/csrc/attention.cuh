// Tile helpers shared by the attention kernels (flash_attention.cu,
// flash_attention_train.cu, sam_attention.cu): 64-key tiles, 4 warps of 16
// rows, bf16 operands in padded shared-memory rows, f32 logit slabs, WMMA
// 16x16x16. The head dim HD is a template parameter (a multiple of 16; 64, the
// Perceiver's, by default); a q/k/v tile row holds HD + 8 bf16 values.

#pragma once

#include "common.cuh"

namespace vx {
namespace attn {

constexpr int kHd = 64;
constexpr int kBk = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kHd + 8;     // bf16 row stride of the q/k/v tiles at head dim 64
constexpr int kLdP = kBk + 8;    // bf16 row stride of a P tile (64 keys)
constexpr int kLdS = kBk + 4;    // f32 row stride of the logit slab

// rows x HD bf16 (HD / 8 chunks of 16 bytes per row) by `nt` threads; rows
// past rows_valid are zero
template <int HD = kHd>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int rows,
                                          int rows_valid, int t, int nt) {
  constexpr int kChunks = HD / 8;
  for (int j = t; j < rows * kChunks; j += nt) {
    int r = j / kChunks, ch = j % kChunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows_valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * HD + ch * 8);
    *reinterpret_cast<uint4*>(dst + r * (HD + 8) + ch * 8) = val;
  }
}

// S (16 x 64, f32, in shared memory) = A_warp (16 x HD) . B_tile^T, where
// B_tile holds 64 rows of HD (keys for q k^T; queries for k q^T)
template <int HD = kHd>
__device__ __forceinline__ void logits_slab(const bf16* Qw, const bf16* Ks, float* Sw) {
  using namespace nvcuda;
  constexpr int ld = HD + 8;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> s[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(s[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, Qw + kk * 16, ld);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      // K^T as a column-major (d x key) matrix is K's row-major (key x d) storage
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
      wmma::load_matrix_sync(bk, Ks + n * 16 * ld + kk * 16, ld);
      wmma::mma_sync(s[n], a, bk, s[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(Sw + n * 16, s[n], kLdS, wmma::mem_row_major);
}

// acc (16 x HD, HD / 16 f32 fragments) += P_warp (16 x 64 bf16, row stride
// kLdP) . V_tile (64 x HD bf16, row stride HD + 8)
template <int HD = kHd>
__device__ __forceinline__ void accumulate_pv(
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>* acc,
    const bf16* Pw, const bf16* Vs) {
  using namespace nvcuda;
  constexpr int ld = HD + 8;
#pragma unroll
  for (int kk = 0; kk < kBk / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, Pw + kk * 16, kLdP);
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
      wmma::load_matrix_sync(bv, Vs + kk * 16 * ld + n * 16, ld);
      wmma::mma_sync(acc[n], a, bv, acc[n]);
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace attn
}  // namespace vx
