// Hopper (sm_90a) building blocks written as raw PTX: TMA tile loads through
// 3-D tensor maps, mbarrier rings, warpgroup matrix multiply (wgmma) with
// shared-memory descriptors for 128-byte-swizzled tiles, register
// rebalancing, thread-block clusters and their distributed shared memory.
// Used by the trainable attention (flash_attention_train.cu), by the
// inference forward loop of attention_fwd.cuh, which the act path's attention
// (flash_attention.cu) and SAM's rel-pos attention (sam_attention.cu)
// instantiate, by the decoder tail's conv (tail_conv.cuh), K8's phase GEMM
// (phase_gemm.cuh), the front's k5/s5 patchify (front_patchify.cuh) and the
// shifted-window probe (probes.cu).
//
// Tile layout. An operand tile holds rows of 64 bf16 (128 bytes), loaded
// by TMA with CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte-aligned buffer:
// row r sits at r * 128 bytes with its 16-byte chunks permuted by r % 8. A
// descriptor over such a tile serves both operand majors of wgmma:
//  - K-major (the 64 values of a row are the reduction dimension): q k^T,
//    dO v^T and their transposes. One k16 step is 32 bytes along the row.
//  - MN-major (the rows are the reduction dimension, the 64 values of a row
//    the output columns): the value, key, query or dO tile as the B operand of
//    P v, dS k, dS^T q and A^T dO. One k16 step is 16 rows, 2048 bytes.
// In both, 8-row groups lie 1024 bytes apart (the stride byte offset).
// A head dim of 80 adds a narrow tile of the columns 64-79 (32-byte rows,
// CU_TENSOR_MAP_SWIZZLE_32B, 8-row groups 256 bytes apart): one k16 step
// K-major, or an n16 B operand MN-major whose k16 step is 512 bytes.
//
// Host side: tensor maps over [BH, T, hd] bf16 tensors, encoded with the
// driver's cuTensorMapEncodeTiled reached through cudaGetDriverEntryPoint,
// so the library needs no -lcuda. Rows past T are filled with zeros by the
// TMA unit, and a tile never crosses into the next head.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vx {
namespace hopper {

constexpr int kHd = 64;              // head dim: one 128-byte row per tile row
constexpr int kRowBytes = kHd * 2;
constexpr int kTile64Bytes = 64 * kRowBytes;  // a 64-row tile
constexpr int kStages = 3;        // TMA ring depth
constexpr int kProducerRegs = 24;  // registers the producer warpgroup keeps
constexpr float kLog2e = 1.4426950408889634f;

// NC consumer warpgroups of 64 rows, then one producer warpgroup
template <int NC>
struct Roles {
  static constexpr int kThreads = (NC + 1) * 128;
  static constexpr int kMinBlocks = NC == 1 ? 2 : 1;
  // the register file split between NC consumer warpgroups and the producer
  static constexpr int kConsumerRegs = NC == 1 ? 232 : 240;
};

__host__ __device__ constexpr uint32_t align1024(uint32_t a) { return (a + 1023) & ~1023u; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarrier ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival that also announces `bytes` of TMA traffic for this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed. A wait that lasts
// beyond ~2^34 cycles (several seconds) can only be a broken ring: it traps,
// so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// A ring of `S` stages: stage and phase parity of the i-th use.
template <int S>
struct Ring {
  __device__ __forceinline__ static int stage(int i) { return i % S; }
  __device__ __forceinline__ static uint32_t parity(int i) { return (i / S) & 1; }
};

// -- TMA -----------------------------------------------------------------------

// rows [row, row + box rows) of head `bh` of a [BH, T, hd] map, from column
// `col` on, into `dst`
__device__ __forceinline__ void tma_load_rows(uint32_t dst, const CUtensorMap* map,
                                              uint32_t bar, int row, int bh, int col = 0) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(bh)
      : "memory");
}

// 4 bytes from global to shared memory without a register round trip,
// zero-filled where `valid` is false (then `src` is not read). The copies a
// thread issued before a commit form a group; the data may be read once
// cp_async_wait_group<N>() (at most N groups still in flight) has returned.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
// 16 bytes from global to shared memory, cached in L2 only
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory writes of this thread (st.shared, or cp.async copies it has
// waited for) made visible to the async proxy, which wgmma reads its shared
// operands through; a barrier after it publishes them to the warpgroup.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- wgmma -----------------------------------------------------------------------

// descriptor of a 128-byte-swizzled tile at shared address `addr` (1024-byte
// aligned, or advanced from such a base by whole k16 steps)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// descriptor of a 32-byte-swizzled tile of 32-byte rows (256-byte aligned)
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}
// descriptor increments (in 16-byte units) of one k16 step
constexpr uint64_t kDescKStepKMajor = 32 >> 4;
constexpr uint64_t kDescKStepMnMajor = (16 * kRowBytes) >> 4;
constexpr uint64_t kDescKStepMnMajor32 = (16 * 32) >> 4;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// all but the last committed group done
__device__ __forceinline__ void wgmma_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma operands across the
// asynchronous window (issue .. wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define VX_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define VX_F16(d, i) VX_F4(d, i), VX_F4(d, i + 4), VX_F4(d, i + 8), VX_F4(d, i + 12)

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : VX_F16(d, 0), VX_F16(d, 16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : VX_F16(d, 0), VX_F16(d, 16), VX_F16(d, 32), VX_F16(d, 48)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma_ss takes N = 64 or 128");
  if constexpr (N == 64)
    wgmma_ss_n64(d, da, db, accumulate);
  else
    wgmma_ss_n128(d, da, db, accumulate);
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A K-major and B MN-major in shared
// memory
__device__ __forceinline__ void wgmma_ss_n64_bmn(float (&d)[32], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : VX_F16(d, 0), VX_F16(d, 16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A in registers (the fragment of
// a_fragments below), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : VX_F16(d, 0), VX_F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 16] += A[64 x 16] B[16 x 16]: A in registers, B MN-major in shared
// memory (the narrow 32-byte-swizzled tile)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : VX_F4(d, 0), VX_F4(d, 4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128]: A in registers, B K-major in shared
// memory (128 rows of the reduction dimension's 64 values)
__device__ __forceinline__ void wgmma_rs_n128_kmajor(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : VX_F16(d, 0), VX_F16(d, 16), VX_F16(d, 32), VX_F16(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef VX_F16
#undef VX_F4

// four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8: the register A fragment of a 16 x 16 tile
// (matrices: rows 0-7 / 8-15 of k 0-7, then of k 8-15)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The accumulator fragment of m64nN: thread t of the warpgroup (warp w, lane
// l) holds rows 16 w + l / 4 (h = 0) and 16 w + l / 4 + 8 (h = 1), columns
// 8 j + 2 (l % 4) + e, in d[4 j + 2 h + e]. Columns 16 kk .. 16 kk + 15 of it,
// rounded to bf16, are the register A fragment of k-step kk.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void a_fragments(const float (&d)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// issue S[64 x N] = A B^T over 64 columns of the head dim (four k16 steps),
// both operands K-major tiles, or S += A B^T with `accumulate` (the second
// 64-column box of a 128-wide head); the caller commits and waits
template <int N>
__device__ __forceinline__ void gemm_nt(float (&d)[N / 2], uint32_t a_tile, uint32_t b_tile,
                                        bool accumulate = false) {
  const uint64_t da = desc_sw128(a_tile), db = desc_sw128(b_tile);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk)
    wgmma_ss<N>(d, da + kk * kDescKStepKMajor, db + kk * kDescKStepKMajor,
                kk > 0 || accumulate);
}

// issue acc[64 x 64] += P[64 x N] B[N x 64]: P as register fragments, B an
// MN-major tile of N rows; the caller fences before and commits and waits
template <int N>
__device__ __forceinline__ void gemm_rs(float (&acc)[32], const uint32_t (&a)[N / 16][4],
                                        uint32_t b_tile) {
  const uint64_t db = desc_sw128(b_tile);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) wgmma_rs_n64(acc, a[kk], db + kk * kDescKStepMnMajor);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// -inf into the logits of columns >= Tk (c0: this thread's first column)
template <int N>
__device__ __forceinline__ void mask_columns(float (&acc)[N], int c0, int Tk) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (c0 + 8 * j + e >= Tk) acc[4 * j + e] = acc[4 * j + 2 + e] = -INFINITY;
}

// this thread's part of a 64 x (2 N) accumulator tile (rows `row` and
// `row + 8` of the fragment layout), rounded to bf16 into rows of stride `ld`
// values; rows >= rows_valid are not written
template <int N>
__device__ __forceinline__ void store_rows_bf16(const float (&acc)[N], __nv_bfloat16* dst,
                                                int row, int rows_valid, int qd, int ld) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= rows_valid) continue;
    __nv_bfloat16* p = dst + (size_t)(row + 8 * h) * ld + 2 * qd;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) =
          pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// 2^x on the special-function unit (relative error below 2^-22; results
// below 2^-126 flush to zero, 2^-inf is 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- warp specialisation ----------------------------------------------------------

// Two consumer warpgroups taking turns at issuing their products (named
// barriers 1 and 2, 256 threads): warpgroup w waits at barrier 1 + w until the
// other has issued, so that one's element-wise work overlaps the other's
// products instead of both contending for the same pipes at once. Every
// warpgroup takes the same number of turns; `start` lets warpgroup 0 go first
// and the last hand-over of warpgroup 1 is left out, so both barriers end
// balanced. With one consumer warpgroup (`on` false) all of it is a no-op.
struct PingPong {
  bool on;
  int wg;
  __device__ __forceinline__ static void sync(int id) {
    asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
  }
  __device__ __forceinline__ static void arrive(int id) {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
  }
  __device__ __forceinline__ void start() const {
    if (on && wg == 1) arrive(1);
  }
  __device__ __forceinline__ void take_turn() const {
    if (on) sync(1 + wg);
  }
  __device__ __forceinline__ void hand_over(bool last_turn) const {
    if (on && !(wg == 1 && last_turn)) arrive(2 - wg);
  }
};

// -- clusters ----------------------------------------------------------------------

// split-phase barrier of every thread of the cluster; the release/acquire pair
// orders shared-memory writes before it with reads of them (by any CTA of the
// cluster) after it
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
// the address of this CTA's shared `addr` in the CTA of rank `rank`
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float2 ld_cluster_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ float4 ld_cluster_f32x4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// -- host ------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline cudaError_t encode_fn(EncodeTiledFn* out) {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !p) return cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// A map over a contiguous [BH, T, hd] bf16 tensor (16-byte aligned) whose
// box is `box_rows` rows of one head by `box_cols` columns: 64 (128-byte
// swizzled) or 16 (32-byte swizzled); zero past T.
inline cudaError_t rows_map(CUtensorMap* map, const void* ptr, int BH, int T, int box_rows,
                            int hd = kHd, int box_cols = kHd) {
  EncodeTiledFn fn;
  cudaError_t err = encode_fn(&fn);
  if (err != cudaSuccess) return err;
  cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)T, (cuuint64_t)BH};
  cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)T * hd * 2};
  cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                  strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  box_cols == kHd ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
}  // namespace vx
