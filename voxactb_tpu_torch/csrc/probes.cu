// The three TPU measurement probes of tools/, as Hopper (sm_90a) kernels.
//
// Replaces:
//  - tools/profile_stages.py::grid_copy (kernel `copy_rows_kernel`): o = x for
//    a [B, N, H, W, C] grid, streamed through on-chip memory in slabs of
//    `rows` rows (grid (B, N / rows)). The stage profile's copy floor.
//  - tools/probe_vmem.py::probe_scratch: row 0 of x [8, 128] f32 through a
//    scratch of a given size into row 0 of the output; whether that launches.
//  - tools/probe_vmem.py::probe_shifted_einsum: the 3 x 3 (9-tap) shifted-
//    window matmul, sum over taps (dy, dx) of x[dy:dy+H, dx:dx+W, :] @ w[tap]
//    with f32 accumulation, x [H+2, W+2, 128] bf16, w [9, 128, 64] bf16.
//
// What bounds each on an H100:
//  - grid_copy: bytes. d0 at 100^3 (128 MB) is read and written once, 256 MB
//    at 3.35 TB/s, 0.076 ms; larger than the 50 MB L2.
//  - smem_scratch: a launch; it moves 1 KB.
//  - shifted_window: at H = W = 100, 1.47 GFLOP (0.0015 ms at 989 TFLOP/s)
//    and 5.4 MB (0.0016 ms), all of which fit in the L2; launch-bound.
//
// Designs (simple first):
//  - grid_copy: a slab is split into chunks of kChunkBytes, and the chunks of
//    a slab over `ctas_per_slab` CTAs, so that a batch-1 grid (100 or 25
//    slabs) still fills every SM. One thread of a CTA streams its chunks
//    through a ring of kCopyStages shared-memory buffers with the bulk copy
//    unit: a load (cp.async.bulk, completing on the stage's mbarrier) and a
//    store (cp.async.bulk ... bulk_group) per chunk, kCopyStages - 1 loads in
//    flight. No register touches the data, so the copy is bit for bit.
//  - smem_scratch: 128 threads, a dynamic shared-memory scratch of `nbytes`.
//    The entry point raises the kernel's dynamic shared-memory limit to
//    `nbytes` and launches; past the card's opt-in limit the first step fails
//    with cudaErrorInvalidValue. The kernel has no static shared memory, so
//    the limit it finds is exactly cudaDevAttrMaxSharedMemoryPerBlockOptin.
//  - shifted_window: an implicit GEMM, M = H * W output pixels, N = 64, K =
//    9 taps x 128. A CTA of four warps computes an 8 x 8 pixel tile: it
//    stages the tile's 10 x 10 x 128 halo by cp.async (rows padded to 136
//    values, so the 8 rows of an ldmatrix hit 8 bank groups), and the taps'
//    [128, 64] weights one at a time in two buffers, the next tap loading
//    while this one multiplies. Warp w takes pixel rows 2w, 2w + 1 (16 A
//    rows) over all 64 columns: per tap 8 k16 steps of mma.sync m16n8k16 on
//    ldmatrix fragments (B through ldmatrix.trans from the row-major
//    weights). Sums run in f32 in another order than the plain version.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using vx::bf16;
using namespace vx::hopper;

// -- grid_copy -------------------------------------------------------------

constexpr int kChunkBytes = 16384;  // one bulk copy
constexpr int kCopyStages = 4;      // ring of chunks in shared memory
constexpr int kCopyCtasPerSm = 3;   // 3 x 64 KB of the SM's 227 KB

__device__ __forceinline__ void bulk_load(uint32_t dst, const char* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(char* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the shared memory of all but the N most recent store groups has been read
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// CTA i copies chunks [part * chunks_per_cta, ...) of slab i / ctas_per_slab,
// part = i % ctas_per_slab; chunks are kChunkBytes but a slab's last.
__global__ void __launch_bounds__(32, kCopyCtasPerSm)
    probe_grid_copy(const char* __restrict__ x, char* __restrict__ out, long long slab_bytes,
                    int ctas_per_slab, int chunks_per_cta) {
  extern __shared__ __align__(128) char smem[];  // kCopyStages chunks, then the barriers
  if (threadIdx.x != 0) return;
  const long long slab = blockIdx.x / ctas_per_slab;
  const long long first = (long long)(blockIdx.x % ctas_per_slab) * chunks_per_cta;
  const long long left = slab_bytes - first * kChunkBytes;  // from this CTA's first chunk on
  if (left <= 0) return;
  const long long chunks_left = (left + kChunkBytes - 1) / kChunkBytes;
  const int n = chunks_left < chunks_per_cta ? (int)chunks_left : chunks_per_cta;
  const char* src = x + slab * slab_bytes + first * kChunkBytes;
  char* dst = out + slab * slab_bytes + first * kChunkBytes;

  const uint32_t buf = smem_u32(smem);
  const uint32_t bars = buf + kCopyStages * kChunkBytes;
  for (int s = 0; s < kCopyStages; ++s) mbar_init(bars + 8 * s, 1);
  mbar_fence_init();
  auto bytes_of = [&](int i) -> uint32_t {
    const long long rest = left - (long long)i * kChunkBytes;
    return rest < kChunkBytes ? (uint32_t)rest : (uint32_t)kChunkBytes;
  };
  auto load = [&](int i) {
    const int s = i % kCopyStages;
    const uint32_t bytes = bytes_of(i);
    mbar_arrive_expect_tx(bars + 8 * s, bytes);
    bulk_load(buf + s * kChunkBytes, src + (long long)i * kChunkBytes, bytes, bars + 8 * s);
  };
  for (int i = 0; i < kCopyStages - 1 && i < n; ++i) load(i);
  for (int i = 0; i < n; ++i) {
    const int s = i % kCopyStages;
    mbar_wait(bars + 8 * s, (i / kCopyStages) & 1);
    fence_proxy_async();
    bulk_store(dst + (long long)i * kChunkBytes, buf + s * kChunkBytes, bytes_of(i));
    bulk_commit();
    // chunk i + kCopyStages - 1 reuses the stage of chunk i - 1, whose store
    // is the second most recent group
    const int j = i + kCopyStages - 1;
    if (j < n) {
      bulk_wait_read<1>();
      load(j);
    }
  }
  bulk_wait_all();
}

// -- smem_scratch ------------------------------------------------------------

constexpr int kScratchCols = 128;  // one row of x: 128 f32

__global__ void __launch_bounds__(kScratchCols) probe_smem_scratch(const float* __restrict__ x,
                                                                    float* __restrict__ out) {
  extern __shared__ float scratch[];
  const int c = threadIdx.x;
  scratch[c] = x[c];
  __syncthreads();
  out[c] = scratch[c];
}

// -- shifted_window ----------------------------------------------------------

constexpr int kSwC = 128;                      // input channels (K per tap)
constexpr int kSwN = 64;                       // output channels
constexpr int kSwTaps = 9;                     // (dy, dx) in row-major order
constexpr int kSwTile = 8;                     // output tile: 8 x 8 pixels
constexpr int kSwHalo = kSwTile + 2;           // 10 x 10 halo pixels
constexpr int kSwThreads = 128;                // four warps, two pixel rows each
constexpr int kHaloStride = kSwC + 8;          // bf16 per halo pixel (272 B)
constexpr int kWStride = kSwN + 8;             // bf16 per weight row (144 B)
constexpr int kHaloBytes = kSwHalo * kSwHalo * kHaloStride * 2;
constexpr int kWBytes = kSwC * kWStride * 2;
constexpr int kSwSmemBytes = kHaloBytes + 2 * kWBytes;

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// tap t's [128, 64] weights into a buffer of rows kWStride apart
__device__ __forceinline__ void load_tap(uint32_t wbuf, const bf16* __restrict__ w, int t) {
  const bf16* src = w + (size_t)t * kSwC * kSwN;
  for (int i = threadIdx.x; i < kSwC * (kSwN / 8); i += kSwThreads) {
    const int k = i / (kSwN / 8), q = i % (kSwN / 8);
    cp_async_16(wbuf + (k * kWStride + q * 8) * 2, src + k * kSwN + q * 8);
  }
}

__global__ void __launch_bounds__(kSwThreads) probe_shifted_window(const bf16* __restrict__ x,
                                                                   const bf16* __restrict__ w,
                                                                   float* __restrict__ out,
                                                                   int H, int W) {
  extern __shared__ __align__(128) char smem[];
  const uint32_t halo = smem_u32(smem);
  const uint32_t wbufs[2] = {halo + kHaloBytes, halo + kHaloBytes + kWBytes};
  const int y0 = blockIdx.y * kSwTile, x0 = blockIdx.x * kSwTile;
  const int Wp = W + 2, Hp = H + 2;

  // the halo, its rows and columns clamped to x (pixels past the edge only
  // feed outputs that are not stored)
  for (int i = threadIdx.x; i < kSwHalo * kSwHalo * (kSwC / 8); i += kSwThreads) {
    const int p = i / (kSwC / 8), q = i % (kSwC / 8);
    const int sy = min(y0 + p / kSwHalo, Hp - 1), sx = min(x0 + p % kSwHalo, Wp - 1);
    cp_async_16(halo + (p * kHaloStride + q * 8) * 2, x + ((size_t)sy * Wp + sx) * kSwC + q * 8);
  }
  load_tap(wbufs[0], w, 0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // ldmatrix row of this lane: A row r = pixel (2 warp + r / 8, r % 8), its
  // k offset 0 or 8; B (weights) row k = lane % 16, column offset 0 or 8
  const int ar = (lane % 8) + 8 * ((lane / 8) % 2), ak = 8 * (lane / 16);
  const int apy = 2 * warp + ar / 8, apx = ar % 8;
  float acc[kSwN / 8][4];
#pragma unroll
  for (int j = 0; j < kSwN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < kSwTaps; ++t) {
    if (t + 1 < kSwTaps) {
      load_tap(wbufs[(t + 1) & 1], w, t + 1);
      cp_async_commit();
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();
    const int dy = t / 3, dx = t % 3;
    const uint32_t arow = halo + (((apy + dy) * kSwHalo + apx + dx) * kHaloStride + ak) * 2;
    const uint32_t brow = wbufs[t & 1] + ((lane % 16) * kWStride + 8 * (lane / 16)) * 2;
#pragma unroll
    for (int kk = 0; kk < kSwC / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, arow + kk * 32);
#pragma unroll
      for (int jj = 0; jj < kSwN / 16; ++jj) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, brow + (kk * 16 * kWStride + jj * 16) * 2);
        mma_bf16_16816(acc[2 * jj], a, b[0], b[1]);
        mma_bf16_16816(acc[2 * jj + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  // accumulator rows lane / 4 (pixel row 2 warp) and lane / 4 + 8 (2 warp + 1),
  // columns 8 j + 2 (lane % 4) + {0, 1}
  const int ox = x0 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int oy = y0 + 2 * warp + h;
    if (oy >= H || ox >= W) continue;
    float* dst = out + ((size_t)oy * W + ox) * kSwN + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < kSwN / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

}  // namespace

VX_EXPORT_ERROR_STRING(voxactb_probes_error_string)

// x, out: `n_slabs` slabs of `slab_bytes` (a multiple of 16, 16-byte aligned)
extern "C" int voxactb_grid_copy(const void* x, void* out, long long slab_bytes, int n_slabs,
                                 int ctas_per_slab, int chunks_per_cta, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int smem = kCopyStages * kChunkBytes + 8 * kCopyStages;
  VX_CHECK(cudaFuncSetAttribute(probe_grid_copy, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem));
  probe_grid_copy<<<n_slabs * ctas_per_slab, 32, smem, stream>>>(
      static_cast<const char*>(x), static_cast<char*>(out), slab_bytes, ctas_per_slab,
      chunks_per_cta);
  return (int)cudaGetLastError();
}

// Row 0 of x [8, 128] f32 through a dynamic shared-memory scratch of `nbytes`
// into row 0 of out. Returns the error of raising the kernel's limit to
// `nbytes` or of the launch (cudaErrorInvalidValue past the card's opt-in
// limit), after clearing it: it is not sticky, and the next launch's check
// must not see it.
extern "C" int voxactb_smem_scratch(const float* x, float* out, int nbytes, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaFuncSetAttribute(probe_smem_scratch,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, nbytes);
  if (err == cudaSuccess) {
    probe_smem_scratch<<<1, kScratchCols, nbytes, stream>>>(x, out);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) (void)cudaGetLastError();
  return (int)err;
}

// The card's shared memory per block with the opt-in (the ceiling the scratch
// probe should find), or -1 when the query fails
extern "C" int voxactb_smem_optin(int device) {
  int v = -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) {
    (void)cudaGetLastError();
    return -1;
  }
  return v;
}

// x [H+2, W+2, 128] bf16, w [9, 128, 64] bf16 -> out [H, W, 64] f32
extern "C" int voxactb_shifted_window(const void* x, const void* w, float* out, int H, int W,
                                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  VX_CHECK(cudaFuncSetAttribute(probe_shifted_window,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kSwSmemBytes));
  dim3 grid((W + kSwTile - 1) / kSwTile, (H + kSwTile - 1) / kSwTile);
  probe_shifted_window<<<grid, kSwThreads, kSwSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), out, H, W);
  return (int)cudaGetLastError();
}
