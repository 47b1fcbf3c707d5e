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
//  - smem_scratch: a launch; it moves 1 KB. probe_empty, the same launch
//    with no work, is its floor.
//  - shifted_window: at H = W = 100, 1.47 GFLOP (0.0015 ms at 989 TFLOP/s)
//    and 5.4 MB (0.0016 ms), all of which fit in the L2, so neither is a
//    floor: what a CTA waits for is its weights' and halo's trip from the L2
//    and its share of the products.
//
// Designs:
//  - grid_copy: persistent CTAs, kCopyCtasPerSm per SM in one wave, over
//    interleaved chunks. A slab is cut into chunks_per_slab chunks of
//    chunk_bytes (at most kChunkBytes, a multiple of 16; a slab's last chunk
//    may be shorter), numbered slab after slab, and CTA c copies chunks c,
//    c + stride, c + 2 stride, ... So the chunks in flight across the card
//    are neighbours, one window advancing through the tensor as a memcpy's
//    accesses do, and a chunk never crosses a slab: `n_slabs` bounds the
//    bytes copied. One thread of a CTA streams its chunks through a ring of
//    kCopyStages shared-memory buffers with the bulk copy unit: a load
//    (cp.async.bulk, completing on the stage's mbarrier) and a store
//    (cp.async.bulk ... bulk_group) per chunk, kCopyAhead loads in flight,
//    and a stage reloaded once the store kCopyStages - kCopyAhead groups back
//    has read it. No register touches the data, so the copy is bit for bit.
//  - smem_scratch: 128 threads, a dynamic shared-memory scratch of `nbytes`.
//    The entry point raises the kernel's dynamic shared-memory limit to
//    `nbytes` and launches; past the card's opt-in limit the first step fails
//    with cudaErrorInvalidValue. The kernel has no static shared memory, so
//    the limit it finds is exactly cudaDevAttrMaxSharedMemoryPerBlockOptin.
//  - shifted_window: an implicit GEMM on wgmma, M = H * W output pixels, N =
//    64, K = 9 taps x 128. A CTA computes a band of kSwConsumers x kSwTile =
//    16 rows by kSwTile = 8 columns of pixels, one 8 x 8 tile (64 rows of
//    m64n64k16) per consumer warpgroup, so that the two tiles share every
//    weight tile: at 100 x 100 that is 13 x 7 = 91 CTAs, one per SM in one
//    wave. At the start thread 0 asks the TMA unit for all nine taps'
//    [128, 64] weights (MN-major, 128-byte swizzled, one mbarrier per tap),
//    so the nine loads are in flight at once instead of one after another,
//    while the 256 threads stage the band's 18 x 10 x 128 halo by cp.async
//    (rows and columns clamped to x; pixels past the edge only feed outputs
//    that are not stored; pixel rows padded to 136 values, so the 8 rows of
//    an ldmatrix hit 8 bank groups). Per tap a warpgroup gathers its A
//    fragments by ldmatrix from the halo shifted by (dy, dx), waits for the
//    tap's weights and issues 8 k16 steps of wgmma with A in registers; the
//    next tap's gathers overlap them (two fragment buffers). The epilogue
//    stores f32 pairs from the accumulator. Each output sums its taps in
//    row-major order, k ascending within a tap: no split, no atomics, two
//    launches give the same bits.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using vx::bf16;
using namespace vx::hopper;

// -- grid_copy -------------------------------------------------------------

constexpr int kChunkBytes = 16384;  // the largest chunk: one stage, one bulk copy
constexpr int kCopyStages = 12;     // ring of chunks in shared memory
constexpr int kCopyAhead = 8;       // loads in flight
constexpr int kCopyCtasPerSm = 1;   // 12 x 16 KB of the SM's 227 KB
constexpr int kCopySmemBytes = kCopyStages * kChunkBytes + 8 * kCopyStages;  // + barriers
static_assert(kCopyAhead >= 1 && kCopyAhead < kCopyStages, "loads ahead within the ring");

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

// CTA c copies chunks c, c + stride, ... of the n_chunks; chunk i is chunk
// i % chunks_per_slab of slab i / chunks_per_slab.
__global__ void __launch_bounds__(32, kCopyCtasPerSm)
    probe_grid_copy(const char* __restrict__ x, char* __restrict__ out, long long slab_bytes,
                    int chunk_bytes, int chunks_per_slab, long long n_chunks, int stride) {
  extern __shared__ __align__(128) char smem[];  // kCopyStages chunks, then the barriers
  if (threadIdx.x != 0 || blockIdx.x >= n_chunks) return;
  const int n = (int)((n_chunks - 1 - blockIdx.x) / stride + 1);  // this CTA's chunks

  const uint32_t buf = smem_u32(smem);
  const uint32_t bars = buf + kCopyStages * kChunkBytes;
  for (int s = 0; s < kCopyStages; ++s) mbar_init(bars + 8 * s, 1);
  mbar_fence_init();
  // byte offset and size of this CTA's k-th chunk
  auto chunk = [&](int k, long long& off) -> uint32_t {
    const long long i = blockIdx.x + (long long)k * stride;
    const long long in = (i % chunks_per_slab) * chunk_bytes;
    off = i / chunks_per_slab * slab_bytes + in;
    const long long rest = slab_bytes - in;
    return rest < chunk_bytes ? (uint32_t)rest : (uint32_t)chunk_bytes;
  };
  auto load = [&](int k) {
    const int s = k % kCopyStages;
    long long off;
    const uint32_t bytes = chunk(k, off);
    mbar_arrive_expect_tx(bars + 8 * s, bytes);
    bulk_load(buf + s * kChunkBytes, x + off, bytes, bars + 8 * s);
  };
  for (int k = 0; k < kCopyAhead && k < n; ++k) load(k);
  for (int k = 0; k < n; ++k) {
    const int s = k % kCopyStages;
    long long off;
    const uint32_t bytes = chunk(k, off);
    mbar_wait(bars + 8 * s, (k / kCopyStages) & 1);
    bulk_store(out + off, buf + s * kChunkBytes, bytes);
    bulk_commit();
    // chunk k + kCopyAhead reuses the stage of chunk k + kCopyAhead -
    // kCopyStages, whose store is kCopyStages - kCopyAhead groups back
    if (k + kCopyAhead < n) {
      bulk_wait_read<kCopyStages - kCopyAhead>();
      load(k + kCopyAhead);
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

// The same launch with nothing in it: the floor of a 128-thread launch, which
// smem_scratch's device time is held against.
__global__ void __launch_bounds__(kScratchCols) probe_empty() {}

// -- shifted_window ----------------------------------------------------------

constexpr int kSwC = 128;                      // input channels (K per tap)
constexpr int kSwN = 64;                       // output channels
constexpr int kSwTaps = 9;                     // (dy, dx) in row-major order
constexpr int kSwTile = 8;                     // a warpgroup's tile: 8 x 8 pixels
constexpr int kSwConsumers = 2;                // warpgroups (tiles) of a CTA, stacked in y
constexpr int kSwBand = kSwConsumers * kSwTile;  // a CTA's 16 output rows
constexpr int kSwHaloRows = kSwBand + 2, kSwHaloCols = kSwTile + 2;  // 18 x 10
constexpr int kSwThreads = kSwConsumers * 128;
constexpr int kHaloStride = kSwC + 8;          // bf16 per halo pixel (272 B)
constexpr int kTapBytes = kSwC * kSwN * 2;     // one tap's weights (1024-aligned)
constexpr int kHaloOff = kSwTaps * kTapBytes;
constexpr int kHaloBytes = kSwHaloRows * kSwHaloCols * kHaloStride * 2;
constexpr int kSwBarOff = kHaloOff + kHaloBytes;
constexpr int kSwSmemBytes = kSwBarOff + 8 * kSwTaps + 1024;  // + alignment of the base
static_assert(kSwSmemBytes <= 232448, "shared memory of one CTA");

// wg_row_offset: the halo row at which warpgroup g's tile gathers its A
// rows, g * wg_row_offset (kSwTile; anything else is a planted fault: the
// tile stored at rows 8 g reads another tile's pixels)
__global__ void __launch_bounds__(kSwThreads, 1)
    probe_shifted_window(const __grid_constant__ CUtensorMap tm_w, const bf16* __restrict__ x,
                         float* __restrict__ out, int H, int W, int wg_row_offset) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = align1024(smem_u32(smem_raw));
  const uint32_t halo = base + kHaloOff;
  const auto full = [&](int t) { return base + kSwBarOff + 8 * t; };
  const int y0 = blockIdx.y * kSwBand, x0 = blockIdx.x * kSwTile;
  const int Wp = W + 2, Hp = H + 2;

  if (threadIdx.x == 0) {
    for (int t = 0; t < kSwTaps; ++t) mbar_init(full(t), 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int t = 0; t < kSwTaps; ++t) {
      mbar_arrive_expect_tx(full(t), kTapBytes);
      tma_load_rows(base + t * kTapBytes, &tm_w, full(t), t * kSwC, 0);
    }
  for (int i = threadIdx.x; i < kSwHaloRows * kSwHaloCols * (kSwC / 8); i += kSwThreads) {
    const int p = i / (kSwC / 8), q = i % (kSwC / 8);
    const int sy = min(y0 + p / kSwHaloCols, Hp - 1), sx = min(x0 + p % kSwHaloCols, Wp - 1);
    cp_async_16(halo + (p * kHaloStride + q * 8) * 2, x + ((size_t)sy * Wp + sx) * kSwC + q * 8);
  }
  cp_async_commit();
  cp_async_wait_group<0>();
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  // ldmatrix.x4 row of this lane: A row r = 16 warp + lane % 8 + 8 ((lane / 8) % 2)
  // is the tile's pixel (r / 8, r % 8); its k chunk 8 (lane / 16) of each k16 step
  const int apy = wg * wg_row_offset + 2 * warp + (lane >> 3 & 1), apx = lane & 7;
  const uint32_t arow = halo + ((apy * kSwHaloCols + apx) * kHaloStride + 8 * (lane >> 4)) * 2;
  float acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.f;
  uint32_t a[2][kSwC / 16][4];  // [tap parity][k16 step][fragment]

#pragma unroll
  for (int t = 0; t < kSwTaps; ++t) {
    const int dy = t / 3, dx = t % 3;
    const uint32_t at = arow + ((dy * kSwHaloCols + dx) * kHaloStride) * 2;
#pragma unroll
    for (int kk = 0; kk < kSwC / 16; ++kk) ldmatrix_x4(a[t & 1][kk], at + kk * 32);
    mbar_wait(full(t), 0);
    wgmma_fence();
    gemm_rs<kSwC>(acc, a[t & 1], base + t * kTapBytes);
    wgmma_commit();
    // tap t - 1's products are done: its fragment buffer may be loaded again
    wgmma_wait_1();
    fence_regs(a[(t + 1) & 1]);
  }
  wgmma_wait_all();
  fence_regs(acc);
  fence_regs(a[(kSwTaps - 1) & 1]);

  // accumulator rows 16 warp + lane / 4 (h = 0) and + 8 (h = 1): tile pixel
  // (2 warp + h, lane / 4); columns 8 j + 2 (lane % 4) + {0, 1}
  const int ox = x0 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int oy = y0 + wg * kSwTile + 2 * warp + h;
    if (oy >= H || ox >= W) continue;
    float* dst = out + ((size_t)oy * W + ox) * kSwN + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < kSwN / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

}  // namespace

VX_EXPORT_ERROR_STRING(voxactb_probes_error_string)

// Raises the copy kernel's dynamic shared-memory limit on the current device
// to what voxactb_grid_copy launches it with; called once per device before
// the first copy.
extern "C" int voxactb_grid_copy_prepare() {
  return (int)cudaFuncSetAttribute(probe_grid_copy, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kCopySmemBytes);
}

// x, out: n_slabs slabs of slab_bytes (a multiple of 16, 16-byte aligned),
// each cut into chunks_per_slab chunks of chunk_bytes (at most kChunkBytes,
// a multiple of 16); chunks are dealt to CTAs `stride` apart, and `grid`
// CTAs launched (stride; fewer leaves the last CTAs' chunks uncopied)
extern "C" int voxactb_grid_copy(const void* x, void* out, long long slab_bytes, int n_slabs,
                                 int chunk_bytes, int chunks_per_slab, int stride, int grid,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (chunk_bytes <= 0 || chunk_bytes > kChunkBytes || chunk_bytes % 16 || grid <= 0 ||
      grid > stride)
    return (int)cudaErrorInvalidValue;
  probe_grid_copy<<<grid, 32, kCopySmemBytes, stream>>>(static_cast<const char*>(x),
                                              static_cast<char*>(out), slab_bytes, chunk_bytes,
                                              chunks_per_slab,
                                              (long long)n_slabs * chunks_per_slab, stride);
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

// One empty 128-thread launch (probe_empty).
extern "C" int voxactb_empty_launch(void* stream_ptr) {
  probe_empty<<<1, kScratchCols, 0, static_cast<cudaStream_t>(stream_ptr)>>>();
  return (int)cudaGetLastError();
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

// x [H+2, W+2, 128] bf16, w [9, 128, 64] bf16 (both 16-byte aligned) ->
// out [H, W, 64] f32; wg_row_offset is kSwTile but in a planted fault (at
// most kSwTile, so that every gather stays in the halo)
extern "C" int voxactb_shifted_window(const void* x, const void* w, float* out, int H, int W,
                                      int wg_row_offset, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (H < 1 || W < 1 || wg_row_offset < 0 || wg_row_offset > kSwTile)
    return (int)cudaErrorInvalidValue;
  VX_CHECK(cudaFuncSetAttribute(probe_shifted_window,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kSwSmemBytes));
  CUtensorMap tm_w;  // w as [1, 9 x 128, 64]: one box per tap
  VX_CHECK(rows_map(&tm_w, w, 1, kSwTaps * kSwC, kSwC));
  const dim3 grid((W + kSwTile - 1) / kSwTile, (H + kSwBand - 1) / kSwBand);
  probe_shifted_window<<<grid, kSwThreads, kSwSmemBytes, stream>>>(
      tm_w, static_cast<const bf16*>(x), out, H, W, wg_row_offset);
  return (int)cudaGetLastError();
}
