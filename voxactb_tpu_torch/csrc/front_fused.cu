// Fused act-program front for Hopper (sm_90a): voxel scatter-mean + 1x1x1
// preprocess conv + soft-argmax stats + k5/s5 patchify.
//
// Replaces voxactb_tpu/ops/pallas/front_fused.py::front_fused (TPU kernel
// `_kernel` / `_scatter_rest` with the host pre-pass `sort_points_by_row`).
//
// What bounds it on an H100: memory. At N = 100, B = 1 it must write d0
// (128 MB bf16) and read 0.8 MB of points; the 1x1 conv is 1.3 GFLOP and the
// patchify 8.2 GFLOP, far below the tensor cores' rate for those bytes.
//
// Design (the launches in order):
//   1. ff_scatter  - one thread per point bins it exactly as the XLA voxelize
//                    does and atomically adds (xyz, rgb, 1) into an
//                    [B, N^3, 8] f32 accumulator. Unlike the TPU kernel, no
//                    point is dropped (no row capacity): overflow is always 0.
//                    Atomics sum in a run-dependent order, so the mean can
//                    differ from the plain version in the last f32 bits and
//                    d0 by one bf16 ulp.
//   2. ff_voxel    - the voxel pass (voxel_pass.cuh) with the 10-channel grid
//                    row (mean, index / N, occupancy) built from the
//                    accumulator: d0 = lrelu(bf16(row . W1 + b1)), written as
//                    16-byte vectors, and one soft-argmax partial per
//                    persistent CTA.
//   3. stats_combine (common.cuh) - merge the partials into kp / gmax.
//   4. patchify_gemm + patchify_reduce (front_patchify.cuh) - the patchify
//                    over d0 with front edge padding 2 (the back padding is
//                    never read), f32 pre-activation out; the caller adds
//                    bias + lrelu. Also exported alone as
//                    voxactb_front_patchify, the dense path's patchify.

#include "front_patchify.cuh"
#include "voxel_pass.cuh"

namespace {

using vx::bf16;

constexpr int kC = vx::kPreC;

__global__ void ff_scatter(const float* __restrict__ coords,
                           const float* __restrict__ feats,
                           const float* __restrict__ bounds, int bounds_per_sample,
                           int P, int N, float* __restrict__ acc) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float inv_n = 1.f / (float)N;
  const float* bd = bounds + (bounds_per_sample ? b * 6 : 0);
  const float* pt = coords + ((size_t)b * P + p) * 3;
  int idx[3];
  bool interior = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    // the f32 sequence of ops/voxelize.py as XLA compiles it: res = range *
    // f32(1 / N) (a division by a constant becomes a multiplication by its
    // reciprocal), floor((p - (min - res)) / (res + 1e-12)), clip to [0, N + 1]
    float mn = bd[a];
    float range = bd[3 + a] - mn;
    float res = range * inv_n;
    float denom = res + 1e-12f;
    float f = floorf((pt[a] - (mn - res)) / denom);
    f = fminf(fmaxf(f, 0.f), (float)(N + 1));
    idx[a] = (int)f;
    interior = interior && idx[a] >= 1 && idx[a] <= N;
  }
  if (!interior) return;  // the cropped border, as the reference's +2 crop
  size_t v = (((size_t)(idx[0] - 1) * N + (idx[1] - 1)) * N + (idx[2] - 1));
  float* dst = acc + ((size_t)b * N * N * N + v) * 8;
  const float* ft = feats + ((size_t)b * P + p) * 3;
  atomicAdd(dst + 0, pt[0]);
  atomicAdd(dst + 1, pt[1]);
  atomicAdd(dst + 2, pt[2]);
  atomicAdd(dst + 3, ft[0]);
  atomicAdd(dst + 4, ft[1]);
  atomicAdd(dst + 5, ft[2]);
  atomicAdd(dst + 6, 1.f);
}

// K1's row source: the grid row of voxel v0 + t from the scatter
// accumulator (mean, index / N, occupancy), rounded to bf16; threads 0-63
// fetch the accumulator rows
struct AccRows {
  const float* acc;
  long long n3;
  int N;
  float4 lo, hi;  // the accumulator row: xyz sums, rgb sums, count, 0

  __device__ __forceinline__ void fetch(int b, long long v0) {
    const long long v = v0 + threadIdx.x;
    if (threadIdx.x >= vx::voxel::kTile || v >= n3) return;
    const float4* a = reinterpret_cast<const float4*>(acc + ((size_t)b * n3 + v) * 8);
    lo = a[0];
    hi = a[1];
  }

  // threads 0-63 put voxel t's means and occupancy (from the row they
  // fetched), threads 64-127 its index / N values, the grid row's channels
  // 0-5, 9 and 6-8, each rounded to bf16
  __device__ __forceinline__ void put(float (*rows)[vx::voxel::kRow], long long v0) {
    const int t = threadIdx.x % vx::voxel::kTile;
    const long long v = v0 + t;
    if (threadIdx.x < vx::voxel::kTile) {
      float r[6], occupied = 0.f;
      if (v < n3) {
        // the mean, sum / max(count, 1): the sum itself where count <= 1
        // (most voxels), so only voxels of two or more points divide
        const float count = hi.z;
        if (count > 1.f) {
          r[0] = lo.x / count;
          r[1] = lo.y / count;
          r[2] = lo.z / count;
          r[3] = lo.w / count;
          r[4] = hi.x / count;
          r[5] = hi.y / count;
        } else {
          r[0] = lo.x;
          r[1] = lo.y;
          r[2] = lo.z;
          r[3] = lo.w;
          r[4] = hi.x;
          r[5] = hi.y;
        }
        occupied = count > 0.f ? 1.f : 0.f;
      } else {
#pragma unroll
        for (int k = 0; k < 6; ++k) r[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) rows[t][k] = vx::voxel::bf16_round(r[k]);
      rows[t][9] = occupied;
    } else {
      float r[3] = {0.f, 0.f, 0.f};
      if (v < n3) {
        const unsigned u = (unsigned)v;
        const float inv_n = 1.f / (float)N;  // index / N, as XLA compiles it
        r[0] = (float)(u / ((unsigned)N * N)) * inv_n;
        r[1] = (float)(u / N % N) * inv_n;
        r[2] = (float)(u % N) * inv_n;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) rows[t][6 + k] = vx::voxel::bf16_round(r[k]);
    }
  }
};

__global__ void __launch_bounds__(vx::voxel::kThreads, vx::voxel::kCtasPerSm)
ff_voxel(const float* __restrict__ acc, const bf16* __restrict__ w1,
         const float* __restrict__ b1, const float* __restrict__ lin, int N, int G,
         bf16* __restrict__ d0, float* __restrict__ part) {
  __shared__ __align__(16) vx::voxel::Smem sh;
  AccRows src;
  src.acc = acc;
  src.n3 = (long long)N * N * N;
  src.N = N;
  vx::voxel::voxel_pass(src, sh, w1, b1, lin, N, G, d0, part);
}

}  // namespace

VX_EXPORT_ERROR_STRING(voxactb_front_fused_error_string)

// coords, feats [B, P, 3] f32; bounds [B or 1, 6] f32; w1 [10, 64] bf16;
// b1 [64] f32; wp [125, 64, 64] bf16 (tap-major kz, ky, kx; ci; co; 16-byte
// aligned); lin [N] f32 (linspace(-1, 1, N)). G: voxel-pass CTAs per sample,
// Gp: patchify CTAs (ops/cuda: voxel_pass_grid, patchify_grid).
// Scratch: acc [B, N^3, 8] f32 (zeroed here), part [B, G, 5, 64] f32,
// ppart [Gp, 2, 128, 64] f32.
// Outputs: d0 [B, N, N, N, 64] bf16, patch [B, N/5, N/5, N/5, 64] f32,
// kp [B, 192] f32, gmax [B, 64] f32. Returns a cudaError_t.
extern "C" int voxactb_front_fused(const float* coords, const float* feats,
                                   const float* bounds, int bounds_per_sample,
                                   const void* w1, const float* b1, const void* wp,
                                   const float* lin, int B, int P, int N, int G, int Gp,
                                   float* acc, float* part, float* ppart, void* d0,
                                   float* patch, float* kp, float* gmax, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n3 = (long long)N * N * N;
  if (G < 1 || G > (n3 + vx::voxel::kTile - 1) / vx::voxel::kTile) return cudaErrorInvalidValue;
  VX_CHECK(cudaMemsetAsync(acc, 0, (size_t)B * n3 * 8 * sizeof(float), stream));
  dim3 g1((P + 255) / 256, B);
  ff_scatter<<<g1, 256, 0, stream>>>(coords, feats, bounds, bounds_per_sample, P, N,
                                     acc);
  VX_CHECK(cudaGetLastError());
  ff_voxel<<<dim3(G, B), vx::voxel::kThreads, 0, stream>>>(
      acc, static_cast<const bf16*>(w1), b1, lin, N, G, static_cast<bf16*>(d0), part);
  VX_CHECK(cudaGetLastError());
  VX_CHECK(vx::launch_stats_combine<kC>(part, B, G, kp, gmax, stream));
  VX_CHECK(vx::patchify::launch_front_patchify(static_cast<const bf16*>(d0),
                                               static_cast<const bf16*>(wp), B, N, Gp, ppart,
                                               patch, stream));
  return 0;
}

// The patchify alone: d0 [B, N, N, N, 64] bf16 (N % 5 == 0), wp as above,
// Gp CTAs, ppart [Gp, 2, 128, 64] f32 scratch; patch [B, N/5, N/5, N/5, 64]
// f32 out. Returns a cudaError_t.
extern "C" int voxactb_front_patchify(const void* d0, const void* wp, int B, int N, int Gp,
                                      float* ppart, float* patch, void* stream_ptr) {
  return (int)vx::patchify::launch_front_patchify(
      static_cast<const bf16*>(d0), static_cast<const bf16*>(wp), B, N, Gp, ppart, patch,
      static_cast<cudaStream_t>(stream_ptr));
}
