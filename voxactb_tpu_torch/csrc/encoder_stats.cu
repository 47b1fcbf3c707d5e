// Dense-grid encoder front for Hopper (sm_90a): 1x1x1 preprocess conv + lrelu
// + soft-argmax stats of d0, one pass over the voxel grid.
//
// Replaces voxactb_tpu/ops/pallas/encoder_stats.py::encoder_stats (TPU kernel
// `_kernel`), the front the act path takes when the fused front (K1) is not
// eligible and the caller hands it a dense [B, N, N, N, 10] grid.
//
// What bounds it on an H100: memory. At N = 100, B = 1 it reads the grid (40
// MB f32, 20 MB as bf16) and writes d0 (128 MB bf16); the 1x1 conv is 1.3
// GFLOP.
//
// Design: K1's voxel pass with the dense grid as its row source.
//   1. es_voxel - the voxel pass (voxel_pass.cuh): each tile's 64 rows of 10
//      values read coalesced (f32 or bf16 grid) and rounded to bf16 (the
//      compute dtype, as the TPU kernel's x_in.astype(bf16)), then d0 =
//      lrelu(bf16(row . W1 + b1)) with the cast before the lrelu, written as
//      16-byte vectors, and one partial of the online soft-argmax at T = 0.01
//      per persistent CTA (positions from linspace).
//   2. stats_combine (common.cuh) - merge the partials into kp / gmax.

#include "voxel_pass.cuh"

namespace {

using vx::bf16;
using vx::voxel::kThreads;
using vx::voxel::kTile;

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(bf16 v) { return __bfloat162float(v); }

// K5's row source: a tile's rows are one contiguous run of up to 64 x 10
// values, read by all threads
template <typename T>
struct GridRows {
  static constexpr int kPer = kTile * 10 / kThreads;
  const T* x;
  long long n3;
  float val[kPer];

  __device__ __forceinline__ void fetch(int b, long long v0) {
    const T* src = x + ((size_t)b * n3 + v0) * 10;
    const long long avail = (n3 - v0) * 10;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = threadIdx.x + kThreads * k;
      val[k] = j < avail ? as_float(src[j]) : 0.f;
    }
  }

  __device__ __forceinline__ void put(float (*rows)[vx::voxel::kRow], long long) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = threadIdx.x + kThreads * k;
      rows[j / 10][j % 10] = vx::voxel::bf16_round(val[k]);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, vx::voxel::kCtasPerSm)
es_voxel(const T* __restrict__ x, const bf16* __restrict__ w1, const float* __restrict__ b1,
         const float* __restrict__ lin, int N, int G, bf16* __restrict__ d0,
         float* __restrict__ part) {
  __shared__ __align__(16) vx::voxel::Smem sh;
  GridRows<T> src;
  src.x = x;
  src.n3 = (long long)N * N * N;
  vx::voxel::voxel_pass(src, sh, w1, b1, lin, N, G, d0, part);
}

template <typename T>
int run(const void* x, const void* w1, const float* b1, const float* lin, int B, int N,
        int G, void* d0, float* part, cudaStream_t stream) {
  es_voxel<T><<<dim3(G, B), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const bf16*>(w1), b1, lin, N, G,
      static_cast<bf16*>(d0), part);
  return (int)cudaGetLastError();
}

}  // namespace

VX_EXPORT_ERROR_STRING(voxactb_encoder_stats_error_string)

// x [B, N, N, N, 10] f32 (x_is_bf16 = 0) or bf16 (1); w1 [10, 64] bf16;
// b1 [64] f32; lin [N] f32 (linspace(-1, 1, N)); G voxel-pass CTAs per
// sample (ops/cuda/encoder_stats.py::voxel_pass_grid).
// Scratch: part [B, G, 5, 64] f32.
// Outputs: d0 [B, N, N, N, 64] bf16, kp [B, 192] f32, gmax [B, 64] f32.
// Returns a cudaError_t.
extern "C" int voxactb_encoder_stats(const void* x, int x_is_bf16, const void* w1,
                                     const float* b1, const float* lin, int B, int N, int G,
                                     float* part, void* d0, float* kp, float* gmax,
                                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n3 = (long long)N * N * N;
  if (G < 1 || G > (n3 + kTile - 1) / kTile) return cudaErrorInvalidValue;
  int err = x_is_bf16 ? run<bf16>(x, w1, b1, lin, B, N, G, d0, part, stream)
                      : run<float>(x, w1, b1, lin, B, N, G, d0, part, stream);
  if (err) return err;
  VX_CHECK(vx::launch_stats_combine<vx::kPreC>(part, B, G, kp, gmax, stream));
  return 0;
}
