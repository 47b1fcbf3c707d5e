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
// Design (simple first): the row source of K1's ff_voxel swapped for the
// dense grid.
//   1. es_voxel - per 128-voxel tile: read the tile's 10-channel rows
//      coalesced (f32 or bf16 grid), round them to bf16 (the compute dtype,
//      as the TPU kernel's x_in.astype(bf16)), then preprocess_tile
//      (common.cuh): d0 = lrelu(bf16(row . W1 + b1)) with the cast before the
//      lrelu, d0 written, and each channel folded into a per-block partial of
//      the online soft-argmax at T = 0.01 (positions from linspace).
//   2. stats_combine (common.cuh) - merge the partials into kp / gmax.

#include "common.cuh"

namespace {

using vx::bf16;

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(bf16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(vx::kPreTile)
es_voxel(const T* __restrict__ x, const bf16* __restrict__ w1,
         const float* __restrict__ b1, const float* __restrict__ lin, int N, int P3,
         bf16* __restrict__ d0, float* __restrict__ part) {
  __shared__ float rows[vx::kPreTile][11];
  __shared__ float sh_stat[vx::kStatFields][vx::kPreC];

  const int b = blockIdx.y;
  const long long n3 = (long long)N * N * N;
  const long long v0 = (long long)blockIdx.x * vx::kPreTile;
  // the tile's rows are one contiguous run of up to 128 x 10 values
  const T* src = x + ((size_t)b * n3 + v0) * 10;
  const long long avail = (n3 - v0) * 10;
  for (int j = threadIdx.x; j < vx::kPreTile * 10; j += vx::kPreTile) {
    float v = j < avail ? as_float(src[j]) : 0.f;
    rows[j / 10][j % 10] = __bfloat162float(__float2bfloat16_rn(v));
  }
  __syncthreads();
  vx::preprocess_tile(rows, sh_stat, w1, b1, lin, N, v0, P3, d0, part);
}

template <typename T>
int run(const void* x, const void* w1, const float* b1, const float* lin, int B, int N,
        int P3, void* d0, float* part, cudaStream_t stream) {
  dim3 grid(P3, B);
  es_voxel<T><<<grid, vx::kPreTile, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const bf16*>(w1), b1, lin, N, P3,
      static_cast<bf16*>(d0), part);
  return (int)cudaGetLastError();
}

}  // namespace

VX_EXPORT_ERROR_STRING(voxactb_encoder_stats_error_string)

// x [B, N, N, N, 10] f32 (x_is_bf16 = 0) or bf16 (1); w1 [10, 64] bf16;
// b1 [64] f32; lin [N] f32 (linspace(-1, 1, N)).
// Scratch: part [B, ceil(N^3/128), 5, 64] f32.
// Outputs: d0 [B, N, N, N, 64] bf16, kp [B, 192] f32, gmax [B, 64] f32.
// Returns a cudaError_t.
extern "C" int voxactb_encoder_stats(const void* x, int x_is_bf16, const void* w1,
                                     const float* b1, const float* lin, int B, int N,
                                     float* part, void* d0, float* kp, float* gmax,
                                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n3 = (long long)N * N * N;
  const int p3 = (int)((n3 + vx::kPreTile - 1) / vx::kPreTile);
  int err = x_is_bf16 ? run<bf16>(x, w1, b1, lin, B, N, p3, d0, part, stream)
                      : run<float>(x, w1, b1, lin, B, N, p3, d0, part, stream);
  if (err) return err;
  VX_CHECK(vx::launch_stats_combine<vx::kPreC>(part, B, p3, kp, gmax, stream));
  return 0;
}
