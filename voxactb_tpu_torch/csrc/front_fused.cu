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
// Design (simple first, not the TPU schedule):
//   1. ff_scatter  - one thread per point bins it exactly as the XLA voxelize
//                    does and atomically adds (xyz, rgb, 1) into an
//                    [B, N^3, 8] f32 accumulator. Unlike the TPU kernel, no
//                    point is dropped (no row capacity): overflow is always 0.
//                    Atomics sum in a run-dependent order, so the mean can
//                    differ from the plain version in the last f32 bits and
//                    d0 by one bf16 ulp.
//   2. ff_voxel    - per 128-voxel tile: build the 10-channel grid row (mean,
//                    index / N, occupancy), round it to bf16, then
//                    preprocess_tile (common.cuh): d0 = lrelu(bf16(row . W1 +
//                    b1)) with f32 products, written coalesced, and each
//                    channel folded into a per-block soft-argmax partial.
//   3. stats_combine (common.cuh) - merge the partials into kp / gmax.
//   4. conv3d_igemm<64, 5, 5, 2> (common.cuh) - the patchify over d0 with
//                    front edge padding 2 (the back padding is never read),
//                    f32 pre-activation out; the caller adds bias + lrelu.

#include "common.cuh"

namespace {

using vx::bf16;

constexpr int kC = vx::kPreC;
constexpr int kVoxTile = vx::kPreTile;

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

__global__ void __launch_bounds__(vx::kPreTile)
ff_voxel(const float* __restrict__ acc, const bf16* __restrict__ w1,
         const float* __restrict__ b1, const float* __restrict__ lin, int N,
         int P3, bf16* __restrict__ d0, float* __restrict__ part) {
  __shared__ float rows[vx::kPreTile][11];
  __shared__ float sh_stat[vx::kStatFields][vx::kPreC];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const long long n3 = (long long)N * N * N;
  const long long v0 = (long long)blockIdx.x * vx::kPreTile;

  {  // grid row of voxel v0 + tid, rounded to bf16 (the compute dtype)
    long long v = v0 + tid;
    float r[10];
    if (v < n3) {
      const float* a = acc + ((size_t)b * n3 + v) * 8;
      float count = a[6];
      float den = fmaxf(count, 1.f);
#pragma unroll
      for (int k = 0; k < 6; ++k) r[k] = a[k] / den;
      int i0 = (int)(v / ((long long)N * N));
      int i1 = (int)((v / N) % N);
      int i2 = (int)(v % N);
      const float inv_n = 1.f / (float)N;  // index / N, as XLA compiles it
      r[6] = (float)i0 * inv_n;
      r[7] = (float)i1 * inv_n;
      r[8] = (float)i2 * inv_n;
      r[9] = count > 0.f ? 1.f : 0.f;
    } else {
#pragma unroll
      for (int k = 0; k < 10; ++k) r[k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < 10; ++k) rows[tid][k] = __bfloat162float(__float2bfloat16_rn(r[k]));
  }
  __syncthreads();
  vx::preprocess_tile(rows, sh_stat, w1, b1, lin, N, v0, P3, d0, part);
}

}  // namespace

VX_EXPORT_ERROR_STRING(voxactb_front_fused_error_string)

// coords, feats [B, P, 3] f32; bounds [B or 1, 6] f32; w1 [10, 64] bf16;
// b1 [64] f32; wp [125, 64, 64] bf16 (tap-major kz, ky, kx; ci; co);
// lin [N] f32 (linspace(-1, 1, N)).
// Scratch: acc [B, N^3, 8] f32 (zeroed here), part [B, ceil(N^3/128), 5, 64] f32.
// Outputs: d0 [B, N, N, N, 64] bf16, patch [B, N/5, N/5, N/5, 64] f32,
// kp [B, 192] f32, gmax [B, 64] f32. Returns a cudaError_t.
extern "C" int voxactb_front_fused(const float* coords, const float* feats,
                                   const float* bounds, int bounds_per_sample,
                                   const void* w1, const float* b1, const void* wp,
                                   const float* lin, int B, int P, int N, float* acc,
                                   float* part, void* d0, float* patch, float* kp,
                                   float* gmax, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n3 = (long long)N * N * N;
  const int p3 = (int)((n3 + kVoxTile - 1) / kVoxTile);
  VX_CHECK(cudaMemsetAsync(acc, 0, (size_t)B * n3 * 8 * sizeof(float), stream));
  dim3 g1((P + 255) / 256, B);
  ff_scatter<<<g1, 256, 0, stream>>>(coords, feats, bounds, bounds_per_sample, P, N,
                                     acc);
  VX_CHECK(cudaGetLastError());
  dim3 g2(p3, B);
  ff_voxel<<<g2, kVoxTile, 0, stream>>>(acc, static_cast<const bf16*>(w1), b1, lin,
                                        N, p3, static_cast<bf16*>(d0), part);
  VX_CHECK(cudaGetLastError());
  VX_CHECK(vx::launch_stats_combine<kC>(part, B, p3, kp, gmax, stream));
  VX_CHECK((vx::launch_conv3d_igemm<64, 5, 5, 2>(static_cast<const bf16*>(d0), nullptr,
                                                  static_cast<const bf16*>(wp), B, N, N / 5,
                                                  patch, stream)));
  return 0;
}
