// Device helpers shared by the act-path kernels (sm_90a).
//
// Counterpart of voxactb_tpu/ops/pallas/common.py: the leaky-relu on an
// already-rounded bf16 value, and the online-softmax soft-argmax statistics at
// T = 0.01 with the corr / -inf guard. On the TPU those statistics are one
// sequential fold over grid rows; here every block folds its own voxels into a
// partial (max, sum e, three weighted sums) per channel and `stats_combine`
// merges the partials, so the result differs from the TPU's only by f32
// summation order. The fronts' voxel pass (voxel_pass.cuh) and the decoder
// tail's trans/stats pass (decoder_tail.cuh) write such partials. The folds
// by tiles (the voxel pass, the decoder tail, stats_head.cu) take the ex2
// form below: one ex2 an element, where stat_corr takes an expf.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace vx {

typedef __nv_bfloat16 bf16;

// bf16(0.02): jax.nn.leaky_relu multiplies a bf16 value by a weakly typed
// slope, i.e. by the slope rounded to bf16.
constexpr float kLreluSlopeBf16 = 0.02001953125f;
// 1 / T for T = 0.01: XLA compiles "/ 0.01" as "* f32(100)", and so do we
constexpr float kInvTemperature = 100.f;
constexpr int kStatFields = 5;  // max, sum e, sum e*lin[dim1], *lin[dim0], *lin[dim2]

// Leaky relu of a value already rounded to bf16; the negative branch is the
// bf16 product (exact in f32, then one rounding), as in common.py.
__device__ __forceinline__ bf16 lrelu_rounded(bf16 v) {
  float f = __bfloat162float(v);
  return f >= 0.f ? v : __float2bfloat16_rn(f * kLreluSlopeBf16);
}

struct Stat {
  float m, s, wx, wd, wz;
};

__device__ __forceinline__ Stat stat_empty() {
  Stat st;
  st.m = -INFINITY;
  st.s = st.wx = st.wd = st.wz = 0.f;
  return st;
}

// exp((m_old - m_new) / T), 0 where that is not finite (both -inf).
__device__ __forceinline__ float stat_corr(float m_old, float m_new) {
  float c = expf((m_old - m_new) * kInvTemperature);
  return isfinite(c) ? c : 0.f;
}

__device__ __forceinline__ void stat_merge(Stat& a, const Stat& b) {
  float m = fmaxf(a.m, b.m);
  float ca = stat_corr(a.m, m), cb = stat_corr(b.m, m);
  a.s = a.s * ca + b.s * cb;
  a.wx = a.wx * ca + b.wx * cb;
  a.wd = a.wd * ca + b.wd * cb;
  a.wz = a.wz * ca + b.wz * cb;
  a.m = m;
}

// The ex2 form: with k = log2(e) / T, a weight exp((x - m) / T) is
// 2^(x k - m k), so a fold keeps its running max as m k and takes one ex2 an
// element.
constexpr float kExp2Scale = kInvTemperature * hopper::kLog2e;

// Sums taken against the running max mk (times k) raised to nk where that is
// larger: times 2^(mk - nk), 0 from mk = -inf (the first tile).
__device__ __forceinline__ void stat_raise(float nk, float& mk, float& s, float& wx, float& wd,
                                           float& wz) {
  if (nk > mk) {
    const float c = hopper::exp2_approx(mk - nk);
    s *= c;
    wx *= c;
    wd *= c;
    wz *= c;
    mk = nk;
  }
}

// stat_merge in the ex2 form: each side's sums rescaled to the larger max M
// by 2^(m k - M k), 1 on the side that holds it (on both with rescale false,
// a fault that stats_head.cu plants).
__device__ __forceinline__ void stat_merge_ex2(Stat& a, const Stat& b, bool rescale = true) {
  const float m = fmaxf(a.m, b.m), mk = m * kExp2Scale;
  const float ca = !rescale || a.m == m ? 1.f : hopper::exp2_approx(a.m * kExp2Scale - mk);
  const float cb = !rescale || b.m == m ? 1.f : hopper::exp2_approx(b.m * kExp2Scale - mk);
  a.s = a.s * ca + b.s * cb;
  a.wx = a.wx * ca + b.wx * cb;
  a.wd = a.wd * ca + b.wd * cb;
  a.wz = a.wz * ca + b.wz * cb;
  a.m = m;
}

// Partials are laid out [B, P, 5, C] f32.
__device__ __forceinline__ void stat_store(float* part, int C, int c, const Stat& st) {
  part[0 * C + c] = st.m;
  part[1 * C + c] = st.s;
  part[2 * C + c] = st.wx;
  part[3 * C + c] = st.wd;
  part[4 * C + c] = st.wz;
}

__device__ __forceinline__ Stat stat_load(const float* part, int C, int c) {
  Stat st;
  st.m = part[0 * C + c];
  st.s = part[1 * C + c];
  st.wx = part[2 * C + c];
  st.wd = part[3 * C + c];
  st.wz = part[4 * C + c];
  return st;
}

// Merge [B, P, 5, C] partials into kp [B, C*3] ((x, y, z) triplets, channel
// major) and gmax [B, C]. One block per sample; blockDim.x = G * C threads,
// group g merges partials g, g + G, ...; group 0 then merges the groups.
template <int C>
__global__ void stats_combine(const float* __restrict__ part, int P,
                              float* __restrict__ kp, float* __restrict__ gmax) {
  extern __shared__ float sh[];  // [5][blockDim.x]
  const int b = blockIdx.x;
  const int c = threadIdx.x % C;
  const int g = threadIdx.x / C;
  const int G = blockDim.x / C;
  Stat st = stat_empty();
  for (int p = g; p < P; p += G) {
    stat_merge(st, stat_load(part + ((size_t)b * P + p) * kStatFields * C, C, c));
  }
  const int T = blockDim.x;
  sh[0 * T + threadIdx.x] = st.m;
  sh[1 * T + threadIdx.x] = st.s;
  sh[2 * T + threadIdx.x] = st.wx;
  sh[3 * T + threadIdx.x] = st.wd;
  sh[4 * T + threadIdx.x] = st.wz;
  __syncthreads();
  if (g == 0) {
    for (int gg = 1; gg < G; ++gg) {
      int t = gg * C + c;
      Stat o;
      o.m = sh[0 * T + t];
      o.s = sh[1 * T + t];
      o.wx = sh[2 * T + t];
      o.wd = sh[3 * T + t];
      o.wz = sh[4 * T + t];
      stat_merge(st, o);
    }
    kp[(size_t)b * C * 3 + c * 3 + 0] = st.wx / st.s;
    kp[(size_t)b * C * 3 + c * 3 + 1] = st.wd / st.s;
    kp[(size_t)b * C * 3 + c * 3 + 2] = st.wz / st.s;
    gmax[(size_t)b * C + c] = st.m;
  }
}

constexpr int kCombineThreads = 1024;

template <int C>
inline cudaError_t launch_stats_combine(const float* part, int B, int P, float* kp,
                                        float* gmax, cudaStream_t stream) {
  size_t smem = kStatFields * kCombineThreads * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stats_combine<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  stats_combine<C><<<B, kCombineThreads, smem, stream>>>(part, P, kp, gmax);
  return cudaGetLastError();
}

constexpr int kPreC = 64;  // channels of d0

}  // namespace vx

#define VX_CHECK(expr)                 \
  do {                                 \
    cudaError_t _e = (expr);           \
    if (_e != cudaSuccess) return (int)_e; \
  } while (0)

// Every library exports its own error-string lookup for the ctypes wrappers.
#define VX_EXPORT_ERROR_STRING(name)                          \
  extern "C" const char* name(int err) {                      \
    return cudaGetErrorString(static_cast<cudaError_t>(err)); \
  }
