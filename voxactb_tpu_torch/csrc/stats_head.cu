// Standalone soft-argmax (T = 0.01) + global max of a cubic grid for Hopper
// (sm_90a).
//
// Replaces voxactb_tpu/ops/pallas/stats_head.py::stats_head (TPU kernel
// `_kernel` under `_stats_head_single`), with that kernel's own arithmetic:
// logits l = x * 100 (XLA's form of x / 0.01), a running max of the logits,
// weights exp(l - max), positions (i * f32(1/(n-1))) * 2 - 1 rounded once (the
// fused multiply-add XLA emits), expectations = sums * (1 / denominator), and
// the global max of x kept as a field of its own. (x, y, z) integrate the
// (h, d, w) indices: the reference's meshgrid-'xy' quirk.
//
// What bounds it on an H100: memory. At [1, 100^3, 64] bf16 it reads 128 MB
// for about 0.4 GFLOP; the decoder grid [B, 20^3, 128] (2 MB) is launch-bound.
//
// Design (simple first): the TPU kernel's sequential grid becomes
//   1. sh_partial - blocks of 1024 rows per sample; thread (g, c) folds
//      channel c of rows g, g + G, ... (G = 256 / C groups, one for C = 192)
//      into an online (max, sum, three weighted sums, global max) and the
//      block merges its groups into a partial [B, P, 6, C];
//   2. sh_combine - one block per sample of G' * C threads (G' = 1024 / C, so
//      960 for C = 192), group g merging partials g, g + G', ...; every
//      partial is merged exactly once. Then the divide.
// Sums differ from the TPU's only in f32 summation order.

#include "common.cuh"

namespace {

using vx::bf16;

constexpr int kRowsPerBlock = 1024;
constexpr int kFields = 6;  // max logit, sum e, e * x, e * y, e * z, max of x

struct LStat {
  float m, s, wx, wy, wz, g;
};

__device__ __forceinline__ LStat lstat_empty() {
  LStat st;
  st.m = st.g = -INFINITY;
  st.s = st.wx = st.wy = st.wz = 0.f;
  return st;
}

// exp(m_old - m_new) in logit units, 0 where that is not finite (both -inf)
__device__ __forceinline__ float lstat_corr(float m_old, float m_new) {
  float c = expf(m_old - m_new);
  return isfinite(c) ? c : 0.f;
}

__device__ __forceinline__ void lstat_merge(LStat& a, const LStat& b) {
  float m = fmaxf(a.m, b.m);
  float ca = lstat_corr(a.m, m), cb = lstat_corr(b.m, m);
  a.s = a.s * ca + b.s * cb;
  a.wx = a.wx * ca + b.wx * cb;
  a.wy = a.wy * ca + b.wy * cb;
  a.wz = a.wz * ca + b.wz * cb;
  a.m = m;
  a.g = fmaxf(a.g, b.g);
}

__device__ __forceinline__ void lstat_put(float* dst, int stride, const LStat& st) {
  dst[0 * stride] = st.m;
  dst[1 * stride] = st.s;
  dst[2 * stride] = st.wx;
  dst[3 * stride] = st.wy;
  dst[4 * stride] = st.wz;
  dst[5 * stride] = st.g;
}

__device__ __forceinline__ LStat lstat_get(const float* src, int stride) {
  LStat st;
  st.m = src[0 * stride];
  st.s = src[1 * stride];
  st.wx = src[2 * stride];
  st.wy = src[3 * stride];
  st.wz = src[4 * stride];
  st.g = src[5 * stride];
  return st;
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(bf16 v) { return __bfloat162float(v); }

template <typename T, int C>
__global__ void __launch_bounds__(256)
sh_partial(const T* __restrict__ x, int n, int P, float* __restrict__ part) {
  constexpr int G = C >= 256 ? 1 : 256 / C;
  __shared__ float sh[G][kFields][C];
  const int b = blockIdx.y;
  const int c = threadIdx.x % C;
  const int g = threadIdx.x / C;
  const int nn = n * n;
  const int S = nn * n;  // the wrapper keeps n^3 below 2^31
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(r0 + kRowsPerBlock, S);
  // lin(i) = (i * f32(1/(n-1))) * 2 - 1 with one rounding
  const float inv2 = 2.f * (1.f / (float)max(n - 1, 1));
  const T* xb = x + (size_t)b * S * C + c;
  LStat st = lstat_empty();
  for (int r = r0 + g; r < r1; r += G) {
    float v = as_float(xb[(size_t)r * C]);
    float l = v * 100.f;
    float px = fmaf((float)((r / n) % n), inv2, -1.f);
    float py = fmaf((float)(r / nn), inv2, -1.f);
    float pz = fmaf((float)(r % n), inv2, -1.f);
    float m_new = fmaxf(st.m, l);
    float corr = lstat_corr(st.m, m_new);
    float e = expf(l - m_new);
    st.s = st.s * corr + e;
    st.wx = st.wx * corr + e * px;
    st.wy = st.wy * corr + e * py;
    st.wz = st.wz * corr + e * pz;
    st.m = m_new;
    st.g = fmaxf(st.g, v);
  }
  lstat_put(&sh[g][0][c], C, st);
  __syncthreads();
  if (g == 0) {
    for (int gg = 1; gg < G; ++gg) lstat_merge(st, lstat_get(&sh[gg][0][c], C));
    lstat_put(part + ((size_t)b * P + blockIdx.x) * kFields * C + c, C, st);
  }
}

template <int C>
__global__ void __launch_bounds__(1024)
sh_combine(const float* __restrict__ part, int P, float* __restrict__ kp,
           float* __restrict__ gmax) {
  constexpr int G = 1024 / C;
  __shared__ float sh[G][kFields][C];
  const int b = blockIdx.x;
  const int c = threadIdx.x % C;
  const int g = threadIdx.x / C;
  LStat st = lstat_empty();
  for (int p = g; p < P; p += G)
    lstat_merge(st, lstat_get(part + ((size_t)b * P + p) * kFields * C + c, C));
  lstat_put(&sh[g][0][c], C, st);
  __syncthreads();
  if (g == 0) {
    for (int gg = 1; gg < G; ++gg) lstat_merge(st, lstat_get(&sh[gg][0][c], C));
    const float inv = 1.f / st.s;
    kp[(size_t)b * C * 3 + c * 3 + 0] = st.wx * inv;
    kp[(size_t)b * C * 3 + c * 3 + 1] = st.wy * inv;
    kp[(size_t)b * C * 3 + c * 3 + 2] = st.wz * inv;
    gmax[(size_t)b * C + c] = st.g;
  }
}

template <typename T, int C>
int run(const void* x, int B, int n, float* part, float* kp, float* gmax,
        cudaStream_t stream) {
  constexpr int G = C >= 256 ? 1 : 256 / C;
  const long long S = (long long)n * n * n;
  const int P = (int)((S + kRowsPerBlock - 1) / kRowsPerBlock);
  sh_partial<T, C><<<dim3(P, B), G * C, 0, stream>>>(static_cast<const T*>(x), n, P,
                                                     part);
  VX_CHECK(cudaGetLastError());
  sh_combine<C><<<B, (1024 / C) * C, 0, stream>>>(part, P, kp, gmax);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, int B, int n, int C, float* part, float* kp, float* gmax,
             cudaStream_t stream) {
  switch (C) {
    case 64: return run<T, 64>(x, B, n, part, kp, gmax, stream);
    case 128: return run<T, 128>(x, B, n, part, kp, gmax, stream);
    case 192: return run<T, 192>(x, B, n, part, kp, gmax, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

VX_EXPORT_ERROR_STRING(voxactb_stats_head_error_string)

// x [B, n, n, n, C] f32 (x_is_bf16 = 0) or bf16 (1), C in 64, 128, 192.
// Scratch: part [B, ceil(n^3/1024), 6, C] f32.
// Outputs: kp [B, 3C] f32 ((x, y, z) triplets, channel major), gmax [B, C] f32.
// Returns a cudaError_t.
extern "C" int voxactb_stats_head(const void* x, int x_is_bf16, int B, int n, int C,
                                  float* part, float* kp, float* gmax, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return x_is_bf16 ? dispatch<bf16>(x, B, n, C, part, kp, gmax, stream)
                   : dispatch<float>(x, B, n, C, part, kp, gmax, stream);
}
