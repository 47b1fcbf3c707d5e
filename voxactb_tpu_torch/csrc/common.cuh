// Device helpers shared by the act-path kernels (sm_90a).
//
// Counterpart of voxactb_tpu/ops/pallas/common.py: the leaky-relu on an
// already-rounded bf16 value, and the online-softmax soft-argmax statistics at
// T = 0.01 with the corr / -inf guard. On the TPU those statistics are one
// sequential fold over grid rows; here every block folds its own voxels into a
// partial (max, sum e, three weighted sums) per channel and `stats_combine`
// merges the partials, so the result differs from the TPU's only by f32
// summation order.
//
// Also the bf16 implicit-GEMM 3D convolution (`conv3d_igemm`) used by the
// front kernel's k5/s5 patchify and the decoder tail's k3 skip-concat conv:
// replicate padding is an index clamp, and the products run on the tensor
// cores through WMMA (16x16x16 bf16 tiles, f32 accumulation).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

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

// Fold one value at position (px = lin[dim1], pd = lin[dim0], pz = lin[dim2]).
__device__ __forceinline__ void stat_fold(Stat& st, float u, float px, float pd,
                                          float pz) {
  float m_new = fmaxf(st.m, u);
  float corr = stat_corr(st.m, m_new);
  float e = expf((u - m_new) * kInvTemperature);
  st.s = st.s * corr + e;
  st.wx = st.wx * corr + e * px;
  st.wd = st.wd * corr + e * pd;
  st.wz = st.wz * corr + e * pz;
  st.m = m_new;
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

// ---------------------------------------------------------------------------
// Implicit-GEMM 3D convolution, channels-last bf16, Cout = 64.
//
//   out[b, o, co] = sum_{tap, ci} in[b, clamp(o * STRIDE + tap - PAD), ci] * w[tap, ci, co]
//
// The input is the channel concat of src0 (channels 0..63) and, for CIN = 128,
// src1 (channels 64..127), both [B, Ni, Ni, Ni, 64]. w is [KS^3, CIN, 64] bf16.
// One block computes 64 output voxels x 64 channels: 4 warps, each 16 voxels
// x 64 channels as four 16x16 f32 accumulators. Per tap the block gathers the
// 64 clamped input rows (A, 64 x CIN) and the tap's weights (B, CIN x 64) into
// shared memory and runs CIN / 16 WMMA k-steps. Epilogues: raw f32 (the
// patchify's pre-activation) or bias + bf16 rounding + leaky relu (bf16 out).
// ---------------------------------------------------------------------------

constexpr int kConvBM = 64;
constexpr int kConvCout = 64;
constexpr int kConvThreads = 128;

template <int CIN>
struct ConvSmem {
  static constexpr int kLdA = CIN + 8;        // bf16 elements
  static constexpr int kLdB = kConvCout + 8;  // bf16 elements
  static constexpr int kLdC = kConvCout + 4;  // f32 elements
  static constexpr int kBytesA = kConvBM * kLdA * 2;
  static constexpr int kBytesB = CIN * kLdB * 2;
  static constexpr int kBytesC = kConvBM * kLdC * 4;
  static constexpr int kBytes =
      (kBytesA + kBytesB) > kBytesC ? (kBytesA + kBytesB) : kBytesC;
};

enum ConvEpilogue { kEpiRawF32 = 0, kEpiBiasLreluBf16 = 1 };

template <int CIN, int KS, int STRIDE, int PAD, int EPI>
__global__ void __launch_bounds__(kConvThreads)
conv3d_igemm(const bf16* __restrict__ src0, const bf16* __restrict__ src1,
             const bf16* __restrict__ w, const float* __restrict__ bias, int B,
             int Ni, int No, float* __restrict__ out_f32,
             bf16* __restrict__ out_bf16) {
  using namespace nvcuda;
  typedef ConvSmem<CIN> S;
  __shared__ __align__(128) unsigned char smem[S::kBytes];
  __shared__ int row_base[kConvBM][4];  // b, z0, y0, x0 (or b = -1: past the end)

  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + S::kBytesA);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const long long no3 = (long long)No * No * No;
  const long long M = (long long)B * no3;
  const long long m0 = (long long)blockIdx.x * kConvBM;

  if (tid < kConvBM) {
    long long m = m0 + tid;
    if (m < M) {
      int b = (int)(m / no3);
      long long r = m - (long long)b * no3;
      int oz = (int)(r / ((long long)No * No));
      int oy = (int)((r / No) % No);
      int ox = (int)(r % No);
      row_base[tid][0] = b;
      row_base[tid][1] = oz * STRIDE - PAD;
      row_base[tid][2] = oy * STRIDE - PAD;
      row_base[tid][3] = ox * STRIDE - PAD;
    } else {
      row_base[tid][0] = -1;
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
  __syncthreads();

  constexpr int kChunksPerRow = CIN / 8;  // 16-byte chunks of one input row
  constexpr int kChunksA = kConvBM * kChunksPerRow;
  constexpr int kChunksB = CIN * kConvCout / 8;
  constexpr int kTaps = KS * KS * KS;

  for (int tap = 0; tap < kTaps; ++tap) {
    const int kz = tap / (KS * KS), ky = (tap / KS) % KS, kx = tap % KS;
    for (int j = tid; j < kChunksA; j += kConvThreads) {
      const int r = j / kChunksPerRow;
      const int ch = j % kChunksPerRow;
      uint4 val = make_uint4(0, 0, 0, 0);
      const int b = row_base[r][0];
      if (b >= 0) {
        int iz = min(max(row_base[r][1] + kz, 0), Ni - 1);
        int iy = min(max(row_base[r][2] + ky, 0), Ni - 1);
        int ix = min(max(row_base[r][3] + kx, 0), Ni - 1);
        size_t vox = (((size_t)b * Ni + iz) * Ni + iy) * Ni + ix;
        const bf16* src = (ch < 8) ? src0 : src1;
        val = *reinterpret_cast<const uint4*>(src + vox * 64 + (ch % 8) * 8);
      }
      *reinterpret_cast<uint4*>(As + r * S::kLdA + ch * 8) = val;
    }
    const bf16* wt = w + (size_t)tap * CIN * kConvCout;
    for (int j = tid; j < kChunksB; j += kConvThreads) {
      const int r = j / (kConvCout / 8);
      const int ch = j % (kConvCout / 8);
      *reinterpret_cast<uint4*>(Bs + r * S::kLdB + ch * 8) =
          *reinterpret_cast<const uint4*>(wt + r * kConvCout + ch * 8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < CIN / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, As + warp * 16 * S::kLdA + kk * 16, S::kLdA);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, Bs + kk * 16 * S::kLdB + n * 16, S::kLdB);
        wmma::mma_sync(acc[n], a, bfr, acc[n]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(Cs + warp * 16 * S::kLdC + n * 16, acc[n], S::kLdC,
                            wmma::mem_row_major);
  __syncthreads();

  if (EPI == kEpiRawF32) {
    for (int j = tid; j < kConvBM * kConvCout; j += kConvThreads) {
      const int r = j / kConvCout, co = j % kConvCout;
      long long m = m0 + r;
      if (m < M) out_f32[m * kConvCout + co] = Cs[r * S::kLdC + co];
    }
  } else {
    for (int j = tid; j < kConvBM * kConvCout / 2; j += kConvThreads) {
      const int r = j / (kConvCout / 2), co = (j % (kConvCout / 2)) * 2;
      long long m = m0 + r;
      if (m < M) {
        bf16 v0 = lrelu_rounded(__float2bfloat16_rn(Cs[r * S::kLdC + co] + bias[co]));
        bf16 v1 = lrelu_rounded(
            __float2bfloat16_rn(Cs[r * S::kLdC + co + 1] + bias[co + 1]));
        __nv_bfloat162 pair;
        pair.x = v0;
        pair.y = v1;
        *reinterpret_cast<__nv_bfloat162*>(out_bf16 + m * kConvCout + co) = pair;
      }
    }
  }
}

template <int CIN, int KS, int STRIDE, int PAD, int EPI>
inline cudaError_t launch_conv3d_igemm(const bf16* src0, const bf16* src1,
                                       const bf16* w, const float* bias, int B, int Ni,
                                       int No, float* out_f32, bf16* out_bf16,
                                       cudaStream_t stream) {
  long long M = (long long)B * No * No * No;
  unsigned blocks = (unsigned)((M + kConvBM - 1) / kConvBM);
  conv3d_igemm<CIN, KS, STRIDE, PAD, EPI><<<blocks, kConvThreads, 0, stream>>>(
      src0, src1, w, bias, B, Ni, No, out_f32, out_bf16);
  return cudaGetLastError();
}

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
