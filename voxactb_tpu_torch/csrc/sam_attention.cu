// SAM attention with a decomposed relative-position bias, for Hopper (sm_90a):
//
//   out[i] = softmax_j(q[i] . k[j] + rel_h[i, j / kw] + rel_w[i, j % kw]) v
//
// over the T = kh * kw tokens of a kh x kw grid (a 64 x 64 global block or a
// 14 x 14 window of SAM's ViT image encoder).
//
// Replaces voxactb_tpu/ops/pallas/sam_attention.py::global_rel_attention
// (TPU kernel `_kernel`). The TPU kernel folds the bias into the q k^T
// contraction through a hi/lo bf16 split of each f32 bias value and one-hot
// key selectors, a trick for the TPU's matrix unit. Here the f32 bias is added
// to the f32 logits in registers instead: each block stages the kh-vector and
// the kw-vector of its 64 query rows in shared memory, and a logit picks one
// value of each. That is exact where the split is within 2^-17 of a value.
//
// What bounds it on an H100: operations for a global block (BH 16, T 4096,
// head dim 80: 86 GFLOP against 42 MB), bytes for a windowed one (BH 400,
// T 196: 59 MB, mostly the two f32 rel terms, against 4.9 GFLOP).
//
// Numerics follow the TPU kernel and the XLA formulation: q arrives pre-scaled
// and rounded to bf16; logits are f32 sums of exact bf16 products, plus
// rel_h, plus rel_w, in that order; the row max m and the row sum s of
// exp(l - m) cover the whole key axis; P = bf16(exp(l - m) / s) is normalised
// BEFORE its cast; P v accumulates in f32 and is rounded to bf16 once. As in
// flash_attention.cu each 64-row query block makes two passes over the keys:
// pass 1 folds m and s online (f32 sums in another order than the XLA row
// sum), pass 2 forms P and accumulates P v. The head dim (80 for ViT-H, no
// multiple of 64) is a template parameter. T is ragged (196 = 3 * 64 + 4 in a
// window): keys past T in the last tile are zero-filled, masked to -inf and
// never index the bias; query rows past T are computed on zeros and not
// stored. 4 warps of 16 query rows share each 64-key tile; products run on
// the tensor cores through WMMA 16x16x16 bf16 tiles.

#include "attention.cuh"

namespace {

using vx::bf16;
using namespace nvcuda;
using namespace vx::attn;

constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kMaxGrid = 64;        // kh, kw at most 64 (ViT-H's global grid)
constexpr int kMaxDevices = 64;

template <int HD>
struct Layout {
  static constexpr int kLdT = HD + 8;  // bf16 row stride of the q/k/v tiles
  static constexpr int kLdO = HD + 4;  // f32 row stride of the output slab
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kRows * kLdT * 2;
  static constexpr int kV = kK + kBk * kLdT * 2;
  static constexpr int kS = kV + kBk * kLdT * 2;
  static constexpr int kP = kS + kWarps * 16 * kLdS * 4;
  static constexpr int kRow = kP + kWarps * 16 * kLdP * 2;  // whole-row m, s
  static constexpr int kBias = kRow + 2 * kRows * 4;        // rel_h, rel_w rows
  static constexpr int bytes(int kh, int kw) { return kBias + kRows * (kh + kw) * 4; }
  // the f32 output slab reuses the K and V tiles after the last key tile
  static_assert(kRows * kLdO * 4 <= kS - kK, "output slab exceeds the K and V tiles");
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
sam_attention_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ rel_h,
                  const float* __restrict__ rel_w, bf16* __restrict__ o, int T, int kh,
                  int kw) {
  using L = Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::kV);
  float* Ss = reinterpret_cast<float*>(smem + L::kS);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::kP);
  float* row_m = reinterpret_cast<float*>(smem + L::kRow);
  float* row_s = row_m + kRows;
  float* bias_h = reinterpret_cast<float*>(smem + L::kBias);  // [kRows, kh]
  float* bias_w = bias_h + kRows * kh;                         // [kRows, kw]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int rows_valid = min(kRows, T - q0);
  const bf16* kb = k + (size_t)bh * T * HD;
  const bf16* vb = v + (size_t)bh * T * HD;
  const float* rhb = rel_h + ((size_t)bh * T + q0) * kh;
  const float* rwb = rel_w + ((size_t)bh * T + q0) * kw;

  load_rows<HD>(Qs, q + ((size_t)bh * T + q0) * HD, kRows, rows_valid, tid, kThreads);
  for (int j = tid; j < kRows * kh; j += kThreads)
    bias_h[j] = j < rows_valid * kh ? rhb[j] : 0.f;
  for (int j = tid; j < kRows * kw; j += kThreads)
    bias_w[j] = j < rows_valid * kw ? rwb[j] : 0.f;
  if (tid < kRows) {
    row_m[tid] = -INFINITY;
    row_s[tid] = 0.f;
  }
  __syncthreads();

  const bf16* Qw = Qs + warp * 16 * L::kLdT;
  float* Sw = Ss + warp * 16 * kLdS;
  bf16* Pw = Ps + warp * 16 * kLdP;
  const float* bhw = bias_h + warp * 16 * kh;
  const float* bww = bias_w + warp * 16 * kw;
  float* pm = row_m + warp * 16;
  float* ps = row_s + warp * 16;
  const int n_tiles = (T + kBk - 1) / kBk;

  // pass 1: the whole row's max and sum of exp(l - max), folded online
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBk;
    load_rows<HD>(Ks, kb + (size_t)k0 * HD, kBk, T - k0, tid, kThreads);
    __syncthreads();
    logits_slab<HD>(Qw, Ks, Sw);
    __syncwarp();
    const int j0 = k0 + lane, j1 = k0 + lane + 32;
    const bool c0 = j0 < T, c1 = j1 < T;
    const int h0 = c0 ? j0 / kw : 0, w0 = c0 ? j0 - h0 * kw : 0;
    const int h1 = c1 ? j1 / kw : 0, w1 = c1 ? j1 - h1 * kw : 0;
    for (int r = 0; r < 16; ++r) {
      const float l0 = c0 ? (Sw[r * kLdS + lane] + bhw[r * kh + h0]) + bww[r * kw + w0]
                          : -INFINITY;
      const float l1 = c1 ? (Sw[r * kLdS + lane + 32] + bhw[r * kh + h1]) + bww[r * kw + w1]
                          : -INFINITY;
      const float m_old = pm[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(l0, l1)));
      float e = (c0 ? expf(l0 - m_new) : 0.f) + (c1 ? expf(l1 - m_new) : 0.f);
      e = warp_sum(e);
      if (lane == 0) {
        const float corr = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        ps[r] = ps[r] * corr + e;
        pm[r] = m_new;
      }
      __syncwarp();
    }
    __syncthreads();  // every warp is done with this K tile
  }

  // pass 2: P = bf16(exp(l - m) / s); O += P v
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBk;
    load_rows<HD>(Ks, kb + (size_t)k0 * HD, kBk, T - k0, tid, kThreads);
    load_rows<HD>(Vs, vb + (size_t)k0 * HD, kBk, T - k0, tid, kThreads);
    __syncthreads();
    logits_slab<HD>(Qw, Ks, Sw);
    __syncwarp();
    const int j0 = k0 + lane, j1 = k0 + lane + 32;
    const bool c0 = j0 < T, c1 = j1 < T;
    const int h0 = c0 ? j0 / kw : 0, w0 = c0 ? j0 - h0 * kw : 0;
    const int h1 = c1 ? j1 / kw : 0, w1 = c1 ? j1 - h1 * kw : 0;
    for (int r = 0; r < 16; ++r) {
      const float m = pm[r], s = ps[r];
      float p0 = 0.f, p1 = 0.f;
      if (c0) p0 = expf((Sw[r * kLdS + lane] + bhw[r * kh + h0]) + bww[r * kw + w0] - m) / s;
      if (c1)
        p1 = expf((Sw[r * kLdS + lane + 32] + bhw[r * kh + h1]) + bww[r * kw + w1] - m) / s;
      Pw[r * kLdP + lane] = __float2bfloat16_rn(p0);
      Pw[r * kLdP + lane + 32] = __float2bfloat16_rn(p1);
    }
    __syncwarp();
    accumulate_pv<HD>(acc, Pw, Vs);
    __syncthreads();  // every warp is done with this K and V tile
  }

  // f32 slab (in the K and V tiles) -> bf16 rows
  float* Os = reinterpret_cast<float*>(smem + L::kK);
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(Os + warp * 16 * L::kLdO + n * 16, acc[n], L::kLdO,
                            wmma::mem_row_major);
  __syncthreads();
  bf16* ob = o + ((size_t)bh * T + q0) * HD;
  for (int j = tid; j < rows_valid * HD; j += kThreads) {
    const int row = j / HD, c = j % HD;
    ob[(size_t)row * HD + c] = __float2bfloat16_rn(Os[row * L::kLdO + c]);
  }
}

// Once per device: the shared-memory opt-in of both head dims at the largest
// grid (cudaFuncSetAttribute is per device).
cudaError_t device_setup() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(sam_attention_fwd<64>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout<64>::bytes(kMaxGrid, kMaxGrid));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(sam_attention_fwd<80>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout<80>::bytes(kMaxGrid, kMaxGrid));
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int HD>
void launch(const void* q, const void* k, const void* v, const void* rel_h,
            const void* rel_w, void* o, int BH, int T, int kh, int kw,
            cudaStream_t stream) {
  dim3 grid((T + kRows - 1) / kRows, BH);
  sam_attention_fwd<HD><<<grid, kThreads, Layout<HD>::bytes(kh, kw), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<bf16*>(o), T, kh, kw);
}

}  // namespace

VX_EXPORT_ERROR_STRING(voxactb_sam_attention_error_string)

// q, k, v, o [BH, T, hd] bf16; rel_h [BH, T, kh], rel_w [BH, T, kw] f32; all
// contiguous. T = kh * kw, 1 <= kh, kw <= 64, hd 64 or 80. q is pre-scaled.
// Returns a cudaError_t.
extern "C" int voxactb_sam_attention(const void* q, const void* k, const void* v,
                                     const void* rel_h, const void* rel_w, void* o,
                                     int BH, int T, int kh, int kw, int hd,
                                     void* stream_ptr) {
  if (kh < 1 || kw < 1 || kh > kMaxGrid || kw > kMaxGrid || kh * kw != T || BH < 1 ||
      BH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  VX_CHECK(device_setup());
  if (hd == 64) {
    launch<64>(q, k, v, rel_h, rel_w, o, BH, T, kh, kw, stream);
  } else if (hd == 80) {
    launch<80>(q, k, v, rel_h, rel_w, o, BH, T, kh, kw, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
