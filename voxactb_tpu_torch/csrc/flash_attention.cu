// Inference attention for Hopper (sm_90a): softmax(q k^T + key mask) v.
//
// Replaces voxactb_tpu/ops/pallas/flash_attention.py::flash_attention (TPU
// kernel `_kernel`), the Perceiver trunk's cross, self and decoder attention
// at bf16 with head dim 64. q arrives pre-scaled by 64^-1/2 (in bf16).
//
// What bounds it on an H100: operations. Per act at 100^3, B = 1 it does about
// 60 GFLOP of bf16 products against ~20 MB of q/k/v/o traffic.
//
// Numerics follow the TPU kernel: f32 logits from bf16 operands, the row max
// m and the row sum s of exp(l - m) over the whole key axis, P =
// bf16(exp(l - m) / s) normalised BEFORE the cast, then P v with f32
// accumulation and a bf16 output. To get the whole-row m and s before forming
// any P, each q tile makes two passes over the keys: pass 1 folds m and s
// online (s rescaled when m grows; f32 sums in another order than the TPU's
// full-row sum), pass 2 recomputes the logits, forms P and accumulates P v.
// Keys past Tk (the ragged 77 + s^3 tail) are masked to -inf.
//
// Layout: 4 warps per block, each on 16 query rows and a share of the key
// tiles. Two schedules of the same kernel:
//  - 64-row blocks (kRowGroups = 4): the warps take 16 rows each and share
//    every key tile;
//  - 16-row blocks (kRowGroups = 1), taken when 64-row blocks would not fill
//    the SMs (cross attention at batch 1 has 32 of them): the warps share the
//    16 rows and take every 4th key tile. Their partial (m, s) are merged into
//    the whole-row m and s (with the corr / -inf guard) between the passes,
//    and their partial P v sums are added after pass 2, so P is still
//    normalised with the whole row before its cast.
// Products run on the tensor cores through WMMA 16x16x16 bf16 tiles; logits of
// a 16 x 64 slab go through shared memory for the row-wise softmax.

#include "attention.cuh"

namespace {

using vx::bf16;
using namespace nvcuda;
using namespace vx::attn;

constexpr int kMaxDevices = 64;

// kRowGroups warps share each key tile; kWarps / kRowGroups key groups take
// every kKeyGroups-th tile.
template <int kRowGroups>
struct Layout {
  static constexpr int kKeyGroups = kWarps / kRowGroups;
  static constexpr int kRows = 16 * kRowGroups;  // query rows per block
  static constexpr int kGroupThreads = 32 * kRowGroups;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kRows * kLd * 2;
  static constexpr int kV = kK + kKeyGroups * kBk * kLd * 2;
  static constexpr int kS = kV + kKeyGroups * kBk * kLd * 2;
  static constexpr int kP = kS + kWarps * 16 * kLdS * 4;
  static constexpr int kPart = kP + kWarps * 16 * kLd * 2;  // per-warp row m, s
  static constexpr int kRow = kPart + 2 * kWarps * 16 * 4;  // whole-row m, s
  static constexpr int kBytes = kRow + 2 * kRows * 4;
};

// barrier of the warps that share a key tile (named barrier 1 + group)
template <int kRowGroups>
__device__ __forceinline__ void group_sync(int group) {
  if (kRowGroups == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(32 * kRowGroups) : "memory");
  }
}

template <int kRowGroups>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ o, int Tq, int Tk) {
  using L = Layout<kRowGroups>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::kV);
  float* Ss = reinterpret_cast<float*>(smem + L::kS);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::kP);
  float* part_m = reinterpret_cast<float*>(smem + L::kPart);
  float* part_s = part_m + kWarps * 16;
  float* row_m = reinterpret_cast<float*>(smem + L::kRow);
  float* row_s = row_m + L::kRows;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = warp % kRowGroups, kg = warp / kRowGroups;
  const int gt = tid % L::kGroupThreads;  // thread index within the key group
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * L::kRows;
  const bf16* qb = q + ((size_t)bh * Tq + q0) * kHd;
  const bf16* kb = k + (size_t)bh * Tk * kHd;
  const bf16* vb = v + (size_t)bh * Tk * kHd;

  load_rows(Qs, qb, L::kRows, min(L::kRows, Tq - q0), tid, kThreads);
  if (lane < 16) {
    part_m[warp * 16 + lane] = -INFINITY;
    part_s[warp * 16 + lane] = 0.f;
  }
  __syncthreads();

  const bf16* Qw = Qs + rg * 16 * kLd;
  bf16* Kg = Ks + kg * kBk * kLd;
  bf16* Vg = Vs + kg * kBk * kLd;
  float* Sw = Ss + warp * 16 * kLdS;
  bf16* Pw = Ps + warp * 16 * kLd;
  float* pm = part_m + warp * 16;
  float* ps = part_s + warp * 16;
  const int n_tiles = (Tk + kBk - 1) / kBk;

  // pass 1: this key group's max and sum of exp(l - max) per row, folded online
  for (int t = kg; t < n_tiles; t += L::kKeyGroups) {
    const int k0 = t * kBk;
    load_rows(Kg, kb + (size_t)k0 * kHd, kBk, Tk - k0, gt, L::kGroupThreads);
    group_sync<kRowGroups>(kg);
    logits_slab(Qw, Kg, Sw);
    __syncwarp();
    const bool c0_ok = k0 + lane < Tk, c1_ok = k0 + lane + 32 < Tk;
    for (int r = 0; r < 16; ++r) {
      float l0 = c0_ok ? Sw[r * kLdS + lane] : -INFINITY;
      float l1 = c1_ok ? Sw[r * kLdS + lane + 32] : -INFINITY;
      float tile_max = warp_max(fmaxf(l0, l1));
      float m_old = pm[r];
      float m_new = fmaxf(m_old, tile_max);
      float e = (c0_ok ? expf(l0 - m_new) : 0.f) + (c1_ok ? expf(l1 - m_new) : 0.f);
      e = warp_sum(e);
      if (lane == 0) {
        float corr = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        ps[r] = ps[r] * corr + e;
        pm[r] = m_new;
      }
      __syncwarp();
    }
    group_sync<kRowGroups>(kg);
  }
  __syncthreads();

  // whole-row m and s from the key groups' partials (one group: unchanged)
  if (tid < L::kRows) {
    const int r_rg = tid / 16, r = tid % 16;
    float m = -INFINITY;
    for (int g = 0; g < L::kKeyGroups; ++g)
      m = fmaxf(m, part_m[(g * kRowGroups + r_rg) * 16 + r]);
    float s = 0.f;
    for (int g = 0; g < L::kKeyGroups; ++g) {
      const float mg = part_m[(g * kRowGroups + r_rg) * 16 + r];
      s += mg == -INFINITY ? 0.f : part_s[(g * kRowGroups + r_rg) * 16 + r] * expf(mg - m);
    }
    row_m[tid] = m;
    row_s[tid] = s;
  }
  __syncthreads();

  // pass 2: P = bf16(exp(l - m) / s); O += P v over this key group's tiles
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
  for (int t = kg; t < n_tiles; t += L::kKeyGroups) {
    const int k0 = t * kBk;
    load_rows(Kg, kb + (size_t)k0 * kHd, kBk, Tk - k0, gt, L::kGroupThreads);
    load_rows(Vg, vb + (size_t)k0 * kHd, kBk, Tk - k0, gt, L::kGroupThreads);
    group_sync<kRowGroups>(kg);
    logits_slab(Qw, Kg, Sw);
    __syncwarp();
    const bool c0_ok = k0 + lane < Tk, c1_ok = k0 + lane + 32 < Tk;
    for (int r = 0; r < 16; ++r) {
      float m = row_m[rg * 16 + r], s = row_s[rg * 16 + r];
      float p0 = c0_ok ? expf(Sw[r * kLdS + lane] - m) / s : 0.f;
      float p1 = c1_ok ? expf(Sw[r * kLdS + lane + 32] - m) / s : 0.f;
      Pw[r * kLd + lane] = __float2bfloat16_rn(p0);
      Pw[r * kLd + lane + 32] = __float2bfloat16_rn(p1);
    }
    __syncwarp();
    accumulate_pv(acc, Pw, Vg);
    group_sync<kRowGroups>(kg);
  }

  // each warp's O partial -> its f32 slab (reusing S); the key groups'
  // partials are added in group order and rounded to bf16 rows
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(Sw + n * 16, acc[n], kLdS, wmma::mem_row_major);
  __syncthreads();
  for (int j = tid; j < L::kRows * kHd; j += kThreads) {
    const int row = j / kHd, c = j % kHd;
    const int qi = q0 + row;
    if (qi >= Tq) break;
    const int r_rg = row / 16, r = row % 16;
    float sum = 0.f;
    for (int g = 0; g < L::kKeyGroups; ++g)
      sum += Ss[((g * kRowGroups + r_rg) * 16 + r) * kLdS + c];
    o[((size_t)bh * Tq + qi) * kHd + c] = __float2bfloat16_rn(sum);
  }
}

// Once per device: its SM count, and the shared-memory opt-in of both
// schedules (cudaFuncSetAttribute is per device).
cudaError_t device_setup(int* sms) {
  static int cached_sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached_sms[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_fwd<4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout<4>::kBytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_fwd<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout<1>::kBytes);
    if (err != cudaSuccess) return err;
    cached_sms[dev] = n;
  }
  *sms = cached_sms[dev];
  return cudaSuccess;
}

template <int kRowGroups>
void launch(const void* q, const void* k, const void* v, void* o, int BH, int Tq,
            int Tk, cudaStream_t stream) {
  using L = Layout<kRowGroups>;
  dim3 grid((Tq + L::kRows - 1) / L::kRows, BH);
  flash_fwd<kRowGroups><<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Tq, Tk);
}

}  // namespace

VX_EXPORT_ERROR_STRING(voxactb_flash_attention_error_string)

// q [BH, Tq, 64], k, v [BH, Tk, 64], o [BH, Tq, 64], all bf16 contiguous.
// rows_per_block: 64 or 16 picks a schedule; 0 takes 16-row blocks when
// 64-row blocks would number fewer than the SMs. Returns a cudaError_t.
extern "C" int voxactb_flash_attention(const void* q, const void* k, const void* v,
                                       void* o, int BH, int Tq, int Tk,
                                       int rows_per_block, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int sms = 0;
  VX_CHECK(device_setup(&sms));
  if (rows_per_block == 0) {
    const long blocks64 = (long)BH * ((Tq + 63) / 64);
    rows_per_block = blocks64 < sms ? 16 : 64;
  }
  if (rows_per_block == 64) {
    launch<4>(q, k, v, o, BH, Tq, Tk, stream);
  } else if (rows_per_block == 16) {
    launch<1>(q, k, v, o, BH, Tq, Tk, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
