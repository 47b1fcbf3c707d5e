// Trainable attention for Hopper (sm_90a): forward with saved row
// log-sum-exp and in-kernel hash dropout, and the backward that recomputes
// the probabilities from it.
//
// Replaces voxactb_tpu/ops/pallas/flash_attention.py::flash_attention_train
// (TPU kernels `_train_fwd_kernel` and `_train_bwd_kernel`, mask `_hash_keep`),
// the Perceiver trunk's cross, self and decoder attention of the BC train step
// at bf16 with head dim 64. q arrives pre-scaled by 64^-1/2 (in bf16).
//
// What bounds it on an H100: operations. One self attention of the train step
// at batch 8 (64 heads of 2048 x 2048) is 69 GFLOP forward and 172 GFLOP
// backward against 50 MB of q/k/v/o/lse traffic.
//
// Numerics follow the TPU kernels' rounding points.
//   forward:  l = q k^T in f32 (keys past Tk masked), m = rowmax l,
//             s = rowsum exp(l - m), lse = m + log s,
//             A = bf16((exp(l - m) / s) * keep / (1 - dropout)),
//             O = bf16(A v) with f32 accumulation.
//   backward: P = exp(l - lse), dA = dO v^T, dP = dA * keep / (1 - dropout),
//             dS = bf16(P * (dP - r)), dQ = dS k, dK = dS^T q,
//             dV = bf16(P * keep / (1 - dropout))^T dO, each accumulated in
//             f32 and rounded to bf16 once.
// The row term r = sum_j P dP is summed from P and dP themselves, as on the
// TPU, in a pass of its own. The shortcut delta = rowsum(dO * O) equals it in
// exact arithmetic, but carries the bf16 rounding of O into every dS of the
// row: where k has a common component that cancels in dS k, that error does
// not cancel (measured on an H100: 24% of the largest dq on such inputs).
//
// The dropout mask is the TPU kernel's: the murmur3 finalizer of
// seed ^ index, kept where the hash >= thr, with
// index = ((bh * tq_pad) + row) * tk_pad + col in the TPU kernel's padded
// extents (passed in by the wrapper), so the mask is the same bit for bit
// whatever the tiling here. The index is formed in 64 bits; its high word,
// zero for every shape below 2^32 elements, is mixed into the hash instead
// of wrapping.
//
// The TPU kernel keeps a whole [q_block, Tk] logit block resident and revisits
// one dK/dV block along a sequential grid axis. Here nothing carries across
// blocks, so:
//  - forward: one block per 64 query rows makes two passes over the key tiles
//    (row max and sum folded online, then A and A v), as the inference kernel;
//  - backward, dQ kernel: one block per 64 query rows makes two passes over
//    the key tiles: the row term (written out for the dK/dV kernel), then dS
//    and dQ;
//  - backward, dK/dV kernel: one block per 64 keys makes one pass over the
//    query tiles with the transposed products (k q^T and v dO^T), so dK and dV
//    are whole sums of one block. No float atomics: a step is reproducible.
// Products run on WMMA 16x16x16 bf16 tiles with f32 accumulation.

#include "attention.cuh"

namespace {

using vx::bf16;
using namespace nvcuda;
using namespace vx::attn;

constexpr int kMaxDevices = 64;
constexpr int kRows = 16 * kWarps;  // query rows (or keys) per block

struct Mask {
  uint32_t seed;
  uint32_t thr;        // keep where hash >= thr; 0 keeps everything
  float scale;         // 1 / (1 - dropout)
  unsigned long long tq_pad, tk_pad;
};

__device__ __forceinline__ Mask load_mask(const long long* seed, uint32_t thr, float scale,
                                          int tq_pad, int tk_pad) {
  Mask m;
  m.seed = thr ? (uint32_t)(*seed) : 0u;
  m.thr = thr;
  m.scale = scale;
  m.tq_pad = (unsigned long long)tq_pad;
  m.tk_pad = (unsigned long long)tk_pad;
  return m;
}

// keep / (1 - dropout) of element (bh, row, col)
__device__ __forceinline__ float keep_scale(const Mask& m, int bh, int row, int col) {
  if (m.thr == 0u) return m.scale;
  const unsigned long long index =
      ((unsigned long long)bh * m.tq_pad + (unsigned long long)row) * m.tk_pad +
      (unsigned long long)col;
  uint32_t x = ((uint32_t)index ^ m.seed) ^ ((uint32_t)(index >> 32) * 0x9E3779B9u);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= m.thr ? m.scale : 0.f;
}

// four 16x16 f32 accumulators of one warp -> 16 rows of 64 bf16 in global
// memory (rows past rows_valid are not written), through the warp's f32 slab
__device__ __forceinline__ void store_rows_bf16(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, float* Sw, bf16* dst,
    int rows_valid, int lane) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(Sw + n * 16, acc[n], kLdS, wmma::mem_row_major);
  __syncwarp();
  for (int j = lane; j < 16 * (kHd / 2); j += 32) {
    const int r = j / (kHd / 2), c = (j % (kHd / 2)) * 2;
    if (r < rows_valid) {
      __nv_bfloat162 pair;
      pair.x = __float2bfloat16_rn(Sw[r * kLdS + c]);
      pair.y = __float2bfloat16_rn(Sw[r * kLdS + c + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * kHd + c) = pair;
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct FwdSmem {
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kRows * kLd * 2;
  static constexpr int kV = kK + kBk * kLd * 2;
  static constexpr int kS = kV + kBk * kLd * 2;
  static constexpr int kP = kS + kWarps * 16 * kLdS * 4;
  static constexpr int kRow = kP + kWarps * 16 * kLd * 2;  // row m, s
  static constexpr int kBytes = kRow + 2 * kRows * 4;
};

__global__ void __launch_bounds__(kThreads)
train_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const long long* __restrict__ seed,
          bf16* __restrict__ o, float* __restrict__ lse, int Tq, int Tk, uint32_t thr,
          float scale, int tq_pad, int tk_pad) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + FwdSmem::kQ);
  bf16* Ks = reinterpret_cast<bf16*>(smem + FwdSmem::kK);
  bf16* Vs = reinterpret_cast<bf16*>(smem + FwdSmem::kV);
  float* Ss = reinterpret_cast<float*>(smem + FwdSmem::kS);
  bf16* Ps = reinterpret_cast<bf16*>(smem + FwdSmem::kP);
  float* row_m = reinterpret_cast<float*>(smem + FwdSmem::kRow);
  float* row_s = row_m + kRows;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const bf16* qb = q + ((size_t)bh * Tq + q0) * kHd;
  const bf16* kb = k + (size_t)bh * Tk * kHd;
  const bf16* vb = v + (size_t)bh * Tk * kHd;
  const Mask mask = load_mask(seed, thr, scale, tq_pad, tk_pad);

  load_rows(Qs, qb, kRows, min(kRows, Tq - q0), tid, kThreads);
  if (tid < kRows) {
    row_m[tid] = -INFINITY;
    row_s[tid] = 0.f;
  }

  const bf16* Qw = Qs + warp * 16 * kLd;
  float* Sw = Ss + warp * 16 * kLdS;
  bf16* Pw = Ps + warp * 16 * kLd;
  float* pm = row_m + warp * 16;
  float* ps = row_s + warp * 16;
  const int n_tiles = (Tk + kBk - 1) / kBk;

  // pass 1: row max and sum of exp(l - max), folded online over the key tiles
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBk;
    __syncthreads();
    load_rows(Ks, kb + (size_t)k0 * kHd, kBk, Tk - k0, tid, kThreads);
    __syncthreads();
    logits_slab(Qw, Ks, Sw);
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
      __syncwarp();
      if (lane == 0) {
        float corr = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        ps[r] = ps[r] * corr + e;
        pm[r] = m_new;
      }
      __syncwarp();
    }
  }
  __syncwarp();
  if (lane < 16) {
    const int qi = q0 + warp * 16 + lane;
    if (qi < Tq) lse[(size_t)bh * Tq + qi] = pm[lane] + logf(ps[lane]);
  }

  // pass 2: A = bf16(exp(l - m) / s * keep / (1 - dropout)); O += A v
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBk;
    __syncthreads();
    load_rows(Ks, kb + (size_t)k0 * kHd, kBk, Tk - k0, tid, kThreads);
    load_rows(Vs, vb + (size_t)k0 * kHd, kBk, Tk - k0, tid, kThreads);
    __syncthreads();
    logits_slab(Qw, Ks, Sw);
    __syncwarp();
    const bool c0_ok = k0 + lane < Tk, c1_ok = k0 + lane + 32 < Tk;
    for (int r = 0; r < 16; ++r) {
      const int qi = q0 + warp * 16 + r;
      const float m = pm[r], s = ps[r];
      float p0 = c0_ok ? expf(Sw[r * kLdS + lane] - m) / s : 0.f;
      float p1 = c1_ok ? expf(Sw[r * kLdS + lane + 32] - m) / s : 0.f;
      p0 *= keep_scale(mask, bh, qi, k0 + lane);
      p1 *= keep_scale(mask, bh, qi, k0 + lane + 32);
      Pw[r * kLd + lane] = __float2bfloat16_rn(p0);
      Pw[r * kLd + lane + 32] = __float2bfloat16_rn(p1);
    }
    __syncwarp();
    accumulate_pv(acc, Pw, Vs);
  }
  store_rows_bf16(acc, Sw, o + ((size_t)bh * Tq + q0 + warp * 16) * kHd,
                  Tq - (q0 + warp * 16), lane);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdSmem {
  static constexpr int kTile = kRows * kLd * 2;  // one 64 x 64 bf16 tile
  static constexpr int kA = 0;             // dQ: q     dK/dV: k
  static constexpr int kB = kA + kTile;    // dQ: dO    dK/dV: v
  static constexpr int kC = kB + kTile;    // dQ: k     dK/dV: q
  static constexpr int kD = kC + kTile;    // dQ: v     dK/dV: dO
  static constexpr int kS = kD + kTile;                   // logits slabs
  static constexpr int kDa = kS + kWarps * 16 * kLdS * 4;  // dA slabs
  static constexpr int kDs = kDa + kWarps * 16 * kLdS * 4;  // bf16 dS per warp
  static constexpr int kAt = kDs + kWarps * 16 * kLd * 2;   // bf16 A per warp
  static constexpr int kRow = kAt + kWarps * 16 * kLd * 2;  // lse, delta
  static constexpr int kBytes = kRow + 2 * kRows * 4;
};

// dQ for 64 query rows; also writes their row term r = sum_j P dP (`delta`)
__global__ void __launch_bounds__(kThreads)
train_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ d_o,
             const float* __restrict__ lse,
             const long long* __restrict__ seed, bf16* __restrict__ dq,
             float* __restrict__ delta, int Tq, int Tk, uint32_t thr, float scale,
             int tq_pad, int tk_pad) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + BwdSmem::kA);
  bf16* dOs = reinterpret_cast<bf16*>(smem + BwdSmem::kB);
  bf16* Ks = reinterpret_cast<bf16*>(smem + BwdSmem::kC);
  bf16* Vs = reinterpret_cast<bf16*>(smem + BwdSmem::kD);
  float* Ss = reinterpret_cast<float*>(smem + BwdSmem::kS);
  float* As = reinterpret_cast<float*>(smem + BwdSmem::kDa);
  bf16* dSs = reinterpret_cast<bf16*>(smem + BwdSmem::kDs);
  float* row_lse = reinterpret_cast<float*>(smem + BwdSmem::kRow);
  float* row_delta = row_lse + kRows;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int rows_valid = min(kRows, Tq - q0);
  const size_t row0 = (size_t)bh * Tq + q0;
  const bf16* kb = k + (size_t)bh * Tk * kHd;
  const bf16* vb = v + (size_t)bh * Tk * kHd;
  const Mask mask = load_mask(seed, thr, scale, tq_pad, tk_pad);

  load_rows(Qs, q + row0 * kHd, kRows, rows_valid, tid, kThreads);
  load_rows(dOs, d_o + row0 * kHd, kRows, rows_valid, tid, kThreads);
  if (tid < kRows) {
    row_lse[tid] = tid < rows_valid ? lse[row0 + tid] : 0.f;
    row_delta[tid] = 0.f;
  }
  __syncthreads();

  const bf16* Qw = Qs + warp * 16 * kLd;
  const bf16* dOw = dOs + warp * 16 * kLd;
  float* Sw = Ss + warp * 16 * kLdS;
  float* Aw = As + warp * 16 * kLdS;
  bf16* dSw = dSs + warp * 16 * kLd;
  const int n_tiles = (Tk + kBk - 1) / kBk;

  // pass 1: the row term r = sum_j P dP of this warp's 16 rows
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBk;
    __syncthreads();
    load_rows(Ks, kb + (size_t)k0 * kHd, kBk, Tk - k0, tid, kThreads);
    load_rows(Vs, vb + (size_t)k0 * kHd, kBk, Tk - k0, tid, kThreads);
    __syncthreads();
    logits_slab(Qw, Ks, Sw);
    logits_slab(dOw, Vs, Aw);
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const float l = row_lse[row];
      float part = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const float p = k0 + c < Tk ? expf(Sw[r * kLdS + c] - l) : 0.f;
        part += p * (Aw[r * kLdS + c] * keep_scale(mask, bh, q0 + row, k0 + c));
      }
      part = warp_sum(part);
      if (lane == 0) row_delta[row] += part;
    }
    __syncwarp();
  }
  if (lane < 16) {
    const int row = warp * 16 + lane;
    if (row < rows_valid) delta[row0 + row] = row_delta[row];
  }

  // pass 2: dS and dQ
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBk;
    __syncthreads();
    load_rows(Ks, kb + (size_t)k0 * kHd, kBk, Tk - k0, tid, kThreads);
    load_rows(Vs, vb + (size_t)k0 * kHd, kBk, Tk - k0, tid, kThreads);
    __syncthreads();
    logits_slab(Qw, Ks, Sw);   // l = q k^T
    logits_slab(dOw, Vs, Aw);  // dA = dO v^T
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const float l = row_lse[row], dl = row_delta[row];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const float p = k0 + c < Tk ? expf(Sw[r * kLdS + c] - l) : 0.f;
        const float dp = Aw[r * kLdS + c] * keep_scale(mask, bh, q0 + row, k0 + c);
        dSw[r * kLd + c] = __float2bfloat16_rn(p * (dp - dl));
      }
    }
    __syncwarp();
    accumulate_pv(acc, dSw, Ks);  // dQ += dS k
  }
  store_rows_bf16(acc, Sw, dq + (row0 + warp * 16) * kHd, rows_valid - warp * 16, lane);
}

// dK and dV for 64 keys: one pass over the query tiles with the transposed
// products, each warp on 16 keys
__global__ void __launch_bounds__(kThreads)
train_bwd_dkv(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ d_o,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const long long* __restrict__ seed, bf16* __restrict__ dk,
              bf16* __restrict__ dv, int Tq, int Tk, uint32_t thr, float scale,
              int tq_pad, int tk_pad) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + BwdSmem::kA);
  bf16* Vs = reinterpret_cast<bf16*>(smem + BwdSmem::kB);
  bf16* Qs = reinterpret_cast<bf16*>(smem + BwdSmem::kC);
  bf16* dOs = reinterpret_cast<bf16*>(smem + BwdSmem::kD);
  float* Ss = reinterpret_cast<float*>(smem + BwdSmem::kS);
  float* As = reinterpret_cast<float*>(smem + BwdSmem::kDa);
  bf16* dSs = reinterpret_cast<bf16*>(smem + BwdSmem::kDs);
  bf16* Ats = reinterpret_cast<bf16*>(smem + BwdSmem::kAt);
  float* tile_lse = reinterpret_cast<float*>(smem + BwdSmem::kRow);
  float* tile_delta = tile_lse + kRows;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const int keys_valid = min(kRows, Tk - k0);
  const size_t key0 = (size_t)bh * Tk + k0;
  const bf16* qb = q + (size_t)bh * Tq * kHd;
  const bf16* dob = d_o + (size_t)bh * Tq * kHd;
  const Mask mask = load_mask(seed, thr, scale, tq_pad, tk_pad);

  load_rows(Ks, k + key0 * kHd, kRows, keys_valid, tid, kThreads);
  load_rows(Vs, v + key0 * kHd, kRows, keys_valid, tid, kThreads);

  const bf16* Kw = Ks + warp * 16 * kLd;
  const bf16* Vw = Vs + warp * 16 * kLd;
  float* Sw = Ss + warp * 16 * kLdS;
  float* Aw = As + warp * 16 * kLdS;
  bf16* dSw = dSs + warp * 16 * kLd;
  bf16* Atw = Ats + warp * 16 * kLd;
  const int n_tiles = (Tq + kRows - 1) / kRows;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_k[4], acc_v[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::fill_fragment(acc_k[n], 0.f);
    wmma::fill_fragment(acc_v[n], 0.f);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kRows;
    __syncthreads();
    load_rows(Qs, qb + (size_t)q0 * kHd, kRows, Tq - q0, tid, kThreads);
    load_rows(dOs, dob + (size_t)q0 * kHd, kRows, Tq - q0, tid, kThreads);
    if (tid < kRows) {
      const bool ok = q0 + tid < Tq;
      tile_lse[tid] = ok ? lse[(size_t)bh * Tq + q0 + tid] : 0.f;
      tile_delta[tid] = ok ? delta[(size_t)bh * Tq + q0 + tid] : 0.f;
    }
    __syncthreads();
    logits_slab(Kw, Qs, Sw);   // l^T = k q^T   (16 keys x 64 queries)
    logits_slab(Vw, dOs, Aw);  // dA^T = v dO^T
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int key = k0 + warp * 16 + r;
      const bool key_ok = key < Tk;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const int qi = q0 + c;
        const float p = key_ok && qi < Tq ? expf(Sw[r * kLdS + c] - tile_lse[c]) : 0.f;
        const float ks = keep_scale(mask, bh, qi, key);
        dSw[r * kLd + c] = __float2bfloat16_rn(p * (Aw[r * kLdS + c] * ks - tile_delta[c]));
        Atw[r * kLd + c] = __float2bfloat16_rn(p * ks);
      }
    }
    __syncwarp();
    accumulate_pv(acc_k, dSw, Qs);   // dK += dS^T q
    accumulate_pv(acc_v, Atw, dOs);  // dV += A^T dO
  }
  const int warp_valid = keys_valid - warp * 16;
  store_rows_bf16(acc_k, Sw, dk + (key0 + warp * 16) * kHd, warp_valid, lane);
  __syncwarp();
  store_rows_bf16(acc_v, Sw, dv + (key0 + warp * 16) * kHd, warp_valid, lane);
}

// Once per device: the shared-memory opt-in of the three kernels
// (cudaFuncSetAttribute is per device).
cudaError_t device_setup() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(train_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               FwdSmem::kBytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(train_bwd_dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BwdSmem::kBytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(train_bwd_dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BwdSmem::kBytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

VX_EXPORT_ERROR_STRING(voxactb_flash_attention_train_error_string)

// q [BH, Tq, 64], k, v [BH, Tk, 64] bf16 contiguous; seed: one int64 on the
// device holding a value below 2^32; o [BH, Tq, 64] bf16 and lse [BH, Tq] f32
// are written. thr = round(dropout * 2^32), scale = 1 / (1 - dropout);
// tq_pad, tk_pad: the padded extents of the mask index. Returns a cudaError_t.
extern "C" int voxactb_flash_attention_train_fwd(
    const void* q, const void* k, const void* v, const void* seed, void* o, void* lse,
    int BH, int Tq, int Tk, unsigned int thr, float scale, int tq_pad, int tk_pad,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  VX_CHECK(device_setup());
  dim3 grid((Tq + kRows - 1) / kRows, BH);
  train_fwd<<<grid, kThreads, FwdSmem::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const long long*>(seed),
      static_cast<bf16*>(o), static_cast<float*>(lse), Tq, Tk, thr, scale, tq_pad,
      tk_pad);
  return (int)cudaGetLastError();
}

// The backward of the call above: lse is its output, d_o the cotangent of o
// (bf16). dq [BH, Tq, 64], dk, dv [BH, Tk, 64] bf16 and the scratch delta
// [BH, Tq] f32 (the row term) are written. Two launches: dQ (which also forms
// delta), then dK/dV.
extern "C" int voxactb_flash_attention_train_bwd(
    const void* q, const void* k, const void* v, const void* d_o, const void* lse,
    const void* seed, void* dq, void* dk, void* dv, void* delta, int BH, int Tq, int Tk,
    unsigned int thr, float scale, int tq_pad, int tk_pad, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  VX_CHECK(device_setup());
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(d_o);
  const float* lsep = static_cast<const float*>(lse);
  const long long* seedp = static_cast<const long long*>(seed);
  float* deltap = static_cast<float*>(delta);
  dim3 grid_q((Tq + kRows - 1) / kRows, BH);
  train_bwd_dq<<<grid_q, kThreads, BwdSmem::kBytes, stream>>>(
      qp, kp, vp, dop, lsep, seedp, static_cast<bf16*>(dq),
      deltap, Tq, Tk, thr, scale, tq_pad, tk_pad);
  VX_CHECK(cudaGetLastError());
  dim3 grid_k((Tk + kRows - 1) / kRows, BH);
  train_bwd_dkv<<<grid_k, kThreads, BwdSmem::kBytes, stream>>>(
      qp, kp, vp, dop, lsep, deltap, seedp, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Tq, Tk, thr, scale, tq_pad, tk_pad);
  return (int)cudaGetLastError();
}
