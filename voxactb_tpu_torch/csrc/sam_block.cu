// The non-GEMM stretches of SAM's ViT block, for Hopper (sm_90a): four
// fused passes around the block's GEMMs and K7.
//
// Replaces no TPU kernel: the JAX package leaves these stretches to XLA. The
// port's eager PyTorch formulation (ops/cuda/sam_block.py's plain versions)
// makes each of them several passes, most in f32, over [4096, 1280] and
// [4096, 5120] tensors: about 1.8 GB of device traffic per ViT-H block and
// 55-58 GB per pass, more device time than the block's GEMMs and K7 together.
//
// What bounds them on an H100: bytes. Each kernel reads its input once and
// writes its output once, in the layout the next GEMM or K7 reads:
//   1. sam_ln_rows - LayerNorm of the bf16 residual stream, one warp per row
//      held in registers (16-byte loads), f32 statistics with the fast
//      variance E[x^2] - E[x]^2 clipped at 0. In a windowed block it writes
//      the window-partitioned, zero-padded rows that window_partition builds,
//      padding rows exactly 0.
//   2. sam_qkv_split - after the qkv GEMM: the bias added in bf16, K7's
//      [B*heads, T, hd] q*scale, k and v, and the f32 rel_h / rel_w terms of
//      the unscaled q against the rel-pos tables staged in shared memory. A
//      block copies a tile of rows with its lanes on neighbouring vectors,
//      staging q in shared memory; then one thread a (token, head) holds its
//      q in registers, and the lanes of a token read the same table rows, so
//      the staged tables broadcast.
//   3. sam_bias_gelu - fc1's bias and gelu_erf in one pass. GELU's rounded
//      result depends on one bf16 value, so sam_gelu_table works it out once
//      for all 2^16 of them with the formula's every rounding, and the pass
//      looks it up in shared memory: erfcf's instructions, not bytes, bounded
//      the formula computed per element.
//   4. sam_bias_residual - x + (y + b) for proj and fc2; for proj in a
//      windowed block it reads the window layout and drops the padding.
// Every rounding of the eager formulation is kept: where PyTorch rounds
// between two ops, __fadd_rn / __fmul_rn keep nvcc from contracting them into
// an FMA. Sums (LayerNorm's statistics, the rel terms' dots) run in another
// f32 order than PyTorch's reductions and cuBLAS.
//
// Every kernel launches on the caller's stream and allocates nothing, so a
// CUDA graph captures them as they are.

#include "common.cuh"

namespace {

using vx::bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLnVecs = 8;     // ln_rows: up to 8 vectors of 8 a lane, C <= 2048
constexpr int kMaxHeadVecs = 16;  // qkv_split: head dims 8 to 128
constexpr int kTabPad = 4;        // floats after each staged table row: rows stay 16-byte
                                  // aligned, neighbouring rows start in other banks
constexpr int kQPad = 8;          // bf16 after each staged q row (16 bytes): the 16-byte
                                  // loads of 8 neighbouring rows fall in distinct banks
constexpr int kTileTokens = 16;   // qkv_split: rows of the qkv GEMM a block takes
constexpr int kGeluTable = 1 << 16;  // bias_gelu: one entry per bf16 bit pattern
constexpr int kGeluThreads = 1024;
constexpr int kMaxSmem = 232448;  // the opt-in limit of a block's shared memory
constexpr int kMaxDevices = 64;
constexpr long long kMaxIndex = 0x7fffffff;  // rows, tokens and vectors are indexed in 32 bits

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Rounds each value to bf16.
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// A bf16 op's result: the f32 value rounded to bf16.
__device__ __forceinline__ float round_bf16(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}

// The grid token (b, i, j), as (b * H + i) * W + j, that row r of the
// window-partitioned layout holds, or -1 for a padding row; ws 0: the identity.
__device__ __forceinline__ int grid_token(int r, int H, int W, int ws) {
  if (ws == 0) return r;
  const int nwh = (H + ws - 1) / ws, nww = (W + ws - 1) / ws;
  const int p = r % (ws * ws), win = r / (ws * ws);
  const int wj = win % nww, wi = win / nww % nwh, b = win / nww / nwh;
  const int i = wi * ws + p / ws, j = wj * ws + p % ws;
  return i < H && j < W ? (b * H + i) * W + j : -1;
}

// The row of the window-partitioned layout that holds grid token g; ws 0:
// the identity.
__device__ __forceinline__ int window_row(int g, int H, int W, int ws) {
  if (ws == 0) return g;
  const int nwh = (H + ws - 1) / ws, nww = (W + ws - 1) / ws;
  const int j = g % W, i = g / W % H, b = g / W / H;
  return ((b * nwh + i / ws) * nww + j / ws) * (ws * ws) + (i % ws) * ws + j % ws;
}

// -- 1. LayerNorm rows ----------------------------------------------------------

// blocks.LayerNorm: mean = sum x / C, var = max(sum x^2 / C - mean^2, 0),
// y = bf16(((x - mean) * (rsqrt(var + eps) * w)) + b), each op rounded in f32.
// Lane l holds the vectors l, l + 32, ... of its warp's row.
template <int NV>
__global__ void __launch_bounds__(kThreads)
    sam_ln_rows(const bf16* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b, bf16* __restrict__ out, int rows, int C, int H,
                int W, int ws, float eps) {
  extern __shared__ __align__(16) float wb[];  // w then b, staged value by value
  for (int i = threadIdx.x; i < C; i += kThreads) {
    wb[i] = w[i];
    wb[C + i] = b[i];
  }
  __syncthreads();
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const int nvec = C / 8;
  uint4* dst = reinterpret_cast<uint4*>(out) + (long long)r * nvec;
  const int g = grid_token(r, H, W, ws);
  if (g < 0) {  // padding: zeros, as F.pad puts them after the norm
    for (int v = lane; v < nvec; v += 32) dst[v] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const uint4* src = reinterpret_cast<const uint4*>(x) + (long long)g * nvec;
  float f[NV][8];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lane + 32 * i;
    if (v < nvec) {
      unpack8(src[v], f[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s = __fadd_rn(s, f[i][e]);
        ss = __fadd_rn(ss, __fmul_rn(f[i][e], f[i][e]));
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  }
  // a mean is its sum times f32(1 / C), as PyTorch's reduction takes it
  const float inv_n = 1.f / (float)C;
  const float mean = __fmul_rn(s, inv_n);
  const float d = __fsub_rn(__fmul_rn(ss, inv_n), __fmul_rn(mean, mean));
  const float rs = rsqrtf(__fadd_rn(d < 0.f ? 0.f : d, eps));
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lane + 32 * i;
    if (v < nvec) {
      const float4* w4 = reinterpret_cast<const float4*>(wb) + 2 * v;
      const float4* b4 = reinterpret_cast<const float4*>(wb + C) + 2 * v;
      const float4 w0 = w4[0], w1 = w4[1], b0 = b4[0], b1 = b4[1];
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = __fadd_rn(__fmul_rn(__fsub_rn(f[i][e], mean), __fmul_rn(rs, wv[e])), bv[e]);
      dst[v] = pack8(o);
    }
  }
}

// -- 2. qkv split with the rel-pos terms -----------------------------------------

// out[k] = q . tab[pos - k + n - 1] for k in [0, n), G terms at a time stored
// as one G-wide vector (out is G-aligned); tab rows are HD + kTabPad apart.
template <int HD, int G>
__device__ __forceinline__ void rel_dots(const float (&q)[HD], const float* tab, int pos, int n,
                                         float* out) {
  constexpr int S = HD + kTabPad;
  for (int k0 = 0; k0 < n; k0 += G) {
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll
    for (int c = 0; c < HD; c += 4) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 t = *reinterpret_cast<const float4*>(tab + (pos - k0 - g + n - 1) * S + c);
        acc[g] = fmaf(q[c], t.x, acc[g]);
        acc[g] = fmaf(q[c + 1], t.y, acc[g]);
        acc[g] = fmaf(q[c + 2], t.z, acc[g]);
        acc[g] = fmaf(q[c + 3], t.w, acc[g]);
      }
    }
    if constexpr (G == 4)
      *reinterpret_cast<float4*>(out + k0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    else if constexpr (G == 2)
      *reinterpret_cast<float2*>(out + k0) = make_float2(acc[0], acc[1]);
    else
      out[k0] = acc[0];
  }
}

template <int HD>
__device__ __forceinline__ void rel_terms(const float (&q)[HD], const float* tab, int pos, int n,
                                          float* out) {
  if (n % 4 == 0)
    rel_dots<HD, 4>(q, tab, pos, n, out);
  else if (n % 2 == 0)
    rel_dots<HD, 2>(q, tab, pos, n, out);
  else
    rel_dots<HD, 1>(q, tab, pos, n, out);
}

// qkv: [B * T, 3C] rows of the qkv GEMM (no bias), T = kh * kw tokens of a
// kh x kw grid (a window or the whole image), C = heads * HD; bias [3C]. A
// block takes kTileTokens consecutive rows:
//   1. lanes on neighbouring 16-byte vectors of the rows (coalesced): q =
//      bf16(qkv + b) into shared memory and q_out = bf16(q * scale), k and v
//      bf16(qkv + b), each to row (b * heads + head) * T + t of its [B *
//      heads, T, HD] output (runs of HD values, whole sectors);
//   2. thread p takes token p / heads and head p % heads of the tile, its q
//      from shared memory into registers: rel_h[row, k] = q . tab_h[i - k +
//      kh - 1], rel_w[row, k] = q . tab_w[j - k + kw - 1] for the token's grid
//      position (i, j), or 0 without tables. The lanes of a token read the
//      same table rows (a broadcast).
template <int NV>
__global__ void __launch_bounds__(kThreads)
    sam_qkv_split(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                  const float* __restrict__ tab_h, const float* __restrict__ tab_w,
                  bf16* __restrict__ q_out, bf16* __restrict__ k_out, bf16* __restrict__ v_out,
                  float* __restrict__ rel_h, float* __restrict__ rel_w, long long tokens,
                  int heads, int kh, int kw, float scale) {
  constexpr int HD = NV * 8;
  constexpr int S = HD + kTabPad;
  constexpr int QS = HD + kQPad;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool rel = tab_h != nullptr;
  const int nh = 2 * kh - 1, nw = 2 * kw - 1;
  float* tab = reinterpret_cast<float*>(smem);
  bf16* qs = reinterpret_cast<bf16*>(smem + (rel ? (size_t)(nh + nw) * S * sizeof(float) : 0));
  if (rel) {
    for (int i = threadIdx.x; i < (nh + nw) * HD; i += kThreads) {
      const int row = i / HD;
      tab[row * S + i % HD] = row < nh ? tab_h[i] : tab_w[i - nh * HD];
    }
  }
  const int T = kh * kw, cv = heads * NV, nv3 = 3 * cv;  // vectors of q (k, v); of a row
  const long long tok0 = (long long)blockIdx.x * kTileTokens;
  const int nt = (int)min((long long)kTileTokens, tokens - tok0);
  // the tile's first token is token t0 of grid b0; the tile may run into the next grids
  const long long b0 = tok0 / T;
  const int t0 = (int)(tok0 - b0 * T);
  const uint4* src = reinterpret_cast<const uint4*>(qkv) + tok0 * nv3;
  for (int v = threadIdx.x; v < nv3; v += kThreads) {
    const int part = v / cv, j = v - part * cv, h = j / NV, o = j - h * NV;
    float b[8];
    unpack8(reinterpret_cast<const uint4*>(bias)[v], b);
    bf16* dst = part == 0 ? q_out : part == 1 ? k_out : v_out;
    uint4 in[kTileTokens];
#pragma unroll
    for (int lt = 0; lt < kTileTokens; ++lt)
      if (lt < nt) in[lt] = src[(long long)lt * nv3 + v];
    long long grid = b0;
    int t = t0;
#pragma unroll
    for (int lt = 0; lt < kTileTokens; ++lt, ++t) {
      if (lt >= nt) break;
      if (t == T) t = 0, ++grid;
      const long long row = (grid * heads + h) * T + t;
      float a[8], r[8];
      unpack8(in[lt], a);
#pragma unroll
      for (int e = 0; e < 8; ++e) r[e] = __fadd_rn(a[e], b[e]);
      const uint4 rounded = pack8(r);
      if (part == 0) {
        *reinterpret_cast<uint4*>(qs + (lt * heads + h) * QS + o * 8) = rounded;
        unpack8(rounded, r);
#pragma unroll
        for (int e = 0; e < 8; ++e) r[e] = __fmul_rn(r[e], scale);
        reinterpret_cast<uint4*>(dst + row * HD)[o] = pack8(r);
      } else {
        reinterpret_cast<uint4*>(dst + row * HD)[o] = rounded;
      }
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < nt * heads; p += kThreads) {
    const int lt = p / heads;
    long long grid = b0;
    int t = t0 + lt;
    while (t >= T) t -= T, ++grid;
    const long long row = (grid * heads + (p - lt * heads)) * T + t;
    float* rh = rel_h + row * kh;
    float* rw = rel_w + row * kw;
    if (!rel) {
      for (int k = 0; k < kh; ++k) rh[k] = 0.f;
      for (int k = 0; k < kw; ++k) rw[k] = 0.f;
      continue;
    }
    float q[HD];
    const uint4* qv = reinterpret_cast<const uint4*>(qs + p * QS);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float f[8];
      unpack8(qv[i], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) q[8 * i + e] = f[e];
    }
    const int i = t / kw;
    rel_terms<HD>(q, tab, i, kh, rh);
    rel_terms<HD>(q, tab + nh * S, t - i * kw, kw, rw);
  }
}

// -- 3. bias + GELU ----------------------------------------------------------------

// blocks.gelu_erf of a bf16 value x op by op in bf16:
// bf16(bf16(x * half) * bf16(erfc(bf16(-x * sqrt_half)))), half and sqrt_half
// the constants rounded to bf16.
__device__ __forceinline__ bf16 gelu_rounded(float x, float half, float sqrt_half) {
  const float hx = round_bf16(__fmul_rn(x, half));
  const float c = round_bf16(erfcf(round_bf16(__fmul_rn(-x, sqrt_half))));
  return __float2bfloat16_rn(__fmul_rn(hx, c));
}

// table[u]: gelu_rounded of the bf16 whose bits are u, for all 2^16 of them.
__global__ void sam_gelu_table(bf16* __restrict__ table, float half, float sqrt_half) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u < kGeluTable)
    table[u] = gelu_rounded(__bfloat162float(__ushort_as_bfloat16((unsigned short)u)), half,
                            sqrt_half);
}

// gelu_erf(y + b): x = bf16(y + b), then the table's entry for x's bits, so
// the result is the formula's, rounding for rounding. Persistent blocks stage
// the table (128 KB) in shared memory once and walk the 16-byte vectors.
__global__ void __launch_bounds__(kGeluThreads)
    sam_bias_gelu(const bf16* __restrict__ y, const bf16* __restrict__ bias,
                  const bf16* __restrict__ table, bf16* __restrict__ out, unsigned nvec,
                  unsigned fvec) {
  extern __shared__ __align__(16) unsigned short lut[];
  for (int i = threadIdx.x; i < kGeluTable / 8; i += kGeluThreads)
    reinterpret_cast<uint4*>(lut)[i] = reinterpret_cast<const uint4*>(table)[i];
  __syncthreads();
#pragma unroll 4
  for (unsigned v = blockIdx.x * kGeluThreads + threadIdx.x; v < nvec;
       v += gridDim.x * kGeluThreads) {
    float a[8], b[8];
    unpack8(reinterpret_cast<const uint4*>(y)[v], a);
    unpack8(reinterpret_cast<const uint4*>(bias)[v % fvec], b);
    uint4 o;
    unsigned short* os = reinterpret_cast<unsigned short*>(&o);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      os[e] = lut[__bfloat16_as_ushort(__float2bfloat16_rn(__fadd_rn(a[e], b[e])))];
    reinterpret_cast<uint4*>(out)[v] = o;
  }
}

// -- 4. bias + residual ------------------------------------------------------------

// out = bf16(x + bf16(y + b)) over x's [B * H * W, C] rows; y's row of grid
// token g is window_row(g) (ws 0: g). One warp a token, lane l on the vectors
// l, l + 32, ... of its row.
__global__ void __launch_bounds__(kThreads)
    sam_bias_residual(const bf16* __restrict__ x, const bf16* __restrict__ y,
                      const bf16* __restrict__ bias, bf16* __restrict__ out, int tokens,
                      int cvec, int H, int W, int ws) {
  const int g = blockIdx.x * kWarps + threadIdx.x / 32;
  if (g >= tokens) return;
  const long long xr = (long long)g * cvec, yr = (long long)window_row(g, H, W, ws) * cvec;
  for (int c = threadIdx.x % 32; c < cvec; c += 32) {
    float xa[8], ya[8], b[8], o[8];
    unpack8(reinterpret_cast<const uint4*>(x)[xr + c], xa);
    unpack8(reinterpret_cast<const uint4*>(y)[yr + c], ya);
    unpack8(reinterpret_cast<const uint4*>(bias)[c], b);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = __fadd_rn(xa[e], round_bf16(__fadd_rn(ya[e], b[e])));
    reinterpret_cast<uint4*>(out)[xr + c] = pack8(o);
  }
}

// -- launches ----------------------------------------------------------------------

#define VX_CASES_8(M) M(1) M(2) M(3) M(4) M(5) M(6) M(7) M(8)
#define VX_CASES_16(M) VX_CASES_8(M) M(9) M(10) M(11) M(12) M(13) M(14) M(15) M(16)

typedef void (*QkvKernel)(const bf16*, const bf16*, const float*, const float*, bf16*, bf16*,
                          bf16*, float*, float*, long long, int, int, int, float);

QkvKernel qkv_kernel(int nv) {
  switch (nv) {
#define VX_QKV_CASE(N) \
  case N:              \
    return sam_qkv_split<N>;
    VX_CASES_16(VX_QKV_CASE)
#undef VX_QKV_CASE
  }
  return nullptr;
}

// Once per device: every qkv_split instantiation and bias_gelu may take
// shared memory up to the opt-in limit (cudaFuncSetAttribute is per device),
// so no launch inside a graph's capture sets an attribute; the SM count.
cudaError_t device_setup(int* sms) {
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!sm_count[dev]) {
    for (int nv = 1; nv <= kMaxHeadVecs; ++nv) {
      err = cudaFuncSetAttribute(qkv_kernel(nv), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
      if (err != cudaSuccess) return err;
    }
    err = cudaFuncSetAttribute(sam_bias_gelu, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = sm_count[dev];
  return cudaSuccess;
}

long long blocks_for(long long n, int per_block) { return (n + per_block - 1) / per_block; }

}  // namespace

VX_EXPORT_ERROR_STRING(voxactb_sam_block_error_string)

// x [B * H * W, C] bf16 rows of a [B, H, W, C] grid; w, b [C] f32; out [rows, C]
// bf16: rows = B * H * W (ws 0) or the window layout's B * ceil(H / ws) *
// ceil(W / ws) * ws * ws, under 2^31. C a multiple of 8 up to 2048; x and out
// 16-byte aligned. Returns a cudaError_t.
extern "C" int voxactb_sam_ln_rows(const void* x, const void* w, const void* b, void* out,
                                   long long rows, int C, int H, int W, int ws, float eps,
                                   void* stream_ptr) {
  const int nv = (C / 8 + 31) / 32;
  if (C < 8 || C % 8 || nv > kMaxLnVecs || rows < 1 || rows > kMaxIndex || ws < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid((unsigned)blocks_for(rows, kWarps));
  const size_t smem = 2 * C * sizeof(float);  // at most 16 KB
  const bf16* xs = static_cast<const bf16*>(x);
  const float* ws_ = static_cast<const float*>(w);
  const float* bs = static_cast<const float*>(b);
  bf16* o = static_cast<bf16*>(out);
  switch (nv) {
#define VX_LN_CASE(N)                                                                 \
  case N:                                                                             \
    sam_ln_rows<N><<<grid, kThreads, smem, stream>>>(xs, ws_, bs, o, rows, C, H, W, ws, eps); \
    break;
    VX_CASES_8(VX_LN_CASE)
#undef VX_LN_CASE
  }
  return (int)cudaGetLastError();
}

// qkv [B * kh * kw, 3C] bf16, bias [3C] bf16, C = heads * hd; tab_h [2kh - 1,
// hd], tab_w [2kw - 1, hd] f32, or both null (the terms are then 0); q, k, v
// [B * heads, kh * kw, hd] bf16, rel_h [..., kh], rel_w [..., kw] f32. hd a
// multiple of 8 up to 128; tables and staged q within the shared memory's
// opt-in limit; bf16 pointers and f32 outputs 16-byte aligned. Returns a
// cudaError_t.
extern "C" int voxactb_sam_qkv_split(const void* qkv, const void* bias, const void* tab_h,
                                     const void* tab_w, void* q, void* k, void* v, void* rel_h,
                                     void* rel_w, int batch, int heads, int hd, int kh, int kw,
                                     float scale, void* stream_ptr) {
  const int nv = hd / 8;
  if (hd % 8 || nv < 1 || nv > kMaxHeadVecs || batch < 1 || heads < 1 || kh < 1 || kw < 1 ||
      (tab_h == nullptr) != (tab_w == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long smem =
      (tab_h ? (long long)(2 * kh - 1 + 2 * kw - 1) * (hd + kTabPad) * (long long)sizeof(float)
             : 0) +
      (long long)kTileTokens * heads * (hd + kQPad) * (long long)sizeof(bf16);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int sms = 0;
  VX_CHECK(device_setup(&sms));
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long tokens = (long long)batch * kh * kw;
  qkv_kernel(nv)<<<(unsigned)blocks_for(tokens, kTileTokens), kThreads, (size_t)smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
      static_cast<const float*>(tab_h), static_cast<const float*>(tab_w), static_cast<bf16*>(q),
      static_cast<bf16*>(k), static_cast<bf16*>(v), static_cast<float*>(rel_h),
      static_cast<float*>(rel_w), tokens, heads, kh, kw, scale);
  return (int)cudaGetLastError();
}

// table [2^16] bf16: the GELU of every bf16 input, as bias_gelu reads it.
// Returns a cudaError_t.
extern "C" int voxactb_sam_gelu_table(void* table, float half, float sqrt_half,
                                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  sam_gelu_table<<<kGeluTable / kThreads, kThreads, 0, stream>>>(static_cast<bf16*>(table), half,
                                                                 sqrt_half);
  return (int)cudaGetLastError();
}

// y, out [n / F, F] bf16, bias [F] bf16, table from voxactb_sam_gelu_table; F
// a multiple of 8; pointers 16-byte aligned. Returns a cudaError_t.
extern "C" int voxactb_sam_bias_gelu(const void* y, const void* bias, const void* table,
                                     void* out, long long n, int F, void* stream_ptr) {
  if (F < 8 || F % 8 || n < 1 || n % F || n / 8 > kMaxIndex) return (int)cudaErrorInvalidValue;
  int sms = 0;
  VX_CHECK(device_setup(&sms));
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long nvec = n / 8, blocks = blocks_for(nvec, kGeluThreads);
  sam_bias_gelu<<<(unsigned)(blocks < sms ? blocks : sms), kGeluThreads,
                  kGeluTable * sizeof(bf16), stream>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(table), static_cast<bf16*>(out), (unsigned)nvec, F / 8);
  return (int)cudaGetLastError();
}

// x, out [B * H * W, C] bf16 rows of a [B, H, W, C] grid; y [B * H * W, C]
// (ws 0) or the window layout's rows (ws > 0) bf16; bias [C] bf16. C a
// multiple of 8; pointers 16-byte aligned. Returns a cudaError_t.
extern "C" int voxactb_sam_bias_residual(const void* x, const void* y, const void* bias,
                                         void* out, long long tokens, int C, int H, int W,
                                         int ws, void* stream_ptr) {
  if (C < 8 || C % 8 || tokens < 1 || H < 1 || W < 1 || ws < 0 ||
      tokens % ((long long)H * W) || tokens > kMaxIndex / (ws > 1 ? ws * ws : 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  sam_bias_residual<<<(unsigned)blocks_for(tokens, kWarps), kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), (int)tokens, C / 8, H, W, ws);
  return (int)cudaGetLastError();
}
