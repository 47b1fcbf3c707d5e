// Standalone soft-argmax (T = 0.01) + global max of a cubic grid for Hopper
// (sm_90a).
//
// Replaces voxactb_tpu/ops/pallas/stats_head.py::stats_head (TPU kernel
// `_kernel` under `_stats_head_single`), with that kernel's arithmetic:
// logits l = x * 100 (XLA's form of x / 0.01), weights exp(l - max l),
// positions (i * f32(1/(n-1))) * 2 - 1 rounded once (the fused multiply-add
// XLA emits), expectations = sums * (1 / denominator), and the global max of
// x. (x, y, z) integrate the (h, d, w) indices: the reference's meshgrid-'xy'
// quirk. x * 100 is monotone, so the largest logit is 100 times the largest x:
// the running max is kept in x's units, it is the global max, and a weight is
// exp((x - m) / T) = 2^(x k - m k) with k = log2(e) / T, one ex2 per element.
// Sums differ from the TPU's only in f32 summation order and ex2's rounding.
//
// What bounds it on an H100: bytes. At [1, 100^3, 64] bf16 it reads 128 MB
// (0.038 ms at 3.35 TB/s) for 64 M elements of about eight instructions each;
// the decoder grid [B, 20^3, 128] (2 MB a sample) is bound by the launch, one
// trip to memory and the merge.
//
// Design:
//  - Persistent CTAs, G per sample (stats_head_grid in ops/cuda/stats_head.py:
//    kCtasPerSm per SM over the batch, at most one per tile), CTA g taking
//    the tiles g, g + G, ... of its sample. A tile is kRowsPerThread row
//    lanes deep: thread (row lane r, vector v) holds the 16 bytes (8 bf16 or
//    4 f32 channels) v of rows r, r + L, r + 2L, r + 3L of the tile, so a
//    tile is one contiguous run of memory, consecutive threads on consecutive
//    16-byte vectors. Each thread copies its own vectors into a ring of
//    kStages tiles in shared memory by cp.async and reads back only those, so
//    no barrier is needed per tile: kStages - 1 tiles (three of 12-16 KB)
//    stay in flight while one is folded, two CTAs per SM. (Six stages were
//    slower at every shape.)
//  - Positions per row from its index, by two multiply-shift divisions by n
//    (no divide instruction), once per row and thread: a thread's 8 or 4
//    channels share them.
//  - Per tile a thread takes the max of its rows per channel first, rescales
//    its running sums where that raises its running max, then takes one ex2
//    per element.
//  - Merges, all in the same launch, of entries [5, C] (common.cuh's partial
//    layout: max, sum e, sum e * lin[h], * lin[d], * lin[w]) per channel
//    (merge_entries): one thread per channel and part, each part taking every
//    P-th entry in order with eight entries' loads in flight, then part 0 the
//    other parts. First the CTA's L row lanes into its partial; then the CTA
//    that arrives last of each group of kGroupCtas CTAs merges the group's
//    partials, and the group merger that arrives last merges the sample's
//    group partials, writes kp and gmax. Each level is found by an arrival
//    counter (one fence, by the thread that counts), which its last arriver
//    sets back to 0 for the next launch. One level would leave one CTA
//    reading every partial (330 KB at 100^3). No float atomics and a fixed
//    merge order: two launches give the same bits. (The partials merged by
//    common.cuh's stats_combine in a second launch instead were slower at
//    three of the five shapes and no faster than the gap between launches
//    at the other two.)
//  - The rescale and the merges are common.cuh's ex2 form (stat_raise,
//    stat_merge_ex2) on its Stat.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using vx::bf16;
using vx::kExp2Scale;
using vx::Stat;

constexpr int kCtasPerSm = 2;      // resident CTAs per SM (read by stats_head_grid)
constexpr int kMaxThreads = 256;   // threads of a CTA, at most
constexpr int kRowsPerThread = 4;  // rows of a tile per thread
constexpr int kStages = 4;         // tiles in a CTA's ring: kStages - 1 in flight while one is folded
constexpr int kGroupCtas = 16;     // CTAs whose partials the first level of the merge takes

// faults that chip_smoke.py plants through the real kernel
constexpr int kFaultSkipCta = 1;       // CTA 0 of every sample folds no tile
constexpr int kFaultNoRescale = 2;     // the merges of partials add unrescaled sums
constexpr int kFaultStaleCounter = 3;  // the arrival counters are not set back to 0

constexpr int pow2_floor(int v) {
  int p = 1;
  while (2 * p <= v) p *= 2;
  return p;
}

template <typename T, int C>
struct Shape {
  static constexpr int kVec = 16 / (int)sizeof(T);  // channels per 16-byte vector
  static constexpr int kGroups = C / kVec;          // vectors per row
  static constexpr int kLanes = pow2_floor(kMaxThreads / kGroups);  // row lanes
  static constexpr int kThreads = kGroups * kLanes;
  static constexpr int kTileRows = kRowsPerThread * kLanes;
  static_assert(C % kVec == 0 && kLanes >= 2, "a row is whole vectors; two lanes at least");
};

// A thread's statistics of its V channels; mk = m * k, the running max in
// the exponent's units
template <int V>
struct Acc {
  float m[V], mk[V], s[V], wx[V], wd[V], wz[V];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[j] = mk[j] = -INFINITY;
      s[j] = wx[j] = wd[j] = wz[j] = 0.f;
    }
  }

  // the five fields of channels c0 .. c0 + V - 1 into a [5, C] block
  template <int C>
  __device__ __forceinline__ void store(float* dst, int c0) const {
    put(dst + 0 * C + c0, m);
    put(dst + 1 * C + c0, s);
    put(dst + 2 * C + c0, wx);
    put(dst + 3 * C + c0, wd);
    put(dst + 4 * C + c0, wz);
  }

  __device__ __forceinline__ static void put(float* dst, const float (&f)[V]) {
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(dst + j) = make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
  }
};

// the 8 bf16 or 4 f32 channels of a 16-byte vector
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8], bf16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4], float) {
  v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
}

// The K entries [5, C] at src (in shared memory, or in global memory read
// through the L2) merged per channel: thread (c = tid % C, p = tid / C) of P
// = kThreads / C takes entries p, p + P, ... in order, with the loads of
// eight of them in flight at once; then thread (c, 0) merges parts 1 .. P-1
// in order, through `red` [P - 1, 5, C]. The result is in the threads of p =
// 0; every thread of the CTA takes part. rescale false plants a fault.
template <int C, int kThreads, bool global>
__device__ __forceinline__ Stat merge_entries(const float* src, int K, float* red,
                                              bool rescale) {
  constexpr int P = kThreads / C, kAhead = 8;
  static_assert(P * C == kThreads, "whole parts");
  const int c = threadIdx.x % C, p = threadIdx.x / C;
  Stat st = vx::stat_empty();
  for (int k0 = p; k0 < K; k0 += kAhead * P) {
    float f[kAhead][5];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int k = k0 + u * P;
      if (k < K) {
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          const float* q = src + ((size_t)k * 5 + i) * C + c;
          f[u][i] = global ? __ldcg(q) : *q;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (k0 + u * P < K)
        vx::stat_merge_ex2(st, Stat{f[u][0], f[u][1], f[u][2], f[u][3], f[u][4]}, rescale);
    }
  }
  if (P > 1) {
    if (p > 0) vx::stat_store(red + (size_t)(p - 1) * 5 * C, C, c, st);
    __syncthreads();
    if (p == 0) {
#pragma unroll
      for (int j = 0; j < P - 1; ++j)
        vx::stat_merge_ex2(st, vx::stat_load(red + (size_t)j * 5 * C, C, c), rescale);
    }
    __syncthreads();
  }
  return st;
}

// The CTA counts its arrival on `counter`, after the partial its threads
// stored: the barrier orders those stores before thread 0's fence, which
// makes them visible at the device's scope before the count (one fence a
// CTA; an acq_rel fence in its place measured the same). True in the CTA
// that arrives last of `expected`, whose second fence makes every partial
// visible to it; it sets the counter back to 0 (unless `reset` is false, a
// planted fault).
__device__ __forceinline__ bool arrive(int* counter, int expected, bool reset, int& flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    flag = atomicAdd(counter, 1) == expected - 1;
    if (flag) {
      if (reset) *counter = 0;
      __threadfence();
    }
  }
  __syncthreads();
  return flag;
}

// x [B, n^3, C] -> part [B, G, 5, C]; then a two-level merge in the same
// launch: the last CTA of each group of kGroupCtas CTAs merges the group's
// partials into part[b, G + group], and the last group's merger merges
// those into kp [B, 3C] and gmax [B, C].
// arrivals [B, 1 + groups]: the sample's counter, then the groups'.
template <typename T, int C>
__global__ void __launch_bounds__(Shape<T, C>::kThreads, kCtasPerSm)
stats_head_kernel(const T* __restrict__ x, int n, int G, float* __restrict__ part,
                  int* __restrict__ arrivals, float* __restrict__ kp,
                  float* __restrict__ gmax, int fault) {
  using S = Shape<T, C>;
  constexpr int V = S::kVec, L = S::kLanes, Q = kRowsPerThread, TR = S::kTileRows;
  // a ring of kStages tiles; thread t's row q of stage s at [s][q][t], so
  // that each thread reads back only what its own cp.async wrote. The lanes'
  // merge reuses it once the last tile is folded.
  extern __shared__ __align__(16) uint4 ring[];
  __shared__ int last;

  const int b = blockIdx.y, tid = threadIdx.x;
  const int vec = tid % S::kGroups, r = tid / S::kGroups, c0 = vec * V;
  const unsigned rows = (unsigned)n * n * n;  // the wrapper keeps n^3 below 2^31
  const int tiles = (int)((rows + TR - 1) / TR);
  const uint4* xb = reinterpret_cast<const uint4*>(x + (size_t)b * rows * C) + vec;
  // v / n = (v * magic) >> shift with magic = ceil(2^shift / n), shift = 32 +
  // ceil(log2 n): exact for every v < 2^32
  const int shift = 32 + (n > 1 ? 32 - __clz(n - 1) : 0);
  const unsigned long long magic = ((1ull << shift) + n - 1) / n;
  // lin(i) = (i * f32(1/(n-1))) * 2 - 1 with one rounding
  const float inv2 = 2.f * (1.f / (float)max(n - 1, 1));

  // the thread's rows of tile i into stage s (rows past the grid not read),
  // as one commit group; an empty group past the last tile
  auto issue = [&](int s, int i) {
    if (i < tiles) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const unsigned v = (unsigned)i * TR + r + L * q;
        if (v < rows)
          vx::hopper::cp_async_16(vx::hopper::smem_u32(&ring[(s * Q + q) * S::kThreads + tid]),
                                  xb + (size_t)v * S::kGroups);
      }
    }
    vx::hopper::cp_async_commit();
  };
  const int first = fault == kFaultSkipCta && blockIdx.x == 0 ? tiles : blockIdx.x;
#pragma unroll
  for (int s = 0; s < kStages; ++s) issue(s, first + s * G);

  Acc<V> acc;
  acc.clear();
  for (int i = first, it = 0; i < tiles; i += G, ++it) {
    const int s = it % kStages;
    vx::hopper::cp_async_wait_group<kStages - 1>();  // this tile's group has landed
    uint4 cur[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) cur[q] = ring[(s * Q + q) * S::kThreads + tid];
    float mt[V];  // the max of the thread's rows of the tile, per channel
#pragma unroll
    for (int j = 0; j < V; ++j) mt[j] = -INFINITY;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if ((unsigned)i * TR + r + L * q >= rows) continue;
      float xv[V];
      unpack(cur[q], xv, T());
#pragma unroll
      for (int j = 0; j < V; ++j) mt[j] = fmaxf(mt[j], xv[j]);
    }
    // the tile's max first: where it raises the running max, the sums are
    // rescaled to it by 2^(mk - mt k) (0 on the first, mk = -inf)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      acc.m[j] = fmaxf(acc.m[j], mt[j]);
      vx::stat_raise(mt[j] * kExp2Scale, acc.mk[j], acc.s[j], acc.wx[j], acc.wd[j], acc.wz[j]);
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const unsigned v = (unsigned)i * TR + r + L * q;
      if (v >= rows) continue;
      const unsigned vn = (unsigned)(((unsigned long long)v * magic) >> shift);  // v / n
      const unsigned d = (unsigned)(((unsigned long long)vn * magic) >> shift);  // v / n^2
      const float px = fmaf((float)(vn - d * n), inv2, -1.f);  // lin[h]
      const float py = fmaf((float)d, inv2, -1.f);             // lin[d]
      const float pz = fmaf((float)(v - vn * n), inv2, -1.f);  // lin[w]
      float xv[V];
      unpack(cur[q], xv, T());
#pragma unroll
      for (int j = 0; j < V; ++j) {
        // exp((x - m) / T) = 2^(x k - m k)
        const float e = vx::hopper::exp2_approx(fmaf(xv[j], kExp2Scale, -acc.mk[j]));
        acc.s[j] += e;
        acc.wx[j] = fmaf(e, px, acc.wx[j]);
        acc.wd[j] = fmaf(e, py, acc.wd[j]);
        acc.wz[j] = fmaf(e, pz, acc.wz[j]);
      }
    }
    issue(s, i + kStages * G);  // the stage just read takes the tile kStages ahead
  }
  vx::hopper::cp_async_wait_group<0>();
  __syncthreads();  // every thread is done with the ring

  // the row lanes' statistics as L entries [5, C], merged per channel
  float* lanes = reinterpret_cast<float*>(ring);
  float* red = lanes + L * 5 * C;
  acc.template store<C>(lanes + r * 5 * C, c0);
  __syncthreads();
  Stat st = merge_entries<C, S::kThreads, false>(lanes, L, red, true);
  const int groups = (G + kGroupCtas - 1) / kGroupCtas, grp = blockIdx.x / kGroupCtas;
  // a sample's partials: its G CTAs', then its groups'
  float* part_b = part + (size_t)b * (G + groups) * 5 * C;
  const bool lead = tid < C;  // the threads that hold a channel's result
  if (lead) vx::stat_store(part_b + (size_t)blockIdx.x * 5 * C, C, tid, st);

  const bool rescale = fault != kFaultNoRescale, reset = fault != kFaultStaleCounter;
  int* arrivals_b = arrivals + (size_t)b * (1 + groups);
  const int in_group = min(kGroupCtas, G - grp * kGroupCtas);
  if (!arrive(arrivals_b + 1 + grp, in_group, reset, last)) return;
  st = merge_entries<C, S::kThreads, true>(part_b + (size_t)grp * kGroupCtas * 5 * C, in_group,
                                           red, rescale);
  if (lead) vx::stat_store(part_b + (size_t)(G + grp) * 5 * C, C, tid, st);
  if (!arrive(arrivals_b, groups, reset, last)) return;
  st = merge_entries<C, S::kThreads, true>(part_b + (size_t)G * 5 * C, groups, red, rescale);
  if (lead) {
    const float inv = 1.f / st.s;
    kp[(size_t)b * 3 * C + 3 * tid + 0] = st.wx * inv;
    kp[(size_t)b * 3 * C + 3 * tid + 1] = st.wd * inv;
    kp[(size_t)b * 3 * C + 3 * tid + 2] = st.wz * inv;
    gmax[(size_t)b * C + tid] = st.m;
  }
}

// the ring's bytes, which the lanes' merge reuses
template <typename T, int C>
constexpr int smem_bytes() {
  using S = Shape<T, C>;
  static_assert((S::kLanes + S::kThreads / C) * 5 * C * 4 <= kStages * kRowsPerThread *
                    S::kThreads * 16, "the lanes' merge fits in the ring");
  return kStages * kRowsPerThread * S::kThreads * 16;
}

template <typename T, int C>
int prepare() {
  return (int)cudaFuncSetAttribute(stats_head_kernel<T, C>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes<T, C>());
}

template <typename T, int C>
int run(const void* x, int B, int n, int G, float* part, int* arrivals, float* kp,
        float* gmax, int fault, cudaStream_t stream) {
  using S = Shape<T, C>;
  stats_head_kernel<T, C><<<dim3(G, B), S::kThreads, smem_bytes<T, C>(), stream>>>(
      static_cast<const T*>(x), n, G, part, arrivals, kp, gmax, fault);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, int B, int n, int C, int G, float* part, int* arrivals,
             float* kp, float* gmax, int fault, cudaStream_t stream) {
  switch (C) {
    case 64: return run<T, 64>(x, B, n, G, part, arrivals, kp, gmax, fault, stream);
    case 128: return run<T, 128>(x, B, n, G, part, arrivals, kp, gmax, fault, stream);
    case 192: return run<T, 192>(x, B, n, G, part, arrivals, kp, gmax, fault, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

VX_EXPORT_ERROR_STRING(voxactb_stats_head_error_string)

// x [B, n, n, n, C] f32 (x_is_bf16 = 0) or bf16 (1), 16-byte aligned, C in
// 64, 128, 192; G CTAs per sample (stats_head_grid); after
// voxactb_stats_head_prepare for C and the dtype on this device.
// Scratch: part [B, G + ceil(G / kGroupCtas), 5, C] f32; arrivals [B, 1 +
// ceil(G / kGroupCtas)] int32, 0 before the launch and after it (each level's
// last CTA sets its counter back).
// Outputs: kp [B, 3C] f32 ((x, y, z) triplets, channel major), gmax [B, C] f32.
// fault: 0, or one of the kFault* faults above.
// Returns a cudaError_t.
// The kernel's shared-memory limit raised to its ring on the current device,
// for C and the dtype; once before the first launch. Returns a cudaError_t.
extern "C" int voxactb_stats_head_prepare(int C, int x_is_bf16) {
  switch (C) {
    case 64: return x_is_bf16 ? prepare<bf16, 64>() : prepare<float, 64>();
    case 128: return x_is_bf16 ? prepare<bf16, 128>() : prepare<float, 128>();
    case 192: return x_is_bf16 ? prepare<bf16, 192>() : prepare<float, 192>();
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int voxactb_stats_head(const void* x, int x_is_bf16, int B, int n, int C, int G,
                                  float* part, int* arrivals, float* kp, float* gmax,
                                  int fault, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return x_is_bf16 ? dispatch<bf16>(x, B, n, C, G, part, arrivals, kp, gmax, fault, stream)
                   : dispatch<float>(x, B, n, C, G, part, arrivals, kp, gmax, fault, stream);
}
