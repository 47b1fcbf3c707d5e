// Fused decoder tail for Hopper (sm_90a): skip-concat k3 conv + lrelu, the k3
// trans head(s) and the soft-argmax / global-max stats over u.
//
// Replaces voxactb_tpu/ops/pallas/decoder_head_v2.py::decoder_head_v2 (TPU
// kernel `_kernel_with_bias`), and with it the same function under the TPU's
// other schedules, decoder_head.py::decoder_head (v1) and
// decoder_head_v2c.py::decoder_head_v2c.
//
// What bounds it on an H100: operations. At N = 100, B = 1 the u conv is about
// 442 GFLOP (1e6 voxels x 27 taps x 128 -> 64 channels) against 256 MB of
// d0/u0 reads; the trans conv adds 3.5 GFLOP.
//
// Design (simple first):
//   1. conv3d_igemm<128, 3, 1, 1> (common.cuh) - u = lrelu(bf16(conv(cat[d0,
//      u0]) + bf)) on the tensor cores, replicate padding as an index clamp
//      in all three axes (the TPU ring clamps plane -1 to 0 and N to N-1);
//      u is written to a bf16 scratch grid.
//   2. dec_trans_stats - one warp per voxel, two channels per lane: trans =
//      sum over the 27 clamped neighbours of u . wt + bt, kept in f32 (not
//      rounded to bf16, as the TPU kernel); the centre values fold into a
//      per-block soft-argmax partial per channel.
//   3. stats_combine (common.cuh) - merge the partials into kp / gmax.

#include "common.cuh"

namespace {

using vx::bf16;

constexpr int kC = 64;
constexpr int kWarps = 8;
constexpr int kVoxPerWarp = 64;
constexpr int kVoxPerBlock = kWarps * kVoxPerWarp;

template <int T>
__global__ void __launch_bounds__(kWarps * 32)
dec_trans_stats(const bf16* __restrict__ u, const bf16* __restrict__ wt,
                const float* __restrict__ bt, const float* __restrict__ lin, int N,
                int P, float* __restrict__ trans, float* __restrict__ part) {
  __shared__ float w_s[27][kC][T];
  __shared__ float sh_stat[kWarps][vx::kStatFields][kC];

  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long n3 = (long long)N * N * N;
  for (int j = tid; j < 27 * kC * T; j += blockDim.x)
    (&w_s[0][0][0])[j] = __bfloat162float(wt[j]);
  __syncthreads();

  const int c0 = 2 * lane;
  vx::Stat st0 = vx::stat_empty(), st1 = vx::stat_empty();
  const bf16* ub = u + (size_t)b * n3 * kC;
  const long long vbase = (long long)blockIdx.x * kVoxPerBlock + warp * kVoxPerWarp;
  for (int i = 0; i < kVoxPerWarp; ++i) {
    long long v = vbase + i;
    if (v >= n3) break;
    int z = (int)(v / ((long long)N * N));
    int y = (int)((v / N) % N);
    int x = (int)(v % N);
    float acc[T];
#pragma unroll
    for (int t = 0; t < T; ++t) acc[t] = 0.f;
    float uc0 = 0.f, uc1 = 0.f;
#pragma unroll
    for (int tap = 0; tap < 27; ++tap) {
      int nz = min(max(z + tap / 9 - 1, 0), N - 1);
      int ny = min(max(y + (tap / 3) % 3 - 1, 0), N - 1);
      int nx = min(max(x + tap % 3 - 1, 0), N - 1);
      __nv_bfloat162 pr = *reinterpret_cast<const __nv_bfloat162*>(
          ub + (((size_t)nz * N + ny) * N + nx) * kC + c0);
      float a0 = __bfloat162float(pr.x), a1 = __bfloat162float(pr.y);
      if (tap == 13) {
        uc0 = a0;
        uc1 = a1;
      }
#pragma unroll
      for (int t = 0; t < T; ++t) acc[t] += a0 * w_s[tap][c0][t] + a1 * w_s[tap][c0 + 1][t];
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float s = acc[t];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) trans[((size_t)b * n3 + v) * T + t] = s + bt[t];
    }
    vx::stat_fold(st0, uc0, lin[y], lin[z], lin[x]);
    vx::stat_fold(st1, uc1, lin[y], lin[z], lin[x]);
  }
  sh_stat[warp][0][c0] = st0.m;
  sh_stat[warp][1][c0] = st0.s;
  sh_stat[warp][2][c0] = st0.wx;
  sh_stat[warp][3][c0] = st0.wd;
  sh_stat[warp][4][c0] = st0.wz;
  sh_stat[warp][0][c0 + 1] = st1.m;
  sh_stat[warp][1][c0 + 1] = st1.s;
  sh_stat[warp][2][c0 + 1] = st1.wx;
  sh_stat[warp][3][c0 + 1] = st1.wd;
  sh_stat[warp][4][c0 + 1] = st1.wz;
  __syncthreads();
  if (tid < kC) {
    vx::Stat st = vx::stat_empty();
    for (int w = 0; w < kWarps; ++w) {
      vx::Stat o;
      o.m = sh_stat[w][0][tid];
      o.s = sh_stat[w][1][tid];
      o.wx = sh_stat[w][2][tid];
      o.wd = sh_stat[w][3][tid];
      o.wz = sh_stat[w][4][tid];
      vx::stat_merge(st, o);
    }
    vx::stat_store(part + ((size_t)b * P + blockIdx.x) * vx::kStatFields * kC, kC, tid,
                   st);
  }
}

template <int T>
int run_trans_stats(const bf16* u, const bf16* wt, const float* bt, const float* lin,
                    int B, int N, int P, float* trans, float* part,
                    cudaStream_t stream) {
  dim3 grid(P, B);
  dec_trans_stats<T><<<grid, kWarps * 32, 0, stream>>>(u, wt, bt, lin, N, P, trans,
                                                       part);
  return (int)cudaGetLastError();
}

}  // namespace

VX_EXPORT_ERROR_STRING(voxactb_decoder_head_error_string)

// d0, u0 [B, N, N, N, 64] bf16; wf [27, 128, 64] bf16 (tap-major dz, dy, dx;
// ci over concat[d0, u0]; co); bf [64] f32; wt [27, 64, T] bf16; bt [T] f32;
// lin [N] f32. Scratch: u [B, N^3, 64] bf16, part [B, ceil(N^3/512), 5, 64] f32.
// Outputs: trans [B, N, N, N, T] f32, kp [B, 192] f32, gmax [B, 64] f32.
// T is 1 or 2. Returns a cudaError_t.
extern "C" int voxactb_decoder_head(const void* d0, const void* u0, const void* wf,
                                    const float* bf, const void* wt, const float* bt,
                                    const float* lin, int B, int N, int T, void* u,
                                    float* part, float* trans, float* kp, float* gmax,
                                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n3 = (long long)N * N * N;
  const int P = (int)((n3 + kVoxPerBlock - 1) / kVoxPerBlock);
  VX_CHECK((vx::launch_conv3d_igemm<128, 3, 1, 1, vx::kEpiBiasLreluBf16>(
      static_cast<const bf16*>(d0), static_cast<const bf16*>(u0),
      static_cast<const bf16*>(wf), bf, B, N, N, nullptr, static_cast<bf16*>(u),
      stream)));
  int err;
  if (T == 1) {
    err = run_trans_stats<1>(static_cast<const bf16*>(u), static_cast<const bf16*>(wt),
                             bt, lin, B, N, P, trans, part, stream);
  } else if (T == 2) {
    err = run_trans_stats<2>(static_cast<const bf16*>(u), static_cast<const bf16*>(wt),
                             bt, lin, B, N, P, trans, part, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  VX_CHECK(vx::launch_stats_combine<kC>(part, B, P, kp, gmax, stream));
  return 0;
}
