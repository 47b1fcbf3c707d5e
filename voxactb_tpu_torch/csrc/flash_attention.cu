// Inference attention for Hopper (sm_90a): softmax(q k^T + key mask) v.
//
// Replaces voxactb_tpu/ops/pallas/flash_attention.py::flash_attention (TPU
// kernel `_kernel`), the Perceiver trunk's cross, self and decoder attention
// at bf16 with head dim 64, or 128 (the wrapper zero-pads heads of up to 64
// to 64 and of 65-128 to 128, which is exact, as the TPU kernel pads to 128).
// q arrives pre-scaled by hd^-1/2 of the true head dim (in bf16).
//
// What bounds it on an H100: operations. Per act at 100^3, B = 1 it does about
// 60 GFLOP of bf16 products against ~20 MB of q/k/v/o traffic.
//
// The main loop is attention_fwd.cuh's (wgmma on TMA-loaded tiles, the
// softmax in registers, two passes so that P is normalised before its bf16
// cast). The schedule is (rows, splits):
//  - rows: 128 query rows per block (two consumer warpgroups taking turns) or
//    64 (one);
//  - splits: the key tiles of a row block go to `splits` CTAs of one cluster
//    (1 to 8), which merge their row max and sum and sum their partial
//    outputs in rank order through distributed shared memory. It is taken
//    where even 64-row blocks cannot fill half the card: cross attention at
//    batch 1 has 32 of them, the 50^3 decoder attention 17.
// Head dim 128 takes the one schedule (64, 1) (attention_fwd.cuh).
// The wrapper (ops/cuda/flash_attention.py) picks the schedule from (BH, Tq,
// Tk, SM count) or takes the caller's.

#include "attention_fwd.cuh"

namespace {

using vx::bf16;
using namespace vx::hopper;
using namespace vx::attn_fwd;

constexpr int kMaxDevices = 64;
constexpr int kMaxSplits = 8;  // the portable cluster size

template <int NC>
constexpr int max_bytes() {
  return Plan<64, NC>::bytes(exchange_bytes(NC * 64));
}

// Once per device: the shared-memory opt-in of both row counts
// (cudaFuncSetAttribute is per device).
cudaError_t device_setup() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(attention_fwd<64, 1, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes<1>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attention_fwd<64, 2, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes<2>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attention_fwd<128, 1, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Plan<128, 1>::bytes(0));
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int HD, int NC>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   Args args, cudaStream_t stream) {
  const int BH = args.BH;
  constexpr int R = NC * 64;
  const int S = args.splits;
  cudaLaunchConfig_t cfg = {};
  // one item (row block of a head) per cluster
  cfg.gridDim = dim3((unsigned)(BH * ((args.Tq + R - 1) / R) * S));
  cfg.blockDim = dim3(Roles<NC>::kThreads);
  cfg.dynamicSmemBytes = Plan<HD, NC>::bytes(S > 1 ? exchange_bytes(R) : 0);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)S;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = S > 1 ? 1 : 0;
  // head dim 64 or 128: the narrow maps are not read
  void* params[] = {(void*)&tq, (void*)&tk, (void*)&tv, (void*)&tq,
                    (void*)&tk, (void*)&tv, (void*)&args};
  return cudaLaunchKernelExC(&cfg, (const void*)attention_fwd<HD, NC, false>, params);
}

}  // namespace

VX_EXPORT_ERROR_STRING(voxactb_flash_attention_error_string)

// q [BH, Tq, hd], k, v [BH, Tk, hd], o [BH, Tq, hd], all bf16 contiguous and
// 16-byte aligned, hd 64 or 128. rows: 64 or 128 query rows per block;
// splits: 1 to 8 CTAs per row block along the key axis, at most
// ceil(Tk / 128); hd 128 takes rows 64 and splits 1 only. Returns a
// cudaError_t.
extern "C" int voxactb_flash_attention(const void* q, const void* k, const void* v, void* o,
                                       int BH, int Tq, int Tk, int rows, int splits, int hd,
                                       void* stream_ptr) {
  const int n_tiles = (Tk + kBn - 1) / kBn;
  if ((rows != 64 && rows != 128) || splits < 1 || splits > kMaxSplits || splits > n_tiles ||
      BH < 1 || Tq < 1 || Tk < 1 || (long long)BH * ((Tq + 63) / 64) * splits >= (1ll << 31) ||
      (hd != 64 && hd != 128) || (hd == 128 && (rows != 64 || splits != 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  VX_CHECK(device_setup());
  CUtensorMap tq, tk, tv;
  VX_CHECK(rows_map(&tq, q, BH, Tq, 64, hd));
  VX_CHECK(rows_map(&tk, k, BH, Tk, kBn, hd));
  VX_CHECK(rows_map(&tv, v, BH, Tk, kBn, hd));
  const Args args{static_cast<bf16*>(o), nullptr, nullptr, BH, Tq, Tk, 0, 0, splits, 0};
  const cudaError_t err = hd == 128    ? launch<128, 1>(tq, tk, tv, args, stream)
                          : rows == 128 ? launch<64, 2>(tq, tk, tv, args, stream)
                                        : launch<64, 1>(tq, tk, tv, args, stream);
  VX_CHECK(err);
  return (int)cudaGetLastError();
}
