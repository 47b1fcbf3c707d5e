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
// to the f32 logits in registers instead (attention_fwd.cuh: each block
// stages the rel_h and rel_w rows of its queries once). That is exact where
// the split is within 2^-17 of a value.
//
// What bounds it on an H100: operations for a global block (BH 16, T 4096,
// head dim 80: 86 GFLOP against 42 MB), bytes for a windowed one (BH 400,
// T 196: 59 MB, mostly the two f32 rel terms, against 4.9 GFLOP).
//
// The main loop is attention_fwd.cuh's at 128 query rows per block: wgmma on
// TMA-loaded 128-key tiles, the softmax in registers, two passes over the keys
// so that P is normalised over the whole row before its bf16 cast. Head dim 80
// (ViT-H) runs on a 64-column and a 16-column box per operand; head dim 64
// (ViT-B, ViT-L) on the first alone. T is ragged (196 in a window): keys past T
// are zero-filled by TMA, masked to -inf and never index the bias; query rows
// past T are computed on zeros and not stored.

#include "attention_fwd.cuh"

namespace {

using vx::bf16;
using namespace vx::hopper;
using namespace vx::attn_fwd;

constexpr int kNC = 2;             // 128 query rows per block
constexpr int kRows = kNC * 64;
constexpr int kMaxGrid = 64;       // kh, kw at most 64 (ViT-H's global grid)
constexpr int kMaxDevices = 64;

template <int HD>
constexpr int max_bytes() {
  return Plan<HD, kNC>::bytes(bias_bytes(kRows, kMaxGrid, kMaxGrid));
}

// Once per device: the shared-memory opt-in of both head dims at the largest
// grid (cudaFuncSetAttribute is per device) and the SM count.
cudaError_t device_setup(int* sms) {
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!sm_count[dev]) {
    err = cudaFuncSetAttribute(attention_fwd<64, kNC, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes<64>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attention_fwd<80, kNC, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes<80>());
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = sm_count[dev];
  return cudaSuccess;
}

}  // namespace

VX_EXPORT_ERROR_STRING(voxactb_sam_attention_error_string)

// q, k, v, o [BH, T, hd] bf16 (16-byte aligned); rel_h [BH, T, kh], rel_w
// [BH, T, kw] f32; all contiguous. T = kh * kw, 1 <= kh, kw <= 64, hd 64 or
// 80. q is pre-scaled. Returns a cudaError_t.
extern "C" int voxactb_sam_attention(const void* q, const void* k, const void* v,
                                     const void* rel_h, const void* rel_w, void* o,
                                     int BH, int T, int kh, int kw, int hd,
                                     void* stream_ptr) {
  if (kh < 1 || kw < 1 || kh > kMaxGrid || kw > kMaxGrid || kh * kw != T || BH < 1 ||
      (hd != 64 && hd != 80))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int sms = 0;
  VX_CHECK(device_setup(&sms));
  CUtensorMap tq, tk, tv, tq1, tk1, tv1;
  VX_CHECK(rows_map(&tq, q, BH, T, 64, hd));
  VX_CHECK(rows_map(&tk, k, BH, T, kBn, hd));
  VX_CHECK(rows_map(&tv, v, BH, T, kBn, hd));
  if (hd == 80) {
    // columns 64-79
    VX_CHECK(rows_map(&tq1, q, BH, T, 64, hd, 16));
    VX_CHECK(rows_map(&tk1, k, BH, T, kBn, hd, 16));
    VX_CHECK(rows_map(&tv1, v, BH, T, kBn, hd, 16));
  } else {
    tq1 = tq, tk1 = tk, tv1 = tv;  // not read
  }
  // two bias buffers where they fit in the room of one at the largest grid
  // (the windows), else one
  const int bias = bias_bytes(kRows, kh, kw);
  const int bufs = 2 * bias <= bias_bytes(kRows, kMaxGrid, kMaxGrid) ? 2 : 1;
  const Args args{static_cast<bf16*>(o), static_cast<const float*>(rel_h),
                  static_cast<const float*>(rel_w), BH, T, T, kh, kw, 1, bufs};
  // persistent: one block per SM walks the items (row blocks of a head), its
  // producer loading the next item's tiles while the consumers finish one
  const int items = BH * ((T + kRows - 1) / kRows);
  const dim3 grid(items < sms ? items : sms);
  const int bytes =
      hd == 80 ? Plan<80, kNC>::bytes(bufs * bias) : Plan<64, kNC>::bytes(bufs * bias);
  if (hd == 80)
    attention_fwd<80, kNC, true><<<grid, Roles<kNC>::kThreads, bytes, stream>>>(
        tq, tk, tv, tq1, tk1, tv1, args);
  else
    attention_fwd<64, kNC, true><<<grid, Roles<kNC>::kThreads, bytes, stream>>>(
        tq, tk, tv, tq1, tk1, tv1, args);
  return (int)cudaGetLastError();
}
