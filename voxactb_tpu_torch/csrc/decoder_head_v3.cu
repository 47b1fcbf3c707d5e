// Decoder tail with the x5 upsample computed inside (sm_90a): from the
// post-conv_in slab h [B, s, s, s, 64] (s = N / 5), u0 = lrelu(bf16(phase-
// conv(edge-pad(h)) + b_up)), then K3's tail over [d0 || u0].
//
// Replaces voxactb_tpu/ops/pallas/decoder_head_v3.py::decoder_head_v3 (TPU
// kernel `_kernel`), which synthesised each u0 row in VMEM from a composed
// phase-weight table because its part had about 66 GB/s to device memory.
//
// What bounds it on an H100: operations. At N = 100, B = 1 the phase conv is
// 8000 cells x 1728 x 8000 x 2 = 221 GFLOP and the tail's u conv 442 GFLOP,
// against about 161 MB of compulsory traffic (0.048 ms at 3.35 TB/s).
//
// Design (simple first): on this card a u0 round trip through device memory
// (256 MB at 100^3, about 0.08 ms) costs far less than re-reading the 27.6 MB
// phase table for every tile, so u0 goes to a bf16 scratch grid.
//   1. conv3d_igemm<64, 3, 1, 0> (common.cuh) as the phase GEMM: M = B s^3
//      cells, K = 27 x 64 (taps dz, dy, dx of the edge-padded h, which the
//      wrapper pads on all three axes), N = 125 x 64 (phases rz, ry, rx and
//      the output channel), one 64-column block per phase. Its epilogue adds
//      the f32 up bias, rounds to bf16, takes the lrelu with the f32 slope
//      (as the TPU kernel) and puts the phase's 64 channels at voxel
//      (5 qz + rz, 5 qy + ry, 5 qx + rx) of u0.
//   2. decoder_tail.cuh's three steps on [d0 || u0]: K3's function.

#include "decoder_tail.cuh"

VX_EXPORT_ERROR_STRING(voxactb_decoder_head_v3_error_string)

// d0 [B, N, N, N, 64] bf16; hp [B, s + 2, s + 2, s + 2, 64] bf16 (h edge-padded
// by one on each side, s = N / 5); table [27, 64, 125 * 64] bf16 (tap dz, dy,
// dx; ci; phase rz, ry, rx; co), the phase-weight table composed in f32 and
// rounded once; up_bias [64] f32; wf, bf, wt, bt, lin as voxactb_decoder_head.
// Scratch: u0 and u [B, N^3, 64] bf16, part [B, ceil(N^3/512), 5, 64] f32.
// Outputs: trans [B, N, N, N, T] f32, kp [B, 192] f32, gmax [B, 64] f32.
// T is 1 or 2. Returns a cudaError_t.
extern "C" int voxactb_decoder_head_v3(const void* d0, const void* hp, const void* table,
                                       const float* up_bias, const void* wf,
                                       const float* bf, const void* wt, const float* bt,
                                       const float* lin, int B, int N, int T, void* u0,
                                       void* u, float* part, float* trans, float* kp,
                                       float* gmax, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (N % 5 != 0) return (int)cudaErrorInvalidValue;
  const int s = N / 5;
  VX_CHECK((vx::launch_conv3d_igemm<64, 3, 1, 0, vx::kEpiPhaseUpsampleBf16>(
      static_cast<const vx::bf16*>(hp), nullptr, static_cast<const vx::bf16*>(table),
      up_bias, B, s + 2, s, nullptr, static_cast<vx::bf16*>(u0), stream, 125)));
  return vx::tail::run_decoder_tail(d0, u0, wf, bf, wt, bt, lin, B, N, T, u, part, trans,
                                    kp, gmax, stream);
}
