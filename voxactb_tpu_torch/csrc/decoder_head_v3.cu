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
// Design: on this card a u0 round trip through device memory (256 MB at
// 100^3, about 0.08 ms) costs far less than re-reading the 27.6 MB phase
// table for every tile, so u0 goes to a bf16 scratch grid.
//   1. phase_gemm (phase_gemm.cuh): u0 from the edge-padded h and the table,
//      on wgmma over staged 4 x 4 x 4-cell halo bricks, with the f32 up bias,
//      one rounding to bf16 and the lrelu with the f32 slope (as the TPU
//      kernel), each phase's 64 channels stored at voxel (5 qz + rz, 5 qy +
//      ry, 5 qx + rx).
//   2. decoder_tail.cuh's three steps on [d0 || u0]: K3's function.

#include "decoder_tail.cuh"
#include "phase_gemm.cuh"

VX_EXPORT_ERROR_STRING(voxactb_decoder_head_v3_error_string)

// d0 [B, N, N, N, 64] bf16; hp [B, s + 2, s + 2, s + 2, 64] bf16 (h edge-padded
// by one on each side, s = N / 5); table [27, 125 * 64, 64] bf16 (tap dz, dy,
// dx; phase rz, ry, rx and co; ci), the phase-weight table composed in f32 and
// rounded once, 16-byte aligned; up_bias [64] f32; wf, bf, wt, bt, lin, G as
// voxactb_decoder_head. Scratch: u [B, N^3, 64] bf16, part [B, G, 5, 64] f32.
// Outputs: u0 [B, N^3, 64] bf16, trans [B, N, N, N, T] f32, kp [B, 192] f32,
// gmax [B, 64] f32. T is 1 or 2. Returns a cudaError_t.
extern "C" int voxactb_decoder_head_v3(const void* d0, const void* hp, const void* table,
                                       const float* up_bias, const void* wf,
                                       const float* bf, const void* wt, const float* bt,
                                       const float* lin, int B, int N, int T, int G,
                                       void* u0, void* u, float* part, float* trans,
                                       float* kp, float* gmax, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (N % 5 != 0) return (int)cudaErrorInvalidValue;
  VX_CHECK(vx::phase::launch_phase_gemm(static_cast<const vx::bf16*>(hp),
                                        static_cast<const vx::bf16*>(table), up_bias, B,
                                        N / 5, static_cast<vx::bf16*>(u0), stream));
  return vx::tail::run_decoder_tail(d0, u0, wf, bf, wt, bt, lin, B, N, T, G, u, part, trans,
                                    kp, gmax, stream);
}
