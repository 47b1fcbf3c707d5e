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
// Design: the three steps of decoder_tail.cuh, on the given u0; the u conv
// is tail_conv.cuh's wgmma kernel over staged halo bricks, the trans head and
// the statistics read u from staged halo bricks too.

#include "decoder_tail.cuh"

VX_EXPORT_ERROR_STRING(voxactb_decoder_head_error_string)

// d0, u0 [B, N, N, N, 64] bf16; wf [27, 128, 64] bf16 (tap-major dz, dy, dx;
// ci over concat[d0, u0]; co); bf [64] f32; wt [27, 64, T] bf16; bt [T] f32;
// lin [N] f32; G the trans/stats CTAs per sample (1 .. the sample's output
// bricks). Scratch: u [B, N^3, 64] bf16, part [B, G, 5, 64] f32.
// Outputs: trans [B, N, N, N, T] f32, kp [B, 192] f32, gmax [B, 64] f32.
// T is 1 or 2. Returns a cudaError_t.
extern "C" int voxactb_decoder_head(const void* d0, const void* u0, const void* wf,
                                    const float* bf, const void* wt, const float* bt,
                                    const float* lin, int B, int N, int T, int G, void* u,
                                    float* part, float* trans, float* kp, float* gmax,
                                    void* stream_ptr) {
  return vx::tail::run_decoder_tail(d0, u0, wf, bf, wt, bt, lin, B, N, T, G, u, part,
                                    trans, kp, gmax, static_cast<cudaStream_t>(stream_ptr));
}

// The trans head(s) and statistics alone (steps 2-3) on a given u [B, N, N, N,
// 64] bf16; other arguments as voxactb_decoder_head.
extern "C" int voxactb_tail_trans_stats(const void* u, const void* wt, const float* bt,
                                        const float* lin, int B, int N, int T, int G,
                                        float* part, float* trans, float* kp, float* gmax,
                                        void* stream_ptr) {
  return vx::tail::run_trans_stats(u, wt, bt, lin, B, N, T, G, part, trans, kp, gmax,
                                   static_cast<cudaStream_t>(stream_ptr));
}
