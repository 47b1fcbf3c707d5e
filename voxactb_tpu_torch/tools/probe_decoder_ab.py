"""Paired A/B of the decoder tail from the decoded patch slab, in one process.

Counterpart of ``tools/probe_decoder_ab.py``. The whole tail from the slab
h ``[B, 20, 20, 20, C]`` at 100^3, chained 16 deep (a fresh d0 and h per
step), in turns (median of 5):

  v1  the fused upsample conv (cuDNN) and lrelu to u0, then the decoder tail
      kernel K3 reading d0 and u0
  v3  K8: the phase-GEMM upsample inside the tail, u0 never in memory

The trans argmax of v3 is checked against v1's (``v3 argmax == v1``). The
JAX probe's v1 and v2 are two TPU kernels of one function; the port has one
(K3), reported once, under v1.

    python3 -m voxactb_tpu_torch.tools.probe_decoder_ab
"""

from __future__ import annotations

import numpy as np
import torch

from voxactb_tpu_torch.device import resolve_device
from voxactb_tpu_torch.models.blocks import lrelu
from voxactb_tpu_torch.tools import device_line, device_normal, emit, median_ms

N, C, T_HEADS, CHAIN = 100, 64, 1, 16
NO_COUNTERPART = {
    "v2": "the JAX package's decoder_head and decoder_head_v2 are two TPU kernels of one "
          "function; the port has one kernel (K3, csrc/decoder_head.cu), reported under v1",
}


def tail_weights(rng, dev, c: int = C, t_heads: int = T_HEADS):
    """The JAX probe's weights: (up kernel, up bias, wf, bf, wt, bt) in f32."""
    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    upk = t(rng.normal(size=(5, 5, 5, c, c)) * .05)
    upb = t(np.zeros(c))
    wf = t(rng.normal(size=(3, 3, 3, 2 * c, c)) * .05)
    bf = t(np.zeros(c))
    wt = t(rng.normal(size=(t_heads, 3, 3, 3, c, 1)) * .05)
    bt = t(np.zeros(t_heads))
    return upk, upb, wf, bf, wt, bt


def main(*, device=None, n: int = N, chain: int = CHAIN, reps: int = 5) -> dict:
    """``{variant: ms per tail}`` and the argmax checks; ``n`` and ``chain``
    are there to run it small."""
    from voxactb_tpu_torch.ops.cuda.decoder_head import decoder_head
    from voxactb_tpu_torch.ops.cuda.decoder_head_v3 import decoder_head_v3
    from voxactb_tpu_torch.ops.upsample_conv import upsample_conv

    dev = resolve_device(device)
    emit(device_line(dev))
    s = n // 5
    d0s = device_normal((chain, 1, n, n, n, C), 40, dev)
    hs = device_normal((chain, 1, s, s, s, C), 41, dev)
    upk, upb, wf, bf, wt, bt = tail_weights(np.random.default_rng(0), dev)
    bf16 = torch.bfloat16

    def v1(d0, h):
        u0 = lrelu(upsample_conv(h, upk.to(bf16), upb.to(bf16), 5)).to(bf16)
        return decoder_head(d0, u0, wf, bf, wt, bt)

    def v3(d0, h):
        return decoder_head_v3(d0, h, upk, upb, wf, bf, wt, bt)

    def chained(tail):
        @torch.inference_mode()
        def run():
            sums, argmaxes = [], []
            for i in range(chain):
                tr, kp, gm = tail(d0s[i], hs[i])
                argmaxes.append(tr.reshape(tr.shape[0], -1, tr.shape[-1]).argmax(1))
                sums.append(tr.sum(dtype=torch.float32) + kp.sum() + gm.sum())
            return torch.stack(sums), torch.stack(argmaxes)
        return run

    runs = {"v1": chained(v1), "v3": chained(v3)}
    outs = {name: fn() for name, fn in runs.items()}
    checks = {}
    for name in outs:
        if name != "v1":
            checks[name] = bool(torch.equal(outs[name][1], outs["v1"][1]))
            emit({"argmax_check": f"{name} argmax == v1", "equal": checks[name]})
    walls = {name: [] for name in runs}
    for _ in range(reps):
        for name, fn in runs.items():
            walls[name].append(median_ms(fn, dev, 1, chain))
    med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    emit(med)
    return dict(ms=med, argmax_equal=checks)


if __name__ == "__main__":
    main()
