"""Operations and bytes counted from shapes: the model's FLOPs per call and
per train step, and the roofline bounds of the kernels K3 and K4.

FLOPs are 2 per multiply-add of the matrix products and convolutions of the
plain reference (``reference/qnet.py``), elementwise work, softmax, the
normalisations, the losses and the optimizer left out. A train step adds the
backward's products: one per operand that needs a gradient (the voxel grid,
the proprio and the language tokens need none), nothing recomputed.
``tests/test_portbench_flops.py`` holds the count to
``torch.utils.flop_counter.FlopCounterMode`` on the reference.

The peaks are an H100 SXM's data-sheet figures at its 700 W limit.
"""

from __future__ import annotations

from typing import List, Tuple

from portbench.reference.qnet import Spec

PEAK_BF16_FLOPS = 989e12   # dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12       # HBM3 bytes/s

# (flops, operands that need a gradient in training)
Op = Tuple[float, int]


def model_ops(s: Spec, b: int) -> List[Op]:
    """Every product of one forward at batch ``b``."""
    n3, sp3 = s.voxel_size ** 3, s.spatial ** 3
    c, dim, ld, fd = s.im_channels, s.dim, s.latent_dim, s.final_dim
    lat, seq = s.num_latents, s.lang_len + sp3
    k3, st3 = s.patch_size ** 3, s.patch_stride ** 3
    mm = lambda m, k, n, grads=2: (2.0 * b * m * k * n, grads)  # noqa: E731
    stats = lambda cells, ch: (2.0 * b * cells * ch * 4, 1)  # noqa: E731

    def attn(nq, nk, qdim, kdim, heads, hd, out):
        inner = heads * hd
        return [mm(nq, qdim, inner), mm(nk, kdim, inner), mm(nk, kdim, inner),
                mm(heads * nq, hd, nk), mm(heads * nq, nk, hd), mm(nq, inner, out)]

    def ff():
        return [mm(lat, ld, 8 * ld), mm(lat, 4 * ld, ld)]

    ops = [mm(n3, s.initial_dim, c, 1), stats(n3, c), mm(sp3, c * k3, c),
           mm(1, s.low_dim_size, c, 1), mm(s.lang_len, s.lang_dim, dim, 1)]
    for _ in range(s.iterations):
        ops += attn(lat, seq, ld, dim, s.cross_heads, s.cross_dim_head, ld) + ff()
        for _ in range(s.depth):
            ops += attn(lat, lat, ld, ld, s.latent_heads, s.latent_dim_head, ld) + ff()
    ops += attn(seq, lat, dim, ld, s.cross_heads, s.cross_dim_head, dim)
    ops += [stats(sp3, dim), mm(sp3, dim * k3, fd), mm(sp3, fd * 27, st3 * fd),
            mm(n3, (c + fd) * 27, c), stats(n3, c), mm(n3, c * 27, 1)]
    feat = 8 * c + 4 * dim
    ops += [mm(1, feat, 256), mm(1, 256, fd), mm(1, fd, 3 * s.num_rotation_classes + 4)]
    if s.arm_pred:
        ops += [mm(1, feat, fd), mm(1, fd, 2)]
    return ops


def kernel_prep_ops(s: Spec) -> List[Op]:
    """Per call, whatever the batch: the composition of the upsample's
    kernel with the trilinear taps (three contractions, 3 coarse taps x
    ``stride`` phases each)."""
    k, fd, st = s.patch_size, s.final_dim, s.patch_stride
    ops, rest = [], k ** 3 * fd * fd
    for _ in range(3):
        rest //= k
        ops.append((2.0 * rest * k * st * 3, 1))
        rest *= st * 3
    return ops


def forward_flops(s: Spec, b: int) -> float:
    """One forward call at batch ``b``."""
    return sum(f for f, _ in model_ops(s, b) + kernel_prep_ops(s))


def train_flops(s: Spec, b: int) -> float:
    """One train step at batch ``b``: the forward, plus one product per
    operand that needs a gradient."""
    return sum(f * (1 + g) for f, g in model_ops(s, b) + kernel_prep_ops(s))


# -- kernel bounds ------------------------------------------------------------------


def bound_s(nbytes: float, flops: float) -> float:
    """The least time: bytes at the HBM rate or bf16 operations at the
    tensor-core peak, whichever is longer."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS)


def k4_calls(s: Spec, b: int):
    """The train step's attention calls: ``(bh, tq, tk, head_dim, dropout)``."""
    seq = s.lang_len + s.spatial ** 3
    trunk = [(b * s.cross_heads, s.num_latents, seq, s.cross_dim_head, s.input_dropout)]
    trunk += [(b * s.latent_heads, s.num_latents, s.num_latents, s.latent_dim_head,
               s.attn_dropout)] * s.depth
    return trunk * s.iterations + [
        (b * s.cross_heads, seq, s.num_latents, s.cross_dim_head, s.decoder_dropout)]


def k4_step_bound_s(s: Spec, b: int) -> float:
    """K4's forward and backward bounds over one train step: q, k, v (and
    dO) read once, out, lse, the keep bits and dq, dk, dv written once;
    4 bh tq tk hd operations forward, 2.5 times that backward (the
    probabilities are recomputed, not stored)."""
    total = 0.0
    for bh, tq, tk, hd, drop in k4_calls(s, b):
        flops = 4.0 * bh * tq * tk * hd
        qkv = 2.0 * (bh * tq * hd + 2 * bh * tk * hd)
        bits = 4.0 * bh * tq * (-(-tk // 32)) if drop > 0.0 else 0.0
        total += bound_s(qkv + 2.0 * bh * tq * hd + 4.0 * bh * tq + bits, flops)
        total += bound_s(2.0 * qkv + 4.0 * bh * tq * hd + 4.0 * bh * tq + bits, 2.5 * flops)
    return total


def k3_call_bound_s(s: Spec, b: int, heads: int = 1) -> float:
    """K3's bound for one call: d0 and u0 read, the trans field, the
    soft-argmax partials and the weights; the u conv's and the trans
    head's products."""
    n3 = s.voxel_size ** 3
    nbytes = (2.0 * b * n3 * 64 * 2 + b * n3 * 4 * heads + b * 64 * 4 * 4
              + (27 * 128 * 64 + 27 * 64 * heads) * 2 + (64 + heads) * 4)
    flops = 2.0 * b * n3 * 27 * 128 * 64 + 2.0 * b * n3 * 27 * 64 * heads
    return bound_s(nbytes, flops)
