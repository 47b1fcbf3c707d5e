"""The plain reference of the PerceiverIO voxel-language Q-network, float32.

PerAct's Q-network (``PerceiverVoxelLangEncoder``, Shridhar et al., CoRL
2022, ``peract/agents/peract_bc/perceiver_lang_io.py``) with VoxAct-B's arm
head, written as one function of a parameter dictionary. Parameter names and
layouts are the port's ``state_dict`` names, so the benchmark can hand the
same tensors to both; nothing here imports the port.

Departures from the published network, each as the port has it:
- the x5 trilinear upsample and the conv that follows it are composed into
  one conv at the coarse grid (``upsample_conv``), which clamps at the grid
  edge where resize-then-conv pads the fine grid;
- the soft-argmax positions follow the reference code's meshgrid 'xy' order
  (x from axis 1, y from axis 0).

``precision`` sets the precision of every matrix product and convolution:
``exact`` leaves them in float32 (TF32 must be off, see ``float32_only``);
``fp8``, the control that a comparison must reject, rounds each operand to
float8 e4m3 and, in training, each gradient that enters a product of the
backward to float8 e5m2, with one scale per tensor, as fp8 training does.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.prep import keep_mask

F32 = torch.float32
LRELU_SLOPE = 0.02
TEMPERATURE = 0.01


class Spec(NamedTuple):
    """The widths of one policy, from a configuration file."""

    voxel_size: int
    low_dim_size: int
    num_latents: int
    latent_dim: int
    depth: int
    cross_heads: int
    latent_heads: int
    cross_dim_head: int
    latent_dim_head: int
    patch_size: int
    patch_stride: int
    final_dim: int
    num_rotation_classes: int
    arm_pred: bool
    input_dropout: float
    attn_dropout: float
    decoder_dropout: float
    im_channels: int = 64
    initial_dim: int = 10
    lang_dim: int = 512
    lang_len: int = 77
    iterations: int = 1

    @property
    def spatial(self) -> int:
        return self.voxel_size // self.patch_stride

    @property
    def dim(self) -> int:
        return 2 * self.im_channels

    def num_dropout_seeds(self) -> int:
        return self.iterations * (1 + self.depth) + 1


def spec_from(method: dict, model: dict, low_dim_size: int) -> Spec:
    """A ``Spec`` from a configuration file's ``method`` and ``model`` groups."""
    return Spec(
        voxel_size=method["voxel_sizes"][0], low_dim_size=low_dim_size,
        num_latents=method["num_latents"], latent_dim=method["latent_dim"],
        depth=method["transformer_depth"], cross_heads=method["cross_heads"],
        latent_heads=method["latent_heads"], cross_dim_head=method["cross_dim_head"],
        latent_dim_head=method["latent_dim_head"], patch_size=method["voxel_patch_size"],
        patch_stride=method["voxel_patch_stride"], final_dim=method["final_dim"],
        num_rotation_classes=int(360 // method["rotation_resolution"]),
        arm_pred=bool(method.get("arm_pred_loss", False)),
        input_dropout=method["input_dropout"], attn_dropout=method["attn_dropout"],
        decoder_dropout=method["decoder_dropout"], im_channels=model["im_channels"],
        initial_dim=model["initial_dim"], lang_dim=model["lang_emb_dim"],
        lang_len=model["lang_max_seq_len"],
        iterations=method.get("transformer_iterations", 1))


# -- parameters -------------------------------------------------------------------


def param_shapes(s: Spec) -> Dict[str, tuple]:
    """Every parameter: name -> shape, in the port's ``state_dict`` order."""
    c, dim, ld = s.im_channels, s.dim, s.latent_dim
    shapes = {
        "pos_encoding": (1, s.lang_len + s.spatial ** 3, dim),
        "latents": (s.num_latents, ld),
        "input_preprocess.weight": (c, s.initial_dim, 1, 1, 1),
        "input_preprocess.bias": (c,),
        "patchify.weight": (c, c) + (s.patch_size,) * 3,
        "patchify.bias": (c,),
        "proprio_preprocess.Dense_0.weight": (c, s.low_dim_size),
        "proprio_preprocess.Dense_0.bias": (c,),
        "lang_preprocess.weight": (dim, s.lang_dim),
        "lang_preprocess.bias": (dim,),
    }

    def attention(prefix, qdim, cdim, heads, hd, out, norm_context):
        inner = heads * hd
        shapes[f"{prefix}.norm.weight"] = (qdim,)
        shapes[f"{prefix}.norm.bias"] = (qdim,)
        if norm_context:
            shapes[f"{prefix}.norm_context.weight"] = (cdim,)
            shapes[f"{prefix}.norm_context.bias"] = (cdim,)
        shapes[f"{prefix}.attn.to_q.weight"] = (inner, qdim)
        shapes[f"{prefix}.attn.to_k.weight"] = (inner, cdim)
        shapes[f"{prefix}.attn.to_v.weight"] = (inner, cdim)
        shapes[f"{prefix}.attn.to_out.weight"] = (out, inner)
        shapes[f"{prefix}.attn.to_out.bias"] = (out,)

    def feed_forward(prefix):
        shapes[f"{prefix}.norm.weight"] = (ld,)
        shapes[f"{prefix}.norm.bias"] = (ld,)
        shapes[f"{prefix}.w_in.weight"] = (ld * 8, ld)
        shapes[f"{prefix}.w_in.bias"] = (ld * 8,)
        shapes[f"{prefix}.w_out.weight"] = (ld, ld * 4)
        shapes[f"{prefix}.w_out.bias"] = (ld,)

    attention("cross_attend", ld, dim, s.cross_heads, s.cross_dim_head, ld, True)
    feed_forward("cross_ff")
    for i in range(s.depth):
        attention(f"self_attn_{i}", ld, ld, s.latent_heads, s.latent_dim_head, ld, False)
        feed_forward(f"self_ff_{i}")
    attention("decoder_cross_attn", dim, ld, s.cross_heads, s.cross_dim_head, dim, True)
    k, fd = s.patch_size, s.final_dim
    shapes.update({
        "up0.out_kernel": (k, k, k, fd, fd),
        "up0.out_bias": (fd,),
        "up0.conv_in.weight": (fd, dim, k, k, k),
        "up0.conv_in.bias": (fd,),
        "final.weight": (c, c + fd, 3, 3, 3),
        "final.bias": (c,),
        "trans_decoder.weight": (1, c, 3, 3, 3),
        "trans_decoder.bias": (1,),
    })
    feat = 8 * c + 4 * dim
    heads = [("dense0", feat, 256), ("dense1", 256, fd),
             ("rot_grip_collision_ff", fd, 3 * s.num_rotation_classes + 4)]
    if s.arm_pred:
        heads += [("dense2", feat, fd), ("arm_ff", fd, 2)]
    for name, fin, fout in heads:
        shapes[f"{name}.Dense_0.weight"] = (fout, fin)
        shapes[f"{name}.Dense_0.bias"] = (fout,)
    return shapes


def draw_params(s: Spec, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights in one draw on ``device``: each matrix or
    kernel N(0, 1 / fan_in) (fan_in over its input channels and taps), each
    bias N(0, 0.02^2), each LayerNorm scale 1 + N(0, 0.1^2), the position
    encoding and the latents N(0, 1)."""
    shapes = param_shapes(s)
    sizes = [int(np.prod(v)) for v in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator, device=device, dtype=F32)
    out, at = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        x = flat[at:at + size].view(shape)
        at += size
        if name in ("pos_encoding", "latents"):
            out[name] = x
        elif ".norm" in name and name.endswith(".weight"):
            out[name] = 1.0 + 0.1 * x
        elif name.endswith("bias"):
            out[name] = 0.02 * x
        elif name == "up0.out_kernel":  # [k, k, k, Cin, Cout]
            out[name] = x * (np.prod(shape[:4])) ** -0.5
        else:  # [out, in, taps...]
            out[name] = x * (np.prod(shape[1:])) ** -0.5
    return out


# -- precision --------------------------------------------------------------------

FP8_MAX = 448.0      # float8 e4m3's largest value: operands
FP8_GRAD_MAX = 57344.0  # float8 e5m2's: gradients


def _fp8_round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """Round to an 8-bit float with one scale per tensor (amax to ``top``)."""
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(F32) / scale


class _Fp8Operand(torch.autograd.Function):
    """Forward: the operand rounded to e4m3. Backward: the gradient as is."""

    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Output(torch.autograd.Function):
    """Forward: the product's output as is. Backward: its gradient rounded
    to e5m2, so that the backward's products take fp8 operands too."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2, FP8_GRAD_MAX)


class Rounding(NamedTuple):
    """Where a precision rounds: ``a`` each operand of a product, ``g`` each
    product's output (its gradient, in training)."""

    a: object
    g: object


def rounding(precision: str) -> Rounding:
    if precision == "exact":
        return Rounding(lambda x: x, lambda y: y)
    if precision == "fp8":
        return Rounding(_Fp8Operand.apply, _Fp8Output.apply)
    raise ValueError(f"unknown precision {precision!r}")


@contextlib.contextmanager
def float32_only():
    """TF32 off for matrix products and cuDNN convolutions, restored after."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


# -- layers -------------------------------------------------------------------------


def lrelu(x):
    return torch.where(x >= 0, x, x * LRELU_SLOPE)


def dense(p, name, x, r, act=False):
    y = r.g(torch.matmul(r.a(x), r.a(p[f"{name}.weight"]).t())) + p[f"{name}.bias"]
    return lrelu(y) if act else y


def layer_norm(p, name, x):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], 1e-5)


def conv3d(x, w, b, stride, r, act=True):
    """Channels-last conv with replicate padding ``k // 2``."""
    pad = w.shape[-1] // 2
    xc = x.permute(0, 4, 1, 2, 3)
    if pad:
        xc = F.pad(xc, (pad,) * 6, mode="replicate")
    y = r.g(F.conv3d(r.a(xc), r.a(w), stride=stride)).permute(0, 2, 3, 4, 1) + b
    return lrelu(y) if act else y


def _phase_taps(scale: int, k: int) -> np.ndarray:
    """T[r, k, d]: weight of coarse cell q + d - 1 in fine phase r through tap k
    of a trilinear (half-pixel) upsample followed by a k-tap conv."""
    pad = k // 2
    t = np.zeros((scale, k, 3), np.float64)
    for r in range(scale):
        for j in range(k):
            qq, rr = divmod(r + j - pad, scale)
            c = (rr + 0.5) / scale - 0.5
            lo = int(np.floor(c))
            for off, w in ((lo, 1.0 - (c - lo)), (lo + 1, c - lo)):
                if w != 0.0:
                    t[r, j, max(-1, min(1, qq + off)) + 1] += w
    return t


def upsample_conv(x, kernel, bias, scale: int, r):
    """x``scale`` trilinear upsample then conv, as one conv at the coarse grid."""
    b, d = x.shape[0], x.shape[1]
    k, cin, cout = kernel.shape[0], kernel.shape[3], kernel.shape[4]
    t = torch.as_tensor(_phase_taps(scale, k), dtype=F32, device=x.device)
    w = kernel
    for _ in range(3):
        w = torch.tensordot(w, t, dims=([0], [1]))
    w = w.permute(3, 5, 7, 0, 2, 4, 6, 1).reshape(3, 3, 3, cin, scale ** 3 * cout)
    xc = F.pad(x.permute(0, 4, 1, 2, 3), (1,) * 6, mode="replicate")
    y = r.g(F.conv3d(r.a(xc), r.a(w.permute(4, 3, 0, 1, 2))))
    y = y.reshape(b, scale, scale, scale, cout, d, d, d).permute(0, 5, 1, 6, 2, 7, 3, 4)
    return y.reshape(b, d * scale, d * scale, d * scale, cout) + bias


def softargmax_stats(x):
    """(soft-argmax keypoints ``[B, 3C]``, global max ``[B, C]``) of a cubic
    grid at temperature 0.01."""
    b, n, _, _, c = x.shape
    flat = x.reshape(b, n ** 3, c)
    m = flat.amax(1)
    e = torch.exp((flat - m[:, None]) / TEMPERATURE)
    lin = torch.linspace(-1.0, 1.0, n, dtype=F32, device=x.device)
    pos = torch.stack([lin[None, :, None].expand(n, n, n).reshape(-1),
                       lin[:, None, None].expand(n, n, n).reshape(-1),
                       lin[None, None, :].expand(n, n, n).reshape(-1)], -1)
    sums = torch.einsum("bsc,sk->bck", e, torch.cat([torch.ones_like(pos[:, :1]), pos], -1))
    return (sums[..., 1:] / sums[..., :1]).reshape(b, 3 * c), m


def attention(p, name, x, context, heads, hd, r, dropout, seed):
    """PreNorm multi-head attention; dropout on the probabilities from
    ``keep_mask(seed)`` when ``dropout > 0``."""
    y = layer_norm(p, f"{name}.norm", x)
    ctx = y if context is None else (
        layer_norm(p, f"{name}.norm_context", context)
        if f"{name}.norm_context.weight" in p else context)
    a = f"{name}.attn"
    q = r.g(torch.matmul(r.a(y), r.a(p[f"{a}.to_q.weight"]).t()))
    k = r.g(torch.matmul(r.a(ctx), r.a(p[f"{a}.to_k.weight"]).t()))
    v = r.g(torch.matmul(r.a(ctx), r.a(p[f"{a}.to_v.weight"]).t()))
    b, n, m = q.shape[0], q.shape[1], k.shape[1]
    q, k, v = (t.reshape(b, -1, heads, hd).transpose(1, 2) for t in (q, k, v))
    attn = torch.softmax(r.g(torch.matmul(r.a(q), r.a(k).transpose(-1, -2))) * hd ** -0.5, -1)
    if dropout > 0.0:
        attn = attn * keep_mask(seed, b, heads, n, m, dropout).to(F32) * (1.0 / (1.0 - dropout))
    out = r.g(torch.matmul(r.a(attn), r.a(v))).transpose(1, 2).reshape(b, n, heads * hd)
    return dense(p, f"{a}.to_out", out, r)


def feed_forward(p, name, x, r):
    y = dense(p, f"{name}.w_in", layer_norm(p, f"{name}.norm", x), r)
    y, gates = y.chunk(2, -1)
    return dense(p, f"{name}.w_out", y * F.gelu(gates, approximate="tanh"), r)


def forward(p: Dict[str, torch.Tensor], s: Spec, grid, proprio, lang_tokens, *,
            precision: str = "exact", dropout_seeds: Optional[torch.Tensor] = None):
    """``grid [B, N, N, N, 10]``, ``proprio [B, low_dim]``, ``lang_tokens [B,
    77, 512]`` -> logits: ``trans [B, N, N, N]``, ``rot_grip [B, 3R + 2]``,
    ``collision [B, 2]`` and, with the arm head, ``arm [B, 2]``. With
    ``dropout_seeds`` (one per attention call) dropout is applied."""
    r = rounding(precision)
    b = grid.shape[0]
    sp, dim, c = s.spatial, s.dim, s.im_channels
    train = dropout_seeds is not None
    seeds = iter(dropout_seeds.unbind(0)) if train else iter([None] * s.num_dropout_seeds())

    d0 = conv3d(grid, p["input_preprocess.weight"], p["input_preprocess.bias"], 1, r)
    kp0, gmax0 = softargmax_stats(d0)
    ins = conv3d(d0, p["patchify.weight"], p["patchify.bias"], s.patch_stride, r)
    prop = dense(p, "proprio_preprocess.Dense_0", proprio.reshape(b, s.low_dim_size), r, True)
    ins = torch.cat([ins, prop[:, None, None, None].expand(b, sp, sp, sp, c)], -1)
    lang = dense(p, "lang_preprocess", lang_tokens, r)
    seq = torch.cat([lang, ins.reshape(b, sp ** 3, dim)], 1) + p["pos_encoding"]

    def drop(rate):
        seed = next(seeds)
        return rate if train else 0.0, seed

    x = p["latents"][None].expand(b, -1, -1)
    for _ in range(s.iterations):
        x = attention(p, "cross_attend", x, seq, s.cross_heads, s.cross_dim_head, r,
                      *drop(s.input_dropout)) + x
        x = feed_forward(p, "cross_ff", x, r) + x
        for i in range(s.depth):
            x = attention(p, f"self_attn_{i}", x, None, s.latent_heads, s.latent_dim_head,
                          r, *drop(s.attn_dropout)) + x
            x = feed_forward(p, f"self_ff_{i}", x, r) + x
    dec = attention(p, "decoder_cross_attn", seq, x, s.cross_heads, s.cross_dim_head, r,
                    *drop(s.decoder_dropout))
    coarse = dec[:, s.lang_len:].reshape(b, sp, sp, sp, dim)
    kp1, gmax1 = softargmax_stats(coarse)

    h = conv3d(coarse, p["up0.conv_in.weight"], p["up0.conv_in.bias"], 1, r)
    u0 = lrelu(upsample_conv(h, p["up0.out_kernel"], p["up0.out_bias"], s.patch_stride, r))
    u = conv3d(torch.cat([d0, u0], -1), p["final.weight"], p["final.bias"], 1, r)
    kpu, gmaxu = softargmax_stats(u)
    trans = conv3d(u, p["trans_decoder.weight"], p["trans_decoder.bias"], 1, r, act=False)

    feats = torch.cat([kp0, gmax0, kp1, gmax1, kpu, gmaxu], 1)
    h1 = dense(p, "dense1.Dense_0", dense(p, "dense0.Dense_0", feats, r, True), r, True)
    rgc = dense(p, "rot_grip_collision_ff.Dense_0", h1, r)
    out = {"trans": trans[..., 0], "rot_grip": rgc[:, :-2], "collision": rgc[:, -2:]}
    if s.arm_pred:
        out["arm"] = dense(p, "arm_ff.Dense_0", dense(p, "dense2.Dense_0", feats, r, True), r)
    return out
