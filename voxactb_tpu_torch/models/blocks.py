"""Network building blocks, channels-LAST at every public boundary.

Counterpart of ``voxactb_tpu.models.blocks``. Parameters are stored in f32
and cast to the module's compute ``dtype`` at use, as flax does with
``dtype=bfloat16``. Every conv body accumulates in f32, adds its bias in f32,
rounds to the compute dtype and only then applies the activation
(blocks.py:143, :163, :167 of the JAX package).

Initialisation follows the JAX initializers from a ``torch.Generator`` (so the
port can build seeded weights where JAX is absent): he-uniform for relu/lrelu
bodies, xavier-uniform otherwise (blocks.py:78-84), lecun-normal for plain
Dense layers, zeros for biases.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from voxactb_tpu_torch.ops.cuda.graphs import weight

LRELU_SLOPE = 0.02
TEMPERATURE = 0.01


@functools.lru_cache(maxsize=None)
def rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float. An elementwise op
    takes it as a scalar operand, which it forms its result with exactly as
    with a 0-dim tensor of ``dtype`` holding it (in f32 for bf16 operands,
    rounded once), but without making that tensor on the device: a copy from
    the host there could not be captured in a CUDA graph."""
    return torch.tensor(value, dtype=dtype).item()


def lrelu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    """Leaky relu with the slope in ``x``'s dtype, as ``jax.nn.leaky_relu``
    multiplies by a weakly typed scalar (bf16(0.02) = 0.02001953125)."""
    return torch.where(x >= 0, x, x * rounded(slope, x.dtype))


def act_fn(name: Optional[str]):
    """Activation registry (network_utils.py:15-27)."""
    if name is None:
        return lambda x: x
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lrelu
    if name == "elu":
        return F.elu
    if name == "tanh":
        return torch.tanh
    raise ValueError(f"activation {name!r} not recognized")


# -- initialisation ------------------------------------------------------------


def variance_scaling_uniform_(w: torch.Tensor, scale: float, fan: float,
                              generator: Optional[torch.Generator]) -> torch.Tensor:
    limit = math.sqrt(3.0 * scale / fan)
    with torch.no_grad():
        return w.uniform_(-limit, limit, generator=generator)


def activation_init_(w: torch.Tensor, fan_in: int, fan_out: int,
                     activation: Optional[str],
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    """He-uniform for relu/lrelu, xavier-uniform otherwise (blocks.py:78-84)."""
    if activation in ("relu", "lrelu"):
        return variance_scaling_uniform_(w, 2.0, fan_in, generator)
    return variance_scaling_uniform_(w, 1.0, (fan_in + fan_out) / 2.0, generator)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's default Dense init: truncated normal (+-2 sigma) with
    variance 1/fan_in, corrected for the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


# -- f32-accumulating convolution ---------------------------------------------


def _exact_products(x: torch.Tensor):
    """Context in which an f32 cuDNN conv of upcast operands forms exact
    products. For bf16 operands on the card TF32 is allowed: a bf16 value
    (8-bit mantissa) is exact in TF32 (11-bit), so the tensor cores still form
    exact products and sum them in f32."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        cudnn = torch.backends.cudnn
        return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                           deterministic=cudnn.deterministic, allow_tf32=True)
    return contextlib.nullcontext()


class _ConvF32Acc(torch.autograd.Function):
    """``_conv_f32acc`` of the JAX package (blocks.py:29-60): the forward
    keeps the f32 sums; the backward casts the cotangent to the operand dtype
    and runs the two transposed convolutions in that dtype, so ``dx`` and
    ``dw`` are f32 sums of exact products rounded once to the operand dtype."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with _exact_products(x):
            return F.conv3d(x.to(torch.float32), w.to(torch.float32), stride=stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        f32 = torch.float32
        g = g.to(x.dtype).to(f32)
        dx = dw = None
        with _exact_products(x):
            if ctx.needs_input_grad[0]:
                dx = torch.nn.grad.conv3d_input(x.shape, w.to(f32), g,
                                                stride=ctx.stride).to(x.dtype)
            if ctx.needs_input_grad[1]:
                dw = torch.nn.grad.conv3d_weight(x.to(f32), w.shape, g,
                                                 stride=ctx.stride).to(w.dtype)
        return dx, dw, None


def conv3d_f32acc(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """VALID 3D conv of compute-dtype operands with f32 accumulation.

    ``x`` is NCDHW, ``w`` OIDHW, both already rounded to the compute dtype;
    the result is f32. The operands are upcast so every product is exact.
    Differentiable, with the JAX package's mixed-precision backward.
    """
    return _ConvF32Acc.apply(x, w, stride)


def to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def edge_pad(x_ncdhw: torch.Tensor, pad: int) -> torch.Tensor:
    """Replicate ('edge') padding on the three spatial axes."""
    return F.pad(x_ncdhw, (pad,) * 6, mode="replicate")


# -- modules -------------------------------------------------------------------


class Dense(nn.Module):
    """flax ``nn.Dense`` semantics: input and kernel cast to ``dtype``, the
    product in ``dtype`` (f32 accumulation inside the matmul), then the bias
    added in ``dtype``. ``weight`` is stored ``[out, in]``."""

    def __init__(self, in_features: int, features: int, *, use_bias: bool = True,
                 activation_init: Optional[str] = "lecun",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        if activation_init == "lecun":
            lecun_normal_(self.weight, in_features, generator)
        else:
            activation_init_(self.weight, in_features, features,
                             activation_init, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), weight(self.weight, self.dtype))
        if self.bias is not None:
            y = y + weight(self.bias, self.dtype)
        return y


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-5)``: statistics in f32 with the fast
    variance E[x^2] - E[x]^2 clipped at 0, normalisation in f32, output cast
    to ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class DenseBlock(nn.Module):
    """Linear + optional activation (network_utils.py:257-289). The inner
    layer is named ``Dense_0`` after flax's auto-name."""

    def __init__(self, in_features: int, features: int,
                 activation: Optional[str] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.Dense_0 = Dense(in_features, features, activation_init=activation,
                             dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return act_fn(self.activation)(self.Dense_0(x))


class Conv3D(nn.Module):
    """3D conv with replicate padding ``k // 2``, stride ``s``, optional
    activation (network_utils.py:128-170). ``[B, D, H, W, C]`` in and out;
    ``weight`` is stored OIDHW. The JAX package's ``zshift_2d`` and
    ``s2d_matmul`` are TPU schedules of this same function."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 strides: int = 1, activation: Optional[str] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size = kernel_size
        self.strides = strides
        self.activation = activation
        self.dtype = dtype
        k3 = kernel_size ** 3
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel_size, kernel_size, kernel_size))
        activation_init_(self.weight, k3 * in_features, k3 * features,
                         activation, generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def kernel_dhwio(self) -> torch.Tensor:
        """The weight in the JAX package's ``[k, k, k, Cin, Cout]`` layout."""
        return self.weight.permute(2, 3, 4, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.kernel_size // 2
        xc = to_ncdhw(x).to(self.dtype)
        if pad:
            xc = edge_pad(xc, pad)
        y = conv3d_f32acc(xc, weight(self.weight, self.dtype), self.strides)
        y = to_ndhwc(y + self.bias[:, None, None, None])  # f32 conv + bias
        return act_fn(self.activation)(y.to(self.dtype))


class Conv3DUpsample(nn.Module):
    """conv -> trilinear x``strides`` upsample -> conv (network_utils.py:237-254),
    the (upsample -> conv) pair computed by the phase decomposition of
    ``ops/upsample_conv``. ``out_kernel`` stays ``[k, k, k, Cin, Cout]``, the
    layout the phase composition consumes."""

    def __init__(self, in_features: int, features: int, strides: int,
                 kernel_size: int = 3, activation: Optional[str] = None,
                 fast: bool = True, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.strides = strides
        self.activation = activation
        self.fast = fast
        self.dtype = dtype
        self.conv_in = Conv3D(in_features, features, kernel_size, 1, activation,
                              dtype=dtype, generator=generator)
        k3 = kernel_size ** 3
        self.out_kernel = nn.Parameter(
            torch.empty(kernel_size, kernel_size, kernel_size, features, features))
        activation_init_(self.out_kernel, k3 * features, k3 * features,
                         activation, generator)
        self.out_bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, pre_only: bool = False):
        """``pre_only=True`` stops after ``conv_in`` and returns ``(h,
        out_kernel, out_bias)``, the two f32 parameters as they are: the
        inputs of the inline-upsample decoder tail (``ops/cuda/
        decoder_head_v3``), which makes u0 itself."""
        from voxactb_tpu_torch.ops.upsample_conv import (
            reference_upsample_conv, upsample_conv)

        if self.strides <= 1:
            raise NotImplementedError("Conv3DUpsample with strides <= 1")
        x = self.conv_in(x)
        if pre_only:
            return x, self.out_kernel, self.out_bias
        op = upsample_conv if self.fast else reference_upsample_conv
        y = op(x.to(self.dtype), weight(self.out_kernel, self.dtype),
               weight(self.out_bias, self.dtype), self.strides)
        return act_fn(self.activation)(y).to(self.dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA expands it, ``1 / (1 + exp(-x))`` op by op in
    ``x``'s dtype (at bf16 ``torch.sigmoid`` rounds once and differs from it
    in about a third of the outputs)."""
    return torch.reciprocal(1.0 + torch.exp(-x))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=False)``, ``0.5 x erfc(-x sqrt(1/2))``,
    op by op in ``x``'s dtype with the constants rounded to it (at bf16 every
    op rounds, as in the JAX package)."""
    def c(v):
        return rounded(v, x.dtype)

    return x * c(0.5) * torch.special.erfc(-x * c(math.sqrt(0.5)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation, its default) op by op in ``x``'s
    dtype with the constants rounded to it. At bf16 this is bit-identical to
    the JAX package; ``F.gelu(x, approximate="tanh")`` rounds once at the end
    and differs from it in about 40% of bf16 outputs by one ulp."""
    def c(v):
        return rounded(v, x.dtype)

    inner = (x + x ** 3 * c(0.044715)) * c(math.sqrt(2.0 / math.pi))
    return x * ((1.0 + torch.tanh(inner)) * c(0.5))


class Conv2D(nn.Module):
    """flax ``nn.Conv`` in 2D, ``[B, H, W, C]`` in and out: operands cast to
    ``dtype``, the f32 sum of their exact products rounded to ``dtype``, then
    the bias added in ``dtype``. ``weight`` is stored OIHW. ``padding`` is
    "VALID" or "SAME" (stride 1, odd kernel)."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 strides: int = 1, padding: str = "VALID", use_bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if padding not in ("VALID", "SAME") or (padding == "SAME" and (
                strides != 1 or kernel_size % 2 == 0)):
            raise ValueError(f"Conv2D padding {padding!r} with kernel {kernel_size}, "
                             f"stride {strides}")
        self.strides = strides
        self.pad = kernel_size // 2 if padding == "SAME" else 0
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel_size,
                                               kernel_size))
        lecun_normal_(self.weight, in_features * kernel_size ** 2, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = x.permute(0, 3, 1, 2).to(self.dtype)
        with _exact_products(xc):
            y = F.conv2d(xc.to(torch.float32),
                         weight(weight(self.weight, self.dtype), torch.float32),
                         stride=self.strides, padding=self.pad)
        y = y.to(self.dtype).permute(0, 2, 3, 1)
        return y if self.bias is None else y + weight(self.bias, self.dtype)


class ConvTranspose2D(nn.Module):
    """flax ``nn.ConvTranspose`` with "VALID" padding, ``[B, H, W, C]`` in and
    out, rounded as ``Conv2D``. ``weight`` is stored ``[in, out, kh, kw]`` as
    torch's ``ConvTranspose2d`` holds it: flax keeps the kernel ``[kh, kw, in,
    out]`` in forward-conv orientation, i.e. spatially flipped
    (``weights.py`` maps one to the other)."""

    def __init__(self, in_features: int, features: int, kernel_size: int, strides: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.strides = strides
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_features, features, kernel_size,
                                               kernel_size))
        lecun_normal_(self.weight, in_features * kernel_size ** 2, generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = x.permute(0, 3, 1, 2).to(self.dtype)
        with _exact_products(xc):
            y = F.conv_transpose2d(xc.to(torch.float32),
                                   weight(weight(self.weight, self.dtype), torch.float32),
                                   stride=self.strides)
        return y.to(self.dtype).permute(0, 2, 3, 1) + weight(self.bias, self.dtype)


# -- spatial statistics ---------------------------------------------------------


def _position_grids(n: int, device) -> torch.Tensor:
    """[S, 3] positions (lin[dim1], lin[dim0], lin[dim2]) of a cubic grid —
    the reference's meshgrid-'xy' axis quirk (network_utils.py:782-786).
    ``torch.linspace`` may differ from ``jnp.linspace`` by 1 ulp at some
    points; the tests state the keypoint tolerance that covers it."""
    lin = torch.linspace(-1.0, 1.0, n, dtype=torch.float32, device=device)
    pos_x = lin[None, :, None].expand(n, n, n).reshape(-1)  # lin[dim1]
    pos_y = lin[:, None, None].expand(n, n, n).reshape(-1)  # lin[dim0]
    pos_z = lin[None, None, :].expand(n, n, n).reshape(-1)  # lin[dim2]
    return torch.stack([pos_x, pos_y, pos_z], -1)


def spatial_softmax_3d(feature: torch.Tensor,
                       temperature: float = TEMPERATURE) -> torch.Tensor:
    """Per-channel soft-argmax over a cubic grid -> ``[B, C*3]`` (x, y, z)
    triplets, with the meshgrid-'xy' quirk."""
    b, d, h, w, c = feature.shape
    assert d == h == w, "SpatialSoftmax3D expects a cubic grid"
    flat = feature.reshape(b, d * h * w, c).to(torch.float32)
    attn = torch.softmax(flat * (1.0 / temperature), dim=1)
    pos = _position_grids(d, feature.device)
    return torch.einsum("bsc,sk->bck", attn, pos).reshape(b, c * 3)


def softargmax_stats_3d(feature: torch.Tensor, temperature: float = TEMPERATURE):
    """(spatial soft-argmax ``[B, C*3]``, global max ``[B, C]``), both f32,
    in the two-pass form of the JAX package: the max pass is the global-max
    pool and one contraction with (ones | pos) gives the partition function
    and the three expected coordinates."""
    b, d, h, w, c = feature.shape
    assert d == h == w, "softargmax_stats_3d expects a cubic grid"
    flat = feature.reshape(b, d * h * w, c).to(torch.float32)
    m = flat.amax(dim=1)
    # XLA compiles "/ 0.01" as "* f32(100)"
    e = torch.exp((flat - m[:, None, :]) * (1.0 / temperature))
    pos = _position_grids(d, feature.device)
    p = torch.cat([torch.ones_like(pos[:, :1]), pos], -1)
    sums = torch.einsum("bsc,sk->bck", e, p)
    kp = sums[..., 1:] / sums[..., 0:1]
    return kp.reshape(b, c * 3), m
