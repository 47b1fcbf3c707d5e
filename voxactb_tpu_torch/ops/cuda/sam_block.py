"""The non-GEMM stretches of SAM's ViT block as four hand-written kernels.

``csrc/sam_block.cu`` replaces no TPU kernel: the JAX package leaves these
stretches to XLA. Eager, each was several passes over the block's
``[4096, 1280]`` and ``[4096, 5120]`` tensors, most of them in f32, about
1.8 GB of device traffic per ViT-H block. Each kernel is bound by bytes: it
reads its input once and writes its output once, in the layout the next GEMM
or K7 (``ops/cuda/sam_attention``) reads.

- ``ln_rows``: ``norm1`` / ``norm2`` (``blocks.LayerNorm``'s function) of a
  ``[B, H, W, C]`` grid into ``[rows, C]``; with a ``window``, the
  window-partitioned, zero-padded rows ``window_partition`` builds.
- ``qkv_split``: the qkv GEMM's rows plus their bias into K7's
  ``[B * heads, T, hd]`` ``q * scale``, ``k`` and ``v``, with the f32 rel-pos
  terms of the unscaled ``q``.
- ``bias_gelu``: fc1's bias and ``blocks.gelu_erf``, the latter looked up
  in a table of its rounded value at every bf16 input, worked out once per
  device by the same formula on the card.
- ``bias_residual``: ``x + (y + bias)`` for proj (reading the window layout
  and dropping its padding) and fc2.

Each wrapper checks its arguments, takes its plain version (the eager
formulas, below) for CPU tensors and launches its kernel for CUDA ones, which
must be bf16. ``SamBlock`` takes the kernels (``ops_for``) for a CUDA bf16
input and the plain versions otherwise. The kernels keep every rounding of the
plain versions: ``bias_gelu``, ``bias_residual`` and the layouts are
bit-equal to them; LayerNorm's statistics and the rel terms' dot products sum
in another f32 order. Launches go on the current stream and allocate nothing
(the wrappers allocate with ``torch.empty``), so a CUDA graph captures them.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from voxactb_tpu_torch.models.blocks import gelu_erf, rounded
from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.resize import resize_linear

MAX_LN_WIDTH = 2048  # ln_rows: eight 16-byte vectors a lane
MAX_HEAD_DIM = 128
_VP, _CI, _CF, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


# -- layouts ---------------------------------------------------------------------


def window_partition(x: torch.Tensor, window: int):
    """``[B, H, W, C]`` -> (``[B * nW, window, window, C]``, padded (Hp, Wp));
    the grid is zero-padded to a multiple of the window."""
    b, h, w, c = x.shape
    pad_h = (window - h % window) % window
    pad_w = (window - w % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, window: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window // window)
    x = windows.reshape(b, hp // window, wp // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)[:, :h, :w]


def padded_grid(h: int, w: int, window: int) -> Tuple[int, int]:
    """(Hp, Wp): the grid padded to a multiple of ``window`` (0: unpadded)."""
    if window == 0:
        return h, w
    return -(-h // window) * window, -(-w // window) * window


def rel_pos_embed(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Interpolate/select relative position embeddings (SAM's get_rel_pos):
    ``[2 * max(q, k) - 1, hd]`` (resized linearly if it has another length)
    -> ``[q_size, k_size, hd]``."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = resize_linear(rel_pos, (max_rel_dist, rel_pos.shape[1]))
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.to(torch.int64)]


# -- plain versions ----------------------------------------------------------------


def ln_rows_plain(x, weight, bias, *, eps: float, window: int) -> torch.Tensor:
    """``blocks.LayerNorm`` of ``x`` ``[B, H, W, C]`` (f32 statistics with the
    fast variance, output in ``x.dtype``) as ``[B * H * W, C]`` rows, or with
    a ``window`` the rows of ``window_partition``'s layout."""
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * weight
    y = ((xf - mean) * mul + bias).to(x.dtype)
    if window > 0:
        y = window_partition(y, window)[0]
    return y.reshape(-1, x.shape[-1])


def ln_rows_bound(x, weight, *, eps: float, window: int) -> torch.Tensor:
    """How far, per output of ``ln_rows``, the kernel's f32 value may lie from
    the plain version's before both round to bf16 (so the bf16 outputs lie
    within this plus one bf16 ulp): the two sum each row's x and x^2 in other
    orders, each sum within gamma_C = C u / (1 - C u) (u = 2^-24) of the
    exact one times the sum of magnitudes, and that reaches the output
    through the mean and through rsqrt(var + eps). The rows are laid out as
    ``ln_rows`` lays them (zero for padding rows)."""
    f64 = torch.float64
    xf = x.to(f64)
    u = x.shape[-1] * 2.0 ** -24
    gamma = u / (1 - u)
    mean, ex2 = xf.mean(-1, keepdim=True), (xf * xf).mean(-1, keepdim=True)
    var = (ex2 - mean * mean).clamp_min(0.0) + eps
    d_mean = 2 * gamma * xf.abs().mean(-1, keepdim=True)
    d_var = 2 * gamma * ex2 + 2 * mean.abs() * d_mean + d_mean * d_mean
    bound = (d_mean + (xf - mean).abs() * d_var / (2 * var)) * var.rsqrt() * weight.abs()
    if window > 0:
        bound = window_partition(bound, window)[0]
    return bound.reshape(-1, x.shape[-1])


def qkv_split_plain(qkv, bias, *, heads: int, grid: Tuple[int, int], scale: float,
                    rel_pos: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]] = (None, None)):
    """The qkv GEMM's ``[B * kh * kw, 3C]`` rows plus ``bias`` -> ``(q * scale,
    k, v)`` ``[B * heads, kh * kw, hd]`` and the f32 rel terms ``[B * heads,
    kh * kw, kh]``, ``[..., kw]`` of the unscaled q against the ``rel_pos``
    tables (zeros without them)."""
    kh, kw = grid
    t = kh * kw
    b = qkv.shape[0] // t
    hd = qkv.shape[1] // (3 * heads)
    x = (qkv + bias).reshape(b, t, 3, heads, hd)
    q, k, v = (u.transpose(1, 2) for u in x.unbind(2))  # each [B, heads, T, hd]
    f32 = torch.float32
    if rel_pos[0] is not None:
        rq = q.reshape(b, heads, kh, kw, hd).to(f32)
        rh = torch.einsum("bnhwc,hkc->bnhwk", rq, rel_pos_embed(kh, kh, rel_pos[0].to(f32)))
        rw = torch.einsum("bnhwc,wkc->bnhwk", rq, rel_pos_embed(kw, kw, rel_pos[1].to(f32)))
        rel_h, rel_w = rh.reshape(b * heads, t, kh), rw.reshape(b * heads, t, kw)
    else:
        rel_h = qkv.new_zeros(b * heads, t, kh, dtype=f32)
        rel_w = qkv.new_zeros(b * heads, t, kw, dtype=f32)
    flat = lambda u: u.reshape(b * heads, t, hd)  # noqa: E731
    return flat(q * scale), flat(k), flat(v), rel_h, rel_w


def bias_gelu_plain(y, bias) -> torch.Tensor:
    """``blocks.gelu_erf(y + bias)``."""
    return gelu_erf(y + bias)


def bias_residual_plain(x, y, bias, *, window: int) -> torch.Tensor:
    """``x`` ``[B, H, W, C]`` plus ``y + bias``, ``y`` the ``[B * H * W, C]``
    rows or, with a ``window``, the rows of the window layout."""
    y = y + bias
    b, h, w, c = x.shape
    if window > 0:
        y = window_unpartition(y.reshape(-1, window, window, c), window,
                               padded_grid(h, w, window), (h, w))
    return x + y.reshape(x.shape)


# -- argument checks -------------------------------------------------------------


def _fail(name: str, msg: str):
    raise ValueError(f"sam_block.{name}: {msg}")


def _check_rows(name: str, t: torch.Tensor, what: str, dims: int) -> None:
    if t.dim() != dims:
        _fail(name, f"{what} has shape {tuple(t.shape)}, wants {dims} dims")
    if not t.is_contiguous():
        _fail(name, f"{what} of strides {t.stride()} is not contiguous")


def _check_vector(name: str, t: torch.Tensor, what: str, n: int, dtype) -> None:
    if tuple(t.shape) != (n,) or t.dtype != dtype or not t.is_contiguous():
        _fail(name, f"{what} is {t.dtype} {tuple(t.shape)} of strides {t.stride()}, wants a "
                    f"contiguous {dtype} ({n},)")


def _window_rows(name: str, x: torch.Tensor, window: int) -> int:
    if window < 0:
        _fail(name, f"window {window} < 0")
    b, h, w, _ = x.shape
    hp, wp = padded_grid(h, w, window)
    return b * hp * wp


def _check_ln(x, weight, bias, window) -> int:
    _check_rows("ln_rows", x, "x", 4)
    c = x.shape[-1]
    for t, what in ((weight, "weight"), (bias, "bias")):
        _check_vector("ln_rows", t, what, c, torch.float32)
    return _window_rows("ln_rows", x, window)


def _check_qkv(qkv, bias, heads, grid, rel_pos) -> Tuple[int, int]:
    _check_rows("qkv_split", qkv, "qkv", 2)
    kh, kw = grid
    n, width = qkv.shape
    if kh < 1 or kw < 1 or n % (kh * kw) or heads < 1 or width % (3 * heads):
        _fail("qkv_split", f"qkv {tuple(qkv.shape)} is not B * {kh} * {kw} rows of 3 x "
                           f"{heads} heads")
    _check_vector("qkv_split", bias, "bias", width, qkv.dtype)
    hd = width // (3 * heads)
    if (rel_pos[0] is None) != (rel_pos[1] is None):
        _fail("qkv_split", "takes both rel-pos tables or neither")
    for t, what in zip(rel_pos, ("rel_pos_h", "rel_pos_w")):
        if t is not None and (t.dim() != 2 or t.shape[1] != hd or t.dtype != torch.float32):
            _fail("qkv_split", f"{what} is {t.dtype} {tuple(t.shape)}, wants f32 [L, {hd}]")
    return n // (kh * kw), hd


def _check_gelu(y, bias) -> None:
    _check_rows("bias_gelu", y, "y", 2)
    _check_vector("bias_gelu", bias, "bias", y.shape[1], y.dtype)


def _check_residual(x, y, bias, window) -> None:
    _check_rows("bias_residual", x, "x", 4)
    _check_rows("bias_residual", y, "y", 2)
    rows, c = _window_rows("bias_residual", x, window), x.shape[-1]
    if tuple(y.shape) != (rows, c) or y.dtype != x.dtype:
        _fail("bias_residual", f"y is {y.dtype} {tuple(y.shape)}, wants {x.dtype} "
                               f"({rows}, {c}) for x {tuple(x.shape)} and window {window}")
    _check_vector("bias_residual", bias, "bias", c, x.dtype)


def _check_launch(name: str, acts, params, width: int, limit: int) -> None:
    """What the kernels take beyond the plain versions: CUDA bf16 activations
    and biases (``acts``, read as 16-byte vectors, so 16-byte aligned), CUDA
    f32 ``params`` (read value by value), rows of 16-byte vectors."""
    for ts, dtype in ((acts, torch.bfloat16), (params, torch.float32)):
        for t in ts:
            if t.dtype != dtype or not t.is_cuda:
                _fail(name, f"the kernel takes CUDA {dtype}; got {t.dtype} on {t.device}")
    if any(t.data_ptr() % 16 for t in acts):
        _fail(name, "the kernel takes 16-byte aligned activations and biases")
    if width % 8 or not 8 <= width <= limit:
        _fail(name, f"the kernel takes a width that is a multiple of 8 up to {limit}; "
                    f"got {width}")


# -- wrappers ----------------------------------------------------------------------


def ln_rows(x, weight, bias, *, eps: float, window: int) -> torch.Tensor:
    """``ln_rows_plain`` on the CPU; on the card the kernel, bf16 ``x``."""
    rows = _check_ln(x, weight, bias, window)
    if not x.is_cuda:
        return ln_rows_plain(x, weight, bias, eps=eps, window=window)
    from voxactb_tpu_torch.ops.cuda.build import check, entry, stream_ptr

    b, h, w, c = x.shape
    _check_launch("ln_rows", (x,), (weight, bias), c, MAX_LN_WIDTH)
    out = torch.empty(rows, c, dtype=x.dtype, device=x.device)
    lib, fn = entry("sam_block", "voxactb_sam_ln_rows",
                    [_VP] * 4 + [_CL] + [_CI] * 4 + [_CF, _VP])
    check(lib, "sam_block", fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                               out.data_ptr(), rows, c, h, w, window, eps,
                               stream_ptr(x.device)))
    LAUNCHES["sam_ln"] += 1
    return out


def _rel_table(rel_pos: Optional[torch.Tensor], size: int) -> Optional[torch.Tensor]:
    """``rel_pos`` as the kernel indexes it: ``[2 * size - 1, hd]`` f32,
    resized as ``rel_pos_embed`` resizes it."""
    if rel_pos is None:
        return None
    if rel_pos.shape[0] != 2 * size - 1:
        rel_pos = resize_linear(rel_pos, (2 * size - 1, rel_pos.shape[1]))
    return rel_pos.contiguous()


def qkv_split(qkv, bias, *, heads: int, grid: Tuple[int, int], scale: float,
              rel_pos: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]] = (None, None)):
    """``qkv_split_plain`` on the CPU; on the card the kernel, bf16 ``qkv``."""
    b, hd = _check_qkv(qkv, bias, heads, grid, rel_pos)
    if not qkv.is_cuda:
        return qkv_split_plain(qkv, bias, heads=heads, grid=grid, scale=scale, rel_pos=rel_pos)
    from voxactb_tpu_torch.ops.cuda.build import check, entry, stream_ptr

    kh, kw = grid
    tab_h, tab_w = _rel_table(rel_pos[0], kh), _rel_table(rel_pos[1], kw)
    tables = () if tab_h is None else (tab_h, tab_w)
    _check_launch("qkv_split", (qkv, bias), tables, hd, MAX_HEAD_DIM)
    t = kh * kw
    q, k, v = (torch.empty(b * heads, t, hd, dtype=qkv.dtype, device=qkv.device)
               for _ in range(3))
    rel_h = torch.empty(b * heads, t, kh, dtype=torch.float32, device=qkv.device)
    rel_w = torch.empty(b * heads, t, kw, dtype=torch.float32, device=qkv.device)
    lib, fn = entry("sam_block", "voxactb_sam_qkv_split", [_VP] * 9 + [_CI] * 5 + [_CF, _VP])
    ptr = lambda u: None if u is None else u.data_ptr()  # noqa: E731
    check(lib, "sam_block", fn(qkv.data_ptr(), bias.data_ptr(), ptr(tab_h), ptr(tab_w),
                               q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(),
                               rel_w.data_ptr(), b, heads, hd, kh, kw, scale,
                               stream_ptr(qkv.device)))
    LAUNCHES["sam_qkv_split"] += 1
    return q, k, v, rel_h, rel_w


_GELU_TABLES: Dict[torch.device, torch.Tensor] = {}


def _gelu_table(device: torch.device) -> torch.Tensor:
    """The GELU of every bf16 input on ``device``, worked out once by the
    formula on the card (``sam_gelu_table``): what ``bias_gelu`` looks up."""
    if device not in _GELU_TABLES:
        from voxactb_tpu_torch.ops.cuda.build import check, entry, stream_ptr

        table = torch.empty(1 << 16, dtype=torch.bfloat16, device=device)
        lib, fn = entry("sam_block", "voxactb_sam_gelu_table", [_VP, _CF, _CF, _VP])
        bf = torch.bfloat16
        check(lib, "sam_block", fn(table.data_ptr(), rounded(0.5, bf),
                                   rounded(math.sqrt(0.5), bf), stream_ptr(device)))
        _GELU_TABLES[device] = table
    return _GELU_TABLES[device]


def bias_gelu(y, bias) -> torch.Tensor:
    """``bias_gelu_plain`` on the CPU; on the card the kernel, bf16 ``y``."""
    _check_gelu(y, bias)
    if not y.is_cuda:
        return bias_gelu_plain(y, bias)
    from voxactb_tpu_torch.ops.cuda.build import check, entry, stream_ptr

    _check_launch("bias_gelu", (y, bias), (), y.shape[1], y.shape[1])
    table = _gelu_table(y.device)
    out = torch.empty_like(y)
    lib, fn = entry("sam_block", "voxactb_sam_bias_gelu", [_VP] * 4 + [_CL, _CI, _VP])
    check(lib, "sam_block", fn(y.data_ptr(), bias.data_ptr(), table.data_ptr(), out.data_ptr(),
                               y.numel(), y.shape[1], stream_ptr(y.device)))
    LAUNCHES["sam_bias_gelu"] += 1
    return out


def bias_residual(x, y, bias, *, window: int) -> torch.Tensor:
    """``bias_residual_plain`` on the CPU; on the card the kernel, bf16."""
    _check_residual(x, y, bias, window)
    if not x.is_cuda:
        return bias_residual_plain(x, y, bias, window=window)
    from voxactb_tpu_torch.ops.cuda.build import check, entry, stream_ptr

    b, h, w, c = x.shape
    _check_launch("bias_residual", (x, y, bias), (), c, c)
    out = torch.empty_like(x)
    lib, fn = entry("sam_block", "voxactb_sam_bias_residual",
                    [_VP] * 4 + [_CL] + [_CI] * 4 + [_VP])
    check(lib, "sam_block", fn(x.data_ptr(), y.data_ptr(), bias.data_ptr(), out.data_ptr(),
                               b * h * w, c, h, w, window, stream_ptr(x.device)))
    LAUNCHES["sam_bias_residual"] += 1
    return out


class Ops(NamedTuple):
    ln_rows: Callable
    qkv_split: Callable
    bias_gelu: Callable
    bias_residual: Callable


KERNELS = Ops(ln_rows, qkv_split, bias_gelu, bias_residual)
PLAIN = Ops(ln_rows_plain, qkv_split_plain, bias_gelu_plain, bias_residual_plain)


def ops_for(x: torch.Tensor) -> Ops:
    """The kernels for a CUDA bf16 block input, else the plain versions."""
    return KERNELS if x.is_cuda and x.dtype == torch.bfloat16 else PLAIN
