"""SAM's block kernels (``ops/cuda/sam_block.py``, ``csrc/sam_block.cu``).

On the CPU (small widths, no JAX): each plain version equals, bit for bit at
bf16 and f32, the eager formula it replaced in ``SamBlock`` /
``WindowAttention`` (restated below as ``old_*``), windowed with padding and
global, and so does a whole block; the wrappers take the plain versions for
CPU tensors, launch nothing, and raise on a wrong dtype, shape or stride; a
model of the kernels' row mappings covers the window layout.

On the card (``python -m pytest tests/test_torch_sam_block_fused.py -m card
--noconftest -q``), at ViT-H's shapes: each kernel against its plain version
(``bias_gelu``, ``bias_residual``, q/k/v and the window layouts bit-equal;
LayerNorm within an f32 sum-order bound plus one bf16 ulp, the rel terms
within an f32 sum-order bound), a whole bf16 block of each kind, and the
launches of a replayed encoder pass.
"""

import pytest
import torch
import torch.nn.functional as F

from voxactb_tpu_torch.models import sam_encoder as S
from voxactb_tpu_torch.models.blocks import gelu_erf, rounded
from voxactb_tpu_torch.ops import cuda
from voxactb_tpu_torch.ops.cuda import sam_block as B
from voxactb_tpu_torch.ops.sam_attention import global_rel_attention_plain

DTYPES = (torch.float32, torch.bfloat16)
# (dim, heads, window, grid): a 7 x 7 grid in windows of 3 pads to 9 x 9
KINDS = {"windowed": (32, 2, 3, (7, 7)), "global": (32, 2, 0, (7, 7))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def block_of(kind, dtype, seed=0, device="cpu"):
    """A ``SamBlock`` with every parameter drawn (biases, norms and rel-pos
    tables too, which start at constants), and an input grid."""
    dim, heads, window, grid = KINDS[kind] if isinstance(kind, str) else kind
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        blk = S.SamBlock(dim, heads, window_size=window, grid_size=grid, dtype=dtype,
                         generator=g)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if not name.endswith("weight") or "norm" in name:  # the norms' scales about 1
                p.normal_(1.0 if name.endswith("weight") else 0.0, 0.3, generator=g)
    x = (torch.randn(1, *grid, dim, generator=g, device=device) * 2 + 0.5).to(dtype)
    return blk, x


# -- the eager formulation the plain versions replaced --------------------------


def old_operands(attn, x):
    """``WindowAttention.forward`` up to K7's operands, on ``[B, h, w, C]``."""
    b, h, w, _ = x.shape
    heads, hd = attn.num_heads, attn.dim // attn.num_heads
    qkv = attn.qkv(x).reshape(b, h * w, 3, heads, hd)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    f32 = torch.float32
    if attn.use_rel_pos:
        rq = q.reshape(b, heads, h, w, hd).to(f32)
        rh = torch.einsum("bnhwc,hkc->bnhwk", rq, S._rel_pos_embed(h, h, attn.rel_pos_h.to(f32)))
        rw = torch.einsum("bnhwc,wkc->bnhwk", rq, S._rel_pos_embed(w, w, attn.rel_pos_w.to(f32)))
        rel_h, rel_w = rh.reshape(b * heads, h * w, h), rw.reshape(b * heads, h * w, w)
    else:
        rel_h = x.new_zeros(b * heads, h * w, h, dtype=f32)
        rel_w = x.new_zeros(b * heads, h * w, w, dtype=f32)
    scale = rounded(hd ** -0.5, q.dtype)
    flat = lambda t: t.reshape(b * heads, h * w, hd)  # noqa: E731
    return flat(q * scale), flat(k), flat(v), rel_h, rel_w


def old_attention(attn, x):
    b, h, w, _ = x.shape
    q, k, v, rel_h, rel_w = old_operands(attn, x)
    out = global_rel_attention_plain(q, k, v, rel_h, rel_w, kh=h, kw=w)
    return attn.proj(out.reshape(b, attn.num_heads, h * w, -1).transpose(1, 2)
                     .reshape(b, h, w, attn.dim))


def old_block(blk, x):
    y = blk.norm1(x)
    if blk.window_size > 0:
        hw = y.shape[1:3]
        y, pad_hw = S.window_partition(y, blk.window_size)
        y = S.window_unpartition(old_attention(blk.attn, y), blk.window_size, pad_hw, hw)
    else:
        y = old_attention(blk.attn, y)
    x = x + y
    return x + blk.mlp_fc2(gelu_erf(blk.mlp_fc1(blk.norm2(x))))


def same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), float((a.float() - b.float()).abs().max())


# -- CPU: plain versions against the formulas they replaced -----------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_ln_rows_plain_is_the_norm_and_partition(kind, dtype):
    blk, x = block_of(kind, dtype)
    ws = blk.window_size
    want = blk.norm1(x)
    if ws:
        want = S.window_partition(want, ws)[0]
    got = B.ln_rows_plain(x, blk.norm1.weight, blk.norm1.bias, eps=blk.norm1.eps, window=ws)
    same(got, want.reshape(-1, x.shape[-1]))
    if ws:  # 7 x 7 in windows of 3: 32 of the 81 padded rows are zero
        assert int((got.abs().sum(-1) == 0).sum()) == 81 - 49


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rel", (True, False))
def test_qkv_split_plain_is_the_attention_operands(kind, dtype, rel):
    blk, x = block_of(kind, dtype, seed=1)
    attn = blk.attn
    attn.use_rel_pos = rel
    ws = blk.window_size
    y = S.window_partition(x, ws)[0] if ws else x
    grid = tuple(y.shape[1:3])
    hd = attn.dim // attn.num_heads
    got = B.qkv_split_plain(
        F.linear(y.reshape(-1, attn.dim), attn.qkv.weight.to(dtype)), attn.qkv.bias.to(dtype),
        heads=attn.num_heads, grid=grid, scale=rounded(hd ** -0.5, dtype),
        rel_pos=(attn.rel_pos_h, attn.rel_pos_w) if rel else (None, None))
    for a, b in zip(got, old_operands(attn, y)):
        same(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bias_gelu_plain_is_gelu_of_the_dense(dtype):
    blk, x = block_of("global", dtype, seed=2)
    fc1 = blk.mlp_fc1
    rows = x.reshape(-1, x.shape[-1])
    same(B.bias_gelu_plain(F.linear(rows, fc1.weight.to(dtype)), fc1.bias.to(dtype)),
         gelu_erf(fc1(rows)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_bias_residual_plain_is_the_residual_add(kind, dtype):
    blk, x = block_of(kind, dtype, seed=3)
    ws, proj = blk.window_size, blk.attn.proj
    y = S.window_partition(x.flip(1), ws)[0] if ws else x.flip(1)
    want = proj(y)
    if ws:
        want = S.window_unpartition(want, ws, B.padded_grid(7, 7, ws), (7, 7))
    got = B.bias_residual_plain(x, F.linear(y.reshape(-1, x.shape[-1]), proj.weight.to(dtype)),
                                proj.bias.to(dtype), window=ws)
    same(got, x + want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_block_is_the_eager_block(kind, dtype):
    blk, x = block_of(kind, dtype, seed=4)
    before = cuda.launch_counts()
    same(blk(x), old_block(blk, x))
    assert cuda.launch_counts() == before


@pytest.mark.parametrize("dtype", DTYPES)
def test_wrappers_take_the_plain_versions_on_the_cpu(dtype):
    blk, x = block_of("windowed", dtype, seed=5)
    assert B.ops_for(x) is B.PLAIN
    ws, c = 3, x.shape[-1]
    before = cuda.launch_counts()
    same(B.ln_rows(x, blk.norm1.weight, blk.norm1.bias, eps=1e-6, window=ws),
         B.ln_rows_plain(x, blk.norm1.weight, blk.norm1.bias, eps=1e-6, window=ws))
    rows = torch.randn(81, 3 * c, generator=torch.Generator().manual_seed(0)).to(dtype)
    kw = dict(heads=2, grid=(3, 3), scale=0.25, rel_pos=(blk.attn.rel_pos_h, blk.attn.rel_pos_w))
    for a, b in zip(B.qkv_split(rows, blk.attn.qkv.bias.to(dtype), **kw),
                    B.qkv_split_plain(rows, blk.attn.qkv.bias.to(dtype), **kw)):
        same(a, b)
    bias = blk.mlp_fc1.bias.to(dtype)[:3 * c]
    same(B.bias_gelu(rows, bias), B.bias_gelu_plain(rows, bias))
    y, b = rows[:, :c].contiguous(), blk.attn.proj.bias.to(dtype)
    same(B.bias_residual(x, y, b, window=ws), B.bias_residual_plain(x, y, b, window=ws))
    assert cuda.launch_counts() == before


@pytest.mark.parametrize("kind", KINDS)
def test_ln_rows_bound_covers_another_sum_order(kind):
    """LayerNorm whose statistics are summed in another order (one lane per
    32nd channel first, as the kernel's warp does, then across lanes) lies
    within ``ln_rows_bound`` plus one bf16 ulp of the plain version, and the
    bound is 0 on padding rows."""
    blk, x = block_of(kind, torch.bfloat16, seed=6)
    ws, c = blk.window_size, x.shape[-1]
    w, b = blk.norm1.weight, blk.norm1.bias
    xf = x.float()
    lanes = lambda t: t.reshape(*t.shape[:-1], -1, 32).sum(-2).sum(-1, keepdim=True)  # noqa
    mean = lanes(xf) * (1.0 / c)
    var = torch.clamp(lanes(xf * xf) * (1.0 / c) - mean * mean, min=0.0)
    other = ((xf - mean) * (torch.rsqrt(var + 1e-6) * w) + b).to(x.dtype)
    if ws:
        other = S.window_partition(other, ws)[0]
    other = other.reshape(-1, c).float()
    want = B.ln_rows_plain(x, w, b, eps=1e-6, window=ws).float()
    bound = B.ln_rows_bound(x, w, eps=1e-6, window=ws)
    _, e = torch.frexp(torch.maximum(other.abs(), want.abs()).clamp_min(2.0 ** -126))
    assert bool(((other - want).abs() <= bound + torch.ldexp(torch.ones_like(want), e - 8)).all())
    if ws:
        assert not bool(bound[want.abs().sum(-1) == 0].any())


def test_ops_for_engages_on_cuda_bf16_only():
    class Probe:
        def __init__(self, is_cuda, dtype):
            self.is_cuda, self.dtype = is_cuda, dtype

    assert B.ops_for(Probe(True, torch.bfloat16)) is B.KERNELS
    assert B.ops_for(Probe(True, torch.float32)) is B.PLAIN
    assert B.ops_for(Probe(False, torch.bfloat16)) is B.PLAIN
    assert {"sam_ln", "sam_qkv_split", "sam_bias_gelu", "sam_bias_residual"} <= set(
        cuda.LAUNCHES)


def bad_calls():
    """(name, call) pairs each of which a wrapper must refuse."""
    bf = torch.bfloat16
    x = torch.zeros(1, 7, 7, 16, dtype=bf)
    w, b = torch.ones(16), torch.zeros(16)
    qkv, qb = torch.zeros(18, 48, dtype=bf), torch.zeros(48, dtype=bf)
    tab = torch.zeros(5, 8)
    qk = dict(heads=2, grid=(3, 3), scale=0.5)
    y, yb = torch.zeros(81, 16, dtype=bf), torch.zeros(16, dtype=bf)
    return {
        "ln_weight_dtype": lambda: B.ln_rows(x, w.to(bf), b, eps=1e-6, window=0),
        "ln_weight_shape": lambda: B.ln_rows(x, w[:8], b, eps=1e-6, window=0),
        "ln_x_stride": lambda: B.ln_rows(x.transpose(1, 2), w, b, eps=1e-6, window=0),
        "ln_x_dims": lambda: B.ln_rows(x[0], w, b, eps=1e-6, window=0),
        "ln_window": lambda: B.ln_rows(x, w, b, eps=1e-6, window=-1),
        "qkv_bias_dtype": lambda: B.qkv_split(qkv, qb.float(), **qk),
        "qkv_rows": lambda: B.qkv_split(qkv[:17], qb, **qk),
        "qkv_heads": lambda: B.qkv_split(qkv, qb, **{**qk, "heads": 5}),
        "qkv_stride": lambda: B.qkv_split(qkv.t().contiguous().t(), qb, **qk),
        "qkv_one_table": lambda: B.qkv_split(qkv, qb, rel_pos=(tab, None), **qk),
        "qkv_table_dtype": lambda: B.qkv_split(qkv, qb, rel_pos=(tab, tab.to(bf)), **qk),
        "qkv_table_width": lambda: B.qkv_split(qkv, qb, rel_pos=(tab, tab[:, :4]), **qk),
        "gelu_bias_dtype": lambda: B.bias_gelu(y, yb.float()),
        "gelu_bias_shape": lambda: B.bias_gelu(y, yb[:8]),
        "gelu_stride": lambda: B.bias_gelu(y.t(), yb),
        "residual_rows": lambda: B.bias_residual(x, y[:49], yb, window=3),
        "residual_global_rows": lambda: B.bias_residual(x, y, yb, window=0),
        "residual_dtype": lambda: B.bias_residual(x, y.float(), yb, window=3),
        "residual_bias_dtype": lambda: B.bias_residual(x, y, yb.float(), window=3),
        "residual_stride": lambda: B.bias_residual(x.transpose(1, 2), y, yb, window=3),
    }


@pytest.mark.parametrize("case", list(bad_calls()))
def test_wrapper_refuses(case):
    with pytest.raises(ValueError, match=r"sam_block\."):
        bad_calls()[case]()


# -- CPU: a model of the kernels' row mappings ----------------------------------


def grid_token(r, h, w, ws):
    """``csrc/sam_block.cu``'s ``grid_token``: the grid token of window row r, -1
    for padding."""
    if ws == 0:
        return r
    nwh, nww = -(-h // ws), -(-w // ws)
    p, win = r % (ws * ws), r // (ws * ws)
    wj, win = win % nww, win // nww
    wi, b = win % nwh, win // nwh
    i, j = wi * ws + p // ws, wj * ws + p % ws
    return (b * h + i) * w + j if i < h and j < w else -1


def window_row(g, h, w, ws):
    """``csrc/sam_block.cu``'s ``window_row``: the window row of grid token g."""
    if ws == 0:
        return g
    nwh, nww = -(-h // ws), -(-w // ws)
    j, t = g % w, g // w
    i, b = t % h, t // h
    return ((b * nwh + i // ws) * nww + j // ws) * (ws * ws) + (i % ws) * ws + j % ws


@pytest.mark.parametrize("b, h, w, ws", [(1, 7, 7, 3), (2, 7, 5, 3), (1, 64, 64, 14),
                                         (1, 9, 9, 3), (2, 8, 8, 0)])
def test_row_mappings_are_window_partition(b, h, w, ws):
    """Window row r holds grid token ``grid_token(r)`` (padding -1) as
    ``window_partition`` lays the grid out, and ``window_row`` inverts it."""
    tokens = torch.arange(b * h * w, dtype=torch.float64).reshape(b, h, w, 1) + 1
    laid = (S.window_partition(tokens, ws)[0] if ws else tokens).reshape(-1).long() - 1
    got = torch.tensor([grid_token(r, h, w, ws) for r in range(laid.numel())])
    assert torch.equal(got, laid)
    back = torch.tensor([window_row(g, h, w, ws) for g in range(b * h * w)])
    assert torch.equal(laid[back], torch.arange(b * h * w))


# -- the card ------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `python -m pytest "
                    "tests/test_torch_sam_block_fused.py -m card --noconftest -q` on the card")
    return torch.device("cuda")


VIT_H = dict(dim=1280, heads=16, hd=80, window=14, grid=64, hidden=5120)


def ulps(a, b):
    """Distance in bf16 ulps of two bf16 tensors (as ordered integers)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    return (ordered(a) - ordered(b)).abs()


def noise(g, shape, dev, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def bf16_ulp(v):
    """One bf16 ulp at the magnitude of ``v`` (f32)."""
    _, e = torch.frexp(v.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v), e - 8)


@pytest.mark.card
@pytest.mark.parametrize("window", (14, 0))
def test_ln_rows_kernel(card, window):
    """Within ``ln_rows_bound`` plus one bf16 ulp of the plain version (the
    statistics sum in another f32 order; the shares one ulp and more apart
    are printed: more only where the output cancels to near 0), padding rows
    exactly 0, and the windowed rows exactly the global rows partitioned."""
    g = torch.Generator(device=card).manual_seed(10)
    c = VIT_H["dim"]
    x = noise(g, (1, 64, 64, c), card, 3.0) + 0.5
    w = torch.randn(c, generator=g, device=card) * 0.3 + 1
    b = torch.randn(c, generator=g, device=card) * 0.3
    got = B.ln_rows(x, w, b, eps=1e-6, window=window)
    want = B.ln_rows_plain(x, w, b, eps=1e-6, window=window)
    d = ulps(got, want)
    err = (got.float() - want.float()).abs()
    tol = B.ln_rows_bound(x, w, eps=1e-6, window=window) + bf16_ulp(
        torch.maximum(got.float().abs(), want.float().abs()))
    print(f"ln_rows window {window}: {float((d == 1).float().mean()):.3e} of outputs one ulp "
          f"apart, {int((d > 1).sum())} more (largest |out| among them "
          f"{float(want.float().abs()[d > 1].max()) if bool((d > 1).any()) else 0.0:.3g}); "
          f"largest error over its bound {float((err / tol).max()):.3g}")
    assert bool((err <= tol).all())
    if window:
        pad = want.float().abs().sum(-1) == 0
        assert int(pad.sum()) == 70 * 70 - 64 * 64 and not bool(got[pad].any())
        flat = B.ln_rows(x, w, b, eps=1e-6, window=0).reshape(1, 64, 64, c)
        assert torch.equal(got, S.window_partition(flat, window)[0].reshape(-1, c))


@pytest.mark.card
@pytest.mark.parametrize("window", (14, 0))
def test_qkv_split_kernel(card, window):
    """q * scale, k and v bit-equal to the plain version; the f32 rel terms
    within 2 * hd * 2^-24 * sum |q||t| of the plain version's einsums."""
    g = torch.Generator(device=card).manual_seed(11)
    c, heads, hd = VIT_H["dim"], VIT_H["heads"], VIT_H["hd"]
    kh = window or VIT_H["grid"]
    n = (25 if window else 1) * kh * kh
    qkv = noise(g, (n, 3 * c), card, 2.0)
    bias = noise(g, (3 * c,), card, 0.5)
    tabs = tuple(torch.randn(2 * kh - 1, hd, generator=g, device=card) * 0.1 for _ in range(2))
    kw = dict(heads=heads, grid=(kh, kh), scale=rounded(hd ** -0.5, torch.bfloat16))
    got = B.qkv_split(qkv, bias, rel_pos=tabs, **kw)
    want = B.qkv_split_plain(qkv, bias, rel_pos=tabs, **kw)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    # the same terms of |q| against |t|: sum |q||t| for each
    bound = B.qkv_split_plain((qkv + bias).abs(), torch.zeros_like(bias),
                              rel_pos=tuple(t.abs() for t in tabs), **kw)
    for a, b, s in zip(got[3:], want[3:], bound[3:]):
        err = (a - b).abs()
        assert bool((err <= 2 * hd * 2.0 ** -24 * s).all()), float(err.max())
    zeros = B.qkv_split(qkv, bias, **kw)
    assert not bool(zeros[3].any()) and not bool(zeros[4].any())


@pytest.mark.card
def test_bias_gelu_kernel(card):
    """Bit-equal to the plain version at ViT-H's MLP width, and its table is
    ``gelu_erf`` of every bf16 value (NaNs at the same inputs)."""
    g = torch.Generator(device=card).manual_seed(12)
    y = noise(g, (4096, VIT_H["hidden"]), card, 3.0)
    bias = noise(g, (VIT_H["hidden"],), card, 1.0)
    assert torch.equal(B.bias_gelu(y, bias), B.bias_gelu_plain(y, bias))
    every = torch.arange(1 << 16, dtype=torch.int32, device=card).to(torch.int16).view(
        torch.bfloat16)
    table, want = B._gelu_table(every.device), gelu_erf(every)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(table), nan) and int(nan.sum()) > 0
    assert torch.equal(table[~nan].view(torch.int16), want[~nan].view(torch.int16))


@pytest.mark.card
@pytest.mark.parametrize("window", (14, 0))
def test_bias_residual_kernel(card, window):
    g = torch.Generator(device=card).manual_seed(13)
    c = VIT_H["dim"]
    x = noise(g, (1, 64, 64, c), card, 4.0)
    y = noise(g, ((70 * 70) if window else 4096, c), card, 1.0)
    bias = noise(g, (c,), card, 0.5)
    assert torch.equal(B.bias_residual(x, y, bias, window=window),
                       B.bias_residual_plain(x, y, bias, window=window))


@pytest.mark.card
@pytest.mark.parametrize("window", (14, 0))
def test_block_fused_against_plain(card, window, monkeypatch):
    """A bf16 ViT-H block (K7 on either way) through the four kernels within
    twice the plain bf16 block's distance from the plain f32 block, and the
    four kernels' launches per block 2 / 1 / 1 / 2."""
    kind = (VIT_H["dim"], VIT_H["heads"], window, (64, 64))
    blk, x = block_of(kind, torch.bfloat16, seed=14, device=card)
    blk.attn.fused_global = True
    with torch.device(card):
        f32 = S.SamBlock(VIT_H["dim"], VIT_H["heads"], window_size=window, grid_size=(64, 64))
    f32.load_state_dict(blk.state_dict())
    with torch.inference_mode():
        cuda.reset_launch_counts()
        fused = blk(x)
        counts = cuda.launch_counts()
        ref32 = f32(x.float())
        monkeypatch.setattr(B, "ops_for", lambda _: B.PLAIN)
        plain = blk(x)
    assert (counts["sam_ln"], counts["sam_qkv_split"], counts["sam_bias_gelu"],
            counts["sam_bias_residual"], counts["sam_attention"]) == (2, 1, 1, 2, 1)
    err = float((fused.float() - plain.float()).abs().max())
    tol = 2 * float((plain.float() - ref32).abs().max())
    print(f"block window {window}: fused vs plain {err:.4g}, tolerance {tol:.4g}")
    assert err <= tol


@pytest.mark.card
def test_replayed_encoder_pass_counts(card):
    """A ViT-H encoder pass replayed as a CUDA graph counts 64 / 32 / 32 / 64
    launches of the four kernels (and K7's 32), and no block's eager
    ``LayerNorm`` module runs, in its first call or its capture."""
    from voxactb_tpu_torch.ops.cuda import graphs

    g = torch.Generator(device=card).manual_seed(15)
    with torch.device(card):
        enc = S.sam_vit_h(dtype=torch.bfloat16, fused_windowed=True, generator=g).eval()
    calls = []
    for i in range(enc.depth):
        blk = getattr(enc, f"block_{i}")
        for norm in (blk.norm1, blk.norm2):
            norm.register_forward_pre_hook(lambda *_: calls.append(1))
    frame = torch.randn(1, 1024, 1024, 3, generator=g, device=card)
    table = graphs.Graphs("vlm", card)

    def run():
        g = table.entry(enc, (), (), (frame,))
        with g.lock:
            g.copy_in((frame,))
            return g.run("encode", lambda x: (enc(x),))[0]

    first = run()
    cuda.reset_launch_counts()
    replayed = run()
    counts = cuda.launch_counts()
    assert (counts["sam_ln"], counts["sam_qkv_split"], counts["sam_bias_gelu"],
            counts["sam_bias_residual"], counts["sam_attention"]) == (64, 32, 32, 64, 32)
    assert not calls
    assert torch.equal(first, replayed) and bool(torch.isfinite(first).all())
