"""P1-P3 (voxactb_tpu_torch/ops/cuda/probes.py): the plain versions the
wrappers take on the CPU against the JAX package's probe kernels, run as the
probes themselves with ``pl.pallas_call`` in interpret mode and ``jax.jit``
as the identity (patched into the loaded probe module only); the copy
kernel's interleaved chunk schedule and the shifted-window kernel's tile and
tap schedule modelled in plain Python."""

import contextlib
import importlib.util
import io
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.build import header_constant
from voxactb_tpu_torch.ops.cuda.probes import (
    CHUNK_BYTES, SCRATCH_ROW_BYTES, SW_TILE, grid_copy, grid_copy_chunks, grid_copy_plan,
    grid_copy_reference, shifted_window, shifted_window_reference, shifted_window_tiles,
    smem_scratch, smem_scratch_reference)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ROOT = pathlib.Path(__file__).resolve().parents[1]


def _interpreted_probe_module():
    """``tools/probe_vmem.py`` loaded as a module of its own, its
    ``pallas_call`` interpreting and its ``jax.jit`` the identity; returns the
    module and the list that collects every Pallas output."""
    spec = importlib.util.spec_from_file_location("jax_probe_vmem", ROOT / "tools/probe_vmem.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    outputs = []

    def pallas_call(kernel, **kw):
        f = pl.pallas_call(kernel, interpret=True, **kw)

        def call(*args):
            y = f(*args)
            outputs.append(np.asarray(y))
            return y
        return call

    module.pl = types.SimpleNamespace(pallas_call=pallas_call, BlockSpec=pl.BlockSpec)
    module.jax = types.SimpleNamespace(jit=lambda f: f, ShapeDtypeStruct=jax.ShapeDtypeStruct,
                                       block_until_ready=jax.block_until_ready)
    return module, outputs


# -- P3 shifted_window -------------------------------------------------------------


def test_shifted_window_plain_version_matches_the_jax_probe(capsys):
    probe, outputs = _interpreted_probe_module()
    probe.probe_shifted_einsum()
    said = capsys.readouterr().out
    assert float(re.search(r"rel err ([0-9.e+-]+)", said).group(1)) < 1e-5, said
    pallas = outputs[0]
    assert pallas.shape == (100, 100, 64) and pallas.dtype == np.float32
    # the probe's own inputs: default_rng(0), rounded to bf16
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(102, 102, 128)).astype(np.float32)).to(torch.bfloat16)
    w = torch.tensor(rng.normal(size=(9, 128, 64)).astype(np.float32) * 0.1).to(torch.bfloat16)
    got = shifted_window_reference(x, w)
    assert got.dtype == torch.float32 and got.shape == (100, 100, 64)
    # bf16 products are exact in f32; the 9 x 128 = 1152-term f32 sums run in
    # another order, each within 1152 x 2^-24 of the sum of |products|
    bound = 1152 * 2.0 ** -24 * shifted_window_reference(x.abs(), w.abs()).numpy()
    err = np.abs(got.numpy() - pallas)
    assert (err <= bound).all(), float((err / bound).max())
    # on CPU tensors the wrapper is the plain version, and counts no launch
    before = LAUNCHES["shifted_window"]
    assert torch.equal(shifted_window(x, w), got)
    assert LAUNCHES["shifted_window"] == before


def test_shifted_window_tap_order():
    """Tap t = 3 dy + dx: a unit weight on one tap reads x shifted by (dy, dx)."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(7, 9, 128)).astype(np.float32))
    for t in range(9):
        w = torch.zeros((9, 128, 64))
        w[t, :64, :] = torch.eye(64)
        dy, dx = divmod(t, 3)
        assert torch.equal(shifted_window_reference(x, w), x[dy:dy + 5, dx:dx + 7, :64])


def _window_inputs(h, w, seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(h + 2, w + 2, 128)).astype(np.float32)).to(torch.bfloat16)
    wt = torch.tensor(rng.normal(size=(9, 128, 64)).astype(np.float32) * 0.1).to(torch.bfloat16)
    return x, wt


def _window_model(x, w, wg_row_offset=SW_TILE):
    """The shifted-window kernel's schedule in plain PyTorch: every CTA's
    warpgroup tiles (``shifted_window_tiles``), each tile's 64 A rows
    gathered from the band's clamped halo at each tap (warpgroup g's from
    halo row ``g * wg_row_offset`` on), f32 sums over the taps in row-major
    order and k16 steps ascending within a tap, and the tile's pixels inside
    the output stored. Returns the output (NaN where nothing was stored) and
    the number of stores per pixel."""
    h, wd = x.shape[0] - 2, x.shape[1] - 2
    xf, wf = x.float(), w.float()
    tiles = [(y0, x0, g) for cta in shifted_window_tiles(h, wd)
             for g, (y0, x0) in enumerate(cta)]
    i = torch.arange(SW_TILE)
    ty = torch.tensor([y0 + g * (wg_row_offset - SW_TILE) for y0, _, g in tiles])
    oy = torch.tensor([y0 for y0, _, _ in tiles])[:, None, None] + i[None, :, None]
    ox = torch.tensor([x0 for _, x0, _ in tiles])[:, None, None] + i[None, None, :]
    acc = torch.zeros((len(tiles), SW_TILE * SW_TILE, 64))
    for t in range(9):
        dy, dx = divmod(t, 3)
        rows = (ty[:, None, None] + i[None, :, None] + dy).clamp(max=h + 1)
        a = xf[rows, (ox + dx).clamp(max=wd + 1)].reshape(len(tiles), -1, 128)
        for kk in range(8):
            acc += a[..., 16 * kk:16 * kk + 16] @ wf[t, 16 * kk:16 * kk + 16]
    oy, ox = oy.expand(-1, SW_TILE, SW_TILE), ox.expand(-1, SW_TILE, SW_TILE)
    keep = (oy < h) & (ox < wd)
    out = torch.full((h, wd, 64), float("nan"))
    stores = torch.zeros((h, wd), dtype=torch.int32)
    out[oy[keep], ox[keep]] = acc.reshape(len(tiles), SW_TILE, SW_TILE, 64)[keep]
    stores.index_put_((oy[keep], ox[keep]), torch.ones(int(keep.sum()), dtype=torch.int32),
                      accumulate=True)
    return out, stores


def _swapped_taps(w):
    return w.reshape(3, 3, 128, 64).transpose(0, 1).reshape(9, 128, 64)


@pytest.fixture(scope="module")
def jax_window_probe():
    """The JAX probe's Pallas output, interpreted once (its 50 timed calls
    return that output again), and the probe's own inputs."""
    probe, outputs = _interpreted_probe_module()
    interpreted = probe.pl.pallas_call

    def pallas_call(kernel, **kw):
        f = interpreted(kernel, **kw)
        return lambda *args: outputs[0] if outputs else f(*args)

    probe.pl = types.SimpleNamespace(pallas_call=pallas_call, BlockSpec=pl.BlockSpec)
    with contextlib.redirect_stdout(io.StringIO()):
        probe.probe_shifted_einsum()
    return _window_inputs(100, 100, 0), np.asarray(outputs[0])


@pytest.mark.parametrize("h, w", [(10, 10), (37, 69), (100, 100)])
def test_window_schedule_covers_every_pixel_once(h, w):
    """Every CTA holds two tiles stacked in y; the grid is one wave on 132
    SMs at 100 x 100 (7 x 13 = 91 CTAs); every output pixel is stored
    once."""
    ctas = shifted_window_tiles(h, w)
    assert len(ctas) == -(-h // (2 * SW_TILE)) * -(-w // SW_TILE)
    assert all(len(c) == 2 and c[1] == (c[0][0] + SW_TILE, c[0][1]) for c in ctas)
    if (h, w) == (100, 100):
        assert len(ctas) == 91
    x, wt = _window_inputs(h, w, 11)
    _, stores = _window_model(x, wt)
    assert (stores == 1).all()


def _window_bound(x, w):
    # bf16 products are exact in f32; 1152-term f32 sums in two orders differ
    # by at most 1152 x 2^-24 of the sum of |products|
    return 1152 * 2.0 ** -24 * shifted_window_reference(x.abs(), w.abs()).numpy()


def test_window_model_matches_the_jax_probe(jax_window_probe):
    """At the probe's shapes and inputs the kernel's schedule and summation
    order hold against the Pallas kernel in interpret mode; the planted
    faults' models (both warpgroups on the first tile's pixels; dy and dx
    swapped) miss it."""
    (x, w), pallas = jax_window_probe
    bound = _window_bound(x, w)
    got, _ = _window_model(x, w)
    assert (np.abs(got.numpy() - pallas) <= bound).all()
    for fault in (_window_model(x, w, wg_row_offset=0)[0], _window_model(x, _swapped_taps(w))[0]):
        assert not (np.abs(fault.numpy() - pallas) <= bound).all()


@pytest.mark.parametrize("h, w", [(10, 10), (37, 69)])
def test_window_model_matches_jax_on_ragged_grids(h, w):
    """Where neither H nor W is a multiple of the tile, the model (edge
    tiles on clamped inputs) holds against the JAX sum over taps, as the
    probe's kernel computes it, within the same bound; the faults miss."""
    x, wt = _window_inputs(h, w, 13)
    xj, wj = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (x, wt))
    ref = sum(jnp.einsum("yxc,cf->yxf", xj[dy:dy + h, dx:dx + w], wj[3 * dy + dx],
                         preferred_element_type=jnp.float32)
              for dy in range(3) for dx in range(3))
    bound = _window_bound(x, wt)
    got, _ = _window_model(x, wt)
    assert (np.abs(got.numpy() - np.asarray(ref)) <= bound).all()
    for fault in (_window_model(x, wt, wg_row_offset=0)[0],
                  _window_model(x, _swapped_taps(wt))[0]):
        assert not (np.abs(fault.numpy() - np.asarray(ref)) <= bound).all()


@pytest.mark.parametrize("shape", [(10, 10, 64), (2, 10, 128), (10, 10)])
def test_shifted_window_refuses_other_shapes(shape):
    with pytest.raises(ValueError, match="shifted_window"):
        shifted_window(torch.zeros(shape), torch.zeros((9, 128, 64)))


# -- P2 smem_scratch ---------------------------------------------------------------


def test_scratch_plain_version_matches_the_jax_probe(capsys):
    probe, outputs = _interpreted_probe_module()
    assert probe.probe_scratch(1)  # a 1 MB scratch
    (pallas,) = outputs
    x = torch.ones((8, 128), dtype=torch.float32)
    got = smem_scratch_reference(x, 1 << 20)
    # row 0 went through the scratch; rows 1-7 are unwritten by both (NaN in
    # JAX's interpret mode, unspecified in the port) and not compared
    np.testing.assert_array_equal(got[0].numpy(), pallas[0])
    assert np.isnan(pallas[1:]).all()


@pytest.mark.parametrize("nbytes", [SCRATCH_ROW_BYTES, 232448, 232960, 1 << 20])
def test_scratch_row_zero_passes_through(nbytes):
    """The plain version always succeeds, at any scratch size; the wrapper
    takes it on CPU tensors."""
    x = torch.tensor(np.random.default_rng(2).normal(size=(8, 128)).astype(np.float32))
    assert torch.equal(smem_scratch_reference(x, nbytes)[0], x[0])
    assert torch.equal(smem_scratch(x, nbytes)[0], x[0])


@pytest.mark.parametrize("x, nbytes", [(torch.zeros((8, 128)), 256),
                                       (torch.zeros((8, 64)), 4096),
                                       (torch.zeros((8, 128), dtype=torch.float64), 4096)])
def test_scratch_refuses_other_operands(x, nbytes):
    with pytest.raises(ValueError):
        smem_scratch(x, nbytes)


# -- P1 grid_copy -------------------------------------------------------------------


def test_jax_copy_kernel_is_a_plain_copy():
    """The TPU kernel is a closure inside ``main()`` with fixed 100^3 inputs,
    so it cannot run here; its body is ``o = x``, the function the port's
    plain version and kernel compute."""
    src = (ROOT / "tools/profile_stages.py").read_text()
    assert re.search(r"def copy_rows_kernel\(x_ref, o_ref\):\n\s+o_ref\[\.\.\.\] = x_ref\[\.\.\.\]\n",
                     src)


def _model_copy(x, rows, sms, fill=0, **kw):
    """The kernel's schedule run in plain Python on x's bytes (``kw`` as for
    ``grid_copy_chunks``): returns the copy (``fill`` where nothing was
    written), how often each byte was written and the schedule."""
    raw = x.contiguous().view(torch.uint8).reshape(-1).numpy()
    out = np.full_like(raw, fill)
    writes = np.zeros(raw.size, np.int32)
    slab_bytes = x[0, :rows].numel() * x.element_size()
    n_slabs = x.shape[0] * x.shape[1] // rows
    chunks = grid_copy_chunks(n_slabs, slab_bytes, sms, **kw)
    for copies in chunks:
        for start, size in copies:
            assert 0 < size and start % 16 == 0 and size % 16 == 0
            assert start // slab_bytes == (start + size - 1) // slab_bytes  # inside one slab
            out[start:start + size] = raw[start:start + size]
            writes[start:start + size] += 1
    return torch.from_numpy(out).view(x.dtype).reshape(x.shape), writes, chunks


@pytest.mark.parametrize("shape, dtype, rows", [
    ((1, 10, 4, 4, 64), torch.bfloat16, 1),
    ((1, 10, 4, 4, 64), torch.bfloat16, 5),
    ((2, 4, 16, 16, 64), torch.bfloat16, 2),     # slabs of 64 KB
    ((2, 5, 20, 20, 32), torch.float32, 5),      # slabs of 250 KB
    ((3, 6, 10, 10, 8), torch.float32, 3),       # slabs of 9,600 bytes
    ((1, 2, 1, 4097, 8), torch.bfloat16, 1),     # 65,552 bytes: a shorter last chunk
])
@pytest.mark.parametrize("sms", [1, 4, 132])
@pytest.mark.parametrize("chunk_limit", [CHUNK_BYTES, 4096])
def test_copy_schedule_covers_every_byte_once(shape, dtype, rows, sms, chunk_limit):
    """Chunks of at most ``chunk_limit`` bytes, each inside one slab, cover
    every byte once; chunk i goes to CTA i mod G, so consecutive chunks go
    to different CTAs."""
    x = torch.tensor(np.random.default_rng(3).normal(size=shape).astype(np.float32)).to(dtype)
    x.view(-1)[::7] = float("nan")  # NaNs are copied as bits
    got, writes, chunks = _model_copy(x, rows, sms, chunk_limit=chunk_limit)
    assert (writes == 1).all()
    assert torch.equal(got.view(torch.uint8), x.view(torch.uint8))
    owner = sorted((start, cta, size) for cta, copies in enumerate(chunks)
                   for start, size in copies)
    assert all(size <= chunk_limit for _, _, size in owner)
    assert all(cta == i % len(chunks) for i, (_, cta, _) in enumerate(owner))
    assert len(chunks) == 1 or all(a[1] != b[1] for a, b in zip(owner, owner[1:]))
    assert torch.equal(grid_copy_reference(x, rows).view(torch.uint8), x.view(torch.uint8))
    assert torch.equal(grid_copy(x, rows).view(torch.uint8), x.view(torch.uint8))


@pytest.mark.parametrize("batch, rows", [(1, 1), (1, 4), (8, 1)])
def test_copy_plan_fills_the_card_at_d0(batch, rows):
    """At d0's shape ([B, 100^3, 64] bf16) the copy runs in one wave of
    ``kCopyCtasPerSm`` persistent CTAs per SM on all 132 SMs, over chunks of
    at most ``CHUNK_BYTES`` inside the slabs, dealt out in turns so that no
    CTA has more than one chunk more than another."""
    n_slabs, slab_bytes = batch * 100 // rows, rows * 100 * 100 * 64 * 2
    plan = grid_copy_plan(n_slabs, slab_bytes, 132)
    assert plan.ctas == 132 * header_constant("probes.cu", "kCopyCtasPerSm")
    assert plan.chunk_bytes <= CHUNK_BYTES and plan.chunk_bytes % 16 == 0
    assert plan.chunks_per_slab * plan.chunk_bytes >= slab_bytes
    assert (plan.chunks_per_slab - 1) * plan.chunk_bytes < slab_bytes
    counts = [len(c) for c in grid_copy_chunks(n_slabs, slab_bytes, 132)]
    assert len(counts) == plan.ctas and max(counts) - min(counts) <= 1 and min(counts) > 0
    assert sum(counts) == n_slabs * plan.chunks_per_slab


@pytest.mark.parametrize("shape, rows, sms", [((2, 5, 20, 20, 32), 5, 4),
                                              ((1, 10, 4, 4, 64), 1, 132)])
def test_copy_faults_leave_their_own_chunks(shape, rows, sms):
    """The planted faults of the copy, modelled: one CTA short leaves
    exactly the last CTA's chunks unwritten, one slab short exactly the last
    slab; everything else is copied."""
    x = torch.tensor(np.random.default_rng(4).normal(size=shape).astype(np.float32))
    raw = x.view(torch.uint8).reshape(-1)
    full = _model_copy(x, rows, sms)[2]
    short, writes, _ = _model_copy(x, rows, sms, fill=255, grid=len(full) - 1)
    missed = np.zeros(raw.numel(), bool)
    for start, size in full[-1]:
        missed[start:start + size] = True
    assert missed.any() and (writes == ~missed).all()
    assert torch.equal(short.view(torch.uint8).reshape(-1)[~missed], raw[~missed])
    slab_bytes = x[0, :rows].numel() * 4
    n_slabs = shape[0] * shape[1] // rows
    _, writes, _ = _model_copy(x, rows, sms, copied=n_slabs - 1)
    assert (writes[:-slab_bytes] == 1).all() and (writes[-slab_bytes:] == 0).all()


@pytest.mark.parametrize("shape, rows", [((1, 10, 4, 4, 64), 3), ((1, 10, 4, 4), 1),
                                         ((1, 10, 1, 1, 3), 1)])
def test_copy_refuses_what_the_kernel_does_not_take(shape, rows):
    """N must divide by rows, as in the TPU kernel; a slab is a multiple of
    the bulk copy's 16 bytes."""
    with pytest.raises(ValueError, match="grid_copy"):
        grid_copy(torch.zeros(shape), rows)
