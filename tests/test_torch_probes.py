"""P1-P3 (voxactb_tpu_torch/ops/cuda/probes.py): the plain versions the
wrappers take on the CPU against the JAX package's probe kernels, run as the
probes themselves with ``pl.pallas_call`` in interpret mode and ``jax.jit``
as the identity (patched into the loaded probe module only); the copy
kernel's slab and chunk schedule modelled in plain Python."""

import importlib.util
import pathlib
import re
import types

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.probes import (
    CHUNK_BYTES, SCRATCH_ROW_BYTES, grid_copy, grid_copy_chunks, grid_copy_plan,
    grid_copy_reference, shifted_window, shifted_window_reference, smem_scratch,
    smem_scratch_reference)


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


def _model_copy(x, rows, sms):
    """The kernel's schedule run in plain Python on x's bytes: returns the
    copy and how often each byte was written."""
    raw = x.contiguous().view(torch.uint8).reshape(-1).numpy()
    out = np.zeros_like(raw)
    writes = np.zeros(raw.size, np.int32)
    slab_bytes = x[0, :rows].numel() * x.element_size()
    n_slabs = x.shape[0] * x.shape[1] // rows
    for copies in grid_copy_chunks(n_slabs, slab_bytes, sms):
        for start, size in copies:
            assert 0 < size <= CHUNK_BYTES and start % 16 == 0 and size % 16 == 0
            out[start:start + size] = raw[start:start + size]
            writes[start:start + size] += 1
    return torch.from_numpy(out).view(x.dtype).reshape(x.shape), writes


@pytest.mark.parametrize("shape, dtype, rows", [
    ((1, 10, 4, 4, 64), torch.bfloat16, 1),
    ((1, 10, 4, 4, 64), torch.bfloat16, 5),
    ((2, 4, 16, 16, 64), torch.bfloat16, 2),     # slabs of 4 chunks
    ((2, 5, 20, 20, 32), torch.float32, 5),      # slabs of 16 chunks, ragged last
    ((3, 6, 10, 10, 8), torch.float32, 3),       # slabs of 9,600 bytes
])
@pytest.mark.parametrize("sms", [1, 4, 132])
def test_copy_schedule_covers_every_byte_once(shape, dtype, rows, sms):
    x = torch.tensor(np.random.default_rng(3).normal(size=shape).astype(np.float32)).to(dtype)
    x.view(-1)[::7] = float("nan")  # NaNs are copied as bits
    got, writes = _model_copy(x, rows, sms)
    assert (writes == 1).all()
    assert torch.equal(got.view(torch.uint8), x.view(torch.uint8))
    assert torch.equal(grid_copy_reference(x, rows).view(torch.uint8), x.view(torch.uint8))
    assert torch.equal(grid_copy(x, rows).view(torch.uint8), x.view(torch.uint8))


@pytest.mark.parametrize("batch, rows", [(1, 1), (1, 4), (8, 1)])
def test_copy_plan_fills_the_card_at_d0(batch, rows):
    """At d0's shape ([B, 100^3, 64] bf16) the copy runs in one wave of at
    most three CTAs per SM, and at batch 1 on at least one CTA per SM (one CTA
    per slab would give 100 or 25)."""
    n_slabs, slab_bytes = batch * 100 // rows, rows * 100 * 100 * 64 * 2
    ctas, per = grid_copy_plan(n_slabs, slab_bytes, 132)
    assert ctas * per * CHUNK_BYTES >= slab_bytes > (ctas - 1) * per * CHUNK_BYTES
    total = n_slabs * ctas
    assert total >= 132
    assert total <= 3 * 132 or ctas == 1


@pytest.mark.parametrize("shape, rows", [((1, 10, 4, 4, 64), 3), ((1, 10, 4, 4), 1),
                                         ((1, 10, 1, 1, 3), 1)])
def test_copy_refuses_what_the_kernel_does_not_take(shape, rows):
    """N must divide by rows, as in the TPU kernel; a slab is a multiple of
    the bulk copy's 16 bytes."""
    with pytest.raises(ValueError, match="grid_copy"):
        grid_copy(torch.zeros(shape), rows)
