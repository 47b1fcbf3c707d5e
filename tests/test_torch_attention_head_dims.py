"""The head dims K2, K4 and K7 are not built for (voxactb_tpu_torch/ops/cuda/
head_dim.py): the wrappers zero-pad q, k, v (and K4's dO) on the head dim to
the kernel's width and slice the outputs back. On the CPU the one helper,
``padded_call``, is held around the plain versions against the JAX package's
Pallas kernels in interpret mode, which pad the head dim to 128 themselves:
K2 and K4 (out, dQ, dK, dV, with and without dropout) at head dims 16, 32
and 96, K7 at 32 and 72, at the tolerances of the head dim 64 tests
(tests/test_torch_flash_attention*.py, tests/test_torch_sam_attention.py).
The wrappers raise above their largest width."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from voxactb_tpu.ops.pallas.flash_attention import flash_attention_train as jax_flash_train
from voxactb_tpu.ops.pallas.sam_attention import global_rel_attention as jax_sam
from voxactb_tpu_torch.ops.cuda import flash_attention as K2
from voxactb_tpu_torch.ops.cuda import flash_attention_train as K4
from voxactb_tpu_torch.ops.cuda import sam_attention as K7
from voxactb_tpu_torch.ops.cuda.head_dim import kernel_head_dim, pad_head_dim, padded_call
from voxactb_tpu_torch.ops.sam_attention import global_rel_attention_plain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bf(x):
    return torch.tensor(x).to(torch.bfloat16)


def _qkv(rng, bh, tq, tk, hd):
    q = (rng.normal(size=(bh, tq, hd)) * hd ** -0.5).astype(np.float32)
    k = rng.normal(size=(bh, tk, hd)).astype(np.float32)
    v = rng.normal(size=(bh, tk, hd)).astype(np.float32)
    return q, k, v


def test_kernel_head_dim_takes_the_next_width_and_raises_above_the_last():
    assert [kernel_head_dim(hd, K2.HEAD_DIMS, "k") for hd in (1, 32, 64, 65, 96, 128)] == [
        64, 64, 64, 128, 128, 128]
    assert [kernel_head_dim(hd, K7.HEAD_DIMS, "k") for hd in (16, 64, 72, 80)] == [
        64, 64, 80, 80]
    with pytest.raises(ValueError, match="at most 128"):
        kernel_head_dim(129, K4.HEAD_DIMS, "flash_attention_train")
    x = torch.ones(2, 3, 5)
    assert pad_head_dim(x, 5) is x
    padded = pad_head_dim(x, 8)
    assert padded.shape == (2, 3, 8) and bool((padded[..., 5:] == 0).all())


@pytest.mark.parametrize("hd", [16, 32, 96])
def test_k2_padded_plain_version_matches_the_pallas_kernel(hd):
    bh, tq, tk = 2, 24, 85  # a ragged key length: 77 + 2^3
    rng = np.random.default_rng(hd)
    q, k, v = _qkv(rng, bh, tq, tk, hd)
    bf = jnp.bfloat16
    ref = np.asarray(jax_flash(jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf),
                               interpret=True), np.float32)
    width = kernel_head_dim(hd, K2.HEAD_DIMS, "flash_attention")
    got = padded_call(K2.flash_attention_reference, (_bf(q), _bf(k), _bf(v)), width)
    assert got.dtype == torch.bfloat16 and got.shape == (bh, tq, hd)
    # the tolerance of the head dim 64 test: one bf16 ulp of summation order
    got = got.float().numpy()
    np.testing.assert_allclose(got, ref, atol=2.0 ** -8 * np.abs(ref).max(), rtol=0)
    assert (got != ref).mean() < 0.05


def _k4_padded(q, k, v, seed, dropout, width):
    """Out and dQ, dK, dV of sum(out^2) through the helper around K4's plain
    forward and backward (the launchers' order: q, k, v, dO first)."""
    s = torch.tensor(seed)
    q, k, v = _bf(q), _bf(k), _bf(v)
    out, lse = padded_call(lambda *ops: K4.plain_forward(*ops, s, dropout), (q, k, v), width,
                           sliced=(0,))
    d_out = (2.0 * out.float()).to(torch.bfloat16)
    grads = padded_call(lambda q_, k_, v_, d_: K4.plain_backward(q_, k_, v_, lse, d_, s,
                                                                 dropout),
                        (q, k, v, d_out), width, sliced=(0, 1, 2))
    return out.float().numpy(), [g.float().numpy() for g in grads]


@pytest.mark.parametrize("hd", [16, 32, 96])
@pytest.mark.parametrize("dropout,seed", [(0.0, 0), (0.25, 99)])
def test_k4_padded_plain_version_matches_the_pallas_kernel(hd, dropout, seed):
    """The mask is indexed by the padded sequence extents and never the head
    dim, on both sides: at dropout the outputs and gradients agree too."""
    bh, tq, tk = 2, 45, 131
    rng = np.random.default_rng(hd + 7)
    q, k, v = _qkv(rng, bh, tq, tk, hd)
    qj, kj, vj = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))

    def loss(q, k, v):
        out = jax_flash_train(q, k, v, jnp.uint32(seed), dropout=dropout, interpret=True)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (_, ref_out), ref_g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(qj, kj, vj)
    width = kernel_head_dim(hd, K4.HEAD_DIMS, "flash_attention_train")
    out, grads = _k4_padded(q, k, v, seed, dropout, width)
    assert out.shape == (bh, tq, hd) and [g.shape for g in grads] == [
        (bh, tq, hd), (bh, tk, hd), (bh, tk, hd)]
    # the head dim 64 tests' tolerances (tests/test_torch_flash_attention_train.py)
    np.testing.assert_allclose(out, np.asarray(ref_out, np.float32), atol=2e-2, rtol=2e-2)
    for name, a, b in zip("qkv", grads, ref_g):
        b = np.asarray(b, np.float32)
        scale = max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-2, err_msg=f"d{name}")


@pytest.mark.parametrize("hd", [32, 72])
def test_k7_padded_plain_version_matches_the_pallas_kernel(hd):
    bh, kh, kw = 2, 5, 7  # T = 35: ragged
    rng = np.random.default_rng(hd)
    t = kh * kw
    q = (rng.normal(size=(bh, t, hd)) * hd ** -0.5).astype(np.float32)
    k, v = (rng.normal(size=(bh, t, hd)).astype(np.float32) for _ in range(2))
    rel_h = rng.normal(size=(bh, t, kh)).astype(np.float32)
    rel_w = (0.5 * rng.normal(size=(bh, t, kw))).astype(np.float32)
    bf = jnp.bfloat16
    ref = np.asarray(jax_sam(jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf),
                             jnp.asarray(rel_h), jnp.asarray(rel_w), kh=kh, kw=kw,
                             interpret=True), np.float32)
    width = kernel_head_dim(hd, K7.HEAD_DIMS, "sam_attention")
    got = padded_call(global_rel_attention_plain, (_bf(q), _bf(k), _bf(v)), width,
                      torch.tensor(rel_h), torch.tensor(rel_w), kh=kh, kw=kw)
    assert got.dtype == torch.bfloat16 and got.shape == (bh, t, hd)
    # the head dim 64 / 80 test's tolerance (tests/test_torch_sam_attention.py)
    np.testing.assert_allclose(got.float().numpy(), ref,
                               atol=2.0 ** -7 * np.abs(ref).max(), rtol=0)


def test_the_wrappers_raise_above_their_largest_head_dim():
    """On the card each wrapper raises with its limit; the checks are made
    before any launch, so they show on the CPU through ``_check_operands``
    and ``kernel_head_dim``. CPU tensors of any head dim take the plain
    version."""
    q = torch.zeros(1, 8, 136, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 128"):
        K4._check_operands(q, q, q)
    with pytest.raises(ValueError, match="flash_attention kernel takes head dims of at most "
                                         "128"):
        kernel_head_dim(136, K2.HEAD_DIMS, "flash_attention")
    with pytest.raises(ValueError, match="sam_attention kernel takes head dims of at most 80"):
        kernel_head_dim(96, K7.HEAD_DIMS, "sam_attention")
    assert K2.flash_attention(q, q, q).shape == q.shape
    assert K4._check_operands(q[..., :96], q[..., :96], q[..., :96])[3] == 128
    assert K4._check_operands(q[..., :32], q[..., :32], q[..., :32])[3] == 64
