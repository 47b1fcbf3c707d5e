"""K2 (voxactb_tpu_torch/ops/cuda/flash_attention.py): the plain version the
wrapper takes on the CPU against the JAX package's flash-attention kernel in
interpret mode, including a ragged key length (77 + s^3), and the port's
Attention module on its flash path against the JAX module's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.models.perceiver import Attention as JaxAttention
from voxactb_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from voxactb_tpu_torch.models.perceiver import Attention
from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.flash_attention import (
    flash_attention, flash_attention_reference)
from voxactb_tpu_torch.weights import load_flax_params


def _qkv(rng, bh, tq, tk, hd):
    q = (rng.normal(size=(bh, tq, hd)) * hd ** -0.5).astype(np.float32)
    k = rng.normal(size=(bh, tk, hd)).astype(np.float32)
    v = rng.normal(size=(bh, tk, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("bh,tq,tk,hd", [
    (2, 16, 85, 64),    # ragged cross: Tk = 77 + 2^3
    (4, 24, 40, 16),    # unaligned everywhere
    (1, 85, 16, 64),    # decoder direction: Tq = 77 + 2^3
])
def test_plain_version_matches_pallas_kernel(bh, tq, tk, hd):
    rng = np.random.default_rng(bh * 100 + tk)
    q, k, v = _qkv(rng, bh, tq, tk, hd)
    bf = jnp.bfloat16
    ref = np.asarray(jax_flash(jnp.asarray(q, bf), jnp.asarray(k, bf),
                               jnp.asarray(v, bf), interpret=True), np.float32)
    tb = torch.bfloat16
    got = flash_attention_reference(torch.tensor(q).to(tb), torch.tensor(k).to(tb),
                                    torch.tensor(v).to(tb))
    assert got.dtype == tb and got.shape == (bh, tq, hd)
    # same rounding points (P normalised in f32 before its bf16 cast); f32 sums
    # in another order may move an output by one bf16 ulp
    got = got.float().numpy()
    np.testing.assert_allclose(got, ref, atol=2.0 ** -8 * np.abs(ref).max(), rtol=0)
    assert (got != ref).mean() < 0.05


def test_plain_version_masks_the_ragged_tail():
    """Inputs where keys past Tk would dominate if they took part: real logits
    near -8 against 0 for a zero-filled key. The plain version agrees with the
    Pallas kernel, and the zero-filled (unmasked) variant does not."""
    rng = np.random.default_rng(7)
    bh, tq, tk, hd = 2, 16, 85, 64   # Tk = 77 + 2^3: 43 keys short of 128
    q = (0.25 + 0.05 * rng.normal(size=(bh, tq, hd))).astype(np.float32)
    k = (-0.5 + 0.2 * rng.normal(size=(bh, tk, hd))).astype(np.float32)
    v = (1.0 + 0.5 * rng.normal(size=(bh, tk, hd))).astype(np.float32)
    bf = jnp.bfloat16
    ref = np.asarray(jax_flash(jnp.asarray(q, bf), jnp.asarray(k, bf),
                               jnp.asarray(v, bf), interpret=True), np.float32)
    tb = torch.bfloat16
    tq_, tk_, tv_ = (torch.tensor(a).to(tb) for a in (q, k, v))
    got = flash_attention_reference(tq_, tk_, tv_).float().numpy()
    # f32 sums in another order may move an output by one bf16 ulp of its
    # size; 2^-7 of the largest output is at least that
    tol = 2.0 ** -7 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
    zeros = torch.zeros(bh, 128 - tk, hd, dtype=tb)
    unmasked = flash_attention_reference(tq_, torch.cat([tk_, zeros], 1),
                                         torch.cat([tv_, zeros], 1)).float().numpy()
    assert np.abs(unmasked - ref).max() > 50 * tol


def test_cpu_wrapper_takes_plain_version():
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(a).to(torch.bfloat16) for a in _qkv(rng, 2, 8, 20, 64))
    before = dict(LAUNCHES)
    assert torch.equal(flash_attention(q, k, v), flash_attention_reference(q, k, v))
    assert LAUNCHES == before


@pytest.mark.parametrize("heads,dim_head", [(1, 64), (2, 16)])
def test_attention_flash_path_matches_jax(heads, dim_head):
    """The module's flash path (q scaled in bf16 before the kernel) against the
    JAX module with pallas flash attention in interpret mode, at bf16."""
    rng = np.random.default_rng(heads)
    x = rng.normal(size=(2, 12, 32)).astype(np.float32)
    ctx = rng.normal(size=(2, 85, 48)).astype(np.float32)
    jm = JaxAttention(heads, dim_head, 32, flash=True, flash_interpret=True,
                      dtype=jnp.bfloat16)
    params = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(ctx))
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(ctx)), np.float32)
    tm = Attention(32, 48, heads, dim_head, 32, flash=True, dtype=torch.bfloat16)
    load_flax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = tm(torch.tensor(x), torch.tensor(ctx)).float().numpy()
    np.testing.assert_allclose(got, ref, atol=2.0 ** -7 * np.abs(ref).max(), rtol=0)
