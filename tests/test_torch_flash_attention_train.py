"""K4 of the port on the CPU: the plain version of ``flash_attention_train``
(forward, written-out backward and the dropout keep mask) against the JAX
package's Pallas kernel in interpret mode, on numpy-seeded inputs.

Tolerances are those of the JAX package's own kernel tests
(tests/test_flash_attention.py): both sides round P, dS and the outputs to
bf16 at the same points and differ in f32 summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.ops.pallas.flash_attention import (
    _hash_keep, _thr, flash_attention_train as jax_flash_train)
from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda import flash_attention_train as K4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mk(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _bf(x):
    return torch.tensor(x).to(torch.bfloat16)


def _jax_out_and_grads(q, k, v, seed, dropout, q_block=512):
    q, k, v = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))

    def loss(q, k, v):
        out = jax_flash_train(q, k, v, jnp.uint32(seed), dropout=dropout,
                              q_block=q_block, interpret=True)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    return np.asarray(out, np.float32), [np.asarray(g, np.float32) for g in grads]


def _torch_out_and_grads(q, k, v, seed, dropout, q_block=512, fn=None):
    q, k, v = (_bf(t).requires_grad_() for t in (q, k, v))
    fn = fn or K4.flash_attention_train_reference
    out = fn(q, k, v, seed, dropout=dropout, q_block=q_block)
    (out.float() ** 2).sum().backward()
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in (q, k, v)]


def _assert_grads(got, ref, atol):
    for name, a, b in zip("qkv", got, ref):
        scale = max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(a / scale, b / scale, atol=atol, err_msg=f"d{name}")


# (bh, tq, tk, hd, q_block): one block; dK/dV accumulated over three query
# blocks; Tq and Tk off the multiples of 8 and 128, two query blocks
CASES = {"one_block": (4, 24, 40, 16, 512), "multi_block": (2, 96, 64, 8, 32),
         "ragged": (3, 45, 131, 16, 32)}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_jax_kernel_without_dropout(case):
    bh, tq, tk, hd, q_block = CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v = _mk(rng, bh, tq, hd), _mk(rng, bh, tk, hd), _mk(rng, bh, tk, hd)
    ref_out, ref_g = _jax_out_and_grads(q, k, v, 0, 0.0, q_block)
    out, g = _torch_out_and_grads(q, k, v, 0, 0.0, q_block)
    np.testing.assert_allclose(out, ref_out, atol=2e-2, rtol=2e-2)
    _assert_grads(g, ref_g, 1e-2)


def _jax_keep_mask(seed, bh, tq, tk, dropout, q_block):
    """The mask as tests/test_flash_attention.py builds it from ``_hash_keep``:
    block by block, with the TPU kernel's uint32 index."""
    tk_pad = -(-tk // 128) * 128
    qb = q_block if tq >= q_block else -(-tq // 8) * 8
    nq = -(-tq // qb)
    heads = []
    for h in range(bh):
        blocks = [_hash_keep(jnp.uint32(seed), jnp.uint32((h * nq + i) * qb * tk_pad),
                             qb, tk_pad, _thr(dropout)) for i in range(nq)]
        heads.append(jnp.concatenate(blocks, 0))
    return np.asarray(jnp.stack(heads))[:, :tq, :tk] > 0


@pytest.mark.parametrize("bh,tq,tk,q_block,dropout,seed", [
    (2, 32, 48, 512, 0.25, 1234), (3, 45, 131, 32, 0.1, 99),
    (4, 128, 256, 64, 0.1, 4294967295), (2, 20, 1077, 512, 0.5, 7)])
def test_keep_mask_is_bit_equal_to_the_jax_kernels(bh, tq, tk, q_block, dropout, seed):
    ref = _jax_keep_mask(seed, bh, tq, tk, dropout, q_block)
    got = K4.keep_mask(torch.tensor(seed), bh, tq, tk, dropout, q_block).numpy()
    np.testing.assert_array_equal(got, ref)
    assert abs((1.0 - got.mean()) - dropout) < 0.02
    assert K4.dropout_threshold(dropout) == _thr(dropout)


def test_keep_mask_beyond_32_bits_mixes_the_high_word():
    """Below 2^32 the high word is zero and the mask is the TPU kernel's; past
    it the uint32 index of the TPU kernel wraps (head h repeats head 0's mask
    when a head spans 2^32 elements), while the port's 64-bit index does not."""
    tq, tk = 8, 128
    seed = torch.tensor(5)
    base = K4.keep_mask(seed, 1, tq, tk, 0.3)

    # a head stride of exactly 2^32 elements: tq_pad * tk_pad = 2^32
    def strided(head):
        i64 = torch.int64
        index = (head << 32) + (torch.arange(tq, dtype=i64)[:, None] * tk
                                + torch.arange(tk, dtype=i64)[None])
        x = (index & K4._M32) ^ 5 ^ K4._mul32(index >> 32, 0x9E3779B9)
        x = x ^ (x >> 16)
        x = K4._mul32(x, 0x85EBCA6B)
        x = x ^ (x >> 13)
        x = K4._mul32(x, 0xC2B2AE35)
        x = x ^ (x >> 16)
        return x >= K4.dropout_threshold(0.3)

    assert torch.equal(strided(0), base[0])
    assert not torch.equal(strided(1), base[0])
    assert abs(float(strided(1).float().mean()) - 0.7) < 0.05


def test_plain_version_matches_jax_kernel_with_dropout():
    bh, tq, tk, hd = 2, 32, 48, 16
    drop, seed = 0.25, 1234
    rng = np.random.default_rng(3)
    q, k, v = _mk(rng, bh, tq, hd), _mk(rng, bh, tk, hd), _mk(rng, bh, tk, hd)
    ref_out, ref_g = _jax_out_and_grads(q, k, v, seed, drop)
    out, g = _torch_out_and_grads(q, k, v, seed, drop)
    np.testing.assert_allclose(out, ref_out, atol=3e-2, rtol=3e-2)
    _assert_grads(g, ref_g, 1.5e-2)
    # the mask took part: without it the output differs
    out0, _ = _torch_out_and_grads(q, k, v, seed, 0.0)
    assert np.abs(out - out0).max() > 0.1


def test_seed_decides_the_mask():
    rng = np.random.default_rng(4)
    q, k, v = (_bf(_mk(rng, 2, 16, 8)), _bf(_mk(rng, 2, 24, 8)), _bf(_mk(rng, 2, 24, 8)))
    a = K4.flash_attention_train(q, k, v, 5, dropout=0.1)
    b = K4.flash_attention_train(q, k, v, torch.tensor(5), dropout=0.1)
    c = K4.flash_attention_train(q, k, v, 6, dropout=0.1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_written_out_backward_matches_autograd_of_the_forward_formula():
    """The plain backward against torch autograd through the same forward in
    f32 (no bf16 rounding of P): they differ by the rounding of dS, A and the
    outputs to bf16, 2^-9 relative per term."""
    bh, tq, tk, hd = 2, 24, 40, 16
    drop, seed = 0.25, 11
    rng = np.random.default_rng(5)
    q, k, v = _mk(rng, bh, tq, hd), _mk(rng, bh, tk, hd), _mk(rng, bh, tk, hd)
    _, g = _torch_out_and_grads(q, k, v, seed, drop)

    qf, kf, vf = (_bf(t).float().requires_grad_() for t in (q, k, v))
    keep = K4.keep_mask(torch.tensor(seed), bh, tq, tk, drop).float() / (1.0 - drop)
    out = torch.matmul(torch.softmax(qf @ kf.transpose(-1, -2), -1) * keep, vf)
    (out.to(torch.bfloat16).float() ** 2).sum().backward()
    _assert_grads(g, [t.grad.numpy() for t in (qf, kf, vf)], 1.5e-2)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = dict(LAUNCHES)
    rng = np.random.default_rng(6)
    q, k, v = (_bf(_mk(rng, 1, 8, 64)).requires_grad_() for _ in range(3))
    out = K4.flash_attention_train(q, k, v, 0, dropout=0.0)
    out.float().sum().backward()
    assert out.dtype == torch.bfloat16 and q.grad is not None
    assert dict(LAUNCHES) == before
    assert {"flash_attention_train_fwd", "flash_attention_train_bwd"} <= set(LAUNCHES)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 136, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 128"):
        K4._check_operands(q, q, q)
    q = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError, match="bf16"):
        K4._check_operands(q, q, q)


@pytest.mark.parametrize("bh,tq,tk,q_block,dropout,seed", [
    (2, 45, 131, 32, 0.1, 99), (3, 20, 1077, 512, 0.5, 7),
    (1, 96, 33, 64, 0.25, 4294967295), (2, 8, 31, 8, 0.1, 0)])
def test_keep_bits_unpack_to_the_keep_mask(bh, tq, tk, q_block, dropout, seed):
    """The forward kernel's saved mask layout: word w of a row holds columns
    32 w .. 32 w + 31, bit j for column 32 w + j, bits past Tk zero."""
    s = torch.tensor(seed)
    bits = K4.keep_bits(s, bh, tq, tk, dropout, q_block)
    assert bits.dtype == torch.int32 and bits.shape == (bh, tq, -(-tk // 32))
    keep = K4.keep_mask(s, bh, tq, tk, dropout, q_block)
    assert torch.equal(K4.unpack_keep_bits(bits, tk), keep)
    words = bits.to(torch.int64) & 0xFFFFFFFF
    col = 33 if tk > 33 else tk - 1
    assert torch.equal((words[..., col // 32] >> (col % 32)) & 1, keep[..., col].to(torch.int64))
    if tk % 32:
        assert int((words[..., -1] >> (tk % 32)).abs().sum()) == 0


@pytest.mark.parametrize("bh,tq,tk,dropout", [(2, 24, 40, 0.25), (3, 45, 131, 0.1)])
def test_plain_backward_from_the_bits_equals_it_from_the_seed(bh, tq, tk, dropout):
    rng = np.random.default_rng(tq)
    q, k, v = (_bf(_mk(rng, bh, t, 16)) for t in (tq, tk, tk))
    d_out = _bf(_mk(rng, bh, tq, 16))
    seed = torch.tensor(4321)
    _, lse = K4.plain_forward(q, k, v, seed, dropout)
    bits = K4.keep_bits(seed, bh, tq, tk, dropout)
    from_seed = K4.plain_backward(q, k, v, lse, d_out, seed, dropout)
    from_bits = K4.plain_backward(q, k, v, lse, d_out, None, dropout, bits=bits)
    for a, b in zip(from_bits, from_seed):
        assert torch.equal(a, b)
    # another seed's bits give other gradients
    other = K4.plain_backward(q, k, v, lse, d_out, None, dropout,
                              bits=K4.keep_bits(seed + 1, bh, tq, tk, dropout))
    assert not torch.equal(other[0], from_seed[0])


def test_kernel_wrappers_on_cpu_tensors_save_and_read_the_bits():
    rng = np.random.default_rng(8)
    q, k, v = (_bf(_mk(rng, 2, t, 64)) for t in (16, 40, 40))
    d_out = _bf(_mk(rng, 2, 16, 64))
    seed = torch.tensor(77)
    out, lse, bits = K4.flash_attention_train_forward(q, k, v, seed, 0.1)
    assert torch.equal(bits, K4.keep_bits(seed, 2, 16, 40, 0.1))
    grads = K4.flash_attention_train_backward(q, k, v, lse, d_out, bits, 0.1)
    for a, b in zip(grads, K4.plain_backward(q, k, v, lse, d_out, seed, 0.1)):
        assert torch.equal(a, b)
    assert K4.flash_attention_train_forward(q, k, v, seed, 0.0)[2] is None
    with pytest.raises(ValueError, match="keep bits"):
        K4.flash_attention_train_backward(q, k, v, lse, d_out, None, 0.1)
    with pytest.raises(ValueError, match="keep bits"):
        K4.flash_attention_train_backward(q, k, v, lse, d_out, bits, 0.0)


def _grads_with_rowsum_delta(q, k, v):
    """dq, dk of the plain backward (loss sum(out^2), no dropout) with the
    row term taken as rowsum(dO * O) from the bf16 output instead of the
    resident sum(P * dP)."""
    qb, kb, vb = (_bf(t) for t in (q, k, v))
    out, lse = K4.plain_forward(qb, kb, vb, torch.tensor(0), 0.0)
    d_out = (2.0 * out.float()).to(torch.bfloat16)
    qf, kf, vf, dof = (t.float() for t in (qb, kb, vb, d_out))
    p = torch.exp(qf @ kf.transpose(-1, -2) - lse[..., None])
    dp = dof @ vf.transpose(-1, -2)
    r = (dof * out.float()).sum(-1, keepdim=True)
    ds = (p * (dp - r)).to(torch.bfloat16).float()
    return [(ds @ kf).to(torch.bfloat16).float().numpy(),
            (ds.transpose(-1, -2) @ qf).to(torch.bfloat16).float().numpy()]


def test_row_term_pass_holds_where_the_rowsum_shortcut_does_not():
    """Keys with a large common component (k = c + 0.1 noise): the rows of dS
    sum to zero, so c cancels in dq = dS k, but an error e in a row term does
    not (it adds -e c). The resident sum(P * dP) holds to the Pallas kernel;
    rowsum(dO * O) carries the bf16 rounding of O (values with a mean, so that
    it is visible) and misses by 29x the tolerance."""
    bh, tq, tk, hd = 2, 64, 256, 64
    rng = np.random.default_rng(11)
    q = (0.125 * rng.normal(size=(bh, tq, hd))).astype(np.float32)
    c = rng.normal(size=(bh, 1, hd))
    k = (c + 0.1 * rng.normal(size=(bh, tk, hd))).astype(np.float32)
    v = (1.0 + rng.normal(size=(bh, tk, hd))).astype(np.float32)
    _, ref_g = _jax_out_and_grads(q, k, v, 0, 0.0)
    _, g = _torch_out_and_grads(q, k, v, 0, 0.0)
    _assert_grads(g, ref_g, 1e-2)
    shortcut = _grads_with_rowsum_delta(q, k, v)
    scale = max(np.abs(ref_g[0]).max(), 1.0)
    assert np.abs(shortcut[0] - ref_g[0]).max() / scale > 1e-2
