"""K3 (voxactb_tpu_torch/ops/cuda/decoder_head.py): the plain version the
wrapper takes on the CPU against the JAX package's decoder_head_v2 kernel in
interpret mode, for one and two trans heads, at bf16 and at f32 (both compute
in d0's dtype); the kernel's operand check refuses f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.ops.pallas.decoder_head_v2 import decoder_head_v2
from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.decoder_head import (
    check_tail_operands, decoder_head, decoder_head_reference)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _case(t_heads, n=10, c=16, b=2):
    rng = np.random.default_rng(t_heads)
    d0 = rng.normal(size=(b, n, n, n, c)).astype(np.float32)
    u0 = rng.normal(size=(b, n, n, n, c)).astype(np.float32)
    wf = (rng.normal(size=(3, 3, 3, 2 * c, c)) * 0.1).astype(np.float32)
    bf = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    wt = (rng.normal(size=(t_heads, 3, 3, 3, c, 1)) * 0.1).astype(np.float32)
    bt = (rng.normal(size=(t_heads,)) * 0.1).astype(np.float32)
    return d0, u0, wf, bf, wt, bt


@pytest.mark.parametrize("t_heads", [1, 2])
def test_plain_version_matches_pallas_kernel(t_heads):
    d0, u0, wf, bf, wt, bt = _case(t_heads)
    j = decoder_head_v2(jnp.asarray(d0, jnp.bfloat16), jnp.asarray(u0, jnp.bfloat16),
                        jnp.asarray(wf), jnp.asarray(bf), jnp.asarray(wt),
                        jnp.asarray(bt), interpret=True)
    tb = torch.bfloat16
    trans, kp, gmax = decoder_head_reference(
        torch.tensor(d0).to(tb), torch.tensor(u0).to(tb), torch.tensor(wf),
        torch.tensor(bf), torch.tensor(wt), torch.tensor(bt))
    assert trans.dtype == torch.float32 and trans.shape == (2, 10, 10, 10, t_heads)
    ref = np.asarray(j[0])
    # u: 3456-term f32 sums in another order, rounded to bf16 (a sum on a
    # rounding boundary moves u by one ulp); trans is then a 432-term f32 sum
    np.testing.assert_allclose(trans.numpy(), ref, atol=2e-3 * np.abs(ref).max(), rtol=0)
    np.testing.assert_allclose(kp.numpy(), np.asarray(j[1]), atol=1e-4)
    np.testing.assert_allclose(gmax.numpy(), np.asarray(j[2]),
                               atol=2.0 ** -7 * np.abs(np.asarray(j[2])).max())
    assert (trans.numpy().reshape(2, -1, t_heads).argmax(1)
            == ref.reshape(2, -1, t_heads).argmax(1)).all()


def test_trans_stays_f32():
    """The tail kernel keeps trans in f32 (acc + bt), not rounded to bf16."""
    d0, u0, wf, bf, wt, bt = _case(1)
    tb = torch.bfloat16
    trans, _, _ = decoder_head_reference(torch.tensor(d0).to(tb), torch.tensor(u0).to(tb),
                                         torch.tensor(wf), torch.tensor(bf),
                                         torch.tensor(wt), torch.tensor(bt))
    assert (trans != trans.to(tb).float()).any()


def test_cpu_wrapper_takes_plain_version():
    args = [torch.tensor(a) for a in _case(2)]
    args[0], args[1] = args[0].to(torch.bfloat16), args[1].to(torch.bfloat16)
    before = dict(LAUNCHES)
    for a, b in zip(decoder_head(*args), decoder_head_reference(*args)):
        assert torch.equal(a, b)
    assert LAUNCHES == before


@pytest.mark.parametrize("t_heads", [1, 2])
def test_plain_version_at_f32_matches_pallas_kernel(t_heads):
    """At f32 the JAX tail computes in f32 (decoder_head_v2 takes d0's
    dtype), and so does the plain version: no bf16 rounding anywhere."""
    d0, u0, wf, bf, wt, bt = _case(t_heads)
    j = decoder_head_v2(*map(jnp.asarray, (d0, u0, wf, bf, wt, bt)), interpret=True)
    trans, kp, gmax = decoder_head_reference(*map(torch.tensor, (d0, u0, wf, bf, wt, bt)))
    ref, kp_ref, gmax_ref = (np.asarray(a) for a in j)
    assert trans.dtype == torch.float32
    # f32 sums (3456 terms for u, 432 for trans) in another order: a few f32
    # ulps of the largest; bf16 rounding would be 2^-8 of it
    np.testing.assert_allclose(trans.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    np.testing.assert_allclose(gmax.numpy(), gmax_ref, atol=1e-5 * np.abs(gmax_ref).max(),
                               rtol=0)
    # u itself moves by a few f32 ulps (about 1e-6 of its scale of about 10);
    # T = 0.01 multiplies that by 100 inside a logit, which moves a keypoint
    # by up to its position range (2) times 1e-3 where its weight is split
    # over voxels (bf16 rounds both sides' u alike, so there 1e-4 holds)
    np.testing.assert_allclose(kp.numpy(), kp_ref, atol=2e-3, rtol=0)
    assert (trans.numpy().reshape(2, -1, t_heads).argmax(1)
            == ref.reshape(2, -1, t_heads).argmax(1)).all()


def test_kernel_refuses_f32_operands():
    """The kernel computes in bf16: operands bound for it in f32 raise and
    name the dtype, instead of being rounded to bf16 silently."""
    d0, u0, wf, bf, wt, bt = (torch.tensor(a) for a in _case(1, c=64, n=5, b=1))
    with pytest.raises(ValueError, match="torch.float32"):
        check_tail_operands("decoder_head", d0, wf, wt, u0)
    with pytest.raises(ValueError, match="torch.float32"):
        check_tail_operands("decoder_head", d0.to(torch.bfloat16), wf, wt, u0)
    check_tail_operands("decoder_head", d0.to(torch.bfloat16), wf, wt,
                        u0.to(torch.bfloat16))
