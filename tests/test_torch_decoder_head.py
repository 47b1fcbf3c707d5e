"""K3 (voxactb_tpu_torch/ops/cuda/decoder_head.py): the plain version the
wrapper takes on the CPU against the JAX package's decoder_head_v2 kernel in
interpret mode, for one and two trans heads."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.ops.pallas.decoder_head_v2 import decoder_head_v2
from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.decoder_head import decoder_head, decoder_head_reference


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
