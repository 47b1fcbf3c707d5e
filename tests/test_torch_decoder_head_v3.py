"""K8 (voxactb_tpu_torch/ops/cuda/decoder_head_v3.py): the phase-weight table
and the plain version the wrapper takes on the CPU against the JAX package's
decoder_head_v3 kernel in interpret mode, for one and two trans heads at bf16
and at f32; and ``Conv3DUpsample(pre_only=True)``, which feeds it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.models import blocks as JB
from voxactb_tpu.ops.pallas.decoder_head_v3 import _phase_weight_table, decoder_head_v3 as jv3
from voxactb_tpu_torch.models import blocks as B
from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.decoder_head_v3 import (
    decoder_head_v3, decoder_head_v3_reference, phase_weight_table)
from voxactb_tpu_torch.weights import load_flax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _case(t_heads, n=10, c=16, b=2):
    rng = np.random.default_rng(10 + t_heads)
    s = n // 5
    d0 = rng.normal(size=(b, n, n, n, c)).astype(np.float32)
    h = rng.normal(size=(b, s, s, s, c)).astype(np.float32)
    upk = (rng.normal(size=(5, 5, 5, c, c)) * 0.08).astype(np.float32)
    upb = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    wf = (rng.normal(size=(3, 3, 3, 2 * c, c)) * 0.1).astype(np.float32)
    bf = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    wt = (rng.normal(size=(t_heads, 3, 3, 3, c, 1)) * 0.1).astype(np.float32)
    bt = (rng.normal(size=(t_heads,)) * 0.1).astype(np.float32)
    return d0, h, upk, upb, wf, bf, wt, bt


def test_phase_weight_table_matches_jax():
    k = (np.random.default_rng(0).normal(size=(5, 5, 5, 16, 16)) * 0.08).astype(np.float32)
    ref = np.asarray(_phase_weight_table(jnp.asarray(k), 5))
    got = phase_weight_table(torch.tensor(k), 5).numpy()
    assert got.shape == ref.shape == (5, 5, 9 * 16, 15 * 16)
    # one f32 contraction each, in another order: a few f32 ulps of entries
    # of up to about 1
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    # the one rounding to bf16: equal, except where an f32 ulp moved an entry
    # across a rounding boundary (one bf16 ulp), or where an entry that
    # cancels to about 1e-7 carries the 1e-6 f32 difference itself
    ref_bf = np.asarray(jnp.asarray(ref).astype(jnp.bfloat16), np.float32)
    got_bf = torch.tensor(got).to(torch.bfloat16).float().numpy()
    diff = np.abs(got_bf - ref_bf)
    assert (diff <= np.abs(ref_bf) * 2.0 ** -7 + 1e-6).all()
    assert (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("t_heads", [1, 2])
def test_plain_version_matches_pallas_kernel(t_heads, dt):
    jdt, tdt = DTYPES[dt]
    d0, h, upk, upb, wf, bf, wt, bt = _case(t_heads)
    ref = jv3(jnp.asarray(d0, jdt), jnp.asarray(h, jdt), *map(jnp.asarray, (upk, upb, wf, bf,
                                                                            wt, bt)),
              interpret=True)
    trans_ref, kp_ref, gmax_ref = (np.asarray(a) for a in ref)
    trans, kp, gmax = decoder_head_v3_reference(
        torch.tensor(d0).to(tdt), torch.tensor(h).to(tdt),
        *map(torch.tensor, (upk, upb, wf, bf, wt, bt)))
    assert trans.dtype == torch.float32 and trans.shape == (2, 10, 10, 10, t_heads)
    trans, kp, gmax = trans.numpy(), kp.numpy(), gmax.numpy()
    t_max, g_max = np.abs(trans_ref).max(), np.abs(gmax_ref).max()
    if dt == "bfloat16":
        # u0 and u are f32 sums (432 and 864 terms) in another order rounded
        # to bf16: one on a rounding boundary moves by one ulp and carries into
        # the 432-term f32 trans sum, as in K3's test
        np.testing.assert_allclose(trans, trans_ref, atol=2e-3 * t_max, rtol=0)
        np.testing.assert_allclose(gmax, gmax_ref, atol=2.0 ** -7 * g_max, rtol=0)
    else:
        # f32 throughout: the sums' order alone, a few f32 ulps of the largest
        np.testing.assert_allclose(trans, trans_ref, atol=1e-5 * t_max, rtol=0)
        np.testing.assert_allclose(gmax, gmax_ref, atol=1e-5 * g_max, rtol=0)
    # T = 0.01 multiplies u's differences by 100 inside the keypoint weights
    np.testing.assert_allclose(kp, kp_ref, atol=1e-4, rtol=0)
    # the action-level contract: the Q-field's argmax per sample and head
    assert (trans.reshape(2, -1, t_heads).argmax(1)
            == trans_ref.reshape(2, -1, t_heads).argmax(1)).all()


def test_cpu_wrapper_takes_plain_version():
    args = [torch.tensor(a) for a in _case(2)]
    args[0], args[1] = args[0].to(torch.bfloat16), args[1].to(torch.bfloat16)
    before = dict(LAUNCHES)
    for a, b in zip(decoder_head_v3(*args), decoder_head_v3_reference(*args)):
        assert torch.equal(a, b)
    assert LAUNCHES == before


def test_upsample_pre_only_matches_jax():
    """``Conv3DUpsample(pre_only=True)`` returns the post-``conv_in`` slab
    (bit-identical to the JAX module's at bf16) and the f32 ``out_kernel`` and
    ``out_bias`` as they are."""
    x = np.random.default_rng(5).normal(size=(1, 2, 2, 2, 16)).astype(np.float32)
    jmod = JB.Conv3DUpsample(8, 5, 5, "lrelu", dtype=jnp.bfloat16)
    params = jmod.init(jax.random.key(0), jnp.asarray(x))
    tmod = B.Conv3DUpsample(16, 8, 5, 5, "lrelu", dtype=torch.bfloat16)
    load_flax_params(tmod, jax.tree_util.tree_map(np.asarray, params))
    jh, jk, jb = jmod.apply(params, jnp.asarray(x), pre_only=True)
    with torch.no_grad():
        h, k, b = tmod(torch.tensor(x), pre_only=True)
    assert h.dtype == torch.bfloat16 and k.dtype == b.dtype == torch.float32
    np.testing.assert_array_equal(h.float().numpy(), np.asarray(jh, np.float32))
    np.testing.assert_array_equal(k.detach().numpy(), np.asarray(jk))
    np.testing.assert_array_equal(b.detach().numpy(), np.asarray(jb))
