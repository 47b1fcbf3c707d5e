"""Building blocks of the port (models/blocks.py, ops/upsample_conv.py) against
the JAX package's on the same flax parameters and numpy-seeded inputs (CPU).

At bf16 the port rounds where the JAX package rounds, so most blocks are
bit-identical; where a long f32 sum is taken in another order (a k3 conv, a
512-wide dense) a bf16 output may land one ulp away."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from voxactb_tpu.models import blocks as JB
from voxactb_tpu.models import perceiver as JP
from voxactb_tpu.ops import upsample_conv as JU
from voxactb_tpu_torch.models import blocks as B
from voxactb_tpu_torch.models import perceiver as P
from voxactb_tpu_torch.ops import upsample_conv as U
from voxactb_tpu_torch.weights import load_flax_params

BF = (jnp.bfloat16, torch.bfloat16)
F32 = (jnp.float32, torch.float32)


def _run(jmod, tmod, *xs):
    params = jmod.init(jax.random.key(0), *[jnp.asarray(x) for x in xs])
    load_flax_params(tmod, jax.tree_util.tree_map(np.asarray, params))
    ref = np.asarray(jmod.apply(params, *[jnp.asarray(x) for x in xs]), np.float32)
    with torch.no_grad():
        got = tmod(*[torch.tensor(x) for x in xs]).float().numpy()
    return got, ref


def _ulp_frac(got, ref):
    """Fraction of elements that differ, and the largest difference in bf16 ulps."""
    diff = np.abs(got - ref)
    ulp = np.maximum(np.abs(ref), 1e-30) * 2.0 ** -7
    return float((diff > 0).mean()), float((diff / ulp).max())


@pytest.mark.parametrize("dt", [F32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("k,s,act", [(1, 1, "lrelu"), (3, 1, "lrelu"), (3, 1, None),
                                     (5, 5, "lrelu")])
def test_conv3d(dt, k, s, act):
    rng = np.random.default_rng(k * 10 + s)
    x = rng.normal(size=(2, 10, 10, 10, 16)).astype(np.float32)
    got, ref = _run(JB.Conv3D(8, k, s, act, zshift_2d=True, dtype=dt[0]),
                    B.Conv3D(16, 8, k, s, act, dtype=dt[1]), x)
    assert got.shape == ref.shape
    if dt is F32:
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
    else:
        frac, ulps = _ulp_frac(got, ref)
        assert ulps <= 1.0 and frac < 1e-2, (frac, ulps)


def test_compose_upsample_kernel_bit_identical_at_bf16():
    rng = np.random.default_rng(0)
    k = (rng.normal(size=(5, 5, 5, 16, 8)) * 0.1).astype(np.float32)
    ref = np.asarray(JU.compose_upsample_kernel(jnp.asarray(k, jnp.bfloat16), 5),
                     np.float32)
    got = U.compose_upsample_kernel(torch.tensor(k).to(torch.bfloat16), 5).float().numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("fast", [True, False], ids=["phase", "exact"])
def test_upsample_conv_f32(fast):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 3, 3, 3, 8)).astype(np.float32)
    k = (rng.normal(size=(5, 5, 5, 8, 4)) * 0.1).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    jop = JU.upsample_conv if fast else JU.reference_upsample_conv
    top = U.upsample_conv if fast else U.reference_upsample_conv
    ref = np.asarray(jop(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), 5))
    got = top(torch.tensor(x), torch.tensor(k), torch.tensor(b), 5).numpy()
    assert got.shape == (1, 15, 15, 15, 4)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dt", [F32, BF], ids=["f32", "bf16"])
def test_conv3d_upsample_module(dt):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 2, 2, 2, 16)).astype(np.float32)
    got, ref = _run(JB.Conv3DUpsample(8, 5, 5, "lrelu", dtype=dt[0]),
                    B.Conv3DUpsample(16, 8, 5, 5, "lrelu", dtype=dt[1]), x)
    if dt is F32:
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
    else:
        frac, ulps = _ulp_frac(got, ref)
        assert ulps <= 1.0 and frac < 1e-2, (frac, ulps)


def _softargmax_f64(x, temperature=0.01):
    """The soft-argmax formula in float64, and the error that f32 arithmetic
    can put on each keypoint, per (batch, channel, axis).

    kp = sum_i e_i pos_i / sum_i e_i with e_i = exp(a_i), a_i = (x_i - m) * 100.
    With u = 2^-24 (half an f32 ulp, relative):
    - the argument carries two roundings (the subtraction, the product by 100),
      so e_i moves by up to 2u |a_i| relative, and exp itself by about one ulp
      (2u): e_i (1 + d_i) with |d_i| <= 2u (|a_i| + 1). A relative error d_i on
      term i moves kp by w_i d_i (pos_i - kp), w the softmax weights;
    - each of the two n^3-term sums is taken in f32 in an order that depends on
      the machine's blocking and vector width. Every addition rounds a partial
      sum no larger than sum|t_i|; the errors of n^3 additions accumulate as a
      random walk: sqrt(n^3) u sum|t_i| (Higham's rule of thumb; the worst case
      is n^3 u). On kp: sqrt(n^3) u (sum_i w_i |pos_i| + |kp|).
    The positions (linspace) differ by at most one ulp between the packages,
    which is within the first term.
    """
    b, n = x.shape[0], x.shape[1]
    u = 2.0 ** -24
    flat = x.reshape(b, n ** 3, -1).astype(np.float64)
    m = flat.max(1)
    a = (flat - m[:, None]) / temperature
    e = np.exp(a)
    w = e / e.sum(1, keepdims=True)
    lin = np.linspace(-1.0, 1.0, n)
    pos = np.stack([np.broadcast_to(lin[None, :, None], (n, n, n)).reshape(-1),
                    np.broadcast_to(lin[:, None, None], (n, n, n)).reshape(-1),
                    np.broadcast_to(lin[None, None, :], (n, n, n)).reshape(-1)], -1)
    kp = np.einsum("bsc,sk->bck", w, pos)
    spread = np.abs(pos[None, :, None, :] - kp[:, None])        # [b, s, c, 3]
    terms = np.einsum("bsc,bsck->bck", w * 2 * u * (np.abs(a) + 1), spread)
    sums = np.sqrt(n ** 3) * u * (np.einsum("bsc,sk->bck", w, np.abs(pos)) + np.abs(kp))
    return kp.reshape(b, -1), m, (terms + sums).reshape(b, -1)


@pytest.mark.parametrize("n", [10, 20])
def test_softargmax_stats_3d(n):
    """Port and JAX package each against the float64 evaluation of the same
    formula, within 6x the error f32 arithmetic can give (``_softargmax_f64``;
    the largest bound over the keypoints, since which keypoint draws the
    unlucky summation order depends on the machine), and against each other
    within 8x of it, which is 3e-5 at n = 10 and 7e-5 at n = 20: T = 0.01
    multiplies the logits by 100, so last-bit differences in exp and in the
    order of an n^3-term f32 sum show in the fifth decimal. The global max has
    no arithmetic in it and stays exact."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(2, n, n, n, 6)) * 0.05).astype(np.float32)
    kp64, m64, bound = _softargmax_f64(x)
    bound = bound.max()
    assert 1e-6 < bound < 1e-5, bound
    kp_ref, m_ref = JB.softargmax_stats_3d(jnp.asarray(x))
    kp, m = B.softargmax_stats_3d(torch.tensor(x))
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    np.testing.assert_array_equal(m.numpy(), m64.astype(np.float32))
    kp, kp_ref = kp.numpy().astype(np.float64), np.asarray(kp_ref, np.float64)
    np.testing.assert_allclose(kp, kp64, atol=6 * bound, rtol=0)
    np.testing.assert_allclose(kp_ref, kp64, atol=6 * bound, rtol=0)
    np.testing.assert_allclose(kp, kp_ref, atol=8 * bound, rtol=0)
    # the softmax form of the same function, under the same bounds
    ss = B.spatial_softmax_3d(torch.tensor(x)).numpy().astype(np.float64)
    ss_ref = np.asarray(JB.spatial_softmax_3d(jnp.asarray(x)), np.float64)
    np.testing.assert_allclose(ss, kp64, atol=6 * bound, rtol=0)
    np.testing.assert_allclose(ss_ref, kp64, atol=6 * bound, rtol=0)
    np.testing.assert_allclose(ss, ss_ref, atol=8 * bound, rtol=0)


@pytest.mark.parametrize("dt", [F32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("act", ["lrelu", None])
def test_dense_block(dt, act):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 37)).astype(np.float32)
    got, ref = _run(JB.DenseBlock(24, act, dt[0]), B.DenseBlock(37, 24, act, dtype=dt[1]),
                    x)
    if dt is F32:
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, ref)


def test_layernorm_gelu_feedforward_at_bf16():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(3, 50, 64)) * 3).astype(np.float32)
    # LayerNorm: the f32 row statistics sum in another order (rare one-ulp outputs)
    got, ref = _run(fnn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16),
                    B.LayerNorm(64, dtype=torch.bfloat16), x)
    frac, ulps = _ulp_frac(got, ref)
    assert ulps <= 1.0 and frac < 1e-3, (frac, ulps)
    # gelu: op by op in bf16, bit-identical
    xb = jnp.asarray(x, jnp.bfloat16)
    np.testing.assert_array_equal(
        P.gelu_tanh(torch.tensor(x).to(torch.bfloat16)).float().numpy(),
        np.asarray(jax.nn.gelu(xb), np.float32))
    # FeedForward: the 256-wide w_out sums in another f32 order, and a bf16
    # output near 0 after cancellation moves by an ulp of the terms: within
    # one ulp at the output's scale, in few elements
    got, ref = _run(JP.FeedForward(64, dtype=jnp.bfloat16),
                    P.FeedForward(64, dtype=torch.bfloat16), x)
    assert np.abs(got - ref).max() <= 2.0 ** -7 * np.abs(ref).max()
    assert (got != ref).mean() < 1e-2


def test_lrelu_slope_rounds_like_jax():
    x = np.linspace(-3, 3, 1001).astype(np.float32)
    for jd, td in (BF, F32):
        ref = np.asarray(jax.nn.leaky_relu(jnp.asarray(x, jd), 0.02), np.float32)
        got = B.lrelu(torch.tensor(x).to(td)).float().numpy()
        np.testing.assert_array_equal(got, ref)
