"""K7 (voxactb_tpu_torch/ops/cuda/sam_attention.py): the plain version the
wrapper takes on the CPU against the JAX package's global_rel_attention
kernel in interpret mode and against the XLA formulation it replaces, on
ragged grids; the planted faults of the on-card check move it; the CPU
wrapper launches nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.ops.pallas.sam_attention import global_rel_attention as jax_kernel
from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.sam_attention import global_rel_attention
from voxactb_tpu_torch.ops.sam_attention import global_rel_attention_plain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed, bh, kh, kw, hd):
    rng = np.random.default_rng(seed)
    t = kh * kw
    q = (rng.normal(size=(bh, t, hd)) * hd ** -0.5).astype(np.float32)
    k, v = (rng.normal(size=(bh, t, hd)).astype(np.float32) for _ in range(2))
    rel_h = rng.normal(size=(bh, t, kh)).astype(np.float32)
    rel_w = (0.5 * rng.normal(size=(bh, t, kw))).astype(np.float32)
    return q, k, v, rel_h, rel_w


def _xla_reference(q, k, v, rel_h, rel_w, kh, kw):
    """The XLA math of WindowAttention (tests/test_sam_attention.py)."""
    bh, t, _ = q.shape
    attn = jnp.einsum("bid,bjd->bij", q, k, preferred_element_type=jnp.float32)
    attn = (attn.reshape(bh, t, kh, kw) + rel_h[..., :, None]
            + rel_w[..., None, :]).reshape(bh, t, t)
    return jnp.einsum("bij,bjd->bid", jax.nn.softmax(attn, axis=-1).astype(v.dtype), v)


def _torch(*arrays):
    q, k, v, rel_h, rel_w = arrays
    bf = torch.bfloat16
    return (torch.tensor(q).to(bf), torch.tensor(k).to(bf), torch.tensor(v).to(bf),
            torch.tensor(rel_h), torch.tensor(rel_w))


@pytest.mark.parametrize("bh,kh,kw,hd", [
    (3, 8, 8, 16),    # the JAX package's own kernel test
    (2, 5, 7, 80),    # ragged: T = 35 is no multiple of 16; ViT-H's head dim
    (4, 3, 6, 16),    # kh != kw
])
def test_plain_version_matches_pallas_kernel(bh, kh, kw, hd):
    arrays = _inputs(bh * 100 + kh * 10 + kw, bh, kh, kw, hd)
    bf = jnp.bfloat16
    q, k, v, rel_h, rel_w = (jnp.asarray(a, bf) if i < 3 else jnp.asarray(a)
                             for i, a in enumerate(arrays))
    ref = np.asarray(jax_kernel(q, k, v, rel_h, rel_w, kh=kh, kw=kw, interpret=True),
                     np.float32)
    got = global_rel_attention_plain(*_torch(*arrays), kh=kh, kw=kw)
    assert got.dtype == torch.bfloat16 and got.shape == (bh, kh * kw, hd)
    # the Pallas kernel folds the bias into its contraction through a hi/lo
    # bf16 split (within 2^-17 of each value) and sums in another order, so an
    # output may sit one bf16 ulp away: 2^-7 of the largest covers one to two
    np.testing.assert_allclose(got.float().numpy(), ref,
                               atol=2.0 ** -7 * np.abs(ref).max(), rtol=0)
    # against the XLA formulation, the same rounding points: bit for bit or
    # one f32 summation order away
    xla = np.asarray(_xla_reference(q, k, v, rel_h, rel_w, kh, kw), np.float32)
    np.testing.assert_allclose(got.float().numpy(), xla,
                               atol=2.0 ** -8 * np.abs(xla).max(), rtol=0)


def test_plain_version_at_f32_matches_xla_math():
    """The encoder's f32 path goes through the same function."""
    arrays = _inputs(3, 2, 4, 6, 16)
    got = global_rel_attention_plain(*(torch.tensor(a) for a in arrays), kh=4, kw=6)
    ref = np.asarray(_xla_reference(*(jnp.asarray(a) for a in arrays), 4, 6))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-5)


def test_planted_faults_move_the_output():
    """The on-card check's faults, on the plain version: rel_h read by the
    key's grid column (h and w swapped) and the key tail past T taking part
    must each move the output by more than the 2^-7 tolerance."""
    import chip_smoke

    g = torch.Generator().manual_seed(0)
    q, k, v, rel_h, rel_w = chip_smoke.sam_attention_inputs(g, "ragged", 2, 14, 14, "cpu")
    ref = global_rel_attention_plain(q, k, v, rel_h, rel_w, kh=14, kw=14)
    tol = 2.0 ** -7 * float(ref.float().abs().max())
    swapped = global_rel_attention(q, k, v, rel_w, rel_h, kh=14, kw=14)
    tail = chip_smoke.sam_unmasked_tail(q, k, v, rel_h, rel_w, 14, 14)
    for wrong in (swapped, tail):
        assert (wrong.float() - ref.float()).abs().max() > 10 * tol


def test_dropped_columns_fault_moves_the_output():
    """The on-card check's fault for head dim 80, on the plain version: q k^T
    without the columns 64-79 (the kernel's second, 16-column box) must move
    the ragged case's output by more than the 2^-7 tolerance."""
    import chip_smoke

    g = torch.Generator().manual_seed(0)
    q, k, v, rel_h, rel_w = chip_smoke.sam_attention_inputs(g, "ragged", 2, 14, 14, "cpu")
    assert q.shape[-1] == 80
    ref = global_rel_attention_plain(q, k, v, rel_h, rel_w, kh=14, kw=14)
    tol = 2.0 ** -7 * float(ref.float().abs().max())
    wrong = chip_smoke.sam_dropped_columns(q, k, v, rel_h, rel_w, 14, 14)
    assert (wrong.float() - ref.float()).abs().max() > 4 * tol


def test_cpu_wrapper_takes_plain_version():
    tensors = _torch(*_inputs(0, 2, 4, 4, 16))
    before = dict(LAUNCHES)
    assert torch.equal(global_rel_attention(*tensors, kh=4, kw=4),
                       global_rel_attention_plain(*tensors, kh=4, kw=4))
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="kh \\* kw"):
        global_rel_attention_plain(*tensors, kh=4, kw=3)
