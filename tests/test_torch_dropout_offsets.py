"""K4's dropout mask keyed to the global batch of heads (``MaskIndex``): a rank
that holds some of the samples (a data split) or some of the heads (a
tensor-parallel split) draws the rows of the one-process mask, in the mask,
in the plain forward and in its backward. The global reference is the JAX
package's Pallas kernel in interpret mode on the whole tensor (its mask does
not depend on how the tensor is sharded). With the offsets zeroed, a head
split draws other masks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.ops.pallas.flash_attention import (
    _hash_keep, _thr, flash_attention_train as jax_flash_train)
from voxactb_tpu_torch.ops.cuda import flash_attention_train as K4
from voxactb_tpu_torch.ops.cuda.flash_attention_train import MaskIndex


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


B, H, TQ, TK, HD = 4, 4, 24, 40, 16
DROPOUT, SEED = 0.3, 123456789


def _jax_mask(bh):
    """The TPU kernel's keep mask over the whole ``[B * H]`` batch of heads,
    one ``_hash_keep`` block per head (``TQ`` is below one query block)."""
    tq_pad, tk_pad = K4.padded_extents(TQ, TK)
    heads = [_hash_keep(jnp.uint32(SEED), jnp.uint32(h * tq_pad * tk_pad), tq_pad, tk_pad,
                        _thr(DROPOUT)) for h in range(bh)]
    return np.asarray(jnp.stack(heads))[:, :TQ, :TK] > 0


@pytest.fixture(scope="module")
def global_run():
    """q, k, v of the whole batch, and the JAX kernel's output and gradients."""
    rng = np.random.default_rng(41)
    q, k, v = (rng.normal(size=(B * H, t, HD)).astype(np.float32) for t in (TQ, TK, TK))
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))

    def loss(q, k, v):
        out = jax_flash_train(q, k, v, jnp.uint32(SEED), dropout=DROPOUT, interpret=True)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
    return (q, k, v), np.asarray(out, np.float32), [np.asarray(g, np.float32) for g in grads]


def _splits():
    """(case, [(rows of the global [B * H] axis, MaskIndex)] per rank)."""
    rows = np.arange(B * H).reshape(B, H)
    cases = []
    for n in (2, 4):  # a data split over n ranks
        b = B // n
        cases.append((f"batch{n}", [(rows[r * b:(r + 1) * b].reshape(-1),
                                     MaskIndex(H, H, r * b, 0)) for r in range(n)]))
    h = H // 2  # tp 2: each rank its half of the heads of every sample
    cases.append(("heads2", [(rows[:, t * h:(t + 1) * h].reshape(-1), MaskIndex(h, H, 0, t * h))
                             for t in range(2)]))
    # dp 2 x tp 2
    cases.append(("batch2_heads2", [
        (rows[d * 2:(d + 1) * 2, t * h:(t + 1) * h].reshape(-1), MaskIndex(h, H, d * 2, t * h))
        for d in range(2) for t in range(2)]))
    return cases


@pytest.mark.parametrize("case,ranks", _splits(), ids=[c for c, _ in _splits()])
def test_rank_mask_is_the_global_masks_rows(case, ranks):
    want = _jax_mask(B * H)
    seed = torch.tensor(SEED)
    for rows, index in ranks:
        got = K4.keep_mask(seed, len(rows), TQ, TK, DROPOUT, index=index)
        np.testing.assert_array_equal(got.numpy(), want[rows], err_msg=f"{case} {index}")
        bits = K4.keep_bits(seed, len(rows), TQ, TK, DROPOUT, index=index)
        assert torch.equal(K4.unpack_keep_bits(bits, TK), got)


def test_default_index_is_the_calls_own():
    seed = torch.tensor(SEED)
    assert torch.equal(K4.keep_mask(seed, B * H, TQ, TK, DROPOUT),
                       K4.keep_mask(seed, B * H, TQ, TK, DROPOUT, index=MaskIndex(H, H, 0, 0)))
    assert K4.global_heads(6, MaskIndex(), "cpu").tolist() == list(range(6))


def test_zeroed_offsets_miss_the_head_split():
    """Rank 1 of a head split with its offsets zeroed (as the call's own index
    or with heads but no offset) draws masks that are not its rows."""
    want = _jax_mask(B * H)
    rows = np.arange(B * H).reshape(B, H)[:, H // 2:].reshape(-1)
    seed = torch.tensor(SEED)
    for index in (MaskIndex(), MaskIndex(H // 2, H, 0, 0)):
        got = K4.keep_mask(seed, len(rows), TQ, TK, DROPOUT, index=index).numpy()
        assert (got != want[rows]).mean() > 0.2, index


@pytest.mark.parametrize("case,ranks", _splits(), ids=[c for c, _ in _splits()])
def test_rank_forward_and_backward_are_the_global_rows(global_run, case, ranks):
    (q, k, v), out, grads = global_run
    for rows, index in ranks:
        ts = [torch.tensor(t[rows]).to(torch.bfloat16).requires_grad_() for t in (q, k, v)]
        got = K4.flash_attention_train_reference(*ts, SEED, dropout=DROPOUT, index=index)
        (got.float() ** 2).sum().backward()
        scale = np.abs(out).max()
        np.testing.assert_allclose(got.detach().float().numpy(), out[rows], rtol=0,
                                   atol=1e-2 * scale, err_msg=f"{case} out")
        for name, t, g in zip("qkv", ts, grads):
            np.testing.assert_allclose(t.grad.float().numpy(), g[rows], rtol=0,
                                       atol=2e-2 * np.abs(g).max(), err_msg=f"{case} d{name}")
    # the zero-offset fault on the head split moves the output past that bound
    if case == "heads2":
        rows, index = ranks[1]
        ts = [torch.tensor(t[rows]).to(torch.bfloat16) for t in (q, k, v)]
        bad = K4.flash_attention_train_reference(*ts, SEED, dropout=DROPOUT,
                                                 index=index._replace(head_offset=0))
        assert np.abs(bad.float().numpy() - out[rows]).max() > 1e-1 * np.abs(out).max()


def test_rank_output_equals_the_ports_global_call():
    """The port's plain version on the whole batch and on each rank's rows:
    the same numbers (one row's softmax does not see the others)."""
    rng = np.random.default_rng(42)
    q, k, v = (torch.tensor(rng.normal(size=(B * H, t, HD)).astype(np.float32))
               .to(torch.bfloat16) for t in (TQ, TK, TK))
    whole = K4.flash_attention_train_reference(q, k, v, SEED, dropout=DROPOUT)
    for case, ranks in _splits():
        for rows, index in ranks:
            part = K4.flash_attention_train_reference(q[rows], k[rows], v[rows], SEED,
                                                      dropout=DROPOUT, index=index)
            torch.testing.assert_close(part, whole[rows], rtol=0, atol=0, msg=case)
