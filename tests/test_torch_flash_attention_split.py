"""K2's key-split schedule (voxactb_tpu_torch/ops/cuda/flash_attention.py):
a plain model of its arithmetic (per-split row max and sum, merged in split
order before P is normalised and cast, partial P v summed in split order)
against the JAX package's flash-attention kernel in interpret mode; the
planted fault of the on-card check (each split normalised alone) missing it;
and the wrapper's schedule choice on the act's shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from voxactb_tpu_torch.ops.cuda.flash_attention import (
    KEY_TILE, MAX_SPLITS, ROWS, all_schedules, choose_schedule)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def split_model(q, k, v, splits, merge=True):
    """The kernel's key-split arithmetic in plain PyTorch: the key tiles of
    ``KEY_TILE`` cut into ``splits`` runs as the kernel cuts them; each
    split's row max and sum of exp(l - max); merged in split order (a split
    whose max is -inf adds nothing) into the whole row's m and s; P =
    bf16(exp(l - m) / s) over each split's keys; the splits' f32 P v summed
    in split order and rounded once. With ``merge=False`` each split
    normalises by its own m and s (the planted fault)."""
    f32 = torch.float32
    tk = k.shape[1]
    n = -(-tk // KEY_TILE)
    cuts = [min(tk, KEY_TILE * (i * n // splits)) for i in range(splits + 1)]
    logits = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2))
    parts = []
    for a, b in zip(cuts, cuts[1:]):
        lg = logits[..., a:b]
        m = lg.amax(-1, keepdim=True)
        parts.append((lg, m, torch.exp(lg - m).sum(-1, keepdim=True)))
    m_row = parts[0][1]
    for _, m, _ in parts[1:]:
        m_row = torch.maximum(m_row, m)
    s_row = torch.zeros_like(m_row)
    for _, m, s in parts:
        s_row = s_row + torch.where(m == -torch.inf, torch.zeros_like(s),
                                    s * torch.exp(m - m_row))
    out = torch.zeros(q.shape[:-1] + (v.shape[-1],), dtype=f32)
    for (lg, m, s), a, b in zip(parts, cuts, cuts[1:]):
        mm, ss = (m_row, s_row) if merge else (m, s)
        p = (torch.exp(lg - mm) / ss).to(v.dtype).to(f32)
        out = out + torch.matmul(p, v[:, a:b].to(f32))
    return out.to(v.dtype)


def _bf16(*arrays):
    return tuple(torch.tensor(a).to(torch.bfloat16) for a in arrays)


def _jax(q, k, v):
    bf = jnp.bfloat16
    return np.asarray(jax_flash(jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf),
                                interpret=True), np.float32)


@pytest.mark.parametrize("splits,tk", [
    (1, 200),   # one CTA: the plain two-pass arithmetic
    (2, 256),   # two whole tiles
    (3, 333),   # three splits of one tile each, the last ragged (77 keys)
    (2, 333),   # uneven: one tile, then two (the last ragged)
])
def test_split_model_matches_pallas_kernel(splits, tk):
    rng = np.random.default_rng(splits * 1000 + tk)
    bh, tq, hd = 2, 16, 64
    q = (rng.normal(size=(bh, tq, hd)) * hd ** -0.5).astype(np.float32)
    k = rng.normal(size=(bh, tk, hd)).astype(np.float32)
    v = rng.normal(size=(bh, tk, hd)).astype(np.float32)
    ref = _jax(q, k, v)
    got = split_model(*_bf16(q, k, v), splits)
    assert got.dtype == torch.bfloat16 and got.shape == (bh, tq, hd)
    # the same rounding points (P normalised in f32 with the whole row's m and
    # s before its bf16 cast); f32 sums in another order may move an output by
    # one bf16 ulp
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2.0 ** -8 * np.abs(ref).max(),
                               rtol=0)


def test_per_split_normalisation_misses():
    """The on-card check's inputs at a small size: each split's values of
    another sign and the row max in the last split. The merged model agrees
    with the Pallas kernel; splits normalised alone do not."""
    rng = np.random.default_rng(5)
    bh, tq, hd, tk, splits = 1, 16, 64, 333, 2
    n = -(-tk // KEY_TILE)
    cuts = [i * n // splits for i in range(splits + 1)]
    split_of = np.repeat([i for i in range(splits) for _ in range(cuts[i], cuts[i + 1])],
                         KEY_TILE)[:tk]
    sign = (1.0 - 2.0 * (split_of % 2))[None, :, None]
    last = (split_of == splits - 1).astype(np.float64)[None, :, None]
    q = (0.25 + 0.05 * rng.normal(size=(bh, tq, hd))).astype(np.float32)
    k = (0.5 * last + 0.2 * rng.normal(size=(bh, tk, hd))).astype(np.float32)
    v = (sign + 0.5 * rng.normal(size=(bh, tk, hd))).astype(np.float32)
    ref = _jax(q, k, v)
    tol = 2.0 ** -7 * np.abs(ref).max()
    merged = split_model(*_bf16(q, k, v), splits).float().numpy()
    np.testing.assert_allclose(merged, ref, atol=tol, rtol=0)
    alone = split_model(*_bf16(q, k, v), splits, merge=False).float().numpy()
    assert np.abs(alone - ref).max() > 50 * tol


# (BH, Tq, Tk) of one act at batch 1 (heads 8, 2048 latents, 77 language
# tokens + the grid's patches) and whether a 132-SM card splits the keys
ACT_SHAPES = {
    "cross 100^3": ((1, 2048, 77 + 20 ** 3), True),
    "cross 50^3": ((1, 2048, 77 + 10 ** 3), True),
    "decoder 50^3": ((1, 77 + 10 ** 3, 2048), True),
    "self": ((8, 2048, 2048), False),
    "decoder 100^3": ((1, 77 + 20 ** 3, 2048), False),
    "cross 100^3 batch 8": ((8, 2048, 77 + 20 ** 3), False),
    "self batch 8": ((64, 2048, 2048), False),
}


@pytest.mark.parametrize("name", list(ACT_SHAPES))
def test_schedule_choice_on_act_shapes(name):
    (bh, tq, tk), splits_keys = ACT_SHAPES[name]
    rows, splits = choose_schedule(bh, tq, tk, 132)
    assert (rows, splits) in all_schedules(tk)
    assert (splits > 1) == splits_keys
    if splits > 1:
        # the split fills at least half the card without passing it
        blocks = bh * -(-tq // rows)
        assert 66 <= blocks * splits <= 132


def test_all_schedules_cover_rows_and_splits():
    assert all_schedules(100) == [(64, 1), (128, 1)]
    got = all_schedules(8077)
    assert len(got) == len(ROWS) * MAX_SPLITS and (128, MAX_SPLITS) in got
