"""The port's hand-written LAMB, coupled-L2 Adam and LR schedule against
``optax`` on the same gradients over ten steps (CPU), at 1e-6 relative to each
leaf's largest value. The tree holds a fused ``to_kv`` leaf that the port
stores as two parameters: LAMB's trust ratio has to be taken over both."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from voxactb_tpu.agents.qfunction import cosine_hard_restarts_schedule as jax_schedule
from voxactb_tpu.agents.qfunction import make_optimizer as jax_make_optimizer
from voxactb_tpu.config import MethodConfig as JaxConfig
from voxactb_tpu_torch import optim as O
from voxactb_tpu_torch.agents.qfunction import make_optimizer
from voxactb_tpu_torch.config import MethodConfig

STEPS = 10
GROUPS = [["attn.to_k", "attn.to_v"]]


def _tree(rng, scale=1.0):
    """A small flax-like tree: a fused to_kv kernel [in, 2 * inner], a dense
    kernel, a bias that starts at zero (trust ratio 1) and a scalar-like leaf."""
    return {"to_kv": (rng.normal(size=(12, 16)) * scale).astype(np.float32),
            "dense": (rng.normal(size=(7, 5)) * scale).astype(np.float32),
            "bias": np.zeros((5,), np.float32),
            "latents": (rng.normal(size=(3, 4)) * 3 * scale).astype(np.float32)}


def _to_port(tree):
    """The same values as the port stores them: to_kv split into k and v."""
    t = {k: torch.tensor(v) for k, v in tree.items() if k != "to_kv"}
    t["attn.to_k"] = torch.tensor(tree["to_kv"][:, :8].T.copy())
    t["attn.to_v"] = torch.tensor(tree["to_kv"][:, 8:].T.copy())
    return t


def _from_port(t):
    out = {k: v.numpy() for k, v in t.items() if not k.startswith("attn.")}
    out["to_kv"] = np.concatenate([t["attn.to_k"].numpy().T, t["attn.to_v"].numpy().T], -1)
    return out


def _run_both(jax_opt, port_opt, seed=0):
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    grads = [_tree(rng, 0.1 * (1 + i % 3)) for i in range(STEPS)]
    for g in grads:
        g["bias"] = rng.normal(size=(5,)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax_opt.init(jp)
    update = jax.jit(jax_opt.update)
    tp = _to_port(params)
    ts = port_opt.init(tp)
    worst = 0.0
    for g in grads:
        upd, js = update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = port_opt.update(_to_port(g), ts, tp)
        got = _from_port(tp)
        for k in params:
            ref = np.asarray(jp[k])
            scale = max(float(np.abs(ref).max()), 1e-30)  # the zero bias at lr 0
            worst = max(worst, float(np.abs(got[k] - ref).max()) / scale)
    assert int(ts.count) == STEPS
    return worst, tp, jp


@pytest.mark.parametrize("lr_scheduler", [False, True], ids=["constant_lr", "schedule"])
def test_lamb_matches_optax_over_ten_steps(lr_scheduler):
    kw = dict(optimizer="lamb", lr=5e-3, lambda_weight_l2=1e-3, lr_scheduler=lr_scheduler,
              num_warmup_steps=4)
    port = make_optimizer(MethodConfig(**kw), 20_000).with_leaf_groups(GROUPS)
    worst, _, _ = _run_both(jax_make_optimizer(JaxConfig(**kw), 20_000), port)
    assert worst < 1e-6, worst


def test_lamb_with_a_trust_ratio_per_to_k_and_to_v_leaf_drifts():
    """The trap: without the leaf group, to_k and to_v get a ratio each and the
    parameters leave optax's from the first step."""
    kw = dict(optimizer="lamb", lr=5e-3, lambda_weight_l2=1e-3)
    port = make_optimizer(MethodConfig(**kw), 20_000)  # no groups
    worst, _, _ = _run_both(jax_make_optimizer(JaxConfig(**kw), 20_000), port)
    assert worst > 1e-4, worst


def test_adam_with_coupled_l2_matches_optax_over_ten_steps():
    kw = dict(optimizer="adam", lr=1e-3, lambda_weight_l2=1e-2)
    port = make_optimizer(MethodConfig(**kw), 20_000).with_leaf_groups(GROUPS)
    worst, tp, _ = _run_both(jax_make_optimizer(JaxConfig(**kw), 20_000), port)
    assert worst < 1e-6, worst
    # coupled, not decoupled: the zero-gradient direction still moves
    with pytest.raises(ValueError, match="Unknown optimizer"):
        make_optimizer(MethodConfig(optimizer="sgd"))


@pytest.mark.parametrize("warmup,total,cycles", [(3000, 100_000, 10), (10, 200, 3),
                                                 (0, 50, 1)])
def test_cosine_hard_restarts_schedule_matches_jax(warmup, total, cycles):
    ref_fn = jax.jit(jax_schedule(5e-4, warmup, total, cycles))
    fn = O.cosine_hard_restarts_schedule(5e-4, warmup, total, cycles)
    steps = np.unique(np.concatenate([np.arange(0, 40), [warmup - 1, warmup, warmup + 1],
                                      np.linspace(0, total + 10, 300).astype(int)]))
    steps = steps[steps >= 0]
    ref = np.asarray([float(ref_fn(int(s))) for s in steps])
    got = np.asarray([float(fn(torch.tensor(int(s)))) for s in steps])
    # f32 cos of an argument with a few ulps of error: absolute, at the lr's scale
    np.testing.assert_allclose(got, ref, atol=5e-4 * 1e-5)
    assert got.max() <= 5e-4 * (1 + 1e-6) and got[steps >= total].max() == 0.0


def test_state_roundtrip_and_global_norm():
    rng = np.random.default_rng(1)
    p = _to_port(_tree(rng))
    opt = O.Optimizer("lamb", 1e-3, leaf_groups=GROUPS)
    _, st = opt.update(_to_port(_tree(rng)), opt.init(p), p)
    back = O.state_from_saved(O.state_to_cpu(st))
    assert int(back.count) == 1 and back.count.dtype == torch.int64
    for k in p:
        assert torch.equal(back.mu[k], st.mu[k]) and torch.equal(back.nu[k], st.nu[k])
        assert st.mu[k].dtype == torch.float32
    g = _tree(rng)
    ref = float(optax.global_norm(jax.tree_util.tree_map(jnp.asarray, g)))
    np.testing.assert_allclose(float(O.global_norm(_to_port(g))), ref, rtol=1e-6)
