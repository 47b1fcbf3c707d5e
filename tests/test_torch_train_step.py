"""The BC train step of the port against the JAX package (CPU, tiny sizes):
the trunk's parameter gradients in train mode, and one whole step from the
same parameters and optimizer state (losses, ``grad_norm``, updated parameters
and moments), for single-arm with the arm loss and for the two-head variant.
Augmentation, crop jitter and dropout are off where the two packages are
compared (their random streams cannot match) and on where the port is compared
with itself."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.agents import qfunction as JQ
from voxactb_tpu.config import MethodConfig as JaxConfig
from voxactb_tpu.models.perceiver import PerceiverVoxelLangEncoder as JaxEncoder
from voxactb_tpu_torch.agents import qfunction as Q
from voxactb_tpu_torch.config import MethodConfig
from voxactb_tpu_torch.models.perceiver import PerceiverVoxelLangEncoder
from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.weights import (
    flax_tree_to_tensors, load_flax_params, opt_state_from_optax, tensors_to_flax_tree)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

CAMERAS = ["wrist", "wrist2"]
IMG = 12
TINY = dict(voxel_sizes=[10], num_latents=16, latent_dim=32, transformer_depth=1,
            cross_dim_head=16, latent_dim_head=16, final_dim=8, lr=1e-3,
            lambda_weight_l2=1e-3, crop_target_obj_voxel=True, crop_radius=0.3)
MODES = {"single_arm_arm_loss": dict(which_arm="dominant", arm_pred_loss=True),
         "two_heads": dict(which_arm="both", variant="one_policy_more_heads")}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _batch(rng, cfg, b=2):
    n = cfg.voxel_size

    def actions():
        return (rng.integers(0, n, (b, 3)).astype(np.int32),
                np.concatenate([rng.integers(0, 72, (b, 3)), rng.integers(0, 2, (b, 1))],
                               -1).astype(np.int32))

    def pose():
        p = np.concatenate([rng.uniform([-0.1, -0.3, 0.6], [0.4, 0.3, 1.0], (b, 3)),
                            rng.normal(size=(b, 4))], -1).astype(np.float32)
        p[:, 3:] /= np.linalg.norm(p[:, 3:], axis=-1, keepdims=True)
        return p

    t, rg = actions()
    bounds = np.tile(np.asarray([-0.1, -0.3, 0.5, 0.5, 0.3, 1.1], np.float32), (b, 1))
    bounds[1, :3] -= 0.05  # per-sample crops
    batch = {"trans_action_indicies": t, "rot_grip_action_indicies": rg,
             "ignore_collisions": rng.integers(0, 2, (b, 1)).astype(np.int32),
             "gripper_pose": pose(),
             "lang_goal_emb": rng.normal(size=(b, 1024)).astype(np.float32),
             "lang_token_embs": rng.normal(size=(b, 77, 512)).astype(np.float32),
             "low_dim_state": rng.normal(size=(b, cfg.proprio_width())).astype(np.float32),
             "label": rng.integers(0, 2, (b, 1)).astype(np.int32),
             "scene_bounds": np.asarray([-0.3, -0.5, 0.4, 0.5, 0.5, 1.2], np.float32),
             "target_object_scene_bounds": bounds}
    if cfg.variant == "one_policy_more_heads":
        t, rg = actions()
        batch.update(trans_action_indicies_left=t, rot_grip_action_indicies_left=rg,
                     gripper_pose_left=pose())
    for c in CAMERAS:
        batch[f"{c}_rgb"] = rng.integers(0, 255, (b, IMG, IMG, 3)).astype(np.float32)
        batch[f"{c}_point_cloud"] = rng.uniform(-0.3, 1.2, (b, IMG, IMG, 3)).astype(
            np.float32)
    return batch


# -- the trunk in train mode ----------------------------------------------------------

SMALL = dict(depth=2, voxel_size=10, num_latents=32, latent_dim=64, im_channels=8,
             cross_dim_head=16, latent_heads=2, latent_dim_head=16, final_dim=8,
             low_dim_size=4, input_dropout=0.0, attn_dropout=0.0, decoder_dropout=0.0)


def _trunk_grads(jax_kw, torch_kw, seed=0):
    rng = np.random.default_rng(seed)
    xs = (rng.normal(size=(2, 10, 10, 10, 10)).astype(np.float32),
          rng.normal(size=(2, 4)).astype(np.float32),
          rng.normal(size=(2, 1024)).astype(np.float32),
          rng.normal(size=(2, 77, 512)).astype(np.float32))
    jm = JaxEncoder(**SMALL, **jax_kw)
    params = JaxEncoder(**SMALL).init(jax.random.key(0), *map(jnp.asarray, xs))

    def jloss(p):
        out = jm.apply(p, *map(jnp.asarray, xs), train=True,
                       rngs={"dropout": jax.random.key(1)})
        return sum(jnp.sum(v.astype(jnp.float32) ** 2) for v in out.values())

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    tm = PerceiverVoxelLangEncoder(**SMALL, **torch_kw)
    load_flax_params(tm, _np_tree(params))
    out = tm(*map(torch.tensor, xs), train=True)
    loss = sum((v.float() ** 2).sum() for v in out.values())
    loss.backward()
    got = tensors_to_flax_tree(tm, {k: p.grad for k, p in tm.named_parameters()})
    return float(loss), got, float(jl), _np_tree(jg)


def _assert_grad_trees(got, ref, tol):
    """Every leaf within ``tol`` of the largest gradient of the whole tree."""
    ref_leaves = dict(jax.tree_util.tree_leaves_with_path(ref))
    scale = max(float(np.abs(v).max()) for v in ref_leaves.values())
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert len(got_leaves) == len(ref_leaves)
    for path, a in got_leaves:
        np.testing.assert_allclose(a / scale, ref_leaves[path] / scale, atol=tol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_trunk_train_grads_match_jax_f32():
    """f32, dropout 0: 1e-4 of the largest gradient (f32 sums in another order
    through two attention layers and the convs)."""
    loss, got, jl, ref = _trunk_grads({}, {})
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    _assert_grad_trees(got, ref, 1e-4)


@pytest.mark.parametrize("flash_train", [False, True], ids=["plain", "flash_train"])
def test_trunk_train_grads_match_jax_bf16(flash_train):
    """bf16: both packages round activations and cotangents to bf16 at the same
    points, and sum in other orders between them (XLA's CPU backend sums bf16
    reductions of broadcasts in bf16), so gradients agree to a few percent of
    the largest: 5e-2, the bound the JAX package's own flash-train test holds
    its two attention paths to."""
    before = dict(LAUNCHES)
    loss, got, jl, ref = _trunk_grads(
        dict(dtype=jnp.bfloat16, pallas_attention_train=flash_train,
             pallas_interpret=True),
        dict(dtype=torch.bfloat16, pallas_attention_train=flash_train))
    np.testing.assert_allclose(loss, jl, rtol=2e-2)
    _assert_grad_trees(got, ref, 5e-2)
    assert dict(LAUNCHES) == before  # CPU tensors: the plain version, no launch


def test_trunk_flash_train_path_matches_plain_path_bf16():
    """The port against itself: ``pallas_attention_train`` on (K4's plain
    version on the CPU) vs the plain attention path, same weights."""
    torch.manual_seed(0)
    rng = np.random.default_rng(3)
    xs = (rng.normal(size=(2, 10, 10, 10, 10)).astype(np.float32),
          rng.normal(size=(2, 4)).astype(np.float32), None,
          rng.normal(size=(2, 77, 512)).astype(np.float32))
    grads = {}
    for flash in (False, True):
        tm = PerceiverVoxelLangEncoder(**SMALL, dtype=torch.bfloat16,
                                       pallas_attention_train=flash,
                                       generator=torch.Generator().manual_seed(1))
        out = tm(*[None if x is None else torch.tensor(x) for x in xs], train=True)
        sum((v.float() ** 2).sum() for v in out.values()).backward()
        grads[flash] = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    scale = max(np.abs(g).max() for g in grads[False].values())
    for k, g in grads[False].items():
        np.testing.assert_allclose(grads[True][k] / scale, g / scale, atol=5e-2,
                                   err_msg=k)


def test_train_mode_turns_the_inference_kernels_off_and_needs_seeds():
    tm = PerceiverVoxelLangEncoder(**dict(SMALL, attn_dropout=0.1), pallas_decoder=True,
                                   pallas_attention=True, dtype=torch.bfloat16)
    assert tm.num_dropout_seeds() == 4
    seeds = tm.draw_dropout_seeds(torch.Generator().manual_seed(0))
    assert seeds.shape == (4,) and seeds.dtype == torch.int64
    assert (seeds >= 0).all() and (seeds < 2 ** 32).all()
    rng = np.random.default_rng(0)
    xs = [torch.tensor(rng.normal(size=s).astype(np.float32))
          for s in ((1, 10, 10, 10, 10), (1, 4), (1, 1024), (1, 77, 512))]
    a = tm(*xs, train=True, dropout_seeds=seeds)
    b = tm(*xs, train=True, dropout_seeds=seeds)
    c = tm(*xs, train=True, dropout_seeds=seeds + 1)
    assert a["trans"].requires_grad  # the differentiable tail, not the fused kernel
    assert torch.equal(a["trans"], b["trans"]) and not torch.equal(a["trans"], c["trans"])
    with pytest.raises(ValueError, match="inference path"):
        tm(*xs, train=True, front=(None,) * 4)
    with pytest.raises(ValueError, match="needs a seed"):
        tm.self_attn_0(torch.zeros(1, 32, 64), train=True)


# -- one whole step -------------------------------------------------------------------


def _both_steps(mode, optimizer="lamb", **extra):
    kw = dict(TINY, **MODES[mode], apply_se3=False, input_dropout=0.0, attn_dropout=0.0,
              optimizer=optimizer, **extra)
    jcfg, cfg = JaxConfig(**kw), MethodConfig(**kw)
    rng = np.random.default_rng(len(mode))
    batch = _batch(rng, cfg)

    jopt = JQ.make_optimizer(jcfg, 1000)
    _, jinit, jstep = JQ.make_train_step(jcfg, jopt, CAMERAS)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = jinit(jax.random.key(0), jbatch)
    # a common optimizer state three steps in: numpy-seeded moments
    params = _np_tree(jstate.params)
    mu = jax.tree_util.tree_map(
        lambda p: (0.05 * rng.normal(size=p.shape)).astype(np.float32), params)
    nu = jax.tree_util.tree_map(
        lambda p: (0.01 * rng.uniform(0.5, 2.0, size=p.shape)).astype(np.float32), params)
    adam_at = 0 if optimizer == "lamb" else 1
    opt_state = list(jstate.opt_state)
    opt_state[adam_at] = opt_state[adam_at]._replace(
        count=jnp.asarray(3, jnp.int32), mu=jax.tree_util.tree_map(jnp.asarray, mu),
        nu=jax.tree_util.tree_map(jnp.asarray, nu))
    # optax's LR schedule keeps a step count of its own
    opt_state = [s._replace(count=jnp.asarray(3, jnp.int32))
                 if "count" in getattr(s, "_fields", ()) and "mu" not in s._fields else s
                 for s in opt_state]
    jstate = JQ.TrainState(jnp.asarray(3, jnp.int32), jstate.params, tuple(opt_state))
    jnew, jmetrics = jstep(jstate, jbatch, jax.random.key(1))

    opt = Q.make_optimizer(cfg, 1000)
    model, init_fn, step = Q.make_train_step(cfg, opt, CAMERAS, device="cpu")
    state = Q.TrainState(torch.tensor(3), flax_tree_to_tensors(model, params),
                         opt_state_from_optax(model, 3, mu, nu))
    new, metrics = step(state, batch, torch.Generator().manual_seed(0))
    return model, (new, metrics), (jnew, jmetrics), params, adam_at


def _assert_updated_params(model, new_params, jax_new_params, old_tree):
    got = tensors_to_flax_tree(model, new_params)["params"]
    ref_leaves = dict(jax.tree_util.tree_leaves_with_path(_np_tree(jax_new_params)["params"]))
    old_leaves = dict(jax.tree_util.tree_leaves_with_path(old_tree["params"]))
    moved = 0.0
    for path, a in jax.tree_util.tree_leaves_with_path(got):
        r = ref_leaves[path]
        move = float(np.abs(r - old_leaves[path]).max())
        np.testing.assert_allclose(a, r, atol=1e-6 * np.abs(r).max() + 1e-3 * move, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
        moved = max(moved, move)
    return moved


@pytest.mark.parametrize("mode", list(MODES))
def test_one_step_matches_jax_f32(mode):
    model, (new, metrics), (jnew, jmetrics), params, _ = _both_steps(mode)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        # losses to 1e-4, the norm of all gradients to 1e-3
        rtol = 1e-3 if k == "grad_norm" else 1e-4
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=rtol, err_msg=k)
    assert int(new.step) == int(jnew.step) == 4
    # updated parameters: u = mu_hat / (sqrt(nu_hat) + eps) is smooth in the
    # gradient with these moments, so the f32 noise of the gradients (1e-4 of
    # the tree's largest, more of a small leaf's own) reaches a leaf's update
    # at about that size: 1e-3 of the leaf's largest move, plus the f32
    # rounding of the parameter itself
    moved = _assert_updated_params(model, new.params, jnew.params, params)
    assert moved > 1e-5  # the step did move the parameters
    # the moments, in the flax layout
    jadam = jnew.opt_state[0]
    assert int(new.opt_state.count) == int(jadam.count) == 4
    # the moments take in a tenth (mu) and a thousandth (nu) of the gradients,
    # whose f32 noise is 1e-4 of the largest: 3e-5 of a leaf's largest moment
    for mine, theirs, tol in ((new.opt_state.mu, jadam.mu, 3e-5),
                              (new.opt_state.nu, jadam.nu, 3e-5)):
        ref = dict(jax.tree_util.tree_leaves_with_path(_np_tree(theirs)))
        for path, a in jax.tree_util.tree_leaves_with_path(
                tensors_to_flax_tree(model, mine)):
            np.testing.assert_allclose(a, ref[path], rtol=0,
                                       atol=tol * max(np.abs(ref[path]).max(), 1e-6),
                                       err_msg=jax.tree_util.keystr(path))


def test_one_adam_step_with_schedule_matches_jax_f32():
    model, (new, metrics), (jnew, jmetrics), params, _ = _both_steps(
        "single_arm_arm_loss", optimizer="adam", lr_scheduler=True, num_warmup_steps=10)
    np.testing.assert_allclose(float(metrics["total_loss"]), float(jmetrics["total_loss"]),
                               rtol=1e-4)
    assert _assert_updated_params(model, new.params, jnew.params, params) > 1e-6


# -- the port against itself, everything on ---------------------------------------------


def _port_step(remat=False, seed=0, steps=1, **kw):
    cfg = MethodConfig(**dict(TINY, **MODES["single_arm_arm_loss"], apply_se3=True,
                              randomizations_crop_point=True, compute_dtype="bfloat16",
                              pallas_attention_train=True, remat=remat, **kw))
    batch = _batch(np.random.default_rng(0), cfg)
    model, init_fn, step = Q.make_train_step(cfg, Q.make_optimizer(cfg, 1000), CAMERAS,
                                             device="cpu", seed=3)
    state = init_fn()
    metrics, grads = step.loss_and_grads(state, batch, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch, g)
        losses.append(float(m["total_loss"]))
    return metrics, grads, losses, state, model


def test_remat_gives_the_same_loss_and_grads_with_dropout_on():
    """``remat`` recomputes the forward in the backward: the dropout seeds are
    drawn before the checkpoint, so the recomputed masks are the same."""
    m0, g0, _, _, _ = _port_step(remat=False)
    m1, g1, _, _, _ = _port_step(remat=True)
    assert float(m0["total_loss"]) == float(m1["total_loss"])
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert max(float(g.abs().max()) for g in g0.values()) > 0


def test_step_is_a_function_of_state_batch_and_generator():
    _, _, a, state, model = _port_step(seed=0, steps=3)
    _, _, b, _, _ = _port_step(seed=0, steps=3)
    _, _, c, _, _ = _port_step(seed=1, steps=3)
    assert a == b and a != c
    assert all(np.isfinite(a)) and int(state.step) == 3
    # the step leaves the module's own (initial) weights untouched
    first = next(iter(state.params))
    assert not torch.equal(state.params[first], dict(model.named_parameters())[first])
    assert all(v.dtype == torch.float32 for v in state.opt_state.mu.values())


def test_loss_weights_and_static_bounds():
    cfg = MethodConfig(**dict(TINY, crop_target_obj_voxel=False, apply_se3=False,
                              input_dropout=0.0, attn_dropout=0.0, trans_loss_weight=2.0,
                              rot_loss_weight=0.5, grip_loss_weight=3.0,
                              collision_loss_weight=0.25))
    batch = _batch(np.random.default_rng(1), cfg)
    _, init_fn, step = Q.make_train_step(cfg, Q.make_optimizer(cfg), CAMERAS, device="cpu")
    m, _ = step.loss_and_grads(init_fn(), batch)
    want = (2.0 * m["trans_loss"] + 0.5 * m["rot_loss"] + 3.0 * m["grip_loss"]
            + 0.25 * m["collision_loss"])
    np.testing.assert_allclose(float(m["total_loss"]), float(want), rtol=1e-6)
    assert "arm_loss" not in m
