"""The port's train-step and SAM-encoder profilers (voxactb_tpu_torch/tools/
profile_train.py, profile_sam.py) against the JAX package's tools/ and
modules on the same parameters, at a narrow width on the CPU:

- profile_train: the synthetic batch equals the JAX tool's bit for bit;
  the stage functions' outputs equal what the JAX tool's stages compute
  (its loss and ``jax.value_and_grad``, the encoder's train-mode outputs,
  one LAMB update with the parameters as gradients through optax, and
  voxelize after an SE(3) augmentation of zero range) on the same weights at
  f32 and dropout 0, within 1e-4 of the largest value (f32 sums in another
  order); every JAX stage and A/B row has its counterpart; the timed rows run.
- profile_sam: the depth-truncated encoders of the ``--stage`` ladder equal
  the JAX encoder's with ``depth_limit`` / ``skip_neck`` at f32 (1e-4 of the
  largest output); the A/B, block and stage rows run and carry the JAX
  tool's keys.
"""

import argparse
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from voxactb_tpu_torch.tools import profile_sam, profile_train

ROOT = os.path.join(os.path.dirname(__file__), "..")
CAMERAS = ("wrist", "wrist2")
TINY = dict(voxel_sizes=[10], num_latents=16, latent_dim=32, transformer_depth=1,
            cross_dim_head=16, latent_dim_head=16, final_dim=8, which_arm="dominant",
            arm_pred_loss=True, crop_target_obj_voxel=True, crop_radius=0.3,
            compute_dtype="float32", input_dropout=0.0, attn_dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees(got, ref, tol=1e-4):
    """Every leaf within ``tol`` of the largest value of the whole tree."""
    ref_leaves = dict(jax.tree_util.tree_leaves_with_path(ref))
    scale = max(float(np.abs(v).max()) for v in ref_leaves.values())
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert len(got_leaves) == len(ref_leaves) > 0
    for path, a in got_leaves:
        np.testing.assert_allclose(a / scale, ref_leaves[path] / scale, atol=tol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_make_batch_equals_the_jax_tool():
    from voxactb_tpu.config import MethodConfig as JaxConfig
    from voxactb_tpu_torch.config import MethodConfig

    ref = _jax_tool("profile_train").make_batch(JaxConfig(**TINY), CAMERAS, 3, img=8)
    got = profile_train.make_batch(MethodConfig(**TINY), CAMERAS, 3, img=8)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.fixture(scope="module")
def stage_setup():
    """The port's seeded encoder at the tiny f32 config, the same weights as
    a flax tree, and one batch (its trans labels taken modulo the 10^3 grid)
    for both."""
    from voxactb_tpu_torch.agents.qfunction import build_encoder
    from voxactb_tpu_torch.config import MethodConfig
    from voxactb_tpu_torch.weights import tensors_to_flax_tree

    cfg = MethodConfig(**TINY)
    model = build_encoder(cfg, device="cpu", seed=0)
    params = tensors_to_flax_tree(model, dict(model.named_parameters()))
    batch = profile_train.make_batch(cfg, CAMERAS, 2, img=16)
    batch["trans_action_indicies"] %= 10
    return cfg, model, params, batch


def _jax_loss(jcfg, batch):
    """The JAX tool's ``grad_only`` loss (tools/profile_train.py), with the
    outputs as its aux."""
    from voxactb_tpu.agents.qfunction import build_encoder, normalize_rgb
    from voxactb_tpu.ops.voxelize import voxelize

    jmodel = build_encoder(jcfg)
    n = jcfg.voxel_size
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p, k):
        pcds = [jb[f"{c}_point_cloud"] for c in CAMERAS]
        rgbs = [normalize_rgb(jb[f"{c}_rgb"]) for c in CAMERAS]
        b = pcds[0].shape[0]
        coords = jnp.concatenate([pc.reshape(b, -1, 3) for pc in pcds], 1)
        feats = jnp.concatenate([r.reshape(b, -1, 3) for r in rgbs], 1)
        grid = voxelize(coords, feats, jb["target_object_scene_bounds"], voxel_size=n)
        out = jmodel.apply(p, grid, jb["low_dim_state"], jb["lang_goal_emb"],
                           jb["lang_token_embs"], train=True, rngs={"dropout": k})
        flat = out["trans"].reshape(b, -1).astype(jnp.float32)
        lab = jb["trans_action_indicies"].astype(jnp.int32)
        flat_label = (lab[:, 0] * n + lab[:, 1]) * n + lab[:, 2]
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(flat, flat_label)), out

    return loss


def test_fwd_and_grad_stages_match_the_jax_tools_stages(stage_setup):
    from voxactb_tpu.config import MethodConfig as JaxConfig
    from voxactb_tpu_torch.weights import tensors_to_flax_tree

    cfg, model, params, batch = stage_setup
    loss_fn = _jax_loss(JaxConfig(**TINY), batch)
    (jl, jout), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jax.random.key(1))
    tb = profile_train.to_device(batch, torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    out = profile_train.fwd_only(cfg, CAMERAS, model, tb, gen)
    assert sorted(out) == sorted(jout)
    _assert_trees({k: v.float().numpy() for k, v in out.items()}, _np_tree(jout))
    loss, grads = profile_train.grad_only(cfg, CAMERAS, model, tb, gen)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _assert_trees(tensors_to_flax_tree(model, grads), _np_tree(jg))


def test_opt_stage_matches_one_optax_update(stage_setup):
    """One LAMB update whose gradients are the parameters (the JAX tool's
    ``opt_only``) from a fresh state: the new parameters."""
    from voxactb_tpu.agents import qfunction as JQ
    from voxactb_tpu.config import MethodConfig as JaxConfig
    from voxactb_tpu_torch.agents import qfunction as Q
    from voxactb_tpu_torch.weights import leaf_groups, load_flax_params, tensors_to_flax_tree

    cfg, _, params, _ = stage_setup
    jopt = JQ.make_optimizer(JaxConfig(**TINY), training_iterations=100_000)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    updates, _ = jax.jit(lambda p, st: jopt.update(p, st, p))(jparams, jopt.init(jparams))
    ref = _np_tree(optax.apply_updates(jparams, updates))
    model, init_fn, _ = Q.make_train_step(cfg, Q.make_optimizer(cfg, 100_000), CAMERAS,
                                          device="cpu")
    load_flax_params(model, params)
    opt = Q.make_optimizer(cfg, 100_000).with_leaf_groups(leaf_groups(model))
    state = profile_train.opt_only(opt, init_fn())
    assert int(state.step) == 1
    _assert_trees(tensors_to_flax_tree(model, state.params), ref)


def test_vox_aug_stage_of_zero_range_is_the_jax_voxel_grid(stage_setup):
    import dataclasses

    from voxactb_tpu.agents.qfunction import normalize_rgb
    from voxactb_tpu.ops.voxelize import voxelize

    cfg, _, _, batch = stage_setup
    still = dataclasses.replace(cfg, aug_xyz=[0.0, 0.0, 0.0], aug_rpy=[0.0, 0.0, 0.0])
    grid = profile_train.vox_aug_only(still, CAMERAS, profile_train.to_device(
        batch, torch.device("cpu")), torch.Generator().manual_seed(2))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    coords = jnp.concatenate([jb[f"{c}_point_cloud"].reshape(2, -1, 3) for c in CAMERAS], 1)
    feats = jnp.concatenate([normalize_rgb(jb[f"{c}_rgb"]).reshape(2, -1, 3)
                             for c in CAMERAS], 1)
    ref = np.asarray(voxelize(coords, feats, jb["target_object_scene_bounds"], voxel_size=10))
    assert grid.shape == ref.shape
    np.testing.assert_allclose(grid.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_every_jax_train_stage_has_a_counterpart():
    src = open(os.path.join(ROOT, "tools", "profile_train.py")).read()
    rows = re.findall(r'\("(\w+)", \{', src)
    stages = re.findall(r'timed\("(\w+)"', src)
    assert [name for name, _ in profile_train.AB_ROWS] == rows
    assert set(stages) == {"vox_aug_only", "fwd_only", "grad_only", "opt_only"}
    assert all(hasattr(profile_train, s) for s in stages)


def test_train_rows_run_small(capsys):
    """The ``--flash-ab-only`` and ``--bwd-split`` rows on the tiny model, one
    step each: every row printed with its wall ms (no device time off the
    card)."""
    args = argparse.Namespace(batch=1, steps=1)
    dev = torch.device("cpu")
    rows = profile_train.full_rows(args, dev, profile_train.AB_ROWS[::3], base=TINY)
    assert list(rows) == ["full", "full_flashtrain"]
    assert all(r["per_step_ms"] > 0 and r["device_ms"] is None for r in rows.values())
    split = profile_train.bwd_split(args, dev, base=TINY)
    assert {f"bwd_depth{d}" for d in profile_train.BWD_DEPTHS} <= set(split)
    assert "bwd_attn_mlp_per_layer_ms" in split
    printed = capsys.readouterr().out
    assert '"stage": "full_flashtrain"' in printed and '"stage": "bwd_depth1"' in printed


SAM_TINY = dict(img_size=64, patch_size=8, embed_dim=32, depth=3, num_heads=2,
                window_size=3, global_attn_indexes=(1,), out_chans=16)


def test_truncated_sam_encoders_match_jax():
    """The ``--stage`` ladder's encoders (``profile_sam.ladder``) on the same
    flax parameters, nonzero rel-pos tables, at f32."""
    from voxactb_tpu.models.sam_encoder import SamImageEncoder as JaxEncoder
    from voxactb_tpu_torch.models.sam_encoder import SamImageEncoder
    from voxactb_tpu_torch.weights import load_flax_params

    x = np.random.default_rng(0).normal(size=(1, 64, 64, 3)).astype(np.float32)
    params = _np_tree(jax.jit(JaxEncoder(**SAM_TINY).init)(jax.random.key(0), jnp.asarray(x)))
    r = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (0.1 * r.normal(size=v.shape)).astype(np.float32)
        if "rel_pos" in jax.tree_util.keystr(p) else v, params)
    enc = SamImageEncoder(**SAM_TINY)
    load_flax_params(enc, params)
    ladder = profile_sam.ladder(SAM_TINY)
    assert [name for name, _, _ in ladder] == ["d0", "d1", "d2", "d3nn", "full"]
    for name, depth, skip in ladder:
        ref = np.asarray(JaxEncoder(**SAM_TINY, depth_limit=depth, skip_neck=skip).apply(
            params, jnp.asarray(x)))
        with torch.no_grad():
            got = profile_sam.truncated(enc, depth, skip)(torch.tensor(x)).numpy()
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(), rtol=0,
                                   err_msg=name)


def test_sam_rows_run_small():
    """The A/B, block and stage rows at a narrow spec: the JAX tool's keys."""
    spec = dict(img_size=64, embed_dim=32, depth=4, num_heads=2, global_attn_indexes=(1, 3))
    dev = torch.device("cpu")
    rec = profile_sam.run(argparse.Namespace(frames=1, skip_blocks=False, stage=False), dev,
                          spec, block_grid=4, window=2)
    want = {f"vit_h_ms_fused={n}" for n, _, _ in profile_sam.AB} | {
        f"block_{n}_ms" for n, _, _ in profile_sam.BLOCKS}
    assert want <= set(rec["all"]) and all(rec["all"][k] > 0 for k in want)
    table = profile_sam.run(argparse.Namespace(frames=1, skip_blocks=True, stage=True), dev,
                            spec, block_grid=4, window=2)["stage_table"]
    assert {"patch_embed_ms", "windowed_2_ms", "global_2_ms", "neck_ms", "full_ms",
            "ladder_sum_ms", "sol_full_ms_h100"} <= set(table)
    # the JAX tool's relay row has no counterpart, and says so
    src = open(os.path.join(ROOT, "tools", "profile_sam.py")).read()
    relay = set(re.findall(r'stages\["(\w+_relay)"\]', src))
    assert relay and relay <= set(profile_sam.NO_COUNTERPART) and not relay & set(table)
