"""The port's multi-process dry run and entry points (``parallel/dryrun.py``,
``graft_entry.py``) on the CPU: the tiny set-up's batch against the JAX dry
run's, two real worker processes against one process, a failing worker,
``entry()``'s act against ``make_infer_fn``'s, and the worker's options
against the JAX worker's."""

import pathlib
import re

import numpy as np
import pytest
import torch

from voxactb_tpu_torch import graft_entry
from voxactb_tpu_torch.agents.qfunction import make_infer_fn
from voxactb_tpu_torch.parallel import dryrun as D

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_tiny_setup_batch_is_the_jax_dry_runs():
    from voxactb_tpu.parallel.dryrun import tiny_train_setup as jax_setup

    jcfg, _, _, jbatch = jax_setup(batch_size=4)
    cfg, _, _, batch = D.tiny_train_setup(4)
    assert set(batch) == set(jbatch)
    for k, v in jbatch.items():
        assert batch[k].dtype == v.dtype, k
        np.testing.assert_array_equal(batch[k], v, err_msg=k)
    for key in ("voxel_sizes", "num_latents", "latent_dim", "transformer_depth",
                "cross_dim_head", "latent_dim_head", "final_dim", "which_arm",
                "arm_pred_loss", "apply_se3", "attn_dropout", "input_dropout"):
        assert getattr(cfg, key) == getattr(jcfg, key), key


def test_two_processes_take_the_one_process_step():
    """Two ``python -m voxactb_tpu_torch.parallel.dryrun`` ranks at a global
    batch of 2 (one row each), dropout and SE(3) augmentation on, against the
    same three steps on one process."""
    losses = D.spawn_two_process_dryrun(2, steps=3, timeout=120)
    assert all(np.isfinite(losses))
    _, init_fn, step, batch = D.tiny_train_setup(2)
    state, gen, want = init_fn(), torch.Generator().manual_seed(1), []
    for _ in range(3):
        state, metrics = step(state, batch, gen)
        want.append(float(metrics["total_loss"]))
    # the worker prints six decimals
    np.testing.assert_allclose(losses, want, rtol=1e-5, atol=1e-6)


def test_a_failing_worker_fails_the_spawn():
    with pytest.raises(RuntimeError, match="rc=1"):
        D.spawn_two_process_dryrun(2, steps=0, timeout=120)


def test_entry_acts_as_make_infer_fn():
    """``entry()`` on the CPU at reduced widths: its act program and example
    arguments give the outputs ``make_infer_fn`` gives on them."""
    small = dict(voxel_sizes=[10], num_latents=16, latent_dim=32, transformer_depth=1,
                 cross_dim_head=16, latent_dim_head=16, final_dim=8)
    infer, args = graft_entry.entry(device="cpu", img=16, **small)
    cfg = graft_entry.entry_config(**small)
    assert (cfg.pallas_front, cfg.pallas_attention, cfg.pallas_decoder) == (True, True, True)
    assert cfg.compute_dtype == "bfloat16" and cfg.crop_target_obj_voxel
    got = infer(*args)
    model, infer2 = make_infer_fn(cfg, device="cpu", seed=0)
    want = infer2(model, *args[1:])
    assert got.continuous_action.shape == (1, 9)
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.isfinite(got.q_trans).all()


def _options(path):
    return set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', path.read_text()))


def test_worker_options_are_the_jax_workers_or_have_no_counterpart():
    jax_opts = _options(ROOT / "voxactb_tpu" / "parallel" / "dryrun.py")
    ours = _options(ROOT / "voxactb_tpu_torch" / "parallel" / "dryrun.py")
    assert jax_opts
    assert jax_opts <= ours | set(D.NO_COUNTERPART), jax_opts - ours - set(D.NO_COUNTERPART)
    assert not set(D.NO_COUNTERPART) & ours
