"""The baseline zoo in the port against the JAX package, on the CPU at small
widths: ``CnnLangPolicy``, ``ViTLangPolicy`` and ``LingUNetQNet`` on flax
parameters carried over by ``weights.baseline_state_dict_from_flax`` (outputs
and the MSE loss's gradients within 1e-5 of the largest value, f32), flax's
asymmetric ``"SAME"`` pads (symmetric padding must fail), the nearest x2
upsample, the 50^3 LingUNet failure of both packages, and ``BCLangAgent``:
one Adam step from the same parameters, ``act``, and its ``{name}.msgpack``
read by the other package bit for bit in both directions."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import serialization

from voxactb_tpu_torch.models import baselines as TB
from voxactb_tpu_torch.weights import (
    baseline_flax_tree, baseline_state_dict_from_flax, load_flax_params)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = 1e-5  # of the largest |value| of the compared output or gradient tree
CAMERAS = ["wrist", "wrist2"]
VIT_KW = dict(patch=8, dim=32, depth=2, heads=2)
CNN_KW = dict(filters=(8, 16, 16), fc_layers=(32, 16))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cams(rng, b=2, img=16):
    rgbs = [rng.uniform(-1, 1, (b, img, img, 3)).astype(np.float32) for _ in CAMERAS]
    pcds = [rng.uniform(-1, 1, (b, img, img, 3)).astype(np.float32) for _ in CAMERAS]
    return rgbs, pcds


def _policy_inputs(rng, b=2, img=16):
    rgbs, pcds = _cams(rng, b, img)
    return (rgbs, pcds, rng.normal(size=(b, 4)).astype(np.float32),
            rng.normal(size=(b, 1024)).astype(np.float32))


def _t(x):
    if isinstance(x, (list, tuple)):
        return [torch.from_numpy(a) for a in x]
    return torch.from_numpy(x)


def _j(x):
    if isinstance(x, (list, tuple)):
        return [jnp.asarray(a) for a in x]
    return jnp.asarray(x)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = TOL * max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: {err} > {tol}"


def _jax_policy(network):
    from voxactb_tpu.models.baselines import CnnLangPolicy, ViTLangPolicy

    return CnnLangPolicy(**CNN_KW) if network == "cnn" else ViTLangPolicy(**VIT_KW)


def _port_policy(network, inputs, params):
    kw = CNN_KW if network == "cnn" else VIT_KW
    model = TB.build_policy(network, *[_t(x) for x in inputs],
                            generator=torch.Generator().manual_seed(0), **kw)
    model.load_state_dict(baseline_state_dict_from_flax(model, _np_tree(params)))
    return model


def _jax_value_and_grad(jm, params, inputs, target):
    """The flax module's outputs, MSE loss and its gradients in one jitted
    program (op by op each primitive compiles alone)."""
    def loss(p):
        out = jm.apply(p, *[_j(x) for x in inputs])
        if isinstance(out, dict):
            return sum(jnp.mean((out[k] - target[k]) ** 2) for k in sorted(out)), out
        return jnp.mean((out - target) ** 2), out

    (value, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return float(value), _np_tree(out), _np_tree(grads)


def _model_run(name):
    """One JAX run per model: parameters from ``jax.random.key(0)``, the
    inputs, the outputs and the MSE loss's gradients."""
    rng = np.random.default_rng(len(name) + (name == "cnn15"))
    if name == "lingunet":
        from voxactb_tpu.models.baselines import LingUNetQNet

        inputs = (rng.normal(size=(1, 8, 8, 8, 10)).astype(np.float32),
                  rng.normal(size=(1, 4)).astype(np.float32),
                  rng.normal(size=(1, 1024)).astype(np.float32))
        jm = LingUNetQNet(base_channels=4, levels=2)
        target = {"trans": rng.normal(size=(1, 8, 8, 8, 1)).astype(np.float32),
                  "rot_grip": rng.normal(size=(1, 218)).astype(np.float32),
                  "collision": rng.normal(size=(1, 2)).astype(np.float32)}
    else:
        inputs = _policy_inputs(rng, 2, 15 if name == "cnn15" else 16)
        jm = _jax_policy(name[:3])
        target = rng.normal(size=(2, 8)).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.key(0), *[_j(x) for x in inputs])
    loss, out, grads = _jax_value_and_grad(jm, params, inputs, target)
    return dict(params=_np_tree(params), inputs=inputs, target=target, loss=loss,
                out=out, grads=grads)


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _model_run(name)
        return cache[name]
    return get


def _port_model(name, run):
    if name == "lingunet":
        model = TB.LingUNetQNet(10, 4, 1024, base_channels=4, levels=2)
    else:
        model = _port_policy(name[:3], run["inputs"], run["params"])
    model.load_state_dict(baseline_state_dict_from_flax(model, run["params"]))
    return model


# -- flax's "SAME" pads ----------------------------------------------------------


@pytest.mark.parametrize("size,kernel,stride", [(128, 3, 2), (127, 3, 2), (16, 3, 2),
                                                (15, 3, 2), (8, 3, 1), (9, 4, 3)])
def test_same_pads_match_lax(size, kernel, stride):
    (want,) = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert TB.flax_same_pads(size, kernel, stride) == tuple(want)


@pytest.mark.parametrize("name", ["cnn", "cnn15"])
def test_cnn_matches_jax_and_symmetric_padding_fails(name, runs, monkeypatch):
    """At an even (16) and an odd (15) camera size; the odd one pads its
    first conv symmetrically (1, 1), its later ones not, so both must fail
    with torch's symmetric ``padding=1``."""
    run = runs(name)
    model = _port_model(name, run)
    got = model(*[_t(x) for x in run["inputs"]]).detach().numpy()
    _close(got, run["out"], name)
    np.testing.assert_allclose(np.linalg.norm(got[:, 3:7], axis=-1), 1.0, atol=1e-5)

    monkeypatch.setattr(TB, "pad_same_nhwc",
                        lambda x, k, s: F.pad(x, (0, 0, 1, 1, 1, 1)))
    bad = model(*[_t(x) for x in run["inputs"]]).detach().numpy()
    assert np.abs(bad - run["out"]).max() > 100 * TOL * np.abs(run["out"]).max()


def test_vit_matches_jax(runs):
    run = runs("vit")
    model = _port_model("vit", run)
    assert model.pos.shape == (1, 1 + 2 * 2 * 2, 32)  # lang + 2 x (2 x 4) patches
    _close(model(*[_t(x) for x in run["inputs"]]).detach().numpy(), run["out"], "vit")


def test_vit_pos_is_sized_by_the_token_count(runs, rng):
    """A tree whose ``pos`` was sized for another camera size does not load."""
    other = TB.build_policy("vit", *[_t(x) for x in _policy_inputs(rng, 2, 24)],
                            **VIT_KW)
    with pytest.raises(ValueError, match="pos"):
        baseline_state_dict_from_flax(other, runs("vit")["params"])


def test_lingunet_matches_jax(runs):
    run = runs("lingunet")
    got = _port_model("lingunet", run)(*[_t(x) for x in run["inputs"]])
    assert set(got) == set(run["out"]) == {"trans", "rot_grip", "collision"}
    assert got["rot_grip"].shape == (1, 72 * 3 + 2) and got["collision"].shape == (1, 2)
    for k, want in run["out"].items():
        _close(got[k].detach().numpy(), want, f"lingunet {k}")


def test_nearest_upsample_matches_jax_resize(rng):
    x = rng.normal(size=(2, 3, 4, 5, 6)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 6, 8, 10, 6), "nearest")
    np.testing.assert_array_equal(TB.upsample_nearest2(_t(x)).numpy(), np.asarray(want))


def test_lingunet_at_50_fails_in_both_packages(rng):
    """The reference fact: at 50^3 and 2 levels the 24^3 upsample meets the
    25^3 skip, and the concat fails in both packages."""
    from voxactb_tpu.models.baselines import LingUNetQNet

    vox = rng.normal(size=(1, 50, 50, 50, 10)).astype(np.float32)
    proprio, lang = np.zeros((1, 4), np.float32), np.zeros((1, 1024), np.float32)
    with pytest.raises((TypeError, ValueError)):
        jax.eval_shape(LingUNetQNet(base_channels=2, levels=2).init,
                       jax.random.key(0), _j(vox), _j(proprio), _j(lang))
    model = TB.LingUNetQNet(10, 4, 1024, base_channels=2, levels=2)
    with pytest.raises(RuntimeError, match="[Ss]izes"):
        model(_t(vox), _t(proprio), _t(lang))


@pytest.mark.parametrize("name", ["cnn", "vit", "lingunet"])
def test_mse_gradients_match_jax(name, runs):
    run = runs(name)
    model = _port_model(name, run)
    out = model(*[_t(x) for x in run["inputs"]])
    if isinstance(out, dict):
        loss = sum(torch.mean((out[k] - _t(run["target"][k])) ** 2) for k in sorted(out))
    else:
        loss = torch.mean((out - _t(run["target"])) ** 2)
    loss.backward()
    _close(loss.item(), run["loss"], f"{name} loss")
    got = baseline_flax_tree(model, {k: p.grad for k, p in model.named_parameters()})
    want, got = _leaves(run["grads"]), _leaves(got)
    largest = max(np.abs(v).max() for v in want.values())
    assert set(want) == set(got)
    for k, w in want.items():
        err = np.abs(np.asarray(got[k], np.float64) - w).max()
        assert err <= TOL * largest, (name, k, err, largest)


# -- the agent ------------------------------------------------------------------------


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _batch(rng, b=2, img=16):
    batch = {
        "low_dim_state": rng.normal(size=(b, 4)).astype(np.float32),
        "lang_goal_emb": rng.normal(size=(b, 1024)).astype(np.float32),
        "gripper_pose": rng.normal(size=(b, 7)).astype(np.float32),
        "rot_grip_action_indicies": rng.integers(0, 72, (b, 4)).astype(np.int32),
    }
    for c in CAMERAS:
        batch[f"{c}_rgb"] = rng.integers(0, 255, (b, img, img, 3)).astype(np.float32)
        batch[f"{c}_point_cloud"] = rng.normal(size=(b, img, img, 3)).astype(np.float32)
    return batch


def _obs(batch):
    return {k: v[:1] for k, v in batch.items()}


def _agent_run(network, runs, root):
    """One JAX ``BCLangAgent`` per network: its first-update state from the
    model run's parameters (``net.init(jax.random.key(0), ...)`` as its
    ``update`` makes it, on inputs of these shapes), one update, its
    checkpoint and an act."""
    from voxactb_tpu.agents.baseline_agents import BCLangAgent as JaxAgent
    from voxactb_tpu.agents.qfunction import TrainState

    agent = JaxAgent(CAMERAS, network=network, **(CNN_KW if network == "cnn" else VIT_KW))
    agent.build(training=True)
    p0 = runs(network)["params"]
    agent._state = TrainState(jnp.zeros((), jnp.int32), p0, agent._optimizer.init(p0))
    batch = _batch(np.random.default_rng(7))
    loss = float(np.asarray(agent.update(0, batch)["total_loss"]))
    ckpt = os.path.join(root, network, "jax")
    agent.save_weights(ckpt)
    return dict(agent=agent, batch=batch, p0=p0, loss=loss, ckpt=ckpt,
                after=_leaves(_np_tree(agent._params)),
                act=np.asarray(agent.act(0, _obs(batch), which_arm=None).action))


@pytest.fixture(scope="module")
def agent_runs(runs, tmp_path_factory):
    cache, root = {}, str(tmp_path_factory.mktemp("bc_lang"))

    def get(network):
        if network not in cache:
            cache[network] = _agent_run(network, runs, root)
        return cache[network]
    return get


def _port_agent(network):
    from voxactb_tpu_torch.agents.baseline_agents import BCLangAgent

    agent = BCLangAgent(CAMERAS, network=network, device="cpu",
                        **(CNN_KW if network == "cnn" else VIT_KW))
    agent.build(training=True)
    return agent


@pytest.mark.parametrize("network", ["cnn", "vit"])
def test_agent_update_matches_jax(network, agent_runs, tmp_path):
    """One Adam step of ``update`` from the JAX agent's own initial
    parameters, handed to the port as a checkpoint: the same loss, and each
    weight's update within 1% of the learning rate (Adam's first step moves
    a weight by about lr, its sign set by its gradient's) wherever the
    gradient is clear of the gradients' tolerance of 0."""
    run = agent_runs(network)
    port = _port_agent(network)
    os.makedirs(tmp_path / "init")
    with open(tmp_path / "init" / "BCLangAgent.msgpack", "wb") as f:
        f.write(serialization.msgpack_serialize(run["p0"]))
    port.load_weights(str(tmp_path / "init"))
    got = float(port.update(0, run["batch"])["total_loss"])
    assert abs(got - run["loss"]) <= TOL * abs(run["loss"])

    # the step's gradients, from the port at the same parameters
    ref = _port_agent(network)
    ref.load_weights(str(tmp_path / "init"))
    ref.act(0, _obs(run["batch"]))  # builds the net from the tree
    rgbs, pcds = ref._inputs(run["batch"])
    t = {k: torch.from_numpy(np.asarray(run["batch"][k], np.float32))
         for k in ("low_dim_state", "lang_goal_emb", "gripper_pose",
                   "rot_grip_action_indicies")}
    target = torch.cat([t["gripper_pose"], t["rot_grip_action_indicies"][:, 3:4]], -1)
    torch.mean((ref.network(rgbs, pcds, t["low_dim_state"], t["lang_goal_emb"])
                - target) ** 2).backward()
    grads = _leaves(baseline_flax_tree(
        ref.network, {k: p.grad for k, p in ref.network.named_parameters()}))
    largest = max(np.abs(g).max() for g in grads.values())

    before, after = _leaves(run["p0"]), run["after"]
    mine = _leaves(baseline_flax_tree(port.network))
    assert set(mine) == set(after) == set(grads)
    lr = 1e-3
    for k in after:
        d_mine, d_jax = mine[k] - before[k], after[k] - before[k]
        # where a gradient is within the gradients' tolerance of 0 (the key
        # biases', which the softmax cancels exactly), Adam's sign is noise:
        # there only its step bound holds
        sure = np.abs(grads[k]) > 4 * TOL * largest
        np.testing.assert_allclose(d_mine[sure], d_jax[sure], rtol=0, atol=1e-2 * lr,
                                   err_msg=k)
        ulps = 4 * np.finfo(np.float32).eps * np.abs(before[k]).max()  # p1 - p0 rounds
        assert np.abs(d_mine).max() <= lr * (1 + 1e-5) + ulps, k
    assert port.update_summaries()[0].name == "BCLangAgent/losses/mse"


def test_agent_loss_falls_and_acts(rng):
    from voxactb_tpu_torch.agents.baseline_agents import BCLangAgent

    agent = BCLangAgent(CAMERAS, network="cnn", device="cpu", **CNN_KW)
    batch = _batch(rng)
    losses = [float(agent.update(i, batch)["total_loss"]) for i in range(5)]
    assert losses[-1] < losses[0]
    action = np.asarray(agent.act(0, _obs(batch), which_arm=None).action)
    assert action.shape == (9,) and action[8] == 1.0
    assert abs(np.linalg.norm(action[3:7]) - 1.0) < 1e-5


@pytest.mark.parametrize("network", ["cnn", "vit"])
def test_jax_checkpoint_read_by_port_bit_equal(network, agent_runs, tmp_path):
    """A JAX-written ``BCLangAgent.msgpack``: the port's parameters equal it
    bit for bit, its act agrees with the JAX act, and the file it writes back
    has the JAX file's bytes."""
    run = agent_runs(network)
    port = _port_agent(network)
    port.load_weights(run["ckpt"])
    got = np.asarray(port.act(0, _obs(run["batch"]), which_arm=None).action)
    _close(got, run["act"], f"{network} act")
    mine = _leaves(baseline_flax_tree(port.network))
    assert set(mine) == set(run["after"])
    for k, want in run["after"].items():
        np.testing.assert_array_equal(mine[k], want, err_msg=k)
    port.save_weights(str(tmp_path / "port"))
    assert ((tmp_path / "port" / "BCLangAgent.msgpack").read_bytes()
            == open(os.path.join(run["ckpt"], "BCLangAgent.msgpack"), "rb").read())


def test_load_after_training_replaces_the_weights(rng, tmp_path):
    """A departure from the JAX agent (whose next update goes on from its
    earlier state): a load after training replaces the weights the next
    update starts from; a tree for another camera count does not load."""
    from voxactb_tpu_torch.agents.baseline_agents import BCLangAgent

    agent = BCLangAgent(CAMERAS, network="cnn", device="cpu", **CNN_KW)
    batch = _batch(rng)
    agent.update(0, batch)
    agent.save_weights(str(tmp_path / "a"))
    saved = _leaves(baseline_flax_tree(agent.network))
    agent.update(1, batch)
    agent.load_weights(str(tmp_path / "a"))
    now = _leaves(baseline_flax_tree(agent.network))
    for k in saved:
        np.testing.assert_array_equal(now[k], saved[k], err_msg=k)
    other = BCLangAgent(["wrist"], network="cnn", device="cpu", **CNN_KW)
    other.act(0, {k: v[:1] for k, v in batch.items() if not k.startswith("wrist2")})
    with pytest.raises(ValueError, match="does not match"):
        other.load_weights(str(tmp_path / "a"))


@pytest.mark.parametrize("network", ["cnn", "vit"])
def test_port_checkpoint_read_by_jax_bit_equal(network, agent_runs, tmp_path):
    """The port's ``BCLangAgent.msgpack`` (its own weights after a port
    update): the JAX agent loads it, acts alike, and writes the same bytes
    back. Last in the file: it loads new weights into the JAX agent of
    ``agent_runs``."""
    run = agent_runs(network)
    port = _port_agent(network)
    port.update(0, run["batch"])
    port.save_weights(str(tmp_path / "port"))
    run["agent"].load_weights(str(tmp_path / "port"))
    obs = _obs(run["batch"])
    _close(np.asarray(port.act(0, obs).action),
           np.asarray(run["agent"].act(0, obs).action), f"{network} act")
    run["agent"].save_weights(str(tmp_path / "jax"))
    assert ((tmp_path / "jax" / "BCLangAgent.msgpack").read_bytes()
            == (tmp_path / "port" / "BCLangAgent.msgpack").read_bytes())
