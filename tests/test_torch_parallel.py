"""The train step split over ranks (``parallel/mesh.py``), on CPU gloo ranks
spawned per test module:

- the sharding rules against the JAX package's, leaf by leaf on the tiny and
  the 256-latent models (the port's decisions mapped back to the flax
  layout; ``to_kv`` is one leaf in flax and two tensors here);
- 2 and 4 ranks (dp, fsdp, tp; dp x fsdp, tp x sp) against the port's own
  step on one process at the global batch, three steps with dropout and
  SE(3) augmentation on; planted faults (LAMB's trust ratio from a rank's
  slices, gradients summed over the data ranks) must fail the same check;
- the port's 4-rank dp x fsdp run against ``make_parallel_train_step`` of the
  JAX package on the 8 virtual devices of ``conftest.py`` (dp 4 x fsdp 2),
  from the same parameters, dropout and augmentation off.

A rank's run is held to the one-process step by its losses (relative 1e-4),
``grad_norm`` (1e-4) and, per parameter, the L2 distance of its update from
the one-process update over that update's norm (1e-2: LAMB's first updates
are nearly the gradients' signs, so an element whose gradient is f32 noise
flips when sums are taken in another order; over three steps that moved a
parameter's update by 1e-5 to 3e-3 on these splits). The trans decoder's
bias has a gradient of 0 in exact arithmetic (a shift of every trans logit
leaves their softmax unchanged), so LAMB moves it by the sign of rounding
noise: it is held to the learning rate's step bound instead. Before the
steps, the ranks' optimizer applied once to seeded gradients must give the
one-process update within 5e-4 of each parameter's update: it is f32
element-wise arithmetic with the norms' sums reordered, and the parameter's
own f32 rounding moves an update of 1e-3 of it by up to 1e-4; a trust ratio
taken from a rank's slices moves a split parameter's by 5e-3 to 4e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.agents import qfunction as JQ
from voxactb_tpu.config import MethodConfig as JaxConfig
from voxactb_tpu.parallel import mesh as JM
from voxactb_tpu_torch.agents.qfunction import build_encoder
from voxactb_tpu_torch.parallel import dryrun as D
from voxactb_tpu_torch.parallel import mesh as M
from voxactb_tpu_torch.weights import flax_tree_to_tensors, tensors_to_flax_tree


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


BIG = dict(num_latents=256, latent_dim=256, cross_dim_head=32, latent_dim_head=32)
# the trunk at 256 wide on the tiny config's 16 latents: 13 parameters cross
# fsdp's 2^16 elements, at under half the 256-latent model's step time
MED = dict(latent_dim=256, cross_dim_head=32, latent_dim_head=32)
QUIET = dict(apply_se3=False, input_dropout=0.0, attn_dropout=0.0)
SPAWN_TIMEOUT = 120
LOSS_RTOL, NORM_RTOL, UPDATE_TOL, OPTIMIZER_TOL = 1e-4, 1e-4, 1e-2, 5e-4
NOISE_LEAVES = ("trans_decoder.bias",)
LR = D.tiny_config().lr


# -- the rules ------------------------------------------------------------------------


TINY = dict(voxel_sizes=[10], num_latents=16, latent_dim=32, transformer_depth=1,
            cross_dim_head=16, latent_dim_head=16, final_dim=8, which_arm="dominant",
            arm_pred_loss=True)  # parallel/dryrun.py:29's config of both packages


def _jax_shapes(cfg_kw):
    jcfg = JaxConfig(**{**TINY, **cfg_kw})
    model = JQ.build_encoder(jcfg)
    b = 2
    args = (jnp.zeros((b, 10, 10, 10, 10)), jnp.zeros((b, jcfg.low_dim_size())),
            jnp.zeros((b, 1024)), jnp.zeros((b, 77, 512)))
    return jax.eval_shape(lambda: model.init(jax.random.key(0), *args))


def _jax_specs(tree, shardings):
    """flax path (without the ``params`` root) -> spec tuple, trailing Nones cut."""
    out = {}
    for (path, _), sh in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                             jax.tree_util.tree_leaves(shardings)):
        key = "/".join(str(getattr(p, "key", p)) for p in path[1:])
        spec = list(sh.spec)
        while spec and spec[-1] is None:
            spec.pop()
        out[key] = tuple(spec)
    return out


def _port_specs(model, shards):
    """The port's decisions in the flax layout: flax path -> spec tuple."""
    out = {}
    for leaf in M.flax_leaves(model):
        specs = set()
        for name, perm in leaf.params:
            s = shards[name]
            spec = [None] * len(leaf.shape)
            if s is not None:
                spec[perm[s.dim]] = s.axis
            while spec and spec[-1] is None:
                spec.pop()
            specs.add(tuple(spec))
        assert len(specs) == 1, (leaf.path, specs)  # to_kv's halves agree
        out[leaf.path] = specs.pop()
    return out


class _FakeMesh:
    """Enough of a DeviceMesh for the rules: axis names and sizes."""

    def __init__(self, sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = list(sizes.values())

    def size(self, i):
        return self._sizes[i]


@pytest.mark.parametrize("width", ["tiny", "big"])
@pytest.mark.parametrize("sizes", [{"dp": 2, "fsdp": 4}, {"dp": 2, "tp": 2, "sp": 2},
                                   {"tp": 4, "fsdp": 2}])
def test_specs_match_the_jax_rules(width, sizes):
    cfg_kw = BIG if width == "big" else {}
    tree = _jax_shapes(cfg_kw)
    jmesh = JM.make_mesh(sizes, jax.devices()[:int(np.prod(list(sizes.values())))])
    model = build_encoder(D.tiny_config(**cfg_kw), device="cpu")
    fake = _FakeMesh(sizes)
    if "tp" in sizes:
        want = _jax_specs(tree, JM.shard_params_model_parallel(jmesh, tree))
        got = _port_specs(model, M.shard_params_model_parallel(fake, model))
    else:
        want = _jax_specs(tree, JM.shard_params_fsdp(jmesh, tree))
        got = _port_specs(model, M.shard_params_fsdp(fake, model))
    assert got == want
    if width == "big" and "fsdp" in sizes and "tp" not in sizes:
        assert any(s for s in got.values())  # some leaves really shard


def test_to_kv_departs_by_heads():
    """The JAX rule column-shards the fused ``to_kv`` leaf: at tp 2 its rank 0
    holds K, its rank 1 V. The port splits ``to_k`` and ``to_v`` each along
    their output rows (heads), so a rank holds the K and V of its own heads."""
    model = build_encoder(D.tiny_config(), device="cpu")
    shards = M.shard_params_model_parallel(_FakeMesh({"tp": 2}), model)
    leaf = next(l for l in M.flax_leaves(model) if l.path == "self_attn_0/attn/to_kv/kernel")
    inner = leaf.shape[1] // 2
    assert M.tp_param_spec(leaf.path, leaf.shape, 2) == (None, "tp")
    assert tuple(JM.tp_param_spec(leaf.path, leaf.shape, 2)) == (None, "tp")
    # JAX's rank 0 holds columns 0 .. inner of [K | V]: all of K, no V
    assert leaf.shape[1] // 2 == inner == model.self_attn_0.attn.to_k.weight.shape[0]
    for half in ("to_k", "to_v"):
        assert shards[f"self_attn_0.attn.{half}.weight"] == M.Shard(0, "tp")


def test_make_mesh_refuses_a_wrong_product():
    with pytest.raises(ValueError, match="ranks"):
        M.make_mesh({"dp": 3})
    with pytest.raises(ValueError, match="ranks"):
        M.make_mesh({"dp": 2, "tp": 2})


# -- ranks against one process ----------------------------------------------------------


def _update_errors(ref, got, init):
    """Per parameter: ||got - ref|| / ||ref - init|| of the parameters after
    the run (the update's L2 distance over its norm)."""
    out = {}
    for k, r in ref["params"].items():
        n = float((r - init[k]).norm())
        if n > 0 and k not in NOISE_LEAVES:
            out[k] = float((got["params"][k] - r).norm()) / n
    return out


def _misses(ref, got, init, steps):
    """What in ``got`` lies beyond the one-process run's tolerance."""
    bad = []
    for i, (a, b) in enumerate(zip(ref["metrics"], got["metrics"])):
        for k, v in a.items():
            tol = NORM_RTOL if k == "grad_norm" else LOSS_RTOL
            if abs(b[k] - v) > tol * abs(v):
                bad.append(f"step {i} {k}: {b[k]} vs {v}")
    errs = _update_errors(ref, got, init)
    bad += [f"{k}: update err {e:.3g}" for k, e in errs.items() if e > UPDATE_TOL]
    for k in NOISE_LEAVES:
        step = float((got["params"][k] - ref["params"][k]).abs().max())
        if step > 2 * LR * steps:
            bad.append(f"{k}: {step}")
    if got["update_params"] is not None:
        errs = _update_errors(dict(params=ref["update_params"]),
                              dict(params=got["update_params"]), init)
        bad += [f"{k}: optimizer err {e:.3g}" for k, e in errs.items() if e > OPTIMIZER_TOL]
    return bad


def _init_params(spec):
    init_fn, _, _ = D._build(spec, "cpu")
    return {k: v.detach() for k, v in init_fn().params.items()}


CHECK = dict(batch_size=4, update_check=True)
RANKS2 = [D.job("dp2", {"dp": 2}, **CHECK),
          D.job("fsdp2", {"fsdp": 2}, fsdp=True, cfg=MED, **CHECK),
          D.job("tp2", {"tp": 2}, model_parallel=True, **CHECK),
          D.job("dp2_summed_grads", {"dp": 2}, fault="summed_grads", **CHECK),
          D.job("fsdp2_local_trust_ratio", {"fsdp": 2}, fsdp=True, cfg=MED,
                fault="local_trust_ratio", **CHECK),
          D.job("tp2_local_trust_ratio", {"tp": 2}, model_parallel=True,
                fault="local_trust_ratio", **CHECK)]
RANKS4 = [D.job("dp2_fsdp2", {"dp": 2, "fsdp": 2}, fsdp=True, cfg=MED, **CHECK),
          D.job("tp2_sp2", {"tp": 2, "sp": 2}, model_parallel=True, **CHECK)]


@pytest.fixture(scope="module")
def references():
    """One-process runs, one per distinct config."""
    out = {}
    for spec in RANKS2 + RANKS4:
        key = repr(sorted(spec["cfg"].items()))
        if key not in out:
            out[key] = (D.run_job(spec), _init_params(spec))
    return out


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    res = D.spawn_jobs(2, RANKS2, workdir=str(tmp_path_factory.mktemp("ranks2")),
                       timeout=SPAWN_TIMEOUT)
    return {r["name"]: r for r in res}


def _held(references, spec, got):
    ref, init = references[repr(sorted(spec["cfg"].items()))]
    return _misses(ref, got, init, spec["steps"])


@pytest.mark.parametrize("spec", [s for s in RANKS2 if not s["fault"]], ids=lambda s: s["name"])
def test_two_ranks_take_the_one_process_step(references, ranks2, spec):
    got = ranks2[spec["name"]]
    assert not _held(references, spec, got)
    assert all(np.isfinite(m["total_loss"]) for m in got["metrics"])
    if spec["fsdp"]:
        # parameters and both moments: each rank holds half of a split one
        assert got["n_sharded"] > 0
        for name, (held, whole) in got["sharded_bytes"].items():
            assert held * 2 == whole, name
    if spec["model_parallel"]:
        compute = [n for n, p in got["plans"].items() if p and p["compute"]]
        # every latent attention and GEGLU of the trunk runs on its own heads
        assert "self_attn_0.attn.to_q.weight" in compute
        assert "self_ff_0.w_in.weight" in compute
        # the cross attention's single head is not split: its weights are stored split
        assert not got["plans"]["cross_attend.attn.to_q.weight"]["compute"]


@pytest.mark.parametrize("spec", [s for s in RANKS2 if s["fault"]], ids=lambda s: s["name"])
def test_planted_faults_fail_the_check(references, ranks2, spec):
    bad = _held(references, spec, ranks2[spec["name"]])
    assert bad
    if spec["fault"] == "local_trust_ratio":  # seen by the optimizer check alone
        assert any("optimizer err" in b for b in bad), bad


@pytest.fixture(scope="module")
def jax_parity(tmp_path_factory):
    """The JAX package's dp 4 x fsdp 2 mesh: its initial parameters (saved for
    the port), losses and parameters over three steps."""
    tmp = tmp_path_factory.mktemp("jax_parity")
    jcfg = JaxConfig(**TINY, **QUIET)
    _, init_fn, train_step = JQ.make_train_step(jcfg, JQ.make_optimizer(jcfg, 100), D.CAMERAS)
    batch = D.tiny_batch(D.tiny_config(**QUIET), 8)
    mesh = JM.make_mesh({"dp": 4, "fsdp": 2})
    with mesh:
        # the init under jax.jit: op by op, each primitive compiles alone
        state, place, step = JM.make_parallel_train_step(mesh, jax.jit(init_fn), train_step,
                                                         batch, jax.random.key(0), fsdp=True)
        init_tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                           jax.device_get(state.params))
        db = place(batch)
        step = step.lower(state, db, jax.random.key(1)).compile()  # compiled once
        losses = []
        for i in range(3):
            state, metrics = step(state, db, jax.random.key(1 + i))
            losses.append({k: float(np.asarray(v)) for k, v in metrics.items()})
        final = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       jax.device_get(state.params))
    model = build_encoder(D.tiny_config(**QUIET), device="cpu")
    path = str(tmp / "init.pt")
    torch.save(flax_tree_to_tensors(model, init_tree), path)
    return dict(init=path, metrics=losses, final=final, init_tree=init_tree, model=model)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory, jax_parity):
    jobs = RANKS4 + [D.job("jax_parity", {"dp": 2, "fsdp": 2}, fsdp=True, batch_size=8,
                           cfg=QUIET, init=jax_parity["init"])]
    res = D.spawn_jobs(4, jobs, workdir=str(tmp_path_factory.mktemp("ranks4")),
                       timeout=SPAWN_TIMEOUT)
    return {r["name"]: r for r in res}


@pytest.mark.parametrize("spec", RANKS4, ids=lambda s: s["name"])
def test_four_ranks_take_the_one_process_step(references, ranks4, spec):
    got = ranks4[spec["name"]]
    assert not _held(references, spec, got)
    if spec["name"] == "tp2_sp2":
        assert got["plans"]["latents"] == dict(dim=0, axis="sp", compute=False)
    # every rank ran its share: K4's plain version has no counter, the ranks' steps do
    assert len(got["launches"]) == 4


def test_four_ranks_match_the_jax_mesh(jax_parity, ranks4):
    """The port's 4-rank dp 2 x fsdp 2 run and the JAX package's dp 4 x fsdp 2
    mesh at the global batch 8, from the JAX mesh's initial parameters:
    losses to 1e-4 and ``grad_norm`` to 1e-3 at every step
    (tests/test_torch_train_step.py's tolerances), and the parameters after
    three steps per leaf by the update rule above."""
    got = ranks4["jax_parity"]
    for i, (mine, theirs) in enumerate(zip(got["metrics"], jax_parity["metrics"])):
        assert set(mine) == set(theirs)
        for k, v in theirs.items():
            rtol = 1e-3 if k == "grad_norm" else 1e-4
            np.testing.assert_allclose(mine[k], v, rtol=rtol, err_msg=f"step {i} {k}")
    model = jax_parity["model"]
    final = flax_tree_to_tensors(model, jax_parity["final"])
    init = flax_tree_to_tensors(model, jax_parity["init_tree"])
    ref = dict(params=final)
    errs = _update_errors(ref, got, init)
    assert max(errs.values()) < UPDATE_TOL, max(errs.items(), key=lambda kv: kv[1])
    assert tensors_to_flax_tree(model, got["params"])  # the port's tree maps back whole
