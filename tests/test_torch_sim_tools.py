"""The port's sim validator and data tools (voxactb_tpu_torch/sim/validator.py,
sim/pyrep_backend.py, envs/gym_adapter.py and tools/task_builder.py,
dataset_generator.py, make_synthetic_dataset.py) against the JAX package's:
equal validator reports, the same task template, byte-equal dataset files at
the same seed, datasets that each package's loader reads from the other, the
PyRep gate and the gym adapter. Every check here is exact."""

import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from voxactb_tpu_torch.tools import dataset_generator, make_synthetic_dataset, task_builder

ROOT = os.path.join(os.path.dirname(__file__), "..")
PROTOCOL_TASKS = ["open_jar", "open_drawer", "put_item_in_drawer", "hand_over_item"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_tool(name):
    """``tools/<name>.py`` as the module ``jax_<name>``, registered so that
    pickle finds the classes it defines."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same_value(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert type(a) is type(b) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same_value(a[k], b[k], f"{where}.{k}")
    else:
        assert type(a) is type(b) and a == b, where


def _assert_same_attributes(a, b, where):
    assert vars(a).keys() == vars(b).keys(), where
    for k in vars(a):
        _assert_same_value(getattr(a, k), getattr(b, k), f"{where}.{k}")


# -- the validator ---------------------------------------------------------------------


@pytest.mark.parametrize("task", PROTOCOL_TASKS)
def test_task_smoke_reports_equal_the_jax_validator(task):
    from voxactb_tpu.sim.tasks import TASK_REGISTRY as JAX_REGISTRY
    from voxactb_tpu.sim.validator import task_smoke as jax_task_smoke
    from voxactb_tpu_torch.sim.tasks import TASK_REGISTRY
    from voxactb_tpu_torch.sim.validator import task_smoke

    kw = dict(demos_per_variation=2, image_size=8, cameras=("wrist",), episode_length=25)
    report = task_smoke(TASK_REGISTRY[task], **kw)
    assert report == jax_task_smoke(JAX_REGISTRY[task], **kw)
    assert report["successes"] == 2 * TASK_REGISTRY[task].num_variations


def test_validate_all_reports_equal_the_jax_validator(monkeypatch):
    """``validate_all`` over a registry of every tenth task (both packages'
    registries hold the same names), which ``validate_all`` reads when it is
    called."""
    import voxactb_tpu.sim.tasks as jax_tasks
    import voxactb_tpu_torch.sim.tasks as tasks
    from voxactb_tpu.sim.validator import validate_all as jax_validate_all
    from voxactb_tpu_torch.sim.validator import TaskValidationError, validate_all

    names = sorted(tasks.TASK_REGISTRY)[::10]
    assert sorted(jax_tasks.TASK_REGISTRY) == sorted(tasks.TASK_REGISTRY)
    monkeypatch.setattr(tasks, "TASK_REGISTRY", {n: tasks.TASK_REGISTRY[n] for n in names})
    monkeypatch.setattr(jax_tasks, "TASK_REGISTRY",
                        {n: jax_tasks.TASK_REGISTRY[n] for n in names})
    reports = validate_all(image_size=8, cameras=("wrist",))
    assert reports == jax_validate_all(image_size=8, cameras=("wrist",))
    assert [r["task"] for r in reports] == names
    assert all(r["successes"] == r["variations"] for r in reports)
    assert issubclass(TaskValidationError, AssertionError)


# -- task_builder ----------------------------------------------------------------------


def test_task_builder_new_writes_the_jax_template(tmp_path, monkeypatch):
    """The port's template is the JAX tool's text with the package renamed,
    and the task it scaffolds passes the port's validator."""
    jax_builder = _jax_tool("task_builder")
    monkeypatch.setattr("sys.argv", ["task_builder.py", "new", "--name", "stack_cups",
                                     "--out", str(tmp_path / "jax")])
    jax_builder.main()
    task_builder.main(["new", "--name", "stack_cups", "--out", str(tmp_path / "port")])
    jax_text = (tmp_path / "jax" / "stack_cups.py").read_text()
    port_text = (tmp_path / "port" / "stack_cups.py").read_text()
    assert "voxactb_tpu_torch" not in jax_text
    assert port_text == jax_text.replace("voxactb_tpu.", "voxactb_tpu_torch.")
    assert port_text == task_builder.TEMPLATE.format(
        name="stack_cups", cls="StackCups", desc="stack cups")
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == [
        "__init__.py", "stack_cups.py"]
    with pytest.raises(SystemExit, match="exists"):
        task_builder.main(["new", "--name", "stack_cups", "--out", str(tmp_path / "port")])

    reports = task_builder.main(["validate", "--file", str(tmp_path / "port" / "stack_cups.py"),
                                 "--image-size", "8"])
    assert reports == [{"task": "stack_cups", "variations": 2, "successes": 2}]
    assert task_builder.main(["validate", "--task", "open_jar", "--image-size", "8"]) == [
        {"task": "open_jar", "variations": 2, "successes": 2}]


# -- the data tools --------------------------------------------------------------------


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """Two open_jar episodes (both variations) from each package's
    dataset_generator at seed 0, 16^2."""
    root = tmp_path_factory.mktemp("generated")
    jax_gen = _jax_tool("dataset_generator")
    assert jax_gen.generate(str(root / "jax"), ["open_jar"], episodes=2, image_size=16,
                            seed=0) == 2
    assert dataset_generator.generate(str(root / "port"), ["open_jar"], episodes=2,
                                      image_size=16, seed=0) == 2
    return root


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    jax_syn = _jax_tool("make_synthetic_dataset")
    jax_syn.write_dataset(str(root / "jax"), "open_jar", 2, 12, 16, seed=3)
    make_synthetic_dataset.write_dataset(str(root / "port"), "open_jar", 2, 12, 16, seed=3)
    return root


def _pickle_objects(path):
    from voxactb_tpu_torch.data.rlbench_format import permissive_load

    return list(permissive_load(path))


@pytest.mark.parametrize("which", ["generated", "synthetic"])
def test_data_tools_write_the_jax_tools_files(which, request):
    """Every PNG and .npy byte-equal, the descriptions' pickle byte-equal, and
    the frames' pickles load into objects with equal attributes."""
    root = request.getfixturevalue(which)
    files = _files(root / "jax")
    assert files == _files(root / "port") and len(files) > 8
    n_images = 0
    for rel in files:
        jax_bytes = (root / "jax" / rel).read_bytes()
        port_bytes = (root / "port" / rel).read_bytes()
        if rel.endswith((".png", ".npy")) or rel.endswith("variation_descriptions.pkl"):
            assert port_bytes == jax_bytes, rel
            n_images += rel.endswith((".png", ".npy"))
        else:
            assert rel.endswith("low_dim_obs.pkl"), rel
            port_obs = _pickle_objects(str(root / "port" / rel))
            jax_obs = _pickle_objects(str(root / "jax" / rel))
            assert len(port_obs) == len(jax_obs) > 0
            for i, (a, b) in enumerate(zip(port_obs, jax_obs)):
                _assert_same_attributes(a, b, f"{rel}[{i}]")
    assert n_images > 0


def test_the_generator_pickles_name_the_port_module(generated):
    """The port's frames unpickle into its own ``_PickleObs``."""
    path = next(os.path.join(d, f) for d, _, fs in os.walk(generated / "port")
                for f in fs if f == "low_dim_obs.pkl")
    with open(path, "rb") as f:
        frames = pickle.load(f)
    assert type(frames[0]) is dataset_generator._PickleObs


@pytest.mark.parametrize("which", ["generated", "synthetic"])
def test_each_loader_reads_the_other_packages_dataset(which, request):
    """``DemoReader`` of each package on each package's dataset gives equal
    demos: descriptions, variation, observations and their images."""
    from voxactb_tpu.data.rlbench_format import DemoReader as JaxReader
    from voxactb_tpu_torch.data.rlbench_format import DemoReader

    root = request.getfixturevalue(which)
    variation = -1 if which == "generated" else 0
    loaded = {(reader, writer): cls(str(root / writer)).load(
                  "open_jar", amount=-1, variation=variation)
              for reader, cls in (("port", DemoReader), ("jax", JaxReader))
              for writer in ("port", "jax")}
    want = loaded[("jax", "jax")]
    assert len(want) == 2
    for key, demos in loaded.items():
        assert len(demos) == len(want), key
        for d, w in zip(demos, want):
            assert d.descriptions == w.descriptions and d.variation == w.variation, key
            assert len(d.observations) == len(w.observations) > 0, key
            for i, (a, b) in enumerate(zip(d.observations, w.observations)):
                _assert_same_attributes(a, b, f"{key}[{i}]")
    o = loaded[("port", "jax")][0].observations[0]
    assert o.wrist_rgb.shape == (16, 16, 3)


# -- PyRep and gym -----------------------------------------------------------------------


def test_pyrep_backend_gates_cleanly():
    from voxactb_tpu_torch.sim.pyrep_backend import PyRepBackend, pyrep_available

    if pyrep_available():
        pytest.skip("CoppeliaSim present; adapter exercised by sim-in-the-loop runs")
    with pytest.raises(RuntimeError, match="KinematicBackend"):
        PyRepBackend("/nonexistent/scene.ttt")


def test_pyrep_backend_declares_full_simbackend_contract():
    """Every SimBackend abstract must be overridden by the adapter — the
    environment calls them all (reset() -> reset_arms regression)."""
    from voxactb_tpu.sim.pyrep_backend import PyRepBackend as JaxPyRepBackend
    from voxactb_tpu_torch.sim.backend import SimBackend
    from voxactb_tpu_torch.sim.pyrep_backend import PyRepBackend

    missing = [name for name in SimBackend.__abstractmethods__
               if getattr(PyRepBackend, name) is getattr(SimBackend, name)]
    assert not missing, f"PyRepBackend misses SimBackend methods: {missing}"
    own = lambda cls: sorted(k for k, v in vars(cls).items() if callable(v))  # noqa: E731
    assert own(PyRepBackend) == own(JaxPyRepBackend)


def test_gym_adapter_steps_like_the_jax_adapter():
    """tests/test_extras.py's gym adapter case on the port, with the JAX
    adapter stepped beside it on the JAX sim: equal observations, rewards,
    flags and frames."""
    from voxactb_tpu.envs.gym_adapter import BimanualGymEnv as JaxGymEnv
    from voxactb_tpu.sim.environment import BimanualTaskEnvironment as JaxEnv
    from voxactb_tpu.sim.tasks import OpenDrawer as JaxOpenDrawer
    from voxactb_tpu_torch.envs.gym_adapter import BimanualGymEnv, register_gymnasium
    from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment
    from voxactb_tpu_torch.sim.tasks import OpenDrawer

    def language(text):
        r = np.random.default_rng(len(text))
        return (r.normal(size=(1024,)).astype(np.float32),
                r.normal(size=(77, 512)).astype(np.float32))

    kw = dict(image_size=16, episode_length=3, lang_encoder=language)
    env = BimanualGymEnv(BimanualTaskEnvironment(OpenDrawer, **kw))
    jax_env = JaxGymEnv(JaxEnv(JaxOpenDrawer, **kw))
    obs, info = env.reset(seed=4)
    jax_obs, _ = jax_env.reset(seed=4)
    assert "wrist_rgb" in obs and info == {}
    _assert_same_value(obs, jax_obs, "reset")
    action = np.r_[0.3, 0.0, 1.0, 0, 0, 0, 1, 1.0, 1.0]
    for step in range(3):
        got, want = env.step(action), jax_env.step(action)
        assert isinstance(got[1], float)
        _assert_same_value(got[0], want[0], f"step {step}")
        assert got[1:4] == want[1:4], step
    frame = env.render()
    assert frame.shape[-1] == 3
    np.testing.assert_array_equal(frame, jax_env.render())
    assert env.action_dim == 9
    env.close()
    jax_env.close()
    try:
        import gymnasium  # noqa: F401
    except ImportError:
        assert register_gymnasium("open_jar") is None
    else:
        assert register_gymnasium("open_jar") == "VoxActB/open_jar-v0"
