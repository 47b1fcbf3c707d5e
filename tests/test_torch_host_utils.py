"""The port's host utilities against the JAX package's, exact: ``retry`` and
``RecoveringEnv`` (restarts on reset and step crashes, the per-incident
budget, the give-up, the passthroughs), the episode video recorder (its
``.npz`` fallback and the camera orbit) and the voxel and value-map
visualisers."""

import logging

import numpy as np
import pytest
import torch

import voxactb_tpu.utils.recovery as JR
import voxactb_tpu.utils.video as JV
import voxactb_tpu.utils.visualize as JZ
import voxactb_tpu_torch.utils.recovery as PR
import voxactb_tpu_torch.utils.video as PV
import voxactb_tpu_torch.utils.visualize as PZ


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, str) or a is None:
        assert a == b
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# -- recovery ----------------------------------------------------------------------------


def _flaky_cls(fake_env_cls):
    class FlakyEnv(fake_env_cls):
        """Crashes on the first ``fail_resets`` resets and on command."""

        def __init__(self, fail_resets=0, **kw):
            super().__init__(**kw)
            self._fail_resets = fail_resets
            self.crash_next_step = False

        def reset(self):
            if self._fail_resets > 0:
                self._fail_resets -= 1
                raise RuntimeError("sim crashed during reset")
            return super().reset()

        def step(self, action, which_arm):
            if self.crash_next_step:
                self.crash_next_step = False
                raise RuntimeError("sim crashed during step")
            return super().step(action, which_arm)
    return FlakyEnv


def _both_flaky():
    from voxactb_tpu.envs.fake_env import FakeBimanualEnv as JaxEnv
    from voxactb_tpu_torch.envs.fake_env import FakeBimanualEnv

    return ((JR, _flaky_cls(JaxEnv)), (PR, _flaky_cls(FakeBimanualEnv)))


@pytest.mark.parametrize("fails", [0, 2, 5])
def test_retry_matches_jax(fails, monkeypatch):
    seen = []
    for mod in (JR, PR):
        sleeps, calls, retried = [], [], []
        monkeypatch.setattr(mod.time, "sleep", sleeps.append)

        def fn():
            calls.append(1)
            if len(calls) <= fails:
                raise ValueError(f"boom {len(calls)}")
            return 42
        try:
            out = mod.retry(fn, attempts=4, delay=0.5,
                            on_retry=lambda i, e: retried.append((i, str(e))))
        except ValueError as e:
            out = f"raised {e}"
        seen.append((out, len(calls), sleeps, retried))
    assert seen[1] == seen[0]


def _recovering_run(mod, flaky, fail_resets, crash_step, max_restarts):
    made = []

    def factory():
        # 99: every env crashes on reset; otherwise only the first one
        env = flaky(fail_resets=fail_resets if not made or fail_resets == 99 else 0,
                    image_size=8,
                    episode_length=4, seed=len(made))
        env.launch()
        made.append(env)
        return env

    env = mod.RecoveringEnv(factory, max_restarts=max_restarts, retry_delay=0.0)
    try:
        obs = env.reset()
    except RuntimeError as e:
        return [f"raised {e}", len(made)]
    out = [obs, env.restarts, len(made), env.task_name, env.env_language_goal,
           env.episode_length, env.dominant_arm(), env.target_object_world_coords(),
           env.auto_crop_radius()]
    action = np.r_[0.3, 0.0, 1.0, 0, 0, 0, 1, 1.0, 1.0]
    env._env.crash_next_step = crash_step
    t = env.step(action, "right")
    out += [t.observation, t.terminal, t.info, len(made)]
    t = env.step(action, "left")
    out += [t.observation, t.terminal, len(made), env.reset_to_demo(1)]
    return out


@pytest.mark.parametrize("case", [(1, False, 3), (2, True, 3), (0, True, 1), (99, False, 2)])
def test_recovering_env_matches_jax(case, monkeypatch):
    """Reset crashes (rebuilt, budget re-armed), a step crash (the episode
    ends, the env is rebuilt and usable), and the give-up: the same
    observations, flags and rebuild counts in both packages."""
    seen = []
    for mod, flaky in _both_flaky():
        monkeypatch.setattr(mod.time, "sleep", lambda s: None)
        seen.append(_recovering_run(mod, flaky, *case))
    _same(seen[1], seen[0])
    if case[0] == 99:
        assert "giving up" in seen[1][0]


def test_recovering_env_logs_like_jax(caplog):
    seen = []
    for mod, flaky in _both_flaky():
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            made = []

            def factory():
                made.append(flaky(fail_resets=0 if made else 1, image_size=8,
                                  episode_length=4))
                return made[-1]
            mod.RecoveringEnv(factory, max_restarts=2, retry_delay=0.0).reset()
        seen.append([r.getMessage() for r in caplog.records])
    assert seen[1] == seen[0] and seen[1]


# -- video -----------------------------------------------------------------------------


def test_circle_camera_motion_matches_jax():
    mj = JV.CircleCameraMotion([0.1, 0.2, 0.3], radius=0.9, speed_deg=7.5)
    mp = PV.CircleCameraMotion([0.1, 0.2, 0.3], radius=0.9, speed_deg=7.5)
    for _ in range(60):
        _same(mp.step(), mj.step())


@pytest.mark.parametrize("imageio", [False, True])
def test_task_recorder_matches_jax(imageio, tmp_path, rng, monkeypatch):
    """Without an encoder (``imageio`` missing, or failing mid-write) both
    packages fall back to the same ``.npz``; with a working one both write
    the same frames through it."""
    import sys

    frames = [rng.integers(0, 255, (6, 8, 3)).astype(np.uint8) for _ in range(5)]
    written = {}
    if imageio:
        fake = type(sys)("imageio.v2")
        fake.mimwrite = lambda out, fr, fps: written.setdefault(out, (np.stack(fr), fps))
        monkeypatch.setitem(sys.modules, "imageio.v2", fake)
        monkeypatch.setitem(sys.modules, "imageio", type(sys)("imageio"))
        sys.modules["imageio"].v2 = fake
    else:
        monkeypatch.setitem(sys.modules, "imageio", None)
    outs = []
    for mod in (JV, PV):
        it = iter(frames)
        rec = mod.TaskRecorder(lambda: next(it), fps=12)
        for _ in frames:
            rec.take_snap()
        out = rec.save(str(tmp_path / mod.__name__ / "ep0.mp4"))
        outs.append(out)
        with pytest.raises(RuntimeError, match="no frames"):
            rec.save(str(tmp_path / "empty.mp4"))
    if imageio:
        _same(written[outs[1]], written[outs[0]])
        assert outs[1].endswith(".mp4")
    else:
        a, b = np.load(outs[0]), np.load(outs[1])
        assert outs[1].endswith("ep0.npz")
        _same({k: b[k] for k in b.files}, {k: a[k] for k in a.files})


# -- visualisers ---------------------------------------------------------------------------


@pytest.mark.parametrize("overlay", [False, True])
def test_visualise_voxel_matches_jax(overlay, rng):
    grid = rng.uniform(-1, 1, (10, 10, 10, 10)).astype(np.float32)
    grid[..., -1] = rng.uniform(size=(10, 10, 10)) > 0.7
    kw = {}
    if overlay:
        kw = dict(q_attention=rng.normal(size=(1, 1000)), highlight_coordinate=[2, 5, 9],
                  gt_coordinate=np.array([7, 0, 3]))
    got = PZ.visualise_voxel(grid, **kw)
    _same(got, JZ.visualise_voxel(grid, **kw))
    assert got.shape == (10, 32, 3) and got.dtype == np.uint8


def test_value_map_visualizer_matches_jax(tmp_path, rng):
    maps = {"affordance": rng.uniform(size=(6, 6, 6)), "rotation": rng.normal(size=(6, 6, 6, 4))}
    path = rng.uniform(0, 6, (7, 3))
    dumps = []
    for mod in (JZ, PZ):
        viz = mod.ValueMapVisualizer(str(tmp_path / mod.__name__), max_dumps=2)
        outs = [viz.update(maps, path), viz.update(maps), viz.update(maps, path)]
        assert outs[2] is None
        dumps.append([dict(np.load(o)) for o in outs[:2]])
    _same(dumps[1], dumps[0])
