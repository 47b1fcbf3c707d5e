"""The port's VoxPoser subsystem against the JAX package's on the same inputs,
all exact (host code on both sides): value-map specs and
``set_voxel_by_radius``, the greedy planner's paths, the LMP sandbox, the
scripted LMP and its disk cache (a cache written by the JAX package is read
by the port), the dominant-hand rules, ``LMPInterface.execute`` on each
package's ``FakeBimanualEnv``, the MPC's push plans, the ``voxposer_only``
rollout and the pre-positioning prologue through ``RolloutGenerator``, the
sim's object lookup, and ``llm_http``'s request bodies against a loopback
HTTP server."""

import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest
import torch

import voxactb_tpu.voxposer.controller as JC
import voxactb_tpu.voxposer.heuristics as JH
import voxactb_tpu.voxposer.interface as JI
import voxactb_tpu.voxposer.lmp as JL
import voxactb_tpu.voxposer.planner as JP
import voxactb_tpu.voxposer.value_maps as JV
import voxactb_tpu_torch.voxposer.controller as PC
import voxactb_tpu_torch.voxposer.heuristics as PH
import voxactb_tpu_torch.voxposer.interface as PI
import voxactb_tpu_torch.voxposer.lmp as PL
import voxactb_tpu_torch.voxposer.planner as PP
import voxactb_tpu_torch.voxposer.value_maps as PV


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


BOUNDS = np.array([-0.4, -0.5, 0.6, 0.6, 0.5, 1.4], np.float32)
PROGRAM = (
    "obj = detect('cube')\n"
    "aff = get_empty_affordance_map()\n"
    "set_voxel_by_radius(aff, pointat2index(obj.position), 4, 1.0)\n"
    "grip = get_default_gripper_map()\n"
    "grip[:, :, :] = 0.0\n"
    "ret_val = execute('ee', aff, gripper_map=grip)\n"
)


def _same(a, b):
    """Equal structure, and arrays equal bit for bit."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _envs(seed, episode_length=30):
    from voxactb_tpu.envs.fake_env import FakeBimanualEnv as JaxEnv
    from voxactb_tpu_torch.envs.fake_env import FakeBimanualEnv

    envs = []
    for cls in (JaxEnv, FakeBimanualEnv):
        env = cls(image_size=8, episode_length=episode_length, seed=seed)
        env.launch()
        envs.append(env)
    return envs


# -- value maps and the planner -------------------------------------------------------


def test_map_spec_matches_jax(rng):
    j, p = JV.VoxelMapSpec(BOUNDS, 50), PV.VoxelMapSpec(BOUNDS, 50)
    pts = rng.uniform(-1, 2, (20, 3))
    for pt in pts:
        _same(p.world_to_voxel(pt), j.world_to_voxel(pt))
        _same(p.voxel_to_world(p.world_to_voxel(pt)), j.voxel_to_world(j.world_to_voxel(pt)))
    for cm in (0.5, 3, 10, 37.5):
        assert p.cm2index(cm) == j.cm2index(cm)
        assert p.cm2index(cm, [1, 2, 0.5]) == j.cm2index(cm, [1, 2, 0.5])
    for name in ("affordance_map", "avoidance_map", "rotation_map", "velocity_map",
                 "gripper_map"):
        _same(getattr(p, name)(), getattr(j, name)())
    m = rng.normal(size=(6, 6, 6))
    _same(PV.normalize_map(m), JV.normalize_map(m))


@pytest.mark.parametrize("vector", [False, True])
def test_set_voxel_by_radius_matches_jax(vector):
    spec_j, spec_p = JV.VoxelMapSpec(BOUNDS, 40), PV.VoxelMapSpec(BOUNDS, 40)
    make = (lambda s: s.rotation_map()) if vector else (lambda s: s.affordance_map())
    for center, radius in (([20, 20, 20], 6), ([0, 39, 3], 10), ([5, 5, 5], 0.4)):
        want = JV.set_voxel_by_radius(make(spec_j), center, radius, spec_j, 0.5)
        got = PV.set_voxel_by_radius(make(spec_p), center, radius, spec_p, 0.5)
        _same(got, want)


def _planner_case(name):
    target = np.zeros((40, 40, 40))
    obstacle = np.zeros_like(target)
    cfg = {}
    if name == "reach":
        target[30, 30, 30] = 1
        start, centric = [5.0, 5.0, 5.0], False
    elif name == "avoid":
        target[35, 20, 20] = 1
        obstacle[15:25, 15:25, :] = 1
        cfg = dict(obstacle_map_weight=10.0, obstacle_map_gaussian_sigma=2.0)
        start, centric = [5.0, 20.0, 20.0], False
    else:
        target[28:31, 8:11, 12] = 1
        start, centric = [10.0, 30.0, 12.0], True
    return target, obstacle, cfg, np.asarray(start), centric


@pytest.mark.parametrize("name", ["reach", "avoid", "object_centric"])
def test_planner_paths_match_jax(name):
    target, obstacle, cfg, start, centric = _planner_case(name)
    pj = JP.GreedyPathPlanner(JP.PlannerConfig(**cfg), map_size=40)
    pp = PP.GreedyPathPlanner(PP.PlannerConfig(**cfg), map_size=40)
    path_j, info_j = pj.optimize(start, target, obstacle, object_centric=centric)
    path_p, info_p = pp.optimize(start, target, obstacle, object_centric=centric)
    assert len(path_p) >= 2
    _same(path_p, path_j)
    _same(info_p, info_j)


def test_curvature_matches_jax(rng):
    path = np.cumsum(rng.normal(size=(30, 3)), 0)
    _same(PP.calc_curvature(path), JP.calc_curvature(path))


# -- the LMP ---------------------------------------------------------------------------


@pytest.mark.parametrize("code", ["ret_val = sum([1, 2, 3])", "ret_val = eval('1+1')",
                                  "import os", "x = ().__class__",
                                  "ret_val = sorted(reversed(range(4)))"])
def test_exec_safe_matches_jax(code):
    def run(fn):
        try:
            return "ok", fn(code)
        except ValueError as e:
            return "raised", str(e)
    want, got = run(JL.exec_safe), run(PL.exec_safe)
    assert got == want


@pytest.mark.parametrize("query", ["wave at the camera",
                                   "grasp the jar with left hand and twist with right hand",
                                   "hold the drawer with left hand and open the bottom "
                                   "drawer with right hand"])
def test_scripted_lmp_and_cache_match_jax(query, tmp_path):
    """The same prompt, cache key and file, value and execution history; a
    cache the JAX package wrote is read by the port (whose backend then is
    never called)."""
    programs = {"wave": "ret_val = helper() * 2", "hand": "ret_val = helper() + 1"}
    kw = dict(variable_vars={"helper": lambda: 21})
    lj = JL.LMP("planner", JL.LMPConfig(prompt_text="{variable_vars_imports}\n# hi"),
                JL.ScriptedBackend(programs), cache_dir=str(tmp_path / "jax"), **kw)
    lp = PL.LMP("planner", PL.LMPConfig(prompt_text="{variable_vars_imports}\n# hi"),
                PL.ScriptedBackend(programs), cache_dir=str(tmp_path / "port"), **kw)
    assert lp.build_prompt(query) == lj.build_prompt(query)
    assert lp(query) == lj(query)
    assert lp.exec_hist == lj.exec_hist
    files_j, files_p = (sorted(os.listdir(tmp_path / d)) for d in ("jax", "port"))
    assert files_p == files_j and len(files_p) == 1
    assert ((tmp_path / "port" / files_p[0]).read_bytes()
            == (tmp_path / "jax" / files_j[0]).read_bytes())

    def never(prompt, stop):
        raise AssertionError("the cache was not read")
    cached = PL.LMP("planner", PL.LMPConfig(prompt_text="{variable_vars_imports}\n# hi"),
                    never, cache_dir=str(tmp_path / "jax"), **kw)
    assert cached(query) == lj(query)


def test_disk_cache_roundtrip_across_packages(tmp_path):
    key = {"prompt": "p", "stop": ["#"], "n": 3}
    JL.DiskCache(str(tmp_path)).put(key, {"code": "x = 1"})
    assert PL.DiskCache(str(tmp_path)).get(key) == {"code": "x = 1"}
    PL.DiskCache(str(tmp_path)).put({"other": 1}, "y")
    assert JL.DiskCache(str(tmp_path)).get({"other": 1}) == "y"
    assert PL.DiskCache(str(tmp_path), load_cache=False).get(key) is None


def test_default_cache_dir_is_under_the_temp_dir():
    import tempfile

    assert PL.DEFAULT_CACHE_DIR == os.path.join(tempfile.gettempdir(), "voxactb_llm_cache")


@pytest.mark.parametrize("case", [
    dict(task_name="open_drawer", front_lookat=[1, 0, 0], object_normals=[[-1, 0, 0]]),
    dict(task_name="open_drawer", front_lookat=[1, 0, 0], object_normals=[[1, 0, 0]]),
    dict(task_name="PutItemInDrawer", front_lookat=[1, 0.2, 0],
         object_normals=[[-1, 0, 0], [-0.9, 0.1, 0]]),
    dict(task_name="open_jar", object_centroid=[0.1, -0.3, 0.8],
         right_arm_base=[0.0, -0.5, 0.75], left_arm_base=[0.0, 0.5, 0.75]),
    dict(task_name="hand_over_item", object_centroid=[0.1, -0.3, 0.8],
         right_arm_base=[0.0, -0.5, 0.75], left_arm_base=[0.0, 0.5, 0.75]),
    dict(task_name="sweep_to_dustpan", object_centroid=[0.1, 0.3, 0.8],
         right_arm_base=[0.0, -0.5, 0.75], left_arm_base=[0.0, 0.5, 0.75]),
    dict(task_name="stack_blocks"),
])
def test_dominant_hand_matches_jax(case):
    case = dict(case)
    if "object_normals" in case:
        case["object_normals"] = np.asarray(case["object_normals"])
    name = case.pop("task_name")

    def run(fn):
        try:
            return fn(name, **case)
        except NotImplementedError as e:
            return f"raised {e}"
    assert run(PH.determine_dominant_hand) == run(JH.determine_dominant_hand)


# -- execution on the envs -----------------------------------------------------------


def test_lmp_interface_execute_matches_jax():
    """The same waypoints, the same commanded arm motions, on each package's
    ``FakeBimanualEnv`` from one seed."""
    out = []
    for env, mod, vm in zip(_envs(0, 50), (JI, PI), (JV, PV)):
        env.reset()
        spec = vm.VoxelMapSpec(BOUNDS, 40)
        obj = mod.DetectedObject("cube", np.asarray(env.target_object_world_coords()))
        iface = mod.LMPInterface(env, spec, lambda name, obj=obj: obj, arm="right")
        aff = iface.get_empty_affordance_map()
        iface.set_voxel_by_radius(aff, iface.pointat2index(obj.position), radius_cm=4,
                                  value=1.0)
        actions = iface.execute("ee", aff)
        out.append((actions, iface.executed_paths, env.step_log))
    _same(out[1], out[0])
    assert len(out[1][0]) >= 1


def test_object_centric_execute_matches_jax():
    """'push the cube': the MPC's plan and its approach, push and retreat."""
    out = []
    for env, mod, vm in zip(_envs(3, 50), (JI, PI), (JV, PV)):
        env.reset()
        spec = vm.VoxelMapSpec(BOUNDS, 40)
        pos = np.asarray(env.target_object_world_coords())
        obj = mod.DetectedObject("cube", pos, aabb=np.r_[pos - 0.02, pos + 0.02])
        iface = mod.LMPInterface(env, spec, lambda name, obj=obj: obj, arm="left")
        aff = iface.get_empty_affordance_map()
        iface.set_voxel_by_radius(aff, iface.pointat2index(pos + [0.1, 0.05, 0]), 3)
        out.append((iface.execute(obj, aff), env.step_log))
    _same(out[1], out[0])
    assert len(out[1][1]) == 3


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_mpc_push_plan_bit_equal(seed):
    obj, tgt = np.array([0.3, 0.0, 0.8]), np.array([0.35, 0.15, 0.8])
    mj = JC.RandomShootingMPC(cfg=JC.MPCConfig(num_samples=256), seed=seed)
    mp = PC.RandomShootingMPC(cfg=PC.MPCConfig(num_samples=256), seed=seed)
    for _ in range(2):  # the generator's stream goes on alike
        _same(mp.plan_push(obj, 0.03, tgt), mj.plan_push(obj, 0.03, tgt))
    dyn = (JC.PushingDynamicsModel(0.8), PC.PushingDynamicsModel(0.8))
    args = (obj, obj - [0.03, 0, 0], np.array([[1.0, 0, 0], [0, 2.0, 0]]),
            np.array([0.1, 0.05]))
    _same(dyn[1].predict(*args), dyn[0].predict(*args))


def test_voxposer_only_rollout_matches_jax(tmp_path):
    from voxactb_tpu.runners.rollout import RolloutGenerator as JaxRollout
    from voxactb_tpu_torch.runners.rollout import RolloutGenerator

    out = []
    for env, mod, vm, gen, lm in zip(_envs(1), (JI, PI), (JV, PV),
                                     (JaxRollout, RolloutGenerator), (JL, PL)):
        planner = mod.VoxPoserPlanner(
            lm.ScriptedBackend({"hand": PROGRAM}), vm.VoxelMapSpec(BOUNDS, 40),
            lambda name, env=env, mod=mod: mod.DetectedObject(
                name, np.asarray(env.target_object_world_coords())),
            cache_dir=str(tmp_path / mod.__name__))
        ts = list(gen().generator(env, agent=None, episode_length=30,
                                  voxposer_only_eval=True, planner=planner))
        out.append(([(t.action, t.reward, t.terminal, t.timeout) for t in ts],
                    env.step_log))
    assert out[1][0]
    _same(out[1], out[0])
    # both arms driven, unless the left arm's plan already ended the episode
    assert {arm for _, arm, _ in out[1][1]} == {"left", "right"} or out[1][0][-1][2]


class _ScriptedAgent:
    """The same action every act, whatever the observation."""

    def act(self, step, observation, **kw):
        from voxactb_tpu_torch.agents.base import ActResult

        return ActResult(np.r_[0.1, 0.0, 1.0, 0, 0, 0, 1, 1.0, 1.0].astype(np.float32))


def _prologue_run(mods, env, agent, tmp_path, episode_length=4):
    mod, vm, gen, lm = mods
    planner = mod.VoxPoserPlanner(
        lm.ScriptedBackend({"hand": PROGRAM}), vm.VoxelMapSpec(BOUNDS, 40),
        lambda name: mod.DetectedObject(name, np.asarray(env.target_object_world_coords())),
        cache_dir=str(tmp_path / mod.__name__))
    ts = list(gen().generator(env, agent, episode_length=episode_length,
                              which_arm="right", crop_target_obj_voxel=True,
                              crop_radius=0.3, no_voxposer=False, planner=planner,
                              max_preposition_steps=6))
    return [t.action for t in ts], env.step_log


def test_preposition_prologue_matches_jax(tmp_path):
    """VoxAct-B's prologue through ``RolloutGenerator``: the planner's six
    motions, then the policy's acts, the same in both packages; with the
    port's own agent on the CPU the prologue is the same again."""
    from voxactb_tpu.runners.rollout import RolloutGenerator as JaxRollout
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.config import MethodConfig
    from voxactb_tpu_torch.runners.rollout import RolloutGenerator

    envs = _envs(2)
    want = _prologue_run((JI, JV, JaxRollout, JL), envs[0], _ScriptedAgent(), tmp_path)
    got = _prologue_run((PI, PV, RolloutGenerator, PL), envs[1], _ScriptedAgent(),
                        tmp_path)
    _same(got, want)
    prologue = got[1][:6]
    arms = [arm for _, arm, _ in prologue]
    assert len(got[1]) == 6 + 4 and arms == sorted(arms)  # the left arm's plan first

    cfg = MethodConfig(voxel_sizes=[10], num_latents=16, latent_dim=32,
                       transformer_depth=1, cross_dim_head=16, latent_dim_head=16,
                       final_dim=8, which_arm="right")
    agent = QAttentionBCAgent(cfg, ["wrist", "wrist2"], [-0.8, -1.0, 0.1, 1.2, 1.0, 2.1],
                              device="cpu")
    agent.build(training=False)
    env = _envs(2)[1]
    actions, log = _prologue_run((PI, PV, RolloutGenerator, PL), env, agent, tmp_path)
    _same(log[:6], prologue)
    # the policy's own action may end the episode early
    assert 1 <= len(actions) <= 4 and all(np.asarray(a).shape == (9,) for a in actions)


def test_sim_object_lookup_matches_jax():
    from voxactb_tpu.sim.environment import BimanualTaskEnvironment as JaxSim
    from voxactb_tpu.sim.tasks import OpenJar as JaxOpenJar
    from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment
    from voxactb_tpu_torch.sim.tasks import OpenJar

    def lang(text):
        return np.zeros(1024, np.float32), np.zeros((77, 512), np.float32)

    out = []
    for sim, task, mod in ((JaxSim, JaxOpenJar, JI), (BimanualTaskEnvironment, OpenJar, PI)):
        env = sim(task, image_size=8, seed=0, lang_encoder=lang)
        env.launch()
        env.reset()
        lookup = mod.make_sim_object_lookup(env)
        obj = lookup("the jar")
        with pytest.raises(KeyError):
            lookup("nonexistent thing")
        out.append((obj.name, obj.position, obj.aabb, obj.points, obj.normals))
    _same(out[1], out[0])
    assert out[1][0] == "jar"


# -- llm_http --------------------------------------------------------------------------


class _FakeOpenAI(BaseHTTPRequestHandler):
    script = []
    requests = []

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        type(self).requests.append((self.path, dict(self.headers), body))
        kind, arg = type(self).script.pop(0) if type(self).script else ("ok", "pass")
        if kind == "fail":
            self.send_response(arg)
            self.end_headers()
            return
        data = json.dumps({"choices": [{"message": {"content": arg}}]}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


@pytest.fixture
def fake_server():
    _FakeOpenAI.script, _FakeOpenAI.requests = [], []
    srv = HTTPServer(("127.0.0.1", 0), _FakeOpenAI)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}/v1", _FakeOpenAI
    srv.shutdown()


def _bodies(fake):
    return [(path, {k: v for k, v in headers.items()
                    if k in ("Content-Type", "Authorization")}, body)
            for path, headers, body in fake.requests]


def test_chat_requests_match_jax(fake_server):
    """The same request bodies and headers, the same retries and sleeps, the
    same answers and the same error after the budget."""
    import voxactb_tpu.voxposer.llm_http as JH_
    import voxactb_tpu_torch.voxposer.llm_http as PH_

    url, fake = fake_server
    seen = []
    for mod in (JH_, PH_):
        fake.requests = []
        fake.script = [("fail", 500), ("ok", "ret_val = 42"), ("fail", 503)] + [
            ("fail", 500)] * 3
        sleeps = []
        be = mod.OpenAIChatBackend(base_url=url, api_key="k", max_retries=3,
                                   retry_sleep_s=2.0, _sleep=sleeps.append)
        answer = be("compute the answer", stop=["# Query:", "a", "b", "c", "d"])
        with pytest.raises(mod.LLMTransportError) as err:
            be("q", stop=[])
        seen.append((answer, sleeps, be.n_requests, str(err.value).split(":")[0],
                     _bodies(fake)))
    assert seen[1] == seen[0]
    assert seen[1][4][1][2]["stop"] == ["# Query:", "a", "b", "c"]


def test_vision_requests_match_jax(fake_server, rng):
    pytest.importorskip("PIL")
    import voxactb_tpu.voxposer.llm_http as JH_
    import voxactb_tpu_torch.voxposer.llm_http as PH_

    url, fake = fake_server
    rgb = rng.integers(0, 255, (8, 8, 3)).astype(np.uint8)
    seen = []
    for mod in (JH_, PH_):
        fake.requests = []
        fake.script = [("ok", "Reasoning. The left arm should act."), ("ok", "no idea")]
        be = mod.VisionChatBackend(base_url=url, api_key="k", _sleep=lambda s: None)
        arms = [mod.determine_dominant_hand_llm(rgb, "which arm?", be),
                mod.determine_dominant_hand_llm(rgb, "which arm?", be),  # cached
                mod.determine_dominant_hand_llm(rgb[::-1], "?", be,
                                                rng=np.random.default_rng(0))]
        seen.append((arms, be.n_requests, _bodies(fake)))
    assert seen[1] == seen[0]
    assert seen[1][0][0] == "left"


def test_voxposer_imports_without_pil(monkeypatch):
    """The card's machine may lack PIL: the package imports without it, and
    only the image encoding needs it."""
    import importlib

    import voxactb_tpu_torch.voxposer as package
    from voxactb_tpu_torch.voxposer import llm_http

    monkeypatch.setitem(sys.modules, "PIL", None)  # "import PIL" raises
    try:
        importlib.reload(importlib.reload(llm_http) and package)
        with pytest.raises(ImportError):
            llm_http._encode_jpeg_b64(np.zeros((2, 2, 3), np.uint8))
    finally:
        monkeypatch.undo()
        importlib.reload(package)
