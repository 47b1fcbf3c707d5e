"""The port's real-robot stack against the JAX package's, all exact: the
URScript strings byte for byte, the secondary and realtime packet parsers,
``URRobot`` and ``BimanualURRobot`` against a loopback fake UR controller (the
scripts each package sends, byte for byte, and the states it reads back), the
axis-angle conversions, ``guard_gimbal_lock``, ``_deproject``,
``RealRobotEnv`` (commands and observations on the same camera callables,
the VLM crop hook, and the programs on the fake controllers), and the offline
checkpoint selection (the same step, row and CSV)."""

import os
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

import voxactb_tpu.realrobot.monitor as JM
import voxactb_tpu.realrobot.robot as JR
import voxactb_tpu.realrobot.robot_env as JE
import voxactb_tpu.realrobot.urscript as JU
import voxactb_tpu_torch.realrobot.monitor as PM
import voxactb_tpu_torch.realrobot.robot as PR
import voxactb_tpu_torch.realrobot.robot_env as PE
import voxactb_tpu_torch.realrobot.urscript as PU


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


DOWN = np.array([0.0, 1.0, 0.0, 0.0])


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, str):
        assert a == b
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(x, y)


class FakeURController:
    """Serves the secondary and realtime streams on loopback and executes
    ``movel`` / ``movej`` by teleporting (as tests/test_realrobot.py's)."""

    def __init__(self):
        self.q = np.zeros(6)
        self.tcp = np.array([0.3, 0.0, 0.4, 0.0, 3.14, 0.0])
        self.programs = []
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.sec_srv = socket.create_server(("127.0.0.1", 0))
        self.rt_srv = socket.create_server(("127.0.0.1", 0))
        self.sec_port = self.sec_srv.getsockname()[1]
        self.rt_port = self.rt_srv.getsockname()[1]
        threading.Thread(target=self._sec_loop, daemon=True).start()
        threading.Thread(target=self._rt_loop, daemon=True).start()

    def state_packet(self) -> bytes:
        with self._lock:
            q, tcp = self.q.copy(), self.tcp.copy()
        mode = struct.pack(">Q", 0) + bytes([1, 1, 1, 0, 0, 1, 0, 7])
        mode_pkg = struct.pack(">i", 5 + len(mode)) + bytes([0]) + mode
        jd = b"".join(struct.pack(">ddd", q[j], q[j], 0.01 * j) + bytes(17)
                      for j in range(6))
        jd_pkg = struct.pack(">i", 5 + len(jd)) + bytes([1]) + jd
        ci = struct.pack(">6d", *tcp)
        ci_pkg = struct.pack(">i", 5 + len(ci)) + bytes([4]) + ci
        payload = bytes([16]) + mode_pkg + jd_pkg + ci_pkg
        return struct.pack(">i", 4 + len(payload)) + payload

    def rt_packet(self) -> bytes:
        with self._lock:
            q, tcp = self.q.copy(), self.tcp.copy()
        doubles = np.zeros(131)
        doubles[0] = 12.5
        doubles[31:37] = q
        doubles[55:61] = tcp
        payload = struct.pack(f">{len(doubles)}d", *doubles)
        return struct.pack(">i", 4 + len(payload)) + payload

    def _sec_loop(self):
        conn, _ = self.sec_srv.accept()
        conn.settimeout(0.01)
        buf = b""
        while not self._stop.is_set():
            try:
                conn.sendall(self.state_packet())
            except OSError:
                return
            try:
                data = conn.recv(65536)
                if data:
                    buf += data
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        self._execute(line.decode())
            except socket.timeout:
                pass
            except OSError:
                return
            time.sleep(0.005)

    def _execute(self, program: str) -> None:
        self.programs.append(program)
        for prefix, attr in (("movel(p[", "tcp"), ("movej([", "q")):
            if program.startswith(prefix):
                vals = [float(v) for v in program.split("[")[1].split("]")[0].split(",")]
                with self._lock:
                    setattr(self, attr, np.array(vals))

    def _rt_loop(self):
        conn, _ = self.rt_srv.accept()
        while not self._stop.is_set():
            try:
                conn.sendall(self.rt_packet())
            except OSError:
                return
            time.sleep(0.005)

    def stop(self):
        self._stop.set()
        self.sec_srv.close()
        self.rt_srv.close()


class _QuickTime:
    """``time`` for the robot modules with every sleep cut to 5 ms: the
    gripper's 1 s settle has no feedback to wait for here."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def sleep(s):
        time.sleep(min(s, 0.005))


@pytest.fixture
def quick(monkeypatch):
    for mod in (JR, PR):
        monkeypatch.setattr(mod, "time", _QuickTime())


# -- URScript ---------------------------------------------------------------------------

URSCRIPT_CASES = [
    ("movel", ([0.4, -0.1, 0.3, 0.0, 3.14159265, 1e-7],), {}),
    ("movel", ([1, 2, 3, 4, 5, 6],), dict(acc=0.2, vel=0.3, t=1.5, radius=0.01)),
    ("movej", ([0.1, -1.2, 1.3, -1.4, 1.5, -1.6],), dict(acc=0.5)),
    ("movec", ([0.1] * 6, [0.2] * 6), dict(radius=0.02)),
    ("speedl", ([0.01, 0, 0, 0, 0, -0.02],), dict(min_time=0.5)),
    ("speedj", ([0.1] * 6,), {}),
    ("stopl", (), {}), ("stopj", (2.0,), {}),
    ("set_tcp", ([0, 0, 0.15, 0, 0, 0],), {}),
    ("set_payload", (1.25, (0.0, 0.01, 0.05)), {}),
    ("set_digital_out", (3, True), {}), ("set_digital_out", (0, False), {}),
    ("freedrive_mode", (), {}), ("freedrive_mode", (False,), {}),
    ("robotiq_activate", (), {}), ("robotiq_set_position", (300,), dict(speed=10)),
    ("robotiq_set_position", (-5.7,), {}), ("robotiq_open", (), {}),
    ("robotiq_close", (), {}), ("robotiq_program", (["sync()", "sync()"],), {}),
]


@pytest.mark.parametrize("case", range(len(URSCRIPT_CASES)))
def test_urscript_bytes_match_jax(case):
    name, args, kw = URSCRIPT_CASES[case]
    got = getattr(PU, name)(*args, **kw)
    assert got.encode() == getattr(JU, name)(*args, **kw).encode()


# -- the packet parsers -------------------------------------------------------------------


def _state(monitor):
    return {k: v for k, v in vars(monitor.get_state()).items() if k != "timestamp"}


def test_secondary_parser_matches_jax():
    """A robot-state message, then a message of another type and one with a
    truncated joint record: the same states read."""
    c = FakeURController.__new__(FakeURController)
    c._lock = threading.Lock()
    c.q = np.arange(6) * 0.1
    c.tcp = np.array([0.5, -0.2, 0.3, 0.1, 3.0, -0.1])
    packet = c.state_packet()
    other = bytes([20]) + b"\x00" * 12
    short = packet[4:4 + 1 + 21] + struct.pack(">i", 5 + 60) + bytes([1]) + bytes(60)
    states = []
    for mod in (JM, PM):
        mon = mod.SecondaryMonitor("127.0.0.1", connect=False)
        seen = []
        for payload in (packet[4:], other, short):
            mon._parse_message(payload)
            seen.append(_state(mon))
        states.append(seen)
    _same(states[1], states[0])
    np.testing.assert_array_equal(states[1][0]["tcp_pose"], c.tcp)


def test_realtime_parser_matches_jax():
    c = FakeURController.__new__(FakeURController)
    c._lock = threading.Lock()
    c.q, c.tcp = np.arange(6) * -0.2, np.array([0.1, 0.2, 0.3, 0.4, 0.5, 0.6])
    full = c.rt_packet()[4:]
    short = full[:37 * 8]  # a CB2-sized message without the tool pose
    too_short = full[:36 * 8]
    seen = []
    for mod in (JM, PM):
        mon = mod.RealtimeMonitor("127.0.0.1", connect=False)
        out = []
        for payload in (full, short, too_short):
            mon._parse(payload)
            out.append((mon.q_actual(), mon.tcp_pose(), mon.timestamp()))
        seen.append(out)
    _same(seen[1], seen[0])


def test_urrobot_scripts_match_jax(quick):
    """The same calls on each package's ``URRobot``, each against its own
    fake controller: the same programs, byte for byte, the same poses and
    joints read back."""
    seen = []
    for mod in (JR, PR):
        c = FakeURController()
        robot = mod.URRobot("127.0.0.1", secondary_port=c.sec_port, realtime_port=c.rt_port)
        try:
            robot.set_tcp([0, 0, 0.15, 0, 0, 0])
            robot.set_payload(1.5)
            csys = np.eye(4)
            csys[:3, 3] = [1.0, 0.0, 0.0]
            robot.set_csys(csys)
            robot.movel([0.0, 0.1, 0.5, 0.0, 3.14, 0.0], timeout=5.0)
            pose = robot.get_pose()
            robot.movej([0.1, -1.0, 1.0, -1.5, -1.57, 0.0], timeout=5.0)
            joints = robot.getj()
            robot.speedl([0.01, 0, 0, 0, 0, 0])
            robot.stopl()
            robot.gripper_activate()
            robot.gripper_set(0.3)
            deadline = time.time() + 5
            while len(c.programs) < 24 and time.time() < deadline:
                time.sleep(0.01)
            seen.append(("\n".join(c.programs).encode(), pose, joints))
        finally:
            robot.close()
            c.stop()
    assert seen[1][0] == seen[0][0] and seen[1][0].count(b"\n") == 23
    np.testing.assert_allclose(seen[1][1][:3], [0.0, 0.1, 0.5], atol=1e-6)
    _same(seen[1][1:], seen[0][1:])


def test_bimanual_facade_matches_jax(quick):
    seen = []
    for mod in (JR, PR):
        cs = [FakeURController(), FakeURController()]
        bot = mod.BimanualURRobot(*(mod.URRobot("127.0.0.1", c.sec_port, c.rt_port)
                                    for c in cs))
        try:
            bot.move_arm("right", [0.4, -0.1, 0.3], [0, 0, 0, 1], gripper_open=1.0)
            bot.move_arm("left", [0.3, 0.2, 0.35], DOWN, gripper_open=0.25)
            seen.append(([c.programs[:] for c in cs], bot.observation()))
        finally:
            bot.close()
            for c in cs:
                c.stop()
    _same(seen[1], seen[0])


def test_axis_angle_round_trip_matches_jax(rng):
    for _ in range(50):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        rv = PR.quat_to_axis_angle(q)
        _same(rv, JR.quat_to_axis_angle(q))
        back = PR.axis_angle_to_quat(rv)
        _same(back, JR.axis_angle_to_quat(rv))
        assert abs(np.dot(back, q)) > 1 - 1e-6
    _same(PR.axis_angle_to_quat(np.zeros(3)), JR.axis_angle_to_quat(np.zeros(3)))
    _same(PR.quat_to_axis_angle([0, 0, 0, 1.0]), JR.quat_to_axis_angle([0, 0, 0, 1.0]))


# -- the env and its helpers ----------------------------------------------------------------


def test_guard_gimbal_lock_matches_jax(rng):
    quats = list(rng.normal(size=(40, 4))) + [DOWN, -DOWN, np.array([0, 0, 0, 1.0]),
                                               np.array([0.05, 0.995, 0, 0])]
    for q in quats:
        for tilt in (10.0, 30.0, 90.0):
            _same(PE.guard_gimbal_lock(q, tilt), JE.guard_gimbal_lock(q, tilt))


def test_deproject_matches_jax(rng):
    K = np.array([[120.0, 0, 9.5], [0, 110.0, 7.0], [0, 0, 1.0]], np.float32)
    depth = rng.uniform(0.3, 2.0, (14, 18)).astype(np.float32)
    ext = np.eye(4)
    ext[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    ext[:3, 3] = rng.normal(size=3)
    _same(PE._deproject(depth, K, ext), JE._deproject(depth, K, ext))


class _FakeRobots:
    def __init__(self):
        self.moves = []

    def move_arm(self, arm, pos, quat, gripper_open):
        self.moves.append((arm, np.asarray(pos), np.asarray(quat), gripper_open))

    def observation(self):
        p = len(self.moves) * 0.01
        return {"gripper_right_pose": np.array([0.3 + p, 0, 0.8, 0, 1, 0, 0], np.float32),
                "gripper_left_pose": np.array([0.3, 0.2 - p, 0.8, 0, 1, 0, 0], np.float32)}


def _cameras(seed):
    rng = np.random.default_rng(seed)
    K = np.array([[100.0, 0, 8.0], [0, 100.0, 6.0], [0, 0, 1.0]])
    frames = [(rng.integers(0, 255, (12, 16, 3)).astype(np.uint8),
               rng.uniform(0.5, 2.0, (12, 16)).astype(np.float32), K) for _ in range(2)]
    return {"front": lambda: frames[0], "wrist": lambda: frames[1]}


def _lang(text):
    v = float(len(text))
    return np.full(1024, v, np.float32), np.full((77, 512), -v, np.float32)


class _FakeVLM:
    def __init__(self):
        self.calls = []

    def get_target_object_world_coords(self, rgb, pcd, task):
        self.calls.append((rgb, pcd, task))
        return pcd.reshape(-1, 3).mean(0), 0.125


@pytest.mark.parametrize("lang", [True, False])
def test_real_robot_env_matches_jax(lang, rng):
    """The same robot commands (hand-eye extrinsics, gimbal guard, grip) and
    the same observations on the same camera callables, the VLM crop from the
    first camera; without a language encoder the raw BPE tokens."""
    T = np.eye(4)
    T[:3, 3] = [0.1, -0.2, 0.05]
    cam_ext = {"front": np.eye(4)}
    cam_ext["front"][:3, 3] = [0.0, 0.5, 1.0]
    actions = [(np.r_[0.3, 0.1, 0.8, DOWN, 1.0, 0.0], "dominant"),
               (np.r_[0.2, -0.1, 0.9, 0, 0, 0, 1, 0.2, 0.0], "assistive"),
               (np.r_[0.25, 0.0, 0.7, rng.normal(size=4), 0.7, 1.0], "right")]
    seen = []
    for mod in (JE, PE):
        robots, vlm = _FakeRobots(), _FakeVLM()
        env = mod.RealRobotEnv(robots, _cameras(3), extrinsics={"right": T, "left": np.eye(4)},
                               cam_extrinsics=cam_ext, vlm=vlm, task_name="open_jar",
                               episode_length=3, dominant_arm="left",
                               lang_encoder=_lang if lang else None)
        out = [env.reset(), env.target_object_world_coords(), env.auto_crop_radius(),
               env.target_object_world_coords()]
        for action, arm in actions:
            tr = env.step(action, arm)
            out.append((tr.observation, tr.reward, tr.terminal, tr.info))
        seen.append((out, robots.moves, vlm.calls, env.dominant_arm(), env.episode_length))
    _same(seen[1], seen[0])
    assert [m[0] for m in seen[1][1]] == ["left", "right", "right"]
    assert len(seen[1][2]) == 1 and seen[1][0][-1][2]  # one VLM pass; terminal at 3


def test_real_robot_env_on_fake_controllers_matches_jax(quick):
    """``RealRobotEnv`` over ``BimanualURRobot`` and two fake controllers per
    package: the programs each controller receives, byte for byte, and the
    commanded pose inside them is the action after the extrinsics and the
    gimbal guard."""
    T = np.eye(4)
    T[:3, 3] = [0.05, 0.0, -0.1]
    actions = [(np.r_[0.3, 0.1, 0.8, 0.1, 0.9, 0.05, 0.1, 1.0, 0.0], "dominant"),
               (np.r_[0.2, -0.1, 0.7, 0, 0, 0, 1, 0.0, 0.0], "assistive")]
    seen = []
    for mod, rmod in ((JE, JR), (PE, PR)):
        cs = {arm: FakeURController() for arm in ("right", "left")}
        bot = rmod.BimanualURRobot(*(rmod.URRobot("127.0.0.1", cs[a].sec_port, cs[a].rt_port)
                                     for a in ("right", "left")))
        try:
            env = mod.RealRobotEnv(bot, _cameras(4), extrinsics={"right": T, "left": T},
                                   episode_length=5, lang_encoder=_lang)
            env.reset()
            for action, arm in actions:
                env.step(action, arm)
            deadline = time.time() + 5
            while min(len(c.programs) for c in cs.values()) < 9 and time.time() < deadline:
                time.sleep(0.01)
            seen.append({a: "\n".join(c.programs).encode() for a, c in cs.items()})
        finally:
            bot.close()
            for c in cs.values():
                c.stop()
    assert seen[1] == seen[0]
    pos = (T @ np.r_[actions[0][0][:3], 1.0])[:3]
    rv = PR.quat_to_axis_angle(PE.guard_gimbal_lock(actions[0][0][3:7]))
    want = PU.movel(PR.URRobot._to_base(type("R", (), {"csys": np.eye(4)})(), np.r_[pos, rv]),
                    0.1, 0.1)
    assert seen[1]["right"].split(b"\n")[0] == want.encode()


def test_realsense_camera_needs_pyrealsense2():
    for mod in (JE, PE):
        with pytest.raises(RuntimeError, match="pyrealsense2"):
            mod.RealSenseCamera()


# -- offline checkpoint selection ----------------------------------------------------------


class _ScriptedAgent:
    """act() returns a fixed action per checkpoint; load_weights records it."""

    def __init__(self, actions_by_step):
        self._by_step = actions_by_step
        self._current = None
        self.loaded = []

    def load_weights(self, path):
        self._current = int(os.path.basename(path))
        self.loaded.append(self._current)

    def act(self, step, obs, **kw):
        from voxactb_tpu_torch.agents.base import ActResult

        return ActResult(self._by_step[self._current] + obs["shift"])


def test_select_best_checkpoint_matches_jax(tmp_path, rng):
    gt = np.r_[0.3, 0.1, 0.8, DOWN, 1.0]
    val = [{"observation": {"shift": s * rng.normal(size=9) * 1e-3}, "action": gt}
           for s in range(3)]
    actions = {1000: np.r_[gt[:3] + [0.1, 0, 0], gt[3:], 1.0],
               2000: np.r_[gt[:3], 0.1, 0.99, 0, 0, 0.0, 1.0],
               4000: np.r_[gt, 1.0],
               3000: np.r_[gt[:3] + [0, 0.02, 0], gt[3:], 1.0]}
    for step in actions:
        os.makedirs(tmp_path / "weights" / str(step))
    os.makedirs(tmp_path / "weights" / "not_a_step")
    seen = []
    for mod in (JE, PE):
        agent = _ScriptedAgent(actions)
        csv_path = str(tmp_path / f"{mod.__name__}.csv")
        best, row = mod.select_best_checkpoint(agent, str(tmp_path / "weights"), val,
                                               "right", csv_path=csv_path)
        errs = mod.open_loop_errors(agent, val, "right")
        seen.append((best, row, agent.loaded, errs, open(csv_path).read()))
    assert seen[1] == seen[0]
    assert seen[1][0] == 4000 and seen[1][2][-1] == 4000  # the winner is left loaded
