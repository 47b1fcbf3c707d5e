"""UR controller state monitors over TCP.

Counterparts of urx's ``SecondaryMonitor`` (urx/ursecmon.py:239-443 — port 30002,
parses the secondary-interface packet stream and dispatches URScript programs) and the
125 Hz ``URRTMonitor`` (urx/urrtmon.py:2-403 — port 30003 fixed-layout double arrays).

Packet formats (public UR interface):
- secondary: stream of messages [int32 total_size, uint8 msg_type, payload];
  RobotStateMessage (type 16) payload is a sequence of subpackages
  [int32 size, uint8 subtype, data] — we parse RobotModeData (0), JointData (1,
  per-joint 41-byte records) and CartesianInfo (4, six doubles of TCP pose).
- realtime: one message per cycle, [int32 size] then big-endian doubles; offsets
  (in doubles, after the size word) 1+6*5=31 for q_actual, 55 for tool pose on the
  1044/1108-byte CB3 layouts; the 812-byte CB2 layout has q_actual at 31 as well.

A copy of ``voxactb_tpu.realrobot.monitor``, kept in the port so that it imports nothing
of the JAX package; host code, the same on every device.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class RobotState:
    timestamp: float = 0.0
    robot_mode: int = 0
    is_power_on: bool = False
    is_emergency_stopped: bool = False
    is_program_running: bool = False
    joint_positions: np.ndarray = field(default_factory=lambda: np.zeros(6))
    joint_velocities: np.ndarray = field(default_factory=lambda: np.zeros(6))
    tcp_pose: np.ndarray = field(default_factory=lambda: np.zeros(6))  # x y z rx ry rz


class SecondaryMonitor:
    """Port-30002 client: background state parsing + program dispatch."""

    PORT = 30002
    ROBOT_STATE_MSG = 16

    def __init__(self, host: str, port: Optional[int] = None, connect: bool = True):
        self._host = host
        self._port = port or self.PORT
        self._sock: Optional[socket.socket] = None
        self._state = RobotState()
        self._state_lock = threading.Lock()
        self._send_lock = threading.Lock()
        self._stop = threading.Event()
        self._fresh = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if connect:
            self.connect()

    # -- lifecycle ------------------------------------------------------------------

    def connect(self, timeout: float = 5.0) -> None:
        self._sock = socket.create_connection((self._host, self._port), timeout)
        self._sock.settimeout(1.0)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
        if self._sock:
            try:
                self._sock.close()
            except OSError:
                pass

    # -- program dispatch (ursecmon.py send_program behavior) -------------------------

    def send_program(self, program: str) -> None:
        data = program.strip() + "\n"
        with self._send_lock:
            self._sock.sendall(data.encode("utf-8"))

    # -- state ------------------------------------------------------------------------

    def get_state(self, wait: bool = False, timeout: float = 2.0) -> RobotState:
        if wait:
            self._fresh.clear()
            if not self._fresh.wait(timeout):
                raise TimeoutError("no fresh robot state received")
        with self._state_lock:
            return RobotState(**vars(self._state))

    def running(self) -> bool:
        return self.get_state().is_program_running

    # -- parser -------------------------------------------------------------------------

    def _run(self) -> None:
        buf = b""
        while not self._stop.is_set():
            try:
                chunk = self._sock.recv(4096)
            except socket.timeout:
                continue
            except OSError:
                break
            if not chunk:
                break
            buf += chunk
            while len(buf) >= 5:
                (size,) = struct.unpack(">i", buf[:4])
                if size < 5 or size > 10 ** 7:
                    buf = buf[1:]  # resync
                    continue
                if len(buf) < size:
                    break
                self._parse_message(buf[4:size])
                buf = buf[size:]

    def _parse_message(self, payload: bytes) -> None:
        msg_type = payload[0]
        if msg_type != self.ROBOT_STATE_MSG:
            return
        body = payload[1:]
        state = RobotState(timestamp=time.time())
        while len(body) >= 5:
            (sub_size,) = struct.unpack(">i", body[:4])
            if sub_size < 5 or sub_size > len(body):
                break
            subtype = body[4]
            data = body[5:sub_size]
            if subtype == 0 and len(data) >= 16:  # RobotModeData
                # uint64 timestamp, bools: connected, enabled, power_on, e-stop,
                # security_stop, program_running, program_paused
                state.is_power_on = bool(data[10])
                state.is_emergency_stopped = bool(data[11])
                state.is_program_running = bool(data[13])
                state.robot_mode = data[15]
            elif subtype == 1:  # JointData: 6 records of 41 bytes
                q, qd = [], []
                rec = 41
                for j in range(6):
                    if len(data) < (j + 1) * rec:
                        break
                    qj, qj_target, qdj = struct.unpack_from(">ddd", data, j * rec)
                    q.append(qj)
                    qd.append(qdj)
                if len(q) == 6:
                    state.joint_positions = np.array(q)
                    state.joint_velocities = np.array(qd)
            elif subtype == 4 and len(data) >= 48:  # CartesianInfo
                state.tcp_pose = np.array(struct.unpack_from(">6d", data, 0))
            body = body[sub_size:]
        with self._state_lock:
            self._state = state
        self._fresh.set()


class RealtimeMonitor:
    """Port-30003 client: fixed-layout 125 Hz state stream (urrtmon.py:2-403)."""

    PORT = 30003
    Q_ACTUAL_OFFSET = 31   # doubles after the size word
    TCP_OFFSET = 55        # tool_vector_actual on CB3 layouts

    def __init__(self, host: str, port: Optional[int] = None, connect: bool = True):
        self._host = host
        self._port = port or self.PORT
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._q = np.zeros(6)
        self._tcp = np.zeros(6)
        self._timestamp = 0.0
        self._thread: Optional[threading.Thread] = None
        if connect:
            self.connect()

    def connect(self, timeout: float = 5.0) -> None:
        self._sock = socket.create_connection((self._host, self._port), timeout)
        self._sock.settimeout(1.0)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
        if self._sock:
            try:
                self._sock.close()
            except OSError:
                pass

    def _run(self) -> None:
        buf = b""
        while not self._stop.is_set():
            try:
                chunk = self._sock.recv(4096)
            except socket.timeout:
                continue
            except OSError:
                break
            if not chunk:
                break
            buf += chunk
            while len(buf) >= 4:
                (size,) = struct.unpack(">i", buf[:4])
                if size < 4 or size > 65536:
                    buf = buf[1:]
                    continue
                if len(buf) < size:
                    break
                self._parse(buf[4:size])
                buf = buf[size:]

    def _parse(self, payload: bytes) -> None:
        n_doubles = len(payload) // 8
        if n_doubles < self.Q_ACTUAL_OFFSET + 6:
            return
        doubles = struct.unpack(f">{n_doubles}d", payload[: n_doubles * 8])
        with self._lock:
            # doubles[0] is the controller time; q_actual occupies doubles
            # [31:37] (1 time + 5 six-vectors before it), tool pose [55:61]
            self._timestamp = doubles[0]
            self._q = np.array(doubles[self.Q_ACTUAL_OFFSET:
                                       self.Q_ACTUAL_OFFSET + 6])
            if n_doubles >= self.TCP_OFFSET + 6:
                self._tcp = np.array(doubles[self.TCP_OFFSET:
                                             self.TCP_OFFSET + 6])

    def q_actual(self) -> np.ndarray:
        with self._lock:
            return self._q.copy()

    def tcp_pose(self) -> np.ndarray:
        with self._lock:
            return self._tcp.copy()

    def timestamp(self) -> float:
        with self._lock:
            return self._timestamp
