"""URScript program generation for UR arms.

Counterpart of the command layer in urx (urx/urrobot.py, 612 LoC): the reference
formats URScript strings and ships them over the secondary interface. Same approach,
as composable functions instead of a god-object, plus the Robotiq two-finger gripper
activation/actuation programs (urx/robotiq_two_finger_gripper.py:1-216 behavior).

A copy of ``voxactb_tpu.realrobot.urscript``, kept in the port so that it imports nothing
of the JAX package; host code, the same on every device.
"""

from __future__ import annotations

from typing import Iterable, Sequence


def _fmt(vals: Iterable[float]) -> str:
    return ", ".join(f"{v:.6f}" for v in vals)


def movel(pose: Sequence[float], acc: float = 0.01, vel: float = 0.01,
          t: float = 0.0, radius: float = 0.0) -> str:
    """Linear move in tool space; pose = [x y z rx ry rz] (axis-angle)."""
    return (f"movel(p[{_fmt(pose)}], a={acc:.6f}, v={vel:.6f}, t={t:.6f}, "
            f"r={radius:.6f})")


def movej(joints: Sequence[float], acc: float = 0.1, vel: float = 0.05,
          t: float = 0.0, radius: float = 0.0) -> str:
    return (f"movej([{_fmt(joints)}], a={acc:.6f}, v={vel:.6f}, t={t:.6f}, "
            f"r={radius:.6f})")


def movec(pose_via: Sequence[float], pose_to: Sequence[float], acc: float = 0.01,
          vel: float = 0.01, radius: float = 0.0) -> str:
    return (f"movec(p[{_fmt(pose_via)}], p[{_fmt(pose_to)}], a={acc:.6f}, "
            f"v={vel:.6f}, r={radius:.6f})")


def speedl(velocities: Sequence[float], acc: float = 0.01,
           min_time: float = 1.0) -> str:
    return f"speedl([{_fmt(velocities)}], a={acc:.6f}, t_min={min_time:.6f})"


def speedj(velocities: Sequence[float], acc: float = 0.1,
           min_time: float = 1.0) -> str:
    return f"speedj([{_fmt(velocities)}], a={acc:.6f}, t_min={min_time:.6f})"


def stopl(acc: float = 0.5) -> str:
    return f"stopl({acc:.6f})"


def stopj(acc: float = 1.5) -> str:
    return f"stopj({acc:.6f})"


def set_tcp(pose: Sequence[float]) -> str:
    return f"set_tcp(p[{_fmt(pose)}])"


def set_payload(weight: float, cog: Sequence[float] = (0, 0, 0)) -> str:
    return f"set_payload({weight:.6f}, ({_fmt(cog)}))"


def set_digital_out(port: int, value: bool) -> str:
    return f"digital_out[{port}]={'True' if value else 'False'}"


def freedrive_mode(enable: bool = True) -> str:
    return "set robotmode freedrive" if enable else "set robotmode run"


# -- Robotiq two-finger gripper (driven through the UR controller's tool port) ------

ROBOTIQ_HEADER = """\
def rq_prog():
  socket_close("gripper_socket")
  socket_open("127.0.0.1", 63352, "gripper_socket")
"""


def robotiq_program(commands: Sequence[str]) -> str:
    """Wrap gripper register writes into a runnable URScript program."""
    body = "\n".join(f"  {c}" for c in commands)
    return f"{ROBOTIQ_HEADER}{body}\n  socket_close(\"gripper_socket\")\nend\n"


def robotiq_activate() -> str:
    return robotiq_program([
        'socket_set_var("ACT", 1, "gripper_socket")',
        "sync()",
        'socket_set_var("GTO", 1, "gripper_socket")',
        "sync()",
    ])


def robotiq_set_position(pos_0_255: int, speed: int = 255, force: int = 150) -> str:
    pos = max(0, min(255, int(pos_0_255)))
    return robotiq_program([
        f'socket_set_var("SPE", {int(speed)}, "gripper_socket")',
        f'socket_set_var("FOR", {int(force)}, "gripper_socket")',
        f'socket_set_var("POS", {pos}, "gripper_socket")',
        "sync()",
    ])


def robotiq_open() -> str:
    return robotiq_set_position(0)


def robotiq_close() -> str:
    return robotiq_set_position(255)
