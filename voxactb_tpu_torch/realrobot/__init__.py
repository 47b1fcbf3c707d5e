"""Real-robot stack: UR arm protocol clients, Robotiq gripper, bimanual robot env."""

from voxactb_tpu_torch.realrobot.robot import URRobot, BimanualURRobot  # noqa: F401
