"""Simulation benchmark framework: task contract, scene orchestration, action modes.

The RLBench-layer counterpart (SURVEY §2.3) redesigned around a pluggable
``SimBackend``: the shipped ``KinematicBackend`` runs everywhere (no CoppeliaSim) and
supports task authoring, scripted bimanual demo generation, observation rendering and
success evaluation; a PyRep/CoppeliaSim adapter can implement the same protocol where
the simulator exists.
"""

from voxactb_tpu_torch.sim.backend import KinematicBackend, SimBackend  # noqa: F401
from voxactb_tpu_torch.sim.task import BimanualTask, Waypoint  # noqa: F401
from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment, SimEnvironment  # noqa: F401
