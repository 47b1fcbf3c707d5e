"""Scaffold + validate new bimanual tasks.

Counterpart of RLBench's interactive authoring shells (tools/task_builder.py and
task_builder_two_arms.py:397): ``new`` writes a task-class skeleton wired into the
framework's contract, ``validate`` runs the task_smoke protocol over it (or over every
registered task).

The port's counterpart of ``tools/task_builder.py``: the same template, on
the port's sim.

Usage:
  python3 -m voxactb_tpu_torch.tools.task_builder new --name stack_cups \
      --out voxactb_tpu_torch/sim/custom
  python3 -m voxactb_tpu_torch.tools.task_builder validate --task open_jar
  python3 -m voxactb_tpu_torch.tools.task_builder validate --all
"""

from __future__ import annotations

import argparse
import importlib.util
import os

TEMPLATE = '''"""Custom bimanual task: {name}."""

from typing import List

import numpy as np

from voxactb_tpu_torch.sim.backend import SceneObject
from voxactb_tpu_torch.sim.conditions import GraspedCondition
from voxactb_tpu_torch.sim.task import BimanualTask, Waypoint

TABLE_Z = 0.76
DOWN = np.array([0.0, 1.0, 0.0, 0.0])


class {cls}(BimanualTask):
    name = "{name}"
    num_variations = 2

    def init_task(self) -> None:
        pass

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        side = -1.0 if variation % 2 == 0 else 1.0
        pos = np.array([rng.uniform(0.2, 0.4),
                        side * rng.uniform(0.1, 0.3), TABLE_Z + 0.02])
        self.backend.add_object(SceneObject("target", pos))
        self._dominant = "right" if side < 0 else "left"
        self.register_success_conditions([
            GraspedCondition("target", self._dominant),
        ])
        return ["{desc} with the " + self._dominant + " hand"]

    def target_object_name(self):
        return "target"

    def dominant_arm(self) -> str:
        return self._dominant

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        obj = self.backend.get_object("target")
        a = "left" if dominant_arm == "right" else "right"
        return [
            Waypoint(a, obj.position + [0, 0, 0.15], DOWN, 1.0, label="watch"),
            Waypoint(dominant_arm, obj.position + [0, 0, 0.10], DOWN, 1.0,
                     label="approach"),
            Waypoint(dominant_arm, obj.position, DOWN, 0.0, label="grasp"),
            Waypoint(dominant_arm, obj.position + [0, 0, 0.2], DOWN, None,
                     label="lift"),
        ]
'''


def cmd_new(args):
    cls = "".join(p.capitalize() for p in args.name.split("_"))
    os.makedirs(args.out, exist_ok=True)
    init_py = os.path.join(args.out, "__init__.py")
    if not os.path.exists(init_py):
        open(init_py, "w").close()
    path = os.path.join(args.out, f"{args.name}.py")
    if os.path.exists(path) and not args.force:
        raise SystemExit(f"{path} exists (use --force)")
    with open(path, "w") as f:
        f.write(TEMPLATE.format(name=args.name, cls=cls,
                                desc=args.name.replace("_", " ")))
    print(f"wrote {path}; validate with:\n"
          f"  python3 -m voxactb_tpu_torch.tools.task_builder validate --file {path}")


def _load_task_cls(path: str):
    from voxactb_tpu_torch.sim.task import BimanualTask

    spec = importlib.util.spec_from_file_location("custom_task", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for v in vars(mod).values():
        if (isinstance(v, type) and issubclass(v, BimanualTask)
                and v is not BimanualTask):
            return v
    raise SystemExit(f"no BimanualTask subclass found in {path}")


def cmd_validate(args):
    """Print the task_smoke report of one task (or of every registered one);
    returns the reports."""
    from voxactb_tpu_torch.sim.tasks import TASK_REGISTRY
    from voxactb_tpu_torch.sim.validator import task_smoke, validate_all

    if args.all:
        reports = validate_all(image_size=args.image_size)
        for report in reports:
            print(report)
        return reports
    if args.file:
        cls = _load_task_cls(args.file)
    else:
        cls = TASK_REGISTRY[args.task]
    report = task_smoke(cls, image_size=args.image_size)
    print(report)
    return [report]


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_new = sub.add_parser("new")
    p_new.add_argument("--name", required=True)
    p_new.add_argument("--out", default="voxactb_tpu_torch/sim/custom")
    p_new.add_argument("--force", action="store_true")
    p_val = sub.add_parser("validate")
    p_val.add_argument("--task")
    p_val.add_argument("--file")
    p_val.add_argument("--all", action="store_true")
    p_val.add_argument("--image-size", type=int, default=16)
    args = ap.parse_args(argv)
    return {"new": cmd_new, "validate": cmd_validate}[args.cmd](args)


if __name__ == "__main__":
    main()
