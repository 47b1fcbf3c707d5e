"""Task smoke validation.

Counterpart of RLBench's ``task_validator.py`` ``task_smoke`` (run by
tests/unit/test_tasks.py:20-55 over the whole task set): for each variation, run the
task's scripted demo and assert the success conditions fire, plus basic contract
checks (descriptions, target object, waypoint arms).
"""

from __future__ import annotations

from typing import Dict, List, Type

from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment
from voxactb_tpu_torch.sim.task import BimanualTask


class TaskValidationError(AssertionError):
    pass


def task_smoke(task_cls: Type[BimanualTask], variations: int = -1,
               demos_per_variation: int = 1, **env_kw) -> Dict:
    env = BimanualTaskEnvironment(task_cls, **env_kw)
    env.launch()
    n_var = task_cls.num_variations if variations == -1 else variations
    report = {"task": task_cls.name, "variations": n_var, "successes": 0}
    for v in range(n_var):
        for d in range(demos_per_variation):
            # reset_to_demo sets variation = demo_index % num_variations, so
            # the index must be v-congruent — v*100+d collapsed every task
            # onto variation (v*100)%n and never exercised the others
            frames, descriptions = env.get_demo(
                d * task_cls.num_variations + v)
            if not descriptions or not descriptions[0]:
                raise TaskValidationError(f"{task_cls.name}: empty description")
            if len(frames) < 5:
                raise TaskValidationError(
                    f"{task_cls.name}: demo produced only {len(frames)} frames")
            wps = env.task.get_waypoints(env.task.dominant_arm())
            arms = {w.arm for w in wps}
            if task_cls.bimanual and arms != {"right", "left"}:
                raise TaskValidationError(
                    f"{task_cls.name}: waypoints must use both arms, got {arms}")
            if not task_cls.bimanual and len(arms) != 1:
                raise TaskValidationError(
                    f"{task_cls.name}: single-arm task must use one arm, got {arms}")
            if not env.task.success():
                raise TaskValidationError(
                    f"{task_cls.name} v{v}: scripted demo did not reach success")
            report["successes"] += 1
    return report


def validate_all(**env_kw) -> List[Dict]:
    from voxactb_tpu_torch.sim.tasks import TASK_REGISTRY

    return [task_smoke(cls, **env_kw) for cls in TASK_REGISTRY.values()]
