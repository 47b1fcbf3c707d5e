"""The harness is driven by its files: a copy of ``portbench/`` with a new
cell file, a new traffic file and a new metric file, and their entries in
``BENCHMARK.json``, runs the new cell and reports the new metric, with no
other file edited."""

import json
import shutil
import subprocess
import sys

from conftest import REPO, tiny

NEW_METRIC = '''"""Acts completed in the traced run's window (a test metric)."""


def read(record):
    return float(record["samples"])
'''

DRIVER = """
import json, sys
sys.path[:0] = [{copy!r}, {repo!r}]
import torch
torch.set_num_threads(2)
from portbench import run
assert run.REPO.as_posix() == {copy!r}, run.REPO
bench = json.load(open({copy!r} + "/BENCHMARK.json"))
out = run.report(bench, "scene100_extra_b1", 3, 0.3, True, device="cpu",
                 overrides=json.loads({overrides!r}))
print(json.dumps(out))
"""


def test_new_cell_and_metric_are_files(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(REPO / "portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", copy / "BENCHMARK.json")
    pb = copy / "portbench"
    cell = json.loads((pb / "workloads" / "scene100_act_b1.json").read_text())
    cell["traffic"] = "scene_extra_b1"
    (pb / "workloads" / "scene100_extra_b1.json").write_text(json.dumps(cell))
    traffic = json.loads((pb / "traffic" / "scene_acts_b1.json").read_text())
    traffic["points_low"] = [0.0, 0.0, 0.5]
    (pb / "traffic" / "scene_extra_b1.json").write_text(json.dumps(traffic))
    (pb / "metrics" / "acts_done.latency.py").write_text(NEW_METRIC)
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "scene100_extra_b1", "config": "peract_scene100",
                               "traffic": "scene_extra_b1", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "act_ms_p95":
            m["workloads"].append("scene100_extra_b1")
    bench["per_layer"].append({"name": "acts_done.latency", "unit": "acts", "better": "higher",
                               "source": "host_clock", "layer": "agent host path",
                               "moves": "act_ms_p95", "workloads": ["scene100_extra_b1"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p.relative_to(REPO / "portbench").as_posix(): p.read_bytes()
              for p in (REPO / "portbench").rglob("*") if p.is_file()
              and "__pycache__" not in p.parts and "tests" not in p.parts}

    code = DRIVER.format(copy=copy.as_posix(), repo=REPO.as_posix(),
                         overrides=json.dumps(tiny("scene100_act_b1")))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["metrics"]["acts_done.latency"]["value"] >= 1
    assert set(out["checks"]) == {"q_err", "gap", "decode_err"}
    for rel, data in before.items():  # every file that was there is unchanged
        assert (pb / rel).read_bytes() == data, rel
