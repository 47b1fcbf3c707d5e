"""Nothing the benchmark runs loads JAX, flax, optax or the JAX package
(names compared whole, by their part before the first dot: the port's
``voxactb_tpu_torch`` is not ``voxactb_tpu``), and the plain reference
loads nothing of the port."""

import json
import subprocess
import sys

from conftest import CELLS, REPO, tiny

HARNESS = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from portbench import control, run
from portbench.harness import core
for path in sorted((core.ROOT / "metrics").glob("*.py")) + sorted((core.ROOT / "entries").glob("*.py")):
    core.load_module(path, "m_" + path.stem.replace(".", "_"))
for cell, ov in json.loads({cells!r}).items():
    core.run(core.Context(cell, 1, 0.2, True, device="cpu", overrides=ov))
print(json.dumps(core.forbidden_modules()))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {repo!r})
from portbench.reference import prep, qnet, train
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def run_code(code):
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax():
    cells = json.dumps({c: tiny(c) for c in CELLS})
    assert run_code(HARNESS.format(repo=REPO.as_posix(), cells=cells)) == []


def test_reference_loads_nothing_of_the_port():
    top = set(run_code(REFERENCE.format(repo=REPO.as_posix())))
    assert not top & {"voxactb_tpu_torch", "voxactb_tpu", "jax", "jaxlib", "flax", "optax"}
    assert "portbench" in top and "torch" in top
