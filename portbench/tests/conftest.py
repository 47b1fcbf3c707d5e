"""Tests of the port's benchmark. They import neither JAX nor the JAX
package. CPU tests run the harness at tiny widths with the kernels' plain
versions; tests marked ``card`` need a CUDA device and skip without one.

    python -m pytest portbench/tests -q
"""

import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# tiny widths for the CPU: every cell's own files, with these keys replaced
TINY = {"method": {"voxel_sizes": [10], "num_latents": 16, "latent_dim": 32,
                   "transformer_depth": 1, "cross_dim_head": 16, "latent_heads": 2,
                   "latent_dim_head": 16},
        "traffic": {"image": 16, "pool": 16},
        "cell": {"check_samples": 2, "trace_units": 2, "warm_units": 1}}
TINY_TRAFFIC = {"scene100_act_b8": {"batch": 2}, "crop50_dual_b1": {"episode_length": 4}}
CELLS = ("crop50_train_b8", "scene100_act_b8", "crop50_dual_b1", "scene100_act_b1")


def tiny(cell: str, **method) -> dict:
    """The overrides that run ``cell`` at tiny widths."""
    out = json.loads(json.dumps(TINY))
    out["traffic"].update(TINY_TRAFFIC.get(cell, {}))
    out["method"].update(method)
    return out


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `python -m pytest portbench/tests -m card` "
                    "on a machine with an H100")
    return "cuda"


@pytest.fixture
def bench():
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)
