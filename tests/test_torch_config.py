"""The port's configuration tree against the JAX package's: the same defaults,
the same dotted overrides, and a ``config.json`` that crosses both ways."""

import dataclasses
import json

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _groups():
    from voxactb_tpu import config as J
    from voxactb_tpu_torch import config as T

    return [(getattr(J, n), getattr(T, n)) for n in (
        "MethodConfig", "ReplayConfig", "RLBenchConfig", "FrameworkConfig",
        "DDPConfig", "Config")]


@pytest.mark.parametrize("index", range(6))
def test_defaults_equal_the_jax_package(index):
    jax_cls, port_cls = _groups()[index]
    assert [f.name for f in dataclasses.fields(port_cls)] == \
        [f.name for f in dataclasses.fields(jax_cls)]
    assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())


def test_override_and_unknown_keys():
    from voxactb_tpu.config import Config as JaxConfig
    from voxactb_tpu_torch.config import Config

    over = {"method.lr": 1e-4, "method.voxel_sizes": [50], "replay.batch_size": 8,
            "rlbench.cameras": ["front"], "framework.left_arm_ckpt": "x.pt", "seed": 3}
    base = Config()
    cfg = base.override(**over)
    assert cfg.to_dict() == JaxConfig().override(**over).to_dict()
    # the original is untouched (override deep-copies the groups)
    assert base.method.lr == 0.0005 and base.replay.batch_size == 1
    with pytest.raises(KeyError, match="unknown config key"):
        base.override(**{"method.no_such_flag": 1})
    with pytest.raises(KeyError):
        base.override(**{"framework.pallas_front": True})


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_config_json_crosses_both_ways(tmp_path, direction):
    from voxactb_tpu.config import Config as JaxConfig
    from voxactb_tpu_torch.config import Config

    over = {"method.which_arm": "dominant", "method.compute_dtype": "bfloat16",
            "method.pallas_front": True, "method.crop_radius": 0.3,
            "rlbench.camera_resolution": [64, 64], "ddp.mesh_axes": ("dp", "tp"),
            "framework.eval_type": "best", "log_dir": str(tmp_path / "logs")}
    writer, reader = (JaxConfig, Config) if direction == "jax_to_port" else (Config, JaxConfig)
    path = tmp_path / "config.json"
    src = writer().override(**over)
    src.save(str(path))
    loaded = reader.load(str(path))
    assert type(loaded) is reader
    assert loaded.to_dict() == src.to_dict()
    assert loaded.ddp.mesh_axes == ("dp", "tp")
    assert json.loads(path.read_text())["method"]["pallas_front"] is True
