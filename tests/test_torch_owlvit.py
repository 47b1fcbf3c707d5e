"""OWL-ViT (voxactb_tpu_torch/models/owlvit.py) against the JAX package's on
the same flax parameters: the detector at f32 and bf16, and the pipeline's
detect on frames that the resize to the tower's input grows and shrinks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.models.owlvit import OwlViTDetector as JaxDetector
from voxactb_tpu.models.owlvit import OwlViTImageEncoder as JaxImageEncoder
from voxactb_tpu.models.owlvit import OwlViTPipeline as JaxPipeline
from voxactb_tpu_torch.models.owlvit import (
    OwlViTDetector, OwlViTImageEncoder, OwlViTPipeline)
from voxactb_tpu_torch.weights import load_flax_params

TOWER = dict(img_size=64, patch=16, dim=32, depth=2, heads=2)
EMBED = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_detector(dtype=jnp.float32):
    return JaxDetector(embed_dim=EMBED, image_encoder=JaxImageEncoder(**TOWER, dtype=dtype),
                       dtype=dtype)


def _detector(dtype=torch.float32):
    return OwlViTDetector(embed_dim=EMBED, image_encoder=OwlViTImageEncoder(**TOWER,
                                                                            dtype=dtype),
                          dtype=dtype)


@pytest.fixture(scope="module")
def owl():
    """Flax parameters of the tiny detector (the box head's last layer scaled
    up so that boxes move away from their grid cells) and two text embeddings."""
    rng = np.random.default_rng(0)
    txt = rng.normal(size=(2, EMBED)).astype(np.float32)
    params = _jax_detector().init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                                  jnp.asarray(txt))
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["box_dense2"]["kernel"] = params["params"]["box_dense2"]["kernel"] * 20
    return params, txt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_detector_matches_jax(owl, dtype):
    params, txt = owl
    img = np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    ref_logits, ref_boxes = (np.asarray(a) for a in _jax_detector(
        getattr(jnp, dtype)).apply(params, jnp.asarray(img), jnp.asarray(txt)))
    det = _detector(getattr(torch, dtype))
    load_flax_params(det, params)
    with torch.no_grad():
        logits, boxes = (a.numpy() for a in det(torch.tensor(img), torch.tensor(txt)))
    assert logits.shape == (1, 16, 2) and boxes.shape == (1, 16, 4)
    # f32: sums in another order; bf16: the same rounding points, and a value
    # on a bf16 rounding boundary may round the other way (two ulps of the
    # largest value)
    rel = 1e-5 if dtype == "float32" else 2.0 ** -7
    for got, ref in ((logits, ref_logits), (boxes, ref_boxes)):
        np.testing.assert_allclose(got, ref, atol=rel * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("frame", [(48, 80), (100, 90)])
def test_pipeline_detect_matches_jax(owl, frame):
    """A 48x80 frame grows to the tower's 64x64 input (plain bilinear); a
    100x90 frame shrinks to it, where jax.image.resize applies its triangle
    (antialiasing) filter."""
    params, txt = owl
    rgb = np.random.default_rng(2).integers(0, 255, frame + (3,)).astype(np.uint8)
    ref_box, ref_score = JaxPipeline(_jax_detector(), params, img_size=64).detect(
        rgb, txt, score_threshold=0.0)
    det = _detector()
    load_flax_params(det, params)
    box, score = OwlViTPipeline(det, img_size=64).detect(rgb, txt, score_threshold=0.0)
    # boxes in pixels: the box head's f32 outputs in [0, 1] (sums in another
    # order through the scaled last layer and a sigmoid) times the frame size
    np.testing.assert_allclose(box, ref_box, atol=1e-5 * max(frame), rtol=0)
    assert abs(score - ref_score) < 1e-6
    with pytest.raises(ValueError, match="no detection"):
        OwlViTPipeline(det, img_size=64).detect(rgb, txt, score_threshold=1.1)
