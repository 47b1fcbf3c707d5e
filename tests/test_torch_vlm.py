"""The VLM crop path of the port end to end on the CPU, against the JAX
package's on the same flax parameters: the host-only geometry copied from
voxactb_tpu/vlm/pipeline.py; then, at f32, VLM(TorchOwlVitSamDetector) against
VLM(JaxOwlVitSamDetector) on the tests/test_vlm.py scene (crop point and
radius), and the act inside the derived bounds with CLIP-text embeddings of
the task description (exact integer actions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_infer import TINY, random_params
from voxactb_tpu.agents.qattention_agent import QAttentionBCAgent as JaxAgent
from voxactb_tpu.config import MethodConfig as JaxMethodConfig
from voxactb_tpu.models.clip_text import ClipLanguageEncoder as JaxLanguageEncoder
from voxactb_tpu.models.clip_text import ClipTextEncoder as JaxTextEncoder
from voxactb_tpu.models.owlvit import OwlViTDetector as JaxDetector
from voxactb_tpu.models.owlvit import OwlViTImageEncoder as JaxImageEncoder
from voxactb_tpu.models.owlvit import OwlViTPipeline as JaxPipeline
from voxactb_tpu.models.sam_decoder import SamMaskDecoder as JaxDecoder
from voxactb_tpu.models.sam_decoder import SamSegmenter as JaxSegmenter
from voxactb_tpu.models.sam_encoder import SamImageEncoder as JaxEncoder
from voxactb_tpu.ops.geometry import scene_bounds_from_crop as jax_bounds
from voxactb_tpu.vlm import pipeline as JP
from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
from voxactb_tpu_torch.config import MethodConfig
from voxactb_tpu_torch.models.clip_text import ClipLanguageEncoder, ClipTextEncoder
from voxactb_tpu_torch.models.owlvit import OwlViTDetector, OwlViTImageEncoder, OwlViTPipeline
from voxactb_tpu_torch.models.sam_decoder import SamMaskDecoder, SamSegmenter
from voxactb_tpu_torch.models.sam_encoder import SamImageEncoder
from voxactb_tpu_torch.ops.geometry import scene_bounds_from_crop
from voxactb_tpu_torch.vlm import pipeline as P
from voxactb_tpu_torch.weights import load_flax_params

TASK = "open_drawer"
OWL = dict(img_size=64, patch=16, dim=32, depth=2, heads=2)
TEXT = dict(layers=2, width=32, heads=2, embed_dim=16)
SAM = dict(img_size=64, patch_size=8, embed_dim=32, depth=2, num_heads=2, window_size=2,
           global_attn_indexes=(1,), out_chans=32)
DECODER = dict(dim=32, heads=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def scene(rng, h=32, w=32, obj_center=(0.2, -0.1, 0.9), obj_size=0.06):
    """tests/test_vlm.py's scene, with the object's pixels in the task colour."""
    pcd = rng.uniform(-1, 1, (h, w, 3)).astype(np.float32)
    pcd[..., 2] += 1.0
    mask = np.zeros((h, w), bool)
    mask[5:15, 5:15] = True
    pcd[mask] = np.asarray(obj_center) + rng.uniform(
        -obj_size / 2, obj_size / 2, (mask.sum(), 3)).astype(np.float32)
    rgb = rng.integers(0, 60, (h, w, 3)).astype(np.uint8)
    rgb[mask] = P.TASK_COLORS[TASK].astype(np.uint8)
    return rgb, pcd, mask


@pytest.mark.parametrize("task,size", [("open_drawer", 0.06), ("open_jar", 0.06),
                                       ("open_jar", 0.5)])
def test_crop_point_from_mask_is_the_jax_packages(task, size):
    _, pcd, mask = scene(np.random.default_rng(0), obj_size=size)
    point, radius = P.crop_point_from_mask(mask, pcd, task)
    ref_point, ref_radius = JP.crop_point_from_mask(mask, pcd, task)
    np.testing.assert_array_equal(point, ref_point)
    assert radius == ref_radius
    with pytest.raises(ValueError, match="empty object mask"):
        P.crop_point_from_mask(np.zeros_like(mask), pcd, task)
    assert P.task_queries(task) == JP.task_queries(task)
    rgb, _, _ = scene(np.random.default_rng(0))
    np.testing.assert_array_equal(P.ColorDetector(TASK)(rgb, "x"),
                                  JP.ColorDetector(TASK)(rgb, "x"))


def _jit_init(module, *args):
    return jax.tree_util.tree_map(np.asarray, jax.jit(module.init)(jax.random.key(0), *args))


def _loaded(module, params):
    load_flax_params(module, params)
    return module.eval()


@pytest.fixture(scope="module")
def detectors():
    """The JAX and the port's OWL-ViT + SAM detectors on the same parameters."""
    jdet = JaxDetector(embed_dim=16, image_encoder=JaxImageEncoder(**OWL))
    det_p = _jit_init(jdet, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 16)))
    det_p["params"]["box_dense2"]["kernel"] = det_p["params"]["box_dense2"]["kernel"] * 10
    jtext = JaxTextEncoder(**TEXT)
    text_p = _jit_init(jtext, jnp.zeros((1, 77), jnp.int32))
    jenc = JaxEncoder(**SAM)
    enc_p = _jit_init(jenc, jnp.zeros((1, 64, 64, 3)))
    jdec = JaxDecoder(**DECODER)
    dec_p = _jit_init(jdec, jnp.zeros((1, 8, 8, 32)), jnp.zeros((1, 4)))
    ref = JP.JaxOwlVitSamDetector(
        JaxPipeline(jdet, det_p, jtext, text_p, img_size=64),
        JaxSegmenter(jenc, enc_p, jdec, dec_p, img_size=64), score_threshold=0.0)
    got = P.TorchOwlVitSamDetector(
        OwlViTPipeline(_loaded(OwlViTDetector(16, OwlViTImageEncoder(**OWL)), det_p),
                       _loaded(ClipTextEncoder(**TEXT), text_p), img_size=64),
        SamSegmenter(_loaded(SamImageEncoder(**SAM), enc_p),
                     _loaded(SamMaskDecoder(**DECODER), dec_p), img_size=64),
        score_threshold=0.0)
    return ref, got


def test_vlm_crop_then_act_matches_jax(detectors):
    ref_det, det = detectors
    rgb, pcd, _ = scene(np.random.default_rng(1))
    ref_point, ref_radius = JP.VLM(ref_det).get_target_object_world_coords(rgb, pcd, TASK)
    point, radius = P.VLM(det).get_target_object_world_coords(rgb, pcd, TASK)
    np.testing.assert_allclose(point, ref_point, atol=1e-5, rtol=0)
    assert radius == ref_radius
    bounds = scene_bounds_from_crop(point, radius).numpy()
    np.testing.assert_allclose(bounds, np.asarray(jax_bounds(ref_point, ref_radius)),
                               atol=1e-5, rtol=0)

    # the acting policy inside those bounds, language from CLIP-text tokens
    kw = dict(TINY, which_arm="dominant", arm_pred_loss=True)
    params = random_params(kw, 0)
    jlang = JaxLanguageEncoder()
    lang = ClipLanguageEncoder(params=jax.tree_util.tree_map(np.asarray, jlang._params),
                               device="cpu")
    cams = ["wrist", "wrist2"]
    jagent = JaxAgent(JaxMethodConfig(**kw), cams, bounds, lang_encoder=jlang)
    jagent.build(training=False)
    jagent.params = params
    agent = QAttentionBCAgent(MethodConfig(**kw), cams, bounds, lang_encoder=lang,
                              device="cpu")
    agent.build(training=False)
    agent.params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(2)
    obs = {"lang_goal_tokens": lang.tokenize("open the bottom drawer")[0],
           "low_dim_state_left_arm": np.asarray([1.0, 0.02, 0.01, 0.5], np.float32),
           "low_dim_state_right_arm": np.asarray([0.0, 0.03, 0.04, 0.5], np.float32)}
    for cam in cams:
        obs[f"{cam}_rgb"] = rng.integers(0, 255, (16, 16, 3)).astype(np.float32)
        obs[f"{cam}_point_cloud"] = (bounds[:3] + rng.uniform(0, 1, (16, 16, 3))
                                     * (bounds[3:] - bounds[:3])).astype(np.float32)
    args = dict(which_arm="dominant", new_scene_bounds=bounds, dominant_assitive_policy=True)
    ref = jagent.act(0, obs, **args)
    got = agent.act(0, obs, **args)
    for key in ("trans_action_indicies", "rot_grip_action_indicies"):
        np.testing.assert_array_equal(got.observation_elements[key],
                                      np.asarray(ref.observation_elements[key]))
    action, ref_action = np.asarray(got.action), np.asarray(ref.action)
    assert action[8] == ref_action[8]  # the collision index
    np.testing.assert_allclose(action, ref_action, atol=1e-5)
    assert ((action[:3] >= bounds[:3]) & (action[:3] <= bounds[3:])).all()
