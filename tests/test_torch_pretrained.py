"""Real weights into the port, on the CPU: the reference-checkpoint tool
(``tools/port_torch_checkpoint``) against the JAX tool's bytes, each upstream
importer (CLIP text and RN50, OWL-ViT, SAM in transformers' and facebook's
layouts) against the JAX importer leaf for leaf, the towers' forwards on
imported weights against the JAX towers and transformers, the key-shape
functions against the upstream state_dicts, ``utils/pretrained`` discovery,
``TorchOwlVitSamDetector.from_pretrained``, and the sim's language encoder
on a ``clip_rn50.pt``."""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same_tree(got, want, path=""):
    """Same nesting, keys, shapes, dtypes and values, exactly."""
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=path)


def _synthetic(shapes, seed=0, scale=0.05):
    """A state_dict of float32 numpy arrays at ``shapes`` (integer counters
    as int64), BatchNorm variances positive."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, s in shapes.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = np.asarray(7, np.int64)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, s).astype(np.float32)
        else:
            sd[k] = np.asarray(rng.normal(size=s) * scale, np.float32)
    return sd


def _loaded(module, tree):
    from voxactb_tpu_torch.weights import load_flax_params

    load_flax_params(module, tree)
    return module.eval()


# -- the reference policy checkpoint ----------------------------------------------------


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_port_torch_checkpoint", os.path.join(ROOT, "tools", "port_torch_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _left_arm_heads(sd):
    """The two-arm variant's second set of heads (``*_left_arm``)."""
    out = dict(sd)
    for head in ("trans_decoder.conv3d", "dense0.linear", "dense1.linear",
                 "rot_grip_collision_ff.linear"):
        base, layer = head.split(".")
        for leaf in ("weight", "bias"):
            out[f"{base}_left_arm.{layer}.{leaf}"] = sd[f"{head}.{leaf}"] * 1.5
    return out


@pytest.mark.parametrize("arm_pred,two_arm,prefix", [
    (False, False, ""), (True, False, "_qnet.module."), (False, True, "_qnet.")])
def test_port_torch_checkpoint_writes_the_jax_tools_bytes(tmp_path, monkeypatch, arm_pred,
                                                          two_arm, prefix):
    from voxactb_tpu_torch.tools import port_torch_checkpoint as tool

    shapes = tool.reference_key_shapes(depth=2, voxel_size=10, latents=16, latent_dim=32,
                                       arm_pred=True)
    assert shapes == _jax_tool().reference_key_shapes(depth=2, voxel_size=10, latents=16,
                                                      latent_dim=32, arm_pred=True)
    sd = _synthetic(shapes)
    if two_arm:
        sd = _left_arm_heads(sd)
    ckpt = tmp_path / "QAttentionAgent_layer0.pt"
    torch.save({prefix + k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    args = ["--ckpt", str(ckpt), "--depth", "2"] + ["--arm-pred"] * arm_pred \
        + ["--two-arm"] * two_arm
    tool.main(args + ["--out", str(tmp_path / "port.msgpack")])
    monkeypatch.setattr(sys, "argv", ["port_torch_checkpoint.py", *args,
                                      "--out", str(tmp_path / "jax.msgpack")])
    _jax_tool().main()
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()


def test_port_torch_checkpoint_pt_out_loads_into_the_agent(tmp_path):
    """``--out *.pt``: the port's own checkpoint, which the port's agent at
    the checkpoint's widths loads; every parameter equal to the msgpack's."""
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.config import MethodConfig
    from voxactb_tpu_torch.tools import port_torch_checkpoint as tool

    sd = _synthetic(tool.reference_key_shapes(depth=2, voxel_size=10, latents=16,
                                              latent_dim=32, arm_pred=True))
    ckpt = tmp_path / "ref.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    for out in ("a.pt", "a.msgpack"):
        tool.main(["--ckpt", str(ckpt), "--depth", "2", "--arm-pred",
                   "--out", str(tmp_path / out)])
    cfg = MethodConfig(voxel_sizes=[10], num_latents=16, latent_dim=32, transformer_depth=2,
                       latent_heads=8, latent_dim_head=4, which_arm="right",
                       arm_pred_loss=True)
    agents = []
    for out in ("a.pt", "a.msgpack"):
        agent = QAttentionBCAgent(cfg, ["front"], [0] * 6, device="cpu")
        agent.load_weight(str(tmp_path / out))
        agents.append(agent.params.state_dict())
    assert agents[0].keys() == agents[1].keys()
    for k in agents[0]:
        assert torch.equal(agents[0][k], agents[1][k]), k
    assert torch.equal(agents[0]["latents"], torch.from_numpy(sd["latents"]))


# -- the upstream towers: trees, forwards, layouts ---------------------------------------


@pytest.fixture(scope="module")
def hf():
    pytest.importorskip("transformers")
    from tests.test_hf_tower_parity import _tiny_owlvit, _tiny_sam

    return _tiny_owlvit(), _tiny_sam()


def _hf_to_facebook(sd):
    """A transformers ``SamModel`` state_dict renamed to segment-anything's
    layout (``tests/test_pretrained.py``'s decoder renaming, and the encoder's
    and the prompt encoder's)."""
    fb = {}
    for k, v in sd.items():
        if k.startswith("shared_image_embedding."):
            continue  # segment-anything has one positional-encoding layer
        k2 = (k.replace("vision_encoder.", "image_encoder.")
              .replace("patch_embed.projection", "patch_embed.proj")
              .replace("prompt_encoder.shared_embedding.positional_embedding",
                       "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix")
              .replace("prompt_encoder.point_embed.", "prompt_encoder.point_embeddings.")
              .replace("mask_embed.conv1", "mask_downscaling.0")
              .replace("mask_embed.layer_norm1", "mask_downscaling.1")
              .replace("mask_embed.conv2", "mask_downscaling.3")
              .replace("mask_embed.layer_norm2", "mask_downscaling.4")
              .replace("mask_embed.conv3", "mask_downscaling.6"))
        if k2.startswith("image_encoder."):
            k2 = (k2.replace(".layers.", ".blocks.").replace(".layer_norm1", ".norm1")
                  .replace(".layer_norm2", ".norm2").replace("neck.conv1", "neck.0")
                  .replace("neck.norm1", "neck.1").replace("neck.conv2", "neck.2")
                  .replace("neck.norm2", "neck.3"))
        if k.startswith("mask_decoder."):
            k2 = (k2.replace(".layer_norm1", ".norm1").replace(".layer_norm2", ".norm2")
                  .replace(".layer_norm3", ".norm3").replace(".layer_norm4", ".norm4")
                  .replace("transformer.layer_norm_final_attn", "transformer.norm_final_attn")
                  .replace("upscale_conv1", "output_upscaling.0")
                  .replace("upscale_layer_norm", "output_upscaling.1")
                  .replace("upscale_conv2", "output_upscaling.3"))
            if "iou_prediction_head" in k2 or "output_hypernetworks_mlps" in k2:
                if ".proj_in." in k2:
                    k2 = k2.replace(".proj_in.", ".layers.0.")
                elif ".layers.0." in k2:
                    k2 = k2.replace(".layers.0.", ".layers.1.")
                elif ".proj_out." in k2:
                    k2 = k2.replace(".proj_out.", ".layers.2.")
        fb[k2] = v
    return fb


TINY_SAM = dict(embed_dim=32, depth=4, num_heads=2, global_attn_indexes=(1, 3), img_size=64,
                patch=16, window=2, out_chans=32, mlp_dim=64, iou_hidden=32, mask_in_chans=8)
TINY_OWL = dict(vision_width=32, vision_layers=2, vision_mlp=128, image_size=32, patch=8,
                text_width=32, text_layers=2, text_mlp=128, context_length=16, vocab_size=99,
                projection_dim=32)
TINY_CLIP = dict(embed_dim=32, image_resolution=64, vision_layers=(1, 2, 1, 1),
                 vision_width=16, context_length=77, vocab_size=100, transformer_width=64,
                 transformer_layers=2)


def _shapes(sd):
    return {k: tuple(v.shape) for k, v in sd.items()}


def test_key_shapes_match_the_upstream_state_dicts(hf):
    """The layouts the chip phase's synthetic checkpoints take, at tiny
    configs, against the transformers models' own state_dicts (SAM renamed
    to segment-anything's keys); at the published sizes, their parameter
    counts (OWL-ViT B/32 153M, SAM ViT-H 641M, CLIP RN50 102M)."""
    from voxactb_tpu_torch.utils import pretrained as P

    owl, sam = hf
    assert P.owlvit_key_shapes(**TINY_OWL) == _shapes(owl.state_dict())
    assert P.sam_key_shapes(**TINY_SAM) == _shapes(_hf_to_facebook(sam.state_dict()))
    count = lambda shapes: sum(int(np.prod(s)) for s in shapes.values())  # noqa: E731
    assert 150e6 < count(P.owlvit_key_shapes()) < 156e6
    assert 635e6 < count(P.sam_key_shapes()) < 645e6
    assert 100e6 < count(P.clip_rn50_key_shapes()) < 104e6


def test_clip_importers_match_jax_exactly():
    """CLIP text and RN50 on a synthetic OpenAI-layout state_dict (from the
    key-shape function): the port's trees equal the JAX importers' leaf for
    leaf, and the RN50 tree has the JAX module's structure."""
    from voxactb_tpu.models import clip_image as jax_image
    from voxactb_tpu.models import clip_text as jax_text
    from voxactb_tpu_torch.models import clip_image, clip_text
    from voxactb_tpu_torch.utils import pretrained as P

    sd = _synthetic(P.clip_rn50_key_shapes(**TINY_CLIP))
    _same_tree(clip_text.load_torch_clip_weights(sd), jax_text.load_torch_clip_weights(sd))
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    got = clip_image.load_torch_clip_image_weights(tsd)
    _same_tree(got, jax_image.load_torch_clip_image_weights(sd))
    enc = jax_image.ClipResNetImageEncoder(layers=(1, 2, 1, 1), width=16, output_dim=32,
                                           heads=8)
    shapes = jax.eval_shape(enc.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    _same_tree(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes),
               jax.tree_util.tree_map(np.zeros_like, got))


def test_hf_and_facebook_importers_match_jax_exactly(hf):
    from voxactb_tpu.models import owlvit as jax_owl
    from voxactb_tpu.models import sam_decoder as jax_dec
    from voxactb_tpu.models import sam_encoder as jax_enc
    from voxactb_tpu_torch.models import owlvit, sam_decoder, sam_encoder

    owl, sam = hf
    sd = owl.state_dict()
    for got, want in zip(owlvit.load_hf_owlvit_weights(sd), jax_owl.load_hf_owlvit_weights(sd)):
        _same_tree(got, want)
    sd = sam.state_dict()
    _same_tree(sam_encoder.load_hf_sam_vision_weights(sd),
               jax_enc.load_hf_sam_vision_weights(sd))
    _same_tree(sam_decoder.load_hf_sam_decoder_weights(sd),
               jax_dec.load_hf_sam_decoder_weights(sd))
    fb = _hf_to_facebook(sd)
    _same_tree(sam_encoder.load_torch_sam_weights(fb), jax_enc.load_torch_sam_weights(fb))
    _same_tree(sam_decoder.load_torch_sam_decoder_weights(fb),
               jax_dec.load_torch_sam_decoder_weights(fb))
    # one segment-anything file loads the same towers as transformers' layout
    _same_tree(sam_encoder.load_torch_sam_weights(fb), sam_encoder.load_hf_sam_vision_weights(sd))
    _same_tree(sam_decoder.load_torch_sam_decoder_weights(fb),
               sam_decoder.load_hf_sam_decoder_weights(sd))


def test_importer_raises_on_a_missing_key(hf):
    from voxactb_tpu_torch.models import sam_encoder

    fb = _hf_to_facebook(hf[1].state_dict())
    del fb["image_encoder.blocks.2.attn.rel_pos_h"]
    with pytest.raises(KeyError, match="rel_pos_h"):
        sam_encoder.load_torch_sam_weights(fb)


def test_owlvit_forward_on_imported_weights(hf, rng):
    """The port's OWL-ViT on transformers' weights: logits and boxes against
    transformers' (the JAX test's 1e-4 and 1e-5) and the JAX towers (1e-5 of
    the largest). The tiny model's heads are 8 wide; ``utils/pretrained``
    takes the published models' 64."""
    from voxactb_tpu.models.clip_text import ClipTextEncoder as JaxText
    from voxactb_tpu.models.owlvit import (
        OwlViTDetector as JaxDet, OwlViTImageEncoder as JaxImage, load_hf_owlvit_weights)
    from voxactb_tpu_torch.models.clip_text import ClipTextEncoder
    from voxactb_tpu_torch.models.owlvit import OwlViTDetector, OwlViTImageEncoder

    owl = hf[0]
    tokens = rng.integers(1, 90, (2, 16)).astype(np.int64)
    tokens[:, 10] = 98
    pixels = rng.normal(size=(1, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        out_t = owl(input_ids=torch.from_numpy(tokens),
                    pixel_values=torch.from_numpy(pixels).permute(0, 3, 1, 2))
    det_params, text_params = load_hf_owlvit_weights(owl.state_dict())
    det = _loaded(OwlViTDetector(32, OwlViTImageEncoder(img_size=32, patch=8, dim=32, depth=2,
                                                        heads=4)), det_params)
    text = _loaded(ClipTextEncoder(vocab_size=99, context_length=16, width=32, heads=4,
                                   layers=2, embed_dim=32), text_params)
    with torch.no_grad():
        sent, _ = text(torch.from_numpy(tokens))
        sent = sent / torch.linalg.vector_norm(sent, dim=-1, keepdim=True)
        logits, boxes = det(torch.from_numpy(pixels), sent)
    np.testing.assert_allclose(logits.numpy(), out_t.logits.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(boxes.numpy(), out_t.pred_boxes.numpy(), atol=1e-5, rtol=1e-5)
    jtext = JaxText(vocab_size=99, context_length=16, width=32, heads=4, layers=2,
                    embed_dim=32)
    jsent = np.asarray(jtext.apply(text_params, jnp.asarray(tokens, jnp.int32))[0])
    jsent = jsent / np.linalg.norm(jsent, axis=-1, keepdims=True)
    jdet = JaxDet(embed_dim=32, image_encoder=JaxImage(img_size=32, patch=8, dim=32, depth=2,
                                                       heads=4))
    jl, jb = (np.asarray(a) for a in jdet.apply(det_params, jnp.asarray(pixels),
                                                jnp.asarray(jsent)))
    np.testing.assert_allclose(logits.numpy(), jl, atol=1e-5 * np.abs(jl).max(), rtol=0)
    np.testing.assert_allclose(boxes.numpy(), jb, atol=1e-5 * np.abs(jb).max(), rtol=0)


def test_sam_forward_on_imported_facebook_weights(hf, rng):
    """The port's SAM encoder and decoder on a segment-anything state_dict:
    features, mask logits and IoU against transformers' (the JAX test's
    tolerances, 1e-4 / 2e-4 / 1e-4)."""
    from voxactb_tpu_torch.models.sam_decoder import (
        SamMaskDecoder, load_torch_sam_decoder_weights)
    from voxactb_tpu_torch.models.sam_encoder import SamImageEncoder, load_torch_sam_weights

    sam = hf[1]
    pixels = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    box = np.array([[8.0, 12.0, 40.0, 52.0]], np.float32)
    with torch.no_grad():
        out_t = sam(pixel_values=torch.from_numpy(pixels).permute(0, 3, 1, 2),
                    input_boxes=torch.from_numpy(box)[None], multimask_output=True)
        feats_t = sam.vision_encoder(torch.from_numpy(pixels).permute(0, 3, 1, 2)
                                     ).last_hidden_state.permute(0, 2, 3, 1)
    fb = _hf_to_facebook(sam.state_dict())
    enc = _loaded(SamImageEncoder(img_size=64, embed_dim=32, depth=4, num_heads=2,
                                  window_size=2, global_attn_indexes=(1, 3), out_chans=32),
                  load_torch_sam_weights(fb))
    dec = _loaded(SamMaskDecoder(dim=32, heads=2, depth=2, num_masks=4, mlp_dim=64),
                  load_torch_sam_decoder_weights(fb))
    with torch.no_grad():
        emb = enc(torch.from_numpy(pixels))
        masks, iou = dec(emb, torch.from_numpy((box + 0.5) / 64.0))
    np.testing.assert_allclose(emb.numpy(), feats_t.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(masks.numpy()[:, 1:], out_t.pred_masks.numpy()[:, 0],
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(iou.numpy()[:, 1:], out_t.iou_scores.numpy()[:, 0],
                               atol=1e-4, rtol=1e-4)


def test_clip_towers_forward_on_imported_weights(rng):
    """CLIP text and the new RN50 image tower (BatchNorm running statistics
    from ``batch_stats``) on one synthetic OpenAI checkpoint, against the JAX
    towers: within 1e-5 of the largest output (f32 sums in another order)."""
    from voxactb_tpu.models import clip_image as jax_image
    from voxactb_tpu.models import clip_text as jax_text
    from voxactb_tpu_torch.models.clip_image import load_torch_clip_image_weights
    from voxactb_tpu_torch.models.clip_text import load_torch_clip_weights
    from voxactb_tpu_torch.utils import pretrained as P
    from voxactb_tpu_torch.weights import batch_stats_tree

    sd = _synthetic(P.clip_rn50_key_shapes(**TINY_CLIP), seed=1, scale=0.1)
    tokens = rng.integers(1, 90, (2, 77)).astype(np.int64)
    tokens[:, 30] = 99
    params = load_torch_clip_weights(sd)
    text = P.clip_text_from(params, device="cpu")
    with torch.no_grad():
        sent, tok = text(torch.from_numpy(tokens))
    jt = jax_text.ClipTextEncoder(vocab_size=100, context_length=77, width=64, heads=1,
                                  layers=2, embed_dim=32)
    jsent, jtok = (np.asarray(a) for a in jt.apply(params, jnp.asarray(tokens, jnp.int32)))
    np.testing.assert_allclose(sent.numpy(), jsent, atol=1e-5 * np.abs(jsent).max(), rtol=0)
    np.testing.assert_allclose(tok.numpy(), jtok, atol=1e-5 * np.abs(jtok).max(), rtol=0)

    variables = load_torch_clip_image_weights(sd)
    from voxactb_tpu_torch.models.clip_image import ClipResNetImageEncoder

    img = _loaded(ClipResNetImageEncoder(layers=(1, 2, 1, 1), width=16, output_dim=32,
                                         heads=8, input_resolution=64), variables)
    _same_tree(batch_stats_tree(img), variables["batch_stats"])
    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        emb, pyramid = img(torch.from_numpy(images), return_pyramid=True)
    je = jax_image.ClipResNetImageEncoder(layers=(1, 2, 1, 1), width=16, output_dim=32,
                                          heads=8)
    jemb, jpyr = je.apply(variables, jnp.asarray(images), return_pyramid=True)
    jemb = np.asarray(jemb)
    np.testing.assert_allclose(emb.numpy(), jemb, atol=1e-5 * np.abs(jemb).max(), rtol=0)
    for got, want in zip(pyramid, jpyr):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)

    # the joint model's similarity logits (clip.py:445-465)
    from voxactb_tpu_torch.models.clip_text import ClipModel

    with torch.no_grad():
        logits, logits_t = ClipModel(img, text)(torch.from_numpy(images),
                                                torch.from_numpy(tokens))
    jl, jlt = jax_text.ClipModel(je, variables, jt, params)(images, tokens)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jl)).max())
    np.testing.assert_array_equal(logits_t.numpy(), logits.numpy().T)


def _keys_cubic_weights(n_in, n_out):
    """``jax.image.resize``'s cubic weights of one axis (``compute_weight_mat``):
    sample positions on half-pixel centres in f32, as JAX computes them, then
    Keys' kernel (a = -0.5), widened by the shrink factor, and the column
    normalisation in float64."""
    inv = np.float32(n_in / n_out)
    k = max(inv, np.float32(1.0))
    pos = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = (np.abs(pos[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / k).astype(
        np.float64)
    w = np.where(x < 1, (1.5 * x - 2.5) * x * x + 1,
                 np.where(x < 2, ((-0.5 * x + 2.5) * x - 4) * x + 2, 0.0))
    return w / w.sum(0, keepdims=True)


def test_preprocess_clip_image_matches_jax():
    """The bicubic resize and normalisation against a float64 sum over JAX's
    weights (within 4e-6 of the largest output: f32 sums of up to 36 products
    and the normalisation, a few tens of ulps) and the JAX package's
    (within twice the JAX result's own distance from that sum, which is
    about 1e-5 of a pixel's range at these sizes)."""
    from voxactb_tpu.models.clip_image import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
    from voxactb_tpu.models.clip_image import preprocess_clip_image as jax_pre
    from voxactb_tpu_torch.models.clip_image import preprocess_clip_image

    for shape in ((100, 160, 3), (300, 250, 3)):
        rgb = np.random.default_rng(0).integers(0, 255, shape).astype(np.uint8)
        x = (rgb / np.float32(255.0)).astype(np.float32).astype(np.float64)
        ref = np.einsum("hwc,hH->Hwc", x, _keys_cubic_weights(shape[0], 224))
        ref = np.einsum("Hwc,wW->HWc", ref, _keys_cubic_weights(shape[1], 224))
        ref = ((ref - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD)[None]
        got = preprocess_clip_image(rgb, device="cpu").numpy()
        want = jax_pre(rgb)
        assert got.shape == want.shape == (1, 224, 224, 3)
        np.testing.assert_allclose(got, ref, atol=4e-6 * np.abs(ref).max(), rtol=0)
        np.testing.assert_allclose(got, want, atol=2 * np.abs(want - ref).max(), rtol=0)


def test_owlvit_queries_take_the_text_towers_context():
    """OWL-ViT's text tower has 16 positions: the pipeline tokenizes its
    queries to that length (to 77 for a CLIP-sized tower), as transformers'
    processor pads to 16."""
    from voxactb_tpu_torch.models.clip_text import ClipTextEncoder
    from voxactb_tpu_torch.models.owlvit import (
        OwlViTDetector, OwlViTImageEncoder, OwlViTPipeline)
    from voxactb_tpu_torch.utils.bpe import SimpleTokenizer

    g = torch.Generator().manual_seed(0)
    det = OwlViTDetector(32, OwlViTImageEncoder(img_size=32, patch=8, dim=32, depth=1,
                                                heads=4, generator=g), generator=g)
    tok = SimpleTokenizer()
    for ctx in (16, 77):
        text = ClipTextEncoder(context_length=ctx, width=32, heads=4, layers=1,
                               embed_dim=32, generator=g).eval()
        got = OwlViTPipeline(det, text, tokenizer=tok, img_size=32).embed_queries(
            ["drawer handle"])
        with torch.no_grad():
            want, _ = text(torch.as_tensor(tok.tokenize(["drawer handle"], context_length=ctx)))
        assert got.shape == (1, 32)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


# -- discovery, the detector, the sim's language ------------------------------------------


def _fake_clip(path, embed=48, vocab=49408):
    """``tests/test_pretrained.py``'s fake CLIP text checkpoint (2 layers,
    width 64, a 48-d projection), saved as ``clip_rn50.pt``."""
    from tests.test_pretrained import _fake_clip_state_dict

    torch.save(_fake_clip_state_dict(embed=embed, vocab=vocab), os.path.join(path,
                                                                             "clip_rn50.pt"))


def test_find_weights_absent(tmp_path, monkeypatch):
    from voxactb_tpu_torch.utils import pretrained

    monkeypatch.setenv("VOXACTB_WEIGHTS_DIR", str(tmp_path))
    assert pretrained.find_weights("clip") is None
    assert pretrained.load_clip_text(device="cpu") is None
    assert pretrained.load_owlvit(device="cpu") is None
    assert pretrained.load_sam_encoder("vit_h", device="cpu") is None
    monkeypatch.delenv("VOXACTB_WEIGHTS_DIR")
    assert pretrained.weights_dir() == os.path.join(ROOT, "weights")


def test_load_clip_text_from_checkpoint(tmp_path, monkeypatch):
    from voxactb_tpu_torch.utils import pretrained

    monkeypatch.setenv("VOXACTB_WEIGHTS_DIR", str(tmp_path))
    _fake_clip(tmp_path, vocab=120)
    model, params = pretrained.load_clip_text(device="cpu")
    assert model.layers == 2 and model.text_projection.shape == (64, 48)
    tokens = torch.as_tensor(np.array([[1, 5, 9] + [0] * 73 + [119]]))
    with torch.no_grad():
        sent, tok = model(tokens)
    assert sent.shape == (1, 48) and tok.shape == (1, 77, 64)
    assert torch.isfinite(sent).all()
    if not torch.cuda.is_available():  # the loaders build on CUDA unless told otherwise
        with pytest.raises(RuntimeError, match="CUDA"):
            pretrained.load_clip_text()


def test_sim_language_encoder_uses_checkpoint(tmp_path, monkeypatch):
    """The repair: with ``clip_rn50.pt`` on disk, the JAX sim and the port's
    sim hand out the checkpoint's 48-d embedding, and the port's values are
    the loaded tower's (and the JAX sim's within f32 noise)."""
    from voxactb_tpu.sim import environment as JE
    from voxactb_tpu_torch.sim import environment as E
    from voxactb_tpu_torch.utils import pretrained

    monkeypatch.setenv("VOXACTB_WEIGHTS_DIR", str(tmp_path))
    _fake_clip(tmp_path)
    for mod in (E, JE):
        monkeypatch.setattr(mod, "_LANG_ENC", None)
        monkeypatch.setattr(mod, "_LANG_CACHE", {})
    sent, tok = E.default_sim_language_encoder()("open the jar")
    jsent, jtok = JE.default_sim_language_encoder()("open the jar")
    assert sent.shape == jsent.shape == (48,) and tok.shape == jtok.shape == (77, 64)
    model, _ = pretrained.load_clip_text(device="cpu")
    from voxactb_tpu_torch.utils.bpe import SimpleTokenizer

    tokens = torch.as_tensor(np.asarray(SimpleTokenizer().tokenize("open the jar")))
    with torch.no_grad():
        want, _ = model(tokens.reshape(1, -1))
    np.testing.assert_array_equal(sent, want[0].numpy())
    np.testing.assert_allclose(sent, jsent, atol=1e-5 * np.abs(jsent).max(), rtol=0)
    assert not np.allclose(sent, E.default_sim_language_encoder()("open the drawer")[0])


def test_sim_language_encoder_raises_on_an_unreadable_checkpoint(tmp_path, monkeypatch):
    """The departure: the JAX sim falls back to random weights, the port raises."""
    from voxactb_tpu_torch.sim import environment as E

    monkeypatch.setenv("VOXACTB_WEIGHTS_DIR", str(tmp_path))
    (tmp_path / "clip_rn50.pt").write_bytes(b"not a checkpoint")
    monkeypatch.setattr(E, "_LANG_ENC", None)
    monkeypatch.setattr(E, "_LANG_CACHE", {})
    with pytest.raises(Exception):
        E.default_sim_language_encoder()("open the jar")


def test_from_pretrained(tmp_path, monkeypatch, hf):
    """``TorchOwlVitSamDetector.from_pretrained`` raises ``FileNotFoundError``
    without the files; with them (a tiny OWL-ViT and a tiny segment-anything
    file) its towers, at the widths read off the files, hold the imported
    weights."""
    from voxactb_tpu_torch.models.owlvit import load_hf_owlvit_weights
    from voxactb_tpu_torch.models.sam_decoder import load_torch_sam_decoder_weights
    from voxactb_tpu_torch.models.sam_encoder import load_torch_sam_weights
    from voxactb_tpu_torch.vlm.pipeline import TorchOwlVitSamDetector
    from voxactb_tpu_torch.weights import tensors_to_flax_tree

    monkeypatch.setenv("VOXACTB_WEIGHTS_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="owlvit_base.pt"):
        TorchOwlVitSamDetector.from_pretrained("vit_h", device="cpu")
    owl, sam = hf
    torch.save(owl.state_dict(), tmp_path / "owlvit_base.pt")
    fb = _hf_to_facebook(sam.state_dict())
    torch.save(fb, tmp_path / "sam_vit_h.pth")
    det = TorchOwlVitSamDetector.from_pretrained("vit_h", device="cpu")
    want_det, want_text = load_hf_owlvit_weights(owl.state_dict())
    for module, tree in ((det._owl._det, want_det), (det._owl._text, want_text),
                         (det._sam.encoder, load_torch_sam_weights(fb)),
                         (det._sam.decoder, load_torch_sam_decoder_weights(fb))):
        _same_tree(tensors_to_flax_tree(module, dict(module.named_parameters())), tree)
    assert det._owl._img_size == 32
