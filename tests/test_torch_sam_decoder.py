"""SAM mask decoder and box-prompted segmenter (voxactb_tpu_torch/models/
sam_decoder.py) against the JAX package's on the same flax parameters,
including a frame the mask must shrink to (jax.image.resize's triangle
filter)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.models.sam_decoder import SamMaskDecoder as JaxDecoder
from voxactb_tpu.models.sam_decoder import SamSegmenter as JaxSegmenter
from voxactb_tpu.models.sam_encoder import SamImageEncoder as JaxEncoder
from voxactb_tpu_torch.models.sam_decoder import SamMaskDecoder, SamSegmenter
from voxactb_tpu_torch.models.sam_encoder import SamImageEncoder
from voxactb_tpu_torch.weights import load_flax_params

ENCODER = dict(img_size=64, patch_size=8, embed_dim=32, depth=2, num_heads=2,
               window_size=2, global_attn_indexes=(1,), out_chans=32)
DECODER = dict(dim=32, heads=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def decoder_params():
    params = jax.jit(JaxDecoder(**DECODER).init)(jax.random.key(2),
                                                 jnp.zeros((1, 8, 8, 32)), jnp.zeros((1, 4)))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_matches_jax(decoder_params, dtype):
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    boxes = np.asarray([[0.1, 0.1, 0.5, 0.5], [0.2, 0.3, 0.9, 0.8]], np.float32)
    apply = JaxDecoder(**DECODER, dtype=getattr(jnp, dtype)).apply
    # at bf16 against the op-by-op (un-jitted) JAX module: XLA's fusions under
    # jit skip some bf16 roundings and move the masks by up to 0.019 of 1.2
    # from the op-by-op result, which the port follows
    if dtype == "float32":
        apply = jax.jit(apply)
    ref_masks, ref_iou = (np.asarray(a) for a in apply(decoder_params, jnp.asarray(emb),
                                                         jnp.asarray(boxes)))
    dec = SamMaskDecoder(**DECODER, dtype=getattr(torch, dtype))
    load_flax_params(dec, decoder_params)
    with torch.no_grad():
        masks, iou = (a.numpy() for a in dec(torch.tensor(emb), torch.tensor(boxes)))
    assert masks.shape == (2, 4, 32, 32) and iou.shape == (2, 4)
    # f32: sums in another order; bf16: the same rounding points, and a value
    # on a bf16 rounding boundary may round the other way (two ulps)
    rel = 1e-5 if dtype == "float32" else 2.0 ** -7
    for got, ref in ((masks, ref_masks), (iou, ref_iou)):
        np.testing.assert_allclose(got, ref, atol=rel * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("frame,box", [
    ((48, 96), [10, 10, 60, 40]),   # the 32x16 mask crop grows to the frame
    ((20, 24), [3, 2, 15, 17]),     # the 27x32 crop shrinks to it (triangle filter)
])
def test_segment_box_matches_jax(decoder_params, frame, box):
    enc_params = jax.jit(JaxEncoder(**ENCODER).init)(jax.random.key(1),
                                                     jnp.zeros((1, 64, 64, 3)))
    ref_seg = JaxSegmenter(JaxEncoder(**ENCODER), enc_params, JaxDecoder(**DECODER),
                           decoder_params, img_size=64)
    enc = SamImageEncoder(**ENCODER)
    load_flax_params(enc, jax.tree_util.tree_map(np.asarray, enc_params))
    dec = SamMaskDecoder(**DECODER)
    load_flax_params(dec, decoder_params)
    seg = SamSegmenter(enc, dec, img_size=64)
    rgb = np.random.default_rng(4).integers(0, 255, frame + (3,)).astype(np.uint8)
    ref = ref_seg.segment_box(rgb, box)
    got = seg.segment_box(rgb, box)
    assert got.shape == frame and got.dtype == bool
    assert 0 < ref.sum() < ref.size
    # the f32 logits agree to ~1e-6; no pixel of this frame sits that close to 0
    np.testing.assert_array_equal(got, ref)


def test_bridge_round_trips_the_decoder_tree(decoder_params):
    """The decoder's flax tree (auto-named Dense_i / LayerNorm_i, the
    transposed convs' flipped kernels) goes into the port and back unchanged."""
    from voxactb_tpu_torch.weights import tensors_to_flax_tree

    dec = SamMaskDecoder(**DECODER)
    load_flax_params(dec, decoder_params)
    back = tensors_to_flax_tree(dec, dict(dec.named_parameters()))
    want = jax.tree_util.tree_leaves_with_path(decoder_params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf)
    up1 = decoder_params["params"]["up1"]["kernel"]  # [kh, kw, in, out]
    np.testing.assert_array_equal(dec.up1.weight.detach().numpy()[:, :, 0, 0],
                                  up1[-1, -1])
