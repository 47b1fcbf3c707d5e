"""SAM image encoder (voxactb_tpu_torch/models/sam_encoder.py) against the
JAX package's on the same flax parameters (nonzero rel-pos): windowing, the
rel-pos selection with its resize branch, preprocessing on frames that grow
and shrink, the encoder at f32, and at bf16 with K7's flags on (the port
takes K7's plain version on the CPU) against the XLA path and the Pallas
kernel in interpret mode."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.models import sam_encoder as J
from voxactb_tpu_torch.models import sam_encoder as S
from voxactb_tpu_torch.weights import load_flax_params

TINY = dict(img_size=64, patch_size=8, embed_dim=32, depth=2, num_heads=2,
            window_size=3, global_attn_indexes=(1,), out_chans=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_window_partition_roundtrip_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 7, 7, 5)).astype(np.float32)
    ref, ref_pad = J.window_partition(jnp.asarray(x), 3)
    wins, pad_hw = S.window_partition(torch.tensor(x), 3)
    assert pad_hw == ref_pad == (9, 9)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(ref))
    back = S.window_unpartition(wins, 3, pad_hw, (7, 7))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("size,rows", [(4, 7), (6, 7), (3, 9)])
def test_rel_pos_embed_matches_jax(size, rows):
    """Rows equal to 2 * size - 1 are selected as they are; other lengths are
    resized linearly first (growing 7 -> 11, shrinking 9 -> 5)."""
    rel = np.random.default_rng(size).normal(size=(rows, 8)).astype(np.float32)
    ref = np.asarray(J._rel_pos_embed(size, size, jnp.asarray(rel)))
    got = S._rel_pos_embed(size, size, torch.tensor(rel)).numpy()
    assert got.shape == (size, size, 8)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("frame", [(48, 96), (100, 90)])
def test_preprocess_image_matches_jax(frame):
    rgb = np.random.default_rng(1).integers(0, 255, frame + (3,)).astype(np.uint8)
    ref = J.preprocess_image(rgb, img_size=64)
    got = S.preprocess_image(rgb, img_size=64).numpy()
    assert got.shape == ref.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def encoder_params():
    x = np.random.default_rng(2).normal(size=(1, 64, 64, 3)).astype(np.float32)
    params = J.SamImageEncoder(**TINY).init(jax.random.key(0), jnp.asarray(x))
    flat = flax.traverse_util.flatten_dict(params["params"])
    rng = np.random.default_rng(3)
    for key in flat:
        if "rel_pos" in "/".join(key):
            flat[key] = (0.3 * rng.normal(size=flat[key].shape)).astype(np.float32)
    return x, {"params": flax.traverse_util.unflatten_dict(flat)}


def _port(params, **kw):
    model = S.SamImageEncoder(**TINY, **kw)
    load_flax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return model


def test_encoder_f32_matches_jax(encoder_params):
    x, params = encoder_params
    ref = np.asarray(J.SamImageEncoder(**TINY).apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(params)(torch.tensor(x)).numpy()
    assert got.shape == (1, 8, 8, 16)
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_encoder_bf16_with_sam_attention_matches_jax(encoder_params):
    """K7's flags on in the port (global and windowed blocks; its plain
    version on the CPU) against the JAX encoder's XLA path, which rounds at
    the same points, and against the JAX encoder with its Pallas kernel in
    the global block (interpret mode), whose hi/lo bias split and summation
    order may move an output by a bf16 ulp."""
    x, params = encoder_params
    bf = jnp.bfloat16
    xla = np.asarray(J.SamImageEncoder(**TINY, fused_global=False, dtype=bf).apply(
        params, jnp.asarray(x)), np.float32)
    pallas = np.asarray(J.SamImageEncoder(**TINY, fused_global=True, fused_interpret=True,
                                          dtype=bf).apply(params, jnp.asarray(x)),
                        np.float32)
    with torch.no_grad():
        got = _port(params, fused_global=True, fused_windowed=True,
                    dtype=torch.bfloat16)(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, xla, atol=2.0 ** -8 * np.abs(xla).max(), rtol=0)
    np.testing.assert_allclose(got, pallas, atol=2.0 ** -7 * np.abs(pallas).max(), rtol=0)


def test_vit_h_widths():
    """sam_vit_h at 1024^2: ~637M parameters as the JAX package's (built on the
    meta device, no memory), 4 global blocks, 28 windowed, head dim 80."""
    with torch.device("meta"):
        enc = S.sam_vit_h()
    assert sum(p.numel() for p in enc.parameters()) == 637_026_048
    blocks = [getattr(enc, f"block_{i}") for i in range(32)]
    assert [i for i, b in enumerate(blocks) if b.window_size == 0] == [7, 15, 23, 31]
    assert blocks[0].attn.rel_pos_h.shape == (27, 80)
    assert blocks[7].attn.rel_pos_h.shape == (127, 80)
