"""CLIP text tower (voxactb_tpu_torch/models/clip_text.py) and the port's own
copy of the BPE tokenizer, against the JAX package's on the same flax
parameters and token ids."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.models.clip_text import ClipLanguageEncoder as JaxLanguageEncoder
from voxactb_tpu.models.clip_text import ClipTextEncoder as JaxTextEncoder
from voxactb_tpu.utils.bpe import SimpleTokenizer as JaxTokenizer
from voxactb_tpu_torch.models.clip_text import ClipLanguageEncoder, ClipTextEncoder
from voxactb_tpu_torch.utils import bpe
from voxactb_tpu_torch.weights import load_flax_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
TEXTS = ["open the jar", "hand over the item to the other arm",
         "put the item in the top drawer, then close it!"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_tokenizer_reads_its_own_vocab_and_matches_jax():
    path = pathlib.Path(bpe._DEFAULT_VOCAB_PATHS[1]).resolve()
    assert path == ROOT / "voxactb_tpu_torch" / "assets" / "bpe_simple_vocab_16e6.txt.gz"
    tok = bpe.SimpleTokenizer()
    np.testing.assert_array_equal(tok.tokenize(TEXTS), JaxTokenizer().tokenize(TEXTS))
    ids = tok.tokenize("a photo of a cat")[0]
    np.testing.assert_array_equal(ids[:7], [bpe.SOT, 320, 1125, 539, 320, 2368, bpe.EOT])


@pytest.fixture(scope="module")
def tiny_tower():
    """A 2-layer tower (width 64, 2 heads, embed 96) and its flax parameters."""
    tokens = JaxTokenizer().tokenize(TEXTS)
    params = JaxTextEncoder(layers=2, width=64, heads=2, embed_dim=96).init(
        jax.random.key(0), jnp.asarray(tokens))
    return tokens, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_encoder_matches_jax(tiny_tower, dtype):
    tokens, params = tiny_tower
    kw = dict(layers=2, width=64, heads=2, embed_dim=96)
    ref_sent, ref_tok = (np.asarray(a) for a in JaxTextEncoder(
        **kw, dtype=getattr(jnp, dtype)).apply(params, jnp.asarray(tokens)))
    model = ClipTextEncoder(**kw, dtype=getattr(torch, dtype))
    load_flax_params(model, params)
    with torch.no_grad():
        sent, tok = (a.numpy() for a in model(torch.tensor(tokens)))
    assert sent.shape == (3, 96) and tok.shape == (3, 77, 64)
    for got, ref in ((sent, ref_sent), (tok, ref_tok)):
        if dtype == "float32":
            # f32 sums in another order through two layers
            np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
        else:
            # every op rounds to bf16 at the same points; a sum on a rounding
            # boundary may round the other way: two ulps of the largest value
            np.testing.assert_allclose(got, ref, atol=2.0 ** -7 * np.abs(ref).max(),
                                       rtol=0)


def test_language_encoder_matches_jax_at_full_width():
    """The agents' lang_encoder slot at the RN50 widths (12 layers, 512, 8
    heads, embed 1024), f32."""
    jenc = JaxLanguageEncoder()
    enc = ClipLanguageEncoder(params=jax.tree_util.tree_map(np.asarray, jenc._params),
                              device="cpu")
    tokens = enc.tokenize(TEXTS[1])[0]
    np.testing.assert_array_equal(tokens, jenc.tokenize(TEXTS[1])[0])
    ref_sent, ref_tok = jenc(tokens)
    sent, tok = enc(tokens)
    assert sent.shape == (1, 1024) and tok.shape == (1, 77, 512)
    np.testing.assert_allclose(sent.numpy(), ref_sent, atol=1e-5 * np.abs(ref_sent).max(),
                               rtol=0)
    np.testing.assert_allclose(tok.numpy(), ref_tok, atol=1e-5 * np.abs(ref_tok).max(),
                               rtol=0)
    got, _ = enc.encode_text(TEXTS[1])
    assert torch.equal(got, sent)
