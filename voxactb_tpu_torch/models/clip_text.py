"""CLIP text encoder (RN50 text tower): act-time language conditioning.

Counterpart of ``voxactb_tpu.models.clip_text``: a 12-layer pre-LN causal
transformer, width 512, 8 heads, context 77, QuickGELU MLPs, returning BOTH
the 1024-d sentence embedding (``ln_final`` output at the EOT position @
``text_projection``) and the 77x512 per-token embeddings (``ln_final`` output)
that feed the Perceiver's language fusion. Parameters are stored in f32 under
the flax names and cast to the compute ``dtype`` at use; ``weights.py`` loads
a flax tree, which ``load_torch_clip_weights`` makes from an OpenAI CLIP
state_dict. ``ClipModel`` joins this tower and the RN50 image tower
(``models/clip_image.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from voxactb_tpu_torch.device import resolve_device
from voxactb_tpu_torch.models.blocks import Dense, LayerNorm, rounded, sigmoid
from voxactb_tpu_torch.models.torch_port import make_port_helpers
from voxactb_tpu_torch.ops.cuda.graphs import weight

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(1.702 x)`` op by op in ``x``'s dtype, 1.702 rounded to it."""
    return x * sigmoid(rounded(1.702, x.dtype) * x)


def attend_logits(logits: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The towers' XLA attention from f32 logits: the f32 softmax cast to
    ``v``'s dtype, then ``P v`` in that dtype."""
    return torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``attend_logits`` of ``q k^T`` (f32 sums of exact products); q arrives
    scaled in its own dtype."""
    f32 = torch.float32
    return attend_logits(torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)), v)


def split_heads(a: torch.Tensor, heads: int) -> torch.Tensor:
    """``[B, T, H * hd]`` -> ``[B, H, T, hd]``."""
    b, t, d = a.shape
    return a.reshape(b, t, heads, d // heads).transpose(1, 2)


def merge_heads(a: torch.Tensor) -> torch.Tensor:
    """``[B, H, T, hd]`` -> ``[B, T, H * hd]``."""
    b, h, t, hd = a.shape
    return a.transpose(1, 2).reshape(b, t, h * hd)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads = heads
        self.ln_1 = LayerNorm(width, dtype=dtype)
        self.attn_in = Dense(width, 3 * width, dtype=dtype, generator=generator)
        self.attn_out = Dense(width, width, dtype=dtype, generator=generator)
        self.ln_2 = LayerNorm(width, dtype=dtype)
        self.mlp_fc = Dense(width, 4 * width, dtype=dtype, generator=generator)
        self.mlp_proj = Dense(4 * width, width, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        q, k, v = (split_heads(a, self.heads)
                   for a in self.attn_in(self.ln_1(x)).chunk(3, dim=-1))
        f32 = torch.float32
        # the logits are scaled in f32 after the product (clip.py:398-404)
        logits = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) \
            * q.shape[-1] ** -0.5
        x = x + self.attn_out(merge_heads(attend_logits(logits + mask, v)))
        return x + self.mlp_proj(quick_gelu(self.mlp_fc(self.ln_2(x))))


class ClipTextEncoder(nn.Module):
    """tokens ``[B, T]`` -> (sentence_emb ``[B, embed_dim]``, token_embs
    ``[B, T, width]``), both f32."""

    def __init__(self, vocab_size: int = VOCAB_SIZE, context_length: int = CONTEXT_LENGTH,
                 width: int = 512, heads: int = 8, layers: int = 12,
                 embed_dim: int = 1024, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.token_embedding = nn.Parameter(torch.empty(vocab_size, width))
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))
        with torch.no_grad():
            self.token_embedding.normal_(0.0, 0.02, generator=generator)
            self.positional_embedding.normal_(0.0, 0.01, generator=generator)
            self.text_projection.normal_(0.0, width ** -0.5, generator=generator)
        for i in range(layers):
            self.add_module(f"resblock_{i}",
                            ResidualAttentionBlock(width, heads, dtype, generator))
        self.layers = layers
        self.ln_final = LayerNorm(width, dtype=dtype)

    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t = tokens.shape
        tokens = tokens.long()
        x = self.token_embedding[tokens].to(self.dtype) \
            + weight(self.positional_embedding[None, :t], self.dtype)
        causal = torch.full((t, t), float("-inf"), device=x.device).triu(1)
        for i in range(self.layers):
            x = getattr(self, f"resblock_{i}")(x, causal)
        x = self.ln_final(x)
        # EOT has the highest token id (clip.py:423)
        sent = x[torch.arange(b, device=x.device), tokens.argmax(-1)]
        sentence = torch.matmul(sent, weight(self.text_projection, self.dtype))
        return sentence.float(), x.float()


def load_torch_clip_weights(state_dict) -> dict:
    """Map an OpenAI CLIP state_dict's text tower onto ClipTextEncoder params.

    Accepts a dict of numpy arrays or torch tensors keyed as in clip.py:311-365
    (``transformer.resblocks.N.attn.in_proj_weight`` etc.).
    """

    a = make_port_helpers(state_dict)[0]

    params = {
        "token_embedding": a("token_embedding.weight"),
        "positional_embedding": a("positional_embedding"),
        "text_projection": a("text_projection"),
        "ln_final": {"scale": a("ln_final.weight"), "bias": a("ln_final.bias")},
    }
    n_layers = max(
        int(k.split(".")[2]) for k in state_dict
        if k.startswith("transformer.resblocks.")
    ) + 1
    for i in range(n_layers):
        p = f"transformer.resblocks.{i}"
        params[f"resblock_{i}"] = {
            "ln_1": {"scale": a(f"{p}.ln_1.weight"), "bias": a(f"{p}.ln_1.bias")},
            "ln_2": {"scale": a(f"{p}.ln_2.weight"), "bias": a(f"{p}.ln_2.bias")},
            # torch Linear stores [out, in]; flax Dense wants [in, out]
            "attn_in": {"kernel": a(f"{p}.attn.in_proj_weight").T,
                        "bias": a(f"{p}.attn.in_proj_bias")},
            "attn_out": {"kernel": a(f"{p}.attn.out_proj.weight").T,
                         "bias": a(f"{p}.attn.out_proj.bias")},
            "mlp_fc": {"kernel": a(f"{p}.mlp.c_fc.weight").T,
                       "bias": a(f"{p}.mlp.c_fc.bias")},
            "mlp_proj": {"kernel": a(f"{p}.mlp.c_proj.weight").T,
                         "bias": a(f"{p}.mlp.c_proj.bias")},
        }
    return {"params": params}


class ClipLanguageEncoder:
    """Tokenizer + text encoder, the callable the agents' ``lang_encoder`` takes:
    token ids ``[77]`` -> (``[1, 1024]``, ``[1, 77, 512]``) f32 tensors on the
    encoder's device. ``params`` (a flax tree of numpy arrays) loads the
    weights; without it they are initialised from ``seed``."""

    def __init__(self, params=None, tokenizer=None, dtype: torch.dtype = torch.float32,
                 device=None, seed: int = 0):
        self.device = resolve_device(device)
        model = ClipTextEncoder(dtype=dtype, generator=torch.Generator().manual_seed(seed))
        if params is not None:
            from voxactb_tpu_torch.weights import load_flax_params

            load_flax_params(model, params)
        self.model = model.to(self.device).eval()
        self._tokenizer = tokenizer

    def tokenize(self, texts):
        if self._tokenizer is None:
            from voxactb_tpu_torch.utils.bpe import SimpleTokenizer

            self._tokenizer = SimpleTokenizer()
        return self._tokenizer.tokenize(texts)

    def __call__(self, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device).reshape(1, -1)
        with torch.inference_mode():
            return self.model(tokens)

    def encode_text(self, texts):
        return self(self.tokenize(texts)[0])


class ClipModel(nn.Module):
    """Joint CLIP: image tower + text tower + temperature (clip.py:311-465),
    the reference's contrastive interface: ``encode_image`` / ``encode_text``
    / ``forward`` -> similarity logits. Images ``[B, H, W, 3]`` normalised
    (``clip_image.preprocess_clip_image``), tokens ``[B, 77]``."""

    def __init__(self, image_encoder: Optional[nn.Module] = None,
                 text_encoder: Optional[ClipTextEncoder] = None,
                 logit_scale: float = 100.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        from voxactb_tpu_torch.models.clip_image import ClipResNetImageEncoder

        self.image_encoder = image_encoder or ClipResNetImageEncoder(generator=generator)
        self.text_encoder = text_encoder or ClipTextEncoder(generator=generator)
        self.logit_scale = logit_scale

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.image_encoder(images)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text_encoder(tokens)[0]

    def encode_text_with_embeddings(self, tokens: torch.Tensor):
        """The VoxAct-B entry point (clip.py:426-441)."""
        return self.text_encoder(tokens)

    def forward(self, images: torch.Tensor, tokens: torch.Tensor):
        img = self.encode_image(images)
        txt = self.encode_text(tokens)
        img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
        txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
        logits_per_image = self.logit_scale * img @ txt.T
        return logits_per_image, logits_per_image.T
