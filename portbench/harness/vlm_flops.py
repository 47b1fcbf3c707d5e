"""Operations and bytes of the VLM crop, counted from shapes: the model
FLOPs of OWL-ViT's detection, its text tower, SAM's image encoder and its
mask decoder, and K7's roofline bound per launch.

FLOPs are 2 per multiply-add of the matrix products and convolutions of the
plain reference (``reference/owlvit.py``, ``reference/sam.py``), as
``harness/flops.py`` counts the policy's: elementwise work, softmax,
normalisations and the frame's resizes left out.
``tests/test_portbench_vlm.py`` holds each count to
``torch.utils.flop_counter.FlopCounterMode`` on the reference.
"""

from __future__ import annotations

from typing import Iterator, Tuple

from portbench.harness.flops import bound_s


def _attention(nq: int, nk: int, dim: int) -> float:
    """q k^T and P v over all heads: ``dim`` = heads x head dim."""
    return 2.0 * 2.0 * nq * nk * dim


def owl_flops(o: dict, queries: int = 1) -> float:
    """OWL-ViT's image tower and heads on one frame against ``queries``."""
    d, g = o["dim"], o["img_size"] // o["patch"]
    t, e = g * g + 1, o["embed_dim"]
    total = 2.0 * g * g * d * 3 * o["patch"] ** 2
    per_block = (2.0 * t * d * 3 * d + _attention(t, t, d) + 2.0 * t * d * d
                 + 2 * 2.0 * t * d * 4 * d)
    total += o["depth"] * per_block
    p = g * g
    total += 2.0 * p * d * e + 2 * 2.0 * p * d + 2.0 * p * e * queries
    total += 2 * 2.0 * p * d * d + 2.0 * p * d * 4
    return total


def text_flops(t: dict, queries: int = 1) -> float:
    """CLIP's text tower over ``queries`` token rows (run once per query)."""
    w, n = t["width"], t["context_length"]
    per_block = (2.0 * n * w * 3 * w + _attention(n, n, w) + 2.0 * n * w * w
                 + 2 * 2.0 * n * w * 4 * w)
    return queries * (t["layers"] * per_block + 2.0 * w * t["embed_dim"])


def sam_blocks(s: dict) -> Iterator[Tuple[int, int]]:
    """Each block's attention: ``(windows, side)``, the side of its square
    token grid per window."""
    g = s["img_size"] // s["patch_size"]
    win = s["window_size"]
    per = -(-g // win)
    for i in range(s["depth"]):
        yield (1, g) if i in s["global_attn_indexes"] else (per * per, win)


def sam_flops(s: dict) -> float:
    """SAM's image encoder on one frame."""
    c = s["embed_dim"]
    g = s["img_size"] // s["patch_size"]
    total = 2.0 * g * g * c * 3 * s["patch_size"] ** 2
    for windows, n in sam_blocks(s):
        t = n * n
        tokens = windows * t
        total += 2.0 * tokens * c * 3 * c + 2.0 * tokens * c * c
        total += windows * (_attention(t, t, c) + 2 * 2.0 * t * n * c)  # the rel-pos terms
        total += 2 * 2.0 * g * g * c * 4 * c
    oc = s["out_chans"]
    return total + 2.0 * g * g * c * oc + 2.0 * g * g * oc * oc * 9


def decoder_flops(d: dict, g: int) -> float:
    """The prompt encoder and mask decoder on a ``g x g`` embedding."""
    dim, m = d["dim"], d["num_masks"]
    n, hw = 1 + m + 2, g * g

    def attn(nq, nk, inner):
        return 2.0 * nq * dim * inner + 2 * 2.0 * nk * dim * inner + _attention(nq, nk, inner) \
            + 2.0 * nq * inner * dim

    total = 2.0 * 2 * 2 * (dim // 2) + 2.0 * hw * 2 * (dim // 2)  # the Fourier features
    for _ in range(d["depth"]):
        total += attn(n, n, dim) + attn(n, hw, dim // 2) + 2 * 2.0 * n * dim * d["mlp_dim"]
        total += attn(hw, n, dim // 2)
    total += attn(n, hw, dim // 2)
    total += 2.0 * hw * 4 * dim * (dim // 4) + 2.0 * 4 * hw * 4 * (dim // 4) * (dim // 8)
    total += m * (2 * 2.0 * dim * dim + 2.0 * dim * (dim // 8))
    total += 2.0 * m * 16 * hw * (dim // 8)
    return total + 2 * 2.0 * dim * dim + 2.0 * dim * m


def pass_flops(spec: dict) -> float:
    """One VLM pass with the query's embedding cached: OWL-ViT's detection,
    SAM's encoder and decoder."""
    g = spec["sam"]["img_size"] // spec["sam"]["patch_size"]
    return owl_flops(spec["owl"]) + sam_flops(spec["sam"]) + decoder_flops(spec["decoder"], g)


# -- K7 ------------------------------------------------------------------------------


def k7_launch_bound_s(bh: int, side: int, head_dim: int) -> float:
    """K7's bound for one launch over ``bh`` heads x windows of a
    ``side x side`` grid: q, k, v read and the output written in bf16, the
    two f32 rel terms read once; q k^T and P v."""
    t = side * side
    nbytes = 2.0 * 4 * bh * t * head_dim + 4.0 * 2 * bh * t * side
    return bound_s(nbytes, 4.0 * bh * t * t * head_dim)


def k7_pass_bound_s(s: dict) -> float:
    """K7's bound over one image encoder pass: one launch per block."""
    hd = s["embed_dim"] // s["num_heads"]
    return sum(k7_launch_bound_s(w * s["num_heads"], n, hd) for w, n in sam_blocks(s))
