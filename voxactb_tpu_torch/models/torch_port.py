"""torch -> flax tensor-porting helpers of the weight importers.

The port's copy of ``voxactb_tpu.models.torch_port`` (numpy only): each
importer (CLIP text and image, OWL-ViT, SAM encoder and decoder) maps an
upstream ``state_dict`` onto the flax-layout numpy tree the JAX package's
importer returns, leaf for leaf, and loads that tree into the port's module
through ``weights.load_flax_params``. One factory keeps the porting
subtleties (dense transpose, the ConvTranspose spatial flip) in one place.
"""

from __future__ import annotations

import numpy as np


def make_port_helpers(state_dict, prefix: str = ""):
    """Returns (a, dense, ln, sam_attn, conv_t) closures over ``state_dict``.

    - ``a(key)``: tensor -> f32 numpy (detaches torch tensors, passes numpy).
    - ``dense(key)``: torch Linear [out, in] -> flax {"kernel" [in, out], "bias"}.
    - ``ln(key)``: torch LayerNorm -> flax {"scale", "bias"}.
    - ``sam_attn(key)``: SAM q/k/v/out projection group.
    - ``conv_t(key)``: torch ConvTranspose2d [in, out, kh, kw] -> flax
      [kh, kw, in, out], spatially flipped: flax's ConvTranspose uses the
      kernel in forward-conv orientation (``weights.py`` flips it back into
      the port's ``ConvTranspose2D``, which holds torch's layout).

    A missing key raises ``KeyError`` naming it.
    """

    def a(key):
        v = state_dict[prefix + key]
        if hasattr(v, "detach"):
            v = v.detach().cpu().float().numpy()
        return np.asarray(v, np.float32)

    def dense(key):
        return {"kernel": a(key + ".weight").T, "bias": a(key + ".bias")}

    def ln(key):
        return {"scale": a(key + ".weight"), "bias": a(key + ".bias")}

    def sam_attn(key):
        return {"q": dense(key + ".q_proj"), "k": dense(key + ".k_proj"),
                "v": dense(key + ".v_proj"), "out": dense(key + ".out_proj")}

    def conv_t(key):
        w = a(key + ".weight").transpose(2, 3, 0, 1)[::-1, ::-1]
        return {"kernel": np.ascontiguousarray(w), "bias": a(key + ".bias")}

    return a, dense, ln, sam_attn, conv_t
