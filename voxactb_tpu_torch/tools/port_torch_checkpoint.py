"""Port a reference ``QAttentionAgent_layer0.pt`` onto the port's policy.

The port's copy of the JAX package's ``tools/port_torch_checkpoint.py``: the
reference saves ``QAttentionAgent_layer0.pt`` state_dicts
(qattention_peract_bc_agent.py:878-880) whose keys follow ``QFunction`` ->
``PerceiverVoxelLangEncoder`` (perceiver_lang_io.py:136-334), with a DDP
``module.`` prefix when trained distributed (stripped on load, :845-855).
``map_reference_qattention`` translates those tensors into the flax
parameter tree of the JAX package (numpy leaves, the same tree the JAX tool
makes), which both packages load.

Layout conversions:
  torch Conv3d  [out, in, kd, kh, kw] -> flax NDHWC kernel [kd, kh, kw, in, out]
  torch Linear  [out, in]             -> flax Dense kernel [in, out]

Usage:
  python -m voxactb_tpu_torch.tools.port_torch_checkpoint \\
      --ckpt QAttentionAgent_layer0.pt --out QAttentionAgent_layer0.msgpack \\
      [--depth 6] [--arm-pred] [--two-arm]

``--out`` ending in ``.msgpack`` writes the JAX tool's bytes (``{"params",
"step": 0}`` in flax's msgpack, through ``utils/msgpack_codec``); ending in
``.pt`` it writes the port's own checkpoint (``{"params": state_dict, "step":
0}``), for a ``weights/<step>/`` directory of the port. Both read as
``QAttentionBCAgent.load_weight`` files.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np


def _np(t):
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def _conv3d(sd, key):
    return {
        "kernel": _np(sd[f"{key}.conv3d.weight"]).transpose(2, 3, 4, 1, 0),
        "bias": _np(sd[f"{key}.conv3d.bias"]),
    }


def _dense_block(sd, key):
    return {
        "Dense_0": {
            "kernel": _np(sd[f"{key}.linear.weight"]).T,
            "bias": _np(sd[f"{key}.linear.bias"]),
        }
    }


def _linear(sd, key):
    return {"kernel": _np(sd[f"{key}.weight"]).T,
            "bias": _np(sd[f"{key}.bias"])}


def _ln(sd, key):
    return {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}


def _attention(sd, prenorm_key, has_context_norm):
    """reference PreNorm(Attention) pair -> PreNormAttention params."""
    out = {
        "norm": _ln(sd, f"{prenorm_key}.norm"),
        "attn": {
            "to_q": {"kernel": _np(sd[f"{prenorm_key}.fn.to_q.weight"]).T},
            "to_kv": {"kernel": _np(sd[f"{prenorm_key}.fn.to_kv.weight"]).T},
            "to_out": _linear(sd, f"{prenorm_key}.fn.to_out"),
        },
    }
    if has_context_norm:
        out["norm_context"] = _ln(sd, f"{prenorm_key}.norm_context")
    return out


def _feedforward(sd, prenorm_key):
    """reference PreNorm(FeedForward(net: Linear, GEGLU, Linear))."""
    return {
        "norm": _ln(sd, f"{prenorm_key}.norm"),
        "w_in": _linear(sd, f"{prenorm_key}.fn.net.0"),
        "w_out": _linear(sd, f"{prenorm_key}.fn.net.2"),
    }


def map_reference_qattention(state_dict: Dict, depth: int = 6,
                             arm_pred: bool = False,
                             two_arm_heads: bool = False) -> dict:
    """Reference ``QAttentionAgent_layer0.pt`` state_dict -> flax {'params': ...}."""
    # strip QFunction/DDP prefixes (load_weights behavior, :845-855)
    sd = {}
    for k, v in state_dict.items():
        for prefix in ("_qnet.module.", "_qnet."):
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        sd[k] = v

    p = {
        "input_preprocess": _conv3d(sd, "input_preprocess"),
        "patchify": _conv3d(sd, "patchify"),
        "proprio_preprocess": _dense_block(sd, "proprio_preprocess"),
        "lang_preprocess": _linear(sd, "lang_preprocess"),
        "pos_encoding": _np(sd["pos_encoding"]),
        "latents": _np(sd["latents"]),
        "cross_attend": _attention(sd, "cross_attend_blocks.0", True),
        "cross_ff": _feedforward(sd, "cross_attend_blocks.1"),
        "decoder_cross_attn": _attention(sd, "decoder_cross_attn", True),
        "final": _conv3d(sd, "final"),
        "trans_decoder": _conv3d(sd, "trans_decoder"),
        "dense0": _dense_block(sd, "dense0"),
        "dense1": _dense_block(sd, "dense1"),
        "rot_grip_collision_ff": _dense_block(sd, "rot_grip_collision_ff"),
    }
    for i in range(depth):
        p[f"self_attn_{i}"] = _attention(sd, f"layers.{i}.0", False)
        p[f"self_ff_{i}"] = _feedforward(sd, f"layers.{i}.1")

    # Conv3DUpsample: reference conv_up.0 (pre-upsample conv) and conv_up.2
    # (post-upsample conv -> the composed out_kernel/out_bias)
    p["up0"] = {
        "conv_in": _conv3d(sd, "up0.conv_up.0"),
        "out_kernel": _np(sd["up0.conv_up.2.conv3d.weight"]).transpose(
            2, 3, 4, 1, 0),
        "out_bias": _np(sd["up0.conv_up.2.conv3d.bias"]),
    }

    if arm_pred and "dense2.linear.weight" in sd:
        p["dense2"] = _dense_block(sd, "dense2")
        p["arm_ff"] = _dense_block(sd, "arm_ff")

    if two_arm_heads:
        p["trans_decoder_left"] = _conv3d(sd, "trans_decoder_left_arm")
        p["dense0_left"] = _dense_block(sd, "dense0_left_arm")
        p["dense1_left"] = _dense_block(sd, "dense1_left_arm")
        p["rot_grip_collision_ff_left"] = _dense_block(
            sd, "rot_grip_collision_ff_left_arm")

    return {"params": p}


def reference_key_shapes(depth: int = 6, voxel_size: int = 100,
                         low_dim: int = 4, im: int = 64, latents: int = 2048,
                         latent_dim: int = 512, arm_pred: bool = False) -> Dict:
    """Key -> shape of the reference checkpoint (PERACT_BC's widths by
    default), for synthetic checkpoints."""
    s = voxel_size // 5
    dim = im * 2
    flat = im * 4 + dim * 4 + im * 4
    shapes = {
        "input_preprocess.conv3d.weight": (im, 10, 1, 1, 1),
        "input_preprocess.conv3d.bias": (im,),
        "patchify.conv3d.weight": (im, im, 5, 5, 5),
        "patchify.conv3d.bias": (im,),
        "proprio_preprocess.linear.weight": (im, low_dim),
        "proprio_preprocess.linear.bias": (im,),
        "lang_preprocess.weight": (dim, 512),
        "lang_preprocess.bias": (dim,),
        "pos_encoding": (1, 77 + s ** 3, dim),
        "latents": (latents, latent_dim),
        "cross_attend_blocks.0.norm.weight": (latent_dim,),
        "cross_attend_blocks.0.norm.bias": (latent_dim,),
        "cross_attend_blocks.0.norm_context.weight": (dim,),
        "cross_attend_blocks.0.norm_context.bias": (dim,),
        "cross_attend_blocks.0.fn.to_q.weight": (64, latent_dim),
        "cross_attend_blocks.0.fn.to_kv.weight": (128, dim),
        "cross_attend_blocks.0.fn.to_out.weight": (latent_dim, 64),
        "cross_attend_blocks.0.fn.to_out.bias": (latent_dim,),
        "cross_attend_blocks.1.norm.weight": (latent_dim,),
        "cross_attend_blocks.1.norm.bias": (latent_dim,),
        "cross_attend_blocks.1.fn.net.0.weight": (latent_dim * 8, latent_dim),
        "cross_attend_blocks.1.fn.net.0.bias": (latent_dim * 8,),
        "cross_attend_blocks.1.fn.net.2.weight": (latent_dim, latent_dim * 4),
        "cross_attend_blocks.1.fn.net.2.bias": (latent_dim,),
        "decoder_cross_attn.norm.weight": (dim,),
        "decoder_cross_attn.norm.bias": (dim,),
        "decoder_cross_attn.norm_context.weight": (latent_dim,),
        "decoder_cross_attn.norm_context.bias": (latent_dim,),
        "decoder_cross_attn.fn.to_q.weight": (64, dim),
        "decoder_cross_attn.fn.to_kv.weight": (128, latent_dim),
        "decoder_cross_attn.fn.to_out.weight": (dim, 64),
        "decoder_cross_attn.fn.to_out.bias": (dim,),
        "up0.conv_up.0.conv3d.weight": (im, dim, 5, 5, 5),
        "up0.conv_up.0.conv3d.bias": (im,),
        "up0.conv_up.2.conv3d.weight": (im, im, 5, 5, 5),
        "up0.conv_up.2.conv3d.bias": (im,),
        "final.conv3d.weight": (im, im * 2, 3, 3, 3),
        "final.conv3d.bias": (im,),
        "trans_decoder.conv3d.weight": (1, im, 3, 3, 3),
        "trans_decoder.conv3d.bias": (1,),
        "dense0.linear.weight": (256, flat),
        "dense0.linear.bias": (256,),
        "dense1.linear.weight": (im, 256),
        "dense1.linear.bias": (im,),
        "rot_grip_collision_ff.linear.weight": (220, im),
        "rot_grip_collision_ff.linear.bias": (220,),
    }
    for i in range(depth):
        shapes.update({
            f"layers.{i}.0.norm.weight": (latent_dim,),
            f"layers.{i}.0.norm.bias": (latent_dim,),
            f"layers.{i}.0.fn.to_q.weight": (latent_dim, latent_dim),
            f"layers.{i}.0.fn.to_kv.weight": (latent_dim * 2, latent_dim),
            f"layers.{i}.0.fn.to_out.weight": (latent_dim, latent_dim),
            f"layers.{i}.0.fn.to_out.bias": (latent_dim,),
            f"layers.{i}.1.norm.weight": (latent_dim,),
            f"layers.{i}.1.norm.bias": (latent_dim,),
            f"layers.{i}.1.fn.net.0.weight": (latent_dim * 8, latent_dim),
            f"layers.{i}.1.fn.net.0.bias": (latent_dim * 8,),
            f"layers.{i}.1.fn.net.2.weight": (latent_dim, latent_dim * 4),
            f"layers.{i}.1.fn.net.2.bias": (latent_dim,),
        })
    if arm_pred:
        shapes.update({
            "dense2.linear.weight": (im, flat),
            "dense2.linear.bias": (im,),
            "arm_ff.linear.weight": (2, im),
            "arm_ff.linear.bias": (2,),
        })
    return shapes


def encoder_for(params: dict, depth: int):
    """The port's ``PerceiverVoxelLangEncoder`` (on the CPU, f32) whose
    parameters have the shapes of the flax tree ``params``: widths, grid and
    heads' sizes read off the tree (5^3 patches of stride 5 and 77 language
    tokens, as the reference's; 8 latent heads, which only split the widths)."""
    from voxactb_tpu_torch.models.perceiver import PerceiverVoxelLangEncoder

    p = params["params"]
    im = p["input_preprocess"]["kernel"].shape[-1]
    patch = p["patchify"]["kernel"].shape[0]
    dim = p["lang_preprocess"]["kernel"].shape[1]
    spatial = round((p["pos_encoding"].shape[1] - 77) ** (1 / 3))
    num_latents, latent_dim = p["latents"].shape
    two_heads = "trans_decoder_left" in p
    rot_out = p["rot_grip_collision_ff"]["Dense_0"]["kernel"].shape[1]
    return PerceiverVoxelLangEncoder(
        depth=depth, voxel_size=spatial * patch, initial_dim=p["input_preprocess"]["kernel"]
        .shape[3], low_dim_size=p["proprio_preprocess"]["Dense_0"]["kernel"].shape[0],
        num_rotation_classes=(rot_out - 4) // 3, num_latents=num_latents, im_channels=im,
        latent_dim=latent_dim, cross_dim_head=p["cross_attend"]["attn"]["to_q"]["kernel"]
        .shape[1], latent_heads=8,
        latent_dim_head=p["self_attn_0"]["attn"]["to_q"]["kernel"].shape[1] // 8
        if depth else 64, voxel_patch_size=patch, voxel_patch_stride=patch,
        final_dim=p["dense1"]["Dense_0"]["kernel"].shape[1],
        lang_emb_dim=p["lang_preprocess"]["kernel"].shape[0],
        arm_pred="dense2" in p, num_proprio=dim // im - 1, two_arm_heads=two_heads)


def write_checkpoint(params: dict, out: str, depth: int) -> None:
    """``params`` (the flax tree) as ``out``: flax's msgpack ``{"params",
    "step": 0}`` for a ``.msgpack`` path, else the port's ``torch.save``
    checkpoint ``{"params": state_dict, "step": 0}``."""
    if out.endswith(".msgpack"):
        from voxactb_tpu_torch.utils import msgpack_codec

        msgpack_codec.save(out, {"params": msgpack_codec.to_state_dict(params), "step": 0})
        return
    import torch
    from voxactb_tpu_torch.weights import load_flax_params

    model = encoder_for(params, depth)
    load_flax_params(model, params)
    torch.save({"params": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "step": 0}, out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True, help="a .msgpack (JAX format) or .pt path")
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--arm-pred", action="store_true")
    ap.add_argument("--two-arm", action="store_true")
    args = ap.parse_args(argv)

    import torch

    sd = torch.load(args.ckpt, map_location="cpu")
    params = map_reference_qattention(sd, args.depth, args.arm_pred, args.two_arm)
    write_checkpoint(params, args.out, args.depth)
    print(f"ported {args.ckpt} -> {args.out}")


if __name__ == "__main__":
    main()
