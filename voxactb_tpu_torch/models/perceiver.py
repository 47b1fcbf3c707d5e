"""PerceiverIO voxel-language Q-network (inference and training), PyTorch.

Counterpart of ``voxactb_tpu.models.perceiver`` (itself the behavioural twin of
``PerceiverVoxelLangEncoder``, peract/agents/peract_bc/perceiver_lang_io.py).
Submodule and parameter names follow the flax tree so the weight bridge
(``voxactb_tpu_torch.weights``) maps one onto the other by name.

Shape walk at N=100, patch 5/5: voxel grid [B,100^3,10] --1x1x1--> d0 [..,64]
--k5/s5--> [B,20^3,64] --+proprio--> [B,20^3,128] --+77 lang tokens + pos-->
[B,8077,128] --cross-attn into 2048 latents, 6 self-attn layers, decoder
cross-attn--> [B,8000,128] --x5 upsample + skip-concat d0 + k3 conv--> u
[B,100^3,64] --k3--> Q_trans; MLP heads off (soft-argmax || global max) stats.

Three paths take the hand-written kernels (``ops/cuda``), exactly where the
JAX package takes its Pallas kernels: ``front=`` (from the fused front,
``pallas_front``), ``pallas_attention`` at bf16, ``pallas_decoder``. Under
``train=True`` those three are off, as in the JAX package, and
``pallas_attention_train`` at bf16 takes the trainable attention kernel with
its in-kernel dropout; every other op differentiates through torch autograd.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from voxactb_tpu_torch.models.blocks import (
    Conv3D, Conv3DUpsample, Dense, DenseBlock, LayerNorm, softargmax_stats_3d)


class Attention(nn.Module):
    """Multi-head attention, queries from ``x``, keys/values from ``context``
    (perceiver_lang_io.py:93-132): no-bias q/k/v projections (flax's fused
    ``to_kv`` is split into ``to_k`` and ``to_v``), biased output projection,
    post-softmax dropout. Softmax runs in f32 regardless of the compute dtype.

    Dropout, on either path, keeps the elements that ``keep_mask`` of
    ``ops/cuda/flash_attention_train`` derives from a seed: the caller draws
    the seed (from its generator, on the device) and passes it in, so a
    recomputed forward (``torch.utils.checkpoint``) sees the same mask."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int,
                 out_dim: int, dropout: float = 0.0, flash: bool = False,
                 flash_train: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.dropout = dropout
        self.flash = flash
        self.flash_train = flash_train
        self.dtype = dtype
        self.to_q = Dense(query_dim, inner, use_bias=False, dtype=dtype,
                          generator=generator)
        # flax initialises to_kv as one [context_dim, 2 * inner] lecun-normal kernel
        self.to_k = Dense(context_dim, inner, use_bias=False, dtype=dtype,
                          generator=generator)
        self.to_v = Dense(context_dim, inner, use_bias=False, dtype=dtype,
                          generator=generator)
        self.to_out = Dense(inner, out_dim, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None, *,
                train: bool = False, seed: Optional[torch.Tensor] = None):
        context = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)

        def split_heads(t):
            b, n, _ = t.shape
            return t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = map(split_heads, (q, k, v))
        scale = self.dim_head ** -0.5
        b, h, n, d = q.shape
        dropout = self.dropout if train else 0.0
        if dropout > 0.0 and seed is None:
            raise ValueError("attention dropout in train mode needs a seed")
        bf16 = self.dtype == torch.bfloat16
        flat = lambda t: t.reshape(b * h, t.shape[2], d)
        if self.flash and not train and bf16:
            from voxactb_tpu_torch.ops.cuda.flash_attention import flash_attention

            # q scaled in the compute dtype before the kernel, as the JAX flash path
            out = flash_attention(flat(q * scale), flat(k), flat(v)).reshape(b, h, n, d)
        elif self.flash_train and train and bf16:
            from voxactb_tpu_torch.ops.cuda.flash_attention_train import (
                flash_attention_train)

            out = flash_attention_train(flat(q * scale), flat(k), flat(v),
                                        0 if seed is None else seed,
                                        dropout=dropout).reshape(b, h, n, d)
        else:
            sim = torch.matmul(q.to(torch.float32),
                               k.to(torch.float32).transpose(-1, -2))
            attn = torch.softmax(sim * scale, dim=-1)
            if dropout > 0.0:
                from voxactb_tpu_torch.ops.cuda.flash_attention_train import keep_mask

                keep = keep_mask(seed, b * h, n, k.shape[2], dropout).reshape(sim.shape)
                attn = attn * keep.to(torch.float32) * (1.0 / (1.0 - dropout))
            out = torch.matmul(attn.to(v.dtype).to(torch.float32),
                               v.to(torch.float32))
        out = out.transpose(1, 2).reshape(b, n, h * d).to(self.dtype)
        return self.to_out(out)


class PreNormAttention(nn.Module):
    """LayerNorm(x) [+ LayerNorm(context)] -> Attention (perceiver_lang_io.py:56-71)."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int,
                 out_dim: int, dropout: float = 0.0, norm_context: bool = False,
                 flash: bool = False, flash_train: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm = LayerNorm(query_dim, dtype=dtype)
        self.norm_context = LayerNorm(context_dim, dtype=dtype) if norm_context else None
        self.attn = Attention(query_dim, context_dim, heads, dim_head, out_dim,
                              dropout=dropout, flash=flash, flash_train=flash_train,
                              dtype=dtype, generator=generator)

    def forward(self, x, context=None, *, train: bool = False, seed=None):
        y = self.norm(x)
        if context is not None and self.norm_context is not None:
            context = self.norm_context(context)
        return self.attn(y, context, train=train, seed=seed)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation, its default) op by op in ``x``'s
    dtype with the constants rounded to it. At bf16 this is bit-identical to
    the JAX package; ``F.gelu(x, approximate="tanh")`` rounds once at the end
    and differs from it in about 40% of bf16 outputs by one ulp."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    inner = c(math.sqrt(2.0 / math.pi)) * (x + c(0.044715) * x ** 3)
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


class FeedForward(nn.Module):
    """PreNorm GEGLU MLP: dim -> dim*mult (gated) -> dim (perceiver_lang_io.py:74-90),
    with the tanh-approximate gelu of ``jax.nn.gelu``."""

    def __init__(self, dim: int, mult: int = 4, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm = LayerNorm(dim, dtype=dtype)
        self.w_in = Dense(dim, dim * mult * 2, dtype=dtype, generator=generator)
        self.w_out = Dense(dim * mult, dim, dtype=dtype, generator=generator)

    def forward(self, x):
        y = self.w_in(self.norm(x))
        y, gates = y.chunk(2, dim=-1)
        return self.w_out(y * gelu_tanh(gates))


class PerceiverVoxelLangEncoder(nn.Module):
    """Voxel grid + language + proprio -> Q values for trans/rot/grip/collision.
    ``arm_pred=True`` adds the acting/stabilizing arm-ID head;
    ``num_proprio=2, two_arm_heads=True`` is the 'one_policy_more_heads'
    variant (right/left heads off one trunk)."""

    def __init__(self, depth: int = 6, iterations: int = 1, voxel_size: int = 100,
                 initial_dim: int = 10, low_dim_size: int = 4,
                 num_rotation_classes: int = 72, num_grip_classes: int = 2,
                 num_collision_classes: int = 2, num_latents: int = 2048,
                 im_channels: int = 64, latent_dim: int = 512, cross_heads: int = 1,
                 latent_heads: int = 8, cross_dim_head: int = 64,
                 latent_dim_head: int = 64, activation: str = "lrelu",
                 input_dropout: float = 0.1, attn_dropout: float = 0.1,
                 decoder_dropout: float = 0.0, voxel_patch_size: int = 5,
                 voxel_patch_stride: int = 5,
                 final_dim: int = 64, lang_emb_dim: int = 512,
                 lang_max_seq_len: int = 77, no_skip_connection: bool = False,
                 no_perceiver: bool = False, no_language: bool = False,
                 arm_pred: bool = False, num_proprio: int = 1,
                 two_arm_heads: bool = False, fused_upsample: bool = True,
                 pallas_decoder: bool = False, pallas_attention: bool = False,
                 pallas_attention_train: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.depth = depth
        self.iterations = iterations
        self.voxel_size = voxel_size
        self.low_dim_size = low_dim_size
        self.num_rotation_classes = num_rotation_classes
        self.num_collision_classes = num_collision_classes
        self.num_latents = num_latents
        self.im_channels = im_channels
        self.latent_dim = latent_dim
        self.activation = activation
        self.voxel_patch_size = voxel_patch_size
        self.voxel_patch_stride = voxel_patch_stride
        self.final_dim = final_dim
        self.lang_max_seq_len = lang_max_seq_len
        self.no_skip_connection = no_skip_connection
        self.no_perceiver = no_perceiver
        self.no_language = no_language
        self.arm_pred = arm_pred
        self.num_proprio = num_proprio
        self.two_arm_heads = two_arm_heads
        self.pallas_decoder = pallas_decoder
        self.dtype = dtype

        spatial = voxel_size // voxel_patch_stride
        dim = im_channels * (1 + num_proprio)
        self.input_dim_before_seq = dim

        self.input_preprocess = Conv3D(initial_dim, im_channels, 1, 1, activation,
                                       dtype=dtype, generator=g)
        self.patchify = Conv3D(im_channels, im_channels, voxel_patch_size,
                               voxel_patch_stride, activation, dtype=dtype, generator=g)
        if low_dim_size > 0:
            self.proprio_preprocess = DenseBlock(low_dim_size, im_channels, activation,
                                                 dtype=dtype, generator=g)
        self.lang_preprocess = Dense(lang_emb_dim, dim, dtype=dtype, generator=g)
        self.pos_encoding = nn.Parameter(torch.empty(1, lang_max_seq_len + spatial ** 3, dim))
        self.latents = nn.Parameter(torch.empty(num_latents, latent_dim))
        with torch.no_grad():
            self.pos_encoding.normal_(0.0, 1.0, generator=g)
            self.latents.normal_(0.0, 1.0, generator=g)

        flash = dict(flash=pallas_attention, flash_train=pallas_attention_train)
        self.dropouts = (input_dropout, attn_dropout, decoder_dropout)
        self.cross_attend = PreNormAttention(latent_dim, dim, cross_heads, cross_dim_head,
                                             latent_dim, input_dropout, norm_context=True,
                                             dtype=dtype, generator=g, **flash)
        self.cross_ff = FeedForward(latent_dim, dtype=dtype, generator=g)
        for i in range(depth):
            setattr(self, f"self_attn_{i}", PreNormAttention(
                latent_dim, latent_dim, latent_heads, latent_dim_head, latent_dim,
                attn_dropout, dtype=dtype, generator=g, **flash))
            setattr(self, f"self_ff_{i}", FeedForward(latent_dim, dtype=dtype,
                                                      generator=g))
        self.decoder_cross_attn = PreNormAttention(
            dim, latent_dim, cross_heads, cross_dim_head, dim, decoder_dropout,
            norm_context=True, dtype=dtype, generator=g, **flash)

        self.up0 = Conv3DUpsample(dim, final_dim, voxel_patch_stride, voxel_patch_size,
                                  activation, fast=fused_upsample, dtype=dtype,
                                  generator=g)
        final_in = (final_dim if no_skip_connection else
                    im_channels if no_perceiver else im_channels + final_dim)
        self.final = Conv3D(final_in, im_channels, 3, 1, activation, dtype=dtype,
                            generator=g)
        heads = ["", "_left"] if two_arm_heads else [""]
        # (kp 3C + gmax C) of d0 and of u, (kp 3dim + gmax dim) of the patch grid
        feat_dim = 8 * im_channels + 4 * dim
        for sfx in heads:
            setattr(self, f"trans_decoder{sfx}", Conv3D(im_channels, 1, 3, 1, None,
                                                        dtype=dtype, generator=g))
        for sfx in heads:
            setattr(self, f"dense0{sfx}", DenseBlock(feat_dim, 256, activation,
                                                     dtype=dtype, generator=g))
            setattr(self, f"dense1{sfx}", DenseBlock(256, final_dim, activation,
                                                     dtype=dtype, generator=g))
            setattr(self, f"rot_grip_collision_ff{sfx}", DenseBlock(
                final_dim, num_rotation_classes * 3 + num_grip_classes
                + num_collision_classes, None, dtype=dtype, generator=g))
        if arm_pred and not two_arm_heads:
            self.dense2 = DenseBlock(feat_dim, final_dim, activation, dtype=dtype,
                                     generator=g)
            self.arm_ff = DenseBlock(final_dim, 2, None, dtype=dtype, generator=g)

    def _tail_eligible(self) -> bool:
        return (self.pallas_decoder and not self.no_skip_connection
                and not self.no_perceiver and self.activation == "lrelu"
                and self.im_channels == self.final_dim)

    def num_dropout_seeds(self) -> int:
        """One seed per attention call of a forward."""
        return self.iterations * (1 + self.depth) + 1

    def draw_dropout_seeds(self, generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
        """The dropout seeds of one train-mode forward: int64 values below
        2^32, drawn on the parameters' device (no host sync) from ``generator``
        (None: that device's default generator)."""
        return torch.randint(0, 1 << 32, (self.num_dropout_seeds(),), dtype=torch.int64,
                             device=self.latents.device, generator=generator)

    def forward(self, voxel_grid: torch.Tensor, proprio: torch.Tensor,
                lang_goal_emb: Optional[torch.Tensor], lang_token_embs: torch.Tensor,
                *, train: bool = False, dropout_seeds: Optional[torch.Tensor] = None,
                front=None):
        """``voxel_grid [B,N,N,N,10]`` (channels last), ``proprio [B, low_dim]``
        or ``[B, 2, low_dim]``, ``lang_token_embs [B, 77, 512]``. ``front``,
        when given, is ``(d0, patch_tokens, kp0, gmax0)`` from the fused front
        kernel; ``voxel_grid`` then only carries the batch size. ``train=True``
        applies dropout from ``dropout_seeds`` (``draw_dropout_seeds``; drawn
        here from the default generator when not given) and keeps to the
        differentiable ops."""
        del lang_goal_emb  # 'seq' fusion conditions on token embeddings only
        if train and front is not None:
            raise ValueError("the fused front is an inference path")
        seeds = [None] * self.num_dropout_seeds()
        if train and any(d > 0.0 for d in self.dropouts):
            if dropout_seeds is None:
                dropout_seeds = self.draw_dropout_seeds()
            seeds = list(dropout_seeds.unbind(0))
        seeds = iter(seeds)
        dt = self.dtype
        b = voxel_grid.shape[0]
        spatial = self.voxel_size // self.voxel_patch_stride
        dim = self.input_dim_before_seq

        if front is not None:
            d0, ins, kp0, gmax0 = front
            d0, ins = d0.to(dt), ins.to(dt)
        else:
            d0 = self.input_preprocess(voxel_grid.to(dt))
            kp0, gmax0 = softargmax_stats_3d(d0)
            ins = self.patchify(d0)
        feats = [kp0, gmax0]

        if self.low_dim_size > 0:
            p = proprio.reshape(b, self.num_proprio, self.low_dim_size)
            p = self.proprio_preprocess(p.to(dt))
            p = p.reshape(b, 1, 1, 1, self.num_proprio * self.im_channels).expand(
                b, spatial, spatial, spatial, self.num_proprio * self.im_channels)
            ins = torch.cat([ins, p], -1)
        ins = ins.reshape(b, spatial ** 3, dim)

        if self.no_language:
            lang_token_embs = torch.zeros_like(lang_token_embs)
        lang = self.lang_preprocess(lang_token_embs.to(dt))
        seq = torch.cat([lang, ins], 1) + self.pos_encoding.to(dt)

        x = self.latents[None].to(dt).expand(b, self.num_latents, self.latent_dim)
        for _ in range(self.iterations):
            x = self.cross_attend(x, seq, train=train, seed=next(seeds)) + x
            x = self.cross_ff(x) + x
            for i in range(self.depth):
                x = getattr(self, f"self_attn_{i}")(x, train=train, seed=next(seeds)) + x
                x = getattr(self, f"self_ff_{i}")(x) + x

        decoded = self.decoder_cross_attn(seq, x, train=train, seed=next(seeds))
        grid = decoded[:, self.lang_max_seq_len:].reshape(b, spatial, spatial, spatial, dim)
        kp1, gmax1 = softargmax_stats_3d(grid)
        feats.extend([kp1, gmax1])

        u0 = self.up0(grid)
        heads = ["", "_left"] if self.two_arm_heads else [""]
        trans = {}
        if self._tail_eligible() and not train:
            from voxactb_tpu_torch.ops.cuda.decoder_head import decoder_head

            tds = [getattr(self, f"trans_decoder{s}") for s in heads]
            wt = torch.stack([td.kernel_dhwio() for td in tds])
            bt = torch.cat([td.bias for td in tds])
            trans_all, kp_u, gmax_u = decoder_head(
                d0, u0, self.final.kernel_dhwio(), self.final.bias, wt, bt)
            for i, s in enumerate(heads):
                trans[s] = trans_all[..., i:i + 1]
        else:
            if self.no_skip_connection:
                u = self.final(u0)
            elif self.no_perceiver:
                u = self.final(d0)
            else:
                u = self.final(torch.cat([d0, u0], -1))
            kp_u, gmax_u = softargmax_stats_3d(u)
            for s in heads:
                # the conv rounds to the compute dtype, then the f32 view
                trans[s] = getattr(self, f"trans_decoder{s}")(u).to(torch.float32)

        cat = torch.cat(feats + [kp_u, gmax_u], 1).to(dt)
        out = {}
        for s in heads:
            h0 = getattr(self, f"dense0{s}")(cat)
            h1 = getattr(self, f"dense1{s}")(h0)
            rgc = getattr(self, f"rot_grip_collision_ff{s}")(h1)
            nc = self.num_collision_classes
            key = {"": "right", "_left": "left"}[s] if self.two_arm_heads else None
            names = (("trans", "rot_grip", "collision") if key is None else
                     (f"trans_{key}", f"rot_grip_{key}", f"collision_{key}"))
            out[names[0]] = trans[s]
            out[names[1]] = rgc[:, :-nc].to(torch.float32)
            out[names[2]] = rgc[:, -nc:].to(torch.float32)
        if self.arm_pred and not self.two_arm_heads:
            h2 = self.dense2(cat)
            out["arm"] = self.arm_ff(h2).to(torch.float32)
        return out
