"""The act program as CUDA graphs (``ops/cuda/graphs``).

On the CPU: ``make_infer_fn``'s ``infer`` runs the program eagerly and counts
no capture or replay; the graph key follows the inputs' shapes and the model's
parameter storage and not an in-place load; the activations' constants, now
Python floats rounded to the operand's dtype, give the bits of the 0-dim
tensor constants they replace; and the upsample's tap matrix, now made once
per device, composes the same kernels.

On the card (marked ``card``; skip without CUDA; no JAX imported, so the
file runs where the port runs: ``python -m pytest
tests/test_torch_act_graph.py -m card --noconftest -q``): every field of a
replayed act is bit-equal to the eager program's at the 100^3 scene policy,
the 50^3 crop policy with bounds that move on every call, the two-head
variant and the dense path, against the program run inside
``graphs.eager()``; an in-place weight load is read without a new
capture, every operand of the weight mirror made again; outputs stay as
returned; two shapes alternate; two threads acting on one agent each get
their eager result; and the counters (the mirror's operands made once per
model) and ``ops/cuda.LAUNCHES`` count as the module says. The clouds put at most one
point in a voxel, so the front kernel's atomic sums are exact and two runs of
the program give the same bits.
"""

import dataclasses
import math
import threading

import numpy as np
import pytest
import torch

from voxactb_tpu_torch.agents.qfunction import build_encoder, make_infer_fn
from voxactb_tpu_torch.config import MethodConfig
from voxactb_tpu_torch.models import blocks
from voxactb_tpu_torch.ops import upsample_conv
from voxactb_tpu_torch.ops.cuda import LAUNCHES, graphs
from voxactb_tpu_torch.ops.cuda.decoder_head_v3 import phase_weight_table
from voxactb_tpu_torch.utils.profiling import collect

SCENE = np.array([[-0.8, -1.0, 0.1, 1.2, 1.0, 2.1]], np.float32)
TINY = dict(voxel_sizes=[10], num_latents=16, latent_dim=32, transformer_depth=1,
            latent_heads=2, latent_dim_head=16, cross_dim_head=16)
KERNELS = dict(compute_dtype="bfloat16", pallas_front=True, pallas_attention=True,
               pallas_decoder=True)
FIELDS = ("trans_idx", "rot_grip_idx", "collision_idx", "attention_coordinate",
          "continuous_action", "q_trans", "voxel_grid", "front_overflow")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def observation(rng, cfg, bounds, cameras=4, res=128, batch=1):
    """``infer``'s host arguments after the model: ``cameras`` clouds of
    ``res``^2 points in distinct voxels of the grid over ``bounds`` (each
    within 0.3 of a voxel from its centre), colours in [0, 255]."""
    n = cfg.voxel_size
    p = cameras * res * res
    lo, hi = bounds[0, :3].astype(np.float64), bounds[0, 3:].astype(np.float64)
    pcds, rgbs = [], []
    for _ in range(batch):
        cells = rng.choice(n ** 3, size=p, replace=False)
        ijk = np.stack([cells // (n * n), (cells // n) % n, cells % n], -1)
        pts = lo + (ijk + 0.5 + rng.uniform(-0.3, 0.3, (p, 3))) * (hi - lo) / n
        pcds.append(pts.astype(np.float32).reshape(cameras, res, res, 3))
        rgbs.append(rng.uniform(0, 255, (cameras, res, res, 3)).astype(np.float32))
    pcds, rgbs = np.stack(pcds, 1), np.stack(rgbs, 1)  # [cameras, B, res, res, 3]
    return (list(rgbs), list(pcds),
            rng.normal(size=(batch, cfg.proprio_width())).astype(np.float32),
            rng.normal(size=(batch, 1024)).astype(np.float32),
            rng.normal(size=(batch, 77, 512)).astype(np.float32),
            np.repeat(bounds, batch, 0))


def bits(t):
    """``t``'s bits as integers of its width."""
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def eager(infer, model, args):
    """``infer``'s program run eagerly on ``args``."""
    with graphs.eager():
        return infer(model, *args)


def assert_bit_equal(got, want):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.equal(bits(a), bits(b)), f"{name} differs from the eager program's"


# -- CPU ---------------------------------------------------------------------------


def test_cpu_infer_is_the_eager_program_and_counts_no_graph():
    cfg = MethodConfig(**TINY, **KERNELS)
    model, infer = make_infer_fn(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    args = observation(rng, cfg, SCENE, cameras=2, res=8)
    with collect() as coll:
        outs = [infer(model, *args) for _ in range(2)] + [eager(infer, model, args)]
    assert_bit_equal(outs[1], outs[0])
    assert_bit_equal(outs[2], outs[0])
    counts = coll.as_dict()["counts"]
    assert counts.get("act.graph_captures", 0) == 0
    assert counts.get("act.graph_replays", 0) == 0


def test_graph_key_follows_shapes_and_storage_not_in_place_loads():
    cfg = MethodConfig(**TINY, **KERNELS)
    model = build_encoder(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(1)
    args = observation(rng, cfg, SCENE, cameras=2, res=8)

    def graph_key(model, args):  # the act's key, as ``make_infer_fn``'s ``infer`` makes it
        rgbs, pcds, *rest = args
        return graphs.key(graphs.storage(model), (), (*rgbs, *pcds, *rest))

    key = graph_key(model, args)
    assert graph_key(model, observation(rng, cfg, SCENE, cameras=2, res=8)) == key
    # shapes, camera count and dtypes of the inputs
    assert graph_key(model, observation(rng, cfg, SCENE, cameras=2, res=8,
                                                  batch=2)) != key
    assert graph_key(model, observation(rng, cfg, SCENE, cameras=2, res=4)) != key
    assert graph_key(model, observation(rng, cfg, SCENE, cameras=3, res=8)) != key
    wide = (args[0], args[1], args[2].astype(np.float64), *args[3:])
    assert graph_key(model, wide) != key
    moved = (args[0], args[1], args[2], args[3], args[4], torch.as_tensor(args[5]))
    assert graph_key(model, moved) == key  # a host tensor is a host array
    # an in-place load keeps the storage; a new parameter or buffer does not
    other = build_encoder(cfg, device="cpu", seed=1)
    model.load_state_dict(other.state_dict())
    assert graph_key(model, args) == key
    with torch.no_grad():
        model.final.bias.add_(1.0)
    assert graph_key(model, args) == key
    model.final.bias = torch.nn.Parameter(model.final.bias.detach().clone())
    assert graph_key(model, args) != key
    key = graph_key(model, args)
    model.to(torch.float64)
    assert graph_key(model, args) != key


def _lrelu_before(x, slope=blocks.LRELU_SLOPE):
    s = torch.tensor(slope, dtype=x.dtype, device=x.device)
    return torch.where(x >= 0, x, x * s)


def _sigmoid_before(x):
    one = torch.tensor(1.0, dtype=x.dtype, device=x.device)
    return one / (one + torch.exp(-x))


def _gelu_erf_before(x):
    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    return c(0.5) * x * torch.special.erfc(-x * c(math.sqrt(0.5)))


def _gelu_tanh_before(x):
    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    inner = c(math.sqrt(2.0 / math.pi)) * (x + c(0.044715) * x ** 3)
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


ACTIVATIONS = {"lrelu": (blocks.lrelu, _lrelu_before),
               "sigmoid": (blocks.sigmoid, _sigmoid_before),
               "gelu_erf": (blocks.gelu_erf, _gelu_erf_before),
               "gelu_tanh": (blocks.gelu_tanh, _gelu_tanh_before)}


def activation_inputs(dtype, device="cpu"):
    """Every finite bf16 value from -16 to 16 and a normal draw, in ``dtype``."""
    codes = torch.arange(0, 1 << 16, dtype=torch.int32).to(torch.int16)
    every = codes.view(torch.bfloat16).float()
    every = every[torch.isfinite(every) & (every.abs() <= 16)]
    draw = torch.randn(1 << 16, generator=torch.Generator().manual_seed(0)) * 4
    return torch.cat([every, draw]).to(dtype).to(device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_constants_bit_identical_to_tensor_constants(name, dtype):
    new, old = ACTIVATIONS[name]
    x = activation_inputs(dtype)
    got, want = new(x), old(x)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_phase_taps_compose_the_kernels_the_host_copy_did(dtype):
    g = torch.Generator().manual_seed(2)
    kernel = (torch.randn((3, 3, 3, 8, 8), generator=g) * 0.1).to(dtype)
    taps = torch.as_tensor(upsample_conv._phase_tap_matrix(5, 3))
    want = kernel
    for _ in range(3):
        want = torch.tensordot(want.to(torch.float32), taps.to(dtype).to(torch.float32),
                               dims=([0], [1])).to(dtype)
    want = want.permute(3, 5, 7, 0, 2, 4, 6, 1).reshape(3, 3, 3, 8, 125 * 8)
    assert torch.equal(upsample_conv.compose_upsample_kernel(kernel, 5), want)
    up = torch.randn((5, 5, 5, 8, 8), generator=g)
    t = torch.as_tensor(upsample_conv._phase_tap_matrix(5, 5), dtype=torch.float32)
    w8 = torch.einsum("aud,bve,cwf,uvwio->defiabco", t, t, t, up)
    table = w8.permute(4, 5, 0, 1, 3, 2, 6, 7).reshape(5, 5, 72, 120)
    assert torch.equal(phase_weight_table(up), table)


# -- the card --------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `python -m pytest tests/test_torch_act_graph.py "
                    "-m card --noconftest -q` on the card")
    return torch.device("cuda")


def card_config(kind):
    """The 100^3 scene policy, the 50^3 crop policy, the two-head variant
    and the dense path (K5, K6, K8 in place of K1 and K3), all at published
    widths."""
    if kind == "scene100":
        return MethodConfig(voxel_sizes=[100], **KERNELS)
    crop = MethodConfig(voxel_sizes=[50], **KERNELS)
    if kind == "crop50":
        return crop
    if kind == "two_heads50":
        return dataclasses.replace(crop, variant="one_policy_more_heads")
    return MethodConfig(voxel_sizes=[100], compute_dtype="bfloat16", pallas_attention=True,
                        pallas_encoder=True, pallas_stats=True, pallas_decoder_v3=True)


def crop_bounds(rng):
    """A 0.3 m crop around a point of the scene, as VoxAct-B's VLM gives it."""
    centre = rng.uniform(SCENE[0, :3] + 0.3, SCENE[0, 3:] - 0.3)
    return np.concatenate([centre - 0.15, centre + 0.15])[None].astype(np.float32)


@pytest.mark.card
@pytest.mark.parametrize("kind", ["scene100", "crop50", "two_heads50", "dense100"])
def test_replays_bit_equal_to_the_eager_program(card, kind):
    cfg = card_config(kind)
    model, infer = make_infer_fn(cfg, device=card, seed=0)
    rng = np.random.default_rng(3)
    for _ in range(4):  # the capture, then three replays
        bounds = SCENE if kind in ("scene100", "dense100") else crop_bounds(rng)
        args = observation(rng, cfg, bounds)
        assert_bit_equal(infer(model, *args), eager(infer, model, args))


def mirrored_operands(model):
    """The operands the act's weight mirror holds for a bf16 one-head model
    with K1-K3: every ``Dense`` layer's weight and bias in bf16, the
    Perceiver's position encoding and latents, K1's w1 and wp layouts (its
    bias is read as it is), ``up0``'s inner conv kernel, outer kernel, bias
    and composed kernel, the trans heads stacked (wt, bt) and K3's wf and wt
    layouts (bf and bt are read as they are)."""
    dense = sum(1 + (m.bias is not None) for m in model.modules()
                if isinstance(m, blocks.Dense))
    return dense + 2 + 2 + 4 + 2 + 2


@pytest.mark.card
def test_in_place_load_is_replayed_without_a_capture(card):
    cfg = card_config("crop50")
    model, infer = make_infer_fn(cfg, device=card, seed=0)
    other = build_encoder(cfg, device=card, seed=1)
    rng = np.random.default_rng(4)
    args = observation(rng, cfg, crop_bounds(rng))
    with collect() as coll:
        first = infer(model, *args)
        model.load_state_dict(other.state_dict())
        got = infer(model, *args)
    # the mirror's operands made in the first call, then every one made again
    # after the load, which writes every parameter
    assert coll.as_dict()["counts"] == {"act.graph_captures": 1, "act.graph_replays": 1,
                                        "act.weight_casts": 2 * mirrored_operands(model)}
    assert_bit_equal(got, eager(infer, other, args))
    assert not torch.equal(got.q_trans, first.q_trans)


@pytest.mark.card
def test_outputs_stay_as_returned_and_shapes_alternate(card):
    cfg = card_config("crop50")
    model, infer = make_infer_fn(cfg, device=card, seed=0)
    rng = np.random.default_rng(5)
    calls = [observation(rng, cfg, crop_bounds(rng), batch=1 + i % 2) for i in range(6)]
    with collect() as coll:
        outs = [infer(model, *args) for args in calls]
    # the two keys' programs share the model's weight mirror, made in the first
    assert coll.as_dict()["counts"] == {"act.graph_captures": 2, "act.graph_replays": 4,
                                        "act.weight_casts": mirrored_operands(model)}
    for args, out in zip(calls, outs):
        assert_bit_equal(out, eager(infer, model, args))


@pytest.mark.card
def test_threads_acting_on_one_agent_get_their_eager_results(card):
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent

    cfg = card_config("crop50")
    cams = ["front", "wrist"]
    agent = QAttentionBCAgent(cfg, cams, SCENE[0], device=card)
    agent.build(training=False)
    rng = np.random.default_rng(6)
    observations = []
    for _ in range(2):
        args = observation(rng, cfg, SCENE, cameras=2)
        obs = {"low_dim_state": args[2][0], "lang_goal_emb": args[3][0],
               "lang_token_embs": args[4][0]}
        for c, rgb, pcd in zip(cams, args[0], args[1]):
            obs[f"{c}_rgb"], obs[f"{c}_point_cloud"] = rgb[0], pcd[0]
        want = eager(agent._infer, agent._model, agent._act_inputs(obs, None, None, False))
        observations.append((obs, want.continuous_action[0].cpu().numpy()))
    agent.act(0, observations[0][0])  # the capture
    failures = []

    def worker(i):
        obs, want = observations[i]
        for step in range(20):
            got = agent.act(step, obs).action
            if not np.array_equal(got, want):
                failures.append((i, step, got, want))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures[:2]


@pytest.mark.card
def test_counters_and_launches(card):
    cfg = card_config("scene100")
    model, infer = make_infer_fn(cfg, device=card, seed=0)
    rng = np.random.default_rng(7)
    args = observation(rng, cfg, SCENE)
    with collect() as coll:
        before = dict(LAUNCHES)
        infer(model, *args)
        torch.cuda.synchronize()
        eager = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        rises = []
        for _ in range(3):
            before = dict(LAUNCHES)
            infer(model, *args)
            rises.append({k: LAUNCHES[k] - before[k] for k in LAUNCHES})
    assert coll.as_dict()["counts"] == {"act.graph_captures": 1, "act.graph_replays": 3,
                                        "act.weight_casts": mirrored_operands(model)}
    assert eager["front_fused"] == eager["decoder_head"] == 1
    assert eager["flash_attention"] == 8
    assert all(rise == eager for rise in rises)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_constants_bit_identical_on_the_card(card, name, dtype):
    new, old = ACTIVATIONS[name]
    x = activation_inputs(dtype, card)
    assert torch.equal(bits(new(x)), bits(old(x)))
