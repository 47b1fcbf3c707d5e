"""The weight mirror of ``ops/cuda/graphs``: what a program run through graphs
derives from its owner's parameters (``weight``, ``derived``), made once and
made again in place after an in-place write.

Programs reach the mirror only through graphs on a CUDA device, so these
tests call it directly with CPU tensors (``Mirror.active`` as ``Graph.run``
sets it): an operand is made once and counted; it is left alone while its
parameters' versions hold; after an in-place ``copy_`` it is made again into
the same memory, bit-equal to the cast, and ``<name>.weight_casts`` rises by
exactly the operands of the changed parameters; operands derived from
operands (a Conv2D's rounded weight, K3's layouts of the stacked trans
heads, the upsample's composed kernel) follow; views of parameters are read
anew; a write that lands while an operand is made again is made by the
next refresh, and threads refreshing under writes leave every operand
current; the mirror goes with the owner's storage version; a capture's miss
is computed and not kept; and outside a program ``weight`` is ``param.to`` and
a ``Dense`` layer's gradients through it are unchanged. A tiny act program
run inside the mirror, then after an in-place load, gives the eager
program's bits on the new weights.

On the card (marked ``card``; ``python -m pytest
tests/test_torch_weight_mirror.py -m card --noconftest -q``): the capture of
the act and of the VLM pass casts no parameter; the profiler finds no more
f32 -> bf16 cast kernels in a replay than the capture's casts of
activations, and in the eager program at least one more per contiguous
parameter it casts.
"""

import sys
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from voxactb_tpu_torch.agents.qfunction import build_encoder
from voxactb_tpu_torch.config import MethodConfig
from voxactb_tpu_torch.models import blocks
from voxactb_tpu_torch.models.perceiver import trans_heads
from voxactb_tpu_torch.ops.cuda import graphs
from voxactb_tpu_torch.ops.cuda.decoder_head import tail_weights
from voxactb_tpu_torch.ops.cuda.front_fused import front_weights
from voxactb_tpu_torch.ops.upsample_conv import compose_upsample_kernel
from voxactb_tpu_torch.utils.profiling import collect

BF16, F32 = torch.bfloat16, torch.float32
TINY = dict(voxel_sizes=[10], num_latents=16, latent_dim=32, transformer_depth=1,
            latent_heads=2, latent_dim_head=16, cross_dim_head=16, compute_dtype="bfloat16")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def casts(coll):
    return coll.as_dict()["counts"].get("act.weight_casts", 0)


def made(mirror, fn, *args):
    """``fn(*args)`` in a program's first run under ``mirror``."""
    with torch.inference_mode(), mirror.active(making=True):
        return fn(*args)


def dense(seed=0, bias=True):
    return blocks.Dense(12, 8, use_bias=bias, dtype=BF16,
                        generator=torch.Generator().manual_seed(seed))


def test_an_operand_is_made_once_and_counted():
    layer, mirror = dense(), graphs.Mirror("act")
    x = torch.randn(3, 12)
    with collect() as coll:
        w = made(mirror, graphs.weight, layer.weight, BF16)
        again = made(mirror, graphs.weight, layer.weight, BF16)
        y = made(mirror, layer, x)
        y2 = made(mirror, layer, x)
    assert again is w and same_bits(w, layer.weight.detach().to(BF16))
    assert casts(coll) == 2  # the weight, then the bias in the first call of the layer
    assert same_bits(y, y2) and same_bits(y, layer(x).detach())
    # the compute dtype's own parameters are themselves, and not counted
    f32 = blocks.Dense(12, 8, dtype=F32)
    with collect() as coll:
        assert made(mirror, graphs.weight, f32.weight, F32) is f32.weight
    assert casts(coll) == 0


def test_operands_left_alone_while_versions_hold():
    layer, mirror = dense(), graphs.Mirror("act")
    w = made(mirror, graphs.weight, layer.weight, BF16)
    b = made(mirror, graphs.weight, layer.bias, BF16)
    with torch.inference_mode():
        w.fill_(7.0)  # a mark that only a remake would clear
    with collect() as coll:
        mirror.refresh()
        mirror.refresh()
    assert casts(coll) == 0
    assert bool((w == 7.0).all()) and same_bits(b, layer.bias.detach().to(BF16))


@pytest.mark.parametrize("changed", [("weight",), ("bias",), ("weight", "bias")])
def test_in_place_copy_remakes_into_the_same_memory(changed):
    layer, other, mirror = dense(0), dense(1), graphs.Mirror("act")
    with torch.no_grad():
        other.bias.normal_(generator=torch.Generator().manual_seed(2))
    ops = {n: made(mirror, graphs.weight, getattr(layer, n), BF16) for n in ("weight", "bias")}
    ptrs = {n: t.data_ptr() for n, t in ops.items()}
    with torch.no_grad():
        for n in changed:
            getattr(layer, n).copy_(getattr(other, n))
    with collect() as coll:
        mirror.refresh()
        mirror.refresh()  # nothing moved since
    assert casts(coll) == len(changed)
    for n, t in ops.items():
        assert t.data_ptr() == ptrs[n]
        assert same_bits(t, getattr(layer, n).detach().to(BF16)), n
        assert made(mirror, graphs.weight, getattr(layer, n), BF16) is t


def test_operands_of_operands_follow_in_order():
    """A Conv2D's weight rounded to bf16 and back to f32, K3's layouts of the
    stacked trans heads and the upsample's composed kernel: each made from
    an operand, each made again after its parameter is written."""
    g = torch.Generator().manual_seed(3)
    conv = blocks.Conv2D(3, 4, 3, dtype=BF16, generator=g)
    final = blocks.Conv3D(128, 64, 3, dtype=BF16, generator=g)
    heads = [blocks.Conv3D(64, 1, 3, dtype=BF16, generator=g) for _ in range(2)]
    up = torch.nn.Parameter(torch.randn(3, 3, 3, 4, 4, generator=g) * 0.1)
    pairs = [p for td in heads for p in (td.weight, td.bias)]

    def program():
        rounded = graphs.weight(graphs.weight(conv.weight, BF16), F32)
        wt, bt = graphs.derived(trans_heads, *pairs)
        layout = graphs.derived(tail_weights, final.kernel_dhwio(), final.bias, wt, bt)
        composed = graphs.derived(compose_upsample_kernel, graphs.weight(up, BF16), 5)
        return rounded, layout, composed

    def plain():
        wt = torch.stack([td.kernel_dhwio() for td in heads])
        bt = torch.cat([td.bias for td in heads])
        return (conv.weight.to(BF16).to(F32), tail_weights(final.kernel_dhwio(), final.bias,
                                                            wt, bt),
                compose_upsample_kernel(up.to(BF16), 5))

    mirror = graphs.Mirror("act")
    with collect() as coll:
        first = made(mirror, program)
    # bf16 and f32 copies; the f32 stack and bias; wf and wt laid out (bf and
    # bt are passed through as they are); up in bf16 and composed
    assert casts(coll) == 2 + 2 + 2 + 2
    assert made(mirror, program)[1][1] is final.bias
    with torch.no_grad():
        for p in (conv.weight, heads[1].weight, up):
            p.mul_(-1.5)
    with collect() as coll:
        mirror.refresh()
    assert casts(coll) == 2 + 2 + 2 + 2  # each derives from a written parameter
    with torch.no_grad():
        final.weight.add_(0.25)
    with collect() as coll:
        mirror.refresh()
    assert casts(coll) == 2  # the tail's layouts, made together
    with torch.no_grad():
        want = plain()
    got = made(mirror, program)
    assert same_bits(got[0], want[0]) and same_bits(got[2], want[2])
    for a, b in zip(got[1], want[1]):
        assert same_bits(a, b)
    assert got[0] is first[0] and got[2] is first[2]


def test_views_of_parameters_are_read_anew():
    """K1's layouts from views of the Conv3D weights (``kernel_dhwio``): made
    once, and made again from the written weights through fresh views (a
    view taken under inference_mode cannot be read after its base is
    written outside it)."""
    g = torch.Generator().manual_seed(4)
    pre = blocks.Conv3D(10, 64, 1, dtype=BF16, generator=g)
    patch = blocks.Conv3D(64, 64, 5, 5, dtype=BF16, generator=g)
    mirror = graphs.Mirror("act")

    def program():
        return graphs.derived(front_weights, pre.kernel_dhwio()[0, 0, 0], pre.bias,
                              patch.kernel_dhwio())

    with collect() as coll:
        w1, b1, wp = made(mirror, program)
    assert casts(coll) == 2 and b1 is pre.bias
    with torch.no_grad():
        pre.weight.normal_(generator=g)
        patch.weight.normal_(generator=g)
    with collect() as coll:
        mirror.refresh()
    assert casts(coll) == 2
    with torch.no_grad():
        want = front_weights(pre.kernel_dhwio()[0, 0, 0], pre.bias, patch.kernel_dhwio())
    got = made(mirror, program)
    assert got[0] is w1 and got[2] is wp
    for a, b in zip(got, want):
        assert same_bits(a, b)


def test_what_is_not_a_weight_is_not_kept():
    layer, mirror = dense(), graphs.Mirror("act")
    x = torch.randn(3, 12)
    with collect() as coll:
        a = made(mirror, graphs.weight, x, BF16)
        b = made(mirror, graphs.weight, x, BF16)
        # a view returned as it is: taken anew in each call
        v = made(mirror, graphs.derived, torch.Tensor.t, layer.weight)
    assert a is not b and same_bits(a, b) and v._base is layer.weight
    assert casts(coll) == 0
    # a capture's miss is computed, and not kept
    with torch.inference_mode(), mirror.active(making=False):
        c = graphs.weight(layer.weight, BF16)
        d = graphs.weight(layer.weight, BF16)
    assert c is not d and same_bits(c, d)


def test_outside_a_program_weight_is_the_cast_and_gradients_hold():
    layer = dense()
    assert same_bits(graphs.weight(layer.weight, BF16), layer.weight.to(BF16))
    assert graphs.weight(layer.weight, BF16) is not graphs.weight(layer.weight, BF16)
    x = torch.randn(5, 12, generator=torch.Generator().manual_seed(5))
    got = torch.autograd.grad(layer(x).float().square().sum(), [layer.weight, layer.bias])
    y = F.linear(x.to(BF16), layer.weight.to(BF16)) + layer.bias.to(BF16)
    want = torch.autograd.grad(y.float().square().sum(), [layer.weight, layer.bias])
    for a, b in zip(got, want):
        assert same_bits(a, b)


def test_refreshes_under_concurrent_writes_end_current():
    """Threads refreshing one mirror while another writes its parameters in
    place: once all have joined, one more refresh leaves every operand the
    cast of its parameter's last value."""
    layers = [dense(i) for i in range(4)]
    mirror = graphs.Mirror("act")
    ops = [made(mirror, graphs.weight, p, BF16) for m in layers for p in m.parameters()]
    params = [p for m in layers for p in m.parameters()]
    stop = threading.Event()

    def refresher():
        while not stop.is_set():
            mirror.refresh()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=refresher) for _ in range(6)]
        for t in threads:
            t.start()
        g = torch.Generator().manual_seed(7)
        with torch.no_grad():
            for step in range(200):
                params[step % len(params)].normal_(generator=g)
        stop.set()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    mirror.refresh()
    for p, op in zip(params, ops):
        assert same_bits(op, p.detach().to(BF16))


WRITES = []  # parameters that ``cast_then_write`` writes once each


def cast_then_write(p):
    """``p`` in bf16, then a write of ``p`` in place, as if another thread's
    load had landed while the mirror made the operand again."""
    out = p.to(BF16)
    if WRITES:
        with torch.no_grad():
            WRITES.pop().add_(1.0)
    return out


def test_a_write_during_a_remake_is_made_by_the_next_refresh():
    layer, mirror = dense(), graphs.Mirror("act")
    op = made(mirror, graphs.derived, cast_then_write, layer.weight)
    with torch.no_grad():
        layer.weight.mul_(2.0)
    WRITES.append(layer.weight)
    mirror.refresh()  # makes it from the doubled weight, which then moves again
    assert not WRITES and not same_bits(op, layer.weight.detach().to(BF16))
    mirror.refresh()
    assert same_bits(op, layer.weight.detach().to(BF16))


def test_the_mirror_goes_with_the_owner_storage():
    cfg = MethodConfig(**TINY)
    model = build_encoder(cfg, device="cpu", seed=0)
    table = graphs.Graphs("act", "cpu")
    leaves = (np.zeros((1, 3), np.float32),)
    table.entry(model, graphs.storage(model), (), leaves)
    mirror = table.mirrors[model]
    model.load_state_dict(build_encoder(cfg, device="cpu", seed=1).state_dict())
    table.entry(model, graphs.storage(model), (), leaves)
    assert table.mirrors[model] is mirror  # an in-place load keeps it
    model.final.bias = torch.nn.Parameter(model.final.bias.detach().clone())
    table.entry(model, graphs.storage(model), (), leaves)
    assert table.mirrors[model] is not mirror
    assert len(table.table[model][1]) == 1


def test_a_program_in_the_mirror_reads_an_in_place_load():
    """A tiny bf16 act model run inside the mirror (the first run makes,
    the next reads), then after ``load_state_dict`` of other weights and a
    refresh: the eager forward's bits on the new weights."""
    cfg = MethodConfig(**TINY)
    model = build_encoder(cfg, device="cpu", seed=0)
    other = build_encoder(cfg, device="cpu", seed=1)
    g = torch.Generator().manual_seed(6)
    n = cfg.voxel_size
    args = (torch.randn(1, n, n, n, 10, generator=g),
            torch.randn(1, cfg.proprio_width(), generator=g),
            torch.randn(1, 1024, generator=g), torch.randn(1, 77, 512, generator=g))
    mirror = graphs.Mirror("act")
    with collect() as coll:
        first = made(mirror, model, *args)
    made_once = casts(coll)
    assert made_once > 0
    model.load_state_dict(other.state_dict())
    with collect() as coll:
        mirror.refresh()
        with torch.inference_mode(), mirror.active(making=False):
            got = model(*args)
    assert casts(coll) == made_once  # every parameter was loaded
    with torch.inference_mode():
        want, before = other(*args), build_encoder(cfg, device="cpu", seed=0)(*args)
    for k in want:
        assert same_bits(got[k], want[k]), k
        assert same_bits(first[k], before[k]), k


# -- the card --------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `python -m pytest tests/test_torch_weight_mirror.py "
                    "-m card --noconftest -q` on the card")
    return torch.device("cuda")


class Casts(TorchDispatchMode):
    """Every f32 -> bf16 conversion dispatched: whether a graph capture was
    on, whether its input is a parameter (or a view of one), and whether
    that input is contiguous."""

    def __init__(self, params):
        super().__init__()
        self.params = {id(p) for p in params}
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        src = dst = None
        if func.overloadpacket in (torch.ops.aten.to, torch.ops.aten._to_copy):
            src, dst = args[0], out  # under inference_mode ``to`` reaches the mode itself
        elif func.overloadpacket is torch.ops.aten.copy_:
            src, dst = args[1], args[0]
        if (isinstance(src, torch.Tensor) and src.dtype == F32 and isinstance(dst, torch.Tensor)
                and dst.dtype == BF16):
            base = src if src._base is None else src._base
            capturing = torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
            self.seen.append((capturing, id(base) in self.params, src.is_contiguous()))
        return out


def cast_kernels(run):
    """The f32 -> bf16 cast kernels (PyTorch's ``bfloat16_copy_kernel_cuda``)
    the profiler records in ``run()``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if "bfloat16_copy_kernel" in e.key)


def assert_no_weight_cast(first, eager, params, replay, run_eager):
    """``first``: the casts of a key's first call (its eager run, then its
    capture); ``eager``: the same program run eagerly; ``replay``: the cast
    kernels of one replay."""
    captured = [s for s in first.seen if s[0]]
    assert any(p for c, p, _ in first.seen if not c), "the first run made no operand"
    assert not any(p for _, p, _ in captured), "a capture cast a parameter"
    # each cast kernel of the replay is one of the capture's casts of activations
    assert replay <= len(captured), (replay, len(captured))
    # the profiler sees a parameter's cast where one is made: the eager
    # program's contiguous parameters each add a cast kernel to the replay's
    with Casts(params) as mode:
        kernels = cast_kernels(run_eager)
    assert mode.seen == eager.seen
    contiguous = sum(1 for _, p, c in eager.seen if p and c)
    assert contiguous > 0 and kernels - replay >= contiguous, (kernels, replay, contiguous)


@pytest.mark.card
def test_replayed_act_casts_no_weight(card):
    from test_torch_act_graph import card_config, crop_bounds, observation

    from voxactb_tpu_torch.agents.qfunction import make_infer_fn

    cfg = card_config("crop50")
    model, infer = make_infer_fn(cfg, device=card, seed=0)
    rng = np.random.default_rng(8)
    args = observation(rng, cfg, crop_bounds(rng))
    params = list(model.parameters())

    def run_eager():
        with graphs.eager():
            infer(model, *args)

    with Casts(params) as first:
        infer(model, *args)  # the first run, then the capture
    with Casts(params) as eager:
        run_eager()
    replay = cast_kernels(lambda: infer(model, *args))
    assert_no_weight_cast(first, eager, params, replay, run_eager)


@pytest.mark.card
def test_replayed_vlm_pass_casts_no_weight(card):
    from test_torch_vlm_build import SPEC, scene

    from voxactb_tpu_torch.vlm import pipeline as P

    g = torch.Generator(device=card).manual_seed(2)
    det = P.TorchOwlVitSamDetector.build(SPEC, device=card, generator=g, dtype=BF16,
                                         fused_global=True, fused_windowed=True,
                                         score_threshold=0.0)
    params = [p for t in (det._owl._det, det._sam.encoder, det._sam.decoder)
              for p in t.parameters()]
    rgb, _ = scene(np.random.default_rng(9), 30, 40)
    det._query_cache["item"] = det._owl.embed_queries(["item"])  # outside the graphs

    def run_eager():
        with graphs.eager():
            det.mask_logits(rgb, "item")

    with Casts(params) as first:
        det.mask_logits(rgb, "item")
    with Casts(params) as eager:
        run_eager()
    replay = cast_kernels(lambda: det.mask_logits(rgb, "item"))
    assert_no_weight_cast(first, eager, params, replay, run_eager)
