"""The benchmark's analytic FLOP count (``harness/flops.py``) against
``torch.utils.flop_counter.FlopCounterMode`` on the plain reference, at
tiny widths: forward, and forward plus backward."""

import pytest
import torch
from conftest import tiny
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import core, flops
from portbench.reference import qnet


def spec_and_inputs(cell, b):
    ctx = core.Context(cell, 0, 0.0, False, device="cpu", overrides=tiny(cell))
    role = ctx.cell["policies"][0]
    s = ctx.spec(role)
    g = torch.Generator().manual_seed(3)
    params = qnet.draw_params(s, g, "cpu")
    n = s.voxel_size
    grid = torch.rand((b, n, n, n, s.initial_dim), generator=g)
    proprio = torch.randn((b, s.low_dim_size), generator=g)
    tokens = torch.randn((b, s.lang_len, s.lang_dim), generator=g)
    return s, params, (grid, proprio, tokens)


@pytest.mark.parametrize("cell", ("crop50_train_b8", "scene100_act_b1"))
def test_forward_flops_match_the_counter(cell):
    s, params, inputs = spec_and_inputs(cell, 2)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        qnet.forward(params, s, *inputs)
    assert counter.get_total_flops() == flops.forward_flops(s, 2)


def test_train_flops_match_the_counter():
    s, params, inputs = spec_and_inputs("crop50_train_b8", 2)
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    seeds = torch.arange(s.num_dropout_seeds(), dtype=torch.int64) * 7919
    with FlopCounterMode(display=False) as counter:
        out = qnet.forward(leaves, s, *inputs, dropout_seeds=seeds)
        loss = sum(v.float().square().mean() for v in out.values())
        torch.autograd.grad(loss, list(leaves.values()))
    assert counter.get_total_flops() == flops.train_flops(s, 2)


def test_full_width_counts():
    """At published widths a 100^3 act is about 0.9 TFLOP and a batch-8
    train step at 50^3 about 3 times the forward of its batch."""
    ctx = core.Context("scene100_act_b1", 0, 0.0, False, device="cpu")
    s100 = ctx.spec("main")
    assert 0.5e12 < flops.forward_flops(s100, 1) < 1.5e12
    s50 = core.Context("crop50_train_b8", 0, 0.0, False, device="cpu").spec("acting")
    ratio = flops.train_flops(s50, 8) / flops.forward_flops(s50, 8)
    assert 2.5 < ratio < 3.0
