"""The plain reference against the port's plain path, at tiny widths on the
CPU, through the harness's own comparison: at float32 the two compute the
same function (voxelizer, augmentation, dropout masks, Q-network, losses,
LAMB), so every compared number is at rounding level; at bf16 (the port as
configured) they stay finite."""

import pytest
from conftest import CELLS, tiny

from portbench.harness import core

# float32 against float32: sums in another order, a few ulps through depth 1;
# Adam's first steps divide each gradient element by its own magnitude, so
# an element whose gradient is rounding noise moves by a full step either
# way, and a leaf's three-step change differs by up to about 1e-3 of it
F32_LIMITS = {"q_err": 1e-5, "gap": 0.0, "decode_err": 0.0,
              "grad_gap": 1e-3, "delta_gap": 1e-2}
F32_LIMITS.update({"late_" + k: F32_LIMITS[k] for k in ("q_err", "delta_gap")})


@pytest.mark.parametrize("cell", CELLS)
def test_reference_matches_port_at_float32(cell):
    ctx = core.Context(cell, 2 ** 31 + 99, 0.3, False, device="cpu",
                       overrides=tiny(cell, compute_dtype="float32"))
    checks = core.run(ctx)["checks"]
    assert checks, cell
    for name, value in checks.items():
        assert value <= F32_LIMITS[name], (cell, name, value)


@pytest.mark.parametrize("cell", ("crop50_train_b8", "crop50_dual_b1"))
def test_bf16_run_reads_finite(cell):
    ctx = core.Context(cell, 5, 0.3, False, device="cpu", overrides=tiny(cell))
    record = core.run(ctx)
    assert record["units"] >= 1 and record["samples"] >= record["units"]
    assert all(v == v and v < 1e3 for v in record["checks"].values()), record["checks"]


def test_train_check_reads_the_first_three_steps():
    """The rows of the checked steps come back by their number, and the
    reference's losses, first gradient and three-step change are those the
    program gives, at float32; so is the late step's loss."""
    cell = "crop50_train_b8"
    seen = {}

    def after(entry):
        seen["ids"] = entry.checked["ids"]
        seen["losses"] = entry.checked["losses"], entry.ref["losses"]
        seen["late"] = entry.checked["late"], entry.ref["late"]["losses"]
        return None

    ctx = core.Context(cell, 11, 0.3, False, device="cpu",
                       overrides=tiny(cell, compute_dtype="float32"))
    core.run(ctx, after=after)
    assert len(seen["ids"]) == 3 and all(len(i) == 8 for i in seen["ids"])
    prog, ref = seen["losses"]
    assert len(prog) == len(ref) == 3
    assert prog[0] != prog[1]
    assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(prog, ref)), (prog, ref)
    # the late step: after the window, from the state it left, the
    # reference's generator advanced past every step between
    late, late_ref = seen["late"]
    assert late["skip"] >= 3 + 1 and len(late["ids"]) == 8
    assert abs(late["losses"][0] - late_ref[0]) <= 1e-5 * abs(late_ref[0]), (late, late_ref)
