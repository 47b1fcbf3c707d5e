"""The cell ``samh_episode_start_b1`` (VoxAct-B's episode start: OWL-ViT,
SAM, the crop on the card, one act), at tiny widths on the CPU with the
kernels' plain versions, and at its own size on the card (``-m card``):

- the plain reference (``reference/owlvit.py``, ``reference/sam.py``)
  against the port's detector at float32 through the harness's own check,
  every number at rounding level; its parameter names and shapes are the
  port's ``state_dict``'s;
- the FLOP counts (``harness/vlm_flops.py``) against ``FlopCounterMode`` on
  the reference;
- planted faults in the timed path read ``correct`` false (SAM's global
  blocks run in windows; the rel-pos bias left out; OWL-ViT's worst patch
  served; SAM's mask of lowest IoU served; the crop without its voxel
  downsample), and so does the control, the reference in fp8 (its crop at
  fp16);
- ``k7_roofline`` counts K7's launches and not the act's K2 on a canned
  trace; the program-span metrics read a traced run and nothing without a
  collection;
- the cell runs from files of its own, and loads neither JAX nor, in the
  reference, the port.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import REPO, tiny
from torch.utils.flop_counter import FlopCounterMode

from portbench import control, run
from portbench.harness import core, vlm_flops
from portbench.reference import owlvit as ref_owl
from portbench.reference import sam as ref_sam
from portbench.reference.vlm_params import draw_vlm_params, param_shapes, tower

CELL = "samh_episode_start_b1"
SPEC = {"owl": dict(img_size=64, patch=16, dim=32, depth=2, heads=2, embed_dim=16),
        "owl_text": dict(vocab_size=49408, context_length=16, width=32, heads=2, layers=2,
                         embed_dim=16),
        "sam": dict(img_size=64, patch_size=8, embed_dim=32, depth=3, num_heads=2,
                    window_size=3, global_attn_indexes=[1], out_chans=32),
        "decoder": dict(dim=32, heads=2, depth=2, num_masks=4, mlp_dim=64)}
SEEDS = (3_200_000_001, 3_200_000_002, 3_200_000_003)


def tiny_vlm(**keys) -> dict:
    """The overrides that run the cell at tiny widths (``keys``: the
    configuration's ``vlm`` keys and, as ``method``, ``MethodConfig``'s)."""
    out = tiny(CELL, **keys.pop("method", {}))
    out["traffic"] = {"frame": [24, 32], "pool": 4, "image": 16, "focal": 30.0}
    out["cell"]["vlm"] = {**SPEC, "score_threshold": 0.0, **keys}
    return out


def failing(out):
    return [k for k, c in out["checks"].items() if c["value"] > c["limit"]]


def test_reference_matches_port_at_float32():
    ctx = core.Context(CELL, 2 ** 31 + 7, 0.3, False, device="cpu",
                       overrides=tiny_vlm(compute_dtype="float32",
                                          method={"compute_dtype": "float32"}))
    checks = core.run(ctx)["checks"]
    # float32 against float32: sums in another order, a few ulps through the
    # towers; the crop's centroid: float64 sums on one side, numpy's float32 on the other
    limits = {"owl_logit_err": 1e-4, "owl_gap": 0.0, "sam_embed_err": 1e-4, "mask_err": 1e-4,
              "iou_gap": 0.0, "crop_err": 1e-6, "q_err": 1e-5, "gap": 0.0, "decode_err": 0.0}
    assert set(checks) == set(limits)
    for name, value in checks.items():
        assert value <= limits[name], (name, value)


def test_parameter_names_are_the_ports():
    from voxactb_tpu_torch.vlm.pipeline import build_towers

    want = {}
    for name, module in build_towers(SPEC, device="meta").items():
        want.update({f"{name}.{k}": tuple(v.shape) for k, v in module.state_dict().items()})
    assert param_shapes(SPEC) == want


def flop_count(fn) -> int:
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn()
    return counter.get_total_flops()


def test_flops_match_the_counter():
    p = draw_vlm_params(SPEC, torch.Generator().manual_seed(1), "cpu")
    rgb = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (30, 40, 3)))
    ids = torch.randint(1, 49407, (1, 16), generator=torch.Generator().manual_seed(3))
    q = ref_owl.embed_text(tower(p, "owl_text."), SPEC["owl_text"], ids)
    emb = ref_sam.encode(tower(p, "sam."), SPEC["sam"], rgb)
    box = torch.tensor([[0.1, 0.2, 0.6, 0.5]])
    assert flop_count(lambda: ref_owl.embed_text(tower(p, "owl_text."), SPEC["owl_text"], ids)) \
        == vlm_flops.text_flops(SPEC["owl_text"])
    assert flop_count(lambda: ref_owl.detect(tower(p, "owl."), SPEC["owl"], rgb, q)) \
        == vlm_flops.owl_flops(SPEC["owl"])
    assert flop_count(lambda: ref_sam.encode(tower(p, "sam."), SPEC["sam"], rgb)) \
        == vlm_flops.sam_flops(SPEC["sam"])
    assert flop_count(lambda: ref_sam.decode(tower(p, "decoder."), SPEC["decoder"], emb, box)) \
        == vlm_flops.decoder_flops(SPEC["decoder"], 8)


def test_full_width_counts():
    """At published widths a pass is about 6.1 TFLOP, SAM ViT-H's encoder
    about 5.96 of it, and K7's bound 0.84 ms over its 32 launches."""
    spec = core.load_json(core.ROOT / "configs" / "voxactb_vlm_samh.json")["vlm"]
    assert 5.9e12 < vlm_flops.pass_flops(spec) < 6.3e12
    assert 5.9e12 < vlm_flops.sam_flops(spec["sam"]) < 6.0e12
    assert len(list(vlm_flops.sam_blocks(spec["sam"]))) == 32
    assert 0.8e-3 < vlm_flops.k7_pass_bound_s(spec["sam"]) < 0.9e-3


def global_windowed(entry):
    enc = entry.detector._sam.encoder
    for i in SPEC["sam"]["global_attn_indexes"]:
        getattr(enc, f"block_{i}").window_size = SPEC["sam"]["window_size"]


def rel_pos_dropped(entry):
    enc = entry.detector._sam.encoder
    for i in range(SPEC["sam"]["depth"]):
        getattr(enc, f"block_{i}").attn.use_rel_pos = False


@pytest.mark.parametrize("plant", (global_windowed, rel_pos_dropped))
def test_planted_fault_fails(bench, plant):
    out = run.report(bench, CELL, 23, 0.3, False, device="cpu", overrides=tiny_vlm(),
                     plant=plant)
    assert out["correct"] is False
    assert "sam_embed_err" in failing(out), out["checks"]


def worst_patch(entry):
    """OWL-ViT serves the patch of its lowest logit."""
    owl = entry.detector._owl
    choose = owl.choose
    owl.choose = lambda logits, boxes, frame_hw, threshold: choose(-logits, boxes, frame_hw,
                                                                   -1.0)


def iou_argmin(entry):
    """SAM serves the mask of its lowest predicted IoU (the IoU head's sign
    flipped)."""
    sam = entry.detector._sam
    decode = sam.decode
    sam.decode = lambda embedding, box: (lambda m, iou: (m, -iou))(*decode(embedding, box))


def no_downsample(entry):
    """The crop without its 1 cm voxel downsample."""
    entry.vlm._downsample_voxel = 1e-6


@pytest.mark.parametrize("plant, readings", ((worst_patch, ["owl_gap"]),
                                             (iou_argmin, ["iou_gap"])))
def test_planted_wrong_choice_fails(bench, plant, readings):
    out = run.report(bench, CELL, 25, 0.3, False, device="cpu", overrides=tiny_vlm(),
                     plant=plant)
    assert out["correct"] is False
    assert failing(out) == readings, out["checks"]


def test_planted_crop_fault_fails(bench):
    """Several points to a voxel (a 48 x 64 frame at focal 300), so that the
    downsample moves the centroid; float32, so that nothing but the crop
    reads the fault."""
    overrides = tiny_vlm(compute_dtype="float32", method={"compute_dtype": "float32"})
    overrides["traffic"].update(frame=[48, 64], focal=300.0)
    out = run.report(bench, CELL, 26, 0.3, False, device="cpu", overrides=overrides,
                     plant=no_downsample)
    assert out["correct"] is False
    assert failing(out) == ["crop_err"], out["checks"]


def test_program_passes_and_control_reads_above_it_on_the_cpu(bench):
    out = run.report(bench, CELL, 24, 0.3, False, device="cpu", overrides=tiny_vlm())
    assert out["correct"] is True, out["checks"]
    row = control.readings(CELL, 24, 0.3, "cpu", tiny_vlm())
    for name in ("sam_embed_err", "mask_err", "crop_err", "q_err"):
        assert row["control"][name] > 2 * row["program"][name], (name, row)


def test_k7_roofline_reads_k7_alone():
    reader = core.load_module(core.ROOT / "metrics" / "k7_roofline.py", "k7_roofline_test")
    kernels = {"void vx::attn_fwd::attention_fwd<80, 2, true>(CUtensorMap_st, int)": 0.003,
               "void vx::attn_fwd::attention_fwd<64, 2, true>(CUtensorMap_st, int)": 0.001,
               "void vx::attn_fwd::attention_fwd<64, 2, false>(CUtensorMap_st, int)": 0.002,
               "void vx::attn_fwd::attention_fwd<128, 1, false>(CUtensorMap_st, int)": 0.002,
               "nvjet_tst_320x128_64x3_1x2_h_bz_coopB_TNT": 0.5}
    record = {"trace": {"kernels": kernels, "k7_bound_s": 0.001}}
    assert reader.read(record) == pytest.approx(25.0)
    assert reader.read({"trace": {"kernels": {}, "k7_bound_s": 0.001}}) is None


PROGRAM_METRICS = ("sam_encode_ms.latency", "owl_detect_ms.latency", "vlm_crop_ms.latency",
                   "vlm_d2h_copies.latency")


def test_program_metrics_read_in_a_traced_run(bench, monkeypatch):
    assert {m["name"] for m in run.cell_metrics(bench, "per_layer", CELL)} >= set(
        PROGRAM_METRICS) | {"k7_roofline"}
    out = run.report(bench, CELL, 2_900_000_019, 0.3, True, device="cpu",
                     overrides=tiny_vlm())
    got = {k: out["metrics"][k]["value"] for k in PROGRAM_METRICS}
    assert got["vlm_d2h_copies.latency"] == 3
    assert all(v > 0 for v in got.values()), got
    from voxactb_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "last_collection")  # a program without the spans
    out = run.report(bench, CELL, 5, 0.2, True, device="cpu", overrides=tiny_vlm())
    assert not set(out["metrics"]) & set(PROGRAM_METRICS)


def test_the_cell_runs_from_files_of_its_own(bench):
    cell = core.load_json(core.ROOT / "workloads" / f"{CELL}.json")
    for path in (core.ROOT / "configs" / f"{cell['config']}.json",
                 core.ROOT / "traffic" / f"{cell['traffic']}.json",
                 core.ROOT / "entries" / f"{cell['entry']}.py"):
        assert path.is_file(), path
    names = {m["name"] for m in run.cell_metrics(bench, "per_layer", CELL)}
    names |= {m["name"] for m in run.cell_metrics(bench, "end_to_end", CELL)}
    for name in names:
        assert (core.ROOT / "metrics" / f"{name}.py").is_file(), name
    shared = ["run.py", "control.py"] + [f"harness/{f}.py" for f in (
        "core", "traffic", "acts", "compare", "trace", "flops")]
    for rel in shared:  # nothing the other cells run names this one
        text = (core.ROOT / rel).read_text()
        assert "samh" not in text and "vlm" not in text.lower(), rel


ISOLATION = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from portbench.harness import core
from portbench.reference import owlvit, sam, vlm_params
ref = sorted({{m.split(".")[0] for m in sys.modules}})
core.run(core.Context({cell!r}, 1, 0.2, True, device="cpu", overrides=json.loads({ov!r})))
print(json.dumps([ref, core.forbidden_modules()]))
"""


def test_reference_loads_nothing_of_the_port_and_the_cell_no_jax():
    code = ISOLATION.format(repo=REPO.as_posix(), cell=CELL, ov=json.dumps(tiny_vlm()))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref, forbidden = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not set(ref) & {"voxactb_tpu_torch", "voxactb_tpu", "jax", "jaxlib", "flax", "optax"}
    assert forbidden == []


@pytest.mark.card
def test_control_fails_at_the_cells_size(card):
    limits = core.Context(CELL, 0, 0.0, False).limits
    for seed in SEEDS:
        row = control.readings(CELL, seed, 2.0, card)
        assert all(v <= limits[k] for k, v in row["program"].items()), row
        assert any(v > limits[k] for k, v in row["control"].items() if k in limits), row
