"""The VLM detector's constructor, its crop on the device and its spans, at
tiny widths on the CPU (no JAX: the port's own functions are the
references here, the JAX comparison is ``test_torch_vlm.py``'s).

- ``TorchOwlVitSamDetector.build``: towers at a spec's widths, weights taken
  from a flat dict without a copy, or drawn from a generator; the spec read
  back off flax trees (``spec_from_trees``, what ``from_pretrained`` builds
  from);
- ``crop_stats_on_device`` + ``crop_from_stats`` against the host's
  ``crop_point_from_mask`` on the same mask and cloud (point within 1e-6 m,
  radius equal), non-finite points and the open_jar fallback included;
- an all-negative mask: the detector keeps the pixels at its largest logit
  and the pass returns a crop, where ``crop_point_from_mask`` raises on an
  empty host mask;
- the spans and counters of one pass;
- the pass's keyed table (``ops/cuda/graphs``): one entry for OWL-ViT and
  SAM's encoder per frame and one for SAM's decoder per frame size.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from voxactb_tpu_torch.ops.cuda import graphs
from voxactb_tpu_torch.utils import profiling
from voxactb_tpu_torch.vlm import pipeline as P
from voxactb_tpu_torch.weights import tensors_to_flax_tree

SPEC = {"owl": dict(img_size=64, patch=16, dim=32, depth=2, heads=2, embed_dim=16),
        "owl_text": dict(vocab_size=49408, context_length=16, width=32, heads=2, layers=2,
                         embed_dim=16),
        "sam": dict(img_size=64, patch_size=8, embed_dim=32, depth=3, num_heads=2,
                    window_size=3, global_attn_indexes=(1,), out_chans=32),
        "decoder": dict(dim=32, heads=8, depth=2, num_masks=4, mlp_dim=64)}
TASKS = ("open_jar", "open_drawer", "hand_over_item")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def detector():
    params = {}
    g = torch.Generator().manual_seed(0)
    for name, module in P.build_towers(SPEC, device="cpu", generator=g).items():
        params.update({f"{name}.{k}": v.detach().clone() for k, v in module.state_dict().items()})
    for k, v in params.items():  # rel-pos tables start at zero: give the bias path work
        if ".rel_pos_" in k:
            v.normal_(0.0, 0.1, generator=g)
    return P.TorchOwlVitSamDetector.build(SPEC, params=params, score_threshold=0.0), params


def scene(rng, h=24, w=32):
    """A tilted table 0.6-1.2 m away with a raised object patch."""
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    z = 1.2 - 0.6 * v / (h - 1)
    z[8:16, 10:20] -= 0.08
    cloud = np.stack([(u - w / 2) * z / 30.0, (v - h / 2) * z / 30.0, z], -1).astype(np.float32)
    return rng.integers(0, 256, (h, w, 3)).astype(np.uint8), cloud


def test_build_takes_the_params_without_a_copy(detector):
    det, params = detector
    towers = {"owl": det._owl._det, "owl_text": det._owl._text, "sam": det._sam.encoder,
              "decoder": det._sam.decoder}
    for name, module in towers.items():
        for k, v in module.state_dict().items():
            assert v.data_ptr() == params[f"{name}.{k}"].data_ptr(), (name, k)
    assert det._owl._img_size == 64 and det._sam._img_size == 64


def test_build_from_a_generator_matches_build_from_its_params():
    g = torch.Generator().manual_seed(3)
    a = P.TorchOwlVitSamDetector.build(SPEC, device="cpu", generator=g, score_threshold=0.0)
    params = {}
    for name, m in (("owl", a._owl._det), ("owl_text", a._owl._text), ("sam", a._sam.encoder),
                    ("decoder", a._sam.decoder)):
        params.update({f"{name}.{k}": v.detach().clone() for k, v in m.state_dict().items()})
    b = P.TorchOwlVitSamDetector.build(SPEC, params=params, score_threshold=0.0)
    rgb, _ = scene(np.random.default_rng(1))
    torch.testing.assert_close(a.mask_logits(rgb, "jar"), b.mask_logits(rgb, "jar"),
                               rtol=0, atol=0)


def test_spec_read_back_from_flax_trees(detector):
    det, _ = detector
    trees = [tensors_to_flax_tree(m, dict(m.named_parameters())) for m in (
        det._owl._det, det._owl._text, det._sam.encoder, det._sam.decoder)]
    got = P.spec_from_trees(*trees)
    # heads show in no shape: OWL-ViT's towers take heads of 64 (one here)
    assert got == {**SPEC, "owl": {**SPEC["owl"], "heads": 1},
                   "owl_text": {**SPEC["owl_text"], "heads": 1}}


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("share", (0.05, 0.5, 1.0))
def test_crop_on_the_device_is_the_hosts(task, share):
    rng = np.random.default_rng(int(share * 100) + len(task))
    h, w = 48, 64
    _, cloud = scene(rng, h, w)
    cloud = cloud + rng.normal(0.0, 0.03, cloud.shape).astype(np.float32)
    cloud[rng.random((h, w)) < 0.05] = np.nan
    logits = torch.as_tensor(rng.standard_normal((h, w)).astype(np.float32)
                             + np.float32(np.quantile(rng.standard_normal(4096), share)))
    want = P.crop_point_from_mask(P.chosen_mask(logits).numpy(), cloud, task)
    stats = P.crop_stats_on_device(logits, torch.as_tensor(cloud))
    got = P.crop_from_stats(stats.numpy(), task)
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
    assert got[1] == want[1]
    assert int(stats[6]) == int(P.chosen_mask(logits).sum())


def test_no_finite_point_raises_on_both_paths():
    logits = torch.ones(4, 4)
    cloud = np.full((4, 4, 3), np.nan, np.float32)
    with pytest.raises(ValueError, match="empty object mask"):
        P.crop_point_from_mask(np.ones((4, 4), bool), cloud)
    with pytest.raises(ValueError, match="empty object mask"):
        P.crop_from_stats(P.crop_stats_on_device(logits, torch.as_tensor(cloud)).numpy())


def test_an_all_negative_mask_keeps_its_best_pixels(detector, monkeypatch):
    det, _ = detector
    rgb, cloud = scene(np.random.default_rng(2))
    planted = torch.full(rgb.shape[:2], -4.0)
    planted[5, 7] = planted[11, 3] = -0.5

    def mask_logits(frame, query):
        return planted

    monkeypatch.setattr(det, "mask_logits", mask_logits)
    np.testing.assert_array_equal(det(rgb, "jar"), (planted == -0.5).numpy())
    point, radius = P.VLM(det).get_target_object_world_coords(rgb, cloud, "open_drawer")
    want = P.crop_point_from_mask((planted == -0.5).numpy(), cloud, "open_drawer")
    np.testing.assert_allclose(point, want[0], atol=1e-6, rtol=0)
    assert radius == want[1]
    with pytest.raises(ValueError, match="empty object mask"):
        P.crop_point_from_mask(np.zeros(rgb.shape[:2], bool), cloud)


def test_one_pass_spans_and_counters(detector):
    det, _ = detector
    rgb, cloud = scene(np.random.default_rng(4))
    vlm = P.VLM(det)
    with profiling.collect() as coll:
        point, radius = vlm.get_target_object_world_coords(rgb, cloud, "open_drawer")
    got = coll.as_dict()
    for name in ("vx.vlm", "vx.vlm.owl", "vx.vlm.sam.encode", "vx.vlm.sam.decode",
                 "vx.vlm.crop", "vx.vlm.d2h"):
        assert got["spans"][name]["calls"] == 1, name
        assert got["spans"][name]["parent"] == (None if name == "vx.vlm" else "vx.vlm"), name
    area = int(P.chosen_mask(det.last["mask_logits"]).sum())
    assert got["counts"] == {"vlm.d2h_copies": 3, "vlm.mask_pixels": area}
    # the same pass on the host's geometry
    mask = det(rgb, "drawer handle")
    want = P.crop_point_from_mask(mask, cloud, "open_drawer")
    np.testing.assert_allclose(point, want[0], atol=1e-6, rtol=0)
    assert radius == want[1]


def test_one_set_of_programs_per_frame_size(detector):
    _, params = detector
    det = P.TorchOwlVitSamDetector.build(SPEC, params=params, score_threshold=0.0)
    rng = np.random.default_rng(6)
    for h, w in ((24, 32), (24, 32), (30, 40), (24, 32)):
        rgb, cloud = scene(rng, h, w)
        P.VLM(det).get_target_object_world_coords(rgb, cloud, "open_drawer")
    version, entries = det._graphs.table[det]
    got = sorted((tag, tuple(shape for shape, _ in shapes)) for _, tag, shapes in entries)
    embedding = (1, 8, 8, SPEC["sam"]["out_chans"])
    assert version == () and got == [
        ((), ((24, 32, 3), (1, 16))), ((), ((30, 40, 3), (1, 16))),
        ((24, 32), (embedding, (1, 4))), ((30, 40), (embedding, (1, 4)))]


def test_the_chosen_index_read_on_the_device(detector):
    det, _ = detector
    rgb, _ = scene(np.random.default_rng(5))
    det.mask_logits(rgb, "item")
    last = det.last
    best = int(np.argmax(last["iou"][0].numpy()))
    assert int(last["index"]) == best
    torch.testing.assert_close(last["mask_logits"],
                               det._sam.mask_logits(last["masks"], rgb.shape[:2], best),
                               rtol=0, atol=0)


# -- the card --------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `python -m pytest tests/test_torch_vlm_build.py "
                    "-m card --noconftest -q` on the card")
    return "cuda"


@pytest.mark.card
def test_replayed_pass_is_the_eager_pass(card):
    """``build``'s detector replays its three programs as CUDA graphs: every
    output of a pass, and the crop, bit-equal to its programs run eagerly
    (``graphs.eager()``) on the same weights (bf16, K7 in every block), over
    two frames of one size and one of another; K7's launches counted per pass
    either way."""
    from voxactb_tpu_torch.ops import cuda

    kw = dict(dtype=torch.bfloat16, fused_global=True, fused_windowed=True,
              score_threshold=0.0)
    g = torch.Generator(device=card).manual_seed(0)
    replayed = P.TorchOwlVitSamDetector.build(SPEC, device=card, generator=g, **kw)
    params = {}
    for name, m in (("owl", replayed._owl._det), ("owl_text", replayed._owl._text),
                    ("sam", replayed._sam.encoder), ("decoder", replayed._sam.decoder)):
        params.update({f"{name}.{k}": v for k, v in m.state_dict().items()})
    eager = P.TorchOwlVitSamDetector.build(SPEC, params=params, **kw)
    rng = np.random.default_rng(6)
    for h, w in ((24, 32), (24, 32), (30, 40), (24, 32)):
        rgb, cloud = scene(rng, h, w)
        got = []
        for det in (replayed, eager):
            before = cuda.launch_counts()["sam_attention"]
            with graphs.eager() if det is eager else contextlib.nullcontext():
                crop = P.VLM(det).get_target_object_world_coords(rgb, cloud, "open_drawer")
            assert cuda.launch_counts()["sam_attention"] - before == SPEC["sam"]["depth"]
            got.append((crop, dict(det.last)))
        (crop_r, last_r), (crop_e, last_e) = got
        np.testing.assert_array_equal(crop_r[0], crop_e[0])
        assert crop_r[1] == crop_e[1]
        for key, value in last_e.items():
            if isinstance(value, torch.Tensor):
                assert torch.equal(last_r[key], value), key
            else:
                np.testing.assert_array_equal(last_r[key], value)


@pytest.mark.card
def test_replayed_pass_uploads_the_frame_pinned(card, tmp_path):
    """In a replayed pass the frame goes up in one pinned host-to-device copy
    inside ``vx.vlm.owl``, and no pageable host-to-device copy starts inside
    ``vx.vlm.owl`` or ``vx.vlm.sam.encode`` (the profiler's trace: each
    copy's runtime call, by its correlation id, within the span)."""
    g = torch.Generator(device=card).manual_seed(1)
    det = P.TorchOwlVitSamDetector.build(SPEC, device=card, generator=g, dtype=torch.bfloat16,
                                         fused_global=True, fused_windowed=True,
                                         score_threshold=0.0)
    rgb, cloud = scene(np.random.default_rng(7), 30, 40)
    vlm = P.VLM(det)
    for _ in range(2):  # the capture, then a replay
        vlm.get_target_object_world_coords(rgb, cloud, "open_drawer")
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        vlm.get_target_object_world_coords(rgb, cloud, "open_drawer")
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = {n: [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("name") == n and e.get("cat") == "user_annotation"]
             for n in ("vx.vlm.owl", "vx.vlm.sam.encode")}
    assert all(len(v) == 1 for v in spans.values()), spans
    calls = {e["args"]["correlation"]: e["ts"] for e in events
             if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}

    def inside(copy, name):
        ts = calls[copy["args"]["correlation"]]
        return any(lo <= ts <= hi for lo, hi in spans[name])

    h2d = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]]
    pinned = [e for e in h2d if "Pinned" in e["name"] and inside(e, "vx.vlm.owl")]
    assert len(pinned) == 1 and pinned[0]["args"]["bytes"] >= rgb.size * 4, pinned
    pageable = [e for e in h2d if "Pageable" in e["name"]
                and (inside(e, "vx.vlm.owl") or inside(e, "vx.vlm.sam.encode"))]
    assert not pageable, pageable


def mirrored_operands(towers):
    """The operands the VLM pass's weight mirror holds for bf16 towers: every
    ``Dense`` layer's weight and bias in bf16, every 2D conv's weight in bf16
    and back in f32 and its bias in bf16, OWL-ViT's class token and position
    embedding, SAM's position embedding and the decoder's no-mask
    embedding."""
    from voxactb_tpu_torch.models import blocks

    n = 0
    for m in (m for t in towers for m in t.modules()):
        if isinstance(m, blocks.Dense):
            n += 1 + (m.bias is not None)
        elif isinstance(m, (blocks.Conv2D, blocks.ConvTranspose2D)):
            n += 2 + (m.bias is not None)
    return n + 2 + 1 + 1


@pytest.mark.card
def test_in_place_load_is_replayed_without_a_capture(card):
    """A load of other weights into the towers the pass runs
    (``load_state_dict``, storage kept) is read by the next replayed pass
    with no new capture: the weight mirror makes each of its operands
    again, and every output is the eager pass's on the loaded weights."""
    kw = dict(dtype=torch.bfloat16, fused_global=True, fused_windowed=True,
              score_threshold=0.0)
    det, other = (P.TorchOwlVitSamDetector.build(
        SPEC, device=card, generator=torch.Generator(device=card).manual_seed(s), **kw)
        for s in (3, 4))
    other._owl._text.load_state_dict(det._owl._text.state_dict())  # the same query embedding

    def towers(d):
        return d._owl._det, d._sam.encoder, d._sam.decoder

    rgb, _ = scene(np.random.default_rng(10), 30, 40)
    with profiling.collect() as coll:
        det.mask_logits(rgb, "item")
        first = dict(det.last)
        for mine, theirs in zip(towers(det), towers(other)):
            mine.load_state_dict(theirs.state_dict())
        det.mask_logits(rgb, "item")
    counts = coll.as_dict()["counts"]
    assert counts["vlm.graph_captures"] == 3 and counts["vlm.graph_replays"] == 3
    assert counts["vlm.weight_casts"] == 2 * mirrored_operands(towers(det))
    with graphs.eager():
        other.mask_logits(rgb, "item")
    assert not torch.equal(first["embedding"], det.last["embedding"])
    for key, value in other.last.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(det.last[key], value), key
        else:
            np.testing.assert_array_equal(det.last[key], value)
