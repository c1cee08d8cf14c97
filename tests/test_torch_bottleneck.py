"""DRN-D-105 DRNSeg (bottleneck blocks) through the port's serving path,
held against the benchmark's plain float32 reference
(``h100bench/reference/drn.py``: fyu/drn's Bottleneck, stride and dilation
on conv2, the downsample last), and the spans inside each bottleneck block:
``block.reduce``, ``block.spatial`` and ``block.expand``, recorded exactly
while a profiler session is on, nested in their stage's span."""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from h100bench import scene
from h100bench.reference import drn as ref
from tpuseg_torch.metrics import profiling
from tpuseg_torch.models.drn import drn_forward
from tpuseg_torch.models.drnseg import build_drnseg_spec
from tpuseg_torch.ops.fold_bn import fold_bn
from tpuseg_torch.video.pipeline import PolyphaseFrontend, VideoSegmenter

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("block.reduce", "block.spatial", "block.expand")


def _cfg(name="drn_d_105"):
    with open(os.path.join(ROOT, "h100bench", "configs", f"{name}.json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def d105():
    """The configuration, seeded He-init weights with a random (trained-like)
    BatchNorm, and 4 frames of a moving-shapes scene at 64x128."""
    cfg = _cfg()
    params, state = scene.make_weights(cfg, 2 ** 31 + 7, "cpu")
    frames = scene.video(11, "cpu", (64, 128), 4, cfg["num_classes"])
    return cfg, params, state, frames


@pytest.fixture(autouse=True)
def _empty_record():
    profiling.clear()
    yield
    profiling.clear()


def test_served_ids_follow_the_reference(d105):
    """``VideoSegmenter`` in float32 on the unfused polyphase frontend: every
    served id's reference logit within 1e-4 of the logits' scale below the
    reference's best at its pixel."""
    cfg, params, state, frames = d105
    spec = build_drnseg_spec(cfg["arch"], cfg["num_classes"])
    seg = VideoSegmenter(params, state, spec, cfg["mean"], cfg["std"], device="cpu",
                         compute_dtype=torch.float32, batch=4)
    assert isinstance(seg.stem_fn, PolyphaseFrontend) and seg.stem_stages == 3
    out = seg.run(list(frames), need_color=False)
    assert out["frames"] == 4 and out["ids"].shape == (4, 64, 128)
    with torch.no_grad():
        logits = ref.serve_logits(ref.fold(params, state, cfg), cfg, torch.from_numpy(frames),
                                  ref.Precision("float32"))
    gap, scale = ref.gap_of(logits, torch.from_numpy(out["ids"]))
    assert scale > 0 and gap <= 1e-4 * scale


def test_backbone_features_follow_the_reference(d105):
    """The port's backbone on its own BN fold against the reference's, to
    float32 rounding (the two sum each conv in another order)."""
    cfg, params, state, frames = d105
    spec = build_drnseg_spec(cfg["arch"], cfg["num_classes"])
    x = ref.normalize(torch.from_numpy(frames), cfg["mean"], cfg["std"])
    with torch.no_grad():
        got, _ = drn_forward(fold_bn(params, state, spec), {}, x.permute(0, 2, 3, 1), spec)
        want = ref.backbone(ref.fold(params, state, cfg), cfg, x, ref.Precision("float32"))
    got = got.permute(0, 3, 1, 2)
    assert got.shape == want.shape == (4, 512, 8, 16)
    err = (got - want).norm() / want.norm()
    assert err < 1e-5, float(err)


def _forward(arch, size=(32, 32)):
    spec = build_drnseg_spec(arch, 19)
    params, state = scene.make_weights(_cfg(arch), 3, "cpu")
    folded = fold_bn(params, state, spec)
    x = torch.rand((1, *size, 3), generator=torch.Generator().manual_seed(0))
    return spec, lambda: drn_forward(folded, {}, x, spec)


def test_each_bottleneck_block_records_three_spans():
    spec, fwd = _forward("drn_d_105")
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        fwd()
    spans = profiling.spans()
    by_id = {s.id: s for s in spans}
    blocks = [s for s in spans if s.name.startswith("block.")]
    want = [(i, blk.convs[-1].cout) for i, (_n, st) in enumerate(spec.stages)
            for blk in st.blocks if blk.kind == "bottleneck"]
    assert len(want) == 33 and len(blocks) == 99
    assert [s.name for s in blocks] == list(PARTS) * 33
    for k, s in enumerate(blocks):
        stage, width = want[k // 3]
        assert s.attrs == {"stage": stage, "width": width}
        assert by_id[s.parent].name == f"forward.layer.{stage}"
        assert s.device_ms is None  # no CUDA events on a CPU tensor
    assert {w for _s, w in want} == {256, 512, 1024, 2048}
    # the three parts of a block follow one another inside it
    for a, b in zip(blocks, blocks[1:]):
        assert a.t1_ns <= b.t0_ns


def test_basic_blocks_and_unprofiled_forwards_record_nothing_new():
    _spec, fwd = _forward("drn_d_22")
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        fwd()
    names = {s.name for s in profiling.spans()}
    assert names and not names & set(PARTS)
    profiling.clear()
    _spec, fwd = _forward("drn_d_105")
    with torch.no_grad():
        fwd()
    assert profiling.spans() == [] and profiling.spans_dropped() == 0
