"""The cell ``d105.video960`` (DRN-D-105 DRNSeg served as ``d22.video960``
is): its entries in BENCHMARK.json, a small run on the CPU, the bottleneck
blocks' operation and byte counts (``blocks.py``) against a hand
computation, and the two readers of the blocks' spans
(``bottleneck_roofline.video``, ``expand_ms_per_frame.video``) on
hand-made span records and on the spans the cell's program records."""

import time

import pytest
from torch.profiler import ProfilerActivity, profile

from h100bench import blocks, harness, program_spans, work

CELL = "d105.video960"
NEW = ("bottleneck_roofline.video", "expand_ms_per_frame.video")
SMALL = {"config": {"frame": [64, 128]},
         "traffic": {"pool_frames": 8, "frames_per_call": 12, "warm_frames": 4, "batch": 4,
                     "check_frames": 3}}


def test_benchmark_json_gains_the_cell_and_its_metrics():
    spec = harness.bench_spec()
    conf = next(c for c in spec["configs"] if c["name"] == "drn_d_105")
    assert conf["reduced"] == [] and conf["file"] == "h100bench/configs/drn_d_105.json"
    # a configuration is told apart from the others by its source and its reduced keys
    assert all(c["source"] != conf["source"] for c in spec["configs"] if c is not conf)
    wl = harness.workload(spec, CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == ("drn_d_105", "video960", 1)
    cfg = harness.cell_for(spec, CELL, 1, "cpu").cfg
    assert (cfg["arch"], cfg["block"], cfg["layers"]) == (
        "drn_d_105", "bottleneck", [1, 1, 3, 4, 23, 3, 1, 1])
    assert cfg["frame"] == [1024, 2048] and cfg["compute_dtype"] == "bfloat16"
    assert [m["name"] for m in harness.metrics_of(spec, "end_to_end", CELL)] == ["fps",
                                                                                 "setup_s"]
    # run_host_idle_share.video leaves the cell out: its run.wait anchors failed to
    # line up in one of eight traced runs of this 16 s window, so the reader can
    # come back empty here
    video = [m["name"] for m in spec["per_layer"]
             if m["name"].endswith(".video") and m["name"] != "run_host_idle_share.video"]
    assert [m["name"] for m in harness.metrics_of(spec, "per_layer", CELL)] == video
    assert video[-2:] == list(NEW)
    new = [m for m in spec["per_layer"] if m["name"] in NEW]
    assert all(m["workloads"] == [CELL] and m["source"] == "program_span"
               and m["moves"] == "fps" for m in new)
    assert new[0]["layer"] == new[1]["layer"]


def test_the_cell_runs_small_on_the_cpu():
    spec = harness.bench_spec()
    cell = harness.cell_for(spec, CELL, 2 ** 31 + 12345, "cpu", overrides=SMALL)
    line = harness.run_cell(spec, cell, 0.3, False, time.perf_counter())
    assert line["correct"] and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"fps", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())


def test_altered_ids_are_not_correct(monkeypatch):
    """Class ids shifted where B1 writes them (as ``test_h100bench_faults``
    does for the DRN-D-22 cells) push the gap past the cell's limit."""
    import tpuseg_torch.video.pipeline as pipeline

    real = pipeline.upsample_argmax

    def shifted(seg, up):
        ids = real(seg, up)
        ids[:, ::7] = (ids[:, ::7] + 1) % seg.shape[-1]
        return ids

    monkeypatch.setattr(pipeline, "upsample_argmax", shifted)
    spec = harness.bench_spec()
    cell = harness.cell_for(spec, CELL, 77, "cpu", overrides=SMALL)
    line = harness.run_cell(spec, cell, 0.2, False, time.perf_counter())
    assert not line["correct"] and line["checks"]["gap"]["value"] > cell.limits["gap"]


def _block(cfg, conv1):
    return next(b for b in blocks.bottleneck_convs(cfg, (1024, 2048))
                if b[0][0][0].name == conv1)


def test_a_stage5_block_counted_by_hand():
    """``layer.5.3`` at 1024x2048 (128x256 at stride 8): 1x1 1024 -> 256,
    3x3 256 -> 256 at dilation 2, 1x1 256 -> 1024, no downsample."""
    cfg = harness.cell_for(harness.bench_spec(), CELL, 1, "cpu").cfg
    convs, residual = _block(cfg, "layer.5.3.conv1")
    assert [c.name for c, *_ in convs] == ["layer.5.3.conv1", "layer.5.3.conv2",
                                           "layer.5.3.conv3"]
    assert [g for _c, *g in convs] == [[128, 256, 128, 256]] * 3
    assert residual == (1024, 128, 256)
    pix = 128 * 256
    want = [(2 * pix * 1024 * 256, 2 * (pix * 1024 + 256 * 1024 + pix * 256)),
            (2 * pix * 9 * 256 * 256, 2 * (pix * 256 + 9 * 256 * 256 + pix * 256)),
            (2 * pix * 256 * 1024, 2 * (pix * 256 + 1024 * 256 + pix * 1024))]
    assert [blocks.conv_ops_bytes(c, *g, 1) for c, *g in convs] == want
    # the 1x1s by their bytes, the 3x3 by its operations, and the residual read
    ms = (want[0][1] / 3.35e12 + want[1][0] / 989e12 + want[2][1] / 3.35e12
          + 2 * 1024 * pix / 3.35e12) * 1e3
    assert blocks.block_ms(convs, residual, 1) == pytest.approx(ms, rel=1e-12)
    assert ms == pytest.approx(0.10951, abs=1e-5)


def test_the_blocks_of_the_configuration():
    """33 blocks: 2,825 GFLOP a 1024x2048 frame, 78 % of its convs', least
    time 4.17 ms a frame; a strided block's conv2 and downsample read the
    block's input; D-22's basic blocks count nothing."""
    spec = harness.bench_spec()
    cfg = harness.cell_for(spec, CELL, 1, "cpu").cfg
    all_blocks = blocks.bottleneck_convs(cfg, (1024, 2048))
    assert len(all_blocks) == 33
    ops = sum(blocks.conv_ops_bytes(c, *g, 1)[0] for convs, _r in all_blocks
              for c, *g in convs)
    assert ops == pytest.approx(2825.0147e9, rel=1e-7)
    assert ops / work.frame_ops(cfg, None, (1024, 2048))["bf16"] == pytest.approx(0.78, abs=0.005)
    assert blocks.bound_ms(cfg, (1024, 2048), 1) == pytest.approx(4.1744, abs=1e-4)
    convs, residual = _block(cfg, "layer.4.0.conv1")
    assert [(c.name.split(".")[-1], g) for c, *g in convs] == [
        ("conv1", [256, 512, 256, 512]), ("conv2", [256, 512, 128, 256]),
        ("conv3", [128, 256, 128, 256]), ("0", [256, 512, 128, 256])]
    assert residual == (512, 128, 256)
    d22 = harness.cell_for(spec, "d22.video960", 1, "cpu").cfg
    assert blocks.bottleneck_convs(d22, (1024, 2048)) == [] and blocks.bound_ms(
        d22, (1024, 2048), 32) == 0


def _rec(name, id_, parent, call, attrs=None, device_ms=None):
    return program_spans.Rec(name, id_, parent, call, id_ * 10, id_ * 10 + 5, attrs or {},
                             device_ms)


def _spans(batches=(32, 32), ms=(1.0, 2.0, 3.0), blocks_a_forward=2):
    """One ``run`` call: a ``forward`` span a batch, each with
    ``blocks_a_forward`` blocks of three parts whose ``device_ms`` are
    ``ms``."""
    out = [_rec("run", 1, None, 1)]
    nid = 1
    for b in batches:
        nid += 1
        fwd = nid
        out.append(_rec("forward", fwd, 1, 1, {"batch": b}))
        for _ in range(blocks_a_forward):
            for name, v in zip(("block.reduce", "block.spatial", "block.expand"), ms):
                nid += 1
                out.append(_rec(name, nid, fwd, 1, {"stage": 5, "width": 1024}, v))
    return out


@pytest.fixture
def fake_record(monkeypatch):
    box = []
    monkeypatch.setattr(program_spans, "recorded", lambda: box[0])
    monkeypatch.setattr(program_spans, "_last", [None, None])
    return box


def _read(name, cell, counts=None):
    ctx = harness.Ctx(cell, None, 1.0, 0.5, counts or {"attempted": 1, "frames": 64}, {})
    return harness.layer_metric(name).read(ctx)


def test_the_readers_on_hand_made_spans(fake_record):
    cell = harness.cell_for(harness.bench_spec(), CELL, 1, "cpu")
    fake_record.append(_spans())
    bound = 2 * blocks.bound_ms(cell.cfg, (1024, 2048), 32)
    assert _read("bottleneck_roofline.video", cell) == pytest.approx(100 * bound / 24.0)
    assert _read("expand_ms_per_frame.video", cell) == pytest.approx(4 * 3.0 / 64)


@pytest.mark.parametrize("fault", ["no_record", "no_spans", "no_blocks", "no_forwards",
                                   "device_ms_none"])
def test_the_readers_give_none(fake_record, fault):
    cell = harness.cell_for(harness.bench_spec(), CELL, 1, "cpu")
    spans = _spans()
    if fault == "no_record":
        spans = None
    elif fault == "no_spans":
        spans = []
    elif fault == "no_blocks":
        spans = [s for s in spans if not s.name.startswith("block.")]
    elif fault == "no_forwards":
        spans = [s for s in spans if s.name != "forward"]
    else:
        spans[-1] = spans[-1]._replace(device_ms=None)
    fake_record.append(spans)
    for name in NEW:
        assert _read(name, cell) is None


def test_the_programs_spans_reach_the_readers():
    """The cell's program at a small size under a CPU profiler: its burst
    records 3 spans a bottleneck block in every forward, each forward's
    ``batch`` and the stage and width of each block; with no CUDA events
    on the CPU every ``device_ms`` is None, so both readers give None."""
    from h100bench.drivers.serve import ServeRunner
    from tpuseg_torch.metrics import profiling

    spec = harness.bench_spec()
    cell = harness.cell_for(spec, CELL, 5, "cpu", overrides=SMALL)
    runner = ServeRunner(cell)
    profiling.clear()
    program_spans._last[:] = [None, None]
    with profile(activities=[ProfilerActivity.CPU]):
        counts = runner.burst()
    ctx = harness.Ctx(cell, None, 1.0, 0.5, counts, {})
    spans = program_spans.burst(ctx)
    forwards = program_spans.named(spans, "forward")
    parts = program_spans.named(spans, "block.reduce", "block.spatial", "block.expand")
    assert [s.attrs["batch"] for s in forwards] == [4] * 4  # the warm batch and 12 frames
    assert len(parts) == 99 * len(forwards)
    assert {(s.attrs["stage"], s.attrs["width"]) for s in parts} == {
        (3, 256), (4, 512), (5, 1024), (6, 2048)}
    assert all(s.device_ms is None for s in parts)
    for name in NEW:
        assert harness.layer_metric(name).read(ctx) is None
    runner.free()
    profiling.clear()
