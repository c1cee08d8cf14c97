"""The readers of the program's spans (``program_spans.py`` and the four
metrics that use it) on synthetic spans and a synthetic ``Trace``: the
anchors recover a clock offset, and every reader returns None where it has
nothing to read.  On the CPU the serving cell's own spans feed the
counter's reader; on the card (``-m card``) the recorder is on under the
CUDA-only ``device_trace()`` and the ``run.wait`` spans anchor.

    python -m pytest h100bench/test_h100bench_spans.py -q -m card
"""

import time

import pytest
import torch

from h100bench import harness, program_spans
from h100bench.trace import Trace

OFFSET_US = 1_790_000_000_000_000.0 / 1e3 + 123.456  # span clock less trace clock
T0_US = 1_000_000.0  # trace time of the first call's start


def _rec(name, id_, parent, call, t0_us, t1_us, attrs=None, device_ms=None):
    """A span at trace times ``t0_us``..``t1_us``, stamped on the span clock."""
    return program_spans.Rec(name, id_, parent, call, round((t0_us + OFFSET_US) * 1e3),
                             round((t1_us + OFFSET_US) * 1e3), attrs or {}, device_ms)


def _serving(calls=2, waits=10, sync_us=150.0, lead_us=None):
    """``calls`` run() calls of ``waits`` batches, 1000 us apart: per batch
    a 100 us stack, a 200 us wait around a ``sync_us`` cudaEventSynchronize
    (in its middle, or ``lead_us`` after the wait's start), and a 50 us
    unpack; kernels run in [0, 300) us of each batch.  Returns (spans,
    trace events)."""
    spans, events, nid = [], [], 0
    for c in range(calls):
        t = T0_US + c * (waits * 1000.0 + 500.0)
        nid += 1
        root = nid
        body = []
        for b in range(waits):
            bt = t + b * 1000.0
            for name, a, d in (("run.stack", 0, 100), ("run.wait", 400, 200),
                               ("run.unpack", 700, 50)):
                nid += 1
                body.append(_rec(name, nid, root, root, bt + a, bt + a + d))
            lead = (200.0 - sync_us) / 2 if lead_us is None else lead_us
            events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaEventSynchronize",
                           "ts": bt + 400.0 + lead, "dur": sync_us})
            events.append({"ph": "X", "cat": "kernel", "name": "k", "ts": bt, "dur": 300.0})
        fr = waits * 8
        spans.append(_rec("run", root, None, root, t, t + waits * 1000.0,
                          {"frames_returned": fr, "frames_forwarded": fr + 8 + 3,
                           "frames_warm": 8, "frames_padded": 3}))
        spans.extend(body)
    return spans, events


def _ctx(trace_events, counts, window_s=1.0):
    return harness.Ctx(None, Trace(trace_events), window_s, 0.5, counts, {})


@pytest.fixture
def fake_record(monkeypatch):
    box = []
    monkeypatch.setattr(program_spans, "recorded", lambda: box[0])
    monkeypatch.setattr(program_spans, "_last", [None, None])
    return box


def test_anchors_recover_the_offset():
    spans, events = _serving()
    off = program_spans.offset_us(spans, Trace(events))
    assert off == pytest.approx(OFFSET_US, abs=1e-3)


def test_anchors_hold_when_waits_wake_late():
    """As on the card: a wait's call starts about a microsecond after the
    span, but a long block wakes tens of microseconds late, so the short
    waits' margins are a few microseconds after the event and the long
    ones' far more.  Every wait must still enclose its event."""
    spans, events = _serving(calls=1, waits=10, sync_us=196.0, lead_us=1.0)
    syncs = [e for e in events if e["name"] == "cudaEventSynchronize"]
    for e in syncs[:3]:  # three short waits: the event 195 us, woken 4 us later
        e["dur"] = 195.0
    for e in syncs[3:]:  # seven long ones: woken 55 us after the event's end
        e["dur"] = 144.0
    trace = Trace(events)
    off = program_spans.offset_us(spans, trace)
    assert off is not None
    waits = program_spans.named(spans, "run.wait")
    starts = sorted(e["ts"] for e in syncs)
    evs = sorted((e["ts"], e["ts"] + e["dur"]) for e in syncs)
    assert all(len(program_spans._enclosed(w.t0_ns * 1e-3 - off, w.t1_ns * 1e-3 - off,
                                           starts, evs)) == 1 for w in waits)


@pytest.mark.parametrize("fault", ["no_events", "no_waits", "events_longer"])
def test_anchors_missing_give_none(fault):
    spans, events = _serving(sync_us=250.0 if fault == "events_longer" else 150.0)
    if fault == "no_events":
        events = [e for e in events if e["name"] != "cudaEventSynchronize"]
    if fault == "no_waits":
        spans = [s for s in spans if s.name != "run.wait"]
    assert program_spans.offset_us(spans, Trace(events)) is None
    assert program_spans.idle_inside_s(spans, Trace(events), program_spans.HOST_SPANS) is None


def test_under_nine_tenths_anchored_gives_none():
    spans, events = _serving(calls=1, waits=10)
    syncs = [e for e in events if e["name"] == "cudaEventSynchronize"]
    for e in syncs[:2]:  # two of ten waits no longer enclose their event
        e["ts"] += 300.0
    assert program_spans.offset_us(spans, Trace(events)) is None
    syncs[1]["ts"] -= 300.0  # nine of ten
    assert program_spans.offset_us(spans, Trace(events)) is not None


def test_the_four_readers(fake_record):
    spans, events = _serving(calls=3)
    fake_record.append(spans)
    ctx = _ctx(events, {"attempted": 2, "frames": 160}, window_s=0.05)
    read = {n: harness.layer_metric(n).read(ctx) for n in (
        "run_host_ms_per_frame.video", "run_host_idle_share.video",
        "unreturned_frame_share.video", "update_ms_per_step.train")}
    # the last two calls: 20 batches of 150 us host work for 160 frames
    assert read["run_host_ms_per_frame.video"] == pytest.approx(20 * 0.150 / 160)
    # the kernels cover each batch's [0, 300): the stack is busy, the unpack idle
    assert read["run_host_idle_share.video"] == pytest.approx(100 * 20 * 50e-6 / 0.05)
    assert read["unreturned_frame_share.video"] == pytest.approx(100 * 22 / (160 + 22))
    assert read["update_ms_per_step.train"] is None


def test_self_time_leaves_out_children():
    a = _rec("run.color", 2, 1, 1, 0.0, 100.0)
    kids = [_rec("x", 3, 2, 1, 10.0, 30.0), _rec("x", 4, 2, 1, 20.0, 40.0),
            _rec("x", 5, 2, 1, 90.0, 120.0)]
    # covered: [10, 40) and [90, 100) of its [0, 100) us
    assert program_spans.self_ms([a] + kids, ("run.color",)) == pytest.approx(0.060)


def test_update_reader_and_burst_choice(fake_record):
    steps, nid = [], 0
    for i in range(5):
        nid += 1
        root = nid
        steps.append(_rec("train.step", root, None, root, i * 100.0, i * 100.0 + 90))
        for j, name in enumerate(("train.forward", "train.backward", "train.update")):
            nid += 1
            steps.append(_rec(name, nid, root, root, i * 100.0 + j * 30, i * 100.0 + j * 30 + 20,
                              device_ms=float(i + 1) if name == "train.update" else 5.0))
    fake_record.append(steps)
    ctx = _ctx([], {"attempted": 3, "steps": 3})
    reader = harness.layer_metric("update_ms_per_step.train")
    assert reader.read(ctx) == pytest.approx((3 + 4 + 5) / 3)  # the last three steps


def test_without_a_recorder_every_reader_gives_none(fake_record):
    fake_record.append(None)
    ctx = _ctx(_serving()[1], {"attempted": 1, "frames": 80})
    for n in ("run_host_ms_per_frame.video", "run_host_idle_share.video",
              "unreturned_frame_share.video", "update_ms_per_step.train"):
        assert harness.layer_metric(n).read(ctx) is None


def test_serving_cell_counts_on_the_cpu():
    """The serving cell small on the CPU, its burst under a CPU profiler
    session: the counter's reader reads the program's own attributes."""
    from torch.profiler import ProfilerActivity, profile

    from tpuseg_torch.metrics import profiling

    spec = harness.bench_spec()
    over = {"config": {"frame": [64, 128]},
            "traffic": {"pool_frames": 8, "frames_per_call": 13, "warm_frames": 4, "batch": 4,
                        "check_frames": 2, "trace_calls": 2}}
    cell = harness.cell_for(spec, "d22.video960", 2 ** 31 + 77, "cpu", overrides=over)
    runner = harness.driver(cell).setup(cell)
    profiling.clear()
    runner.lead()
    with profile(activities=[ProfilerActivity.CPU]):
        counts = runner.burst()
    program_spans._last[:] = [None, None]
    ctx = harness.Ctx(cell, Trace([]), 1.0, 0.5, counts, {})
    try:
        share = harness.layer_metric("unreturned_frame_share.video").read(ctx)
        host_ms = harness.layer_metric("run_host_ms_per_frame.video").read(ctx)
        runs = program_spans.named(program_spans.burst(ctx), "run")
    finally:
        profiling.clear()
    # 13 frames at batch 4: a warm batch of 4, then 4 + 4 + 4 + (1 + 3 padded)
    assert len(runs) == 2 and share == pytest.approx(100 * 7 / 20)
    assert host_ms > 0
    assert harness.layer_metric("run_host_idle_share.video").read(ctx) is None  # no anchors


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.mark.card
def test_the_recorder_is_on_under_the_device_trace_and_anchors():
    from h100bench.trace import device_trace
    from tpuseg_torch.metrics import profiling

    dev = _card()
    spec = harness.bench_spec()
    over = {"traffic": {"frames_per_call": 320, "warm_frames": 32}}
    cell = harness.cell_for(spec, "d22.video960", 2 ** 33 + 5, dev, overrides=over)
    runner = harness.driver(cell).setup(cell)
    profiling.clear()
    runner.lead()
    assert profiling.spans() == []  # off outside a profiler session
    with device_trace() as box:
        t0 = time.perf_counter()
        counts = runner.burst()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    ctx = harness.Ctx(cell, box[0], window_s, box[0].busy_s(), counts, runner.work())
    spans = program_spans.burst(ctx)
    assert spans, "no span recorded under the CUDA-only device trace"
    waits = program_spans.named(spans, "run.wait")
    off = program_spans.offset_us(spans, ctx.trace)
    assert off is not None and len(waits) == 10
    events = sorted((t, t + d) for n, t, d in ctx.trace.host if n == "cudaEventSynchronize")
    starts = [e[0] for e in events]
    anchored = [len(program_spans._enclosed(s.t0_ns * 1e-3 - off, s.t1_ns * 1e-3 - off,
                                            starts, events)) == 1 for s in waits]
    assert sum(anchored) >= 0.9 * len(waits)
    read = {m["name"]: harness.layer_metric(m["name"]).read(ctx)
            for m in harness.metrics_of(spec, "per_layer", cell.name)}
    assert read["unreturned_frame_share.video"] == pytest.approx(100 * 32 / 352)
    assert 0 < read["run_host_idle_share.video"] <= read["device_idle_share.video"]
    assert read["run_host_ms_per_frame.video"] > 0
    profiling.clear()


@pytest.mark.card
def test_the_update_span_reads_on_the_card():
    from h100bench.trace import device_trace
    from tpuseg_torch.metrics import profiling

    dev = _card()
    spec = harness.bench_spec()
    cell = harness.cell_for(spec, "d22.train512", 2 ** 33 + 6, dev,
                            overrides={"traffic": {"trace_steps": 5}})
    runner = harness.driver(cell).setup(cell)
    profiling.clear()
    runner.lead()
    with device_trace() as box:
        t0 = time.perf_counter()
        counts = runner.burst()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    ctx = harness.Ctx(cell, box[0], window_s, box[0].busy_s(), counts, runner.work())
    ms = harness.layer_metric("update_ms_per_step.train").read(ctx)
    assert ms is not None and 0 < ms < 1e3 * window_s / counts["steps"]
    profiling.clear()
