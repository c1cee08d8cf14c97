"""The port's spans (``tpuseg_torch.metrics.profiling.span``): recorded
exactly while a ``torch.profiler`` session is active, with their parents,
call ids and attributes; ``run()``'s serving-loop spans and counters, the
forward's stages and the train step's phases; the clock against the
exported trace's; ``trace`` still writing one file, now with the spans."""

import glob
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpuseg_torch.metrics import profiling
from tpuseg_torch.models.drn import build_drn_spec, init_drn
from tpuseg_torch.models.drnseg import init_drnseg
from tpuseg_torch.train import (
    create_train_state,
    make_cls_train_step,
    make_seg_train_step,
    make_sgd,
)
from tpuseg_torch.video.pipeline import SyntheticFrames, VideoSegmenter

torch.set_num_threads(2)

MEAN = [0.290, 0.328, 0.287]
STD = [0.183, 0.187, 0.184]
STAGES = [f"forward.layer.{i}" for i in range(9)]


@pytest.fixture(autouse=True)
def _empty_record():
    profiling.clear()
    yield
    profiling.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _serve(frames=5, batch=4):
    p, s, spec = init_drnseg(0, "drn_d_22", 19)
    seg = VideoSegmenter(p, s, spec, MEAN, STD, device="cpu", compute_dtype=torch.float32,
                         batch=batch)
    return seg, list(SyntheticFrames(frames, (32, 64), seed=1))


def _seg_step():
    p, s, spec = init_drnseg(0, "drn_d_22", 19)
    tx = make_sgd(0.01, 0.9, 1e-4)
    g = torch.Generator().manual_seed(0)
    images = torch.rand((2, 32, 32, 3), generator=g)
    labels = torch.randint(0, 19, (2, 32, 32), generator=g)
    step = make_seg_train_step(spec, tx, compute_dtype=None)
    return (lambda: step(create_train_state(p, s, tx), images, labels)), spec


def _cls_step():
    spec = build_drn_spec("drn_d_22", 10)
    p, s = init_drn(0, spec)
    tx = make_sgd(0.01, 0.9, 1e-4)
    g = torch.Generator().manual_seed(0)
    images = torch.rand((2, 32, 32, 3), generator=g)
    labels = torch.randint(0, 10, (2,), generator=g)
    step = make_cls_train_step(spec, tx, compute_dtype=None)
    return (lambda: step(create_train_state(p, s, tx), images, labels)), spec


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_span_off_is_the_shared_noop():
    assert not torch.autograd.profiler._is_profiler_enabled
    for sp in (profiling.span("x"), profiling.span("x", device=torch.device("cpu"), n=3)):
        assert sp is profiling._NO_SPAN
        with sp as s:
            s.set(k=1)
    assert profiling.spans() == []


@pytest.mark.parametrize("work", ["run", "seg_step", "cls_step"])
def test_nothing_is_recorded_without_a_profiler(work):
    if work == "run":
        seg, frames = _serve()
        out = seg.run(frames)
        assert out["frames"] == 5 and "batch_times" not in out
    else:
        (_seg_step if work == "seg_step" else _cls_step)()[0]()
    assert profiling.spans() == [] and profiling.spans_dropped() == 0


def test_parents_call_ids_and_attrs():
    with _cpu_profile():
        with profiling.span("a", n=1) as a:
            with profiling.span("b") as b:
                with profiling.span("c") as c:
                    pass
            a.set(m=2)
        with profiling.span("d") as d:
            pass
    assert [s.name for s in profiling.spans()] == ["a", "b", "c", "d"]
    assert (a.parent, b.parent, c.parent, d.parent) == (None, a.id, b.id, None)
    assert a.call == b.call == c.call == a.id and d.call == d.id
    assert a.attrs == {"n": 1, "m": 2}
    assert a.t0_ns <= b.t0_ns <= c.t0_ns <= c.t1_ns <= b.t1_ns <= a.t1_ns <= d.t0_ns
    assert all(s.device_ms is None for s in profiling.spans())
    profiling.clear()
    assert profiling.spans() == []


def test_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAP", 3)
    with _cpu_profile():
        for _ in range(5):
            with profiling.span("x"):
                pass
    assert len(profiling.spans()) == 3 and profiling.spans_dropped() == 2


def test_run_spans_and_counters():
    """5 frames at batch 4: the warm batch (4), then 4 and 1 + 3 padded; the
    two batches take two new input ring buffers, and the output, sized from
    the list's length, never grows."""
    seg, frames = _serve()
    with _cpu_profile():
        out = seg.run(frames)
    spans = profiling.spans()
    runs = [s for s in spans if s.name == "run"]
    assert len(runs) == 1
    run = runs[0]
    assert run.parent is None and all(s.call == run.id for s in spans)
    assert run.attrs == {"frames_forwarded": 12, "frames_returned": 5, "frames_warm": 4,
                         "frames_padded": 3, "h2d_bytes": out["h2d_bytes"],
                         "d2h_bytes": out["d2h_bytes"], "staging_allocs": 2, "out_grows": 0}
    kids = _children(spans, run)
    # no h2d, d2h or wait on the CPU: that work happens only on the card; each
    # batch's rows go into the output in its run.unpack and run.color
    assert [s.name for s in kids] == [
        "run.stack", "run.warm", "run.dispatch", "run.stack", "run.dispatch",
        "run.unpack", "run.color", "run.unpack", "run.color"]
    assert all(a.t1_ns <= b.t0_ns for a, b in zip(kids, kids[1:]))
    forwards = [s for s in spans if s.name == "forward"]
    assert [s.attrs for s in forwards] == [{"batch": 4}] * 3
    for fwd in forwards:
        names = [s.name for s in _children(spans, fwd)]
        assert names == ["forward.frontend"] + STAGES[4:] + ["forward.upsample_argmax"]
    assert all(s.device_ms is None for s in spans)


@pytest.mark.parametrize("make", [_seg_step, _cls_step], ids=["seg", "cls"])
def test_train_step_spans(make):
    step, spec = make()
    with _cpu_profile():
        step()
    spans = profiling.spans()
    root = spans[0]
    assert root.name == "train.step" and all(s.call == root.id for s in spans)
    kids = _children(spans, root)
    assert [s.name for s in kids] == ["train.forward", "train.backward", "train.update"]
    assert all(a.t1_ns <= b.t0_ns for a, b in zip(kids, kids[1:]))
    stages = [s.name for s in _children(spans, kids[0])]
    assert stages == [f"forward.{name}" for name, _ in spec.stages]
    assert all(s.device_ms is None for s in spans)


def _trace_file(logdir) -> dict:
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as fh:
        return json.load(fh)


def test_span_clock_encloses_the_traced_op(tmp_path):
    """Span stamps and the trace's ``ts`` + ``baseTimeNanoseconds`` are one
    clock: the op run inside a span lies inside it."""
    with profiling.trace(str(tmp_path)):
        with profiling.span("ones") as sp:
            torch.ones(1000, 1000)
    doc = _trace_file(str(tmp_path))
    base = int(doc["baseTimeNanoseconds"])
    ops = [e for e in doc["traceEvents"] if e.get("name") == "aten::ones"]
    assert len(ops) == 1
    t0 = base + round(ops[0]["ts"] * 1e3)  # integer ns: a float of 1e18 rounds to 256
    assert sp.t0_ns <= t0 and t0 + round(ops[0]["dur"] * 1e3) <= sp.t1_ns


def test_trace_writes_one_file_with_the_spans(tmp_path):
    with _cpu_profile():
        with profiling.span("before"):
            pass
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer", n=7):
            with profiling.span("inner"):
                torch.ones(8) * 2
    doc = _trace_file(str(tmp_path))
    ours = [e for e in doc["traceEvents"] if e.get("cat") == "tpuseg_span"]
    assert [e["name"] for e in ours] == ["outer", "inner"]
    outer, inner = ours
    assert (outer["pid"], outer["tid"]) == profiling.SPAN_TRACK
    assert outer["args"]["n"] == 7 and outer["args"]["parent"] is None
    assert inner["args"]["parent"] == outer["args"]["span_id"]
    assert inner["args"]["call"] == outer["args"]["span_id"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert any(e.get("name") == "aten::mul" for e in doc["traceEvents"])
