"""``correct`` comes out false when the timed path is broken underneath: a
run driven past the harness's look for a card (the cell on the CPU at a
small size), with each fault its cell can have planted in the program.
Serving: an answer altered where it is produced (class ids shifted in the
fused upsample+argmax's output).  Training: a step that returns its state
unchanged; half of each batch left out, the mean taken over the rest.  A
run with nothing broken comes out correct."""

import time

import pytest
import torch

from h100bench import harness

SERVE = {"config": {"frame": [64, 128]},
         "traffic": {"pool_frames": 8, "frames_per_call": 8, "warm_frames": 4, "batch": 4,
                     "check_frames": 3}}
TRAIN = {"traffic": {"crop": [64, 64], "batch": 4, "ring": 4}}


def _run(name, over, seed=77):
    spec = harness.with_waiting(harness.bench_spec())
    cell = harness.cell_for(spec, name, seed, "cpu", overrides=over)
    return harness.run_cell(spec, cell, 0.2, False, time.perf_counter())


@pytest.mark.parametrize("name", ["d22.clips30", "d22_b875_int8.clips30", "d22.video960"])
def test_serving_with_altered_ids_is_not_correct(name, monkeypatch):
    import tpuseg_torch.video.pipeline as pipeline

    real = pipeline.upsample_argmax

    def shifted(seg, up):
        ids = real(seg, up)
        ids[:, ::7] = (ids[:, ::7] + 1) % seg.shape[-1]
        return ids

    assert _run(name, SERVE)["correct"]
    monkeypatch.setattr(pipeline, "upsample_argmax", shifted)
    line = _run(name, SERVE)
    assert not line["correct"] and line["checks"]["gap"]["value"] > line["checks"]["gap"]["limit"]


def _broken_step(monkeypatch, fault):
    import tpuseg_torch.train as train

    real = train.make_seg_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def broken(state, images, labels, ranks=None):
            if fault == "half_batch":
                h = images.shape[0] // 2
                return step(state, images[:h], labels[:h], ranks)
            _new, m = step(state, images, labels, ranks)
            return state, m  # the update computed and thrown away

        return broken

    monkeypatch.setattr(train, "make_seg_train_step", make)


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_a_broken_train_step_is_not_correct(fault, monkeypatch):
    _broken_step(monkeypatch, fault)
    line = _run("d22.train512", TRAIN)
    assert not line["correct"]
    over = [k for k, c in line["checks"].items() if c["value"] > c["limit"]]
    assert over, line["checks"]
    if fault == "unchanged_state":
        assert line["checks"]["step"]["value"] == pytest.approx(1.0)


def test_the_reference_follows_the_port_in_float32():
    """The port's float32 train step and the reference's agree on the first
    step to rounding (the harness's comparison itself is sound)."""
    from h100bench.drivers.train import TrainRunner, compare
    from h100bench.reference import drn

    spec = harness.with_waiting(harness.bench_spec())
    over = {"traffic": {"crop": [64, 64], "batch": 2, "ring": 4, "check_steps": 1},
            "config": {"compute_dtype": "float32"}}
    cell = harness.cell_for(spec, "d22.train512", 5, "cpu", overrides=over)
    r = TrainRunner(cell)
    got = compare(r.p0, r.prog, r.reference(drn.Precision("float32")))
    assert got["loss"] < 1e-5 and got["grad"] < 1e-4 and got["step"] < 1e-4


@pytest.mark.parametrize("name", ["d22.clips30", "d22_b875_int8.clips30"])
def test_the_reference_follows_the_port_serving_float32(name):
    """The port served in float32 and the reference in the configuration's
    precision lie within rounding of each other.  Two correct int8 paths
    differ by more: a last-bit difference flips a rounding to the int8 grid
    now and then, and each flip moves every later layer's inputs, so their
    ids differ about as much as int8's from float32's (a gap near 0.1 at
    this size; an int4 control reads ~1)."""
    from h100bench.drivers.serve import ServeRunner

    spec = harness.with_waiting(harness.bench_spec())
    over = {"config": {"frame": [64, 128], "compute_dtype": "float32"},
            "traffic": {"pool_frames": 8, "frames_per_call": 8, "warm_frames": 4, "batch": 4,
                        "check_frames": 4}}
    cell = harness.cell_for(spec, name, 9, "cpu", overrides=over)
    r = ServeRunner(cell)
    r.window(0.1)
    r.free()
    assert r.check()["gap"]["value"] < (1e-4 if name == "d22.clips30" else 0.25)
    assert torch.get_default_dtype() == torch.float32
