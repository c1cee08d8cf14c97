"""The control of each cell fails its check, on the card, at sizes a test
run holds (the limits were set from the control at the cells' own sizes,
``python -m h100bench.control``; PERF.md gives the readings).  The control
is put in the program's place and judged by the cell's own ``check()`` and
``harness.verdict``.  Serving: the ids the reference puts first in the next
lower precision (fp8 for bf16, int4 for int8).  Training: the fp8
reference, and the half-batch fault.

    python -m pytest h100bench/test_h100bench_control.py -q -m card
"""

import pytest
import torch

from h100bench import control, harness

SERVE = {"config": {"frame": [256, 512]}, "traffic": {"pool_frames": 8, "check_frames": 4}}
TRAIN = {"traffic": {"crop": [256, 256], "ring": 3}}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.mark.card
@pytest.mark.parametrize("name", ["d22.clips30", "d22_b875_int8.clips30", "d22.video960"])
def test_the_serving_control_fails(name):
    dev = _card()
    spec = harness.with_waiting(harness.bench_spec())
    for seed in (101, 102, 103):
        cell = harness.cell_for(spec, name, seed, dev, overrides=SERVE)
        runner = harness.driver(cell).setup(cell, program=False)
        checks = control.serve_control(runner, cell.limits["control"])
        assert not harness.verdict(0, checks), checks


@pytest.mark.card
def test_the_training_control_and_fault_fail():
    dev = _card()
    spec = harness.with_waiting(harness.bench_spec())
    for seed in (101, 102, 103):
        cell = harness.cell_for(spec, "d22.train512", seed, dev, overrides=TRAIN)
        runner = harness.driver(cell).setup(cell, program=False)
        for kind in ("fp8", "half_batch"):
            checks = control.train_control(runner, kind)
            assert not harness.verdict(0, checks), (kind, checks)


@pytest.mark.parametrize("name", ["d22.clips30", "d22_b875_int8.clips30"])
def test_the_control_goes_through_the_cells_check(name):
    """On the CPU at a small size: the reference's own ids, put in the
    reservoir as the control's are, read no gap and pass the verdict; the
    same ids with one class shifted fail it."""
    from h100bench.drivers import serve

    spec = harness.with_waiting(harness.bench_spec())
    over = {"config": {"frame": [64, 128]},
            "traffic": {"pool_frames": 8, "check_frames": 2, "pool_clips": 2}}
    cell = harness.cell_for(spec, name, 13, "cpu", overrides=over)
    runner = serve.setup(cell, program=False)
    checks = control.serve_control(runner, None)
    assert checks["gap"]["value"] == 0.0 and harness.verdict(0, checks)
    runner.reservoir = [(k, (ids + 1) % cell.cfg["num_classes"]) for k, ids in runner.reservoir]
    assert not harness.verdict(0, runner.check())
