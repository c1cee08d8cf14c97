"""Readings that set the limits of ``correct``: the control (the plain
reference in a lower precision than the configuration states, put in the
program's place) and the faults a cell can have, on the card, at the cell's
own sizes, for each of several seeds (the cells of ``BENCHMARK.json`` and
those ``waiting.json`` keeps for later).  Each goes through the cell's own
``check()``, and ``harness.verdict`` says whether a run would be correct.

    python -m h100bench.control --workload d22.video960 --seeds 11 12 13
    python -m h100bench.control --workload d22.train512 --seeds 11 --look

Serving cells: on ``check_frames`` frames of the pool drawn from the seed,
the ids the lower precision puts first (``fp8`` for a bf16 configuration,
``int4`` for an int8 one; the cell's limits file names it).  Training: the
reference's three steps in fp8, and the fault of half of each batch left
out (the mean taken over the rest).  ``--look`` (training): the worst leaf
of each reading, the program's and the reference's own in bf16 (under
autocast, and with bf16 casts of every conv's operands and output
gradient), each against the float32 reference.  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def serve_control(runner, mode: str) -> dict:
    """The control's ids in the reservoir, judged by ``runner.check()``."""
    rng = np.random.default_rng(runner.cell.seeds(5)[4])
    n = runner.cell.traffic["check_frames"]
    keys = [(int(rng.integers(runner.pool.shape[0])), int(rng.integers(runner.pool.shape[1])))
            for _ in range(n)]
    runner.reservoir = [(key, logits.argmax(dim=1)[0].to(torch.uint8).cpu().numpy())
                        for key, logits in runner.reference_logits(keys, mode)]
    return runner.check()


def train_control(runner, kind: str) -> dict:
    """``kind`` ``"fp8"`` (the control) or ``"half_batch"`` (the fault) in
    the program's place, judged by ``runner.check()``."""
    from h100bench.reference import drn

    if kind == "fp8":
        runner.prog = runner.reference(drn.Precision("fp8", train=True))
    else:
        runner.prog = runner.reference(drn.Precision("float32"),
                                       slice(0, runner.cell.traffic["batch"] // 2))
    return runner.check()


def train_look(runner) -> dict:
    """The worst leaf ``[name, reading, elements]`` of ``grad``, ``step``
    and ``var`` and the medians, for the program and for the reference in
    bf16, each against the float32 reference."""
    from h100bench.drivers.train import leaf_readings
    from h100bench.reference import drn

    ref = runner.reference(drn.Precision("float32"))
    with torch.autocast(runner.cell.device.type, dtype=torch.bfloat16):
        autocast = runner.reference(drn.Precision("float32"))
    sides = {"program": runner.prog, "reference_bf16_autocast": autocast,
             "reference_bf16_casts": runner.reference(drn.Precision("bf16", train=True))}
    out = {}
    for side, got in sides.items():
        r = leaf_readings(runner.p0, got, ref)
        size = lambda n: runner.p0.get(n, runner.p0.get(f"{n}.weight")).numel()  # noqa: E731
        out[side] = {k: {"worst": max(([n, v, size(n)] for n, v in r[k].items()),
                                      key=lambda x: x[1]),
                         "median": float(np.median(list(r[k].values())))}
                     for k in ("grad", "step", "var")}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--look", action="store_true")
    args = p.parse_args(argv)

    from h100bench import harness

    spec = harness.with_waiting(harness.bench_spec())
    for seed in args.seeds:
        cell = harness.cell_for(spec, args.workload, seed, args.device)
        train = cell.traffic["kind"] == "train"
        runner = harness.driver(cell).setup(cell, program=args.look and train)
        if args.look and train:
            runner.free()
            out = train_look(runner)
        elif train:
            out = {}
            for kind in ("fp8", "half_batch"):
                checks = train_control(runner, kind)
                out[kind] = {"correct": harness.verdict(0, checks), "checks": checks}
        else:
            checks = serve_control(runner, cell.limits["control"])
            out = {cell.limits["control"]: {"correct": harness.verdict(0, checks),
                                            "checks": checks}}
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
        del runner
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
