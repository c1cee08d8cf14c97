"""Run one cell of the benchmark once and print its result line.

    python -m h100bench.run --workload d22.video960 --seed 7 --seconds 30 --trace 0

Loads the cell's configuration and traffic, builds the program's state from
the seed and warms it up (``setup_s``, from the first line of this module),
measures for ``--seconds`` (``--trace 0``: the cell's end-to-end metrics) or
traces a short steady burst (``--trace 1``: its per-layer metrics), then
frees the program's state and compares what the timed path produced with
the plain reference.  The last line of standard output is one JSON object;
the numbers compared, each beside its limit, are also the last lines of
standard error.  Needs as many CUDA devices as the cell asks for; exits 1
without them, and exits 1 if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from h100bench import harness

    spec = harness.bench_spec()
    wl = harness.workload(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"error: {args.workload} needs {wl['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    cell = harness.cell_for(spec, args.workload, args.seed, "cuda:0")
    line = harness.run_cell(spec, cell, args.seconds, bool(args.trace), T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"error: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 1
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
