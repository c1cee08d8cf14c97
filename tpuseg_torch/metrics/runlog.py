"""Persistent run logging: JSONL + TensorBoard event files + run comparison
(counterpart of ``tpuseg/metrics/runlog.py``).

The replacement for the reference's two logging surfaces:

- TensorBoard ``SummaryWriter`` with a hyperparameter-encoded run name
  (the reference's semantic_seg.py:1010-1024)
- wandb run logging in the dense baseline
  (the reference's semseg_baseline.py:73-75,253,303,985)

JSONL is always written (it is the machine-readable source of truth and
needs no dependencies); TensorBoard event files are written only where the
``tensorboard`` package imports, so runs can be compared in the TB UI
exactly like the reference's.
``compare_runs`` supplies the reference's missing run-comparison tooling on
top of the JSONL files.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping


def encode_run_name(prefix: str, hparams: Mapping[str, Any] | None) -> str:
    """Reference-style run name with hyperparams baked in
    (semantic_seg.py:1010-1024 builds e.g. ``runs/<arch>_<lr>_<...>``)."""
    parts = [prefix]
    for k in sorted(hparams or {}):
        v = hparams[k]
        if isinstance(v, float):
            v = f"{v:g}"
        parts.append(f"{k}={v}")
    return "_".join(parts)


class RunLogger:
    """Scalar metrics logger: one JSONL line per ``log`` call + TB scalars.

    ``log_dir/<run_name>/metrics.jsonl`` plus TB event files in the same
    directory.  Use as a context manager or call ``close()``.
    """

    def __init__(
        self,
        log_dir: str,
        run_name: str = "run",
        hparams: Mapping[str, Any] | None = None,
        tensorboard: bool = True,
    ):
        self.dir = os.path.join(log_dir, run_name) if run_name else log_dir
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None  # keep JSONL-only where tensorboard is absent
            if SummaryWriter is not None:
                self._tb = SummaryWriter(self.dir)
        if hparams:
            meta = {"event": "hparams", "time": time.time(), **dict(hparams)}
            self._jsonl.write(json.dumps(meta, default=str) + "\n")
            self._jsonl.flush()
            if self._tb is not None:
                self._tb.add_text("hparams", json.dumps(dict(hparams), default=str))

    def log(self, step: int, scalars: Mapping[str, Any] | None = None, **kw) -> dict:
        """Record scalars at ``step``.  Non-numeric values go to JSONL only."""
        record = {**(scalars or {}), **kw}
        line = {"step": int(step), **record}
        self._jsonl.write(json.dumps(line, default=str) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in record.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    self._tb.add_scalar(k, v, int(step))
        return line

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_run(run_dir: str) -> list[dict]:
    """Load a run's JSONL records (skipping the hparams event)."""
    path = os.path.join(run_dir, "metrics.jsonl")
    out = []
    with open(path) as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            rec = json.loads(raw)
            if rec.get("event") == "hparams":
                continue
            out.append(rec)
    return out


def compare_runs(
    run_dirs: list[str], metric: str, mode: str = "max"
) -> list[dict]:
    """Best-value comparison across runs for ``metric``; returns rows sorted
    best-first: ``{run, best, step, last}``."""
    rows = []
    for d in run_dirs:
        recs = [r for r in read_run(d) if metric in r]
        if not recs:
            rows.append({"run": d, "best": None, "step": None, "last": None})
            continue
        pick = max if mode == "max" else min
        best = pick(recs, key=lambda r: r[metric])
        rows.append({
            "run": d,
            "best": best[metric],
            "step": best.get("step", best.get("epoch")),
            "last": recs[-1][metric],
        })
    rows.sort(
        key=lambda r: (r["best"] is None,
                       -r["best"] if mode == "max" and r["best"] is not None
                       else r["best"] if r["best"] is not None else 0)
    )
    return rows


def main(argv=None):
    """CLI: ``python -m tpuseg_torch.metrics.runlog <metric> <run_dir>...``"""
    import argparse

    p = argparse.ArgumentParser(description="Compare runs by a JSONL metric")
    p.add_argument("metric")
    p.add_argument("run_dirs", nargs="+")
    p.add_argument("--mode", choices=["max", "min"], default="max")
    args = p.parse_args(argv)
    for row in compare_runs(args.run_dirs, args.metric, args.mode):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
