"""Runs one cell of ``BENCHMARK.json`` once and builds its result line.

Everything that belongs to a configuration, a traffic mix, a cell's limits
or a per-layer metric is a file of its own, found by the name
``BENCHMARK.json`` gives it:

- ``configs/<config>.json`` (the path in the configuration's ``file``);
- ``traffic/<mix>.json``, whose ``kind`` names the driver
  ``drivers/<kind>.py``;
- ``limits/<workload>.json``, the limits of the numbers that decide
  ``correct``, with the control that set them;
- ``layer_metrics/<metric>.py``, a reader ``read(ctx) -> float | None``.

``waiting.json`` holds the entries of cells kept for later, whose files are
here too (``with_waiting``).

A driver's ``setup(cell)`` builds the program's state from the seed and
warms up every shape the traffic uses; the runner it returns has
``window(seconds)``, ``burst()`` (the traced calls), ``free()`` and
``check()``.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuseg")


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict
    traffic: dict
    limits: dict
    seed: int
    device: torch.device
    root: Path = HERE.parent

    def seeds(self, n: int) -> list[int]:
        """``n`` independent seeds drawn from the run's seed."""
        return [int(s) for s in np.random.SeedSequence(self.seed).generate_state(n, np.uint64)
                % (2 ** 63)]


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def bench_spec(root: Path = HERE.parent) -> dict:
    return load_json(root / "BENCHMARK.json")


def with_waiting(spec: dict, root: Path = HERE.parent) -> dict:
    """``spec`` with the cells ``waiting.json`` keeps for later added: its
    configurations, cells and metrics, and its cells in the ``workloads``
    of the metrics they report (``reported_by``).  The tests and the
    control run those cells this way; a run of the benchmark does not."""
    wait = load_json(root / HERE.name / "waiting.json")
    out = copy.deepcopy(spec)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        out[key] += wait[key]
    for m in out["end_to_end"] + out["per_layer"]:
        if m["name"] in wait["reported_by"]:
            m["workloads"] = m["workloads"] + wait["reported_by"][m["name"]]
    return out


def workload(spec: dict, name: str) -> dict:
    for wl in spec["workloads"]:
        if wl["name"] == name:
            return wl
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_for(spec: dict, name: str, seed: int, device, root: Path = HERE.parent,
             overrides: dict | None = None) -> Cell:
    """The cell named ``name``: its configuration, traffic and limits files,
    ``overrides`` merged over the configuration and the traffic (tests run
    cells at small sizes on the CPU this way)."""
    wl = workload(spec, name)
    conf = next(c for c in spec["configs"] if c["name"] == wl["config"])
    bench = root / HERE.name
    cfg = load_json(root / conf["file"])
    traffic = load_json(bench / "traffic" / f"{wl['traffic']}.json")
    limits = load_json(bench / "limits" / f"{name}.json")
    for k, v in (overrides or {}).get("config", {}).items():
        cfg[k] = v
    for k, v in (overrides or {}).get("traffic", {}).items():
        traffic[k] = v
    return Cell(name, cfg, traffic, limits, int(seed), torch.device(device), root)


def driver(cell: Cell):
    return importlib.import_module(f"{__package__}.drivers.{cell.traffic['kind']}")


def layer_metric(name: str, root: Path = HERE.parent):
    """The reader module ``layer_metrics/<name>.py``."""
    path = root / HERE.name / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(spec: dict, key: str, name: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics cell ``name`` reports."""
    return [m for m in spec[key] if "workloads" not in m or name in m["workloads"]]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def verdict(failed: int, checks: dict) -> bool:
    """``correct``: no call failed, and every number compared lies within
    its limit."""
    return bool(failed == 0 and checks and all(c["value"] <= c["limit"] for c in checks.values()))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device: torch.device, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


@dataclasses.dataclass
class Ctx:
    """What a per-layer metric reads: the traced window's device trace, its
    wall time, its device busy time, the units the traced calls completed
    (``frames`` or ``steps``) and the cell's work model (``work``)."""

    cell: Cell
    trace: object
    window_s: float
    busy_s: float
    counts: dict
    work: dict


def run_cell(spec: dict, cell: Cell, seconds: float, traced: bool, t_start: float) -> dict:
    """One run: set-up, the window (or the traced burst), the peak memory,
    the program's state freed, the comparison with the reference.  Returns
    the result line's object (``checks`` last)."""
    runner = driver(cell).setup(cell)
    setup_s = time.perf_counter() - t_start
    line: dict = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    breakdown = None
    if traced:
        from h100bench.trace import device_trace

        runner.lead()
        with device_trace() as box:
            t0 = time.perf_counter()
            counts = runner.burst()
            sync(cell.device)
            window_s = time.perf_counter() - t0
        tr = box[0]
        busy = tr.busy_s()
        ctx = Ctx(cell, tr, window_s, busy, counts, runner.work())
        for m in metrics_of(spec, "per_layer", cell.name):
            v = layer_metric(m["name"], cell.root).read(ctx)
            if v is not None:
                line["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        line["attempted"], line["failed"] = counts["attempted"], counts["failed"]
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        extra = {"busy_s": busy, "window_s": window_s}
    else:
        res = runner.window(seconds)
        for m in metrics_of(spec, "end_to_end", cell.name):
            v = setup_s if m["name"] == "setup_s" else res["metrics"].get(m["name"])
            if v is not None:
                line["metrics"][m["name"]] = {"value": v, "unit": units[m["name"]]}
        line["attempted"], line["failed"] = res["attempted"], res["failed"]
        extra = {}
    peak = torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0
    runner.free()
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = runner.check()
    line["correct"] = verdict(line["failed"], checks)
    line["device"] = {**device_info(cell.device, peak), **extra}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line
