"""The harness is driven by data: a configuration, a traffic mix and a
per-layer metric added as new files (and entries in BENCHMARK.json) are
found by name, with no file that exists edited; and BENCHMARK.json keeps to
the contract's shapes."""

import json
import re
import shutil
import time
from pathlib import Path

import pytest

from h100bench import harness

ROOT = Path(harness.__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("waiting", [False, True])
def test_benchmark_json_keeps_to_the_contract(waiting):
    """BENCHMARK.json, and BENCHMARK.json with the cells ``waiting.json``
    keeps for later added back."""
    spec = harness.bench_spec()
    if waiting:
        spec = harness.with_waiting(spec)
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["h100bench"]
    names = [c["name"] for c in spec["configs"]]
    cells = [w["name"] for w in spec["workloads"]]
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h100bench/") and (ROOT / c["file"]).is_file()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in names and len(w["why"]) <= 200
        assert (ROOT / "h100bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "h100bench" / "limits" / f"{w['name']}.json").is_file()
        reported = harness.metrics_of(spec, "end_to_end", w["name"])
        assert len(reported) >= 2 and harness.metrics_of(spec, "per_layer", w["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert 0.01 <= m.get("bound", 0.01) <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "h100bench" / "layer_metrics" / f"{m['name']}.py").is_file()
        for w in m["workloads"]:
            assert m["moves"] in [x["name"] for x in harness.metrics_of(spec, "end_to_end", w)]
    for n in names + cells:
        assert NAME.match(n)


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    (tmp_path / "h100bench").mkdir()
    for sub in ("configs", "traffic", "limits", "layer_metrics"):
        shutil.copytree(ROOT / "h100bench" / sub, tmp_path / "h100bench" / sub)
    spec = harness.bench_spec()
    before = {p: p.read_bytes() for p in (tmp_path / "h100bench").rglob("*") if p.is_file()}
    # new files only
    cfg = json.loads((ROOT / "h100bench/configs/drn_d_22.json").read_text())
    cfg.update(name="drn_d_38", arch="drn_d_38", layers=[1, 1, 3, 4, 6, 3, 1, 1])
    (tmp_path / "h100bench/configs/drn_d_38.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "h100bench/traffic/clips30.json").read_text())
    mix.update(batch=1, frames_per_call=8, warm_frames=1)
    (tmp_path / "h100bench/traffic/live1.json").write_text(json.dumps(mix))
    (tmp_path / "h100bench/limits/d38.live1.json").write_text(json.dumps({"gap": 1.0}))
    (tmp_path / "h100bench/layer_metrics/frames_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.counts['frames'])\n")
    spec["configs"].append({"name": "drn_d_38", "source": "https://arxiv.org/abs/1705.09914",
                            "file": "h100bench/configs/drn_d_38.json", "reduced": [],
                            "why": "deeper"})
    spec["workloads"].append({"name": "d38.live1", "config": "drn_d_38", "traffic": "live1",
                              "chips": 1, "why": "batch 1"})
    next(m for m in spec["end_to_end"] if m["name"] == "fps")["workloads"].append("d38.live1")
    spec["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "x", "moves": "fps",
                              "workloads": ["d38.live1"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    for p, data in before.items():
        assert p.read_bytes() == data
    new = harness.bench_spec(tmp_path)
    cell = harness.cell_for(new, "d38.live1", 3, "cpu", root=tmp_path,
                            overrides={"config": {"frame": [64, 64]},
                                       "traffic": {"pool_frames": 4, "check_frames": 2}})
    assert cell.cfg["arch"] == "drn_d_38" and cell.traffic["batch"] == 1
    assert harness.driver(cell).__name__ == "h100bench.drivers.serve"
    reader = harness.layer_metric("frames_traced", tmp_path)
    assert reader.read(harness.Ctx(cell, None, 1.0, 0.5, {"frames": 8}, {})) == 8.0
    line = harness.run_cell(new, cell, 0.5, False, time.perf_counter())
    assert line["correct"] and set(line["metrics"]) == {"fps", "setup_s"}
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name", ["d22.clips30", "d22_b875_int8.clips30", "d22.video960",
                                  "d22.train512"])
def test_each_cell_runs_small_on_the_cpu(name):
    spec = harness.with_waiting(harness.bench_spec())
    over = ({"traffic": {"crop": [64, 64], "batch": 2, "ring": 4}} if "train" in name else
            {"config": {"frame": [64, 128]},
             "traffic": {"pool_frames": 8, "frames_per_call": 12, "warm_frames": 4, "batch": 4,
                         "check_frames": 3}})
    cell = harness.cell_for(spec, name, 2 ** 31 + 12345, "cpu", overrides=over)
    line = harness.run_cell(spec, cell, 0.3, False, time.perf_counter())
    assert line["attempted"] >= 1 and line["failed"] == 0
    want = {m["name"] for m in harness.metrics_of(spec, "end_to_end", name)}
    assert set(line["metrics"]) == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["device"]["platform"] == "cpu" and list(line)[-1] == "checks"
