"""The port's sparse-conv bench (``python -m tpuseg_torch.bench_sparse``):
without a CUDA card it exits non-zero and prints no result line; its modes'
control flow and JSON keys, run on the CPU at a small shape with the plain
versions and a stub timer."""

import json
import os
import subprocess
import sys

import pytest
import torch

from tpuseg_torch import bench_sparse

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("args", [[], ["--fused", "--gathered"]])
def test_bench_without_card_exits_nonzero(args):
    proc = subprocess.run([sys.executable, "-m", "tpuseg_torch.bench_sparse", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                               "OMP_NUM_THREADS": "2"})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA card" in proc.stderr


class _CpuBench(bench_sparse.Bench):
    """The bench on the CPU: each timed function runs once on x, its output
    checked for shape, dtype and finiteness; every time reads 1 ms."""

    def timeit(self, one_fn, x, reps=3):
        y = one_fn(x)
        assert y.shape == x.shape and torch.isfinite(y).all()
        return 1.0


def test_bench_modes_on_cpu(monkeypatch, capsys):
    for name, value in (("N", 1), ("H", 6), ("W", 10), ("C", 256)):
        monkeypatch.setattr(bench_sparse, name, value)
    b = _CpuBench(torch.device("cpu"), "cpu stub")
    bench_sparse.bench_main(b)
    bench_sparse.bench_fused(b)
    bench_sparse.bench_gathered(b)
    rows = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert all(r["card"] == "cpu stub" for r in rows)
    metrics = [r["metric"] for r in rows]
    assert metrics == (
        ["dense_conv3x3_ms", "dense_conv1x1_ms"]
        + [f"sparse_conv1x1_{p}pct" for p in ("50.0", "75.0", "87.5")]
        + [f"sparse_conv_{p}pct" for p in ("50.0", "75.0", "87.5")]
        + ["fused/dense_conv3x3_ms"]
        + [f"fused_sparse_conv_{p}pct" for p in ("50.0", "75.0", "87.5")]
        + ["phase_kernel_density_1.0", "gathered/dense_conv3x3_ms"]
        + [f"gathered_{p}pct" for p in ("50.0", "75.0", "87.5")])
    fused = rows[9]
    for key in ("ms", "int8_ms", "shared_ms", "phase_ms", "fphase_ms", "imcol_ms",
                "cphase_ms", "sconcat_ms"):
        assert fused[key] == 1.0
        assert fused["speedup_vs_dense" if key == "ms"
                     else key[:-3] + "_speedup_vs_dense"] == 1.0
    assert 0 < fused["block_density"] <= fused["phase_union_density"] <= 1
    assert set(rows[-1]) >= {"split_ms", "exact_ms", "grouped_ms", "fused_pallas_ms",
                             "fused_pallas_speedup", "block_density"}
