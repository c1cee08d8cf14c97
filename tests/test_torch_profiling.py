"""The port's profiling (``tpuseg_torch.metrics.profiling``): ``trace`` is
a no-op without a directory and writes a Chrome trace of the host's ops on
the CPU; ``cost_analysis`` counts 2MNK for a matmul (and a conv's
multiply-adds twice), as ``tpuseg``'s XLA count does; ``seg_video
--profile-dir`` writes a trace of its run."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuseg.metrics import profiling as jprof
from tpuseg_torch.metrics import profiling


def _events(logdir) -> list:
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as fh:
        return json.load(fh)["traceEvents"]


@pytest.mark.parametrize("logdir", [None, ""])
def test_trace_without_dir_is_a_noop(tmp_path, logdir, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiling.trace(logdir):
        y = torch.ones(4) * 2
    assert float(y.sum()) == 8.0 and os.listdir(tmp_path) == []


def test_trace_writes_cpu_ops(tmp_path):
    logdir = str(tmp_path / "prof")
    with profiling.trace(logdir):
        torch.mm(torch.ones(64, 32), torch.ones(32, 16))
    names = {e.get("name") for e in _events(logdir) if e.get("cat") == "cpu_op"}
    assert "aten::mm" in names


@pytest.mark.parametrize("m,k,n", [(8, 16, 4), (128, 256, 64), (3, 5, 7)])
def test_cost_analysis_matmul(m, k, n):
    rng = np.random.default_rng(m)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    got = profiling.cost_analysis(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    want = jprof.cost_analysis(jnp.matmul, jnp.asarray(a), jnp.asarray(b))
    assert got == {"flops": float(2 * m * n * k)}
    assert got["flops"] == want["flops"]


def test_cost_analysis_conv():
    """A 3x3 'same' conv: 2 * N*H*W * Cout * Cin*9 (products only)."""
    import torch.nn.functional as F

    x, w = torch.ones(2, 8, 10, 12), torch.ones(16, 8, 3, 3)
    got = profiling.cost_analysis(F.conv2d, x, w, padding=1)
    assert got["flops"] == 2 * 2 * 10 * 12 * 16 * 8 * 9


def test_seg_video_profile_dir(tmp_path, capsys):
    from tpuseg_torch.cli.seg_video import main

    logdir = str(tmp_path / "prof")
    line, _ = main(["--device", "cpu", "--video", "synthetic", "--size", "64x128",
                    "--frames", "4", "--batch", "2", "--profile-dir", logdir])
    assert line["frames"] == 4
    names = {e.get("name") for e in _events(logdir) if e.get("cat") == "cpu_op"}
    assert any(n.startswith("aten::conv") or n == "aten::cudnn_convolution"
               or n.startswith("aten::mkldnn") for n in names), sorted(names)[:20]
