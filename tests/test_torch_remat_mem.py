"""The port's ``tools/remat_mem`` on the CPU: the case it measures is
``tpuseg``'s ``run_seg`` (name, weights, optimizer, batch shapes), its
lines carry ``tpuseg``'s case name and keys, and it refuses what it cannot
measure (the classifier cases, and any CPU device: it reads the card's
allocator).  The measurement itself runs on the card (``chip_smoke.py``
phase 35)."""

import json

import numpy as np
import pytest
import torch

import tpuseg.tools.remat_mem as jrm
import tpuseg_torch.tools.remat_mem as trm
from tpuseg_torch.models import to_jax_params


def test_seg_case_is_tpusegs(monkeypatch):
    seen = {}

    def report(case, make_step, ts, batch_args):
        seen.update(case=case, ts=ts, batch=batch_args, step=make_step)

    monkeypatch.setattr(jrm, "_report", report)
    jrm.run_seg()
    case, params, state, spec, tx, images, labels = trm.seg_case()
    assert case == seen["case"] == "seg_drn_d_22_768x768_b4"
    for got, want in zip((images, labels), seen["batch"]):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    hp, hs = to_jax_params(params, state)
    jp, js = seen["ts"].params, seen["ts"].bn_state
    assert set(hp) == set(jp) and set(hs) == set(js)
    for k in jp:
        np.testing.assert_array_equal(hp[k], np.asarray(jp[k]), err_msg=k)
    assert (tx.lr, tx.momentum, tx.weight_decay) == (0.01, 0.9, 1e-4)
    assert spec.arch == "drn_d_22"


def test_lines(monkeypatch, capsys):
    """One line per (case, remat) with temp_mb and arg_mb, then the
    temp_ratio line (the measurement stubbed: it needs the card)."""
    calls = []

    def measure(device, step, ts, batch):
        calls.append((step, [tuple(t.shape) for t in batch]))
        return {"temp_mb": 200.0 if len(calls) == 1 else 100.0, "arg_mb": 50.0}

    monkeypatch.setattr(trm, "_measure", measure)
    out = trm.run_seg(torch.device("cpu"))
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines == [
        {"case": "seg_drn_d_22_768x768_b4", "remat": False, "temp_mb": 200.0, "arg_mb": 50.0},
        {"case": "seg_drn_d_22_768x768_b4", "remat": True, "temp_mb": 100.0, "arg_mb": 50.0},
        {"case": "seg_drn_d_22_768x768_b4", "temp_ratio": 0.5},
    ]
    assert out["temp_ratio"] == 0.5
    assert [b for _, b in calls] == [[(4, 768, 768, 3), (4, 768, 768)]] * 2


def test_nbytes():
    ts = {"a": torch.zeros(3, 4),
          "b": (torch.zeros(2, dtype=torch.bfloat16), {"c": torch.zeros(5, dtype=torch.int32)})}
    assert trm._nbytes(ts) == 3 * 4 * 4 + 2 * 2 + 5 * 4


@pytest.mark.parametrize("argv, match", [
    (["--cases", "cls"], "A20"),
    (["--cases", "seg,kd"], "A20"),
    (["--cases", "seg", "--device", "cpu"], "CUDA caching allocator"),
    (["--cases", "nope"], "unknown"),
])
def test_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        trm.main(argv)
