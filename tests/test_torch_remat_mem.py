"""The port's ``tools/remat_mem`` on the CPU: the cases it measures are
``tpuseg``'s ``run_seg``, ``run_cls`` and ``run_kd`` (name, weights,
optimizer, batch shapes, the KD teacher), its lines carry ``tpuseg``'s case
names and keys, and it refuses what it cannot measure (any CPU device: it
reads the card's allocator).  The measurement itself runs on the card
(``chip_smoke.py`` phases 35 and 39)."""

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
    (["--cases", "seg", "--device", "cpu"], "CUDA caching allocator"),
    (["--cases", "nope"], "unknown"),
])
def test_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        trm.main(argv)


@pytest.mark.parametrize("case", ["cls", "kd"])
def test_cls_cases_are_tpusegs(monkeypatch, case):
    """The classifier cases are ``tpuseg``'s ``run_cls`` and ``run_kd``:
    case name, student weights, optimizer and batch, and for ``kd`` the
    teacher's weights (cifar_resnet56 from seed 1) and its bf16 logits."""
    seen = {}

    def report(name, make_step, ts, batch_args):
        seen.update(case=name, ts=ts, batch=batch_args, step=make_step)

    monkeypatch.setattr(jrm, "_report", report)
    {"cls": jrm.run_cls, "kd": jrm.run_kd}[case]()
    name, params, state, spec, tx, images, labels, t_arch = trm.cls_case(teacher=case == "kd")
    assert name == seen["case"] == {"cls": "cls_resnet56_b1024",
                                    "kd": "kd_resnet20_from_56_b1024"}[case]
    for got, want in zip((images, labels), seen["batch"]):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    hp, hs = to_jax_params(params, state)
    jp, js = seen["ts"].params, seen["ts"].bn_state
    assert set(hp) == set(jp) and set(hs) == set(js)
    for k in jp:
        np.testing.assert_array_equal(hp[k], np.asarray(jp[k]), err_msg=k)
    assert (tx.lr, tx.momentum, tx.weight_decay) == (0.1, 0.9, 1e-4)
    assert spec.arch == ("cifar_resnet20" if case == "kd" else "cifar_resnet56")
    if case == "kd":
        from tpuseg.models.cifar import create_cifar_model

        assert t_arch == "cifar_resnet56"
        t_fwd, tp, ts = trm._teacher(t_arch, torch.device("cpu"))
        jtp, _, _ = create_cifar_model(1, t_arch, 10)
        np.testing.assert_array_equal(to_jax_params(tp, {})[0]["fc.weight"],
                                      np.asarray(jtp["fc.weight"]))
        logits = t_fwd(tp, ts, torch.zeros((2, 32, 32, 3)))
        assert logits.shape == (2, 10) and logits.dtype == torch.bfloat16


def test_cls_cases_run(monkeypatch):
    """``--cases cls,kd`` runs the classifier cases in order, each building
    its train step for both remat settings (the measurement stubbed and the
    device resolved to the CPU: the allocator it reads is the card's)."""
    import tpuseg_torch.device as tdev

    seen = []

    def report(device, case, params, state, tx, images, labels, make_step):
        steps = [make_step(remat) for remat in (False, True)]
        seen.append((case, images.shape, all(callable(st) for st in steps)))
        return {"case": case}

    monkeypatch.setattr(trm, "_report", report)
    monkeypatch.setattr(tdev, "resolve_device", lambda name: torch.device("cpu"))
    out = trm.main(["--cases", "cls,kd"])
    assert [o["case"] for o in out] == ["cls_resnet56_b1024", "kd_resnet20_from_56_b1024"]
    assert seen == [("cls_resnet56_b1024", (1024, 32, 32, 3), True),
                    ("kd_resnet20_from_56_b1024", (1024, 32, 32, 3), True)]
