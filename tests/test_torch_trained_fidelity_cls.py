"""The port's trained-fidelity ``cls`` stage against ``tpuseg``'s on the CPU
at a tiny size (a 3-step teacher, 2 recovery steps, the full 1024-image
validation set).

The classification proxy's batches, the initial weights and the RBGP 50 %
masks on the same weights are held bit-equal.  The stage trains in bf16, as
``tpuseg``'s does, and the two frameworks round bf16 at different points:
each printed loss within rtol 0.02 of ``tpuseg``'s (measured 0.006 at most)
and each accuracy within 0.03 (measured 0.009 at most, near chance after so
few steps)."""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

import jax

import tpuseg.tools.trained_fidelity as jtool
import tpuseg_torch.tools.trained_fidelity as ttool
from tpuseg.data import shapes as jshapes
from tpuseg_torch.data import shapes as tshapes

torch.set_num_threads(2)

ARGS = ["--stage", "cls", "--cls-steps", "3", "--recover-steps", "2", "--eval-every", "1"]
LOSS_RTOL = 0.02
ACC_ATOL = 0.03


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _losses(text):
    return [(m.group(1), float(m.group(2)))
            for m in re.finditer(r"^(\w+ step \d+): loss=([\d.]+)", text, re.M)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cls")
    out = {}
    for name, main, extra in (("tpuseg", jtool.main, []), ("port", ttool.main,
                                                           ["--device", "cpu"])):
        d = str(root / name)
        text = _run(main, ARGS + extra + ["--out", d])
        with open(os.path.join(d, "report.json")) as fh:
            out[name] = (text, json.load(fh))
    return out


def test_cls_stage_matches_tpuseg(runs):
    j_text, j_rows = runs["tpuseg"]
    t_text, t_rows = runs["port"]
    assert [r["stage"] for r in t_rows] == ["cls"]
    j, t = j_rows[0], t_rows[0]
    assert set(t) == set(j) and t["arch"] == "cifar_resnet20"
    assert t["weights"] == j["weights"] == "trained-on-shapes-cls"
    for k in ("teacher_acc", "acc_at_mask_50pct", "retrain_plain_acc", "retrain_kd_acc"):
        assert abs(t[k] - j[k]) <= ACC_ATOL, (k, t[k], j[k])
    tl, jl = _losses(t_text), _losses(j_text)
    assert [s for s, _ in tl] == [s for s, _ in jl] and len(tl) == 7
    for (step, a), (_, b) in zip(tl, jl):
        assert a == pytest.approx(b, rel=LOSS_RTOL), step
    assert [ln for ln in t_text.splitlines() if ln.startswith("cls ")][0].startswith(
        "cls retrain_plain: ")


def test_cls_batches_and_masks_bit_equal():
    """The stage's streams (seed + 10 for training, seed + 11 for the
    validation set) and its masks from the same weights: bit for bit."""
    from tpuseg.cli.expander_batch import generate_rbgp_config as jgen
    from tpuseg.models.factory import create_model as jcreate
    from tpuseg.sparsity import create_masker as jmasker
    from tpuseg_torch.cli.expander_batch import generate_rbgp_config
    from tpuseg_torch.models.drn import jax_key
    from tpuseg_torch.models.factory import create_model
    from tpuseg_torch.models.weights import to_jax_params
    from tpuseg_torch.sparsity import create_masker

    for seed in (10, 11):
        a = tshapes.sample_cls_batch(np.random.default_rng(seed), 8)
        b = jshapes.sample_cls_batch(np.random.default_rng(seed), 8)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    tp, _, _, _ = create_model(jax_key(0), "cifar10", "cifar_resnet20")
    jp, _, _, _ = jcreate(jax.random.key(0), "cifar10", "cifar_resnet20")
    kw = dict(oblock=(16, 16), cblock=(8, 8), iblock=(1, 1), osp=0.0, isp=0.5)
    tcfg = generate_rbgp_config(tp, "cifar_resnet20", **kw)
    assert tcfg == jgen({k: np.asarray(v) for k, v in jp.items()}, "cifar_resnet20", **kw)
    tm = create_masker(tcfg, seed=0).generate_masks(tp, is_static=False)
    jm = jmasker(tcfg, seed=0).generate_masks(jp)
    back, _ = to_jax_params(tm, {})
    assert sorted(back) == sorted(jm) and len(back) == 20
    for k in jm:
        np.testing.assert_array_equal(back[k], np.asarray(jm[k]), err_msg=k)
