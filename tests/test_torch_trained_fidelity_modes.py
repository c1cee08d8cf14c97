"""The port's trained-fidelity tool against ``tpuseg``'s on the modes the
CPU runs only when asked, on the CPU at a tiny size: the int8 modes forced
through ``--modes``, the warp modes at train size 128, and the compose
stage (its cached recovered checkpoint, its sparse plan count, the
composed int8 mode).

The shared checkpoint is the port's: its train stage (train size 32, batch
2, 2 steps) writes it and ``tpuseg`` loads it, as the compose stage's
recovered checkpoint (weights, masks, meta) written by the port.  The
recovery's --sparse-exec route runs in the port alone (``tpuseg``'s runs
Pallas in interpret mode); its eligible layers are counted against
``tpuseg``'s ``build_sparse_train_structs`` on the same masks."""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

import tpuseg.tools.trained_fidelity as jtool
import tpuseg_torch.tools.trained_fidelity as ttool

torch.set_num_threads(2)

ARGS = ["--train-size", "32", "--batch", "2", "--steps", "2", "--recover-steps", "2",
        "--eval-every", "2", "--target-miou", "200", "--video-frames", "4",
        "--serve-batch", "2"]
INT8 = ["--modes", "int8_dynamic,int8_stem_calib"]
WARP = ["--train-size", "128", "--modes", "temporal2_warp,budget_warp,budget_warp_nearest"]
# test_torch_trained_fidelity.py's tolerances: served from one checkpoint,
# GT mIoU (percent) and ids agreement measured at most 0.023 and 0.0018
# apart (the int8 modes 0.02 and 0.001)
GT_MIOU_ATOL = 0.25
AGREEMENT_ATOL = 0.01


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _rows(out):
    with open(os.path.join(out, "report.json")) as fh:
        return {r["stage"]: r for r in json.load(fh)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port trains and composes (recovering block128reg) in ``made``;
    then each package runs the int8 and warp fidelity modes and compose
    (twice: default, then --modes sparse_int8) from copies of the port's two
    checkpoints."""
    root = tmp_path_factory.mktemp("modes")
    made = root / "made"
    cpu = ["--device", "cpu"]
    made_text = _run(ttool.main, ["--stage", "train", "--out", str(made)] + ARGS + cpu)
    made_text += _run(ttool.main, ["--stage", "compose", "--out", str(made)] + ARGS + cpu)
    out = {"made": (made, made_text)}
    for pkg, tool, extra in (("tpuseg", jtool, []), ("port", ttool, cpu)):
        texts = {}
        for name, stage, flags in (("int8", "fidelity", INT8), ("warp", "fidelity", WARP),
                                   ("compose", "compose", []),
                                   ("compose_int8", "compose", ["--modes", "sparse_int8"])):
            d = root / pkg / name
            d.mkdir(parents=True)
            for f in ("drn_d_22_shapes.npz", "drn_d_22_shapes_block128reg.npz"):
                shutil.copy(made / f, d)
            texts[name] = (_run(tool.main, ["--stage", stage, "--out", str(d)] + ARGS + flags
                                + extra), _rows(d)[stage])
        out[pkg] = texts
    return out


def _close_modes(t, j, key):
    assert set(t) == set(j)
    for name in j:
        assert set(t[name]) == set(j[name]), name
        assert 0 <= t[name]["gt_miou"] <= 100
        assert abs(t[name]["gt_miou"] - j[name]["gt_miou"]) <= GT_MIOU_ATOL, name
        assert abs(t[name][key] - j[name][key]) <= AGREEMENT_ATOL, name


@pytest.mark.parametrize("name", ["int8", "warp"])
def test_forced_fidelity_modes(runs, name):
    """``--modes`` runs the int8 modes on the CPU (no skip line), and the
    warp modes at 128x256; exact runs beside them as the baseline."""
    (jtext, j), (ttext, t) = runs["tpuseg"][name], runs["port"][name]
    want = {"int8": {"exact", "int8_dynamic", "int8_stem_calib"},
            "warp": {"exact", "temporal2_warp", "budget_warp", "budget_warp_nearest"}}[name]
    assert set(t["modes"]) == want
    assert t["video"] == j["video"]
    assert t["video"]["size"] == ([128, 256] if name == "warp" else [32, 64])
    assert t["modes"]["exact"]["ids_agreement_vs_exact"] == 1.0
    _close_modes(t["modes"], j["modes"], "ids_agreement_vs_exact")
    for text in (jtext, ttext):
        assert "on the CPU backend" not in text
        assert ("skipping warp modes" in text) == (name == "int8")


def test_compose_stage(runs):
    """Both packages reuse the port's recovered checkpoint (the same printed
    reuse and plan-count lines: 9 of the 15 masked convs on the
    gathered-exact lowering) and serve the three CPU rows, then the forced
    sparse_int8 row merged into them; GT mIoU and agreement within the
    tolerances."""
    made, made_text = runs["made"]
    assert "compose-recover: keeping best weights" in made_text
    for name in ("compose", "compose_int8"):
        (jtext, j), (ttext, t) = runs["tpuseg"][name], runs["port"][name]
        for text in (jtext, ttext):
            assert "compose: reusing recovered checkpoint" in text
            assert "compose: 9/15 masked convs on the gathered-exact lowering" in text
            assert "compose-recover" not in text
        assert {k: v for k, v in t.items() if k != "modes"} == \
            {k: v for k, v in j.items() if k != "modes"}
        want = {"sparse_exact", "dense_exact"} | (
            {"sparse_int8"} if name == "compose_int8" else {"sparse_budget"})
        assert set(t["modes"]) == want
        assert t["modes"]["sparse_exact"]["ids_agreement_vs_sparse_exact"] == 1.0
        _close_modes(t["modes"], j["modes"], "ids_agreement_vs_sparse_exact")


def test_compose_reuses_its_cache(runs, tmp_path):
    """A second compose in the same out dir loads the cached recovered
    checkpoint and does not retrain (the file's mtime stays); tpuseg loads
    the port's recovered checkpoint with its masks and meta."""
    from tpuseg.train import load_checkpoint as j_load
    from tpuseg_torch.train import load_checkpoint as t_load

    made, _ = runs["made"]
    d = tmp_path / "again"
    shutil.copytree(made, d)
    ck = d / "drn_d_22_shapes_block128reg.npz"
    mtime = os.path.getmtime(ck)
    text = _run(ttool.main, ["--stage", "compose", "--out", str(d), "--device", "cpu"] + ARGS)
    assert os.path.getmtime(ck) == mtime and "compose-recover" not in text
    jp, _jb, jm, _o, jmeta = j_load(str(ck))
    tp, _tb, tm, _o, tmeta = t_load(str(ck))
    assert jmeta == tmeta and set(tmeta) == {"miou_recovered", "recover_steps"}
    assert set(jm) == set(tm) and len(tm) == 15
    from tpuseg_torch.models import to_jax_params

    hm, _ = to_jax_params(tm)
    for k in jm:
        np.testing.assert_array_equal(hm[k], np.asarray(jm[k]))
        # the recovered weights sit on their masks
        assert float(np.abs(np.asarray(jp[k]) * (1 - hm[k])).max()) == 0.0


def test_compress_sparse_exec(runs, tmp_path):
    """Recovery through the fused sparse train step: the eligible layers the
    port counts equal tpuseg's ``build_sparse_train_structs`` on the same
    masks, and the row says ``sparse_exec``."""
    from tpuseg.models.drnseg import build_drnseg_spec
    from tpuseg.ops.sparse_train import build_sparse_train_structs
    from tpuseg.sparsity import create_masker
    from tpuseg.train import load_checkpoint as j_load

    made, _ = runs["made"]
    d = tmp_path / "sx"
    d.mkdir()
    shutil.copy(made / "drn_d_22_shapes.npz", d)
    text = _run(ttool.main, ["--stage", "compress", "--variants", "block128reg_87.5",
                             "--sparse-exec", "--out", str(d), "--device", "cpu"] + ARGS)
    row = _rows(d)["compress"]["block128reg_87.5"]
    assert row["sparse_exec"] is True and 0 <= row["miou_recovered"] <= 100
    jp, *_ = j_load(str(d / "drn_d_22_shapes.npz"))
    cfg = ttool._config(ttool.parse_args([]), "block128reg_87.50")
    masks = create_masker(cfg, seed=0).generate_masks(jp)
    _structs, report = build_sparse_train_structs(masks, build_drnseg_spec("drn_d_22", 6))
    n = sum(1 for v in report.values() if v.startswith("sparse-train"))
    assert n == 10
    assert f"recover[block128reg_87.5]: sparse-exec on {n} eligible layers" in text
