"""The port's trained-weights fidelity tool (``tpuseg_torch.tools.
trained_fidelity``) against ``tpuseg``'s, on the CPU at a tiny size.

Both packages run the train stage (DRN-D-22, train size 32, batch 2, 2
steps); then both run the fidelity, compress and budget_curve stages from
``tpuseg``'s checkpoint, which the port loads.  The helpers, the seeds and
the data streams are held bit-equal; the stages' numbers within stated
tolerances (the tool computes in bf16, and the two frameworks round bf16 at
different points); the train step in f32 within float tolerances.  The
int8 modes, the warp modes and the compose stage are in
``test_torch_trained_fidelity_modes.py``; the cls stage in
``test_torch_trained_fidelity_cls.py``."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import tpuseg.tools.trained_fidelity as jtool
import tpuseg_torch.tools.trained_fidelity as ttool
from tpuseg.data import shapes as jshapes
from tpuseg.models.drnseg import init_drnseg as j_init
from tpuseg_torch.data import shapes as tshapes
from tpuseg_torch.models import init_drnseg as t_init
from tpuseg_torch.models import jax_key, to_jax_params

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--train-size", "32", "--batch", "2", "--steps", "2", "--recover-steps", "2",
        "--eval-every", "2", "--target-miou", "200", "--video-frames", "4",
        "--serve-batch", "2"]
COMPRESS = ["--variants", "rbgp_50,block128reg_87.5"]
CURVE = ["--budget-ks", "1,2", "--speeds", "2.0"]
# bf16 tolerances between the packages.  Two bf16 train steps at lr 0.05
# from a random start are chaotic: the f32 trajectories agree to 1e-5
# (test_train_step_f32_matches), the bf16 ones measured 24.54 vs 25.65 in
# loss and 5.47 vs 6.65 val mIoU at step 2.
TRAIN_LOSS_RTOL = 0.1
TRAIN_MIOU_ATOL = 3.0
# Served from one checkpoint, the two packages' exact ids agree on >= 0.98
# of the pixels (the port's bf16 serving floor, test_torch_pipeline.py).  GT
# mIoU (in percent) and ids agreement per mode within these: measured at
# most 0.023 and 0.0018 apart (fidelity, compress at mask time,
# budget_curve; int8 modes 0.02 and 0.001)
GT_MIOU_ATOL = 0.25
AGREEMENT_ATOL = 0.01
EXACT_IDS_MIN = 0.98


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _rows(out):
    with open(os.path.join(out, "report.json")) as fh:
        return {r["stage"]: r for r in json.load(fh)}


def _recorder(monkeypatch, module, log):
    """Record every batch ``module.sample_batch`` draws."""
    orig = module.sample_batch

    def sample_batch(rng, batch, size):
        imgs, labs = orig(rng, batch, size)
        log.append((imgs.copy(), labs.copy()))
        return imgs, labs

    monkeypatch.setattr(module, "sample_batch", sample_batch)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's train stage in its own out dir (with the batches it
    drew), then the other stages in a second dir from a copy of tpuseg's
    checkpoint.  Returns {pkg: {"train": (rows, text, draws), "stages":
    (rows, text), "out": dir}} and the shared checkpoint's path."""
    root = tmp_path_factory.mktemp("fid")
    out = {}
    for pkg, tool, shp, extra in (("tpuseg", jtool, jshapes, []),
                                  ("port", ttool, tshapes, ["--device", "cpu"])):
        draws = []
        with pytest.MonkeyPatch.context() as mp:
            _recorder(mp, shp, draws)
            text = _run(tool.main, ["--stage", "train", "--out", str(root / pkg)] + ARGS + extra)
        out[pkg] = {"train": (_rows(root / pkg), text, draws)}
    shared = root / "tpuseg" / "drn_d_22_shapes.npz"
    for pkg, tool, extra in (("tpuseg", jtool, []), ("port", ttool, ["--device", "cpu"])):
        d = root / f"{pkg}_shared"
        d.mkdir()
        shutil.copy(shared, d)
        base = ["--out", str(d)] + ARGS + extra
        text = _run(tool.main, ["--stage", "fidelity"] + base)
        text += _run(tool.main, ["--stage", "compress"] + COMPRESS + base)
        text += _run(tool.main, ["--stage", "budget_curve"] + CURVE + base)
        out[pkg]["stages"] = (_rows(d), text)
        out[pkg]["out"] = d
    return out, str(shared)


@pytest.mark.parametrize("seed", [0, 3])
def test_initial_weights_bit_equal(seed):
    """The train stage's start: ``init_drnseg(jax_key(seed))`` draws
    ``tpuseg``'s ``init_drnseg(jax.random.key(seed))`` bit for bit.  At seed
    3 an int seed draws other weights (``default_rng(3)`` is not
    ``SeedSequence([0, 3])``; at seed 0 the two coincide)."""
    jp, js, _ = j_init(jax.random.key(seed), "drn_d_22", 6)
    tp, ts, _ = t_init(jax_key(seed), "drn_d_22", 6)
    hp, hs = to_jax_params(tp, ts)
    assert set(hp) == set(jp) and set(hs) == set(js)
    for k in jp:
        np.testing.assert_array_equal(hp[k], np.asarray(jp[k]), err_msg=k)
    for k in js:
        np.testing.assert_array_equal(hs[k], np.asarray(js[k]), err_msg=k)
    if seed:
        ip, _ = to_jax_params(t_init(seed, "drn_d_22", 6)[0])
        assert not np.array_equal(ip["seg.weight"], hp["seg.weight"])


def test_helpers_bit_equal():
    for a, b in zip(ttool._shapes_stats(), jtool._shapes_stats()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    imgs = np.random.default_rng(5).integers(0, 256, (3, 8, 12, 3), dtype=np.uint8)
    np.testing.assert_array_equal(ttool._normalize(imgs), jtool._normalize(imgs))
    for size in ((32, 32), (16, 24)):
        for a, b in zip(ttool._val_set(size), jtool._val_set(size)):
            np.testing.assert_array_equal(a, b)
    args = ttool.parse_args(["--train-size", "32", "--video-frames", "5", "--seed", "2"])
    for speed in (4.0, 1.0):
        got = ttool._video(args, speed)
        want = jshapes.shapes_video(5, (32, 64), seed=4, speed=speed)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    # the training stream (seed + 1) and the recovery stream (seed + 3)
    for seed in (1, 3):
        for a, b in zip(tshapes.sample_batch(np.random.default_rng(seed), 2, (32, 32)),
                        jshapes.sample_batch(np.random.default_rng(seed), 2, (32, 32))):
            np.testing.assert_array_equal(a, b)


def test_append_report_merges_and_replaces(tmp_path):
    """The same sequence of entries gives the same report and printed lines:
    rows keyed by (stage, arch), partial mode matrices merged, the rest
    replaced."""
    entries = [
        {"stage": "train", "arch": "drn_d_22", "val_miou": 1.0},
        {"stage": "fidelity", "arch": "drn_d_22", "modes": {"exact": {"gt_miou": 1.0}}},
        {"stage": "train", "arch": "drn_d_38", "val_miou": 2.0},
        {"stage": "fidelity", "arch": "drn_d_22", "video": {"frames": 4},
         "modes": {"yuv420": {"gt_miou": 2.0}, "exact": {"gt_miou": 3.0}}},
        {"stage": "train", "arch": "drn_d_22", "val_miou": 4.0},
        {"stage": "compress", "arch": "drn_d_22", "dense_miou": 5.0},
    ]
    reports = {}
    for name, fn in (("tpuseg", jtool._append_report), ("port", ttool._append_report)):
        out = str(tmp_path / name)
        text = "".join(_run(lambda _a, e=e, o=out: fn(o, e), []) for e in entries)
        with open(os.path.join(out, "report.json")) as fh:
            reports[name] = (fh.read(), text)
    assert reports["port"] == reports["tpuseg"]
    rows = json.loads(reports["port"][0])
    assert [(r["stage"], r["arch"]) for r in rows] == [
        ("train", "drn_d_38"), ("fidelity", "drn_d_22"), ("train", "drn_d_22"),
        ("compress", "drn_d_22")]
    assert rows[1]["modes"] == {"exact": {"gt_miou": 3.0}, "yuv420": {"gt_miou": 2.0}}


def _losses(text, prefix):
    out = {}
    for ln in text.splitlines():
        if ln.startswith(f"{prefix} step "):
            step = int(ln.split()[2].rstrip(":"))
            out[step] = float(ln.split("loss=")[1].split()[0])
    return out


def test_train_stage(runs):
    """The same report keys, curve steps and draws (the val set, then the
    training stream, bit for bit); losses and val mIoU within the bf16
    tolerances; the port's checkpoint loads in tpuseg with tpuseg's names,
    shapes and meta."""
    from tpuseg.train import load_checkpoint as j_load

    out, _ = runs
    (jrows, jtext, jdraws), (trows, ttext, tdraws) = out["tpuseg"]["train"], out["port"]["train"]
    j, t = jrows["train"], trows["train"]
    assert set(t) == set(j)
    assert t["steps_run"] == j["steps_run"] == 2
    assert [s for s, _ in t["curve"]] == [s for s, _ in j["curve"]] == [2]
    assert abs(t["val_miou"] - j["val_miou"]) <= TRAIN_MIOU_ATOL
    assert len(tdraws) == len(jdraws) == 3  # the val set, then 2 training batches
    for (ta, tl), (ja, jl) in zip(tdraws, jdraws):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tl, jl)
    jl, tl = _losses(jtext, "train"), _losses(ttext, "train")
    assert set(tl) == set(jl) == {2}
    np.testing.assert_allclose(tl[2], jl[2], rtol=TRAIN_LOSS_RTOL)
    jp, js, _m, _o, jmeta = j_load(t["checkpoint"])
    tp, ts, _spec, tmeta = ttool._load_trained(
        ttool.parse_args(["--out", os.path.dirname(t["checkpoint"])]))
    assert tmeta == jmeta == {"arch": "drn_d_22", "classes": 6, "world": "shapes",
                              "train_size": 32}
    hp, hs = to_jax_params(tp, ts)
    assert set(hp) == set(jp) and set(hs) == set(js)
    for k in jp:
        np.testing.assert_array_equal(hp[k], np.asarray(jp[k]), err_msg=k)


def _mious(text):
    return [float(ln.split("val_miou=")[1].split()[0]) for ln in text.splitlines()
            if "val_miou=" in ln]


def test_train_step_f32_matches(monkeypatch):
    """``_train_seg_model``'s trajectory in f32 (both packages' steps made
    f32): losses within rtol 1e-4 and val mIoU within 0.05 over two steps
    evaluated each."""
    import jax.numpy as jnp  # noqa: F401

    import tpuseg.train as jt
    import tpuseg_torch.train as tt

    for mod, f32 in ((jt, {"compute_dtype": None}), (tt, {"compute_dtype": torch.float32})):
        for name in ("make_seg_train_step", "make_eval_step"):
            orig = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _o=orig, _k=f32, **k: _o(*a, **_k, **k))
    kw = dict(steps=2, size=(32, 32), batch=2, lr=0.05, target_miou=None, eval_every=1,
              seed=1, log_prefix="f32")
    p, s, spec = j_init(jax.random.key(0), "drn_d_22", 6)
    jtext = _run(lambda _a: jtool._train_seg_model(p, s, spec, **kw), [])
    tp, ts, tspec = t_init(jax_key(0), "drn_d_22", 6)
    ttext = _run(lambda _a: ttool._train_seg_model(tp, ts, tspec, device=torch.device("cpu"),
                                                   **kw), [])
    jl, tl = _losses(jtext, "f32"), _losses(ttext, "f32")
    assert set(jl) == set(tl) == {1, 2}
    np.testing.assert_allclose([tl[1], tl[2]], [jl[1], jl[2]], rtol=1e-4)
    np.testing.assert_allclose(_mious(ttext), _mious(jtext), atol=0.05)


def _close_modes(t, j, key):
    assert set(t) == set(j)
    for name in j:
        assert set(t[name]) == set(j[name]), name
        assert abs(t[name]["gt_miou"] - j[name]["gt_miou"]) <= GT_MIOU_ATOL, name
        assert 0 <= t[name]["gt_miou"] <= 100
        if key in j[name]:
            assert abs(t[name][key] - j[name][key]) <= AGREEMENT_ATOL, name


def test_fidelity_stage(runs):
    """The CPU's mode matrix (int8 gated off, warp skipped at 32x64), the
    same video block (drift and threshold bit-equal: same frames) and the
    same printed skip lines; GT mIoU and agreement per mode within the
    tolerances."""
    out, _ = runs
    j, t = out["tpuseg"]["stages"][0]["fidelity"], out["port"]["stages"][0]["fidelity"]
    assert set(t) == set(j) and t["video"] == j["video"] and t["weights"] == j["weights"]
    assert t["modes"]["exact"]["ids_agreement_vs_exact"] == 1.0
    assert not any("int8" in m or "warp" in m for m in t["modes"])
    _close_modes(t["modes"], j["modes"], "ids_agreement_vs_exact")
    for text in (out["tpuseg"]["stages"][1], out["port"]["stages"][1]):
        assert "fidelity: skipping warp modes (frame 32x64 not a multiple of 128 per axis)" in text
        assert ("fidelity: skipping ['int8_dynamic', 'int8_calib', 'int8_stem_calib', "
                "'budget_int8'] on the CPU backend") in text


def test_exact_ids_agree(runs):
    """The exact mode's ids of both packages from the shared checkpoint, on
    the fidelity video: agreement >= EXACT_IDS_MIN."""
    from tpuseg.video.pipeline import VideoSegmenter as JSeg
    from tpuseg_torch.video.pipeline import VideoSegmenter as TSeg

    out, _ = runs
    args = ttool.parse_args(["--out", str(out["port"]["out"])] + ARGS)
    frames, _ = ttool._video(args, args.speed)
    mean, std = ttool._shapes_stats()
    tp, tb, tspec, _ = ttool._load_trained(args)
    jp, jb, jspec, _ = jtool._load_trained(args)
    tids = TSeg(tp, tb, tspec, mean, std, device="cpu", batch=2).run(
        list(frames), need_color=False)["ids"]
    jids = np.stack(JSeg(dict(jp), dict(jb), jspec, mean, std, batch=2).run(
        list(frames), need_color=False)["ids"])
    assert tids.shape == jids.shape == (4, 32, 64)
    assert float((tids == jids).mean()) >= EXACT_IDS_MIN


def test_compress_stage(runs):
    out, _ = runs
    j, t = out["tpuseg"]["stages"][0]["compress"], out["port"]["stages"][0]["compress"]
    assert set(t) == set(j) == {"stage", "arch", "weights", "dense_miou", "rbgp_50",
                                "block128reg_87.5"}
    assert abs(t["dense_miou"] - j["dense_miou"]) <= GT_MIOU_ATOL
    for v in ("rbgp_50", "block128reg_87.5"):
        assert set(t[v]) == set(j[v])
        assert abs(t[v]["miou_at_mask"] - j[v]["miou_at_mask"]) <= GT_MIOU_ATOL, v
        assert [s for s, _ in t[v]["recovery_curve"]] == [s for s, _ in j[v]["recovery_curve"]]
        assert 0 <= t[v]["miou_recovered"] <= 100


def test_unknown_variant_refused(runs):
    out, _ = runs
    with pytest.raises(SystemExit, match="unknown"):
        ttool.main(["--stage", "compress", "--variants", "nope", "--device", "cpu",
                    "--out", str(out["port"]["out"])] + ARGS)


def test_budget_curve_stage(runs):
    out, _ = runs
    j, t = out["tpuseg"]["stages"][0]["budget_curve"], out["port"]["stages"][0]["budget_curve"]
    assert set(t) == set(j) and t["video"] == j["video"]
    jc, tc = j["curves"]["speed=2.0"], t["curves"]["speed=2.0"]
    assert {k: v for k, v in tc.items() if k != "points"} == \
        {k: v for k, v in jc.items() if k != "points"}
    _close_modes(tc["points"], jc["points"], "ids_agreement_vs_exact")
    assert [p["max_refresh_fraction"] for p in tc["points"].values()] == [1.0, 0.5, 1.0]


def test_refusals(tmp_path):
    with pytest.raises(SystemExit, match="run --stage train first"):
        ttool.main(["--stage", "fidelity", "--device", "cpu", "--out", str(tmp_path / "empty")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ttool.main(["--stage", "train", "--out", str(tmp_path / "card")])


def test_stage_all_loads_no_jax(tmp_path):
    """``--stage all`` at a tiny size in a fresh interpreter: train,
    fidelity, compress, compose and cls rows, no skipped stage, and no jax,
    jaxlib or tpuseg module loaded."""
    code = (
        "import json, sys\n"
        "from tpuseg_torch.tools import trained_fidelity\n"
        f"trained_fidelity.main(['--device', 'cpu', '--stage', 'all', '--out', {str(tmp_path)!r},"
        " '--train-size', '16', '--batch', '2', '--steps', '1', '--recover-steps', '1',"
        " '--cls-steps', '1', '--eval-every', '1', '--video-frames', '2',"
        " '--serve-batch', '2'])\n"
        "print('@@loaded ' + json.dumps(sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('jax', 'jaxlib', 'tpuseg'))))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.split("@@loaded ")[1]) == []
    events = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith('{"event"')]
    assert events == []
    assert list(_rows(tmp_path)) == ["train", "fidelity", "compress", "compose", "cls"]
    cls = _rows(tmp_path)["cls"]
    assert set(cls) == {"stage", "arch", "weights", "teacher_acc", "acc_at_mask_50pct",
                        "retrain_plain_acc", "retrain_kd_acc"}
