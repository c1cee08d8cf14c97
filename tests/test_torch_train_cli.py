"""The port's trainer CLI (``python -m tpuseg_torch.cli.semantic_seg``)
against ``tpuseg``'s on the same arguments: ``train --synthetic 4 -s 64
--batch-size 2 --epochs 1 --dtype float32`` on the CPU, dense, masked
(block128reg_87.50, static masks) and with ``--sparse-exec``; the
``sparse_exec`` report; checkpoints read and resumed both ways; ``calc``'s
parameter count; the multi-rank and directory-envelope flags running; and, in the fresh
interpreter that runs the port, no ``jax``, ``jaxlib``, ``tpuseg`` or
``PIL`` module loaded on the ``--synthetic`` path."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REG = os.path.join(REPO, "optimal_configs", "drn_d_22", "drn_d_22_block128reg_87.50.json")
BASE = ["train", "--synthetic", "4", "-s", "64", "--batch-size", "2", "--epochs", "1",
        "--dtype", "float32"]
MASKED = ["--mc-pruning", "--pr-static", "--pr-config-path", REG]
CASES = {"dense": [], "masked": MASKED, "sparse_exec": MASKED + ["--sparse-exec"]}


def _lines(text):
    return [json.loads(ln) for ln in text.strip().splitlines() if ln.startswith("{")]


def _epoch(lines, epoch=0):
    return next(ln for ln in lines if ln.get("epoch") == epoch and "train_loss" in ln)


def _tpuseg_main(argv) -> list:
    from tpuseg.cli.semantic_seg import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return _lines(buf.getvalue())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """tpuseg's CLI in this process (dense, masked, calc), then
    the port's in one fresh interpreter (the same cases, a resume from
    tpuseg's dense checkpoint, calc), which lists the jax, jaxlib, tpuseg
    and PIL modules it loaded; last, tpuseg resumes the port's dense
    checkpoint.  That interpreter cannot import TensorFlow, as on the card's
    machine: TensorBoard, which the run log writes through where it
    imports, would otherwise load TensorFlow and with it PIL."""
    root = tmp_path_factory.mktemp("cli")
    jruns = {name: _tpuseg_main(BASE + flags + ["--mesh-devices", "1", "--save-dir",
                                                str(root / f"j_{name}")])
             for name, flags in CASES.items() if name != "sparse_exec"}
    jruns["calc"] = _tpuseg_main(["calc", "-s", "64"])
    argvs = {name: ["--device", "cpu", *BASE, *flags, "--save-dir", str(root / f"t_{name}")]
             for name, flags in CASES.items()}
    argvs["resume"] = ["--device", "cpu", *BASE[:-4], "--epochs", "2", "--dtype", "float32",
                       "--resume", str(root / "j_dense" / "checkpoint.npz"),
                       "--save-dir", str(root / "t_resume")]
    argvs["calc"] = ["calc", "--device", "cpu", "-s", "64"]
    code = (
        "import json, sys\n"
        "sys.modules['tensorflow'] = None\n"
        "import tpuseg_torch.train\n"
        "from tpuseg_torch.cli import semantic_seg\n"
        f"for name, argv in {argvs!r}.items():\n"
        "    print('@@' + name, flush=True)\n"
        "    semantic_seg.main(argv)\n"
        "print('@@loaded ' + json.dumps(sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('jax', 'jaxlib', 'tpuseg', 'PIL'))))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    parts = proc.stdout.split("@@")[1:]
    truns = {p.split("\n", 1)[0]: p.split("\n", 1)[1] for p in parts[:-1]}
    loaded = json.loads(parts[-1].split(" ", 1)[1])
    jruns["resume"] = _tpuseg_main(BASE[:-4] + ["--epochs", "2", "--dtype", "float32",
                                                "--mesh-devices", "1", "--resume",
                                                str(root / "t_dense" / "checkpoint.npz"),
                                                "--save-dir", str(root / "j_resume")])
    return jruns, truns, loaded, root


@pytest.mark.parametrize("name", list(CASES))
def test_train_matches_tpuseg_cli(runs, name):
    """The epoch line: the same keys, train_loss within rtol 1e-3 of
    tpuseg's (--sparse-exec against tpuseg's masked run: the same
    trajectory in other float orders); the same mask sparsity when
    masked."""
    jruns, truns, _, _ = runs
    want, text = _epoch(jruns["masked" if name == "sparse_exec" else name]), truns[name]
    got = _epoch(_lines(text))
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-3)
    assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
    if name != "dense":
        assert got["mean_weight_sparsity"] == want["mean_weight_sparsity"]
        assert [ln for ln in text.splitlines() if ln.startswith("mask sparsity:")]


def test_sparse_exec_report_matches_tpuseg(runs):
    """The port's printed report equals the one tpuseg's CLI prints: its
    build_sparse_train_structs on the masks its CLI makes."""
    from tpuseg.cli.semantic_seg import load_weights, make_masker, parse_args
    from tpuseg.ops.sparse_train import build_sparse_train_structs

    _, truns, _, _ = runs
    args = parse_args(BASE + CASES["sparse_exec"])
    params, _, spec = load_weights(args, args.classes)
    _, masks = make_masker(args, params)
    want = build_sparse_train_structs(masks, spec)[1]
    got = next(ln["sparse_exec"] for ln in _lines(truns["sparse_exec"]) if "sparse_exec" in ln)
    assert got == want
    assert sum(v.startswith("sparse-train") for v in got.values()) == 10


def test_checkpoints_read_both_ways(runs):
    """Each package's checkpoint loads in the other: the same keys, shapes
    and dtypes, params, BN state and masks within the train step's
    tolerance (the same step in other float orders) and the masks exactly;
    the optimizer state restores into the port's."""
    from tpuseg.train.checkpoint import load_checkpoint as j_load
    from tpuseg_torch.models.weights import from_jax_params
    from tpuseg_torch.train import create_train_state, make_sgd
    from tpuseg_torch.train.checkpoint import load_checkpoint, restore_opt_state

    root = runs[3]
    for name in ("dense", "masked"):
        j_path, t_path = (str(root / f"{p}_{name}" / "checkpoint.npz") for p in "jt")
        with np.load(j_path) as a, np.load(t_path) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        jp, js, jm, jopt, jmeta = j_load(j_path)
        tp, ts, tm, topt, tmeta = load_checkpoint(j_path)   # tpuseg's file, the port's reader
        assert jmeta == tmeta and tmeta["epoch"] == 1
        want_p, want_s = from_jax_params(jp, js)
        for k in want_p:
            assert torch.equal(tp[k], want_p[k]), k
        for k in want_s:
            assert torch.equal(ts[k], want_s[k]), k
        assert sorted(tm) == sorted(jm)
        for k, v in from_jax_params(jm)[0].items():
            assert torch.equal(tm[k], v), k
        # the port's file, tpuseg's reader
        jp2, js2, jm2, jopt2, _ = j_load(t_path)
        for k in jp:
            np.testing.assert_allclose(jp2[k], jp[k], rtol=2e-3, atol=5e-4, err_msg=k)
        for k in js:
            np.testing.assert_allclose(js2[k], js[k], rtol=2e-3, atol=5e-4, err_msg=k)
        for k in jm:
            assert np.array_equal(jm2[k], jm[k]), k
        # tpuseg's optimizer arrays restore into the port's state, trace for trace
        tx = make_sgd(lambda c: 0.01, 0.9, 1e-4)
        state = create_train_state(tp, ts, tx, tm or None)
        opt = restore_opt_state(state.opt_state, topt)
        trace = next(link["trace"] for link in opt if "trace" in link)
        want_trace = from_jax_params({k[len("1/.trace/"):]: v for k, v in jopt.items()
                                      if k.startswith("1/.trace/")})[0]
        assert sorted(trace) == sorted(want_trace)
        for k, v in want_trace.items():
            assert torch.equal(trace[k], v), k
        assert int(opt[-1]["count"]) == int(jopt["2/.count"]) == 2


def test_checkpoints_resume_both_ways(runs):
    """The port resumes tpuseg's dense checkpoint and tpuseg the port's:
    each runs epoch 1 only, and their losses agree within rtol 1e-3."""
    jruns, truns, _, _ = runs
    got, want = _lines(truns["resume"]), jruns["resume"]
    assert [ln["epoch"] for ln in got if "train_loss" in ln] == [1]
    assert [ln["epoch"] for ln in want if "train_loss" in ln] == [1]
    np.testing.assert_allclose(_epoch(got, 1)["train_loss"], _epoch(want, 1)["train_loss"],
                               rtol=1e-3)
    assert _epoch(got, 1)["lr"] == pytest.approx(_epoch(want, 1)["lr"], rel=1e-6)


def test_calc_params_match_tpuseg(runs):
    jruns, truns, _, _ = runs
    want, got = jruns["calc"][-1], _lines(truns["calc"])[-1]
    assert got["params"] == want["params"] and got["input"] == want["input"] == "64x64"
    assert got["flops"] > 0


def test_synthetic_path_loads_no_jax_or_pil(runs):
    assert runs[2] == []


def test_device_defaults_to_cuda():
    """Without --device the trainer asks for the card, and raises without
    one."""
    from tpuseg_torch.cli.semantic_seg import main, parse_args

    assert parse_args(BASE).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        main(BASE)


@pytest.mark.parametrize("flags,ckpt", [
    (["--mesh-devices", "2"], "checkpoint.npz"),
    (["--num-processes", "2"], "checkpoint.npz"),
    (["--ckpt-format", "orbax"], "checkpoint.orbax")])
def test_parallel_flags_run(flags, ckpt, tmp_path):
    """The flags an earlier slice refused now run: two gloo ranks
    (``--mesh-devices 2``, or two processes with ``--num-processes 2``
    and their coordinator) and the directory envelope; each run prints its
    epoch line and leaves its checkpoint.  Fresh interpreters that cannot
    import TensorFlow, each with a timeout."""
    import socket

    argv = BASE + ["--device", "cpu", "--save-dir", str(tmp_path)] + flags
    ids = [None]
    if "--num-processes" in flags:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            argv += ["--coordinator", f"localhost:{sock.getsockname()[1]}"]
        ids = [0, 1]
    code = ("import sys; sys.modules['tensorflow'] = None\n"
            "from tpuseg_torch.cli.semantic_seg import main\nmain(sys.argv[1:])\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, *argv,
                               *([] if i is None else ["--process-id", str(i)])],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for i in ids]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert np.isfinite(_epoch(_lines(outs[0]))["val_miou"])
    assert os.path.exists(tmp_path / ckpt)


def test_profile_dir_traces_first_epoch(tmp_path, capsys):
    """``--profile-dir`` (refused before it was ported) traces the first
    trained epoch into one Chrome trace; the second epoch is not traced."""
    import glob

    from tpuseg_torch.cli.semantic_seg import main

    logdir = tmp_path / "prof"
    main(["--device", "cpu", "train", "--synthetic", "4", "-s", "64", "--batch-size", "2",
          "--epochs", "2", "--eval-every", "2", "--dtype", "float32",
          "--save-dir", str(tmp_path / "run"), "--profile-dir", str(logdir)])
    lines = _lines(capsys.readouterr().out)
    assert _epoch(lines, 0) and _epoch(lines, 1)
    files = glob.glob(str(logdir / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "cpu_op"}
    assert "aten::convolution" in names


@pytest.mark.parametrize("flag", ["--pretrained", "--pretrained-backbone"])
def test_pretrained_pth_matches_tpuseg(tmp_path, flag):
    """``--pretrained x.pth`` and ``--pretrained-backbone <local .pth>``
    load the reference's torch checkpoints as ``tpuseg``'s ``load_weights``
    does: a DRNSeg ``.pth`` (``module.``/``base.`` keys, a (C, 1, 16, 16)
    ``up.weight``) or a DRN-D-22 classifier ``.pth`` whose backbone fills
    the seg model, the head kept at its init."""
    import argparse

    from tpuseg.cli import semantic_seg as jseg
    from tpuseg_torch.cli import semantic_seg as tseg
    from tpuseg_torch.models import to_jax_params
    from tpuseg_torch.models.drn import build_drn_spec, init_drn
    from tpuseg_torch.models.drnseg import init_drnseg

    if flag == "--pretrained":
        params, state, _ = init_drnseg(3, "drn_d_22", 19)
        sd = {("module.base." + k[len("layer."):] if k.startswith("layer.") else k): v
              for k, v in {**params, **state}.items()}
        sd["up.weight"] = params["up.weight"].expand(19, 1, 16, 16).clone()
        sd["module.base.0.1.num_batches_tracked"] = torch.tensor(7)
    else:
        spec = build_drn_spec("drn_d_22", num_classes=1000, naming="cls")
        params, state = init_drn(5, spec)
        sd = {**params, **state}
    path = str(tmp_path / "w.pth")
    torch.save({"state_dict": sd, "epoch": 3}, path)
    args = argparse.Namespace(seed=0, arch="drn_d_22", pretrained=None,
                              pretrained_backbone=None)
    setattr(args, flag[2:].replace("-", "_"), path)
    tp, ts, _ = tseg.load_weights(args, 19)
    jp, js, _ = jseg.load_weights(args, 19)
    bp, bs = to_jax_params(tp, ts)
    assert sorted(bp) == sorted(jp) and sorted(bs) == sorted(js)
    for k in jp:
        np.testing.assert_array_equal(bp[k], np.asarray(jp[k]), err_msg=k)
    for k in js:
        np.testing.assert_array_equal(bs[k], np.asarray(js[k]), err_msg=k)
    # the loaded tensors are the checkpoint's, not the seed's
    src = params["layer.5.0.conv1.weight" if flag == "--pretrained" else "layer5.0.conv1.weight"]
    assert torch.equal(tp["layer.5.0.conv1.weight"], src)
