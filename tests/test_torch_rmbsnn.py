"""The classifier CLIs of the port against ``tpuseg``'s on the CPU:
``rmbsnn`` (training, KD, pruning, ``--resume`` both ways, ``--evaluate
--quantize``, ``--sparse-exec`` on a DRN arch), ``imagenet_train`` and
``expander_batch`` (``generate_rbgp_config``'s JSON, the sweep's commands,
``collect_results``), and a fresh interpreter that runs them and loads no
jax, jaxlib or tpuseg module.

``--dataset synthetic`` in f32: the result lines carry ``tpuseg``'s keys
and values, losses within rtol 1e-3 (f32 rounding over a few SGD steps
moves the 4th decimal) and accuracies within one sample of the 32 (a
near-tie may flip)."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYN = ["--dataset", "synthetic", "--synthetic-n", "32", "-b", "8"]
CLS_BLOCK = {"pruner_type": "block_regular", "configs": [{
    "layer_set": ["layer6.0.conv1.weight", "layer7.0.weight"],
    "sparsity": 0.875, "block_height": 128, "block_width": 128}]}
R20_RBGP = {"pruner_type": "block_regular", "configs": [{
    "layer_set": ["layer2.1.conv1.weight", "layer3.0.conv2.weight"],
    "sparsity": 0.5, "block_height": 8, "block_width": 8}]}


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    return buf.getvalue(), ret


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _no_seconds(line):
    return {k: v for k, v in line.items() if "seconds" not in k}


LOSS_RTOL = 1e-3
ACC_ATOL = 100 / 32 + 1e-9  # one sample of --synthetic-n 32


def _assert_lines_match(t_lines, j_lines):
    assert len(t_lines) == len(j_lines) > 0
    for t, j in zip(t_lines, j_lines):
        t, j = _no_seconds(t), _no_seconds(j)
        assert set(t) == set(j)
        for k, v in j.items():
            if "loss" in k:
                assert t[k] == pytest.approx(v, rel=LOSS_RTOL), k
            elif "acc" in k:
                assert abs(t[k] - v) <= ACC_ATOL, k
            elif k == "lr":  # tpuseg's schedule value is an f32 scalar
                assert t[k] == pytest.approx(v, rel=1e-6), k
            else:
                assert t[k] == v, k


def _both(argv_t, argv_j=None):
    from tpuseg.cli import rmbsnn as j
    from tpuseg_torch.cli import rmbsnn as t

    t_out, _ = _run(t.main, ["--device", "cpu"] + argv_t)
    # tpuseg on one device of the test's CPU mesh, as the port runs
    j_out, _ = _run(j.main, (argv_j if argv_j is not None else argv_t) + ["--mesh-devices", "1"])
    return t_out, j_out


def test_rmbsnn_train_and_evaluate_match_tpuseg(tmp_path):
    """Two epochs of cifar_resnet20 with a block-regular mask, then
    ``--evaluate --quantize`` from each package's checkpoint in the other
    package: the epoch lines and the evaluation line equal ``tpuseg``'s."""
    cfg = tmp_path / "r20.json"
    cfg.write_text(json.dumps(R20_RBGP))
    prune = ["--mc-pruning", "--pr-static", "--pr-config-path", str(cfg)]
    t_out, j_out = _both(SYN + ["--epochs", "2", "--save-dir", str(tmp_path / "t")] + prune,
                         SYN + ["--epochs", "2", "--save-dir", str(tmp_path / "j")] + prune)
    tl, jl = _json_lines(t_out), _json_lines(j_out)
    _assert_lines_match(tl, jl)
    assert len(tl) == 2
    # tpuseg's per-layer mask sparsity lines
    assert [ln for ln in t_out.splitlines() if "sparsity =" in ln] == \
        [ln for ln in j_out.splitlines() if "sparsity =" in ln]
    ev = ["--evaluate", "--quantize"]
    t_ev, j_ev = _both(SYN + ev + ["--resume", str(tmp_path / "j" / "checkpoint.npz")],
                       SYN + ev + ["--resume", str(tmp_path / "t" / "checkpoint.npz")])
    t_line, j_line = _json_lines(t_ev)[-1], _json_lines(j_ev)[-1]
    assert set(t_line) == set(j_line)
    assert t_line["int8_layers"] == j_line["int8_layers"] == 20
    # two exact int8 paths agree only to float rounding
    for k in ("acc1", "acc5", "int8_acc1", "int8_acc5"):
        assert abs(t_line[k] - j_line[k]) <= ACC_ATOL, k
    assert t_line["pred_agreement"] >= 0.9


def test_rmbsnn_kd_matches_tpuseg(tmp_path):
    """KD from ``--teacher-model`` (cifar_resnet56 written by the port's
    trainer, read by both packages) with ``--teacher-arch``, ``--remat``."""
    from tpuseg_torch.cli import rmbsnn as t

    _run(t.main, ["--device", "cpu"] + SYN + ["-a", "cifar_resnet32", "--epochs", "1",
                                              "--save-dir", str(tmp_path / "teacher")])
    kd = ["--teacher-model", str(tmp_path / "teacher" / "checkpoint.npz"), "--teacher-arch",
          "cifar_resnet32", "--kd-temperature", "2.0", "--remat", "--epochs", "1"]
    t_out, j_out = _both(SYN + kd + ["--save-dir", str(tmp_path / "t")],
                         SYN + kd + ["--save-dir", str(tmp_path / "j")])
    _assert_lines_match(_json_lines(t_out), _json_lines(j_out))


def test_rmbsnn_pth_base_model(tmp_path):
    """``--base-model x.pth`` (a torch state_dict with ``module.`` keys):
    the evaluation of its weights equals ``tpuseg``'s."""
    from tpuseg_torch.models.cifar import create_cifar_model

    params, state, _ = create_cifar_model(7, "cifar_resnet20", 10)
    path = str(tmp_path / "r20.pth")
    torch.save({"module." + k: v for k, v in {**params, **state}.items()}, path)
    t_out, j_out = _both(SYN + ["--evaluate", "--base-model", path])
    _assert_lines_match(_json_lines(t_out)[-1:], _json_lines(j_out)[-1:])


def test_rmbsnn_drn_sparse_exec(tmp_path):
    """``-a drn_d_22 --sparse-exec``: the report of ``tpuseg``'s (2
    eligible convs in classifier naming), finite epoch lines, a checkpoint
    with the masks that ``tpuseg`` resumes."""
    cfg = tmp_path / "blk.json"
    cfg.write_text(json.dumps(CLS_BLOCK))
    argv = ["--dataset", "synthetic", "--synthetic-n", "8", "-a", "drn_d_22", "-b", "4",
            "--epochs", "1", "--mc-pruning", "--pr-static", "--pr-config-path", str(cfg),
            "--sparse-exec"]
    t_out, j_out = _both(argv + ["--save-dir", str(tmp_path / "t")],
                         argv + ["--save-dir", str(tmp_path / "j")])
    t_rep = next(x["sparse_exec"] for x in _json_lines(t_out) if "sparse_exec" in x)
    j_rep = next(x["sparse_exec"] for x in _json_lines(j_out) if "sparse_exec" in x)
    assert t_rep == j_rep and sum(v.startswith("sparse-train") for v in t_rep.values()) == 2
    line = _json_lines(t_out)[-1]
    assert set(line) == set(_json_lines(j_out)[-1]) and np.isfinite(line["train_loss"])
    from tpuseg.train import load_checkpoint

    _, _, masks, _, meta = load_checkpoint(str(tmp_path / "t" / "checkpoint.npz"))
    assert sorted(masks) == ["layer6.0.conv1.weight", "layer7.0.weight"]
    assert meta["arch"] == "drn_d_22" and meta["epoch"] == 1


@pytest.mark.parametrize("argv,match", [
    (["--mesh-devices", "2"], "A21"), (["--num-processes", "2"], "A21"),
    (["--ckpt-format", "orbax"], "A21"),
    (["--sparse-exec", "--epochs", "1"], "DrnSpec"),
    (["-a", "drn_d_22", "--sparse-exec", "--epochs", "1"], "requires masks")])
def test_rmbsnn_refusals(argv, match, tmp_path):
    from tpuseg_torch.cli import rmbsnn as t

    with pytest.raises(SystemExit, match=match):
        t.main(["--device", "cpu", "--save-dir", str(tmp_path)] + SYN + argv)


def test_rmbsnn_device_defaults_to_cuda(tmp_path):
    from tpuseg_torch.cli import rmbsnn as t

    assert t.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t.main(SYN + ["--save-dir", str(tmp_path)])


def test_imagenet_train_matches_tpuseg(tmp_path):
    """One epoch of the vanilla trainer: the ProgressMeter lines' labels
    and counters, the epoch line (``lr * 0.1^(epoch // 30)``) and the
    evaluation of its checkpoint equal ``tpuseg``'s."""
    from tpuseg.cli import imagenet_train as j
    from tpuseg_torch.cli import imagenet_train as t

    argv = ["--dataset", "synthetic", "--synthetic-n", "32", "-b", "8", "-a", "cifar_resnet20",
            "--epochs", "1", "-p", "2"]
    t_out, t_line = _run(t.main, ["--device", "cpu"] + argv + ["--save-dir", str(tmp_path / "t")])
    j_out, _ = _run(j.main, argv + ["--save-dir", str(tmp_path / "j")])

    def skeleton(text):
        return [[f.split(" ")[0] for f in ln.split("\t")] for ln in text.splitlines()
                if "\t" in ln]

    assert skeleton(t_out) == skeleton(j_out) and len(skeleton(t_out)) == 4
    assert [ln for ln in t_out.splitlines() if ln.startswith(" * ")] == \
        [ln for ln in j_out.splitlines() if ln.startswith(" * ")]
    assert _json_lines(t_out) == [t_line]
    _assert_lines_match([t_line], _json_lines(j_out))
    assert t_line["lr"] == pytest.approx(0.1)
    ev = ["--evaluate", "--resume", str(tmp_path / "j" / "checkpoint.npz")]
    t_ev, _ = _run(t.main, ["--device", "cpu"] + argv + ev)
    j_ev, _ = _run(j.main, argv + ev)
    assert [ln for ln in t_ev.splitlines() if ln.startswith(" * ")] == \
        [ln for ln in j_ev.splitlines() if ln.startswith(" * ")]


@pytest.mark.parametrize("dataset,arch", [("cifar10", "cifar_resnet20"),
                                          ("cityscapes", "drn_d_22"),
                                          ("cifar10", "cifar_wrn_16_4")])
def test_generate_rbgp_config_matches_tpuseg(dataset, arch):
    import jax

    from tpuseg.cli.expander_batch import generate_rbgp_config as jgen
    from tpuseg.models.factory import create_model as jcreate
    from tpuseg_torch.cli.expander_batch import generate_rbgp_config, prunable_layers
    from tpuseg_torch.models.drn import jax_key
    from tpuseg_torch.models.factory import create_model

    jp, _, _, _ = jcreate(jax.random.key(0), dataset, arch)
    tp, _, _, _ = create_model(jax_key(0), dataset, arch)
    for ob, cb, ib, isp in (((64, 32), (32, 32), (2, 2), 0.5), ((16, 16), (8, 8), (1, 1), 0.75)):
        want = json.dumps(jgen(jp, arch, ob, cb, ib, 0.0, isp), indent=4)
        got = json.dumps(generate_rbgp_config(tp, arch, ob, cb, ib, 0.0, isp), indent=4)
        assert got == want
    assert "conv1.weight" not in prunable_layers(tp, arch)


def test_expander_batch_sweep_and_collect(tmp_path, capsys):
    """The sweep writes ``tpuseg``'s config files and prints the port's
    rmbsnn commands; ``--launch`` runs one; ``--collect`` reads its
    checkpoint's meta and the spectral gap of its masks as ``tpuseg``'s
    ``collect_results`` does."""
    from tpuseg.cli import expander_batch as j
    from tpuseg_torch.cli import expander_batch as t

    common = ["--arch", "cifar_resnet20", "--sparsities", "0.5", "--iblocks", "1x1",
              "--epochs", "1", "--batch-size", "8"]
    j.main(common + ["--out-dir", str(tmp_path / "j")])
    capsys.readouterr()
    cmds = t.main(common + ["--out-dir", str(tmp_path / "t"), "--launch", "--extra",
                            "--device cpu --dataset synthetic --synthetic-n 16"])
    assert len(cmds) == 1 and "-m tpuseg_torch.cli.rmbsnn" in cmds[0]
    name = "cifar_resnet20_isp0.5_ib1x1.json"
    assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
    capsys.readouterr()
    rows = t.main(["--collect", "--out-dir", str(tmp_path / "t")])
    assert rows == j.collect_results(str(tmp_path / "t"))
    assert rows[0]["experiment"] == "cifar_resnet20_isp0.5_ib1x1"
    assert rows[0]["mean_normalized_spectral_gap"] > 0


def test_cls_modules_load_no_jax(tmp_path):
    """Every module of the classifier arm in a fresh interpreter, and a
    one-epoch rmbsnn run with ``--evaluate --quantize`` after it: no jax,
    jaxlib or tpuseg module loaded."""
    code = (
        "import json, sys\n"
        "import tpuseg_torch.models.cifar, tpuseg_torch.models.factory\n"
        "import tpuseg_torch.models.torch_import, tpuseg_torch.data.classification\n"
        "import tpuseg_torch.data.recipes, tpuseg_torch.cli.rmbsnn\n"
        "import tpuseg_torch.cli.imagenet_train, tpuseg_torch.cli.expander_batch\n"
        "import tpuseg_torch.tools.spectral, tpuseg_torch.tools.remat_mem\n"
        "from tpuseg_torch.cli import rmbsnn\n"
        f"argv = ['--device', 'cpu', '--dataset', 'synthetic', '--synthetic-n', '16', '-b', '8',"
        f" '--save-dir', {str(tmp_path)!r}]\n"
        "rmbsnn.main(argv + ['--epochs', '1'])\n"
        f"rmbsnn.main(argv + ['--evaluate', '--quantize', '--resume', "
        f"{str(tmp_path / 'checkpoint.npz')!r}])\n"
        "print('@@loaded ' + json.dumps(sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('jax', 'jaxlib', 'tpuseg', 'PIL'))))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out, loaded = proc.stdout.split("@@loaded ")
    assert json.loads(loaded) == []
    assert _json_lines(out)[-1]["int8_layers"] == 20
