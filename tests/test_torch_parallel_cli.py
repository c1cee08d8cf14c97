"""The port's trainer CLIs on several gloo ranks of the CPU
(``tpuseg/cli`` flags: ``--mesh-devices``, ``--num-processes`` with
``--coordinator``/``--process-id``), held to the one-rank run and to
``tpuseg``'s contracts (``tests/test_parallel_cli.py``):

- ``--mesh-devices 2`` gives the one-device run's params (one step: the
  global batch's step) and the same merged confusion matrix (val mIoU);
- two processes (``--num-processes 2``) stay in lockstep
  (``TPUSEG_SAVE_ALL_PROCS``: every replica bit-equal), rank 0 alone
  writes the npz, and its val mIoU is the one-process ``test`` of that
  checkpoint;
- ``rmbsnn --evaluate`` over 2 processes, or 2 local ranks of
  ``--mesh-devices 2``, covers the FULL val set: 13 samples in unequal
  shards give the one-process accuracies;
- the coordinator checks.

Each CLI runs in a fresh interpreter that cannot import TensorFlow
(TensorBoard, which the run log writes through, would load it), with a
timeout, and is killed on the way out, so a deadlocked collective fails
the test."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG = ["train", "--device", "cpu", "--synthetic", "8", "-s", "32", "--batch-size", "8",
       "--epochs", "1", "--dtype", "float32", "--eval-every", "1"]
CLS_EVAL = ["--device", "cpu", "--dataset", "synthetic", "--synthetic-n", "13",
            "--batch-size", "4", "--arch", "cifar_resnet20", "--evaluate"]


def _port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(module, argv, env=None):
    code = ("import sys; sys.modules['tensorflow'] = None\n"
            f"from tpuseg_torch.cli.{module} import main\n"
            "main(sys.argv[1:])\n")
    return subprocess.Popen([sys.executable, "-c", code, *argv], cwd=REPO,
                            env={**os.environ, **(env or {})}, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(procs, timeout=240):
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:  # never leak a deadlocked rank
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _epoch(out):
    return next(ln for ln in _lines(out) if "train_loss" in ln)


@pytest.fixture(scope="module")
def seg_runs(tmp_path_factory):
    """semantic_seg: one rank, --mesh-devices 2 (directory envelope), and
    two processes with every replica saved, all at once."""
    root = tmp_path_factory.mktemp("seg")
    port = _port()
    two = [*SEG, "--save-dir", str(root / "mp"), "--coordinator", f"localhost:{port}",
           "--num-processes", "2"]
    procs = [
        _start("semantic_seg", [*SEG, "--save-dir", str(root / "one"), "--mesh-devices", "1"]),
        _start("semantic_seg", [*SEG, "--save-dir", str(root / "md2"), "--mesh-devices", "2",
                                "--ckpt-format", "orbax"]),
        *(_start("semantic_seg", [*two, "--process-id", str(i)],
                 env={"TPUSEG_SAVE_ALL_PROCS": "1"}) for i in (0, 1)),
    ]
    outs = _finish(procs)
    return root, dict(zip(("one", "md2", "mp0", "mp1"), outs))


def test_mesh_devices_matches_one_rank(seg_runs):
    """--mesh-devices 2 == one device: every param and BN statistic after
    the step (``tpuseg``'s CLI tolerance, atol 1e-4), the mesh event, and
    the val mIoU of the merged confusion matrix."""
    from tpuseg_torch.train import load_checkpoint

    root, outs = seg_runs
    assert {"mesh": {"data": 2, "processes": 2, "local_batch": 4, "global_batch": 8}} in \
        _lines(outs["md2"])
    p1, s1, _, _, m1 = load_checkpoint(str(root / "one" / "checkpoint.npz"))
    p2, s2, _, _, m2 = load_checkpoint(str(root / "md2" / "checkpoint.orbax"))
    assert p1.keys() == p2.keys() and m1 == m2
    for k in p1:
        np.testing.assert_allclose(p2[k].numpy(), p1[k].numpy(), rtol=0, atol=1e-4, err_msg=k)
    for k in s1:
        np.testing.assert_allclose(s2[k].numpy(), s1[k].numpy(), rtol=0, atol=1e-4, err_msg=k)
    assert _epoch(outs["md2"])["val_miou"] == _epoch(outs["one"])["val_miou"]
    assert os.path.isdir(root / "md2" / "checkpoint_best.orbax")


def test_two_process_replicas_lockstep(seg_runs):
    from tpuseg_torch.train import load_checkpoint

    root, outs = seg_runs
    r0 = load_checkpoint(str(root / "mp" / "replica_proc0.npz"))
    r1 = load_checkpoint(str(root / "mp" / "replica_proc1.npz"))
    for a, b in zip(r0[:2], r1[:2]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)
    assert os.path.exists(root / "mp" / "checkpoint.npz")  # rank 0's
    assert not _lines(outs["mp1"])  # one result stream: rank 0's
    assert np.isfinite(_epoch(outs["mp0"])["val_miou"])


def test_merged_confusion_matches_one_process(seg_runs):
    """The two processes' merged confusion matrix (one int64 all-reduce of
    their shards' matrices) gives the val mIoU that one process's ``test``
    of the same checkpoint gives over the whole set."""
    root, outs = seg_runs
    out = _finish([_start("semantic_seg", [
        "test", "--device", "cpu", "--synthetic", "8", "-s", "32", "--batch-size", "8",
        "--dtype", "float32", "--pretrained", str(root / "mp" / "checkpoint.npz")])])[0]
    assert _lines(out)[-1]["miou"] == _epoch(outs["mp0"])["val_miou"]


def test_two_process_eval_covers_full_val_set():
    """13 val samples over 2 processes (shards of 7 and 6, padded and masked
    around the gather) give the one-process accuracies exactly, and so do
    the 2 local ranks that ``--mesh-devices 2 --evaluate`` starts."""
    port = _port()
    mp = [*CLS_EVAL, "--coordinator", f"localhost:{port}", "--num-processes", "2"]
    outs = _finish([_start("rmbsnn", CLS_EVAL),
                    *(_start("rmbsnn", [*mp, "--process-id", str(i)]) for i in (0, 1)),
                    _start("rmbsnn", [*CLS_EVAL, "--mesh-devices", "2"])])
    single, multi, local = _lines(outs[0])[-1], _lines(outs[1])[-1], _lines(outs[3])
    assert multi["acc1"] == single["acc1"] and multi["acc5"] == single["acc5"]
    assert not _lines(outs[2])
    assert {"mesh": {"data": 2, "processes": 2, "local_batch": 2, "global_batch": 4}} in local
    assert local[-1]["acc1"] == single["acc1"] and local[-1]["acc5"] == single["acc5"]


def test_rmbsnn_mesh_devices_trains(tmp_path):
    """rmbsnn --mesh-devices 2 (the reference's DDP trainer): one epoch, a
    mesh event, rank 0's npz."""
    out = _finish([_start("rmbsnn", [
        "--device", "cpu", "--dataset", "synthetic", "--synthetic-n", "32", "-b", "16",
        "-a", "cifar_resnet20", "--epochs", "1", "--mesh-devices", "2",
        "--save-dir", str(tmp_path)])])[0]
    assert {"mesh": {"data": 2, "processes": 2, "local_batch": 8, "global_batch": 16}} in \
        _lines(out)
    assert np.isfinite(_lines(out)[-1]["acc1"])
    assert os.path.exists(tmp_path / "checkpoint.npz")


@pytest.mark.parametrize("module", ["semantic_seg", "rmbsnn"])
def test_coordinator_flag_requires_process_id(module):
    import importlib

    main = importlib.import_module(f"tpuseg_torch.cli.{module}").main
    base = (["train", "--device", "cpu", "--synthetic", "4", "-s", "32"]
            if module == "semantic_seg" else ["--device", "cpu", "--dataset", "synthetic"])
    with pytest.raises(SystemExit, match="--coordinator"):
        main([*base, "--num-processes", "2", "--coordinator", "localhost:1234"])
    with pytest.raises(SystemExit, match="--coordinator"):
        main([*base, "--num-processes", "2"])
