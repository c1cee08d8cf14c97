"""Video files in the port: ``FrameSource`` (the native decoder built by the
port, cv2, imageio) bit-equal to ``tpuseg``'s on the same file, and
``seg_video --video <file> --pretrained <npz>`` against ``tpuseg``'s CLI on
the same file and checkpoint, on the CPU.

The file is a 6-frame 128x256 shapes video that cv2 writes as mp4v: lossy,
so the port's frames are compared with ``tpuseg``'s decode of the file, not
with the frames written."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpuseg.video.pipeline import FrameSource as JSource
from tpuseg_torch.video import FrameSource as TSource

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# port bf16 vs tpuseg bf16 ids: the floor of the port's other bf16 CLI and
# pipeline tests (test_torch_pipeline.py)
BF16_AGREEMENT_MIN = 0.98
CLI_CASES = {
    "device_resize": [],
    "host_resize": ["--host-resize"],
    "yuv420": ["--transport", "yuv420"],
}


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    from tpuseg_torch.data.shapes import shapes_video
    from tpuseg_torch.models import jax_key
    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.train import save_checkpoint

    root = tmp_path_factory.mktemp("video")
    path = str(root / "shapes.mp4")
    frames, _ = shapes_video(6, (128, 256), seed=3)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (256, 128))
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    params, state, _ = init_drnseg(jax_key(1), "drn_d_22", 6)
    ckpt = str(root / "drn_d_22_shapes.npz")
    save_checkpoint(ckpt, params, state, meta={"arch": "drn_d_22", "classes": 6})
    return path, ckpt


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("fmt", ["rgb", "i420"])
@pytest.mark.parametrize("size", [None, (64, 128)])
def test_frame_source_matches_tpuseg(video, native, fmt, size):
    path, _ = video
    if native:
        from tpuseg_torch.video.native_source import available

        if not available():
            pytest.skip("the native decoder cannot be built here (g++, libav or OpenCV "
                        "headers missing)")
    src = TSource(path, size, native=native, fmt=fmt)
    assert src.decoder is None
    got = list(src)
    assert src.decoder == ("native" if native else "cv2")
    want = list(JSource(path, size, native=native, fmt=fmt))
    h, w = size or (128, 256)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a.shape == ((h * 3 // 2, w) if fmt == "i420" else (h, w, 3))
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    # a second pass decodes the file again from its start
    np.testing.assert_array_equal(next(iter(src)), got[0])


def test_frame_source_cv2_i420_crops_to_packing_grid(video):
    path, _ = video
    got = list(TSource(path, (62, 101), native=False, fmt="i420"))
    want = list(JSource(path, (62, 101), native=False, fmt="i420"))
    assert got[0].shape == (90, 100)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _capture_run(monkeypatch, cls, log):
    orig = cls.run

    def run(self, frames, **kw):
        frames = list(frames)
        log["first_frame_shape"] = np.asarray(frames[0]).shape
        out = orig(self, frames, **kw)
        log["ids"] = np.asarray(out["ids"])
        return out

    monkeypatch.setattr(cls, "run", run)


def _lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _argv(path, ckpt, flags):
    return ["--video", path, "--size", "64x128", "--frames", "6", "--batch", "2",
            "--pretrained", ckpt, *flags]


@pytest.mark.parametrize("name", list(CLI_CASES))
def test_cli_file_pretrained_matches_tpuseg(video, monkeypatch, capsys, name):
    """The port's CLI serves the decoded file with the checkpoint's weights
    (6 classes: ids < 6) at the ids of ``tpuseg``'s CLI (>= the bf16
    floor), frames shipped at decode size and resized on the device, resized
    on the host, or decoded straight to I420 planes."""
    from tpuseg.cli import seg_video as jcli
    from tpuseg.video.pipeline import VideoSegmenter as JSeg
    from tpuseg_torch.cli import seg_video as tcli
    from tpuseg_torch.video.pipeline import VideoSegmenter as TSeg

    path, ckpt = video
    flags = CLI_CASES[name]
    got, want = {}, {}
    _capture_run(monkeypatch, TSeg, got)
    _capture_run(monkeypatch, JSeg, want)
    line, result = tcli.main(["--device", "cpu"] + _argv(path, ckpt, flags))
    t_lines = _lines(capsys.readouterr().out)
    jcli.main(_argv(path, ckpt, flags))
    j_lines = _lines(capsys.readouterr().out)
    assert t_lines[-1] == line
    # the ids_pack_auto event: --classes' 19 (5 bits) hold the checkpoint's 6
    assert t_lines[:-1] == j_lines[:-1] == [
        {"event": "ids_pack_auto", "bits": 5, "classes": 19}]
    assert set(line) == set(j_lines[-1]) | {"device"}
    assert line["frames"] == j_lines[-1]["frames"] == 6 and line["size"] == "64x128"
    np.testing.assert_array_equal(result["ids"], got["ids"])
    assert got["first_frame_shape"] == want["first_frame_shape"] == {
        "device_resize": (128, 256, 3), "host_resize": (64, 128, 3),
        "yuv420": (192, 256)}[name]
    assert got["ids"].shape == want["ids"].shape == (6, 64, 128)
    assert int(got["ids"].max()) < 6
    assert float((got["ids"] == want["ids"]).mean()) >= BF16_AGREEMENT_MIN
    if name == "device_resize":
        _, random = tcli.main(["--device", "cpu"] + _argv(path, ckpt, flags)[:-2])
        assert not np.array_equal(random["ids"], result["ids"])


def test_cli_refusals(video, tmp_path):
    from tpuseg_torch.cli import seg_video as tcli

    path, ckpt = video
    with pytest.raises(SystemExit, match="video file not found"):
        tcli.main(["--device", "cpu", "--video", str(tmp_path / "missing.mp4")])
    with pytest.raises(SystemExit, match="A20"):
        tcli.main(["--device", "cpu", "--video", path, "--pretrained",
                   str(tmp_path / "model.pth")])


def test_cli_file_loads_no_jax(video):
    """The CLI on a file with a checkpoint in a fresh interpreter: its
    result line, and no jax, jaxlib or tpuseg module loaded."""
    path, ckpt = video
    code = (
        "import json, sys\n"
        "from tpuseg_torch.cli import seg_video\n"
        f"seg_video.main({['--device', 'cpu'] + _argv(path, ckpt, [])!r})\n"
        "print('@@loaded ' + json.dumps(sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('jax', 'jaxlib', 'tpuseg'))))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out, loaded = proc.stdout.split("@@loaded ")
    assert json.loads(loaded) == []
    assert json.loads(out.strip().splitlines()[-1])["frames"] == 6
