"""Port parity for the served slice: tpuseg_torch.video.pipeline.VideoSegmenter
against tpuseg.video.pipeline.VideoSegmenter on the same frames and weights,
plus the CLI, the copied data modules and the no-JAX import rule."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuseg.data.cityscapes import CITYSCAPE_PALETTE as J_PALETTE
from tpuseg.data.shapes import shapes_video as j_shapes_video
from tpuseg.models.drnseg import init_drnseg as j_init
from tpuseg.video.pipeline import SyntheticFrames as JFrames
from tpuseg.video.pipeline import VideoSegmenter as JSegmenter
from tpuseg_torch.data.cityscapes import CITYSCAPE_PALETTE as T_PALETTE
from tpuseg_torch.data.shapes import shapes_video as t_shapes_video
from tpuseg_torch.models.drnseg import init_drnseg as t_init
from tpuseg_torch.ops.upsample import upsample_argmax
from tpuseg_torch.video.pipeline import SyntheticFrames as TFrames
from tpuseg_torch.video.pipeline import VideoSegmenter as TSegmenter

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN = [0.290, 0.328, 0.287]
STD = [0.183, 0.187, 0.184]
# port bf16 vs tpuseg bf16 ids at 64x128, seed 0, measured 0.993683 on the
# CPU (the two frameworks round bf16 at different points; see
# test_pipeline_bf16_agreement_with_jax)
BF16_AGREEMENT_MIN = 0.98


def _jax_ids(size, compute_dtype, n=4, seed=0):
    p, s, spec = j_init(0, "drn_d_22", 19)
    seg = JSegmenter(p, s, spec, MEAN, STD, compute_dtype=compute_dtype, batch=2)
    return seg.run(JFrames(n, size, seed=seed), need_color=False)["ids"]


def _port_run(size, compute_dtype, n=4, seed=0):
    p, s, spec = t_init(0, "drn_d_22", 19)
    seg = TSegmenter(p, s, spec, MEAN, STD, device="cpu",
                     compute_dtype=compute_dtype, batch=2)
    return seg.run(TFrames(n, size, seed=seed))


@pytest.mark.parametrize("size", [(64, 128), (60, 100)])
def test_pipeline_f32_matches_jax(size):
    """(64, 128) runs the polyphase frontend, (60, 100) the direct stem and
    the crop of the rounded-up feature grid."""
    ref = _jax_ids(size, None)
    upsample_argmax.launches = 0
    out = _port_run(size, torch.float32)
    assert upsample_argmax.launches == 0  # CPU tensors run the plain version
    ids = out["ids"]
    assert ids.shape == ref.shape == (4,) + size and ids.dtype == np.uint8
    agreement = float((ids == np.asarray(ref)).mean())
    assert agreement >= 0.999, agreement
    assert out["frames"] == 4 and out["fps"] > 0
    assert out["color"].shape == (4,) + size + (3,)
    np.testing.assert_array_equal(out["color"], T_PALETTE[ids])


def test_pipeline_bf16_agreement_with_jax():
    ref = np.asarray(_jax_ids((64, 128), jnp.bfloat16))
    ids = _port_run((64, 128), torch.bfloat16)["ids"]
    agreement = float((ids == ref).mean())
    print(f"bf16 ids agreement port vs tpuseg: {agreement:.6f}")
    assert agreement >= BF16_AGREEMENT_MIN, agreement


def test_pipeline_pads_last_batch_and_overlays():
    p, s, spec = t_init(0, "drn_d_22", 19)
    seg = TSegmenter(p, s, spec, MEAN, STD, device="cpu",
                     compute_dtype=torch.float32, batch=2, want_overlay=True)
    frames = list(TFrames(3, (32, 32), seed=1))
    out = seg.run(frames, max_frames=3)
    assert out["ids"].shape == (3, 32, 32)
    full = seg.run(frames + frames[-1:], need_color=False)["ids"]
    np.testing.assert_array_equal(out["ids"], full[:3])
    want = (np.stack(frames) // 2 + T_PALETTE[out["ids"]] // 2).astype(np.uint8)
    np.testing.assert_array_equal(out["color"], want)


def test_device_fps_refuses_cpu():
    p, s, spec = t_init(0, "drn_d_22", 19)
    seg = TSegmenter(p, s, spec, MEAN, STD, device="cpu", batch=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        seg.benchmark_device_fps((32, 32))


def test_shapes_and_palette_byte_equal():
    jf, jl = j_shapes_video(3, (40, 56), seed=2)
    tf, tl = t_shapes_video(3, (40, 56), seed=2)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tl, jl)
    assert T_PALETTE.dtype == J_PALETTE.dtype
    np.testing.assert_array_equal(T_PALETTE, J_PALETTE)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import tpuseg_torch, tpuseg_torch.video.pipeline, tpuseg_torch.cli.seg_video\n"
        "import tpuseg_torch.ops._build, tpuseg_torch.models\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpuseg'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_cli_runs_on_cpu(capsys):
    from tpuseg_torch.cli import seg_video

    seg_video.main(["--device", "cpu", "--video", "synthetic", "--size", "64x128",
                    "--frames", "4", "--batch", "2"])
    import json

    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["frames"] == 4 and line["size"] == "64x128"
    assert line["arch"] == "drn_d_22" and line["device"] == "cpu"
    assert set(line) >= {"frames", "seconds", "fps", "size", "arch"}


def test_cli_cuda_without_card_raises(monkeypatch):
    from tpuseg_torch.cli import seg_video

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        seg_video.main(["--video", "synthetic", "--size", "64x128", "--frames", "2"])


def test_chip_smoke_refuses_without_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without CUDA."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
