"""Port parity for int8 serving: VideoSegmenter(quantize=True), dynamic and
calibrated, dense and pruned, and the CLI's --quantize/--calibrate, against
tpuseg's VideoSegmenter on the same seed, weights and frames (its Pallas
kernels in interpret mode)."""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpuseg.ops.sparse_conv as jsc
from tpuseg.models.drnseg import init_drnseg as j_init
from tpuseg.models.sparse_exec import build_sparse_plans as j_build_sparse
from tpuseg.ops.fold_bn import fold_bn as j_fold_bn
from tpuseg.sparsity import apply_masks as j_apply_masks
from tpuseg.sparsity import create_masker as j_create_masker
from tpuseg.video.pipeline import SyntheticFrames as JFrames
from tpuseg.video.pipeline import VideoSegmenter as JSegmenter
from tpuseg_torch.models.drnseg import init_drnseg
from tpuseg_torch.models.sparse_exec import build_sparse_plans
from tpuseg_torch.ops.fold_bn import fold_bn
from tpuseg_torch.ops.quant import QuantConv, ids_agreement
from tpuseg_torch.ops.sparse_conv import fused_sparse_conv_apply_q
from tpuseg_torch.sparsity import apply_masks, create_masker
from tpuseg_torch.video.pipeline import SyntheticFrames as TFrames
from tpuseg_torch.video.pipeline import VideoSegmenter as TSegmenter

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "optimal_configs", "drn_d_22")
REG = os.path.join(CONFIGS, "drn_d_22_block128reg_87.50.json")
BLOCK = os.path.join(CONFIGS, "drn_d_22_block128_75.00.json")
MEAN = [0.290, 0.328, 0.287]
STD = [0.183, 0.187, 0.184]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(jsc.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


@functools.cache
def _masked(config):
    """Port and tpuseg (params, state, spec, masks) with masks from masker
    seed 0, applied."""
    tp, ts, tspec = init_drnseg(0, "drn_d_22", 19)
    tmasks = create_masker(config, seed=0).generate_masks(tp)
    jp, js, jspec = j_init(0, "drn_d_22", 19)
    jmasks = j_create_masker(config, seed=0).generate_masks(jp, is_static=True)
    return ((apply_masks(tp, tmasks), ts, tspec, tmasks),
            (dict(j_apply_masks(jp, jmasks)), js, jspec, jmasks))


# Whole-slice ids agreement with tpuseg.  Two exact int8 paths fed float
# activations that differ in the last bit (the float convs around them sum
# in different orders) round a few x/scale quotients to different integers;
# each such step is a whole quantum, and it cascades through the int8 convs
# after it.  The port against itself with oneDNN on and off (the same
# algorithm, another summation order) agrees on 0.983-1.0 of the ids (drn_d_22,
# random seed-0 weights, 64x64 to 128x256, frame seeds 0-2), so 0.999 is
# out of reach for any two correct int8 paths on these weights.  Bit-equality
# of every int8 conv on the slice's activations is checked by
# tests/test_torch_quant.py::
# test_int8_convs_bit_equal_on_slice_activations.
INT8_AGREEMENT_MIN = 0.98


def _segment_both(quantize_kw, plans=None, size=(64, 64), n=2):
    """Port and tpuseg VideoSegmenter(quantize=True) ids on the same frames,
    f32 serving."""
    (tp, ts, tspec, tpl), (jp, js, jspec, jpl) = plans or (
        (*init_drnseg(0, "drn_d_22", 19), None), (*j_init(0, "drn_d_22", 19), None))
    tseg = TSegmenter(tp, ts, tspec, MEAN, STD, device="cpu", compute_dtype=torch.float32,
                      batch=2, exec_plans=tpl, quantize=True, **quantize_kw)
    fused_sparse_conv_apply_q.launches = 0
    ids = tseg.run(TFrames(n, size, seed=0), need_color=False)["ids"]
    assert fused_sparse_conv_apply_q.launches == 0  # CPU tensors run the plain versions
    jseg = JSegmenter(jp, js, jspec, MEAN, STD, compute_dtype=None, batch=2,
                      exec_plans=jpl, quantize=True, **quantize_kw)
    ref = np.asarray(jseg.run(JFrames(n, size, seed=0), warmup=False, need_color=False)["ids"])
    assert ids.shape == ref.shape == (n,) + size
    return ids, ref, tseg


def _pruned_plans(config):
    """Port and tpuseg (params, state, spec, f32 Pallas-lowering plans)."""
    (tp, ts, tspec, tmasks), (jp, js, jspec, jmasks) = _masked(config)
    tpl, _ = build_sparse_plans(fold_bn(tp, ts, tspec), tmasks, tspec, dtype=torch.float32)
    jpl, _ = j_build_sparse(j_fold_bn(jp, js, jspec), jmasks, jspec, dtype=jnp.float32)
    return (tp, ts, tspec, tpl), (jp, js, jspec, jpl)


def test_segmenter_int8_dense_matches_jax():
    """The whole dense int8 slice at 64x64 in f32: ids agreement with
    tpuseg's >= INT8_AGREEMENT_MIN (measured 0.99194; see above)."""
    ids, ref, tseg = _segment_both({})
    assert len(tseg.exec_plans) == 13
    assert all(isinstance(p, QuantConv) and p.x_scale is None for p in tseg.exec_plans.values())
    agreement = ids_agreement(ids, ref)
    print(f"int8 dense ids agreement port vs tpuseg: {agreement:.6f}")
    assert agreement >= INT8_AGREEMENT_MIN, agreement


def test_segmenter_int8_pruned_matches_jax():
    """block128_75.00 masks, Pallas-lowering f32 plans lifted to int8 with
    quantize=True, f32 serving at 64x64: ids agreement with tpuseg's >=
    INT8_AGREEMENT_MIN (measured 0.99902)."""
    ids, ref, tseg = _segment_both({}, _pruned_plans(BLOCK))
    kinds = {type(p).__name__ for p in tseg.exec_plans.values()}
    assert {"QuantConv", "FusedSparseConvQ"} <= kinds, kinds
    agreement = ids_agreement(ids, ref)
    print(f"int8 pruned ids agreement port vs tpuseg: {agreement:.6f}")
    assert agreement >= INT8_AGREEMENT_MIN, agreement


def test_segmenter_calibrated_static_scales():
    """calib_frames: every int8 plan carries a static scale, and its ids
    agree with tpuseg's calibrated segmenter >= INT8_AGREEMENT_MIN (36x36:
    the non-stem calibration and serving path)."""
    calib = list(TFrames(2, (36, 36), seed=5))
    ids, ref, tseg = _segment_both({"calib_frames": calib}, size=(36, 36))
    assert len(tseg.exec_plans) == 13
    assert all(p.x_scale is not None and p.packed.x_scale == p.x_scale
               for p in tseg.exec_plans.values())
    agreement = ids_agreement(ids, ref)
    print(f"int8 calibrated ids agreement port vs tpuseg: {agreement:.6f}")
    assert agreement >= INT8_AGREEMENT_MIN, agreement


def test_segmenter_int8_frames_independent():
    """A frame's int8 ids are the same alone (run() pads the batch of 2
    with a repeat of it) and beside a frame of larger range: scales are per
    frame, so padding frames and batch neighbours change nothing."""
    tp, ts, tspec = init_drnseg(0, "drn_d_22", 19)
    frames = list(TFrames(2, (64, 64), seed=9))
    frames[0] = (frames[0] // 4).astype(np.uint8)  # a whole-batch scale would follow frame 1
    seg = TSegmenter(tp, ts, tspec, MEAN, STD, device="cpu", compute_dtype=torch.float32,
                     batch=2, quantize=True)
    alone = seg.run(frames[:1], need_color=False)["ids"]
    both = seg.run(frames, need_color=False)["ids"]
    np.testing.assert_array_equal(alone[0], both[0])


@pytest.mark.parametrize("extra,kinds", [
    ([], {"QuantConv": 13}),
    (["--pr-config-path", REG, "--sparse-lowering", "pallas"],
     {"QuantConv": 4, "RbgpPlan": 3, "FusedSparseConvQ": 3, "CompactSparseQ": 4}),
])
def test_cli_quantize_calibrate(capsys, extra, kinds):
    """--quantize --calibrate 2 on the CPU at 64x128 prints the int8_plans
    event and then the result line."""
    from tpuseg_torch.cli import seg_video

    seg_video.main(["--device", "cpu", "--video", "synthetic", "--size", "64x128",
                    "--frames", "2", "--batch", "2", "--quantize", "--calibrate", "2", *extra])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert lines[-2] == {"event": "int8_plans", "kinds": kinds, "calibrated_frames": 2}
    assert lines[-1]["frames"] == 2 and lines[-1]["device"] == "cpu"


def test_cli_calibrate_needs_quantize():
    from tpuseg_torch.cli import seg_video

    with pytest.raises(SystemExit, match="--quantize"):
        seg_video.main(["--device", "cpu", "--video", "synthetic", "--size", "32x64",
                        "--frames", "1", "--calibrate", "1"])


def test_cli_int8_path_loads_no_jax():
    """The int8 CLI path (with calibration) in a fresh interpreter imports
    no jax, jaxlib or tpuseg module."""
    code = (
        "import sys\n"
        "from tpuseg_torch.cli import seg_video\n"
        "seg_video.main(['--device', 'cpu', '--video', 'synthetic', '--size', '32x64',"
        " '--frames', '1', '--batch', '1', '--quantize', '--calibrate', '1'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpuseg'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert '"event": "int8_plans"' in proc.stdout
