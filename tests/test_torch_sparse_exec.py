"""Port parity for pruned serving: masks, tpuseg_torch.models.sparse_exec
plan decisions, drn_forward and VideoSegmenter with sparse plans, and the
CLI's --pr-config-path path, against tpuseg on the same seed, config and
frames (the JAX side's Pallas kernel in interpret mode)."""

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
from tpuseg.models.drn import drn_forward as j_drn_forward
from tpuseg.models.drnseg import init_drnseg as j_init
from tpuseg.models.sparse_exec import build_sparse_plans as j_build
from tpuseg.ops.fold_bn import fold_bn as j_fold_bn
from tpuseg.sparsity import apply_masks as j_apply_masks
from tpuseg.sparsity import create_masker as j_create_masker
from tpuseg.video.pipeline import SyntheticFrames as JFrames
from tpuseg.video.pipeline import VideoSegmenter as JSegmenter
from tpuseg_torch.models.drn import drn_forward
from tpuseg_torch.models.drnseg import init_drnseg
from tpuseg_torch.models.sparse_exec import CompactSparse, build_sparse_plans
from tpuseg_torch.ops.fold_bn import fold_bn
from tpuseg_torch.ops.rbgp_matmul import RbgpPlan
from tpuseg_torch.ops.sparse_conv import FusedSparseConv, fused_sparse_conv_apply
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


def _hwio(t):
    return np.ascontiguousarray(t.numpy().transpose(2, 3, 1, 0))


@functools.cache
def _models(config):
    """(port masked params, state, spec, masks), (tpuseg the same): masks
    from masker seed 0 with is_static=True, as both CLIs make them.  Cached
    per config; no test changes what it gets."""
    tp, ts, tspec = init_drnseg(0, "drn_d_22", 19)
    tmasks = create_masker(config, seed=0).generate_masks(tp)
    jp, js, jspec = j_init(0, "drn_d_22", 19)
    jmasks = j_create_masker(config, seed=0).generate_masks(jp, is_static=True)
    return ((apply_masks(tp, tmasks), ts, tspec, tmasks),
            (dict(j_apply_masks(jp, jmasks)), js, jspec, jmasks))


@pytest.mark.parametrize("name", [
    "drn_d_22_block128reg_87.50.json",   # block_regular
    "drn_d_22_block128_75.00.json",      # block
    "drn_d_22_512X256_0.00_50.00.json",  # srmbrep
])
def test_masks_bit_equal(name):
    """The port's masks equal tpuseg's for the same config and seed, bit
    for bit after the HWIO -> OIHW transpose."""
    (tp, _, _, tmasks), (jp, _, _, jmasks) = _models(os.path.join(CONFIGS, name))
    assert list(tmasks) == list(jmasks)
    for k, m in tmasks.items():
        assert m.dtype == torch.float32
        np.testing.assert_array_equal(_hwio(m), jmasks[k])
        np.testing.assert_array_equal(_hwio(tp[k]), np.asarray(jp[k]))


@pytest.mark.parametrize("config", [REG, BLOCK], ids=["block128reg_87.50", "block128_75.00"])
def test_plan_reports_equal_jax(config):
    """build_sparse_plans at full DRN-D-22 width: the report dict equals
    tpuseg's key for key and string for string, and the same convs get the
    same plan kinds, for both lowerings."""
    (tp, ts, tspec, tmasks), (jp, js, jspec, jmasks) = _models(config)
    tfold, jfold = fold_bn(tp, ts, tspec), j_fold_bn(jp, js, jspec)
    for lowering in ("pallas", "gathered"):
        tplans, treport = build_sparse_plans(tfold, tmasks, tspec, lowering=lowering)
        jplans, jreport = j_build(jfold, jmasks, jspec, lowering=lowering)
        assert treport == jreport
        assert {k: type(v).__name__ for k, v in tplans.items()} == {
            k: type(v).__name__ for k, v in jplans.items()}
    if config == REG:
        # the pallas lowering of the served config: 7 convs run kernel B2
        tplans, _ = build_sparse_plans(tfold, tmasks, tspec, lowering="pallas")
        b2 = [k for k, v in tplans.items() if isinstance(v, (FusedSparseConv, CompactSparse))]
        assert len(tplans) == 10 and len(b2) == 7, sorted(tplans)


def test_drn_forward_with_plans_matches_jax():
    """drn_forward with Pallas-lowering f32 plans (block128_75.00: S=2
    supports, a 1x1 B2 plan, an all-dead plan, RBGP plans) on the CPU vs
    tpuseg's drn_forward with its plans, full width, 1x64x64 f32;
    rtol=atol=2e-3 as tests/test_sparse_exec.py holds tpuseg."""
    (tp, ts, tspec, tmasks), (jp, js, jspec, jmasks) = _models(BLOCK)
    tfold, jfold = fold_bn(tp, ts, tspec), j_fold_bn(jp, js, jspec)
    tplans, _ = build_sparse_plans(tfold, tmasks, tspec, dtype=torch.float32)
    jplans, _ = j_build(jfold, jmasks, jspec, dtype=jnp.float32)
    kinds = {type(v).__name__ for v in tplans.values()}
    assert {"FusedSparseConv", "RbgpPlan"} <= kinds, kinds
    assert any(isinstance(v, FusedSparseConv) and v.kernel == 1 for v in tplans.values())
    assert any(isinstance(v, FusedSparseConv) and v.block_density == 0 for v in tplans.values())
    assert any(isinstance(v, RbgpPlan) and v.kind == "grouped_conv" for v in tplans.values())
    x = np.random.default_rng(0).random((1, 64, 64, 3), dtype=np.float32)
    fused_sparse_conv_apply.launches = 0
    got = drn_forward(tfold, {}, torch.from_numpy(x), tspec, sparse_plans=tplans)
    assert fused_sparse_conv_apply.launches == 0
    want, _, _ = j_drn_forward(jfold, {}, jnp.asarray(x), jspec, train=False,
                               sparse_plans=jplans)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)


def test_segmenter_with_plans_matches_jax():
    """VideoSegmenter(exec_plans=...) ids vs tpuseg's VideoSegmenter with
    its plans: block128reg_87.50, Pallas lowering, f32 plans, f32 serving,
    4 frames of 64x128; ids agreement >= 0.999."""
    (tp, ts, tspec, tmasks), (jp, js, jspec, jmasks) = _models(REG)
    tplans, _ = build_sparse_plans(fold_bn(tp, ts, tspec), tmasks, tspec, dtype=torch.float32)
    jplans, _ = j_build(j_fold_bn(jp, js, jspec), jmasks, jspec, dtype=jnp.float32)
    seg = TSegmenter(tp, ts, tspec, MEAN, STD, device="cpu", compute_dtype=torch.float32,
                     batch=2, exec_plans=tplans)
    ids = seg.run(TFrames(4, (64, 128), seed=0), need_color=False)["ids"]
    jseg = JSegmenter(jp, js, jspec, MEAN, STD, compute_dtype=None, batch=2,
                      exec_plans=jplans)
    ref = np.asarray(jseg.run(JFrames(4, (64, 128), seed=0), need_color=False)["ids"])
    assert ids.shape == ref.shape == (4, 64, 128)
    agreement = float((ids == ref).mean())
    assert agreement >= 0.999, agreement


@pytest.mark.parametrize("lowering,lowered", [("pallas", 10), ("gathered", 9)])
def test_cli_pruned_path(capsys, lowering, lowered):
    """--pr-config-path block128reg_87.50 on the CPU at 64x128 prints the
    sparse_plans event (15 masked convs) and then the result line."""
    from tpuseg_torch.cli import seg_video

    seg_video.main(["--device", "cpu", "--video", "synthetic", "--size", "64x128",
                    "--frames", "2", "--batch", "2", "--pr-config-path", REG,
                    "--sparse-lowering", lowering])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert lines[-2] == {"event": "sparse_plans", "lowered": lowered, "total_masked": 15,
                         "lowering": lowering, "gathered_mode": "exact"}
    assert lines[-1]["frames"] == 2 and lines[-1]["device"] == "cpu"


def test_cli_pruned_path_loads_no_jax():
    """The same pruned path in a fresh interpreter imports no jax, jaxlib or
    tpuseg module (its masks come from the port's own masker copy)."""
    code = (
        "import sys\n"
        "from tpuseg_torch.cli import seg_video\n"
        f"seg_video.main(['--device', 'cpu', '--video', 'synthetic', '--size', '32x64',"
        f" '--frames', '1', '--batch', '1', '--pr-config-path', {REG!r},"
        " '--sparse-lowering', 'pallas'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpuseg'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert '"event": "sparse_plans"' in proc.stdout
