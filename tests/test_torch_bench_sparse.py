"""The port's sparse-conv bench (``python -m tpuseg_torch.bench_sparse``):
without a CUDA card it exits non-zero and prints no result line, whatever
the flags; its modes' control flow, metric names and JSON keys, run on the
CPU at small shapes with the plain versions and a stub timer; and where a
mode computes a function ``tpuseg`` has, the two agree at a small size
(the train step's loss and gradient, the model's ids, the int8 frontend's
embedded conv, the conv1split gate)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpuseg_torch import bench_sparse

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("args", [
    [], ["--fused", "--gathered"], ["--fused-only"], ["--fused-appendix"], ["--rmcdb"],
    ["--layout"], ["--model"], ["--model", "--sweep"], ["--frontend"], ["--train"],
    ["--conv1split"], ["--trainer"]])
def test_bench_without_card_exits_nonzero(args):
    proc = subprocess.run([sys.executable, "-m", "tpuseg_torch.bench_sparse", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                               "OMP_NUM_THREADS": "2"})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA card" in proc.stderr


class _CpuBench(bench_sparse.Bench):
    """The bench on the CPU: each timed step runs once on its carry, a
    tensor result checked for shape, dtype and finiteness; every time reads
    1 ms."""

    def time_loop(self, step, carry, reps=3, inner=None):
        y = step(carry)
        if isinstance(carry, torch.Tensor):
            assert y.shape == carry.shape and y.dtype == carry.dtype
            assert torch.isfinite(y.float()).all()
        return 1.0


def test_bench_modes_on_cpu(monkeypatch, capsys):
    for name, value in (("N", 1), ("H", 6), ("W", 10), ("C", 256)):
        monkeypatch.setattr(bench_sparse, name, value)
    b = _CpuBench(torch.device("cpu"), "cpu stub")
    bench_sparse.bench_main(b)
    bench_sparse.bench_fused(b)
    bench_sparse.bench_gathered(b)
    rows = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert all(r["card"] == "cpu stub" for r in rows)
    metrics = [r["metric"] for r in rows]
    assert metrics == (
        ["dense_conv3x3_ms", "dense_conv1x1_ms"]
        + [f"sparse_conv1x1_{p}pct" for p in ("50.0", "75.0", "87.5")]
        + [f"sparse_conv_{p}pct" for p in ("50.0", "75.0", "87.5")]
        + ["fused/dense_conv3x3_ms"]
        + [f"fused_sparse_conv_{p}pct" for p in ("50.0", "75.0", "87.5")]
        + ["phase_kernel_density_1.0", "gathered/dense_conv3x3_ms"]
        + [f"gathered_{p}pct" for p in ("50.0", "75.0", "87.5")])
    fused = rows[9]
    for key in ("ms", "int8_ms", "shared_ms", "phase_ms", "fphase_ms", "imcol_ms",
                "cphase_ms", "sconcat_ms"):
        assert fused[key] == 1.0
        assert fused["speedup_vs_dense" if key == "ms"
                     else key[:-3] + "_speedup_vs_dense"] == 1.0
    assert 0 < fused["block_density"] <= fused["phase_union_density"] <= 1
    assert set(rows[-1]) >= {"split_ms", "exact_ms", "grouped_ms", "fused_pallas_ms",
                             "fused_pallas_speedup", "block_density"}


SMALL = {"N": 1, "H": 6, "W": 10, "C": 256, "RMCDB_P": 64, "MODEL_HW": (64, 128),
         "CONV1SPLIT_HW": (8, 16), "TRAINER_CROP": 64, "TRAINER_BATCH": 1}


@pytest.fixture
def small(monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setattr(bench_sparse, name, value)
    return _CpuBench(torch.device("cpu"), "cpu stub")


def _rows(capsys):
    rows = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert all(r.pop("card") == "cpu stub" for r in rows)
    return rows


def test_rmcdb_and_layout_modes(small, capsys):
    bench_sparse.bench_rmcdb(small)
    bench_sparse.bench_layout(small)
    rows = _rows(capsys)
    assert [r["metric"] for r in rows] == [
        "rmcdb/dense_matmul_ms", "rmcdb_roll_bh64_b8_c2", "rmcdb_roll_bh64_b16_c1",
        "rmcdb_roll_bh64_b4_c2", "rmcdb_roll_bh128_b16_c2", "layout/nhwc_nchw_roundtrip_ms",
        "layout/nhwc_nwhc_roundtrip_ms", "layout/copy_ms"]
    assert rows[0] == {"metric": "rmcdb/dense_matmul_ms", "value": 1.0}
    # count diagonals of bh/b: 2/8, 1/4, 2/16, 2/8 of each block
    assert [r["density"] for r in rows[1:5]] == [0.25, 0.25, 0.125, 0.25]
    assert all(set(r) == {"metric", "density", "ms", "speedup_vs_dense"} for r in rows[1:5])
    assert rows[5] == {"metric": "layout/nhwc_nchw_roundtrip_ms", "value": 1.0,
                       "one_way_ms": 0.5}
    x = torch.randn(1, 6, 10, 256)
    for perm in ((0, 3, 1, 2), (0, 2, 1, 3)):
        y = bench_sparse._roundtrip(perm)(x)
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()


def test_model_mode(small, capsys):
    plan_rows = bench_sparse.bench_model(small, sweep=True)
    rows = _rows(capsys)
    assert [name for name, _ in plan_rows] == [r["metric"] for r in rows]
    assert plan_rows[0][1] is None
    for r, (_, plans) in zip(rows[1:4] + rows[7:], plan_rows[1:4] + plan_rows[7:]):
        assert len(plans) == r["sparse_layers"]
    assert [r["metric"] for r in rows] == [
        "model_dense_fps", "model_sparse_87.5pct_fps", "model_gathered_87.5pct_fps",
        "model_gathered_exact_87.5pct_fps", "model_sparse_int8_87.5pct_fps",
        "model_gathered_int8_87.5pct_fps", "model_gathered_exact_int8_87.5pct_fps",
        "model_gathered_75.0pct_fps", "model_gathered_exact_75.0pct_fps",
        "model_gathered_50.0pct_fps", "model_gathered_exact_50.0pct_fps"]
    assert rows[0] == {"metric": "model_dense_fps", "value": 1000.0}
    for r in rows[1:4] + rows[7:]:
        assert set(r) == {"metric", "value", "sparse_layers", "speedup_vs_dense"}
        assert r["sparse_layers"] > 0
    for r in rows[4:7]:
        assert set(r) == {"metric", "value", "speedup_vs_dense"}


def test_model_masks_and_ids_match_tpuseg(monkeypatch):
    """The --model masks equal tpuseg's bench rule (BlockPruner on the
    folded weights, /128 convs of two blocks or more), and its ids, dense
    and under the 87.5 % Pallas plans, agree with tpuseg's drnseg_forward +
    upsample_argmax on a 64x128 frame in f32 (>= 0.999)."""
    import jax.experimental.pallas as pl
    import jax.numpy as jnp

    from tpuseg.models.drnseg import drnseg_forward, init_drnseg
    from tpuseg.models.sparse_exec import build_sparse_plans as jbuild
    from tpuseg.ops import sparse_conv as jsc
    from tpuseg.ops.fold_bn import fold_bn
    from tpuseg.ops.polyphase import FusedStage3Frontend
    from tpuseg.ops.upsample import upsample_argmax
    from tpuseg.sparsity import apply_masks as japply
    from tpuseg.sparsity.base import hwio_to_oihw, oihw_to_hwio
    from tpuseg.sparsity.block import BlockConfig, prune_as_block
    from tpuseg_torch.models.sparse_exec import build_sparse_plans
    from tpuseg_torch.sparsity import apply_masks

    orig = pl.pallas_call
    monkeypatch.setattr(jsc.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    m = bench_sparse.DrnModel(torch.device("cpu"), torch.float32)
    masks = m.block_masks(0.875)
    params, state, spec = init_drnseg(0, "drn_d_22", 19)
    jfold = fold_bn(params, state, spec)
    jmasks = {}
    for name, v in jfold.items():
        w = hwio_to_oihw(np.asarray(v))
        if w.ndim != 4 or name == "up.weight" or w.shape[0] % 128 or w.shape[1] % 128:
            continue
        if (w.shape[0] // 128) * (w.shape[1] // 128) < 2:
            continue
        jmasks[name] = oihw_to_hwio(prune_as_block(
            w, BlockConfig(0.875, 128, 128, -1, -1, collapse_tensor=False))).astype(np.float32)
    assert sorted(masks) == sorted(jmasks) and len(masks) > 10
    for k in masks:
        np.testing.assert_array_equal(masks[k].numpy().transpose(2, 3, 1, 0), jmasks[k])
    stem = FusedStage3Frontend(jfold, normalize=bench_sparse.NORMALIZE, dtype=jnp.float32)
    frames = np.random.default_rng(0).integers(0, 255, size=(1, 64, 128 * 3), dtype=np.uint8)
    tmasked = apply_masks(m.folded, masks)
    jmasked = dict(japply(jfold, jmasks))
    tplans, _ = build_sparse_plans(tmasked, masks, m.spec, dtype=torch.float32)
    jplans, _ = jbuild(jmasked, jmasks, spec, dtype=jnp.float32)
    assert len(tplans) == len(jplans) > 0
    for tparams, tp, jparams, jp in ((m.folded, None, jfold, None),
                                     (tmasked, tplans, jmasked, jplans)):
        ids = m.ids_fn(tparams, tp)(torch.from_numpy(frames)).numpy()
        _, seg, _ = drnseg_forward(jparams, {}, jnp.asarray(frames), spec, train=False,
                                   upsample=False, stem_fn=stem, stem_stages=4,
                                   sparse_plans=jp)
        want = np.asarray(upsample_argmax(seg, jparams["up.weight"]))
        assert ids.shape == want.shape == (1, 64, 128)
        assert float((ids == want).mean()) >= 0.999


def test_frontend_mode_and_embedded_int8_conv(small, capsys):
    """--frontend's rows, and stage 3's folded 2x2 conv1 (padding (1, 0),
    128 -> 64) through B3's narrow route's plan equal to tpuseg's bench
    arithmetic (an int8 XLA conv of the 2x2 kernel, y * (xs * ws)) on
    the CPU, bit for bit."""
    import jax
    import jax.numpy as jnp

    from tpuseg.ops.quant import quantize_weight as jquant

    bench_sparse.bench_frontend(small)
    rows = _rows(capsys)
    assert rows[0] == {"metric": "frontend/bf16_ms", "value": 1.0}
    assert rows[1:] == [{"metric": f"frontend/{n}_ms", "value": 1.0, "speedup_vs_bf16": 1.0}
                        for n in ("int8_stem", "int8_stem_stage3")]
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(64, 128, 2, 2)).astype(np.float32) * 0.05)
    x = rng.normal(size=(2, 8, 16, 128)).astype(np.float32)
    plan = bench_sparse._quant_conv_of("conv1", w, 1, 0)
    # B3's narrow packing: 128 input channels a step, one 64-wide out-block
    assert plan.packed.kernel == 3 and plan.packed.narrow
    assert (plan.packed.cin, plan.packed.cout, plan.packed.bk, plan.packed.bm) == (128, 64, 128, 64)
    got = plan.apply(torch.from_numpy(x)).numpy()
    wq, ws = jquant(w.numpy().transpose(2, 3, 1, 0))
    xs = np.float32(bench_sparse.FRONTEND_XS)
    xq = jnp.clip(jnp.round(jnp.asarray(x) / xs), -127, 127).astype(jnp.int8)
    acc = jax.lax.conv_general_dilated(
        xq, jnp.asarray(wq), (1, 1), [(1, 0), (1, 0)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    want = np.asarray(acc.astype(jnp.float32) * (xs * jnp.asarray(ws)))
    assert got.shape == want.shape == (2, 8, 16, 64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel,pad_lo,pad_hi,cin", [
    (2, 1, 0, 128), (2, 0, 1, 128), (2, 1, 0, 256), (1, 0, 0, 128), (3, 1, 1, 64)])
def test_embedded_kernel_walks_only_its_taps(kernel, pad_lo, pad_hi, cin):
    """An even or asymmetric kernel embedded in the odd "same" one
    (``embed_same``, as --frontend's stage-3 conv1 and the stem route's
    conv2 are) adds all-zero tiles, and B3's packing does not walk them:
    its live steps are the kernel's own taps over every input block (the
    64-channel case on a narrow packing, K = 64)."""
    from tpuseg_torch.models.weights import oihw_to_hwio_np
    from tpuseg_torch.ops.quant import quantize_weight, stem_packing

    rng = np.random.default_rng(kernel + cin)
    w = torch.from_numpy(rng.normal(size=(128, cin, kernel, kernel)).astype(np.float32))
    wq, ws = quantize_weight(oihw_to_hwio_np(w))
    packings = [bench_sparse._quant_conv_of("conv", w, pad_lo, pad_hi).packed,
                stem_packing("conv", wq, ws, pad_lo, pad_hi)]
    same = 2 * max(pad_lo, pad_hi) + 1
    off = max(pad_lo, pad_hi) - pad_lo
    own = [p * same + q for p in range(off, off + kernel) for q in range(off, off + kernel)]
    for packed in packings:
        assert packed.kernel == same
        s = packed.s
        want = [t * s + i for t in own for i in range(s)]
        assert packed.nsteps.tolist() == [len(want)] * (packed.cout // packed.bm)
        for j in range(packed.cout // packed.bm):
            assert packed.steps[j, :len(want)].tolist() == want


def test_train_mode_matches_tpuseg(small, capsys):
    """--train's row, and its sparse loss and gradient against tpuseg's
    sparse_conv_train on the same seeded problem in f32 (rtol 1e-4), and
    against the masked dense loss."""
    import jax
    import jax.numpy as jnp

    from tpuseg.ops.sparse_train import plan_sparse_conv_train, sparse_conv_train

    bench_sparse.bench_train(small)
    (row,) = _rows(capsys)
    assert set(row) == {"metric", "dense_ms", "sparse_ms", "speedup_vs_dense_masked",
                        "union_density"}
    assert row["metric"] == "train_step_sparse_87.5pct" and 0 < row["union_density"] < 1
    w0, x, tgt, mask = bench_sparse.train_problem(torch.device("cpu"))
    loss_dense, loss_sparse, _ = bench_sparse.train_losses(x, tgt, mask, torch.float32)
    results = {}
    for name, fn in (("dense", loss_dense), ("sparse", loss_sparse)):
        w = w0.clone().requires_grad_(True)
        loss = fn(w)
        (g,) = torch.autograd.grad(loss, [w])
        results[name] = (float(loss.detach()), g.numpy())
    st = plan_sparse_conv_train(mask.transpose(2, 3, 1, 0), dilation=bench_sparse.DIL)
    tgt_j = jnp.asarray(tgt.numpy())

    def jloss(w_hwio):
        y = sparse_conv_train(jnp.asarray(x.numpy()), w_hwio, st, compute_dtype=jnp.float32)
        return jnp.mean((y - tgt_j) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(w0.numpy().transpose(2, 3, 1, 0)))
    jg = np.asarray(jg).transpose(3, 2, 0, 1)
    loss, g = results["sparse"]
    np.testing.assert_allclose(loss, float(jl), rtol=1e-4)
    np.testing.assert_allclose(g, jg, rtol=1e-4, atol=1e-4 * np.abs(jg).max())
    np.testing.assert_allclose(loss, results["dense"][0], rtol=1e-4)
    np.testing.assert_allclose(g, results["dense"][1] * mask, rtol=1e-4,
                               atol=1e-4 * np.abs(g).max())
    assert np.all(g[mask == 0] == 0)


def test_conv1split_mode_and_gate(small, capsys):
    """--conv1split's rows; the gate passes on the real splits at a small
    grid and raises on a split whose channels are permuted wrongly."""
    bench_sparse.bench_conv1split(small)
    rows = _rows(capsys)
    assert [r["metric"] for r in rows] == [
        "conv1split/split1d_numerics_ok", "conv1split/split2d_numerics_ok", "conv1split_ms"]
    assert all(r["max_abs_err"] < 1e-2 for r in rows[:2])
    assert rows[2] == {"metric": "conv1split_ms", "dense": 1.0, "split1d": 1.0,
                       "split2d": 1.0, "speedup_1d": 1.0, "speedup_2d": 1.0}
    from tpuseg_torch.ops.polyphase import fold_conv_poly

    rng = np.random.default_rng(5)
    w16 = rng.normal(size=(3, 3, 16, 16)).astype(np.float32) * 0.1  # a 3x3 16->16 conv
    wp, lo, hi = fold_conv_poly(w16, 1, 1, 4, 4)  # ... on the f=4 grid, as conv1 is folded
    assert wp.shape == (3, 3, 256, 256) and (lo, hi) == (1, 1)
    cs = bench_sparse.Conv1Split(wp, torch.device("cpu"), torch.float32)
    x = torch.from_numpy(rng.normal(size=(1, 8, 12, 256)).astype(np.float32))
    y_ref = cs.dense(x)
    for name, (_, perm) in cs.splits.items():
        y = cs.split(name, x)
        assert bench_sparse.conv1split_gate(name, y, perm, y_ref) < 1e-4
        with pytest.raises(AssertionError, match=name):
            bench_sparse.conv1split_gate(name, y, np.roll(perm, 16), y_ref)


def test_trainer_mode(small, capsys):
    bench_sparse.bench_trainer(small)
    (row,) = _rows(capsys)
    assert row == {"metric": "trainer_step_sparse_exec_block128reg_87.5", "crop": 64,
                   "batch": 1, "dense_masked_ms": 1.0, "sparse_exec_ms": 1.0,
                   "speedup_vs_dense_masked": 1.0, "sparse_layers": 10}


@pytest.mark.parametrize("argv,modes", [
    ([], ["main"]), (["--fused"], ["main", "fused"]), (["--fused-only"], ["fused"]),
    (["--fused-appendix"], ["main", "fused"]), (["--gathered"], ["gathered"]),
    (["--model", "--sweep"], ["model"]),
    (["--rmcdb", "--layout", "--frontend", "--train", "--trainer", "--conv1split"],
     ["frontend", "rmcdb", "layout", "train", "trainer", "conv1split"])])
def test_main_dispatch(monkeypatch, argv, modes):
    """main runs unless one of bench_sparse.py's nine flags is given;
    --fused-appendix is an alias of --fused; the modes run in its order."""
    ran = []
    monkeypatch.setattr(bench_sparse.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench_sparse, "card_label", lambda: "stub")
    for mode in ("main", "fused", "gathered", "frontend", "rmcdb", "layout", "train",
                 "trainer", "conv1split"):
        monkeypatch.setattr(bench_sparse, f"bench_{mode}",
                            lambda b, m=mode: ran.append(m))
    monkeypatch.setattr(bench_sparse, "bench_model",
                        lambda b, sweep=False: ran.append("model" if sweep else "model1"))
    assert bench_sparse.main(argv) == 0
    assert ran == modes
