"""The sparse-conv bench on one CUDA card (counterpart of the repo's
``bench_sparse.py``: every mode, the same metric names and keys, plus
``"card"``, the card's name and power limit).

The per-conv modes time one conv shaped like DRN-D-22's layer 6 (3x3,
512->512, dilation 2, at the stride-8 grid of one 1024x2048 frame: x (1,
128, 256, 512) bf16), with magnitude BlockPruner masks of 128x128 blocks at
50 / 75 / 87.5 % sparsity, weights and input drawn as ``bench_sparse.py``
draws them (numpy seed 0):

- ``main`` (run unless one of ``--fused-only``, ``--model``, ``--train``,
  ``--gathered``, ``--rmcdb``, ``--layout``, ``--frontend``, ``--trainer``,
  ``--conv1split`` is given): the dense conv (cuDNN), then the per-tap
  lowering ``sparse_conv_apply`` (kernel B4 once per tap), for a 1x1 conv
  and the 3x3 conv;
- ``--fused`` / ``--fused-only`` / ``--fused-appendix``: the dense conv, B2
  (``fused_sparse_conv_apply``), B3 (``fused_sparse_conv_apply_q``, static
  scale 0.05) and the six round-3 entry points (B7a-f) at each sparsity,
  then ``phase_sparse_conv_apply`` on an all-ones mask;
- ``--gathered``: the dense conv, the gathered lowering in its three modes
  and B2;
- ``--rmcdb``: the dense (P, 512) @ (512, 512) matmul against the RMCDB
  roll lowering (``ops/rmcdb_lowering.py``, PyTorch ops, as ``tpuseg``'s is
  XLA) at four cyclic-diagonal geometries, P = 32768;
- ``--layout``: the NHWC <-> NCHW and NHWC <-> NWHC round trips
  (``.contiguous()`` each way) and one full-tensor copy at layer 6's
  activation;
- ``--model [--sweep]``: DRN-D-22 end to end at 1024x2048, batch 1: flat
  uint8 frames, ``FusedStage3Frontend`` (``tpuseg``'s normalize
  constants), ``drnseg_logits`` with ``stem_stages=4`` (``tpuseg``'s
  ``drnseg_forward`` without its unused log-softmax) and B1
  (``upsample_argmax``); one probe byte of each frame's ids written into
  the next frame.  Rows: dense; at 87.5 % the Pallas lowering (B2), the
  gathered lowering split and exact, and the three int8 compositions (B3
  and its quantize pass); with ``--sweep`` the gathered rows at 75 and
  50 %.  Masks: BlockPruner 128x128 on the folded weights of every conv
  whose channels divide by 128 and that has two blocks or more;
- ``--frontend``: ``FusedStage3Frontend`` alone at 1024x2048: bf16, the
  int8 stem, and the int8 stem plus stage 3, at a fixed activation scale of
  0.05 (a timing harness: ``tpuseg``'s has no calibration either).  The
  three stem convs run as the port serves them, B3's stem route
  (``fused_sparse_conv_q_bias_relu``: relu(y + bias) in f32, then the
  cast; ``tpuseg``'s bench casts y before the bias).  The five 64-channel
  stage-3 convs run through ``ops/quant.py::quant_conv_apply`` on B3's
  narrow route (N = 64): block 0's folded 2x2 conv1 (128 -> 64, padding
  (1, 0), embedded in a 3x3 "same" kernel as the stem route embeds conv2)
  and folded 1x1 downsample (128 -> 64), and the three 3x3 64 -> 64 convs
  (K = 64); each y is cast to bf16, then the bias added, as in
  ``tpuseg``;
- ``--train``: one train step of the layer-6 conv at 87.5 %: MSE against a
  seeded target, w <- w - 1e-4 g, masked dense (cuDNN) against
  ``ops/sparse_train.py::sparse_conv_train`` (B2's forward, the wgrad on
  the support); the gradient is w's alone, as ``bench_sparse.py``'s
  ``jax.grad`` over w, so neither path runs a dgrad; ``tpuseg``'s
  ``rows_per_tile=8`` is a TPU knob, the port's tile rows come from
  ``b2_tile_rows``;
- ``--conv1split``: the folded stem conv1, (3, 3, 256, 256) on the
  256x512 grid, dense against its 1-D and 2-D phase splits (all through
  cuDNN), after a numerics gate that raises unless each split, permuted
  back, is within 0.02 * max|y| + 1e-3 of the dense conv;
- ``--trainer``: the whole segmentation train step at crop 512, batch 4,
  bf16, block128reg_87.50 masks (seed 0): masked dense against
  ``--sparse-exec`` (10 convs through B2), the train state carried step to
  step.

Timing follows ``bench_sparse.py``'s: the FULL output (cast to the input's
dtype) is the next call's input, so no call can be skipped or overlapped;
INNER calls between two CUDA events, best of 3 after one untimed loop; ms
per call.  ``bench_sparse.py``'s ``rows_per_tile`` and ``out_split``
sweeps were TPU tiling and are gone.  ``shared_ms`` (B7a) is the port's
addition, so every kernel of the module runs here.  Numbers are not
rounded.

    python -m tpuseg_torch.bench_sparse [--fused | --fused-only | --fused-appendix]
        [--gathered] [--rmcdb] [--layout] [--model [--sweep]] [--frontend]
        [--train] [--conv1split] [--trainer]

It runs on a CUDA card only: without one it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

N, H, W, C = 1, 128, 256, 512
K, DIL = 3, 2
INNER = 50
SPARSITIES = (0.5, 0.75, 0.875)
# the other modes' shapes and loop lengths (bench_sparse.py's)
RMCDB_P, RMCDB_ROWS, RMCDB_COLS, RMCDB_INNER = 128 * 256, 512, 512, 30
RMCDB_GEOMETRIES = ((64, 8, 2), (64, 16, 1), (64, 4, 2), (128, 16, 2))  # (bh, b, count)
ARCH, CLASSES = "drn_d_22", 19
NORMALIZE = ([0.290, 0.328, 0.287], [0.183, 0.187, 0.184])
MODEL_HW, MODEL_INNER = (1024, 2048), 32
FRONTEND_XS = 0.05  # the fixed activation scale of --frontend's int8 convs
TRAIN_INNER, TRAIN_LR = 30, 1e-4
CONV1SPLIT_HW, CONV1SPLIT_INNER = (256, 512), 32  # 1024x2048 on the f=4 grid
TRAINER_CROP, TRAINER_BATCH, TRAINER_INNER = 512, 4, 16
TRAINER_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "optimal_configs", "drn_d_22", "drn_d_22_block128reg_87.50.json")
# bench_sparse.py:1052-1058: main runs unless one of these is given
NOT_MAIN = ("fused_only", "model", "train", "gathered", "rmcdb", "layout", "frontend",
            "trainer", "conv1split")


def card_label() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class Bench:
    """One card, its label, and the problem ``bench_sparse.py`` draws."""

    def __init__(self, dev: torch.device, card: str):
        self.dev, self.card = dev, card

    def emit(self, **kw) -> None:
        print(json.dumps({**kw, "card": self.card}), flush=True)

    def problem(self):
        """(rng, OIHW f32 weight, bf16 x on the card): seed 0, drawn in
        ``bench_sparse.py``'s order (an HWIO weight, then x)."""
        rng = np.random.default_rng(0)
        w = rng.normal(size=(K, K, C, C)).astype(np.float32) * 0.05
        x = rng.normal(size=(N, H, W, C)).astype(np.float32)
        return rng, _oihw(w), torch.from_numpy(x).to(self.dev, torch.bfloat16)

    def time_loop(self, step, carry, reps: int = 3, inner: int | None = None) -> float:
        """ms per call of ``step``, each call taking the previous call's
        result: ``inner`` calls (INNER by default) between two CUDA events,
        best of ``reps`` after one untimed loop, each loop from ``carry``."""
        inner = INNER if inner is None else inner

        def loop():
            c = carry
            for _ in range(inner):
                c = step(c)
            return c

        loop()
        torch.cuda.synchronize(self.dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        best = float("inf")
        for _ in range(reps):
            start.record()
            loop()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / inner)
        return best

    def timeit(self, one_fn, x: torch.Tensor, inner: int | None = None) -> float:
        """ms per call of ``one_fn``, chained on its full output cast to
        x's dtype (``time_loop``)."""
        return self.time_loop(lambda xc: one_fn(xc).to(xc.dtype), x, inner=inner)

    def dense(self, w_oihw: np.ndarray, dilation: int):
        """The dense conv of NHWC x with the OIHW weight (cuDNN, bf16)."""
        wd = torch.from_numpy(w_oihw).to(self.dev, torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        pad = dilation * (w_oihw.shape[2] - 1) // 2
        return lambda xx: F.conv2d(xx.permute(0, 3, 1, 2), wd, None, 1, pad,
                                   dilation).permute(0, 2, 3, 1)


def _oihw(w_hwio: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))


def conv1x1_weight(rng: np.random.Generator) -> np.ndarray:
    """The main mode's 1x1 OIHW weight, drawn from ``problem``'s rng after x."""
    return _oihw(rng.normal(size=(1, 1, C, C)).astype(np.float32) * 0.05)


def block_mask(w_oihw: np.ndarray, sparsity: float) -> np.ndarray:
    """The bench's OIHW mask: magnitude BlockPruner over 128x128 blocks,
    not collapsed over the taps (``bench_sparse.py``'s config)."""
    from tpuseg_torch.sparsity.block import BlockConfig, prune_as_block

    return prune_as_block(w_oihw, BlockConfig(sparsity, 128, 128, -1, -1,
                                              collapse_tensor=False))


def _pct(sparsity: float) -> str:
    return f"{int(sparsity * 1000) / 10}pct"


def bench_main(b: Bench) -> None:
    """Dense vs the per-tap lowering (B4), 3x3 and 1x1."""
    from tpuseg_torch.ops.sparse_conv import plan_sparse_conv, sparse_conv_apply

    rng, w, x = b.problem()
    t_dense = b.timeit(b.dense(w, DIL), x)
    b.emit(metric="dense_conv3x3_ms", value=t_dense)
    w1 = conv1x1_weight(rng)
    t1_dense = b.timeit(b.dense(w1, 1), x)
    b.emit(metric="dense_conv1x1_ms", value=t1_dense)
    for kind, wk, dil, t_ref in (("conv1x1_", w1, 1, t1_dense), ("conv_", w, DIL, t_dense)):
        for sparsity in SPARSITIES:
            plan = plan_sparse_conv(wk, block_mask(wk, sparsity)).to(b.dev)
            t = b.timeit(lambda xx, p=plan, d=dil: sparse_conv_apply(xx, p, dilation=d), x)
            b.emit(metric=f"sparse_{kind}{_pct(sparsity)}", block_density=plan.density, ms=t,
                   speedup_vs_dense=t_ref / t)


def bench_fused(b: Bench) -> None:
    """Dense vs B2, B3 and the six round-3 entry points (B7a-f)."""
    from tpuseg_torch.ops import sparse_conv as sc

    _, w, x = b.problem()
    t_dense = b.timeit(b.dense(w, DIL), x)
    b.emit(metric="fused/dense_conv3x3_ms", value=t_dense)
    for sparsity in SPARSITIES:
        mask = block_mask(w, sparsity)
        fplan = sc.plan_fused_sparse_conv(w, mask, dilation=DIL)
        qplan = sc.quantize_fused_plan(fplan, x_scale=0.05).to(b.dev)
        plan = fplan.to(b.dev)
        sh_plan = sc.plan_shared_sparse_conv(w, mask, dilation=DIL).to(b.dev)
        ms = {key: b.timeit(lambda xx, f=fn, p=p: f(xx, p), x) for key, fn, p in (
            ("ms", sc.fused_sparse_conv_apply, plan),
            ("int8_ms", sc.fused_sparse_conv_apply_q, qplan),
            ("shared_ms", sc.shared_sparse_conv_apply, sh_plan),
            ("phase_ms", sc.phase_sparse_conv_apply, sh_plan),
            ("fphase_ms", sc.fused_phase_sparse_conv_apply, plan),
            ("imcol_ms", sc.imcol_phase_sparse_conv_apply, plan),
            ("cphase_ms", sc.cphase_sparse_conv_apply, plan),
            ("sconcat_ms", sc.shared_concat_sparse_conv_apply, sh_plan),
        )}
        row = {"metric": f"fused_sparse_conv_{_pct(sparsity)}",
               "block_density": plan.block_density,
               "phase_union_density": sh_plan.union_density}
        for key, t in ms.items():
            row[key] = t
            row["speedup_vs_dense" if key == "ms" else key[:-3] + "_speedup_vs_dense"] = (
                t_dense / t)
        b.emit(**row)
    # the phase entry point at density 1.0 (every block of the shared union)
    dense_plan = sc.plan_shared_sparse_conv(w, np.ones_like(w), dilation=DIL).to(b.dev)
    t = b.timeit(lambda xx: sc.phase_sparse_conv_apply(xx, dense_plan), x)
    b.emit(metric="phase_kernel_density_1.0", ms=t, vs_dense=t_dense / t)


def bench_gathered(b: Bench) -> None:
    """Dense vs the gathered lowering (split, exact, grouped) vs B2."""
    from tpuseg_torch.ops.gathered_conv import gathered_conv_apply, plan_gathered_conv
    from tpuseg_torch.ops.sparse_conv import fused_sparse_conv_apply, plan_fused_sparse_conv

    _, w, x = b.problem()
    t_dense = b.timeit(b.dense(w, DIL), x)
    b.emit(metric="gathered/dense_conv3x3_ms", value=t_dense)
    for sparsity in SPARSITIES:
        mask = block_mask(w, sparsity)
        row = {"metric": f"gathered_{_pct(sparsity)}"}
        for mode in ("split", "exact", "grouped"):
            plan = plan_gathered_conv(w, mask, dilation=DIL, mode=mode).to(b.dev)
            t = b.timeit(lambda xx, p=plan: gathered_conv_apply(xx, p), x)
            row[f"{mode}_ms"] = t
            row[f"{mode}_speedup"] = t_dense / t
            row["block_density"] = plan.block_density
        fplan = plan_fused_sparse_conv(w, mask, dilation=DIL).to(b.dev)
        t = b.timeit(lambda xx: fused_sparse_conv_apply(xx, fplan), x)
        row["fused_pallas_ms"] = t
        row["fused_pallas_speedup"] = t_dense / t
        b.emit(**row)


def bench_rmcdb(b: Bench) -> None:
    """The dense matmul vs the RMCDB roll lowering at four geometries."""
    from tpuseg_torch.ops.rmcdb_lowering import detect_rmcdb_rolls, rmcdb_roll_matmul
    from tpuseg_torch.sparsity.rmcdb import BlockletType, RmcdbConfig, prune_as_rmcdb

    rng = np.random.default_rng(0)
    w = rng.normal(size=(RMCDB_ROWS, RMCDB_COLS)).astype(np.float32) * 0.05
    x = torch.from_numpy(rng.normal(size=(RMCDB_P, RMCDB_COLS)).astype(np.float32)).to(
        b.dev, torch.bfloat16)
    wd_t = torch.from_numpy(w).to(b.dev, torch.bfloat16).t()
    t_dense = b.timeit(lambda xx: xx @ wd_t, x, inner=RMCDB_INNER)
    b.emit(metric="rmcdb/dense_matmul_ms", value=t_dense)
    for bh, bl, count in RMCDB_GEOMETRIES:
        cfg = RmcdbConfig(bh=bh, bw=bh, spo=0.0, bl_types=[BlockletType(bl, bl)],
                          bl_counts=[count])
        mask, _ = prune_as_rmcdb(w, cfg)
        plan = detect_rmcdb_rolls(w, mask.astype(np.float32), bh, bh, bl)
        if plan is None:
            raise AssertionError(f"rmcdb bh={bh} b={bl}: the mask is not whole cyclic diagonals")
        plan = plan.to(b.dev)
        t = b.timeit(lambda xx, p=plan: rmcdb_roll_matmul(xx, p), x, inner=RMCDB_INNER)
        b.emit(metric=f"rmcdb_roll_bh{bh}_b{bl}_c{count}", density=plan.density, ms=t,
               speedup_vs_dense=t_dense / t)


def _roundtrip(perm):
    """x -> the permuted layout -> back, each a real copy."""
    inv = tuple(int(i) for i in np.argsort(perm))
    return lambda xc: xc.permute(perm).contiguous().permute(inv).contiguous()


def bench_layout(b: Bench) -> None:
    """Layout conversions at layer 6's activation: the NHWC <-> NCHW and
    NHWC <-> NWHC round trips (one way = half) and one full copy."""
    _, _, x = b.problem()
    for name, perm in (("nhwc_nchw", (0, 3, 1, 2)), ("nhwc_nwhc", (0, 2, 1, 3))):
        t = b.timeit(_roundtrip(perm), x)
        b.emit(metric=f"layout/{name}_roundtrip_ms", value=t, one_way_ms=t / 2)
    t = b.timeit(lambda xx: xx.clone(), x)
    b.emit(metric="layout/copy_ms", value=t)


class DrnModel:
    """DRN-D-22 (seed 0, BN folded) served as ``bench_sparse.py``'s
    ``--model`` serves it: ``FusedStage3Frontend`` -> ``drnseg_logits``
    (stem_stages=4) -> B1, on flat uint8 frames."""

    def __init__(self, dev: torch.device, dtype=torch.bfloat16):
        from tpuseg_torch.models.drnseg import init_drnseg
        from tpuseg_torch.ops.fold_bn import fold_bn
        from tpuseg_torch.ops.polyphase import FusedStage3Frontend

        params, state, self.spec = init_drnseg(0, ARCH, CLASSES)
        self.folded = fold_bn(params, state, self.spec)  # f32, on the host
        self.dev, self.dtype = dev, dtype
        self.stem = FusedStage3Frontend(self.folded, device=dev, dtype=dtype,
                                        normalize=NORMALIZE)
        self.up_kernel = self.folded["up.weight"].float()

    def on_device(self, params) -> dict:
        out = {}
        for k, v in params.items():
            if k == "up.weight":
                continue
            v = v.to(self.dev, self.dtype)
            out[k] = v.contiguous(memory_format=torch.channels_last) if v.dim() == 4 else v
        return out

    def ids_fn(self, params, plans):
        """frames (N, H, W*3) uint8 -> ids (N, H, W) uint8 with ``plans``."""
        from tpuseg_torch.models.drnseg import drnseg_logits
        from tpuseg_torch.models.sparse_exec import plans_to
        from tpuseg_torch.ops.upsample import upsample_argmax

        p, dplans = self.on_device(params), plans_to(plans, self.dev)

        @torch.inference_mode()
        def fn(frames):
            seg = drnseg_logits(p, {}, frames, self.spec, compute_dtype=self.dtype,
                                stem_fn=self.stem, stem_stages=4, sparse_plans=dplans)
            return upsample_argmax(seg, self.up_kernel)
        return fn

    def block_masks(self, sparsity: float) -> dict:
        """BlockPruner 128x128 masks (OIHW f32) of every conv whose channels
        divide by 128, single-block layers skipped (BlockPruner's strict
        threshold would zero them whole; bench_sparse.py:555-561)."""
        masks = {}
        for name, v in self.folded.items():
            if v.dim() != 4 or name == "up.weight":
                continue
            cout, cin = v.shape[:2]
            if cout % 128 or cin % 128 or (cout // 128) * (cin // 128) < 2:
                continue
            masks[name] = torch.from_numpy(block_mask(v.numpy(), sparsity).astype(np.float32))
        return masks


def _frames_step(fn):
    """One chained frame: the ids of ``fc``, and their first byte written
    into ``fc`` (the data-dependent carry; in place, on the loop's frames)."""
    def step(fc):
        ids = fn(fc)
        fc[0, 0, 0] = ids[0, 0, 0]
        return fc
    return step


def bench_model(b: Bench, sweep: bool = False) -> list:
    """Dense vs block-sparse DRN-D-22 at 1024x2048, batch 1.  Returns each
    timed row's ``(metric, plans)`` in order (``plans`` None when dense)."""
    from tpuseg_torch.models.sparse_exec import build_sparse_plans, quantize_sparse_plans
    from tpuseg_torch.ops.quant import build_quant_plans
    from tpuseg_torch.sparsity import apply_masks

    m = DrnModel(b.dev)
    h, w = MODEL_HW
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, size=(1, h, w * 3), dtype=np.uint8)).to(b.dev)

    rows = []

    def run(params, plans):
        return b.time_loop(_frames_step(m.ids_fn(params, plans)), x.clone(), inner=MODEL_INNER)

    def emit(plans, **kw):
        rows.append((kw["metric"], plans))
        b.emit(**kw)

    t_dense = run(m.folded, None)
    emit(None, metric="model_dense_fps", value=1e3 / t_dense)
    for sparsity in ((0.875, 0.75, 0.5) if sweep else (0.875,)):
        pct = f"{int(sparsity * 1000) / 10}pct"
        masks = m.block_masks(sparsity)
        masked = apply_masks(m.folded, masks)
        full_set = sparsity == 0.875
        if full_set:
            plans, _ = build_sparse_plans(masked, masks, m.spec)
            t = run(masked, plans)
            emit(plans, metric=f"model_sparse_{pct}_fps", value=1e3 / t,
                 sparse_layers=len(plans), speedup_vs_dense=t_dense / t)
        lowered = {}
        for mode, key in (("split", "gathered"), ("exact", "gathered_exact")):
            lowered[key], _ = build_sparse_plans(masked, masks, m.spec, lowering="gathered",
                                                 gathered_mode=mode)
            t = run(masked, lowered[key])
            emit(lowered[key], metric=f"model_{key}_{pct}_fps", value=1e3 / t,
                 sparse_layers=len(lowered[key]), speedup_vs_dense=t_dense / t)
        if not full_set:
            continue
        # prune + int8 on the same layers + int8 on the other eligible convs
        qdense = build_quant_plans(masked, m.spec)
        for key, sp in (("sparse_int8", plans), ("gathered_int8", lowered["gathered"]),
                        ("gathered_exact_int8", lowered["gathered_exact"])):
            qplans = {**qdense, **quantize_sparse_plans(sp)}
            t = run(masked, qplans)
            emit(qplans, metric=f"model_{key}_{pct}_fps", value=1e3 / t,
                 speedup_vs_dense=t_dense / t)
    return rows


class Int8Frontend:
    """The bf16 ``FusedStage3Frontend`` with the stem convs in int8 (B3's
    stem route) and, with ``stage3``, stage 3's five convs in int8 (B3's
    narrow route through ``quant_conv_apply``), every activation scale
    fixed at ``FRONTEND_XS``; weights quantized from the frontend's bf16
    weights."""

    def __init__(self, folded, dev: torch.device, stage3: bool):
        from tpuseg_torch.ops.polyphase import FusedStage3Frontend

        self.stem = FusedStage3Frontend(folded, device=dev, dtype=torch.bfloat16,
                                        normalize=NORMALIZE, int8_stem=True)
        self.stem.conv0_x_scale = FRONTEND_XS
        self.stem.stem_x_scales = [FRONTEND_XS] * len(self.stem.convs)
        self.plans = None
        if stage3:
            s3 = self.stem.stage3
            convs = {f"{s3}.0.conv1": self.stem.b0_conv1, f"{s3}.0.downsample.0": self.stem.b0_ds}
            convs.update({n: (wb[0], wb[1], 1, 1) for n, wb in self.stem.image_convs.items()})
            self.plans = {n: (_quant_conv_of(n, wt, lo, hi).to(dev), bias)
                          for n, (wt, bias, lo, hi) in convs.items()}

    def _iconv(self, x, name):
        """One int8 conv of NHWC x: B3's f32 y cast to bf16, then + bias."""
        from tpuseg_torch.ops.quant import quant_conv_apply

        plan, bias = self.plans[name]
        return quant_conv_apply(x, plan).to(torch.bfloat16) + bias

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        from tpuseg_torch.models.drn import nchw_to_nhwc

        if self.plans is None:
            return self.stem(frames)
        s3 = self.stem.stage3
        x = nchw_to_nhwc(self.stem._stem_convs(self.stem._input(frames)))
        y1 = torch.relu(self._iconv(x, f"{s3}.0.conv1"))
        yd = self._iconv(x, f"{s3}.0.downsample.0")
        out = torch.relu(self._iconv(y1, f"{s3}.0.conv2") + yd)
        r = out
        out = torch.relu(self._iconv(out, f"{s3}.1.conv1"))
        return torch.relu(self._iconv(out, f"{s3}.1.conv2") + r)


def _quant_conv_of(name: str, w_oihw: torch.Tensor, pad_lo: int, pad_hi: int):
    """The ``QuantConv`` of one stride-1 frontend conv (OIHW weight in the
    compute dtype, padding (pad_lo, pad_hi) on both axes) at the fixed
    scale: an even or asymmetric kernel embedded in the odd "same" kernel,
    on B3's narrow packing (``int8_packing``)."""
    from tpuseg_torch.models.weights import oihw_to_hwio_np
    from tpuseg_torch.ops.quant import QuantConv, embed_same, int8_packing, quantize_weight

    wq, ws = quantize_weight(oihw_to_hwio_np(w_oihw))
    wq, pad = embed_same(wq, pad_lo, pad_hi)
    return QuantConv(w_q=torch.from_numpy(wq), w_scale=torch.from_numpy(ws), stride=1,
                     dilation=1, padding=pad, x_scale=FRONTEND_XS,
                     packed=int8_packing(name, wq, ws, 1, pad, FRONTEND_XS))


def bench_frontend(b: Bench) -> None:
    """The fused frontend alone at 1024x2048: bf16, int8 stem, int8 stem
    and stage 3."""
    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.ops.fold_bn import fold_bn
    from tpuseg_torch.ops.polyphase import FusedStage3Frontend

    params, state, spec = init_drnseg(0, ARCH, CLASSES)
    folded = fold_bn(params, state, spec)
    h, w = MODEL_HW
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, size=(1, h, w * 3), dtype=np.uint8)).to(b.dev)

    def run(fwd):
        def step(fc):
            with torch.inference_mode():
                y = fwd(fc)
            fc[0, 0, 0] = y[0, 0, 0, 0].to(fc.dtype)
            return fc
        return b.time_loop(step, x.clone(), inner=MODEL_INNER)

    t_bf16 = run(FusedStage3Frontend(folded, device=b.dev, dtype=torch.bfloat16,
                                     normalize=NORMALIZE))
    b.emit(metric="frontend/bf16_ms", value=t_bf16)
    for name, stage3 in (("int8_stem", False), ("int8_stem_stage3", True)):
        t = run(Int8Frontend(folded, b.dev, stage3))
        b.emit(metric=f"frontend/{name}_ms", value=t, speedup_vs_bf16=t_bf16 / t)


def train_problem(dev: torch.device):
    """(w0 OIHW f32, x f32 NHWC, target f32, OIHW 87.5 % mask), drawn in
    ``bench_sparse.py``'s order (HWIO w0, x, target; seed 0)."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(K, K, C, C)).astype(np.float32) * 0.05
    x = rng.normal(size=(N, H, W, C)).astype(np.float32)
    tgt = rng.normal(size=(N, H, W, C)).astype(np.float32)
    w = _oihw(w0)
    mask = block_mask(w, 0.875).astype(np.float32)
    return (torch.from_numpy(w).to(dev), torch.from_numpy(x).to(dev),
            torch.from_numpy(tgt).to(dev), mask)


def train_losses(x, tgt, mask_oihw: np.ndarray, compute_dtype=torch.bfloat16):
    """(masked dense loss, sparse loss, the struct): MSE against ``tgt`` of
    the layer-6 conv of w, masked dense (cuDNN) or ``sparse_conv_train``."""
    from tpuseg_torch.models.weights import oihw_to_hwio_np
    from tpuseg_torch.ops.sparse_train import plan_sparse_conv_train, sparse_conv_train

    st = plan_sparse_conv_train(oihw_to_hwio_np(mask_oihw), dilation=DIL)
    plan = st.to(x.device)
    m = torch.from_numpy(mask_oihw).to(x.device)
    xc = x.to(compute_dtype).permute(0, 3, 1, 2)

    def loss_dense(w):
        y = F.conv2d(xc, (w * m).to(compute_dtype), None, 1, DIL * (K - 1) // 2, DIL)
        return torch.mean((y.permute(0, 2, 3, 1).float() - tgt) ** 2)

    def loss_sparse(w):
        y = sparse_conv_train(x, w, plan, compute_dtype=compute_dtype)
        return torch.mean((y.float() - tgt) ** 2)

    return loss_dense, loss_sparse, st


def _sgd_step(loss_fn):
    def step(w):
        w = w.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(w), [w])
        return (w - TRAIN_LR * g).detach()
    return step


def bench_train(b: Bench) -> None:
    """The layer-6 conv's train step at 87.5 %: masked dense vs B2."""
    w0, x, tgt, mask = train_problem(b.dev)
    loss_dense, loss_sparse, st = train_losses(x, tgt, mask)
    t_dense = b.time_loop(_sgd_step(loss_dense), w0, inner=TRAIN_INNER)
    t_sparse = b.time_loop(_sgd_step(loss_sparse), w0, inner=TRAIN_INNER)
    b.emit(metric="train_step_sparse_87.5pct", dense_ms=t_dense, sparse_ms=t_sparse,
           speedup_vs_dense_masked=t_dense / t_sparse, union_density=st.block_density)


# the folded conv1's phase structure on one axis: a in {1, 2} needs tap m = 0,
# a = 0 taps {-1, 0}, a = 3 taps {0, 1} (tap indices into the folded kernel,
# pad_lo, pad_hi)
SPLIT_AXIS = {"mid": ((1,), 0, 0), "lo": ((0, 1), 1, 0), "hi": ((1, 2), 0, 1)}
SPLIT_PHASES = {"mid": (1, 2), "lo": (0,), "hi": (3,)}
SPLIT_F, SPLIT_C = 4, 16


def _phase_cols(avals, bvals) -> np.ndarray:
    return np.asarray([(a * SPLIT_F + b_) * SPLIT_C + k
                       for a in avals for b_ in bvals for k in range(SPLIT_C)], np.int64)


class Conv1Split:
    """The folded stem conv1 (HWIO ``wp``, 3x3, padding 1) on NHWC x, dense
    and split by output phase into exact smaller convs (cuDNN)."""

    GROUPS = {  # name -> (row types, column types); None: the full 3 taps
        "split1d": (("lo", "mid", "hi"), None),
        "split2d": (("lo", "mid", "hi"), ("lo", "mid", "hi")),
    }

    def __init__(self, wp_hwio: np.ndarray, dev: torch.device, dtype=torch.bfloat16):
        if wp_hwio.shape != (3, 3, 256, 256):
            raise ValueError(f"the folded conv1 is (3, 3, 256, 256), got {wp_hwio.shape}")
        self.wd = self._weight(wp_hwio, dev, dtype)
        self.splits = {}
        for name, (rows, cols) in self.GROUPS.items():
            convs, order = [], []
            for rt in rows:
                for ct in cols or (None,):
                    taps_r, plo_r, phi_r = SPLIT_AXIS[rt]
                    taps_c, plo_c, phi_c = SPLIT_AXIS[ct] if ct else ((0, 1, 2), 1, 1)
                    sel = _phase_cols(SPLIT_PHASES[rt],
                                      SPLIT_PHASES[ct] if ct else range(SPLIT_F))
                    w = wp_hwio[np.ix_(taps_r, taps_c)][:, :, :, sel]
                    convs.append((self._weight(w, dev, dtype), (plo_c, phi_c, plo_r, phi_r)))
                    order.append(sel)
            self.splits[name] = (convs, np.argsort(np.concatenate(order)))

    @staticmethod
    def _weight(w_hwio, dev, dtype):
        return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))).to(
            dev, dtype).contiguous(memory_format=torch.channels_last)

    def dense(self, x):
        return F.conv2d(x.permute(0, 3, 1, 2), self.wd, None, 1, 1).permute(0, 2, 3, 1)

    def split(self, name: str, x):
        """The concatenated phase groups' outputs (channel order: the split's;
        ``self.splits[name][1]`` permutes them back)."""
        xc = x.permute(0, 3, 1, 2)
        outs = [F.conv2d(F.pad(xc, pad).contiguous(memory_format=torch.channels_last)
                         if any(pad) else xc, w) for w, pad in self.splits[name][0]]
        return torch.cat(outs, dim=1).permute(0, 2, 3, 1)


def conv1split_gate(name: str, y_split: torch.Tensor, perm: np.ndarray,
                    y_ref: torch.Tensor) -> float:
    """``bench_sparse.py``'s numerics gate: the split, permuted back, within
    0.02 * max|y_ref| + 1e-3 of the dense conv; raises otherwise."""
    ys = y_split.float().cpu()[..., torch.from_numpy(perm)]
    yr = y_ref.float().cpu()
    err = float((ys - yr).abs().max())
    scale = float(yr.abs().max())
    if not err < 0.02 * scale + 1e-3:
        raise AssertionError(f"conv1split {name}: max |err| {err} >= 0.02 * {scale} + 1e-3")
    return err


def bench_conv1split(b: Bench) -> None:
    """The folded stem conv1 dense vs its 1-D and 2-D phase splits."""
    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.ops.fold_bn import fold_bn
    from tpuseg_torch.ops.polyphase import FusedStage3Frontend

    params, state, spec = init_drnseg(0, ARCH, CLASSES)
    stem = FusedStage3Frontend(fold_bn(params, state, spec), device=b.dev,
                               dtype=torch.bfloat16, normalize=NORMALIZE)
    wp, _bias, lo, hi = stem.convs[1]
    if (lo, hi) != (1, 1):
        raise AssertionError(f"the folded conv1's padding is ({lo}, {hi}), not (1, 1)")
    cs = Conv1Split(wp.float().cpu().numpy().transpose(2, 3, 1, 0), b.dev)
    hq, wq = CONV1SPLIT_HW
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, hq, wq, 256)).astype(
        np.float32) * 0.1).to(b.dev, torch.bfloat16)
    y_ref = cs.dense(x)
    for name in cs.GROUPS:
        err = conv1split_gate(name, cs.split(name, x), cs.splits[name][1], y_ref)
        b.emit(metric=f"conv1split/{name}_numerics_ok", max_abs_err=err)
    t = {name: b.timeit(lambda c, f=fn: f(c)[..., :256], x, inner=CONV1SPLIT_INNER)
         for name, fn in (("dense", cs.dense),
                          ("split1d", lambda c: cs.split("split1d", c)),
                          ("split2d", lambda c: cs.split("split2d", c)))}
    b.emit(metric="conv1split_ms", **t, speedup_1d=t["dense"] / t["split1d"],
           speedup_2d=t["dense"] / t["split2d"])


def trainer_setup(dev: torch.device, crop: int, batch: int):
    """(params, bn state, spec, masks, structs, report, images, labels, tx)
    of ``--trainer``: DRN-D-22 (seed 0), block128reg_87.50 static masks
    (seed 0), images and labels drawn from numpy seed 0."""
    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.ops.sparse_train import build_sparse_train_structs
    from tpuseg_torch.sparsity import create_masker
    from tpuseg_torch.train import make_sgd

    params, state, spec = init_drnseg(0, ARCH, CLASSES)
    masks = create_masker(TRAINER_CONFIG, seed=0).generate_masks(params, is_static=True)
    structs, report = build_sparse_train_structs(masks, spec)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((batch, crop, crop, 3), dtype=np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, CLASSES, size=(batch, crop, crop)).astype(
        np.int32)).to(dev)
    tx = make_sgd(lambda _: 0.01, 0.9, 1e-4)
    on = lambda d: {k: v.to(dev) for k, v in d.items()}  # noqa: E731
    return on(params), on(state), spec, on(masks), structs, report, x, y, tx


def bench_trainer(b: Bench) -> None:
    """The whole seg train step, masked dense vs ``--sparse-exec``."""
    from tpuseg_torch.train import create_train_state, make_seg_train_step

    params, state, spec, masks, structs, report, x, y, tx = trainer_setup(
        b.dev, TRAINER_CROP, TRAINER_BATCH)
    n_sparse = sum(1 for v in report.values() if v.startswith("sparse-train"))

    def time_step(plans):
        step = make_seg_train_step(spec, tx, compute_dtype=torch.bfloat16, sparse_plans=plans)
        ts0 = create_train_state(params, state, tx, masks)
        return b.time_loop(lambda ts: step(ts, x, y)[0], ts0, inner=TRAINER_INNER)

    t_dense = time_step(None)
    t_sparse = time_step({k: st.to(b.dev) for k, st in structs.items()})
    b.emit(metric="trainer_step_sparse_exec_block128reg_87.5", crop=TRAINER_CROP,
           batch=TRAINER_BATCH, dense_masked_ms=t_dense, sparse_exec_ms=t_sparse,
           speedup_vs_dense_masked=t_dense / t_sparse, sparse_layers=n_sparse)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpuseg_torch.bench_sparse",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--fused", action="store_true", help="also time B2, B3 and B7a-f")
    ap.add_argument("--fused-only", action="store_true", help="time only B2, B3 and B7a-f")
    ap.add_argument("--fused-appendix", action="store_true",
                    help="also time B2, B3 and B7a-f (an alias of --fused)")
    ap.add_argument("--gathered", action="store_true", help="time the gathered lowering")
    ap.add_argument("--rmcdb", action="store_true", help="time the RMCDB roll lowering")
    ap.add_argument("--layout", action="store_true", help="time the layout round trips")
    ap.add_argument("--model", action="store_true", help="time DRN-D-22 end to end")
    ap.add_argument("--sweep", action="store_true",
                    help="with --model: the gathered rows at 75 and 50 %% too")
    ap.add_argument("--frontend", action="store_true",
                    help="time the fused frontend in bf16 and int8")
    ap.add_argument("--train", action="store_true", help="time the layer-6 train step")
    ap.add_argument("--conv1split", action="store_true",
                    help="time the folded stem conv1's phase splits")
    ap.add_argument("--trainer", action="store_true", help="time the whole seg train step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_sparse: torch.cuda.is_available() is False; the bench needs a CUDA "
              "card", file=sys.stderr)
        return 1
    b = Bench(torch.device("cuda", 0), card_label())
    if not any(getattr(args, flag) for flag in NOT_MAIN):
        bench_main(b)
    if args.fused or args.fused_only or args.fused_appendix:
        bench_fused(b)
    for flag, mode in (("gathered", bench_gathered), ("frontend", bench_frontend),
                       ("rmcdb", bench_rmcdb), ("layout", bench_layout)):
        if getattr(args, flag):
            mode(b)
    if args.model:
        bench_model(b, sweep=args.sweep)
    for flag, mode in (("train", bench_train), ("trainer", bench_trainer),
                       ("conv1split", bench_conv1split)):
        if getattr(args, flag):
            mode(b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
