#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``tpuseg_torch``): builds the CUDA
kernels from ``tpuseg_torch/csrc/``, holds each against its plain PyTorch
version, drives the served slices (DRN-D-22 DRNSeg, 19 classes, 1024x2048,
dense and pruned, float and int8) through ``VideoSegmenter``, and times the
kernels against their plain versions.

    python3 chip_smoke.py        # from the repo root, one CUDA card

Phases (any failed check raises and the exit code is non-zero):
  1. card, versions, kernel build time;
  2. kernel vs plain ids on the card, bit-equal, at several shapes/dtypes;
  3. slice parity in f32 (TF32 off): CUDA with the kernel vs CPU with the
     plain versions, ids agreement >= 0.999;
  4. the slice at full width and size in bf16: run() over 32 shapes frames
     at batch 8 (ids checked, kernel launch count > 0, agreement with the
     same frames in f32 >= 0.9), then the device rate at batch 32;
  5. kernel vs plain time at the serving shape (32, 128, 256, 19) bf16;
  6. the block-sparse conv kernel (B2) vs its plain version (f32 convs, TF32
     off) at the CPU tests' shapes, a 1x1, an S=2 and an all-zero plan, f32
     and bf16 plans, then each of the 7 B2 plans of block128reg_87.50 at its
     batch-32 serving input; a non-contiguous input must raise;
  7. pruned slice parity in f32: block128_75.00 masks, Pallas lowering, f32
     plans, CUDA with the kernel vs CPU with the plain versions, ids
     agreement >= 0.999;
  8. the pruned slice at full width and size: block128reg_87.50, Pallas
     lowering, bf16; run() over 32 shapes frames at batch 8 (B2 launched
     exactly 7 times per forward, ids agreement with the f32 masked-dense
     path >= 0.9), then the device rate at batch 32 for the Pallas lowering,
     the gathered lowering and masked dense;
  9. B2 vs plain vs the dense cuDNN conv at the layer.6.1.conv2 serving shape;
 10. the int8 block-sparse conv kernel (B3) vs its exact plain version,
     bit-equal: the CPU tests' shapes with per-frame and static scales, f32
     and bf16 x; the quantize pass on the card vs on the CPU; then every B3
     plan the served int8 configurations launch (the 7 lifted B2 plans of
     block128reg_87.50, the full-support packings of the 13 dense int8
     convs, one gathered packing) at its batch-32 serving input; a
     non-contiguous input must raise;
 11. int8 slice parity in f32 (TF32 off), dense and block128_75.00 Pallas:
     every int8 conv's CUDA output is bit-equal to the CPU plain version on
     the activation the CUDA run gave it, and CUDA vs CPU ids agree >= 0.97;
 12. int8 at full width and size, bf16, batch 8, 32 frames: dense (per-frame
     scales), dense calibrated on 8 frames, block128reg_87.50 under the
     Pallas and the gathered lowering; B3 launched exactly 13 / 13 / 11 / 13
     times per forward and B2 never; ids agreement with the float runs and
     calibrated vs dynamic >= INT8_FULL_MIN (0.9 dense, 0.85 pruned);
 13. device fps at batch 32 of those four int8 variants, and B3 vs its plain
     version vs B2 vs the dense cuDNN bf16 conv at layer.6.1.conv2, with the
     quantize pass and a dense conv through B3.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter

ARCH = "drn_d_22"
CLASSES = 19
MEAN = [0.290, 0.328, 0.287]
STD = [0.183, 0.187, 0.184]
FULL = (1024, 2048)
SERVING_LOGITS = (32, 128, 256, 19)
CONFIGS = "optimal_configs/drn_d_22"
SERVED_CONFIG = f"{CONFIGS}/drn_d_22_block128reg_87.50.json"
PARITY_CONFIG = f"{CONFIGS}/drn_d_22_block128_75.00.json"
# layer.6.1.conv2 at batch 32, 1024x2048 frames: x (N, H, W, Cin), kernel, dilation
SERVING_SPARSE = ((32, 128, 256, 512), 3, 4)
B2_PER_FORWARD = 7  # B2 convs of block128reg_87.50 under the Pallas lowering
# B3 launches per forward under --quantize: the 13 dense int8 convs; under
# block128reg_87.50, Pallas: 4 QuantConv + 3 FusedSparseConvQ + 4
# CompactSparseQ (3 RBGP plans stay float); gathered: 9 GatheredGroupConvQ
# + 4 QuantConv
B3_PER_FORWARD = {"dense": 13, "dense_calibrated": 13, "pallas": 11, "gathered": 13}
# int8 ids CUDA vs CPU in f32: two exact int8 paths fed f32 activations that
# differ in the last bit (cuDNN and oneDNN sum in other orders) round a few
# x/scale quotients to other integers, and each such step of a whole
# quantum cascades through the int8 convs after it.  The CPU port against
# itself with oneDNN on and off agreed on 0.983-1.0 of the ids (64x64 to
# 128x256); phase 11 holds every int8 conv bit-equal on the same activation
# and the ids to this floor.
INT8_PARITY_MIN = 0.97
# Phase 12 floors of int8 ids against the float run (calibrated: against the
# dynamic int8 run).  On these random weights int8 agreement falls with the
# frame size, in tpuseg as in the port: block128reg_87.50 under the Pallas
# lowering, f32 on the CPU, shapes frames, int8 vs float agreed on
# 0.9587 / 0.9272 / 0.9015 of the ids at 128x256 / 256x512 / 512x1024 in the
# port and on 0.9594 / 0.9276 / 0.9018 in tpuseg (PERF.md, Findings).  A pruned
# run at 1024x2048 reads about 0.89, so its floor is 0.85; a broken int8
# conv reads far lower.
INT8_FULL_MIN = {"dense": 0.9, "dense_calibrated": 0.9, "pallas": 0.85, "gathered": 0.85}


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _agreement(a, b) -> float:
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a == b).mean())


def _time_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _time_turns(torch, fns: dict, iters: dict) -> dict:
    """Time each callable in turns (a, b, ..., ..., b, a): name -> [ms, ms]."""
    order = list(fns) + list(fns)[::-1]
    out = {name: [] for name in fns}
    for name in order:
        out[name].append(_time_ms(torch, fns[name], iters[name]))
    return out


def _b2_mask(rng, k, cin, cout, s, dead_out=False):
    """OIHW 0/1 mask: every out-block keeps s random in-blocks (the last
    one none with ``dead_out``); per-tap holes keep the union at s."""
    import numpy as np

    nkb, nmb = cin // 128, cout // 128
    m = np.zeros((cout, cin, k, k), np.float32)
    for j in range(nmb - 1 if dead_out else nmb):
        for kb in rng.choice(nkb, size=s, replace=False):
            taps = rng.random(k * k) < 0.8
            taps[0] = True
            m[j * 128:(j + 1) * 128, kb * 128:(kb + 1) * 128] = taps.reshape(k, k)
    return m


def _b2_vs_plain(torch, np, dev, rng, served: dict) -> float:
    """Phase 6: B2 on the card vs its plain version on the same inputs: the
    CPU tests' shapes and kinds, then every B2 plan of ``served`` (the
    FusedSparseConv plans and each CompactSparse's inner plan) at its
    batch-32 serving input."""
    from tpuseg_torch.models.sparse_exec import CompactSparse
    from tpuseg_torch.ops.sparse_conv import (
        FusedSparseConv, fused_sparse_conv_apply, fused_sparse_conv_reference,
        plan_fused_sparse_conv)

    eps = float(np.finfo(np.float32).eps)
    worst = 0.0

    def check(x, plan, case):
        nonlocal worst
        got = fused_sparse_conv_apply(x, plan)
        want = fused_sparse_conv_reference(x, plan)
        torch.cuda.synchronize()
        shape = tuple(x.shape[:3])
        assert got.shape == want.shape == shape + (plan.cout,) and got.dtype == torch.float32
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        K = plan.kernel * plan.kernel * plan.s * 128
        # f32 sums of K exact products in two orders: bounded by ~K*eps
        # relative to the output scale; never looser than 1e-3
        tol = min(1e-3, 2 * K * eps)
        rel = err / scale if scale > 0 else err
        worst = max(worst, err)
        _emit(phase="b2_vs_plain", shape=list(x.shape), k=plan.kernel, dilation=plan.dilation,
              cout=plan.cout, s=plan.s, plan_dtype=str(plan.vals.dtype), case=case,
              max_abs_err=err, rel_err=rel, tol_rel=tol, max_abs_want=scale)
        if (scale == 0 and err != 0) or rel > tol:
            raise AssertionError(f"B2 differs from its plain version: {rel} > {tol} "
                                 f"at {list(x.shape)} k={plan.kernel} d={plan.dilation} "
                                 f"S={plan.s} {plan.vals.dtype} ({case})")

    cases = [  # (x shape without C, k, dilation, cin, cout, S, kind)
        ((1, 17, 33), 3, 1, 384, 256, 3, ""),
        ((1, 17, 33), 3, 2, 384, 256, 2, ""),
        ((2, 8, 12), 3, 4, 256, 256, 1, ""),
        ((1, 9, 20), 1, 1, 512, 256, 2, "1x1"),
        ((1, 6, 10), 3, 1, 384, 128, 3, ""),
        ((2, 64, 128), 3, 2, 512, 512, 2, "S=2, dead out-block"),
        ((1, 16, 24), 3, 2, 256, 256, 1, "all-zero plan"),
    ]
    for shape, k, d, cin, cout, s, kind in cases:
        w = (rng.normal(size=(cout, cin, k, k)) * 0.05).astype(np.float32)
        m = _b2_mask(rng, k, cin, cout, s, dead_out="dead" in kind)
        if kind == "all-zero plan":
            m[:] = 0
        for dtype in (torch.float32, torch.bfloat16):
            plan = plan_fused_sparse_conv(w, m, dilation=d, dtype=dtype).to(dev)
            x = torch.from_numpy(rng.normal(size=shape + (cin,)).astype(np.float32)).to(dev, dtype)
            check(x, plan, kind)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n, h, w = SERVING_SPARSE[0][:3]
    served_b2 = 0
    for name, p in served.items():
        plan = p.inner if isinstance(p, CompactSparse) else p
        if not isinstance(plan, FusedSparseConv):
            continue
        plan = plan.to(dev)
        x = torch.randn((n, h, w, plan.cin), generator=gen, device=dev, dtype=plan.vals.dtype)
        check(x, plan, f"{name} serving input"
              + (" (CompactSparse survivors)" if isinstance(p, CompactSparse) else ""))
        served_b2 += 1
        del x
    if served_b2 != B2_PER_FORWARD:
        raise AssertionError(f"the served config has {served_b2} B2 plans; "
                             f"want {B2_PER_FORWARD}")
    x = torch.zeros((1, plan.cin, 16, 24), device=dev,
                    dtype=torch.bfloat16).permute(0, 2, 3, 1)  # NHWC view of NCHW memory
    try:
        fused_sparse_conv_apply(x, plan)
    except ValueError:
        pass
    else:
        raise AssertionError("B2 accepted a non-contiguous NHWC view")
    return worst


def _b3_vs_plain(torch, np, dev, rng, served: dict) -> float:
    """Phase 10: B3 on the card vs its exact plain version on the same
    inputs, bit for bit; ``served`` maps a label to each B3 packing the
    served int8 configurations launch, checked at its batch-32 input."""
    from tpuseg_torch.ops.sparse_conv import (
        fused_sparse_conv_apply_q, fused_sparse_conv_q_reference, plan_fused_sparse_conv,
        quantize_activation, quantize_fused_plan)

    worst = 0.0

    def check(x, plan, case):
        nonlocal worst
        got = fused_sparse_conv_apply_q(x, plan)
        want = fused_sparse_conv_q_reference(x, plan)
        torch.cuda.synchronize()
        assert got.shape == want.shape == tuple(x.shape[:3]) + (plan.cout,)
        assert got.dtype == want.dtype == torch.float32
        mism = int((got != want).sum())
        err = float((got - want).abs().max())
        worst = max(worst, err)
        _emit(phase="b3_vs_plain", shape=list(x.shape), x_dtype=str(x.dtype), k=plan.kernel,
              dilation=plan.dilation, cout=plan.cout, s=plan.s,
              scale="static" if plan.x_scale is not None else "per-frame", case=case,
              mismatches=mism, max_abs_err=err, max_abs_want=float(want.abs().max()))
        if mism:
            raise AssertionError(f"B3 differs from its plain version in {mism} values at "
                                 f"{list(x.shape)} k={plan.kernel} d={plan.dilation} "
                                 f"S={plan.s} ({case})")

    cases = [  # (x shape without C, k, dilation, cin, cout, S, kind): the CPU tests' kinds
        ((1, 17, 33), 3, 1, 384, 256, 3, "odd grid"),
        ((1, 17, 33), 3, 2, 384, 256, 2, "odd grid"),
        ((2, 8, 12), 3, 4, 256, 256, 1, ""),
        ((1, 9, 20), 1, 1, 512, 256, 2, "1x1"),
        ((1, 6, 10), 3, 1, 384, 128, 3, "S=3"),
        ((2, 64, 128), 3, 2, 512, 512, 2, "S=2, dead out-block"),
        ((1, 16, 24), 3, 2, 256, 256, 1, "all-zero plan"),
    ]
    for shape, k, d, cin, cout, s, kind in cases:
        w = (rng.normal(size=(cout, cin, k, k)) * 0.05).astype(np.float32)
        m = _b2_mask(rng, k, cin, cout, s, dead_out="dead" in kind)
        if kind == "all-zero plan":
            m[:] = 0
        fplan = plan_fused_sparse_conv(w, m, dilation=d)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.normal(size=shape + (cin,)).astype(np.float32)).to(dev, dtype)
            static = float(x.float().abs().max()) / 127.0 * 0.8  # some values clip
            for x_scale in (None, static):
                check(x, quantize_fused_plan(fplan, x_scale).to(dev), kind)
    # the quantize pass on the card vs on the CPU (B3's plain version runs it
    # on the card too, so the comparison above cannot see it)
    x = torch.from_numpy(rng.normal(size=(3, 32, 48, 256)).astype(np.float32))
    x[1] *= 40.0
    x[2] = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for x_scale in (None, 0.013):
            xq_d, xs_d = quantize_activation(x.to(dev, dtype), x_scale)
            xq_c, xs_c = quantize_activation(x.to(dtype), x_scale)
            same = torch.equal(xq_d.cpu(), xq_c) and torch.equal(xs_d.cpu(), xs_c)
            _emit(phase="b3_quantize_pass_vs_cpu", x_dtype=str(dtype),
                  scale="static" if x_scale else "per-frame", bit_equal=same)
            if not same:
                raise AssertionError(f"the quantize pass differs between CUDA and CPU ({dtype})")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n, h, w = SERVING_SPARSE[0][:3]
    for label, plan in served.items():
        plan = plan.to(dev)
        x = torch.randn((n, h, w, plan.cin), generator=gen, device=dev, dtype=torch.bfloat16)
        check(x, plan, f"{label} serving input")
        del x
        torch.cuda.empty_cache()
    x = torch.zeros((1, plan.cin, 16, 24), device=dev,
                    dtype=torch.bfloat16).permute(0, 2, 3, 1)  # NHWC view of NCHW memory
    try:
        fused_sparse_conv_apply_q(x, plan)
    except ValueError:
        pass
    else:
        raise AssertionError("B3 accepted a non-contiguous NHWC view")
    return worst


def _served_b3_packings(dense_plans: dict, pallas_plans: dict, gathered_plans: dict) -> dict:
    """label -> every B3 packing the served int8 configurations launch: the
    13 dense convs' full-support packings, the 7 lifted B2 plans of the
    Pallas lowering (CompactSparseQ's inner plans take the survivors), and
    the gathered packing of layer.6.1.conv2."""
    from tpuseg_torch.models.sparse_exec import CompactSparseQ, quantize_sparse_plans
    from tpuseg_torch.ops.gathered_conv import GatheredGroupConvQ
    from tpuseg_torch.ops.sparse_conv import FusedSparseConvQ

    out = {f"{n} QuantConv": p.packed for n, p in dense_plans.items()}
    for n, p in quantize_sparse_plans(pallas_plans).items():
        if isinstance(p, FusedSparseConvQ):
            out[f"{n} FusedSparseConvQ"] = p
        elif isinstance(p, CompactSparseQ):
            out[f"{n} CompactSparseQ survivors"] = p.inner
    g = quantize_sparse_plans({"layer.6.1.conv2": gathered_plans["layer.6.1.conv2"]})
    assert isinstance(g["layer.6.1.conv2"], GatheredGroupConvQ)
    out["layer.6.1.conv2 GatheredGroupConvQ"] = g["layer.6.1.conv2"].packed
    want = B3_PER_FORWARD["dense"] + B2_PER_FORWARD + 1
    if len(out) != want:
        raise AssertionError(f"{len(out)} served B3 packings; want {want}")
    return out


class _Recorder:
    """An int8 plan that records each input and output of the plan it wraps
    (the dispatch runs any plan with ``.apply``)."""

    def __init__(self, plan, log: list):
        self.plan, self.log = plan, log

    def apply(self, x):
        from tpuseg_torch.ops.sparse_conv import FusedSparseConvQ, fused_sparse_conv_apply_q

        if isinstance(self.plan, FusedSparseConvQ):
            y = fused_sparse_conv_apply_q(x, self.plan)
        else:
            y = self.plan.apply(x)
        self.log.append((x.clone(), y.clone()))
        return y


def _int8_parity_f32(torch, np, variants: dict, state, spec, small) -> None:
    """Phase 11: for each (params, float plans) variant, int8 f32 serving on
    the card (TF32 off) and on the CPU.  Every int8 conv's CUDA output must
    equal, bit for bit, the CPU plain version run on the activation the CUDA
    run gave that conv; the ids must agree >= INT8_PARITY_MIN."""
    from tpuseg_torch.ops.sparse_conv import FusedSparseConvQ, fused_sparse_conv_apply_q
    from tpuseg_torch.video.pipeline import VideoSegmenter

    for label, (params, plans) in variants.items():
        segs, ids = {}, {}
        logs: dict = {}
        for name in ("cuda", "cpu"):
            seg = VideoSegmenter(params, state, spec, MEAN, STD, device=name,
                                 compute_dtype=torch.float32, batch=2, exec_plans=plans,
                                 quantize=True)
            if name == "cuda":
                for conv, p in list(seg.exec_plans.items()):
                    if type(p).__name__ != "RbgpPlan":
                        logs[conv] = []
                        seg.exec_plans[conv] = _Recorder(p, logs[conv])
            segs[name] = seg
            ids[name] = seg.run(small, need_color=False)["ids"]
        agree = _agreement(ids["cuda"], ids["cpu"])
        checked = 0
        for conv, log in logs.items():
            plan = segs["cpu"].exec_plans[conv]
            for x, y in log:
                xc = x.cpu()
                want = (fused_sparse_conv_apply_q(xc, plan) if isinstance(plan, FusedSparseConvQ)
                        else plan.apply(xc))
                if not torch.equal(y.cpu(), want):
                    raise AssertionError(f"int8 conv {conv} ({label}): CUDA output differs from "
                                         "the CPU plain version on the same activation")
                checked += 1
        _emit(phase="int8_parity_f32", variant=label, tf32=False, size=list(small[0].shape[:2]),
              frames=len(small), int8_convs=len(logs), conv_calls_bit_equal=checked,
              ids_agreement=agree, limit=INT8_PARITY_MIN)
        if not logs or checked < len(logs):
            raise AssertionError(f"{label}: {checked} int8 conv calls recorded for {len(logs)} convs")
        if agree < INT8_PARITY_MIN:
            raise AssertionError(f"int8 f32 CUDA vs CPU ids agreement {agree} < {INT8_PARITY_MIN}")


def _pruned(torch, params, state, spec, config, lowering, dtype):
    """Masked params and sparse plans for ``config`` (masker seed 0)."""
    from tpuseg_torch.models.sparse_exec import build_sparse_plans
    from tpuseg_torch.ops.fold_bn import fold_bn
    from tpuseg_torch.sparsity import apply_masks, create_masker

    masks = create_masker(config, seed=0).generate_masks(params)
    masked = apply_masks(params, masks)
    plans, report = build_sparse_plans(fold_bn(masked, state, spec), masks, spec,
                                       lowering=lowering, dtype=dtype)
    return masked, plans, report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import numpy as np

    from tpuseg_torch.data.shapes import shapes_video
    from tpuseg_torch.models.drnseg import bilinear_upsample_kernel, init_drnseg
    from tpuseg_torch.ops import _build
    from tpuseg_torch.ops.sparse_conv import fused_sparse_conv_apply
    from tpuseg_torch.ops.upsample import upsample_argmax, upsample_argmax_reference
    from tpuseg_torch.video.pipeline import SyntheticFrames, VideoSegmenter

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. card, versions, build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    _emit(phase="card", name=kind, nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0],
          device_count=torch.cuda.device_count())
    t0 = time.perf_counter()
    lib_path, log = _build.build_library()
    build_s = time.perf_counter() - t0
    _build.load_library()
    _emit(phase="build", seconds=round(build_s, 3), library=lib_path.split("/")[-1],
          ptxas=[ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "Compiling entry" in ln])

    # 2. kernel vs plain on the card: bit-equal ids
    rng = np.random.default_rng(0)
    sym = bilinear_upsample_kernel()
    f1 = rng.random(16).astype(np.float32) + 0.1
    asym = np.outer(f1, f1).astype(np.float32)
    checks = [
        ((4, 128, 256, 19), torch.bfloat16, "bilinear", sym),
        ((4, 128, 256, 19), torch.float32, "bilinear", sym),
        ((2, 17, 33, 19), torch.bfloat16, "asymmetric", asym),
        ((2, 17, 33, 19), torch.float32, "asymmetric", asym),
        ((1, 5, 7, 1), torch.float32, "bilinear", sym),
        ((1, 5, 7, 1), torch.bfloat16, "bilinear", sym),
        ((1, 9, 11, 255), torch.float32, "bilinear", sym),
        ((1, 9, 11, 255), torch.bfloat16, "bilinear", sym),
    ]
    max_abs_err = 0
    for shape, dtype, kname, k in checks:
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)
        got = upsample_argmax(x, k)
        want = upsample_argmax_reference(x, k)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (shape[0], 8 * shape[1], 8 * shape[2])
        assert got.dtype == want.dtype == torch.uint8
        err = int((got.int() - want.int()).abs().max().item())
        mism = int((got != want).sum().item())
        max_abs_err = max(max_abs_err, err)
        _emit(phase="kernel_vs_plain", shape=list(shape), dtype=str(dtype),
              up_kernel=kname, mismatches=mism, max_abs_err=err)
        if mism:
            raise AssertionError(f"kernel ids differ from the plain version at {shape} {dtype}")

    # 3. slice parity in f32: CUDA (kernel) vs CPU (plain versions)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    params, state, spec = init_drnseg(0, ARCH, CLASSES)
    small = list(SyntheticFrames(2, (256, 512), seed=0))
    ids = {}
    for name in ("cuda", "cpu"):
        seg = VideoSegmenter(params, state, spec, MEAN, STD, device=name,
                             compute_dtype=torch.float32, batch=2)
        ids[name] = seg.run(small, need_color=False)["ids"]
    agree = _agreement(ids["cuda"], ids["cpu"])
    _emit(phase="slice_parity_f32", tf32=False, size=[256, 512], frames=2,
          ids_agreement=agree, limit=0.999)
    if agree < 0.999:
        raise AssertionError(f"f32 CUDA vs CPU ids agreement {agree} < 0.999")

    # 4. the slice at full width and size
    t0 = time.perf_counter()
    frames = list(shapes_video(32, FULL, seed=0)[0])
    gen_s = time.perf_counter() - t0
    serve = VideoSegmenter(params, state, spec, MEAN, STD, device=dev,
                           compute_dtype=torch.bfloat16, batch=8)
    torch.cuda.synchronize()
    upsample_argmax.launches = 0
    res = serve.run(frames, need_color=False)
    torch.cuda.synchronize()
    launches = upsample_argmax.launches
    out = dense_ids = res["ids"]
    assert out.shape == (32,) + FULL and out.dtype == np.uint8, (out.shape, out.dtype)
    assert int(out.max()) < CLASSES
    if launches <= 0:
        raise AssertionError("the served slice never launched the upsample_argmax kernel")
    ref32 = VideoSegmenter(params, state, spec, MEAN, STD, device=dev,
                           compute_dtype=torch.float32, batch=8)
    agree_bf16 = _agreement(out, ref32.run(frames, need_color=False)["ids"])
    _emit(phase="slice_full", arch=ARCH, classes=CLASSES, size=list(FULL),
          dtype="bfloat16", batch=8, frames=res["frames"], run_fps=res["fps"],
          run_seconds=res["seconds"], launches=launches,
          bf16_vs_f32_ids_agreement=agree_bf16, limit=0.9,
          frame_gen_seconds=round(gen_s, 3))
    if agree_bf16 < 0.9:
        raise AssertionError(f"bf16 vs f32 ids agreement {agree_bf16} < 0.9")
    bench = VideoSegmenter(params, state, spec, MEAN, STD, device=dev,
                           compute_dtype=torch.bfloat16, batch=32)
    device_fps = bench.benchmark_device_fps(FULL)
    _emit(phase="device_fps", arch=ARCH, size=list(FULL), dtype="bfloat16",
          batch=32, device_fps=device_fps, card=smi)
    del serve, ref32, bench
    torch.cuda.empty_cache()

    # 5. kernel vs plain time at the serving shape, in turns
    x = torch.from_numpy(
        rng.normal(size=SERVING_LOGITS).astype(np.float32)).to(dev, torch.bfloat16)
    plain = [_time_ms(torch, lambda: upsample_argmax_reference(x, sym), 3)]
    kern = [_time_ms(torch, lambda: upsample_argmax(x, sym), 20) for _ in range(2)]
    plain.append(_time_ms(torch, lambda: upsample_argmax_reference(x, sym), 3))
    kernel_ms, plain_ms = min(kern), min(plain)
    _emit(phase="kernel_time", shape=list(SERVING_LOGITS), dtype="bfloat16",
          kernel_ms=kern, plain_ms=plain, card=smi)
    del x

    # 6. B2 vs plain on the card (f32 plain convs with TF32 off, set above)
    masked, plans, report = _pruned(torch, params, state, spec, SERVED_CONFIG, "pallas",
                                    torch.bfloat16)
    b2_err = _b2_vs_plain(torch, np, dev, rng, plans)
    torch.cuda.empty_cache()

    # 7. pruned slice parity in f32: CUDA (kernel) vs CPU (plain versions)
    pmasked, pplans, _ = _pruned(torch, params, state, spec, PARITY_CONFIG, "pallas",
                                 torch.float32)
    ids = {}
    for name in ("cuda", "cpu"):
        seg = VideoSegmenter(pmasked, state, spec, MEAN, STD, device=name,
                             compute_dtype=torch.float32, batch=2, exec_plans=pplans)
        ids[name] = seg.run(small, need_color=False)["ids"]
    agree = _agreement(ids["cuda"], ids["cpu"])
    _emit(phase="pruned_parity_f32", config=PARITY_CONFIG, lowering="pallas", tf32=False,
          size=[256, 512], frames=2, ids_agreement=agree, limit=0.999)
    if agree < 0.999:
        raise AssertionError(f"pruned f32 CUDA vs CPU ids agreement {agree} < 0.999")
    del seg

    # 8. the pruned slice at full width and size
    serve = VideoSegmenter(masked, state, spec, MEAN, STD, device=dev,
                           compute_dtype=torch.bfloat16, batch=8, exec_plans=plans)
    torch.cuda.synchronize()
    fused_sparse_conv_apply.launches = 0
    upsample_argmax.launches = 0
    res = serve.run(frames, need_color=False)
    torch.cuda.synchronize()
    b2_launches, up_launches = fused_sparse_conv_apply.launches, upsample_argmax.launches
    out = pruned_ids = res["ids"]
    assert out.shape == (32,) + FULL and out.dtype == np.uint8, (out.shape, out.dtype)
    assert int(out.max()) < CLASSES
    forwards = 1 + -(-len(frames) // 8)  # run()'s untimed first call + 4 batches
    if b2_launches != B2_PER_FORWARD * forwards or up_launches != forwards:
        raise AssertionError(f"pruned run launched B2 {b2_launches} and upsample_argmax "
                             f"{up_launches} times; want {B2_PER_FORWARD * forwards} "
                             f"and {forwards}")
    dense32 = VideoSegmenter(masked, state, spec, MEAN, STD, device=dev,
                             compute_dtype=torch.float32, batch=8)
    agree_dense = _agreement(out, dense32.run(frames, need_color=False)["ids"])
    _emit(phase="pruned_full", config=SERVED_CONFIG, lowering="pallas", size=list(FULL),
          dtype="bfloat16", batch=8, frames=res["frames"], run_fps=res["fps"],
          run_seconds=res["seconds"], b2_launches=b2_launches,
          upsample_launches=up_launches,
          lowered=sum(1 for v in report.values() if not v.startswith("dense")),
          vs_f32_masked_dense_ids_agreement=agree_dense, limit=0.9)
    if agree_dense < 0.9:
        raise AssertionError(f"pruned bf16 vs f32 masked dense agreement {agree_dense} < 0.9")
    del serve, dense32
    torch.cuda.empty_cache()
    _, gplans, _ = _pruned(torch, params, state, spec, SERVED_CONFIG, "gathered",
                           torch.bfloat16)
    variants = {"pallas": plans, "gathered_exact": gplans, "masked_dense": None}
    pruned_fps = {}
    for name, vplans in variants.items():
        bench = VideoSegmenter(masked, state, spec, MEAN, STD, device=dev,
                               compute_dtype=torch.bfloat16, batch=32, exec_plans=vplans)
        pruned_fps[name] = bench.benchmark_device_fps(FULL, inner=16, reps=2)
        del bench
        torch.cuda.empty_cache()
    _emit(phase="pruned_device_fps", config=SERVED_CONFIG, size=list(FULL), dtype="bfloat16",
          batch=32, device_fps=pruned_fps, card=smi)

    # 9. B2 vs plain vs the dense cuDNN conv at the layer.6.1.conv2 serving shape
    from tpuseg_torch.ops.sparse_conv import fused_sparse_conv_reference

    plan = plans["layer.6.1.conv2"].to(dev)
    (sn, sh, sw, sc), sk, sd = SERVING_SPARSE
    assert (plan.cin, plan.kernel, plan.dilation) == (sc, sk, sd), plan
    x = torch.from_numpy(rng.normal(size=(sn, sh, sw, sc)).astype(np.float32)).to(dev, torch.bfloat16)
    w_dense = masked["layer.6.1.conv2.weight"].to(dev, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    x_nchw = x.permute(0, 3, 1, 2)
    turns = _time_turns(torch, {
        "plain": lambda: fused_sparse_conv_reference(x, plan),
        "kernel": lambda: fused_sparse_conv_apply(x, plan),
        "dense_cudnn": lambda: torch.nn.functional.conv2d(x_nchw, w_dense, None, 1, sd, sd),
    }, {"plain": 3, "kernel": 10, "dense_cudnn": 10})
    b2_ms, b2_plain_ms = min(turns["kernel"]), min(turns["plain"])
    _emit(phase="b2_time", conv="layer.6.1.conv2", shape=[sn, sh, sw, sc], dilation=sd,
          s=plan.s, dtype="bfloat16", kernel_ms=turns["kernel"], plain_ms=turns["plain"],
          dense_cudnn_ms=turns["dense_cudnn"],
          kernel_tflops=2 * sn * sh * sw * sk * sk * plan.s * 128 * plan.cout / b2_ms / 1e9,
          card=smi)

    del x_nchw
    torch.cuda.empty_cache()

    # 10. B3 vs its exact plain version on the card, bit-equal
    from tpuseg_torch.ops.fold_bn import fold_bn
    from tpuseg_torch.ops.quant import build_quant_plans
    from tpuseg_torch.ops.sparse_conv import fused_sparse_conv_apply_q

    dense_int8 = build_quant_plans(fold_bn(params, state, spec), spec)
    served = _served_b3_packings(dense_int8, plans, gplans)
    b3_err = _b3_vs_plain(torch, np, dev, rng, served)
    del served
    torch.cuda.empty_cache()

    # 11. int8 slice parity in f32: CUDA (B3) vs CPU (plain versions)
    _int8_parity_f32(torch, np, {"dense": (params, None), "block128_75.00 pallas":
                                 (pmasked, pplans)}, state, spec, small)
    torch.cuda.empty_cache()

    # 12. int8 at full width and size: counts zeroed just before each run
    int8_variants = {  # label -> (params, float plans, calibration frames, float ids)
        "dense": (params, None, None, dense_ids),
        "dense_calibrated": (params, None, frames[:8], None),
        "pallas": (masked, plans, None, pruned_ids),
        "gathered": (masked, gplans, None, pruned_ids),
    }
    forwards = 1 + -(-len(frames) // 8)
    b3_launches = 0
    int8_ids = {}
    for label, (vparams, vplans, calib, float_ids) in int8_variants.items():
        serve = VideoSegmenter(vparams, state, spec, MEAN, STD, device=dev,
                               compute_dtype=torch.bfloat16, batch=8, exec_plans=vplans,
                               quantize=True, calib_frames=calib)
        kinds = Counter(type(p).__name__ for p in serve.exec_plans.values())
        if calib is not None:
            static = [n for n, p in serve.exec_plans.items() if p.x_scale is not None]
            if len(static) != 13 or len(serve.exec_plans) != 13:
                raise AssertionError(f"calibrated: {len(static)} of {len(serve.exec_plans)} "
                                     "int8 plans carry a static scale; want 13 of 13")
        torch.cuda.synchronize()
        fused_sparse_conv_apply_q.launches = 0
        fused_sparse_conv_apply.launches = 0
        upsample_argmax.launches = 0
        res = serve.run(frames, need_color=False)
        torch.cuda.synchronize()
        b3, b2, up = (fused_sparse_conv_apply_q.launches, fused_sparse_conv_apply.launches,
                      upsample_argmax.launches)
        out = res["ids"]
        assert out.shape == (32,) + FULL and out.dtype == np.uint8, (out.shape, out.dtype)
        assert int(out.max()) < CLASSES
        if b3 != B3_PER_FORWARD[label] * forwards or b2 != 0 or up != forwards:
            raise AssertionError(f"int8 {label}: B3 {b3}, B2 {b2}, upsample_argmax {up} "
                                 f"launches; want {B3_PER_FORWARD[label] * forwards}, 0, "
                                 f"{forwards}")
        b3_launches += b3
        int8_ids[label] = out
        ref_label, ref = (("float", float_ids) if float_ids is not None
                          else ("dynamic int8", int8_ids["dense"]))
        agree, limit = _agreement(out, ref), INT8_FULL_MIN[label]
        _emit(phase="int8_full", variant=label, size=list(FULL), dtype="bfloat16", batch=8,
              frames=res["frames"], run_fps=res["fps"], plans=kinds,
              calibrated_frames=0 if calib is None else len(calib), b3_launches=b3,
              b2_launches=b2, upsample_launches=up, ids_agreement=agree,
              agreement_with=ref_label, limit=limit)
        if agree < limit:
            raise AssertionError(f"int8 {label} vs {ref_label} ids agreement {agree} < {limit}")
        del serve
        torch.cuda.empty_cache()

    # 13. int8 device fps, and B3 vs plain vs B2 vs cuDNN at layer.6.1.conv2
    int8_fps = {}
    for label, (vparams, vplans, calib, _) in int8_variants.items():
        bench = VideoSegmenter(vparams, state, spec, MEAN, STD, device=dev,
                               compute_dtype=torch.bfloat16, batch=32, exec_plans=vplans,
                               quantize=True, calib_frames=calib)
        int8_fps[label] = bench.benchmark_device_fps(FULL, inner=16, reps=2)
        del bench
        torch.cuda.empty_cache()
    _emit(phase="int8_device_fps", size=list(FULL), dtype="bfloat16", batch=32,
          device_fps=int8_fps, card=smi)
    from tpuseg_torch.ops.quant import full_support_packing, quantize_weight
    from tpuseg_torch.ops.sparse_conv import (
        fused_sparse_conv_q_reference, quantize_activation, quantize_fused_plan)

    qplan = quantize_fused_plan(plans["layer.6.1.conv2"]).to(dev)
    w6 = masked["layer.6.1.conv2.weight"].numpy().transpose(2, 3, 1, 0)
    qdense = full_support_packing("layer.6.1.conv2", *quantize_weight(w6), sd, sd).to(dev)
    xq, xs = quantize_activation(x, None)
    out6 = torch.empty((sn, sh, sw, qplan.cout), device=dev)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def b3_kernel_only():
        err = lib.tpuseg_sparse_conv_q(
            xq.data_ptr(), qplan.vals_k.data_ptr(), qplan.rows.data_ptr(),
            qplan.w_scale.data_ptr(), xs.data_ptr(), out6.data_ptr(),
            sn, sh, sw, sc, qplan.cout, qplan.s, qplan.kernel, qplan.dilation, stream)
        assert err == 0, err

    x_nchw = x.permute(0, 3, 1, 2)
    turns = _time_turns(torch, {
        "b3_plain": lambda: fused_sparse_conv_q_reference(x, qplan),
        "b3": lambda: fused_sparse_conv_apply_q(x, qplan),
        "b3_kernel_only": b3_kernel_only,
        "quantize_pass": lambda: quantize_activation(x, None),
        "b2": lambda: fused_sparse_conv_apply(x, plan),
        "dense_cudnn": lambda: torch.nn.functional.conv2d(x_nchw, w_dense, None, 1, sd, sd),
        "b3_dense_s4": lambda: fused_sparse_conv_apply_q(x, qdense),
    }, {"b3_plain": 2, "b3": 10, "b3_kernel_only": 10, "quantize_pass": 10, "b2": 10,
        "dense_cudnn": 10, "b3_dense_s4": 5})
    b3_ms, b3_plain_ms = min(turns["b3"]), min(turns["b3_plain"])
    k_ms = min(turns["b3_kernel_only"])
    _emit(phase="b3_time", conv="layer.6.1.conv2", shape=[sn, sh, sw, sc], dilation=sd,
          s=qplan.s, x_dtype="bfloat16", ms=turns, card=smi,
          kernel_tops=2 * sn * sh * sw * sk * sk * qplan.s * 128 * qplan.cout / k_ms / 1e9,
          dense_s4_tops=2 * sn * sh * sw * sk * sk * sc * qplan.cout
          / (min(turns["b3_dense_s4"]) - min(turns["quantize_pass"])) / 1e9)

    _emit(phase="total", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": [{
        "name": "upsample_argmax",
        "route": "cuda",
        "source": "tpuseg_torch/csrc/upsample_argmax.cu",
        "replaces": "tpuseg/ops/upsample.py:91",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, {
        "name": "sparse_conv",
        "route": "cuda",
        "source": "tpuseg_torch/csrc/sparse_conv.cu",
        "replaces": "tpuseg/ops/sparse_conv.py:270",
        "launches": b2_launches,
        "max_abs_err": b2_err,
        "ms": b2_ms,
        "plain_ms": b2_plain_ms,
    }, {
        "name": "sparse_conv_q",
        "route": "cuda",
        "source": "tpuseg_torch/csrc/sparse_conv_q.cu",
        "replaces": "tpuseg/ops/sparse_conv.py:1294",
        "launches": b3_launches,
        "max_abs_err": b3_err,
        "ms": b3_ms,
        "plain_ms": b3_plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
