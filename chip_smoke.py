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
     batch-32 serving input; on each of those 7 the served bf16+bias route
     (one B2 launch writing bf16(bf16(y) + bias)) bit-equal to the two
     passes it replaces (B2's f32 y, cast, bias add); a non-contiguous
     input must raise;
  7. pruned slice parity in f32: block128_75.00 masks, Pallas lowering, f32
     plans, CUDA with the kernel vs CPU with the plain versions, ids
     agreement >= 0.999;
  8. the pruned slice at full width and size: block128reg_87.50, Pallas
     lowering, bf16; run() over 32 shapes frames at batch 8 (B2 launched
     exactly 7 times per forward, ids agreement with the f32 masked-dense
     path >= 0.9), then the device rate at batch 32 for the Pallas lowering,
     the gathered lowering and masked dense;
  9. B2 vs plain vs the dense cuDNN conv at the layer.6.1.conv2 serving shape,
     and the bf16+bias route vs the two passes it replaces;
 10. the quantize kernels (``csrc/quantize.cu``) vs ``quantize_activation``
     on the CPU, bit for bit on xq and xs (bf16 and f32, per-frame and
     static, with and without a channel map, a 40x frame and an all-zero
     frame; a NaN frame's scale NaN on both sides); the int8 block-sparse
     conv kernel (B3) vs its exact plain version, bit-equal: the CPU tests'
     shapes with per-frame and static scales, f32 and bf16 x; then every
     int8 plan the served configurations launch (13 ``QuantConv``, the 7
     lifted B2 plans of block128reg_87.50, ``CompactSparseQ`` through its
     channel map, one ``GatheredGroupConvQ``) at its batch-32 serving input,
     on the f32 route and on the served bf16+bias route (0 mismatches
     against the plain f32 y cast and biased); a non-contiguous input must
     raise;
 11. int8 slice parity in f32 (TF32 off), dense and block128_75.00 Pallas:
     every int8 conv's CUDA output is bit-equal to the CPU plain version on
     the activation the CUDA run gave it, and CUDA vs CPU ids agree >= 0.97;
 12. int8 at full width and size, bf16, batch 8, 32 frames: dense (per-frame
     scales), dense calibrated on 8 frames, block128reg_87.50 under the
     Pallas and the gathered lowering; B3 launched exactly 13 / 13 / 11 / 13
     times per forward and B2 never, the quantize kernel once per B3 launch
     and the absmax kernel too except in the calibrated run (0); ids
     agreement with the float runs and calibrated vs dynamic >=
     INT8_FULL_MIN (0.9 dense, 0.85 pruned);
 13. device fps at batch 32 of those four int8 variants, and at
     layer.6.1.conv2: B3's served route (quantize + B3 with its bf16+bias
     epilogue), B3 alone (bf16 and f32 out), the quantize kernels alone
     (per-frame and static), their plain versions, B2, the dense cuDNN bf16
     conv with bias (context only: no PyTorch call computes an int8 conv on
     CUDA) and the dense S=4 conv through B3's served route;
 14. B4 (``bsr_matmul_xw``, B2's kernel at k=1) and ``sparse_conv_apply``
     vs their plain versions (TF32 off): the CPU tests' cases in f32 and
     bf16, x (32768, 512) and (1048576, 512) bf16 against a 512x512
     BlockPruner 87.5 % weight, the bench's 3x3 d=2 and 1x1 convs at each of
     its sparsities at batch 1 and the 3x3 at 87.5 % at batch 32, with B4
     launched exactly once per tap; a non-contiguous x must raise;
 15. B5/B6 (``bsr_matmul``, ``bsr_matmul_gathered``: ``csrc/bsr_matmul.cu``)
     vs their plain version: the CPU tests' cases (ragged rows, an empty
     row, an all-zero W, a ragged N through the non-TMA path), and a
     512x512 87.5 % W, which has empty rows, on x (512, 32768) and
     (512, 1048576) bf16;
 16. B7a-f (B2's kernel on their packings) vs ``fused_sparse_conv_reference``
     on the same packing: the CPU tests' kinds, every plan the bench's fused
     mode launches (each sparsity, the all-ones shared plan) at batch 1, and
     the 87.5 % plans at batch 32;
 17. this slice's paths with every launch count zeroed just before and read
     just after: ``python -m tpuseg_torch.bench_sparse --fused``'s
     ``main`` (the bench's main and fused modes: B2, B3, B4, B7a-f) and one
     call each of ``bsr_matmul`` and ``bsr_matmul_gathered`` at the batch-32
     shape; exact launch counts;
 18. B4, B5, B6 and B7a-f at their batch-32 shapes in turns against their
     plain versions and one PyTorch call of the same function (for B4-B6
     ``torch.mm(..., out_dtype=torch.float32)`` of the masked dense bf16 W,
     which writes the f32 y they write, beside the bf16-out
     ``torch.matmul``; for B7 the masked dense cuDNN conv), a yardstick the
     port never calls.
The line before the last is the kernels' JSON record (each kernel's time,
its plain version's, its bound at the card's published peaks and the
PyTorch call's, at its main shape; B3's time is its served route, the
``quantize`` entry the quantize kernels' per-frame pass); the last line is
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
# The card's published peaks (NVIDIA H100 SXM data sheet, dense rates, at
# the full 700 W): each kernel's bound is the larger of its bytes (each
# input the function needs read once: the nonzero 128x128 weight tiles and
# the input channel blocks they read; each output written once) over the
# memory rate and its operations (those nonzero tiles' products) over the
# peak of their type.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
# slice 4: the bench's conv (bench_sparse's layer-6 shape) at batch 1 and 32
BENCH_BATCH32 = (32, 128, 256, 512)
P32 = 32 * 128 * 256  # pixels of the batch-32 conv, the rows of B4's x
B7_ENTRIES = {  # entry point -> (ROADMAP id, packing, tpuseg/ops/sparse_conv.py line)
    "shared_sparse_conv_apply": ("B7a", "shared", 450),
    "fused_phase_sparse_conv_apply": ("B7b", "fused", 555),
    "imcol_phase_sparse_conv_apply": ("B7c", "fused", 684),
    "cphase_sparse_conv_apply": ("B7d", "fused", 826),
    "phase_sparse_conv_apply": ("B7e", "shared", 952),
    "shared_concat_sparse_conv_apply": ("B7f", "shared", 1091),
}


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


def _bound(nbytes: float, ops: float, peak: str) -> tuple[float, str]:
    """(ms, what bounds it): the larger of bytes / memory rate and
    operations / the peak of their type."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _live_tiles(vals) -> int:
    """Nonzero 128x128 weight tiles of a packing's ``vals`` (every packing
    stacks its tiles as 128-row slices of a (..., 128) tensor)."""
    return int((vals.reshape(-1, 128 * 128) != 0).any(1).sum())


def _live_in_blocks(vals, rows) -> int:
    """The 128-channel in-blocks that some nonzero tile of a B2-layout
    packing reads: ``rows`` (nmb, S) names each slot's in-block, ``vals``
    (nmb, T*S*128, 128) holds T tiles per slot.  Only these blocks of x
    enter the function, so a bound counts only their bytes."""
    nmb, s = rows.shape
    live = (vals.reshape(nmb, -1, s, 128 * 128) != 0).any(-1).any(1)  # (nmb, S)
    return len(set(rows[live].tolist()))


def _b2_bound(pixels: int, vals, rows, out_channels: int) -> tuple[float, str]:
    """Bound of B2's function on a bf16 packing over ``pixels`` output
    pixels: the bf16 x of the in-blocks live tiles read, the live tiles and
    ``rows`` read once, the f32 y written once; 2*128*128 operations per
    live tile and pixel."""
    live = _live_tiles(vals)
    return _bound(pixels * _live_in_blocks(vals, rows) * 128 * 2 + live * 128 * 128 * 2
                  + rows.numel() * 4 + pixels * out_channels * 4,
                  2 * pixels * live * 128 * 128, "bf16")


def _close(torch, np, phase, got, want, k_len, **info) -> float:
    """Raise unless ``got`` is within 2*K*eps of ``want`` relative to
    max|want| (never looser than 1e-3), K the contraction length: two f32
    sums of the same exact products in other orders.  Returns the max abs
    error."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32, (
        got.shape, want.shape, got.dtype, want.dtype)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    tol = min(1e-3, 2 * k_len * float(np.finfo(np.float32).eps))
    rel = err / scale if scale > 0 else err
    _emit(phase=phase, max_abs_err=err, rel_err=rel, tol_rel=tol, max_abs_want=scale, **info)
    if (scale == 0 and err != 0) or rel > tol:
        raise AssertionError(f"{phase}: kernel differs from its plain version: {rel} > {tol} "
                             f"({info})")
    return err


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


def _b2_vs_plain(torch, np, dev, rng, served: dict, folded: dict) -> float:
    """Phase 6: B2 on the card vs its plain version on the same inputs: the
    CPU tests' shapes and kinds, then every B2 plan of ``served`` (the
    FusedSparseConv plans and each CompactSparse's inner plan) at its
    batch-32 serving input, and on each the served bf16+bias route
    (``models/drn.py``, ``folded``'s bias) bit-equal to the two passes."""
    from tpuseg_torch.models import drn as tdrn
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
        # the served bf16 route vs the two passes, on the conv's full input
        pd = p.to(dev)
        cin = folded[f"{name}.weight"].shape[1]
        x = tdrn.nhwc_to_nchw(torch.randn((n, h, w, cin), generator=gen, device=dev,
                                          dtype=torch.bfloat16))
        bias = folded[f"{name}.bias"].to(dev)
        got = tdrn._sparse_conv_bias_bf16(x, pd, bias)
        want = (tdrn._sparse_conv(x, pd, None).to(torch.bfloat16)
                + bias.to(torch.bfloat16).view(1, -1, 1, 1))
        torch.cuda.synchronize()
        mism = int((got.view(torch.int16) != want.view(torch.int16)).sum())
        _emit(phase="b2_bf16_bias_route", conv=name, kind=type(p).__name__,
              shape=[n, h, w, cin], mismatches=mism, max_abs_want=float(want.abs().max()))
        if mism or got.shape != want.shape or got.dtype != torch.bfloat16:
            raise AssertionError(f"{name}: the bf16+bias route differs from the two passes "
                                 f"in {mism} values")
        del x, got, want
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


def _quantize_vs_cpu(torch, np, dev, rng) -> float:
    """Phase 10: the quantize kernels (``quantize_activation`` on the card)
    vs ``quantize_activation`` on the CPU, bit for bit on xq and xs: bf16
    and f32, per-frame and static, a frame of 40x the range and an all-zero
    frame, with and without a channel map; a frame holding a NaN must get a
    NaN scale on both sides (its xq is not compared: PyTorch's cast of a NaN
    to int8 is undefined).  -> the max |difference| of xq (0)."""
    from tpuseg_torch.ops.sparse_conv import quantize_activation

    x = torch.from_numpy(rng.normal(size=(4, 32, 48, 384)).astype(np.float32))
    x[1] *= 40.0
    x[2] = 0.0
    x[3, 7, 9, 300] = float("nan")
    chan = torch.cat([torch.arange(128), torch.arange(256, 384)]).to(torch.int32)
    worst = 0
    for dtype in (torch.float32, torch.bfloat16):
        for x_scale in (None, 0.013):
            for cmap in (None, chan):
                xd = x.to(dev, dtype)
                before = (quantize_activation.launches, quantize_activation.absmax_launches)
                xq_d, xs_d = quantize_activation(
                    xd, x_scale, None if cmap is None else cmap.to(dev))
                torch.cuda.synchronize()
                launched = (quantize_activation.launches - before[0],
                            quantize_activation.absmax_launches - before[1])
                xq_c, xs_c = quantize_activation(x.to(dtype), x_scale, cmap)
                xq_d, xs_d = xq_d.cpu(), xs_d.cpu()
                same = (torch.equal(xq_d[:3], xq_c[:3]) and torch.equal(xs_d[:3], xs_c[:3])
                        and xs_d[3].isnan() == xs_c[3].isnan()
                        and (x_scale is not None or bool(xs_d[3].isnan())))
                if x_scale is not None:
                    same = same and torch.equal(xs_d[3], xs_c[3])
                err = int((xq_d[:3].int() - xq_c[:3].int()).abs().max())
                worst = max(worst, err)
                _emit(phase="b3_quantize_pass_vs_cpu", x_dtype=str(dtype), shape=list(x.shape),
                      scale="static" if x_scale else "per-frame",
                      channel_map=cmap is not None, bit_equal=same, max_abs_err=err,
                      nan_frame_scale=float(xs_d[3]), launches=launched)
                if not same:
                    raise AssertionError(f"the quantize kernels differ from the CPU "
                                         f"({dtype}, {x_scale}, map {cmap is not None})")
                if launched != (1, 0 if x_scale is not None else 1):
                    raise AssertionError(f"quantize launches {launched}")
    return float(worst)


def _b3_vs_plain(torch, np, dev, rng, served: dict) -> float:
    """Phase 10: B3 on the card vs its exact plain version on the same
    inputs, bit for bit: the CPU tests' kinds, then each int8 plan the served
    configurations launch (``served``: label -> (plan, x channels)) at its
    batch-32 input, on the f32 route and on the served bf16+bias route
    (``models/drn.py``; 0 mismatches against the plain f32 y cast and
    biased)."""
    from tpuseg_torch.models import drn as tdrn
    from tpuseg_torch.models.sparse_exec import CompactSparseQ
    from tpuseg_torch.ops.sparse_conv import (
        cast_bias_bf16, fused_sparse_conv_apply_q, fused_sparse_conv_q_reference,
        plan_fused_sparse_conv, quantize_fused_plan)

    worst = 0.0

    def check(x, plan, case, chan=None):
        nonlocal worst
        got = fused_sparse_conv_apply_q(x, plan, chan=chan)
        want = fused_sparse_conv_q_reference(
            x if chan is None else x.index_select(3, chan), plan)
        torch.cuda.synchronize()
        assert got.shape == want.shape == tuple(x.shape[:3]) + (plan.cout,)
        assert got.dtype == want.dtype == torch.float32
        mism = int((got != want).sum())
        err = float((got - want).abs().max())
        worst = max(worst, err)
        _emit(phase="b3_vs_plain", shape=list(x.shape), x_dtype=str(x.dtype), k=plan.kernel,
              dilation=plan.dilation, cout=plan.cout, s=plan.s,
              live_steps=int(plan.nsteps.sum()), scale="static" if plan.x_scale is not None
              else "per-frame", case=case, mismatches=mism, max_abs_err=err,
              max_abs_want=float(want.abs().max()))
        if mism:
            raise AssertionError(f"B3 differs from its plain version in {mism} values at "
                                 f"{list(x.shape)} k={plan.kernel} d={plan.dilation} "
                                 f"S={plan.s} ({case})")
        return want

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
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n, h, w = SERVING_SPARSE[0][:3]
    for label, (plan, cin) in served.items():
        plan = plan.to(dev)
        if isinstance(plan, CompactSparseQ):
            packing, chan = plan.inner, plan.live_in32
        else:
            packing, chan = getattr(plan, "packed", plan), None
        x = torch.randn((n, h, w, cin), generator=gen, device=dev, dtype=torch.bfloat16)
        want = check(x, packing, f"{label} serving input", chan)
        bias = torch.randn((packing.cout,), generator=gen, device=dev).to(torch.bfloat16)
        got = tdrn._sparse_conv_bias_bf16(tdrn.nhwc_to_nchw(x), plan, bias)
        got = tdrn.nchw_to_nhwc(got)
        want = cast_bias_bf16(want, bias)
        torch.cuda.synchronize()
        mism = int((got.view(torch.int16) != want.view(torch.int16)).sum())
        _emit(phase="b3_bf16_bias_route", plan=label, kind=type(plan).__name__,
              shape=[n, h, w, cin], mismatches=mism, max_abs_want=float(want.float().abs().max()))
        if mism or got.shape != want.shape or got.dtype != torch.bfloat16:
            raise AssertionError(f"{label}: the int8 bf16+bias route differs from its plain "
                                 f"version in {mism} values")
        del x, got, want
        torch.cuda.empty_cache()
    x = torch.zeros((1, packing.cin, 16, 24), device=dev,
                    dtype=torch.bfloat16).permute(0, 2, 3, 1)  # NHWC view of NCHW memory
    try:
        fused_sparse_conv_apply_q(x, packing)
    except ValueError:
        pass
    else:
        raise AssertionError("B3 accepted a non-contiguous NHWC view")
    return worst


def _served_b3_plans(dense_plans: dict, pallas_plans: dict, gathered_plans: dict,
                     folded: dict) -> dict:
    """label -> (int8 plan, its input's channels) for every B3 plan the
    served int8 configurations launch: the 13 dense ``QuantConv``s, the 7
    lifted B2 plans of the Pallas lowering (3 ``FusedSparseConvQ``, 4
    ``CompactSparseQ`` whose channel map gathers the survivors), and the
    ``GatheredGroupConvQ`` of layer.6.1.conv2."""
    from tpuseg_torch.models.sparse_exec import quantize_sparse_plans
    from tpuseg_torch.ops.gathered_conv import GatheredGroupConvQ

    def cin(name):
        return folded[f"{name}.weight"].shape[1]

    out = {f"{n} QuantConv": (p, cin(n)) for n, p in dense_plans.items()}
    for n, p in quantize_sparse_plans(pallas_plans).items():
        if type(p).__name__ in ("FusedSparseConvQ", "CompactSparseQ"):
            out[f"{n} {type(p).__name__}"] = (p, cin(n))
    g = quantize_sparse_plans({"layer.6.1.conv2": gathered_plans["layer.6.1.conv2"]})
    assert isinstance(g["layer.6.1.conv2"], GatheredGroupConvQ)
    out["layer.6.1.conv2 GatheredGroupConvQ"] = (g["layer.6.1.conv2"], cin("layer.6.1.conv2"))
    want = B3_PER_FORWARD["dense"] + B2_PER_FORWARD + 1
    if len(out) != want:
        raise AssertionError(f"{len(out)} served B3 plans; want {want}")
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


def _bench_problem(torch, dev, smi):
    """The bench's problem: (3x3 OIHW weight, 1x1 OIHW weight, x (1, 128,
    256, 512) bf16 on the card), drawn as ``tpuseg_torch.bench_sparse``
    draws them."""
    from tpuseg_torch import bench_sparse

    rng, w, x = bench_sparse.Bench(dev, smi).problem()
    return w, bench_sparse.conv1x1_weight(rng), x


def _matrix_mask(np, rng, shape, sparsity=0.875):
    """A (rows, cols) weight and its BlockPruner 128x128 mask."""
    from tpuseg_torch.sparsity.block import BlockConfig, prune_as_block

    w = (rng.normal(size=shape) * 0.05).astype(np.float32)
    return w, prune_as_block(w, BlockConfig(sparsity, 128, 128, -1, -1, True))


def _b4_vs_plain(torch, np, dev, rng, smi) -> float:
    """Phase 14: B4 and sparse_conv_apply vs their plain versions."""
    from tpuseg_torch import bench_sparse
    from tpuseg_torch.ops import sparse_conv as sc

    worst = 0.0

    def check(x, packed, case):
        nonlocal worst
        got, want = sc.bsr_matmul_xw(x, packed), sc.bsr_matmul_xw_reference(x, packed)
        worst = max(worst, _close(torch, np, "b4_vs_plain", got, want, packed.s * 128,
                                  case=case, shape=list(x.shape), dtype=str(x.dtype)))

    def block_w(K, M, density, dead_col=False):
        nz = (rng.random((K // 128, M // 128)) < density).astype(np.float32)
        nz[0] = 1
        if dead_col:
            nz[:, 1] = 0
        return rng.normal(size=(K, M)).astype(np.float32) * np.kron(
            nz, np.ones((128, 128), np.float32))

    cases = [  # (P, K, M, density, kind): the CPU tests' kinds
        (256, 256, 384, 0.4, ""), (200, 256, 384, 0.4, "ragged P"),
        (384, 512, 256, 0.5, ""), (300, 384, 512, 0.5, "dead column"),
        (130, 384, 512, 0.0, "all-zero W"), (257, 384, 512, 1.0, "full support"),
    ]
    for P, K, M, density, kind in cases:
        wkm = block_w(K, M, density, dead_col=kind == "dead column")
        if kind == "all-zero W":
            wkm[:] = 0
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.normal(size=(P, K)).astype(np.float32)).to(dev, dtype)
            check(x, sc.pack_xw_bsr(wkm, dtype).to(dev), kind)
    w2, m2 = _matrix_mask(np, rng, (512, 512))
    packed = sc.pack_xw_bsr(w2 * m2).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    for P in (32768, P32):
        x = torch.randn((P, 512), generator=gen, device=dev, dtype=torch.bfloat16)
        check(x, packed, "BlockPruner 87.5 %")
    del x
    # sparse_conv_apply: the CPU tests' cases, then the bench's conv
    for (k, d), dtype in [((1, 1), torch.float32), ((3, 1), torch.float32),
                          ((3, 2), torch.float32), ((3, 2), torch.bfloat16)]:
        wk = rng.normal(size=(256, 256, k, k)).astype(np.float32)
        mk = np.broadcast_to(np.kron(np.array([[1, 1], [0, 1]], np.float32),
                                     np.ones((128, 128), np.float32))[:, :, None, None],
                             wk.shape).copy()
        plan = sc.plan_sparse_conv(wk, mk, dtype=dtype).to(dev)
        x = torch.from_numpy(rng.normal(size=(1, 8, 16, 256)).astype(np.float32)).to(dev, dtype)
        _close(torch, np, "sparse_conv_apply_vs_plain", sc.sparse_conv_apply(x, plan, d),
               sc.sparse_conv_reference(x, plan, d), sum(t[2].s for t in plan.taps) * 128,
               k=k, dilation=d, dtype=str(dtype), shape=list(x.shape))

    def check_conv(x, plan, dilation, case):
        torch.cuda.synchronize()
        sc.bsr_matmul_xw.launches = 0
        got = sc.sparse_conv_apply(x, plan, dilation=dilation)
        torch.cuda.synchronize()
        launches = sc.bsr_matmul_xw.launches
        _close(torch, np, "sparse_conv_apply_vs_plain", got,
               sc.sparse_conv_reference(x, plan, dilation),
               sum(t[2].s for t in plan.taps) * 128, k=plan.kernel, dilation=dilation,
               dtype="torch.bfloat16", shape=list(x.shape), density=plan.density,
               dense_taps=sum(t[3] for t in plan.taps), b4_launches=launches, case=case)
        if launches != len(plan.taps):
            raise AssertionError(f"sparse_conv_apply launched B4 {launches} times for "
                                 f"{len(plan.taps)} taps")

    # the bench's main mode: the 3x3 d=2 and the 1x1 conv at each sparsity,
    # batch 1; then the 3x3 at 87.5 % at batch 32
    w, w1, x1 = _bench_problem(torch, dev, smi)
    for sparsity in bench_sparse.SPARSITIES:
        for wk, d in ((w, 2), (w1, 1)):
            plan = sc.plan_sparse_conv(wk, bench_sparse.block_mask(wk, sparsity)).to(dev)
            check_conv(x1, plan, d, f"bench {wk.shape[2]}x{wk.shape[3]} {sparsity * 100} %, "
                       "batch 1")
    x = torch.randn(BENCH_BATCH32, generator=gen, device=dev, dtype=torch.bfloat16)
    check_conv(x, sc.plan_sparse_conv(w, bench_sparse.block_mask(w, 0.875)).to(dev), 2,
               "bench 3x3 87.5 %, batch 32")
    del x
    try:
        sc.bsr_matmul_xw(torch.zeros((512, 64), device=dev, dtype=torch.bfloat16).t(), packed)
    except ValueError:
        pass
    else:
        raise AssertionError("B4 accepted a non-contiguous x")
    torch.cuda.empty_cache()
    return worst


def _b56_vs_plain(torch, np, dev, rng) -> dict:
    """Phase 15: B5/B6 vs their plain version; -> entry -> max abs error."""
    from tpuseg_torch.ops import bsr

    worst = {"bsr_matmul": 0.0, "bsr_matmul_gathered": 0.0}

    def check(packed, x, case):
        want = bsr.bsr_matmul_reference(packed, x)
        for name in worst:
            got = getattr(bsr, name)(packed, x)
            worst[name] = max(worst[name], _close(
                torch, np, "b56_vs_plain", got, want, 128 * max(packed.max_nnzb_row, 1),
                entry=name, case=case, w=list(packed.shape), x=list(x.shape),
                dtype=str(x.dtype), block_density=packed.block_density))
            del got

    def kron(c):
        return np.kron(np.asarray(c, np.float32), np.ones((128, 128), np.float32))

    cases = [  # (M, K, N, coarse mask or density, kind): the CPU tests' kinds
        (256, 512, 256, 0.25, ""), (256, 512, 256, 0.5, ""), (256, 512, 256, 1.0, ""),
        (384, 384, 128, [[1, 0, 0], [1, 1, 1], [0, 1, 0]], "ragged rows"),
        (384, 512, 256, [[0, 1, 0, 1], [0, 0, 0, 0], [1, 1, 1, 0]], "empty row"),
        (256, 256, 128, [[0, 0], [0, 0]], "all-zero W"),
        (384, 384, 37, [[1, 0, 0], [1, 1, 1], [0, 1, 0]], "ragged N"),
    ]
    for M, K, N, mask, kind in cases:
        if not isinstance(mask, list):
            mask = (rng.random((M // 128, K // 128)) < mask).astype(np.float32)
            mask[:, 0] = 1
        w = rng.normal(size=(M, K)).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            packed = bsr.pack_bsr(w, kron(mask), dtype=dtype).to(dev)
            x = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).to(dev, dtype)
            check(packed, x, kind)
    w, m = _matrix_mask(np, rng, (512, 512))
    packed = bsr.pack_bsr(w, m).to(dev)
    if not (np.diff(packed.rowptr) == 0).any():
        raise AssertionError("the 87.5 % W has no empty row block")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for n in (32768, P32):
        x = torch.randn((512, n), generator=gen, device=dev, dtype=torch.bfloat16)
        check(packed, x, "BlockPruner 87.5 %, empty rows")
    del x
    torch.cuda.empty_cache()
    return worst


def _b7_vs_plain(torch, np, dev, rng, smi) -> dict:
    """Phase 16: each B7 entry point vs fused_sparse_conv_reference on the
    packing it takes; -> entry -> max abs error."""
    from tpuseg_torch import bench_sparse
    from tpuseg_torch.ops import sparse_conv as sc

    worst = {name: 0.0 for name in B7_ENTRIES}

    def check(x, plans, case):
        for packing, plan in plans.items():
            want = sc.fused_sparse_conv_reference(x, plan)
            k_len = plan.kernel * plan.kernel * plan.s * 128
            for name, (_, pk, _) in B7_ENTRIES.items():
                if pk != packing:
                    continue
                got = getattr(sc, name)(x, plan)
                worst[name] = max(worst[name], _close(
                    torch, np, "b7_vs_plain", got, want, k_len, entry=name, case=case,
                    shape=list(x.shape), dtype=str(x.dtype), s=plan.s))
                del got
            del want

    def plans(w, m, d, dtype):
        return {"shared": sc.plan_shared_sparse_conv(w, m, d, dtype).to(dev),
                "fused": sc.plan_fused_sparse_conv(w, m, d, dtype).to(dev)}

    def kron_mask(nz, k, cout, cin):
        m2 = np.kron(np.asarray(nz, np.float32).T, np.ones((128, 128), np.float32))
        return np.broadcast_to(m2[:, :, None, None], (cout, cin, k, k)).copy()

    # the CPU tests' kinds: test_sparse_conv.py's mask at d = 1, 2; an odd
    # grid with a per-tap hole and a dead out-block
    w = rng.normal(size=(256, 512, 3, 3)).astype(np.float32)
    m = kron_mask([[0, 1], [1, 0], [0, 0], [0, 1]], 3, 256, 512)
    for d in (1, 2):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.normal(size=(2, 8, 16, 512)).astype(np.float32)).to(dev, dtype)
            check(x, plans(w, m, d, dtype), f"d={d}")
    w = (rng.normal(size=(384, 384, 3, 3)) * 0.1).astype(np.float32)
    m = kron_mask([[1, 0, 0], [0, 0, 0], [1, 1, 0]], 3, 384, 384)
    m[:128, :, 0, 1] = 0
    x = torch.from_numpy(rng.normal(size=(2, 7, 10, 384)).astype(np.float32)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        check(x.to(dtype), plans(w, m, 2, dtype), "odd grid, per-tap hole, dead out-block")
    # the bench's conv at batch 1 on every plan bench_fused launches (each
    # sparsity, and the shared plan of an all-ones mask), then at batch 32
    w, _, x1 = _bench_problem(torch, dev, smi)
    bench_plans = {sparsity: plans(w, bench_sparse.block_mask(w, sparsity), 2, torch.bfloat16)
                   for sparsity in bench_sparse.SPARSITIES}
    for sparsity, p in bench_plans.items():
        check(x1, p, f"bench {sparsity * 100} %, batch 1")
    check(x1, {"shared": sc.plan_shared_sparse_conv(w, np.ones_like(w), 2).to(dev)},
          "bench all-ones mask, batch 1")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    x = torch.randn(BENCH_BATCH32, generator=gen, device=dev, dtype=torch.bfloat16)
    check(x, bench_plans[0.875], "bench 87.5 %, batch 32")
    del x
    torch.cuda.empty_cache()
    return worst


def _slice4_paths(torch, dev) -> dict:
    """Phase 17: this slice's paths, every launch count zeroed just before
    and read just after: the bench's main and fused modes
    (``tpuseg_torch.bench_sparse.main(["--fused"])``), then one call each of
    ``bsr_matmul`` and ``bsr_matmul_gathered`` at the batch-32 shape.
    -> entry -> launches."""
    import numpy as np

    from tpuseg_torch import bench_sparse
    from tpuseg_torch.ops import bsr
    from tpuseg_torch.ops import sparse_conv as sc

    bench_entries = [sc.bsr_matmul_xw, sc.fused_sparse_conv_apply, sc.fused_sparse_conv_apply_q,
                     *(getattr(sc, name) for name in B7_ENTRIES)]
    torch.cuda.synchronize()
    for e in bench_entries:
        e.launches = 0
    t0 = time.perf_counter()
    rc = bench_sparse.main(["--fused"])
    torch.cuda.synchronize()
    launches = {e.__name__: e.launches for e in bench_entries}
    bench_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"bench_sparse --fused returned {rc}")
    # per timed function: one untimed and three timed loops of INNER calls
    calls = 4 * bench_sparse.INNER
    n_sp = len(bench_sparse.SPARSITIES)
    want = {name: calls * n_sp for name in launches}
    want["bsr_matmul_xw"] = calls * n_sp * (1 + bench_sparse.K * bench_sparse.K)  # a launch per tap
    want["phase_sparse_conv_apply"] += calls  # the density-1.0 probe
    _emit(phase="slice4_bench_path", command="python -m tpuseg_torch.bench_sparse --fused",
          seconds=round(bench_s, 3), launches=launches, want=want)
    if launches != want:
        raise AssertionError(f"bench launches {launches}; want {want}")
    rng = np.random.default_rng(4)
    w, m = _matrix_mask(np, rng, (512, 512))
    packed = bsr.pack_bsr(w, m).to(dev)
    x = torch.randn((512, P32), device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    bsr.bsr_matmul.launches = bsr.bsr_matmul_gathered.launches = 0
    y5 = bsr.bsr_matmul(packed, x)
    y6 = bsr.bsr_matmul_gathered(packed, x)
    torch.cuda.synchronize()
    launches.update(bsr_matmul=bsr.bsr_matmul.launches,
                    bsr_matmul_gathered=bsr.bsr_matmul_gathered.launches)
    ok = bool(torch.isfinite(y5).all()) and torch.equal(y5, y6) and y5.shape == (512, P32)
    _emit(phase="slice4_bsr_path", w=[512, 512], x=[512, P32], finite_and_equal=ok,
          launches={k: launches[k] for k in ("bsr_matmul", "bsr_matmul_gathered")})
    if not ok or launches["bsr_matmul"] != 1 or launches["bsr_matmul_gathered"] != 1:
        raise AssertionError("bsr_matmul / bsr_matmul_gathered path failed")
    del x, y5, y6
    torch.cuda.empty_cache()
    return launches


def _slice4_times(torch, np, dev, smi) -> dict:
    """Phase 18: B4, B5, B6 and B7a-f at their batch-32 shapes, in turns
    (plain, kernels, library, library, kernels, plain), with each one's
    bound.  -> kernel name -> {ms, plain_ms, library_ms, bound_ms, bound_by}."""
    import torch.nn.functional as F

    from tpuseg_torch import bench_sparse
    from tpuseg_torch.ops import bsr
    from tpuseg_torch.ops import sparse_conv as sc

    out = {}
    rng = np.random.default_rng(5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    # B4 and sparse_conv_apply
    w2, m2 = _matrix_mask(np, rng, (512, 512))
    packed = sc.pack_xw_bsr(w2 * m2).to(dev)
    wd = torch.from_numpy(w2 * m2).to(dev, torch.bfloat16)
    x = torch.randn((P32, 512), generator=gen, device=dev, dtype=torch.bfloat16)
    turns = _time_turns(torch, {
        "plain": lambda: sc.bsr_matmul_xw_reference(x, packed),
        "kernel": lambda: sc.bsr_matmul_xw(x, packed),
        "library": lambda: torch.mm(x, wd, out_dtype=torch.float32),
        "library_bf16_out": lambda: torch.matmul(x, wd),
    }, {"plain": 2, "kernel": 10, "library": 10, "library_bf16_out": 10})
    out["bsr_matmul_xw"] = {
        "ms": min(turns["kernel"]), "plain_ms": min(turns["plain"]),
        "library_ms": min(turns["library"]), "library_bf16_out_ms": min(turns["library_bf16_out"]),
        **dict(zip(("bound_ms", "bound_by"), _b2_bound(P32, packed.vals, packed.rows, 512)))}
    _emit(phase="b4_time", x=list(x.shape), w="512x512 BlockPruner 87.5 %", s=packed.s,
          live_tiles=_live_tiles(packed.vals),
          live_in_blocks=_live_in_blocks(packed.vals, packed.rows), turns=turns,
          **out["bsr_matmul_xw"], card=smi)
    del x
    # B5 and B6
    bpacked = bsr.pack_bsr(w2, m2).to(dev)
    wdm = torch.from_numpy(w2 * m2).to(dev, torch.bfloat16)
    x = torch.randn((512, P32), generator=gen, device=dev, dtype=torch.bfloat16)
    turns = _time_turns(torch, {
        "plain": lambda: bsr.bsr_matmul_reference(bpacked, x),
        "bsr_matmul": lambda: bsr.bsr_matmul(bpacked, x),
        "bsr_matmul_gathered": lambda: bsr.bsr_matmul_gathered(bpacked, x),
        "library": lambda: torch.mm(wdm, x, out_dtype=torch.float32),
        "library_bf16_out": lambda: torch.matmul(wdm, x),
    }, {"plain": 2, "bsr_matmul": 10, "bsr_matmul_gathered": 10, "library": 10,
        "library_bf16_out": 10})
    # the x rows of the K-blocks that live tiles read, the live tiles, the
    # CSR and the f32 y
    live = (bpacked.vals.reshape(len(bpacked.colidx), -1) != 0).any(1).cpu().numpy()
    b56_in_blocks = len(set(bpacked.colidx[live].tolist()))
    b56 = dict(zip(("bound_ms", "bound_by"), _bound(
        b56_in_blocks * 128 * P32 * 2 + int(live.sum()) * 128 * 128 * 2
        + (bpacked.nrb + 1 + len(bpacked.colidx)) * 4 + 512 * P32 * 4,
        2 * P32 * int(live.sum()) * 128 * 128, "bf16")))
    for name in ("bsr_matmul", "bsr_matmul_gathered"):
        out[name] = {"ms": min(turns[name]), "plain_ms": min(turns["plain"]),
                     "library_ms": min(turns["library"]),
                     "library_bf16_out_ms": min(turns["library_bf16_out"]), **b56}
    _emit(phase="b56_time", w="512x512 BlockPruner 87.5 %", x=list(x.shape),
          nnzb=len(bpacked.colidx), live_in_blocks=b56_in_blocks, turns=turns, **b56,
          card=smi)
    del x
    torch.cuda.empty_cache()
    # B7a-f and sparse_conv_apply at the bench's conv, batch 32
    w, _, _ = _bench_problem(torch, dev, smi)
    m = bench_sparse.block_mask(w, 0.875)
    plans = {"shared": sc.plan_shared_sparse_conv(w, m, 2).to(dev),
             "fused": sc.plan_fused_sparse_conv(w, m, 2).to(dev)}
    tplan = sc.plan_sparse_conv(w, m).to(dev)
    wconv = torch.from_numpy(w * m).to(dev, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    x = torch.randn(BENCH_BATCH32, generator=gen, device=dev, dtype=torch.bfloat16)
    xn = x.permute(0, 3, 1, 2)
    fns = {"plain_fused": lambda: sc.fused_sparse_conv_reference(x, plans["fused"]),
           "plain_shared": lambda: sc.fused_sparse_conv_reference(x, plans["shared"]),
           "sparse_conv_apply": lambda: sc.sparse_conv_apply(x, tplan, 2),
           "library": lambda: F.conv2d(xn, wconv, None, 1, 2, 2)}
    for name, (_, pk, _) in B7_ENTRIES.items():
        fns[name] = lambda f=getattr(sc, name), p=plans[pk]: f(x, p)
    iters = {name: 2 if name.startswith("plain") else 10 for name in fns}
    turns = _time_turns(torch, fns, iters)
    for name, (_, pk, _) in B7_ENTRIES.items():
        p = plans[pk]
        out[name] = {
            "ms": min(turns[name]), "plain_ms": min(turns[f"plain_{pk}"]),
            "library_ms": min(turns["library"]),
            **dict(zip(("bound_ms", "bound_by"), _b2_bound(P32, p.vals, p.rows, p.cout)))}
    _emit(phase="b7_time", x=list(x.shape), k=3, dilation=2, mask="BlockPruner 87.5 %",
          s={pk: p.s for pk, p in plans.items()},
          live_tiles={pk: _live_tiles(p.vals) for pk, p in plans.items()},
          live_in_blocks={pk: _live_in_blocks(p.vals, p.rows) for pk, p in plans.items()},
          union_density=plans["shared"].union_density, turns=turns,
          bounds={n: out[n]["bound_ms"] for n in B7_ENTRIES}, card=smi)
    del x, xn
    torch.cuda.empty_cache()
    return out


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
    from tpuseg_torch.ops.sparse_conv import fused_sparse_conv_apply, quantize_activation
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
    # B1's bound: logits read once, ids written once; per output pixel and
    # class, 2 multiplies and an add of the column pass, the running max, and
    # the row pass's 3 operations shared by 8 output columns: 4.375 f32 ops
    n_out = SERVING_LOGITS[0] * 64 * SERVING_LOGITS[1] * SERVING_LOGITS[2]
    b1_bound = _bound(x.numel() * 2 + n_out, n_out * SERVING_LOGITS[3] * 4.375, "f32")
    _emit(phase="kernel_time", shape=list(SERVING_LOGITS), dtype="bfloat16",
          kernel_ms=kern, plain_ms=plain, bound_ms=b1_bound[0], bound_by=b1_bound[1], card=smi)
    del x

    # 6. B2 vs plain on the card (f32 plain convs with TF32 off, set above)
    masked, plans, report = _pruned(torch, params, state, spec, SERVED_CONFIG, "pallas",
                                    torch.bfloat16)
    from tpuseg_torch.ops.fold_bn import fold_bn

    b2_err = _b2_vs_plain(torch, np, dev, rng, plans, fold_bn(masked, state, spec))
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
    from tpuseg_torch.ops.sparse_conv import fused_sparse_conv_bias_bf16

    bias6 = torch.randn(plan.cout, device=dev).to(torch.bfloat16)
    turns = _time_turns(torch, {
        "plain": lambda: fused_sparse_conv_reference(x, plan),
        "kernel": lambda: fused_sparse_conv_apply(x, plan),
        "dense_cudnn": lambda: torch.nn.functional.conv2d(x_nchw, w_dense, None, 1, sd, sd),
        "bf16_bias_route": lambda: fused_sparse_conv_bias_bf16(x, plan, bias6),
        "two_passes": lambda: fused_sparse_conv_apply(x, plan).to(torch.bfloat16) + bias6,
    }, {"plain": 3, "kernel": 10, "dense_cudnn": 10, "bf16_bias_route": 10, "two_passes": 10})
    b2_ms, b2_plain_ms = min(turns["kernel"]), min(turns["plain"])
    b2_cudnn_ms = min(turns["dense_cudnn"])
    b2_bound = _b2_bound(sn * sh * sw, plan.vals, plan.rows, plan.cout)
    _emit(phase="b2_time", conv="layer.6.1.conv2", shape=[sn, sh, sw, sc], dilation=sd,
          s=plan.s, dtype="bfloat16", kernel_ms=turns["kernel"], plain_ms=turns["plain"],
          dense_cudnn_ms=turns["dense_cudnn"], bf16_bias_route_ms=turns["bf16_bias_route"],
          two_passes_ms=turns["two_passes"], bound_ms=b2_bound[0], bound_by=b2_bound[1],
          kernel_tflops=2 * sn * sh * sw * sk * sk * plan.s * 128 * plan.cout / b2_ms / 1e9,
          card=smi)

    del x_nchw
    torch.cuda.empty_cache()

    # 10. B3 vs its exact plain version on the card, bit-equal
    from tpuseg_torch.ops.fold_bn import fold_bn
    from tpuseg_torch.ops.quant import build_quant_plans
    from tpuseg_torch.ops.sparse_conv import fused_sparse_conv_apply_q

    dense_int8 = build_quant_plans(fold_bn(params, state, spec), spec)
    served = _served_b3_plans(dense_int8, plans, gplans, fold_bn(masked, state, spec))
    quantize_err = _quantize_vs_cpu(torch, np, dev, rng)
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
    b3_launches = q_launches = 0
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
        quantize_activation.launches = quantize_activation.absmax_launches = 0
        res = serve.run(frames, need_color=False)
        torch.cuda.synchronize()
        b3, b2, up = (fused_sparse_conv_apply_q.launches, fused_sparse_conv_apply.launches,
                      upsample_argmax.launches)
        quant, absmax = quantize_activation.launches, quantize_activation.absmax_launches
        out = res["ids"]
        assert out.shape == (32,) + FULL and out.dtype == np.uint8, (out.shape, out.dtype)
        assert int(out.max()) < CLASSES
        if b3 != B3_PER_FORWARD[label] * forwards or b2 != 0 or up != forwards:
            raise AssertionError(f"int8 {label}: B3 {b3}, B2 {b2}, upsample_argmax {up} "
                                 f"launches; want {B3_PER_FORWARD[label] * forwards}, 0, "
                                 f"{forwards}")
        # one quantize pass per B3 launch; the absmax pass only without static scales
        if quant != b3 or absmax != (0 if calib is not None else b3):
            raise AssertionError(f"int8 {label}: quantize {quant}, absmax {absmax} launches "
                                 f"for {b3} B3 launches")
        b3_launches += b3
        q_launches += quant
        int8_ids[label] = out
        ref_label, ref = (("float", float_ids) if float_ids is not None
                          else ("dynamic int8", int8_ids["dense"]))
        agree, limit = _agreement(out, ref), INT8_FULL_MIN[label]
        _emit(phase="int8_full", variant=label, size=list(FULL), dtype="bfloat16", batch=8,
              frames=res["frames"], run_fps=res["fps"], plans=kinds,
              calibrated_frames=0 if calib is None else len(calib), b3_launches=b3,
              quantize_launches=quant, absmax_launches=absmax,
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
        fused_sparse_conv_q_bias_bf16, fused_sparse_conv_q_bias_bf16_reference,
        quantize_activation_reference, quantize_fused_plan)

    qplan = quantize_fused_plan(plans["layer.6.1.conv2"]).to(dev)
    # the dense int8 conv as dense int8 serving runs it: the unpruned weight
    w6 = params["layer.6.1.conv2.weight"].numpy().transpose(2, 3, 1, 0)
    qdense = full_support_packing("layer.6.1.conv2", *quantize_weight(w6), sd, sd).to(dev)
    xq, xs = quantize_activation(x, None)
    out6 = {dt: torch.empty((sn, sh, sw, qplan.cout), device=dev, dtype=dt)
            for dt in (torch.float32, torch.bfloat16)}
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def b3_kernel_only(bf16_out):
        o = out6[torch.bfloat16 if bf16_out else torch.float32]
        err = lib.tpuseg_sparse_conv_q(
            xq.data_ptr(), qplan.vals_k.data_ptr(), qplan.rows.data_ptr(),
            qplan.steps.data_ptr(), qplan.nsteps.data_ptr(), qplan.w_scale.data_ptr(),
            xs.data_ptr(), bias6.data_ptr() if bf16_out else None, o.data_ptr(),
            sn, sh, sw, sc, qplan.cout, qplan.s, qplan.kernel, qplan.dilation, int(bf16_out),
            stream)
        assert err == 0, err

    x_nchw = x.permute(0, 3, 1, 2)
    turns = _time_turns(torch, {
        "b3_plain": lambda: fused_sparse_conv_q_bias_bf16_reference(x, qplan, bias6),
        "b3_served": lambda: fused_sparse_conv_q_bias_bf16(x, qplan, bias6),
        "b3_f32": lambda: fused_sparse_conv_apply_q(x, qplan),
        "b3_kernel_only": lambda: b3_kernel_only(True),
        "b3_kernel_only_f32": lambda: b3_kernel_only(False),
        "quantize": lambda: quantize_activation(x, None),
        "quantize_static": lambda: quantize_activation(x, 0.013),
        "quantize_plain": lambda: quantize_activation_reference(x, None),
        "b2": lambda: fused_sparse_conv_apply(x, plan),
        "dense_cudnn_bias": lambda: torch.nn.functional.conv2d(x_nchw, w_dense, bias6, 1, sd,
                                                               sd),
        "b3_dense_s4_served": lambda: fused_sparse_conv_q_bias_bf16(x, qdense, bias6),
    }, {"b3_plain": 2, "b3_served": 10, "b3_f32": 10, "b3_kernel_only": 10,
        "b3_kernel_only_f32": 10, "quantize": 10, "quantize_static": 10, "quantize_plain": 3,
        "b2": 10, "dense_cudnn_bias": 10, "b3_dense_s4_served": 5})
    b3_ms, b3_plain_ms = min(turns["b3_served"]), min(turns["b3_plain"])
    k_ms = min(turns["b3_kernel_only"])
    # the served function: bf16 x in (all of it: the per-frame scale is its
    # absmax), the live int8 tiles, bf16 y out with its bias, int8 operations
    b3_live = _live_tiles(qplan.vals)
    b3_bound = _bound(x.numel() * 2 + b3_live * 128 * 128 + qplan.w_scale.numel() * 4
                      + qplan.rows.numel() * 4 + qplan.cout * 2 + sn * sh * sw * qplan.cout * 2,
                      2 * sn * sh * sw * b3_live * 128 * 128, "int8")
    # the quantize pass's function: x read once, int8 x and the scales
    # written once; one division an element
    q_ms, q_plain_ms = min(turns["quantize"]), min(turns["quantize_plain"])
    q_bound = _bound(x.numel() * 3 + sn * 4, x.numel(), "f32")
    _emit(phase="b3_time", conv="layer.6.1.conv2", shape=[sn, sh, sw, sc], dilation=sd,
          s=qplan.s, live_tiles=b3_live, x_dtype="bfloat16", ms=turns, card=smi,
          bound_ms=b3_bound[0], bound_by=b3_bound[1], quantize_bound_ms=q_bound[0],
          kernel_tops=2 * sn * sh * sw * b3_live * 128 * 128 / k_ms / 1e9,
          dense_s4_live_tiles=_live_tiles(qdense.vals),
          dense_s4_served_tops=2 * sn * sh * sw * _live_tiles(qdense.vals) * 128 * 128
          / min(turns["b3_dense_s4_served"]) / 1e9)

    del x, x_nchw, xq, out6
    torch.cuda.empty_cache()

    # 14-16. slice 4's kernels vs their plain versions (TF32 off, set above)
    b4_err = _b4_vs_plain(torch, np, dev, rng, smi)
    b56_err = _b56_vs_plain(torch, np, dev, rng)
    b7_err = _b7_vs_plain(torch, np, dev, rng, smi)
    # 17. this slice's paths, counts zeroed just before each
    s4_launches = _slice4_paths(torch, dev)
    # 18. times at the batch-32 shapes
    s4_times = _slice4_times(torch, np, dev, smi)

    _emit(phase="total", seconds=round(time.perf_counter() - t_start, 1))
    sc_src, b2_src = "tpuseg/ops/sparse_conv.py", "tpuseg_torch/csrc/sparse_conv.cu"

    def entry(name, source, replaces, launched, err, ms, plain, bound, library):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launched, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library}

    def s4(name, source, replaces, err):
        t = s4_times[name]
        return entry(name, source, replaces, s4_launches[name], err, t["ms"], t["plain_ms"],
                     (t["bound_ms"], t["bound_by"]), t["library_ms"])

    kernels = [
        entry("upsample_argmax", "tpuseg_torch/csrc/upsample_argmax.cu",
              "tpuseg/ops/upsample.py:91", launches, max_abs_err, kernel_ms, plain_ms,
              b1_bound, None),
        entry("sparse_conv", b2_src, f"{sc_src}:270", b2_launches, b2_err, b2_ms,
              b2_plain_ms, b2_bound, b2_cudnn_ms),
        entry("sparse_conv_q", "tpuseg_torch/csrc/sparse_conv_q.cu", f"{sc_src}:1294",
              b3_launches, b3_err, b3_ms, b3_plain_ms, b3_bound, None),
        entry("quantize", "tpuseg_torch/csrc/quantize.cu", f"{sc_src}:1312-1324", q_launches,
              quantize_err, q_ms, q_plain_ms, q_bound, None),
        s4("bsr_matmul_xw", b2_src, f"{sc_src}:84", b4_err),
        s4("bsr_matmul", "tpuseg_torch/csrc/bsr_matmul.cu", "tpuseg/ops/bsr.py:105",
           b56_err["bsr_matmul"]),
        s4("bsr_matmul_gathered", "tpuseg_torch/csrc/bsr_matmul.cu", "tpuseg/ops/bsr.py:187",
           b56_err["bsr_matmul_gathered"]),
    ] + [s4(name, b2_src, f"{sc_src}:{line}", b7_err[name])
         for name, (_, _, line) in B7_ENTRIES.items()]
    bad = [k["name"] for k in kernels if not k["launches"] > 0]
    if bad:
        raise AssertionError(f"kernels never launched on their path: {bad}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
