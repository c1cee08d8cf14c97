#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``tpuseg_torch``): builds the CUDA
kernels from ``tpuseg_torch/csrc/``, holds each against its plain PyTorch
version, drives the served slices (DRN-D-22 DRNSeg, 19 classes, 1024x2048,
dense and pruned) through ``VideoSegmenter``, and times the kernels against
their plain versions.

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
  9. B2 vs plain vs the dense cuDNN conv at the layer.6.1.conv2 serving shape.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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
    out = res["ids"]
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
    out = res["ids"]
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
