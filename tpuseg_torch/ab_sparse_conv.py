"""A/B of the port's hand-written kernels against other builds of them, on
one card in one process, so that the two are timed under the same clocks
and neighbours.

    python -m tpuseg_torch.ab_sparse_conv [--old OLD_sparse_conv.cu]
        [--old-q OLD_sparse_conv_q.cu] [--old-bsr OLD_bsr_matmul.cu]
        [--old-up OLD_upsample_argmax.cu] [--skip-fps]

Each option is a copy of that source from another commit, e.g.
``git show <commit>:tpuseg_torch/csrc/sparse_conv_q.cu > _scratch/old_q.cu``
(``_scratch/`` is git-ignored).  The script renames each copy's C entry
point, builds the copies with the package's nvcc flags into one library
beside the first (with the package's ``csrc/hopper.cuh`` next to them, for
copies that include it), and times, in turns (old, new, new, old), at the
batch-32 shapes of ``chip_smoke.py``:

- ``--old`` (kernel B2, ``sparse_conv.cu``): B2 at ``layer.6.1.conv2`` of
  ``drn_d_22_block128reg_87.50`` (masker seed 0), f32 out, and the served
  bf16 step (the new kernel's bf16+bias route against the old kernel's f32
  y cast and biased in PyTorch); B7a-f on the bench's 3x3 d=2 conv at 87.5 %
  (both packings); B4 at x (2**20, 512) with a 512x512 BlockPruner 87.5 %
  W, and ``sparse_conv_apply`` (9 x B4) on the bench's conv; the pruned
  device fps at batch 32 (1024x2048, bf16) under the Pallas lowering with
  each kernel, beside the gathered lowering and masked dense, and
  ``torch.profiler``'s device time per kernel name over one batch of the
  Pallas lowering with each.
- ``--old-q`` (kernel B3, ``sparse_conv_q.cu``): B3 alone on the quantized
  x of ``layer.6.1.conv2`` (f32 out, the function both builds have); the
  int8 served step there (quantize, B3, bf16 cast, bias: one route of the
  new build against an old build's PyTorch quantize, f32 kernel and two
  PyTorch passes); the quantize pass and B3 alone at each of the 13 dense
  int8 convs; and the int8 device fps at batch 32 of the four int8
  variants (dense, dense calibrated on 8 frames, block128reg_87.50 under
  the Pallas and the gathered lowering) with one profiled dense batch.
- ``--old-bsr`` (kernels B5/B6, ``bsr_matmul.cu``): ``bsr_matmul`` and
  ``bsr_matmul_gathered`` at x (512, 2**20) with the 512x512 87.5 % W,
  beside ``torch.mm(..., out_dtype=torch.float32)``.
- ``--old-up`` (kernel B1, ``upsample_argmax.cu``): B1 at the serving
  logits (32, 128, 256, 19) in bf16 and f32, the dense device fps at batch
  32 (1024x2048, bf16) with each build, and ``torch.profiler``'s device time
  per kernel name over one dense batch with each.

An old copy whose entry point predates a change of its C interface (B2
without ``steps``/``nsteps``/``bias``, B3 without the step lists and the
bf16 epilogue, B5/B6 without ``nnzb``) is launched with its own arguments,
and the served path then keeps the passes that copy needed.  Every line
printed is JSON; the card (``nvidia-smi`` name and power limit) is on the
first.  Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from tpuseg_torch.ops import _build
from tpuseg_torch.ops import bsr
from tpuseg_torch.ops import sparse_conv as sc
from tpuseg_torch.ops import upsample as up

CONFIG = "optimal_configs/drn_d_22/drn_d_22_block128reg_87.50.json"
MEAN = [0.290, 0.328, 0.287]
STD = [0.183, 0.187, 0.184]
FULL = (1024, 2048)
BATCH32 = (32, 128, 256, 512)
P32 = 32 * 128 * 256
# per kernel: (source, C entry point, a parameter only the newer interface has)
SOURCES = {"b2": ("sparse_conv.cu", "tpuseg_sparse_conv", "const void* nsteps"),
           "b3": ("sparse_conv_q.cu", "tpuseg_sparse_conv_q", "const void* nsteps"),
           "bsr": ("bsr_matmul.cu", "tpuseg_bsr_matmul", "int nnzb"),
           "up": ("upsample_argmax.cu", "tpuseg_upsample_argmax", "void* stream")}
SERVING_LOGITS = (32, 128, 256, 19)


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def build_old(copies: dict) -> dict:
    """Build the old copies (kernel -> path) into one library, each entry
    point renamed ``<name>_old``; -> kernel -> (C function, newer ABI?)."""
    first = next(iter(copies.values()))
    build = os.path.join(os.path.dirname(os.path.abspath(first)), "ab_old_build")
    src_dir = os.path.join(build, "src")
    os.makedirs(src_dir, exist_ok=True)
    for name in os.listdir(src_dir):
        os.remove(os.path.join(src_dir, name))
    shutil.copy(os.path.join(_build.SRC_DIR, "hopper.cuh"), src_dir)
    newer = {}
    for kernel, path in copies.items():
        fname, symbol, marker = SOURCES[kernel]
        src = open(path).read()
        newer[kernel] = marker in src
        with open(os.path.join(src_dir, fname.replace(".cu", "_old.cu")), "w") as fh:
            fh.write(src.replace(f'extern "C" int {symbol}(', f'extern "C" int {symbol}_old('))
    lib = ctypes.CDLL(_build.build_library(src_dir, build)[0])
    out = {}
    for kernel in copies:
        fn = getattr(lib, SOURCES[kernel][1] + "_old")
        fn.restype = ctypes.c_int
        out[kernel] = (fn, newer[kernel])
    return out


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def old_b2(fn, newer: bool):
    """A launcher with ``sc._launch_b2``'s signature on the old B2 copy."""
    fn.argtypes = ([ctypes.c_void_p] * (7 if newer else 4) + [ctypes.c_int] * (10 if newer else 9)
                   + [ctypes.c_void_p])

    def launch(x, p, kernel, dilation, cout, bias=None, bf16_out=False):
        if not newer and bf16_out:
            raise ValueError("the old kernel has no bf16 epilogue")
        x = x.to(p.vals.dtype)
        n, h, w, cin = x.shape
        out = torch.empty((n, h, w, cout), device=x.device,
                          dtype=torch.bfloat16 if bf16_out else torch.float32)
        dt = sc._DTYPE_CODE[p.vals.dtype]
        if newer:
            err = fn(x.data_ptr(), p.vals.data_ptr(), p.rows.data_ptr(), p.steps.data_ptr(),
                     p.nsteps.data_ptr(), None if bias is None else bias.data_ptr(),
                     out.data_ptr(), n, h, w, cin, cout, p.s, kernel, dilation, dt,
                     int(bf16_out), _stream(x))
        else:
            err = fn(x.data_ptr(), p.vals.data_ptr(), p.rows.data_ptr(), out.data_ptr(),
                     n, h, w, cin, cout, p.s, kernel, dilation, dt, _stream(x))
        if err != 0:
            raise RuntimeError(f"old sparse_conv launch failed ({err})")
        return out

    return launch


def old_b3(fn, newer: bool):
    """A launcher with ``sc._launch_b3``'s signature on the old B3 copy."""
    fn.argtypes = ([ctypes.c_void_p] * (9 if newer else 6) + [ctypes.c_int] * (9 if newer else 8)
                   + [ctypes.c_void_p])

    def launch(xq, xs, plan, bias, bf16_out):
        if not newer and bf16_out:
            raise ValueError("the old kernel has no bf16 epilogue")
        n, h, w, cin = xq.shape
        out = torch.empty((n, h, w, plan.cout), device=xq.device,
                          dtype=torch.bfloat16 if bf16_out else torch.float32)
        if newer:
            err = fn(xq.data_ptr(), plan.vals_k.data_ptr(), plan.rows.data_ptr(),
                     plan.steps.data_ptr(), plan.nsteps.data_ptr(), plan.w_scale.data_ptr(),
                     xs.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
                     n, h, w, cin, plan.cout, plan.s, plan.kernel, plan.dilation,
                     int(bf16_out), _stream(xq))
        else:
            err = fn(xq.data_ptr(), plan.vals_k.data_ptr(), plan.rows.data_ptr(),
                     plan.w_scale.data_ptr(), xs.data_ptr(), out.data_ptr(),
                     n, h, w, cin, plan.cout, plan.s, plan.kernel, plan.dilation, _stream(xq))
        if err != 0:
            raise RuntimeError(f"old sparse_conv_q launch failed ({err})")
        return out

    return launch


def old_bsr(fn, newer: bool):
    """A launcher with ``bsr._launch``'s signature on the old B5/B6 copy."""
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * (5 if newer else 4) + [ctypes.c_void_p]

    def launch(w, x):
        x = x.to(w.vals.dtype)
        M, K = w.shape
        y = torch.empty((M, x.shape[1]), dtype=torch.float32, device=x.device)
        args = [w.vals.data_ptr(), w.rowptr_t.data_ptr(), w.colidx_t.data_ptr(), x.data_ptr(),
                y.data_ptr(), M, K, x.shape[1]] + ([len(w.colidx)] if newer else [])
        err = fn(*args, sc._DTYPE_CODE[w.vals.dtype], _stream(x))
        if err != 0:
            raise RuntimeError(f"old bsr_matmul launch failed ({err})")
        return y

    return launch


def old_up(fn, _newer: bool):
    """A launcher with ``up._launch``'s signature on the old B1 copy (its C
    interface is the new one's)."""
    fn.argtypes = _build.load_library().tpuseg_upsample_argmax.argtypes

    def launch(seg, ab, out):
        n, h, w, c = seg.shape
        return fn(seg.data_ptr(), out.data_ptr(), ab, n, h, w, c, up._DTYPE_CODE[seg.dtype],
                  _stream(seg))

    return launch


def _quantize_plain(x, x_scale, chan=None):
    """The PyTorch quantize pass, with the channel map the kernels take."""
    return sc.quantize_activation_reference(
        x if chan is None else x.index_select(x.dim() - 1, chan), x_scale)


class Kernels:
    """Switches the package between the new kernels and the old copies:
    ``use("old")`` points each kernel's launcher at its old copy and turns
    off the bf16 routes an old copy does not have."""

    def __init__(self, olds: dict):
        from tpuseg_torch.models import drn

        self.drn = drn
        self.new = {"b2": sc._launch_b2, "b3": sc._launch_b3, "bsr": bsr._launch,
                    "up": up._launch, "quantize": sc.quantize_activation,
                    "route": drn._sparse_conv_bias_bf16}
        self.old = {}
        if "b2" in olds:
            self.old["b2"] = old_b2(*olds["b2"])
        if "b3" in olds:
            self.old["b3"] = old_b3(*olds["b3"])
            if not olds["b3"][1]:  # a build before the quantize kernels quantized in PyTorch
                self.old["quantize"] = _quantize_plain
        if "bsr" in olds:
            self.old["bsr"] = old_bsr(*olds["bsr"])
        if "up" in olds:
            self.old["up"] = old_up(*olds["up"])
        # plan kinds whose old kernel has no bf16+bias route
        self.no_route = tuple(
            kinds for kernel, kinds in (("b2", ("FusedSparseConv", "CompactSparse")),
                                        ("b3", ("FusedSparseConvQ", "CompactSparseQ",
                                                "QuantConv", "GatheredGroupConvQ")))
            if kernel in olds and not olds[kernel][1])

    def use(self, which: str) -> None:
        funcs = {**self.new, **(self.old if which == "old" else {})}
        sc._launch_b2, sc._launch_b3, bsr._launch = funcs["b2"], funcs["b3"], funcs["bsr"]
        up._launch = funcs["up"]
        sc.quantize_activation = funcs["quantize"]
        skip = {k for kinds in self.no_route for k in kinds} if which == "old" else set()
        route = self.new["route"]
        self.drn._sparse_conv_bias_bf16 = (
            (lambda x, plan, bias: None if type(plan).__name__ in skip else route(x, plan, bias))
            if skip else route)


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def ab(kernels: Kernels, fns: dict, iters: int = 10) -> dict:
    """name -> {"old": [ms, ms], "new": [ms, ms]}: each callable timed with
    the old kernels, the new, the new and the old."""
    out = {name: {"old": [], "new": []} for name in fns}
    for which in ("old", "new", "new", "old"):
        kernels.use(which)
        for name, fn in fns.items():
            out[name][which].append(_time_ms(fn, iters))
    kernels.use("new")
    return out


def _served():
    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.models.sparse_exec import build_sparse_plans
    from tpuseg_torch.ops.fold_bn import fold_bn
    from tpuseg_torch.sparsity import apply_masks, create_masker

    params, state, spec = init_drnseg(0, "drn_d_22", 19)
    masks = create_masker(CONFIG, seed=0).generate_masks(params)
    masked = apply_masks(params, masks)
    folded = fold_bn(masked, state, spec)
    plans = {low: build_sparse_plans(folded, masks, spec, lowering=low)[0]
             for low in ("pallas", "gathered")}
    return params, masked, state, spec, folded, plans


def _profile(seg, frames) -> dict:
    """Device ms per kernel name over one ``ids_for`` batch (after a warm
    one): the 12 largest, B1's, and the total."""
    seg.ids_for(frames)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        seg.ids_for(frames)
        torch.cuda.synchronize()
    # key_averages() lists each kernel's time under its name and again under
    # the aten:: op that launched it: sum the kernel names only
    times = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
             if e.self_device_time_total > 0 and not e.key.startswith("aten::")}
    top = sorted(times.items(), key=lambda kv: -kv[1])[:12]
    return {"total_ms": sum(times.values()), "top": [[k[:90], v] for k, v in top],
            "upsample_argmax": [[k[:90], v] for k, v in times.items() if "upsample_argmax" in k]}


def _fps_turns(kernels: Kernels, segs: dict, fixed: dict | None = None) -> dict:
    """Device fps at 1024x2048 of each segmenter with the old and the new
    kernels in turns (old, new, new, old), and of each ``fixed`` segmenter
    (paths the kernels under test do not run) once, between the two news."""
    fps = {f"{name}_{which}": [] for name in segs for which in ("old", "new")}
    fps.update({name: [] for name in fixed or {}})
    for turn, which in enumerate(("old", "new", "new", "old")):
        kernels.use(which)
        for name, seg in segs.items():
            fps[f"{name}_{which}"].append(seg.benchmark_device_fps(FULL, inner=16, reps=2))
        if turn == 1:
            for name, seg in (fixed or {}).items():
                fps[name].append(seg.benchmark_device_fps(FULL, inner=16, reps=2))
    kernels.use("new")
    return fps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="the other commit's sparse_conv.cu (kernel B2)")
    ap.add_argument("--old-q", help="the other commit's sparse_conv_q.cu (kernel B3)")
    ap.add_argument("--old-bsr", help="the other commit's bsr_matmul.cu (kernels B5/B6)")
    ap.add_argument("--old-up", help="the other commit's upsample_argmax.cu (kernel B1)")
    ap.add_argument("--skip-fps", action="store_true", help="kernel times only")
    args = ap.parse_args(argv)
    copies = {k: v for k, v in (("b2", args.old), ("b3", args.old_q), ("bsr", args.old_bsr),
                                ("up", args.old_up)) if v}
    if not copies:
        ap.error("give at least one of --old, --old-q, --old-bsr, --old-up")
    if not torch.cuda.is_available():
        print("ab_sparse_conv: no CUDA card", file=sys.stderr)
        return 1
    from tpuseg_torch import bench_sparse
    from tpuseg_torch.video.pipeline import VideoSegmenter

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    _build.load_library()
    olds = build_old(copies)
    _emit(phase="card", nvidia_smi=smi, torch=torch.__version__, old=copies,
          old_newer_abi={k: v[1] for k, v in olds.items()},
          build_s=round(time.perf_counter() - t0, 2))
    kernels = Kernels(olds)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    if {"b2", "b3"} & set(olds):
        params, masked, state, spec, folded, plans = _served()
        bias = folded["layer.6.1.conv2.bias"].to(dev, torch.bfloat16)
    else:
        from tpuseg_torch.models.drnseg import init_drnseg

        params, state, spec = init_drnseg(0, "drn_d_22", 19)
    x = torch.randn(BATCH32, generator=gen, device=dev, dtype=torch.bfloat16)

    def served_step(plan):
        """The served bf16 layer: the route where the kernel has one, else
        the f32 conv, cast and bias (``models/drn.py``)."""
        y = kernels.drn._sparse_conv_bias_bf16(x.permute(0, 3, 1, 2), plan, bias)
        if y is None:
            y = kernels.drn._sparse_conv(x.permute(0, 3, 1, 2), plan, None).to(
                torch.bfloat16) + bias.view(1, -1, 1, 1)
        return y

    if "b2" in olds:
        # B2 at layer.6.1.conv2, f32 out and the served bf16 step
        plan = plans["pallas"]["layer.6.1.conv2"].to(dev)
        turns = ab(kernels, {"b2_f32": lambda: sc.fused_sparse_conv_apply(x, plan),
                             "served_step": lambda: served_step(plan)})
        _emit(phase="b2", conv="layer.6.1.conv2", shape=list(BATCH32), s=plan.s, turns=turns,
              card=smi)
        # B7a-f on the bench's conv at 87.5 %, batch 32; B4; sparse_conv_apply
        _, w, _ = bench_sparse.Bench(dev, smi).problem()
        m = bench_sparse.block_mask(w, 0.875)
        packs = {"shared": sc.plan_shared_sparse_conv(w, m, 2).to(dev),
                 "fused": sc.plan_fused_sparse_conv(w, m, 2).to(dev)}
        tplan = sc.plan_sparse_conv(w, m).to(dev)
        entries = {"B7a": ("shared_sparse_conv_apply", "shared"),
                   "B7b": ("fused_phase_sparse_conv_apply", "fused"),
                   "B7c": ("imcol_phase_sparse_conv_apply", "fused"),
                   "B7d": ("cphase_sparse_conv_apply", "fused"),
                   "B7e": ("phase_sparse_conv_apply", "shared"),
                   "B7f": ("shared_concat_sparse_conv_apply", "shared")}
        fns = {key: (lambda fn=getattr(sc, name), p=packs[pk]: fn(x, p))
               for key, (name, pk) in entries.items()}
        fns["sparse_conv_apply"] = lambda: sc.sparse_conv_apply(x, tplan, 2)
        _emit(phase="b7_b4conv", shape=list(BATCH32), k=3, dilation=2,
              mask="BlockPruner 87.5 %", s={pk: p.s for pk, p in packs.items()},
              live_steps={pk: p.nsteps.tolist() for pk, p in packs.items()},
              turns=ab(kernels, fns, iters=5), card=smi)

    if "b3" in olds:
        # B3 alone (f32 out) on the quantized x, and the int8 served step
        qplan = sc.quantize_fused_plan(plans["pallas"]["layer.6.1.conv2"]).to(dev)
        xq, xs = sc.quantize_activation_reference(x, None)
        turns = ab(kernels, {
            "b3_f32_alone": lambda: sc._launch_b3(xq, xs, qplan, None, False),
            "served_step": lambda: served_step(qplan),
        })
        _emit(phase="b3", conv="layer.6.1.conv2", shape=list(BATCH32), s=qplan.s,
              live_steps=qplan.nsteps.tolist(), turns=turns, card=smi)
        del xq, xs
    del x
    if "b3" in olds:
        # each of the 13 dense int8 convs at its batch-32 input: the quantize
        # pass and B3 alone (f32 out), old and new, and the new kernel's
        # served bf16+bias epilogue
        from tpuseg_torch.ops.fold_bn import fold_bn
        from tpuseg_torch.ops.quant import build_quant_plans

        for name, qc in build_quant_plans(fold_bn(params, state, spec), spec).items():
            pk = qc.packed.to(dev)
            xc = torch.randn(BATCH32[:3] + (pk.cin,), generator=gen, device=dev,
                             dtype=torch.bfloat16)
            bc = torch.randn(pk.cout, generator=gen, device=dev).to(torch.bfloat16)
            xq, xs = sc.quantize_activation_reference(xc, None)
            turns = ab(kernels, {
                "quantize": lambda: sc.quantize_activation(xc, None),
                "b3_f32_alone": lambda: sc._launch_b3(xq, xs, pk, None, False)})
            kernels.use("new")
            served = [_time_ms(lambda: sc._launch_b3(xq, xs, pk, bc, True), 10)
                      for _ in range(2)]
            ops = 2 * xc[..., 0].numel() * int(pk.nsteps.sum()) * 128 * 128
            _emit(phase="b3_dense_conv", conv=name, cin=pk.cin, cout=pk.cout,
                  dilation=pk.dilation, turns=turns, b3_bf16_bias_alone_new=served,
                  new_tops_f32=ops / min(turns["b3_f32_alone"]["new"]) / 1e9,
                  new_tops_bf16=ops / min(served) / 1e9, card=smi)
            del xc, xq, xs
        torch.cuda.empty_cache()

    from tpuseg_torch.sparsity.block import BlockConfig, prune_as_block

    w2 = (np.random.default_rng(5).normal(size=(512, 512)) * 0.05).astype(np.float32)
    m2 = prune_as_block(w2, BlockConfig(0.875, 128, 128, -1, -1, True))
    if "b2" in olds:
        packed = sc.pack_xw_bsr(w2 * m2).to(dev)
        x = torch.randn((P32, 512), generator=gen, device=dev, dtype=torch.bfloat16)
        _emit(phase="b4", x=list(x.shape), w="512x512 BlockPruner 87.5 %",
              live_steps=packed.nsteps.tolist(),
              turns=ab(kernels, {"B4": lambda: sc.bsr_matmul_xw(x, packed)}), card=smi)
        del x
    if "bsr" in olds:
        bp = bsr.pack_bsr(w2, m2).to(dev)
        wd = torch.from_numpy(w2 * m2).to(dev, torch.bfloat16)
        x = torch.randn((512, P32), generator=gen, device=dev, dtype=torch.bfloat16)
        turns = ab(kernels, {"bsr_matmul": lambda: bsr.bsr_matmul(bp, x),
                             "bsr_matmul_gathered": lambda: bsr.bsr_matmul_gathered(bp, x),
                             "torch_mm_f32_out": lambda: torch.mm(wd, x,
                                                                  out_dtype=torch.float32)})
        _emit(phase="b56", x=list(x.shape), w="512x512 BlockPruner 87.5 %",
              rowptr=bp.rowptr.tolist(), turns=turns, card=smi)
        del x
    if "up" in olds:
        # B1 at the serving logits, bf16 and f32
        from tpuseg_torch.models.drnseg import bilinear_upsample_kernel

        k = bilinear_upsample_kernel()
        xb = torch.randn(SERVING_LOGITS, generator=gen, device=dev, dtype=torch.bfloat16)
        xf = xb.float()
        _emit(phase="b1", shape=list(SERVING_LOGITS),
              turns=ab(kernels, {"b1_bf16": lambda: up.upsample_argmax(xb, k),
                                 "b1_f32": lambda: up.upsample_argmax(xf, k)}, iters=20),
              card=smi)
        del xb, xf
    torch.cuda.empty_cache()
    if args.skip_fps:
        return 0

    frames = torch.zeros((32, FULL[0], FULL[1] * 3), dtype=torch.uint8, device=dev)
    if "b2" in olds:
        # pruned device fps at batch 32, and one profiled batch of the Pallas lowering
        seg = VideoSegmenter(masked, state, spec, MEAN, STD, device=dev,
                             compute_dtype=torch.bfloat16, batch=32, exec_plans=plans["pallas"])
        fixed = {name: VideoSegmenter(masked, state, spec, MEAN, STD, device=dev,
                                      compute_dtype=torch.bfloat16, batch=32, exec_plans=p)
                 for name, p in (("gathered", plans["gathered"]), ("masked_dense", None))}
        fps = _fps_turns(kernels, {"pallas": seg}, fixed)
        _emit(phase="pruned_device_fps", config=CONFIG, size=list(FULL), batch=32,
              device_fps=fps, ids_for_ms={k: [32e3 / v for v in vs] for k, vs in fps.items()},
              card=smi)
        prof = {}
        for which in ("old", "new"):
            kernels.use(which)
            prof[which] = _profile(seg, frames)
        kernels.use("new")
        _emit(phase="pallas_profile", device_ms_by_kernel=prof, card=smi)
        del seg, fixed
        torch.cuda.empty_cache()
    if "b3" in olds:
        # int8 device fps at batch 32 of the four int8 variants, and one
        # profiled batch of dense int8 with each build
        from tpuseg_torch.data.shapes import shapes_video

        calib = list(shapes_video(8, FULL, seed=0)[0])
        variants = {"dense": (params, None, None), "dense_calibrated": (params, None, calib),
                    "pallas": (masked, plans["pallas"], None),
                    "gathered": (masked, plans["gathered"], None)}
        segs = {name: VideoSegmenter(p, state, spec, MEAN, STD, device=dev,
                                     compute_dtype=torch.bfloat16, batch=32, exec_plans=vp,
                                     quantize=True, calib_frames=c)
                for name, (p, vp, c) in variants.items()}
        fps = _fps_turns(kernels, segs)
        _emit(phase="int8_device_fps", size=list(FULL), batch=32, device_fps=fps,
              ids_for_ms={k: [32e3 / v for v in vs] for k, vs in fps.items()}, card=smi)
        prof = {}
        for which in ("old", "new"):
            kernels.use(which)
            prof[which] = _profile(segs["dense"], frames)
        kernels.use("new")
        _emit(phase="int8_dense_profile", device_ms_by_kernel=prof, card=smi)
        del segs
        torch.cuda.empty_cache()
    if "up" in olds:
        # dense bf16 device fps at batch 32 with each B1 build, and one
        # profiled dense batch with each
        seg = VideoSegmenter(params, state, spec, MEAN, STD, device=dev,
                             compute_dtype=torch.bfloat16, batch=32)
        fps = _fps_turns(kernels, {"dense": seg})
        _emit(phase="dense_device_fps", size=list(FULL), batch=32, device_fps=fps,
              ids_for_ms={k: [32e3 / v for v in vs] for k, vs in fps.items()}, card=smi)
        prof = {}
        for which in ("old", "new"):
            kernels.use(which)
            prof[which] = _profile(seg, frames)
        kernels.use("new")
        _emit(phase="dense_profile", device_ms_by_kernel=prof, card=smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
