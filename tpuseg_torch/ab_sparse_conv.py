"""A/B of kernel B2 (``csrc/sparse_conv.cu``) against another build of it,
on one card in one process, so that the two are timed under the same
clocks and neighbours.

    python -m tpuseg_torch.ab_sparse_conv --old path/to/old_sparse_conv.cu

``--old`` is a copy of ``sparse_conv.cu`` from another commit, e.g.
``git show <commit>:tpuseg_torch/csrc/sparse_conv.cu > _scratch/old.cu``
(``_scratch/`` is git-ignored).  The script renames its C entry point,
builds it with the package's nvcc flags into its own library beside the
copy, and times, in turns (old, new, new, old), at the batch-32 shapes of
``chip_smoke.py``:

- B2 at ``layer.6.1.conv2`` of ``drn_d_22_block128reg_87.50`` (masker seed
  0), f32 out, and the served bf16 step: the new kernel's bf16+bias route
  against the old kernel's f32 y cast and biased in PyTorch;
- B7a-f on the bench's 3x3 d=2 conv at 87.5 % (both packings);
- B4 at x (2**20, 512) with a 512x512 BlockPruner 87.5 % W, and
  ``sparse_conv_apply`` (9 x B4) on the bench's conv;
- the pruned device fps at batch 32 (1024x2048, bf16) under the Pallas
  lowering with each kernel, beside the gathered lowering and masked dense,
  and ``torch.profiler``'s device time per kernel name over one batch of
  the Pallas lowering with each.

An old copy that predates the step lists (its entry point takes no
``steps``/``nsteps``/``bias``) is launched with its own arguments and the
served path then keeps the two passes.  Every line printed is JSON; the card
(``nvidia-smi`` name and power limit) is on the first.  Exits 1 without a
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from tpuseg_torch.ops import _build
from tpuseg_torch.ops import sparse_conv as sc

CONFIG = "optimal_configs/drn_d_22/drn_d_22_block128reg_87.50.json"
MEAN = [0.290, 0.328, 0.287]
STD = [0.183, 0.187, 0.184]
FULL = (1024, 2048)
BATCH32 = (32, 128, 256, 512)
P32 = 32 * 128 * 256
OLD_SYMBOL = "tpuseg_sparse_conv_old"


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def load_old(path: str):
    """Build the old copy with its entry point renamed; -> (launch, abi).
    ``launch`` has ``_launch_b2``'s signature."""
    src = open(path).read()
    abi = "steps" if "nsteps" in src else "nosteps"
    build = os.path.join(os.path.dirname(os.path.abspath(path)), "ab_old_build")
    src_dir = os.path.join(build, "src")
    os.makedirs(src_dir, exist_ok=True)
    with open(os.path.join(src_dir, "sparse_conv_old.cu"), "w") as fh:
        fh.write(src.replace('extern "C" int tpuseg_sparse_conv(',
                             f'extern "C" int {OLD_SYMBOL}('))
    lib_path, _ = _build.build_library(src_dir, build)
    fn = getattr(ctypes.CDLL(lib_path), OLD_SYMBOL)
    n_ptr = 7 if abi == "steps" else 4
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * (10 if abi == "steps" else 9)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def launch(x, p, kernel, dilation, cout, bias=None, bf16_out=False):
        if abi == "nosteps" and bf16_out:
            raise ValueError("the old kernel has no bf16 epilogue")
        x = x.to(p.vals.dtype)
        n, h, w, cin = x.shape
        out = torch.empty((n, h, w, cout), device=x.device,
                          dtype=torch.bfloat16 if bf16_out else torch.float32)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        dt = sc._DTYPE_CODE[p.vals.dtype]
        if abi == "steps":
            err = fn(x.data_ptr(), p.vals.data_ptr(), p.rows.data_ptr(), p.steps.data_ptr(),
                     p.nsteps.data_ptr(), None if bias is None else bias.data_ptr(),
                     out.data_ptr(), n, h, w, cin, cout, p.s, kernel, dilation, dt,
                     int(bf16_out), stream)
        else:
            err = fn(x.data_ptr(), p.vals.data_ptr(), p.rows.data_ptr(), out.data_ptr(),
                     n, h, w, cin, cout, p.s, kernel, dilation, dt, stream)
        if err != 0:
            raise RuntimeError(f"old sparse_conv launch failed ({err})")
        return out

    return launch, abi


class Kernels:
    """Switches the package between the new kernel and the old copy."""

    def __init__(self, old_launch, abi):
        from tpuseg_torch.models import drn

        self.drn = drn
        self.new_launch, self.old_launch, self.abi = sc._launch_b2, old_launch, abi
        self.new_route = drn._sparse_conv_bias_bf16

    def use(self, which: str) -> None:
        old = which == "old"
        sc._launch_b2 = self.old_launch if old else self.new_launch
        self.drn._sparse_conv_bias_bf16 = (
            (lambda *a: None) if old and self.abi == "nosteps" else self.new_route)


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
    the old kernel, the new, the new and the old."""
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
    return masked, state, spec, folded, plans


def _profile(seg, frames) -> dict:
    """Device ms per kernel name over one ``ids_for`` batch (after a warm
    one), the 12 largest, and the total."""
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
    return {"total_ms": sum(times.values()), "top": [[k[:90], v] for k, v in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="the other commit's sparse_conv.cu")
    ap.add_argument("--skip-fps", action="store_true", help="kernel times only")
    args = ap.parse_args(argv)
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
    old_launch, abi = load_old(args.old)
    _emit(phase="card", nvidia_smi=smi, torch=torch.__version__, old=args.old, old_abi=abi,
          build_s=round(time.perf_counter() - t0, 2))
    kernels = Kernels(old_launch, abi)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # B2 at layer.6.1.conv2, f32 out and the served bf16 step
    masked, state, spec, folded, plans = _served()
    plan = plans["pallas"]["layer.6.1.conv2"].to(dev)
    bias = folded["layer.6.1.conv2.bias"].to(dev, torch.bfloat16)
    x = torch.randn(BATCH32, generator=gen, device=dev, dtype=torch.bfloat16)

    def served_step():
        y = kernels.drn._sparse_conv_bias_bf16(x.permute(0, 3, 1, 2), plan, bias)
        if y is None:
            y = sc.fused_sparse_conv_apply(x, plan).to(torch.bfloat16) + bias
        return y

    turns = ab(kernels, {"b2_f32": lambda: sc.fused_sparse_conv_apply(x, plan),
                         "served_step": served_step})
    _emit(phase="b2", conv="layer.6.1.conv2", shape=list(BATCH32), s=plan.s, turns=turns,
          card=smi)
    del x

    # B7a-f on the bench's conv at 87.5 %, batch 32; B4; sparse_conv_apply
    _, w, _ = bench_sparse.Bench(dev, smi).problem()
    m = bench_sparse.block_mask(w, 0.875)
    packs = {"shared": sc.plan_shared_sparse_conv(w, m, 2).to(dev),
             "fused": sc.plan_fused_sparse_conv(w, m, 2).to(dev)}
    tplan = sc.plan_sparse_conv(w, m).to(dev)
    x = torch.randn(BATCH32, generator=gen, device=dev, dtype=torch.bfloat16)
    entries = {"B7a": ("shared_sparse_conv_apply", "shared"),
               "B7b": ("fused_phase_sparse_conv_apply", "fused"),
               "B7c": ("imcol_phase_sparse_conv_apply", "fused"),
               "B7d": ("cphase_sparse_conv_apply", "fused"),
               "B7e": ("phase_sparse_conv_apply", "shared"),
               "B7f": ("shared_concat_sparse_conv_apply", "shared")}
    fns = {key: (lambda fn=getattr(sc, name), p=packs[pk]: fn(x, p))
           for key, (name, pk) in entries.items()}
    fns["sparse_conv_apply"] = lambda: sc.sparse_conv_apply(x, tplan, 2)
    _emit(phase="b7_b4conv", shape=list(BATCH32), k=3, dilation=2, mask="BlockPruner 87.5 %",
          s={pk: p.s for pk, p in packs.items()},
          live_steps={pk: p.nsteps.tolist() for pk, p in packs.items()},
          turns=ab(kernels, fns, iters=5), card=smi)
    del x
    from tpuseg_torch.sparsity.block import BlockConfig, prune_as_block

    w2 = (np.random.default_rng(5).normal(size=(512, 512)) * 0.05).astype(np.float32)
    packed = sc.pack_xw_bsr(w2 * prune_as_block(w2, BlockConfig(0.875, 128, 128, -1, -1, True)))
    packed = packed.to(dev)
    x = torch.randn((P32, 512), generator=gen, device=dev, dtype=torch.bfloat16)
    _emit(phase="b4", x=list(x.shape), w="512x512 BlockPruner 87.5 %",
          live_steps=packed.nsteps.tolist(),
          turns=ab(kernels, {"B4": lambda: sc.bsr_matmul_xw(x, packed)}), card=smi)
    del x
    torch.cuda.empty_cache()
    if args.skip_fps:
        return 0

    # pruned device fps at batch 32, and one profiled batch of the Pallas lowering
    segs = {name: VideoSegmenter(masked, state, spec, MEAN, STD, device=dev,
                                 compute_dtype=torch.bfloat16, batch=32, exec_plans=p)
            for name, p in (("pallas", plans["pallas"]), ("gathered", plans["gathered"]),
                            ("masked_dense", None))}
    fps: dict = {"pallas_old": [], "pallas_new": [], "gathered": [], "masked_dense": []}
    for which in ("old", "new", "new", "old"):
        kernels.use(which)
        fps[f"pallas_{which}"].append(segs["pallas"].benchmark_device_fps(FULL, inner=16, reps=2))
        if which == "new" and len(fps["pallas_new"]) == 1:
            for name in ("gathered", "masked_dense"):
                fps[name].append(segs[name].benchmark_device_fps(FULL, inner=16, reps=2))
    kernels.use("new")
    _emit(phase="pruned_device_fps", config=CONFIG, size=list(FULL), batch=32,
          device_fps=fps, ids_for_ms={k: [32e3 / v for v in vs] for k, vs in fps.items()},
          card=smi)
    frames = torch.zeros((32, FULL[0], FULL[1] * 3), dtype=torch.uint8, device=dev)
    prof = {}
    for which in ("old", "new"):
        kernels.use(which)
        prof[which] = _profile(segs["pallas"], frames)
    kernels.use("new")
    _emit(phase="pallas_profile", device_ms_by_kernel=prof, card=smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
