"""The sparse-conv lowerings timed per conv on one CUDA card (counterpart of
the repo's ``bench_sparse.py``, modes ``main``, ``--fused`` and
``--gathered``).

Every mode times one conv shaped like DRN-D-22's layer 6 (3x3, 512->512,
dilation 2, at the stride-8 grid of one 1024x2048 frame: x (1, 128, 256,
512) bf16), with magnitude BlockPruner masks of 128x128 blocks at 50 / 75 /
87.5 % sparsity, weights and input drawn as ``bench_sparse.py`` draws them
(numpy seed 0):

- ``main`` (run unless ``--fused-only`` or ``--gathered``): the dense conv
  (cuDNN), then the per-tap lowering ``sparse_conv_apply`` (kernel B4 once
  per tap), for a 1x1 conv and the 3x3 conv;
- ``--fused`` / ``--fused-only``: the dense conv, B2
  (``fused_sparse_conv_apply``), B3 (``fused_sparse_conv_apply_q``, static
  scale 0.05) and the six round-3 entry points (B7a-f) at each sparsity,
  then ``phase_sparse_conv_apply`` on an all-ones mask;
- ``--gathered``: the dense conv, the gathered lowering in its three modes
  and B2.

Timing follows ``bench_sparse.py``'s ``timeit``: the FULL output, cast to
x's dtype, is the next call's input (so no call can be skipped or
overlapped, and that cast is inside the timed window), INNER calls between
two CUDA events, best of 3 after one untimed loop; ms per call.
``bench_sparse.py``'s ``rows_per_tile`` and ``out_split`` sweeps were TPU
tiling and are gone: each key times its function once.  ``shared_ms``
(B7a) is the port's addition, so every kernel of the module runs here.
Each result is one JSON line carrying the card's name and power limit.

    python -m tpuseg_torch.bench_sparse [--fused | --fused-only] [--gathered]

It runs on a CUDA card only: without one it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

N, H, W, C = 1, 128, 256, 512
K, DIL = 3, 2
INNER = 50
SPARSITIES = (0.5, 0.75, 0.875)


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

    def timeit(self, one_fn, x: torch.Tensor, reps: int = 3) -> float:
        """ms per call of ``one_fn``, chained on its full output."""
        def loop():
            xc = x
            for _ in range(INNER):
                xc = one_fn(xc).to(xc.dtype)
            return xc

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
            best = min(best, start.elapsed_time(end) / INNER)
        return best

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpuseg_torch.bench_sparse",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--fused", action="store_true", help="also time B2, B3 and B7a-f")
    ap.add_argument("--fused-only", action="store_true", help="time only B2, B3 and B7a-f")
    ap.add_argument("--gathered", action="store_true",
                    help="time the gathered lowering (and skip main)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_sparse: torch.cuda.is_available() is False; the bench needs a CUDA "
              "card", file=sys.stderr)
        return 1
    b = Bench(torch.device("cuda", 0), card_label())
    if not (args.fused_only or args.gathered):
        bench_main(b)
    if args.fused or args.fused_only:
        bench_fused(b)
    if args.gathered:
        bench_gathered(b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
