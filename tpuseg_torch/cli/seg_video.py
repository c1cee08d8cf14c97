"""Video segmentation CLI of the port (counterpart of ``tpuseg/cli/seg_video.py``:
dense or pruned, float or int8 with or without the int8 stem, exact or with
batched temporal reuse).

Runs DRNSeg with random weights from seed 0 over a generated video, batch by
batch, and prints one JSON line with the end-to-end rate (and, with
``--device-fps``, the device rate timed with CUDA events).  With
``--pr-config-path`` it serves the pruned model: masks from the pruner
config (masker seed 0), applied to the weights, and every eligible masked
conv lowered to a sparse plan; a ``{"event": "sparse_plans", ...}`` line
comes before the result line.  With ``--quantize`` the eligible convs of
stages 4-8 (and the sparse plans that have an int8 lowering) run in int8,
with activation scales per frame or, with ``--calibrate N``, static scales
calibrated on the first N frames; an ``{"event": "int8_plans", ...}`` line
counts the plans by kind.  ``--quantize-stem`` (with ``--quantize``) runs
the three folded stem convs in int8 too.  ``--temporal N`` forwards every
Nth frame and reuses its ids; ``--temporal-thresh T --temporal-budget K``
picks up to K content-chosen keyframes a batch on the device (the result
line gains ``promotion_rate``); ``--temporal-report`` also runs the exact
pipeline on the same frames and reports the ids agreement.

Usage:
  python -m tpuseg_torch.cli.seg_video --video shapes --size 1024x2048 \\
      --batch 8 --frames 32 --device-fps
  python -m tpuseg_torch.cli.seg_video --video synthetic --size 64x128 \\
      --frames 4 --batch 2 --device cpu
  python -m tpuseg_torch.cli.seg_video --video shapes --size 1024x2048 \\
      --batch 8 --frames 32 --device-fps \\
      --pr-config-path optimal_configs/drn_d_22/drn_d_22_block128reg_87.50.json \\
      --sparse-lowering pallas
  python -m tpuseg_torch.cli.seg_video --video shapes --size 1024x2048 \
      --batch 8 --frames 32 --device-fps --quantize --calibrate 8 \
      [--pr-config-path optimal_configs/drn_d_22/drn_d_22_block128reg_87.50.json \
       --sparse-lowering pallas] [--quantize-stem]
  python -m tpuseg_torch.cli.seg_video --video shapes:1 --size 1024x2048 \
      --batch 32 --frames 64 --device-fps --temporal-thresh 4.0 \
      --temporal-budget 8 [--temporal-report]

``--device cuda`` (the default) raises when no CUDA device is present; there
is no silent CPU fallback.
"""

from __future__ import annotations

import argparse
import itertools
import json
from collections import Counter

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="tpuseg_torch video segmentation demo")
    p.add_argument("--video", required=True,
                   help="frame source: 'shapes[:seed]' (the moving-shapes "
                        "world of tpuseg_torch.data.shapes) or "
                        "'synthetic[:seed]' (uniform random frames), both "
                        "generated at --size")
    p.add_argument("--arch", default="drn_d_22")
    p.add_argument("--classes", type=int, default=19)
    p.add_argument("--frames", type=int, default=25,
                   help="number of frames (reference demos use 25)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", default="300x300",
                   help="HxW, e.g. 300x300 (reference) or 1024x2048")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--mean", default="0.290,0.328,0.287")
    p.add_argument("--std", default="0.183,0.187,0.184")
    p.add_argument("--pr-config-path", default=None,
                   help="serve a PRUNED model: generate masks from this "
                        "JSON pruner config (e.g. optimal_configs/drn_d_22/"
                        "*.json), apply them, and run eligible layers "
                        "through the sparse lowering")
    p.add_argument("--sparse-lowering", default="gathered",
                   choices=("gathered", "pallas"),
                   help="sparse execution family for --pr-config-path: "
                        "'gathered' (channel gather + small dense cuDNN "
                        "convs) or 'pallas' (the fused block-sparse CUDA "
                        "kernel, the port of tpuseg's Pallas kernel)")
    p.add_argument("--gathered-mode", default="exact",
                   choices=("exact", "split"),
                   help="gathered-lowering form: 'exact' (per-out-block "
                        "supports; dead out-blocks emit zeros with no conv) "
                        "or 'split' (uniform repeat-padded supports)")
    p.add_argument("--quantize", action="store_true",
                   help="int8 serving: stride-1 convs of stages 4-8 with >= 128 "
                        "channels run in int8 (symmetric PTQ, per-output-channel "
                        "weight scales; tpuseg_torch.ops.quant), and with "
                        "--pr-config-path the sparse plans that have an int8 "
                        "lowering too.  Changes numerics: compare ids with the "
                        "float run (tpuseg_torch.ops.quant.ids_agreement)")
    p.add_argument("--quantize-stem", action="store_true",
                   help="with --quantize: run the three polyphase stem convs in int8 "
                        "too (kernel B3).  conv0's activation scale is analytic (the "
                        "exact normalize bounds); the others calibrate with "
                        "--calibrate or take per-frame scales")
    p.add_argument("--calibrate", type=int, default=0, metavar="N",
                   help="with --quantize: static activation scales calibrated on "
                        "the first N frames of --video (default: per-frame scales)")
    p.add_argument("--temporal", type=int, default=1, metavar="N",
                   help="temporal reuse: run the network only on every Nth frame of "
                        "a batch (keyframes); the frames between reuse the preceding "
                        "keyframe's ids.  Approximate: measure with --temporal-report")
    p.add_argument("--temporal-thresh", type=float, default=None, metavar="T",
                   help="with --temporal-budget: content-chosen keyframes.  A frame "
                        "is promoted when the mean |pixel delta| accumulated since the "
                        "last keyframe exceeds T (0..255 units); reports "
                        "promotion_rate (the sequential mode without a budget is not "
                        "ported yet)")
    p.add_argument("--temporal-budget", type=int, default=None, metavar="K",
                   help="with --temporal-thresh: at most K keyframes a batch, chosen "
                        "on the device and served by one K-frame forward; changes "
                        "beyond the budget promote in the next batch")
    p.add_argument("--temporal-report", action="store_true",
                   help="with --temporal N or --temporal-thresh T: also run the exact "
                        "pipeline on the same frames and report temporal_ids_agreement "
                        "and its fps")
    p.add_argument("--device-fps", action="store_true",
                   help="also report the device rate at --size (CUDA events "
                        "over back-to-back dependent batches; CUDA only)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    return p.parse_args(argv)


def open_frames(video: str, n: int, h: int, w: int):
    """``shapes[:seed]`` or ``synthetic[:seed]`` frames, (h, w, 3) uint8."""
    kind, _, seed = video.partition(":")
    seed = int(seed) if seed else 0
    if kind == "shapes":
        from tpuseg_torch.data.shapes import shapes_video

        return list(shapes_video(max(n, 1), (h, w), seed=seed)[0])
    if kind == "synthetic":
        from tpuseg_torch.video.pipeline import SyntheticFrames

        return SyntheticFrames(max(n, 1), (h, w), seed=seed)
    raise SystemExit(
        f"error: --video {video!r}: the port reads 'shapes[:seed]' or "
        "'synthetic[:seed]' (no video files yet)")


def main(argv=None):
    args = parse_args(argv)
    from tpuseg_torch.device import resolve_device
    from tpuseg_torch.models.drnseg import init_drnseg
    from tpuseg_torch.video.pipeline import VideoSegmenter

    device = resolve_device(args.device)
    h, w = (int(v) for v in args.size.lower().split("x"))
    mean = [float(v) for v in args.mean.split(",")]
    std = [float(v) for v in args.std.split(",")]

    params, state, spec = init_drnseg(0, args.arch, args.classes)
    exec_plans = None
    if args.pr_config_path:
        from tpuseg_torch.models.sparse_exec import build_sparse_plans
        from tpuseg_torch.ops.fold_bn import fold_bn
        from tpuseg_torch.sparsity import apply_masks, create_masker

        masker = create_masker(args.pr_config_path, seed=0)
        masks = masker.generate_masks(params)
        params = apply_masks(params, masks)
        # plans are packed from the BN-folded masked weights: the same
        # values VideoSegmenter's own fold produces from (params, state)
        exec_plans, report = build_sparse_plans(
            fold_bn(params, state, spec), masks, spec,
            lowering=args.sparse_lowering, gathered_mode=args.gathered_mode,
        )
        n_sparse = sum(1 for v in report.values() if not v.startswith("dense"))
        print(json.dumps({"event": "sparse_plans", "lowered": n_sparse,
                          "total_masked": len(report),
                          "lowering": args.sparse_lowering,
                          "gathered_mode": args.gathered_mode}))
    if args.calibrate and not args.quantize:
        raise SystemExit("error: --calibrate needs --quantize")
    if args.quantize_stem and not args.quantize:
        raise SystemExit("error: --quantize-stem needs --quantize")
    # calibration takes the first --calibrate frames, served or not: generate
    # enough for both (frame t of either source does not depend on the count)
    frames = open_frames(args.video, max(args.frames, args.calibrate), h, w)
    calib = None
    if args.quantize and args.calibrate > 0:
        calib = list(itertools.islice(frames, args.calibrate))
    serve_kw = dict(
        device=device,
        compute_dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        batch=args.batch,
        exec_plans=exec_plans,
        quantize=args.quantize,
        quantize_stem=args.quantize_stem,
        calib_frames=calib,
    )
    seg = VideoSegmenter(
        params, state, spec, mean, std,
        temporal_interval=args.temporal,
        temporal_thresh=args.temporal_thresh,
        temporal_budget=args.temporal_budget,
        **serve_kw,
    )
    if args.quantize:
        kinds = Counter(type(plan).__name__ for plan in seg.exec_plans.values())
        event = {"event": "int8_plans", "kinds": kinds, "calibrated_frames": len(calib or ())}
        if args.quantize_stem:
            event["int8_stem"] = True
        print(json.dumps(event))
    result = seg.run(frames, max_frames=args.frames, need_color=False)
    if result["frames"] == 0:
        raise SystemExit(f"error: no frames from {args.video}")
    line = {
        "frames": result["frames"],
        "seconds": round(result["seconds"], 4),
        "fps": round(result["fps"], 2),
        "size": f"{h}x{w}",
        "arch": args.arch,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
    }
    if args.temporal > 1:
        line["temporal_interval"] = args.temporal
    if args.temporal_thresh is not None:
        line["temporal_thresh"] = args.temporal_thresh
        line["promotion_rate"] = round(result["promotion_rate"], 4)
        line["temporal_budget"] = args.temporal_budget
    if args.device_fps:
        if args.temporal_thresh is not None:
            # the budgeted rate depends on the content: measure on the served
            # frames themselves, from a fresh carry
            served = list(itertools.islice(open_frames(args.video, args.frames, h, w),
                                           args.frames))
            dev = seg.benchmark_adaptive_device_fps(served)
            line["device_fps"] = round(dev["device_fps"], 2)
            line["device_promotion_rate"] = round(dev["promotion_rate"], 4)
        else:
            line["device_fps"] = round(seg.benchmark_device_fps((h, w)), 2)
    if args.temporal_report and (args.temporal > 1 or args.temporal_thresh is not None):
        # fidelity: the exact per-frame run on the same frames
        from tpuseg_torch.ops.quant import ids_agreement

        seg_full = VideoSegmenter(params, state, spec, mean, std, **serve_kw)
        full = seg_full.run(open_frames(args.video, args.frames, h, w),
                            max_frames=args.frames, need_color=False)
        n = min(len(result["ids"]), len(full["ids"]))
        line["temporal_ids_agreement"] = round(
            ids_agreement(result["ids"][:n], full["ids"][:n]), 4)
        line["full_fps"] = round(full["fps"], 2)
        if args.device_fps:
            line["full_device_fps"] = round(seg_full.benchmark_device_fps((h, w)), 2)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
