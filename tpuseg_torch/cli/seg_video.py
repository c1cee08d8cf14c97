"""Video segmentation CLI of the port (counterpart of ``tpuseg/cli/seg_video.py``).

Runs DRNSeg over a video file (decoded by ``video.pipeline.FrameSource``)
or a generated video, batch by batch, and prints one JSON line with the
end-to-end rate (and, with ``--device-fps``, the device rate timed with CUDA
events).  It takes ``tpuseg``'s flags except ``--mesh-devices`` and
``--profile-dir``:
- the weights: random from seed 0 by default, or ``--pretrained`` (an
  npz checkpoint of either package's trainer, e.g. the
  ``<arch>_shapes.npz`` of ``tools/trained_fidelity``, or a reference
  ``.pth``; the classes are the checkpoint head's);
- the model: ``--pr-config-path`` (pruned; a ``sparse_plans`` event first),
  ``--quantize`` [``--calibrate N``] [``--quantize-stem``] (int8; an
  ``int8_plans`` event);
- temporal reuse: ``--temporal N``, ``--temporal-thresh T`` (the sequential
  adaptive mode) [``--temporal-budget K``] (budgeted), ``--temporal-nearest``,
  ``--temporal-warp``, ``--temporal-autotune A`` [``--autotune-frames M``]
  (a ``temporal_autotune`` event), ``--temporal-report`` (agreement with
  the exact run);
- transport and outputs: ``--transport yuv420``, ``--host-resize``,
  ``--ids-pack BITS`` (auto by default, with an ``ids_pack_auto`` event),
  ``--device-outputs``, ``--overlay``, ``--save-dir``.

Usage:
  python -m tpuseg_torch.cli.seg_video --video shapes --size 1024x2048 \\
      --batch 8 --frames 32 --device-fps
  python -m tpuseg_torch.cli.seg_video --video synthetic --size 64x128 \\
      --frames 4 --batch 2 --device cpu
  python -m tpuseg_torch.cli.seg_video --video clip.mp4 --size 128x256 \\
      --pretrained runs/fidelity/drn_d_22_shapes.npz [--device cpu]
  python -m tpuseg_torch.cli.seg_video --video shapes --size 1024x2048 \\
      --batch 8 --frames 32 --device-fps \\
      --pr-config-path optimal_configs/drn_d_22/drn_d_22_block128reg_87.50.json \\
      --sparse-lowering pallas [--quantize --calibrate 8 [--quantize-stem]]
  python -m tpuseg_torch.cli.seg_video --video shapes:1 --size 1024x2048 \\
      --batch 32 --frames 64 --device-fps --temporal-thresh 4.0 \\
      --temporal-budget 8 [--temporal-nearest] [--temporal-warp] [--temporal-report]
  python -m tpuseg_torch.cli.seg_video --video shapes --size 1024x2048 \\
      --frames 32 --batch 8 --temporal-autotune 0.9 --temporal-warp

``--device cuda`` (the default) raises when no CUDA device is present; there
is no silent CPU fallback.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
from collections import Counter

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="tpuseg_torch video segmentation demo")
    p.add_argument("--video", required=True,
                   help="frame source: a video file path, 'shapes[:seed]' (the "
                        "moving-shapes world of tpuseg_torch.data.shapes) or "
                        "'synthetic[:seed]' (uniform random frames), both "
                        "generated at --size")
    p.add_argument("--arch", default="drn_d_22")
    p.add_argument("--classes", type=int, default=19)
    p.add_argument("--pretrained", default=None,
                   help=".npz checkpoint (tpuseg_torch.train.save_checkpoint or "
                        "tpuseg's) or a reference .pth; the classes are its head's")
    p.add_argument("--frames", type=int, default=25,
                   help="number of frames (reference demos use 25)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", default="300x300",
                   help="HxW, e.g. 300x300 (reference) or 1024x2048")
    p.add_argument("--save-dir", default=None, help="save pred_i.png color or overlay images")
    p.add_argument("--overlay", action="store_true",
                   help="blend the prediction over the frame (frame//2 + color//2)")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--host-resize", action="store_true",
                   help="the frames are at --size on the host and no device resize "
                        "runs.  By default frames ship at their decode size and the "
                        "device resizes them to --size (bilinear, half-pixel centres, "
                        "rounded to uint8); the generated sources are made at --size, "
                        "so the flag changes nothing for them")
    p.add_argument("--transport", default="rgb", choices=["rgb", "yuv420"],
                   help="frame bytes over the host->device link: rgb (3 B/px) or "
                        "planar yuv420 (1.5 B/px, turned back into RGB on the device; "
                        "tpuseg_torch.video.yuv).  Chroma is 2x2-subsampled, so ids "
                        "can differ slightly at color edges")
    p.add_argument("--ids-pack", type=int, default=None, metavar="BITS",
                   help="pack the fetched class ids to BITS bits/px on the device "
                        "(tpuseg_torch.ops.idpack; exact, unpacked on the host).  "
                        "Needs a --size width divisible by 8 and the ids-only fetch "
                        "(not --device-outputs).  Default: auto, packing whenever "
                        "eligible and the classes fit 5 bits or fewer; 0 disables, "
                        "8 fetches unpacked bytes")
    p.add_argument("--device-outputs", action="store_true",
                   help="colorize/overlay on the device and fetch the RGB images "
                        "(default: fetch 1-byte/px ids and rebuild color on the host)")
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
                   help="adaptive temporal reuse: a frame is promoted to keyframe when "
                        "its mean |pixel delta| against the last keyframe exceeds T "
                        "(0..255 units); the others reuse the keyframe's ids.  The "
                        "keyframes of a batch are chosen on the device first and one "
                        "forward serves them.  Reports promotion_rate")
    p.add_argument("--temporal-budget", type=int, default=None, metavar="K",
                   help="with --temporal-thresh: budgeted promotion; the mean |delta| "
                        "accumulated since the last keyframe is compared with T, at "
                        "most K keyframes a batch, served by one K-frame forward; "
                        "changes beyond the budget promote in the next batch")
    p.add_argument("--temporal-warp", action="store_true",
                   help="with --temporal N, or with --temporal-thresh + "
                        "--temporal-budget: motion-compensate the reused ids instead "
                        "of copying them: per-block shifts estimated keyframe->frame "
                        "on pooled luma (block matching, evidence-gated) and the "
                        "keyframe's ids shifted along them.  Same keyframe compute.  "
                        "Target dims must divide 128")
    p.add_argument("--temporal-nearest", action="store_true",
                   help="with --temporal N, or with --temporal-thresh + "
                        "--temporal-budget: bidirectional reuse; each non-key frame "
                        "takes ids from the nearest keyframe behind or ahead within "
                        "the batch (by accumulated |delta|).  Zero extra compute.  "
                        "Composes with --temporal-warp")
    p.add_argument("--temporal-autotune", type=float, default=None, metavar="A",
                   help="agreement-targeted autotuning across the temporal modes: on "
                        "an --autotune-frames calibration prefix, run exact serving "
                        "and a cheapest-first ladder of fixed-N cadences (N=8/4/2, "
                        "each with its +nearest variant) and budgeted configs "
                        "(threshold from the prefix's drift, budgets ~1/8..3/4 of "
                        "--batch), and serve with the cheapest candidate whose ids "
                        "agreement with exact is >= A (0..1); exact serving when none "
                        "qualifies.  Replaces --temporal/--temporal-thresh/"
                        "--temporal-budget; a passed --temporal-warp/"
                        "--temporal-nearest rides every candidate")
    p.add_argument("--autotune-frames", type=int, default=32, metavar="M",
                   help="calibration prefix length for --temporal-autotune (>= --batch)")
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


def _is_generated(video: str) -> bool:
    return video.partition(":")[0] in ("shapes", "synthetic")


def open_frames(args, n: int, h: int, w: int, *, fmt: str = "rgb"):
    """Frames of ``args.video``: a decoded file (``FrameSource``, resized on
    the host to (h, w) with ``--host-resize``, as packed I420 planes with
    ``fmt="i420"``), or ``shapes[:seed]`` / ``synthetic[:seed]`` frames
    generated at (h, w), (h, w, 3) uint8."""
    if not _is_generated(args.video):
        from tpuseg_torch.video.pipeline import FrameSource

        if not os.path.exists(args.video):
            raise SystemExit(f"error: video file not found: {args.video}")
        return FrameSource(args.video, size=(h, w) if args.host_resize else None, fmt=fmt)
    kind, _, seed = args.video.partition(":")
    seed = int(seed) if seed else 0
    if kind == "shapes":
        from tpuseg_torch.data.shapes import shapes_video

        return list(shapes_video(max(n, 1), (h, w), seed=seed)[0])
    from tpuseg_torch.video.pipeline import SyntheticFrames

    return SyntheticFrames(max(n, 1), (h, w), seed=seed)


def load_model(args):
    """(params, state, spec): ``--pretrained``'s weights, a reference
    ``.pth`` (``models.torch_import.load_pth``) or an npz checkpoint of
    either package (``tpuseg``'s rule: the spec has no classes, the head's
    weights carry them), else random weights from seed 0 with
    ``--classes``."""
    from tpuseg_torch.models.drn import build_drn_spec
    from tpuseg_torch.models.drnseg import init_drnseg

    if args.pretrained and args.pretrained.endswith(".pth"):
        from tpuseg_torch.models.torch_import import load_pth

        params, state, _meta = load_pth(args.pretrained)
        return params, state, build_drn_spec(args.arch, num_classes=0, naming="seg")
    if args.pretrained:
        from tpuseg_torch.train import load_checkpoint

        params, state, _masks, _opt, _meta = load_checkpoint(args.pretrained)
        return params, state, build_drn_spec(args.arch, num_classes=0, naming="seg")
    return init_drnseg(0, args.arch, args.classes)


def _resolve_ids_pack(args, w: int) -> int | None:
    """``--ids-pack`` policy (``tpuseg``'s): explicit BITS wins (0
    disables), else auto: pack whenever the ids-only fetch is in play (not
    --device-outputs), the width is 8-divisible, and the classes fit 5 bits
    or fewer, announced by an ``ids_pack_auto`` event.  Exact either way."""
    if args.ids_pack is not None:
        return args.ids_pack if args.ids_pack > 0 else None
    if args.device_outputs or w % 8:
        return None
    bits = max(1, (args.classes - 1).bit_length())
    if bits > 5:
        return None
    print(json.dumps({"event": "ids_pack_auto", "bits": bits, "classes": args.classes}))
    return bits


def main(argv=None) -> tuple[dict, dict]:
    """Runs the CLI; returns the printed result line and ``run()``'s result
    (the served ids among it)."""
    args = parse_args(argv)
    from tpuseg_torch.device import resolve_device
    from tpuseg_torch.video.pipeline import VideoSegmenter

    device = resolve_device(args.device)
    h, w = (int(v) for v in args.size.lower().split("x"))
    mean = [float(v) for v in args.mean.split(",")]
    std = [float(v) for v in args.std.split(",")]

    # resolved once, before the other events: the event line must not repeat
    # for autotune's segmenters
    ids_bits = _resolve_ids_pack(args, w)
    params, state, spec = load_model(args)
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
    autotune = args.temporal_autotune is not None
    if autotune and (args.temporal > 1 or args.temporal_thresh is not None
                     or args.temporal_budget is not None):
        raise SystemExit("error: --temporal-autotune replaces --temporal/--temporal-thresh/"
                         "--temporal-budget")
    # calibration and the autotune prefix take the first frames, served or
    # not: generate enough for all (frame t of either source does not depend
    # on the count); a file decodes from its start on each pass
    prefix = max(args.autotune_frames, args.batch) if autotune else 0
    n_frames = max(args.frames, args.calibrate, prefix)
    frames = open_frames(args, n_frames, h, w)
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
        device_outputs=args.device_outputs,
        target_size=None if args.host_resize else (h, w),
        transport=args.transport,
        ids_bits=ids_bits,
    )
    autotune_res = None
    if autotune:
        from tpuseg_torch.video.autotune import autotune_budget

        def make_segmenter(**temporal_kw):
            if temporal_kw:
                # candidates are measured as they would serve, warp/nearest
                # included; the exact baseline carries no temporal options
                temporal_kw.setdefault("temporal_warp", args.temporal_warp)
                temporal_kw.setdefault("temporal_nearest", args.temporal_nearest)
            return VideoSegmenter(params, state, spec, mean, std, **serve_kw, **temporal_kw)

        autotune_res = autotune_budget(
            make_segmenter, list(itertools.islice(frames, prefix)),
            target_agreement=args.temporal_autotune, batch=args.batch,
            # a forced --temporal-nearest already rides every candidate
            include_nearest=not args.temporal_nearest,
        )
        print(json.dumps({"event": "temporal_autotune", **autotune_res}))
        ck = autotune_res["choice_kwargs"]
        if ck:
            args.temporal = ck.get("temporal_interval", 1)
            args.temporal_thresh = ck.get("temporal_thresh")
            args.temporal_budget = ck.get("temporal_budget")
            args.temporal_nearest = args.temporal_nearest or ck.get("temporal_nearest", False)
            args.temporal_warp = args.temporal_warp or ck.get("temporal_warp", False)
        else:
            # exact serving: warp/nearest apply to temporal modes only
            args.temporal_warp = args.temporal_nearest = False
    seg = VideoSegmenter(
        params, state, spec, mean, std,
        want_overlay=args.overlay,
        temporal_interval=args.temporal,
        temporal_thresh=args.temporal_thresh,
        temporal_budget=args.temporal_budget,
        temporal_nearest=args.temporal_nearest,
        temporal_warp=args.temporal_warp,
        **serve_kw,
    )
    if args.quantize:
        kinds = Counter(type(plan).__name__ for plan in seg.exec_plans.values())
        event = {"event": "int8_plans", "kinds": kinds, "calibrated_frames": len(calib or ())}
        if args.quantize_stem:
            event["int8_stem"] = True
        print(json.dumps(event))
    # with the yuv420 transport a file decodes straight to I420 planes (the
    # native decoder emits them with no RGB detour); generated sources and
    # runs that save images keep RGB on the host
    served = frames
    if args.transport == "yuv420" and not _is_generated(args.video) and not args.save_dir:
        served = open_frames(args, n_frames, h, w, fmt="i420")
    # color and overlay images are made only when they are saved
    result = seg.run(served, max_frames=args.frames, need_color=bool(args.save_dir))
    if result["frames"] == 0:
        raise SystemExit(f"error: no frames decoded from {args.video}")
    if args.save_dir:
        from PIL import Image

        os.makedirs(args.save_dir, exist_ok=True)
        for i, img in enumerate(result["color"]):
            Image.fromarray(img).save(os.path.join(args.save_dir, f"pred_{i}.png"))
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
        if args.temporal_warp:
            line["temporal_warp"] = True
        if args.temporal_nearest:
            line["temporal_nearest"] = True
    if autotune_res is not None:
        line["autotune_target"] = args.temporal_autotune
        line["autotune_choice"] = autotune_res["choice"]
        line["autotune_budget"] = autotune_res["temporal_budget"]
    if args.temporal_thresh is not None:
        line["temporal_thresh"] = args.temporal_thresh
        line["promotion_rate"] = round(result["promotion_rate"], 4)
        if args.temporal_budget is not None:
            line["temporal_budget"] = args.temporal_budget
            if args.temporal_warp:
                line["temporal_warp"] = True
            if args.temporal_nearest:
                line["temporal_nearest"] = True
    if args.device_fps:
        if args.temporal_thresh is not None:
            # the adaptive rate depends on the content: measure on the served
            # frames themselves, from a fresh carry
            dev = seg.benchmark_adaptive_device_fps(list(itertools.islice(frames, args.frames)))
            line["device_fps"] = round(dev["device_fps"], 2)
            line["device_promotion_rate"] = round(dev["promotion_rate"], 4)
        else:
            line["device_fps"] = round(seg.benchmark_device_fps((h, w)), 2)
    if args.temporal_report and (args.temporal > 1 or args.temporal_thresh is not None):
        # fidelity: the exact per-frame run on the same frames
        from tpuseg_torch.ops.quant import ids_agreement

        seg_full = VideoSegmenter(params, state, spec, mean, std, **serve_kw)
        full = seg_full.run(frames, max_frames=args.frames, need_color=False)
        n = min(len(result["ids"]), len(full["ids"]))
        line["temporal_ids_agreement"] = round(
            ids_agreement(result["ids"][:n], full["ids"][:n]), 4)
        line["full_fps"] = round(full["fps"], 2)
        if args.device_fps:
            line["full_device_fps"] = round(seg_full.benchmark_device_fps((h, w)), 2)
    print(json.dumps(line))
    return line, result


if __name__ == "__main__":
    main()
