"""Video segmentation CLI of the port (counterpart of ``tpuseg/cli/seg_video.py``,
exact mode).

Runs DRNSeg with random weights from seed 0 over a generated video, batch by
batch, and prints one JSON line with the end-to-end rate (and, with
``--device-fps``, the device rate timed with CUDA events).

Usage:
  python -m tpuseg_torch.cli.seg_video --video shapes --size 1024x2048 \\
      --batch 8 --frames 32 --device-fps
  python -m tpuseg_torch.cli.seg_video --video synthetic --size 64x128 \\
      --frames 4 --batch 2 --device cpu

``--device cuda`` (the default) raises when no CUDA device is present; there
is no silent CPU fallback.
"""

from __future__ import annotations

import argparse
import json

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
    seg = VideoSegmenter(
        params, state, spec, mean, std,
        device=device,
        compute_dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        batch=args.batch,
    )
    frames = open_frames(args.video, args.frames, h, w)
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
    if args.device_fps:
        line["device_fps"] = round(seg.benchmark_device_fps((h, w)), 2)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
