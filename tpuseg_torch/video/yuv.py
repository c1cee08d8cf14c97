"""YUV420 (I420) frame transport (counterpart of ``tpuseg/video/yuv.py``):
1.5 bytes a pixel over the host-to-device link instead of 3, turned back into
RGB on the device by kernel K8 (``csrc/yuv.cu``).

Full-range BT.601 (the JPEG matrix), 2x2 box-mean chroma on the host,
nearest (2x2 repeat) chroma on the device.  Plane packing: one (B, H*3/2, W)
uint8 array; rows [0, H) are Y, rows [H, H + H/4) hold the (H/2, W/2) U
plane row-major (two chroma rows per storage row), the last H/4 rows V the
same way.  Needs H % 4 == 0 and W % 2 == 0.

``rgb_to_i420`` and ``i420_geometry`` are ``tpuseg``'s numpy.  On a CUDA
tensor ``i420_to_rgb_flat`` launches K8 (counted in
``i420_to_rgb_flat.launches``); on a CPU tensor it runs
``i420_to_rgb_flat_reference``, which equals ``tpuseg``'s function bit for
bit (each product and sum rounded on its own, round half to even, clip).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuseg_torch.ops.sparse_conv import _raise_on


def rgb_to_i420(frames: np.ndarray) -> np.ndarray:
    """Host side: (B, H, W, 3) uint8 RGB -> (B, H*3/2, W) uint8 planar I420.

    Full-range BT.601 forward matrix (JPEG):
      Y =  0.299 R + 0.587 G + 0.114 B
      U = -0.168736 R - 0.331264 G + 0.5 B + 128
      V =  0.5 R - 0.418688 G - 0.081312 B + 128
    Chroma is 2x2 box-mean subsampled.
    """
    frames = np.asarray(frames)
    if frames.ndim == 3:
        frames = frames[None]
    b, h, w, _ = frames.shape
    if h % 4 or w % 2:
        raise ValueError(f"I420 packing needs H%4==0 and W%2==0, got {h}x{w}")
    f = frames.astype(np.float32)
    r, g, bl = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * bl
    u = -0.168736 * r - 0.331264 * g + 0.5 * bl + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * bl + 128.0
    u = u.reshape(b, h // 2, 2, w // 2, 2).mean((2, 4))
    v = v.reshape(b, h // 2, 2, w // 2, 2).mean((2, 4))
    out = np.empty((b, h * 3 // 2, w), np.uint8)
    out[:, :h] = np.clip(np.round(y), 0, 255).astype(np.uint8)
    out[:, h:h + h // 4] = np.clip(np.round(u), 0, 255).astype(np.uint8).reshape(b, h // 4, w)
    out[:, h + h // 4:] = np.clip(np.round(v), 0, 255).astype(np.uint8).reshape(b, h // 4, w)
    return out


def i420_geometry(rows: int) -> int:
    """Decode height H from the packed row count H*3/2."""
    if rows % 3:
        raise ValueError(f"not an I420 row count: {rows}")
    return rows * 2 // 3


def _check(x: torch.Tensor) -> tuple[int, int, int]:
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise ValueError(f"I420 frames must be (B, H*3/2, W) uint8, got {x.dtype} "
                         f"{tuple(x.shape)}")
    b, rows, w = x.shape
    h = i420_geometry(rows)
    if h % 4 or w % 2:
        raise ValueError(f"I420 packing needs H%4==0 and W%2==0, got {h}x{w}")
    return b, h, w


def i420_to_rgb_flat_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: ``tpuseg``'s expression in PyTorch ops."""
    b, h, w = _check(x)
    y = x[:, :h].float()
    u = x[:, h:h + h // 4].reshape(b, h // 2, w // 2).float()
    v = x[:, h + h // 4:].reshape(b, h // 2, w // 2).float()
    u = u.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0
    v = v.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    bl = y + 1.772 * u
    rgb = torch.stack([r, g, bl], dim=-1).round_().clamp_(0, 255).to(torch.uint8)
    return rgb.reshape(b, h, w * 3)


def i420_to_rgb_flat(x: torch.Tensor) -> torch.Tensor:
    """(B, H*3/2, W) uint8 I420 -> FLAT (B, H, W*3) uint8 RGB."""
    b, h, w = _check(x)
    if x.device.type == "cpu":
        return i420_to_rgb_flat_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("I420 frames must be contiguous")
    from tpuseg_torch.ops._build import load_library

    out = torch.empty((b, h, w * 3), dtype=torch.uint8, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tpuseg_i420_to_rgb(x.data_ptr(), out.data_ptr(), b, h, w, stream)
    _raise_on(lib, "i420_to_rgb_flat", err)
    i420_to_rgb_flat.launches += 1
    return out


i420_to_rgb_flat.launches = 0
