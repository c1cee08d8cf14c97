"""Block motion estimation and id warping for temporal reuse (counterpart of
``tpuseg/video/flow.py``).

Temporal reuse copies a keyframe's class ids; ``--temporal-warp`` instead
estimates a per-block translation keyframe -> frame on pooled luma and
gathers the keyframe's ids along it.

- ``downsample_luma`` and ``pooled_luma``: integer box sums over the flat
  byte layout (PyTorch reduces), and one ``F.interpolate`` of the small maps
  onto the target /8 grid when the decode size differs.
- ``estimate_block_shifts``: kernel K6 (``csrc/flow.cu``), the SAD of every
  (2r+1)^2 shift of the edge-replicated keyframe luma per block, argmin
  (first index on ties), accepted where it beats the zero shift by the
  margin ``accept_frac``.
- ``warp_ids``: kernel K7 (``csrc/flow.cu``), ``tpuseg``'s separable
  roll + select passes as one gather per pixel.

On a CUDA tensor each kernel's wrapper launches it on the current stream and
counts it in ``<wrapper>.launches``; on a CPU tensor it runs the plain
version beside it.  Nothing leaves the device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuseg_torch.ops.sparse_conv import _raise_on


def downsample_luma(frames_u8: torch.Tensor, h: int, w: int, factor: int) -> torch.Tensor:
    """(B, h, w*3) flat or (B, h, w, 3) uint8 -> (B, h//f, w//f) int32
    box-summed luma (channel sum x f*f pixel sum; argmin-equivalent to the
    mean).  h and w must divide by ``factor``."""
    b = frames_u8.shape[0]
    x = frames_u8.reshape(b, h, w // factor, factor * 3).sum(dim=3, dtype=torch.int32)
    return x.reshape(b, h // factor, factor, w // factor).sum(dim=2, dtype=torch.int32)


def pooled_luma(frames_u8: torch.Tensor, grid: tuple[int, int] | None = None) -> torch.Tensor:
    """(B, h, w*3) flat or (B, h, w, 3) uint8 -> (B, h8//8, w8//8) f32
    box-summed luma, the <8-px trailing remainder cropped.  With ``grid``
    the pooled map is resized onto that grid with ``tpuseg``'s bilinear
    (``jax.image.resize``, antialiased when it shrinks: PyTorch's
    antialiased triangle filter, which agrees with it to f32 rounding)."""
    b = frames_u8.shape[0]
    if frames_u8.dim() == 3:
        h, w = frames_u8.shape[1], frames_u8.shape[2] // 3
    else:
        h, w = frames_u8.shape[1], frames_u8.shape[2]
    h8, w8 = h - h % 8, w - w % 8
    raw = frames_u8.reshape(b, h, w, 3)[:, :h8, :w8]
    small = downsample_luma(raw, h8, w8, 8).float()
    if grid is not None and tuple(small.shape[1:]) != tuple(grid):
        small = F.interpolate(small[:, None], size=tuple(grid), mode="bilinear",
                              align_corners=False, antialias=True)[:, 0]
    return small


def _check_luma(key: torch.Tensor, cur: torch.Tensor, radius: int, block: int) -> None:
    if key.dtype != torch.float32 or cur.dtype != torch.float32 or key.dim() != 3:
        raise ValueError(f"luma maps must be (B, hs, ws) f32, got {key.dtype} {tuple(key.shape)}")
    if key.shape != cur.shape or key.device != cur.device:
        raise ValueError(f"key {tuple(key.shape)} on {key.device} and cur {tuple(cur.shape)} "
                         f"on {cur.device} must match")
    _, hs, ws = key.shape
    if hs % block or ws % block:
        raise ValueError(f"luma grid {hs}x{ws} must divide into {block}-blocks")
    if radius < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")


def estimate_block_shifts_reference(key_small: torch.Tensor, cur_small: torch.Tensor, *,
                                    radius: int = 4, block: int = 16,
                                    accept_frac: float = 0.7):
    """Plain version of K6: ``tpuseg``'s SAD volume as ``F.pad``
    (replicate) + ``F.unfold`` + abs/sum/argmin."""
    _check_luma(key_small, cur_small, radius, block)
    b, hs, ws = key_small.shape
    k = 2 * radius + 1
    xp = F.pad(key_small[:, None], (radius,) * 4, mode="replicate")
    patches = F.unfold(xp, (k, k)).reshape(b, k * k, hs, ws)
    sad = (cur_small[:, None] - patches).abs_()
    sad = sad.reshape(b, k * k, hs // block, block, ws // block, block).sum(dim=(3, 5))
    best = sad.argmin(dim=1)
    centre = sad[:, radius * k + radius]
    accept = sad.amin(dim=1) < centre * torch.tensor(accept_frac, dtype=torch.float32)
    zero = torch.zeros_like(best)
    dy = torch.where(accept, radius - torch.div(best, k, rounding_mode="floor"), zero)
    dx = torch.where(accept, radius - best % k, zero)
    return dy.to(torch.int32), dx.to(torch.int32)


def estimate_block_shifts(key_small: torch.Tensor, cur_small: torch.Tensor, *,
                          radius: int = 4, block: int = 16, accept_frac: float = 0.7):
    """Per-block integer translation (dy, dx), each (B, hs//block,
    ws//block) int32 in [-radius, radius], such that cur[y, x] ~= key[y - dy,
    x - dx]: the (2r+1)^2 shifts of the edge-replicated keyframe luma, the
    least SAD (first on ties), accepted only where it is below
    ``accept_frac`` x the zero shift's SAD, else (0, 0).

    On a CUDA tensor it launches K6 (counted in
    ``estimate_block_shifts.launches``); on a CPU tensor it runs
    ``estimate_block_shifts_reference``."""
    _check_luma(key_small, cur_small, radius, block)
    if key_small.device.type == "cpu":
        return estimate_block_shifts_reference(key_small, cur_small, radius=radius, block=block,
                                               accept_frac=accept_frac)
    if key_small.device.type != "cuda":
        raise ValueError(f"unsupported device {key_small.device}")
    if not (key_small.is_contiguous() and cur_small.is_contiguous()):
        raise ValueError("luma maps must be contiguous")
    from tpuseg_torch.ops._build import load_library

    b, hs, ws = key_small.shape
    dy = torch.empty((b, hs // block, ws // block), dtype=torch.int32, device=key_small.device)
    dx = torch.empty_like(dy)
    lib = load_library()
    with torch.cuda.device(key_small.device):
        stream = torch.cuda.current_stream(key_small.device).cuda_stream
        err = lib.tpuseg_block_shifts(key_small.data_ptr(), cur_small.data_ptr(), dy.data_ptr(),
                                      dx.data_ptr(), b, hs, ws, radius, block, float(accept_frac),
                                      stream)
    _raise_on(lib, "estimate_block_shifts", err)
    estimate_block_shifts.launches += 1
    return dy, dx


estimate_block_shifts.launches = 0


def _check_warp(key_ids, dy, dx, scale, block) -> None:
    if key_ids.dtype != torch.uint8 or key_ids.dim() != 3:
        raise ValueError(f"ids must be (B, H, W) uint8, got {key_ids.dtype} "
                         f"{tuple(key_ids.shape)}")
    b, h, w = key_ids.shape
    up = scale * block
    if h % up or w % up:
        raise ValueError(f"ids {h}x{w} must divide into {up}-px blocks (scale {scale} x block "
                         f"{block})")
    want = (b, h // up, w // up)
    for name, t in (("dy", dy), ("dx", dx)):
        if t.dtype != torch.int32 or tuple(t.shape) != want or t.device != key_ids.device:
            raise ValueError(f"{name} must be {want} int32 on {key_ids.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def warp_ids_reference(key_ids: torch.Tensor, dy_blocks: torch.Tensor, dx_blocks: torch.Tensor,
                       *, scale: int, block: int, radius: int = 4) -> torch.Tensor:
    """Plain version of K7: ``tpuseg``'s 2*(2r) roll + where passes."""
    _check_warp(key_ids, dy_blocks, dx_blocks, scale, block)
    _, h, w = key_ids.shape
    up = scale * block
    dy_full = dy_blocks.repeat_interleave(up, 1).repeat_interleave(up, 2)
    dx_full = dx_blocks.repeat_interleave(up, 1).repeat_interleave(up, 2)
    rows = torch.arange(h, device=key_ids.device).reshape(1, h, 1)
    cols = torch.arange(w, device=key_ids.device).reshape(1, 1, w)
    out = key_ids
    for s in range(-radius, radius + 1):
        if s:
            row_ok = (rows >= s * scale) & (rows < h + s * scale)
            out = torch.where((dy_full == s) & row_ok, torch.roll(key_ids, s * scale, 1), out)
    out2 = out
    for s in range(-radius, radius + 1):
        if s:
            col_ok = (cols >= s * scale) & (cols < w + s * scale)
            out2 = torch.where((dx_full == s) & col_ok, torch.roll(out, s * scale, 2), out2)
    return out2


def warp_ids(key_ids: torch.Tensor, dy_blocks: torch.Tensor, dx_blocks: torch.Tensor, *,
             scale: int, block: int, radius: int = 4) -> torch.Tensor:
    """Warp (B, H, W) uint8 keyframe ids by per-block shifts estimated at
    1/``scale`` resolution with ``block``-px blocks: xs = x - dx(y, x)*scale
    where that shift is nonzero, within ``radius`` and its source column in
    the frame, else x; out[y, x] = key[y - dy(y, xs)*scale, xs] under the same
    rule for rows, else key[y, xs] (``tpuseg``'s separable semantics).

    On a CUDA tensor it launches K7 (counted in ``warp_ids.launches``); on a
    CPU tensor it runs ``warp_ids_reference``."""
    _check_warp(key_ids, dy_blocks, dx_blocks, scale, block)
    if key_ids.device.type == "cpu":
        return warp_ids_reference(key_ids, dy_blocks, dx_blocks, scale=scale, block=block,
                                  radius=radius)
    if key_ids.device.type != "cuda":
        raise ValueError(f"unsupported device {key_ids.device}")
    if not (key_ids.is_contiguous() and dy_blocks.is_contiguous() and dx_blocks.is_contiguous()):
        raise ValueError("ids and shifts must be contiguous")
    from tpuseg_torch.ops._build import load_library

    b, h, w = key_ids.shape
    out = torch.empty_like(key_ids)
    lib = load_library()
    with torch.cuda.device(key_ids.device):
        stream = torch.cuda.current_stream(key_ids.device).cuda_stream
        err = lib.tpuseg_warp_ids(key_ids.data_ptr(), dy_blocks.data_ptr(), dx_blocks.data_ptr(),
                                  out.data_ptr(), b, h, w, scale, block, radius, stream)
    _raise_on(lib, "warp_ids", err)
    warp_ids.launches += 1
    return out


warp_ids.launches = 0


def warp_key_ids_to_frames(key_ids: torch.Tensor, key_frames_u8: torch.Tensor,
                           cur_frames_u8: torch.Tensor, *, radius: int = 4,
                           block: int = 16) -> torch.Tensor:
    """For each (keyframe, current) pair, estimate block motion on pooled
    luma and warp the keyframe's ids along it: the pool + grid-resize +
    estimate + warp chain the serving pipeline runs.  ``key_ids`` (B, H, W)
    uint8; the frames (B, h, w*3) flat or (B, h, w, 3), any decode size."""
    h, w = key_ids.shape[1], key_ids.shape[2]
    grid = (h // 8, w // 8)
    ks = pooled_luma(key_frames_u8, grid=grid)
    cs = pooled_luma(cur_frames_u8, grid=grid)
    dy, dx = estimate_block_shifts(ks, cs, radius=radius, block=block)
    return warp_ids(key_ids, dy, dx, scale=8, block=block, radius=radius)
