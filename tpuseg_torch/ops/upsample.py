"""Fused x8 bilinear upsample + argmax for the segmentation head.

Counterpart of ``tpuseg/ops/upsample.py``.  The reference upsampler is a
frozen depthwise ConvTranspose2d(16, stride=8, pad=4) with bilinear weights.
Because stride 8 divides kernel 16 exactly, every output pixel receives
contributions from at most 2 input pixels per axis.  Decomposing by output
phase r = o % 8:

    out[8m + r] = a[r] * xp[m + d(r)] + b[r] * xp[m + d(r) + 1]

with d(r) = (r >= 4), xp zero-padded by one pixel on each side, and the
2-tap weights (a, b) from ``_phase_weights`` (the transposed-conv flip is
part of the index map, so asymmetric kernels are exact too).

- ``upsample8_phase``: the separable phase upsample in the input's dtype
  (``tpuseg``'s XLA formulation), plain PyTorch.
- ``upsample_argmax_reference``: the plain version of the kernel — f32
  interpolation (rows, then columns), argmax over classes (first maximum
  wins), uint8 ids.  It materializes the full-resolution logits.
- ``upsample_argmax``: the serving entry point.  On a CUDA tensor it
  launches the hand-written kernel ``tpuseg_torch/csrc/upsample_argmax.cu``
  (the port of ``tpuseg.ops.upsample.upsample_argmax_pallas``), which never
  materializes them; on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

STRIDE = 8
MAX_CLASSES = 255  # ids are uint8

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _host_kernel(up_kernel) -> np.ndarray:
    """The upsample kernel as host float32 numpy: the phase weights are
    computed on the host, never read back from the device."""
    if isinstance(up_kernel, torch.Tensor):
        if up_kernel.device.type != "cpu":
            raise ValueError(
                "up_kernel must be a CPU tensor or numpy array (the phase "
                f"weights are computed on the host), got {up_kernel.device}")
        up_kernel = up_kernel.detach().numpy()
    return np.asarray(up_kernel, np.float32)


def _kernel_1d(up_kernel: np.ndarray) -> np.ndarray:
    """Extract the separable 1-D factor from the 2-D bilinear kernel.

    fill_up_weights builds k2[i,j] = f(i) * f(j), so f = sqrt(diag(k2))."""
    if up_kernel.ndim == 1:
        return up_kernel
    return np.sqrt(np.diagonal(up_kernel)).astype(np.float32)


def _phase_weights(kernel_1d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-phase 2-tap weights (a[r], b[r]) for r in [0, 8).

    Transposed-conv semantics: y[8m+r] picks kernel taps k[8m+r+4-8i], so
    the two contributing taps are k[15-k0] and k[7-k0] with k0 = (11-r) % 8.
    """
    k0 = (11 - np.arange(STRIDE)) % STRIDE
    return kernel_1d[15 - k0], kernel_1d[7 - k0]


def _upsample_axis(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """Upsample one spatial axis by 8 via the phase decomposition."""
    x = torch.movedim(x, axis, 1)  # (N, L, ...)
    n, L = x.shape[0], x.shape[1]
    rest = tuple(x.shape[2:])
    xp = F.pad(x, (0, 0) * len(rest) + (1, 1))
    p0 = xp[:, 0:L]        # xp[m]
    p1 = xp[:, 1 : L + 1]  # xp[m+1]
    p2 = xp[:, 2 : L + 2]  # xp[m+2]
    shape_r = (1, 1, STRIDE // 2) + (1,) * len(rest)
    lo = p0[:, :, None] * a[:4].reshape(shape_r) + p1[:, :, None] * b[:4].reshape(shape_r)
    hi = p1[:, :, None] * a[4:].reshape(shape_r) + p2[:, :, None] * b[4:].reshape(shape_r)
    out = torch.cat([lo, hi], dim=2).reshape((n, L * STRIDE) + rest)
    return torch.movedim(out, 1, axis)


def upsample8_phase(x: torch.Tensor, up_kernel) -> torch.Tensor:
    """(N, H, W, C) -> (N, 8H, 8W, C) in ``x``'s dtype, identical to the
    depthwise transposed conv with the given (16, 16) kernel."""
    a, b = (
        torch.from_numpy(np.ascontiguousarray(v)).to(device=x.device, dtype=x.dtype)
        for v in _phase_weights(_kernel_1d(_host_kernel(up_kernel)))
    )
    x = _upsample_axis(x, a, b, axis=1)
    return _upsample_axis(x, a, b, axis=2)


def upsample_argmax_reference(seg: torch.Tensor, up_kernel) -> torch.Tensor:
    """Plain version of the kernel: argmax over classes of the f32 x8
    upsample of NHWC ``seg`` -> (N, 8h, 8w) uint8 ids.  Ties go to the
    lowest class index (``torch.argmax`` returns the first maximum).

    Each interpolation is a separate multiply and add, so the card computes
    the same f32 roundings as the kernel and the ids are bit-equal."""
    up = upsample8_phase(seg.float(), up_kernel)
    return torch.argmax(up, dim=-1).to(torch.uint8)


def _check_seg(seg: torch.Tensor) -> None:
    if seg.dim() != 4:
        raise ValueError(f"seg must be (N, h, w, C), got shape {tuple(seg.shape)}")
    if seg.dtype not in _DTYPE_CODE:
        raise TypeError(f"seg must be float32 or bfloat16, got {seg.dtype}")
    if not seg.is_contiguous():
        raise ValueError("seg must be NHWC-contiguous")
    c = seg.shape[3]
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"1..{MAX_CLASSES} classes supported, got {c}")


def _launch(seg: torch.Tensor, ab, out: torch.Tensor) -> int:
    """Launch the kernel on the current stream; returns its cudaError_t."""
    from tpuseg_torch.ops._build import load_library

    n, h, w, c = seg.shape
    with torch.cuda.device(seg.device):
        stream = torch.cuda.current_stream(seg.device).cuda_stream
        return load_library().tpuseg_upsample_argmax(
            seg.data_ptr(), out.data_ptr(), ab, n, h, w, c, _DTYPE_CODE[seg.dtype], stream)


def upsample_argmax(seg: torch.Tensor, up_kernel) -> torch.Tensor:
    """argmax_c(upsample8(seg)) as (N, 8h, 8w) uint8 ids.

    ``seg`` is NHWC-contiguous float32 or bfloat16 logits with at most 255
    classes; ``up_kernel`` the (16, 16) (or 1-D separable) upsample kernel
    on the host.  On a CUDA tensor this launches the CUDA kernel on the
    current stream, counts the launch in ``upsample_argmax.launches`` and
    raises if the launch fails; on a CPU tensor it runs
    ``upsample_argmax_reference``.  Nothing falls back: A/B checks call
    ``upsample_argmax_reference`` by name."""
    _check_seg(seg)
    if seg.device.type == "cpu":
        return upsample_argmax_reference(seg, up_kernel)
    if seg.device.type != "cuda":
        raise ValueError(f"unsupported device {seg.device}")
    from tpuseg_torch.ops._build import load_library

    n, h, w, _ = seg.shape
    a, b = _phase_weights(_kernel_1d(_host_kernel(up_kernel)))
    ab = (ctypes.c_float * 16)(*np.concatenate([a, b]).astype(np.float32).tolist())
    out = torch.empty((n, STRIDE * h, STRIDE * w), dtype=torch.uint8, device=seg.device)
    err = _launch(seg, ab, out)
    if err != 0:
        msg = load_library().tpuseg_cuda_error_string(err).decode()
        raise RuntimeError(f"upsample_argmax kernel launch failed: {msg} ({err})")
    upsample_argmax.launches += 1
    return out


upsample_argmax.launches = 0
