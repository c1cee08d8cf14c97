"""Temporal serving's keyframe choice (the XLA work of
``tpuseg/video/pipeline.py::program_budget``, ``:670-704``, and of
``program_adaptive``'s scan, ``:614-638``), as hand-written CUDA kernels in
``tpuseg_torch/csrc/temporal.cu``, each with its plain PyTorch version
beside it.

- ``frame_deltas`` (K3): ``d[i] = mean |f[i] - f[i-1]|`` over a batch of
  flat uint8 frames, ``f[-1]`` the carried previous frame.  The |differences|
  are summed exactly in integers, divided once in double by the frame's
  bytes and rounded to f32 (``tpuseg``'s f32 ``jnp.mean`` sums in an order
  XLA picks, so its d can differ in the last bits).
- ``budget_select`` (K4): ``tpuseg``'s scalar scan (accumulated drift since
  the last keyframe; promote when nothing was keyed yet or the drift exceeds
  the threshold, at most ``budget`` a batch) and its slot arithmetic: the
  flags, the forwarded frames' indices ``fwd_idx`` (0 where a slot is not
  filled) and each frame's keyframe slot ``keyslot`` (cumsum(flags) - 1).
- ``frame_deltas_budget`` (K3 + K4): the budgeted mode's selection in one
  launch, K4's scan run by K3's last block over the deltas it has just made.
- ``keyframe_select`` (K5): the sequential adaptive mode's choice, for each
  frame in order the mean |f[i] - kf| against the live keyframe (exact
  integer sum divided in double, as K3), promote when nothing was keyed yet
  or it exceeds the threshold, and the promoted frame becomes the keyframe.
  It depends only on pixels, so a whole batch is chosen before any forward:
  one cooperative launch computes the sums of every frame pair the scan can
  need, chunk by chunk, and runs the scan between grid barriers.

On a CUDA tensor each wrapper launches its kernel on the current stream,
counts it in ``<wrapper>.launches`` and raises if the launch fails; on a CPU
tensor it runs the plain version.  Nothing leaves the device.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpuseg_torch.ops.sparse_conv import _on_device, _raise_on, _raw_stream


def _check_frames(frames: torch.Tensor, prev: torch.Tensor) -> None:
    if frames.dtype != torch.uint8 or prev.dtype != torch.uint8:
        raise TypeError(f"frames and prev must be uint8, got {frames.dtype} and {prev.dtype}")
    if frames.dim() < 2 or tuple(prev.shape) != tuple(frames.shape[1:]):
        raise ValueError(f"prev {tuple(prev.shape)} must be one frame of frames "
                         f"{tuple(frames.shape)}")
    if prev.device != frames.device:
        raise ValueError(f"frames on {frames.device}, prev on {prev.device}")


def frame_deltas_reference(frames: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: the exact int64 sum of |f[i] - f[i-1]| per frame,
    divided in double by the frame's element count, rounded to f32."""
    _check_frames(frames, prev)
    prevs = torch.cat([prev[None], frames[:-1]])
    diff = (frames.to(torch.int16) - prevs.to(torch.int16)).abs_()
    sums = diff.reshape(frames.shape[0], -1).sum(dim=1, dtype=torch.int64)
    return (sums.to(torch.float64) / prev.numel()).to(torch.float32)


def frame_deltas(frames: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """(B,) f32 mean |f[i] - f[i-1]| of uint8 frames (B, ...) against the
    carried previous frame ``prev`` (one frame's shape) for i = 0.

    On a CUDA tensor (both contiguous) it launches K3 (counted in
    ``frame_deltas.launches``); on a CPU tensor it runs
    ``frame_deltas_reference``."""
    _check_frames(frames, prev)
    if frames.device.type == "cpu":
        return frame_deltas_reference(frames, prev)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if not (frames.is_contiguous() and prev.is_contiguous()):
        raise ValueError("frames and prev must be contiguous")
    from tpuseg_torch.ops._build import load_library

    n = frames.shape[0]
    sums = torch.zeros((n + 1,), dtype=torch.int64, device=frames.device)
    d = torch.empty((n,), dtype=torch.float32, device=frames.device)
    lib = load_library()
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        err = lib.tpuseg_frame_deltas(frames.data_ptr(), prev.data_ptr(), sums.data_ptr(),
                                      d.data_ptr(), n, prev.numel(), stream)
    _raise_on(lib, "frame_deltas", err)
    frame_deltas.launches += 1
    return d


frame_deltas.launches = 0


def _check_carry(acc0, n_keyed, budget, nframes: int, device) -> None:
    if (acc0.dtype != torch.float32 or n_keyed.dtype != torch.int32
            or acc0.numel() != 1 or n_keyed.numel() != 1):
        raise ValueError("acc0 must be one f32 value and n_keyed one int32")
    if acc0.device != device or n_keyed.device != device:
        raise ValueError(f"acc0 and n_keyed must be on {device}")
    if not 0 < budget <= nframes:
        raise ValueError(f"budget {budget} must be in 1..{nframes}")


def _check_select(d, acc0, n_keyed, budget) -> None:
    if d.dtype != torch.float32 or d.dim() != 1 or d.numel() == 0:
        raise ValueError(f"d must be a non-empty 1-D f32 tensor, got {d.dtype} {tuple(d.shape)}")
    _check_carry(acc0, n_keyed, budget, d.numel(), d.device)


def budget_select_reference(d: torch.Tensor, acc0: torch.Tensor, n_keyed: torch.Tensor,
                            thresh: float, budget: int):
    """Plain version of K4: ``tpuseg``'s scan in numpy float32 on the host
    (each add rounded to f32, ``thresh`` rounded to f32 once), results on
    d's device."""
    _check_select(d, acc0, n_keyed, budget)
    ds = d.cpu().numpy()
    t = np.float32(thresh)
    acc = acc0.cpu().numpy().reshape(())[()]
    n = int(n_keyed.cpu().reshape(()))
    used = 0
    flags = np.zeros(len(ds), bool)
    fwd_idx = np.zeros(budget, np.int32)
    for i, di in enumerate(ds):
        acc = np.float32(acc + di)
        if (n == 0 or acc > t) and used < budget:
            acc = np.float32(0.0)
            fwd_idx[used] = i
            used += 1
            n += 1
            flags[i] = True
    keyslot = (np.cumsum(flags) - 1).astype(np.int32)
    dev = d.device
    return (torch.from_numpy(flags).to(dev), torch.from_numpy(fwd_idx).to(dev),
            torch.from_numpy(keyslot).to(dev),
            torch.tensor([acc], dtype=torch.float32, device=dev),
            torch.tensor([n], dtype=torch.int32, device=dev))


def budget_select(d: torch.Tensor, acc0: torch.Tensor, n_keyed: torch.Tensor,
                  thresh: float, budget: int):
    """``(flags (B,) bool, fwd_idx (budget,) int32, keyslot (B,) int32,
    acc0 (1,) f32, n_keyed (1,) int32)``: ``tpuseg``'s budgeted keyframe
    choice over the deltas ``d`` from the carried drift ``acc0`` and
    promotion count ``n_keyed`` (0 promotes the first frame).  The carry
    comes back as new tensors; the inputs are not written.

    On a CUDA tensor it launches K4 (counted in ``budget_select.launches``);
    on a CPU tensor it runs ``budget_select_reference``."""
    _check_select(d, acc0, n_keyed, budget)
    if d.device.type == "cpu":
        return budget_select_reference(d, acc0, n_keyed, thresh, budget)
    if d.device.type != "cuda":
        raise ValueError(f"unsupported device {d.device}")
    from tpuseg_torch.ops._build import load_library

    d = d.contiguous()
    n, dev = d.numel(), d.device
    flags = torch.empty((n,), dtype=torch.bool, device=dev)
    fwd_idx = torch.empty((budget,), dtype=torch.int32, device=dev)
    keyslot = torch.empty((n,), dtype=torch.int32, device=dev)
    acc_out = torch.empty((1,), dtype=torch.float32, device=dev)
    n_out = torch.empty((1,), dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tpuseg_budget_select(
            d.data_ptr(), acc0.data_ptr(), n_keyed.data_ptr(), float(thresh),
            budget, n, flags.data_ptr(), fwd_idx.data_ptr(), keyslot.data_ptr(),
            acc_out.data_ptr(), n_out.data_ptr(), stream)
    _raise_on(lib, "budget_select", err)
    budget_select.launches += 1
    return flags, fwd_idx, keyslot, acc_out, n_out


budget_select.launches = 0


def frame_deltas_budget_reference(frames: torch.Tensor, prev: torch.Tensor, acc0: torch.Tensor,
                                  n_keyed: torch.Tensor, thresh: float, budget: int):
    """Plain version of ``frame_deltas_budget``: ``frame_deltas_reference``,
    then ``budget_select_reference`` over its deltas."""
    d = frame_deltas_reference(frames, prev)
    return (d, *budget_select_reference(d, acc0, n_keyed, thresh, budget))


def frame_deltas_budget(frames: torch.Tensor, prev: torch.Tensor, acc0: torch.Tensor,
                        n_keyed: torch.Tensor, thresh: float, budget: int):
    """The budgeted mode's selection over a batch of uint8 frames (B, ...)
    from the carried previous frame ``prev``, drift ``acc0`` and promotion
    count ``n_keyed``: ``(d (B,) f32, flags (B,) bool, fwd_idx (budget,)
    int32, keyslot (B,) int32, acc0 (1,) f32, n_keyed (1,) int32)``, as
    ``frame_deltas`` followed by ``budget_select``.  The inputs are not
    written.

    On a CUDA tensor (frames and prev contiguous) it makes one launch, K3
    whose last block runs K4's scan, counted in
    ``frame_deltas_budget.launches``; the outputs are views of one buffer
    (with K3's sums, which it zeroes).  On a CPU tensor it runs
    ``frame_deltas_budget_reference``."""
    _check_frames(frames, prev)
    _check_carry(acc0, n_keyed, budget, frames.shape[0], frames.device)
    if frames.device.type == "cpu":
        return frame_deltas_budget_reference(frames, prev, acc0, n_keyed, thresh, budget)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if not (frames.is_contiguous() and prev.is_contiguous()):
        raise ValueError("frames and prev must be contiguous")
    from tpuseg_torch.ops._build import load_library

    n, dev = frames.shape[0], frames.device
    sums, d, flags, fwd_idx, keyslot, acc_out, n_out = _budget_buffers(n, budget, dev)
    sums.zero_()
    lib = load_library()
    with _on_device(dev):
        err = lib.tpuseg_frame_deltas_budget(
            frames.data_ptr(), prev.data_ptr(), sums.data_ptr(), d.data_ptr(), n, prev.numel(),
            acc0.data_ptr(), n_keyed.data_ptr(), float(thresh), budget, flags.data_ptr(),
            fwd_idx.data_ptr(), keyslot.data_ptr(), acc_out.data_ptr(), n_out.data_ptr(),
            _raw_stream(dev))
    _raise_on(lib, "frame_deltas_budget", err)
    frame_deltas_budget.launches += 1
    return d, flags, fwd_idx, keyslot, acc_out, n_out


frame_deltas_budget.launches = 0


def _budget_buffers(n: int, budget: int, device) -> tuple:
    """``frame_deltas_budget``'s K3 sums ((n + 1,) int64) and outputs, views
    of one int32 buffer split once (less host time than a slice and a view
    for each output): (sums, d, flags, fwd_idx, keyslot, acc, n_keyed)."""
    sums, d, fwd_idx, keyslot, acc, nk, flags = torch.empty(
        (2 * (n + 1) + 2 * n + budget + 2 + -(-n // 4),), dtype=torch.int32,
        device=device).split_with_sizes([2 * (n + 1), n, budget, n, 1, 1, -(-n // 4)])
    return (sums.view(torch.int64), d.view(torch.float32), flags.view(torch.bool)[:n], fwd_idx,
            keyslot, acc.view(torch.float32), nk)


def _keyframe_buffers(nb: int, scratch: int, device) -> tuple:
    """``keyframe_select``'s scratch ((scratch,) int64, first) and small
    outputs, views of one int32 buffer: (partials, state (3,), flags,
    keyslot, fwd_idx, diffs)."""
    partials, state, keyslot, fwd_idx, diffs, flags = torch.empty(
        (2 * scratch + 3 + 3 * nb + -(-nb // 4),), dtype=torch.int32,
        device=device).split_with_sizes([2 * scratch, 3, nb, nb, nb, -(-nb // 4)])
    return (partials.view(torch.int64), state, flags.view(torch.bool)[:nb], keyslot, fwd_idx,
            diffs.view(torch.float32))


def _check_keyframe(frames, carried, n_keyed) -> None:
    _check_frames(frames, carried)
    if n_keyed.dtype != torch.int32 or n_keyed.numel() != 1 or n_keyed.device != frames.device:
        raise ValueError("n_keyed must be one int32 on the frames' device")
    if frames.shape[0] == 0:
        raise ValueError("frames must hold at least one frame")


def keyframe_select_reference(frames: torch.Tensor, carried: torch.Tensor,
                              n_keyed: torch.Tensor, thresh: float):
    """Plain version of K5: ``tpuseg``'s scan as a loop, each diff the exact
    int64 sum of |f[i] - kf| divided in double by the frame's element
    count and rounded to f32, compared with ``thresh`` rounded to f32."""
    _check_keyframe(frames, carried, n_keyed)
    t = torch.tensor(thresh, dtype=torch.float32)
    nb = frames.shape[0]
    n = int(n_keyed.reshape(()))
    key, used = -1, 0
    flags = torch.zeros(nb, dtype=torch.bool)
    keyslot = torch.empty(nb, dtype=torch.int32)
    fwd_idx = torch.zeros(nb, dtype=torch.int32)
    diffs = torch.empty(nb, dtype=torch.float32)
    for i in range(nb):
        kf = carried if key < 0 else frames[key]
        s = (frames[i].to(torch.int16) - kf.to(torch.int16)).abs_().sum(dtype=torch.int64)
        diffs[i] = (s.to(torch.float64) / carried.numel()).to(torch.float32)
        if n == 0 or bool(diffs[i] > t):
            fwd_idx[used] = i
            used += 1
            n += 1
            key = i
            flags[i] = True
        keyslot[i] = used - 1
    dev = frames.device
    new_kf = (carried if key < 0 else frames[key]).clone()
    return (flags.to(dev), keyslot.to(dev), fwd_idx.to(dev), diffs.to(dev),
            torch.tensor([used], dtype=torch.int32, device=dev),
            torch.tensor([n], dtype=torch.int32, device=dev), new_kf)


def keyframe_select(frames: torch.Tensor, carried: torch.Tensor, n_keyed: torch.Tensor,
                    thresh: float):
    """The sequential adaptive mode's keyframe choice over a batch of uint8
    frames (B, ...) from the carried keyframe ``carried`` (one frame's shape)
    and promotion count ``n_keyed`` (0 promotes the first frame):
    ``(flags (B,) bool, keyslot (B,) int32, fwd_idx (B,) int32, diffs (B,)
    f32, count (1,) int32, n_keyed (1,) int32, keyframe)``.  ``keyslot[i]``
    is the promotions up to frame i - 1 (-1: the carried keyframe);
    ``fwd_idx[:count]`` are the promoted frames in order (the rest
    unspecified); ``keyframe`` is the live keyframe after the batch, a new
    tensor.  The inputs are not written.

    On a CUDA tensor (both frames contiguous) it makes one cooperative
    launch of K5, counted in ``keyframe_select.launches``, and raises if the
    card cannot hold its grid; the small outputs are views of one buffer
    (with the kernel's scratch, which needs no zeroing).  On a CPU tensor it
    runs ``keyframe_select_reference``."""
    _check_keyframe(frames, carried, n_keyed)
    if frames.device.type == "cpu":
        return keyframe_select_reference(frames, carried, n_keyed, thresh)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if not (frames.is_contiguous() and carried.is_contiguous()):
        raise ValueError("frames and the carried keyframe must be contiguous")
    from tpuseg_torch.ops._build import load_library

    nb, dev = frames.shape[0], frames.device
    lib = load_library()
    with _on_device(dev):
        scratch = _keyframe_partials(dev.index)
        partials, state, flags, keyslot, fwd_idx, diffs = _keyframe_buffers(nb, scratch, dev)
        new_kf = torch.empty_like(carried)
        err = lib.tpuseg_keyframe_select(
            frames.data_ptr(), carried.data_ptr(), n_keyed.data_ptr(), state.data_ptr(),
            partials.data_ptr(), scratch, float(thresh), nb, carried.numel(), flags.data_ptr(),
            keyslot.data_ptr(), fwd_idx.data_ptr(), diffs.data_ptr(), new_kf.data_ptr(),
            _raw_stream(dev))
    _raise_on(lib, "keyframe_select", err)
    keyframe_select.launches += 1
    return flags, keyslot, fwd_idx, diffs, state[2:3], state[1:2], new_kf


keyframe_select.launches = 0


@functools.cache
def _keyframe_partials(index: int) -> int:
    """The uint64 scratch K5 needs on CUDA device ``index`` (the current
    one): its pair sums for every block the card holds at once."""
    from tpuseg_torch.ops._build import load_library

    lib = load_library()
    count = ctypes.c_longlong(0)
    _raise_on(lib, "keyframe_select", lib.tpuseg_keyframe_select_partials(ctypes.byref(count)))
    return count.value
