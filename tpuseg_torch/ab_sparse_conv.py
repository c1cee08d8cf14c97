"""A/B of the port's hand-written kernels against other builds of them, on
one card in one process, so that the two are timed under the same clocks
and neighbours.

    python -m tpuseg_torch.ab_sparse_conv [--old OLD_sparse_conv.cu]
        [--old-q OLD_sparse_conv_q.cu] [--old-quantize OLD_quantize.cu]
        [--old-stem OLD_sparse_conv_q.cu OLD_sparse_conv_q_narrow.cu]
        [--old-bsr OLD_bsr_matmul.cu] [--old-up OLD_upsample_argmax.cu]
        [--old-temporal OLD_temporal.cu] [--old-flow OLD_flow.cu]
        [--old-yuv OLD_yuv.cu] [--skip-fps]

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
  y cast and biased in PyTorch) at w = 256 (1024x2048 frames) and w = 128
  (512x1024 frames, x (32, 64, 128, 512)); B2's two training roles,
  ``sparse_conv_train_forward`` and ``sparse_conv_train_dgrad``, at that
  conv's crop-512, batch-8 shape (8, 64, 64, 512) d=4 on random weights
  on its mask; B7a-f on the bench's 3x3 d=2 conv at 87.5 %
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
  A copy without the narrow route (``sparse_conv_q_narrow.cu``) runs a
  narrow conv as the padded route did: x quantized through a -1 channel
  map to 128 channels, B3 on the conv's weights zero-padded to 128-channel
  blocks, the padded output channels sliced off (``padded_route``).  So
  ``--old-q`` also times that route against the narrow one at
  cifar_resnet20's three 3x3 convs (16 on 32x32, 32 on 16x16, 64 on 8x8,
  f32, batch 64) and at the int8 stem's conv0 ((32, 256, 512, 48) bf16 ->
  256, relu, static scale).
- ``--old-quantize`` (``quantize.cu``): the quantize pass through each of
  the four ``CompactSparseQ`` maps of block128reg_87.50's Pallas lowering
  at its batch-32 input, per-frame and static, conv0's pass (the old build
  through its -1 map to 128 channels, the new one unpadded) and the
  unmapped served pass of ``layer.6.1.conv2``.
- ``--old-stem`` (B3's two kernels, ``sparse_conv_q.cu`` and
  ``sparse_conv_q_narrow.cu``, from a build before the int8 stem's
  hand-off): the old build runs B3 as it did (its ``_launch_b3``: a
  packing by its channels to the 128-wide or the narrow copy) and the int8
  stem conv by conv, each quantizing its own x and writing bf16
  (``per_conv_stem``: conv1 and conv2 on the 128-wide kernel).  It times,
  on the inputs a calibrated bf16 batch-32 int8-stem frontend gives its
  three convs (1024x2048 shapes frames): each conv's route static (the new
  build as the frontend runs it, handing int8 on; the old one on the bf16
  x, writing bf16) and per frame, the whole stem static and per frame and
  the int8 frontend's ms a batch, the old and new outputs compared bit for
  bit where they compute the same thing (the per-frame convs, the stems,
  the frontend); then the unmapped quantize pass at ``layer.6.1.conv2``.
- ``--old-q``, ``--old-quantize`` and ``--old-stem`` also time the
  128-wide served int8 step at ``layer.6.1.conv2`` and, unless
  ``--skip-fps``, the device fps at batch 32 of ``int8_stem`` (dense int8
  calibrated, with the int8 stem) and of ``sparse_int8`` under the Pallas
  lowering with each build.
- ``--old-temporal`` (K3, K4 and K5, ``temporal.cu``, from a build before
  K5's one launch; ``old_temporal``: the parent's wrappers, K3 and K4 two
  launches, K5 a launch a frame and a copy, after three fills): K5 at
  ``(8, 1024, 6144)``, back to back and with its promoted count read after
  each call as the sequential mode serves it, and the budgeted selection
  at ``(32, 1024, 6144)`` (the old build's K3 and K4 against the new one
  launch), the two builds' outputs compared; unless ``--skip-fps``, the
  sequential mode's adaptive device fps (dense bf16, batch 8, the 32
  shapes frames of seed 0, ``drift_threshold`` of the first 8) and
  ``sparse_int8_budget8``'s (block128reg_87.50 gathered, int8 calibrated
  on 8 frames, batch 32, K = 8, 64 shapes frames of seed 1) through
  ``benchmark_adaptive_device_fps`` with each build.
- ``--old-flow`` (K6 and K7, ``flow.cu``; the C interface is unchanged, so
  ``old_flow`` launches the copy through the current wrappers' host code):
  the two builds' outputs compared, then K6 at the serving luma (32, 128,
  256) f32 (the 32 shapes frames of seed 0 against their interval-4
  keyframes) and K7 at (32, 1024, 2048) uint8 with K6's shifts and with
  random shifts in [-6, 6], in turns (old, new, new, old) twice, back to
  back and as device time (``graph_ms``); unless ``--skip-fps``, the device
  fps of interval 4 + nearest + warp (dense bf16, batch 32) with each
  build, beside interval 4 + nearest without the warp.
- ``--old-yuv`` (K8, ``yuv.cu``; the C interface is unchanged, so
  ``old_yuv`` puts the copy behind the current wrapper's own host code):
  the two builds' outputs compared, then K8 on random I420 planes at
  (8, 1024x2048), (8, 512x1024) and (32, 1024x2048) in turns (old, new,
  new, old) twice, back to back and as device time (``graph_ms``); unless
  ``--skip-fps``, the dense bf16 device fps at batch 32 with
  ``transport="yuv420"`` with each build.
- ``--old-bsr`` (kernels B5/B6, ``bsr_matmul.cu``): ``bsr_matmul`` and
  ``bsr_matmul_gathered`` at x (512, 2**20) with the 512x512 87.5 % W,
  beside ``torch.mm(..., out_dtype=torch.float32)``.
- ``--old-up`` (kernel B1, ``upsample_argmax.cu``): B1 at the serving
  logits (32, 128, 256, 19) in bf16 and f32, the dense device fps at batch
  32 (1024x2048, bf16) with each build, and ``torch.profiler``'s device time
  per kernel name over one dense batch with each.

An old copy whose entry point predates a change of its C interface (B2
without ``steps``/``nsteps``/``bias``, or without ``rows_per_tile``, B3 without the step lists and the
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
import types

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
BATCH32_HALF = (32, 64, 128, 512)  # layer.6.1.conv2's input at 512x1024 frames
TRAIN_SHAPE = (8, 64, 64)  # the trainer's stride-8 maps: crop 512, batch 8
P32 = 32 * 128 * 256
# per kernel: (source, C entry points, a parameter only the newer interface has)
SOURCES = {"b2": ("sparse_conv.cu", ("tpuseg_sparse_conv",), "const void* nsteps"),
           "b3": ("sparse_conv_q.cu", ("tpuseg_sparse_conv_q",), "const void* nsteps"),
           "stem_q": ("sparse_conv_q.cu", ("tpuseg_sparse_conv_q",), "const void* nsteps"),
           "stem_narrow": ("sparse_conv_q_narrow.cu", ("tpuseg_sparse_conv_q_narrow",),
                           "float next_scale"),
           "quantize": ("quantize.cu", ("tpuseg_absmax", "tpuseg_quantize"),
                        "const void* vecs"),
           "bsr": ("bsr_matmul.cu", ("tpuseg_bsr_matmul",), "int nnzb"),
           "up": ("upsample_argmax.cu", ("tpuseg_upsample_argmax",), "void* stream"),
           "temporal": ("temporal.cu", ("tpuseg_frame_deltas", "tpuseg_budget_select",
                                        "tpuseg_keyframe_select"), "tpuseg_frame_deltas_budget"),
           "flow": ("flow.cu", ("tpuseg_block_shifts", "tpuseg_warp_ids"), "void* stream"),
           "yuv": ("yuv.cu", ("tpuseg_i420_to_rgb",), "void* stream")}
SERVING_LOGITS = (32, 128, 256, 19)


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def build_old(copies: dict) -> dict:
    """Build the old copies (kernel -> path) into one library, each entry
    point renamed ``<name>_old``; -> kernel -> (C function, or the tuple of
    them, newer ABI?)."""
    first = next(iter(copies.values()))
    build = os.path.join(os.path.dirname(os.path.abspath(first)), "ab_old_build")
    src_dir = os.path.join(build, "src")
    os.makedirs(src_dir, exist_ok=True)
    for name in os.listdir(src_dir):
        os.remove(os.path.join(src_dir, name))
    shutil.copy(os.path.join(_build.SRC_DIR, "hopper.cuh"), src_dir)
    newer = {}
    for kernel, path in copies.items():
        fname, symbols, marker = SOURCES[kernel]
        src = open(path).read()
        newer[kernel] = marker in src
        if kernel == "b2" and "int rows_per_tile" in src:
            newer[kernel] = 2  # B2 whose caller names the tile's rows
        for symbol in symbols:
            src = src.replace(f'extern "C" int {symbol}(', f'extern "C" int {symbol}_old(')
        with open(os.path.join(src_dir, fname.replace(".cu", "_old.cu")), "w") as fh:
            fh.write(src)
    lib = ctypes.CDLL(_build.build_library(src_dir, build)[0])
    out = {}
    for kernel in copies:
        fns = tuple(getattr(lib, symbol + "_old") for symbol in SOURCES[kernel][1])
        for fn in fns:
            fn.restype = ctypes.c_int
        out[kernel] = (fns[0] if len(fns) == 1 else fns, newer[kernel])
    return out


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def old_b2(fn, newer: int):
    """A launcher with ``sc._launch_b2``'s signature on the old B2 copy
    (``newer``: 0 without steps, 1 with steps and the bf16 epilogue, 2 with
    ``rows_per_tile`` too)."""
    fn.argtypes = ([ctypes.c_void_p] * (7 if newer else 4)
                   + [ctypes.c_int] * {0: 9, 1: 10, 2: 11}[int(newer)] + [ctypes.c_void_p])

    def launch(x, p, kernel, dilation, cout, bias=None, bf16_out=False, rows_per_tile=None):
        if not newer and bf16_out:
            raise ValueError("the old kernel has no bf16 epilogue")
        x = x.to(p.vals.dtype)
        n, h, w, cin = x.shape
        out = torch.empty((n, h, w, cout), device=x.device,
                          dtype=torch.bfloat16 if bf16_out else torch.float32)
        dt = sc._DTYPE_CODE[p.vals.dtype]
        if newer:
            # the old build's rule: floor(256 / w) rows, not clamped to h
            rows = ([max(1, sc.B2_TILE_PIXELS // w) if rows_per_tile is None else rows_per_tile]
                    if newer == 2 else [])
            err = fn(x.data_ptr(), p.vals.data_ptr(), p.rows.data_ptr(), p.steps.data_ptr(),
                     p.nsteps.data_ptr(), None if bias is None else bias.data_ptr(),
                     out.data_ptr(), n, h, w, cin, cout, p.s, kernel, dilation, dt,
                     int(bf16_out), *rows, _stream(x))
        else:
            err = fn(x.data_ptr(), p.vals.data_ptr(), p.rows.data_ptr(), out.data_ptr(),
                     n, h, w, cin, cout, p.s, kernel, dilation, dt, _stream(x))
        if err != 0:
            raise RuntimeError(f"old sparse_conv launch failed ({err})")
        return out

    return launch


def old_b3(fn, newer: bool):
    """A launcher with ``sc._launch_b3``'s signature on the old B3 copy (its
    128-wide route alone)."""
    fn.argtypes = ([ctypes.c_void_p] * (9 if newer else 6) + [ctypes.c_int] * (9 if newer else 8)
                   + [ctypes.c_void_p])

    def launch(xq, xs, plan, bias, bf16_out, relu=False):
        if not newer and (bf16_out or relu):
            raise ValueError("the old kernel has no bf16 or relu epilogue")
        if plan.narrow:
            raise ValueError("the old kernel has no narrow route: see padded_route")
        n, h, w, cin = xq.shape
        out = torch.empty((n, h, w, plan.cout), device=xq.device,
                          dtype=torch.bfloat16 if bf16_out else torch.float32)
        if newer:
            err = fn(xq.data_ptr(), plan.vals_k.data_ptr(), plan.rows.data_ptr(),
                     plan.steps.data_ptr(), plan.nsteps.data_ptr(), plan.w_scale.data_ptr(),
                     xs.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
                     n, h, w, cin, plan.cout, plan.s, plan.kernel, plan.dilation,
                     2 * int(relu) + int(bf16_out), _stream(xq))
        else:
            err = fn(xq.data_ptr(), plan.vals_k.data_ptr(), plan.rows.data_ptr(),
                     plan.w_scale.data_ptr(), xs.data_ptr(), out.data_ptr(),
                     n, h, w, cin, plan.cout, plan.s, plan.kernel, plan.dilation, _stream(xq))
        if err != 0:
            raise RuntimeError(f"old sparse_conv_q launch failed ({err})")
        return out

    return launch


def old_quantize(fns, _newer: bool):
    """A ``sc.quantize_activation`` on the old quantize copy (entries
    without the vector descriptor; the caller zeroes absmax): the map is
    read element by element."""
    absmax_fn, quantize_fn = fns
    absmax_fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
                          + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    quantize_fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 2
                            + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 3
                            + [ctypes.c_void_p])

    def quantize(x, x_scale, chan=None, *, vecs=None):
        n, cx = x.shape[0], x.shape[-1]
        cq = cx if chan is None else chan.numel()
        xq = torch.empty(x.shape[:-1] + (cq,), dtype=torch.int8, device=x.device)
        xs = torch.empty((n,), dtype=torch.float32, device=x.device)
        absmax = None if x_scale is not None else torch.zeros(n, dtype=torch.int32,
                                                              device=x.device)
        cptr = None if chan is None else chan.data_ptr()
        shape = (n, x.numel() // (n * cx), cx, cq, sc._DTYPE_CODE[x.dtype], _stream(x))
        if absmax is not None and absmax_fn(x.data_ptr(), cptr, absmax.data_ptr(), *shape):
            raise RuntimeError("old absmax launch failed")
        if quantize_fn(x.data_ptr(), cptr, None if absmax is None else absmax.data_ptr(),
                       0.0 if x_scale is None else float(x_scale), xq.data_ptr(),
                       xs.data_ptr(), *shape):
            raise RuntimeError("old quantize launch failed")
        return xq, xs

    return quantize


def old_stem_b3(q, narrow):
    """The ``_launch_b3`` of a build before the int8 stem's hand-off, on
    its two B3 copies (``q``, ``narrow``: (C function, newer ABI?) each):
    a packing whose blocks are 128 wide over channels that divide by 128
    goes to the 128-wide copy (epilogue modes 0-3), any other to the
    narrow copy (its entry without the hand-off's scale)."""
    q_fn, narrow_fn = q[0], narrow[0]
    if narrow[1]:
        raise ValueError("--old-stem takes a narrow kernel from before the int8 hand-off")
    q_fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    narrow_fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 13 + [ctypes.c_void_p]

    def launch(xq, xs, plan, bias, bf16_out, relu=False, next_scale=None):
        if next_scale is not None:
            raise ValueError("the old build has no int8 hand-off")
        mode = 2 * int(relu) + int(bf16_out)
        n, h, w, cin = xq.shape
        out = torch.empty((n, h, w, plan.cout), device=xq.device,
                          dtype=torch.bfloat16 if bf16_out else torch.float32)
        ptrs = (None if bias is None else bias.data_ptr(), out.data_ptr())
        if (plan.bk, plan.bm) == (128, 128) and plan.cin % 128 == 0 and plan.cout % 128 == 0:
            err = q_fn(xq.data_ptr(), plan.vals_k.data_ptr(), plan.rows.data_ptr(),
                       plan.steps.data_ptr(), plan.nsteps.data_ptr(), plan.w_scale.data_ptr(),
                       xs.data_ptr(), *ptrs, n, h, w, cin, plan.cout, plan.s, plan.kernel,
                       plan.dilation, mode, _stream(xq))
        else:
            err = narrow_fn(xq.data_ptr(), plan.vals_k.data_ptr(), plan.steps.data_ptr(),
                            plan.nsteps.data_ptr(), plan.w_scale.data_ptr(), xs.data_ptr(),
                            *ptrs, n, h, w, cin, plan.cout, plan.s, plan.kernel, plan.dilation,
                            plan.bk, plan.bm, *sc.b3_narrow_tile(n, h, w), mode, _stream(xq))
        if err != 0:
            raise RuntimeError(f"old B3 launch failed ({err})")
        return out

    return launch


def per_conv_stem(fe, x):
    """``PolyphaseFrontend._stem_convs`` as builds before the int8 stem's
    hand-off ran it: each stem conv quantizes its own x (at its scale) and
    writes the frontend dtype, through the stem route the module uses."""
    import dataclasses

    from tpuseg_torch.ops import polyphase

    if not fe.int8_stem:
        for wp, bias, plo, phi in fe.convs:
            x = torch.nn.functional.relu_(polyphase._conv(x, wp, bias, plo, phi))
        return x
    x = polyphase.nchw_to_nhwc(x)
    for i, (plan, bias) in enumerate(fe.q_plans):
        xs = fe._stem_x_scale(i)
        if plan.x_scale != xs:
            plan = dataclasses.replace(plan, x_scale=xs)
        x = polyphase.fused_sparse_conv_q_bias_relu(x, plan, bias, fe.dtype)
    return polyphase.nhwc_to_nchw(x)


_PADDED = {}


def padded_packing(packed):
    """The padded route's operands for a narrow packing (cached): its weights
    zero-padded to 128-channel blocks (``full_support_packing``, scale 1 on
    the padded columns) and the quantize pass's channel map, x's channels
    then -1s up to the padded width, with its vectors (None, None when cin
    divides by 128)."""
    key = id(packed)
    if key not in _PADDED:
        from tpuseg_torch.ops.quant import full_support_packing

        k, S, bk, bm = packed.kernel, packed.s, packed.bk, packed.bm
        nmb = -(-packed.cout // bm)
        dense = packed.vals.cpu().reshape(nmb, k * k, S * bk, bm).permute(1, 2, 0, 3).reshape(
            k, k, S * bk, nmb * bm)[:, :, :packed.cin, :packed.cout].numpy()
        cin_p, cout_p = -(-packed.cin // 128) * 128, -(-packed.cout // 128) * 128
        w = np.zeros((k, k, cin_p, cout_p), np.int8)
        w[:, :, :packed.cin, :packed.cout] = dense
        ws = np.ones(cout_p, np.float32)
        ws[:packed.cout] = packed.w_scale.reshape(-1)[:packed.cout].cpu().numpy()
        pp = full_support_packing("padded", w, ws, packed.dilation,
                                  packed.dilation * (k - 1) // 2, packed.x_scale)
        chan = None if cin_p == packed.cin else torch.cat(
            [torch.arange(packed.cin), torch.full((cin_p - packed.cin,), -1)]).to(torch.int32)
        dev = packed.vals.device
        chan = None if chan is None else chan.to(dev)
        vecs = None if chan is None else sc.channel_map_vectors(chan)
        _PADDED[key] = (pp.to(dev), chan, vecs, packed)
    return _PADDED[key][:3]


def padded_route(x, packed, bias=None, relu=False, bf16_out=False):
    """A narrow conv as the builds before B3's narrow route ran it: x
    quantized through the -1 map to 128 channels (``sc.quantize_activation``),
    one launch of the 128-wide B3 (``sc._launch_b3``) on the padded
    packing, the padded output channels sliced off.  f32 y, or with
    ``relu`` relu(y + bias) (f32 bias) as f32 or bf16."""
    import dataclasses

    pp, chan, vecs = padded_packing(packed)
    if pp.x_scale != packed.x_scale:
        pp = dataclasses.replace(pp, x_scale=packed.x_scale)
    xq, xs = sc.quantize_activation(x, pp.x_scale, chan, vecs=vecs)
    if bias is not None and pp.cout != packed.cout:
        bias = torch.nn.functional.pad(bias, (0, pp.cout - packed.cout))
    y = sc._launch_b3(xq, xs, pp, bias, bf16_out, relu)
    return y[..., :packed.cout].contiguous() if pp.cout != packed.cout else y


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


def old_temporal(fns, newer: bool) -> dict:
    """The budgeted selection and K5 as builds before K5's one launch ran
    them, on the old copy's three entries (``fns``): K3 then K4, each
    allocating its outputs; K5 after zero-filling its sums, finish counters
    and ``fwd_idx``, a launch a frame and one copy.  name -> a function with
    the new wrapper's signature."""
    if newer:
        raise ValueError("--old-temporal takes a temporal.cu from before K5's one launch")
    deltas, select, keyframe = fns
    p, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    deltas.argtypes = [p, p, p, p, i32, i64, p]
    select.argtypes = [p, p, p, f32, i32, i32, p, p, p, p, p, p]
    keyframe.argtypes = [p] * 6 + [f32, i32, i64] + [p] * 6
    lib = _build.load_library()  # its error strings

    def frame_deltas_budget(frames, prev, acc0, n_keyed, thresh, budget):
        n, dev = frames.shape[0], frames.device
        sums = torch.zeros((n + 1,), dtype=torch.int64, device=dev)
        d = torch.empty((n,), dtype=torch.float32, device=dev)
        sc._raise_on(lib, "old frame_deltas", deltas(
            frames.data_ptr(), prev.data_ptr(), sums.data_ptr(), d.data_ptr(), n, prev.numel(),
            _stream(frames)))
        flags = torch.empty((n,), dtype=torch.bool, device=dev)
        fwd_idx = torch.empty((budget,), dtype=torch.int32, device=dev)
        keyslot = torch.empty((n,), dtype=torch.int32, device=dev)
        acc_out = torch.empty((1,), dtype=torch.float32, device=dev)
        n_out = torch.empty((1,), dtype=torch.int32, device=dev)
        sc._raise_on(lib, "old budget_select", select(
            d.data_ptr(), acc0.data_ptr(), n_keyed.data_ptr(), float(thresh), budget, n,
            flags.data_ptr(), fwd_idx.data_ptr(), keyslot.data_ptr(), acc_out.data_ptr(),
            n_out.data_ptr(), _stream(frames)))
        return d, flags, fwd_idx, keyslot, acc_out, n_out

    def keyframe_select(frames, carried, n_keyed, thresh):
        nb, dev = frames.shape[0], frames.device
        state = torch.empty((3,), dtype=torch.int32, device=dev)
        sums = torch.zeros((nb,), dtype=torch.int64, device=dev)
        done = torch.zeros((nb,), dtype=torch.int32, device=dev)
        flags = torch.empty((nb,), dtype=torch.bool, device=dev)
        keyslot = torch.empty((nb,), dtype=torch.int32, device=dev)
        fwd_idx = torch.zeros((nb,), dtype=torch.int32, device=dev)
        diffs = torch.empty((nb,), dtype=torch.float32, device=dev)
        new_kf = torch.empty_like(carried)
        sc._raise_on(lib, "old keyframe_select", keyframe(
            frames.data_ptr(), carried.data_ptr(), n_keyed.data_ptr(), state.data_ptr(),
            sums.data_ptr(), done.data_ptr(), float(thresh), nb, carried.numel(),
            flags.data_ptr(), keyslot.data_ptr(), fwd_idx.data_ptr(), diffs.data_ptr(),
            new_kf.data_ptr(), _stream(frames)))
        return flags, keyslot, fwd_idx, diffs, state[2:3], state[1:2], new_kf

    return {"frame_deltas_budget": frame_deltas_budget, "keyframe_select": keyframe_select}


def old_flow(fns, _newer: bool) -> dict:
    """K6 and K7 on the old copy's two entries (``fns``; the C interface is
    the new one's), with the new wrappers' host code: name -> a function
    with the new wrapper's signature."""
    from tpuseg_torch.video import flow

    shifts_fn, warp_fn = fns
    lib = _build.load_library()
    shifts_fn.argtypes = lib.tpuseg_block_shifts.argtypes
    warp_fn.argtypes = lib.tpuseg_warp_ids.argtypes

    def estimate_block_shifts(key_small, cur_small, *, radius=4, block=16, accept_frac=0.7):
        flow._check_luma(key_small, cur_small, radius, block)
        b, hs, ws = key_small.shape
        dy, dx = torch.empty((2, b, hs // block, ws // block), dtype=torch.int32,
                             device=key_small.device).unbind(0)
        sc._raise_on(lib, "old estimate_block_shifts", shifts_fn(
            key_small.data_ptr(), cur_small.data_ptr(), dy.data_ptr(), dx.data_ptr(), b, hs, ws,
            radius, block, float(accept_frac), _stream(key_small)))
        return dy, dx

    def warp_ids(key_ids, dy_blocks, dx_blocks, *, scale, block, radius=4):
        flow._check_warp(key_ids, dy_blocks, dx_blocks, scale, block)
        b, h, w = key_ids.shape
        out = torch.empty_like(key_ids)
        sc._raise_on(lib, "old warp_ids", warp_fn(
            key_ids.data_ptr(), dy_blocks.data_ptr(), dx_blocks.data_ptr(), out.data_ptr(), b, h,
            w, scale, block, radius, _stream(key_ids)))
        return out

    return {"estimate_block_shifts": estimate_block_shifts, "warp_ids": warp_ids}


def old_yuv(fn, _newer: bool) -> dict:
    """K8's old copy (``fn``; the C interface is the new one's) behind the
    new wrapper's own host code: a stand-in for the library that
    ``video/yuv.py`` loads, with the old entry in the new one's place."""
    lib = _build.load_library()
    fn.argtypes = lib.tpuseg_i420_to_rgb.argtypes
    old_lib = types.SimpleNamespace(tpuseg_i420_to_rgb=fn,
                                    tpuseg_cuda_error_string=lib.tpuseg_cuda_error_string)
    return {"yuv_library": lambda: old_lib}


def _quantize_plain(x, x_scale, chan=None):
    """The PyTorch quantize pass, with the channel map the kernels take."""
    return sc.quantize_activation_reference(
        x if chan is None else x.index_select(x.dim() - 1, chan), x_scale)


class Kernels:
    """Switches the package between the new kernels and the old copies:
    ``use("old")`` points each kernel's launcher at its old copy, turns off
    the bf16 routes an old copy does not have and, with an old B3, runs
    narrow convs on the padded route (``padded_route``); ``active`` says
    which is in use."""

    def __init__(self, olds: dict):
        from tpuseg_torch.models import drn
        from tpuseg_torch.ops import polyphase, quant
        from tpuseg_torch.video import pipeline, yuv

        self.drn, self.quant, self.poly, self.pipe, self.yuv = drn, quant, polyphase, pipeline, yuv
        self.active = "new"
        self.new = {"b2": sc._launch_b2, "b3": sc._launch_b3, "bsr": bsr._launch,
                    "up": up._launch, "quantize": sc.quantize_activation,
                    "route": drn._sparse_conv_bias_bf16, "qconv": quant.quant_conv_apply,
                    "stem": polyphase.fused_sparse_conv_q_bias_relu,
                    "stem_convs": polyphase.PolyphaseFrontend._stem_convs,
                    "keyframe_select": pipeline.keyframe_select,
                    "frame_deltas_budget": pipeline.frame_deltas_budget,
                    "estimate_block_shifts": pipeline.estimate_block_shifts,
                    "warp_ids": pipeline.warp_ids, "yuv_library": yuv.load_library}
        self.old = {}
        if "temporal" in olds:
            self.old.update(old_temporal(*olds["temporal"]))
        if "flow" in olds:
            self.old.update(old_flow(*olds["flow"]))
        if "yuv" in olds:
            self.old.update(old_yuv(*olds["yuv"]))
        if "b2" in olds:
            self.old["b2"] = old_b2(*olds["b2"])
        if "b3" in olds:
            self.old["b3"] = old_b3(*olds["b3"])
            if not olds["b3"][1]:  # a build before the quantize kernels quantized in PyTorch
                self.old["quantize"] = _quantize_plain
            new_qconv, new_stem = self.new["qconv"], self.new["stem"]

            def qconv(x, plan, bias=None, bf16_bias=False):
                if not plan.packed.narrow:
                    return new_qconv(x, plan, bias, bf16_bias)
                y = padded_route(x, plan.packed)
                return sc.cast_bias_bf16(y, bias) if bf16_bias else y

            def stem(x, plan, bias, out_dtype):
                if not plan.narrow:
                    return new_stem(x, plan, bias, out_dtype)
                return padded_route(x, plan, bias.float(), True, out_dtype == torch.bfloat16)

            self.old["qconv"], self.old["stem"] = qconv, stem
            self.old["stem_convs"] = per_conv_stem
        if "stem_q" in olds:
            self.old["b3"] = old_stem_b3(olds["stem_q"], olds["stem_narrow"])
            self.old["stem_convs"] = per_conv_stem
        if "quantize" in olds:
            self.old["quantize"] = old_quantize(*olds["quantize"])
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
        self.active = which
        funcs = {**self.new, **(self.old if which == "old" else {})}
        sc._launch_b2, sc._launch_b3, bsr._launch = funcs["b2"], funcs["b3"], funcs["bsr"]
        up._launch = funcs["up"]
        sc.quantize_activation = funcs["quantize"]
        self.quant.quant_conv_apply = funcs["qconv"]
        self.poly.fused_sparse_conv_q_bias_relu = funcs["stem"]
        self.poly.PolyphaseFrontend._stem_convs = funcs["stem_convs"]
        self.pipe.keyframe_select = funcs["keyframe_select"]
        self.pipe.frame_deltas_budget = funcs["frame_deltas_budget"]
        self.pipe.estimate_block_shifts = funcs["estimate_block_shifts"]
        self.pipe.warp_ids = funcs["warp_ids"]
        self.yuv.load_library = funcs["yuv_library"]
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


def graph_ms(fn, iters: int) -> float:
    """Device ms of one call of ``fn``: ``iters`` calls captured in one CUDA
    graph (after a warm call outside it), replayed 3 times between CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def ab(kernels: Kernels, fns: dict, iters: int = 10, rounds: int = 1) -> dict:
    """name -> {"old": [ms, ...], "new": [ms, ...]}: each callable timed with
    the old kernels, the new, the new and the old, ``rounds`` times over."""
    out = {name: {"old": [], "new": []} for name in fns}
    for which in ("old", "new", "new", "old") * rounds:
        kernels.use(which)
        for name, fn in fns.items():
            out[name][which].append(_time_ms(fn, iters))
    kernels.use("new")
    return out


def _median_ratios(turns: dict) -> dict:
    """name -> the median of the new build's turns over the old's."""
    return {name: float(np.median(t["new"]) / np.median(t["old"])) for name, t in turns.items()}


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


def _train_turns(kernels: Kernels, params, spec, gen, dev) -> dict:
    """B2's forward and dgrad on ``layer.6.1.conv2``'s training packings
    (``build_sparse_train_structs`` of the config's masks) at
    ``TRAIN_SHAPE``, random weights on the mask, in turns (old, new, new,
    old)."""
    from tpuseg_torch.ops import sparse_train as tst
    from tpuseg_torch.sparsity import create_masker

    masks = create_masker(CONFIG, seed=0).generate_masks(params)
    plan = tst.build_sparse_train_structs(masks, spec)[0]["layer.6.1.conv2"].to(dev)
    st = plan.struct
    mask = masks["layer.6.1.conv2.weight"].to(dev)
    wt = torch.randn((st.cout, st.cin, st.kernel, st.kernel), generator=gen, device=dev) * mask
    vals = tst.pack_vals(wt, plan, torch.bfloat16)
    vals_t = tst._transpose_vals(vals, plan)
    xt = torch.randn(TRAIN_SHAPE + (st.cin,), generator=gen, device=dev, dtype=torch.bfloat16)
    dyt = torch.randn(TRAIN_SHAPE + (st.cout,), generator=gen, device=dev, dtype=torch.bfloat16)
    turns = ab(kernels, {"forward": lambda: tst.sparse_conv_train_forward(xt, vals, plan),
                         "dgrad": lambda: tst.sparse_conv_train_dgrad(dyt, vals_t, plan)},
               iters=50, rounds=4)
    return {"shape": list(TRAIN_SHAPE) + [st.cin], "dilation": st.dilation,
            "rows_per_tile": sc.b2_tile_rows(TRAIN_SHAPE[2], TRAIN_SHAPE[1]), "turns": turns,
            "new_over_old": _median_ratios(turns)}


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


R20_CONVS = ((16, 32), (32, 16), (64, 8))  # cifar_resnet20's 3x3 convs: (channels, map side)
R20_BATCH = 64
CONV0 = ((32, 256, 512, 48), 256, 0.03)  # the int8 stem's conv0: x, cout, static scale


def _narrow_turns(kernels: Kernels, gen, dev) -> dict:
    """B3's narrow route (new) against the padded route (an old B3 build)
    at cifar_resnet20's three 3x3 convs (f32, batch 64, per-frame scales,
    ``quant_conv_apply``) and the int8 stem's conv0 (bf16, relu(y + bias)
    as bf16, static scale, the stem route), in turns; the two builds'
    outputs compared bit for bit."""
    import dataclasses

    from tpuseg_torch.ops.quant import QuantConv, int8_packing, quantize_weight

    rng = np.random.default_rng(16)
    fns, shapes = {}, {}
    for c, side in R20_CONVS:
        wq, ws = quantize_weight(rng.normal(size=(3, 3, c, c)).astype(np.float32))
        qc = QuantConv(torch.from_numpy(wq), torch.from_numpy(ws), 1, 1, 1, None,
                       int8_packing("r20", wq, ws, 1, 1)).to(dev)
        xr = torch.randn((R20_BATCH, side, side, c), generator=gen, device=dev)
        fns[f"r20_{c}"] = lambda xr=xr, qc=qc: kernels.quant.quant_conv_apply(xr, qc)
        shapes[f"r20_{c}"] = list(xr.shape)
    (shape0, cout0, xs0) = CONV0
    wq, ws = quantize_weight(rng.normal(size=(3, 3, shape0[3], cout0)).astype(np.float32))
    p0 = dataclasses.replace(int8_packing("conv0", wq, ws, 1, 1), x_scale=xs0).to(dev)
    x0 = torch.randn(shape0, generator=gen, device=dev, dtype=torch.bfloat16)
    b0 = torch.randn(cout0, generator=gen, device=dev)
    fns["stem_conv0"] = lambda: kernels.poly.fused_sparse_conv_q_bias_relu(x0, p0, b0,
                                                                           torch.bfloat16)
    shapes["stem_conv0"] = list(shape0)
    same = {}
    for name, fn in fns.items():
        kernels.use("old")
        old = fn()
        kernels.use("new")
        same[name] = bool(torch.equal(old, fn()))
        del old
    turns = ab(kernels, fns, iters=20, rounds=2)
    # the same calls captured in a CUDA graph: the routes' device time,
    # without the host work that paces the small convs' calls above
    graph = {name: {"old": [], "new": []} for name in fns}
    for which in ("old", "new", "new", "old"):
        kernels.use(which)
        for name, fn in fns.items():
            graph[name][which].append(graph_ms(fn, 5 if name == "stem_conv0" else 20))
    kernels.use("new")
    return {"shapes": shapes, "old_equals_new": same, "turns": turns,
            "new_over_old": _median_ratios(turns), "graph_turns": graph,
            "graph_new_over_old": _median_ratios(graph)}


def _quantize_turns(kernels: Kernels, pallas_plans: dict, folded: dict, gen, dev, x) -> dict:
    """The quantize pass with each build: through the four ``CompactSparseQ``
    maps of the Pallas lowering at their batch-32 input (per-frame and
    static), conv0's input (static; the old build through its -1 map to 128
    channels, the new one through its narrow packing's map to 64) and the
    unmapped served pass of ``layer.6.1.conv2`` (``x``, per-frame), in
    turns."""
    from tpuseg_torch.models.sparse_exec import CompactSparseQ, quantize_sparse_plans
    from tpuseg_torch.ops.quant import int8_packing

    fns, live = {}, {}
    for name, p in quantize_sparse_plans(pallas_plans).items():
        if not isinstance(p, CompactSparseQ):
            continue
        p = p.to(dev)
        cin = folded[f"{name}.weight"].shape[1]
        xm = torch.randn(BATCH32[:3] + (cin,), generator=gen, device=dev, dtype=torch.bfloat16)
        live[name] = p.live_in32.numel()
        fns[f"{name}_per_frame"] = (lambda xm=xm, p=p: sc.quantize_activation(
            xm, None, p.live_in32, vecs=p.live_vecs))
        fns[f"{name}_static"] = (lambda xm=xm, p=p: sc.quantize_activation(
            xm, 0.013, p.live_in32, vecs=p.live_vecs))
    (shape0, cout0, xs0) = CONV0
    x0 = torch.randn(shape0, generator=gen, device=dev, dtype=torch.bfloat16)
    chan128 = torch.cat([torch.arange(shape0[3]), torch.full((128 - shape0[3],), -1)]).to(
        device=dev, dtype=torch.int32)
    p0 = int8_packing("conv0", np.zeros((3, 3, shape0[3], cout0), np.int8),
                      np.ones(cout0, np.float32), 1, 1).to(dev)
    # the old build pads conv0's x to 128 channels, the new one to the narrow
    # route's 64 (the packing's map: its -1s are zero vectors)
    vecs128 = sc.channel_map_vectors(chan128)
    fns["stem_conv0"] = lambda: sc.quantize_activation(
        x0, xs0, *((chan128, vecs128) if kernels.active == "old" else (p0.in_chan, p0.in_vecs)))
    fns["unmapped_served"] = lambda: sc.quantize_activation(x, None)
    turns = ab(kernels, fns, iters=10, rounds=2)
    return {"live_channels": live, "turns": turns, "new_over_old": _median_ratios(turns)}


def _stem_turns(kernels: Kernels, seg, frames) -> dict:
    """``--old-stem``: the int8 stem's routes with each build, in turns, on
    the inputs the calibrated int8-stem frontend ``seg.stem_fn`` gives its
    three convs on ``frames`` (recorded with the new build): each conv
    static (new: as the frontend runs it, handing int8 on; old: on the bf16
    x the conv before wrote, writing bf16) and per frame (both builds on
    that bf16 x), the whole stem static and per frame, and the int8
    frontend; the two builds' outputs compared bit for bit where both
    compute the same tensor."""
    import copy
    import dataclasses

    from tpuseg_torch.ops import polyphase as poly

    fe = seg.stem_fn
    log = []
    orig = poly.fused_sparse_conv_q_bias_relu

    def record(x, plan, bias, out_dtype, *, xs=None, next_scale=None):
        log.append((x, plan, bias, xs, next_scale))
        return orig(x, plan, bias, out_dtype, xs=xs, next_scale=next_scale)

    kernels.use("new")
    poly.fused_sparse_conv_q_bias_relu = record
    try:
        with torch.inference_mode():
            fe(frames)
    finally:
        poly.fused_sparse_conv_q_bias_relu = orig
    scales = [fe._stem_x_scale(i) for i in range(len(log))]
    # the float x each conv reads without the hand-off: conv0's, then the
    # bf16 output of the conv before
    xf = [log[0][0]]
    for i in range(len(log) - 1):
        p = dataclasses.replace(log[i][1], x_scale=scales[i])
        xf.append(sc.fused_sparse_conv_q_bias_relu(xf[i], p, log[i][2], torch.bfloat16))
    fns, shapes = {}, {}
    for i, (xrec, plan, bias, xs, nxt) in enumerate(log):
        ps = dataclasses.replace(plan, x_scale=scales[i])
        pd = dataclasses.replace(plan, x_scale=None)

        def static(x=xf[i], xrec=xrec, plan=plan, ps=ps, bias=bias, xs=xs, nxt=nxt):
            if kernels.active == "new":
                return sc.fused_sparse_conv_q_bias_relu(xrec, plan, bias, torch.bfloat16, xs=xs,
                                                        next_scale=nxt)
            return sc.fused_sparse_conv_q_bias_relu(x, ps, bias, torch.bfloat16)

        fns[f"conv{i}_static"] = static
        fns[f"conv{i}_per_frame"] = (lambda x=xf[i], pd=pd, bias=bias:
                                     sc.fused_sparse_conv_q_bias_relu(x, pd, bias,
                                                                      torch.bfloat16))
        shapes[f"conv{i}"] = {"x": list(xf[i].shape), "new_x_in": str(xrec.dtype),
                              "new_out": "int8" if nxt is not None else "bfloat16",
                              "packing": [plan.bk, plan.bm, plan.s],
                              "live_steps": int(plan.nsteps.sum())}
    per_frame = copy.copy(fe)
    per_frame.stem_x_scales, per_frame._stem_chain = None, None
    xn = poly.nhwc_to_nchw(xf[0])
    fns["stem_static"] = lambda: fe._stem_convs(xn)
    fns["stem_per_frame"] = lambda: per_frame._stem_convs(xn)
    fns["frontend_int8"] = lambda: fe(frames)
    same = {}
    with torch.inference_mode():
        for name, fn in fns.items():
            if name.endswith("_static") and name.startswith("conv"):
                continue  # int8 against bf16: not the same tensor
            kernels.use("old")
            old = fn()
            kernels.use("new")
            same[name] = bool(torch.equal(old, fn()))
            del old
        turns = ab(kernels, fns, iters=5, rounds=2)
    return {"shapes": shapes, "scales": scales, "old_equals_new": same, "turns": turns,
            "new_over_old": _median_ratios(turns)}


SEQ_BATCH = 8  # the sequential adaptive mode's batch (chip_smoke.py phase 28)


def _temporal_turns(kernels: Kernels, frames: list, dev) -> dict:
    """``--old-temporal``: K5 on 8 of the 32 shapes ``frames`` against the
    9th as the carried keyframe (n_keyed on the device, as the sequential
    mode carries it), back to back and with the promoted count read after
    each call; the budgeted selection (K3 + K4) on all 32 against a zero
    carried frame, K = 8; in turns (old, new, new, old) twice, after the
    two builds' outputs are compared."""
    from tpuseg_torch.video.autotune import drift_threshold

    h, w = FULL
    fb = torch.from_numpy(np.stack(frames).reshape(len(frames), h, -1)).to(dev)
    fb8, kf = fb[:SEQ_BATCH], fb[SEQ_BATCH]
    thresh = drift_threshold(frames[:SEQ_BATCH])[0]
    nk0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    prev = torch.zeros((h, w * 3), dtype=torch.uint8, device=dev)
    acc0 = torch.zeros((1,), dtype=torch.float32, device=dev)
    pipe = kernels.pipe
    fns = {"k5": lambda: pipe.keyframe_select(fb8, kf, nk0, thresh),
           "k5_count_read": lambda: int(pipe.keyframe_select(fb8, kf, nk0, thresh)[4]),
           "k3_k4": lambda: pipe.frame_deltas_budget(fb, prev, acc0, nk0, thresh, 8)}
    same = {}
    with torch.inference_mode():
        for name in ("k5", "k3_k4"):
            kernels.use("old")
            old = fns[name]()
            kernels.use("new")
            new = fns[name]()
            if name == "k5":  # fwd_idx past the promoted count is unspecified
                count = int(new[4])
                old, new = (old[:2] + (old[2][:count],) + old[3:],
                            new[:2] + (new[2][:count],) + new[3:])
            same[name] = all(torch.equal(a, b) for a, b in zip(old, new))
        turns = ab(kernels, fns, iters=50, rounds=2)
        device = {}
        for which in ("old", "new"):
            kernels.use(which)
            device[which] = {name: _device_ms(fns[name]) for name in ("k5", "k3_k4")}
        kernels.use("new")
    return {"k5_shape": list(fb8.shape), "k3_k4_shape": list(fb.shape), "thresh": thresh,
            "old_equals_new": same, "turns": turns, "new_over_old": _median_ratios(turns),
            "device": device}


def _flow_turns(kernels: Kernels, frames: list, dev, gen) -> dict:
    """``--old-flow``: K6 on the pooled luma of the 32 shapes ``frames``
    against their interval-4 keyframes' (as phase 25 of ``chip_smoke.py``
    times it) and K7 on random (32, 1024, 2048) ids with K6's shifts and
    with random shifts in [-6, 6]; the two builds' outputs compared, then
    in turns (old, new, new, old) twice, back to back and in CUDA graphs
    (device time)."""
    from tpuseg_torch.video.flow import pooled_luma

    h, w = FULL
    fb = torch.from_numpy(np.stack(frames).reshape(len(frames), h, -1)).to(dev)
    cs = pooled_luma(fb)
    ks = cs[::4].repeat_interleave(4, 0).contiguous()
    del fb
    ids = torch.randint(0, 19, (32, h, w), generator=gen, device=dev,
                        dtype=torch.int32).to(torch.uint8)
    pipe = kernels.pipe
    dyk, dxk = pipe.estimate_block_shifts(ks, cs)
    dyr, dxr = (torch.randint(-6, 7, (32, h // 128, w // 128), generator=gen, device=dev,
                              dtype=torch.int32) for _ in range(2))
    fns = {"k6": lambda: pipe.estimate_block_shifts(ks, cs),
           "k7_k6_shifts": lambda: pipe.warp_ids(ids, dyk, dxk, scale=8, block=16),
           "k7_random_shifts": lambda: pipe.warp_ids(ids, dyr, dxr, scale=8, block=16)}
    same = {}
    for name, fn in fns.items():
        kernels.use("old")
        old = fn()
        kernels.use("new")
        new = fn()
        old, new = (old, new) if isinstance(old, tuple) else ((old,), (new,))
        same[name] = all(torch.equal(a, b) for a, b in zip(old, new))
    turns = ab(kernels, fns, iters=20, rounds=2)
    graph = {name: {"old": [], "new": []} for name in fns}
    for which in ("old", "new", "new", "old") * 2:
        kernels.use(which)
        for name, fn in fns.items():
            graph[name][which].append(graph_ms(fn, 20))
    kernels.use("new")
    return {"k6_shape": list(cs.shape), "k7_shape": list(ids.shape), "old_equals_new": same,
            "accepted_k6_shifts": int((dyk != 0).sum() + (dxk != 0).sum()), "turns": turns,
            "new_over_old": _median_ratios(turns), "graph_turns": graph,
            "graph_new_over_old": _median_ratios(graph)}


YUV_SHAPES = ((8, 1024, 2048), (8, 512, 1024), (32, 1024, 2048))  # (B, H, W) decodes


def _yuv_turns(kernels: Kernels, dev, gen) -> dict:
    """``--old-yuv``: K8 on random I420 planes at each of ``YUV_SHAPES``
    (the kernels line's shape, phase 29's served decode, a batch of 32);
    the two builds' outputs compared, then in turns (old, new, new, old)
    twice, back to back and in CUDA graphs (device time)."""
    pipe = kernels.pipe
    xs = {f"{b}x{h}x{w}": torch.randint(0, 256, (b, h * 3 // 2, w), generator=gen, device=dev,
                                        dtype=torch.int32).to(torch.uint8)
          for b, h, w in YUV_SHAPES}
    fns = {name: (lambda x=x: pipe.i420_to_rgb_flat(x)) for name, x in xs.items()}
    same = {}
    for name, fn in fns.items():
        kernels.use("old")
        old = fn()
        kernels.use("new")
        same[name] = torch.equal(old, fn())
    turns = ab(kernels, fns, iters=50, rounds=2)
    graph = {name: {"old": [], "new": []} for name in fns}
    for which in ("old", "new", "new", "old") * 2:
        kernels.use(which)
        for name, fn in fns.items():
            graph[name][which].append(graph_ms(fn, 50))
    kernels.use("new")
    return {"old_equals_new": same, "turns": turns, "new_over_old": _median_ratios(turns),
            "graph_turns": graph, "graph_new_over_old": _median_ratios(graph)}


def _device_ms(fn, calls: int = 10) -> dict:
    """Device ms a call of ``fn`` (``torch.profiler`` over ``calls`` calls,
    after a warm one): the sum over kernels and memsets, and each kernel
    name's share."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = {e.key[:80]: e.self_device_time_total / 1e3 / calls for e in prof.key_averages()
             if e.self_device_time_total > 0 and not e.key.startswith("aten::")}
    return {"ms": sum(times.values()), "by_kernel": times}


def _adaptive_fps_turns(kernels: Kernels, params, masked, state, spec, gathered) -> dict:
    """``--old-temporal``'s served rates: ``benchmark_adaptive_device_fps``
    of the sequential mode (dense bf16, batch 8, the 32 shapes frames of
    seed 0, ``drift_threshold`` of the first 8) and of
    ``sparse_int8_budget8`` (block128reg_87.50 gathered, int8 calibrated on
    8 frames, batch 32, K = 8, 64 shapes frames of seed 1), with the old and
    the new build in turns (old, new, new, old)."""
    from tpuseg_torch.data.shapes import shapes_video
    from tpuseg_torch.video.autotune import drift_threshold
    from tpuseg_torch.video.pipeline import VideoSegmenter

    seq_frames = list(shapes_video(32, FULL, seed=0)[0])
    budget_frames = list(shapes_video(64, FULL, seed=1)[0])
    runs = {
        "sequential": (VideoSegmenter(
            params, state, spec, MEAN, STD, device="cuda", compute_dtype=torch.bfloat16,
            batch=SEQ_BATCH, temporal_thresh=drift_threshold(seq_frames[:SEQ_BATCH])[0]),
            seq_frames),
        "sparse_int8_budget8": (VideoSegmenter(
            masked, state, spec, MEAN, STD, device="cuda", compute_dtype=torch.bfloat16,
            batch=32, exec_plans=gathered, quantize=True, calib_frames=seq_frames[:8],
            temporal_thresh=drift_threshold(budget_frames)[0], temporal_budget=8),
            budget_frames),
    }
    fps = {f"{name}_{which}": [] for name in runs for which in ("old", "new")}
    rates = {}
    for which in ("old", "new", "new", "old"):
        kernels.use(which)
        for name, (seg, fr) in runs.items():
            res = seg.benchmark_adaptive_device_fps(fr)
            fps[f"{name}_{which}"].append(res["device_fps"])
            rates.setdefault(name, set()).add(res["promotion_rate"])
    kernels.use("new")
    return {"device_fps": fps, "promotion_rates": {k: sorted(v) for k, v in rates.items()},
            "new_over_old": {name: float(np.median(fps[f"{name}_new"])
                                         / np.median(fps[f"{name}_old"])) for name in runs}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="the other commit's sparse_conv.cu (kernel B2)")
    ap.add_argument("--old-q", help="the other commit's sparse_conv_q.cu (kernel B3)")
    ap.add_argument("--old-quantize", help="the other commit's quantize.cu (B3's quantize pass)")
    ap.add_argument("--old-stem", nargs=2, metavar=("Q", "NARROW"),
                    help="sparse_conv_q.cu and sparse_conv_q_narrow.cu of a commit before the "
                         "int8 stem's hand-off (B3's stem route)")
    ap.add_argument("--old-bsr", help="the other commit's bsr_matmul.cu (kernels B5/B6)")
    ap.add_argument("--old-up", help="the other commit's upsample_argmax.cu (kernel B1)")
    ap.add_argument("--old-temporal", help="temporal.cu of a commit before K5's one launch "
                                           "(K3, K4 and K5)")
    ap.add_argument("--old-flow", help="the other commit's flow.cu (K6 and K7)")
    ap.add_argument("--old-yuv", help="the other commit's yuv.cu (K8)")
    ap.add_argument("--skip-fps", action="store_true", help="kernel times only")
    args = ap.parse_args(argv)
    copies = {k: v for k, v in (("b2", args.old), ("b3", args.old_q),
                                ("quantize", args.old_quantize), ("bsr", args.old_bsr),
                                ("up", args.old_up), ("temporal", args.old_temporal),
                                ("flow", args.old_flow), ("yuv", args.old_yuv)) if v}
    if args.old_stem:
        if args.old_q:
            ap.error("--old-stem and --old-q both replace B3: give one")
        copies["stem_q"], copies["stem_narrow"] = args.old_stem
    if not copies:
        ap.error("give at least one of --old, --old-q, --old-quantize, --old-stem, --old-bsr, "
                 "--old-up, --old-temporal, --old-flow, --old-yuv")
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
    int8 = {"b3", "quantize", "stem_q"} & set(olds)
    if ({"b2", "temporal"} | int8) & set(olds):
        params, masked, state, spec, folded, plans = _served()
        bias = folded["layer.6.1.conv2.bias"].to(dev, torch.bfloat16)
    else:
        from tpuseg_torch.models.drnseg import init_drnseg

        params, state, spec = init_drnseg(0, "drn_d_22", 19)
    x = torch.randn(BATCH32, generator=gen, device=dev, dtype=torch.bfloat16)

    def served_step(plan, xs=None):
        """The served bf16 layer on ``xs`` (default ``x``): the route where
        the kernel has one, else the f32 conv, cast and bias
        (``models/drn.py``)."""
        xs = (x if xs is None else xs).permute(0, 3, 1, 2)
        y = kernels.drn._sparse_conv_bias_bf16(xs, plan, bias)
        if y is None:
            y = kernels.drn._sparse_conv(xs, plan, None).to(
                torch.bfloat16) + bias.view(1, -1, 1, 1)
        return y

    if "b2" in olds:
        # B2 at layer.6.1.conv2, f32 out and the served bf16 step, at w = 256
        # and at w = 128
        plan = plans["pallas"]["layer.6.1.conv2"].to(dev)
        x128 = torch.randn(BATCH32_HALF, generator=gen, device=dev, dtype=torch.bfloat16)
        # four rounds of 30 launches: turns of 10 spread by up to 14 % on an H100
        turns = ab(kernels, {"b2_f32": lambda: sc.fused_sparse_conv_apply(x, plan),
                             "served_step": lambda: served_step(plan),
                             "served_step_w128": lambda: served_step(plan, x128)},
                   iters=30, rounds=4)
        _emit(phase="b2", conv="layer.6.1.conv2", shape=list(BATCH32), s=plan.s,
              shape_w128=list(BATCH32_HALF), rows_per_tile={
                  "w256": sc.b2_tile_rows(BATCH32[2], BATCH32[1]),
                  "w128": sc.b2_tile_rows(BATCH32_HALF[2], BATCH32_HALF[1])},
              turns=turns, new_over_old=_median_ratios(turns), card=smi)
        del x128
        # B2's training forward and dgrad at the same conv's crop-512 shape
        _emit(phase="b2_train", conv="layer.6.1.conv2", **_train_turns(kernels, params, spec,
                                                                       gen, dev), card=smi)
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
    if int8:
        # the 128-wide served int8 step, which no redesign of the int8 stem
        # or the narrow route touches, and its unmapped quantize pass
        qplan = sc.quantize_fused_plan(plans["pallas"]["layer.6.1.conv2"]).to(dev)
        turns = ab(kernels, {"served_int8_w128": lambda: served_step(qplan),
                             "unmapped_quantize": lambda: sc.quantize_activation(x, None)},
                   iters=10, rounds=2)
        _emit(phase="served_int8_w128", conv="layer.6.1.conv2", shape=list(BATCH32),
              turns=turns, new_over_old=_median_ratios(turns), card=smi)
    if "b3" in olds:
        _emit(phase="narrow_vs_padded", **_narrow_turns(kernels, gen, dev), card=smi)
    if "quantize" in olds:
        _emit(phase="quantize_maps", **_quantize_turns(kernels, plans["pallas"], folded, gen,
                                                       dev, x), card=smi)
    del x
    if "stem_q" in olds:
        from tpuseg_torch.data.shapes import shapes_video

        stem_frames = list(shapes_video(32, FULL, seed=0)[0])
        seg = VideoSegmenter(params, state, spec, MEAN, STD, device=dev,
                             compute_dtype=torch.bfloat16, batch=32, quantize=True,
                             quantize_stem=True, calib_frames=stem_frames[:8])
        fd = torch.from_numpy(np.stack(stem_frames).reshape(32, FULL[0], -1)).to(dev)
        _emit(phase="stem_routes", size=list(FULL), batch=32,
              **_stem_turns(kernels, seg, fd), card=smi)
        del seg, fd, stem_frames
        torch.cuda.empty_cache()
    if "temporal" in olds:
        from tpuseg_torch.data.shapes import shapes_video

        _emit(phase="temporal_select", size=list(FULL),
              **_temporal_turns(kernels, list(shapes_video(32, FULL, seed=0)[0]), dev),
              card=smi)
        torch.cuda.empty_cache()
    if "flow" in olds:
        from tpuseg_torch.data.shapes import shapes_video

        _emit(phase="flow_kernels", size=list(FULL),
              **_flow_turns(kernels, list(shapes_video(32, FULL, seed=0)[0]), dev, gen),
              card=smi)
        torch.cuda.empty_cache()
    if "yuv" in olds:
        _emit(phase="yuv_kernel", **_yuv_turns(kernels, dev, gen), card=smi)
        torch.cuda.empty_cache()
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
    if int8:
        # int8_stem (dense int8 calibrated, with the int8 stem) and
        # sparse_int8 (block128reg_87.50, Pallas lowering) with each build
        from tpuseg_torch.data.shapes import shapes_video

        calib = list(shapes_video(8, FULL, seed=0)[0])
        segs = {"int8_stem": VideoSegmenter(params, state, spec, MEAN, STD, device=dev,
                                            compute_dtype=torch.bfloat16, batch=32,
                                            quantize=True, quantize_stem=True,
                                            calib_frames=calib),
                "sparse_int8": VideoSegmenter(masked, state, spec, MEAN, STD, device=dev,
                                              compute_dtype=torch.bfloat16, batch=32,
                                              exec_plans=plans["pallas"], quantize=True)}
        fps = _fps_turns(kernels, segs)
        _emit(phase="int8_stem_sparse_int8_fps", size=list(FULL), batch=32, device_fps=fps,
              ids_for_ms={k: [32e3 / v for v in vs] for k, vs in fps.items()}, card=smi)
        del segs
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
    if "temporal" in olds:
        _emit(phase="adaptive_device_fps", size=list(FULL),
              **_adaptive_fps_turns(kernels, params, masked, state, spec, plans["gathered"]),
              card=smi)
        torch.cuda.empty_cache()
    if "flow" in olds:
        # interval 4 + nearest + warp with each K6/K7 build, beside the
        # same without the warp
        def interval(warp):
            return VideoSegmenter(params, state, spec, MEAN, STD, device=dev,
                                  compute_dtype=torch.bfloat16, batch=32, temporal_interval=4,
                                  temporal_nearest=True, temporal_warp=warp)

        fps = _fps_turns(kernels, {"interval4_nearest_warp": interval(True)},
                         {"interval4_nearest": interval(False)})
        _emit(phase="warp_device_fps", size=list(FULL), batch=32, device_fps=fps,
              new_over_old=float(np.median(fps["interval4_nearest_warp_new"])
                                 / np.median(fps["interval4_nearest_warp_old"])), card=smi)
        torch.cuda.empty_cache()
    if "yuv" in olds:
        # dense bf16 served over the yuv420 transport with each K8 build
        seg = VideoSegmenter(params, state, spec, MEAN, STD, device=dev,
                             compute_dtype=torch.bfloat16, batch=32, transport="yuv420")
        fps = _fps_turns(kernels, {"dense_yuv420": seg})
        _emit(phase="yuv420_device_fps", size=list(FULL), batch=32, device_fps=fps,
              new_over_old=float(np.median(fps["dense_yuv420_new"])
                                 / np.median(fps["dense_yuv420_old"])), card=smi)
        del seg
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
