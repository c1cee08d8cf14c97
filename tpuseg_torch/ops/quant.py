"""Int8 post-training quantization for DRNSeg serving (counterpart of
``tpuseg/ops/quant.py``).

Symmetric PTQ, as in ``tpuseg``: per-output-channel int8 weights
(``quantize_weight``), an activation scale per frame (dynamic absmax over
H, W, C) or a static one from ``calibrate_scales``, an exact integer conv
and the epilogue ``float(acc) * (x_scale[n] * w_scale[o])``.  Bias, ReLU and
the residual run unquantized, as for float plans.

``build_quant_plans`` returns ``{conv_name: QuantConv}`` for the
``sparse_plans`` dispatch of ``tpuseg_torch.models.drn``, and
``build_cls_quant_plans`` the classifier zoo's for ``cifar_forward(...,
plans=...)``.  PyTorch has no eager int8 conv on CUDA, so a ``QuantConv``
carries, besides ``tpuseg``'s ``w_q``/``w_scale``, its full-support packing
for kernel B3 (``tpuseg_torch.ops.sparse_conv.fused_sparse_conv_apply_q``,
``int8_packing``): 128-wide blocks when its channels divide by 128, else a
narrow packing (the zoo's 16-64 wide convs: K of 32, 64 or 128 input
channels a step, N of 16-128 output channels a block, x padded to whole
steps by the quantize pass's map) that B3's narrow route writes at its
own width.  A CUDA tensor runs B3 on the packing; a CPU tensor runs
``quant_conv_reference``.  Build the plans from the f32 (BN-folded)
weights: ``w_q`` is then ``tpuseg``'s bit for bit.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.models.drn import DrnSpec, drn_forward, nchw_to_nhwc, nhwc_to_nchw
from tpuseg_torch.models.weights import oihw_to_hwio_np
from tpuseg_torch.ops.sparse_conv import (
    BK,
    BM,
    QMAX,
    FusedSparseConvQ,
    cast_bias_bf16,
    dequantize,
    fused_sparse_conv_apply_q,
    fused_sparse_conv_q_bias_bf16,
    int_conv_exact,
    quantize_activation_reference,
)


@dataclasses.dataclass
class QuantConv:
    """Int8 execution plan for one dense conv."""

    w_q: torch.Tensor       # (KH, KW, C, O) int8, tpuseg's HWIO layout
    w_scale: torch.Tensor   # (O,) f32 per-output-channel
    stride: int
    dilation: int
    padding: int
    x_scale: float | None = None  # static activation scale; None = per frame
    packed: FusedSparseConvQ | None = None  # full-support packing: B3's operand

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC float x -> f32 NHWC: the plain version on a CPU tensor,
        kernel B3 on a CUDA tensor (``quant_conv_apply``, which raises on
        anything else)."""
        if x.device.type == "cpu":
            return quant_conv_reference(x, self)
        return quant_conv_apply(x, self)

    def apply_bias_bf16(self, x: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
        """The served bf16 route: ``bf16(float(bf16(y)) + float(bias))``, the
        cast and bias passes on a CPU tensor, one B3 launch writing it on a
        CUDA tensor (``quant_conv_apply``)."""
        if x.device.type == "cpu":
            return cast_bias_bf16(quant_conv_reference(x, self), bias)
        return quant_conv_apply(x, self, bias, bf16_bias=True)

    def to(self, device) -> "QuantConv":
        return dataclasses.replace(
            self, w_q=self.w_q.to(device), w_scale=self.w_scale.to(device),
            packed=self.packed.to(device))


def quant_conv_apply(x: torch.Tensor, plan: QuantConv, bias: torch.Tensor | None = None,
                     bf16_bias: bool = False) -> torch.Tensor:
    """One B3 launch on the plan's packing (``int8_packing``) for NHWC x:
    f32 out, or with ``bf16_bias`` the served bf16 route.  Launches count in
    ``fused_sparse_conv_apply_q.launches``; those on a narrow packing (B3's
    narrow route) also in ``quant_conv_apply.narrow_launches``.  On a CPU
    tensor the B3 wrappers run their plain version, which equals
    ``quant_conv_reference``."""
    if bf16_bias:
        y = fused_sparse_conv_q_bias_bf16(x, plan.packed, bias)
    else:
        y = fused_sparse_conv_apply_q(x, plan.packed)
    if x.device.type == "cuda" and plan.packed.narrow:
        quant_conv_apply.narrow_launches += 1
    return y


quant_conv_apply.narrow_launches = 0


def quant_conv_reference(x: torch.Tensor, plan: QuantConv) -> torch.Tensor:
    """Plain version of ``QuantConv.apply``: quantize x, the exact integer
    conv with ``w_q``, the epilogue (``tpuseg``'s ``QuantConv.apply``)."""
    xq, xs = quantize_activation_reference(x, plan.x_scale)
    return dequantize(int_conv_exact(xq, plan.w_q, plan.dilation), xs, plan.w_scale)


def quantize_weight(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(KH, KW, C, O) float -> (int8 weights, (O,) per-channel scales);
    ``tpuseg``'s numpy."""
    w = np.asarray(w, np.float32)
    absmax = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0)
    scale = np.maximum(absmax, 1e-8) / 127.0
    wq = np.clip(np.round(w / scale), -QMAX, QMAX).astype(np.int8)
    return wq, scale.astype(np.float32)


def full_support_packing(name: str, w_q: np.ndarray, w_scale: np.ndarray, dilation: int,
                         padding: int, x_scale: float | None = None) -> FusedSparseConvQ:
    """The B3 packing of a dense int8 conv: every input block in ``rows``;
    ``vals``/``w_scale`` equal ``quantize_fused_plan(plan_fused_sparse_conv(
    w, ones, dtype=float32))``.  Raises ``ValueError``, naming the conv, on a
    conv B3 cannot run."""
    kh, kw, cin, cout = w_q.shape
    if kh != kw or kh % 2 == 0 or padding != dilation * (kh - 1) // 2 or cin % BK or cout % BM:
        raise ValueError(
            f"{name}: int8 conv {kh}x{kw} {cin}->{cout} (dilation {dilation}, padding "
            f"{padding}) does not fit kernel B3: it needs an odd square 'same' kernel and "
            f"channels divisible by {BK}")
    nmb, S, T = cout // BM, cin // BK, kh * kw
    vals = w_q.reshape(T, cin, nmb, BM).transpose(2, 0, 1, 3).reshape(nmb, T * cin, BM)
    taps = np.array([(p * dilation, q * dilation) for p in range(kh) for q in range(kw)],
                    np.int32)
    return FusedSparseConvQ(
        vals=torch.from_numpy(np.ascontiguousarray(vals)),
        w_scale=torch.from_numpy(np.ascontiguousarray(w_scale.reshape(nmb, 1, BM))),
        rows=torch.from_numpy(np.tile(np.arange(S, dtype=np.int32), (nmb, 1))),
        taps=taps, s=S, bk=BK, bm=BM, kernel=kh, dilation=dilation, cin=cin, cout=cout,
        block_density=1.0, x_scale=x_scale,
    )


def narrow_widths(cin: int, cout: int) -> tuple[int, int]:
    """B3's narrow route's (K, N) for a cin -> cout conv: K = 32, 64 or 128
    input channels a step (cin rounded up to 32, then to 64 or to slots of
    128), N = 16, 32 or 64 output channels a block (cout rounded up to 16,
    then to the next of them), or 128 past 64."""
    kb = 32 if cin <= 32 else 64 if cin <= 64 else BK
    bn = next(n for n in (16, 32, 64, BM) if cout <= n or n == BM)
    return kb, bn


def int8_packing(name: str, w_q: np.ndarray, w_scale: np.ndarray, dilation: int,
                 padding: int, x_scale: float | None = None) -> FusedSparseConvQ:
    """B3's packing of a dense stride-1 'same' int8 conv (HWIO ``w_q``).  A
    conv whose channels divide by 128 gets ``full_support_packing``; any
    other a narrow one (``FusedSparseConvQ.narrow``) at ``narrow_widths``:
    zero weight rows up to S * K input channels, and where cin < S * K the
    map ``[0..cin-1] + [-1] * (S * K - cin)`` through which the quantize
    pass writes the padded int8 x (``in_chan``; its -1s are zero vectors,
    read from nothing); zero columns (scale 1) up to the out-blocks' width,
    which B3's narrow route does not write (y is cout wide).

    Raises ``ValueError``, naming the conv, on a conv B3 cannot take (an
    even or non-square kernel, padding other than 'same', or a narrow conv
    whose channels do not divide by 8)."""
    kh, kw, cin, cout = w_q.shape
    if cin % BK == 0 and cout % BM == 0:
        return full_support_packing(name, w_q, w_scale, dilation, padding, x_scale)
    if kh != kw or kh % 2 == 0 or padding != dilation * (kh - 1) // 2 or cin % 8 or cout % 8:
        raise ValueError(
            f"{name}: int8 conv {kh}x{kw} {cin}->{cout} (dilation {dilation}, padding "
            f"{padding}) does not fit kernel B3's narrow route: it needs an odd square 'same' "
            f"kernel and channels divisible by 8")
    kb, bn = narrow_widths(cin, cout)
    S, nmb, T = -(-cin // kb), -(-cout // bn), kh * kw
    w = np.zeros((kh, kw, S * kb, nmb * bn), np.int8)
    w[:, :, :cin, :cout] = w_q
    scale = np.ones(nmb * bn, np.float32)
    scale[:cout] = w_scale
    vals = w.reshape(T, S * kb, nmb, bn).transpose(2, 0, 1, 3).reshape(nmb, T * S * kb, bn)
    taps = np.array([(p * dilation, q * dilation) for p in range(kh) for q in range(kw)],
                    np.int32)
    return FusedSparseConvQ(
        vals=torch.from_numpy(np.ascontiguousarray(vals)),
        w_scale=torch.from_numpy(scale.reshape(nmb, 1, bn)),
        rows=torch.from_numpy(np.tile(np.arange(S, dtype=np.int32), (nmb, 1))),
        taps=taps, s=S, bk=kb, bm=bn, kernel=kh, dilation=dilation, cin=cin, cout=cout,
        block_density=1.0, x_scale=x_scale,
        in_chan=None if cin == S * kb else torch.cat(
            [torch.arange(cin, dtype=torch.int32),
             torch.full((S * kb - cin,), -1, dtype=torch.int32)]),
    )


def embed_same(w: np.ndarray, pad_lo: int, pad_hi: int) -> tuple[np.ndarray, int]:
    """A stride-1 HWIO conv with padding ``(pad_lo, pad_hi)`` on both axes
    that keeps the grid (``pad_lo + pad_hi = kernel - 1``) as the same
    function in the odd "same" kernel of ``max(pad_lo, pad_hi)`` padding:
    ``(w_same, padding)``.  The taps it adds are zero, so their tiles are
    not live steps of a B3 packing (``FusedSparseConvQ`` takes its steps
    from the nonzero tiles, ``full_support_packing``'s too): B3 walks the
    kernel's own kh * kw taps.  Raises ``ValueError`` otherwise."""
    kh, kw = w.shape[:2]
    if kh != kw or pad_lo + pad_hi != kh - 1 or min(pad_lo, pad_hi) < 0:
        raise ValueError(f"a {kh}x{kw} conv with padding ({pad_lo}, {pad_hi}) does not keep "
                         f"the grid")
    pad = max(pad_lo, pad_hi)
    if pad_lo == pad_hi:
        return w, pad
    out = np.zeros((2 * pad + 1, 2 * pad + 1) + w.shape[2:], w.dtype)
    off = pad - pad_lo  # tap p of the conv sits at tap p + off of the "same" kernel
    out[off:off + kh, off:off + kw] = w
    return out, pad


def stem_packing(name: str, w_q: np.ndarray, w_scale: np.ndarray, pad_lo: int, pad_hi: int,
                 x_scale: float | None = None) -> FusedSparseConvQ:
    """B3's packing of a folded int8 stem conv (HWIO ``w_q``, stride 1,
    padding ``(pad_lo, pad_hi)`` on both axes): ``int8_packing`` of the
    conv as an odd "same" kernel, with ``narrow_route`` set: every stem
    conv runs on B3's narrow kernel, which has the stem's epilogues (relu,
    and the int8 hand-off to the next conv).  A kernel that keeps the grid
    but is even or padded asymmetrically (conv2: 2x2, pad (1, 0)) is
    embedded in the odd "same" kernel of ``max(pad_lo, pad_hi)`` padding
    (``embed_same``); the taps it adds are zero, so their tiles are not
    live steps (the packing's steps come from its nonzero tiles) and B3
    walks conv2's 4 taps of the 9.  conv0's 48 input channels take K = 64,
    x padded to 64 through its map; conv1 and conv2 K = 128 over S = 2
    slots, N = 128.  Raises ``ValueError``, naming the conv, on a shape B3
    cannot take this way."""
    kh, kw, cin, cout = w_q.shape
    if kh != kw or pad_lo + pad_hi != kh - 1 or min(pad_lo, pad_hi) < 0:
        raise ValueError(
            f"{name}: int8 stem conv {kh}x{kw} {cin}->{cout} with padding ({pad_lo}, "
            f"{pad_hi}) does not fit kernel B3: it needs a square kernel that keeps the grid "
            f"(pad_lo + pad_hi = kernel - 1)")
    w_same, pad = embed_same(w_q, pad_lo, pad_hi)
    return dataclasses.replace(int8_packing(name, w_same, w_scale, 1, pad, x_scale),
                               narrow_route=True)


# tpuseg's eligibility rule (its build_quant_plans defaults, the only
# values any caller uses)
QUANT_STAGES = (4, 5, 6, 7, 8)
MIN_CHANNELS = 128


def build_quant_plans(
    params,
    spec: DrnSpec,
    *,
    x_scales: dict[str, float] | None = None,
) -> dict[str, QuantConv]:
    """Quantize the eligible convs of a BN-folded param dict (OIHW f32
    tensors): ``tpuseg``'s rule, stride-1 convs (block convs and the conv
    stages; downsamples are not considered) in ``QUANT_STAGES`` with >=
    ``MIN_CHANNELS`` in and out channels.  ``x_scales`` (from
    ``calibrate_scales``) gives those convs static activation scales."""
    plans: dict[str, QuantConv] = {}

    def consider(cdef):
        if cdef.stride != 1:
            return
        wt = params[f"{cdef.name}.weight"]
        if wt.dtype != torch.float32:
            raise ValueError(f"{cdef.name}: build int8 plans from the f32 folded weights, "
                             f"got {wt.dtype}")
        w = oihw_to_hwio_np(wt)
        if w.shape[2] < MIN_CHANNELS or w.shape[3] < MIN_CHANNELS:
            return
        plans[cdef.name] = _quant_conv(cdef.name, w, cdef.stride, cdef.dilation,
                                       cdef.padding, (x_scales or {}).get(cdef.name))

    for key, sdef in spec.stages:
        m = re.search(r"(\d+)$", key)  # seg "layer.5" or cls "layer5"
        if not m or int(m.group(1)) not in QUANT_STAGES:
            continue
        for cdef, _bn in sdef.convs:
            consider(cdef)
        for blk in sdef.blocks:
            for cdef in blk.convs:
                consider(cdef)
    return plans


def _quant_conv(name: str, w: np.ndarray, stride: int, dilation: int, padding: int,
                x_scale: float | None) -> QuantConv:
    """The ``QuantConv`` of one f32 HWIO weight, with its B3 packing."""
    wq, ws = quantize_weight(w)
    return QuantConv(w_q=torch.from_numpy(wq), w_scale=torch.from_numpy(ws), stride=stride,
                     dilation=dilation, padding=padding, x_scale=x_scale,
                     packed=int8_packing(name, wq, ws, dilation, padding, x_scale))


def build_cls_quant_plans(
    params,
    *,
    min_channels: int = 16,
    x_scales: dict[str, float] | None = None,
    groups: int = 1,
) -> dict[str, QuantConv]:
    """Quantize the eligible convs of a CLASSIFIER param dict (the CIFAR
    zoo; OIHW f32 tensors) for ``cifar_forward(..., plans=...)``:
    ``tpuseg``'s rule, square 1x1/3x3 conv weights with >= ``min_channels``
    in and out channels, padding ``(k - 1) // 2``, dilation 1 and stride
    baked as 1 (the forward applies a plan only at stride-1, ungrouped call
    sites).  The 3-channel stem falls under the channel floor.  Pass the
    spec's ``groups`` for resnext archs: their grouped 3x3 convs (cin =
    cout / groups) never dispatch and get no plan.  Convs of 16-64 channels
    get B3's narrow packing (``int8_packing``)."""
    plans: dict[str, QuantConv] = {}
    for key, wt in params.items():
        if not key.endswith(".weight") or wt.dim() != 4:
            continue
        if wt.dtype != torch.float32:
            raise ValueError(f"{key}: build int8 plans from the f32 weights, got {wt.dtype}")
        w = oihw_to_hwio_np(wt)
        if w.shape[0] != w.shape[1] or w.shape[0] not in (1, 3):
            continue
        if w.shape[2] < min_channels or w.shape[3] < min_channels:
            continue
        if groups > 1 and w.shape[0] == 3 and w.shape[2] * groups == w.shape[3]:
            continue  # grouped bottleneck conv2: never dispatched
        name = key[: -len(".weight")]
        plans[name] = _quant_conv(name, w, 1, 1, (w.shape[0] - 1) // 2,
                                  (x_scales or {}).get(name))
    return plans


class _Probe:
    """Calibration plan: records its input's absmax, then runs the float
    conv with the dequantized weights ``(w_q * w_scale)`` in x's dtype."""

    def __init__(self, name: str, plan: QuantConv, recorded: dict):
        self.name, self.plan, self.recorded = name, plan, recorded
        w = plan.w_q.float() * plan.w_scale.float()  # HWIO * (O,)
        self.w = w.permute(3, 2, 0, 1).contiguous()  # OIHW

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        amax = float(x.abs().amax())
        self.recorded[self.name] = max(self.recorded.get(self.name, 0.0), amax)
        p = self.plan
        w = self.w.to(device=x.device, dtype=x.dtype)
        y = F.conv2d(nhwc_to_nchw(x), w, None, p.stride, p.padding, p.dilation)
        return nchw_to_nhwc(y)


def calibrate_scales(
    params, state, spec: DrnSpec, frames, *, plans: dict[str, QuantConv],
    compute_dtype: torch.dtype | None = torch.bfloat16, stem_fn=None, stem_stages: int = 1,
) -> dict[str, float]:
    """Static activation scales (``tpuseg``'s ``calibrate_scales``): the
    float forward over the calibration batches ``frames`` (tensors or numpy
    arrays, moved to the device of ``params``) with an absmax probe on each
    conv of ``plans``; only the probes run as plans.  Returns
    ``{conv_name: absmax / 127.0}`` (Python floats) for every absmax > 0."""
    device = next(iter(params.values())).device
    recorded: dict[str, float] = {}
    probes = {n: _Probe(n, p, recorded) for n, p in plans.items()}
    with torch.inference_mode():
        for batch in frames:
            x = torch.as_tensor(batch).to(device)
            drn_forward(params, state, x, spec, compute_dtype=compute_dtype,
                        stem_fn=stem_fn, stem_stages=stem_stages, sparse_plans=probes)
    return {n: v / 127.0 for n, v in recorded.items() if v > 0}


def ids_agreement(ids_a, ids_b) -> float:
    """Fraction of pixels whose class id matches between two runs."""
    a, b = np.asarray(ids_a), np.asarray(ids_b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a == b).mean())
