"""Int8 post-training quantization for DRNSeg serving (counterpart of
``tpuseg/ops/quant.py``).

Symmetric PTQ, as in ``tpuseg``: per-output-channel int8 weights
(``quantize_weight``), an activation scale per frame (dynamic absmax over
H, W, C) or a static one from ``calibrate_scales``, an exact integer conv
and the epilogue ``float(acc) * (x_scale[n] * w_scale[o])``.  Bias, ReLU and
the residual run unquantized, as for float plans.

``build_quant_plans`` returns ``{conv_name: QuantConv}`` for the
``sparse_plans`` dispatch of ``tpuseg_torch.models.drn``.  PyTorch has no
eager int8 conv on CUDA, so a ``QuantConv`` carries, besides ``tpuseg``'s
``w_q``/``w_scale``, its full-support packing for kernel B3
(``tpuseg_torch.ops.sparse_conv.fused_sparse_conv_apply_q``): every input
block in ``rows``, S = Cin/128.  A CUDA tensor runs B3 on it; a CPU tensor
runs ``quant_conv_reference``.  Build the plans from the f32 BN-folded
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
        kernel B3 on a CUDA tensor (which raises on anything else)."""
        if x.device.type == "cpu":
            return quant_conv_reference(x, self)
        return fused_sparse_conv_apply_q(x, self.packed)

    def apply_bias_bf16(self, x: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
        """The served bf16 route: ``bf16(float(bf16(y)) + float(bias))``, the
        cast and bias passes on a CPU tensor, one B3 launch writing it on a
        CUDA tensor (``fused_sparse_conv_q_bias_bf16``)."""
        if x.device.type == "cpu":
            return cast_bias_bf16(quant_conv_reference(x, self), bias)
        return fused_sparse_conv_q_bias_bf16(x, self.packed, bias)

    def to(self, device) -> "QuantConv":
        return dataclasses.replace(self, w_q=self.w_q.to(device),
                                   w_scale=self.w_scale.to(device),
                                   packed=self.packed.to(device))


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
        wq, ws = quantize_weight(w)
        xs = (x_scales or {}).get(cdef.name)
        plans[cdef.name] = QuantConv(
            w_q=torch.from_numpy(wq),
            w_scale=torch.from_numpy(ws),
            stride=cdef.stride,
            dilation=cdef.dilation,
            padding=cdef.padding,
            x_scale=xs,
            packed=full_support_packing(cdef.name, wq, ws, cdef.dilation, cdef.padding, xs),
        )

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
