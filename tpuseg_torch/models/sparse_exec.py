"""Sparse DRN inference: masks -> per-conv execution plans (counterpart of
``tpuseg/models/sparse_exec.py``).

``build_sparse_plans`` walks every masked conv of a DRN spec and decides,
in ``tpuseg``'s order and with its rules and report strings:

1. an RBGP structured lowering (``tpuseg_torch.ops.rbgp_matmul``) first;
   with the ``pallas`` lowering a stride-1 ``column_compact`` layer whose
   survivor is still block-sparse becomes a ``CompactSparse`` (channel
   slice + the fused block-sparse kernel);
2. stride != 1 and channels not /128 stay dense;
3. the ``gathered`` lowering (``tpuseg_torch.ops.gathered_conv``) with its
   1x1 rule (``GATHER_1X1_MAX_DENSITY``), or the ``pallas`` lowering
   (``tpuseg_torch.ops.sparse_conv``, kernel B2), each below the
   ``dense_threshold`` block density (``tpuseg``'s default 0.75).

The plan dtype is fixed here (bf16 by default, as ``tpuseg`` builds its
plans) and is independent of the serving dtype: the fused kernel casts x to
it.  Plans are built on the CPU; ``plans_to`` moves a plan dict to the card.
Use BN-folded weights (``tpuseg_torch.ops.fold_bn``).

``quantize_sparse_plans`` lifts a plan dict to int8 where ``tpuseg`` has an
int8 lowering (``FusedSparseConv`` -> ``FusedSparseConvQ``, ``CompactSparse``
-> ``CompactSparseQ``, ``GatheredGroupConv`` -> ``GatheredGroupConvQ``, all
run by kernel B3 on the card); RBGP plans pass through as float.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from tpuseg_torch.models.drn import DrnSpec
from tpuseg_torch.ops.gathered_conv import (
    GatheredGroupConv,
    plan_gathered_conv,
    quantize_gathered_plan,
)
from tpuseg_torch.ops.rbgp_matmul import plan_rbgp
from tpuseg_torch.ops.sparse_conv import (
    FusedSparseConv,
    FusedSparseConvQ,
    fused_sparse_conv_apply,
    fused_sparse_conv_apply_q,
    fused_sparse_conv_bias_bf16,
    fused_sparse_conv_q_bias_bf16,
    plan_fused_sparse_conv,
    quantize_fused_plan,
)

# Max live-block density at which a 1x1 conv still pays for the gathered
# lowering's activation gather (tpuseg's rule, tuned on its TPU; the port
# keeps it so both packages lower the same layers).
GATHER_1X1_MAX_DENSITY = 0.13


@dataclasses.dataclass
class CompactSparse:
    """Dead input channels sliced away (``index_select`` of the live ones),
    then the compacted conv through the fused block-sparse kernel."""

    live_in: torch.Tensor  # (n_live,) int64 input-channel gather
    inner: FusedSparseConv

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return fused_sparse_conv_apply(x.index_select(3, self.live_in), self.inner)

    def apply_bias_bf16(self, x: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
        """The served bf16 route (``fused_sparse_conv_bias_bf16``) of the
        compacted conv."""
        return fused_sparse_conv_bias_bf16(x.index_select(3, self.live_in), self.inner, bias)

    def to(self, device) -> "CompactSparse":
        return CompactSparse(self.live_in.to(device), self.inner.to(device))


@dataclasses.dataclass
class CompactSparseQ:
    """``CompactSparse`` with an int8 inner plan: the live channels of x are
    quantized (the per-frame scale taken over them, as ``tpuseg`` does after
    its gather) and run through kernel B3.  On the card the quantize kernels
    read the live channels through ``live_in32`` and write the compacted
    int8 x, so no gathered float copy of x is made; on the CPU the plain
    version gathers with ``index_select``."""

    live_in: torch.Tensor  # (n_live,) int64 input-channel gather
    inner: FusedSparseConvQ
    live_in32: torch.Tensor | None = None  # the same gather, int32: the kernels' map

    def __post_init__(self):
        if self.live_in32 is None:
            self.live_in32 = self.live_in.to(torch.int32)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return fused_sparse_conv_apply_q(x, self.inner, chan=self.live_in32)

    def apply_bias_bf16(self, x: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
        """The served bf16 route (``fused_sparse_conv_q_bias_bf16``) of the
        compacted conv."""
        return fused_sparse_conv_q_bias_bf16(x, self.inner, bias, chan=self.live_in32)

    def to(self, device) -> "CompactSparseQ":
        return CompactSparseQ(self.live_in.to(device), self.inner.to(device),
                              self.live_in32.to(device))


def quantize_sparse_plans(plans: Mapping, x_scales: Mapping | None = None) -> dict:
    """Lift a plan dict to int8 where an int8 lowering exists; other plan
    kinds pass through unchanged.  ``x_scales`` maps conv name -> static
    activation scale (``tpuseg_torch.ops.quant.calibrate_scales``); convs
    without one quantize x per frame."""
    out: dict = {}
    for name, p in plans.items():
        xs = (x_scales or {}).get(name)
        if isinstance(p, FusedSparseConv):
            out[name] = quantize_fused_plan(p, x_scale=xs)
        elif isinstance(p, CompactSparse):
            out[name] = CompactSparseQ(p.live_in, quantize_fused_plan(p.inner, x_scale=xs))
        elif isinstance(p, GatheredGroupConv):
            out[name] = quantize_gathered_plan(p, x_scale=xs)
        else:
            out[name] = p
    return out


def plans_to(plans: Mapping | None, device) -> dict | None:
    """Every plan of ``plans`` with its tensors on ``device``."""
    if plans is None:
        return None
    return {name: plan.to(device) for name, plan in plans.items()}


def _conv_defs(spec: DrnSpec) -> dict:
    convs = {}
    for _, stage in spec.stages:
        if stage.kind == "convs":
            for cdef, _bn in stage.convs:
                convs[cdef.name] = cdef
        else:
            for blk in stage.blocks:
                for cdef in blk.convs:
                    convs[cdef.name] = cdef
                if blk.downsample is not None:
                    convs[blk.downsample[0].name] = blk.downsample[0]
    return convs


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float().numpy()
    return np.asarray(a, np.float32)


def build_sparse_plans(
    params: Mapping,
    masks: Mapping,
    spec: DrnSpec,
    dense_threshold: float = 0.75,
    dtype: torch.dtype = torch.bfloat16,
    lowering: str = "pallas",
    gathered_mode: str = "exact",
) -> tuple[dict, dict]:
    """``(plans, report)`` for every masked conv of ``spec``: ``plans``
    maps conv name -> plan for the lowered convs, ``report`` every masked
    conv -> the decision taken (``tpuseg``'s strings).  ``params`` and
    ``masks`` hold OIHW weights (tensors or numpy).  A conv whose block
    density reaches ``dense_threshold`` stays dense (``tpuseg``'s keyword
    and default; its ``rows_per_tile`` is a TPU tiling knob and has no
    counterpart)."""
    assert lowering in ("pallas", "gathered"), lowering
    convs = _conv_defs(spec)
    plans: dict = {}
    report: dict = {}
    for mask_name, mask in masks.items():
        if not mask_name.endswith(".weight"):
            continue
        cname = mask_name[: -len(".weight")]
        cdef = convs.get(cname)
        if cdef is None:
            continue
        w = _np(params[mask_name])
        mk = _np(mask)

        rplan = plan_rbgp(w, mk, dtype=dtype)
        if rplan.kind == "column_compact" and cdef.stride == 1 and lowering == "pallas":
            live = rplan.live_in.numpy()
            if live.size % 128 == 0 and cdef.cout % 128 == 0 and live.size >= 128:
                fplan = plan_fused_sparse_conv(w[:, live], mk[:, live],
                                               dilation=cdef.dilation, dtype=dtype)
                if fplan.block_density < dense_threshold:
                    plans[cname] = CompactSparse(rplan.live_in, fplan)
                    report[cname] = (
                        f"compact+sparse: {cdef.cin - live.size}/{cdef.cin} "
                        f"dead channels, survivor block density "
                        f"{fplan.block_density:.2f}"
                    )
                    continue
        if (
            rplan.kind != "dense"
            and not (rplan.kind == "tap_compact" and cdef.stride != 1)
            and not (
                # the gathered lowering subsumes channel compaction
                lowering == "gathered"
                and rplan.kind == "column_compact"
                and cdef.stride == 1
                and cdef.cin % 128 == 0
                and cdef.cout % 128 == 0
            )
        ):
            plans[cname] = rplan
            report[cname] = f"rbgp {rplan.kind}: {rplan.note}"
            continue

        if cdef.stride != 1:
            report[cname] = "dense: stride != 1"
            continue
        if cdef.cin % 128 or cdef.cout % 128:
            report[cname] = f"dense: channels {cdef.cin}x{cdef.cout} not /128"
            continue
        if lowering == "gathered":
            gplan = plan_gathered_conv(w, mk, dilation=cdef.dilation, dtype=dtype,
                                       mode=gathered_mode)
            if gplan.block_density >= dense_threshold:
                report[cname] = f"dense: block density {gplan.block_density:.2f}"
                continue
            if w.shape[2] == 1 and w.shape[3] == 1:
                # a 1x1 has no tap loop to amortize the channel gather: lower
                # it only when the gather is nearly free or exact mode skips
                # dead out-blocks
                dead = gathered_mode == "exact" and any(len(ks) == 0 for ks in gplan.idx)
                if gplan.block_density > GATHER_1X1_MAX_DENSITY and not dead:
                    report[cname] = (
                        f"dense: 1x1 gather unpaid (block density "
                        f"{gplan.block_density:.2f} > "
                        f"{GATHER_1X1_MAX_DENSITY}, no dead out-blocks)"
                    )
                    continue
            plans[cname] = gplan
            report[cname] = (
                f"gathered[{gathered_mode}]: block density "
                f"{gplan.block_density:.2f}, S={gplan.s}"
            )
            continue
        plan = plan_fused_sparse_conv(w, mk, dilation=cdef.dilation, dtype=dtype)
        if plan.block_density >= dense_threshold:
            report[cname] = (
                f"dense: union block density {plan.block_density:.2f}"
                + (f"; {rplan.note}" if "periodic" in rplan.note else "")
            )
            continue
        plans[cname] = plan
        report[cname] = f"sparse: union block density {plan.block_density:.2f}"
    return plans, report
