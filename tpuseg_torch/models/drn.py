"""Dilated Residual Networks (DRN): the inference forward in PyTorch.

Counterpart of ``tpuseg/models/drn.py``.  The architecture spec
(``ConvDef`` ... ``DrnSpec``, ``DRN_ARCHS``, ``build_drn_spec``) and the numpy
init are copied from there unchanged, so one seed gives identical weights in
both packages.  The forward is the eval path only: dense convs through
``torch.nn.functional.conv2d`` (cuDNN on the card), eval-mode BatchNorm or
BN-folded biases, and the same residual rule.  Convs listed in a
``sparse_plans`` dict (``tpuseg_torch.models.sparse_exec.build_sparse_plans``,
``tpuseg_torch.ops.quant.build_quant_plans``) run through their sparse or
int8 lowering instead.  No train mode, no remat.

Layout: parameters are a flat ``{torch-style name: tensor}`` dict with conv
weights in OIHW (``tpuseg`` stores HWIO; ``tpuseg_torch.models.weights``
converts).  ``drn_forward`` takes and returns NHWC tensors like ``tpuseg``;
inside, activations are NCHW-shaped in ``torch.channels_last`` memory, so
the permutes at the edges are views.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.models.weights import from_jax_params

Params = dict[str, torch.Tensor]
State = dict[str, torch.Tensor]

BN_EPS = 1e-5
BN_MOMENTUM = 0.1

# arch name -> (block kind, per-stage block counts)
# cf. the reference drn.py:333-414
DRN_ARCHS: dict[str, tuple[str, list[int], str]] = {
    # DRN_A: ResNet-style stem (7x7 s2 + maxpool) with dilated layer3/4 and a
    # Linear head (the reference drn.py:262-330, drn_a_50 at :333-337)
    "drn_a_50": ("bottleneck", [3, 4, 6, 3], "A"),
    "drn_c_26": ("basic", [1, 1, 2, 2, 2, 2, 1, 1], "C"),
    "drn_c_42": ("basic", [1, 1, 3, 4, 6, 3, 1, 1], "C"),
    "drn_c_58": ("bottleneck", [1, 1, 3, 4, 6, 3, 1, 1], "C"),
    "drn_d_22": ("basic", [1, 1, 2, 2, 2, 2, 1, 1], "D"),
    "drn_d_24": ("basic", [1, 1, 2, 2, 2, 2, 2, 2], "D"),
    "drn_d_38": ("basic", [1, 1, 3, 4, 6, 3, 1, 1], "D"),
    "drn_d_40": ("basic", [1, 1, 3, 4, 6, 3, 2, 2], "D"),
    "drn_d_54": ("bottleneck", [1, 1, 3, 4, 6, 3, 1, 1], "D"),
    "drn_d_56": ("bottleneck", [1, 1, 3, 4, 6, 3, 2, 2], "D"),
    "drn_d_105": ("bottleneck", [1, 1, 3, 4, 23, 3, 1, 1], "D"),
    "drn_d_107": ("bottleneck", [1, 1, 3, 4, 23, 3, 2, 2], "D"),
}

DEFAULT_CHANNELS = (16, 32, 64, 128, 256, 512, 512, 512)
EXPANSION = {"basic": 1, "bottleneck": 4}


# --------------------------------------------------------------------------
# Static architecture spec
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConvDef:
    name: str
    cin: int
    cout: int
    kernel: int
    stride: int = 1
    dilation: int = 1
    padding: int = 0
    bias: bool = False


@dataclasses.dataclass(frozen=True)
class BNDef:
    name: str
    ch: int


@dataclasses.dataclass(frozen=True)
class BlockDef:
    """One residual block (basic or bottleneck)."""

    kind: str  # "basic" | "bottleneck"
    convs: tuple[ConvDef, ...]
    bns: tuple[BNDef, ...]
    downsample: tuple[ConvDef, BNDef] | None
    residual: bool


@dataclasses.dataclass(frozen=True)
class StageDef:
    """A backbone stage: either plain conv-bn-relu repeats or residual blocks."""

    kind: str  # "convs" | "blocks"
    convs: tuple[tuple[ConvDef, BNDef], ...] = ()
    blocks: tuple[BlockDef, ...] = ()


@dataclasses.dataclass(frozen=True)
class DrnSpec:
    arch: str
    variant: str  # "A" | "C" | "D"
    stages: tuple[tuple[str, StageDef], ...]  # (stage key prefix, stage)
    out_dim: int
    num_classes: int
    pool_size: int
    fc_name: str | None
    # DRN_A: 3x3/s2 maxpool after the stem, stride-1 avgpool, Linear head
    # (drn.py:272,280-281)
    stem_maxpool: bool = False
    linear_fc: bool = False


def _make_blocks_stage(
    key: Callable[[str], str],
    kind: str,
    inplanes: int,
    planes: int,
    n_blocks: int,
    stride: int,
    dilation: int,
    new_level: bool,
    residual: bool,
    a_style: bool = False,
) -> tuple[StageDef, int]:
    """Residual-block stage constructor.

    Mirrors the semantics of the reference ``DRN._make_layer``
    (the reference drn.py:177-199): first block takes the stride and a
    possibly-halved first dilation, and a 1x1-conv downsample path appears
    when the shape changes.  ``a_style`` follows ``DRN_A._make_layer``
    (drn.py:297-314) instead: the first block always runs at dilation 1.
    """
    assert dilation == 1 or dilation % 2 == 0
    expansion = EXPANSION[kind]
    if a_style:
        first_dil = (1, 1)
    else:
        first_dil = (
            (1, 1)
            if dilation == 1
            else ((dilation // 2 if new_level else dilation), dilation)
        )
    blocks = []
    for b in range(n_blocks):
        dil = first_dil if b == 0 else (dilation, dilation)
        bname = key(str(b))
        downsample = None
        if b == 0 and (stride != 1 or inplanes != planes * expansion):
            downsample = (
                ConvDef(f"{bname}.downsample.0", inplanes, planes * expansion, 1, stride),
                BNDef(f"{bname}.downsample.1", planes * expansion),
            )
        s = stride if b == 0 else 1
        if kind == "basic":
            convs = (
                ConvDef(f"{bname}.conv1", inplanes, planes, 3, s, dil[0], dil[0]),
                ConvDef(f"{bname}.conv2", planes, planes, 3, 1, dil[1], dil[1]),
            )
            bns = (BNDef(f"{bname}.bn1", planes), BNDef(f"{bname}.bn2", planes))
            out = planes
        else:
            convs = (
                ConvDef(f"{bname}.conv1", inplanes, planes, 1),
                ConvDef(f"{bname}.conv2", planes, planes, 3, s, dil[1], dil[1]),
                ConvDef(f"{bname}.conv3", planes, planes * 4, 1),
            )
            bns = (
                BNDef(f"{bname}.bn1", planes),
                BNDef(f"{bname}.bn2", planes),
                BNDef(f"{bname}.bn3", planes * 4),
            )
            out = planes * 4
        blocks.append(BlockDef(kind, convs, bns, downsample, residual))
        inplanes = out
    return StageDef("blocks", blocks=tuple(blocks)), inplanes


def _make_convs_stage(
    key: Callable[[str], str],
    inplanes: int,
    channels: int,
    n_convs: int,
    stride: int = 1,
    dilation: int = 1,
) -> tuple[StageDef, int]:
    """Plain conv-bn-relu stage (reference ``_make_conv_layers``, drn.py:201-211).

    The reference flattens each (conv, bn, relu) triple into one Sequential,
    so conv ``j`` gets index ``3*j`` and its BN index ``3*j+1``.
    """
    convs = []
    for j in range(n_convs):
        convs.append(
            (
                ConvDef(
                    key(str(3 * j)),
                    inplanes,
                    channels,
                    3,
                    stride if j == 0 else 1,
                    dilation,
                    dilation,
                ),
                BNDef(key(str(3 * j + 1)), channels),
            )
        )
        inplanes = channels
    return StageDef("convs", convs=tuple(convs)), inplanes


def build_drn_spec(
    arch: str,
    num_classes: int = 1000,
    channels: tuple[int, ...] = DEFAULT_CHANNELS,
    pool_size: int = 28,
    naming: str = "cls",
) -> DrnSpec:
    """Build the static spec for a DRN architecture.

    ``naming='cls'`` produces torch-DRN keys (``layer3.0.conv1.weight``);
    ``naming='seg'`` produces DRNSeg-Sequential keys (``layer.3.0.conv1.weight``)
    matching the reference head wrapper (semantic_seg.py:135).
    """
    kind, layers, variant = DRN_ARCHS[arch]
    sep = "." if naming == "seg" else ""
    prefix = "layer." if naming == "seg" else "layer"

    def stage_key(i: int) -> Callable[[str], str]:
        return lambda rest: f"{prefix}{i}.{rest}"

    stages: list[tuple[str, StageDef]] = []
    inplanes = channels[0]

    if variant == "A":
        # DRN_A (drn.py:262-330): 7x7/s2 stem + maxpool, four ResNet layers
        # with dilation 1/1/2/4, stride-1 avgpool, Linear head.
        if naming == "seg":
            raise ValueError("DRN-A variants are classification-only")
        inplanes = 64
        stem = StageDef(
            "convs",
            convs=((ConvDef("conv1", 3, 64, 7, 2, 1, 3), BNDef("bn1", 64)),),
        )
        stages.append(("stem", stem))
        plan = [(64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4)]
        for i, (planes, stride, dil) in enumerate(plan, start=1):
            st, inplanes = _make_blocks_stage(
                stage_key(i), kind, inplanes, planes, layers[i - 1],
                stride, dil, False, True, a_style=True,
            )
            stages.append((f"{prefix}{i}", st))
        return DrnSpec(
            arch=arch,
            variant="A",
            stages=tuple(stages),
            out_dim=inplanes,
            num_classes=num_classes,
            pool_size=pool_size,
            fc_name="fc" if num_classes > 0 else None,
            stem_maxpool=True,
            linear_fc=True,
        )

    if variant == "C":
        # conv1/bn1 at top level (drn.py:121-130); C-arch is used for
        # classification only in the reference, so 'seg' naming is unsupported.
        if naming == "seg":
            raise ValueError("DRN-C variants are classification-only")
        stage0 = StageDef(
            "convs",
            convs=((ConvDef("conv1", 3, channels[0], 7, 1, 1, 3), BNDef("bn1", channels[0])),),
        )
        stages.append(("stem", stage0))
        s1, inplanes = _make_blocks_stage(
            stage_key(1), "basic", inplanes, channels[0], layers[0], 1, 1, True, True
        )
        stages.append((f"{prefix}1", s1))
        s2, inplanes = _make_blocks_stage(
            stage_key(2), "basic", inplanes, channels[1], layers[1], 2, 1, True, True
        )
        stages.append((f"{prefix}2", s2))
    else:
        s0 = StageDef(
            "convs",
            convs=(
                (
                    ConvDef(f"{prefix}0.0", 3, channels[0], 7, 1, 1, 3),
                    BNDef(f"{prefix}0.1", channels[0]),
                ),
            ),
        )
        stages.append((f"{prefix}0", s0))
        s1, inplanes = _make_convs_stage(stage_key(1), inplanes, channels[0], layers[0], 1)
        stages.append((f"{prefix}1", s1))
        s2, inplanes = _make_convs_stage(stage_key(2), inplanes, channels[1], layers[1], 2)
        stages.append((f"{prefix}2", s2))

    s3, inplanes = _make_blocks_stage(
        stage_key(3), kind, inplanes, channels[2], layers[2], 2, 1, True, True
    )
    stages.append((f"{prefix}3", s3))
    s4, inplanes = _make_blocks_stage(
        stage_key(4), kind, inplanes, channels[3], layers[3], 2, 1, True, True
    )
    stages.append((f"{prefix}4", s4))
    s5, inplanes = _make_blocks_stage(
        stage_key(5), kind, inplanes, channels[4], layers[4], 1, 2, False, True
    )
    stages.append((f"{prefix}5", s5))
    if layers[5] != 0:
        s6, inplanes = _make_blocks_stage(
            stage_key(6), kind, inplanes, channels[5], layers[5], 1, 4, False, True
        )
        stages.append((f"{prefix}6", s6))

    if variant == "C":
        if layers[6] != 0:
            s7, inplanes = _make_blocks_stage(
                stage_key(7), "basic", inplanes, channels[6], layers[6], 1, 2, False, False
            )
            stages.append((f"{prefix}7", s7))
        if layers[7] != 0:
            s8, inplanes = _make_blocks_stage(
                stage_key(8), "basic", inplanes, channels[7], layers[7], 1, 1, False, False
            )
            stages.append((f"{prefix}8", s8))
    else:
        if layers[6] != 0:
            s7, inplanes = _make_convs_stage(stage_key(7), inplanes, channels[6], layers[6], 1, 2)
            stages.append((f"{prefix}7", s7))
        if layers[7] != 0:
            s8, inplanes = _make_convs_stage(stage_key(8), inplanes, channels[7], layers[7], 1, 1)
            stages.append((f"{prefix}8", s8))

    return DrnSpec(
        arch=arch,
        variant=variant,
        stages=tuple(stages),
        out_dim=inplanes,
        num_classes=num_classes,
        pool_size=pool_size,
        fc_name="fc" if num_classes > 0 and naming == "cls" else None,
    )


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------


def rng_from_key(key: int) -> np.random.Generator:
    """Host-side numpy Generator from an int seed (``tpuseg``'s int path)."""
    if not isinstance(key, (int, np.integer)):
        raise TypeError(f"the port seeds from an int, got {type(key).__name__}")
    return np.random.default_rng(int(key))


def _he_normal_conv(rng: np.random.Generator, cdef: ConvDef) -> np.ndarray:
    """He init matching the reference (std = sqrt(2 / (kh*kw*cout)), drn.py:169-172).

    Stored HWIO: (kh, kw, cin, cout).
    """
    n = cdef.kernel * cdef.kernel * cdef.cout
    std = math.sqrt(2.0 / n)
    shape = (cdef.kernel, cdef.kernel, cdef.cin, cdef.cout)
    return (std * rng.standard_normal(shape)).astype(np.float32)


def _init_conv_bn(
    rng: np.random.Generator,
    cdef: ConvDef,
    bdef: BNDef | None,
    params: dict[str, np.ndarray],
    state: dict[str, np.ndarray],
) -> None:
    params[f"{cdef.name}.weight"] = _he_normal_conv(rng, cdef)
    if cdef.bias:
        params[f"{cdef.name}.bias"] = np.zeros((cdef.cout,), np.float32)
    if bdef is not None:
        params[f"{bdef.name}.weight"] = np.ones((bdef.ch,), np.float32)
        params[f"{bdef.name}.bias"] = np.zeros((bdef.ch,), np.float32)
        state[f"{bdef.name}.running_mean"] = np.zeros((bdef.ch,), np.float32)
        state[f"{bdef.name}.running_var"] = np.ones((bdef.ch,), np.float32)


def init_drn(key: int, spec: DrnSpec) -> tuple[Params, State]:
    """Initialize a flat param dict + BN state dict for ``spec``.

    ``key`` is an int seed.  The draws are ``tpuseg``'s, in its order and in
    its HWIO layout, so both packages build identical bytes from one seed;
    the result is converted to the port's OIHW CPU tensors at the end.
    """
    rng = rng_from_key(key)
    params: dict[str, np.ndarray] = {}
    state: dict[str, np.ndarray] = {}
    for _, stage in spec.stages:
        if stage.kind == "convs":
            for cdef, bdef in stage.convs:
                _init_conv_bn(rng, cdef, bdef, params, state)
        else:
            for block in stage.blocks:
                for cdef, bdef in zip(block.convs, block.bns):
                    _init_conv_bn(rng, cdef, bdef, params, state)
                if block.downsample is not None:
                    _init_conv_bn(rng, *block.downsample, params, state)
    if spec.fc_name is not None:
        if spec.linear_fc:
            # DRN_A Linear head (drn.py:280); torch-default uniform init,
            # stored in torch (out, in) layout like the cifar zoo.
            bound = 1.0 / math.sqrt(spec.out_dim)
            params[f"{spec.fc_name}.weight"] = rng.uniform(
                -bound, bound, size=(spec.num_classes, spec.out_dim)
            ).astype(np.float32)
            params[f"{spec.fc_name}.bias"] = rng.uniform(
                -bound, bound, size=(spec.num_classes,)
            ).astype(np.float32)
        else:
            # 1x1 conv classifier head (drn.py:167-168)
            cdef = ConvDef(spec.fc_name, spec.out_dim, spec.num_classes, 1, bias=True)
            _init_conv_bn(rng, cdef, None, params, state)
    return from_jax_params(params, state)


# --------------------------------------------------------------------------
# Forward (inference)
# --------------------------------------------------------------------------


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    stride: int = 1,
    dilation: int = 1,
    padding: int = 0,
    compute_dtype: torch.dtype | None = None,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """NCHW x OIHW conv; both operands are cast to ``compute_dtype`` first
    (``tpuseg``'s policy: the output dtype follows the operands)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    if bias is not None:
        bias = bias.to(x.dtype)
    return F.conv2d(x, w, bias, stride, padding, dilation)


def batch_norm(
    x: torch.Tensor, params: Params, state: State, name: str, eps: float = BN_EPS
) -> torch.Tensor:
    """Eval-mode BatchNorm over the channel axis of an NCHW tensor, in f32
    with the result cast back to ``x.dtype`` (``tpuseg`` drn.py:502-506)."""
    shape = (1, -1, 1, 1)
    inv = torch.rsqrt(state[f"{name}.running_var"] + eps) * params[f"{name}.weight"]
    out = (x.float() - state[f"{name}.running_mean"].view(shape)) * inv.view(shape)
    return (out + params[f"{name}.bias"].view(shape)).to(x.dtype)


def _sparse_conv(x, plan, cdef: ConvDef):
    """One conv through its plan, as ``tpuseg`` dispatches it
    (drn.py:516-546): an ``RbgpPlan`` to ``rbgp_conv_apply``, a
    ``FusedSparseConvQ`` to the int8 block-sparse kernel, a plan with
    ``.apply`` (``CompactSparse(Q)``, ``GatheredGroupConv(Q)``,
    ``QuantConv``, calibration probes) to it, otherwise
    (``FusedSparseConv``) to the fused block-sparse kernel.  NCHW in and
    out; the plans take NHWC-contiguous x, free when x is channels_last."""
    from tpuseg_torch.ops.rbgp_matmul import RbgpPlan, rbgp_conv_apply
    from tpuseg_torch.ops.sparse_conv import (
        FusedSparseConvQ,
        fused_sparse_conv_apply,
        fused_sparse_conv_apply_q,
    )

    xh = nchw_to_nhwc(x).contiguous()
    if isinstance(plan, RbgpPlan):
        y = rbgp_conv_apply(xh, plan, cdef.stride, cdef.dilation, cdef.padding)
    elif isinstance(plan, FusedSparseConvQ):
        y = fused_sparse_conv_apply_q(xh, plan)
    elif hasattr(plan, "apply"):
        y = plan.apply(xh)
    else:
        y = fused_sparse_conv_apply(xh, plan)
    return nhwc_to_nchw(y)


def _conv_maybe_bn(x, params, state, cdef: ConvDef, bdef: BNDef | None, compute_dtype,
                   sparse_plans=None):
    """conv -> (folded bias | batch norm).  BN-folded weights
    (``tpuseg_torch.ops.fold_bn``) carry a conv bias and no BN params.

    A dense conv carries the bias inside the cuDNN call; ``tpuseg`` adds it
    after the conv in the compute dtype, so in bf16 the two round at
    different points.  A conv with a sparse plan follows ``tpuseg``'s order
    exactly: the plan's output is cast to the compute dtype, then the bias
    is added in that dtype (drn.py:556-560)."""
    plan = sparse_plans.get(cdef.name) if sparse_plans else None
    bias = params.get(f"{cdef.name}.bias")
    if plan is not None:
        out_dtype = x.dtype if compute_dtype is None else compute_dtype
        x = _sparse_conv(x, plan, cdef).to(out_dtype)
        if bias is not None:
            x = x + bias.to(x.dtype).view(1, -1, 1, 1)
    else:
        x = conv2d(
            x,
            params[f"{cdef.name}.weight"],
            cdef.stride,
            cdef.dilation,
            cdef.padding,
            compute_dtype,
            bias=bias,
        )
    if bdef is not None and f"{bdef.name}.weight" in params:
        x = batch_norm(x, params, state, bdef.name)
    return x


def _run_block(x, params, state, block: BlockDef, compute_dtype, sparse_plans=None):
    residual = x
    out = x
    n = len(block.convs)
    for i, (cdef, bdef) in enumerate(zip(block.convs, block.bns)):
        out = _conv_maybe_bn(out, params, state, cdef, bdef, compute_dtype, sparse_plans)
        if i < n - 1:
            out = F.relu_(out)
    if block.downsample is not None:
        cdef, bdef = block.downsample
        residual = _conv_maybe_bn(residual, params, state, cdef, bdef, compute_dtype,
                                  sparse_plans)
    # Bottleneck always adds the residual (drn.py:103); BasicBlock honors the
    # flag (drn.py:61-62) even when a downsample path exists.
    if block.kind == "bottleneck" or block.residual:
        out = out + residual
    return F.relu_(out)


def _run_stage(x, params, state, stage: StageDef, compute_dtype, sparse_plans=None):
    if stage.kind == "convs":
        for cdef, bdef in stage.convs:
            x = F.relu_(_conv_maybe_bn(x, params, state, cdef, bdef, compute_dtype,
                                       sparse_plans))
    else:
        for block in stage.blocks:
            x = _run_block(x, params, state, block, compute_dtype, sparse_plans)
    return x


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW-shaped view (channels_last memory when ``x`` is
    contiguous)."""
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> NHWC-shaped view (contiguous when ``x`` is
    channels_last)."""
    return x.permute(0, 2, 3, 1)


def drn_forward(
    params: Params,
    state: State,
    x: torch.Tensor,
    spec: DrnSpec,
    *,
    compute_dtype: torch.dtype | None = None,
    stem_fn: Callable | None = None,
    stem_stages: int = 1,
    sparse_plans: dict | None = None,
) -> torch.Tensor:
    """Run the DRN backbone (inference): NHWC ``x`` -> NHWC feature map.

    ``stem_fn`` optionally replaces the first ``stem_stages`` stages
    (BN-folded weights only) — the polyphase frontend
    (``tpuseg_torch.ops.polyphase``), which takes the raw frames and returns
    NHWC features.  When it covers a single conv stage, the trailing ReLU is
    applied here; multi-stage frontends apply their own activations.

    ``sparse_plans`` maps conv names to sparse plans (on ``x``'s device);
    plans of stages that ``stem_fn`` replaces are not used, as in ``tpuseg``.

    Only backbones without a classifier head (the DRNSeg backbone, and
    classification specs built with ``num_classes=0``) are served here.
    """
    if spec.fc_name is not None or spec.stem_maxpool:
        raise ValueError(
            f"{spec.arch}: the port's drn_forward serves headless DRN-C/D "
            "backbones (DRNSeg); classifier heads are not ported"
        )
    if compute_dtype is not None and stem_fn is None:
        # a stem_fn owns its own input handling (the polyphase frontend
        # space-to-depths RAW uint8 frames before any float math)
        x = x.to(compute_dtype)
    for stage_index, (_, stage) in enumerate(spec.stages):
        if stem_fn is not None and stage_index < stem_stages:
            if stage_index == 0:
                x = nhwc_to_nchw(stem_fn(x))
                if stem_stages == 1:
                    x = F.relu(x)
            continue
        if stage_index == 0:
            x = nhwc_to_nchw(x)
        x = _run_stage(x, params, state, stage, compute_dtype, sparse_plans)
    return nchw_to_nhwc(x)
