"""Dilated Residual Networks (DRN): the forward in PyTorch, eval and train.

Counterpart of ``tpuseg/models/drn.py``.  The architecture spec
(``ConvDef`` ... ``DrnSpec``, ``DRN_ARCHS``, ``build_drn_spec``) and the numpy
init are copied from there unchanged, so one seed gives identical weights in
both packages.  The forward runs dense convs through
``torch.nn.functional.conv2d`` (cuDNN on the card), BatchNorm (eval: the
running stats; train: f32 batch statistics, with the running-stat updates
returned, not written) or BN-folded biases, and the same residual rule.
Convs listed in a ``sparse_plans`` dict run through their sparse or int8
lowering instead (``tpuseg_torch.models.sparse_exec.build_sparse_plans``,
``tpuseg_torch.ops.quant.build_quant_plans``), or, in training, through the
trainable block-sparse conv
(``tpuseg_torch.ops.sparse_train.build_sparse_train_structs``).  ``remat``
recomputes each stage in the backward pass (``torch.utils.checkpoint``).

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

from tpuseg_torch.metrics.profiling import span
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


def jax_key(seed: int) -> tuple[int, int]:
    """The key data of ``jax.random.key(seed)`` (threefry: ``[0, seed]``).

    Pass it as the ``key`` of ``init_drn``/``init_drnseg`` to draw the
    weights ``tpuseg`` draws from ``jax.random.key(seed)``: its
    ``rng_from_key`` seeds numpy from the key's data,
    ``SeedSequence([0, seed])``, where an int seed gives
    ``default_rng(seed)``."""
    return (0, int(seed))


def rng_from_key(key) -> np.random.Generator:
    """Host-side numpy Generator, as ``tpuseg``'s: an int seed gives
    ``default_rng(seed)``; a key's data (a sequence of ints, ``jax_key``)
    gives ``default_rng(SeedSequence(data))``."""
    if isinstance(key, (int, np.integer)):
        return np.random.default_rng(int(key))
    if isinstance(key, (tuple, list)) and all(isinstance(v, (int, np.integer)) for v in key):
        return np.random.default_rng(np.random.SeedSequence([int(v) for v in key]))
    raise TypeError(f"the port seeds from an int or a key's data, got {type(key).__name__}")


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


def init_drn(key, spec: DrnSpec) -> tuple[Params, State]:
    """Initialize a flat param dict + BN state dict for ``spec``.

    ``key`` is an int seed or a key's data (``jax_key``).  The draws are ``tpuseg``'s, in its order and in
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
# Forward
# --------------------------------------------------------------------------


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    stride: int = 1,
    dilation: int = 1,
    padding: int = 0,
    compute_dtype: torch.dtype | None = None,
    bias: torch.Tensor | None = None,
    groups: int = 1,
) -> torch.Tensor:
    """NCHW x OIHW conv; both operands are cast to ``compute_dtype`` first
    (``tpuseg``'s policy: the output dtype follows the operands)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    if bias is not None:
        bias = bias.to(x.dtype)
    return F.conv2d(x, w, bias, stride, padding, dilation, groups)


def batch_norm(
    x: torch.Tensor, params: Params, state: State, name: str, eps: float = BN_EPS,
    updates: State | None = None, momentum: float = BN_MOMENTUM, ranks=None,
) -> torch.Tensor:
    """BatchNorm over the channel axis of an NCHW tensor, in f32 with the
    result cast back to ``x.dtype`` (``tpuseg`` drn.py:474-506).

    Eval (``updates`` None): the running statistics.  Train (``updates`` a
    dict): the f32 batch mean and biased variance normalize, and the running
    statistics' new values (the unbiased variance folded in at
    ``momentum``) go into ``updates``; nothing is written in place, so a
    stage recomputed under ``remat`` applies the momentum once.

    ``ranks`` (``tpuseg_torch.parallel.mesh.Ranks``, train mode): the batch
    is this rank's equal part of a global one, and the statistics are the
    global batch's: each rank's mean and M2 (sum of squared deviations) are
    gathered with their gradient path and combined by Chan's method in rank
    order (bit-equal on every rank), and the unbiased correction uses the
    global count."""
    shape = (1, -1, 1, 1)
    if updates is None:
        mean, var = state[f"{name}.running_mean"], state[f"{name}.running_var"]
        n = 0
    elif ranks is None:
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
        n = x.numel() // x.shape[1]
    else:
        var_r, mean_r = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
        n_r = x.numel() // x.shape[1]
        stats = ranks.gather(torch.stack([mean_r, var_r]))  # (R, 2, C)
        means, m2s = stats[:, 0], stats[:, 1] * n_r
        mean = means.mean(dim=0)
        n = n_r * ranks.size
        var = (m2s.sum(dim=0) + n_r * ((means - mean) ** 2).sum(dim=0)) / n
    if updates is not None:
        unbiased = var.detach() * (n / max(n - 1, 1))
        updates[f"{name}.running_mean"] = (
            (1 - momentum) * state[f"{name}.running_mean"] + momentum * mean.detach())
        updates[f"{name}.running_var"] = (
            (1 - momentum) * state[f"{name}.running_var"] + momentum * unbiased)
    inv = torch.rsqrt(var + eps) * params[f"{name}.weight"]
    out = (x.float() - mean.view(shape)) * inv.view(shape)
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


def _sparse_conv_bias_bf16(x, plan, bias):
    """bf16 serving of a plan whose kernel has a bf16+bias epilogue: one
    launch writes the conv's bf16 output with its bias added, the bits of
    the cast-then-bias passes.  bf16 ``FusedSparseConv`` and
    ``CompactSparse`` plans take B2's route
    (``tpuseg_torch.ops.sparse_conv.fused_sparse_conv_bias_bf16``); the four
    int8 plans (``QuantConv``, ``FusedSparseConvQ``, ``CompactSparseQ``,
    ``GatheredGroupConvQ``) B3's (``fused_sparse_conv_q_bias_bf16``).  None
    for every other plan (RBGP, float gathered, f32 plans, calibration
    probes), which keeps the two passes.  NCHW in and out."""
    from tpuseg_torch.models.sparse_exec import CompactSparse, CompactSparseQ
    from tpuseg_torch.ops.gathered_conv import GatheredGroupConvQ
    from tpuseg_torch.ops.quant import QuantConv
    from tpuseg_torch.ops.sparse_conv import (
        FusedSparseConv,
        FusedSparseConvQ,
        fused_sparse_conv_bias_bf16,
        fused_sparse_conv_q_bias_bf16,
    )

    xh = nchw_to_nhwc(x).contiguous()
    if isinstance(plan, (QuantConv, CompactSparseQ, GatheredGroupConvQ)) or (
            isinstance(plan, CompactSparse) and plan.inner.vals.dtype == torch.bfloat16):
        y = plan.apply_bias_bf16(xh, bias)
    elif isinstance(plan, FusedSparseConvQ):
        y = fused_sparse_conv_q_bias_bf16(xh, plan, bias)
    elif isinstance(plan, FusedSparseConv) and plan.vals.dtype == torch.bfloat16:
        y = fused_sparse_conv_bias_bf16(xh, plan, bias)
    else:
        return None
    return nhwc_to_nchw(y)


def _is_train_plan(plan) -> bool:
    from tpuseg_torch.ops.sparse_train import SparseTrainPlan

    return isinstance(plan, SparseTrainPlan)


def _conv_maybe_bn(x, params, state, cdef: ConvDef, bdef: BNDef | None, compute_dtype,
                   sparse_plans=None, updates=None, ranks=None):
    """conv -> (folded bias | batch norm).  BN-folded weights
    (``tpuseg_torch.ops.fold_bn``) carry a conv bias and no BN params.

    A dense conv carries the bias inside the cuDNN call; ``tpuseg`` adds it
    after the conv in the compute dtype, so in bf16 the two round at
    different points.  A conv with a sparse plan follows ``tpuseg``'s order
    exactly: the plan's output is cast to the compute dtype, then the bias
    is added in that dtype (drn.py:556-560).  In bf16 a bf16
    ``FusedSparseConv`` or ``CompactSparse`` plan and every int8 plan do
    both in their kernel's epilogue, bit for bit
    (``_sparse_conv_bias_bf16``).

    A ``SparseTrainPlan`` (``SparseTrainStruct.to(device)``) runs the
    trainable block-sparse conv on the live weight (``tpuseg``
    drn.py:518-526): packed each call, with the kernel in the forward and
    the dgrad.  ``updates`` (a dict) selects train-mode BatchNorm.

    ``ranks`` (``tpuseg_torch.parallel.mesh.Ranks``): BatchNorm takes the
    global batch's statistics, and with a ``halo`` the rank holds a strip
    of rows: a dense conv runs on the strip and its halo rows
    (``Halo.conv2d``), a plan (stride-1 "same") on the strip widened by
    ``dilation * (k - 1) / 2`` rows each side and cropped back."""
    plan = sparse_plans.get(cdef.name) if sparse_plans else None
    bias = params.get(f"{cdef.name}.bias")
    halo = ranks.halo if ranks is not None else None

    def planned(fn, x):
        if halo is None:
            return fn(x)
        return halo.same(x, cdef.dilation * (cdef.kernel - 1) // 2, fn)

    if plan is not None and _is_train_plan(plan):
        from tpuseg_torch.ops.sparse_train import sparse_conv_train

        out_dtype = x.dtype if compute_dtype is None else compute_dtype
        w = params[f"{cdef.name}.weight"]
        x = planned(lambda x: nhwc_to_nchw(sparse_conv_train(
            nchw_to_nhwc(x), w, plan,
            compute_dtype=out_dtype if compute_dtype else torch.float32)), x).to(out_dtype)
        if bias is not None:
            x = x + bias.to(x.dtype).view(1, -1, 1, 1)
    elif plan is not None:
        out_dtype = x.dtype if compute_dtype is None else compute_dtype
        # the one-launch bf16+bias route equals the two passes bit for bit;
        # a strip takes the two passes
        y = (_sparse_conv_bias_bf16(x, plan, bias)
             if out_dtype == torch.bfloat16 and halo is None else None)
        if y is None:
            y = planned(lambda x: _sparse_conv(x, plan, cdef), x).to(out_dtype)
            if bias is not None:
                y = y + bias.to(y.dtype).view(1, -1, 1, 1)
        x = y
    elif halo is not None:
        w = params[f"{cdef.name}.weight"]
        if compute_dtype is not None:
            x, w = x.to(compute_dtype), w.to(compute_dtype)
        x = halo.conv2d(x, w, None if bias is None else bias.to(x.dtype), cdef.stride,
                        cdef.padding, cdef.dilation)
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
        x = batch_norm(x, params, state, bdef.name, updates=updates, ranks=ranks)
    return x


def _run_block(x, params, state, block: BlockDef, compute_dtype, sparse_plans=None,
               updates=None, ranks=None, stage=None):
    """One residual block.  A bottleneck block's three parts are spans of
    their own (``block.reduce``: conv1 and its ReLU; ``block.spatial``:
    conv2 and its ReLU; ``block.expand``: conv3, the downsample, the
    residual add and the last ReLU), each with the attributes ``stage``
    (the stage index) and ``width`` (the block's output channels)."""
    if block.kind == "bottleneck":
        return _run_bottleneck(x, params, state, block, compute_dtype, sparse_plans, updates,
                               ranks, stage)
    residual = x
    out = x
    n = len(block.convs)
    for i, (cdef, bdef) in enumerate(zip(block.convs, block.bns)):
        out = _conv_maybe_bn(out, params, state, cdef, bdef, compute_dtype, sparse_plans,
                             updates, ranks)
        if i < n - 1:
            out = F.relu_(out)
    if block.downsample is not None:
        cdef, bdef = block.downsample
        residual = _conv_maybe_bn(residual, params, state, cdef, bdef, compute_dtype,
                                  sparse_plans, updates, ranks)
    # BasicBlock honors the residual flag (drn.py:61-62) even when a
    # downsample path exists.
    if block.residual:
        out = out + residual
    return F.relu_(out)


def _run_bottleneck(x, params, state, block: BlockDef, compute_dtype, sparse_plans, updates,
                    ranks, stage):
    """``_run_block`` of a bottleneck block, which always adds the residual
    (drn.py:103)."""
    def conv(cdef, bdef, v):
        return _conv_maybe_bn(v, params, state, cdef, bdef, compute_dtype, sparse_plans,
                              updates, ranks)

    (c1, c2, c3), (b1, b2, b3) = block.convs, block.bns
    attrs = dict(device=x.device, stage=stage, width=c3.cout)
    with span("block.reduce", **attrs):
        out = F.relu_(conv(c1, b1, x))
    with span("block.spatial", **attrs):
        out = F.relu_(conv(c2, b2, out))
    with span("block.expand", **attrs):
        out = conv(c3, b3, out)
        residual = x if block.downsample is None else conv(*block.downsample, x)
        return F.relu_(out + residual)


def _run_stage(x, params, state, stage: StageDef, compute_dtype, sparse_plans=None,
               updates=None, ranks=None, stage_index=None):
    """One backbone stage; ``updates`` (a dict) selects train-mode BatchNorm
    and receives the stage's running-stat updates; ``stage_index`` is the
    ``stage`` attribute of its bottleneck blocks' spans."""
    if stage.kind == "convs":
        for cdef, bdef in stage.convs:
            x = F.relu_(_conv_maybe_bn(x, params, state, cdef, bdef, compute_dtype,
                                       sparse_plans, updates, ranks))
    else:
        for block in stage.blocks:
            x = _run_block(x, params, state, block, compute_dtype, sparse_plans, updates,
                           ranks, stage_index)
    return x


def _stage_and_updates(x, params, state, stage: StageDef, compute_dtype, sparse_plans,
                       train: bool, ranks=None, stage_index=None):
    """``x -> (x, bn_updates)`` of one stage (no updates in eval):
    functional, so that under ``remat`` the checkpoint's recompute returns
    its updates instead of writing them a second time."""
    updates: State | None = {} if train else None
    x = _run_stage(x, params, state, stage, compute_dtype, sparse_plans, updates, ranks,
                   stage_index)
    return x, updates or {}


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
    train: bool = False,
    remat: bool = False,
    ranks=None,
) -> tuple[torch.Tensor, State]:
    """Run the DRN backbone: NHWC ``x`` -> ``(NHWC feature map,
    bn_updates)``, as ``tpuseg``'s ``drn_forward`` without its middle taps.
    ``bn_updates`` is empty in eval; with ``train=True`` it holds every BN's
    new running statistics (``batch_norm``).

    ``stem_fn`` optionally replaces the first ``stem_stages`` stages
    (BN-folded weights only) — the polyphase frontend
    (``tpuseg_torch.ops.polyphase``), which takes the raw frames and returns
    NHWC features.  When it covers a single conv stage, the trailing ReLU is
    applied here; multi-stage frontends apply their own activations.

    ``sparse_plans`` maps conv names to sparse plans (on ``x``'s device);
    plans of stages that ``stem_fn`` replaces are not used, as in ``tpuseg``.

    ``remat=True`` wraps each stage in ``torch.utils.checkpoint`` (not
    reentrant): the backward pass recomputes the stage from its input
    instead of keeping its activations, so a stage's kernels launch twice
    per step.

    A classifier spec (``fc_name`` set, ``tpuseg`` drn.py:684-730) returns
    ``(logits (N, num_classes), bn_updates)`` instead of the feature map:
    DRN-A max-pools the stem's output (3x3, stride 2, padding 1) and ends in
    an average pool of ``min(pool_size, H, W)`` at stride 1 and its Linear
    ``fc``; DRN-C/D end in an average pool of that window at its own stride
    and the 1x1-conv ``fc``.  The window is clamped to the map, so an input
    smaller than the designed 224 still gives logits.

    ``ranks`` (``tpuseg_torch.parallel.mesh.Ranks``): ``x`` is this rank's
    part of a global batch; train-mode BatchNorm takes the global
    statistics, and with a ``halo`` ``x`` is a strip of image rows whose
    convolutions exchange halos (DRNSeg backbones only: no stem frontend,
    no classifier head).
    """
    if ranks is not None and ranks.halo is not None and (
            spec.fc_name is not None or stem_fn is not None or spec.stem_maxpool):
        raise ValueError("a spatially sharded forward runs DRNSeg backbones without a "
                         "stem frontend")
    updates: State = {}
    if compute_dtype is not None and stem_fn is None:
        # a stem_fn owns its own input handling (the polyphase frontend
        # space-to-depths RAW uint8 frames before any float math)
        x = x.to(compute_dtype)
    for stage_index, (stage_name, stage) in enumerate(spec.stages):
        if stem_fn is not None and stage_index < stem_stages:
            if stage_index == 0:
                with span("forward.frontend", device=x.device):
                    x = nhwc_to_nchw(stem_fn(x))
                if stem_stages == 1:
                    x = F.relu(x)
            continue
        if stage_index == 0:
            x = nhwc_to_nchw(x)
        with span(f"forward.{stage_name}", device=x.device):
            if remat:
                from torch.utils.checkpoint import checkpoint

                x, stage_updates = checkpoint(_stage_and_updates, x, params, state, stage,
                                              compute_dtype, sparse_plans, train, ranks,
                                              stage_index, use_reentrant=False)
            else:
                x, stage_updates = _stage_and_updates(x, params, state, stage,
                                                      compute_dtype, sparse_plans, train,
                                                      ranks, stage_index)
        updates.update(stage_updates)
        if stage_name == "stem" and spec.stem_maxpool:
            x = F.max_pool2d(x, 3, 2, 1)
    if spec.fc_name is None:
        return nchw_to_nhwc(x), updates
    return _classifier_head(x, params, spec, compute_dtype), updates


def _classifier_head(x: torch.Tensor, params: Params, spec: DrnSpec,
                     compute_dtype: torch.dtype | None) -> torch.Tensor:
    """NCHW features -> (N, num_classes) logits, ``tpuseg``'s head: the
    average pool in f32 (window ``min(pool_size, H, W)``; stride 1 before
    DRN-A's Linear, the window itself before the 1x1 conv), cast to the
    compute dtype, flattened in NHWC order."""
    p = min(spec.pool_size, x.shape[2], x.shape[3])
    x = F.avg_pool2d(x.float(), p, 1 if spec.linear_fc else p)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    w, b = params[f"{spec.fc_name}.weight"], params[f"{spec.fc_name}.bias"]
    if spec.linear_fc:
        x = nchw_to_nhwc(x).reshape(x.shape[0], -1)
        return x @ w.to(x.dtype).T + b.to(x.dtype)
    # the conv's output in the compute dtype plus the f32 bias: f32 logits
    # under bf16, as in tpuseg
    x = conv2d(x, w, compute_dtype=compute_dtype) + b.view(1, -1, 1, 1)
    return nchw_to_nhwc(x).reshape(x.shape[0], -1)
