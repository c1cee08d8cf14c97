"""CIFAR/ImageNet classifier zoo (counterpart of ``tpuseg/models/cifar.py``).

Families, as in ``tpuseg``:
- ``cresnet``  — scratch CIFAR ResNets incl. pre-activation variants:
  cifar_resnet20/32/44/56/110/1202/164/1001,
  cifar_preact_resnet20/110/164/1001
- ``tvresnet`` — torchvision-style ResNets with a 3x3 stride-1 CIFAR stem:
  cifar_resnet18/34/50/101/152, cifar_resnext50_32x4d/101_32x8d,
  cifar_wide_resnet50_2/101_2
- ``vgg``      — Cifar_VGG incl. reduced rvgg channel configs:
  cifar_vgg11/13/16/19(_bn), cifar_rvgg11_*_bn
- ``rvgg``     — residual VGG: cifar_res_rvgg11_*_bn
- ``wrn``      — Wide ResNet: cifar_wrn_16_4/16_10/28_10/40_4

The spec tables and the numpy init are ``tpuseg``'s, so one seed gives the
same weights in both packages; the port stores conv weights OIHW
(``tpuseg``: HWIO) and Linear weights in torch ``(out, in)`` layout, like
``tpuseg``.  The forward takes and returns NHWC like ``tpuseg``'s; inside,
activations are NCHW-shaped in ``torch.channels_last`` memory, as in
``tpuseg_torch.models.drn``.  Dropout is identity (every shipped config runs
rate 0).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.models.drn import (
    BN_MOMENTUM,
    Params,
    State,
    batch_norm,
    conv2d,
    nchw_to_nhwc,
    nhwc_to_nchw,
    rng_from_key,
)
from tpuseg_torch.models.weights import from_jax_params

VGG_CFGS = {
    "R64": [64, "M", 64, "M", 64, 64, "M", 64, 64, "M", 64, 64],
    "R128": [128, "M", 128, "M", 128, 128, "M", 128, 128, "M", 128, 128],
    "R256": [256, "M", 256, "M", 256, 256, "M", 256, 256, "M", 256, 256],
    "R512": [512, "M", 512, "M", 512, 512, "M", 512, 512, "M", 512, 512],
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
          512, "M", 512, 512, 512, 512],
}

RVGG_CFGS = {k: v + ["M"] for k, v in VGG_CFGS.items() if k.startswith("R")}


@dataclasses.dataclass(frozen=True)
class CifarSpec:
    family: str  # cresnet | tvresnet | vgg | rvgg | wrn
    arch: str
    num_classes: int
    block: str = "basic"  # basic | bottleneck | preact | preact_bottleneck
    layers: tuple[int, ...] = ()
    vgg_cfg: str = ""
    vgg_bn: bool = False
    rvgg_res: bool = False
    fmaps: int = 512
    groups: int = 1
    width_per_group: int = 64
    widen: int = 1


_CRESNET = {
    "cifar_resnet20": ("basic", 3), "cifar_resnet32": ("basic", 5),
    "cifar_resnet44": ("basic", 7), "cifar_resnet56": ("basic", 9),
    "cifar_resnet110": ("basic", 18), "cifar_resnet1202": ("basic", 200),
    "cifar_resnet164": ("bottleneck", 18), "cifar_resnet1001": ("bottleneck", 111),
    "cifar_preact_resnet20": ("preact", 3), "cifar_preact_resnet110": ("preact", 18),
    "cifar_preact_resnet164": ("preact_bottleneck", 18),
    "cifar_preact_resnet1001": ("preact_bottleneck", 111),
}

_TVRESNET = {
    "cifar_resnet18": ("basic", (2, 2, 2, 2), 1, 64),
    "cifar_resnet34": ("basic", (3, 4, 6, 3), 1, 64),
    "cifar_resnet50": ("bottleneck", (3, 4, 6, 3), 1, 64),
    "cifar_resnet101": ("bottleneck", (3, 4, 23, 3), 1, 64),
    "cifar_resnet152": ("bottleneck", (3, 8, 36, 3), 1, 64),
    "cifar_resnext50_32x4d": ("bottleneck", (3, 4, 6, 3), 32, 4),
    "cifar_resnext101_32x8d": ("bottleneck", (3, 4, 23, 3), 32, 8),
    "cifar_wide_resnet50_2": ("bottleneck", (3, 4, 6, 3), 1, 128),
    "cifar_wide_resnet101_2": ("bottleneck", (3, 4, 23, 3), 1, 128),
}

_VGG = {
    "cifar_vgg11": ("A", False), "cifar_vgg11_bn": ("A", True),
    "cifar_vgg13": ("B", False), "cifar_vgg13_bn": ("B", True),
    "cifar_vgg16": ("D", False), "cifar_vgg16_bn": ("D", True),
    "cifar_vgg19": ("E", False), "cifar_vgg19_bn": ("E", True),
    "cifar_rvgg11_64_bn": ("R64", True), "cifar_rvgg11_128_bn": ("R128", True),
    "cifar_rvgg11_256_bn": ("R256", True), "cifar_rvgg11_512_bn": ("R512", True),
}

_RVGG = {
    "cifar_res_rvgg11_64_bn": "R64", "cifar_res_rvgg11_128_bn": "R128",
    "cifar_res_rvgg11_256_bn": "R256", "cifar_res_rvgg11_512_bn": "R512",
}

_WRN = {
    "cifar_wrn_16_4": (16, 4), "cifar_wrn_16_10": (16, 10),
    "cifar_wrn_28_10": (28, 10), "cifar_wrn_40_4": (40, 4),
}

CIFAR_ARCHS = list(_CRESNET) + list(_TVRESNET) + list(_VGG) + list(_RVGG) + list(_WRN)


def build_cifar_spec(arch: str, num_classes: int) -> CifarSpec:
    if arch in _CRESNET:
        block, n = _CRESNET[arch]
        return CifarSpec("cresnet", arch, num_classes, block, (n, n, n))
    if arch in _TVRESNET:
        block, layers, groups, wpg = _TVRESNET[arch]
        return CifarSpec("tvresnet", arch, num_classes, block, layers, groups=groups,
                         width_per_group=wpg)
    if arch in _VGG:
        cfg, bn = _VGG[arch]
        fmaps = VGG_CFGS[cfg][0] if cfg.startswith("R") else 512
        return CifarSpec("vgg", arch, num_classes, vgg_cfg=cfg, vgg_bn=bn, fmaps=fmaps)
    if arch in _RVGG:
        cfg = _RVGG[arch]
        return CifarSpec("rvgg", arch, num_classes, vgg_cfg=cfg, vgg_bn=True, rvgg_res=True,
                         fmaps=RVGG_CFGS[cfg][0])
    if arch in _WRN:
        depth, k = _WRN[arch]
        n = (depth - 4) // 6
        return CifarSpec("wrn", arch, num_classes, layers=(n, n, n), widen=k)
    raise ValueError(f"unknown CIFAR arch {arch!r}")


# --------------------------------------------------------------------------
# init (host numpy, tpuseg's draws in its order and HWIO layout)
# --------------------------------------------------------------------------


class _Init:
    def __init__(self, rng: np.random.Generator, params: dict, state: dict):
        self.rng, self.params, self.state = rng, params, state

    def conv(self, name, cin, cout, k, bias=False, init="he_out"):
        n = k * k * cout
        if init == "he_out":
            w = self.rng.normal(0, math.sqrt(2.0 / n), size=(k, k, cin, cout))
        else:  # xavier-ish for wrn
            fan = k * k * (cin + cout) / 2
            w = self.rng.normal(0, math.sqrt(2.0 / fan), size=(k, k, cin, cout))
        self.params[f"{name}.weight"] = w.astype(np.float32)
        if bias:
            self.params[f"{name}.bias"] = np.zeros((cout,), np.float32)

    def bn(self, name, c):
        self.params[f"{name}.weight"] = np.ones((c,), np.float32)
        self.params[f"{name}.bias"] = np.zeros((c,), np.float32)
        self.state[f"{name}.running_mean"] = np.zeros((c,), np.float32)
        self.state[f"{name}.running_var"] = np.ones((c,), np.float32)

    def linear(self, name, cin, cout):
        self.params[f"{name}.weight"] = self.rng.normal(
            0, 0.01, size=(cout, cin)).astype(np.float32)
        self.params[f"{name}.bias"] = np.zeros((cout,), np.float32)


# --------------------------------------------------------------------------
# forward helpers (NCHW tensors inside)
# --------------------------------------------------------------------------


def linear(x, params, name, compute_dtype=None):
    """``x @ w.T + b`` with the (out, in) weight, operands cast to the
    compute dtype first and the bias added in x's dtype (``tpuseg``'s
    order)."""
    w, b = params[f"{name}.weight"], params[f"{name}.bias"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    return x @ w.T + b.to(x.dtype)


def _bn(x, params, state, name, upd, momentum=BN_MOMENTUM):
    """BatchNorm of an NCHW map or an (N, C) feature vector; ``upd`` (a
    dict) selects train mode and receives the running-stat updates."""
    if x.dim() == 2:
        return batch_norm(x[:, :, None, None], params, state, name, updates=upd,
                          momentum=momentum)[:, :, 0, 0]
    return batch_norm(x, params, state, name, updates=upd, momentum=momentum)


def _pconv(plans, params, cname, x, stride, dilation, padding, cd, groups=1):
    """Plan-aware conv (``tpuseg``'s ``_pconv``): a conv named in ``plans``
    (an int8 ``QuantConv`` from ``build_cls_quant_plans``) runs through its
    plan at a stride-1, ungrouped call site (a plan bakes stride 1), its f32
    output cast to the compute dtype; every other conv is the dense conv."""
    plan = (plans or {}).get(cname)
    if plan is not None and stride == 1 and groups == 1:
        out_dtype = x.dtype if cd is None else cd
        y = plan.apply(nchw_to_nhwc(x).contiguous())
        return nhwc_to_nchw(y.to(out_dtype))
    return conv2d(x, params[f"{cname}.weight"], stride, dilation, padding, cd, groups=groups)


def _add_bias(x, params, name):
    return x + params[f"{name}.bias"].to(x.dtype).view(1, -1, 1, 1)


def _group(upd, train, remat, fn, params, state, x):
    """Run one stage group ``fn(params, state, x, gupd) -> x`` with its own
    update dict (train) or None (eval), under ``torch.utils.checkpoint``
    when ``remat``, and merge its BN updates into ``upd``.  Functional, so
    the checkpoint's recompute returns its updates instead of writing them
    twice (``tpuseg``'s ``_group``)."""

    def run(x, params, state):
        gupd: State | None = {} if train else None
        x = fn(params, state, x, gupd)
        return x, gupd or {}

    if remat:
        from torch.utils.checkpoint import checkpoint

        x, gupd = checkpoint(run, x, params, state, use_reentrant=False)
    else:
        x, gupd = run(x, params, state)
    if upd is not None:
        upd.update(gupd)
    return x


# --------------------------------------------------------------------------
# family: cresnet (scratch CIFAR resnets)
# --------------------------------------------------------------------------


def _init_cresnet(spec: CifarSpec, I: _Init):
    exp = 4 if "bottleneck" in spec.block else 1
    preact = spec.block.startswith("preact")
    I.conv("conv1", 3, 16, 3)
    if not preact:
        I.bn("bn1", 16)
    inp = 16
    for g, planes in enumerate([16, 32, 64], start=1):
        stride = 1 if g == 1 else 2
        for b in range(spec.layers[g - 1]):
            name = f"layer{g}.{b}"
            s = stride if b == 0 else 1
            if b == 0 and (s != 1 or inp != planes * exp):
                I.conv(f"{name}.downsample.0", inp, planes * exp, 1)
                I.bn(f"{name}.downsample.1", planes * exp)
            if "bottleneck" in spec.block:
                if preact:
                    I.bn(f"{name}.bn1", inp)
                    I.conv(f"{name}.conv1", inp, planes, 1)
                    I.bn(f"{name}.bn2", planes)
                    I.conv(f"{name}.conv2", planes, planes, 3)
                    I.bn(f"{name}.bn3", planes)
                    I.conv(f"{name}.conv3", planes, planes * 4, 1)
                else:
                    I.conv(f"{name}.conv1", inp, planes, 1)
                    I.bn(f"{name}.bn1", planes)
                    I.conv(f"{name}.conv2", planes, planes, 3)
                    I.bn(f"{name}.bn2", planes)
                    I.conv(f"{name}.conv3", planes, planes * 4, 1)
                    I.bn(f"{name}.bn3", planes * 4)
            else:
                if preact:
                    I.bn(f"{name}.bn1", inp)
                    I.conv(f"{name}.conv1", inp, planes, 3)
                    I.bn(f"{name}.bn2", planes)
                    I.conv(f"{name}.conv2", planes, planes, 3)
                else:
                    I.conv(f"{name}.conv1", inp, planes, 3)
                    I.bn(f"{name}.bn1", planes)
                    I.conv(f"{name}.conv2", planes, planes, 3)
                    I.bn(f"{name}.bn2", planes)
            inp = planes * exp
    if preact:
        I.bn("bn", 64 * exp)
    I.linear("fc", 64 * exp, spec.num_classes)


def _fwd_cresnet(params, state, x, spec, train, cd, upd, plans=None, remat=False):
    preact = spec.block.startswith("preact")
    bottleneck = "bottleneck" in spec.block
    x = _pconv(plans, params, "conv1", x, 1, 1, 1, cd)
    if not preact:
        x = F.relu(_bn(x, params, state, "bn1", upd))

    def group_fn(params, state, x, gupd, g, stride):
        for b in range(spec.layers[g - 1]):
            name = f"layer{g}.{b}"
            s = stride if b == 0 else 1
            has_ds = f"{name}.downsample.0.weight" in params
            if preact:
                out = F.relu(_bn(x, params, state, f"{name}.bn1", gupd))
                residual = x
                if has_ds:
                    residual = _pconv(plans, params, f"{name}.downsample.0", out, s, 1, 0, cd)
                    residual = _bn(residual, params, state, f"{name}.downsample.1", gupd)
                if bottleneck:
                    # the 1x1 conv1 is stride 1; the 3x3 conv2 carries the stride
                    out = _pconv(plans, params, f"{name}.conv1", out, 1, 1, 0, cd)
                    out = F.relu(_bn(out, params, state, f"{name}.bn2", gupd))
                    out = _pconv(plans, params, f"{name}.conv2", out, s, 1, 1, cd)
                    out = F.relu(_bn(out, params, state, f"{name}.bn3", gupd))
                    out = _pconv(plans, params, f"{name}.conv3", out, 1, 1, 0, cd)
                else:
                    out = _pconv(plans, params, f"{name}.conv1", out, s, 1, 1, cd)
                    out = F.relu(_bn(out, params, state, f"{name}.bn2", gupd))
                    out = _pconv(plans, params, f"{name}.conv2", out, 1, 1, 1, cd)
                x = out + residual
            else:
                residual = x
                if bottleneck:
                    out = _pconv(plans, params, f"{name}.conv1", x, 1, 1, 0, cd)
                    out = F.relu(_bn(out, params, state, f"{name}.bn1", gupd))
                    out = _pconv(plans, params, f"{name}.conv2", out, s, 1, 1, cd)
                    out = F.relu(_bn(out, params, state, f"{name}.bn2", gupd))
                    out = _pconv(plans, params, f"{name}.conv3", out, 1, 1, 0, cd)
                    out = _bn(out, params, state, f"{name}.bn3", gupd)
                else:
                    out = _pconv(plans, params, f"{name}.conv1", x, s, 1, 1, cd)
                    out = F.relu(_bn(out, params, state, f"{name}.bn1", gupd))
                    out = _pconv(plans, params, f"{name}.conv2", out, 1, 1, 1, cd)
                    out = _bn(out, params, state, f"{name}.bn2", gupd)
                if has_ds:
                    residual = _pconv(plans, params, f"{name}.downsample.0", x, s, 1, 0, cd)
                    residual = _bn(residual, params, state, f"{name}.downsample.1", gupd)
                x = F.relu(out + residual)
        return x

    for g in (1, 2, 3):
        x = _group(upd, train, remat, partial(group_fn, g=g, stride=1 if g == 1 else 2),
                   params, state, x)
    if preact:
        x = F.relu(_bn(x, params, state, "bn", upd))
    # AvgPool2d(8) then flatten: CIFAR's 32x32 input ends at 8x8, a global mean
    return linear(x.mean(dim=(2, 3)), params, "fc", cd)


# --------------------------------------------------------------------------
# family: tvresnet (torchvision-style with CIFAR stem)
# --------------------------------------------------------------------------


def _init_tvresnet(spec: CifarSpec, I: _Init):
    exp = 4 if spec.block == "bottleneck" else 1
    I.conv("conv1", 3, 64, 3)
    I.bn("bn1", 64)
    inp = 64
    for g, planes in enumerate([64, 128, 256, 512], start=1):
        stride = 1 if g == 1 else 2
        width = int(planes * (spec.width_per_group / 64.0)) * spec.groups
        for b in range(spec.layers[g - 1]):
            name = f"layer{g}.{b}"
            s = stride if b == 0 else 1
            if b == 0 and (s != 1 or inp != planes * exp):
                I.conv(f"{name}.downsample.0", inp, planes * exp, 1)
                I.bn(f"{name}.downsample.1", planes * exp)
            if spec.block == "bottleneck":
                I.conv(f"{name}.conv1", inp, width, 1)
                I.bn(f"{name}.bn1", width)
                I.conv(f"{name}.conv2", width // spec.groups, width, 3)
                I.bn(f"{name}.bn2", width)
                I.conv(f"{name}.conv3", width, planes * 4, 1)
                I.bn(f"{name}.bn3", planes * 4)
            else:
                I.conv(f"{name}.conv1", inp, planes, 3)
                I.bn(f"{name}.bn1", planes)
                I.conv(f"{name}.conv2", planes, planes, 3)
                I.bn(f"{name}.bn2", planes)
            inp = planes * exp
    I.linear("fc", 512 * exp, spec.num_classes)


def _fwd_tvresnet(params, state, x, spec, train, cd, upd, plans=None, remat=False):
    x = _pconv(plans, params, "conv1", x, 1, 1, 1, cd)
    x = F.relu(_bn(x, params, state, "bn1", upd))

    def group_fn(params, state, x, gupd, g, stride):
        for b in range(spec.layers[g - 1]):
            name = f"layer{g}.{b}"
            s = stride if b == 0 else 1
            residual = x
            if spec.block == "bottleneck":
                out = _pconv(plans, params, f"{name}.conv1", x, 1, 1, 0, cd)
                out = F.relu(_bn(out, params, state, f"{name}.bn1", gupd))
                out = _pconv(plans, params, f"{name}.conv2", out, s, 1, 1, cd,
                             groups=spec.groups)
                out = F.relu(_bn(out, params, state, f"{name}.bn2", gupd))
                out = _pconv(plans, params, f"{name}.conv3", out, 1, 1, 0, cd)
                out = _bn(out, params, state, f"{name}.bn3", gupd)
            else:
                out = _pconv(plans, params, f"{name}.conv1", x, s, 1, 1, cd)
                out = F.relu(_bn(out, params, state, f"{name}.bn1", gupd))
                out = _pconv(plans, params, f"{name}.conv2", out, 1, 1, 1, cd)
                out = _bn(out, params, state, f"{name}.bn2", gupd)
            if f"{name}.downsample.0.weight" in params:
                residual = _pconv(plans, params, f"{name}.downsample.0", x, s, 1, 0, cd)
                residual = _bn(residual, params, state, f"{name}.downsample.1", gupd)
            x = F.relu(out + residual)
        return x

    for g in (1, 2, 3, 4):
        x = _group(upd, train, remat, partial(group_fn, g=g, stride=1 if g == 1 else 2),
                   params, state, x)
    return linear(x.mean(dim=(2, 3)), params, "fc", cd)


# --------------------------------------------------------------------------
# family: vgg / rvgg
# --------------------------------------------------------------------------


def _vgg_layout(spec: CifarSpec):
    """Sequential-index layout of the features stack (index parity with the
    torch Sequential built by make_layers): (kind, seq_index, cin, cout)."""
    cfg = (RVGG_CFGS if spec.family == "rvgg" else VGG_CFGS)[spec.vgg_cfg]
    items = []
    idx = 0
    cin = 3
    first = True
    for v in cfg:
        if v == "M":
            items.append(("pool", idx, 0, 0))
            idx += 1
            continue
        if spec.family == "rvgg" and not first:
            # residual-VGG wraps later convs in BasicBlock submodules
            items.append(("rblock", idx, cin, v))
            idx += 1
        else:
            items.append(("conv", idx, cin, v))
            idx += 1
            if spec.vgg_bn:
                items.append(("bn", idx, v, v))
                idx += 1
            items.append(("relu", idx, 0, 0))
            idx += 1
        cin = v
        first = False
    return items


def _init_vgg(spec: CifarSpec, I: _Init):
    for kind, idx, cin, cout in _vgg_layout(spec):
        if kind == "conv":
            I.conv(f"features.{idx}", cin, cout, 3, bias=True)
        elif kind == "bn":
            I.bn(f"features.{idx}", cout)
        elif kind == "rblock":
            I.conv(f"features.{idx}.conv1", cin, cout, 3, bias=True)
            I.bn(f"features.{idx}.bn1", cout)
    f = spec.fmaps
    if spec.family == "rvgg":
        I.linear("classifier.0", f, f)
        I.linear("classifier.3", f, f)
        I.linear("classifier.6", f, spec.num_classes)
    else:
        I.linear("classifier.0", f, f)
        I.bn("classifier.1", f)
        I.linear("classifier.3", f, spec.num_classes)


def _fwd_vgg(params, state, x, spec, train, cd, upd, plans=None, remat=False):
    # remat groups: the segments between maxpools (each pool halves the
    # live activation)
    segments: list[list] = [[]]
    for item in _vgg_layout(spec):
        segments[-1].append(item)
        if item[0] == "pool":
            segments.append([])

    def seg_fn(params, state, x, gupd, items):
        for kind, idx, cin, cout in items:
            name = f"features.{idx}"
            if kind == "conv":
                x = _add_bias(_pconv(plans, params, name, x, 1, 1, 1, cd), params, name)
            elif kind == "bn":
                x = _bn(x, params, state, name, gupd)
            elif kind == "relu":
                x = F.relu(x)
            elif kind == "pool":
                x = F.max_pool2d(x, 2, 2)
            elif kind == "rblock":
                identity = x
                out = _pconv(plans, params, f"{name}.conv1", x, 1, 1, 1, cd)
                out = _add_bias(out, params, f"{name}.conv1")
                out = _bn(out, params, state, f"{name}.bn1", gupd)
                if spec.rvgg_res and cin == cout:
                    out = out + identity
                x = F.relu(out)
        return x

    for items in segments:
        if items:
            x = _group(upd, train, remat, partial(seg_fn, items=items), params, state, x)
    x = x.mean(dim=(2, 3))
    if spec.family == "rvgg":
        x = F.relu(linear(x, params, "classifier.0", cd))
        x = F.relu(linear(x, params, "classifier.3", cd))
        return linear(x, params, "classifier.6", cd)
    x = linear(x, params, "classifier.0", cd)
    x = F.relu(_bn(x, params, state, "classifier.1", upd))
    return linear(x, params, "classifier.3", cd)


# --------------------------------------------------------------------------
# family: wrn
# --------------------------------------------------------------------------


def _init_wrn(spec: CifarSpec, I: _Init):
    k = spec.widen
    stages = [16, 16 * k, 32 * k, 64 * k]
    I.conv("conv1", 3, 16, 3, bias=True, init="xavier")
    inp = stages[0]
    for g in range(1, 4):
        planes = stages[g]
        stride = 1 if g == 1 else 2
        for b in range(spec.layers[g - 1]):
            name = f"layer{g}.{b}"
            s = stride if b == 0 else 1
            I.bn(f"{name}.bn1", inp)
            I.conv(f"{name}.conv1", inp, planes, 3, bias=True, init="xavier")
            I.bn(f"{name}.bn2", planes)
            I.conv(f"{name}.conv2", planes, planes, 3, bias=True, init="xavier")
            if s != 1 or inp != planes:
                I.conv(f"{name}.shortcut.0", inp, planes, 1, bias=True, init="xavier")
            inp = planes
    I.bn("bn1", stages[3])
    I.linear("linear", stages[3], spec.num_classes)


def _fwd_wrn(params, state, x, spec, train, cd, upd, plans=None, remat=False):
    x = _add_bias(conv2d(x, params["conv1.weight"], 1, 1, 1, cd), params, "conv1")

    def group_fn(params, state, x, gupd, g, stride):
        for b in range(spec.layers[g - 1]):
            name = f"layer{g}.{b}"
            s = stride if b == 0 else 1
            # wide_basic: conv1 on relu(bn1(x)) at stride 1, conv2 at stride
            # s; block BNs use the torch default momentum (0.1), only the
            # top-level bn1 0.9
            out = F.relu(_bn(x, params, state, f"{name}.bn1", gupd))
            out = _add_bias(_pconv(plans, params, f"{name}.conv1", out, 1, 1, 1, cd), params,
                            f"{name}.conv1")
            out = F.relu(_bn(out, params, state, f"{name}.bn2", gupd))
            out = _add_bias(_pconv(plans, params, f"{name}.conv2", out, s, 1, 1, cd), params,
                            f"{name}.conv2")
            if f"{name}.shortcut.0.weight" in params:
                sc = _pconv(plans, params, f"{name}.shortcut.0", x, s, 1, 0, cd)
                sc = _add_bias(sc, params, f"{name}.shortcut.0")
            else:
                sc = x
            x = out + sc
        return x

    for g in (1, 2, 3):
        x = _group(upd, train, remat, partial(group_fn, g=g, stride=1 if g == 1 else 2),
                   params, state, x)
    x = F.relu(_bn(x, params, state, "bn1", upd, momentum=0.9))
    return linear(x.mean(dim=(2, 3)), params, "linear", cd)


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

_INIT = {"cresnet": _init_cresnet, "tvresnet": _init_tvresnet, "vgg": _init_vgg,
         "rvgg": _init_vgg, "wrn": _init_wrn}
_FWD = {"cresnet": _fwd_cresnet, "tvresnet": _fwd_tvresnet, "vgg": _fwd_vgg,
        "rvgg": _fwd_vgg, "wrn": _fwd_wrn}


def init_cifar(key, spec: CifarSpec) -> tuple[Params, State]:
    """Weights from an int seed or a key's data (``models.drn.jax_key``):
    ``tpuseg``'s draws, as the port's CPU tensors (conv weights OIHW)."""
    params: dict = {}
    state: dict = {}
    _INIT[spec.family](spec, _Init(rng_from_key(key), params, state))
    return from_jax_params(params, state)


def cifar_forward(
    params: Params,
    state: State,
    x: torch.Tensor,
    spec: CifarSpec,
    *,
    train: bool = False,
    compute_dtype: torch.dtype | None = None,
    plans: dict | None = None,
    remat: bool = False,
) -> tuple[torch.Tensor, State]:
    """NHWC ``x`` -> ``(logits, bn_updates)``; ``bn_updates`` is empty in
    eval and holds every BN's new running statistics with ``train=True``.

    ``plans`` routes named convs through their int8 plans
    (``tpuseg_torch.ops.quant.build_cls_quant_plans``) at stride-1,
    ungrouped call sites.  ``remat=True`` recomputes each stage group
    (resnet layer1/2/3[/4], a VGG pool-to-pool segment) in the backward
    pass (``torch.utils.checkpoint``, not reentrant)."""
    upd: State | None = {} if train else None
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    logits = _FWD[spec.family](params, state, nhwc_to_nchw(x), spec, train, compute_dtype,
                               upd, plans, remat)
    return logits, upd or {}


def create_cifar_model(key, arch: str, num_classes: int):
    spec = build_cifar_spec(arch, num_classes)
    params, state = init_cifar(key, spec)
    return params, state, spec
