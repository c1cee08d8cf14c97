"""Plain PyTorch reference of DRN-D DRNSeg (Yu, Koltun, Funkhouser,
"Dilated Residual Networks", CVPR 2017; fyu/drn's ``drn.py`` and
``segment.py``): the architecture table, the BN fold, the block_regular
masks, int8/int4 post-training quantization, fp8 and int8 casts, the serving forward
(logits x8-upsampled by the fixed bilinear transposed conv) and the training
loss.

Float32, NCHW, ``torch.nn.functional`` only: no kernel, cache or batching of
the program under test, and nothing imported from it.  Run it with TF32 off
(``exact_float32``): on the card a float32 conv may otherwise run in TF32.

Names follow fyu/drn's DRNSeg state dict with the ``base`` Sequential
written ``layer.<i>``: ``layer.0.0`` (7x7 conv) and ``layer.0.1`` (its BN),
``layer.<i>.<3j>`` / ``<3j+1>`` in the conv stages 1, 2, 7, 8,
``layer.<i>.<b>.conv1`` / ``bn1`` / ... / ``downsample.0`` / ``downsample.1``
in the residual stages 3-6, ``seg`` the 1x1 head and ``up`` the frozen
depthwise ``ConvTranspose2d(C, C, 16, stride=8, padding=4, groups=C)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # nn.BatchNorm2d's default, which fyu/drn keeps
IGNORE = 255
UP_KERNEL, UP_STRIDE, UP_PAD = 16, 8, 4


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str
    bn: str
    cin: int
    cout: int
    k: int
    stride: int
    dilation: int
    stage: int
    role: str  # "conv" (conv stages), "block" (residual branch), "downsample"

    @property
    def padding(self) -> int:
        return self.dilation * (self.k - 1) // 2


@dataclasses.dataclass(frozen=True)
class Block:
    convs: tuple
    downsample: Conv | None


def architecture(cfg: dict) -> list[tuple[str, int, list]]:
    """The DRN-D backbone as stages ``(kind, index, items)``: ``kind``
    "convs" with a list of ``Conv`` (conv, BN, ReLU each) or "blocks" with a
    list of ``Block`` (fyu/drn ``DRN._make_layer`` and ``_make_conv_layers``
    for ``arch='D'``)."""
    ch, layers, kind = cfg["channels"], cfg["layers"], cfg["block"]
    if kind not in ("basic", "bottleneck"):
        raise ValueError(f"block kind {kind!r}")
    expansion = 4 if kind == "bottleneck" else 1
    stages = []
    inp = 3

    def convs_stage(i, c, n, stride, dil, k=3):
        nonlocal inp
        items = []
        for j in range(n):
            items.append(Conv(f"layer.{i}.{3 * j}", f"layer.{i}.{3 * j + 1}", inp, c, k,
                              stride if j == 0 else 1, dil, i, "conv"))
            inp = c
        stages.append(("convs", i, items))

    def blocks_stage(i, planes, n, stride, dil, new_level):
        nonlocal inp
        first = (1, 1) if dil == 1 else ((dil // 2 if new_level else dil), dil)
        items = []
        for b in range(n):
            d = first if b == 0 else (dil, dil)
            s = stride if b == 0 else 1
            p = f"layer.{i}.{b}"
            down = None
            if b == 0 and (stride != 1 or inp != planes * expansion):
                down = Conv(f"{p}.downsample.0", f"{p}.downsample.1", inp, planes * expansion,
                            1, stride, 1, i, "downsample")
            if kind == "basic":
                convs = (Conv(f"{p}.conv1", f"{p}.bn1", inp, planes, 3, s, d[0], i, "block"),
                         Conv(f"{p}.conv2", f"{p}.bn2", planes, planes, 3, 1, d[1], i, "block"))
            else:
                convs = (Conv(f"{p}.conv1", f"{p}.bn1", inp, planes, 1, 1, 1, i, "block"),
                         Conv(f"{p}.conv2", f"{p}.bn2", planes, planes, 3, s, d[1], i, "block"),
                         Conv(f"{p}.conv3", f"{p}.bn3", planes, planes * 4, 1, 1, 1, i, "block"))
            items.append(Block(convs, down))
            inp = planes * expansion
        stages.append(("blocks", i, items))

    convs_stage(0, ch[0], 1, 1, 1, k=7)
    convs_stage(1, ch[0], layers[0], 1, 1)
    convs_stage(2, ch[1], layers[1], 2, 1)
    blocks_stage(3, ch[2], layers[2], 2, 1, True)
    blocks_stage(4, ch[3], layers[3], 2, 1, True)
    blocks_stage(5, ch[4], layers[4], 1, 2, False)
    if layers[5]:
        blocks_stage(6, ch[5], layers[5], 1, 4, False)
    if layers[6]:
        convs_stage(7, ch[6], layers[6], 1, 2)
    if layers[7]:
        convs_stage(8, ch[7], layers[7], 1, 1)
    return stages


def all_convs(cfg: dict) -> list[Conv]:
    """Every backbone conv in forward order (a block's downsample last)."""
    out = []
    for kind, _i, items in architecture(cfg):
        if kind == "convs":
            out.extend(items)
        else:
            for blk in items:
                out.extend(blk.convs)
                if blk.downsample is not None:
                    out.append(blk.downsample)
    return out


def feature_channels(cfg: dict) -> int:
    """Channels of the backbone's output (the head's input)."""
    kind, _i, items = architecture(cfg)[-1]
    return items[-1].cout if kind == "convs" else items[-1].convs[-1].cout


def bilinear_kernel(k: int = UP_KERNEL) -> np.ndarray:
    """fyu/drn ``fill_up_weights``: the (k, k) bilinear kernel."""
    f = math.ceil(k / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    i = np.arange(k)
    w1 = 1 - np.abs(i / f - c)
    return np.outer(w1, w1).astype(np.float32)


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and cuDNN convs inside the block."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


# --------------------------------------------------------------------------
# masks, BN fold, quantization
# --------------------------------------------------------------------------


def block_regular_masks(prune: dict, shapes: dict) -> dict[str, np.ndarray]:
    """The masks of a ``block_regular`` pruner config as its static
    construction draws them: one ``default_rng(seed)`` over the layers in
    the config's order; per 128-channel out-block, ``k = max(1,
    round((1 - sparsity) * in-blocks))`` distinct in-blocks kept, drawn by
    ``rng.choice(in_blocks, k, replace=False)``; the mask is uniform over
    the taps.  ``shapes`` maps a weight name to its OIHW shape.  Returns
    float32 OIHW 0/1 arrays."""
    masker = prune["masker"]
    if masker["pruner_type"] != "block_regular" or not prune.get("is_static", True):
        raise ValueError("the reference draws static block_regular masks only")
    rng = np.random.default_rng(prune["seed"])
    masks = {}
    for group in masker["configs"]:
        sparsity = group["sparsity"]
        bh0, bw0 = group.get("block_height", 128), group.get("block_width", 128)
        for layer in group["layer_set"]:
            shape = shapes[layer]
            o, i = shape[0], shape[1]
            bh, bw = min(bh0, o), min(bw0, i)
            nob, nib = -(-o // bh), -(-i // bw)
            k = max(1, int(round((1.0 - sparsity) * nib)))
            meta = np.zeros((nob, nib), np.float32)
            for ob in range(nob):
                meta[ob, rng.choice(nib, size=k, replace=False)] = 1.0
            full = np.kron(meta, np.ones((bh, bw), np.float32))[:o, :i]
            masks[layer] = np.array(np.broadcast_to(full.reshape(o, i, 1, 1), shape),
                                    np.float32)
    return masks


def fold(params: dict, state: dict, cfg: dict, masks: dict | None = None) -> dict:
    """``{conv name: (w, b)}`` in float32: each conv's weight (masked first,
    as served) scaled by its BN's ``gamma / sqrt(var + eps)`` and the bias
    ``beta - mean * gamma / sqrt(var + eps)``; the head's own weight and
    bias under ``seg``."""
    out = {}
    for c in all_convs(cfg):
        w = params[f"{c.name}.weight"].float()
        if masks and f"{c.name}.weight" in masks:
            w = w * torch.as_tensor(masks[f"{c.name}.weight"], device=w.device)
        g = params[f"{c.bn}.weight"].float() / torch.sqrt(
            state[f"{c.bn}.running_var"].float() + BN_EPS)
        out[c.name] = (w * g.view(-1, 1, 1, 1),
                       params[f"{c.bn}.bias"].float() - state[f"{c.bn}.running_mean"].float() * g)
    out["seg"] = (params["seg.weight"].float(), params["seg.bias"].float())
    return out


def int8_convs(cfg: dict) -> list[str]:
    """The convs served in int8 (``quantize.stages``, stride 1, >= ``quantize
    .min_channels`` in and out, downsamples not considered)."""
    q = cfg.get("quantize")
    if not q:
        return []
    return [c.name for c in all_convs(cfg)
            if c.stage in q["stages"] and c.stride == 1 and c.role != "downsample"
            and c.cin >= q["min_channels"] and c.cout >= q["min_channels"]]


def quantize_weight(w: torch.Tensor, qmax: int) -> torch.Tensor:
    """Symmetric per-output-channel quantization, dequantized: ``round(w /
    s) * s`` with ``s = max(absmax, 1e-8) / qmax``, clipped to +-qmax."""
    s = w.abs().amax(dim=(1, 2, 3)).clamp(min=1e-8) / qmax
    return torch.clamp(torch.round(w / s.view(-1, 1, 1, 1)), -qmax, qmax) * s.view(-1, 1, 1, 1)


def quantize_act(x: torch.Tensor, scale: float, qmax: int) -> torch.Tensor:
    """``clip(rint(x / scale), -qmax, qmax) * scale`` (a static scale)."""
    return torch.clamp(torch.round(x / scale), -qmax, qmax) * scale


def lowp(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """``x`` through a lower precision, back in float32: ``"bf16"``
    (rounded to bfloat16), or with an absmax scale per leading index (an
    output channel of an OIHW weight, a frame of an NCHW activation or
    gradient) ``"e4m3"`` or ``"e5m2"`` (float8, largest 448 / 57344) or
    ``"int8"`` (round half to even, +-127)."""
    if fmt == "bf16":
        return x.to(torch.bfloat16).float()
    top = 127.0 if fmt == "int8" else torch.finfo(FLOAT8[fmt]).max
    s = x.abs().amax(dim=tuple(range(1, x.dim())), keepdim=True).clamp(min=1e-30) / top
    if fmt == "int8":
        return torch.round(x / s) * s
    return (x / s).to(FLOAT8[fmt]).float() * s


FLOAT8 = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
# a cast mode's formats: (weights and activations, gradients)
CASTS = {"fp8": ("e4m3", "e5m2"), "int8": ("int8", "int8"), "bf16": ("bf16", "bf16")}


class _GradCast(torch.autograd.Function):
    """Identity forward; the gradient through ``fmt`` on its way back."""

    @staticmethod
    def forward(ctx, x, fmt):
        ctx.fmt = fmt
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return lowp(g, ctx.fmt), None


class Precision:
    """How each conv computes.  ``"float32"``: as is.  A cast mode
    (``CASTS``: ``"fp8"``, ``"int8"``, ``"bf16"``): every conv's weights and activations
    (the head's too) through ``lowp``.  ``"int"`` (``qmax`` 127 for int8, 7
    for int4): the convs in ``names`` take per-channel quantized weights and
    activations quantized at the static ``scales[name]``; ``scales`` None
    records each such conv's input absmax into ``absmax`` (calibration: the
    weights quantized, x as is).

    ``train=True`` (cast modes) is training in that precision: weights and
    activations cast afresh at every call, gradients passed straight through
    the casts, and each conv's output gradient cast to the mode's gradient
    format before its dgrad and wgrad; otherwise each conv's cast weight is
    made once."""

    def __init__(self, mode: str = "float32", names=(), qmax: int = 127, scales=None,
                 train: bool = False):
        self.mode, self.names, self.qmax = mode, set(names), qmax
        self.scales, self.train = scales, train
        self.fmt = CASTS.get(mode)
        self.absmax: dict[str, float] = {}
        self._wq: dict = {}

    def weight(self, name, w):
        if self.fmt and self.train:
            return w + (lowp(w.detach(), self.fmt[0]) - w).detach()
        if self.fmt or name in self.names:
            if name not in self._wq:
                self._wq[name] = (lowp(w, self.fmt[0]) if self.fmt
                                  else quantize_weight(w, self.qmax))
            return self._wq[name]
        return w

    def act(self, name, x):
        if self.fmt:
            q = lowp(x.detach(), self.fmt[0])
            return x + (q - x).detach() if self.train else q
        if name not in self.names:
            return x
        if self.scales is None:
            self.absmax[name] = max(self.absmax.get(name, 0.0), float(x.abs().amax()))
            return x
        return quantize_act(x, self.scales[name], self.qmax)

    def out(self, y):
        """A conv's output: in training, its gradient cast on the way back."""
        return _GradCast.apply(y, self.fmt[1]) if self.fmt and self.train else y


def _conv(folded, prec, c: Conv, x, train_bn=None):
    w, b = folded[c.name]
    y = F.conv2d(prec.act(c.name, x), prec.weight(c.name, w), None, c.stride, c.padding,
                 c.dilation)
    y = prec.out(y)
    if train_bn is not None:
        return train_bn(c, y)
    return y + b.view(1, -1, 1, 1)


def backbone(folded: dict, cfg: dict, x: torch.Tensor, prec: Precision,
             train_bn=None) -> torch.Tensor:
    """NCHW float32 input -> stride-8 features.  ``train_bn(conv, y)``
    replaces the folded bias by a training-mode BatchNorm of ``y``."""
    for kind, _i, items in architecture(cfg):
        if kind == "convs":
            for c in items:
                x = F.relu(_conv(folded, prec, c, x, train_bn))
            continue
        for blk in items:
            res = x
            out = x
            for j, c in enumerate(blk.convs):
                out = _conv(folded, prec, c, out, train_bn)
                if j < len(blk.convs) - 1:
                    out = F.relu(out)
            if blk.downsample is not None:
                res = _conv(folded, prec, blk.downsample, x, train_bn)
            x = F.relu(out + res)
    return x


def head(folded: dict, feats: torch.Tensor, prec: Precision) -> torch.Tensor:
    w, b = folded["seg"]
    return prec.out(F.conv2d(prec.act("seg", feats), prec.weight("seg", w), b))


def upsample(logits: torch.Tensor) -> torch.Tensor:
    """The fixed x8 bilinear transposed conv, depthwise, in float32."""
    c = logits.shape[1]
    k = torch.from_numpy(bilinear_kernel()).to(logits.device)
    w = k.view(1, 1, UP_KERNEL, UP_KERNEL).expand(c, 1, -1, -1).contiguous()
    return F.conv_transpose2d(logits, w, stride=UP_STRIDE, padding=UP_PAD, groups=c)


def normalize(frames_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> NCHW float32 ``(x / 255 - mean) / std``."""
    x = frames_u8.permute(0, 3, 1, 2).float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device).view(1, 3, 1, 1)
    s = torch.tensor(std, dtype=torch.float32, device=x.device).view(1, 3, 1, 1)
    return (x - m) / s


def serve_logits(folded: dict, cfg: dict, frames_u8: torch.Tensor, prec: Precision):
    """(N, H, W, 3) uint8 frames -> (N, C, H, W) float32 upsampled logits
    (the map whose argmax over C the served ids are)."""
    x = normalize(frames_u8, cfg["mean"], cfg["std"])
    feats = backbone(folded, cfg, x, prec)
    logits = upsample(head(folded, feats, prec))
    return logits[:, :, : frames_u8.shape[1], : frames_u8.shape[2]]


def calibrate(folded: dict, cfg: dict, frames_u8: torch.Tensor, qmax: int) -> dict:
    """Static activation scales of the quantized convs: the float forward
    over the calibration frames with those convs' weights quantized, each
    conv's input absmax over all of them, divided by ``qmax``."""
    prec = Precision("int", int8_convs(cfg), qmax, scales=None)
    for i in range(frames_u8.shape[0]):
        backbone(folded, cfg, normalize(frames_u8[i:i + 1], cfg["mean"], cfg["std"]), prec)
    return {n: v / qmax for n, v in prec.absmax.items() if v > 0}


def gap_of(logits: torch.Tensor, ids: torch.Tensor) -> tuple[float, float]:
    """(widest gap by which a served id's reference logit lies below the
    reference's best at its pixel, the logits' scale): ``logits`` (N, C, H,
    W), ``ids`` (N, H, W).  The scale is the RMS over pixels and classes of
    the logits less their per-pixel mean over classes."""
    best = logits.amax(dim=1)
    got = logits.gather(1, ids.long().unsqueeze(1)).squeeze(1)
    centred = logits - logits.mean(dim=1, keepdim=True)
    return float((best - got).amax()), float(centred.pow(2).mean().sqrt())


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


def train_loss(params: dict, cfg: dict, images: torch.Tensor, labels: torch.Tensor,
               prec: Precision, batch_var: dict | None = None) -> torch.Tensor:
    """fyu/drn's training loss: the backbone with training-mode BatchNorm
    (batch statistics, biased variance), the 1x1 head, the frozen x8
    upsampler, log-softmax and the mean NLL over pixels whose label is not
    255.  ``images`` NHWC float32 (normalized), ``labels`` (N, H, W).  Each
    BatchNorm's unbiased batch variance (what its running variance takes in)
    goes into ``batch_var`` when given."""
    def bn(c, y):
        mean = y.mean(dim=(0, 2, 3))
        var = y.var(dim=(0, 2, 3), unbiased=False)
        if batch_var is not None:
            n = y.numel() // y.shape[1]
            batch_var[c.bn] = var.detach() * (n / max(n - 1, 1))
        g = params[f"{c.bn}.weight"] / torch.sqrt(var + BN_EPS)
        return (y - mean.view(1, -1, 1, 1)) * g.view(1, -1, 1, 1) + params[
            f"{c.bn}.bias"].view(1, -1, 1, 1)

    folded = {c.name: (params[f"{c.name}.weight"], None) for c in all_convs(cfg)}
    folded["seg"] = (params["seg.weight"], params["seg.bias"])
    feats = backbone(folded, cfg, images.permute(0, 3, 1, 2), prec, train_bn=bn)
    logp = torch.log_softmax(upsample(head(folded, feats, prec)), dim=1)
    valid = labels != IGNORE
    picked = logp.gather(1, torch.where(valid, labels, 0).long().unsqueeze(1)).squeeze(1)
    return -(picked * valid).sum() / valid.sum().clamp(min=1)


def sgd_steps(params: dict, cfg: dict, batches, train: dict, prec: Precision,
              frozen=("up.weight",)):
    """torch.optim.SGD (momentum, weight decay added to the gradient before
    the momentum buffer) over ``batches`` ((images, labels) pairs).
    Returns (losses, the first step's gradients, the parameters after the
    last step, the first step's BatchNorm batch variances)."""
    lr, m, wd = train["lr"], train["momentum"], train["weight_decay"]
    p = {k: v.detach().clone().float() for k, v in params.items()}
    buf, var1 = {}, {}
    losses, first = [], None
    for images, labels in batches:
        leaves = {k: v.requires_grad_(k not in frozen) for k, v in p.items()}
        loss = train_loss(leaves, cfg, images, labels, prec, var1 if first is None else None)
        names = [k for k in leaves if k not in frozen]
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            for k, g in grads.items():
                d = g + wd * p[k]
                buf[k] = d if k not in buf else d + m * buf[k]
                p[k] = (p[k] - lr * buf[k]).detach()
        p = {k: v.detach() for k, v in p.items()}
    return losses, first, p, var1
