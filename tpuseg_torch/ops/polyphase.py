"""Polyphase (space-to-depth-folded) DRN-D frontend, in PyTorch.

Counterpart of ``tpuseg/ops/polyphase.py``.  The DRN stem (7x7 s1 3->16 at
full resolution) and the two low-channel convs after it are rewritten as
dense stride-1 convs on a space-to-depth grid (``fold_conv_poly``): the same
function, computed from exactly rearranged weights.  ``tpuseg`` did this for
the TPU's 128-lane matrix unit; the port keeps the identical formulation so
both packages compute the same thing step for step (the unfolded stem is the
same function, tested in tests/test_torch_polyphase.py).

Weights are folded in numpy on ``tpuseg``'s HWIO layout, exactly as there,
then transposed to OIHW.  Activations inside are NCHW-shaped in
``torch.channels_last`` memory; ``__call__`` takes raw frames and returns an
NHWC feature map.  BN must already be folded (``tpuseg_torch.ops.fold_bn``).

``int8_stem=True`` runs the three folded stem convs in int8 as ``tpuseg``
does (``tpuseg/ops/polyphase.py:297-360``): weights quantized per output
channel from the folded weights as cast to the compute dtype, x per conv
with conv0's analytic scale, static scales from ``calibrate_stem_scales`` or
per-frame ones, and the epilogue ``relu(float(acc) * (xs * ws) + bias)``
cast to the compute dtype.  Each conv is kernel B3 on its stem packing
(``tpuseg_torch.ops.quant.stem_packing``) through
``fused_sparse_conv_q_bias_relu``.  Stage 3 stays float, as in ``tpuseg``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.models.drn import nchw_to_nhwc, nhwc_to_nchw
from tpuseg_torch.ops.quant import quantize_weight, stem_packing
from tpuseg_torch.ops.sparse_conv import fused_sparse_conv_q_bias_relu

STEM_CONVS = ("layer.0.0", "layer.1.0", "layer.2.0")  # DRNSeg naming
STAGE3 = "layer.3"


def fold_conv_poly(
    w: np.ndarray, stride: int, pad: int, f_in: int, f_out: int
) -> tuple[np.ndarray, int, int]:
    """General polyphase fold: a (K, K, C, O) conv with ``stride`` and
    ``pad``, whose input lives on an ``f_in`` space-to-depth grid and whose
    output should live on an ``f_out`` grid, becomes a dense stride-1 conv
    with channels (f_in^2*C) -> (f_out^2*O).  Requires
    ``stride * f_out == f_in``.

    Derivation: y[f_out*i + a] = sum_p x[stride*(f_out*i + a) + p - pad] W[p]
    and the x index rewritten on the f_in grid as f_in*(i+m) + dy gives
    m = floor((stride*a + p - pad)/f_in), dy = (stride*a + p - pad) % f_in.

    Returns (w_poly (KH, KW, f_in^2*C, f_out^2*O), pad_lo, pad_hi).
    """
    K = w.shape[0]
    C, O = w.shape[2], w.shape[3]
    assert stride * f_out == f_in, (stride, f_out, f_in)
    lo = (0 - pad) // f_in
    hi = (stride * (f_out - 1) + K - 1 - pad) // f_in
    KH = hi - lo + 1
    wp = np.zeros((KH, KH, f_in * f_in * C, f_out * f_out * O), np.float32)
    for a in range(f_out):
        for b in range(f_out):
            for p in range(K):
                for q in range(K):
                    ia = stride * a + p - pad
                    ib = stride * b + q - pad
                    m, dy = ia // f_in, ia % f_in
                    n, dx = ib // f_in, ib % f_in
                    ci = (dy * f_in + dx) * C
                    co = (a * f_out + b) * O
                    wp[m - lo, n - lo, ci : ci + C, co : co + O] = w[p, q]
    return wp, -lo, hi


def _hwio(w: torch.Tensor) -> np.ndarray:
    """Port OIHW weight -> ``tpuseg``'s HWIO float32 numpy layout."""
    return w.detach().float().cpu().numpy().transpose(2, 3, 1, 0)


def _device_weight(w_hwio: np.ndarray, dtype, device) -> torch.Tensor:
    """HWIO numpy weight -> OIHW tensor on ``device``, channels_last."""
    w = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    return w.to(device=device, dtype=dtype).contiguous(
        memory_format=torch.channels_last)


def space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """Exact (n, h, w, c) -> (n, h/f, w/f, f*f*c), channel order (dy, dx, c)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // f, f, w // f, f, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // f, w // f, f * f * c)


def space_to_depth_flat(x: torch.Tensor, f: int, c: int = 3) -> torch.Tensor:
    """``space_to_depth`` from FLAT frame rows: (n, h, w*c) -> the same
    (n, h/f, w/f, f*f*c) output.  ``tpuseg`` bitcasts (dx, c) cells to int32
    words for the TPU's lanes; a view + permute moves the same bytes
    (bit-equal, tests/test_torch_polyphase.py)."""
    n, h, wc = x.shape
    if wc % c:
        raise ValueError(f"flat row width {wc} is not a multiple of {c}")
    w = wc // c
    x = x.reshape(n, h // f, f, w // f, f * c)
    return x.permute(0, 1, 3, 2, 4).reshape(n, h // f, w // f, f * f * c)


def fold_input(x: torch.Tensor, f: int, c: int = 3) -> torch.Tensor:
    """Space-to-depth that accepts (n, h, w, c) frames or (n, h, w*c) flat
    frame rows."""
    if x.dim() == 3:
        return space_to_depth_flat(x, f, c)
    return space_to_depth(x, f)


def depth_to_space(x: torch.Tensor, f: int) -> torch.Tensor:
    """(n, h, w, f*f*o) -> (n, h*f, w*f, o), channel order (dy, dx, o)."""
    n, h, w, c = x.shape
    o = c // (f * f)
    x = x.reshape(n, h, w, f, f, o)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * f, w * f, o)


def _conv(x, w, b, pad_lo: int, pad_hi: int) -> torch.Tensor:
    """Stride-1 conv with (possibly asymmetric) zero padding on NCHW ``x``.
    ``F.conv2d`` pads symmetrically, so an asymmetric pair pads first."""
    if pad_lo == pad_hi:
        return F.conv2d(x, w, b, padding=pad_lo)
    x = F.pad(x, (pad_lo, pad_hi, pad_lo, pad_hi))
    return F.conv2d(x.contiguous(memory_format=torch.channels_last), w, b)


class PolyphaseFrontend:
    """Polyphase execution of the DRN-D frontend (layers 0..2) in the
    space-to-depth domain:

    layer0 (7x7 s1 3->16, pad 3)  : f=4 -> f=4 grid, 48 -> 256 channels
    layer1 (3x3 s1 16->16, pad 1) : f=4 -> f=4 grid, 256 -> 256 channels
    layer2 (3x3 s2 16->32, pad 1) : f=4 -> f=2 grid, 256 -> 128 channels
    then one depth-to-space(2) emits the (H/2, W/2, 32) map layer3 expects.

    ``normalize=(mean, std)`` applies ``(x/255 - mean) * (1/std)`` AFTER the
    space-to-depth (elementwise math commutes with the permutation), so the
    caller feeds raw uint8 frames — the same order of f32 operations as
    ``tpuseg`` (polyphase.py:276-281, 364-367).

    ``int8_stem=True`` adds ``q_convs`` (``tpuseg``'s (w_q, w_scale) per
    conv, HWIO int8 and (O,) f32, on the host), ``q_plans`` (per conv B3's
    packing, its quantize channel map and the f32 bias, on ``device``),
    ``conv0_x_scale`` (analytic with ``normalize``, else None: per frame)
    and ``stem_x_scales`` (None until ``calibrate_stem_scales``).
    """

    def __init__(self, params, *, device, f: int = 4, dtype=torch.bfloat16,
                 normalize: tuple | None = None, int8_stem: bool = False):
        self.f = f
        self.dtype = dtype
        self.device = torch.device(device)
        self.normalize = None
        if normalize is not None:
            mean, std = (np.asarray(v, np.float32) for v in normalize)
            self.normalize = (
                torch.from_numpy(np.tile(mean, f * f)).to(device),
                torch.from_numpy(np.tile(1.0 / std, f * f)).to(device),
            )
        specs = [  # (stride, pad, f_in, f_out)
            (1, 3, f, f),
            (1, 1, f, f),
            (2, 1, f, f // 2),
        ]
        self.convs = []
        self.int8_stem = bool(int8_stem)
        self.q_convs, self.q_plans = [], []
        self.conv0_x_scale = None
        self.stem_x_scales: list | None = None
        for name, (stride, pad, fi, fo) in zip(STEM_CONVS, specs):
            wp, plo, phi = fold_conv_poly(_hwio(params[f"{name}.weight"]), stride, pad, fi, fo)
            bias = np.tile(params[f"{name}.bias"].float().cpu().numpy(), fo * fo)
            conv = (_device_weight(wp, dtype, device),
                    torch.from_numpy(bias).to(device=device, dtype=dtype), plo, phi)
            self.convs.append(conv)
            if int8_stem:
                # tpuseg quantizes the folded weight after its cast to the
                # compute dtype (polyphase.py:294, 308-314)
                wq, ws = quantize_weight(torch.from_numpy(wp).to(dtype).float().numpy())
                self.q_convs.append((torch.from_numpy(wq), torch.from_numpy(ws)))
                plan, chan = stem_packing(name, wq, ws, plo, phi)
                self.q_plans.append((plan.to(self.device),
                                     None if chan is None else chan.to(self.device),
                                     conv[1].float()))
        self.out_f = specs[-1][3]
        if int8_stem and normalize is not None:
            # conv0's input is the normalized uint8 frame: its exact range
            # follows from (mean, std) (tpuseg polyphase.py:315-320)
            mean, std = (np.asarray(v, np.float32) for v in normalize)
            bound = np.maximum(
                np.abs((0.0 - mean) / std), np.abs((1.0 - mean) / std)
            ).max()
            self.conv0_x_scale = float(bound / 127.0)

    def _input(self, x: torch.Tensor) -> torch.Tensor:
        """Raw frames -> normalized space-to-depth NCHW (channels_last)."""
        x = fold_input(x, self.f)
        if self.normalize is not None:
            mean48, inv_std48 = self.normalize
            x = (x.float() / 255.0 - mean48) * inv_std48
        return nhwc_to_nchw(x.to(self.dtype))

    def _stem_x_scale(self, i: int) -> float | None:
        """Conv i's activation scale: analytic for conv0, else calibrated,
        else None (per frame), ``tpuseg``'s order (polyphase.py:337-348)."""
        if i == 0 and self.conv0_x_scale is not None:
            return self.conv0_x_scale
        if self.stem_x_scales is not None:
            return self.stem_x_scales[i]
        return None

    def _stem_convs(self, x: torch.Tensor) -> torch.Tensor:
        """The three folded stem convs on NCHW (channels_last) x; int8
        (B3 through ``fused_sparse_conv_q_bias_relu``) with ``int8_stem``."""
        if not self.int8_stem:
            for wp, bias, plo, phi in self.convs:
                x = F.relu_(_conv(x, wp, bias, plo, phi))
            return x
        x = nchw_to_nhwc(x)
        for i, (plan, chan, bias) in enumerate(self.q_plans):
            xs = self._stem_x_scale(i)
            if plan.x_scale != xs:
                plan = dataclasses.replace(plan, x_scale=xs)
            x = fused_sparse_conv_q_bias_relu(x, plan, bias, self.dtype, chan)
        return nhwc_to_nchw(x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = nchw_to_nhwc(self._stem_convs(self._input(x)))
        if self.out_f == 1:
            return x
        return depth_to_space(x, self.out_f)


class FusedStage3Frontend(PolyphaseFrontend):
    """PolyphaseFrontend extended through stage 3 (inference, BN-folded).

    The frontend's last conv emits the layer-2 output as an f=2 phase tensor;
    stage 3's stride-2 entry convs are phase-folded to read it directly
    (``fold_conv_poly`` with f_in=2, f_out=1):

    - b0.conv1 (3x3 s2 32->64)      -> 2x2 s1 conv, 128 -> 64
    - b0.downsample (1x1 s2 32->64) -> s1 conv on the phase grid

    The rest of stage 3 (b0.conv2 + residual, block 1) runs in image
    coordinates.  Only for a stage 3 of two basic blocks (drn_d_22/24); use
    with ``drn_forward(stem_stages=4)``.
    """

    def __init__(self, params, *, device, f: int = 4, dtype=torch.bfloat16,
                 normalize: tuple | None = None, int8_stem: bool = False):
        stage3 = STAGE3
        if f"{stage3}.2.conv1.weight" in params or f"{stage3}.1.conv3.weight" in params:
            raise ValueError(
                "FusedStage3Frontend folds a stage 3 of two basic blocks "
                "(drn_d_22/24)")
        super().__init__(params, device=device, f=f, dtype=dtype, normalize=normalize,
                         int8_stem=int8_stem)

        def fold(name, k_pad):
            wp, plo, phi = fold_conv_poly(_hwio(params[f"{name}.weight"]), 2, k_pad, 2, 1)
            bias = params[f"{name}.bias"].to(device=device, dtype=dtype)
            return _device_weight(wp, dtype, device), bias, plo, phi

        self.b0_conv1 = fold(f"{stage3}.0.conv1", 1)
        self.b0_ds = fold(f"{stage3}.0.downsample.0", 0)
        self.image_convs = {
            name: (
                params[f"{name}.weight"].to(device=device, dtype=dtype).contiguous(
                    memory_format=torch.channels_last),
                params[f"{name}.bias"].to(device=device, dtype=dtype),
            )
            for name in (f"{stage3}.0.conv2", f"{stage3}.1.conv1",
                         f"{stage3}.1.conv2")
        }
        self.stage3 = stage3

    def _image_conv(self, x, name):
        w, b = self.image_convs[name]
        return F.conv2d(x, w, b, padding=1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = self._stem_convs(self._input(x))
        # x: layer-2 output on the f=2 phase grid; stage-3 block 0 entry
        y1 = F.relu_(_conv(x, *self.b0_conv1))
        yd = _conv(x, *self.b0_ds)
        out = F.relu_(self._image_conv(y1, f"{self.stage3}.0.conv2") + yd)
        # block 1 (standard basic block, image domain)
        r = out
        out = F.relu_(self._image_conv(out, f"{self.stage3}.1.conv1"))
        out = F.relu_(self._image_conv(out, f"{self.stage3}.1.conv2") + r)
        return nchw_to_nhwc(out)


def calibrate_stem_scales(frontend: PolyphaseFrontend, batches) -> list[float]:
    """Static per-conv activation scales for an ``int8_stem`` frontend
    (``tpuseg``'s ``calibrate_stem_scales``): runs the FLOAT stem convs in
    the frontend's dtype over ``batches`` (uint8 frames in ``fold_input``
    form, tensors or numpy, moved to the frontend's device), records each
    conv's input absmax, and returns ``max(s, 1e-8) / 127.0`` per conv
    (Python floats), conv0's analytic scale kept when it has one.  Installs
    them on ``frontend.stem_x_scales``."""
    scales = [0.0] * len(frontend.convs)
    with torch.inference_mode():
        for fr in batches:
            x = frontend._input(torch.as_tensor(fr).to(frontend.device))
            for i, (wp, bias, plo, phi) in enumerate(frontend.convs):
                scales[i] = max(scales[i], float(x.float().abs().amax()))
                x = F.relu_(_conv(x, wp, bias, plo, phi))
    out = [max(s, 1e-8) / 127.0 for s in scales]
    if frontend.conv0_x_scale is not None:
        out[0] = frontend.conv0_x_scale
    frontend.stem_x_scales = out
    return out
