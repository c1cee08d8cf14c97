"""DRNSeg: DRN backbone + 1x1 seg head + frozen bilinear x8 upsampler.

Counterpart of ``tpuseg/models/drnseg.py``.  The upsampler is the
reference's depthwise ``ConvTranspose2d(classes, classes, 16, stride=8,
padding=4, groups=classes)`` with frozen bilinear weights; here it is that
transposed conv itself (``upsample8``), which ``drnseg_forward`` runs for
training and evaluation (``tpuseg`` computes it in XLA, outside any Pallas
kernel).  Serving never materializes the upsampled logits: it calls
``drnseg_logits`` and the fused upsample+argmax
(``tpuseg_torch.ops.upsample.upsample_argmax``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.models.drn import (
    DrnSpec,
    Params,
    State,
    build_drn_spec,
    conv2d,
    drn_forward,
    init_drn,
    nchw_to_nhwc,
    nhwc_to_nchw,
    rng_from_key,
)

UP_KERNEL = 16
UP_STRIDE = 8
UP_PAD = 4


def bilinear_upsample_kernel(k: int = UP_KERNEL) -> np.ndarray:
    """The fixed bilinear kernel of the reference ``fill_up_weights``
    (semantic_seg.py:115-124).  Returns (k, k) float32."""
    f = math.ceil(k / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    w = np.zeros((k, k), dtype=np.float32)
    for i in range(k):
        for j in range(k):
            w[i, j] = (1 - abs(i / f - c)) * (1 - abs(j / f - c))
    return w


def build_drnseg_spec(arch: str, classes: int) -> DrnSpec:
    """Backbone spec with DRNSeg ('layer.') naming and no classifier head."""
    return build_drn_spec(arch, num_classes=0, naming="seg")


def init_drnseg(key: int, arch: str, classes: int) -> tuple[Params, State, DrnSpec]:
    """Backbone + head weights from an int seed, byte-identical to
    ``tpuseg.models.drnseg.init_drnseg`` (the head draws from its own
    stream, seeded from the backbone's, exactly as there)."""
    spec = build_drnseg_spec(arch, classes)
    params, state = init_drn(key, spec)
    rng = rng_from_key(key)
    rng = np.random.default_rng(rng.integers(0, 2**63 - 1, 2))  # head stream
    # 1x1 seg head, He init with n = kh*kw*cout (semantic_seg.py:140-143),
    # drawn in tpuseg's HWIO order and stored OIHW
    std = math.sqrt(2.0 / classes)
    w = (std * rng.standard_normal((1, 1, spec.out_dim, classes))).astype(np.float32)
    params["seg.weight"] = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    params["seg.bias"] = torch.zeros((classes,), dtype=torch.float32)
    # frozen depthwise transposed-conv weights, stored (k, k) — identical
    # for every channel (fill_up_weights copies channel 0 everywhere)
    params["up.weight"] = torch.from_numpy(bilinear_upsample_kernel())
    return params, state, spec


def upsample8(x: torch.Tensor, up_kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise transposed conv, stride 8, kernel 16, pad 4, on NHWC ``x``:
    (N, h, w, C) -> (N, 8h, 8w, C) in ``x``'s dtype."""
    c = x.shape[-1]
    k = up_kernel.to(device=x.device, dtype=x.dtype)
    w = k.reshape(1, 1, *k.shape[-2:]).expand(c, 1, -1, -1)
    y = F.conv_transpose2d(
        nhwc_to_nchw(x), w, stride=UP_STRIDE, padding=UP_PAD, groups=c
    )
    return nchw_to_nhwc(y)


def _logits_and_updates(params, state, x, spec, *, compute_dtype, stem_fn, stem_stages,
                        sparse_plans, train, remat) -> tuple[torch.Tensor, State]:
    feats, updates = drn_forward(
        params, state, x, spec, compute_dtype=compute_dtype, stem_fn=stem_fn,
        stem_stages=stem_stages, sparse_plans=sparse_plans, train=train, remat=remat,
    )
    seg = conv2d(
        nhwc_to_nchw(feats), params["seg.weight"], compute_dtype=compute_dtype,
        bias=params["seg.bias"],
    )
    return nchw_to_nhwc(seg), updates


def drnseg_logits(
    params: Params,
    state: State,
    x: torch.Tensor,
    spec: DrnSpec,
    *,
    compute_dtype: torch.dtype | None = None,
    stem_fn=None,
    stem_stages: int = 1,
    sparse_plans: dict | None = None,
) -> torch.Tensor:
    """Backbone + seg head (inference): NHWC input -> NHWC logits at stride
    8 (``sparse_plans``: see ``drn_forward``)."""
    return _logits_and_updates(
        params, state, x, spec, compute_dtype=compute_dtype, stem_fn=stem_fn,
        stem_stages=stem_stages, sparse_plans=sparse_plans, train=False, remat=False)[0]


def drnseg_forward(
    params: Params,
    state: State,
    x: torch.Tensor,
    spec: DrnSpec,
    *,
    train: bool = False,
    compute_dtype: torch.dtype | None = None,
    upsample: bool = True,
    stem_fn=None,
    stem_stages: int = 1,
    sparse_plans: dict | None = None,
    remat: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, State]:
    """Full DRNSeg forward (``tpuseg``'s ``drnseg_forward``).

    Returns ``(log_probs, seg_logits, bn_updates)``: ``log_probs`` is the
    f32 log-softmax of the x8-upsampled logits (NHWC; the transposed conv
    runs in the compute dtype), as in the reference forward
    (semantic_seg.py:154-158); with ``upsample=False`` it is the log-softmax
    at feature resolution.  ``train``, ``remat`` and ``sparse_plans``: see
    ``drn_forward``; ``bn_updates`` is empty in eval."""
    seg, updates = _logits_and_updates(
        params, state, x, spec, compute_dtype=compute_dtype, stem_fn=stem_fn,
        stem_stages=stem_stages, sparse_plans=sparse_plans, train=train, remat=remat)
    y = upsample8(seg, params["up.weight"]) if upsample else seg
    return torch.log_softmax(y.float(), dim=-1), seg, updates
