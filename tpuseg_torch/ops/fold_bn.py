"""Inference-time BatchNorm folding (counterpart of ``tpuseg/ops/fold_bn.py``).

At eval time BN is affine: y = (x - mu) * g / sqrt(v + eps) + b.  For a conv
(no bias) followed by BN this folds into the conv:

    W'[o, ...] = W[o, ...] * s[o],   b'[o] = b[o] - mu[o] * s[o],
    s = g / sqrt(v + eps)

The port stores conv weights OIHW, so the scale broadcasts over the first
axis (``tpuseg``'s HWIO broadcasts over the last).  The arithmetic is
``tpuseg``'s numpy f32 math, so the folded values are bit-identical to
``tpuseg``'s after the layout conversion (tests/test_torch_fold_bn.py).
The forward detects folded weights by the absence of BN params.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tpuseg_torch.models.drn import BN_EPS, DrnSpec


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _fold_pair(params, state, out, cname, bname, eps=BN_EPS):
    # numpy on the host, as tpuseg folds (torch's vectorized f32 division
    # can round a scale one ulp apart from numpy's)
    w = _np(params[f"{cname}.weight"])
    g = _np(params[f"{bname}.weight"])
    b = _np(params[f"{bname}.bias"])
    mu = _np(state[f"{bname}.running_mean"])
    var = _np(state[f"{bname}.running_var"])
    s = g / np.sqrt(var + eps)
    out[f"{cname}.weight"] = torch.from_numpy(w * s[:, None, None, None])  # OIHW: over O
    out[f"{cname}.bias"] = torch.from_numpy(b - mu * s)


def fold_bn(params: Mapping, state: Mapping, spec: DrnSpec) -> dict:
    """Return a new param dict with every conv+BN pair folded (BN params
    removed; pair with an empty BN-state dict).  Inference only."""
    out = dict(params)
    folded_bns = []
    for _, stage in spec.stages:
        if stage.kind == "convs":
            pairs = list(stage.convs)
        else:
            pairs = []
            for blk in stage.blocks:
                pairs.extend(zip(blk.convs, blk.bns))
                if blk.downsample is not None:
                    pairs.append(blk.downsample)
        for cdef, bdef in pairs:
            _fold_pair(params, state, out, cdef.name, bdef.name)
            folded_bns.append(bdef.name)
    for bn in folded_bns:
        out.pop(bn + ".weight", None)
        out.pop(bn + ".bias", None)
    return out
