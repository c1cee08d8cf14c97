"""Import PyTorch ``.pth`` checkpoints into the port's flat param/state
dicts (counterpart of ``tpuseg/models/torch_import.py``).

The reference's checkpoint-key quirks are handled as in ``tpuseg``:

- the ``module.`` prefix of DataParallel/DDP wrapping (rmbsnn_main.py:184-190)
- ``base.`` vs ``layer.`` DRNSeg attribute naming (seg_video.py:70 vs
  semantic_seg.py:135)
- the frozen upsampler ``up.weight`` (classes, 1, 16, 16) -> one (16, 16)
  kernel (every channel is the same by construction, fill_up_weights)
- ``num_batches_tracked`` buffers are dropped

The port stores conv weights OIHW, torch's own layout, so they load as they
are (``tpuseg`` transposes them to HWIO).  ``.pth`` files are read with
``torch.load``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Mapping

import numpy as np
import torch


def _to_tensor(t: Any, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().to(device="cpu", dtype=dtype).contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(t))).to(dtype)


def normalize_key(key: str) -> str:
    if key.startswith("module."):
        key = key[len("module."):]
    if key.startswith("base."):
        key = "layer." + key[len("base."):]
    return key


def convert_state_dict(
    sd: Mapping[str, Any], dtype: torch.dtype = torch.float32
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """A torch state_dict (name -> tensor or array) -> ``(params, state)``
    of CPU tensors in ``dtype``, for DRN classifiers, DRNSeg and the CIFAR
    zoo alike."""
    params: dict[str, torch.Tensor] = {}
    state: dict[str, torch.Tensor] = {}
    for raw_key, tensor in sd.items():
        key = normalize_key(raw_key)
        if key.endswith("num_batches_tracked"):
            continue
        t = _to_tensor(tensor, dtype)
        if key.endswith("running_mean") or key.endswith("running_var"):
            state[key] = t
        elif key == "up.weight":
            # (C, 1, k, k) depthwise transposed-conv weight; all channels equal
            params[key] = t[0, 0].contiguous()
        else:
            params[key] = t
    return params, state


def load_pth(path: str, dtype: torch.dtype = torch.float32):
    """Load a ``.pth`` file: a bare state_dict or the reference's envelope
    ``{'state_dict': ..., 'epoch': ...}`` (semantic_seg.py:286-290).
    Returns ``(params, state, meta)``."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    meta: dict[str, Any] = {}
    if isinstance(blob, dict) and "state_dict" in blob:
        meta = {k: v for k, v in blob.items() if k != "state_dict"}
        sd = blob["state_dict"]
    else:
        sd = blob
    params, state = convert_state_dict(sd, dtype)
    return params, state, meta


# Published ImageNet-pretrained DRN backbone checkpoints (the reference's
# drn.py:13-24: every reference seg trainer builds its backbone with
# pretrained=True, which model_zoo-downloads one of these).
DRN_WEBROOT = "http://dl.yf.io/drn/"
DRN_MODEL_URLS = {
    "drn_c_26": DRN_WEBROOT + "drn_c_26-ddedf421.pth",
    "drn_c_42": DRN_WEBROOT + "drn_c_42-9d336e8c.pth",
    "drn_c_58": DRN_WEBROOT + "drn_c_58-0a53a92c.pth",
    "drn_d_22": DRN_WEBROOT + "drn_d_22-4bd2f8ea.pth",
    "drn_d_38": DRN_WEBROOT + "drn_d_38-eebb45f0.pth",
    "drn_d_54": DRN_WEBROOT + "drn_d_54-0e0534ff.pth",
    "drn_d_105": DRN_WEBROOT + "drn_d_105-12b40979.pth",
}

# head tensors never transplanted from a classifier checkpoint: the fc head
# is ImageNet-specific and DRNSeg replaces it with seg/up
_BACKBONE_EXCLUDE = ("fc.", "seg.", "up.")


def _cache_dir() -> str:
    return os.environ.get("TPUSEG_CACHE", os.path.expanduser("~/.cache/tpuseg"))


def resolve_backbone_source(src: str, arch: str) -> str:
    """``auto`` -> the arch's published URL; anything else passes through."""
    if src != "auto":
        return src
    if arch not in DRN_MODEL_URLS:
        raise ValueError(f"no published pretrained backbone for {arch!r}; "
                         f"have {sorted(DRN_MODEL_URLS)}")
    return DRN_MODEL_URLS[arch]


def fetch_backbone(src: str, cache_dir: str | None = None) -> str:
    """A local path for ``src`` (a path or an http(s) URL).

    A URL resolves through the cache directory (``$TPUSEG_CACHE`` or
    ``~/.cache/tpuseg``), keyed by its basename, as torch's model_zoo cache
    does (the reference's drn.py:15); it is downloaded only on a cache
    miss.  On a machine without network, place the file in the cache or
    pass a local path."""
    if not src.startswith(("http://", "https://")):
        return src
    cache = cache_dir or _cache_dir()
    local = os.path.join(cache, os.path.basename(src))
    if os.path.exists(local):
        return local
    os.makedirs(cache, exist_ok=True)
    import urllib.request

    try:
        tmp = local + ".part"
        urllib.request.urlretrieve(src, tmp)
        os.replace(tmp, local)
    except Exception as exc:
        raise RuntimeError(f"could not download pretrained backbone {src!r} ({exc}); "
                           f"place the file at {local!r} or pass a local .pth path") from exc
    return local


def _cls_to_seg_key(key: str) -> str:
    """Classifier-DRN keys (``layer3.0.conv1.weight``) -> DRNSeg keys
    (``layer.3.0.conv1.weight``): the published checkpoints are
    classifiers."""
    return re.sub(r"^layer(\d+)\.", r"layer.\1.", key)


def load_pretrained_backbone(
    arch: str,
    src: str,
    params: dict,
    state: dict,
    dtype: torch.dtype = torch.float32,
    cache_dir: str | None = None,
) -> tuple[dict, dict, int]:
    """Fill a freshly initialized DRNSeg param/state dict's BACKBONE from an
    ImageNet-pretrained DRN classifier checkpoint, keeping the seg/up head
    at its init: the reference's ``pretrained=True`` bootstrap (drn.py:15-24
    via semantic_seg.py:127-134).

    ``src``: a local ``.pth`` path, an http(s) URL (cache-resolved) or
    ``"auto"`` (the arch's published URL).  Returns ``(params, state,
    n_transplanted)``; a tensor without a slot or of another shape raises
    (a checkpoint of another arch)."""
    path = fetch_backbone(resolve_backbone_source(src, arch), cache_dir)
    bb_params, bb_state, _ = load_pth(path, dtype)
    out_p, out_s = dict(params), dict(state)
    # classifier keys are remapped to seg naming when the destination model
    # is seg-named; seg-sourced keys pass through
    seg_dest = any(k.startswith("layer.") for k in params)
    n = 0
    for source, dest in ((bb_params, out_p), (bb_state, out_s)):
        for key, val in source.items():
            if key.startswith(_BACKBONE_EXCLUDE):
                continue
            if seg_dest and key not in dest:
                key = _cls_to_seg_key(key)
            if key not in dest:
                raise KeyError(f"pretrained backbone tensor {key!r} has no slot in {arch}; "
                               "wrong checkpoint for this arch?")
            if tuple(dest[key].shape) != tuple(val.shape):
                raise ValueError(f"pretrained backbone {key!r} shape {tuple(val.shape)} != "
                                 f"model's {tuple(dest[key].shape)}")
            dest[key] = val
            n += 1
    return out_p, out_s, n


def export_state_dict(params: Mapping[str, Any], state: Mapping[str, Any]) -> dict:
    """Inverse mapping: a torch-layout state_dict of numpy values (conv
    weights OIHW, as the port stores them; ``up.weight`` left out, torch
    rebuilds it with fill_up_weights)."""
    def arr(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    out: dict[str, np.ndarray] = {k: arr(v) for k, v in params.items() if k != "up.weight"}
    out.update({k: arr(v) for k, v in state.items()})
    return out
