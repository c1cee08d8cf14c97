"""Bit-packing of class-id maps for the ids-only fetch (counterpart of
``tpuseg/ops/idpack.py``, same layout, bit for bit).

Pixels are packed in groups of 8 along the last (width) axis, little-endian
within the group: pixel ``i`` of a group occupies bits ``[bits*i,
bits*(i+1))`` of the group's ``bits`` bytes.  A (B, H, W) id map packs to
(B, H, W // 8 * bits) uint8; W must be a multiple of 8.  19 Cityscapes
classes fit in 5 bits, so the device-to-host copy of the ids shrinks 1.6x,
exactly: the host unpacks before any consumer sees the ids.

``pack_ids`` runs on the ids' device as PyTorch shifts and ors on uint8
(``<<`` wraps in uint8, dropping the bits that belong to the next byte);
``unpack_ids`` is numpy on the host.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["pack_ids", "unpack_ids", "packed_width"]


def _spans(bits: int):
    """(i, j, shift) triples: pixel i's contribution to packed byte j.

    shift >= 0 means ``byte_j |= v_i << shift`` (uint8 wrap drops the bits
    that belong to the NEXT byte); shift < 0 means ``byte_j |= v_i >> -shift``
    (the pixel's high bits continuing from the previous byte).
    """
    out = []
    for j in range(bits):
        for i in range(8):
            lo, hi = bits * i, bits * i + bits
            if hi <= 8 * j or lo >= 8 * j + 8:
                continue
            out.append((i, j, lo - 8 * j))
    return out


def packed_width(w: int, bits: int) -> int:
    if w % 8:
        raise ValueError(f"width {w} must be a multiple of 8 to pack ids")
    return w // 8 * bits


def _check_bits(bits: int) -> None:
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in 1..8, got {bits}")


def pack_ids(ids: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., W) uint8 ids < 2**bits -> (..., W // 8 * bits) uint8, on the
    ids' device."""
    _check_bits(bits)
    if ids.dtype != torch.uint8:
        raise TypeError(f"ids must be uint8, got {ids.dtype}")
    if bits == 8:
        return ids
    w = ids.shape[-1]
    g = ids.reshape(ids.shape[:-1] + (packed_width(w, bits) // bits, 8))
    out = torch.zeros(g.shape[:-1] + (bits,), dtype=torch.uint8, device=ids.device)
    for i, j, sh in _spans(bits):
        v = g[..., i]
        out[..., j] |= (v << sh) if sh >= 0 else (v >> -sh)
    return out.reshape(ids.shape[:-1] + (w // 8 * bits,))


def unpack_ids(packed: np.ndarray, bits: int) -> np.ndarray:
    """Host-side inverse: (..., W // 8 * bits) uint8 -> (..., W) uint8 ids."""
    _check_bits(bits)
    if bits == 8:
        return packed
    wp = packed.shape[-1]
    if wp % bits:
        raise ValueError(f"packed width {wp} is not a multiple of {bits}")
    g = packed.reshape(packed.shape[:-1] + (wp // bits, bits))
    mask = np.uint8((1 << bits) - 1)
    by_i: dict[int, list] = {}
    for i, j, sh in _spans(bits):
        by_i.setdefault(i, []).append((j, sh))
    pix = []
    for i in range(8):
        v = np.zeros(g.shape[:-1], np.uint8)
        for j, sh in by_i[i]:
            b = g[..., j]
            # pack's byte got (v << sh): recover with >> sh; the uint8 wrap on
            # the <<-side loses only bits >= 8, which the mask drops anyway
            v = v | ((b >> sh) if sh >= 0 else (b << -sh))
        pix.append(v & mask)
    out = np.stack(pix, axis=-1)
    return out.reshape(packed.shape[:-1] + (wp // bits * 8,))
