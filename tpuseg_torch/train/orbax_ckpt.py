"""The directory checkpoint envelope (counterpart of
``tpuseg/train/orbax_ckpt.py``), written with ``torch.distributed.checkpoint``.

``tpuseg`` stores this envelope through orbax, which needs JAX; the port
writes the same logical contract with DCP instead:

- the flat keys of the npz envelope (``params/…``, ``bn_state/…``,
  ``masks/…``, ``opt/…``, conv weights HWIO as on disk) and the JSON
  ``__meta__`` as a uint8 blob, one DCP checkpoint;
- **async save**: ``async_save=True`` returns once the tensors are staged
  in host memory and writes them on a background thread (the next save,
  ``wait_for_saves`` or a best copy waits for it first);
- **every rank calls save** (DCP's plan and commit are collective; a
  replicated tensor is written once); rank 0 alone does the filesystem work
  around it, between barriers;
- atomicity: the save lands in ``<path>.new`` and is swapped over
  ``<path>`` only after DCP committed it (its ``.metadata`` file, written
  last); the old checkpoint moves to ``<path>.old`` until the new one is in
  place.  A committed ``.new`` is preferred on load (it is newer than
  ``<path>``), ``.old`` is the fallback, and a save removes an uncommitted
  ``.new`` (a crashed save) first.

The loader needs no model: each key's shape and dtype come from the
checkpoint's metadata.  A directory that ``tpuseg`` wrote with orbax cannot
be read without orbax: npz is the format both packages read.
"""

from __future__ import annotations

import os
import shutil
from typing import Mapping

import numpy as np
import torch

_PENDING = None  # (future, tmp, final) of an async save awaiting commit + swap


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def _barrier() -> None:
    dist = _dist()
    if dist is not None and dist.get_world_size() > 1:
        dist.barrier()


def _is_committed(path: str) -> bool:
    """True iff ``path`` is a DCP checkpoint directory whose save finished
    (DCP writes ``.metadata`` after every data file)."""
    return os.path.isdir(path) and os.path.exists(os.path.join(path, ".metadata"))


def _rename_over(tmp: str, final: str) -> None:
    """Rename a COMMITTED save at ``tmp`` over ``final`` (rank 0 only, no
    collective): the old checkpoint moves aside to ``<final>.old`` first, so
    a crash at any point leaves a durable checkpoint at ``final``, at a
    committed ``tmp`` or at ``.old``."""
    old = final + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(final):
        os.rename(final, old)
    os.rename(tmp, final)
    if os.path.exists(old):
        shutil.rmtree(old)


def _swap_into_place(tmp: str, final: str) -> None:
    if _rank() == 0:
        _rename_over(tmp, final)
    _barrier()


def _wait(future) -> None:
    # torch returns a Future, or an AsyncSaveResponse whose upload
    # completion is the commit
    (getattr(future, "upload_completion", None) or future).result()


def _finalize_pending() -> None:
    global _PENDING
    if _PENDING is None:
        return
    future, tmp, final = _PENDING
    _PENDING = None
    _wait(future)
    _swap_into_place(tmp, final)


def _state_dict(arrays: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


def save_checkpoint_orbax(
    path: str,
    arrays: Mapping[str, np.ndarray],
    *,
    is_best: bool = False,
    async_save: bool = False,
) -> None:
    """Save the envelope's flat ``arrays`` (``checkpoint._envelope``) as a
    DCP directory at ``path``; every rank of a process group calls this."""
    import torch.distributed.checkpoint as dcp

    global _PENDING
    path = os.path.abspath(path)
    # one save in flight: finish (wait + swap) the previous one first
    _finalize_pending()
    tmp = path + ".new"
    if _rank() == 0:
        if _is_committed(tmp):
            # a crash between DCP's commit and the swap: .new is the newest
            # durable checkpoint, so swap it in instead of deleting it
            _rename_over(tmp, path)
        elif os.path.exists(tmp):
            shutil.rmtree(tmp)  # an uncommitted save of a crashed run
        os.makedirs(os.path.dirname(path), exist_ok=True)
    # unconditional: every rank joins whatever the filesystem looked like
    _barrier()
    state = _state_dict(arrays)
    writer = dcp.FileSystemWriter(tmp)
    no_dist = _dist() is None
    if async_save:
        _PENDING = (dcp.async_save(state, storage_writer=writer, no_dist=no_dist), tmp, path)
    else:
        dcp.save(state, storage_writer=writer, no_dist=no_dist)
        _swap_into_place(tmp, path)
    if is_best:
        _finalize_pending()  # commit + swap before copying
        if _rank() == 0:
            best = os.path.join(os.path.dirname(path), "checkpoint_best.orbax")
            if os.path.exists(best):
                shutil.rmtree(best)
            shutil.copytree(path, best)
        _barrier()


def wait_for_saves() -> None:
    """Block until any outstanding async save has committed AND been
    swapped into place at its final path."""
    _finalize_pending()


def _written_by_orbax(path: str) -> bool:
    return os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, m))
        for m in ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt", "_sharding"))


def load_arrays_orbax(path: str) -> dict[str, np.ndarray]:
    """The flat ``{key: array}`` of a directory envelope, preferring a
    committed ``<path>.new`` and falling back to ``<path>.old``.  Raises a
    ``SystemExit`` for a directory that orbax wrote (``tpuseg``)."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    if _is_committed(path + ".new"):
        path = path + ".new"
    elif not os.path.exists(path):
        for sibling in (path + ".new", path + ".old"):
            if os.path.exists(sibling):
                path = sibling
                break
    if not _is_committed(path):
        if _written_by_orbax(path):
            raise SystemExit(
                f"{path}: an orbax checkpoint (written by tpuseg) cannot be read without "
                "orbax; save it as .npz, the format both packages read")
        raise FileNotFoundError(f"{path}: no committed checkpoint directory")
    reader = dcp.FileSystemReader(path)
    meta = reader.read_metadata().state_dict_metadata
    state = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype) for k, m in meta.items()}
    dcp.load(state, storage_reader=reader, no_dist=True)
    return {k: v.numpy() for k, v in state.items()}
