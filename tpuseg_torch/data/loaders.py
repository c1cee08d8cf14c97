"""Host-side batching + device prefetch (counterpart of
``tpuseg/data/loaders.py``).

A producer thread keeps a short queue of device-resident batches so the card
does not wait on host preprocessing (the answer to ``pin_memory=True`` +
loader workers, semantic_seg.py:911-915).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch


def batch_iterator(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    rng: np.random.Generator | None = None,
    drop_last: bool = False,
    epoch: int = 0,
    num_shards: int = 1,
    shard_index: int = 0,
) -> Iterator[tuple]:
    """Yield tuples of stacked numpy batches.

    ``num_shards``/``shard_index`` give per-host sharding (the moral
    equivalent of DistributedSampler + set_epoch, utils.py:47,
    rmbsnn_main.py:397-398 — the ``epoch`` arg reseeds the shuffle).
    """
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        r = rng or np.random.default_rng(epoch)
        r.shuffle(order)
    if num_shards > 1 and drop_last:
        # equalize step counts across shards — otherwise hosts whose shard
        # got one extra sample would run an extra collective step and hang
        # (the reference's DistributedSampler pads for the same reason)
        n_even = (n // (num_shards * batch_size)) * (num_shards * batch_size)
        order = order[:n_even]
    order = order[shard_index::num_shards]
    end = len(order) - (len(order) % batch_size) if drop_last else len(order)
    for start in range(0, end, batch_size):
        idx = order[start : start + batch_size]
        samples = [dataset[int(i)] for i in idx]
        fields = list(zip(*samples))
        out = []
        for f in fields:
            if isinstance(f[0], (np.ndarray, np.generic, int, float)):
                out.append(np.stack(f))
            else:
                out.append(list(f))
        yield tuple(out)


def _to_device(x, device: torch.device):
    if not isinstance(x, np.ndarray):
        return x
    t = torch.from_numpy(x)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def prefetch_to_device(iterator: Iterable, device, size: int = 2) -> Iterator:
    """Run the host iterator in a background thread, moving each batch's
    numpy arrays to ``device`` ``size`` batches ahead of compute (pinned
    host memory and non-blocking copies on a CUDA device; other fields pass
    through).  An error in the producer is raised here, in the consumer,
    instead of ending the epoch early."""
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    error: list[BaseException] = []

    def producer():
        try:
            for item in iterator:
                q.put(tuple(_to_device(x, device) for x in item))
        except BaseException as exc:  # re-raised in the consumer
            error.append(exc)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            t.join()
            if error:
                raise error[0]
            break
        yield item
