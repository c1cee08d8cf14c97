"""Device-level tracing (the port's copy of ``tpuseg/metrics/profiling.py``),
in place of the reference's ``time.time()`` deltas, ``AverageMeter`` batch
timing and hook-based FLOP extraction (semantic_seg.py:168-226,
rmbsnn_main.py:433-488, tools/get_matrix_shapes.py):

- :func:`trace`: a context manager around ``torch.profiler`` (host
  activity, and the card's kernels when CUDA is available) that writes one
  Chrome trace JSON into a directory; ``--profile-dir`` of ``seg_video``
  (the whole run) and ``semantic_seg train`` (the first trained epoch).
- :func:`cost_analysis`: the FLOPs of one call, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` per dispatched op (matmuls
  and convs at 2 per multiply-add).  ``tpuseg`` reads XLA's cost model of
  the compiled program instead, which also counts elementwise ops and
  gives ``bytes accessed``; the two agree on matmuls and convs.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch


@contextlib.contextmanager
def trace(logdir: str | None):
    """Trace the body into ``<logdir>/<host>_<pid>.<ms>.pt.trace.json``
    (a no-op for None or "").  View it in Perfetto (ui.perfetto.dev) or
    ``chrome://tracing``."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()  # the body's queued kernels end inside the trace
    name = f"{socket.gethostname()}_{os.getpid()}.{int(time.time() * 1000)}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(logdir, name))


def cost_analysis(fn, *example_args, **example_kwargs) -> dict[str, float]:
    """``{"flops": ...}`` of one call ``fn(*example_args, **example_kwargs)``,
    which runs once under ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*example_args, **example_kwargs)
    return {"flops": float(counter.get_total_flops())}
