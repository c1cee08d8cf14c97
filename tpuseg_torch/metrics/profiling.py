"""Device-level tracing (the port's copy of ``tpuseg/metrics/profiling.py``),
in place of the reference's ``time.time()`` deltas, ``AverageMeter`` batch
timing and hook-based FLOP extraction (semantic_seg.py:168-226,
rmbsnn_main.py:433-488, tools/get_matrix_shapes.py):

- :func:`trace`: a context manager around ``torch.profiler`` (host
  activity, and the card's kernels when CUDA is available) that writes one
  Chrome trace JSON into a directory; ``--profile-dir`` of ``seg_video``
  (the whole run) and ``semantic_seg train`` (the first trained epoch).
- :func:`span`: named spans of the program's own phases, with attributes
  (the counters) and, given a CUDA ``device``, the phase's device time.
  They are recorded in memory exactly while a ``torch.profiler`` session
  is active (``trace``, the benchmark's device trace, or any other); with
  none a span is one flag check.  :func:`spans` reads them, :func:`clear`
  empties the record, and ``trace`` adds the body's spans to its file.
- :func:`cost_analysis`: the FLOPs of one call, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` per dispatched op (matmuls
  and convs at 2 per multiply-add).  ``tpuseg`` reads XLA's cost model of
  the compiled program instead, which also counts elementwise ops and
  gives ``bytes accessed``; the two agree on matmuls and convs.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_CAP = 1_000_000  # spans kept; later ones are only counted (spans_dropped)
SPAN_TRACK = ("tpuseg_torch spans", "spans")  # (pid, tid) of their Chrome track


class Span:
    """One recorded span: ``name``, ``id``, ``parent`` (the innermost span
    open when it began, or None), ``call`` (the outermost one's id, its own
    for an outermost span, so every span of one ``run()`` call or one train
    step shares it), ``t0_ns`` and ``t1_ns`` (``time.time_ns()``, the clock
    Kineto stamps host and device events on: a Chrome trace's ``ts`` in us
    plus its ``baseTimeNanoseconds``), ``attrs`` and ``device_ms``.
    ``set(**attrs)`` adds attributes."""

    __slots__ = ("name", "id", "parent", "call", "t0_ns", "t1_ns", "attrs", "_events", "_ms")

    def __init__(self, name: str, device, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = self.parent = self.call = self.t0_ns = self.t1_ns = self._ms = None
        self._events = None
        if device is not False and torch.device(device).type == "cuda":
            stream = torch.cuda.current_stream(device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True), stream)

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _RECORDER.stack()
        self.id = _RECORDER.new_id()
        self.parent = stack[-1].id if stack else None
        self.call = stack[0].id if stack else self.id
        stack.append(self)
        if self._events is not None:
            self._events[0].record(self._events[2])
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record(self._events[2])
        _RECORDER.stack().pop()
        return False

    @property
    def device_ms(self) -> float | None:
        """The phase's device wall time on the stream current when the span
        began, gaps inside it included, in ms; None without a CUDA
        ``device``.  Resolved on first read, which waits for the span's end
        event: read it after the caller's synchronise."""
        if self._events is not None and self.t1_ns is not None:
            start, end, _ = self._events
            end.synchronize()
            self._ms, self._events = start.elapsed_time(end), None
        return self._ms


class _NoSpan:
    """What ``span`` returns while no profiler session is active."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Recorder:
    """The process's spans in the order they began, at most ``SPAN_CAP``,
    and each thread's open spans on a stack of its own."""

    def __init__(self):
        self.spans: list[Span] = []
        self.dropped = 0
        self.last_id = 0
        self._local = threading.local()

    def new_id(self) -> int:
        self.last_id += 1
        return self.last_id

    def stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st


_RECORDER = _Recorder()


def span(name: str, device=False, **attrs):
    """A context manager around one phase, ``with span(...) as s: ...
    s.set(key=value)``.  While a ``torch.profiler`` session is active it
    records a ``Span``; ``device``, a CUDA ``torch.device``, puts a CUDA
    event pair around the phase on that device's current stream (False or
    a CPU device: none).  Otherwise it returns a shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    if len(_RECORDER.spans) >= SPAN_CAP:
        _RECORDER.dropped += 1
        return _NO_SPAN
    s = Span(name, device, attrs)
    _RECORDER.spans.append(s)
    return s


def spans() -> list[Span]:
    """The recorded spans, in the order they began."""
    return list(_RECORDER.spans)


def spans_dropped() -> int:
    """Spans not kept since the last ``clear``: the record was full."""
    return _RECORDER.dropped


def clear() -> None:
    """Forget every recorded span (ids keep counting)."""
    _RECORDER.spans.clear()
    _RECORDER.dropped = 0


def _add_spans(path: str, recorded: list[Span]) -> None:
    """Append the ended spans of ``recorded`` to the Chrome trace at
    ``path``, as complete events on their own track, on the file's
    ``baseTimeNanoseconds``."""
    with open(path) as fh:
        doc = json.load(fh)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid, tid = SPAN_TRACK
    for s in recorded:
        if s.t1_ns is None:
            continue
        args = {**s.attrs, "span_id": s.id, "parent": s.parent, "call": s.call}
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        doc["traceEvents"].append({
            "ph": "X", "cat": "tpuseg_span", "name": s.name, "pid": pid, "tid": tid,
            "ts": (s.t0_ns - base) / 1e3, "dur": (s.t1_ns - s.t0_ns) / 1e3, "args": args})
    with open(path, "w") as fh:
        json.dump(doc, fh)


@contextlib.contextmanager
def trace(logdir: str | None):
    """Trace the body into ``<logdir>/<host>_<pid>.<ms>.pt.trace.json``
    (a no-op for None or ""), the body's spans on a track of their own
    beside its ops and kernels.  View it in Perfetto (ui.perfetto.dev) or
    ``chrome://tracing``."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    first = _RECORDER.last_id + 1
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()  # the body's queued kernels end inside the trace
    name = f"{socket.gethostname()}_{os.getpid()}.{int(time.time() * 1000)}.pt.trace.json"
    path = os.path.join(logdir, name)
    prof.export_chrome_trace(path)
    _add_spans(path, [s for s in _RECORDER.spans if s.id >= first])


def cost_analysis(fn, *example_args, **example_kwargs) -> dict[str, float]:
    """``{"flops": ...}`` of one call ``fn(*example_args, **example_kwargs)``,
    which runs once under ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*example_args, **example_kwargs)
    return {"flops": float(counter.get_total_flops())}
