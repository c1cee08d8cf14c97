"""The program's own spans over a traced burst, as per-layer metrics read
them: ``tpuseg_torch.metrics.profiling`` records them while the device
trace is on (``trace.device_trace``).  ``burst(ctx)`` reads the record once
per ``Ctx`` and keeps the spans of the burst's calls (the last
``ctx.counts["attempted"]`` ``run`` calls or train steps); ``offset_us``
puts them on the trace's clock by anchors, since the ``Trace`` keeps no
``baseTimeNanoseconds``: each ``run.wait`` span encloses the
``cudaEventSynchronize`` of its ``done.synchronize()``.

Every function returns None where there is nothing to read: a program
without the recorder, a burst with no spans, or anchors that do not line
up."""

from __future__ import annotations

import bisect
from typing import NamedTuple

from h100bench.stats import intervals_union

ROOTS = ("run", "train.step")
# run()'s host work outside CUDA calls, synchronisation and the model step
HOST_SPANS = ("run.stack", "run.encode", "run.pin", "run.unpack", "run.color", "run.concat")
ANCHOR_SPAN, ANCHOR_EVENT = "run.wait", "cudaEventSynchronize"
MIN_ANCHORED = 0.9  # share of anchor spans that must enclose exactly one event


class Rec(NamedTuple):
    name: str
    id: int
    parent: int | None
    call: int
    t0_ns: int
    t1_ns: int
    attrs: dict
    device_ms: float | None


_last: list = [None, None]  # (ctx, its burst's spans)


def recorded() -> list[Rec] | None:
    """Every ended span the program recorded, or None if the program has no
    recorder."""
    try:
        from tpuseg_torch.metrics import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    return [Rec(s.name, s.id, s.parent, s.call, s.t0_ns, s.t1_ns, dict(s.attrs), s.device_ms)
            for s in read() if s.t1_ns is not None]


def of_burst(spans: list[Rec], calls: int) -> list[Rec]:
    """The spans of the last ``calls`` outermost ``run`` or ``train.step``
    spans."""
    roots = [s.id for s in spans if s.parent is None and s.name in ROOTS][-calls:]
    keep = set(roots)
    return [s for s in spans if s.call in keep]


def burst(ctx) -> list[Rec] | None:
    """The traced burst's spans (read once per ``ctx``), None if there are
    none."""
    if _last[0] is not ctx:
        spans = recorded()
        calls = int(ctx.counts.get("attempted") or 0)
        _last[:] = [ctx, (of_burst(spans, calls) or None) if spans and calls else None]
    return _last[1]


def named(spans: list[Rec], *names: str) -> list[Rec]:
    return [s for s in spans if s.name in names]


def self_ms(spans: list[Rec], names) -> float:
    """Summed self time of the spans named ``names``: each one's duration
    less the part of it its child spans cover, in ms."""
    total = 0
    for s in spans:
        if s.name not in names:
            continue
        kids = [(max(k.t0_ns, s.t0_ns), min(k.t1_ns, s.t1_ns)) for k in spans
                if k.parent == s.id]
        total += (s.t1_ns - s.t0_ns) - intervals_union((a, b) for a, b in kids if b > a)
    return total * 1e-6


def _enclosed(w0: float, w1: float, starts: list, events: list) -> list:
    """The events (start, end) lying wholly inside [w0, w1]."""
    lo, hi = bisect.bisect_left(starts, w0), bisect.bisect_right(starts, w1)
    return [e for e in events[lo:hi] if e[1] <= w1]


def _best_covered(intervals: list) -> float | None:
    """The middle of the first stretch that the most ``(lo, hi)``
    intervals cover."""
    edges = sorted([(lo, 0) for lo, _ in intervals] + [(hi, 1) for _, hi in intervals])
    best, depth, mid = 0, 0, None
    for i, (x, closing) in enumerate(edges):
        depth += -1 if closing else 1
        if depth > best:
            best, mid = depth, 0.5 * (x + edges[i + 1][0])
    return mid


def offset_us(spans: list[Rec], trace) -> float | None:
    """Span time (unix us) less trace time (us): the offset at which the
    most ``run.wait`` spans enclose a ``cudaEventSynchronize``.  A wait
    encloses an event at every offset from its start less the event's to
    its end less the event's; over every (wait, event) pair the offset
    covered most often is the true one, where each wait meets its own
    event.  (A median of start or of midpoint differences misses it: the
    wait's Python before the call is about a microsecond, after a long
    block tens.)  None unless at least ``MIN_ANCHORED`` of the ``run.wait``
    spans enclose exactly one such event at that offset."""
    waits = [(s.t0_ns * 1e-3, s.t1_ns * 1e-3) for s in spans if s.name == ANCHOR_SPAN]
    events = sorted((t, t + d) for n, t, d in trace.host if n == ANCHOR_EVENT)
    feasible = [(w0 - e0, w1 - e1) for w0, w1 in waits for e0, e1 in events
                if w0 - e0 <= w1 - e1]
    if not feasible:
        return None
    off = _best_covered(feasible)
    starts = [e[0] for e in events]
    anchored = sum(len(_enclosed(w0 - off, w1 - off, starts, events)) == 1 for w0, w1 in waits)
    return off if anchored >= MIN_ANCHORED * len(waits) else None


def idle_inside_s(spans: list[Rec], trace, names) -> float | None:
    """Seconds in which no kernel, copy or memset ran on the device while
    one of the spans named ``names`` was open, on the trace's clock."""
    off = offset_us(spans, trace)
    if off is None:
        return None
    host = [(s.t0_ns * 1e-3 - off, s.t1_ns * 1e-3 - off) for s in spans if s.name in names]
    dev = [(t, t + d) for _, t, d in trace.device]
    return (intervals_union(host + dev) - intervals_union(dev)) * 1e-6
