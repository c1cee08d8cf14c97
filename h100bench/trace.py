"""The device trace of a traced window (``torch.profiler``, CUDA activity
only: tracing host ops too slows host-paced work by up to a half) and what
the benchmark reads from it: device busy time, kernels by name, and the
idle gaps labelled by the CUDA runtime call the host was in."""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile

from h100bench.stats import intervals_union

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


class Trace:
    """Device events ``(name, start_us, dur_us)`` and host CUDA API events
    of one traced window."""

    def __init__(self, events: list[dict]):
        self.device = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                       for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        self.host = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                     for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
        self.device.sort(key=lambda e: e[1])
        self.host.sort(key=lambda e: e[1])

    def busy_s(self) -> float:
        return intervals_union((t, t + d) for _, t, d in self.device) * 1e-6

    def seconds_where(self, pattern: str) -> float:
        """Device seconds of events whose name matches ``pattern`` (a regex)."""
        rx = re.compile(pattern)
        return sum(d for n, _, d in self.device if rx.search(n)) * 1e-6

    def count_where(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for n, _, _ in self.device if rx.search(n))

    def top_ops(self, k: int = 10) -> list:
        by: dict[str, float] = {}
        for n, _, d in self.device:
            by[short_name(n)] = by.get(short_name(n), 0.0) + d * 1e-6
        return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """Device idle time from the first host CUDA call or device event to
        the last, summed by what the host was doing: each CUDA runtime call
        for the part of a gap it covers, ``host code (no CUDA call)`` for
        the rest (Python, numpy, the harness)."""
        if not self.device:
            return []
        lo = min([self.device[0][1]] + [t for _, t, _ in self.host])
        hi = max([t + d for _, t, d in self.device] + [t + d for _, t, d in self.host])
        gaps, end = [], lo
        for _, t, d in self.device + [("", hi, 0.0)]:
            if t > end:
                gaps.append((end, t))
            end = max(end, t + d)
        by: dict[str, float] = {}
        j0 = 0
        for a, b in gaps:
            while j0 < len(self.host) and self.host[j0][1] + self.host[j0][2] < a:
                j0 += 1
            covered = 0.0
            for name, t, d in self.host[j0:]:
                if t >= b:
                    break
                part = max(0.0, min(b, t + d) - max(a, t))
                by[name] = by.get(name, 0.0) + part * 1e-6
                covered += part
            rest = max(0.0, (b - a) - covered)
            by["host code (no CUDA call)"] = by.get("host code (no CUDA call)", 0.0) + rest * 1e-6
        return sorted(([n, s] for n, s in by.items() if s > 0), key=lambda x: -x[1])[:k]


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameter list, at most 96 characters."""
    s = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    s = "".join(out).split("(")[0].strip()
    return s[:96] or name[:96]


@contextlib.contextmanager
def device_trace():
    """Trace the body's CUDA activity (the body synchronises the device
    before it ends); yields a list that holds the ``Trace`` once the body
    has ended.  The Chrome JSON goes to a temporary file that is deleted
    once read."""
    from torch.profiler import ProfilerActivity, profile

    box = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield box
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            box.append(Trace(json.load(fh)["traceEvents"]))
    finally:
        os.unlink(path)
