"""Reduce a profiler trace of the traced window to what the metrics read.

Only the profiler's own device events count as device time: kernels,
copies and memsets on the card. Busy time is the union of their intervals
inside the window (the benchmark's ``tb:window`` span); an idle gap is a
stretch of the window with none of them, named by the innermost of the
benchmark's ``tb:`` spans that was open on the host at the gap's middle.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import re

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "tb:"


def kernel_id(name: str) -> str:
    """A kernel's bare name: ``void (anonymous namespace)::walk_kernel<float,
    true>(float const*, ...)`` → ``walk_kernel``."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    s = re.split(r"[<(\[]", s, 1)[0]
    return s.split("::")[-1].strip()


def short_name(name: str) -> str:
    """A device op's name without its argument list, at most 120
    characters."""
    s = name.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(s)
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            cut = i
            break
    return s[:cut][:120]


@dataclasses.dataclass
class Reduced:
    window_s: float
    busy_s: float
    ops: list          # (short name, kind, seconds), every device op
    gaps: list         # (span name, seconds), every idle gap

    def kernel_seconds(self) -> dict:
        out = collections.Counter()
        for name, kind, sec in self.ops:
            if kind == "kernel":
                out[name] += sec
        return out


def event_kind(e) -> str:
    """A kineto event's activity: its ``activity_type()`` where torch has
    it, else told from its device, annotation flag and name (a span the
    benchmark opened shows on the device too, and is no device op)."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    name = e.name()
    on_card = str(e.device_type()).endswith("CUDA")
    ann = (e.is_user_annotation() if hasattr(e, "is_user_annotation")
           else False) or name.startswith(SPAN_PREFIX)
    if ann:
        return "gpu_user_annotation" if on_card else "user_annotation"
    if not on_card:
        return "cpu_op"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _merge(iv):
    iv.sort()
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events) -> Reduced:
    """Reduce kineto events (``prof.profiler.kineto_results.events()``)."""
    spans, dev = [], []
    for e in events:
        kind = event_kind(e)
        if kind in DEVICE_KINDS:
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        short_name(e.name()), kind))
        elif kind == "user_annotation" and e.name().startswith(SPAN_PREFIX):
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                          e.name()[len(SPAN_PREFIX):]))
    win = [s for s in spans if s[2] == "window"]
    if not win:
        raise RuntimeError("the trace holds no tb:window span")
    w0, w1 = win[0][0], win[0][1]
    inside = [(max(a, w0), min(b, w1)) for a, b, _, _ in dev
              if b > w0 and a < w1]
    busy = _merge([list(x) for x in inside])
    busy_ns = sum(b - a for a, b in busy)
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    inner = sorted((s for s in spans if s[2] != "window"), key=lambda s: s[0])
    starts = [s[0] for s in inner]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        name = "window"
        # The latest-opened span still open at mid.
        for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if inner[k][1] >= mid:
                name = inner[k][2]
                break
        named.append((name, (b - a) * 1e-9))
    ops = [(n, k, (b - a) * 1e-9) for a, b, n, k in dev
           if b > w0 and a < w1]
    return Reduced(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                   ops=ops, gaps=named)


def breakdown(red: Reduced, top: int = 10) -> dict:
    """The device ops that took most time and the idle time by host span,
    each at most ``top`` entries."""
    by_op = collections.Counter()
    for name, _, sec in red.ops:
        by_op[name] += sec
    by_gap = collections.Counter()
    for name, sec in red.gaps:
        by_gap[name] += sec
    return {"device_ops": [[n, s] for n, s in by_op.most_common(top)],
            "idle_gaps": [[n, s] for n, s in by_gap.most_common(top)]}
