"""The device trace of a traced run: ``torch.profiler`` around the measured
window, reduced in memory to what the per-layer metrics read.

Only the profiler's raw events are read (``kineto_results.events()``), not
its Python event tree, whose construction costs seconds per hundred
thousand events. Nothing is written to disk.

Spans are ``record_function`` ranges: the benchmark's own (``bench.``,
around each step or request) and the program's (``repro_torch.``, opened by
the port's ``tracing.span`` inside a step). A device op belongs to the
innermost program span open when the CUDA runtime or driver call that
launched it was made (found by its ``cu`` name prefix and the correlation
id it shares with the op), on any host thread: autograd launches the
backward from a thread of its own while the caller's span is open, and the
port's ctypes kernels launch outside every torch op. An idle gap belongs to
the innermost program span open at its midpoint.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

import torch

#: Benchmark spans are ``record_function`` ranges named with this prefix.
SPAN_PREFIX = "bench."
#: The program's spans (``repro_torch.tracing``) are named with this one.
PROGRAM_PREFIX = "repro_torch."
#: Host events of CUDA runtime and driver calls start with this.
RUNTIME_PREFIX = "cu"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict  # device op name -> [launches, seconds]
    idle_by_host: dict  # "span:op" the host was in -> seconds the device idled
    # program span -> device seconds of the ops launched in it / idle seconds
    # of the gaps whose midpoint it held; every span in the trace has an entry
    span_device_s: dict = dataclasses.field(default_factory=dict)
    span_idle_s: dict = dataclasses.field(default_factory=dict)
    unlaunched_s: float = 0.0  # device seconds whose launching call was not found

    def kernel_time(self, fragment: str) -> tuple[int, float]:
        """``(launches, seconds)`` of the device ops whose name holds
        ``fragment``."""
        n, s = 0, 0.0
        for name, (count, secs) in self.kernels.items():
            if fragment in name:
                n += count
                s += secs
        return n, s

    def span_ms(self, table: str, span: str, per: int) -> float | None:
        """``table`` (``"span_device_s"`` or ``"span_idle_s"``) of ``span``
        in ms over ``per`` steps or requests; None where the span is absent."""
        secs = getattr(self, table).get(span)
        return None if secs is None or not per else secs / per * 1e3

    def describe_spans(self) -> str:
        """A line on how much of the device time the program's spans hold."""
        held = sum(self.span_device_s.values())
        share = f"{held / self.busy_s:.6f}" if self.busy_s else "n/a"
        return (f"program spans hold {held:.6f} s of device time, {share} of busy "
                f"{self.busy_s:.6f} s; launching call not found for {self.unlaunched_s:.6f} s; "
                + ", ".join(f"{k} {v:.6f}/{self.span_idle_s[k]:.6f}"
                            for k, v in sorted(self.span_device_s.items())))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[name, secs] for name, (_, secs) in ops],
                "idle_gaps": [[label, secs] for label, secs in gaps]}


class Tracer:
    """Context manager: profiles CPU and CUDA activity while open."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def summary(self, window_s: float) -> TraceSummary:
        events = self._prof.profiler.kineto_results.events()
        return summarize(events, window_s)


def summarize(events, window_s: float) -> TraceSummary:
    cuda = torch.autograd.DeviceType.CUDA
    device, host, spans, launched = [], [], [], {}
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if name.startswith((SPAN_PREFIX, PROGRAM_PREFIX)) or e.is_user_annotation():
                continue  # a span's shadow on the device timeline, not work
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                           e.correlation_id()))
            continue
        if name.startswith(PROGRAM_PREFIX):
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                          name[len(PROGRAM_PREFIX):]))
        elif name.startswith(RUNTIME_PREFIX):
            launched[e.correlation_id()] = e.start_ns()
        if e.linked_correlation_id() == 0 and not e.is_async():
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    kernels = defaultdict(lambda: [0, 0.0])
    for start, end, name, _ in device:
        k = kernels[name]
        k[0] += 1
        k[1] += (end - start) * 1e-9
    merged = _merge(sorted((s, e) for s, e, _, _ in device))
    busy = sum(e - s for s, e in merged) * 1e-9
    index = _SpanIndex(spans)
    span_device = dict.fromkeys(index.names, 0.0)
    unlaunched = 0.0
    for start, end, _, corr in device:
        at = launched.get(corr)
        if at is None:
            unlaunched += (end - start) * 1e-9
            continue
        span = index.at(at)
        if span is not None:
            span_device[span] += (end - start) * 1e-9
    span_idle = dict.fromkeys(index.names, 0.0)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        span = index.at((a + b) / 2)
        if span is not None:
            span_idle[span] += (b - a) * 1e-9
    return TraceSummary(window_s=window_s, busy_s=busy, kernels=dict(kernels),
                        idle_by_host=_label_gaps(merged, host), span_device_s=span_device,
                        span_idle_s=span_idle, unlaunched_s=unlaunched)


class _SpanIndex:
    """The innermost of nested spans open at a time, by bisection: the
    spans cut into disjoint pieces, each named by the innermost span open
    in it."""

    def __init__(self, spans):
        self.names = sorted({name for _, _, name in spans})
        pieces, stack, t = [], [], None

        def close_until(limit):
            nonlocal t
            while stack and stack[-1][1] <= limit:
                _, end, name = stack.pop()
                if end > t:
                    pieces.append((t, end, name))
                    t = end

        for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            close_until(start)
            if stack and start > t:
                pieces.append((t, start, stack[-1][2]))
            stack.append((start, end, name))
            t = start
        close_until(float("inf"))
        self.pieces = pieces
        self.starts = [p[0] for p in pieces]

    def at(self, t) -> str | None:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.pieces[i][1]:
            return self.pieces[i][2]
        return None


def _merge(intervals):
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _label_gaps(merged, host) -> dict:
    """Seconds of each idle gap between device work, summed by what the host
    was doing at the gap's midpoint: the benchmark span open there and the
    innermost host op (the latest-started one still open)."""
    host = sorted(host)
    starts = [h[0] for h in host]
    spans = [h for h in host if h[2].startswith(SPAN_PREFIX)]  # disjoint, in order
    span_starts = [h[0] for h in spans]
    out = defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        op = "none"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 512, -1), -1):
            s, e, name = host[j]
            if e >= mid and not name.startswith(SPAN_PREFIX):
                op = name
                break
        k = bisect.bisect_right(span_starts, mid) - 1
        span = spans[k][2][len(SPAN_PREFIX):] if k >= 0 and spans[k][1] >= mid else "none"
        out[f"{span}:{op}"] += (b - a) * 1e-9
    return dict(out)
