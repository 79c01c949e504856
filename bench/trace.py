"""The device trace of a traced run: ``torch.profiler`` around the measured
window, reduced in memory to what the per-layer metrics read.

Only the profiler's raw events are read (``kineto_results.events()``), not
its Python event tree, whose construction costs seconds per hundred
thousand events. Nothing is written to disk.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

import torch

#: Benchmark spans are ``record_function`` ranges named with this prefix.
SPAN_PREFIX = "bench."


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict  # device op name -> [launches, seconds]
    idle_by_host: dict  # "span:op" the host was in -> seconds the device idled

    def kernel_time(self, fragment: str) -> tuple[int, float]:
        """``(launches, seconds)`` of the device ops whose name holds
        ``fragment``."""
        n, s = 0, 0.0
        for name, (count, secs) in self.kernels.items():
            if fragment in name:
                n += count
                s += secs
        return n, s

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
    device, host = [], []
    for e in events:
        if e.device_type() == cuda:
            if e.name().startswith(SPAN_PREFIX) or e.is_user_annotation():
                continue  # a span's shadow on the device timeline, not work
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif e.linked_correlation_id() == 0 and not e.is_async():
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    kernels = defaultdict(lambda: [0, 0.0])
    for start, end, name in device:
        k = kernels[name]
        k[0] += 1
        k[1] += (end - start) * 1e-9
    merged = _merge(sorted((s, e) for s, e, _ in device))
    busy = sum(e - s for s, e in merged) * 1e-9
    return TraceSummary(window_s=window_s, busy_s=busy, kernels=dict(kernels),
                        idle_by_host=_label_gaps(merged, host))


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
