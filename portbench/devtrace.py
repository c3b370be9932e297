"""The profiled stretch of a traced run: device busy and idle time,
kernel time by name, and what the host was doing in each idle gap.

``torch.profiler`` records the card's activity (kernels, copies, sets)
over one call of a unit of work. The host's spans inside the stretch are
noted without waiting for the card, so an idle gap on the device is
attributed to the span the host was in when it began. The two clocks are
aligned by one marker kernel launched right after a synchronise.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

NOT_KERNELS = ("Memcpy", "Memset")


def short_name(name: str) -> str:
    """``void at::native::vectorized_elementwise_kernel<4, ...>(...)`` ->
    ``vectorized_elementwise_kernel``; a name without scopes as it is."""
    n = name[5:] if name.startswith("void ") else name
    cut = [i for i in (n.find("("), n.find("<")) if i > 0]
    n = n[:min(cut)] if cut else n
    n = n.strip().rsplit("::", 1)[-1]
    return (n or name)[:64]


@dataclass
class Profile:
    window_s: float
    busy_s: float
    units: int
    kernels: Dict[str, List[float]] = field(default_factory=dict)  # [n, s]
    idle_by_span: Dict[str, float] = field(default_factory=dict)

    def kernel_seconds(self, names: Sequence[str]) -> float:
        return sum(self.kernels[n][1] for n in names if n in self.kernels)

    def kernel_count(self, names: Sequence[str]) -> int:
        return int(sum(self.kernels[n][0] for n in names
                       if n in self.kernels))

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    @property
    def launches(self) -> int:
        return int(sum(c for k, (c, _) in self.kernels.items()
                       if not k.startswith(NOT_KERNELS)))

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v[1]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every device activity of the trace."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns()))
    out.sort(key=lambda x: x[1])
    return out


def _union(intervals, lo: int, hi: int) -> Tuple[int, List[Tuple[int, int]]]:
    """Busy ns of ``intervals`` clipped to [lo, hi], and the idle gaps."""
    busy, gaps, cur = 0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
            cur = s
        busy += e - cur
        cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return busy, gaps


def _span_at(log, t: int) -> str:
    """The innermost host span open at host time ``t``."""
    best, start = "outside spans", None
    for name, s, e in log:
        if s <= t <= e and (start is None or s >= start):
            best, start = name, s
    return best


def profile(fn, units: int, spans) -> Tuple[object, Profile]:
    """Run ``fn()`` (``units`` units of work) under the profiler; returns
    its result and the stretch's ``Profile``."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        marker = torch.empty(1, device="cuda")
        torch.cuda.synchronize()
        mark_ns = time.perf_counter_ns()
        marker.fill_(0.0)
        torch.cuda.synchronize()
        spans.log = []
        t0 = time.perf_counter_ns()
        out = fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        log, spans.log = spans.log, None
    events = _device_events(prof)
    if not events:
        raise RuntimeError("the profiler recorded no device activity")
    offset = events[0][1] - mark_ns          # device clock - host clock
    lo, hi = t0 + offset, t1 + offset
    busy, gaps = _union([(s, e) for _, s, e in events[1:]], lo, hi)
    kernels: Dict[str, List[float]] = {}
    for name, s, e in events[1:]:
        if e <= lo or s >= hi:
            continue
        k = kernels.setdefault(short_name(name), [0, 0.0])
        k[0] += 1
        k[1] += (min(e, hi) - max(s, lo)) / 1e9
    idle: Dict[str, float] = {}
    for s, e in gaps:
        who = _span_at(log, (s + e) // 2 - offset)
        idle[who] = idle.get(who, 0.0) + (e - s) / 1e9
    return out, Profile(window_s=(t1 - t0) / 1e9, busy_s=busy / 1e9,
                        units=units, kernels=kernels, idle_by_span=idle)
