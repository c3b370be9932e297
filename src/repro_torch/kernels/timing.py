"""Device timing of the port's kernels, for ``chip_smoke.py`` and
``python -m repro_torch.kernels.variants`` (never on a model's path).

Needs a CUDA card; nothing runs at import."""
from __future__ import annotations

import re
import statistics

import torch


def median_ms(fn, reps: int = 20, inner: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls of ``fn`` between two CUDA events, after 3 warm-up calls: the
    device stays busy, so the host's time to prepare a launch is not
    counted."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms_by_kernel(fn, calls: int = 10) -> dict:
    """{kernel: device ms a call} over ``calls`` calls of ``fn`` under
    ``torch.profiler``; a kernel is named by its first C++ scope name
    (``chunk_k`` for ``void (anonymous namespace)::chunk_k<float>(...)``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            found = re.search(r"::(\w+)", e.key)
            name = found.group(1) if found else e.key
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 \
                / calls
    return out
