"""The hand-over's copy back onto the card, GB/s: the host bytes the
program's ``sink.fold`` spans moved over their device time, summed over
the profiled round's folds (CUDA events, ``repro_torch.core.telemetry``)."""


def read(rec):
    try:
        from repro_torch.core import telemetry
        spans = telemetry.process().spans()
    except (ImportError, AttributeError):
        return None
    folds = [s for s in spans if s.name == "sink.fold" and s.t1 is not None
             and (s.attrs or {}).get("bytes")]
    if not folds:
        return None
    return (sum(s.attrs["bytes"] for s in folds)
            / sum(s.device_s for s in folds) / 1e9)
