"""The silo train step's AdamW update, ms: the mean device time of the
program's ``train.optimizer`` spans over the profiled round (CUDA
events, ``repro_torch.core.telemetry``)."""


def read(rec):
    try:
        from repro_torch.core import telemetry
        spans = telemetry.process().spans()
    except (ImportError, AttributeError):
        return None
    times = [s.device_s for s in spans
             if s.name == "train.optimizer" and s.t1 is not None]
    return 1e3 * sum(times) / len(times) if times else None
