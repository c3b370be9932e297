"""The blocks' attention heads in a decode step, ms a step: the device time of
the program's ``serve.attention`` spans inside ``serve.decode_step`` over the
profiled steps, over their count (CUDA events,
``repro_torch.core.telemetry``)."""


def read(rec):
    try:
        from repro_torch.core import telemetry
        spans = telemetry.process().spans()
    except (ImportError, AttributeError):
        return None
    parents = {s.span_id for s in spans
               if s.name == "serve.decode_step" and s.t1 is not None}
    times = [s.device_s for s in spans
             if s.name == "serve.attention" and s.parent_id in parents]
    return 1e3 * sum(times) / len(parents) if times else None
