"""The MoE layers of a prefill, ms a prefill: the device time of the
program's ``serve.moe`` spans inside ``serve.prefill`` over the profiled
prefills, over their count (CUDA events,
``repro_torch.core.telemetry``). A program without the span reads
nothing."""


def read(rec):
    try:
        from repro_torch.core import telemetry
        spans = telemetry.process().spans()
    except (ImportError, AttributeError):
        return None
    parents = {s.span_id for s in spans
               if s.name == "serve.prefill" and s.t1 is not None}
    times = [s.device_s for s in spans
             if s.name == "serve.moe" and s.parent_id in parents]
    return 1e3 * sum(times) / len(parents) if times else None
