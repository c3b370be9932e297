"""A Nemotron-H prefill's share of the card's bf16 peak, %: its FLOPs
(``counts_hybrid_moe.prefill``) over 989 TFLOP/s, over the mean device
time of the program's ``serve.prefill`` spans in the profiled prefills
(CUDA events, ``repro_torch.core.telemetry``)."""


def read(rec):
    try:
        from repro_torch.core import telemetry
        spans = telemetry.process().spans()
    except (ImportError, AttributeError):
        return None
    times = [s.device_s for s in spans
             if s.name == "serve.prefill" and s.t1 is not None]
    work = rec.counts.get("prefill")
    if not times or work is None or not rec.peaks:
        return None
    bound = work["flops"] / rec.peaks["bf16_flops"]
    return 100.0 * bound / (sum(times) / len(times))
