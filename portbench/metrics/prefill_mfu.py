"""The whole prefill's share of its roofline, %: its least time on the
card (``counts.prefill``; compute-bound at the bf16 peak) over the traced
window's mean ``prefill`` span."""


def read(rec):
    ms = rec.spans.mean_ms("prefill")
    bound = rec.roofline_s(rec.counts["prefill"])
    if ms is None or bound is None:
        return None
    return 100.0 * bound / (ms / 1e3)
