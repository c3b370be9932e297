"""The decode step's share of its roofline, %: its least time on the card
(``counts.decode_steps``, bytes-bound: the bf16 weights and the visible
cache read once a step) over the traced window's mean ``decode_step``
span."""


def read(rec):
    ms = rec.spans.mean_ms("decode_step")
    bound = rec.roofline_s(rec.counts["decode_step"])
    if ms is None or bound is None:
        return None
    return 100.0 * bound / (ms / 1e3)
