"""K7's share of its roofline in a prefill, %: the least time of a
prefill's SSD scans (``counts.k7`` of every layer) over the device time
of their three passes in the profiled prefills."""

NAMES = ("chunk_k", "pass_k", "output_k")


def read(rec):
    prof = rec.profile
    bound = rec.roofline_s(rec.counts["k7"])
    if not prof.kernel_count(NAMES) or bound is None:
        return None
    return 100.0 * bound * prof.units / prof.kernel_seconds(NAMES)
