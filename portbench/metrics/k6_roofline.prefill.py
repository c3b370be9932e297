"""K6's share of its roofline in a prefill, %: the least time of a
prefill's K6 calls (``counts.k6`` of every layer, visible pairs only)
over their device time in the profiled prefills."""

NAMES = ("flash_wgmma_k", "flash_fwd_k")


def read(rec):
    prof = rec.profile
    bound = rec.roofline_s(rec.counts["k6"])
    if not prof.kernel_count(NAMES) or bound is None:
        return None
    return 100.0 * bound * prof.units / prof.kernel_seconds(NAMES)
