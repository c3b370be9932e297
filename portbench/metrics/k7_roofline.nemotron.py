"""K7's share of its roofline in a Nemotron-H prefill, %: the least time
of the prefill's SSD scans (``counts_hybrid_moe.k7`` of every Mamba2
layer, B and C counted once a group) over the device time of their
three passes in the profiled prefills."""

NAMES = ("chunk_k", "pass_k", "output_k")


def read(rec):
    prof = rec.profile
    work = rec.counts.get("k7")
    bound = rec.roofline_s(work) if work is not None else None
    if not prof.kernel_count(NAMES) or bound is None:
        return None
    return 100.0 * bound * prof.units / prof.kernel_seconds(NAMES)
