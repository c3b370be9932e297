"""K1's share of its roofline in the round, %: its least time on the card
(``counts.k1``, bytes-bound) over its mean device time a launch in the
profiled round."""

NAMES = ("combine_vec4", "combine_scalar")


def read(rec):
    n = rec.profile.kernel_count(NAMES)
    bound = rec.roofline_s(rec.counts["k1"])
    if not n or bound is None:
        return None
    return 100.0 * bound * n / rec.profile.kernel_seconds(NAMES)
