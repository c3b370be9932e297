"""The share of the profiled prefills in which no operation ran on the
card, %."""


def read(rec):
    return rec.profile.idle_pct
