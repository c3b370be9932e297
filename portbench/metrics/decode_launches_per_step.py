"""Kernel launches a decode step: the kernels the profiler saw over the
profiled steps, divided by their number."""


def read(rec):
    return rec.profile.launches / rec.profile.units
