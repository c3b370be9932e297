"""A round's server side: the sink's finalize (K1 over the staged
buffers), the divide, the unpack and the outer step, ms: the traced
window's ``fold`` spans."""


def read(rec):
    return rec.spans.mean_ms("fold")
