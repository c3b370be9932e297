"""One silo's pack, weight scale and mask (``pack_pytree`` and
``mask_packed``), ms: the traced window's ``mask`` spans."""


def read(rec):
    return rec.spans.mean_ms("mask")
