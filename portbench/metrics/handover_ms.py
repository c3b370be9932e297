"""One silo's masked update to the host and, folded by the server, back
onto the card, ms: the traced window's ``handover`` spans."""


def read(rec):
    return rec.spans.mean_ms("handover")
