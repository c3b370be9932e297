"""One silo train step (forward, backward, AdamW), ms: the traced
window's ``train_step`` spans, the card synchronised at both ends."""


def read(rec):
    return rec.spans.mean_ms("train_step")
