"""The round's model FLOPs (every silo's forward and backward passes, no
recompute; ``counts.round_work``) over the traced window's mean round
time and the card's bf16 peak, %."""


def read(rec):
    ms = rec.spans.mean_ms("round")
    if ms is None or not rec.peaks:
        return None
    return 100.0 * rec.counts["round"]["flops"] / (
        ms / 1e3 * rec.peaks["bf16_flops"])
