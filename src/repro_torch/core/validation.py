"""Data Validation (paper §V Data Validator / §VII Data Validation).

The data *schema* is a governance decision; before training starts the
Data Validator checks every client's data-sheet statistics against it —
identical structure is a hard requirement for horizontal FL. On failure the
FL Run Manager pauses the run and the violation is reported (server side)
and the client administrator is notified (client side).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class DataSchema:
    vocab: int
    seq_len: int
    min_examples: int = 1
    value_ranges: Tuple = ()          # ((stat_name, lo, hi), ...)

    def to_dict(self):
        return {"vocab": self.vocab, "seq_len": self.seq_len,
                "min_examples": self.min_examples,
                "value_ranges": [list(r) for r in self.value_ranges]}

    @staticmethod
    def from_dict(d):
        return DataSchema(vocab=d["vocab"], seq_len=d["seq_len"],
                          min_examples=d.get("min_examples", 1),
                          value_ranges=tuple(tuple(r) for r in
                                             d.get("value_ranges", ())))


@dataclass
class ValidationResult:
    client_id: str
    ok: bool
    violations: List[str] = field(default_factory=list)

    def to_dict(self):
        return {"client_id": self.client_id, "ok": self.ok,
                "violations": list(self.violations)}


def validate_stats(client_id: str, schema: DataSchema,
                   stats: Dict) -> ValidationResult:
    """Validate a client's data-sheet statistics (never raw data)."""
    v: List[str] = []
    if stats.get("vocab") != schema.vocab:
        v.append(f"vocab {stats.get('vocab')} != negotiated {schema.vocab}")
    if stats.get("seq_len") != schema.seq_len:
        v.append(f"seq_len {stats.get('seq_len')} != negotiated "
                 f"{schema.seq_len}")
    if stats.get("n_examples", schema.min_examples) < schema.min_examples:
        v.append(f"too few examples: {stats.get('n_examples')}")
    for name, lo, hi in schema.value_ranges:
        val = stats.get(name)
        if val is None:
            v.append(f"missing stat {name!r}")
        elif not (lo <= val <= hi):
            v.append(f"stat {name}={val} outside [{lo}, {hi}]")
    return ValidationResult(client_id, not v, v)


# ---------------------------------------------------------------------------
# Preprocessing configuration (Preprocessing Coordinator <-> Data
# Preprocessing). Ops are declarative so the client executes them locally —
# the server only *informs* how to preprocess (pull model, requirement 6).
# ---------------------------------------------------------------------------
PREPROCESS_OPS = ("clip_vocab", "truncate_seq", "drop_short")


def apply_preprocessing(batch: dict, ops: List[dict]) -> dict:
    import numpy as np
    toks = np.asarray(batch["tokens"])
    for op in ops:
        kind = op["op"]
        if kind == "clip_vocab":
            toks = np.clip(toks, 0, op["vocab"] - 1)
        elif kind == "truncate_seq":
            toks = toks[:, :op["seq_len"]]
        elif kind == "drop_short":
            keep = (toks >= 0).all(axis=1)
            toks = toks[keep]
        else:
            raise ValueError(f"unknown preprocessing op {kind!r}")
    return {**batch, "tokens": toks}
