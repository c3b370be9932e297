"""Assigned input shapes (global, pre-sharding) and shape/arch pairing rules
(a text copy of ``repro.configs.shapes``, which is framework-free)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                     # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES: Tuple[InputShape, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def get_shape(name: str) -> InputShape:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}")


def shape_applicable(cfg, shape: InputShape) -> Tuple[bool, str]:
    """(runs?, reason). Skips are recorded in DESIGN.md §Shape skips."""
    if shape.name == "long_500k" and not cfg.subquadratic_decode:
        return False, ("pure full-attention decode at 524k has no native "
                       "sub-quadratic variant in the source model — skipped "
                       "per spec (DESIGN.md §4)")
    return True, ""
