"""Synthetic per-silo token data (copy of ``repro.data.synthetic``'s
``silo_key``, ``SiloDataset`` and ``make_silo_datasets``).

Pure numpy and copied line for line, so the same seed gives the same
batches as the reference: the port's tests and the reference train on
identical tokens.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np


def silo_key(silo_id) -> int:
    """Stable 63-bit integer identity of a silo for seed derivation."""
    h = hashlib.blake2b(str(silo_id).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big") >> 1


@dataclass
class SiloDataset:
    silo_id: str
    vocab: int
    seq_len: int
    seed: int
    alpha: float = 0.3          # Dirichlet concentration (lower = more skew)
    n_examples: int = None      # declared silo size (None = unbounded);
    _rng: np.random.Generator = None        # caps the silo's FedAvg weight
    _probs: np.ndarray = None

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._probs = self._rng.dirichlet(
            np.full(self.vocab, self.alpha)).astype(np.float64)
        self._probs /= self._probs.sum()

    def batch(self, batch_size: int) -> dict:
        toks = self._rng.choice(self.vocab, size=(batch_size, self.seq_len),
                                p=self._probs).astype(np.int32)
        return {"tokens": toks}

    def stats(self) -> dict:
        p = self._probs
        return {
            "vocab": self.vocab,
            "seq_len": self.seq_len,
            "entropy": float(-(p * np.log(p + 1e-12)).sum()),
            "top_token": int(p.argmax()),
        }


def make_silo_datasets(n_silos: int, vocab: int, seq_len: int,
                       seed: int = 0, alpha: float = 0.3):
    return [SiloDataset(f"silo-{i}", vocab, seq_len, seed * 1000 + i,
                        alpha=alpha) for i in range(n_silos)]
