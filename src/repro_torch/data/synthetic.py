"""Synthetic per-silo token data (copy of ``repro.data.synthetic``'s
``silo_key``, ``SiloDataset``, ``make_silo_datasets``, and the
FederatedForecasts generator ``forecasting_series`` with its
``ForecastSiloDataset``; the device-fleet sharding comes with the
hierarchical tier, ROADMAP queue A item 12).

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


def forecasting_series(silo_seed: int, n_steps: int, vocab: int = 4096,
                       noise: float = 0.05) -> np.ndarray:
    """Quantized energy-production-like series for one provider.

    Daily (24) + weekly (168) seasonality with silo-specific phase and
    amplitude mix, plus weather-like AR(1) noise — then uniformly quantized
    into ``vocab`` bins (token-forecaster input).
    """
    rng = np.random.default_rng(silo_seed)
    t = np.arange(n_steps, dtype=np.float64)
    phase_d, phase_w = rng.uniform(0, 2 * np.pi, 2)
    amp_d, amp_w = rng.uniform(0.5, 1.5, 2)
    base = (amp_d * np.sin(2 * np.pi * t / 24 + phase_d)
            + amp_w * np.sin(2 * np.pi * t / 168 + phase_w))
    ar = np.zeros(n_steps)
    eps = rng.normal(0, noise, n_steps)
    for i in range(1, n_steps):
        ar[i] = 0.9 * ar[i - 1] + eps[i]
    x = base + ar
    x = (x - x.min()) / (x.max() - x.min() + 1e-9)
    return np.clip((x * (vocab - 1)).astype(np.int32), 0, vocab - 1)


class ForecastSiloDataset:
    """Windows over a provider's quantized series -> LM batches."""

    def __init__(self, silo_id: str, seq_len: int, vocab: int = 4096,
                 seed: int = 0, n_steps: int = 200_000):
        self.silo_id = silo_id
        self.seq_len = seq_len
        self.vocab = vocab
        self.series = forecasting_series(seed, n_steps, vocab)
        self._rng = np.random.default_rng(seed + 7)

    def batch(self, batch_size: int) -> dict:
        starts = self._rng.integers(
            0, len(self.series) - self.seq_len - 1, batch_size)
        toks = np.stack([self.series[s:s + self.seq_len] for s in starts])
        return {"tokens": toks.astype(np.int32)}

    def stats(self) -> dict:
        return {"vocab": self.vocab, "seq_len": self.seq_len,
                "mean_level": float(self.series.mean()),
                "n_steps": len(self.series)}
