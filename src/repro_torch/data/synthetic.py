"""Synthetic per-silo token data (copy of ``repro.data.synthetic``:
``silo_key``, ``SiloDataset``, ``make_silo_datasets``, the
FederatedForecasts generator ``forecasting_series`` with its
``ForecastSiloDataset``, and the hierarchical tier's lazy device sharding
``DeviceShard``, ``DeviceFleet`` and ``make_device_shards``).

Pure numpy and copied line for line, so the same seed gives the same
batches as the reference: the port's tests and the reference train on
identical tokens, and a device fleet's profiles (Dirichlet ``probs``,
lognormal ``n_examples``) and batch streams are bitwise equal too.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

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


# ---------------------------------------------------------------------------
# hierarchical tier: deterministic device sharding of a silo's distribution
# ---------------------------------------------------------------------------
class DeviceShard:
    """One simulated edge device's slice of its silo's distribution.

    Same batch contract as ``SiloDataset`` (the client's training loop is
    tier-agnostic), but the token distribution is a per-device Dirichlet
    perturbation of the *silo's* distribution (label skew) and the
    declared ``n_examples`` budget is device-specific (rate skew) — the
    GBoard-style heterogeneity the cross-device tier exists to model.
    The batch stream is deterministic in ``(silo_id, seed, device, round)``:
    re-running an inner round re-draws the same batches.
    """

    def __init__(self, silo_id: str, device_index: int, vocab: int,
                 seq_len: int, probs: np.ndarray,
                 n_examples: Optional[int], rng: np.random.Generator):
        self.silo_id = silo_id
        self.device_index = device_index
        self.vocab = vocab
        self.seq_len = seq_len
        self.n_examples = n_examples
        self._probs = probs
        self._rng = rng

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
            "n_examples": self.n_examples,
        }


class DeviceFleet:
    """Lazy, deterministic device sharding of one silo's dataset.

    ``shard(i, rnd)`` materializes device ``i``'s shard for outer round
    ``rnd`` on demand — a 10k-device fleet never exists in memory, only
    the devices an inner cohort actually samples. A device's *profile*
    (token distribution, declared example budget) is fixed across rounds
    — a phone's data distribution does not change because the server
    started round 3 — while its batch stream is keyed by the round, so
    repeated participation draws fresh batches yet replays exactly on a
    re-run. Profiles are LRU-cached: 10k Dirichlet vectors at once would
    be tens of MB, defeating the point of lazy sharding.

    ``n_devices == 1`` returns the silo dataset itself from ``shard(0)``
    (shared stateful rng included): the degenerate one-device fleet *is*
    the flat silo, which is what makes the flat-twin equivalence test
    bit-for-bit rather than approximate.
    """

    _PROFILE_CACHE_MAX = 512

    def __init__(self, silo, n_devices: int, seed: int, *,
                 label_alpha: float = 50.0, rate_skew: float = 1.0,
                 base_examples: int = 64):
        if int(n_devices) < 1:
            raise ValueError("n_devices must be >= 1")
        if n_devices > 1 and getattr(silo, "_probs", None) is None:
            raise TypeError(
                f"device sharding needs a token-distribution silo "
                f"(SiloDataset-style, with _probs); got "
                f"{type(silo).__name__}")
        self.silo = silo
        self.silo_id = str(getattr(silo, "silo_id", "silo"))
        self.n_devices = int(n_devices)
        self.seed = int(seed) % (2 ** 63)
        self.label_alpha = float(label_alpha)
        self.rate_skew = float(rate_skew)
        self.base_examples = int(base_examples)
        self._key = silo_key(self.silo_id)
        self._profiles: "OrderedDict[int, tuple]" = OrderedDict()

    def _profile(self, i: int):
        """(probs, n_examples) of device ``i`` — fixed across rounds."""
        if i in self._profiles:
            self._profiles.move_to_end(i)
            return self._profiles[i]
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self._key, i]))
        probs = rng.dirichlet(
            self.label_alpha * self.silo._probs + 1e-4).astype(np.float64)
        probs /= probs.sum()
        # rate skew: lognormal device sizes. A declared silo size is
        # split across the fleet pro-rata; an unbounded silo gets
        # per-device budgets around base_examples, so small devices
        # genuinely cap their FedAvg weight below the nominal budget.
        rate = float(rng.lognormal(0.0, self.rate_skew))
        declared = getattr(self.silo, "n_examples", None)
        per_device = (declared / self.n_devices if declared is not None
                      else self.base_examples)
        n_examples = max(1, int(round(per_device * rate)))
        value = self._profiles[i] = (probs, n_examples)
        while len(self._profiles) > self._PROFILE_CACHE_MAX:
            self._profiles.popitem(last=False)
        return value

    def shard(self, device_index: int, rnd: int = 0):
        if not 0 <= device_index < self.n_devices:
            raise IndexError(
                f"device {device_index} out of range [0, {self.n_devices})")
        if self.n_devices == 1:
            return self.silo          # degenerate fleet IS the flat silo
        probs, n_examples = self._profile(device_index)
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, self._key, device_index, int(rnd), 0x5EED]))
        return DeviceShard(self.silo_id, device_index, self.silo.vocab,
                           self.silo.seq_len, probs, n_examples, rng)


def make_device_shards(silo, n_devices: int, seed: int,
                       **kwargs) -> DeviceFleet:
    """Deterministic device sharding of ``silo`` (the tentpole's data-layer
    entry point): returns a lazy ``DeviceFleet`` whose shards are pure
    functions of ``(silo_id, seed, device, round)``."""
    return DeviceFleet(silo, n_devices, seed, **kwargs)
