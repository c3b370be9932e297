"""The benchmark's inputs, drawn from the run's seed on the device.

``silo_probs`` is the program's non-IID silo distribution (a Dirichlet
draw over the vocabulary, ``data/synthetic.py``'s ``SiloDataset``), copied
here so the inputs do not come from the program. Each pool is drawn in
one call and read by index, so a batch is the same whatever ran before
it and both the program and the reference can be given it.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.harness import derive_seed


def generator(seed: int, label: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        derive_seed(seed, label))


def silo_probs(vocab: int, alpha: float, seed: int) -> np.ndarray:
    """A silo's token distribution: Dirichlet(alpha) over the vocabulary."""
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.full(vocab, alpha)).astype(np.float64)
    return probs / probs.sum()


class SiloFeed:
    """Each silo's token batches: ``pool_rounds`` rounds of ``steps``
    batches of (batch, seq) ids drawn from the silo's distribution; round
    r reads pool entry r % pool_rounds."""

    def __init__(self, silos, *, vocab: int, seq: int, batch: int,
                 steps: int, alpha: float, pool_rounds: int, seed: int,
                 device):
        self.pool_rounds = pool_rounds
        self.pools = []
        for cid in silos:
            p = silo_probs(vocab, alpha, derive_seed(seed, f"silo:{cid}"))
            probs = torch.as_tensor(p, dtype=torch.float32, device=device)
            ids = torch.multinomial(
                probs, pool_rounds * steps * batch * seq, replacement=True,
                generator=generator(seed, f"tokens:{cid}", device))
            self.pools.append(ids.reshape(pool_rounds, steps, batch, seq))

    def batch(self, silo: int, rnd: int, step: int) -> dict:
        return {"tokens": self.pools[silo][rnd % self.pool_rounds, step]}


def prompt_pool(n: int, batch: int, length: int, vocab: int, seed: int,
                device) -> torch.Tensor:
    """(n, batch, length) prompt ids, uniform over the vocabulary."""
    return torch.randint(0, vocab, (n, batch, length), device=device,
                         generator=generator(seed, "prompts", device))
