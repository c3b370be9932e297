"""MLA zoo twins: minicpm3-4b (multi-head latent attention: q and kv LoRA
ranks, a shared rotary key, q/k head dim 96 against v head dim 64;
reduced: 48 against 32) against the JAX package on its reduced config,
and the absorbed latent decode itself on a ring cache with empty and
wrapped slots. The prefill is plain attention in both packages (no
kernel; ``impl="kernel"`` launches none). Tolerances: ``torch_zoo_twins``
(1e-4 for logits and caches)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import attention as jattn
from repro_torch.models import attention as tattn
from torch_zoo_twins import (one_torch_thread,  # noqa: F401 (autouse)
                             TOL, assert_tree_close, cfgs,
                             check_adamw_step, check_decode_consistency,
                             check_decode_step, check_loss_and_grads,
                             check_prefill, perturb_zeros)

ARCH = "minicpm3-4b"


def test_loss_and_grads_match():
    check_loss_and_grads(ARCH)


def test_adamw_step_matches():
    check_adamw_step(ARCH)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_prefill_matches(impl):
    check_prefill(ARCH, impl)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_decode_step_matches(impl):
    check_decode_step(ARCH, impl)


def test_decode_consistency_twin():
    check_decode_consistency(ARCH)


@pytest.mark.parametrize("filled", [5, 12, 40])
def test_absorbed_decode_matches_reference(filled):
    """``mla_decode`` over a 16-slot ring holding positions 0 .. filled-1
    (empty slots at 5 and 12; at 40 the ring has wrapped twice), the new
    token at position ``filled``: output and updated cache."""
    jcfg, tcfg = cfgs(ARCH)
    m, T, B = jcfg.mla, 16, 2
    p = jax.tree.map(np.asarray, perturb_zeros(
        jattn.mla_init(jax.random.PRNGKey(filled), jcfg), filled))
    rng = np.random.default_rng(filled)
    pos = np.full((B, T), -1, np.int32)
    for t in range(filled):
        pos[:, t % T] = t
    cache = {"c_kv": rng.normal(size=(B, T, m.kv_lora_rank)),
             "k_rope": rng.normal(size=(B, T, m.qk_rope_dim)), "pos": pos}
    cache = {k: v.astype(np.float32) if k != "pos" else v
             for k, v in cache.items()}
    x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    new_pos = np.full((B, 1), filled, np.int32)
    jy, jc = jattn.mla_decode(jax.tree.map(jnp.asarray, p), jcfg,
                              jnp.asarray(x),
                              jax.tree.map(jnp.asarray, cache),
                              jnp.asarray(new_pos))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ty, tc2 = tattn.mla_decode({k: torch.from_numpy(v.copy()) for k, v in
                                p.items()}, tcfg, torch.from_numpy(x), tc,
                               torch.from_numpy(new_pos))
    assert tc2 is tc                                   # in place
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL,
                               rtol=TOL)
    assert_tree_close({k: v.numpy() for k, v in tc.items()},
                      jax.tree.map(np.asarray, jc))
