"""MoE zoo twins: olmoe-1b-7b (qk-norm, 64 experts top-8; reduced: 4 top-2)
and dbrx-132b (16 experts top-4; reduced: 4 top-2) against the JAX
package on their reduced configs (dropless there: capacity 100x), and the
MoE layer itself at the published capacity factor 1.25, where
assignments are really dropped, with a built top-k tie.

Tolerances: ``torch_zoo_twins`` for the models; the layer's output and
aux loss within 1e-5 (f32, sums in another order); routing (top-k ids,
which assignments are kept) equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import MoEConfig as JMoE
from repro.configs import get_config as jget
from repro.models import moe as jmoe
from repro_torch.configs import MoEConfig as TMoE
from repro_torch.configs import get_config as tget
from repro_torch.models import moe as tmoe
from torch_zoo_twins import (one_torch_thread,  # noqa: F401 (autouse)
                             check_adamw_step, check_decode_consistency,
                             check_decode_step, check_loss_and_grads,
                             check_prefill)

ARCHS = ["olmoe-1b-7b", "dbrx-132b"]
TOL = 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_step_matches(arch):
    check_adamw_step(arch)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches(arch, impl):
    check_prefill(arch, impl)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches(arch, impl):
    check_decode_step(arch, impl)


def test_decode_consistency_twin():
    check_decode_consistency("olmoe-1b-7b")


def _layer_cfgs(E=8, K=2, d_expert=32, cf=1.25):
    moe = dict(num_experts=E, top_k=K, d_expert=d_expert,
               capacity_factor=cf, router_aux_weight=0.01)
    base = dict(d_model=64, n_heads=4, n_kv_heads=4)
    return (dataclasses.replace(jget("olmoe-1b-7b").reduced(), **base,
                                moe=JMoE(**moe)),
            dataclasses.replace(tget("olmoe-1b-7b").reduced(), **base,
                                moe=TMoE(**moe)))


def _params(cfg, seed):
    p = jmoe.moe_init(jax.random.PRNGKey(seed), cfg)
    return ({k: np.asarray(v) for k, v in p.items()})


def _both(jcfg, tcfg, p, x):
    jout, jaux = jmoe.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                                jcfg, jnp.asarray(x))
    tout, taux = tmoe.moe_apply({k: torch.from_numpy(v.copy()) for k, v in
                                 p.items()}, tcfg, torch.from_numpy(x))
    return (np.asarray(jout), float(jaux)), (tout.numpy(), float(taux))


def _kept(cfg, p, x):
    """(top-k ids (T,K), kept flags (T,K)) by the reference's rule."""
    T = x.shape[0] * x.shape[1]
    logits = jnp.asarray(x.reshape(T, -1)) @ jnp.asarray(p["router"])
    _, idx, _ = jmoe.router_topk(logits, cfg.moe.top_k)
    idx = np.asarray(idx)
    cap = max(8, min(int(cfg.moe.capacity_factor * T * cfg.moe.top_k
                         / cfg.moe.num_experts), T))
    seen = np.zeros(cfg.moe.num_experts, int)
    kept = np.zeros(idx.shape, bool)
    for e_order in np.argsort(idx.reshape(-1), kind="stable"):
        t, k = divmod(int(e_order), cfg.moe.top_k)
        kept[t, k] = seen[idx[t, k]] < cap
        seen[idx[t, k]] += 1
    return idx, kept


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_layer_drops_like_the_reference(seed):
    """At capacity factor 1.25 (cap 20 of 64 tokens x 2 over 8 experts)
    the busiest experts drop their latest assignments; the port drops the
    same ones and sums the rest as the reference does."""
    jcfg, tcfg = _layer_cfgs()
    p = _params(jcfg, seed)
    # a component shared by every token skews the routing, as trained
    # routers are skewed: some experts are asked for more than 20 slots
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, 32, 64)) + 2 * rng.normal(size=64)).astype(
        np.float32)
    assert tmoe.capacity(tcfg, 64) == 20
    idx, kept = _kept(jcfg, p, x)
    assert (~kept).sum() > 0                       # real drops
    (jout, jaux), (tout, taux) = _both(jcfg, tcfg, p, x)
    np.testing.assert_allclose(tout, jout, atol=TOL, rtol=TOL)
    assert abs(taux - jaux) <= TOL
    _, tidx, _ = tmoe.router_topk(torch.from_numpy(
        x.reshape(64, -1) @ p["router"]), 2)
    np.testing.assert_array_equal(tidx.numpy(), idx)
    # a token that lost every assignment gets 0 on both sides
    lost = ~kept.any(1)
    assert np.all(tout.reshape(64, -1)[lost] == 0)


def test_topk_ties_take_the_lower_expert_first():
    """Experts 1 and 3 tie for the second place of every token (equal
    router columns): ``jax.lax.top_k`` takes expert 1, and so must the
    port, whatever ``torch.topk`` would; expert 3 computes otherwise, so
    the outputs show it too."""
    jcfg, tcfg = _layer_cfgs(E=4, K=2, cf=100.0)
    p = _params(jcfg, 5)
    u = np.abs(np.random.default_rng(5).normal(size=64)).astype(np.float32)
    p["router"] = np.stack([3 * u, 2 * u, u, 2 * u], 1) / 64
    x = np.abs(np.random.default_rng(6).normal(size=(2, 16, 64))).astype(
        np.float32)
    logits = x.reshape(32, 64) @ p["router"]
    assert np.all(logits[:, 1] == logits[:, 3])
    w, idx, _ = tmoe.router_topk(torch.from_numpy(logits), 2)
    jw, jidx, _ = jmoe.router_topk(jnp.asarray(logits), 2)
    np.testing.assert_array_equal(np.asarray(jidx), np.tile([0, 1], (32, 1)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=TOL)
    (jout, _), (tout, _) = _both(jcfg, tcfg, p, x)
    np.testing.assert_allclose(tout, jout, atol=TOL, rtol=TOL)
    # the same tie in bf16 logits, the served dtype
    bf = torch.from_numpy(logits).to(torch.bfloat16)
    assert bool((bf[:, 1] == bf[:, 3]).all())
    np.testing.assert_array_equal(tmoe.router_topk(bf, 2)[1].numpy(),
                                  np.tile([0, 1], (32, 1)))


def test_prefill_drops_what_a_decode_step_keeps():
    """By design at the published capacity: 64 equal tokens all pick the
    same two experts, whose 20 slots keep tokens 0-19; a prefill drops
    the last token, a decode step (2 tokens, 8 slots) keeps it. Both
    packages do so."""
    jcfg, tcfg = _layer_cfgs()
    p = _params(jcfg, 3)
    row = np.random.default_rng(3).normal(size=64).astype(np.float32)
    x = np.broadcast_to(row, (2, 32, 64)).copy()
    (jout, _), (tout, _) = _both(jcfg, tcfg, p, x)
    np.testing.assert_allclose(tout, jout, atol=TOL, rtol=TOL)
    assert np.all(tout[1, -1] == 0)                # dropped in the prefill
    (jdec, _), (tdec, _) = _both(jcfg, tcfg, p, x[:, -1:])
    np.testing.assert_allclose(tdec, jdec, atol=TOL, rtol=TOL)
    assert np.abs(tdec[1, 0]).max() > 1e-3         # kept in the decode
    # the decode step computes what the prefill computed for a kept token
    np.testing.assert_allclose(tdec[0, 0], tout[0, 0], atol=TOL, rtol=TOL)
