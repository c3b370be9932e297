"""The grouped MoE dispatch (``_moe_apply_grouped`` and the
``REPRO_MOE_GROUPED`` switch) against the JAX package's.

Reduced ``olmoe-1b-7b`` and ``dbrx-132b`` (4 experts, top 2), at their
reduced capacity factor (dropless) and at the published 1.25, where each
group's own capacity ``max(8, min(int(1.25 * Tg * K / E), Tg))`` drops
assignments that the global dispatch keeps. The reference's init is
converted through numpy. Tolerances: the output within 1e-5 and the aux
loss within 1e-6 (f32, sums in another order); the groups must really
differ from the global dispatch at 1.25, or the test would not see them.
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

ARCHS = ["olmoe-1b-7b", "dbrx-132b"]
OUT_TOL, AUX_TOL = 1e-5, 1e-6
B, S = 2, 48                                  # T = 96 tokens


def _configs(arch, cf):
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    if cf is not None:
        jc = dataclasses.replace(jc, moe=JMoE(**{
            **dataclasses.asdict(jc.moe), "capacity_factor": cf}))
        tc = dataclasses.replace(tc, moe=TMoE(**{
            **dataclasses.asdict(tc.moe), "capacity_factor": cf}))
    return jc, tc


def _inputs(jc, seed=0):
    p = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(seed), jc))
    x = np.random.default_rng(seed).normal(
        size=(B, S, jc.d_model)).astype(np.float32)
    return p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}, x


def _close(jout, tout):
    (jo, ja), (to, ta) = jout, tout
    assert to.shape == jo.shape
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=OUT_TOL,
                               rtol=0)
    assert abs(float(ta) - float(ja)) <= AUX_TOL


@pytest.mark.parametrize("cf", [None, 1.25], ids=["reduced", "cf1.25"])
@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_dispatch_matches(arch, G, cf):
    jc, tc = _configs(arch, cf)
    p, tp, x = _inputs(jc)
    jout = jmoe._moe_apply_grouped(p, jc, jnp.asarray(x), G)
    _close(jout, tmoe._moe_apply_grouped(tp, tc, torch.from_numpy(x), G))
    if cf is not None:
        # group-local capacity drops what the global dispatch keeps
        glob = jmoe.moe_apply(p, jc, jnp.asarray(x))[0]
        assert not np.allclose(np.asarray(glob), np.asarray(jout[0]))


@pytest.mark.parametrize("G", ["1", "2", "4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_reads_the_switch(arch, G, monkeypatch):
    jc, tc = _configs(arch, 1.25)
    p, tp, x = _inputs(jc)
    monkeypatch.setenv("REPRO_MOE_GROUPED", G)
    jout = jmoe.moe_apply(p, jc, jnp.asarray(x))
    tout = tmoe.moe_apply(tp, tc, torch.from_numpy(x))
    _close(jout, tout)
    # the switch is read at call time: "1" is the global dispatch
    grouped = tmoe._moe_apply_grouped(tp, tc, torch.from_numpy(x), int(G)) \
        if G != "1" else None
    monkeypatch.delenv("REPRO_MOE_GROUPED")
    plain = tmoe.moe_apply(tp, tc, torch.from_numpy(x))
    if grouped is None:
        assert torch.equal(tout[0], plain[0])
    else:
        assert torch.equal(tout[0], grouped[0])
        assert not torch.equal(tout[0], plain[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_groups_that_do_not_divide_the_tokens_fail(arch, monkeypatch):
    jc, tc = _configs(arch, None)
    p, tp, x = _inputs(jc)
    monkeypatch.setenv("REPRO_MOE_GROUPED", "5")        # 96 % 5 != 0
    with pytest.raises(AssertionError):
        jmoe.moe_apply(p, jc, jnp.asarray(x))
    with pytest.raises(ValueError, match="do not divide"):
        tmoe.moe_apply(tp, tc, torch.from_numpy(x))
