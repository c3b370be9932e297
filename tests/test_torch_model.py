"""Dense model, optimizer and train step of the PyTorch port against the
JAX package, on the reference's params converted through numpy and the
same token batches.

fp32 (tiny config): loss within 1e-5, grads within 1e-4, params after 3
AdamW steps within 1e-5 — the two sides sum in different orders, nothing
more. bf16 compute: loss within 2e-2, because the frameworks round bf16
at different places.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.training import make_train_step as jstep
from repro_torch import tree
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import build_model as tbuild
from repro_torch.models.transformer import layer_windows
from repro_torch.optim import adamw as tadamw
from repro_torch.training import make_train_step as tstep

TINY = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=250)


def _cfgs(**extra):
    ch = {**TINY, **extra}
    return (dataclasses.replace(jget("fedforecast-100m").reduced(), **ch),
            dataclasses.replace(tget("fedforecast-100m").reduced(), **ch))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jm, tm = jbuild(jcfg), tbuild(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(1))
    npp = jax.tree.map(np.asarray, jp)
    toks = np.random.default_rng(0).integers(0, 250, (3, 2, 48)).astype(
        np.int32)
    return jm, tm, jp, npp, toks


def test_loss_and_grads_match(setup):
    jm, tm, jp, npp, toks = setup
    batch = {"tokens": toks[0]}
    (jl, _), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks[0])})
    tp = params_from_numpy(npp, "cpu")
    leaves, treedef = tree.flatten(tp)
    leaves = [p.requires_grad_(True) for p in leaves]
    tl, metrics = tm.loss_fn(tree.unflatten(treedef, leaves), batch)
    tg = torch.autograd.grad(tl, leaves)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5
    assert float(metrics["aux"]) == 0.0
    for a, b in zip(jax.tree.leaves(jg), tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


def test_three_adamw_steps_match(setup):
    jm, tm, jp, npp, toks = setup
    jtrain = jax.jit(jstep(jm, jadamw(3e-4)))
    ttrain = tstep(tm, tadamw(3e-4))
    jopt = jadamw(3e-4).init(jp)
    tp = params_from_numpy(npp, "cpu")
    topt = tadamw(3e-4).init(tp)
    for s in range(3):
        jp, jopt, jmet = jtrain(jp, jopt, {"tokens": jnp.asarray(toks[s])})
        tp, topt, tmet = ttrain(tp, topt, {"tokens": toks[s]})
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-5
        assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) \
            <= 1e-4
    assert topt["count"] == 3
    for a, b in zip(jax.tree.leaves(jp),
                    jax.tree.leaves(params_to_numpy(tp))):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5)


def test_train_step_is_deterministic(setup):
    """Equal inputs give bitwise-equal params (and so equal digests), as
    in the reference: the embedding backward must not accumulate in a
    run-dependent order."""
    _, tm, _, npp, _ = setup
    toks = np.random.default_rng(9).integers(0, 250, (8, 256)).astype(
        np.int32)                     # many repeated ids per embedding row
    runs = []
    for _ in range(3):
        opt = tadamw(3e-4)
        tp = params_from_numpy(npp, "cpu")
        tp, _, _ = tstep(tm, opt)(tp, opt.init(tp), {"tokens": toks})
        runs.append(tree.leaves(tp))
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


def test_bf16_loss_matches():
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jm, tm = jbuild(jcfg), tbuild(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(2))
    toks = np.random.default_rng(1).integers(0, 250, (2, 48)).astype(
        np.int32)
    jl, _ = jm.loss_fn(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.loss_fn(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                       {"tokens": toks})
    assert np.isfinite(float(tl))
    assert abs(float(tl) - float(jl)) <= 2e-2


def test_windowed_long_sequence_matches():
    """Sliding-window layers and q-chunking (S = 2 * Q_CHUNK)."""
    jcfg, tcfg = _cfgs(n_layers=2, sliding_window=16, local_global_period=2,
                       d_model=32, n_heads=2, n_kv_heads=1, d_ff=64)
    assert list(layer_windows(tcfg)) == [16, 0]
    jm, tm = jbuild(jcfg), tbuild(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(3))
    toks = np.random.default_rng(2).integers(0, 250, (1, 1024)).astype(
        np.int32)
    jl, _ = jm.loss_fn(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.loss_fn(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                       {"tokens": toks})
    assert abs(float(tl) - float(jl)) <= 1e-5


def test_port_init_shapes_and_distributions():
    jcfg, tcfg = _cfgs()
    tm = tbuild(tcfg, device="cpu")
    tp = tm.init(tm.generator(0))
    jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                           jbuild(jcfg).abstract_params())
    tshapes = tree.tree_map(lambda a: (tuple(a.shape), "float32"), tp)
    assert jax.tree.leaves(jshapes, is_leaf=lambda x: isinstance(x, tuple)) \
        == tree.leaves(tshapes)
    wq = tp["stack"]["attn"]["wq"]
    assert float(wq.abs().max()) <= 2.0 / 64 ** 0.5 + 1e-6   # truncated
    assert abs(float(wq.std()) * 64 ** 0.5 - 0.88) < 0.05    # trunc-normal std
    assert abs(float(tp["embed"].std()) - 0.02) < 2e-3
    again = tm.init(tm.generator(0))
    assert torch.equal(again["embed"], tp["embed"])
