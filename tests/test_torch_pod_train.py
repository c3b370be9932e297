"""The port's training entry point (``repro_torch.launch.train``), its
silo-stacked pod step and the pod FedAvg aggregators against the JAX
package's.

* ``fedavg_pod_params`` and ``make_fedavg_pod_step``: the three checks of
  ``tests/test_fedavg_variants.py`` on the port; twins on random stacks:
  the unweighted mean bitwise for two silos (one rounding), the weighted
  one within 1e-6, the int8 step bitwise (the same true divisions, round
  half to even and f32 mean).
* ``make_multipod_train_step``: silo i of the pod step bitwise equal to
  ``make_train_step`` alone on silo i's slice and batch.
* ``run_pod``: the reference's pod loop rebuilt in-process from
  ``repro.training`` (``jit`` of ``make_multipod_train_step``, FedAvg
  every 4 steps) on one CPU device against the port's ``run_pod``, on
  reduced ``fedforecast-100m`` from the reference's init converted
  through numpy, both drawing the reference's token batches: 4 steps,
  FedAvg, 4 steps; every leaf and every loss within 1e-4 (the twin rule
  at lr 3e-4).
* ``run_sim`` at the launcher's defaults (3 silos, 3 secure rounds of 5
  steps, batch 4 x 64, reduced): the reference's ``run_sim`` and the
  port's, with the master key fixed and ``uuid4`` counting in both and
  the reference's init injected into the port's server; loss curves
  within 1e-4, ``data_size`` contributions equal, both chains intact.
* ``main`` in both modes with ``--device cpu``; without it, on a host
  without CUDA, it raises.
"""
import argparse
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.training import fedavg_pod_params as jfedavg
from repro.training import make_fedavg_pod_step as jfedavg_step
from repro.training import make_multipod_train_step as jmultipod
from repro_torch import tree
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import train
from repro_torch.models import build_model as tbuild
from repro_torch.optim import adamw as tadamw
from repro_torch.training import (fedavg_pod_params, make_fedavg_pod_step,
                                  make_multipod_train_step, make_train_step)
from repro_torch.training.steps import silo, stack_silos
from test_torch_fl_sync import (KEY, fixed_uuids, one_torch_thread,
                                reference_init)

TOL = 1e-4
WEIGHTED_TOL = 1e-6


def stacked(vals):
    return {"w": torch.stack([torch.full((4, 3), v) for v in vals]),
            "b": torch.stack([torch.full((5,), -v) for v in vals])}


# --- the three checks of tests/test_fedavg_variants.py ---------------------
def test_fedavg_pod_params_mean_and_broadcast():
    p = stacked([1.0, 3.0])
    out = fedavg_pod_params(p)
    assert out["w"].shape == p["w"].shape          # silo dim re-broadcast
    np.testing.assert_allclose(out["w"].numpy(), 2.0)
    np.testing.assert_allclose(out["b"].numpy(), -2.0)


def test_fedavg_pod_params_weighted():
    p = stacked([0.0, 4.0])
    out = fedavg_pod_params(p, weights=torch.tensor([3.0, 1.0]))
    np.testing.assert_allclose(out["w"].numpy(), 1.0)


def test_quantized_fedavg_error_bounded():
    """int8 exchange: error per leaf <= per-silo quantization step."""
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(2, 16, 8)).astype(np.float32)
    step = make_fedavg_pod_step(quantize=True)
    out = step({"w": torch.from_numpy(vals)})["w"].numpy()
    ref = vals.mean(0, keepdims=True)
    max_scale = np.abs(vals).max() / 127.0
    assert np.abs(out - ref).max() <= max_scale + 1e-6
    np.testing.assert_allclose(out[0], out[1])     # both rows identical


# --- twins of the aggregators ----------------------------------------------
def _random_stack(n, seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(n, 32, 24)).astype(np.float32)},
            "b": (rng.normal(size=(n, 40)) * 1e-3).astype(np.float32),
            "s": rng.normal(size=(n,)).astype(np.float32)}


def _twin_leaves(jout, tout):
    return zip(jax.tree.leaves(jax.tree.map(np.asarray, jout)),
               tree.leaves(params_to_numpy(tout)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fedavg_twin_unweighted_is_bitwise(seed):
    p = _random_stack(2, seed)
    jout = jfedavg(jax.tree.map(jnp.asarray, p))
    tout = fedavg_pod_params(params_from_numpy(p, "cpu"))
    for a, b in _twin_leaves(jout, tout):
        assert a.shape == b.shape and np.array_equal(a, b)
        assert np.array_equal(b[0], b[1])


@pytest.mark.parametrize("n", [2, 3, 5])
def test_fedavg_twin_weighted(n):
    p = _random_stack(n, 10 + n)
    w = np.random.default_rng(n).uniform(0.5, 3.0, size=(n,)).astype(
        np.float32)
    jout = jfedavg(jax.tree.map(jnp.asarray, p), weights=jnp.asarray(w))
    tout = fedavg_pod_params(params_from_numpy(p, "cpu"),
                             weights=torch.from_numpy(w))
    for a, b in _twin_leaves(jout, tout):
        np.testing.assert_allclose(b, a, atol=WEIGHTED_TOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantized_fedavg_twin_is_bitwise(seed):
    p = _random_stack(2, 20 + seed)
    jout = jfedavg_step(quantize=True)(jax.tree.map(jnp.asarray, p))
    tout = make_fedavg_pod_step(quantize=True)(params_from_numpy(p, "cpu"))
    for a, b in _twin_leaves(jout, tout):
        assert np.array_equal(a, b)


def test_fedavg_step_without_quantize_is_the_mean():
    assert make_fedavg_pod_step() is fedavg_pod_params


# --- the pod step -------------------------------------------------------
def _reduced():
    return tget("fedforecast-100m").reduced()


def test_pod_step_silo_equals_a_lone_step():
    with one_torch_thread():
        model = tbuild(_reduced(), device="cpu")
        opt = tadamw(3e-4)
        p0 = model.init(model.generator(0))
        p1 = tree.tree_map(lambda a: a + 1e-3, p0)
        params = stack_silos([p0, p1])
        opt_state = stack_silos([opt.init(p0), opt.init(p1)])
        toks = np.random.default_rng(0).integers(
            0, model.cfg.vocab, (2, 2, 16)).astype(np.int32)
        batch = {"tokens": torch.from_numpy(toks)}
        out = make_multipod_train_step(model, opt, 2)(params, opt_state,
                                                      batch)
        lone = make_train_step(model, opt)
        for i in range(2):
            ref = lone(silo(params, i), silo(opt_state, i), silo(batch, i))
            for a, b in zip(tree.leaves(silo(out[0], i)),
                            tree.leaves(ref[0])):
                assert torch.equal(a, b)
            for a, b in zip(tree.leaves(silo(out[1], i)),
                            tree.leaves(ref[1])):
                assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
            assert torch.equal(out[2]["loss"][i], ref[2]["loss"])
        assert not torch.equal(out[2]["loss"][0], out[2]["loss"][1])


def _args(**kw):
    base = dict(mode="pod", arch="fedforecast-100m", silos=3, rounds=3,
                local_steps=5, steps=8, sync_every=4, batch_size=4,
                seq_len=64, lr=3e-4, seed=0, no_secure=False, reduced=True,
                device="cpu")
    return argparse.Namespace(**{**base, **kw})


def reference_pod_loop(args, params):
    """The reference's ``run_pod`` loop (``src/repro/launch/train.py``)
    on one device: the same stacking, step, batches and FedAvg cadence,
    without the host mesh's placement."""
    cfg = jget(args.arch).reduced()
    model = jbuild(cfg)
    opt = jadamw(args.lr)
    opt_state = opt.init(params)
    stack = lambda t: jax.tree.map(lambda a: jnp.stack([a] * 2), t)  # noqa
    params, opt_state = stack(params), stack(opt_state)
    step = jax.jit(jmultipod(model, opt, 2))
    fedavg = jax.jit(jfedavg)
    rng = np.random.default_rng(args.seed)
    losses = []
    for i in range(args.steps):
        toks = np.stack([rng.integers(0, cfg.vocab,
                                      (args.batch_size, args.seq_len)) + 0
                         for _ in range(2)]).astype(np.int32)
        params, opt_state, metrics = step(params, opt_state,
                                          {"tokens": jnp.asarray(toks)})
        if (i + 1) % args.sync_every == 0:
            params = fedavg(params)
        losses.append(np.asarray(metrics["loss"]))
    return params, np.stack(losses)


@functools.lru_cache(maxsize=None)
def pod_twin():
    args = _args()
    init = jax.tree.map(np.asarray, jbuild(jget(args.arch).reduced()).init(
        jax.random.PRNGKey(args.seed)))
    jparams, jlosses = reference_pod_loop(args, jax.tree.map(jnp.asarray,
                                                             init))
    with one_torch_thread():
        out = train.run_pod(args, params_from_numpy(init, "cpu"))
    return jparams, jlosses, out


def test_run_pod_matches_reference_loop():
    jparams, jlosses, out = pod_twin()
    assert out["losses"].shape == jlosses.shape == (8, 2)
    np.testing.assert_allclose(out["losses"], jlosses, atol=TOL, rtol=0)
    for a, b in _twin_leaves(jparams, out["params"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=TOL, rtol=0)


def test_run_pod_ends_on_a_fedavg():
    _, _, out = pod_twin()
    for leaf in tree.leaves(out["params"]):        # synced at step 8
        assert torch.equal(leaf[0], leaf[1])
    # silos saw different batches: their losses differ before a sync
    assert not np.array_equal(out["losses"][:, 0], out["losses"][:, 1])


def test_pod_batches_are_the_reference_draws():
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    got = train.pod_batch(rng_a, 512, 4, 64)
    ref = np.stack([rng_b.integers(0, 512, (4, 64)) + 0
                    for _ in range(2)]).astype(np.int32)
    assert got.dtype == np.int32 and np.array_equal(got, ref)


# --- the sim mode -------------------------------------------------------
def _reference_train_module(monkeypatch):
    """``repro.launch.train`` sets ``XLA_FLAGS`` when it is not set, at
    import; a set (empty) value keeps this process's devices as they
    are."""
    monkeypatch.setenv("XLA_FLAGS", "")
    from repro.launch import train as jtrain
    return jtrain


def test_run_sim_matches_reference(monkeypatch):
    import repro.core
    import repro_torch.core
    jtrain = _reference_train_module(monkeypatch)
    from repro.core import Consortium as JCon
    from repro_torch.core import Consortium as TCon
    monkeypatch.setattr(repro.core, "Consortium",
                        functools.partial(JCon, master_key=KEY))
    monkeypatch.setattr(repro_torch.core, "Consortium",
                        functools.partial(TCon, master_key=KEY))
    args = _args(mode="sim")
    with fixed_uuids(), one_torch_thread():
        jrep = jtrain.run_sim(args)
    with fixed_uuids(), one_torch_thread():
        out = train.run_sim(args, params_from_numpy(reference_init(0),
                                                    "cpu"))
    trep = out["report"]
    assert out["phase"] == "done" and out["chain_ok"]
    assert len(trep["loss_curve"]) == len(jrep["loss_curve"]) == 3
    np.testing.assert_allclose(trep["loss_curve"], jrep["loss_curve"],
                               atol=TOL, rtol=0)
    for a, b in zip(jrep["rounds"], trep["rounds"]):
        assert a["contributions"]["data_size"] == \
            b["contributions"]["data_size"]


@pytest.mark.parametrize("mode", ["sim", "pod"])
def test_main_runs_on_the_cpu(mode, capsys):
    with one_torch_thread():
        out = train.main(["--mode", mode, "--device", "cpu", "--steps", "2",
                          "--sync-every", "2", "--rounds", "1",
                          "--local-steps", "1", "--seq-len", "16"])
    text = capsys.readouterr().out
    if mode == "sim":
        assert out["phase"] == "done" and "metadata chain ok: True" in text
    else:
        assert out["losses"].shape == (2, 2) and "(fedavg)" in text
        assert np.isfinite(out["losses"]).all()


@pytest.mark.parametrize("mode", ["sim", "pod"])
def test_main_needs_cuda_unless_asked_for_cpu(mode):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--mode", mode])
