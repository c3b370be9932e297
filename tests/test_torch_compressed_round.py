"""The port's compressed and secure-int8 planes, as a whole, against the
JAX package, on the 2-layer reduced ``fedforecast-100m``.

Both packages start from the same numpy trees: the reference's init and
3 silos' "trained" params (init plus seeded noise; the train step's twin
is held by ``test_torch_round.py``, and deltas that differed by 1e-7
would flip stochastic roundings). Each side then composes its own
functions the way the reference's client and server do:

1. a secure int8 round: ``pack_delta``, ``ErrorFeedback.step_masked``
   pre-scaled by n_examples / (steps * batch) against the sorted cohort;
   ``solarx`` drops after masking; the survivors' ``int_repair_correction``
   fold into ``ModularSink`` beside their residue streams; the decoded
   sum is divided by the survivors' scaled weight and added to the base;
2. an int8 round from that global over the same deltas:
   ``ErrorFeedback.step``, ``QuantSink`` weighted by raw example counts,
   divided by the total weight, added to the round-1 global.

The decoded sums are bitwise equal (and equal ``float32(sum q) * grid``
of the fixed-grid plain twin); the int8 means agree within 1e-5; the new
globals within 1e-4 (the repo's twin rule).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as jget
from repro.core import compression as jc
from repro.core import secure_agg as jsa
from repro.core import streaming as jstream
from repro.core.packing import PackedLayout as JLayout
from repro.core.packing import unpack_pytree as junpack
from repro.core.protocol import pack_delta as jdelta
from repro.models import build_model as jbuild
from repro_torch import tree
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import compression as tc
from repro_torch.core import secure_agg as tsa
from repro_torch.core import streaming as tstream
from repro_torch.core.packing import PackedLayout as TLayout
from repro_torch.core.packing import unpack_pytree as tunpack
from repro_torch.core.protocol import pack_delta as tdelta
from repro_torch.kernels.compressed_agg import ops as cops

COHORT = ["windco", "solarx", "gridpower"]
DROPPED = "solarx"
SIZES = {"windco": 8, "solarx": 4, "gridpower": 6}   # n_examples
UNIT = 4                                             # steps * batch
SECRET = b"compressed-round-secret"
TINY = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=250)


def _np_add(a, b):
    return jax.tree.map(lambda x, y: (np.asarray(x, np.float32)
                                      + np.asarray(y, np.float32)), a, b)


def _jax_rounds(init, trained):
    cohort = sorted(COHORT)
    layout = JLayout.for_tree(init)
    survivors = [c for c in COHORT if c != DROPPED]
    # round 1: secure int8 + integer repair
    msgs, deltas = {}, {}
    for i, c in enumerate(COHORT):
        deltas[c] = jdelta(trained[c], init)
        ef = jc.ErrorFeedback("int8", seed=i)
        w = SIZES[c] / UNIT
        msgs[c] = ef.step_masked(deltas[c], weight=w, client_id=c,
                                 cohort=cohort, pair_secret=SECRET)
    mbits, grid = msgs[COHORT[0]]["mbits"], msgs[COHORT[0]]["grid"]
    t = layout.total_size
    tp = t + (-t) % 1024
    sink = jstream.ModularSink(t, mbits=mbits, grid=grid, mesh=None)
    for c in survivors:
        sink.fold(msgs[c]["z"])
        sink.fold_correction(np.asarray(jsa.int_repair_correction(
            tp, c, [DROPPED], SECRET, mbits)))
    total = sink.finalize()
    denom = sum(SIZES[c] for c in survivors) / UNIT
    g1 = _np_add(init, junpack(total / np.float32(denom), layout))
    # round 2: int8 over the same deltas, from the new global
    qsink = jstream.QuantSink(t, mesh=None)
    for i, c in enumerate(COHORT):
        ef = jc.ErrorFeedback("int8", seed=10 + i)
        msg = ef.step(deltas[c])
        qsink.fold(c, jc.quantized_values(msg), msg["scales"], SIZES[c])
    mean = qsink.finalize() / np.float32(qsink.total_weight)
    g2 = _np_add(g1, junpack(mean, layout))
    return {"deltas": deltas, "msgs": msgs, "total": total, "mean": mean,
            "g1": g1, "g2": g2, "norms": dict(qsink.norms)}


def _port_rounds(init, trained):
    cohort = sorted(COHORT)
    init_t = params_from_numpy(init, "cpu")
    trained_t = {c: params_from_numpy(p, "cpu") for c, p in trained.items()}
    layout = TLayout.for_tree(init_t)
    survivors = [c for c in COHORT if c != DROPPED]
    msgs, deltas, twin = {}, {}, {}
    for i, c in enumerate(COHORT):
        deltas[c] = tdelta(trained_t[c], init_t)
        ef = tc.ErrorFeedback("int8", seed=i, device="cpu")
        w = SIZES[c] / UNIT
        msgs[c] = ef.step_masked(deltas[c], weight=w, client_id=c,
                                 cohort=cohort, pair_secret=SECRET)
        twin[c] = tc.quantized_values(tc.compress(
            w * deltas[c].numpy(), "int8", grid=ef.grid,
            rng=np.random.default_rng(i)))
    mbits, grid = msgs[COHORT[0]]["mbits"], msgs[COHORT[0]]["grid"]
    t = layout.total_size
    tp = t + (-t) % 1024
    sink = tstream.ModularSink(t, mbits=mbits, grid=grid, device="cpu")
    corr = {c: tsa.int_repair_correction(tp, c, [DROPPED], SECRET, mbits,
                                         device="cpu") for c in survivors}
    for c in survivors:
        sink.fold(msgs[c]["z"])
        sink.fold_correction(corr[c])
    total = sink.finalize()
    stacked = cops.masked_dequant_reduce(
        torch.stack([tsa.u32_bits(msgs[c]["z"]) for c in survivors]),
        torch.full((tp // 1024,), grid, dtype=torch.float32),
        modulus_bits=mbits,
        corr=torch.stack([corr[c] for c in survivors]))[:t]
    denom = sum(SIZES[c] for c in survivors) / UNIT
    mean_delta = tunpack(total / np.float32(denom), layout)
    g1_t = _tadd(init_t, mean_delta)
    g1 = params_to_numpy(g1_t)
    qsink = tstream.QuantSink(t, device="cpu")
    for i, c in enumerate(COHORT):
        ef = tc.ErrorFeedback("int8", seed=10 + i)
        msg = ef.step(deltas[c])
        qsink.fold(c, tc.quantized_values(msg), msg["scales"], SIZES[c])
    mean = qsink.finalize() / np.float32(qsink.total_weight)
    g2 = params_to_numpy(_tadd(g1_t, tunpack(mean, layout)))
    twin_sum = np.float32(sum(twin[c].astype(np.int64)
                              for c in survivors)) * np.float32(grid)
    return {"deltas": deltas, "msgs": msgs, "total": total,
            "stacked": stacked, "twin_sum": twin_sum, "mean": mean,
            "g1": g1, "g2": g2, "norms": dict(qsink.norms)}


def _tadd(a, b):
    return tree.tree_map(lambda x, y: x.to(torch.float32)
                         + y.to(torch.float32), a, b)


@pytest.fixture(scope="module")
def rounds():
    cfg = dataclasses.replace(jget("fedforecast-100m").reduced(), **TINY)
    init = jax.tree.map(np.asarray, jbuild(cfg).init(jax.random.PRNGKey(5)))
    rng = np.random.default_rng(11)
    trained = {c: jax.tree.map(
        lambda p: (np.asarray(p, np.float32) + rng.normal(
            scale=1e-3, size=np.shape(p)).astype(np.float32)), init)
        for c in COHORT}
    before = dict(cops.LAUNCHES)
    out = {"jax": _jax_rounds(init, trained),
           "port": _port_rounds(init, trained)}
    out["launches_moved"] = cops.LAUNCHES != before
    return out


def _assert_wire_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes(), k
        else:
            assert a[k] == b[k], k


def test_deltas_and_wire_dicts_bitwise(rounds):
    for c in COHORT:
        np.testing.assert_array_equal(rounds["port"]["deltas"][c].numpy(),
                                      rounds["jax"]["deltas"][c])
        _assert_wire_equal(rounds["port"]["msgs"][c], rounds["jax"]["msgs"][c])
    assert rounds["port"]["msgs"]["windco"]["mbits"] == 16


def test_secure_int8_repair_decodes_bitwise(rounds):
    p, j = rounds["port"], rounds["jax"]
    total = p["total"].numpy()
    np.testing.assert_array_equal(total.view(np.uint32),
                                  j["total"].view(np.uint32))
    np.testing.assert_array_equal(p["stacked"].numpy().view(np.uint32),
                                  total.view(np.uint32))
    np.testing.assert_array_equal(total.view(np.uint32),
                                  p["twin_sum"].view(np.uint32))


def test_int8_round_means_and_norms_agree(rounds):
    p, j = rounds["port"], rounds["jax"]
    np.testing.assert_allclose(p["mean"].numpy(), j["mean"], atol=1e-5)
    for c in COHORT:
        np.testing.assert_allclose(p["norms"][c], j["norms"][c], rtol=1e-6)


@pytest.mark.parametrize("key", ["g1", "g2"])
def test_new_globals_agree(rounds, key):
    p, j = rounds["port"][key], rounds["jax"][key]
    jl, pl = jax.tree.leaves(j), jax.tree.leaves(p)
    assert len(jl) == len(pl)
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)


def test_cpu_rounds_launch_no_kernel(rounds):
    assert not rounds["launches_moved"]
