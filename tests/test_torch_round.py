"""The port's data plane of one secure FedAvg round, as a whole, against
the JAX package.

Each side composes its own functions the way ``core/client.py`` and
``core/server.py`` do on the main path: 3 silos train ``local_steps``
AdamW steps from the global, pre-scale by n_examples/(steps*batch), pack
and mask against the sorted cohort; the server folds the masked buffers
into ``MaskedF32Sink``, finalizes, divides by the survivors' scaled
weight, unpacks and takes the ``fedavg`` outer step. Round 2 drops one
silo after masking and repairs through the streamed corrections. Both
sides start from the reference's init (converted through numpy) and
draw identical batches from their own copy of the synthetic data. The
final globals agree within 1e-4 (the repo's twin rule).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.core import secure_agg as jsa
from repro.core import streaming as jstream
from repro.core.packing import pack_pytree as jpack
from repro.core.packing import unpack_pytree as junpack
from repro.data.synthetic import make_silo_datasets as jdata
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.optim import fedavg as jfedavg
from repro.training import make_train_step as jstep
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import secure_agg as tsa
from repro_torch.core import streaming as tstream
from repro_torch.core.packing import pack_pytree as tpack
from repro_torch.core.packing import unpack_pytree as tunpack
from repro_torch.data.synthetic import make_silo_datasets as tdata
from repro_torch.kernels.secure_agg import ops
from repro_torch.models import build_model as tbuild
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import fedavg as tfedavg
from repro_torch.training import make_train_step as tstep

COHORT = ["gridpower", "solarx", "windco"]
SECRET = b"round-secret"
STEPS, BATCH, LR = 2, 2, 3e-4
TINY = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=250)


def _jax_round(model, step, opt, params, data, dropped=None):
    masked, plain = {}, {}
    for cid, ds in zip(COHORT, data):
        p, o = params, opt.init(params)
        for _ in range(STEPS):
            p, o, _ = step(p, o, {"tokens": jnp.asarray(
                ds.batch(BATCH)["tokens"])})
        weight = (STEPS * BATCH) / float(STEPS * BATCH)
        buf, layout = jpack(p)
        plain[cid] = np.asarray(buf)
        masked[cid] = np.asarray(jsa.mask_packed(
            buf * jnp.float32(weight), cid, sorted(COHORT), SECRET))
    survivors = [c for c in COHORT if c != dropped]
    sink = jstream.MaskedF32Sink(layout.total_size, mesh=None)
    for c in survivors:
        sink.fold(masked[c], 1.0)
    if dropped:
        for c in survivors:
            sink.fold_correction(np.asarray(jsa.repair_correction(
                layout.total_size, c, [dropped], SECRET)))
    denom = float(len(survivors) * STEPS * BATCH) / float(STEPS * BATCH)
    agg = junpack(sink.finalize() / denom, layout)
    new, _ = jfedavg().step(params, agg, {})
    return new, np.mean([plain[c] for c in survivors], axis=0)


def _port_round(model, step, opt, params, data, dropped=None):
    masked, plain = {}, {}
    for cid, ds in zip(COHORT, data):
        p, o = params, opt.init(params)
        for _ in range(STEPS):
            p, o, _ = step(p, o, ds.batch(BATCH))
        weight = (STEPS * BATCH) / float(STEPS * BATCH)
        buf, layout = tpack(p)
        plain[cid] = buf
        masked[cid] = tsa.mask_packed(buf * weight, cid, sorted(COHORT),
                                      SECRET, device="cpu")
    survivors = [c for c in COHORT if c != dropped]
    sink = tstream.MaskedF32Sink(layout.total_size, device="cpu")
    for c in survivors:
        sink.fold(masked[c], 1.0)
    if dropped:
        for c in survivors:
            sink.fold_correction(tsa.repair_correction(
                layout.total_size, c, [dropped], SECRET, device="cpu"))
    denom = float(len(survivors) * STEPS * BATCH) / float(STEPS * BATCH)
    total = sink.finalize() / denom
    agg = tunpack(total, layout)
    new, _ = tfedavg().step(params, agg, {})
    mean_plain = torch.stack([plain[c] for c in survivors]).mean(0)
    return new, total, mean_plain


@pytest.fixture(scope="module")
def rounds():
    ch = dict(TINY)
    jcfg = dataclasses.replace(jget("fedforecast-100m").reduced(), **ch)
    tcfg = dataclasses.replace(tget("fedforecast-100m").reduced(), **ch)
    jm, tm = jbuild(jcfg), tbuild(tcfg, device="cpu")
    jopt, topt = jadamw(LR, weight_decay=0.0), tadamw(LR, weight_decay=0.0)
    jtrain, ttrain = jax.jit(jstep(jm, jopt)), tstep(tm, topt)
    jp = jm.init(jax.random.PRNGKey(5))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jds = jdata(3, vocab=jcfg.vocab, seq_len=32, seed=1)
    tds = tdata(3, vocab=tcfg.vocab, seq_len=32, seed=1)
    ops.reset_launches()
    out = {"jax": [], "port": []}
    for dropped in (None, "solarx"):
        jp, jmean = _jax_round(jm, jtrain, jopt, jp, jds, dropped)
        tp, ttotal, tmean = _port_round(tm, ttrain, topt, tp, tds, dropped)
        out["jax"].append((jp, jmean))
        out["port"].append((tp, ttotal, tmean))
    return out


@pytest.mark.parametrize("rnd", [0, 1], ids=["secure", "repair"])
def test_round_globals_match_jax(rounds, rnd):
    jp, _ = rounds["jax"][rnd]
    tp, _, _ = rounds["port"][rnd]
    for a, b in zip(jax.tree.leaves(jp),
                    jax.tree.leaves(params_to_numpy(tp))):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-4)


@pytest.mark.parametrize("rnd", [0, 1], ids=["secure", "repair"])
def test_masks_cancel_to_plain_mean(rounds, rnd):
    _, total, mean_plain = rounds["port"][rnd]
    np.testing.assert_allclose(total.numpy(), mean_plain.numpy(), atol=1e-6)
    _, jmean = rounds["jax"][rnd]
    np.testing.assert_allclose(mean_plain.numpy(), jmean, atol=1e-4)


def test_cpu_round_launches_no_kernel(rounds):
    assert {"masked_sum", "masked_sum_corrected"} <= set(ops.LAUNCHES)
    assert set(ops.LAUNCHES.values()) == {0}
