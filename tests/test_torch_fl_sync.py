"""The port's FL-APU sync run end to end against the JAX package.

The reference ``repro.core.Consortium`` and the port's ``Consortium``
(``device="cpu"``) each negotiate the same contract, create the job and
run it to completion over 3 silos: reduced ``fedforecast-100m``, 2 secure
rounds of 2 AdamW steps, batch 4 x 32, lr 3e-4 (the repo's rate, at
which Adam's amplification of rounding stays inside the twin rule). Both
sides share the master key, and ``uuid.uuid4`` is made deterministic
during each run, so client ids, pair secrets and with them the pairwise
masks are identical. The port's server gets the reference's initial
global, computed as ``core/server.py:140,198-200`` does and converted
through numpy; the silos draw identical batches from their own copy of
the synthetic data.

The two runs agree on the terminal phase, the per-round train and eval
losses, every committed global and the personalized deployed params
within 1e-4 (the repo's twin rule), the ``data_size`` contributions
exactly, the provenance trail's ``(operation, outcome)`` sequence, and
the first prefill logits of ``predict``; both hash chains verify.

``run_twin`` and the ``assert_*`` helpers are shared with the other
``test_torch_fl_*`` files.
"""
import contextlib
import functools
import hashlib
import itertools
import uuid

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as jget
from repro.core import Consortium as JConsortium
from repro.data.synthetic import make_silo_datasets as jdata
from repro.models import build_model as jbuild
from repro_torch import tree
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import Consortium as TConsortium
from repro_torch.data.synthetic import make_silo_datasets as tdata

ORGS = ["windco", "solarx", "gridpower"]
KEY = hashlib.sha256(b"fl twin master key").digest()
VOCAB, SEQ = 512, 32
BASE = {"arch": "fedforecast-100m", "rounds": 2, "local_steps": 2,
        "batch_size": 4, "lr": 3e-4, "secure_aggregation": True,
        "data_schema": {"vocab": VOCAB, "seq_len": SEQ}}
TOL = 1e-4


@contextlib.contextmanager
def one_torch_thread():
    """The twin runs are small and the suite runs several workers at
    once: torch's intra-op pool on every core of every worker
    oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@contextlib.contextmanager
def fixed_uuids():
    """``uuid.uuid4`` counts from 1 in its leading hex digits (ids take
    ``hex[:8]``), so both packages mint the same ids in the same order."""
    n = itertools.count(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(n) << 96))
        yield


@functools.lru_cache(maxsize=None)
def reference_init(seed: int = 0):
    """The reference server's first initial global, as numpy."""
    model = jbuild(jget("fedforecast-100m").reduced())
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    return jax.tree.map(np.asarray, model.init(key))


def run_twin(side: str, decisions: dict, *, orgs=ORGS, drop_at=None,
             seed: int = 0, client_config=None, cadences=None,
             before_run=None):
    """Negotiate ``BASE`` updated by ``decisions``, start and run to the
    end on one side ("jax" or "port"). ``cadences`` registers the silos
    polling every k-th scheduler pass (``tick_every``); ``before_run(con)``
    runs between start and run. Returns ``(consortium, phase)``."""
    with fixed_uuids(), one_torch_thread():
        if side == "jax":
            con = JConsortium(orgs, seed=seed, master_key=KEY)
            data = jdata
        else:
            con = TConsortium(orgs, seed=seed, master_key=KEY, device="cpu",
                              initial_params=params_from_numpy(
                                  reference_init(seed), "cpu"))
            data = tdata
        contract = con.negotiate({**BASE, **decisions})
        job = con.server.job_creator.from_contract(contract)
        datasets = data(len(orgs), vocab=VOCAB, seq_len=SEQ, seed=1)
        for org, ds, k in zip(orgs, datasets, cadences or ()):
            con.scheduler.register_agent(con.client_ids[org], ds,
                                         config=client_config, tick_every=k)
        con.start(job, datasets, client_config=client_config)
        if before_run is not None:
            before_run(con)
        phase = con.run_to_completion(drop_at=drop_at)
    return con, phase


def pairs(metadata) -> list:
    return [(r["operation"], r["outcome"])
            for r in metadata.query(kind="provenance")]


def leaves(params) -> list:
    if any(isinstance(x, torch.Tensor) for x in tree.leaves(params)):
        params = params_to_numpy(params)
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(params)]


def assert_trees_close(a, b, tol=TOL):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x, y, atol=tol, rtol=0)


def assert_runs_match(jcon, tcon, tol=TOL):
    """Histories, committed globals and the provenance trail."""
    jh, th = jcon.server.run.history, tcon.server.run.history
    assert [(h["round"], h["hp_index"]) for h in jh] == \
        [(h["round"], h["hp_index"]) for h in th]
    for a, b in zip(jh, th):
        assert sorted(a["train_losses"]) == sorted(b["train_losses"])
        for cid in a["train_losses"]:
            assert abs(a["train_losses"][cid] - b["train_losses"][cid]) \
                <= tol
        assert abs(a["mean_train_loss"] - b["mean_train_loss"]) <= tol
        assert ("mean_eval_loss" in a) == ("mean_eval_loss" in b)
        if "mean_eval_loss" in a:
            assert abs(a["mean_eval_loss"] - b["mean_eval_loss"]) <= tol
        assert_trees_close(jcon.server.store.get(a["digest"]),
                           tcon.server.store.get(b["digest"]), tol)
    assert jcon.server.run.dropped == tcon.server.run.dropped
    assert jcon.server.run.cohort == tcon.server.run.cohort
    assert pairs(jcon.server.metadata) == pairs(tcon.server.metadata)
    for jn, tn in zip(jcon.nodes, tcon.nodes):
        assert pairs(jn.metadata) == pairs(tn.metadata)
    assert jcon.server.metadata.verify_chain()
    assert tcon.server.metadata.verify_chain()


def assert_contributions_match(jcon, tcon, *, secure: bool):
    """Per round: ``data_size`` shares exact; ``update_norm`` shares
    within 1e-4, and none on a secure plane (the server never sees a
    plain update)."""
    def rounds(con):
        return con.server.metadata.query(kind="experiment", event="round")
    jr, tr = rounds(jcon), rounds(tcon)
    assert len(jr) == len(tr)
    for a, b in zip(jr, tr):
        ja, tb = a["contributions"], b["contributions"]
        assert ja["data_size"] == tb["data_size"]
        assert sorted(ja["update_norm"]) == sorted(tb["update_norm"])
        assert (not tb["update_norm"]) == secure
        for cid, share in ja["update_norm"].items():
            assert abs(share - tb["update_norm"][cid]) <= TOL


@pytest.fixture(scope="module")
def twin():
    return {side: run_twin(side, {}) for side in ("jax", "port")}


def test_sync_run_ends_done_on_both_sides(twin):
    (jcon, jphase), (tcon, tphase) = twin["jax"], twin["port"]
    assert jphase == tphase == "done"
    assert len(tcon.server.run.history) == BASE["rounds"]
    assert tcon.server.run.init_digest == jcon.server.run.init_digest


def test_sync_run_matches_reference(twin):
    assert_runs_match(twin["jax"][0], twin["port"][0])


def test_contributions_match_reference(twin):
    assert_contributions_match(twin["jax"][0], twin["port"][0], secure=True)


@pytest.mark.parametrize("org", ORGS)
def test_personalized_deploy_matches_reference(twin, org):
    jcon, tcon = twin["jax"][0], twin["port"][0]
    jn = jcon.nodes[jcon.organizations.index(org)]
    tn = tcon.nodes[tcon.organizations.index(org)]
    assert jn.deployed_digest not in (None, "rejected")
    assert tn.deployed_digest not in (None, "rejected")
    assert_trees_close(jn.deployed_params, tn.deployed_params)


def test_predict_matches_reference(twin):
    jn, tn = twin["jax"][0].nodes[0], twin["port"][0].nodes[0]
    prompt = np.random.default_rng(3).integers(0, VOCAB, (2, 12)).astype(
        np.int32)
    cache_len = tn.model.cache_len_for(12 + 4)
    jl, _ = jn.model.prefill(jn.deployed_params, {"tokens": prompt},
                             cache_len)
    with torch.no_grad():
        tl, _ = tn.model.prefill(tn.deployed_params,
                                 {"tokens": torch.from_numpy(prompt)},
                                 cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    out = tn.predict(prompt, n_steps=4)
    assert out.shape == (2, 4) and out.dtype == np.int32
    assert out.min() >= 0 and out.max() < VOCAB
    np.testing.assert_array_equal(out, jn.predict(prompt, n_steps=4))
