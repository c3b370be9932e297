"""The port's async buffered (FedBuff) protocol against the JAX package,
on the CPU.

* ``staleness_weight`` and ``fold_weights`` equal the reference's over a
  grid of staleness values; the weights of a commit are positive and sum
  to 1 (a hypothesis property, as ``tests/test_protocol.py`` states it).
* Whole ``Consortium`` runs (ids, keys, init and data as in
  ``run_twin`` of ``test_torch_fl_sync.py``) of 3 silos polling at
  cadences 1, 2 and 3 (``tick_every``), so that some folds are stale:
  3 commits of 2 folds each, then the final evaluate, deploy and a
  ``predict``. Plain and int8 planes. The commit history (folds, the
  staleness of each fold, the provenance weights) equals the
  reference's, every committed global within 1e-4 (the repo's twin
  rule; on the int8 plane on all but 0.01 % of the coordinates, where a
  stochastic rounding flip is held to 1e-3). Each committed global is
  bitwise equal to a numpy recomputation of the reference's fold from
  the messages the port's server collected: ``buffer + w * delta`` with
  w rounded to f32, then ``buffer / float32(weight)`` and the leaf add.
* The port versions of the reference's async checks
  (``tests/test_protocol.py``): the serve phase's wake condition watches
  overwrites, job creation rejects secure / robust / hyperparameter
  search / unknown protocols, a pause after the commit budget resumes
  into evaluate (no over-commit), a mid-serve pause resumes serving.
"""
import numpy as np
import pytest

import jax

from repro.core import protocol as jprotocol
from repro.core.packing import PackedLayout as JLayout
from repro.core.packing import unpack_pytree as junpack
from repro.core.compression import decompress as jdecompress
from repro_torch.convert import params_to_numpy
from repro_torch.core import Consortium, make_protocol
from repro_torch.core import protocol as tprotocol
from repro_torch.data.synthetic import make_silo_datasets
from test_torch_fl_sync import (ORGS, SEQ, TOL, VOCAB, assert_trees_close,
                                leaves, one_torch_thread, pairs, run_twin)

# with cadences 1/2/3 and a buffer of 2, the first two commits fold only
# fresh updates; the third folds two that trained on commit 1 (tau 1)
ASYNC = {"protocol": "async_buff", "secure_aggregation": False,
         "async_buffer_size": 2, "rounds": 3}
CADENCES = (1, 2, 3)
PLANES = {"plain": {}, "int8": {"compression": "int8"}}
# int8's stochastic rounding flips a coordinate by one quantization step
# where a rounding-level difference of the trained delta crosses its
# threshold (1 of 131,072 coordinates of a leaf moved by 2.2e-4: an
# async fold weighs a silo 0.5, where a sync round weighs it 1/3); the
# budget of test_torch_fl_planes.py's top-k run
FLIP_SHARE, FLIP_TOL = 1e-4, 1e-3
TAUS = [[0], [0, 0], [0, 1, 3], [7, 2, 0, 0, 1], list(range(40)),
        [1000, 0]]


# ---------------------------------------------------------------------------
# staleness weights
# ---------------------------------------------------------------------------
def test_staleness_weight_matches_reference():
    for tau in list(range(64)) + [100, 999, 10 ** 6, 2.5]:
        assert tprotocol.staleness_weight(tau) \
            == jprotocol.staleness_weight(tau)
    assert tprotocol.staleness_weight(0) == 1.0
    assert tprotocol.staleness_weight(3) == pytest.approx(0.5)
    assert tprotocol.STALENESS_ALPHA == jprotocol.STALENESS_ALPHA


@pytest.mark.parametrize("taus", TAUS, ids=lambda t: f"n{len(t)}")
def test_fold_weights_match_reference(taus):
    ws = tprotocol.fold_weights(taus)
    assert ws == jprotocol.fold_weights(taus)
    assert all(w > 0 for w in ws) and abs(sum(ws) - 1.0) <= 1e-12


def test_fold_weights_positive_and_commit_normalized():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=100, deadline=None)
    @given(st.lists(st.integers(0, 1000), min_size=1, max_size=32))
    def check(taus):
        raws = [tprotocol.staleness_weight(t) for t in taus]
        assert all(0 < w <= 1.0 for w in raws)
        norm = tprotocol.fold_weights(taus)
        assert all(w > 0 for w in norm)
        assert abs(sum(norm) - 1.0) <= 1e-9
        by_tau = sorted(zip(taus, norm))
        assert all(a[1] >= b[1] - 1e-12 for a, b in zip(by_tau, by_tau[1:]))

    check()


# ---------------------------------------------------------------------------
# whole async runs against the reference
# ---------------------------------------------------------------------------
def _capture_folds(con):
    """Wrap the server's ``comm.collect``: the async updates it collects,
    in fold order."""
    folds = []
    collect = con.server.comm.collect

    def spy(path, cid):
        msg = collect(path, cid)
        if "/async/update/" in path:
            folds.append(msg)
        return msg
    con.server.comm.collect = spy
    return folds


@pytest.fixture(scope="module", params=sorted(PLANES))
def twin(request):
    """``{side: (consortium, phase, folded messages)}``."""
    runs = {}
    for side in ("jax", "port"):
        folds = []
        con, phase = run_twin(
            side, {**ASYNC, **PLANES[request.param]}, cadences=CADENCES,
            before_run=lambda c: folds.extend([_capture_folds(c)]))
        runs[side] = (con, phase, folds[0])
    return request.param, runs


def _commits(con):
    return [(c["details"]["folds"], c["details"]["staleness"],
             c["details"]["weights"])
            for c in con.server.metadata.query(operation="async_commit")]


def test_async_run_matches_reference(twin):
    name, runs = twin
    (jcon, jphase, _), (tcon, tphase, _) = runs["jax"], runs["port"]
    assert jphase == tphase == "done"
    assert _commits(tcon) == _commits(jcon)
    assert len(_commits(tcon)) == ASYNC["rounds"]
    taus = [t for _, ts, _ in _commits(tcon) for t in ts]
    assert any(t > 0 for t in taus), "cadences 1/2/3 gave no stale fold"
    jh, th = jcon.server.run.history, tcon.server.run.history
    assert [h["round"] for h in th] == [h["round"] for h in jh] == [0, 1, 2]
    for a, b in zip(jh, th):
        assert a["folds"] == b["folds"]
        assert a["mean_staleness"] == b["mean_staleness"]
        assert abs(a["mean_train_loss"] - b["mean_train_loss"]) <= TOL
        diff = np.concatenate([
            np.abs(x - y).ravel() for x, y in zip(
                leaves(jcon.server.store.get(a["digest"])),
                leaves(tcon.server.store.get(b["digest"])))])
        if name == "plain":
            assert diff.max() <= TOL
        else:
            assert (diff > TOL).mean() <= FLIP_SHARE
            assert diff.max() <= FLIP_TOL
    assert abs(jh[-1]["mean_eval_loss"] - th[-1]["mean_eval_loss"]) <= TOL
    assert pairs(tcon.server.metadata) == pairs(jcon.server.metadata)
    for jn, tn in zip(jcon.nodes, tcon.nodes):
        assert pairs(tn.metadata) == pairs(jn.metadata)
    assert tcon.server.metadata.verify_chain()
    rounds = tcon.server.metadata.query(kind="experiment", event="round")
    assert [r["contributions"]["data_size"] for r in rounds] == [
        r["contributions"]["data_size"] for r in
        jcon.server.metadata.query(kind="experiment", event="round")]


def test_async_deploys_and_predicts(twin):
    name, runs = twin
    jcon, tcon = runs["jax"][0], runs["port"][0]
    r = tcon.server.run
    rel = tcon.nodes[0].comm.fetch(f"runs/{tcon.run_id}/release",
                                   broadcast=True)
    assert rel["digest"] == r.history[-1]["digest"]
    # the run ends when the server is done; a silo deploys on its next
    # poll, so the slow silos may not have polled yet
    assert [n.deployed_digest is None for n in tcon.nodes] == [
        n.deployed_digest is None for n in jcon.nodes]
    assert tcon.nodes[0].deployed_digest not in (None, "rejected")
    for jn, tn in zip(jcon.nodes, tcon.nodes):
        if tn.deployed_params is not None:
            assert_trees_close(jn.deployed_params, tn.deployed_params,
                               TOL if name == "plain" else FLIP_TOL)
    prompt = np.random.default_rng(5).integers(0, VOCAB, (2, 12)).astype(
        np.int32)
    out = tcon.nodes[0].predict(prompt, n_steps=4)
    assert out.shape == (2, 4) and 0 <= out.min() and out.max() < VOCAB
    np.testing.assert_array_equal(out, jcon.nodes[0].predict(prompt, 4))


def test_async_commit_is_the_numpy_fold_bitwise(twin):
    """The reference's fold and commit, in numpy, over the messages the
    port's server folded (on the int8 plane their deltas decompressed by
    the reference's ``decompress``): equal bit for bit, since the
    commit's outer step is fedavg, the identity."""
    name, runs = twin
    tcon, _, folds = runs["port"]
    size = ASYNC["async_buffer_size"]
    hist = tcon.server.run.history
    assert len(folds) == size * len(hist)
    old = params_to_numpy(tcon.server.store.get(tcon.server.run.init_digest))
    for c, h in enumerate(hist):
        buffer, weight = None, 0.0
        for msg in folds[c * size:(c + 1) * size]:
            w = jprotocol.staleness_weight(max(0, c - msg["base_commit"]))
            delta = (jdecompress(msg["comp"]) if name == "int8"
                     else np.asarray(msg["delta"], np.float32))
            buffer = w * delta if buffer is None else buffer + w * delta
            weight += w
        mean = junpack(buffer / np.float32(weight), JLayout.for_tree(old))
        want = jax.tree.map(lambda p, d: np.asarray(p, np.float32)
                            + np.asarray(d, np.float32).reshape(p.shape),
                            old, mean)
        got = params_to_numpy(tcon.server.store.get(h["digest"]))
        for x, y in zip(leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(x, y)
        old = got


# ---------------------------------------------------------------------------
# the reference's async checks, on the port
# ---------------------------------------------------------------------------
def _consortium(orgs, decisions):
    con = Consortium(orgs, seed=0, device="cpu")
    contract = con.negotiate({"arch": "fedforecast-100m", "rounds": 1,
                              "local_steps": 1, "batch_size": 2, "lr": 1e-3,
                              "data_schema": None, **decisions})
    job = con.server.job_creator.from_contract(contract)
    con.start(job, make_silo_datasets(len(orgs), vocab=512, seq_len=32))
    return con


def _step_until(con, done, passes=300):
    with one_torch_thread():
        for _ in range(passes):
            con.scheduler.step()
            if done(con.server.run):
                return


def test_async_protocol_is_registered():
    proto = make_protocol("async_buff")
    assert isinstance(proto, tprotocol.AsyncBuffProtocol)
    assert list(proto.phases) == list(
        jprotocol.make_protocol("async_buff").phases)
    assert tprotocol.PROTOCOLS.keys() == jprotocol.PROTOCOLS.keys()


def test_wake_condition_async_watches_overwrites():
    con = _consortium(["u", "v"], ASYNC)
    server = con.server
    _step_until(con, lambda r: r.phase == "async_serve")
    assert server.run.phase == "async_serve"
    wake = server.wake_condition()
    assert not wake.poll
    assert set(wake.paths) == {f"runs/{con.run_id}/async/update/{cid}"
                               for cid in server.run.cohort}
    with one_torch_thread():
        assert con.run_to_completion() == "done"


def test_async_rejects_secure_and_robust_and_hp():
    con = Consortium(["a", "b"], seed=0, device="cpu")
    jc = con.server.job_creator
    base = {"arch": "fedforecast-100m", "rounds": 1, "local_steps": 1,
            "batch_size": 2, "data_schema": None, "protocol": "async_buff"}
    for extra, what in (
            ({"secure_aggregation": True}, "secure_aggregation"),
            ({"secure_aggregation": False, "aggregation": "median"},
             "aggregation"),
            ({"secure_aggregation": False, "hyperparameter_search":
              {"parameter": "lr", "values": [1e-3]}}, "hyperparameter"),
            ({"protocol": "gossip", "secure_aggregation": False},
             "unknown protocol")):
        with pytest.raises(ValueError, match=what):
            jc.from_admin("admin", {**base, **extra})


def test_async_resume_after_budget_does_not_overcommit():
    con = _consortium(["a", "b"], ASYNC)
    server = con.server
    _step_until(con, lambda r: r.phase == "evaluate")
    assert server.run.phase == "evaluate" and server.run.round == 3
    server.pause("operator", "paused during final evaluate")
    server.admin_resume("operator")
    assert server.run.phase == "evaluate"        # NOT async_serve
    con.scheduler.reactivate(con.run_id)
    with one_torch_thread():
        assert con.run_to_completion() == "done"
    assert server.run.round == 3
    assert [h["round"] for h in server.run.history] == [0, 1, 2]


def test_async_pause_resume_keeps_serving():
    con = _consortium(["a", "b"], ASYNC)
    server = con.server
    _step_until(con, lambda r: bool(r.history))
    server.pause("operator", "maintenance window")
    assert server.run.phase == "paused"
    server.admin_resume("operator")
    assert server.run.phase == "async_serve"
    con.scheduler.reactivate(con.run_id)
    with one_torch_thread():
        assert con.run_to_completion() == "done"
    assert server.run.round == 3
    assert all(n.deployed_params is not None for n in con.nodes)
