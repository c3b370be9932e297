"""The port's plain and top-k planes through its server and client,
against the JAX package, in full ``Consortium`` runs (``run_twin`` of
``test_torch_fl_sync.py``: identical ids, keys, init and data), secure
aggregation off.

* ``fedavg`` (3 silos) and ``median`` (4 silos, so the even-cohort
  midpoint rule is exercised; ROADMAP queue C): the server keeps the
  posted pytrees and aggregates them at commit; every committed global
  within 1e-4, the contributions' shares too.
* ``topk``: the clients post (index, value) wire dicts with error
  feedback, the server scatter-adds them into ``TopkSink``. At ratio 1.0
  every committed global is within 1e-4. At the default ratio 0.1 the
  selection is discontinuous: where a coordinate's |delta| sits at a
  silo's top-k threshold, a rounding-level difference between the two
  trainings decides whether it is sent (3 of 131,072 coordinates of a
  leaf moved by 2e-4 in round 1). That run is held to 1e-4 everywhere
  but on at most 0.01 % of the coordinates, and there to 1e-3.
"""
import numpy as np
import pytest

from test_torch_fl_sync import (ORGS, assert_contributions_match,
                                assert_runs_match, leaves, pairs, run_twin)

PLANES = {
    "fedavg": ({"secure_aggregation": False}, ORGS),
    "median": ({"secure_aggregation": False, "aggregation": "median"},
               ORGS + ["tidal"]),
    "topk_all": ({"secure_aggregation": False, "compression": "topk",
                  "compression_ratio": 1.0}, ORGS),
}
TOPK = {"secure_aggregation": False, "compression": "topk"}
FLIP_SHARE, FLIP_TOL = 1e-4, 1e-3


@pytest.fixture(scope="module", params=sorted(PLANES))
def twin(request):
    decisions, orgs = PLANES[request.param]
    return request.param, {side: run_twin(side, decisions, orgs=orgs)
                           for side in ("jax", "port")}


def test_plane_run_matches_reference(twin):
    name, runs = twin
    (jcon, jphase), (tcon, tphase) = runs["jax"], runs["port"]
    assert jphase == tphase == "done"
    assert_runs_match(jcon, tcon)


def test_plane_contributions(twin):
    _, runs = twin
    assert_contributions_match(runs["jax"][0], runs["port"][0],
                               secure=False)


def test_topk_default_ratio_within_selection_flips():
    (jcon, jphase), (tcon, tphase) = (run_twin(side, TOPK)
                                      for side in ("jax", "port"))
    assert jphase == tphase == "done"
    jh, th = jcon.server.run.history, tcon.server.run.history
    assert len(jh) == len(th) == 2
    for a, b in zip(jh, th):
        assert abs(a["mean_train_loss"] - b["mean_train_loss"]) <= 1e-4
        assert abs(a["mean_eval_loss"] - b["mean_eval_loss"]) <= 1e-4
        diff = np.concatenate([
            np.abs(x - y).ravel() for x, y in zip(
                leaves(jcon.server.store.get(a["digest"])),
                leaves(tcon.server.store.get(b["digest"])))])
        assert (diff > 1e-4).mean() <= FLIP_SHARE
        assert diff.max() <= FLIP_TOL
    assert pairs(jcon.server.metadata) == pairs(tcon.server.metadata)
    assert tcon.server.metadata.verify_chain()
