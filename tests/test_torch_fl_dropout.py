"""Dropout tolerance of the port's sync run against the JAX package.

The scenarios of ``tests/test_dropout.py``, each run by both
``Consortium``s on identical ids, keys, init and data (``run_twin`` of
``test_torch_fl_sync.py``), with ``round_deadline_ticks`` 3:

* a masked run of 5 silos losing one as round 1's collect opens: the
  deadline drops it, the survivors post mask corrections, the server
  folds them into the pending sink (weight -1 rows) and commits the
  repaired global — within 1e-4 of the reference's;
* a silo vanishing during round 0's evaluate: no repair, round 1 runs
  on the shrunk cohort;
* a drop below ``min_cohort``: the run pauses, with the pause on the
  provenance trail and the silos notified.
"""
import pytest

from test_torch_fl_sync import assert_runs_match, run_twin

FIVE = ["a", "b", "c", "d", "e"]
SCENARIOS = {
    "mid_collect": dict(orgs=FIVE, drop_at={"c": ("collect", 1)},
                        decisions={"round_deadline_ticks": 3,
                                   "local_steps": 1, "batch_size": 2}),
    "evaluate": dict(orgs=["p", "q", "r"], drop_at={"q": ("evaluate", 0)},
                     decisions={"round_deadline_ticks": 3}),
    "below_min_cohort": dict(orgs=["w", "x", "y"],
                             drop_at={"y": ("collect", 0)},
                             decisions={"round_deadline_ticks": 3,
                                        "min_cohort": 3, "rounds": 1}),
}


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def twin(request):
    sc = SCENARIOS[request.param]
    out = {side: run_twin(side, sc["decisions"], orgs=sc["orgs"],
                          drop_at=dict(sc["drop_at"]))
           for side in ("jax", "port")}
    return request.param, out


def _ops(con, op):
    return [r for r in con.server.metadata.query(kind="provenance")
            if r["operation"] == op]


def test_dropout_run_matches_reference(twin):
    name, runs = twin
    (jcon, jphase), (tcon, tphase) = runs["jax"], runs["port"]
    assert jphase == tphase == ("paused" if name == "below_min_cohort"
                                else "done")
    assert_runs_match(jcon, tcon)


def test_dropout_run_outcome(twin):
    name, runs = twin
    tcon = runs["port"][0]
    run = tcon.server.run
    assert len(run.dropped) == 1
    repairs = _ops(tcon, "publish_dropout")
    if name == "mid_collect":
        assert len(repairs) == 1 and len(run.cohort) == 4
        model = tcon.server.metadata.query(
            kind="model", digest=run.history[1]["digest"])[0]
        assert model["details"]["repaired"]
        assert len(model["details"]["cohort"]) == 4
        survivors = [n for n in tcon.nodes if n.client_id in run.cohort]
        assert all(n.metadata.query(operation="mask_repair")
                   for n in survivors)
    elif name == "evaluate":
        assert not repairs and len(run.history) == 2
        glob1 = tcon.nodes[0].comm.fetch(
            f"runs/{tcon.run_id}/round/0/1/global", broadcast=True)
        assert run.dropped[0] not in glob1["cohort"]
        assert len(glob1["cohort"]) == 2
    else:
        assert "min_cohort" in run.pause_reason
        pauses = [r for r in _ops(tcon, "pause_run")
                  if r["outcome"] == "paused"]
        assert pauses and run.dropped[0] in pauses[0]["details"]["dropped"]
        assert any("paused" in m for n in tcon.nodes
                   for m in n.notifications)
