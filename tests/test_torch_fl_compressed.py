"""The port's int8 and secure int8 planes through its server and client,
against the JAX package, in full ``Consortium`` runs (``run_twin`` of
``test_torch_fl_sync.py``: identical ids, keys, init and data).

* ``int8``, secure aggregation off: the clients post error-feedback
  int8 wire dicts, the server folds them through ``QuantSink`` (K3's
  plain version here) weighted by raw example counts;
* secure ``int8``: fixed-grid quantization plus integer pairwise masks
  mod 2**16, folded by ``ModularSink`` and decoded at finalize (K4's
  plain version).

Every committed global within 1e-4, the tolerance
``test_torch_compressed_round.py`` holds the globals to (a stochastic
rounding that flips on a rounding-level difference of the trained delta
moves a coordinate by one quantization step, far below it). A fixed
``dp_seed`` secure int8 run with ``dp_epsilon > 0`` repeats its final
digest bit for bit on a second port run.
"""
import pytest

from test_torch_fl_sync import (assert_contributions_match,
                                assert_runs_match, run_twin)

PLANES = {
    "int8": {"secure_aggregation": False, "compression": "int8"},
    "secure_int8": {"secure_aggregation": True, "compression": "int8"},
}
DP = {"secure_aggregation": True, "compression": "int8", "dp_epsilon": 2.0,
      "dp_clip": 0.05, "dp_seed": 7}


@pytest.fixture(scope="module", params=sorted(PLANES))
def twin(request):
    return request.param, {side: run_twin(side, PLANES[request.param])
                           for side in ("jax", "port")}


def test_compressed_run_matches_reference(twin):
    name, runs = twin
    (jcon, jphase), (tcon, tphase) = runs["jax"], runs["port"]
    assert jphase == tphase == "done"
    assert_runs_match(jcon, tcon)


def test_compressed_contributions(twin):
    name, runs = twin
    assert_contributions_match(runs["jax"][0], runs["port"][0],
                               secure=name == "secure_int8")


def test_dp_seed_run_repeats_bitwise():
    digests = []
    for _ in range(2):
        con, phase = run_twin("port", DP)
        assert phase == "done"
        assert len(con.server.metadata.query(
            operation="dp_accounting")) == 1
        digests.append([h["digest"] for h in con.server.run.history])
    assert digests[0] == digests[1]
