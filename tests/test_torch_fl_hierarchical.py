"""The port's hierarchical tier (device fleets behind each silo) against
the JAX package, on the CPU.

* Sampling: ``sample_device_cohort`` and ``sample_device_dropout`` give
  the reference's lists over silos x seeds x rounds x (n, k, p) — both
  are numpy ``SeedSequence`` draws, copied as text.
* Data: a ``DeviceFleet``'s profiles (Dirichlet ``probs``, lognormal
  ``n_examples``) and its shards' batches are bitwise equal to the
  reference's; the one-device fleet is the silo itself; a silo without
  ``_probs`` raises ``TypeError``.
* ``InnerRoundEngine`` on a real silo (reduced ``fedforecast-100m``, the
  reference's init converted through numpy, identical data) at device
  clip 0 and 0.5: cohort, dropped and ``n_examples`` equal, params
  within 1e-4 (the repo's twin rule; the clipped deltas differ from the
  reference's at the 1e-7 relative level, since torch's norm sums in
  another order than numpy's float32 dot). The single-survivor shortcut
  returns ``_fit``'s params bit for bit, and the fold's peak bytes stay
  flat from cohort 12 to 24 (``MaskedF32Sink`` stages at most 8 rows).
* Whole ``Consortium`` runs (``run_twin`` of ``test_torch_fl_sync.py``:
  identical ids, keys, init and data) of a fleet behind each of 3 silos:
  secure fp32, secure int8, and a silo killed at its own round-1 inner
  boundary. Every committed global within 1e-4, the inner-round
  provenance and the ``fleet.*`` counters equal. The degenerate fleet
  (``devices_per_silo`` 1, cohort 1) repeats the port's own flat run bit
  for bit on the plain plane.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from repro.core import client as jclient
from repro.core import protocol as jprotocol
from repro.core.jobs import FLJob as JJob
from repro.core.telemetry import Telemetry as JTelemetry
from repro.data import synthetic as jsyn
from repro_torch import tree
from repro_torch.convert import params_from_numpy
from repro_torch.core import Consortium
from repro_torch.core import client as tclient
from repro_torch.core import protocol as tprotocol
from repro_torch.core.jobs import FLJob as TJob
from repro_torch.core.telemetry import Telemetry as TTelemetry
from repro_torch.data import synthetic as tsyn
from test_torch_fl_sync import (ORGS, SEQ, TOL, VOCAB, assert_runs_match,
                                assert_trees_close, fixed_uuids, leaves,
                                one_torch_thread, reference_init, run_twin)

SAMPLING = [(100, 10, 0.5), (16, 0, 0.9), (10_000, 8, 0.05), (4, 4, 0.99)]
SILO_IDS = ["windco", "silo-0", "x"]
SEEDS = [0, 7, 2 ** 40 + 3]


# ---------------------------------------------------------------------------
# sampling and device shards: bitwise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,k,p", SAMPLING)
def test_device_sampling_matches_reference(n, k, p):
    for silo in SILO_IDS:
        for seed in SEEDS:
            for rnd in range(4):
                jc = jprotocol.sample_device_cohort(silo, seed, rnd, n, k)
                tc = tprotocol.sample_device_cohort(silo, seed, rnd, n, k)
                assert tc == jc
                assert (tprotocol.sample_device_dropout(silo, seed, rnd, tc,
                                                        p)
                        == jprotocol.sample_device_dropout(silo, seed, rnd,
                                                           jc, p))


@pytest.mark.parametrize("declared", [None, 50_000])
def test_device_fleet_matches_reference(declared):
    jsilo = jsyn.make_silo_datasets(1, vocab=64, seq_len=8, seed=3)[0]
    tsilo = tsyn.make_silo_datasets(1, vocab=64, seq_len=8, seed=3)[0]
    jsilo.n_examples = tsilo.n_examples = declared
    jf = jsyn.make_device_shards(jsilo, 10_000, seed=3)
    tf = tsyn.make_device_shards(tsilo, 10_000, seed=3)
    for idx in (0, 5, 9_999, 5, 4_321):
        for rnd in (0, 2):
            js, ts = jf.shard(idx, rnd), tf.shard(idx, rnd)
            assert ts._probs.dtype == np.float64
            np.testing.assert_array_equal(ts._probs, js._probs)
            assert ts.n_examples == js.n_examples
            assert ts.stats() == js.stats()
            for _ in range(2):
                np.testing.assert_array_equal(ts.batch(4)["tokens"],
                                              js.batch(4)["tokens"])
    # the profile cache is an LRU of 512, as the reference's
    for idx in range(600):
        tf.shard(idx)
    assert len(tf._profiles) == tf._PROFILE_CACHE_MAX == 512
    assert list(tf._profiles)[-1] == 599


def test_degenerate_fleet_is_the_silo_and_probless_silos_raise():
    silo = tsyn.make_silo_datasets(1, vocab=64, seq_len=8, seed=0)[0]
    assert tsyn.make_device_shards(silo, 1, seed=0).shard(0) is silo

    class Opaque:
        silo_id = "x"
    with pytest.raises(TypeError):
        tsyn.DeviceFleet(Opaque(), 4, seed=0)
    with pytest.raises(ValueError):
        tsyn.DeviceFleet(Opaque(), 0, seed=0)
    with pytest.raises(IndexError):
        tsyn.make_device_shards(silo, 4, seed=0).shard(4)


# ---------------------------------------------------------------------------
# the inner-round engine on a real silo, against the reference's
# ---------------------------------------------------------------------------
JOB = {"job_id": "fleet-job", "arch": "fedforecast-100m", "rounds": 1,
       "local_steps": 2, "batch_size": 2, "lr": 3e-4, "optimizer": "adamw",
       "outer_optimizer": "fedavg", "aggregation": "fedavg",
       "train_test_split": 0.2, "eval_metrics": ["loss"],
       "secure_aggregation": False, "data_schema": None,
       "devices_per_silo": 16, "device_cohort_size": 5,
       "device_dropout": 0.25}


def _node(side: str, job: dict, silo_seed: int = 1):
    """A silo's FLClientNode with ``job`` set up, on one side."""
    syn, node_cls, job_cls, tel, kw = (
        (jsyn, jclient.FLClientNode, JJob, JTelemetry, {}) if side == "jax"
        else (tsyn, tclient.FLClientNode, TJob, TTelemetry,
              {"device": "cpu"}))
    comm = SimpleNamespace(board=SimpleNamespace(telemetry=tel()))
    ds = syn.SiloDataset("silo-0", VOCAB, SEQ, silo_seed)
    node = node_cls("silo-0", comm, ds, "run-0", ["silo-0"], b"s", **kw)
    node._setup_job(job_cls.from_dict(job))
    return node


def _engine(side: str, job: dict, rnd: int = 1):
    base = reference_init()
    if side == "port":
        base = params_from_numpy(base, "cpu")
    node = _node(side, job)
    cls = jclient.InnerRoundEngine if side == "jax" \
        else tclient.InnerRoundEngine
    engine = cls(node, rnd, 3e-4, base)
    with one_torch_thread():
        return engine, engine.run()


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_inner_round_engine_matches_reference(clip):
    job = {**JOB, "device_clip": clip}
    (je, (jp, jloss, jn)), (te, (tp, tloss, tn)) = (
        _engine(side, job) for side in ("jax", "port"))
    assert te.cohort == je.cohort and len(te.cohort) == 5
    assert te.dropped == je.dropped and te.dropped
    assert te.folded == je.folded > 1
    assert tn == jn
    assert abs(tloss - jloss) <= TOL
    assert_trees_close(jax.tree.map(np.asarray, jp), tp)
    assert te.peak_fold_bytes == je.peak_fold_bytes > 0


def test_single_survivor_shortcut_is_fit_bitwise():
    """A one-device fleet at cohort 1 returns ``_fit``'s trained params
    untouched: no pack, no fold, no unpack."""
    job = {**JOB, "devices_per_silo": 1, "device_cohort_size": 1,
           "device_dropout": 0.0}
    engine, (params, loss, n) = _engine("port", job, rnd=0)
    assert engine.cohort == [0] and engine.sink is None
    twin = _node("port", job)        # same silo seed: the same batches
    with one_torch_thread():
        want, wloss, wn = twin._fit(twin.dataset, params_from_numpy(
            reference_init(), "cpu"), 3e-4)
    assert (loss, n) == (wloss, wn)
    for a, b in zip(tree.leaves(params), tree.leaves(want)):
        assert torch.equal(a, b)


class _StubShard:
    def __init__(self, device_index):
        self.device_index = device_index


class _StubNode:
    """The executor surface the engine drives, with ``_fit`` returning a
    fabricated per-device delta (the fold's cost is what is measured)."""

    def __init__(self, job, base):
        self.job = job
        self.base = base
        self.fleet = SimpleNamespace(shard=lambda idx, rnd=0: _StubShard(idx))
        self.dataset = _StubShard(0)
        self.client_id = "stub-silo"
        self.run_id = "stub-run"
        self.telemetry = TTelemetry(enabled=False)
        self.inner_hooks = []

    def _fit(self, shard, base_params, lr):
        g = torch.Generator().manual_seed(1000 + shard.device_index)
        return ({k: v + torch.randn(v.shape, generator=g)
                 for k, v in base_params.items()}, 0.25, 1)


def test_peak_fold_bytes_flat_in_cohort_size():
    base = {"w": torch.zeros(64, 64)}
    peaks = []
    for cohort in (12, 24):
        job = SimpleNamespace(devices_per_silo=64, device_cohort_size=cohort,
                              device_dropout=0.0, device_clip=0.0)
        engine = tclient.InnerRoundEngine(_StubNode(job, base), 0, 0.1, base)
        engine.run()
        assert engine.folded == cohort
        peaks.append(engine.peak_fold_bytes)
    # the accumulator plus 8 staged rows, whatever the cohort
    assert peaks[0] == 4 * 64 * 64 * (1 + 8)
    assert peaks[1] <= peaks[0] * 1.01


def test_inner_hook_abort_raises_before_sampling():
    base = {"w": torch.zeros(4)}
    job = SimpleNamespace(devices_per_silo=8, device_cohort_size=3,
                          device_dropout=0.0, device_clip=0.0)
    node = _StubNode(job, base)
    calls = []

    def hook(cid, rnd, stage):
        calls.append((cid, rnd, stage))
        raise tclient.InnerRoundAborted("test")

    node.inner_hooks.append(hook)
    node.fleet = object()            # an engine would fail on it
    with pytest.raises(tclient.InnerRoundAborted):
        tclient.FLClientNode.run_inner_round(node, base, 0.1, rnd=2)
    assert calls == [("stub-silo", 2, "enter")]


# ---------------------------------------------------------------------------
# whole runs through Consortium
# ---------------------------------------------------------------------------
# a device delta of one step at lr 3e-4 has a norm of about 0.36 here:
# clip 0.2 clips every one
FLEET = {"devices_per_silo": 16, "device_cohort_size": 3,
         "device_dropout": 0.25, "device_clip": 0.2,
         "local_steps": 1, "batch_size": 2}
RUNS = {
    "secure_fp32": dict(decisions=FLEET),
    "secure_int8": dict(decisions={**FLEET, "compression": "int8"}),
    "inner_drop": dict(decisions={**FLEET, "device_clip": 0.0,
                                  "round_deadline_ticks": 3},
                       drop_at={"solarx": ("inner_round", 1)}),
}
COUNTERS = ("fleet.devices_folded", "fleet.devices_dropped",
            "fleet.inner_rounds")


@pytest.fixture(scope="module", params=sorted(RUNS))
def twin(request):
    sc = RUNS[request.param]
    return request.param, {
        side: run_twin(side, sc["decisions"],
                       drop_at=dict(sc.get("drop_at", {})))
        for side in ("jax", "port")}


def _inner_rounds(con):
    return [[{k: v for k, v in r["details"].items()
              if k != "devices_per_sec"}
             for r in n.metadata.query(operation="inner_round")]
            for n in con.nodes]


def test_fleet_run_matches_reference(twin):
    name, runs = twin
    (jcon, jphase), (tcon, tphase) = runs["jax"], runs["port"]
    assert jphase == tphase == "done"
    assert_runs_match(jcon, tcon)


def test_fleet_inner_rounds_match_reference(twin):
    name, runs = twin
    jcon, tcon = runs["jax"][0], runs["port"][0]
    jr, tr = _inner_rounds(jcon), _inner_rounds(tcon)
    assert tr == jr
    per_silo = [len(r) for r in tr]
    assert per_silo == ([2, 1, 2] if name == "inner_drop" else [2, 2, 2])
    for rounds in tr:
        for d in rounds:
            assert d["sampled"] == 3 == d["dropped"] + d["folded"]
    for c in COUNTERS:
        assert (tcon.telemetry.metrics.counter(c).read()
                == jcon.telemetry.metrics.counter(c).read())
    if name == "inner_drop":
        dropped = tcon.client_ids["solarx"]
        assert tcon.server.run.dropped == [dropped]
        assert dropped in tcon.server.run.history[0]["train_losses"]
        assert dropped not in tcon.server.run.history[1]["train_losses"]


def test_degenerate_fleet_run_is_the_flat_run_bitwise():
    plain = {"secure_aggregation": False}
    flat, p1 = run_twin("port", plain)
    fleet, p2 = run_twin("port", {**plain, "devices_per_silo": 1,
                                  "device_cohort_size": 1,
                                  "device_dropout": 0.0})
    assert p1 == p2 == "done"
    assert all(n.fleet is None for n in flat.nodes)
    assert all(n.fleet is not None for n in fleet.nodes)
    assert all(len(n.metadata.query(operation="inner_round")) == 2
               for n in fleet.nodes)
    for a, b in zip(flat.server.run.history, fleet.server.run.history):
        assert a["digest"] == b["digest"]
        for x, y in zip(leaves(flat.server.store.get(a["digest"])),
                        leaves(fleet.server.store.get(b["digest"]))):
            np.testing.assert_array_equal(x, y)


def test_job_matrix_rejects_fleet_async_and_bad_shapes():
    con = Consortium(ORGS[:2], device="cpu")
    creator = con.server.job_creator

    def contract(extra):
        return con.negotiate({"arch": "fedforecast-100m", "rounds": 1,
                              "data_schema": None, **extra})

    with pytest.raises(ValueError, match="async_buff"):
        creator.from_contract(contract(
            {"protocol": "async_buff", "secure_aggregation": False,
             "devices_per_silo": 8}))
    rejects = con.server.metadata.query(operation="create_job",
                                        outcome="rejected")
    assert rejects[-1]["details"]["decisions"]["devices_per_silo"] == 8
    for extra, what in (({"devices_per_silo": 4, "device_cohort_size": 5},
                         "device_cohort_size"),
                        ({"devices_per_silo": 4, "device_dropout": 1.0},
                         "device_dropout"),
                        ({"devices_per_silo": 0}, "devices_per_silo")):
        with pytest.raises(ValueError, match=what):
            creator.from_contract(contract(extra))
    # the inner tier is the silo's engine, not a negotiable protocol
    assert "intra_silo" not in tprotocol.PROTOCOLS
    with pytest.raises(KeyError):
        tprotocol.make_protocol("intra_silo")
    assert tprotocol.IntraSiloProtocol().initial == "device_sample"


@pytest.mark.parametrize("extra", [{}, FLEET], ids=["flat", "fleet"])
def test_inner_hooks_fire_in_flat_and_fleet_mode(extra):
    events = []
    with fixed_uuids(), one_torch_thread():
        con = Consortium(ORGS, device="cpu", initial_params=params_from_numpy(
            reference_init(), "cpu"))
        job = con.server.job_creator.from_contract(con.negotiate(
            {"arch": "fedforecast-100m", "rounds": 1, "local_steps": 1,
             "batch_size": 2, "data_schema": None, **extra}))
        con.start(job, tsyn.make_silo_datasets(3, vocab=VOCAB, seq_len=SEQ,
                                               seed=1))
        assert con.run_to_completion(
            on_phase=lambda rid, ph: events.append(ph)) == "done"
    assert events.count("inner_round") == 3
    assert all(bool(n.metadata.query(operation="inner_round"))
               == bool(extra) for n in con.nodes)
