"""The silo train step replayed as a CUDA graph
(``training/train_graph.py``) and the optimizers' per-step values as
device scalars (``optim/adamw.py``).

On the CPU, with a stand-in graph class (``FakeGraph``) in place of
``torch.cuda.CUDAGraph``: a replay runs the captured closure again, so a
value the step took from the host at capture shows. (1) The runner's
policy: eager then capture then replay, the key, what stays eager, no
capture while the telemetry records, the bounded cache of graphs, the
counter; (2) replayed steps of reduced fedforecast-100m bitwise the eager
steps under AdamW (constant and cosine lr) and momentum SGD, inputs never
written and outputs never overwritten; (3) the optimizers' device
scalars; (4) the benchmark's reader of the counter. The real graph is
held against the eager step on the card by ``chip_smoke.py``'s ``train
graph`` phase.
"""
import importlib.util
from pathlib import Path

import pytest
import torch
import torch.autograd.profiler as torch_profiler
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core import telemetry
from repro_torch.core.telemetry import Telemetry
from repro_torch.data.synthetic import make_silo_datasets
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.cuda_graph import CudaGraph, Keys
from repro_torch.optim import adamw, cosine_schedule, sgd
from repro_torch.optim.adamw import on_device
from repro_torch.training import make_train_step
from repro_torch.training import train_graph
from repro_torch.training.train_graph import CAPACITY, TrainGraphs
from torch_graph_stand_in import FakeGraph

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
OPTIMIZERS = {
    "adamw": lambda: adamw(3e-4, weight_decay=0.1),
    "adamw_cosine": lambda: adamw(cosine_schedule(1e-3, 3, 10),
                                  weight_decay=0.0),
    "sgd_momentum": lambda: sgd(cosine_schedule(1e-2, 3, 10), momentum=0.9),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_graphs(monkeypatch):
    """No stand-in graph made, and a process-wide store of keys of this
    test's own."""
    FakeGraph.made = []
    monkeypatch.setattr(train_graph, "KEYS", Keys(CAPACITY))
    yield


def paths():
    """The process bundle's ``train.step_graph`` counts by path."""
    return telemetry.process().metrics.labeled("train.step_graph", "path")


def moved(before):
    after = paths()
    return {p: after.get(p, 0) - before.get(p, 0)
            for p in ("eager", "capture", "replay")}


class Toy:
    """A model in miniature: ``loss_fn(params, batch)``."""

    def loss_fn(self, params, batch):
        y = torch.tanh(batch["x"] @ params["w"]) * params["s"]
        loss = torch.mean(torch.square(y - 1.0))
        return loss, {"ce": loss}


def toy(seed=0, rows=4, device=CPU):
    gen = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(5, 3, generator=gen),
              "s": torch.rand(3, generator=gen)}
    batch = {"x": torch.randn(rows, 5, generator=gen)}
    return (tree.tree_map(lambda a: a.to(device), params),
            {"x": batch["x"].to(device)})


def staged(opt, graph=FakeGraph, model=None):
    step = make_train_step(model or Toy(), opt)
    step.graphs = TrainGraphs(graph=graph)
    return step


def run(step, params, state, batches):
    """``step`` over ``batches``; each step's (params, state, metrics)."""
    out = []
    for b in batches:
        params, state, met = step(params, state, b)
        out.append((params, state, met))
    return out


def leaves(t) -> list:
    """The leaves of a tree, or of a tuple of trees."""
    if isinstance(t, tuple):
        return [a for x in t for a in leaves(x)]
    return tree.leaves(t)


def clone(t):
    if isinstance(t, tuple):
        return tuple(clone(x) for x in t)
    return tree.tree_map(lambda a: a.clone() if isinstance(a, torch.Tensor)
                         else a, t)


def same(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        type(x) is type(y) and (torch.equal(x, y)
                                if isinstance(x, torch.Tensor) else x == y)
        for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# (1) the runner's policy
# ---------------------------------------------------------------------------
def test_eager_first_capture_second_replay_after():
    opt = OPTIMIZERS["adamw_cosine"]()
    params, batch = toy()
    step = staged(opt)
    before = paths()
    got = run(step, params, opt.init(params), [batch] * 5)
    assert moved(before) == {"eager": 1, "capture": 1, "replay": 3}
    assert len(FakeGraph.made) == 1 and FakeGraph.made[0].replays == 4
    want = run(make_train_step(Toy(), opt), params, opt.init(params),
               [batch] * 5)
    for g, w in zip(got, want):
        assert same(g, w)
    assert [s["count"] for _, s, _ in got] == [1, 2, 3, 4, 5]


def test_the_key_follows_shapes_strides_dtypes_and_structure():
    opt = adamw(1e-3)
    runner = TrainGraphs(graph=FakeGraph)
    params, batch = toy()
    state = opt.init(params)
    key = runner._key(params, state, batch)
    assert key is not None
    # new tensors of the same layout, another count: the same key
    assert runner._key(clone(params), {**clone(state), "count": 7},
                       clone(batch)) == key
    w = params["w"]
    others = [
        ({**params, "w": w[:4]}, state, batch),                 # shape
        ({**params, "w": w.t().contiguous().t()}, state, batch),  # stride
        ({**params, "w": w.double()}, state, batch),            # dtype
        ({**params, "extra": w}, state, batch),                 # structure
        (params, state, {"x": batch["x"][:2]}),                 # batch
        (params, {**state, "m": {**state["m"], "s": state["m"]["s"][:2]}},
         batch),                                                # state
    ]
    for p, s, b in others:
        assert runner._key(p, s, b) != key


def test_cpu_meta_dtensor_numpy_and_dispatch_modes_stay_eager():
    opt = adamw(1e-3)
    params, batch = toy()
    before = paths()
    # the CUDA graph class on the CPU: never engages, never touches CUDA
    run(staged(opt, graph=CudaGraph), params, opt.init(params), [batch] * 3)
    step = staged(opt)
    meta, mbatch = toy(device=torch.device("meta"))
    run(step, meta, opt.init(meta), [mbatch] * 3)
    npb = {"x": batch["x"].numpy()}
    for _ in range(3):
        step.graphs(lambda p, o, b, s: (p, o, {}), opt, params,
                    opt.init(params), npb)
    with dryrun.fake_world(1):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate
        mesh = init_device_mesh("cpu", (1,))
        dparams = tree.tree_map(lambda a: DTensor.from_local(
            a, mesh, [Replicate()], run_check=False), params)
        for _ in range(3):
            step.graphs(lambda p, o, b, s: (p, o, {}), opt, dparams,
                        opt.init(params), batch)
    assert moved(before) == {"eager": 12, "capture": 0, "replay": 0}
    assert not FakeGraph.made and not step.graphs._keys
    # a captured key runs eagerly under a dispatch mode (the dry run's
    # counters), which then sees every operation of the step
    run(step, params, opt.init(params), [batch] * 2)
    with FlopCounterMode(display=False) as fc:
        step(params, opt.init(params), batch)
    assert fc.get_total_flops() > 0
    assert moved(before) == {"eager": 14, "capture": 1, "replay": 0}


def test_no_capture_while_the_telemetry_records(monkeypatch):
    opt = adamw(1e-3)
    params, batch = toy()
    step = staged(opt)
    state = opt.init(params)
    before = paths()
    monkeypatch.setattr(torch_profiler, "_is_profiler_enabled", True)
    params, state, _ = run(step, params, state, [batch] * 3)[-1]
    assert moved(before) == {"eager": 3, "capture": 0, "replay": 0}
    with telemetry.scope(Telemetry(enabled=True)):
        monkeypatch.setattr(torch_profiler, "_is_profiler_enabled", False)
        params, state, _ = run(step, params, state, [batch] * 2)[-1]
    assert moved(before) == {"eager": 5, "capture": 0, "replay": 0}
    assert not FakeGraph.made
    params, state, _ = run(step, params, state, [batch])[-1]
    assert moved(before) == {"eager": 5, "capture": 1, "replay": 0}
    # a captured key still replays under the profiler
    monkeypatch.setattr(torch_profiler, "_is_profiler_enabled", True)
    run(step, params, state, [batch] * 2)
    assert moved(before) == {"eager": 5, "capture": 1, "replay": 2}


def test_the_cache_of_graphs_is_bounded():
    opt = adamw(1e-3)
    params, _ = toy()
    batches = [toy(rows=r)[1] for r in range(1, CAPACITY + 2)]
    step = staged(opt)
    before = paths()
    for b in batches:                   # each a new key: eager, then graph
        run(step, params, opt.init(params), [b] * 2)
        assert len(step.graphs._keys) <= CAPACITY
    n = len(batches)
    assert moved(before) == {"eager": n, "capture": n, "replay": 0}
    run(step, params, opt.init(params), [batches[-1]])   # kept: replays
    run(step, params, opt.init(params), [batches[0]])    # evicted: new key
    assert moved(before) == {"eager": n + 1, "capture": n, "replay": 1}
    kept = list(step.graphs._keys.values())
    assert len(kept) == CAPACITY and kept[-1] is None and kept[0] is not None


def test_every_runner_of_the_process_shares_one_bound():
    """Train steps of several jobs, as ``core/client.py`` caches them:
    their graphs are kept in one store of ``CAPACITY`` keys in all, so a
    new key of one runner evicts another runner's graph, which is let go
    with its buffers; the graphs kept share one memory pool."""
    import gc
    import weakref
    opt = adamw(1e-3)
    params, batch = toy()
    steps = [staged(opt) for _ in range(CAPACITY + 1)]
    before = paths()
    outs = []
    for step in steps:                       # each captures its key
        run(step, params, opt.init(params), [batch] * 2)
        assert len(train_graph.KEYS) <= CAPACITY
        outs += [weakref.ref(a) for a in step.graphs._keys[next(reversed(
            step.graphs._keys))].outputs[0]]
    n = len(steps)
    assert moved(before) == {"eager": n, "capture": n, "replay": 0}
    kept = list(train_graph.KEYS.values())
    assert len(kept) == CAPACITY and None not in kept
    assert kept[1].graph.pool is kept[0].graph.pool
    FakeGraph.made.clear()
    gc.collect()
    first = len(outs) // n
    assert all(r() is None for r in outs[:first])       # the first let go
    assert all(r() is not None for r in outs[-first:])  # the last kept
    run(steps[-1], params, opt.init(params), [batch])   # kept: replays
    run(steps[0], params, opt.init(params), [batch])    # evicted: eager
    assert moved(before) == {"eager": n + 1, "capture": n, "replay": 1}


def test_the_counter_counts_each_path(monkeypatch):
    tel = Telemetry(recorder_cap=telemetry.PROCESS_RING)
    monkeypatch.setattr(telemetry, "_PROCESS", tel)
    opt = sgd(1e-2, momentum=0.9)
    params, batch = toy()
    step = staged(opt)
    run(step, params, opt.init(params), [batch] * 4)
    run(step, params, opt.init(params), [toy(rows=2)[1]])
    snap = tel.metrics.snapshot()["train.step_graph"]
    assert snap == {"path=eager": 2, "path=capture": 1, "path=replay": 2}


# ---------------------------------------------------------------------------
# (2) replayed steps of the main path's model against eager steps
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fedforecast():
    cfg = get_config("fedforecast-100m").reduced()
    model = build_model(cfg, device=CPU)
    glob = model.init(model.generator(0))
    datasets = make_silo_datasets(3, vocab=cfg.vocab, seq_len=32, seed=1)
    batches = [[{"tokens": torch.as_tensor(ds.batch(2)["tokens"])}
                for _ in range(10)] for ds in datasets]
    return model, glob, batches


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_ten_replayed_steps_are_bitwise_ten_eager_steps(fedforecast, name):
    """Ten steps through the stand-in graph (one eager, one capture, eight
    replays) against ten eager steps of ``make_train_step`` on the CPU:
    the loss, params, moments, gradient norm, learning rate and the
    host count of every step, bitwise. A per-step value frozen at the
    capture (a count, a bias correction, a scheduled lr) would differ."""
    model, glob, batches = fedforecast
    opt = OPTIMIZERS[name]()
    before = paths()
    got = run(staged(opt, model=model), glob, opt.init(glob), batches[0])
    assert moved(before) == {"eager": 1, "capture": 1, "replay": 8}
    want = run(make_train_step(model, opt), glob, opt.init(glob),
               batches[0])
    for k, ((gp, gs, gm), (wp, ws, wm)) in enumerate(zip(got, want)):
        assert gs["count"] == ws["count"] == k + 1
        assert isinstance(gs["count"], int)
        assert same(gp, wp) and same(gs, ws), f"step {k}"
        assert set(gm) == set(wm) and same(gm, wm), f"step {k}"
    lrs = [float(m["lr"]) for _, _, m in got]
    if name != "adamw":
        assert len(set(lrs)) > 5          # the schedule moved every step


def test_inputs_are_never_written_and_outputs_never_overwritten(fedforecast):
    """Three silos from one global, three steps each through one runner,
    as the benchmark's round runs them: the global, each batch and every
    step's returned trees keep their values to the end, and no returned
    tensor shares memory with another step's or with the graph's."""
    model, glob, batches = fedforecast
    opt = adamw(3e-4, weight_decay=0.0)
    step = staged(opt, model=model)
    kept_glob = clone(glob)
    outs, copies = [], []
    for silo in range(3):
        p, o = glob, opt.init(glob)
        for k in range(3):
            p, o, m = step(p, o, batches[silo][k])
            outs.append((p, o, m))
            copies.append(clone((p, o, m)))
    assert same(glob, kept_glob)
    for out, copy in zip(outs, copies):
        assert same(out, copy)
    ptrs = [a.data_ptr() for out in outs for a in leaves(out)
            if isinstance(a, torch.Tensor)]
    assert len(ptrs) == len(set(ptrs))
    graph_ptrs = {a.data_ptr() for a in step.graphs._keys[
        next(iter(step.graphs._keys))].outputs[0]}
    assert not graph_ptrs & set(ptrs)
    assert len(FakeGraph.made) == 1
    # the silos' trained params differ, and each is the eager run's
    for silo in range(3):
        p, o = glob, opt.init(glob)
        for k in range(3):
            p, o, _ = make_train_step(model, opt)(p, o, batches[silo][k])
        assert same(outs[3 * silo + 2][0], p)


# ---------------------------------------------------------------------------
# (3) the optimizers' per-step values as device scalars
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_the_update_reads_its_step_values_from_the_scalars(name):
    """An update given step 5's values as 0-d f32 tensors equals the
    update of a state at count 4 that makes them itself, bitwise, and
    hands back its lr as that 0-d tensor; the values are the host's f64
    rounded once to f32."""
    opt = OPTIMIZERS[name]()
    params, _ = toy()
    grads = tree.tree_map(lambda a: torch.full_like(a, 0.25), params)
    state = {**opt.init(params), "count": 4}
    want = opt.update(grads, state, params)
    host = opt.scalars(5)
    scalars = on_device(host, params["w"])
    got = opt.update(grads, {**state, "count": 0}, params, scalars)
    assert same(got[0], want[0])
    assert got[2]["lr"] is scalars["lr"] and want[2]["lr"].dim() == 0
    assert torch.equal(got[2]["lr"], want[2]["lr"])
    for k, v in host.items():
        assert scalars[k].dtype == torch.float32 and scalars[k].dim() == 0
        assert float(scalars[k]) == float(torch.tensor(v,
                                                       dtype=torch.float32))
    if "c1" in host:
        assert host["c1"] == 1 - 0.9 ** 5 and host["c2"] == 1 - 0.95 ** 5


# ---------------------------------------------------------------------------
# (4) the benchmark's reader
# ---------------------------------------------------------------------------
def test_the_benchmarks_reader_reads_the_replay_share(monkeypatch):
    path = ROOT / "portbench" / "metrics" / "graph_share.round.py"
    spec = importlib.util.spec_from_file_location("graph_share_round", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    tel = Telemetry(recorder_cap=telemetry.PROCESS_RING)
    monkeypatch.setattr(telemetry, "_PROCESS", tel)
    assert reader.read(None) is None          # a program without it
    opt = adamw(1e-3)
    params, batch = toy()
    run(staged(opt), params, opt.init(params), [batch] * 8)
    assert reader.read(None) == pytest.approx(100.0 * 6 / 8)
