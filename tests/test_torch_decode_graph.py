"""The decode step replayed as a CUDA graph (``models/decode_graph.py``).

On the CPU: (1) the graph's precondition, over the reduced config of each
block family of the zoo: ``decode_step`` hands back the cache tree it was
given, every leaf written in place at its address, step after step;
(2) the runner's policy, with a stand-in graph class (``FakeGraph``) in
place of ``torch.cuda.CUDAGraph``: the key, eager then capture then
replay, no capture while the telemetry records, what stays eager, the
bounded cache of graphs, logits that never alias, the counter; (3) the
benchmark's reader of the counter. The real graph is held against the
eager step on the card by ``chip_smoke.py``'s ``decode graph`` phase.
"""
import importlib.util
from pathlib import Path

import pytest
import torch
import torch.autograd.profiler as torch_profiler

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core import telemetry
from repro_torch.core.telemetry import Telemetry
from repro_torch.launch import dryrun, serve
from repro_torch.models import build_model
from repro_torch.models.decode_graph import (ALIGN, CAPACITY, CudaGraph,
                                             DecodeGraphs)
from torch_graph_stand_in import FakeGraph

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
# one reduced config of each block family the zoo has
FAMILIES = {
    "dense": "fedforecast-100m",
    "hybrid": "hymba-1.5b",
    "ssm": "mamba2-780m",
    "mla": "minicpm3-4b",
    "moe": "olmoe-1b-7b",
    "encdec": "seamless-m4t-large-v2",
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_graphs():
    FakeGraph.made = []
    yield


def paths():
    """The process bundle's ``serve.decode_graph`` counts by path."""
    return telemetry.process().metrics.labeled("serve.decode_graph", "path")


def moved(before):
    after = paths()
    return {p: after.get(p, 0) - before.get(p, 0)
            for p in ("eager", "capture", "replay")}


def toy_step(params, cache, token, pos):
    """A decode step in miniature: the state written in place, logits
    read from it."""
    cache["state"].mul_(params["decay"]).add_(token * pos)
    return params["w"] * cache["state"].sum(-1, keepdim=True), cache


def toy(seed=0, B=3):
    gen = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(5, generator=gen),
              "decay": torch.rand(B, 4, generator=gen)}
    cache = {"state": torch.randn(B, 4, generator=gen)}
    return params, cache


def clone(t):
    return tree.tree_map(torch.clone, t)


def token_pos(i, B=3):
    return (torch.full((B, 1), i + 2, dtype=torch.int64),
            torch.full((B, 1), 10 + i, dtype=torch.int32))


@torch.no_grad()
def run(runner, params, cache, steps, start=0):
    """``steps`` toy steps through ``runner``; their logits."""
    out = []
    for i in range(start, start + steps):
        tok, pos = token_pos(i)
        logits, got = runner(toy_step, CPU, params, cache, tok, pos)
        assert got is cache
        out.append(logits)
    return out


# ---------------------------------------------------------------------------
# (1) the graph's precondition, every block family
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_decode_step_keeps_the_cache_tree_and_its_addresses(family):
    cfg = get_config(FAMILIES[family]).reduced()
    model = build_model(cfg, device=CPU)
    params = model.init(model.generator(0))
    batch = serve.make_batch(cfg, 2, 12, 0, CPU)
    n0 = serve.stream_len(model, batch)
    with torch.no_grad():
        logits, cache = model.prefill(params, batch, model.cache_len_for(
            n0 + 2))
        if not cfg.is_encoder_decoder:      # the cache a prefill fills in
            assert layout(cache) == layout(model.init_cache(
                2, model.cache_len_for(n0 + 2)))
        leaves = tree.leaves(cache)
        ptrs = [a.data_ptr() for a in leaves]
        tok = torch.argmax(logits, -1)
        for i in range(2):
            before = [a.clone() for a in leaves]
            pos = torch.full((2, 1), n0 + i, dtype=torch.int32)
            logits, got = model.decode_step(params, cache, tok, pos)
            assert got is cache
            now = tree.leaves(got)
            assert all(a is b for a, b in zip(now, leaves))
            assert [a.data_ptr() for a in now] == ptrs
            # the step wrote its cache in place
            assert any(not torch.equal(a, b) for a, b in zip(now, before))
            tok = torch.argmax(logits, -1)


def layout(tree_):
    return [(a.shape, a.dtype) for a in tree.leaves(tree_)]


def one_buffer(tree_) -> bool:
    base = tree.leaves(tree_)[0].untyped_storage().data_ptr()
    return all(a.untyped_storage().data_ptr() == base
               for a in tree.leaves(tree_))


@pytest.mark.parametrize("family", ["hybrid", "encdec"])
def test_on_the_graphs_path_the_cache_is_made_first_as_one_buffer(
        family, monkeypatch):
    """On the graphs' path (the stand-in's, on the CPU) a prefill makes
    its cache before its activations, as one buffer (``init_cache``'s, or
    the enc-dec's cache), and fills it with what the plain path's stacks
    hold, bitwise."""
    cfg = get_config(FAMILIES[family]).reduced()
    model = build_model(cfg, device=CPU)
    params = model.init(model.generator(0))
    batch = serve.make_batch(cfg, 2, 12, 0, CPU)
    with torch.no_grad():
        _, plain = model.prefill(params, batch, 16)
    assert not one_buffer(plain)
    model._graphs = DecodeGraphs(graph=FakeGraph)
    calls, made = [], []
    for name in ("init_cache", "_encdec_cache", "_assemble_stream",
                 "_encode"):
        def spy(*a, _f=getattr(model, name), _n=name, **k):
            calls.append(_n)
            out = _f(*a, **k)
            if _n in ("init_cache", "_encdec_cache"):
                made.append(out)
            return out
        monkeypatch.setattr(model, name, spy)
    with torch.no_grad():
        _, cache = model.prefill(params, batch, 16)
    first = "_encode" if family == "encdec" else "_assemble_stream"
    assert calls.index(first) > 0 and cache is made[0]
    assert one_buffer(cache) and layout(cache) == layout(plain)
    for a, b in zip(tree.leaves(cache), tree.leaves(plain)):
        assert torch.equal(a, b)


def test_stack_on_the_graphs_path():
    """One buffer a stack, each leaf at a multiple of ``ALIGN`` bytes,
    or ``into``'s leaves where they fit; the plain stacks' values."""
    gen = torch.Generator().manual_seed(3)
    trees = [{"a": {"k": torch.randn(2, 3, generator=gen),
                    "pos": torch.randint(0, 9, (5,), generator=gen,
                                         dtype=torch.int32)},
              "s": torch.randn(7, dtype=torch.float64, generator=gen)
              .to(torch.bfloat16)} for _ in range(3)]
    want = DecodeGraphs().stack(CPU, trees)          # off the path: plain
    assert not one_buffer(want)
    runner = DecodeGraphs(graph=FakeGraph)
    assert not one_buffer(runner.stack(CPU, trees))  # autograd on: plain
    with torch.no_grad():
        got = runner.stack(CPU, trees)
        into = tree.tree_map(torch.zeros_like, got)
        assert runner.stack(CPU, trees, into) is into
        wrong = {**into, "s": torch.zeros(3, 8, dtype=torch.bfloat16)}
        fresh = runner.stack(CPU, trees, wrong)
    assert tree.flatten(got)[1] == tree.flatten(want)[1]
    assert one_buffer(got) and layout(got) == layout(want)
    base = tree.leaves(got)[0].untyped_storage().data_ptr()
    assert all((a.data_ptr() - base) % ALIGN == 0 for a in tree.leaves(got))
    assert fresh is not wrong and one_buffer(fresh)
    for out in (got, into, fresh):
        for a, b in zip(tree.leaves(out), tree.leaves(want)):
            assert a.is_contiguous() and torch.equal(a, b)


# ---------------------------------------------------------------------------
# (2) the runner's policy
# ---------------------------------------------------------------------------
def test_the_key_follows_pointers_shapes_strides_and_dtypes():
    runner = DecodeGraphs(graph=FakeGraph)
    params, cache = toy()
    tok, pos = token_pos(0)
    key = runner._key(params, cache, tok, pos)
    assert runner._key(params, cache, tok.clone(), pos.clone()) == key
    s = cache["state"]
    others = [
        {"state": s.clone()},                        # pointer
        {"state": s.view(4, 3)},                     # shape
        {"state": s.t().contiguous().t()},           # stride (and pointer)
        {"state": torch.as_strided(s, (3, 4), (1, 3))},   # stride alone
        {"state": s.view(torch.int32)},              # dtype
    ]
    for other in others:
        assert runner._key(params, other, tok, pos) != key
    assert runner._key({**params, "w": params["w"].clone()}, cache, tok,
                       pos) != key
    assert runner._key(params, cache, tok[:2], pos[:2]) != key
    assert runner._key(params, cache, tok[:, 0], pos) != key


def test_eager_first_capture_second_replay_after():
    runner = DecodeGraphs(graph=FakeGraph)
    params, cache = toy()
    twin = clone(cache)
    before = paths()
    got = run(runner, params, cache, 5)
    want = [toy_step(params, twin, *token_pos(i))[0] for i in range(5)]
    assert moved(before) == {"eager": 1, "capture": 1, "replay": 3}
    assert len(FakeGraph.made) == 1 and FakeGraph.made[0].replays == 4
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(cache["state"], twin["state"])


def test_no_capture_while_the_telemetry_records(monkeypatch):
    runner = DecodeGraphs(graph=FakeGraph)
    params, cache = toy()
    before = paths()
    monkeypatch.setattr(torch_profiler, "_is_profiler_enabled", True)
    run(runner, params, cache, 3)
    assert moved(before) == {"eager": 3, "capture": 0, "replay": 0}
    assert not FakeGraph.made
    with telemetry.scope(Telemetry(enabled=True)):
        monkeypatch.setattr(torch_profiler, "_is_profiler_enabled", False)
        run(runner, params, cache, 2, start=3)
    assert moved(before) == {"eager": 5, "capture": 0, "replay": 0}
    run(runner, params, cache, 1, start=5)
    assert moved(before) == {"eager": 5, "capture": 1, "replay": 0}
    # a captured key still replays under the profiler
    monkeypatch.setattr(torch_profiler, "_is_profiler_enabled", True)
    run(runner, params, cache, 2, start=6)
    assert moved(before) == {"eager": 5, "capture": 1, "replay": 2}


def test_cpu_grad_and_dtensor_inputs_stay_eager():
    params, cache = toy()
    before = paths()
    # the CUDA graph class on the CPU: never engages, never touches CUDA
    run(DecodeGraphs(graph=CudaGraph), params, cache, 3)
    runner = DecodeGraphs(graph=FakeGraph)
    with torch.enable_grad():
        for i in range(3):
            runner(toy_step, CPU, params, cache, *token_pos(i))
    with dryrun.fake_world(1):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate
        mesh = init_device_mesh("cpu", (1,))
        dcache = {"state": DTensor.from_local(cache["state"], mesh,
                                              [Replicate()],
                                              run_check=False)}
        for i in range(3):
            runner(lambda p, c, t, q: (None, c), CPU, params, dcache,
                   *token_pos(i))
    assert moved(before) == {"eager": 9, "capture": 0, "replay": 0}
    assert not FakeGraph.made and not runner._keys


def test_the_cache_of_graphs_is_bounded():
    runner = DecodeGraphs(graph=FakeGraph)
    params, _ = toy()
    caches = [toy(seed)[1] for seed in range(CAPACITY + 1)]
    before = paths()
    for c in caches:                    # each a new key: eager, then graph
        run(runner, params, c, 2)
        assert len(runner._keys) <= CAPACITY
    n = len(caches)
    assert moved(before) == {"eager": n, "capture": n, "replay": 0}
    assert len(FakeGraph.made) == n
    run(runner, params, caches[-1], 1)  # kept: replays
    run(runner, params, caches[0], 1)   # evicted: a new key again
    assert moved(before) == {"eager": n + 1, "capture": n, "replay": 1}
    kept = list(runner._keys.values())
    assert len(kept) == CAPACITY and kept[-1] is None
    assert all(e is not None for e in kept[:-1])


def test_returned_logits_never_alias():
    runner = DecodeGraphs(graph=FakeGraph)
    params, cache = toy()
    got = run(runner, params, cache, 5)
    kept = [g.clone() for g in got]
    run(runner, params, cache, 2, start=5)
    assert len({g.data_ptr() for g in got}) == len(got)
    assert all(torch.equal(g, k) for g, k in zip(got, kept))
    assert all(g.data_ptr() != FakeGraph.made[0].out[0].data_ptr()
               for g in got)


def test_the_counter_counts_each_path(monkeypatch):
    tel = Telemetry(recorder_cap=telemetry.PROCESS_RING)
    monkeypatch.setattr(telemetry, "_PROCESS", tel)
    runner = DecodeGraphs(graph=FakeGraph)
    params, cache = toy()
    run(runner, params, cache, 4)
    with torch.enable_grad():
        runner(toy_step, CPU, params, cache, *token_pos(4))
    snap = tel.metrics.snapshot()["serve.decode_graph"]
    assert snap == {"path=eager": 2, "path=capture": 1, "path=replay": 2}


def test_a_model_on_a_stand_in_graph_matches_its_eager_steps():
    """Reduced hymba-1.5b through ``Model.decode_step`` on the stand-in,
    two caches interleaved A, B, A, B, against the same steps eagerly on
    copies of the caches: the input buffers, the copies of the logits and
    the caches written in place, bitwise."""
    model, params, _ = serve.setup("hymba-1.5b", reduced=True, batch=2,
                                   prompt_len=12, device=CPU)
    model._graphs = DecodeGraphs(graph=FakeGraph)
    n0 = model.cfg.n_meta_tokens + 12
    cache_len = model.cache_len_for(n0 + 6)
    streams = []
    with torch.no_grad():
        for seed in (1, 2):
            batch = serve.make_batch(model.cfg, 2, 12, seed, CPU)
            logits, cache = model.prefill(params, batch, cache_len)
            tok = torch.argmax(logits, -1)
            streams.append([cache, tok, clone(cache), tok])
        before = paths()
        for i in range(6):
            pos = torch.full((2, 1), n0 + i, dtype=torch.int32)
            for s in streams:
                cache, tok, ecache, etok = s
                logits, _ = model.decode_step(params, cache, tok, pos)
                elogits, _ = model._decode(params, ecache, etok, pos)
                assert torch.equal(logits, elogits)
                s[1], s[3] = (torch.argmax(logits, -1),
                              torch.argmax(elogits, -1))
    assert moved(before) == {"eager": 2, "capture": 2, "replay": 8}
    for cache, _, ecache, _ in streams:
        for a, b in zip(tree.leaves(cache), tree.leaves(ecache)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (3) the benchmark's reader
# ---------------------------------------------------------------------------
def test_the_benchmarks_reader_reads_the_replay_share(monkeypatch):
    path = ROOT / "portbench" / "metrics" / "graph_share.decode.py"
    spec = importlib.util.spec_from_file_location("graph_share", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    tel = Telemetry(recorder_cap=telemetry.PROCESS_RING)
    monkeypatch.setattr(telemetry, "_PROCESS", tel)
    assert reader.read(None) is None          # a program without it
    runner = DecodeGraphs(graph=FakeGraph)
    params, cache = toy()
    run(runner, params, cache, 8)
    assert reader.read(None) == pytest.approx(100.0 * 6 / 8)
