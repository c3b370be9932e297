"""The port's program spans (``core/telemetry.py``): the bundle in scope,
spans at the layer boundaries, device time from CUDA events, and
``kernel.seconds``.

On the CPU at the reduced sizes: ``fedforecast-100m`` for the train step,
the round's pack, mask, sink and outer step, reduced ``hymba-1.5b``
(attention and SSM heads in every block) for prefill and decode. The CUDA
path of a device span runs on stand-in events (``FakeEvent``): what it
records, when it waits and how the pool reuses events.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import streaming, telemetry
from repro_torch.core.packing import pack_pytree
from repro_torch.core.secure_agg import mask_packed
from repro_torch.core.telemetry import _NULL_SPAN, Telemetry
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.optim import OUTER_REGISTRY, adamw
from repro_torch.training import make_train_step

CPU = torch.device("cpu")
SILOS = ["gridpower", "solarx", "windco"]
SECRET = b"s" * 32
LAYER_SPANS = {
    "train": ["train.step", "train.forward", "train.backward",
              "train.optimizer"],
    "pack_mask": ["secure.pack", "secure.mask"],
    "sink": ["sink.fold", "sink.fold", "sink.finalize",
             "kernel:masked_sum_stream"],
    "outer": ["outer.step"],
    "prefill": ["serve.prefill", "serve.logits"]
    + ["serve.attention", "serve.ssm", "serve.ffn"] * 2,
    "decode": ["serve.decode_step", "serve.logits"]
    + ["serve.attention", "serve.ssm", "serve.ffn"] * 2,
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trainer():
    model = build_model(get_config("fedforecast-100m").reduced(), device=CPU)
    params = model.init(model.generator(0))
    opt = adamw(3e-4)
    step = make_train_step(model, opt)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, model.cfg.vocab, (2, 17),
                                     generator=gen)}
    step(params, opt.init(params), batch)        # warm
    return step, opt, params, batch


@pytest.fixture(scope="module")
def server_model():
    model, params, batch = serve.setup("hymba-1.5b", reduced=True, batch=2,
                                       prompt_len=12, device=CPU)
    assert model.cfg.n_layers == 2
    return model, params, batch


def run_layer(layer, trainer, server_model):
    """One call of ``layer`` on the CPU; returns what it returned."""
    step, opt, params, batch = trainer
    if layer == "train":
        return step(params, opt.init(params), batch)
    if layer == "pack_mask":
        buf, _ = pack_pytree(params)
        return mask_packed(buf, SILOS[0], SILOS, SECRET, device=CPU)
    if layer == "sink":
        with telemetry.scope(Telemetry()):
            buf, _ = pack_pytree(params)
        sink = streaming.MaskedF32Sink(buf.shape[0], device=CPU, mesh=None)
        sink.fold(buf.numpy(), 1.0)
        sink.fold(buf, 1.0)
        return sink.finalize()
    if layer == "outer":
        outer = OUTER_REGISTRY["fedavgm"]()
        return outer.step(params, params, outer.init(params))
    model, sparams, sbatch = server_model
    n0 = model.cfg.n_meta_tokens + sbatch["tokens"].shape[1]
    # the decode step's prefill records into a bundle of its own
    aside = Telemetry() if layer == "decode" else telemetry.current()
    with torch.no_grad():
        with telemetry.scope(aside):
            logits, cache = model.prefill(sparams, sbatch,
                                          model.cache_len_for(n0 + 2))
        if layer == "prefill":
            return logits
        tok = torch.argmax(logits, -1)
        pos = torch.full((2, 1), n0, dtype=torch.int32)
        return model.decode_step(sparams, cache, tok, pos)


@contextlib.contextmanager
def spy_synchronize(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    yield calls


def fresh_process_bundle(monkeypatch, **kw):
    tel = Telemetry(recorder_cap=telemetry.PROCESS_RING, **kw)
    monkeypatch.setattr(telemetry, "_PROCESS", tel)
    return tel


def test_the_process_bundle_is_in_scope_and_off_by_default():
    tel = telemetry.process()
    assert telemetry.current() is tel
    assert not tel.enabled and not tel.recording
    assert tel.recorder_cap >= 8192
    board = Telemetry(enabled=True)
    with telemetry.scope(board):
        assert telemetry.current() is board
        with telemetry.scope(tel):
            assert telemetry.current() is tel
        assert telemetry.current() is board
    assert telemetry.current() is tel


@pytest.mark.parametrize("layer", sorted(LAYER_SPANS))
def test_off_every_span_is_the_null_span_and_nothing_records(
        layer, trainer, server_model, monkeypatch):
    tel = fresh_process_bundle(monkeypatch)
    for name in set(LAYER_SPANS[layer]):
        assert tel.span(name, device=CPU) is _NULL_SPAN
    with spy_synchronize(monkeypatch) as calls:
        run_layer(layer, trainer, server_model)
    assert tel.spans() == [] and calls == []


def test_off_a_sink_times_its_reduction_on_the_card_without_waiting(
        monkeypatch):
    """The sinks' kernel span used to synchronise the card inside the
    span; now it records two events and nothing waits."""
    fake_cuda_events(monkeypatch)
    sink = streaming.MaskedF32Sink(8, device=CPU, mesh=None,
                                   telemetry=Telemetry())
    sink.device = torch.device("cuda", 0)
    with spy_synchronize(monkeypatch) as calls:
        with sink._span("masked_sum"):
            pass
    assert calls == [] and FakeEvent.waits == 0
    snap = sink.telemetry.metrics.snapshot()["kernel.seconds"]
    assert snap["kernel=masked_sum_stream"]["count"] == 1
    assert FakeEvent.waits == 1                 # resolved at the snapshot


@pytest.mark.parametrize("layer", sorted(LAYER_SPANS))
def test_enabled_each_layer_records_its_spans(layer, trainer, server_model):
    tel = Telemetry(enabled=True)
    with telemetry.scope(tel):
        run_layer(layer, trainer, server_model)
    spans = tel.spans()
    assert sorted(s.name for s in spans) == sorted(LAYER_SPANS[layer])
    by_id = {s.span_id: s for s in spans}
    parents = {s.name: (by_id[s.parent_id].name if s.parent_id else None)
               for s in spans}
    top = {"train": "train.step", "prefill": "serve.prefill",
           "decode": "serve.decode_step"}.get(layer)
    for s in spans:
        assert s.t1 is not None and s.device == "cpu"
        assert s.device_s == pytest.approx(s.t1 - s.t0)
        if top is not None and s.name != top:
            assert parents[s.name] == top, s.name
    if top is None and layer != "sink":
        assert set(parents.values()) == {None}
    if layer == "sink":
        assert parents == {"sink.fold": None, "sink.finalize": None,
                           "kernel:masked_sum_stream": "sink.finalize"}
        # nothing moves onto a card on the CPU
        assert [s.attrs["bytes"] for s in spans
                if s.name == "sink.fold"] == [0, 0]


@pytest.mark.parametrize("name", sorted(OUTER_REGISTRY))
def test_each_outer_optimizer_steps_under_its_span(name, trainer):
    _, _, params, _ = trainer
    tel = Telemetry(enabled=True)
    outer = OUTER_REGISTRY[name]()
    with telemetry.scope(tel):
        new, _ = outer.step(params, params, outer.init(params))
    assert [s.name for s in tel.spans()] == ["outer.step"]
    assert set(new) == set(params)


@pytest.mark.parametrize("plane", ["masked_f32", "masked_int",
                                   "compressed_int8", "compressed_topk"])
def test_each_sink_folds_and_finalizes_under_its_spans(plane):
    t = 512
    rng = np.random.default_rng(0)
    tel = Telemetry(enabled=True)
    with telemetry.scope(tel):
        if plane == "masked_f32":
            sink = streaming.MaskedF32Sink(t, device=CPU, mesh=None)
            sink.fold(rng.standard_normal(t).astype(np.float32))
        elif plane == "masked_int":
            sink = streaming.ModularSink(t, mbits=16, grid=1e-3, device=CPU,
                                         mesh=None)
            sink.fold(rng.integers(0, 2 ** 16, t).astype(np.uint16))
        elif plane == "compressed_int8":
            sink = streaming.QuantSink(t, device=CPU, mesh=None)
            sink.fold("a", rng.integers(-127, 128, t).astype(np.int8),
                      np.ones(t // streaming.CHUNK or 1, np.float32), 1.0)
        else:
            sink = streaming.TopkSink(t, device=CPU)
            sink.fold("a", np.arange(4, dtype=np.int32),
                      np.ones(4, np.float32), 1.0)
        sink.finalize()
    names = [s.name for s in tel.spans()]
    assert names[0] == "sink.fold" and "sink.finalize" in names
    fold = tel.spans()[0]
    assert fold.attrs["bytes"] == 0
    assert tel.metrics.counter(streaming.COUNTER_H2D_BYTES,
                               plane=plane).read() == 0


def test_a_fold_counts_the_host_bytes_it_moves_onto_the_card():
    tel = Telemetry(enabled=True)
    buf = np.zeros(1000, np.float32)
    assert streaming._host_nbytes(buf) == 4000
    assert streaming._host_nbytes(torch.zeros(10, dtype=torch.int16)) == 20
    with tel.span("sink.fold") as sp:
        streaming._note_moved(tel, sp, torch.device("cuda", 0), "p", 4000)
    with tel.span("sink.fold") as sp:
        streaming._note_moved(tel, sp, CPU, "p", 4000)
    assert [s.attrs["bytes"] for s in tel.spans()] == [4000, 0]
    assert tel.metrics.counter(streaming.COUNTER_H2D_BYTES,
                               plane="p").read() == 4000


def test_a_profiler_session_records_with_the_bundle_disabled(
        trainer, server_model, monkeypatch):
    tel = fresh_process_bundle(monkeypatch)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tel.recording and not tel.enabled
        run_layer("train", trainer, server_model)
        run_layer("decode", trainer, server_model)
    want = LAYER_SPANS["train"] + LAYER_SPANS["decode"]
    assert sorted(s.name for s in tel.spans()) == sorted(want)
    assert not tel.recording
    run_layer("train", trainer, server_model)
    run_layer("pack_mask", trainer, server_model)
    assert len(tel.spans()) == len(want)


def secure_round(tel: Telemetry) -> str:
    """One secure FedAvg round of three silos on the CPU, with ``tel`` on
    the board; returns the run's id."""
    from repro_torch.core import Consortium
    from repro_torch.data.synthetic import make_silo_datasets
    con = Consortium(SILOS, seed=0, master_key=b"k" * 32, device="cpu",
                     telemetry=tel)
    contract = con.negotiate({
        "arch": "fedforecast-100m", "rounds": 1, "local_steps": 2,
        "batch_size": 2, "secure_aggregation": True,
        "data_schema": {"vocab": 512, "seq_len": 32}})
    job = con.server.job_creator.from_contract(contract)
    run_id = con.start(job, make_silo_datasets(3, vocab=512, seq_len=32,
                                               seed=1))
    assert con.run_to_completion() == "done"
    return run_id


def test_scope_nests_the_train_step_under_the_boards_client_train():
    """A consortium with its board's tracing on: each node's and the
    server's tick put the board's bundle in scope."""
    tel = Telemetry(enabled=True)
    run_id = secure_round(tel)
    spans = tel.spans(run_id)
    by_id = {s.span_id: s for s in spans}
    steps = [s for s in spans if s.name == "train.step"]
    assert len(steps) == 3 * 2
    for s in steps:
        parent = by_id[s.parent_id]
        assert parent.name == "client.train" and s.actor == parent.actor
    masks = [s for s in spans if s.name == "secure.mask"]
    assert len(masks) == 3
    # the server's tick scopes the board's bundle too
    (outer,) = [s for s in spans if s.name == "outer.step"]
    assert by_id[outer.parent_id].name == "sched.tick"
    assert all(by_id[s.parent_id].name == "client.compress" for s in masks)
    events = [e for e in tel.export_trace(run_id)["traceEvents"]
              if e["ph"] == "X" and e["name"] == "train.step"
              and e["pid"] == 1 and e["args"].get("run_id") == run_id]
    assert len(events) == 6
    assert all(e["args"]["device_ms"] > 0 for e in events)


@pytest.mark.parametrize("enabled", [False, True])
def test_kernel_seconds_counts_each_aggregation(enabled):
    tel = Telemetry(enabled=enabled)
    bufs = [np.full(64, float(i), np.float32) for i in range(3)]
    for _ in range(2):
        out = streaming.stream_masked_packed(
            bufs, np.ones(3, np.float32), device=CPU, telemetry=tel,
            mesh=None)
    assert torch.equal(out, torch.full((64,), 3.0))
    with tel.kernel_span("masked_sum", device=CPU):
        pass
    ks = tel.metrics.snapshot()["kernel.seconds"]
    assert ks["kernel=masked_sum_stream"]["count"] == 2
    assert ks["kernel=masked_sum"]["count"] == 1
    assert tel.metrics.snapshot()["kernel.seconds"][
        "kernel=masked_sum"]["count"] == 1         # counted once
    kernel_spans = [s.name for s in tel.spans() if s.cat == "kernel"]
    assert kernel_spans == (["kernel:masked_sum_stream"] * 2
                            + ["kernel:masked_sum"] if enabled else [])


# ---------------------------------------------------------------------------
# the CUDA path, on stand-in events
# ---------------------------------------------------------------------------
class FakeEvent:
    """``torch.cuda.Event``'s surface: record stamps a count, elapsed time
    is the stamps' difference in ms, synchronize is counted."""
    clock = 0
    waits = 0
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        FakeEvent.clock += 1
        self.t = FakeEvent.clock

    def synchronize(self):
        FakeEvent.waits += 1

    def elapsed_time(self, end):
        return float(end.t - self.t)


def fake_cuda_events(monkeypatch):
    FakeEvent.clock = FakeEvent.waits = FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda i=None: None)
    monkeypatch.setattr(telemetry, "_EVENTS", {})


def test_a_device_span_waits_for_its_end_event_only_when_read(monkeypatch):
    fake_cuda_events(monkeypatch)
    tel = Telemetry(enabled=True)
    dev = torch.device("cuda", 0)
    with spy_synchronize(monkeypatch) as calls:
        with tel.span("outer", device=dev):
            with tel.span("inner", device=dev):
                pass
        assert FakeEvent.made == 4 and FakeEvent.waits == 0
        outer, inner = sorted(tel.spans(), key=lambda s: s.span_id)
        assert inner.device_s == pytest.approx(1e-3)   # 1 ms between
        assert outer.device_s == pytest.approx(3e-3)
        assert FakeEvent.waits == 2 and outer.device_s == 3e-3
        assert FakeEvent.waits == 2                  # kept once resolved
        # resolved pairs go back to the pool and are recorded again
        with tel.span("again", device=dev):
            pass
    assert FakeEvent.made == 4 and calls == []
    trace = tel.export_trace(None)
    ms = {e["name"]: e["args"]["device_ms"]
          for e in trace["traceEvents"] if e["ph"] == "X"}
    assert ms == {"outer": pytest.approx(3.0), "inner": pytest.approx(1.0),
                  "again": pytest.approx(1.0)}


def test_a_host_span_has_no_device_time_in_the_trace():
    tel = Telemetry(enabled=True)
    with tel.span("client.fetch", actor="a", run_id="r"):
        with tel.span("train.step", device=CPU) as sp:
            pass
    assert sp.actor == "a" and sp.run_id == "r"      # inherited
    args = {e["name"]: e["args"] for e in tel.export_trace("r")[
        "traceEvents"] if e["ph"] == "X"}
    assert "device_ms" not in args["client.fetch"]
    assert args["train.step"]["device_ms"] >= 0.0


def test_kernel_spans_fold_into_the_histogram_without_a_snapshot(
        monkeypatch):
    tel = Telemetry()
    for _ in range(telemetry.KERNEL_BACKLOG + 1):
        with tel.kernel_span("k", device=CPU):
            pass
    assert len(tel._kernels) == telemetry.KERNEL_BACKLOG // 2 + 1
    assert tel.metrics.histogram("kernel.seconds", kernel="k").count \
        == telemetry.KERNEL_BACKLOG // 2
    assert tel.metrics.snapshot()["kernel.seconds"]["kernel=k"]["count"] \
        == telemetry.KERNEL_BACKLOG + 1


def test_the_servers_reduction_is_timed_on_its_device(monkeypatch):
    """The server's ``kernel:masked_sum`` is a device span on the
    server's device, so on a card ``kernel.seconds`` holds the events'
    time. The round runs on the CPU; the server's own reduction span is
    opened on a stand-in card."""
    fake_cuda_events(monkeypatch)
    tel = Telemetry(enabled=True)
    kernel_span = tel.kernel_span

    def on_card(kernel, *, device=None, **kw):
        if kernel == "masked_sum" and device == CPU:
            device = torch.device("cuda", 0)
        return kernel_span(kernel, device=device, **kw)

    monkeypatch.setattr(tel, "kernel_span", on_card)
    with spy_synchronize(monkeypatch) as calls:
        run_id = secure_round(tel)
    assert calls == [] and FakeEvent.made == 2
    (sp,) = [s for s in tel.spans(run_id) if s.name == "kernel:masked_sum"]
    assert sp.device == "cuda" and sp.attrs["scheme"] == "secure"
    assert sp.device_s == pytest.approx(1e-3)  # the events' 1 ms apart
    ks = tel.metrics.snapshot()["kernel.seconds"]["kernel=masked_sum"]
    assert ks["count"] == 1 and ks["total"] == pytest.approx(1e-3)
