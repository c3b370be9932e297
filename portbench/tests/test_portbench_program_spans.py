"""The per-layer metrics that read the program's own spans
(``repro_torch.core.telemetry.process().spans()``): each returns the
value its planted spans give, and ``None`` where it finds nothing, as
on a program that records no such span."""
import pytest

from portbench import harness

SR, PF, DC = ("fedforecast-100m.secure_round", "hymba-1.5b.prefill",
              "hymba-1.5b.decode")
# name: (cell, what it reads, the value of PLANTED)
READERS = {
    "fwd_ms.round": (SR, "train.forward", 15.0),
    "bwd_ms.round": (SR, "train.backward", 60.0),
    "opt_ms.round": (SR, "train.optimizer", 25.0),
    "h2d_gbps.round": (SR, "sink.fold", 4.0),
    "attn_ms.prefill": (PF, "serve.attention", 4.0),
    "ssm_ms.prefill": (PF, "serve.ssm", 6.0),
    "ffn_ms.prefill": (PF, "serve.ffn", 2.0),
    "attn_ms.decode": (DC, "serve.attention", 0.5),
    "ssm_ms.decode": (DC, "serve.ssm", 1.5),
    "ffn_ms.decode": (DC, "serve.ffn", 1.0),
}


def _step(fwd, bwd, opt):
    return ("train.step", fwd + bwd + opt, [
        ("train.forward", fwd), ("train.backward", bwd),
        ("train.optimizer", opt)])


def _block(parent, attn, ssm, ffn, n=2):
    return (parent, n * (attn + ssm + ffn) + 1e-3,
            [("serve.attention", attn), ("serve.ssm", ssm),
             ("serve.ffn", ffn)] * n + [("serve.logits", 1e-4)])


# device seconds: two train steps, three folds (one moved nothing), two
# prefills and four decode steps of two blocks each
PLANTED = [
    _step(0.010, 0.050, 0.020), _step(0.020, 0.070, 0.030),
    ("sink.fold", 1.0, [], {"bytes": 4e9}),
    ("sink.fold", 0.5, [], {"bytes": 2e9}),
    ("sink.fold", 0.2, [], {"bytes": 0}),
    ("sink.finalize", 0.01, [("kernel:masked_sum_stream", 0.005)]),
    ("outer.step", 1e-4),
    _block("serve.prefill", 0.001, 0.002, 0.0005),
    _block("serve.prefill", 0.003, 0.004, 0.0015),
] + [_block("serve.decode_step", 0.00025, 0.00075, 0.0005)] * 4


@pytest.fixture
def process(monkeypatch):
    from repro_torch.core import telemetry
    tel = telemetry.Telemetry(enabled=True)
    monkeypatch.setattr(telemetry, "_PROCESS", tel)
    return tel


def plant(tel, name, device_s, children=(), attrs=None):
    with tel.span(name, attrs=attrs) as sp:
        for child in children:
            plant(tel, *child)
    sp._device_s = device_s


def test_every_reader_is_registered_for_its_cell():
    bench = harness.benchmark()
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for name, (cell, _, _) in READERS.items():
        m = by_name[name]
        assert m["source"] == "program_span" and m["workloads"] == [cell]
        assert callable(harness.metric_reader(name))


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_its_planted_spans(name, process):
    for spec in PLANTED:
        plant(process, *spec)
    assert harness.metric_reader(name)(None) == pytest.approx(
        READERS[name][2])


def pruned(spec, name):
    """``spec`` without any span called ``name``."""
    head, children = spec[:2], spec[2] if len(spec) > 2 else []
    return (*head, [pruned(c, name) for c in children if c[0] != name],
            *spec[3:])


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_none_without_its_spans(name, process):
    span = READERS[name][1]
    for spec in PLANTED:
        if spec[0] != span:
            plant(process, *pruned(spec, span))
    assert process.spans() and all(s.name != span for s in process.spans())
    assert harness.metric_reader(name)(None) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_none_from_a_program_without_process_spans(
        name, monkeypatch):
    from repro_torch.core import telemetry
    monkeypatch.delattr(telemetry, "process")
    assert harness.metric_reader(name)(None) is None


def test_an_open_or_stray_span_is_not_read(process):
    """A decode step's blocks do not count for the prefill, nor an open
    span for its mean."""
    plant(process, *_block("serve.decode_step", 0.001, 0.001, 0.001))
    assert harness.metric_reader("attn_ms.prefill")(None) is None
    with process.span("train.forward"):
        assert harness.metric_reader("fwd_ms.round")(None) is None
