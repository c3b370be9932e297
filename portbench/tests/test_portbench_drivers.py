"""Each driver's loop rehearsed on the CPU at the program's test size, a
run without a card, and the correctness check seen to fail: with the
timed path broken underneath (on the CPU), and for the control at the
cell's own size (on the card)."""
import time

import pytest
import torch

from portbench import bench, harness

SMALL = {
    "fedforecast-100m.secure_round": dict(local_steps=3, batch=2, seq_len=16,
                                          pool_rounds=2),
    "hymba-1.5b.prefill": dict(batch=2, prompt_len=24, prompt_pool=4,
                               checked_requests=3),
    "hymba-1.5b.decode": dict(batch=2, prompt_len=24, gen=4, prompt_pool=2),
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rehearse(workload, seconds=0.2, **kw):
    b = harness.benchmark()
    ctx = bench.make_context(workload, 20260917, seconds, False,
                             torch.device("cpu"), bench=b, reduced=True,
                             traffic_changes=SMALL[workload], **kw)
    return bench.execute(ctx, b)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_each_loop_rehearses_on_the_cpu(workload):
    outcome, checks, metrics = rehearse(workload)
    b = harness.benchmark()
    assert set(metrics) == {m["name"] for m in
                            harness.metrics_of("end_to_end", workload, b)}
    assert all(v["value"] > 0 for v in metrics.values())
    assert harness.checks_ok(checks), checks
    assert outcome.record is None and outcome.memory_peak_bytes == 0
    assert outcome.attempted > 0 and outcome.failed == 0


def test_a_run_without_a_card_fails(capsys):
    assert not torch.cuda.is_available()
    rc = bench.main(["--workload", "hymba-1.5b.prefill", "--seed",
                     str(2**31 + 5), "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


# --- faults planted in the program, one at a time -----------------------
def _unchanged_state(monkeypatch):
    import repro_torch.training as training
    real = training.make_train_step

    def make(model, opt):
        step = real(model, opt)

        def frozen(params, opt_state, batch):
            _, opt_state, met = step(params, opt_state, batch)
            return params, opt_state, met
        return frozen
    monkeypatch.setattr(training, "make_train_step", make)


def _unchanged_after(calls):
    """A step that is right for its first ``calls`` calls, then returns
    its state unchanged: a path that changes once it is warm."""
    def plant(monkeypatch):
        import repro_torch.training as training
        real = training.make_train_step

        def make(model, opt):
            step = real(model, opt)
            n = [0]

            def late(params, opt_state, batch):
                n[0] += 1
                new, opt_state, met = step(params, opt_state, batch)
                return (new if n[0] <= calls else params), opt_state, met
            return late
        monkeypatch.setattr(training, "make_train_step", make)
    return plant


def _half_batch(monkeypatch):
    import repro_torch.training as training
    real = training.make_train_step

    def make(model, opt):
        step = real(model, opt)

        def half(params, opt_state, batch):
            rows = batch["tokens"].shape[0] // 2
            return step(params, opt_state, {"tokens": batch["tokens"][:rows]})
        return half
    monkeypatch.setattr(training, "make_train_step", make)


def _silo_left_out(monkeypatch):
    from repro_torch.core.streaming import MaskedF32Sink
    real = MaskedF32Sink.fold

    def fold(self, buf, weight=1.0):
        if self.n_folded == 1:               # the second silo's update
            buf = torch.zeros(self.t)
        return real(self, buf, weight)
    monkeypatch.setattr(MaskedF32Sink, "fold", fold)


def _altered_logits(method):
    def plant(monkeypatch):
        from repro_torch.models.model import Model
        real = getattr(Model, method)

        def altered(self, *args, **kw):
            logits, cache = real(self, *args, **kw)
            logits = logits.clone()
            logits[..., 0] = logits.max() + 1.0   # token 0 served
            return logits, cache
        monkeypatch.setattr(Model, method, altered)
    return plant


def _half_prefill(monkeypatch):
    from repro_torch.models.model import Model
    real = Model.prefill

    def half(self, params, batch, cache_len):
        rows = batch["tokens"].shape[0] // 2
        logits, cache = real(self, params, {"tokens": batch["tokens"][:rows]},
                             cache_len)
        return torch.cat([logits, logits]), cache
    monkeypatch.setattr(Model, "prefill", half)


ROUND = harness.traffic("secure_round")
SETUP_CALLS = len(ROUND["silos"]) * ROUND["warmup_steps"]
ROUND_CALLS = len(ROUND["silos"]) * SMALL[
    "fedforecast-100m.secure_round"]["local_steps"]

FAULTS = [
    ("fedforecast-100m.secure_round", _unchanged_state),
    ("fedforecast-100m.secure_round", _half_batch),
    ("fedforecast-100m.secure_round", _unchanged_after(SETUP_CALLS)),
    ("fedforecast-100m.secure_round", _silo_left_out),
    ("hymba-1.5b.prefill", _altered_logits("prefill")),
    ("hymba-1.5b.prefill", _half_prefill),
    ("hymba-1.5b.decode", _altered_logits("decode_step")),
]


@pytest.mark.parametrize("workload,plant", FAULTS,
                         ids=[f"{w}-{i}" for i, (w, _) in enumerate(FAULTS)])
def test_a_broken_timed_path_is_not_correct(workload, plant, monkeypatch):
    plant(monkeypatch)
    _, checks, _ = rehearse(workload)
    assert not harness.checks_ok(checks), checks


class _Ticks:
    """A clock that moves one second each time it is read: a window of
    1.5 s then holds two rounds, however busy the host is."""

    def __init__(self):
        self.now = time.perf_counter()

    def perf_counter(self):
        self.now += 1.0
        return self.now


def test_a_step_broken_after_the_first_round_is_not_correct(monkeypatch):
    """The window's last round is checked too, not only its first."""
    _unchanged_after(SETUP_CALLS + ROUND_CALLS)(monkeypatch)
    real_driver = harness.driver

    def ticking(name):
        mod = real_driver(name)
        mod.time = _Ticks()
        return mod
    monkeypatch.setattr(harness, "driver", ticking)
    outcome, checks, _ = rehearse("fedforecast-100m.secure_round",
                                  seconds=1.5)
    assert outcome.attempted == 2
    assert outcome.readings["change_gap.first"] < 1e-3
    assert not harness.checks_ok(checks), checks


# --- the control at the cell's own size ---------------------------------
CONTROL_SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


@pytest.mark.card
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_control_fails_at_the_cells_size(card, workload):
    """The reference in the precision below the configuration's (fp8
    projections; a bf16 aggregate) in the program's place fails the
    cell's limits, where the program passes them."""
    b = harness.benchmark()
    seconds = 30.0 if workload.endswith("decode") else 2.0
    for seed in CONTROL_SEEDS:
        ctx = bench.make_context(workload, seed, seconds, False, card,
                                 bench=b, control=True)
        outcome, checks, _ = bench.execute(ctx, b)
        assert harness.checks_ok(checks), checks
        low = harness.compared(outcome.control["control"], ctx.limits)
        assert not harness.checks_ok(low), low
