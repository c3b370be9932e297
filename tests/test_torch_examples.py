"""The port's twins of the JAX examples (``examples/*_torch.py``).

* ``governance_negotiation_torch.py`` against ``governance_negotiation.py``:
  both run in this process with ``uuid.uuid4`` and ``time.time`` fixed to
  the same sequences, and the provenance trail (``governance_report``:
  every record, its ids, timestamps and hash chain included) and each
  proposal's author, parameter, value and status are equal.
* ``cross_silo_forecasting_torch.py`` and ``serve_model_torch.py`` run
  once with ``--device cpu`` at their reduced defaults and finish: phase
  ``done``, the metadata chain intact, and predictions of the shape and
  vocabulary range the JAX examples print (a 6-bin forecast a provider;
  3 request batches of 4 prompts x 4 tokens).
* Without ``--device`` each twin needs CUDA: here it raises.
"""
import importlib.util
import itertools
import time
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TWINS = ["governance_negotiation_torch", "cross_silo_forecasting_torch",
         "serve_model_torch"]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixed(monkeypatch):
    """``uuid.uuid4`` and ``time.time`` from fresh fixed sequences."""
    ids = itertools.count(1)
    ticks = itertools.count(1)
    monkeypatch.setattr(uuid, "uuid4",
                        lambda: uuid.UUID(int=next(ids) << 80))
    monkeypatch.setattr(time, "time", lambda: 1.7e9 + next(ticks))


def _proposals(cockpit):
    return [(p.author, p.parameter, p.value, p.status)
            for p in cockpit.proposals.values()]


def test_governance_twin_matches_the_jax_example(monkeypatch, capsys):
    ref_mod = _load("governance_negotiation")
    made = {}

    class Cockpit(ref_mod.GovernanceCockpit):
        def __init__(self, participants, md):
            super().__init__(participants, md)
            made["cockpit"], made["md"] = self, md

    monkeypatch.setattr(ref_mod, "GovernanceCockpit", Cockpit)
    _fixed(monkeypatch)
    ref_mod.main()
    ref_out = capsys.readouterr().out
    ref_report = ref_mod.governance_report(made["md"])

    twin = _load("governance_negotiation_torch")
    _fixed(monkeypatch)
    md, cockpit = twin.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert twin.governance_report(md) == ref_report
    assert len(ref_report) == 26
    assert _proposals(cockpit) == _proposals(made["cockpit"])
    assert [s for _, _, _, s in _proposals(cockpit)].count("rejected") == 1
    assert md.verify_chain()
    assert out.splitlines()[:-2] == ref_out.splitlines()
    assert out.splitlines()[-1].startswith("wall ")


def test_forecasting_twin_runs_on_the_cpu(one_thread, capsys):
    got = _load("cross_silo_forecasting_torch").main(["--device", "cpu"])
    assert got["phase"] == "done" and got["chain_ok"]
    assert len(got["loss_curve"]) == 3
    assert np.all(np.isfinite(got["loss_curve"]))
    assert sorted(got["forecasts"]) == sorted(
        ["nordwind-energie", "solarpark-rhein", "stadtwerke-ka"])
    for f in got["forecasts"].values():
        assert f.shape == (6,)
        assert 0 <= f.min() and f.max() < got["vocab"] == 512
    assert "metadata chain intact: True" in capsys.readouterr().out


def test_serving_twin_runs_on_the_cpu(one_thread, capsys):
    got = _load("serve_model_torch").main(["--device", "cpu"])
    assert got["phase"] == "done" and got["chain_ok"]
    assert len(got["predictions"]) == 3
    for p in got["predictions"]:
        assert p.shape == (4, 4)
        assert 0 <= p.min() and p.max() < 512
    assert len(got["evals"]) == 3 and np.all(np.isfinite(got["evals"]))
    assert "request batch 2: 4 prompts" in capsys.readouterr().out


@pytest.mark.parametrize("name", TWINS)
def test_twins_need_cuda_unless_asked_for_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _load(name).main([])
