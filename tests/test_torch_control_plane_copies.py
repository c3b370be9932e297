"""The port's control-plane modules are copies of the reference's.

``metadata``, ``crypto``, ``serialization``, ``telemetry``, ``transport``,
``clients``, ``communicator``, ``governance``, ``validation``, ``jobs``
and ``reporting`` are framework-free in the reference, and the port keeps
them line for line: with ``repro_torch`` read as ``repro``, each port
source equals the reference source. The differences allowed are listed
in ``ALLOWED``, by top-level name, each with its reason.

The FederatedForecasts data generator (``forecasting_series``,
``ForecastSiloDataset``) is copied too and draws the reference's batches.

The wire format is the reference's: ``serialization.pack`` gives the
reference's bytes for every tree a port sync run packs (globals, masked
updates, corrections, control messages), and for params given as
tensors.
"""
import ast
import re
from pathlib import Path

import msgpack
import numpy as np
import pytest
import torch

from repro.core import serialization as jser
from repro_torch.core import serialization as tser
from test_torch_fl_sync import one_torch_thread

ROOT = Path(__file__).resolve().parents[1]
COPIES = ("metadata", "crypto", "serialization", "telemetry", "transport",
          "clients", "communicator", "governance", "validation", "jobs",
          "reporting")
# top-level names whose source may differ, per module
ALLOWED = {
    # the reference turns jax arrays into numpy with ``jax.tree.map`` inside
    # ``pack``; the port does it with ``_to_numpy`` (tensors -> numpy, dicts
    # in sorted-key order as ``jax.tree.map`` rebuilds them), and imports
    # torch instead of jax. ``_encode``, ``_decode`` and ``unpack`` (the
    # codec) stay identical.
    "serialization": {"__doc__", "import jax", "import torch", "pack",
                      "_to_numpy"},
}


def _source(pkg: str, name: str) -> str:
    text = (ROOT / "src" / pkg / "core" / f"{name}.py").read_text()
    return re.sub(r"\brepro_torch\b", "repro", text)


def _nodes(text: str) -> dict:
    """Top-level statements by name: defs and classes by name, imports by
    their source line, the module docstring as ``__doc__``, anything else
    by its source."""
    out = {}
    for i, node in enumerate(ast.parse(text).body):
        seg = ast.get_source_segment(text, node)
        if (i == 0 and isinstance(node, ast.Expr)
                and isinstance(node.value, ast.Constant)):
            key = "__doc__"
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            key = node.name
        else:
            key = seg
        out[key] = seg
    return out


@pytest.mark.parametrize("name", COPIES)
def test_control_plane_module_is_a_copy(name):
    ref, port = _source("repro", name), _source("repro_torch", name)
    allowed = ALLOWED.get(name)
    if allowed is None:
        assert port == ref
        return
    rn, pn = _nodes(ref), _nodes(port)
    assert set(rn) - allowed == set(pn) - allowed
    for key in set(rn) - allowed:
        assert rn[key] == pn[key], key


def _to_numpy(tree):
    """Independent of the port's conversion: tensors -> numpy."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


@pytest.fixture(scope="module")
def packed_trees():
    """Every tree a short port sync run packs: 3 silos, 1 secure round,
    reduced fedforecast-100m on the CPU."""
    from repro_torch.core import Consortium
    from repro_torch.data.synthetic import make_silo_datasets
    seen = []
    orig = tser.pack

    def record(tree):
        seen.append(tree)
        return orig(tree)
    with pytest.MonkeyPatch.context() as mp, one_torch_thread():
        mp.setattr(tser, "pack", record)
        con = Consortium(["windco", "solarx", "gridpower"], seed=0,
                         master_key=b"k" * 32, device="cpu")
        contract = con.negotiate({
            "arch": "fedforecast-100m", "rounds": 1, "local_steps": 1,
            "batch_size": 2, "secure_aggregation": True,
            "data_schema": {"vocab": 512, "seq_len": 32}})
        job = con.server.job_creator.from_contract(contract)
        con.start(job, make_silo_datasets(3, vocab=512, seq_len=32, seed=1))
        assert con.run_to_completion() == "done"
    return seen


def _kind(tree) -> str:
    payload = tree.get("payload", tree) if isinstance(tree, dict) else tree
    if isinstance(payload, dict):
        for key in ("params", "packed", "correction", "phase"):
            if key in payload:
                return key
    return "control"


@pytest.mark.parametrize("kind", ["params", "packed", "phase", "control"])
def test_pack_bytes_equal_reference(packed_trees, kind):
    trees = [t for t in packed_trees if _kind(t) == kind]
    assert trees, kind
    for tree in trees:
        assert tser.pack(tree) == jser.pack(_to_numpy(tree))


def test_pack_of_tensors_equals_reference_of_arrays():
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"z": np.arange(5, dtype=np.int32),
                    "a": rng.standard_normal(7).astype(np.float32)}}
    msg = {"digest": "d" * 64, "round": 1, "lr": 3e-4, "cohort": ["b", "a"],
           "weight_denom": 8, "pause_reason": None, "ok": True,
           "params": params}
    tmsg = dict(msg, params={
        "w": torch.from_numpy(params["w"]),
        "b": {"z": torch.from_numpy(params["b"]["z"]),
              "a": torch.from_numpy(params["b"]["a"])}})
    blob = tser.pack(tmsg)
    assert blob == jser.pack(msg)
    out = tser.unpack(blob)
    np.testing.assert_array_equal(out["params"]["w"], params["w"])
    # the reference's bytes hold the keys in sorted order
    assert list(msgpack.unpackb(blob, raw=False)) == sorted(msg)


def test_forecast_dataset_draws_reference_batches():
    from repro.data.synthetic import ForecastSiloDataset as JForecast
    from repro_torch.data.synthetic import ForecastSiloDataset as TForecast
    j = JForecast("windco", 32, vocab=512, seed=3, n_steps=4000)
    t = TForecast("windco", 32, vocab=512, seed=3, n_steps=4000)
    np.testing.assert_array_equal(t.series, j.series)
    assert t.stats() == j.stats()
    for _ in range(3):
        np.testing.assert_array_equal(t.batch(4)["tokens"],
                                      j.batch(4)["tokens"])
