"""The port's control-plane modules are copies of the reference's.

``metadata``, ``crypto``, ``serialization``, ``telemetry``, ``transport``,
``clients``, ``communicator``, ``governance``, ``validation``, ``jobs``
and ``reporting`` are framework-free in the reference, and the port keeps
them line for line: with ``repro_torch`` read as ``repro``, each port
source equals the reference source. The differences allowed are listed
in ``ALLOWED``, each with its reason: by top-level name (a class's name
allows its whole body), or by ``Class.member`` for one member of a
class whose other members stay the reference's.

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
# names whose source may differ, per module
ALLOWED = {
    # the reference turns jax arrays into numpy with ``jax.tree.map`` inside
    # ``pack``; the port does it with ``_to_numpy`` (tensors -> numpy, dicts
    # in sorted-key order as ``jax.tree.map`` rebuilds them), and imports
    # torch instead of jax. ``_encode``, ``_decode`` and ``unpack`` (the
    # codec) stay identical.
    "serialization": {"__doc__", "import jax", "import torch", "pack",
                      "_to_numpy"},
    # the port's spans carry device time (CUDA timing events from a pool,
    # resolved when read: ``Span._start``, ``_finish``, ``device_s``, and
    # ``device_ms`` in ``export_trace``), record while a ``torch.profiler``
    # session is on (``Telemetry.recording``, ``span``, ``open_span``),
    # take ``actor`` and ``run_id`` from the enclosing span
    # (``_open_span``), and reach the data plane and the models through
    # the bundle in scope (``current``, ``scope``, ``process``);
    # ``kernel_span`` is a device span (``_KernelSpan``, folded into
    # ``kernel.seconds`` by ``_collect_kernels``) where the reference's
    # ``_KernelTimer`` read the host clock. The registry, the null span,
    # the ring, ``spans``, the incidents, ``anchor_trace`` and the digest
    # stay the reference's.
    "telemetry": {"__doc__", "import contextlib", "import contextvars",
                  "import torch", "import torch.autograd.profiler as _profiler",
                  "_EVENTS: Dict[int, list] = {}", "_cuda_index", "_record",
                  "Span.__doc__", "Span.__slots__", "Span.__init__",
                  "Span._start", "Span._finish", "Span.device_s",
                  "_KernelSpan", "_KernelTimer",
                  "Telemetry.__doc__", "Telemetry.__init__",
                  "Telemetry.recording", "Telemetry.span",
                  "Telemetry.open_span", "Telemetry._open_span",
                  "Telemetry._close", "Telemetry.kernel_span",
                  "Telemetry._kernel_done", "Telemetry._collect_kernels",
                  "Telemetry.export_trace",
                  "PROCESS_RING = 8192", "KERNEL_BACKLOG = 256",
                  "_PROCESS = Telemetry(recorder_cap=PROCESS_RING)",
                  '_SCOPE: contextvars.ContextVar = contextvars.ContextVar('
                  '"telemetry")', "process", "current", "scope"},
}


def _source(pkg: str, name: str) -> str:
    text = (ROOT / "src" / pkg / "core" / f"{name}.py").read_text()
    return re.sub(r"\brepro_torch\b", "repro", text)


def _is_doc(i: int, node) -> bool:
    return (i == 0 and isinstance(node, ast.Expr)
            and isinstance(node.value, ast.Constant))


def _nodes(text: str) -> dict:
    """Top-level statements by name: defs by name, imports by their source
    line, the module docstring as ``__doc__``, anything else by its
    source. A class gives its ``class`` line under its name and each
    statement of its body under ``Class.<name>``: the docstring as
    ``__doc__``, a def by its name, an assignment by its target."""
    out = {}
    for i, node in enumerate(ast.parse(text).body):
        seg = ast.get_source_segment(text, node)
        if _is_doc(i, node):
            out["__doc__"] = seg
        elif isinstance(node, ast.ClassDef):
            out[node.name] = seg.split("\n")[0]
            for j, member in enumerate(node.body):
                mseg = ast.get_source_segment(text, member)
                if _is_doc(j, member):
                    name = "__doc__"
                elif isinstance(member, (ast.FunctionDef, ast.ClassDef)):
                    name = member.name
                elif (isinstance(member, ast.Assign)
                      and len(member.targets) == 1
                      and isinstance(member.targets[0], ast.Name)):
                    name = member.targets[0].id
                else:
                    name = mseg
                out[f"{node.name}.{name}"] = mseg
        elif isinstance(node, ast.FunctionDef):
            out[node.name] = seg
        else:
            out[seg] = seg
    return out


def _held(keys, allowed) -> set:
    """The keys held to the reference: neither allowed by name nor a
    member of an allowed class."""
    return {k for k in keys if k not in allowed
            and not (k.split(".")[0].isidentifier()
                     and k.split(".")[0] in allowed)}


@pytest.mark.parametrize("name", COPIES)
def test_control_plane_module_is_a_copy(name):
    ref, port = _source("repro", name), _source("repro_torch", name)
    allowed = ALLOWED.get(name)
    if allowed is None:
        assert port == ref
        return
    rn, pn = _nodes(ref), _nodes(port)
    assert _held(rn, allowed) == _held(pn, allowed)
    for key in _held(rn, allowed):
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
