"""The benchmark's registry and its result line.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric sits in a file of its own, found by the name
``BENCHMARK.json`` gives it:

  configs/<config>.json     the model's sizes as run, its source, its cuts
  traffic/<traffic>.json    the mix's parameters and the driver that runs it
  drivers/<driver>.py       one loop kind: ``run(ctx) -> Outcome``
  metrics/<metric>.py       one per-layer metric: ``read(rec) -> float|None``
  limits/<workload>.json    the cell's correctness limits

A later cell, configuration or metric is added as new files and a new
entry in ``BENCHMARK.json``; no existing file changes.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"

# what a benchmark process may not hold once its window has closed: JAX and
# the JAX package, compared by whole top-level module names
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(path: Path = BENCHMARK) -> dict:
    return load_json(path)


def cell(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(workload: str) -> dict:
    return load_json(HERE / "limits" / f"{workload}.json")


def _load_module(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _load_module(HERE / "drivers" / f"{name}.py",
                        f"portbench_driver_{name}")


def metric_reader(name: str) -> Callable:
    mod = _load_module(HERE / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))
    return mod.read


def metrics_of(kind: str, workload: str, bench: dict) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``workload``
    reports: those whose ``workloads`` list names it, or that have none."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def derive_seed(seed: int, label: str) -> int:
    """A 63-bit seed for one stream of a run (weights, data, prompts)."""
    h = hashlib.blake2b(f"{int(seed)}:{label}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big") >> 1


def forbidden_modules() -> List[str]:
    names = {m.split(".", 1)[0] for m in sys.modules}
    return sorted(names & set(FORBIDDEN_MODULES))


# ---------------------------------------------------------------------------
# spans: the harness's own, around each call into a layer of the program
# ---------------------------------------------------------------------------
class Spans:
    """Host-clock spans by name. ``sync`` (traced runs) waits for the card
    at both ends, so a span holds the device work it launched; otherwise
    a span only notes host time. While ``log`` is a list (the profiled
    stretch) spans are noted there as (name, start_ns, end_ns), without
    waiting for the card."""

    def __init__(self, sync: Optional[Callable] = None):
        self.sync = sync
        self.times: Dict[str, List[float]] = {}
        self.log: Optional[list] = None

    def __call__(self, name: str):
        return _Span(self, name)

    def mean_ms(self, name: str) -> Optional[float]:
        v = self.times.get(name)
        return 1e3 * statistics.fmean(v) if v else None


class _Span:
    def __init__(self, owner: Spans, name: str):
        self.owner, self.name = owner, name

    def __enter__(self):
        o = self.owner
        if o.log is None and o.sync is not None:
            o.sync()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        o = self.owner
        if o.log is not None:
            o.log.append((self.name, self.t0, time.perf_counter_ns()))
            return False
        if o.sync is not None:
            o.sync()
        o.times.setdefault(self.name, []).append(
            (time.perf_counter_ns() - self.t0) / 1e9)
        return False


# ---------------------------------------------------------------------------
# what a driver hands back, and the record a metric reader reads
# ---------------------------------------------------------------------------
@dataclass
class Outcome:
    metrics: Dict[str, float]              # end-to-end values, by name
    attempted: int
    failed: int
    readings: Dict[str, float]             # the numbers of the check
    memory_peak_bytes: int
    record: "Record" = None                # traced runs: what readers read
    control: Optional[dict] = None         # control runs: readings by kind
    seconds: Dict[str, float] = field(default_factory=dict)  # window, check


@dataclass
class Record:
    """What a traced run measured, for the per-layer metric readers."""
    spans: Spans
    counts: Dict[str, dict] = field(default_factory=dict)  # counts.py's
    peaks: Dict[str, float] = field(default_factory=dict)  # peaks.json's
    profile: object = None                 # devtrace.Profile of the stretch

    def roofline_s(self, work: dict) -> Optional[float]:
        """The least time of ``work`` ({flops, bytes, precision}) on the
        card: the larger of its FLOPs over the precision's peak and its
        bytes over the memory's rate."""
        if not self.peaks:
            return None
        return max(work["flops"] / self.peaks[work["precision"] + "_flops"],
                   work["bytes"] / self.peaks["hbm_bytes_per_s"])


def compared(readings: Dict[str, float], limits: dict) -> Dict[str, tuple]:
    """{name: (reading, limit)} of every number the limits file names."""
    missing = sorted(set(limits) - set(readings))
    if missing:
        raise KeyError(f"the driver read no {missing}")
    return {k: (readings[k], limits[k]) for k in limits}


def checks_ok(checks: Dict[str, tuple]) -> bool:
    return all(v == v and v <= lim for v, lim in checks.values())


def print_checks(checks: Dict[str, tuple], out=sys.stderr):
    for name, (v, lim) in checks.items():
        print(f"check {name} {v!r} limit {lim!r}", file=out, flush=True)


def result_line(outcome: Outcome, checks: Dict[str, tuple],
                metrics: Dict[str, dict], device: dict,
                breakdown: Optional[dict] = None) -> str:
    line = {"correct": checks_ok(checks),
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return json.dumps(line)
