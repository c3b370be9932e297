"""The harness finds every cell, configuration, traffic mix, driver,
limit and per-layer metric by the name ``BENCHMARK.json`` gives it, and a
cell or a metric added as new files only is found and runs."""
import json
import re
import shutil
import os
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def test_the_file_keeps_to_its_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    lines = [c["why"] for c in bench["configs"]] + \
        [c["source"] for c in bench["configs"]] + \
        [w["why"] for w in bench["workloads"]] + \
        [m["layer"] for m in bench["per_layer"]] + bench["command"]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in lines)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = harness.metrics_of("end_to_end", w["name"], bench)
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert harness.metrics_of("per_layer", w["name"], bench)


def test_every_name_has_its_file(bench):
    for c in bench["configs"]:
        cfg = harness.config(c["name"])
        assert (ROOT / c["file"]).exists() and cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        tr = harness.traffic(w["traffic"])
        assert callable(harness.driver(tr["driver"]).run)
        assert harness.limits(w["name"])
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_the_configurations_are_the_programs(bench):
    from portbench.bench import program_config
    for c in bench["configs"]:
        pc, _ = program_config(harness.config(c["name"]))
        assert pc.name == c["name"]


NEW_CELL = {"name": "fedforecast-100m.secure_round_b4", "config":
            "fedforecast-100m", "traffic": "secure_round_b4", "chips": 1,
            "why": "A cell added as data files only"}
NEW_METRIC = {"name": "loss_calls", "unit": "calls", "better": "lower",
              "source": "program_span", "layer": "silo train step",
              "moves": "round_s", "workloads": [NEW_CELL["name"]]}


def test_a_cell_and_a_metric_added_as_files_are_found_and_run(tmp_path):
    """Copy the benchmark, add a traffic file, a limits file, a metric
    reader and their entries (no existing file of the benchmark edited),
    and rehearse the new cell on the CPU at the program's test size."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "src").symlink_to(ROOT / "src")
    bench = harness.benchmark()
    bench["workloads"].append(NEW_CELL)
    bench["per_layer"].append(NEW_METRIC)
    for m in bench["end_to_end"]:
        if m["name"] == "round_s":
            m["workloads"].append(NEW_CELL["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    tr = {**harness.traffic("secure_round"), "batch": 4}
    (root / "portbench" / "traffic" / "secure_round_b4.json").write_text(
        json.dumps(tr))
    shutil.copy(ROOT / "portbench" / "limits"
                / "fedforecast-100m.secure_round.json",
                root / "portbench" / "limits" / f"{NEW_CELL['name']}.json")
    (root / "portbench" / "metrics" / "loss_calls.py").write_text(
        "def read(rec):\n    return len(rec.spans.times['train_step'])\n")
    code = f"""
import torch
from portbench import bench, harness
b = harness.benchmark()
assert harness.cell({NEW_CELL['name']!r}, b)['traffic'] == 'secure_round_b4'
assert harness.metric_reader('loss_calls')
ctx = bench.make_context({NEW_CELL['name']!r}, 7, 0.01, False,
                         torch.device('cpu'), bench=b, reduced=True,
                         traffic_changes=dict(local_steps=3, seq_len=16,
                                              pool_rounds=2))
assert ctx.traffic['batch'] == 4
outcome, checks, metrics = bench.execute(ctx, b)
assert set(metrics) == {{'round_s', 'setup_s'}}, metrics
assert harness.checks_ok(checks), checks
print('ok')
"""
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True,
        text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": f"{root}:{root / 'src'}",
             "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0 and res.stdout.strip() == "ok", \
        res.stdout + res.stderr
