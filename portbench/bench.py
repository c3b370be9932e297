"""The benchmark's run of one cell: the context a driver gets, the
driver, the metric readers and the result line (``run.py`` is the
command)."""
from __future__ import annotations

import argparse
import dataclasses
import gc
import os
import subprocess
import sys
import time

from portbench import harness

def set_cache_dirs():
    """Build and kernel caches at fixed places inside the checkout (the
    program's own kernels build under ``build/repro_torch/``)."""
    base = harness.ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


CONFIG_SKIP = ("name", "family", "source")     # descriptive, not sizes


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's files, the seed, the device."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: object
    cfg: dict
    program_cfg: object
    traffic: dict
    limits: dict
    peaks: dict
    t_start: float
    control: bool = False
    spans: harness.Spans = None

    def __post_init__(self):
        self.spans = harness.Spans(self.sync if self.trace else None)
        self.marks = {}

    def mark(self, name: str):
        """Note the seconds since process start at a step of set-up."""
        self.marks[name] = time.perf_counter() - self.t_start

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def check_tree(self, program_tree, params):
        """The program's parameter tree has the reference's leaves."""
        from portbench.reference.model import tree_paths
        got, want = tree_paths(program_tree), tree_paths(params)
        if got != want:
            raise ValueError(f"the program's parameters {got} are not the "
                             f"configuration's {want}")

    def reference_mode(self):
        """Free the program's state; float32 matmuls without TF32."""
        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def program_config(cfg: dict, reduced: bool = False):
    """The program's registered configuration, checked against the file:
    every size the file gives must be the program's. ``reduced``: the
    program's CPU test size instead (tests only); returns it with the
    file's dict updated to it."""
    from repro_torch.configs import get_config
    pc = get_config(cfg["program_arch"])
    if reduced:
        pc = pc.reduced()
        cfg = {**cfg, **{k: v for k, v in dataclasses.asdict(pc).items()
                         if k not in CONFIG_SKIP}}
    sizes = dataclasses.asdict(pc)
    wrong = {k: (cfg.get(k), v) for k, v in sizes.items()
             if k not in CONFIG_SKIP and cfg.get(k) != v}
    if wrong:
        raise ValueError(f"configuration file and program differ (file, "
                         f"program): {wrong}")
    return pc, cfg


def make_context(workload: str, seed: int, seconds: float, trace: bool,
                 device, *, bench=None, reduced: bool = False,
                 traffic_changes=None, control: bool = False,
                 t_start: float = None) -> Context:
    bench = bench or harness.benchmark()
    cell = harness.cell(workload, bench)
    pc, cfg = program_config(harness.config(cell["config"]), reduced)
    traffic = {**harness.traffic(cell["traffic"]), **(traffic_changes or {})}
    peaks = {}
    if device.type == "cuda":
        import torch
        peaks = harness.load_json(harness.HERE / "peaks.json").get(
            torch.cuda.get_device_name(device), {})
    return Context(workload=workload, seed=seed, seconds=seconds,
                   trace=trace, device=device, cfg=cfg, program_cfg=pc,
                   traffic=traffic, limits=harness.limits(workload),
                   peaks=peaks, control=control,
                   t_start=time.perf_counter() if t_start is None
                   else t_start)


def execute(ctx: Context, bench: dict):
    """Run the cell's driver; returns (outcome, the numbers compared with
    their limits, the metrics of the result line)."""
    outcome = harness.driver(ctx.traffic["driver"]).run(ctx)
    checks = harness.compared(outcome.readings, ctx.limits)
    kind = "per_layer" if ctx.trace else "end_to_end"
    metrics = {}
    for m in harness.metrics_of(kind, ctx.workload, bench):
        value = (harness.metric_reader(m["name"])(outcome.record)
                 if ctx.trace else outcome.metrics[m["name"]])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return outcome, checks, metrics


def power_limit_w():
    """The card's power limit in watts, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,"
             "nounits", "-i", "0"], capture_output=True, text=True,
            timeout=60, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None, t_start: float = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    bench = harness.benchmark()
    cell = harness.cell(args.workload, bench)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s), found {found}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.init()
    ctx = make_context(args.workload, args.seed, args.seconds,
                       bool(args.trace), device, bench=bench,
                       t_start=t_start)
    ctx.mark("cuda")
    outcome, checks, metrics = execute(ctx, bench)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the process loaded {loaded}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell["chips"],
           "memory_peak_bytes": outcome.memory_peak_bytes,
           "power_limit_w": power_limit_w()}
    breakdown = None
    if ctx.trace:
        prof = outcome.record.profile
        dev.update(busy_s=prof.busy_s, window_s=prof.window_s)
        breakdown = prof.breakdown()
    print(harness.result_line(outcome, checks, metrics, dev, breakdown),
          flush=True)
    print("portbench: set-up " + " ".join(f"{k} {v:.3f}" for k, v in
                                         ctx.marks.items())
          + " | " + " ".join(f"{k}_s {v!r}" for k, v in
                             outcome.seconds.items()),
          file=sys.stderr, flush=True)
    for k, v in outcome.readings.items():
        if k not in checks:
            print(f"reading {k} {v!r} not compared", file=sys.stderr,
                  flush=True)
    harness.print_checks(checks)
    return 0
