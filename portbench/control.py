"""Readings that set a cell's correctness limits, on the card.

  python3 portbench/control.py --workload <name> --seconds <s> \\
      --seeds <n> [<n> ...]

For each seed, in one process: a run of the cell (its result line, as
``run.py`` prints it with ``--trace 0``), then the control and the
faults the driver can read on the same inputs, one JSON line each:
``{"seed", "program": {number: value}, "<kind>": {number: value}}``.
The program's readings over a dozen seeds give each number's lower
reading, the control's (the reference with fp8 projections in the
program's place) and the faults' its upper one.
"""
import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    import argparse

    import torch

    from portbench import bench, harness
    bench.set_cache_dirs()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench: the control runs on a CUDA card", file=sys.stderr)
        return 2
    b = harness.benchmark()
    device = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        ctx = bench.make_context(args.workload, seed, args.seconds, False,
                                 device, bench=b, control=True,
                                 t_start=T_START if i == 0 else None)
        outcome, checks, metrics = bench.execute(ctx, b)
        line = {"seed": seed, "correct": harness.checks_ok(checks),
                "metrics": {k: v["value"] for k, v in metrics.items()},
                "seconds": outcome.seconds,
                "program": outcome.readings,
                **outcome.control}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parents[1]
    sys.path[0] = str(ROOT)                # the package, not this folder
    sys.path.insert(1, str(ROOT / "src"))
    sys.exit(main())
