"""Run one cell of the benchmark of ``repro_torch`` on the CUDA card.

  python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
      --trace <0|1>

Run from the root of a checkout. The cell is looked up by name in
``BENCHMARK.json``; its configuration, traffic mix, driver, limits and
per-layer metric readers are files under ``portbench/`` found by name.
Set-up (imports, the CUDA context, the program's kernels from
``build/repro_torch/``, the seed's weights and inputs on the card, the
cell's own warm-up) ends at the window's first timed operation. With
``--trace 0`` the result line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, the device's busy and window seconds
and a breakdown. The last line of standard output is the result; the
last lines of standard error are each number the correctness check
compared, with its limit, also the result line's last key.

Exits 2 without enough CUDA cards, 3 if JAX or the JAX package was
loaded, and with an exception's code if the program or the check fails.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parents[1]
    sys.path[0] = str(ROOT)                # the package, not this folder
    sys.path.insert(1, str(ROOT / "src"))
    from portbench.bench import main
    sys.exit(main(t_start=T_START))
