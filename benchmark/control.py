"""The readings that the limits of ``correct`` are set from, in one process.

    python3 benchmark/control.py --workload <cell> --seconds <s>
        --seeds <n> [<n> ...] [--control 3]

For each seed: a run of the cell with a window of ``--seconds`` at the
cell's own load, and the numbers its check compares (the program's
readings). For the first ``--control`` seeds also the control's readings
at the same positions or rows: the reference in the precision below the
configuration's put in the program's place (float8 for the bf16 search
evaluator, bfloat16 for the learner's TF32), and for the learner the
fault of a batch half left out. One JSON line a reading, then a summary:
for each number the largest program reading (the lower end of its limit)
and the smallest control or fault reading (the upper end). The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the learner's cell, measured and proven but not in BENCHMARK.json (its
# rate follows the host's speed; PERF.md)
LEARN = {"name": "az128-learn-b1024", "config": "az-20x128-se",
         "traffic": "learn-b1024", "chips": 1}


def readings(name: str, seed: int, seconds: float, control: bool,
             device: str = "cuda", spec: dict | None = None, **overrides):
    """(program's numbers, {reading: numbers}) for one seed. ``spec`` is
    the cell's workload entry where ``BENCHMARK.json`` does not hold it
    (``LEARN``)."""
    import torch

    from benchmark.lib import cell as cells
    from benchmark.run import load_file

    tmp = tempfile.mkdtemp(prefix="benchmark-control-")
    try:
        cell = cells.load_cell(name, seed, device, tmp, spec=spec,
                               **overrides)
        mod = load_file(os.path.join(ROOT, "benchmark", "drivers",
                                     f"{cell.driver}.py"),
                        f"benchmark_driver_{cell.driver}")
        driver = mod.Driver(cell)
        driver.setup()
        driver.window(seconds)
        driver.release()
        prog = driver.check()
        others = {}
        if control:
            others["control"] = driver.check(control=True)
            if driver.kind == "learn":
                from benchmark.lib import reflearn

                others["fault_half_batch"] = reflearn.numbers(
                    *driver.reference(half_batch=True), *driver.reference())
        del driver
        gc.collect()
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
        return prog, others
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    lower = defaultdict(float)
    upper = defaultdict(lambda: float("inf"))
    spec = LEARN if args.workload == LEARN["name"] else None
    for i, seed in enumerate(args.seeds):
        prog, others = readings(args.workload, seed, args.seconds,
                                i < args.control, spec=spec)
        print(json.dumps({"seed": seed, "reading": "program", **prog}),
              flush=True)
        for k, v in prog.items():
            lower[k] = max(lower[k], v)
        for what, nums in others.items():
            print(json.dumps({"seed": seed, "reading": what, **nums}),
                  flush=True)
            for k, v in nums.items():
                upper[k] = min(upper[k], v)
    print(json.dumps({"summary": args.workload,
                      "lower": dict(lower), "upper": dict(upper)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
