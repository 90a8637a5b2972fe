"""Runs one cell of the benchmark once and prints its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

(or ``python3 -m benchmark.run ...``) from the root of a checkout, on a
machine with the cards the cell asks for. Everything is found by name:
the cell in ``BENCHMARK.json``, its files under ``benchmark/`` (see
``lib/cell.py``), its driver ``benchmark/drivers/<driver>.py``, each
per-layer metric's reader ``benchmark/metrics/<metric>.py``.

A run: set-up (the program's CUDA libraries, built under ``build/`` in
the checkout on a first run and loaded after; weights; every shape the
traffic uses, warmed up, a search's capture included), measured from the
process's start as ``setup_s``; the window of ``--seconds``, timed on the
host's clock; the device's peak memory; with ``--trace 1`` a stretch of
the same work under the profiler after the window, from which the
per-layer metrics are read; the program's state freed; then the check
that decides ``correct``. Standard error ends with each number compared
beside its limit; the last line of standard output is the result.

Without a CUDA card (or with fewer than the cell asks for), in a
directory without the program, or when a module of JAX or of the JAX
package is loaded once the window has closed, it exits with another code
than 0 and prints no result.
"""

from __future__ import annotations

import time

START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Dict, List, Tuple  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "alphazero_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules of JAX or the JAX package, by whole top-level
    name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """The end-to-end and per-layer metrics that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return e2e, per_layer


def run_cell(cell, seconds: float, trace: bool, bench: dict,
             start: float) -> dict:
    """One run of ``cell`` (a ``lib.cell.Cell``). On the CPU (the tests'
    tiny runs) there is no device metric: asking for a trace raises."""
    import torch

    from benchmark.lib import readers
    from benchmark.lib import trace as tracing

    on_card = cell.device.startswith("cuda")
    if trace and not on_card:
        raise RuntimeError("a device trace needs the card; this run is on "
                           f"{cell.device}")
    e2e_specs, layer_specs = cell_metrics(bench, cell.name)
    driver_mod = load_file(os.path.join(ROOT, "benchmark", "drivers",
                                        f"{cell.driver}.py"),
                           f"benchmark_driver_{cell.driver}")
    driver = driver_mod.Driver(cell)
    driver.setup()
    setup_s = time.time() - start
    e2e = driver.window(seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else None

    run = readers.Run(cell=cell, driver=driver, trace=None)
    if trace:
        units = []
        run.trace = tracing.record(
            lambda: units.append(driver.stretch()),
            os.path.join(cell.tmpdir, "trace.json"))
        run.stretch_units = units[0]
    metrics: Dict[str, dict] = {}
    if trace:
        for m in layer_specs:
            reader = load_file(os.path.join(ROOT, "benchmark", "metrics",
                                            f"{m['name']}.py"),
                               f"benchmark_metric_{m['name']}")
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e_specs:
            value = setup_s if m["name"] == "setup_s" else e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    driver.release()

    numbers = driver.check()
    compared = {k: {"value": numbers.get(k, float("nan")), "limit": lim}
                for k, lim in cell.limits.items()}
    correct = (bool(compared) and driver.attempted > 0
               and driver.failed == 0
               and all(c["value"] <= c["limit"] for c in compared.values()))
    result = {"correct": correct, "attempted": driver.attempted,
              "failed": driver.failed, "metrics": metrics,
              "numbers": numbers}
    if on_card:
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(0),
                            "count": 1, "memory_peak_bytes": peak}
    if run.trace is not None:
        result["device"].update(busy_s=run.trace.busy_s,
                                window_s=run.trace.window_s)
        result["breakdown"] = {
            "device_ops": [list(x) for x in run.trace.device_ops()],
            "idle_gaps": [list(x) for x in run.trace.idle_gaps()]}
        result["launch_classes"] = run.trace.launch_classes()
        result["stretch_units"] = run.stretch_units
    result["window"] = driver.window_stats
    result["checked"] = compared
    return result


def finite(x):
    """``x`` with every number that is not finite as None, for JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.lib import cell as cells

    bench = cells.benchmark_json()
    spec = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if spec is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < spec["chips"]:
        print(f"{args.workload} needs {spec['chips']} CUDA card(s); this "
              f"machine has {cards}", file=sys.stderr)
        return 2
    from benchmark.lib import device

    print(device.line(device.identity()), file=sys.stderr, flush=True)
    tmp = tempfile.mkdtemp(prefix="benchmark-")
    try:
        cell = cells.load_cell(args.workload, args.seed, "cuda", tmp,
                               spec=spec)
        result = run_cell(cell, args.seconds, bool(args.trace), bench,
                          START)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checked"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
