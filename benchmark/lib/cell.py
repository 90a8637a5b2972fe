"""What a driver is given: one cell of ``BENCHMARK.json`` with its files.

- ``benchmark/configs/<config>.json``: the model's sizes and precisions;
- ``benchmark/traffic/<traffic>.json``: the mix, naming its driver
  (``benchmark/drivers/<driver>.py``) and its parameters;
- ``benchmark/workloads/<cell>.json``: what belongs to the cell alone,
  the limits of the numbers that decide ``correct``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(*parts: str) -> Dict[str, Any]:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    seed: int
    device: str
    tmpdir: str

    @property
    def driver(self) -> str:
        return self.traffic["driver"]

    def path(self, rel: str) -> str:
        """A file of the checkout, by its path from the root."""
        return os.path.join(ROOT, rel)


def benchmark_json() -> Dict[str, Any]:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_cell(name: str, seed: int, device: str, tmpdir: str,
              spec: Dict[str, Any] | None = None, **overrides) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``spec``, a
    workload entry given directly). ``overrides`` replace traffic
    parameters or configuration sizes (``config_<key>``): for the CPU
    tests' tiny runs only."""
    if spec is None:
        spec = next((w for w in benchmark_json()["workloads"]
                     if w["name"] == name), None)
        if spec is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = load_json("configs", f"{spec['config']}.json")
    traffic = load_json("traffic", f"{spec['traffic']}.json")
    cell_file = os.path.join(HERE, "workloads", f"{name}.json")
    limits = (load_json("workloads", f"{name}.json")["limits"]
              if os.path.exists(cell_file) else {})
    for k, v in overrides.items():
        if k.startswith("config_"):
            config = {**config, k[len("config_"):]: v}
        else:
            traffic = {**traffic, k: v}
    return Cell(name=name, config_name=spec["config"], config=config,
                traffic_name=spec["traffic"], traffic=traffic,
                limits=limits, seed=seed, device=device, tmpdir=tmpdir)
