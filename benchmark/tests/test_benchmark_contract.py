"""``BENCHMARK.json`` against the files it names, and the harness's
imports: nothing of JAX or the JAX package anywhere, nothing of the
program in the reference."""

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_per_layer_metric_is_read_only_where_its_moves_is():
    b = bench()
    for m in b["per_layer"]:
        e2e = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        cells = m.get("workloads", [w["name"] for w in b["workloads"]])
        for c in cells:
            assert "workloads" not in e2e or c in e2e["workloads"], (
                m["name"], c)
            _, per_layer = run.cell_metrics(b, c)
            assert m["name"] in [p["name"] for p in per_layer]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    b = bench()
    for w in b["workloads"]:
        e2e, per_layer = run.cell_metrics(b, w["name"])
        names = [e["name"] for e in e2e]
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert per_layer, w["name"]


def test_every_name_has_its_files():
    b = bench()
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert os.path.isfile(os.path.join(BENCH, "traffic",
                                           f"{w['traffic']}.json"))
        with open(os.path.join(BENCH, "workloads",
                               f"{w['name']}.json")) as f:
            assert json.load(f)["limits"], w["name"]
        with open(os.path.join(BENCH, "traffic",
                               f"{w['traffic']}.json")) as f:
            driver = json.load(f)["driver"]
        assert os.path.isfile(os.path.join(BENCH, "drivers",
                                           f"{driver}.py"))
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py")), m["name"]


def test_names_and_units_keep_to_the_contract():
    b = bench()
    names = ([c["name"] for c in b["configs"]]
             + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in b["end_to_end"] + b["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert all(w["chips"] == 1 for w in b["workloads"])


SCRIPT = """
import importlib, os, sys
sys.path.insert(0, {root!r})
from benchmark import run, control
from benchmark.lib import cell, checks, device, flops, peaks, program
from benchmark.lib import readers, refenv, reflearn, refnet, trace
from benchmark.lib import treecheck, weights
for d in ("drivers", "metrics", "rooflines"):
    for f in sorted(os.listdir(os.path.join({root!r}, "benchmark", d))):
        if f.endswith(".py") and f != "__init__.py":
            run.load_file(os.path.join({root!r}, "benchmark", d, f),
                          "m_" + f[:-3].replace(".", "_"))
print(",".join(run.forbidden_modules()))
"""

REFERENCE = """
import sys
sys.path.insert(0, {root!r})
from benchmark.lib import checks, flops, peaks, refenv, reflearn, refnet
from benchmark.lib import treecheck, weights
from benchmark.rooflines import conv3x3, se_residual
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}}
                      & {{"alphazero_torch", "alphazero_tpu", "jax",
                          "jaxlib", "flax"}})))
"""


def _loaded(script):
    p = subprocess.run([sys.executable, "-c", script.format(root=ROOT)],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr
    return p.stdout.strip()


def test_the_harness_drivers_and_readers_load_no_jax():
    assert _loaded(SCRIPT) == ""


def test_the_reference_loads_nothing_of_the_program():
    assert _loaded(REFERENCE) == ""


@pytest.mark.parametrize("loaded,found", [
    (["jax.numpy"], ["jax"]),
    (["alphazero_tpu.search.mcts"], ["alphazero_tpu"]),
    (["flax", "jaxlib.xla_client"], ["flax", "jaxlib"]),
    (["alphazero_torch.search", "jaxtyping", "flaxen"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(monkeypatch,
                                                         loaded, found):
    fake = {m: None for m in loaded}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == found
