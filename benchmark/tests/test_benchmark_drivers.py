"""Dry runs of each driver on the CPU at a tiny size, with the timed path
sound and with it broken underneath: the check must pass the first and
fail every fault the cell can have, and the control must fail it.

The self-play and bot runs take their configurations' own nets (the
flagship's trained weights, so that its priors and values are a real
net's) at a few lanes and simulations, evaluated in float32; the learner
a 2-block net. Each run goes through ``run.run_cell`` as the benchmark's
own runs do, with the cell's own limits, and reports no device metric.
"""

import os
import subprocess
import sys

import pytest
import torch

from benchmark import control, run
from benchmark.lib import cell as cells

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the search's evaluator in float32: on the CPU the bf16 path is the
# kernels' plain versions, whose sums differ from the card's
F32 = {"config_search_precision": "float32"}
SMALL = {
    "az128-selfplay-512x400": dict(lanes=4, simulations=16, check_trees=4,
                                   tree_share=1.0, warmup_moves=1, **F32),
    "lc0-256-selfplay-512x400": dict(lanes=2, simulations=8, check_trees=2,
                                     tree_share=1.0, warmup_moves=1, **F32),
    "az128-bot-1x200": dict(simulations=16, check_trees=4,
                            warmup_requests=1, **F32),
    "az128-learn-b1024": dict(batch=32, buffer=400, config_num_blocks=2,
                              config_num_filters=32,
                              config_weights={"seeded": True}),
}
SECONDS = {"az128-bot-1x200": 2.0}


def spec(name):
    """The learner's cell is not in BENCHMARK.json (PERF.md)."""
    return control.LEARN if name == control.LEARN["name"] else None


def dry_run(name, tmp_path, seed=2 ** 31 + 77, trace=False):
    cell = cells.load_cell(name, seed, "cpu", str(tmp_path), spec=spec(name),
                           **SMALL[name])
    return run.run_cell(cell, SECONDS.get(name, 1.0), trace,
                        cells.benchmark_json(), start=0.0)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_sound_run_is_correct_and_reports_no_device_metric(name,
                                                             tmp_path):
    r = dry_run(name, tmp_path)
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["correct"], [(k, c["value"], c["limit"])
                          for k, c in r["checked"].items()]
    assert "device" not in r and "breakdown" not in r
    assert list(r)[-1] == "checked"
    assert set(r["checked"]) == set(cells.load_json(
        "workloads", f"{name}.json")["limits"])


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_trace_on_the_cpu_fails_rather_than_falls_back(name, tmp_path):
    with pytest.raises(RuntimeError, match="needs the card"):
        dry_run(name, tmp_path, trace=True)


def test_without_a_card_the_command_exits_without_a_result():
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "az128-selfplay-512x400", "--seed", str(2 ** 32 + 5),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_without_the_program_the_command_exits_without_a_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "az128-bot-1x200", "--seed", "9", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


# -- faults planted in the program underneath the driver -------------------
# (one chip: no exchange between chips to leave out; the bot's batch is one
# board, so it has no half to leave out)

def _step_unchanged(monkeypatch):
    from alphazero_torch.env import breakthrough

    monkeypatch.setattr(breakthrough, "step", lambda state, action: state)


def _wrap_evaluator(monkeypatch, fault):
    from alphazero_torch.search import mcts

    make = mcts.make_net_evaluator

    def wrapped(net, dtype=torch.float32):
        inner = make(net, dtype)

        def eval_fn(planes, *ctx):
            return fault(*inner(planes, *ctx))

        return eval_fn

    monkeypatch.setattr(mcts, "make_net_evaluator", wrapped)


def _answer_altered(monkeypatch):
    # every policy produced is shifted by one action
    _wrap_evaluator(monkeypatch, lambda p, v: (p.roll(1, -1), v))


def _half_batch(monkeypatch):
    # the second half of the batch left out, the mean of the first given
    def fault(p, v):
        n = max(1, p.shape[0] // 2)
        p, v = p.clone(), v.clone()
        p[n:] = p[:n].mean(0)
        v[n:] = v[:n].mean(0)
        return p, v

    _wrap_evaluator(monkeypatch, fault)


def _learn_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def _learn_half_batch(monkeypatch):
    from alphazero_torch.train import learner

    loss_fn = learner.loss_fn

    def half(net, states, pi, wl):
        n = states.shape[0] // 2
        return loss_fn(net, states[:n], pi[:n], wl[:n])

    monkeypatch.setattr(learner, "loss_fn", half)


FAULTS = [
    ("az128-selfplay-512x400", _step_unchanged),
    ("az128-selfplay-512x400", _answer_altered),
    ("az128-selfplay-512x400", _half_batch),
    ("lc0-256-selfplay-512x400", _step_unchanged),
    ("lc0-256-selfplay-512x400", _answer_altered),
    ("lc0-256-selfplay-512x400", _half_batch),
    ("az128-bot-1x200", _step_unchanged),
    ("az128-bot-1x200", _answer_altered),
    ("az128-learn-b1024", _learn_state_unchanged),
    ("az128-learn-b1024", _learn_half_batch),
]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__.strip('_')}"
                              for n, f in FAULTS])
def test_a_fault_underneath_makes_the_run_incorrect(name, fault, tmp_path,
                                                    monkeypatch):
    fault(monkeypatch)
    try:
        r = dry_run(name, tmp_path)
    except (RuntimeError, ValueError, IndexError, KeyError) as e:
        pytest.fail(f"the faulty run crashed instead of reading false: {e}")
    assert not r["correct"], r["checked"]


# -- the control: the reference a precision below, in the program's place --

@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails_the_limits(name):
    prog, others = control.readings(name, 2 ** 31 + 3,
                                    SECONDS.get(name, 1.0), True,
                                    device="cpu", spec=spec(name),
                                    **SMALL[name])
    limits = cells.load_json("workloads", f"{name}.json")["limits"]
    assert all(prog[k] <= lim for k, lim in limits.items()), prog
    ctl = others["control"]
    assert any(ctl[k] > lim for k, lim in limits.items()), ctl
