"""Dry runs of the benchmark's encoder and int8 self-play cells on the CPU
at a tiny size, as ``benchmark/tests/test_benchmark_drivers.py`` runs the
others: a sound run reads ``correct``, every fault planted in the program
underneath the harness reads incorrect, and the control fails the cell's
limits.

The encoder cell runs the configuration's widths at fewer layers (the
float8 control's error grows with the widths, so the cell's limits are
met at them), searched in float32 on the CPU (the bf16 route's sums there
are the plain versions', not the card's); the int8 cell runs its own
int8-static evaluator on the flagship's trained weights, calibrated as on
the card from bf16 moves, a few lanes and simulations.
"""

import pytest
import torch

torch.set_num_threads(2)

from benchmark import control, run
from benchmark.lib import cell as cells
from benchmark.tests import test_benchmark_drivers as drivers

BT4 = "bt4-selfplay-512x400"
INT8 = "az128-selfplay-int8-512x400"
SMALL = {
    BT4: dict(lanes=2, simulations=8, check_trees=2, warmup_moves=1,
              config_enc_layers=2, config_search_precision="float32"),
    INT8: dict(lanes=4, simulations=16, check_trees=4, tree_share=1.0,
               warmup_moves=1, calibration_moves=2, calibration_rows=64,
               calibration_batch=32),
}


def dry_run(name, tmp_path, seed=2 ** 31 + 77):
    cell = cells.load_cell(name, seed, "cpu", str(tmp_path), **SMALL[name])
    return run.run_cell(cell, 1.0, False, cells.benchmark_json(), start=0.0)


@pytest.mark.parametrize("name", [BT4, INT8])
def test_a_sound_run_is_correct(name, tmp_path):
    r = dry_run(name, tmp_path)
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["numbers"]["trees_judged"] > 0
    assert r["correct"], [(k, c["value"], c["limit"])
                          for k, c in r["checked"].items()]
    assert set(r["checked"]) == set(cells.load_json(
        "workloads", f"{name}.json")["limits"])
    assert r["window"]["captures"] == 0


FAULTS = [(name, fault) for name in (BT4, INT8)
          for fault in (drivers._step_unchanged, drivers._answer_altered,
                        drivers._half_batch)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__.strip('_')}"
                              for n, f in FAULTS])
def test_a_fault_underneath_makes_the_run_incorrect(name, fault, tmp_path,
                                                    monkeypatch):
    if name == INT8 and fault is not drivers._step_unchanged:
        # the int8 evaluator is quant.make_quant_evaluator's
        from alphazero_torch.models import quant

        make = quant.make_quant_evaluator
        fault_fn = {drivers._answer_altered: lambda p, v: (p.roll(1, -1), v),
                    drivers._half_batch: _half}[fault]

        def wrapped(*a, **kw):
            inner = make(*a, **kw)
            return lambda planes, *ctx: fault_fn(*inner(planes, *ctx))

        monkeypatch.setattr(quant, "make_quant_evaluator", wrapped)
    else:
        fault(monkeypatch)
    r = dry_run(name, tmp_path)
    assert not r["correct"], r["checked"]


def _half(p, v):
    n = max(1, p.shape[0] // 2)
    p, v = p.clone(), v.clone()
    p[n:] = p[:n].mean(0)
    v[n:] = v[:n].mean(0)
    return p, v


@pytest.mark.parametrize("name", [BT4, INT8])
def test_the_control_fails_the_limits(name):
    prog, others = control.readings(name, 2 ** 31 + 3, 1.0, True,
                                    device="cpu", **SMALL[name])
    limits = cells.load_json("workloads", f"{name}.json")["limits"]
    assert all(prog[k] <= lim for k, lim in limits.items()), prog
    ctl = others["control"]
    assert any(ctl[k] > lim for k, lim in limits.items()), ctl


def test_the_parent_program_refuses_the_encoder_cell_at_once(monkeypatch,
                                                             tmp_path):
    """A program without the encoder body (its ``Config`` takes no
    ``body``) fails the cell when set-up makes the config, before any
    kernel is built or weight drawn."""
    import dataclasses

    from alphazero_torch import config

    @dataclasses.dataclass(frozen=True)
    class OldConfig:
        num_simulations: int = 400

    monkeypatch.setattr(config, "Config", OldConfig)
    with pytest.raises(TypeError):
        dry_run(BT4, tmp_path)
