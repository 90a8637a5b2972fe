"""Dry runs of the benchmark's nested-bottleneck self-play cell and C 256
bot cell on the CPU at a tiny size, as ``tests/test_bench_new_cells.py``
runs the encoder's and int8 cells: a sound run reads ``correct``, a fault
planted in the program underneath the harness reads incorrect, the float8
control fails the cell's limits, and a parent program without the
nested-bottleneck body refuses its cell at once.

The nbt cell runs all 28 blocks (the float8 control's error grows with
depth, so the cell's limits are met at it) at a quarter of the published
widths, its norms calibrated on 256 positions, searched in float32 on the
CPU (the bf16 route's sums there are the plain versions', not the
card's). The bot cell runs T40's 20 x 256 net whole, in float32, as
``benchmark/tests/test_benchmark_drivers.py`` runs its self-play cell.
"""

import pytest
import torch

torch.set_num_threads(2)

from benchmark import control, run
from benchmark.lib import cell as cells
from benchmark.tests import test_benchmark_drivers as drivers

NBT = "nbt-selfplay-512x400"
BOT = "lc0-256-bot-1x200"
SMALL = {
    NBT: dict(lanes=2, simulations=8, check_trees=2, warmup_moves=1,
              config_nbt_trunk=128, config_nbt_mid=64, config_nbt_gpool=16,
              config_search_precision="float32",
              config_weights={"seeded": True, "calibrated_positions": 256}),
    BOT: dict(simulations=16, warmup_requests=1, check_trees=4,
              config_search_precision="float32"),
}
SECONDS = {BOT: 2.0}


def dry_run(name, tmp_path, seed=2 ** 31 + 77):
    cell = cells.load_cell(name, seed, "cpu", str(tmp_path), **SMALL[name])
    return run.run_cell(cell, SECONDS.get(name, 1.0), False,
                        cells.benchmark_json(), start=0.0)


@pytest.mark.parametrize("name", [NBT, BOT])
def test_a_sound_run_is_correct(name, tmp_path):
    r = dry_run(name, tmp_path)
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["numbers"]["trees_judged"] > 0
    assert r["correct"], [(k, c["value"], c["limit"])
                          for k, c in r["checked"].items()]
    assert set(r["checked"]) == set(cells.load_json(
        "workloads", f"{name}.json")["limits"])


# the bot's batch is one board: no half of it to leave out
FAULTS = [(name, fault) for name in (NBT, BOT)
          for fault in (drivers._step_unchanged, drivers._answer_altered,
                        drivers._half_batch)
          if (name, fault) != (BOT, drivers._half_batch)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__.strip('_')}"
                              for n, f in FAULTS])
def test_a_fault_underneath_makes_the_run_incorrect(name, fault, tmp_path,
                                                    monkeypatch):
    fault(monkeypatch)
    r = dry_run(name, tmp_path)
    assert not r["correct"], r["checked"]


@pytest.mark.parametrize("name", [NBT, BOT])
def test_the_control_fails_the_limits(name):
    prog, others = control.readings(name, 2 ** 31 + 3,
                                    SECONDS.get(name, 1.0), True,
                                    device="cpu", **SMALL[name])
    limits = cells.load_json("workloads", f"{name}.json")["limits"]
    assert all(prog[k] <= lim for k, lim in limits.items()), prog
    ctl = others["control"]
    assert any(ctl[k] > lim for k, lim in limits.items()), ctl


def test_the_parent_program_refuses_the_nbt_cell_at_once(monkeypatch,
                                                         tmp_path):
    """A program without the nested-bottleneck body (its ``Config`` has no
    ``nbt_*`` fields) fails the cell when set-up makes the config, before
    any kernel is built or weight drawn."""
    import dataclasses

    from alphazero_torch import config

    @dataclasses.dataclass(frozen=True)
    class OldConfig:
        body: str = "se_resnet"
        num_simulations: int = 400

    monkeypatch.setattr(config, "Config", OldConfig)
    with pytest.raises(TypeError):
        dry_run(NBT, tmp_path)
