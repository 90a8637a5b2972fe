"""Dry runs of the benchmark's MuZero self-play cell and 128-lane self-play
cell on the CPU at a tiny size, as ``tests/test_bench_nbt_cells.py`` runs
the nested-bottleneck cell: a sound run reads ``correct``; a fault planted
in the program underneath the harness, or in the copied trees the check
reads (a stored state, a reward, a visit), reads incorrect; the float8
control fails the cell's limits; and a parent program without MuZero's
body refuses its cell at once.

The MuZero cell runs both towers' 16 blocks (the float8 control's error
grows with depth) at a width of 32, its norms calibrated on 256 positions,
searched in float32 on the CPU (the bf16 route's sums there are the plain
versions', not the card's)."""

import pytest
import torch

torch.set_num_threads(2)

from benchmark import control, run
from benchmark.drivers import selfplay
from benchmark.lib import cell as cells
from benchmark.tests import test_benchmark_drivers as drivers

MZ = "muzero-selfplay-512x800"
SP = "az128-selfplay-128x32"
SMALL = {
    # every copied tree judged: a fault in one lane of two is always seen
    MZ: dict(lanes=2, simulations=8, check_trees=64, warmup_moves=1,
             config_mz_filters=32, config_search_precision="float32",
             config_weights={"seeded": True, "calibrated_positions": 256}),
    SP: dict(lanes=4, simulations=16, check_trees=4, tree_share=1.0,
             warmup_moves=1, config_search_precision="float32"),
}


def dry_run(name, tmp_path, seed=2 ** 31 + 77):
    cell = cells.load_cell(name, seed, "cpu", str(tmp_path), **SMALL[name])
    return run.run_cell(cell, 1.0, False, cells.benchmark_json(), start=0.0)


@pytest.mark.parametrize("name", [MZ, SP])
def test_a_sound_run_is_correct(name, tmp_path):
    r = dry_run(name, tmp_path)
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["numbers"]["trees_judged"] > 0
    assert r["correct"], [(k, c["value"], c["limit"])
                          for k, c in r["checked"].items()]
    assert set(r["checked"]) == set(cells.load_json(
        "workloads", f"{name}.json")["limits"])


def _wrap_recurrent(monkeypatch, fault):
    from alphazero_torch.models import muzero_inference as mi

    rec = mi.Evaluator.recurrent

    def recurrent(self, *a, **kw):
        return fault(*rec(self, *a, **kw))

    monkeypatch.setattr(mi.Evaluator, "recurrent", recurrent)


def _answer_altered(monkeypatch):
    # every policy produced is shifted by one action
    _wrap_recurrent(monkeypatch, lambda p, v, r, s: (p.roll(1, -1), v, r, s))


def _half_batch(monkeypatch):
    # the second half of the batch left out, the mean of the first given
    def fault(p, v, r, s):
        n = max(1, p.shape[0] // 2)
        p, v = p.clone(), v.clone()
        p[n:] = p[:n].mean(0)
        v[n:] = v[:n].mean(0)
        return p, v, r, s

    _wrap_recurrent(monkeypatch, fault)


def _stored_state_altered(monkeypatch):
    from alphazero_torch.models import muzero_inference as mi

    store = mi.Evaluator._store

    def altered(rows, store_, slot):
        store(rows * 0.8, store_, slot)

    monkeypatch.setattr(mi.Evaluator, "_store", staticmethod(altered))


def _reward_altered(monkeypatch):
    _wrap_recurrent(monkeypatch, lambda p, v, r, s: (p, v, -r, s))


FAULTS = [drivers._step_unchanged, _answer_altered, _half_batch,
          _stored_state_altered, _reward_altered]


@pytest.mark.parametrize("fault", FAULTS,
                         ids=[f.__name__.strip("_") for f in FAULTS])
def test_a_fault_underneath_makes_the_run_incorrect(fault, tmp_path,
                                                    monkeypatch):
    fault(monkeypatch)
    r = dry_run(MZ, tmp_path)
    assert not r["correct"], r["checked"]


def _corrupt(what):
    """The copied trees as the check reads them, one number changed in
    every copied tree: a stored state, a reward or a visit."""
    def corrupt(recs):
        for r in recs:
            if "rows" not in r:
                continue
            if what == "latent":
                r["latent"] = r["latent"].copy()
                r["latent"][:, 3, 5] += 0.25
            elif what == "reward":
                r["reward"] = r["reward"].copy()
                r["reward"][:, 2] += 0.25
            else:
                rows = r["rows"].copy()
                flat = rows.reshape(rows.shape[0], rows.shape[1], -1)
                flat[:, 0, 2 * 192 + int(flat[0, 0, 2 * 192:3 * 192]
                                         .argmax())] += 1
                r["rows"] = rows
        return recs
    return corrupt


@pytest.mark.parametrize("what,number", [("latent", "latent_err_max"),
                                         ("reward", "reward_err_max"),
                                         ("visit", "tree_mismatch")])
def test_the_tree_check_fails_a_corrupted_copy(what, number, tmp_path,
                                               monkeypatch):
    # the cell's driver inherits the copies' move to the host
    host = selfplay.Driver._host_records
    monkeypatch.setattr(selfplay.Driver, "_host_records",
                        lambda self: _corrupt(what)(host(self)))
    r = dry_run(MZ, tmp_path)
    assert not r["correct"]
    assert r["checked"][number]["value"] > r["checked"][number]["limit"]


@pytest.mark.parametrize("name", [MZ, SP])
def test_the_control_fails_the_limits(name):
    prog, others = control.readings(name, 2 ** 31 + 3, 1.0, True,
                                    device="cpu", **SMALL[name])
    limits = cells.load_json("workloads", f"{name}.json")["limits"]
    assert all(prog[k] <= lim for k, lim in limits.items()), prog
    ctl = others["control"]
    assert any(ctl[k] > lim for k, lim in limits.items()), ctl


def test_the_parent_program_refuses_the_muzero_cell_at_once(monkeypatch,
                                                            tmp_path):
    """A program without MuZero's body (its ``Config`` has no ``mz_*``
    fields) fails the cell when set-up makes the config, before any
    kernel is built or weight drawn."""
    import dataclasses

    from alphazero_torch import config

    @dataclasses.dataclass(frozen=True)
    class OldConfig:
        body: str = "se_resnet"
        num_simulations: int = 400

    monkeypatch.setattr(config, "Config", OldConfig)
    with pytest.raises(TypeError):
        dry_run(MZ, tmp_path)
