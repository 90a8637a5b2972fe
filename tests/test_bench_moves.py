"""The move-record readers (``benchmark/lib/moves.py`` and the four
metrics that use it): the window's move records picked out of
``tracing.MOVES`` as the bot's requests are out of ``REQUESTS``, and each
metric against its value worked out by hand; None wherever the run holds
nothing to read. Last, a selfplay cell's tiny run on the CPU through the
program, whose window the records cover move for move."""

import collections
import os
import sys
import types

import pytest
import torch

torch.set_num_threads(2)

from alphazero_torch import tracing  # noqa: E402
from benchmark import run as brun  # noqa: E402
from benchmark.lib import cell as cells  # noqa: E402
from benchmark.lib import moves, readers  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SELFPLAY = ("sims_device_share.selfplay", "move_glue_host_p50_s.selfplay",
            "device_allocs_per_move.selfplay")
BOT = "device_allocs_per_request.bot"


def metric(name):
    return brun.load_file(os.path.join(ROOT, "benchmark", "metrics",
                                       f"{name}.py"), "m_" + name)


def fake_run(kind, moves_=0, requests=0, traced=True, sims=32,
             stretch_units=32, traced_requests=2):
    cell = types.SimpleNamespace(traffic={
        "simulations": sims, "traced_requests": traced_requests})
    driver = types.SimpleNamespace(
        kind=kind, window_stats={"moves": moves_, "requests": requests,
                                 "seconds": 0.092})
    return readers.Run(cell=cell, driver=driver,
                       trace=object() if traced else None,
                       stretch_units=stretch_units)


def move(t0, length, sims, wait, device, allocs):
    """A move record of ``length`` seconds from ``t0`` (seconds)."""
    return {"spans": {"selfplay.move": length, "search.root": 0.001,
                      "search.noise": wait + 0.0005, "host.wait": wait,
                      "search.simulations": sims},
            "device": {"search.simulations": device}, "allocs": allocs,
            "intervals": [], "t0": int(t0 * 1e9),
            "t1": int((t0 + length) * 1e9)}


def records(cpu=False):
    """Two warm-up moves, a window of four, then one traced move. The
    warm-up's and the stretch's numbers are far off, so that taking one of
    them would show."""
    far = [move(0.0, 9.0, 1.0, 1.0, None if cpu else 5.0, 40)]
    window = [move(10.000, 0.020, 0.001, 0.011, None if cpu else 0.017, 0),
              move(10.020, 0.019, 0.002, 0.010, None if cpu else 0.018, 1),
              move(10.039, 0.021, 0.001, 0.012, None if cpu else 0.016, 0),
              move(10.060, 0.020, 0.003, 0.009, None if cpu else 0.018, 2)]
    if cpu:
        for r in window:
            r["allocs"] = None
    return far * 2 + window + [move(20.0, 7.0, 2.0, 3.0, 9.0, 50)]


@pytest.fixture
def program(monkeypatch):
    def put(moves_=(), requests=()):
        monkeypatch.setattr(tracing, "MOVES",
                            collections.deque(moves_, maxlen=4096))
        monkeypatch.setattr(tracing, "REQUESTS",
                            collections.deque(requests, maxlen=4096))
    return put


def test_the_window_is_the_moves_before_the_stretch(program):
    program(records())
    r = fake_run("selfplay", moves_=4)
    w = moves.window_moves(r)
    assert [x["t0"] for x in w] == [int(t * 1e9) for t in
                                    (10.000, 10.020, 10.039, 10.060)]
    got = {m: metric(m).read(r) for m in SELFPLAY}
    # 0.069 s of the replays' device time over the window's 0.092 s (the
    # records span 10.000 .. 10.080 s: the card ran the last move's
    # replays after the host closed its record)
    assert got["sims_device_share.selfplay"] == pytest.approx(75.0)
    # move less simulations less host.wait: 0.008, 0.007, 0.008, 0.008
    assert got["move_glue_host_p50_s.selfplay"] == pytest.approx(0.008)
    assert got["device_allocs_per_move.selfplay"] == pytest.approx(0.75)


def test_a_stretch_of_two_moves_drops_two(program):
    recs = records()
    program(recs[:-1] + [recs[-1]] * 2)
    r = fake_run("selfplay", moves_=4, sims=400, stretch_units=800)
    assert [x["t0"] for x in moves.window_moves(r)] == [
        x["t0"] for x in recs[2:6]]


def test_on_the_cpu_the_device_metrics_read_none(program):
    program(records(cpu=True))
    got = {m: metric(m).read(fake_run("selfplay", moves_=4))
           for m in SELFPLAY}
    assert got["sims_device_share.selfplay"] is None
    assert got["device_allocs_per_move.selfplay"] is None
    assert got["move_glue_host_p50_s.selfplay"] == pytest.approx(0.008)


@pytest.mark.parametrize("case", ["untraced", "too-few", "no-window",
                                  "bot-cell"])
def test_selfplay_readers_find_nothing_to_read(program, case):
    program(records())
    r = fake_run("bot" if case == "bot-cell" else "selfplay",
                 moves_={"too-few": 7, "no-window": 0}.get(case, 4),
                 traced=case != "untraced")
    assert [metric(m).read(r) for m in SELFPLAY] == [None] * 3


@pytest.mark.parametrize("missing", ["tracing", "MOVES"])
def test_a_program_without_move_records_reads_none(monkeypatch, program,
                                                   missing):
    # the parent of the change that brought the records
    program()
    if missing == "tracing":
        monkeypatch.setitem(sys.modules, "alphazero_torch.tracing", None)
    else:
        monkeypatch.delattr(tracing, "MOVES")
    r = fake_run("selfplay", moves_=4)
    assert [metric(m).read(r) for m in SELFPLAY] == [None] * 3
    b = fake_run("bot", requests=3)
    assert metric(BOT).read(b) is None


def request(path, allocs="none", searched=True):
    rec = {"path": path, "spans": {"web.request": 0.09},
           "device": {"search.simulations": 0.07} if searched else {}}
    if allocs != "none":
        rec["allocs"] = allocs
    return rec


@pytest.mark.parametrize("old", [False, True], ids=["records", "parent"])
def test_the_bots_allocations_per_request(program, old):
    """3 warm-up moves, a new game, a window of 4 moves (one ended its
    game and searched nothing: its record counts none, and the next
    counts what was allocated since), then the stretch's 2 moves."""
    a = (lambda n: "none") if old else (lambda n: n)
    far = request("/api/move", a(30))
    window = [request("/api/move", a(0)), request("/api/new", a(None), False),
              request("/api/move", a(1)),
              request("/api/move", a(None), False),
              request("/api/move", a(2))]
    program(requests=[far] * 3 + [request("/api/new", a(None), False)]
            + window + [far] * 2)
    r = fake_run("bot", requests=4)
    assert metric(BOT).read(r) == (None if old else pytest.approx(0.75))
    r.driver.kind = "selfplay"
    assert metric(BOT).read(r) is None


def test_a_selfplay_run_on_the_cpu_reads_its_own_records(tmp_path):
    """The selfplay driver at a tiny size on the CPU: a window of moves
    through the program and one stretch move, then the readers as a
    ``--trace 1`` run calls them. The window's records are its moves, one
    for one; on the CPU the device metrics read None."""
    cell = cells.load_cell("az128-selfplay-128x32", 2 ** 31 + 11, "cpu",
                           str(tmp_path), lanes=4, simulations=8,
                           check_trees=2, warmup_moves=1,
                           config_search_precision="float32")
    drv = brun.load_file(os.path.join(ROOT, "benchmark", "drivers",
                                      "selfplay.py"), "d_sp").Driver(cell)
    drv.setup()
    before = len(tracing.MOVES)
    drv.window(0.5)
    units = drv.stretch()
    drv.release()
    n = drv.window_stats["moves"]
    assert n > 0 and len(tracing.MOVES) == min(before + n + 1, 4096)
    r = readers.Run(cell=cell, driver=drv, trace=object(),
                    stretch_units=units)
    w = moves.window_moves(r)
    assert len(w) == n and w[-1] is tracing.MOVES[-2]
    assert all(a["t1"] <= b["t0"] for a, b in zip(w, w[1:]))
    got = {m: metric(m).read(r) for m in SELFPLAY}
    assert got["sims_device_share.selfplay"] is None
    assert got["device_allocs_per_move.selfplay"] is None
    glue = got["move_glue_host_p50_s.selfplay"]
    assert 0 < glue < drv.window_stats["seconds"] / n
    assert w[0]["t0"] < w[-1]["t1"] and (
        w[-1]["t1"] - w[0]["t0"]) / 1e9 <= drv.window_stats["seconds"]
