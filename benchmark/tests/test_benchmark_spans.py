"""The span readers (``lib/spans.py`` and the metrics that use it): the
traced stretch's idle time put down to the program span open at each gap,
and the bot's window read from the web server's request records."""

import collections
import os
import sys
import types

import pytest

from benchmark import run
from benchmark.lib import cell as cells
from benchmark.lib import readers, spans, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SELFPLAY = ("idle_in_replays.selfplay", "idle_in_move_glue.selfplay")
BOT = ("bot_handler_p50_s", "bot_search_host_p50_s",
       "bot_sims_device_p50_s", "bot_transport_p50_s")


def metric(name):
    return run.load_file(os.path.join(ROOT, "benchmark", "metrics",
                                      f"{name}.py"), "m_" + name)


def fake_run(kind, tr=None, window_stats=None, traced_requests=0):
    cell = types.SimpleNamespace(traffic={"traced_requests": traced_requests})
    driver = types.SimpleNamespace(kind=kind,
                                   window_stats=window_stats or {})
    return readers.Run(cell=cell, driver=driver, trace=tr)


def stretch(host=()):
    """0..100 us; the device busy 10-20, 30-50, 60-70 and 80-90, so idle
    in the gaps with middles 5, 25, 55, 75 and 95: 50% in all."""
    device = [trace.Op(f"k{i}", s, e, "kernel")
              for i, (s, e) in enumerate([(10, 20), (30, 50), (60, 70),
                                          (80, 90)])]
    return trace.Trace(device=device,
                       host=[trace.Op(n, s, e, c) for n, s, e, c in host],
                       start=0.0, end=100.0)


MOVE = [
    (trace.STRETCH, 0, 100, "user_annotation"),
    ("selfplay.move", 8, 88, "user_annotation"),
    ("search.noise", 20, 32, "user_annotation"),
    ("aten::_local_scalar_dense", 22, 28, "cpu_op"),
    ("search.simulations", 50, 72, "user_annotation"),
    # a stage span is not one of tracing.NAMES: the gap stays the replays'
    ("mcts.descend", 52, 58, "user_annotation"),
]


# -----------------------------------------------------------------------------
# self-play: the idle gaps by program span
# -----------------------------------------------------------------------------

def test_gaps_go_to_the_innermost_program_span_at_their_middle():
    r = fake_run("selfplay", stretch(MOVE))
    assert spans.idle_by_span(r, "selfplay") == pytest.approx(
        {"": 20e-6, "search.noise": 10e-6, "search.simulations": 10e-6,
         "selfplay.move": 10e-6})
    replays = metric(SELFPLAY[0]).read(r)
    glue = metric(SELFPLAY[1]).read(r)
    assert replays == pytest.approx(10.0)         # the gap at 55
    assert glue == pytest.approx(20.0)            # the gaps at 25 and 75
    idle = metric("device_idle_share.selfplay").read(r)
    assert idle == pytest.approx(50.0)
    assert replays + glue <= idle                 # the rest: the driver's


@pytest.mark.parametrize("r", [
    fake_run("selfplay", None),                    # --trace 0, or the CPU
    fake_run("bot", stretch(MOVE)),                # another kind of cell
    fake_run("selfplay", stretch(MOVE[:1])),       # no program span traced
], ids=["no-trace", "bot-cell", "no-program-span"])
def test_selfplay_readers_find_nothing_to_read(r):
    assert [metric(m).read(r) for m in SELFPLAY] == [None, None]


def test_a_program_without_tracing_reads_none(monkeypatch):
    # the parent of the change that brought the spans: no such module
    monkeypatch.setitem(sys.modules, "alphazero_torch.tracing", None)
    assert spans.program_tracing() is None
    assert [metric(m).read(fake_run("selfplay", stretch(MOVE)))
            for m in SELFPLAY] == [None, None]
    r = fake_run("bot", stretch(), {"requests": 1, "p50": 1.0})
    assert [metric(m).read(r) for m in BOT] == [None] * 4


# -----------------------------------------------------------------------------
# the bot: the window's records
# -----------------------------------------------------------------------------

def record(path, request, search=None, sims=None, cpu=False):
    s = {"web.request": request}
    d = {}
    if search is not None:
        s.update({"bot.search": search, "search.root": 1e-3,
                  "search.simulations": search / 2})
        d = {"search.simulations": None if cpu else sims}
    return {"path": path, "spans": s, "device": d}


def records(cpu=False):
    """3 warm-up moves, a new game, a window of 5 moves with a new game
    inside it (one move ended its game: no search), then the stretch's 2
    moves. The warm-up's and the stretch's numbers are far off, so that
    taking one of them would show."""
    far = [record("/api/move", 9.0, 8.0, 7.0, cpu)]
    window = [record("/api/move", 0.080, 0.075, 0.066, cpu),
              record("/api/move", 0.082, 0.076, 0.067, cpu),
              record("/api/new", 5.0, 4.0, 3.0, cpu),
              record("/api/move", 0.004),
              record("/api/move", 0.084, 0.078, 0.068, cpu),
              record("/api/move", 0.090, 0.081, 0.070, cpu)]
    return (far * 3 + [record("/api/new", 5.0)] + window
            + [record("/api/new", 5.0)] + far * 2)


def bot_run(monkeypatch, recs, requests=5, tr="traced"):
    from alphazero_torch import tracing

    monkeypatch.setattr(tracing, "REQUESTS",
                        collections.deque(recs, maxlen=4096))
    return fake_run("bot", stretch() if tr == "traced" else None,
                    {"requests": requests, "p50": 0.0850},
                    traced_requests=2)


def test_the_window_is_the_moves_before_the_stretch(monkeypatch):
    r = bot_run(monkeypatch, records())
    w = spans.window_requests(r)
    assert [x["spans"]["web.request"] for x in w] == [
        0.080, 0.082, 0.004, 0.084, 0.090]
    got = {m: metric(m).read(r) for m in BOT}
    # web.request less bot.search: 0.005, 0.006, 0.004 (no search), 0.006,
    # 0.009
    assert got["bot_handler_p50_s"] == pytest.approx(0.006)
    # bot.search less the simulations' device time, the four that searched:
    # 0.009, 0.009, 0.010, 0.011
    assert got["bot_search_host_p50_s"] == pytest.approx(0.0095)
    assert got["bot_sims_device_p50_s"] == pytest.approx(0.0675)
    # the client's median less the median web.request (0.082)
    assert got["bot_transport_p50_s"] == pytest.approx(0.003)


def test_on_the_cpu_the_device_metrics_read_none(monkeypatch):
    r = bot_run(monkeypatch, records(cpu=True))
    got = {m: metric(m).read(r) for m in BOT}
    assert got["bot_search_host_p50_s"] is None
    assert got["bot_sims_device_p50_s"] is None
    assert got["bot_handler_p50_s"] == pytest.approx(0.006)
    assert got["bot_transport_p50_s"] == pytest.approx(0.003)


@pytest.mark.parametrize("case", ["untraced", "too-few", "no-window",
                                  "selfplay"])
def test_bot_readers_find_nothing_to_read(monkeypatch, case):
    r = bot_run(monkeypatch, records(),
                requests={"too-few": 9, "no-window": 0}.get(case, 5),
                tr=None if case == "untraced" else "traced")
    if case == "selfplay":
        r.driver.kind = "selfplay"
    assert [metric(m).read(r) for m in BOT] == [None] * 4


def test_a_bot_run_on_the_cpu_reads_its_own_records(tmp_path):
    """The bot driver at a tiny size on the CPU, its window and stretch
    through the program's web server: the window's records are the
    window's requests, and the device metrics read None."""
    cell = cells.load_cell("az128-bot-1x200", 2 ** 31 + 5, "cpu",
                           str(tmp_path), simulations=8, warmup_requests=1,
                           traced_requests=2,
                           config_search_precision="float32")
    drv = run.load_file(os.path.join(ROOT, "benchmark", "drivers",
                                     "bot_http.py"), "d_bot").Driver(cell)
    drv.setup()
    try:
        drv.window(1.0)
        drv.stretch()
    finally:
        drv.release()
    r = readers.Run(cell=cell, driver=drv, trace=stretch())
    w = spans.window_requests(r)
    assert len(w) == drv.window_stats["requests"] > 0
    assert all(x["path"] == "/api/move" for x in w)
    got = {m: metric(m).read(r) for m in BOT}
    assert got["bot_search_host_p50_s"] is None
    assert got["bot_sims_device_p50_s"] is None
    assert 0 < got["bot_handler_p50_s"] < drv.window_stats["p50"]
    assert got["bot_transport_p50_s"] > 0
