"""The PyTorch port's CLI (``python -m alphazero_torch``) and bench
(``alphazero_torch/bench.py``) on the CPU at a tiny size, and the port's
import boundary: no module of it, and not ``chip_smoke.py``, imports JAX,
Flax or the JAX package."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

from alphazero_torch import bench
from alphazero_torch.config import tiny_config
from alphazero_torch.main import build_parser, main

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "alphazero_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_port_imports_nothing_of_jax():
    files = sorted((ROOT / "alphazero_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for sub in ("baseline", "web", "strength", "parallel"):
        assert ROOT / "alphazero_torch" / sub / "__init__.py" in files
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_train_then_arena_through_the_cli(tmp_path):
    """``python -m alphazero_torch train --cpu ... --selfplay-quant static``
    writes two checkpoints and two metrics lines (the second iteration's
    self-play calibrates on the first one's data); ``arena --cpu --rounds
    1`` on them writes the ratings file."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    cmd = [sys.executable, "-m", "alphazero_torch", "train", "--cpu",
           "--blocks", "2", "--filters", "8", "--sims", "8", "--games", "4",
           "--iterations", "2", "--selfplay-quant", "static",
           "--selfplay-batches", "1", "--buffer", "4096"]
    run = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    ck = tmp_path / "checkpoints"
    with open(ck / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [m["iteration"] for m in lines] == [1, 2]
    assert (ck / "iteration_1").is_dir() and (ck / "iteration_2").is_dir()
    assert json.loads((ck / "iteration_2" / "alphazero_meta.json")
                      .read_text())["arch"]["num_filters"] == 8

    main(["arena", "--cpu", "--rounds", "1", "--sims", "4",
          "--checkpoint-dir", str(ck)])
    state = json.loads((ck / "arena_state.json").read_text())
    assert set(state["ratings"]) == {"iteration_1", "iteration_2"}
    assert len(state["matches"]) == 1 and (ck / "model_best").is_dir()


def test_cli_refuses_web_and_jax_only_flags(capsys):
    """``--scan-blocks`` (a Flax layout) is refused by every command;
    ``--distributed`` and ``--debug-nans`` are the JAX ``main.py``'s
    common flags, ported."""
    for argv in (["web", "--scan-blocks"], ["train", "--scan-blocks"],
                 ["arena", "--scan-blocks"]):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
    capsys.readouterr()
    for cmd in ("train", "arena", "web"):
        args = build_parser().parse_args([cmd, "--distributed",
                                          "--debug-nans"])
        assert args.distributed and args.debug_nans


def test_train_over_two_gloo_ranks_through_torchrun(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    alphazero_torch train --cpu --distributed`` for one iteration: one
    metrics line (rank 0 writes it), a replay shard per rank."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "alphazero_torch", "train",
           "--cpu", "--distributed", "--blocks", "1", "--filters", "8",
           "--sims", "4", "--games", "2", "--iterations", "1",
           "--selfplay-batches", "1", "--buffer", "2048"]
    run = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "rank 1 of 2 (gloo)" in run.stderr
    ck = tmp_path / "checkpoints"
    with open(ck / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [m["iteration"] for m in lines] == [1]
    assert (ck / "training_data.npz").exists()
    assert (ck / "training_data_p1.npz").exists()
    assert (ck / "iteration_1").is_dir()


def test_web_through_the_cli(monkeypatch, tmp_path):
    """``python -m alphazero_torch web --cpu --port 0`` serves from a thread,
    answers ``/api/config`` and shuts down."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from alphazero_torch.web import server

    started = []

    class Recorded(ThreadingHTTPServer):
        def serve_forever(self, *a, **kw):
            started.append(self)
            super().serve_forever(*a, **kw)

    monkeypatch.setattr(server, "ThreadingHTTPServer", Recorded)
    argv = ["web", "--cpu", "--host", "127.0.0.1", "--port", "0",
            "--blocks", "1", "--filters", "8", "--sims", "4",
            "--checkpoint-dir", str(tmp_path)]
    t = threading.Thread(target=main, args=(argv,), daemon=True)
    t.start()
    for _ in range(600):
        if started or not t.is_alive():
            break
        t.join(timeout=0.1)
    assert started, "the server did not start"
    httpd = started[0]
    url = f"http://127.0.0.1:{httpd.server_address[1]}/api/config"
    with urllib.request.urlopen(url, timeout=60) as r:
        assert json.loads(r.read()) == {"board_size": 8, "num_actions": 192}
    httpd.shutdown()
    t.join(timeout=30)
    assert not t.is_alive()


def _tiny_bench(**kw):
    cfg = tiny_config(num_blocks=1, num_filters=8)
    return bench.run_bench(**dict(dict(num_games=4, num_sims=4, reps=1,
                                       device="cpu", archive=None, cfg=cfg),
                                  **kw))


@pytest.mark.parametrize("quant", ["static", "dynamic", "off"])
def test_bench_move_mode(quant, capsys):
    out = _tiny_bench(quant=quant)
    assert out["metric"] == "mcts_sims_per_sec_per_chip"
    assert out["unit"] == "sims/s" and out["value"] > 0
    # vs_baseline is the unrounded sims/s over 1e5 rounded to 4 places and
    # value the sims/s rounded to 0.1 (bench.py, as the JAX bench): the
    # two roundings apart are within 5e-5 + 0.05 / 1e5 of each other
    assert abs(out["vs_baseline"] - out["value"] / 100_000.0) <= 5e-5 + 5e-7
    err = capsys.readouterr().err
    assert {"static": "static-calibrated", "dynamic": "dynamic-amax",
            "off": "bf16 net"}[quant] in err
    assert "random init" in err


def test_bench_selfplay_mode_and_one_json_line(monkeypatch, capsys):
    out = _tiny_bench(mode="selfplay", num_sims=2, quant="static")
    assert out["metric"] == "selfplay_games_per_hour_per_chip"
    assert out["unit"] == "games/hour" and out["value"] > 0
    capsys.readouterr()

    # main(): the knobs from the environment, one JSON line on stdout
    real = bench.run_bench
    seen = {}

    def tiny(**kw):
        seen.update(kw)
        return real(**dict(kw, device="cpu", archive=None,
                           cfg=tiny_config(num_blocks=1, num_filters=8)))

    monkeypatch.setattr(bench, "run_bench", tiny)
    for k, v in (("GAMES", "2"), ("SIMS", "3"), ("REPS", "2"),
                 ("MODE", "move"), ("QUANT", "dynamic"),
                 ("VALUE_DTYPE", "float32")):
        monkeypatch.setenv(f"AZTPU_BENCH_{k}", v)
    assert bench.main() == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0])["metric"] == "mcts_sims_per_sec_per_chip"
    assert seen == dict(num_games=2, num_sims=3, reps=2, mode="move",
                        quant="dynamic", value_dtype="float32")
    assert bench.ARCHIVE.endswith("artifacts/model_r5_latest.npz")
    assert os.path.exists(bench.ARCHIVE)
