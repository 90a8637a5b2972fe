"""Benchmark: MCTS simulations/s on one card at self-play settings.

    python3 -m alphazero_torch.bench

Port of the JAX package's ``bench.py``, with its knobs and its metric
names: the flagship 20-block/128-filter SE-ResNet, 800 simulations per
move with Dirichlet root noise, ``selfplay_move`` at 512 games, and

    {"metric": "mcts_sims_per_sec_per_chip", ...}

against the north-star target of 100k sims/s. The weights are the trained
archive ``artifacts/model_r5_latest.npz`` (their origin goes to stderr).
Diagnostics go to stderr; stdout carries exactly one JSON line.

Environment knobs: AZTPU_BENCH_GAMES (512), AZTPU_BENCH_SIMS (800),
AZTPU_BENCH_REPS (3), AZTPU_BENCH_MODE=move|selfplay (``selfplay`` plays
whole games through the continuous actor loop and reports games/hour),
AZTPU_BENCH_QUANT=static|dynamic|off (the evaluator: int8 with static
scales calibrated on all-empty planes, the default as in the JAX package;
int8 with per-layer amax scales; or the bf16 net),
AZTPU_BENCH_VALUE_DTYPE (float32: the CUDA tree kernels take float32
trees only).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional

import torch

from alphazero_torch import resolve_device
from alphazero_torch.config import Config
from alphazero_torch.models.convert import ARCHIVE
TARGET = 100_000.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_evaluator(net, quant: str):
    """The bench's evaluator over ``net`` (float32): "static" (int8,
    scales calibrated on 256 all-empty planes, as the JAX bench does),
    "dynamic" or "1" (int8, per-layer amax), anything else the bf16 net."""
    from alphazero_torch.search import make_net_evaluator

    if quant in ("1", "dynamic"):
        from alphazero_torch.models.quant import make_quant_evaluator

        log("evaluator: int8 dynamic-amax (models/quant.py)")
        return make_quant_evaluator(net)
    if quant == "static":
        from alphazero_torch.models.quant import (
            calibrate,
            make_quant_evaluator,
            quantize_network,
        )

        log("evaluator: int8 static-calibrated (models/quant.py)")
        dev = next(net.parameters()).device
        cal = torch.zeros((256, 3, 8, 8), device=dev)
        cal[:, 2] = 1.0
        qp = quantize_network(net)
        return make_quant_evaluator(net, act_scales=calibrate(qp, [cal]),
                                    qp=qp)
    log("evaluator: bf16 net (models/network.py)")
    return make_net_evaluator(net, torch.bfloat16)


def run_bench(num_games: int = 512, num_sims: int = 800, reps: int = 3,
              mode: str = "move", quant: str = "static",
              value_dtype: str = "float32", device="cuda",
              archive: Optional[str] = ARCHIVE,
              cfg: Optional[Config] = None) -> Dict:
    """The bench's result line as a dict. ``archive=None`` uses a random
    net of ``cfg``'s size (seed 0) instead of trained weights."""
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.search import init_tree
    from alphazero_torch.train import selfplay

    dev = resolve_device(device)
    if archive:
        from alphazero_torch.models.convert import (
            config_from_archive,
            load_archive,
        )

        base = config_from_archive(archive)
        net = load_archive(archive, device=dev)
        log(f"weights: {archive} (trained, {base.num_blocks}x"
            f"{base.num_filters})")
    else:
        from alphazero_torch.models.network import build_network

        base = cfg or Config()
        net = build_network(base, device=dev,
                            generator=torch.Generator().manual_seed(0))
        log(f"weights: random init, seed 0 ({base.num_blocks}x"
            f"{base.num_filters})")
    cfg = base.replace(num_simulations=num_sims, value_dtype=value_dtype,
                       parallel_games=num_games)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {name}, games={num_games}, sims={num_sims}, "
        f"tree dtype={value_dtype}")
    eval_fn = make_evaluator(net, quant)
    gen = torch.Generator(device=dev).manual_seed(1)

    if mode == "selfplay":
        play = (selfplay.selfplay_games_continuous if cfg.continuous_selfplay
                else selfplay.selfplay_games)
        t0 = time.time()
        play(eval_fn, cfg, gen, num_games=1, device=dev)          # warm-up
        _sync(dev)
        log(f"warm-up: {time.time() - t0:.1f}s")
        t0 = time.time()
        examples, stats = play(eval_fn, cfg, gen, device=dev)
        _sync(dev)
        dt = time.time() - t0
        sims_per_sec = stats["simulations"] / dt
        games_per_hour = stats["games"] * 3600 / dt
        log(f"selfplay: {stats['games']} games, {stats['moves']} moves, "
            f"{stats['examples']} examples in {dt:.1f}s; lockstep moves "
            f"played: {stats['moves_played']}")
        log(f"games/hour: {games_per_hour:,.0f}, env-steps/s: "
            f"{stats['moves'] / dt:,.1f}, sims/s: {sims_per_sec:,.0f}")
        return {"metric": "selfplay_games_per_hour_per_chip",
                "value": round(games_per_hour, 1), "unit": "games/hour",
                "vs_baseline": round(sims_per_sec / TARGET, 4)}

    spec = selfplay.search_spec(cfg)
    states = env.initial_state((num_games,), device=dev)
    # one tree for every move: the first move captures the simulation on
    # the card, the timed ones replay it
    tree = init_tree(states, spec)

    def run(s):
        new_states = selfplay.selfplay_move(
            s, gen, eval_fn, spec, cfg.temperature_threshold, tree)[0]
        _sync(dev)
        return new_states

    t0 = time.time()
    run(states)
    log(f"first move: {time.time() - t0:.1f}s")
    best = float("inf")
    cur = states
    for i in range(reps):
        t0 = time.time()
        cur = run(cur)
        dt = time.time() - t0
        best = min(best, dt)
        log(f"rep {i}: {dt:.3f}s -> {num_games * num_sims / dt:,.0f} sims/s")
    sims_per_sec = num_games * num_sims / best
    return {"metric": "mcts_sims_per_sec_per_chip",
            "value": round(sims_per_sec, 1), "unit": "sims/s",
            "vs_baseline": round(sims_per_sec / TARGET, 4)}


def main() -> int:
    env_ = os.environ.get
    out = run_bench(
        num_games=int(env_("AZTPU_BENCH_GAMES", "512")),
        num_sims=int(env_("AZTPU_BENCH_SIMS", "800")),
        reps=int(env_("AZTPU_BENCH_REPS", "3")),
        mode=env_("AZTPU_BENCH_MODE", "move"),
        quant=env_("AZTPU_BENCH_QUANT", "static"),
        value_dtype=env_("AZTPU_BENCH_VALUE_DTYPE", "float32"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
