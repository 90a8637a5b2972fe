"""Arena daemon: continuous matchmaking over iteration checkpoints.

Port of ``alphazero_tpu/arena/runner.py``: discover models, score all
pairs with S = p(1-p) / (1 + sqrt(N_games)) * exp(lambda*z_top),
epsilon-greedy over the top 5 at 15%, then play two standard-start and
two random-opening games (one lockstep batch of four), record ELO, log the
leaderboard. It ranks the port's own ``torch.save`` checkpoints
(``train/checkpoint.py``); the JAX package's Orbax checkpoints do not
cross.
"""

from __future__ import annotations

import math
import random
import time
from itertools import combinations
from typing import Optional, Tuple

import numpy as np

from alphazero_torch import resolve_device
from alphazero_torch.arena.elo import ArenaState
from alphazero_torch.arena.match import play_paired_matches, random_opening
from alphazero_torch.config import Config
from alphazero_torch.env import OracleGame
from alphazero_torch.models.network import AlphaZeroNet, build_network
from alphazero_torch.train import checkpoint as ckpt
from alphazero_torch.utils import setup_logging

log = setup_logging()

EXPLORATION_RATE = 0.15
TOP_K = 5
BIAS_LAMBDA = 0.15


def select_matchup(state: ArenaState,
                   rng: Optional[random.Random] = None
                   ) -> Optional[Tuple[str, str, float]]:
    """Pick the most informative pair."""
    rng = rng or random
    models = list(state.ratings.keys())
    if len(models) < 2:
        return None

    ratings = list(state.ratings.values())
    mu, sigma = float(np.mean(ratings)), float(np.std(ratings))

    scored = []
    for a, b in combinations(models, 2):
        ra, rb = state.get_rating(a), state.get_rating(b)
        p = 1.0 / (1.0 + 10.0 ** ((rb - ra) / 400.0))
        variance = p * (1.0 - p)
        n = state.get_match_count(a, b)
        base = variance / (1.0 + math.sqrt(n))
        z_top = (max(ra, rb) - mu) / (sigma + 1e-9)
        scored.append((a, b, base * math.exp(BIAS_LAMBDA * z_top)))
    scored.sort(key=lambda x: x[2], reverse=True)

    if rng.random() < EXPLORATION_RATE and len(scored) >= TOP_K:
        return rng.choice(scored[:TOP_K])
    return scored[0]


def load_model(cfg: Config, path: str, device="cuda") -> AlphaZeroNet:
    """The float32 net of a checkpoint, in eval mode on ``device``, built
    with the architecture stored beside it (not the live config's)."""
    dev = resolve_device(device)
    net = build_network(cfg.with_arch(ckpt.checkpoint_arch(path)),
                        device=dev)
    return ckpt.load_net_weights(path, net).eval()


def run_arena(cfg: Config, max_rounds: Optional[int] = None,
              seed: Optional[int] = None, device="cuda") -> None:
    dev = resolve_device(device)
    state = ArenaState(cfg)
    rng = random.Random(seed)
    rounds = 0

    log.info("arena started: continuous matchmaking (ctrl-c to stop)")
    while max_rounds is None or rounds < max_rounds:
        state.discover_models()
        matchup = select_matchup(state, rng)
        if matchup is None:
            log.info("waiting for at least 2 models...")
            time.sleep(30)
            continue

        name_a, name_b, score = matchup
        log.info("MATCHMAKING %s vs %s (score %.5f)", name_a, name_b, score)
        net_a = load_model(cfg, cfg.checkpoint_path(name_a), dev)
        net_b = load_model(cfg, cfg.checkpoint_path(name_b), dev)

        openings = [OracleGame(), random_opening(rng)]
        wins_a, wins_b = play_paired_matches(net_a, net_b, openings, cfg,
                                             device=dev)
        log.info("result: %s %d-%d %s", name_a, wins_a, wins_b, name_b)
        state.record_match(name_a, name_b, wins_a, wins_b)

        for rank, (name, rating) in enumerate(state.leaderboard()[:10], 1):
            marker = " *" if name == state.best_model else ""
            log.info("  %d. %s: %.0f%s", rank, name, rating, marker)
        rounds += 1
