"""ELO ratings + persistent arena state.

Port of ``alphazero_tpu/arena/elo.py``: K=32 updates with the standard
expected score, initial rating 1000, JSON persistence with the same schema
(ratings / matches / best_model / match_counts / last_updated), match
counts rebuilt from history on load, best-model tracking synced to a
``model_best`` checkpoint on change. Under a process group only the
coordinator (rank 0) writes, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Dict, List, Optional, Tuple

from alphazero_torch.config import Config
from alphazero_torch.train import checkpoint as ckpt
from alphazero_torch.utils import is_coordinator

INITIAL_ELO = 1000.0
K_FACTOR = 32.0


def expected_score(rating_a: float, rating_b: float) -> float:
    return 1.0 / (1.0 + 10.0 ** ((rating_b - rating_a) / 400.0))


class ArenaState:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.state_file = cfg.checkpoint_path(cfg.arena_state)
        self.ratings: Dict[str, float] = {}
        self.matches: List[dict] = []
        self.best_model: Optional[str] = None
        self.match_counts: Dict[str, int] = {}
        self.load()

    # -- persistence ------------------------------------------------------
    def load(self) -> None:
        if not os.path.exists(self.state_file):
            return
        with open(self.state_file) as f:
            data = json.load(f)
        self.ratings = data.get("ratings", {})
        self.matches = data.get("matches", [])
        self.best_model = data.get("best_model")
        self._rebuild_match_counts()

    def _rebuild_match_counts(self) -> None:
        self.match_counts = {}
        for m in self.matches:
            key = self.pair_key(m["model_a"], m["model_b"])
            games = m["wins_a"] + m["wins_b"]
            self.match_counts[key] = self.match_counts.get(key, 0) + games

    def save(self) -> None:
        if not is_coordinator():
            return
        os.makedirs(os.path.dirname(self.state_file) or ".", exist_ok=True)
        data = {
            "ratings": self.ratings,
            "matches": self.matches,
            "best_model": self.best_model,
            "match_counts": self.match_counts,
            "last_updated": datetime.now().isoformat(),
        }
        tmp = self.state_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2)
        os.replace(tmp, self.state_file)

    # -- ratings ------------------------------------------------------------
    @staticmethod
    def pair_key(a: str, b: str) -> str:
        return "|".join(sorted([a, b]))

    def get_match_count(self, a: str, b: str) -> int:
        return self.match_counts.get(self.pair_key(a, b), 0)

    def get_rating(self, name: str) -> float:
        if name not in self.ratings:
            self.ratings[name] = INITIAL_ELO
        return self.ratings[name]

    def update_ratings(self, a: str, b: str, score_a: float) -> None:
        ra, rb = self.get_rating(a), self.get_rating(b)
        ea = expected_score(ra, rb)
        self.ratings[a] = ra + K_FACTOR * (score_a - ea)
        self.ratings[b] = rb + K_FACTOR * ((1.0 - score_a) - (1.0 - ea))

    def record_match(self, a: str, b: str, wins_a: int, wins_b: int) -> None:
        total = wins_a + wins_b
        if total == 0:
            return
        self.update_ratings(a, b, wins_a / total)
        self.matches.append({
            "model_a": a, "model_b": b,
            "wins_a": wins_a, "wins_b": wins_b,
            "score_a": wins_a / total,
            "timestamp": datetime.now().isoformat(),
        })
        self._update_best()
        key = self.pair_key(a, b)
        self.match_counts[key] = self.match_counts.get(key, 0) + total
        self.save()

    def _update_best(self) -> None:
        best_name, best_rating = None, 0.0
        for name, rating in self.ratings.items():
            if rating > best_rating:
                best_name, best_rating = name, rating
        if best_name and self.best_model != best_name:
            self.best_model = best_name
            ckpt.sync_best_model(self.cfg, best_name)

    def discover_models(self) -> bool:
        """Register any new iteration checkpoints at the initial rating."""
        found = False
        for name in ckpt.list_checkpoints(self.cfg):
            if name not in self.ratings:
                self.ratings[name] = INITIAL_ELO
                found = True
        if found:
            self.save()
        return found

    def leaderboard(self) -> List[Tuple[str, float]]:
        return sorted(self.ratings.items(), key=lambda kv: kv[1],
                      reverse=True)
