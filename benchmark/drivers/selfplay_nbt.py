"""Continuous self-play with the nested-bottleneck body's bf16 evaluator.

``selfplay.Driver`` (``selfplay.py``: its lanes, window, records, tree
copies, ``treecheck`` and the rules' check) with another net: the
configuration's nested-bottleneck body (``body`` "nbt", KataGo's
b28c512nbt at its published widths), on weights drawn on the card from the
seed and calibrated (``lib/nbt.py``), searched through the program's
``Config``, ``build_network``'s net and ``make_net_evaluator``, which takes
the body's bf16 route (``models/nbt_inference.py``). The judged trees'
positions are evaluated by the body's reference (``lib/refnbt``).

A program without the nested-bottleneck body refuses the configuration
when its ``Config`` is made, the first thing set-up does.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from benchmark.drivers import selfplay
from benchmark.lib import nbt
from benchmark.lib.checks import Numbers

# the configuration's sizes that the program's Config takes
NBT_FIELDS = ("nbt_blocks", "nbt_trunk", "nbt_mid", "nbt_gpool",
              "nbt_head", "nbt_value_hidden")


class Driver(selfplay.Driver):
    def setup(self) -> None:
        from alphazero_torch.config import Config
        from alphazero_torch.env import breakthrough as env
        from alphazero_torch.models.network import build_network
        from alphazero_torch.search import mcts
        from alphazero_torch.train import selfplay as program_selfplay

        from benchmark.lib import program

        c, t = self.cell.config, self.cell.traffic
        self.cfg = Config(
            body="nbt", **{k: c[k] for k in NBT_FIELDS},
            num_simulations=self.sims, parallel_games=self.lanes,
            c_puct=t["c_puct"], dirichlet_alpha=t["dirichlet_alpha"],
            dirichlet_epsilon=t["dirichlet_epsilon"],
            temperature_threshold=t["temperature_moves"], tree_reuse=False)
        if self.dev.type == "cuda":
            program.build_kernels()
        self.weights = nbt.seeded(c, self.cell.seed, self.dev)
        with torch.device(self.dev):
            net = build_network(self.cfg, self.dev)
        own = net.state_dict()
        net.load_state_dict({**self.weights, **{
            k: v for k, v in own.items() if k.endswith("batches_tracked")}})
        self.eval_fn = mcts.make_net_evaluator(
            net, getattr(torch, c["search_precision"]))
        del net
        self.spec = program_selfplay.search_spec(self.cfg)
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(self.cell.seed)
        self.states = env.initial_state((self.lanes,), device=self.dev)
        self.tree = mcts.init_tree(self.states, self.spec)
        self._move = program_selfplay.selfplay_move_autoreset
        self.watch = torch.from_numpy(np.sort(self.rng.choice(
            self.lanes, min(int(t["check_lanes"]), self.lanes),
            replace=False))).to(self.dev)
        self.records: List[dict] = []
        for _ in range(int(t["warmup_moves"])):
            self.move(record=False)
        self._sync()

    def check(self, control: bool = False) -> Numbers:
        recs = self._host_records()
        judged = self.judged(recs)
        numbers = nbt.evaluator_numbers(self.weights, judged, self.dev,
                                        control=control)
        numbers["tree_mismatch"] = sum(j.tree_mismatch for j in judged)
        numbers["env_mismatch"] = (sum(j.env_mismatch for j in judged)
                                   + self.outcome_mismatches(recs))
        numbers["select_gap"] = max((j.select_gap for j in judged),
                                    default=0.0)
        numbers["trees_judged"] = len(judged)
        return numbers
