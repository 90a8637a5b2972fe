"""Trainer: orchestrates self-play -> replay -> learn -> checkpoint.

Port of ``alphazero_tpu/train/trainer.py``: resume from the latest
iteration checkpoint, reload the newest ``buffer_size`` examples from
disk, then forever {self-play for ``selfplay_batches x parallel_games``
games -> learn 1 epoch -> append data -> checkpoint}. Every artifact is
re-loadable and the loop is idempotent per iteration, so a run can be
stopped anywhere and restarted.

With a ``parallel.Mesh`` (one process per card) the trainer follows the
JAX package's multi-host branches: every rank plays its own games from
its own streams and keeps its own replay shard; the learner batch is
sharded over the ranks (``cfg.batch_size`` must divide by their number),
with parameters replicated, global-batch BatchNorm and averaged
gradients; every rank runs rank 0's step count; rank 0 alone writes
checkpoints and metrics, and a barrier follows each save. The JAX
package's single-process, several-device layout, with its warnings and
unsharded fallbacks, has no counterpart here.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from alphazero_torch import resolve_device
from alphazero_torch.config import Config
from alphazero_torch.models.network import AlphaZeroNet, build_network
from alphazero_torch.parallel.mesh import (
    Mesh,
    barrier,
    broadcast_int,
    replicate,
)
from alphazero_torch.search.mcts import make_net_evaluator
from alphazero_torch.train import checkpoint as ckpt
from alphazero_torch.train.learner import (
    TrainState,
    create_train_state,
    train_epoch,
    train_step,
    update_rows,
)
from alphazero_torch.train.replay import (
    ReplayBuffer,
    append_training_data,
    epoch_batches,
    host_data_path,
    load_training_data,
)
from alphazero_torch.train.selfplay import (
    selfplay_games,
    selfplay_games_continuous,
)
from alphazero_torch.utils import is_coordinator, profile_trace, setup_logging

log = setup_logging()


class Trainer:
    def __init__(self, cfg: Config, seed: int = 0,
                 net: Optional[AlphaZeroNet] = None,
                 state: Optional[TrainState] = None, device="cuda",
                 mesh: Optional[Mesh] = None):
        if cfg.selfplay_quant not in ("off", "dynamic", "static"):
            raise ValueError(f"selfplay_quant={cfg.selfplay_quant!r}: "
                             "expected 'off', 'dynamic' or 'static'")
        if cfg.body != "se_resnet" and cfg.selfplay_quant != "off":
            raise ValueError(f"selfplay_quant={cfg.selfplay_quant!r}: the "
                             f"int8 evaluator is the SE-ResNet's; the "
                             f"{cfg.body} body searches in "
                             f"{cfg.inference_dtype}")
        if cfg.body == "muzero" and cfg.tree_reuse:
            raise ValueError("tree_reuse: MuZero's search does not carry its "
                             "latent store across moves (advance_root)")
        self.cfg = cfg
        self.mesh = mesh
        self.rank, self.world = (mesh.rank, mesh.world) if mesh else (0, 1)
        if mesh is None:
            self.device = resolve_device(device)
        elif torch.device(device).type != mesh.device.type:
            raise ValueError(f"device {device} but the mesh is on "
                             f"{mesh.device}")
        else:
            self.device = mesh.device
        if cfg.batch_size % self.world:
            # the unsharded fallback would train each rank on its own data
            # with no all-reduce: parameters would silently diverge
            raise ValueError(
                f"batch_size {cfg.batch_size} is not divisible by "
                f"{self.world} ranks: pick a divisible batch size")
        if state is None:
            if net is None:
                net = build_network(
                    cfg, device=self.device,
                    generator=torch.Generator().manual_seed(seed))
            state = create_train_state(cfg, net, device=self.device)
        self.state = state
        if mesh is not None:
            replicate(mesh, self.state)
        # MuZero's learner unrolls each game's trajectory
        self.muzero = cfg.body == "muzero"
        self.buffer = ReplayBuffer(cfg.buffer_size,
                                   num_actions=cfg.num_actions,
                                   trajectory=self.muzero)
        # explicit streams, one set per rank (every rank plays different
        # games): self-play noise and sampling on the device, epoch
        # shuffling on the host; rank 0's are the single-process ones.
        # The CPU generator keeps 32 bits of a seed.
        gen_seed = seed + 1 if self.rank == 0 else int(
            np.random.SeedSequence((seed + 1, self.rank)).generate_state(1)[0])
        self.gen = torch.Generator(device=self.device).manual_seed(gen_seed)
        self.np_rng = np.random.default_rng(seed + 2 + self.rank)
        self.iteration = int(state.iteration)
        # structured per-iteration metrics (stdout logging + JSONL file)
        self.metrics_path = cfg.checkpoint_path("metrics.jsonl")
        # profile_dir: capture ONE torch.profiler trace per phase
        # (selfplay / learn) into it; later iterations run untraced
        self.profile_dir: Optional[str] = None
        self._profiled: set = set()
        self._dev_replay: Optional[tuple] = None

    @property
    def net(self) -> AlphaZeroNet:
        return self.state.net

    def _maybe_profile(self, phase: str):
        if self.profile_dir and phase not in self._profiled:
            self._profiled.add(phase)
            logdir = os.path.join(self.profile_dir, phase)
            if self.world > 1:
                logdir += f"_rank{self.rank}"
            log.info("profiling %s phase -> %s", phase, logdir)
            return profile_trace(logdir)
        return contextlib.nullcontext()

    # -- self-play ---------------------------------------------------------
    # calibration draw of the static int8 evaluator: a fixed number of
    # rows WITH replacement, in batches of a fixed size, as the JAX package
    # draws them (the same np_rng stream, in the same order)
    _CALIBRATION_ROWS = 4096
    _CALIBRATION_BATCH = 1024

    def _selfplay_evaluator(self):
        """The search evaluator for self-play, made anew from the current
        weights at every call: with ``cfg.selfplay_quant`` "off" a copy of
        the float32 training net in ``cfg.inference_dtype`` (bf16 by
        default); "dynamic" or "static" the int8 net (``models/quant.py``).
        Static scales are calibrated on replay positions; with an empty
        buffer the scales stay dynamic, as in the JAX package."""
        if self.cfg.selfplay_quant == "off":
            return make_net_evaluator(self.net,
                                      getattr(torch, self.cfg.inference_dtype))
        from alphazero_torch.models import quant

        qp = quant.quantize_network(self.net)
        act_scales = None
        if self.cfg.selfplay_quant == "static" and len(self.buffer) > 0:
            n, bs = self._CALIBRATION_ROWS, self._CALIBRATION_BATCH
            idx = self.np_rng.integers(0, len(self.buffer), size=n)
            planes = torch.from_numpy(
                self.buffer.states[idx].astype(np.float32)).to(self.device)
            act_scales = quant.calibrate(
                qp, [planes[i:i + bs] for i in range(0, n, bs)])
        return quant.make_quant_evaluator(self.net, act_scales=act_scales,
                                          qp=qp)

    def execute_selfplay(self, num_games: Optional[int] = None):
        eval_fn = self._selfplay_evaluator()
        play = (selfplay_games_continuous if self.cfg.continuous_selfplay
                else selfplay_games)
        with self._maybe_profile("selfplay"):
            examples, stats = play(eval_fn, self.cfg, self.gen,
                                   num_games=num_games, device=self.device,
                                   trajectory=self.muzero)
        return examples, stats

    # -- learning ----------------------------------------------------------
    def _device_replay(self):
        """Device-resident mirror of the replay window (full capacity
        shape; rows >= len(buffer) are never indexed). Synced from the
        host ring via ``ReplayBuffer.consume_writes()``: the whole window
        uploads once, after which only newly-written row spans are copied
        in place; the host buffer stays the single source of truth."""
        buf = self.buffer
        spans = buf.consume_writes()
        if self._dev_replay is None or spans is None:
            self._dev_replay = tuple(
                torch.from_numpy(a).to(self.device)
                for a in (buf.states, buf.policies, buf.wls))
            return self._dev_replay
        for start, n in spans:
            sl = slice(start, start + n)
            update_rows(*self._dev_replay, buf.states[sl], buf.policies[sl],
                        buf.wls[sl], start)
        return self._dev_replay

    def learn(self, epochs: Optional[int] = None,
              batch_size: Optional[int] = None) -> Dict[str, float]:
        """One learn() call: iterate over the (2x-augmented) buffer for
        ``epochs``, then advance the cosine schedule once.

        Under a mesh each rank draws its ``batch_size // world`` share of
        every global batch from its own shard, for rank 0's step count."""
        epochs = epochs if epochs is not None else self.cfg.training_epochs
        batch_size = batch_size or self.cfg.batch_size
        if len(self.buffer) == 0:
            return {}
        if batch_size % self.world:
            raise RuntimeError(
                f"learn(batch_size={batch_size}) cannot be sharded over "
                f"{self.world} ranks: an unsharded step would train each "
                "rank on its own data with no all-reduce (silent parameter "
                "divergence)")
        local_bs = batch_size // self.world
        if self.muzero and self.world > 1:
            raise ValueError("MuZero's learner runs on one process")
        steps = None
        if self.world > 1:
            # collectives are lockstep: every rank runs rank 0's count
            # (epoch_batches wraps or truncates its own permutation)
            steps = broadcast_int(
                self.mesh, max(1, -(-2 * len(self.buffer) // local_bs)))

        # Metrics stay on the device until the end: reading one per step
        # would block the host on every step.
        step_metrics: List[Dict[str, torch.Tensor]] = []
        with self._maybe_profile("learn"):
            for _ in range(epochs):
                # every buffered example in both orientations exactly
                # once, shuffled (see epoch_batches)
                base_idx, mirrors = epoch_batches(
                    self.np_rng, len(self.buffer), local_bs, steps=steps)
                if self.cfg.device_replay and not self.muzero:
                    step_metrics.append(train_epoch(
                        self.state, self._device_replay(),
                        torch.from_numpy(base_idx).to(self.device),
                        torch.from_numpy(mirrors).to(self.device),
                        self.cfg, mesh=self.mesh))
                    continue
                for bi, mirror in zip(base_idx, mirrors):
                    # MuZero's batches are unrolled on the host
                    rows = (self.buffer.unroll(bi, self.cfg.mz_unroll,
                                               self.np_rng)
                            if self.muzero else self.buffer.get(bi))
                    batch = tuple(torch.from_numpy(x).to(self.device)
                                  for x in rows)
                    m = train_step(
                        self.state, batch,
                        torch.from_numpy(mirror).to(self.device), self.cfg,
                        mesh=self.mesh)
                    step_metrics.append(
                        {k: torch.as_tensor(v, dtype=torch.float32,
                                            device=self.device).reshape(1)
                         for k, v in m.items()})
            host = {k: torch.cat([m[k] for m in step_metrics]).cpu().numpy()
                    for k in step_metrics[0]}          # the one host sync
        self.state.net.eval()
        self.state.learn_calls += 1
        return {k: float(np.mean(v)) for k, v in host.items()}

    # -- persistence ---------------------------------------------------------
    # Every rank holds the same replicated state, so checkpoints and
    # metrics are written by rank 0 only (utils.is_coordinator); replay
    # shards are per rank.

    def save(self, iteration: Optional[int] = None) -> str:
        it = self.iteration if iteration is None else iteration
        self.state.iteration = int(it)
        path = ckpt.save_iteration_checkpoint(self.cfg, self.state, it)
        if self.mesh is not None:
            # no rank may go on (or resume()) before rank 0's checkpoint
            # is whole on disk
            barrier(self.mesh)
        return path

    def _rebuild_net(self, cfg: Config) -> None:
        """Rebuild the net and the train state for a config whose
        architecture differs from the live one."""
        self.cfg = cfg
        net = build_network(cfg, device=self.device,
                            generator=torch.Generator().manual_seed(0))
        self.state = create_train_state(cfg, net, device=self.device)
        if self.mesh is not None:
            replicate(self.mesh, self.state)
        if (cfg.body == "muzero") != self.muzero:
            # the replay's kind follows the body: MuZero's keeps games
            self.muzero = cfg.body == "muzero"
            self.buffer = ReplayBuffer(cfg.buffer_size,
                                       num_actions=cfg.num_actions,
                                       trajectory=self.muzero)
            self._dev_replay = None

    def resume(self) -> int:
        """Load the latest checkpoint + replay tail; returns iteration.

        The checkpoint's recorded architecture wins over the live config:
        consumers rebuild the net from the checkpoint alone."""
        it = ckpt.get_latest_iteration(self.cfg)
        if it > 0:
            path = self.cfg.checkpoint_path(f"iteration_{it}")
            try:
                ck_cfg = self.cfg.with_arch(ckpt.checkpoint_arch(path))
            except (OSError, KeyError, ValueError):
                ck_cfg = self.cfg
            if ck_cfg != self.cfg:
                log.warning("checkpoint %s arch %s overrides the live "
                            "config", path, ck_cfg.arch())
                self._rebuild_net(ck_cfg)
            self.state = ckpt.load_checkpoint(path, self.state)
            self.state.net.eval()
            self.iteration = it
        loaded = load_training_data(self._data_path(), self.buffer)
        if it or loaded:
            log.info("resumed at iteration %d with %d examples", it, loaded)
        return it

    def _data_path(self) -> str:
        return host_data_path(self.cfg.checkpoint_path(self.cfg.data_file),
                              self.rank)

    def append_data(self, examples) -> int:
        return append_training_data(self._data_path(), examples)

    # -- the loop ------------------------------------------------------------
    def run_iteration(self) -> Dict[str, float]:
        """One training iteration: self-play for the iteration's game
        budget, one learn() call, persist data + checkpoint."""
        t0 = time.time()
        new_examples: List = []
        selfplay_stats: List[Dict] = []
        if self.cfg.continuous_selfplay:
            # one continuous auto-resetting run for the whole iteration's
            # game budget: stopping discards in-flight episodes, so
            # fewer, longer runs waste less
            target = self.cfg.selfplay_batches * self.cfg.parallel_games
            examples, stats = self.execute_selfplay(num_games=target)
            new_examples.extend(examples)
            selfplay_stats.append(stats)
            log.info("selfplay: %d examples (%d games, %d sims)",
                     stats["examples"], stats["games"],
                     stats["simulations"])
        else:
            for b in range(self.cfg.selfplay_batches):
                examples, stats = self.execute_selfplay()
                new_examples.extend(examples)
                selfplay_stats.append(stats)
                log.info(
                    "selfplay batch %d/%d: %d examples (%d games, %d sims)",
                    b + 1, self.cfg.selfplay_batches, stats["examples"],
                    stats["games"], stats["simulations"])
        selfplay_s = time.time() - t0

        if new_examples:
            self.buffer.add_arrays(
                *(np.stack([e[i] for e in new_examples])
                  for i in range(len(new_examples[0]))))
        t1 = time.time()
        metrics = self.learn()
        learn_s = time.time() - t1

        self.append_data(new_examples)
        self.iteration += 1
        self.save()

        total_sims = sum(s["simulations"] for s in selfplay_stats)
        total_games = sum(s["games"] for s in selfplay_stats)
        metrics.update({
            "iteration": self.iteration,
            "examples_new": len(new_examples),
            "buffer": len(self.buffer),
            "selfplay_seconds": round(selfplay_s, 2),
            "learn_seconds": round(learn_s, 2),
            "sims_per_sec": round(total_sims / max(selfplay_s, 1e-9), 1),
            "games_per_hour": round(
                3600.0 * total_games / max(selfplay_s + learn_s, 1e-9), 1),
        })
        log.info("iteration %d done: %s", self.iteration, metrics)
        self._write_metrics(metrics)
        return metrics

    def _write_metrics(self, metrics: Dict) -> None:
        if not is_coordinator():
            return
        try:
            os.makedirs(os.path.dirname(self.metrics_path) or ".",
                        exist_ok=True)
            with open(self.metrics_path, "a") as f:
                f.write(json.dumps(
                    {"ts": time.time(), **metrics}, default=float) + "\n")
        except OSError as e:  # metrics are best-effort
            log.warning("could not write metrics: %s", e)

    def train_forever(self, max_iterations: Optional[int] = None):
        self.resume()
        while max_iterations is None or self.iteration < max_iterations:
            self.run_iteration()
