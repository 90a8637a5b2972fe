"""Checkpointing: the JAX package's iteration_N / model_best /
resume-from-latest contract, with ``torch.save`` in place of Orbax.

Each checkpoint is a directory ``iteration_N/`` holding ``state.pt`` (the
net's and the optimizer's ``state_dict``s, ``learn_calls``, ``iteration``)
and ``alphazero_meta.json`` (the iteration and the architecture, with
the JAX package's field names), so any consumer can rebuild the right net
from the checkpoint alone. A checkpoint is written under a temporary name
and renamed, so a directory named ``iteration_N`` is always complete.

The cosine schedule's T_max is intentionally NOT stored: the schedule is
a closed form over (learn_calls, live Config).

Under a process group every rank holds the same replicated state: rank 0
alone writes (``utils.is_coordinator``), and every rank reads. The trainer
puts a barrier after each save.

The payloads of the two packages differ (Orbax there, ``torch.save``
here); weights cross from the JAX package through the archive npz
(``models/convert.load_archive``).
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
from typing import Dict, Optional

import torch

from alphazero_torch.config import Config
from alphazero_torch.train.learner import TrainState
from alphazero_torch.utils import is_coordinator

_ITER_RE = re.compile(r"iteration_(\d+)$")
_PAYLOAD = "state.pt"
_META = "alphazero_meta.json"


def _ckpt_dir(cfg: Config, name: str) -> str:
    return os.path.abspath(os.path.join(cfg.checkpoint_dir, name))


def save_iteration_checkpoint(cfg: Config, state: TrainState, iteration: int,
                              name: Optional[str] = None) -> str:
    """Save ``state`` as checkpoints/iteration_N (a directory), on the
    coordinator only; every rank gets the path."""
    name = name or f"iteration_{iteration}"
    path = _ckpt_dir(cfg, name)
    if not is_coordinator():
        return path
    tmp = path + ".tmp"
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save({"net": state.net.state_dict(),
                "opt": state.opt.state_dict(),
                "learn_calls": int(state.learn_calls),
                "iteration": int(iteration)},
               os.path.join(tmp, _PAYLOAD))
    meta = {
        "iteration": int(iteration),
        # everything a consumer needs to rebuild the net (Config.arch: the
        # SE-ResNet's sizes, or the encoder body's with its "body");
        # scan_blocks is kept for field parity with the JAX package (this
        # port's net has one parameter layout)
        "arch": {**cfg.arch(), "scan_blocks": cfg.scan_blocks},
    }
    with open(os.path.join(tmp, _META), "w") as f:
        json.dump(meta, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def checkpoint_arch(path: str) -> Dict[str, int]:
    with open(os.path.join(path, _META)) as f:
        return json.load(f)["arch"]


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore ``state`` in place from ``path`` (its net must have the
    checkpoint's architecture) and return it."""
    payload = torch.load(os.path.join(os.path.abspath(path), _PAYLOAD),
                         map_location=state.device, weights_only=True)
    state.net.load_state_dict(payload["net"])
    state.opt.load_state_dict(payload["opt"])
    state.learn_calls = int(payload["learn_calls"])
    state.iteration = int(payload["iteration"])
    return state


def load_net_weights(path: str, net: torch.nn.Module) -> torch.nn.Module:
    """Load only the net's weights of checkpoint ``path`` into ``net``
    (which must have the checkpoint's architecture) and return it."""
    device = next(net.parameters()).device
    payload = torch.load(os.path.join(os.path.abspath(path), _PAYLOAD),
                         map_location=device, weights_only=True)
    net.load_state_dict(payload["net"])
    return net


def get_latest_iteration(cfg: Config) -> int:
    """Highest iteration number among checkpoints, 0 if none."""
    best = 0
    for p in glob.glob(os.path.join(cfg.checkpoint_dir, "iteration_*")):
        m = _ITER_RE.search(p)
        if m and os.path.isdir(p):
            best = max(best, int(m.group(1)))
    return best


def list_checkpoints(cfg: Config) -> Dict[str, str]:
    """name -> path for all iteration checkpoints."""
    out = {}
    for p in sorted(glob.glob(os.path.join(cfg.checkpoint_dir,
                                           "iteration_*"))):
        if _ITER_RE.search(p) and os.path.isdir(p):
            out[os.path.basename(p)] = os.path.abspath(p)
    return out


def sync_best_model(cfg: Config, name: str) -> None:
    """Copy checkpoint ``name`` to checkpoints/model_best (on the
    coordinator only)."""
    if not is_coordinator():
        return
    src = _ckpt_dir(cfg, name)
    dst = _ckpt_dir(cfg, cfg.best_model)
    if os.path.exists(src):
        if os.path.exists(dst):
            shutil.rmtree(dst)
        shutil.copytree(src, dst)
