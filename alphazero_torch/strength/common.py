"""What the strength gates share: the weights they load, the int8-static
calibration and the line that names the device.

The gates run on a checkpoint directory of the port (``torch.save``,
``train/checkpoint.py``) or on an archive npz of the JAX package
(``models/convert.py``; Orbax checkpoints do not cross), by default the
trained 20x128 archive in the repo.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

from alphazero_torch.models.convert import ARCHIVE
from alphazero_torch.config import Config
from alphazero_torch.env import breakthrough as env

# the JAX gates' calibration: this many positions of the replay file
# beside the checkpoint, drawn by RandomState(42), in two batches
CAL_REPLAY_POSITIONS = 512
# without a replay file (an archive has none): two batches of this many
# random-play positions from seeds CAL_RANDOM_SEED and CAL_RANDOM_SEED + 1
CAL_RANDOM_BATCH, CAL_RANDOM_SEED = 512, 51


def load_net(path: str, device):
    """The float32 net of a port checkpoint directory or an archive npz,
    in eval mode on ``device``."""
    if path.endswith(".npz"):
        from alphazero_torch.models.convert import load_archive

        return load_archive(path, device)
    from alphazero_torch.arena.runner import load_model

    path = os.path.abspath(path)
    return load_model(Config(checkpoint_dir=os.path.dirname(path)), path,
                      device)


def random_positions(n: int, seed: int, max_plies: int = 40
                     ) -> env.EnvState:
    """``n`` positions on the CPU, each after a seeded number of random
    legal plies below ``max_plies`` (a game that ends stays at its last
    live position)."""
    rng = np.random.default_rng(seed)
    state = env.initial_state((n,), device="cpu")
    plies = rng.integers(0, max_plies, n)
    for p in range(max_plies):
        mask = env.legal_action_mask(state).numpy()
        acts = np.array([rng.choice(np.flatnonzero(m)) if m.any() else 0
                         for m in mask])
        stepped = env.step(state, torch.from_numpy(acts))
        state = env.select_state(torch.from_numpy(p < plies) & ~stepped.done,
                                 stepped, state)
    return state


def calibration_batches(path: str, device):
    """(planes batches, what they are) for ``models.quant.calibrate``.

    The JAX gates' rule where the weights are a checkpoint directory with
    ``training_data.npz`` beside it: 512 replay positions drawn by
    ``RandomState(42)``, two batches of 256. Otherwise (an archive) 1,024
    random-play positions from ``random_positions``, as ``chip_smoke.py``
    calibrates."""
    npz = os.path.join(os.path.dirname(os.path.abspath(path)),
                       "training_data.npz")
    if os.path.isdir(path) and os.path.exists(npz):
        with np.load(npz) as data:
            states = data["states"]
        idx = np.sort(np.random.RandomState(42).choice(
            len(states), CAL_REPLAY_POSITIONS, replace=False))
        chosen = states[idx].astype(np.float32)
        half = CAL_REPLAY_POSITIONS // 2
        return ([torch.from_numpy(chosen[i * half:(i + 1) * half]).to(device)
                 for i in range(2)],
                f"{CAL_REPLAY_POSITIONS} replay positions from {npz}")
    return ([env.encoded_state(random_positions(
                CAL_RANDOM_BATCH, CAL_RANDOM_SEED + i)).to(device)
             for i in range(2)],
            f"{2 * CAL_RANDOM_BATCH} random-play positions (seeds "
            f"{CAL_RANDOM_SEED}, {CAL_RANDOM_SEED + 1}; no replay file "
            f"beside {path})")


def int8_evaluator(net, weights: str, device, flavor: str = "static"):
    """(the int8 evaluator of ``net``, what its scales are). ``static``
    calibrates on ``calibration_batches(weights)``."""
    from alphazero_torch.models.quant import (
        calibrate,
        make_quant_evaluator,
        quantize_network,
    )

    if flavor == "dynamic":
        return make_quant_evaluator(net), "dynamic (per-layer amax)"
    if flavor != "static":
        raise ValueError(f"AZTPU_QUANT_FLAVOR must be static or dynamic, "
                         f"got {flavor!r}")
    batches, what = calibration_batches(weights, device)
    qp = quantize_network(net)
    return (make_quant_evaluator(net, act_scales=calibrate(qp, batches),
                                 qp=qp), f"static, calibrated on {what}")


def device_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
