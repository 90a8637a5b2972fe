"""Replay buffer + on-disk training data persistence.

An independent copy of ``alphazero_tpu/train/replay.py`` (pure numpy
there too), so that this package imports nothing of the JAX one. Each
rank of a multi-process run keeps its own replay shard
(``host_data_path``).

In memory: a fixed-capacity numpy ring buffer (planes stored as uint8,
they are 0/1).

On disk: the append-only ``training_data.npz`` contract both packages
share: keys {states uint8, policies float32, wls float32}, the file grows
unbounded, and a reload takes the most recent ``buffer_size`` examples.
Either package reads the other's file.

MuZero's learner unrolls its dynamics along each game's later actions, so
its buffer (``trajectory=True``) keeps whole games in move order and, a
ply each, the action played and the moves left in its game (the npz's
extra keys ``actions`` and ``left``); ``unroll`` builds a sample's next K
actions and targets from them, as the paper's ``make_target`` does.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Sequence, Tuple

import numpy as np

Example = Tuple[np.ndarray, np.ndarray, np.ndarray]


class ReplayBuffer:
    def __init__(self, capacity: int, num_actions: int = 192,
                 planes_shape: Tuple[int, int, int] = (3, 8, 8),
                 trajectory: bool = False):
        self.capacity = capacity
        self.states = np.zeros((capacity,) + planes_shape, np.uint8)
        self.policies = np.zeros((capacity, num_actions), np.float32)
        self.wls = np.zeros((capacity, 2), np.float32)
        # a ply's action and the moves of its game after it (trajectories)
        self.actions = np.zeros(capacity, np.int16) if trajectory else None
        self.left = np.zeros(capacity, np.int16) if trajectory else None
        self.size = 0
        self.cursor = 0
        # bumped on every mutation so consumers holding a device-resident
        # mirror (Trainer._device_replay) know when to re-upload
        self.version = 0
        # row spans written since the last consume_writes() — the
        # device-mirror sync protocol. None = consumer must resync fully.
        self._pending: list | None = None

    def __len__(self) -> int:
        return self.size

    def _note_write(self, start: int, n: int) -> None:
        if self._pending is None:
            return
        if n >= self.capacity or len(self._pending) > 64:
            self._pending = None   # cheaper to resync the whole window
            return
        end = start + n
        self._pending.append((start, min(end, self.capacity) - start))
        if end > self.capacity:   # ring wrap: split at the boundary
            self._pending.append((0, end - self.capacity))

    def consume_writes(self) -> list | None:
        """Row spans (start, n) mutated since the last call, for consumers
        keeping a device-resident mirror. Returns None when the consumer
        must re-upload the whole window (first call after construction, or
        accumulated writes cover it anyway); thereafter returns [] when
        nothing changed."""
        spans = self._pending
        self._pending = []
        return spans

    def add(self, examples: Sequence[Example]) -> None:
        for s, p, wl, *ply in examples:
            i = self.cursor
            self.states[i] = s.astype(np.uint8)
            self.policies[i] = p
            self.wls[i] = wl
            if self.actions is not None:
                self.actions[i], self.left[i] = ply
            self._note_write(i, 1)
            self.cursor = (i + 1) % self.capacity
            self.size = min(self.size + 1, self.capacity)
        if examples:
            self.version += 1

    def add_arrays(self, states: np.ndarray, policies: np.ndarray,
                   wls: np.ndarray, actions: np.ndarray | None = None,
                   left: np.ndarray | None = None) -> None:
        n = len(states)
        if self.actions is not None and (actions is None or left is None):
            raise ValueError("a trajectory buffer takes each ply's action "
                             "and moves left")
        if n >= self.capacity:
            states, policies, wls, actions, left = (
                None if x is None else x[-self.capacity:]
                for x in (states, policies, wls, actions, left))
            n = self.capacity
        idx = (self.cursor + np.arange(n)) % self.capacity
        self.states[idx] = states.astype(np.uint8)
        self.policies[idx] = policies
        self.wls[idx] = wls
        if self.actions is not None:
            self.actions[idx] = actions
            self.left[idx] = left
        self._note_write(self.cursor, n)
        self.cursor = int((self.cursor + n) % self.capacity)
        self.size = min(self.size + n, self.capacity)
        self.version += 1

    def sample(self, rng: np.random.Generator, batch_size: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        idx = rng.integers(0, self.size, size=batch_size)
        return self.get(idx)

    def get(self, idx: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return (self.states[idx].astype(np.float32),
                self.policies[idx], self.wls[idx])

    def unroll(self, idx: np.ndarray, K: int, rng: np.random.Generator):
        """MuZero's sample at rows ``idx`` unrolled ``K`` steps, as
        ``make_target`` builds it: (planes (B, 3, 8, 8) f32, actions (B, K)
        int64, target_pi (B, K+1, A), target_wl (B, K+1, 2), target_r (B,
        K), pi_mask (B, K+1)). Step k reads the ply ``idx + k`` of the same
        game while the game lasts; past its end the step is absorbing
        (win/loss (1/2, 1/2), no policy target: mask 0, reward 0) and its
        action is drawn uniformly from ``rng``. The reward of step k+1 is
        the transition from ply ``idx + k``: the final move's result for
        its mover (+1, a win), else 0. A game's plies must lie in order in
        the ring, which ``add`` and ``add_arrays`` keep when given whole
        games."""
        if self.actions is None:
            raise ValueError("unroll needs a trajectory buffer")
        idx = np.asarray(idx)
        left = self.left[idx].astype(np.int64)
        ks = np.arange(K + 1)
        rows = (idx[:, None] + ks[None]) % self.capacity       # (B, K+1)
        live = ks[None] <= left[:, None]
        target_pi = np.where(live[..., None], self.policies[rows], 0.0)
        target_wl = np.where(live[..., None], self.wls[rows], 0.5)
        drawn = rng.integers(0, self.policies.shape[1], size=(len(idx), K))
        actions = np.where(live[:, :K], self.actions[rows[:, :K]], drawn)
        final = self.wls[rows[:, :K]]
        target_r = np.where(ks[None, :K] == left[:, None],
                            final[..., 0] - final[..., 1], 0.0)
        return (self.states[idx].astype(np.float32),
                actions.astype(np.int64), target_pi.astype(np.float32),
                target_wl.astype(np.float32), target_r.astype(np.float32),
                live.astype(np.float32))


def host_data_path(path: str, process_index: int) -> str:
    """Per-host replay shard path (SURVEY.md §5: replay examples stay
    host-local). Process 0 keeps the reference's exact filename
    (``training_data.npz``) so single-host runs match the reference
    contract; other hosts write ``..._p{i}.npz`` beside it."""
    if process_index == 0:
        return path
    root, ext = os.path.splitext(path)
    if root.endswith(".npz"):   # handles .npz inside compound suffixes
        root, ext2 = os.path.splitext(root)
        ext = ext2 + ext
    return f"{root}_p{process_index}{ext}"


def epoch_batches(rng: np.random.Generator, n_examples: int,
                  batch_size: int,
                  steps: int | None = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffled without-replacement epoch over the 2x-augmented dataset.

    Every example is visited in BOTH orientations exactly once per epoch:
    the 2*n_examples-sized (example, mirror) index space is permuted and
    chunked into fixed-size batches. The tail batch is padded by wrapping
    to the permutation head (those few pairs are seen twice per epoch),
    as in the JAX package, so that the same numpy seed gives both
    packages the same batches.

    ``steps`` overrides the step count (the permutation is truncated or
    wrapped to fit): under a process group every rank runs rank 0's
    count over its own shard, since collectives are lockstep.

    Returns (base_idx, mirror), each (steps, batch_size): buffer row
    indices and the per-sample mirror-augmentation flag.
    """
    n_aug = 2 * n_examples
    if steps is None:
        steps = max(1, -(-n_aug // batch_size))
    perm = rng.permutation(n_aug)
    idx = np.resize(perm, steps * batch_size).reshape(steps, batch_size)
    return (idx % n_examples).astype(np.int64), idx >= n_examples


# -----------------------------------------------------------------------------
# On-disk persistence (reference training_data.npz contract)
# -----------------------------------------------------------------------------

def append_training_data(path: str, examples: Sequence[Example]) -> int:
    """Append examples to the npz data file (created if absent); returns the
    total example count on disk. A full rewrite, made atomic by a
    temporary file and a rename."""
    if not examples:
        return 0
    new_states = np.stack([e[0] for e in examples]).astype(np.uint8)
    new_policies = np.stack([e[1] for e in examples]).astype(np.float32)
    new_wls = np.stack([e[2] for e in examples]).astype(np.float32)
    # trajectories' plies (MuZero's): the action and the moves left
    extra = ({"actions": np.array([e[3] for e in examples], np.int16),
              "left": np.array([e[4] for e in examples], np.int16)}
             if len(examples[0]) == 5 else {})

    if os.path.exists(path):
        old = np.load(path)
        states = np.concatenate(
            [old["states"].astype(np.uint8), new_states])
        policies = np.concatenate([old["policies"], new_policies])
        wls = np.concatenate([old["wls"], new_wls])
        extra = {k: np.concatenate([old[k], v]) for k, v in extra.items()
                 if k in old.files}
    else:
        states, policies, wls = new_states, new_policies, new_wls

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, states=states, policies=policies, wls=wls,
                     **extra)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return len(states)


def load_training_data(path: str, buffer: ReplayBuffer,
                       max_examples: int | None = None) -> int:
    """Load the newest ``max_examples`` (default: buffer capacity) examples
    from disk into ``buffer``. Returns the number loaded."""
    if not os.path.exists(path):
        return 0
    limit = max_examples or buffer.capacity
    data = np.load(path, mmap_mode="r")
    total = len(data["states"])
    start = max(0, total - limit)
    if buffer.actions is not None:
        if "actions" not in data.files:
            return 0                      # no trajectories to unroll
        # a game cut at the window's start keeps its later plies, and an
        # unroll reads only forward
        extra = (np.array(data["actions"][start:]),
                 np.array(data["left"][start:]))
    else:
        extra = ()
    buffer.add_arrays(
        np.array(data["states"][start:]),
        np.array(data["policies"][start:]),
        np.array(data["wls"][start:]),
        *extra,
    )
    return total - start
