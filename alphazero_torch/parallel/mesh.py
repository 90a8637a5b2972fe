"""Data parallelism over ``torch.distributed``: the counterpart of
``alphazero_tpu/parallel/mesh.py``.

The JAX package shards the game batch and the learner batch over the
mesh's "data" axis and replicates the parameters; XLA inserts the
collectives (a psum of the gradients, and of the BatchNorm statistics, so
those are taken over the global batch). Here a process group is the
"data" axis, with one process per card: one rank is what a JAX host with
one local device is, so the port follows the JAX package's multi-host
branches. The "model" axis stays 1, as the JAX default has it.

- ``make_mesh``: this rank's place in the group, its card and backend;
- ``shard_batch``: this rank's contiguous rows of a global batch;
- ``replicate``: rank 0's weights, buffers and optimizer state on every
  rank, and the group attached to every ``BatchNorm2d`` (global-batch
  statistics in train mode);
- ``sharded_train_step``: the learner step on this rank's shard, the
  gradients averaged over the group before the global-norm clip;
- ``sharded_selfplay_move``: ``selfplay_move`` on this rank's games.

NCCL takes CUDA tensors only; gloo takes CPU tensors, and CUDA tensors for
all-reduce, broadcast and barrier. ``collective_device`` says where a
small control tensor goes. The JAX package's single-process, several-device
layouts (and their unsharded fallbacks) have no counterpart: a process
drives one card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from alphazero_torch import resolve_device

# Layering: parallel/ sits below train/, which imports it; the learner and
# self-play imports are deferred into the functions that need them, as in
# the JAX package.


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel group."""
    rank: int
    world: int
    device: torch.device
    backend: str
    group: Any = None


def make_mesh(group=None, model: int = 1, device=None) -> Mesh:
    """The data-parallel mesh over ``group`` (the default group when None,
    which ``init_distributed`` or ``torch.distributed.init_process_group``
    must have made). ``device`` is this rank's card (the current CUDA
    device when None) or the CPU; NCCL needs a card."""
    if model != 1:
        raise ValueError(
            f"model={model}: the port has no tensor parallelism; the mesh's "
            "'model' axis must be 1")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call init_distributed() first")
    group = group if group is not None else dist.group.WORLD
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = str(dist.get_backend(group))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    return Mesh(rank=dist.get_rank(group), world=dist.get_world_size(group),
                device=dev, backend=backend, group=group)


def collective_device(mesh: Mesh) -> torch.device:
    """Where a small control tensor (a count, a digest) goes for a
    collective: the card under NCCL, the CPU under gloo."""
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def barrier(mesh: Mesh) -> None:
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


def broadcast_int(mesh: Mesh, value: int, src: int = 0) -> int:
    """Rank ``src``'s ``value`` on every rank."""
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=collective_device(mesh))
    dist.broadcast(t, src=src, group=mesh.group)
    return int(t.item())


def all_reduce_mean_(mesh: Mesh, tensors) -> None:
    """Replace each tensor (one dtype, on the mesh's device) by its mean
    over the group, with one all-reduce of their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.world
    for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(v.view_as(t))


def _broadcast_(mesh: Mesh, tensors, src: int = 0) -> None:
    """Rank ``src``'s values of ``tensors`` on every rank, in place: one
    broadcast per dtype. A tensor off the collective's device (Adam's
    ``step`` lives on the CPU) travels through a copy."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, group in by_dtype.items():
        dev = (mesh.device if dtype.is_floating_point
               else collective_device(mesh))
        flat = torch.cat([t.detach().reshape(-1).to(dev) for t in group])
        dist.broadcast(flat, src=src, group=mesh.group)
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            with torch.no_grad():
                t.copy_(v.view_as(t))


def replicate(mesh: Mesh, state):
    """Make ``state`` (a ``TrainState`` on the mesh's device) rank 0's on
    every rank: parameters, buffers, Adam's moments and steps, and the two
    counters; then attach the group to every ``BatchNorm2d``, so that
    train mode takes global-batch statistics. Returns ``state``."""
    from alphazero_torch.models.network import BatchNorm2d

    if state.device != mesh.device:
        raise ValueError(f"state on {state.device}, mesh on {mesh.device}")
    tensors = list(state.net.state_dict().values())
    for p in state.net.parameters():
        # the same optimizer state on every rank: all fresh, or all from
        # one checkpoint
        tensors.extend(v for _, v in sorted(state.opt.state.get(p, {})
                                            .items())
                       if torch.is_tensor(v))
    counters = torch.tensor([state.learn_calls, state.iteration])
    _broadcast_(mesh, tensors + [counters])
    state.learn_calls, state.iteration = (int(v) for v in counters)
    for m in state.net.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = mesh.group
    return state


def shard_batch(mesh: Mesh, tree):
    """This rank's contiguous rows of the leading dimension of every
    tensor in ``tree`` (a tensor, a tuple, list or dict of them, or a
    dataclass such as ``EnvState``); 0-dim tensors pass unchanged. Raises
    when a batch does not divide by the group's size."""
    def part(x):
        if torch.is_tensor(x):
            if x.dim() == 0:
                return x
            n = x.shape[0]
            if n % mesh.world:
                raise ValueError(f"a batch of {n} does not divide over "
                                 f"{mesh.world} ranks")
            k = n // mesh.world
            return x[mesh.rank * k:(mesh.rank + 1) * k]
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: part(getattr(x, f.name))
                for f in dataclasses.fields(x)})
        if isinstance(x, (tuple, list)):
            return type(x)(part(v) for v in x)
        if isinstance(x, dict):
            return {k: part(v) for k, v in x.items()}
        raise TypeError(f"shard_batch: cannot shard {type(x).__name__}")
    return part(tree)


def sharded_train_step(mesh: Mesh, cfg):
    """The train step for the mesh: ``step(state, batch, mirror_bits)``
    on this rank's shard of the global batch (``shard_batch``), with
    ``state`` replicated (``replicate``). BatchNorm takes global-batch
    statistics; after the backward one all-reduce averages the gradients
    over the group, before the global-norm clip, so the clip sees the
    gradient of the global loss; the loss metrics are global means."""
    from alphazero_torch.train.learner import train_step

    def step(state, batch, mirror_bits):
        return train_step(state, batch, mirror_bits, cfg, mesh=mesh)

    return step


def sharded_selfplay_move(mesh: Mesh, eval_fn, spec,
                          temperature_threshold: int):
    """One lockstep self-play move of this rank's shard of the games:
    ``move(states, generator)`` with ``states = shard_batch(mesh, ...)``
    on the mesh's device and the rank's own generator. Per-game searches
    are independent, so the shards together make the move of the whole
    batch."""
    from alphazero_torch.train.selfplay import selfplay_move

    def move(states, generator: Optional[torch.Generator]):
        if states.device != mesh.device:
            raise ValueError(f"states on {states.device}, mesh on "
                             f"{mesh.device}")
        return selfplay_move(states, generator, eval_fn, spec,
                             temperature_threshold)

    return move
