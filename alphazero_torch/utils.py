"""Runtime helpers of the port: logging, profiling, debug checks and the
multi-process runtime (``alphazero_tpu/utils/runtime.py``).

One process drives one card. Under ``torchrun`` (or any launcher that sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``) ``init_distributed`` joins the processes into one
``torch.distributed`` group; each rank is then what a JAX host with one
local device is to the JAX package. The JAX package's compilation cache
has no counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

import contextlib
import logging
import os


def setup_logging(level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger("alphazero_torch")
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
    logger.setLevel(level)
    return logger


@contextlib.contextmanager
def profile_trace(logdir: str):
    """``with profile_trace(dir): ...`` records a ``torch.profiler`` trace
    of the host and, where there is a card, the device, and writes it to
    ``dir/trace.json`` (Chrome trace format) and a table of the operators
    by device time to ``dir/key_averages.txt``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    sort = ("self_cuda_time_total" if torch.cuda.is_available()
            else "self_cpu_time_total")
    with open(os.path.join(logdir, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=60))


def enable_debug_checks() -> None:
    """Development mode: ``torch.autograd.set_detect_anomaly(True)``, the
    nearest counterpart of the JAX package's ``jax_debug_nans`` and
    ``jax_debug_infs``.

    It differs from them: it checks the backward pass only (a backward
    function that returns NaN raises, with the trace of the forward
    operation that made it), not forward or inference results, and it
    does not look for infinities. It slows every backward pass."""
    import torch

    torch.autograd.set_detect_anomaly(True)


def is_coordinator() -> bool:
    """True on the process that owns filesystem writes: checkpoints,
    metrics and the arena's state are written by rank 0 only, since every
    rank holds the same replicated weights (replay shards are per rank).
    True without a process group."""
    import torch.distributed as dist

    return (not dist.is_available() or not dist.is_initialized()
            or dist.get_rank() == 0)


def init_distributed(backend: str | None = None, device=None) -> int:
    """Join the process group described by the environment that
    ``torchrun`` sets, and return this process's rank.

    Without ``device`` the process takes the card ``LOCAL_RANK`` names
    (``torch.cuda.set_device``) and raises when there is no such card;
    with ``device="cpu"`` it stays on the CPU. The backend is NCCL for a
    card and gloo for the CPU unless ``backend`` names one; a missing NCCL
    raises. Nothing falls back to gloo or to the CPU. Call it before
    anything touches the card."""
    import torch
    import torch.distributed as dist

    from alphazero_torch import resolve_device

    if device is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not 0 <= local < n_cards:
            raise RuntimeError(
                f"LOCAL_RANK {local} has no CUDA device ({n_cards} visible); "
                "pass device='cpu' to run on the CPU explicitly")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the NCCL backend needs a CUDA device")
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch build has no NCCL")
    dist.init_process_group(
        backend=backend, init_method="env://",
        device_id=dev if backend == "nccl" else None)
    return dist.get_rank()
