"""PyTorch/CUDA port of ``alphazero_tpu`` (AlphaZero for Breakthrough).

The module layout mirrors the JAX package: ``config``, ``env``,
``models``, ``search``, ``train``, ``parallel`` (data parallelism over
``torch.distributed``, one process per card), ``arena``, ``baseline``,
``web`` and ``utils``, with the CLI in ``main`` (``python -m alphazero_torch
train|web|arena``), the bench in ``bench`` and the JAX package's
strength-gate scripts as ``strength``. The JAX package's three Pallas
kernels are hand-written CUDA here: the two search-tree kernels
(``csrc/tree_kernels.cu``) and the fused SE-ResNet tower
(``csrc/tower_kernel.cu``); the int8 evaluator's s8 conv, an XLA op
there, is one too (``csrc/qconv_kernel.cu``). Every entry point takes an
explicit ``device``, ``"cuda"`` by default, and raises when no card is
present instead of quietly running on the CPU.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when no
    card is present (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return dev
