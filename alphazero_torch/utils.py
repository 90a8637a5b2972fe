"""Runtime helpers of the port: logging and profiling.

The JAX package's compilation cache and multi-host helpers have no
counterpart here: PyTorch runs eagerly, and the port is single-device.
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
