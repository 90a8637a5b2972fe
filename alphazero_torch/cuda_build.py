"""Builds the package's CUDA sources into plain-C shared libraries.

Each ``csrc/<stem>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<stem>-<hash>.so`` at the repository root, at first
use, and loaded with ``ctypes``. The hash is of the source, so an edited
source is rebuilt and a stale library is never loaded. Nothing is built
or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin); the CUDA kernels cannot "
                           "be built")
    return path


def library_path(stem: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{stem}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{stem}-{digest[:12]}.so"


def build(stems: Iterable[str]) -> Dict[str, Path]:
    """Compile every source not yet built, all ``nvcc`` runs in parallel.
    The compiler's output (register and shared-memory use per kernel)
    goes to ``<library>.log``. Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {s: library_path(s) for s in stems}
    running = []
    for stem, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        log = open(lib.with_suffix(".log"), "w")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
        running.append((stem, proc, tmp, lib, log))
    failed = []
    for stem, proc, tmp, lib, log in running:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{stem}: nvcc exit {rc}, see "
                          f"{lib.with_suffix('.log')}")
    if failed:
        raise RuntimeError("CUDA build failed: " + "; ".join(failed))
    return libs


@functools.cache
def load_library(stem: str) -> ctypes.CDLL:
    """The built ``csrc/<stem>.cu`` library, building it if needed."""
    return ctypes.CDLL(str(build([stem])[stem]))
