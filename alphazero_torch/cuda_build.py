"""Builds the package's CUDA sources into plain-C shared libraries, and
is the one seam through which the kernel wrappers launch them.

Each ``csrc/<stem>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<stem>-<hash>.so`` at the repository root, at first
use, and loaded with ``ctypes``. The hash is of the source, so an edited
source is rebuilt and a stale library is never loaded. Nothing is built
or loaded when this module is imported.

The launch contract: a wrapper module declares its library's C entry
points once (``Library``), marks each wrapper that counts its launches
(``counted``: ``COUNTED`` is the one list of them, which a replay of a
captured search adds to), checks its operands (``check_operand``,
``check_device``) and calls an entry through ``launch``, which raises on a
CUDA error and counts the launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import types
from pathlib import Path
from typing import Callable, Dict, Iterable, List

import torch

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


def kernel_names() -> List[str]:
    """The ``__global__`` functions of every ``csrc/*.cu``: the hand-written
    kernels, by the names a profiler gives them (before any template
    arguments)."""
    found = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\("
                       r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")
    return sorted({name for path in CSRC.glob("*.cu")
                   for name in found.findall(path.read_text())})


def align(n: int, a: int) -> int:
    """``n`` rounded up to a multiple of ``a``, as the kernels lay out
    their shared memory."""
    return (n + a - 1) // a * a


# the C types of the entry points' arguments
P, I, LL, F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                 ctypes.c_float)


class Library:
    """The C entry points of ``csrc/<stem>.cu``, declared once: ``entries``
    maps each one's name to its argument types, and each returns an
    ``int``, a CUDA error code (0 on success). The library is built and
    every entry bound at the first use of one; an entry is then an
    attribute (``LIB.name(...)``). ``init``, if given, names an entry
    ``int init(int* sms)`` that ``multiprocessors`` runs once a device."""

    def __init__(self, stem: str, init: str | None = None, **entries):
        if init is not None:
            entries[init] = [ctypes.POINTER(I)]
        self.stem, self._init, self._entries = stem, init, entries
        self._sms: Dict[int, int] = {}

    def __getattr__(self, name: str):
        entries = self.__dict__.get("_entries", {})
        if name not in entries:
            raise AttributeError(name)
        lib = load_library(self.stem)
        for entry, argtypes in entries.items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, I
            self.__dict__[entry] = fn
        return self.__dict__[name]

    def multiprocessors(self, dev: torch.device) -> int:
        """The card's multiprocessor count, from the library's ``init``,
        which runs once a device, at the device's first call here, and opts
        its kernels in to their shared memory. The wrappers ask before
        every launch, so it runs before a device's first launch, and never
        inside a capture (the eager warm-up launches first)."""
        sms = self._sms.get(dev.index)
        if sms is None:
            n = I(0)
            rc = getattr(self, self._init)(ctypes.byref(n))
            if rc:
                raise RuntimeError(f"{self._init} failed: CUDA error {rc}")
            sms = self._sms[dev.index] = n.value
        return sms


# the wrappers that count their kernel launches, as their modules are
# imported
COUNTED: List[Callable] = []


def counted(fn: Callable) -> Callable:
    """Marks the kernel wrapper ``fn`` as counted: ``fn.launches``, which
    callers read and reset, counts its successful launches (``launch``);
    a call on the CPU counts none. A replay of a captured search does not
    pass through the wrappers, so it adds to the counts of ``COUNTED``
    what the capture counted (``search/graph.py``)."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


def count_path(wrapper: Callable, name: str) -> None:
    """Gives the counted ``wrapper`` a count of the launches that take one
    path of its kernel, ``wrapper.<name>.launches``, which ``launch(...,
    path=wrapper.<name>)`` adds to; it is in ``COUNTED`` beside the
    wrappers, so that replays add to it too."""
    counter = types.SimpleNamespace(launches=0)
    setattr(wrapper, name, counter)
    COUNTED.append(counter)


def launch(wrapper: Callable, entry, *args, path=None) -> None:
    """Calls the C ``entry`` with ``args``; counts one launch of the
    counted ``wrapper`` (and of its ``path``, if given), or raises if the
    entry returns a CUDA error, naming the kernel (the entry's name less
    its type suffix)."""
    rc = entry(*args)
    if rc:
        raise RuntimeError(f"{entry.__name__.rsplit('_', 1)[0]} kernel "
                           f"launch failed: CUDA error {rc}")
    wrapper.launches += 1
    if path is not None:
        path.launches += 1


def check_operand(name: str, t: torch.Tensor, device: torch.device,
                  dtype: torch.dtype, shape: tuple | None = None,
                  aligned: bool = True, dtype_error: type = TypeError
                  ) -> None:
    """Raises unless the launch operand ``t`` is on ``device``, of
    ``dtype`` and (if given) ``shape``, contiguous and, if ``aligned``,
    16-byte aligned (for kernels that read it in 16-byte vectors). A wrong
    dtype raises ``dtype_error``, the rest ValueError."""
    if t.device != device:
        raise ValueError(f"operand {name} on {t.device}, the launch on "
                         f"{device}")
    if t.dtype != dtype:
        short = str(dtype).removeprefix("torch.")
        raise dtype_error(f"the kernel takes {name} in {short} ({name} in "
                          f"{dtype}), got {t.dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous() or (aligned and t.data_ptr() % 16):
        raise ValueError(f"{name} must be contiguous"
                         + (" and 16-byte aligned" if aligned else ""))


def check_device(device: torch.device) -> None:
    """Raises ValueError unless ``device`` is the current CUDA device, on
    whose stream the kernels launch."""
    if device.type != "cuda":
        raise ValueError(f"the kernels take CPU or CUDA tensors, got "
                         f"{device}")
    if device.index != torch.cuda.current_device():
        raise ValueError(f"operands on {device}, current CUDA device is "
                         f"{torch.cuda.current_device()}")
