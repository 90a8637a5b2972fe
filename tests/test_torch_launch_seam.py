"""The launch seam of the port's hand kernels (``alphazero_torch/
cuda_build.py``): one list of counted wrappers, which the capture reads
and nothing else; one place that binds the libraries' entry points, turns
a CUDA error into an exception and counts a launch; one pair of operand
checks. All on the CPU: a stand-in takes the place of a C entry point.
"""

import ast
import ctypes
import importlib
import re
from pathlib import Path

import pytest
import torch

from alphazero_torch import cuda_build
from alphazero_torch.models import encoder_epilogue as ee
from alphazero_torch.models import quant
from alphazero_torch.search import kernels as K

PACKAGE = Path(cuda_build.__file__).parent
SOURCES = sorted(p.relative_to(PACKAGE).as_posix()
                 for p in PACKAGE.rglob("*.py"))
MODULES = [("alphazero_torch." + s[:-3].replace("/", ".")
            ).removesuffix(".__init__")
           for s in SOURCES if s != "__main__.py"]


@pytest.mark.parametrize("name", MODULES)
def test_every_counted_wrapper_is_in_the_seams_list(name):
    """A function of the package with a ``launches`` count is in
    ``cuda_build.COUNTED``, the list whose counts a replay adds to."""
    module = importlib.import_module(name)
    for value in vars(module).values():
        if callable(value) and hasattr(value, "launches"):
            assert any(value is f for f in cuda_build.COUNTED), value


def test_the_capture_reads_the_counts_from_the_seam_alone():
    """``search/graph.py`` imports no kernel module and looks up no module
    by name: its counters are ``cuda_build.COUNTED``."""
    path = PACKAGE / "search" / "graph.py"
    tree = ast.parse(path.read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported |= {f"{node.module}.{a.name}" for a in node.names}
    assert not any(m.startswith("alphazero_torch.models") or "kernels" in m
                   for m in imported), imported
    assert "sys" not in imported
    text = path.read_text()
    assert "alphazero_torch.models" not in text
    assert "cuda_build.COUNTED" in text


@pytest.mark.parametrize("source", SOURCES)
def test_only_the_seam_binds_and_loads_libraries(source):
    text = (PACKAGE / source).read_text()
    if source == "cuda_build.py":
        return
    for word in (".argtypes", ".restype", "load_library(", "ctypes.CDLL",
                 "_argtypes_set"):
        assert word not in text, word


@pytest.mark.parametrize("entry, kernel, wrapper", [
    ("commit_path_f32", "commit_path", K.commit_edges),
    ("qconv3x3_s8", "qconv3x3", quant.qconv3x3),
    ("deepnorm_ln_bf16", "deepnorm_ln", ee.deepnorm_ln),
    ("dense_mish_bf16", "dense_mish", ee.dense_mish)])
def test_a_failed_launch_raises_naming_the_kernel(entry, kernel, wrapper):
    """A stand-in for a C entry point returns CUDA error 1: the launch
    raises, naming the kernel, and counts nothing; a return of 0 counts
    one launch."""
    rcs = []

    def stand_in(*args):
        return rcs.pop()

    stand_in.__name__ = entry
    before = wrapper.launches
    rcs.append(1)
    with pytest.raises(RuntimeError,
                       match=f"^{kernel} kernel launch failed: CUDA error 1$"):
        cuda_build.launch(wrapper, stand_in, 7, None)
    assert wrapper.launches == before
    rcs.append(0)
    cuda_build.launch(wrapper, stand_in, 7, None)
    assert wrapper.launches == before + 1
    wrapper.launches = before


def test_a_library_binds_its_entries_once(monkeypatch):
    """Every declared entry is bound, with its argument types and an int
    result, at the first use of any; the library is loaded once, and an
    entry it does not declare is no attribute."""
    loads = []

    def load(stem):
        loads.append(stem)
        return ctypes.CDLL(None)             # the process's own symbols

    monkeypatch.setattr(cuda_build, "load_library", load)
    lib = cuda_build.Library("libc", abs=[cuda_build.I],
                             labs=[ctypes.c_long])
    assert lib.abs(-3) == 3 and lib.labs(-4) == 4 and lib.abs(5) == 5
    assert loads == ["libc"]
    assert lib.labs.argtypes == [ctypes.c_long]
    assert lib.abs.restype is ctypes.c_int
    with pytest.raises(AttributeError):
        lib.strlen


def test_a_librarys_init_runs_once_a_device():
    calls = []

    def init(sms):
        calls.append(sms)
        sms._obj.value = 132
        return len(calls) - 1 if len(calls) > 2 else 0

    lib = cuda_build.Library("conv_kernels", init="conv3x3_init")
    lib.__dict__["conv3x3_init"] = init      # bound: the card's stand-in
    for _ in range(3):
        assert lib.multiprocessors(torch.device("cuda", 0)) == 132
    assert len(calls) == 1
    assert lib.multiprocessors(torch.device("cuda", 1)) == 132
    with pytest.raises(RuntimeError, match="conv3x3_init failed: CUDA "
                                           "error 2"):
        lib.multiprocessors(torch.device("cuda", 2))


def _misaligned(t):
    flat = torch.zeros(t.numel() + 8, dtype=t.dtype)
    return flat[1:t.numel() + 1].view(t.shape)


@pytest.mark.parametrize("case, error, match", [
    ("device", ValueError, "operand t on meta"),
    ("dtype", TypeError, r"t in float32 \(t in torch.float32\)"),
    ("dtype_as_value", ValueError, "t in float32"),
    ("shape", ValueError, r"t must be \(4, 8\)"),
    ("strided", ValueError, "contiguous and 16-byte aligned"),
    ("misaligned", ValueError, "16-byte aligned"),
    ("strided_unaligned", ValueError, "t must be contiguous$"),
])
def test_check_operand_raises_by_kind(case, error, match):
    t = torch.zeros((4, 8))
    kw = {}
    if case == "device":
        t = t.to("meta")
    elif case in ("dtype", "dtype_as_value"):
        t = t.double()
        kw = {"dtype_error": ValueError} if case == "dtype_as_value" else {}
    elif case == "shape":
        t = t[:2].contiguous()
    elif case in ("strided", "strided_unaligned"):
        t = torch.zeros((8, 4)).T
        kw = {"aligned": False} if case == "strided_unaligned" else {}
    elif case == "misaligned":
        t = _misaligned(t)
    with pytest.raises(error, match=match):
        cuda_build.check_operand("t", t, torch.device("cpu"), torch.float32,
                                 (4, 8), **kw)


def test_check_operand_takes_what_fits():
    t = torch.zeros((4, 8))
    cuda_build.check_operand("t", t, t.device, torch.float32, (4, 8))
    cuda_build.check_operand("t", t, t.device, torch.float32)
    odd = _misaligned(t)
    cuda_build.check_operand("t", odd, t.device, torch.float32, (4, 8),
                             aligned=False)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_build.check_device(torch.device("meta"))


def test_kernel_names_are_every_global_function_of_the_sources():
    """The port's list of hand kernels (a profile's ``hand`` class) is
    read from the sources: one name for each ``__global__``."""
    names = cuda_build.kernel_names()
    count = sum(p.read_text().count("__global__")
                for p in cuda_build.CSRC.glob("*.cu"))
    assert len(names) == count
    assert all(re.fullmatch(r"\w+_kernel", n) for n in names), names
    assert {"conv3x3_kernel", "se_residual_kernel", "tower_kernel",
            "commit_path_kernel"} <= set(names)


def test_a_path_count_is_in_the_seams_list_and_counts_with_its_wrapper():
    """``count_path`` gives a wrapper a count of one path of its kernel,
    which a replay adds to (it is in ``COUNTED``): ``launch(...,
    path=...)`` counts a launch on both, a failed one on neither, and
    names the path's kernel. ``conv3x3``'s persistent path is one."""
    from alphazero_torch.models import conv

    path = conv.conv3x3.persistent
    assert any(c is path for c in cuda_build.COUNTED)
    rcs = [0, 1]

    def stand_in(*args):
        return rcs.pop()

    stand_in.__name__ = "conv3x3_persistent_bf16"
    before = (conv.conv3x3.launches, path.launches)
    with pytest.raises(RuntimeError, match="^conv3x3_persistent kernel "
                                           "launch failed: CUDA error 1$"):
        cuda_build.launch(conv.conv3x3, stand_in, 7, path=path)
    assert (conv.conv3x3.launches, path.launches) == before
    cuda_build.launch(conv.conv3x3, stand_in, 7, path=path)
    assert (conv.conv3x3.launches, path.launches) == (before[0] + 1,
                                                      before[1] + 1)
    conv.conv3x3.launches, path.launches = before
