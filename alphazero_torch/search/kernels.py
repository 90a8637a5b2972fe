"""The search tree's varying-index row accesses: CUDA kernels and their
plain PyTorch versions.

Port of ``alphazero_tpu/search/kernels.py``. The tree is one
(B, M, RS, 128) tensor; each simulation reads one whole row per game at a
per-game node index on every descent level (``fetch_rows``) and adds three
scalars into one row per game on every backprop level (``commit_edges``,
which takes all levels of a backprop in one call).

On a CUDA tensor each public function launches its hand-written kernel
from ``csrc/tree_kernels.cu`` (float32 trees only) or raises; it never
falls back. On a CPU tensor it runs the plain version beside it. Each
public function counts its kernel launches in ``<function>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from alphazero_torch.cuda_build import load_library

_LIB = "tree_kernels"


def _lib() -> ctypes.CDLL:
    lib = load_library(_LIB)
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fetch_rows_f32.argtypes = [p, p, p, i, ll, i, p]
        lib.fetch_rows_f32.restype = i
        lib.commit_edges_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                         ll, i, p]
        lib.commit_edges_f32.restype = i
        lib.launch_floor.argtypes = [p]
        lib.launch_floor.restype = i
        lib._argtypes_set = True
    return lib


def _check_cuda_operands(rows: torch.Tensor, *index: torch.Tensor,
                         levels: tuple = ()) -> None:
    if rows.dtype != torch.float32:
        raise TypeError(f"the CUDA tree kernels take float32 trees, got "
                        f"{rows.dtype} (16-bit trees are CPU-only)")
    if not rows.is_contiguous():
        raise ValueError("the tree must be contiguous; it is never copied")
    if rows.device.index != torch.cuda.current_device():
        raise ValueError(f"tree on {rows.device}, current CUDA device is "
                         f"{torch.cuda.current_device()}")
    shape = levels + (rows.shape[0],)
    for t in index:
        if t.device != rows.device or t.dtype != torch.int32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"node/act must be contiguous {shape} int32 "
                             f"tensors on the tree's device")


def _raise_on_error(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


# -----------------------------------------------------------------------------
# fetch_rows: out[b] = rows[b, node[b]]
# -----------------------------------------------------------------------------

def _fetch_rows_plain(rows: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    B, M = rows.shape[:2]
    flat = rows.reshape(B, M, -1)
    idx = node.long().view(B, 1, 1).expand(B, 1, flat.shape[2])
    return flat.gather(1, idx).reshape(B, -1)


def fetch_rows(rows: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """(B, R) rows gathered from the (B, M, RS, 128) tree at per-game node
    indices (R = RS*128). ``node`` is (B,) int32 in [0, M): the kernel
    does not check the range."""
    if rows.device.type == "cpu":
        return _fetch_rows_plain(rows, node)
    _check_cuda_operands(rows, node)
    B, M, RS, L = rows.shape
    R = RS * L
    if R % 4 or rows.data_ptr() % 16:
        raise ValueError("fetch_rows kernel needs 16-byte aligned rows")
    out = torch.empty((B, R), dtype=rows.dtype, device=rows.device)
    rc = _lib().fetch_rows_f32(
        rows.data_ptr(), node.data_ptr(), out.data_ptr(), B, M, R,
        torch.cuda.current_stream(rows.device).cuda_stream)
    _raise_on_error(rc, "fetch_rows")
    fetch_rows.launches += 1
    return out


fetch_rows.launches = 0


# -----------------------------------------------------------------------------
# commit_edges: rows[b, node[b], offsets[k] + act[b]] += upd[b, k]
# -----------------------------------------------------------------------------

def _commit_edges_plain(rows, node, act, upd, offsets):
    # Numerics of the TPU kernel (kernels.py:109-124 of the JAX package):
    # the touched row accumulates all K updates in float32 and rounds back
    # to rows.dtype ONCE, so a float64 or 16-bit CPU tree gives the JAX
    # fallback's bits. Stacked levels ((L, B) node and act, (L, B, K) upd)
    # are applied one after the other in order, each by that rule.
    # Updates rows in place and returns it.
    B, M = rows.shape[:2]
    flat = rows.view(B, M, -1)
    b = torch.arange(B, device=rows.device)
    if node.dim() == 1:
        node, act, upd = node[None], act[None], upd[None]
    for n, a, u in zip(node.long(), act.long(), upd):
        row = flat[b, n].float()                              # (B, R) copy
        for k, off in enumerate(offsets):
            row[b, off + a] += u[:, k]
        flat[b, n] = row.to(rows.dtype)
    return rows


def _check_offsets(offsets, num_actions: int, row_len: int) -> None:
    # Every element must be updated at most once per game: that is what
    # lets the CUDA kernel run one thread per (game, k) without atomics.
    offs = sorted(offsets)
    if not 1 <= len(offs) <= 4 or offs[0] < 0 \
            or offs[-1] + num_actions > row_len \
            or any(b - a < num_actions for a, b in zip(offs, offs[1:])):
        raise ValueError(f"offsets {tuple(offsets)} must be 1-4 in-row "
                         f"offsets at least num_actions={num_actions} apart")


def commit_edges(rows: torch.Tensor, node: torch.Tensor, act: torch.Tensor,
                 upd: torch.Tensor, offsets: tuple, num_actions: int
                 ) -> torch.Tensor:
    """In-place per-game edge update of the fused tree; returns ``rows``.

    rows: (B, M, RS, 128); node, act: (B,) int32 with act in
    [0, num_actions); upd: (B, K), cast to float32 and accumulated in
    float32 before rounding to rows.dtype; offsets: K in-row offsets at
    least ``num_actions`` apart. Row ``rows[b, node[b]]`` gets ``upd[b, k]``
    added at flat position ``offsets[k] + act[b]``.

    A whole backprop in one call: node, act of shape (L, B) and upd of
    shape (L, B, K) give, bit for bit, what the L calls on ``node[l]``,
    ``act[l]``, ``upd[l]`` give in the order l = 0 .. L-1, also where
    levels meet on one row. On a CUDA tree that is one kernel launch, in
    which the thread of a (game, k) walks its levels in order.
    """
    B, M, RS, L = rows.shape
    _check_offsets(offsets, num_actions, RS * L)
    levels = tuple(node.shape[:-1])
    if len(levels) > 1 or tuple(node.shape) != levels + (B,) \
            or act.shape != node.shape \
            or tuple(upd.shape) != levels + (B, len(offsets)):
        raise ValueError(f"node and act must be (B,) or (L, B) and upd "
                         f"(B, K) or (L, B, K) with B={B}, K={len(offsets)}; "
                         f"got {tuple(node.shape)}, {tuple(act.shape)}, "
                         f"{tuple(upd.shape)}")
    upd = upd.to(torch.float32)
    if rows.device.type == "cpu":
        return _commit_edges_plain(rows, node, act, upd, tuple(offsets))
    _check_cuda_operands(rows, node, act, levels=levels)
    upd = upd.contiguous()
    if upd.device != rows.device:
        raise ValueError("upd must be on the tree's device")
    o = list(offsets) + [0] * (4 - len(offsets))
    rc = _lib().commit_edges_f32(
        rows.data_ptr(), node.data_ptr(), act.data_ptr(), upd.data_ptr(),
        levels[0] if levels else 1, B, len(offsets), o[0], o[1], o[2], o[3],
        M, RS * L, torch.cuda.current_stream(rows.device).cuda_stream)
    _raise_on_error(rc, "commit_edges")
    commit_edges.launches += 1
    return rows


commit_edges.launches = 0
