"""The search tree's varying-index row accesses: CUDA kernels and their
plain PyTorch versions.

Port of ``alphazero_tpu/search/kernels.py``. The tree is one
(B, M, RS, 128) tensor; each simulation walks one path per game from the
root, reading and scoring one row per level (``descend``: the whole walk
of a simulation in one call, board stepping included), and adds three
scalars into one row per game on every backprop level (``commit_edges``,
which takes all levels of a backprop in one call; ``commit_path``, the
form the search calls, builds those levels itself from the descent's
outputs). ``fetch_rows`` is the row read of one level, the gather the JAX
package's kernel is; the plain per-level descent is built on it.

On a CUDA tensor each public function launches its hand-written kernel
from ``csrc/tree_kernels.cu`` (float32 trees only) or raises; it never
falls back. On a CPU tensor it runs the plain version beside it. Each
public function counts its kernel launches in ``<function>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from alphazero_torch.cuda_build import load_library
from alphazero_torch.env import breakthrough as env

_LIB = "tree_kernels"

# Child-pointer sentinels (stored as floats; slots <= capacity are exactly
# representable in every value dtype used).
ILLEGAL = -2.0       # action illegal at this node
UNALLOCATED = -1.0   # legal action whose child node does not exist yet


def _lib() -> ctypes.CDLL:
    lib = load_library(_LIB)
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fetch_rows_f32.argtypes = [p, p, p, i, ll, i, p]
        lib.fetch_rows_f32.restype = i
        lib.commit_edges_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                         ll, i, p]
        lib.commit_edges_f32.restype = i
        lib.commit_path_f32.argtypes = [p] * 7 + [i] * 5 + [ll, i, p]
        lib.commit_path_f32.restype = i
        f = ctypes.c_float
        lib.descend_f32.argtypes = ([p, ll, i, i] + [p] * 7 + [f, f, i, i, i]
                                    + [p] * 10)
        lib.descend_f32.restype = i
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


# -----------------------------------------------------------------------------
# commit_path: a whole backprop from the descent's outputs
# -----------------------------------------------------------------------------

def _commit_path_plain(rows, path_nodes, path_actions, depth, needs_alloc,
                       value, slot, offsets):
    # The levels ``commit_edges`` is given by the search, built here as
    # (B, N) planes, and applied all at once: the levels of one game touch
    # distinct rows (a path visits a node once), so every element gets at
    # most one update and the order of levels cannot matter. Each update
    # is rounded once, f32 accumulate then the tree's dtype, as the stacked
    # form rounds it. Levels past a game's depth point at its trash row
    # with zero updates, which leave it as it was. Nothing is read by the
    # host.
    B, M = rows.shape[:2]
    N = path_nodes.shape[1]
    vdt = rows.dtype
    dev = rows.device
    flat = rows.view(-1)
    R = flat.numel() // (B * M)
    zero = torch.zeros((), dtype=vdt, device=dev)
    d = torch.arange(N, device=dev)[None]                         # (1, N)
    active = d < depth[:, None]                                   # (B, N)
    sign0 = torch.where(depth % 2 == 1, 1.0, -1.0).to(vdt)
    flip = (1 - 2 * (d % 2)).to(vdt)
    alloc = active & needs_alloc[:, None] & (d == depth[:, None] - 1)
    upd = torch.stack([
        torch.where(alloc, (slot + 1).to(vdt), zero),
        active.to(vdt),
        torch.where(active, (sign0 * value)[:, None] * flip, zero),
    ], dim=-1).to(torch.float32)                                  # (B, N, 3)
    node = torch.where(active, path_nodes, M - 1).long()
    at = torch.arange(B, device=dev)[:, None] * M + node          # (B, N)
    if vdt == torch.float64:
        # the stacked form rounds each touched row through float32 whole
        # (the TPU kernel's rule); for the other dtypes that changes nothing
        by_row = rows.view(B * M, R)
        by_row[at] = by_row[at].float().to(vdt)
    idx = ((at * R + path_actions.long())[..., None]
           + torch.tensor(offsets, device=dev))                   # (B, N, 3)
    flat[idx] = (flat[idx].float() + upd).to(vdt)
    return rows


def commit_path(rows: torch.Tensor, path_nodes: torch.Tensor,
                path_actions: torch.Tensor, depth: torch.Tensor,
                needs_alloc: torch.Tensor, value: torch.Tensor,
                slot: torch.Tensor, offsets: tuple, num_actions: int
                ) -> torch.Tensor:
    """A simulation's whole backprop, in place; returns ``rows``.

    ``path_nodes``, ``path_actions`` (B, N) int32, ``depth`` (B,) int32 and
    ``needs_alloc`` (B,) bool are ``descend``'s results; ``value`` (B,) of
    the tree's dtype is the leaf's value for the side to move there;
    ``slot`` () int32 is the simulation's fresh slot; ``offsets`` are the
    three in-row offsets (child ptr, visit, vsum). Every walked edge ``d <
    depth[b]`` gets ``[slot + 1 if it is the last edge and needs_alloc[b],
    else 0 | 1 | sign0 * (-1)^d * value[b]]``, ``sign0`` +1 for an odd
    depth and -1 for an even one: bit for bit what ``commit_edges`` does
    with the stacked (L, B) levels the search used to build, L = max(depth,
    1), levels past a game's depth on its trash row.

    On a CUDA tree one launch of ``commit_path_kernel``, which reads the
    slot and the depths where they lie: the host reads nothing. It counts
    in ``commit_edges.launches``: it is the path form of that kernel, and
    the backprop's launch count keeps its name.
    """
    B, M, RS, L = rows.shape
    if len(offsets) != 3:
        raise ValueError(f"commit_path takes the three offsets (child ptr, "
                         f"visit, vsum), got {tuple(offsets)}")
    _check_offsets(offsets, num_actions, RS * L)
    N = M - 1
    for name, t, dtype, shape in (
            ("path_nodes", path_nodes, torch.int32, (B, N)),
            ("path_actions", path_actions, torch.int32, (B, N)),
            ("depth", depth, torch.int32, (B,)),
            ("needs_alloc", needs_alloc, torch.bool, (B,)),
            ("value", value, rows.dtype, (B,)),
            ("slot", slot, torch.int32, ())):
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != rows.device:
            raise ValueError(f"{name} must be a contiguous {shape} {dtype} "
                             f"tensor on the tree's device; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if rows.device.type == "cpu":
        return _commit_path_plain(rows, path_nodes, path_actions, depth,
                                  needs_alloc, value, slot, tuple(offsets))
    _check_cuda_operands(rows)
    rc = _lib().commit_path_f32(
        rows.data_ptr(), path_nodes.data_ptr(), path_actions.data_ptr(),
        depth.data_ptr(), needs_alloc.data_ptr(), value.data_ptr(),
        slot.data_ptr(), B, N, *offsets, M, RS * L,
        torch.cuda.current_stream(rows.device).cuda_stream)
    _raise_on_error(rc, "commit_path")
    commit_edges.launches += 1
    return rows


# -----------------------------------------------------------------------------
# descend: the PUCT walk of one simulation, root to leaf, for every game
# -----------------------------------------------------------------------------

def _descend_plain(rows: torch.Tensor, root_state: env.EnvState,
                   root_visit: torch.Tensor, root_vsum: torch.Tensor,
                   num_actions: int, c_puct: float, fpu_reduction: float,
                   out=None):
    # One level at a time for every game in lockstep: a ``fetch_rows``, the
    # scoring, an ``env.step`` and a read of "is any game still walking" by
    # the host. Returns ``descend``'s six results, the last the number of
    # levels run. Every level writes its column of the path buffers for
    # every game, so stopped games record garbage at d >= depth. Of ``out``
    # only the path buffers are recorded into; the rest is made anew.
    B = root_visit.shape[0]
    N = rows.shape[1] - 1
    A = num_actions
    vdt = rows.dtype
    dev = rows.device
    zero = torch.zeros((), dtype=vdt, device=dev)
    neg_inf = torch.full((), float("-inf"), dtype=vdt, device=dev)
    bidx = torch.arange(B, device=dev)

    state = root_state
    cur = torch.zeros((B,), dtype=torch.int32, device=dev)
    n_cur = root_visit.to(vdt)
    parent_q = torch.where(root_visit > 0,
                           root_vsum / root_visit.clamp_min(1).to(vdt), zero)
    stopped = torch.zeros((B,), dtype=torch.bool, device=dev)
    needs_alloc = torch.zeros((B,), dtype=torch.bool, device=dev)
    depth = torch.zeros((B,), dtype=torch.int32, device=dev)
    path_nodes, path_actions = out[3:5] if out is not None else (
        torch.zeros((B, N), dtype=torch.int32, device=dev),
        torch.zeros((B, N), dtype=torch.int32, device=dev))

    d = 0
    while True:
        row = fetch_rows(rows, cur)                           # (B, R)
        child = row[:, :A]
        prior = row[:, A:2 * A]
        ev = row[:, 2 * A:3 * A]
        evs = row[:, 3 * A:4 * A]

        legal = child > (ILLEGAL + 0.5)
        live = legal.any(-1) & ~stopped

        if fpu_reduction:
            q_unvisited = (parent_q - fpu_reduction)[:, None]
        else:
            q_unvisited = zero
        q = torch.where(ev > 0, -evs / ev.clamp_min(1), q_unvisited)
        cs = c_puct * torch.sqrt(n_cur.clamp_min(1))
        u = prior * cs[:, None] / (1 + ev)
        score = torch.where(legal, q + u, neg_inf)
        a = score.argmax(-1)                                  # (B,) int64

        child_a = child[bidx, a]
        ev_a = ev[bidx, a]

        alloc_here = live & (child_a < (UNALLOCATED + 0.5))
        descend = live & (child_a > -0.5)

        if fpu_reduction:
            # The descended-into child becomes next level's parent; its Q
            # from its own mover's side is +evs/ev.
            evs_a = evs[bidx, a]
            child_q = torch.where(ev_a > 0, evs_a / ev_a.clamp_min(1), zero)
            parent_q = torch.where(descend, child_q, parent_q)

        # Stopped games record garbage here; backprop masks on depth.
        path_nodes[:, d] = cur
        path_actions[:, d] = a.int()

        state = env.select_state(live, env.step(state, a), state)

        cur = torch.where(descend, child_a.int(), cur)
        n_cur = torch.where(descend, ev_a, n_cur)
        stopped = stopped | ~live | alloc_here
        needs_alloc = needs_alloc | alloc_here
        depth = depth + live.int()
        d += 1
        if not bool((~stopped).any()):                        # host sync
            break
    return state, needs_alloc, depth, path_nodes, path_actions, d


_STATE_DTYPES = (("board", torch.int8), ("turn", torch.int8),
                 ("winner", torch.int8), ("done", torch.bool),
                 ("move_count", torch.int32))


def _check_descend_operands(rows, root_state, root_visit, root_vsum,
                            num_actions, out) -> None:
    # dtypes, shapes and contiguity first (they need no card to be told),
    # then the device
    if rows.dtype != torch.float32:
        raise TypeError(f"the CUDA tree kernels take float32 trees, got "
                        f"{rows.dtype} (other trees are CPU-only)")
    if rows.dim() != 4 or not rows.is_contiguous():
        raise ValueError("the tree must be a contiguous (B, M, RS, 128) "
                         "tensor; it is never copied")
    B, M, RS, L = rows.shape
    if not 1 <= num_actions <= env.NUM_ACTIONS or 4 * num_actions > RS * L:
        raise ValueError(f"num_actions={num_actions} must be in [1, "
                         f"{env.NUM_ACTIONS}] with four blocks in a row of "
                         f"{RS * L}")
    operands = [(f"root_state.{name}", getattr(root_state, name), dtype,
                 (B, 8, 8) if name == "board" else (B,))
                for name, dtype in _STATE_DTYPES]
    operands += [("root_visit", root_visit, torch.int32, (B,)),
                 ("root_vsum", root_vsum, torch.float32, (B,))]
    if out is not None:
        leaf, needs_alloc, depth, path_nodes, path_actions = out[:5]
        operands += [(f"out leaf_state.{name}", getattr(leaf, name), dtype,
                      (B, 8, 8) if name == "board" else (B,))
                     for name, dtype in _STATE_DTYPES]
        operands += [("out needs_alloc", needs_alloc, torch.bool, (B,)),
                     ("out depth", depth, torch.int32, (B,)),
                     ("out path_nodes", path_nodes, torch.int32, (B, M - 1)),
                     ("out path_actions", path_actions, torch.int32,
                      (B, M - 1))]
    for name, t, dtype, shape in operands:
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != rows.device:
            raise ValueError(f"{name} must be a contiguous {shape} {dtype} "
                             f"tensor on the tree's device; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}"
                             f"{'' if t.is_contiguous() else ', strided'}")
    if rows.device.type != "cuda":
        raise ValueError(f"descend takes CPU or CUDA tensors, got a tree on "
                         f"{rows.device}")
    if rows.device.index != torch.cuda.current_device():
        raise ValueError(f"tree on {rows.device}, current CUDA device is "
                         f"{torch.cuda.current_device()}")


def descend(rows: torch.Tensor, root_state: env.EnvState,
            root_visit: torch.Tensor, root_vsum: torch.Tensor,
            num_actions: int, c_puct: float, fpu_reduction: float = 0.0,
            out=None):
    """The PUCT descent of one simulation for every game of the batch.

    rows: the (B, M, RS, 128) tree; root_state: the games at the root;
    root_visit (B,) int32, root_vsum (B,) of the tree's dtype. Each game
    walks from node 0: at a node it scores every legal action
    (``q + u``, ``q = -vsum/visit`` or, unvisited, ``parent_q -
    fpu_reduction`` if that is not 0, else 0; ``u = prior * c_puct *
    sqrt(max(N_node, 1)) / (1 + visit)``), takes the first maximum, steps
    its board by that action, and goes on to the child; it stops at a node
    with no legal action, or after an edge whose child does not exist yet.

    Returns ``(leaf_state, needs_alloc, depth, path_nodes, path_actions,
    levels)``: the walked edges are ``(path_nodes[b, d], path_actions[b,
    d])`` for ``d < depth[b]`` (entries past that are unspecified),
    ``needs_alloc`` says that the last edge needs a new child, and
    ``leaf_state`` is the root state stepped along the path. ``levels`` is
    the number of levels the per-level loop ran on a CPU tree (the host
    read one value per level), and None on a CUDA tree: nothing was read,
    and a caller that needs a count reads ``depth.max()``.

    ``out`` is the result of an earlier call at the same shapes, to be
    overwritten and returned, so that a search allocates its results once
    and not every simulation: on a CUDA tree every tensor of it is written
    in place, on a CPU tree the two path buffers.

    On a CUDA tree this is one kernel launch, one thread block per game,
    and no host sync; on a CPU tree it is the plain per-level loop.
    """
    if rows.device.type == "cpu":
        return _descend_plain(rows, root_state, root_visit, root_vsum,
                              num_actions, c_puct, fpu_reduction, out)
    _check_descend_operands(rows, root_state, root_visit, root_vsum,
                            num_actions, out)
    B, M, RS, L = rows.shape
    N = M - 1
    dev = rows.device
    if out is not None:
        leaf, needs_alloc, depth, path_nodes, path_actions = out[:5]
    else:
        # zeros, not empty: entries past a game's depth stay valid indices
        path_nodes, path_actions = (
            torch.zeros((B, N), dtype=torch.int32, device=dev),
            torch.zeros((B, N), dtype=torch.int32, device=dev))
        depth = torch.empty((B,), dtype=torch.int32, device=dev)
        needs_alloc = torch.empty((B,), dtype=torch.bool, device=dev)
        leaf = env.EnvState(*(torch.empty_like(getattr(root_state, name))
                              for name, _ in _STATE_DTYPES))
    rc = _lib().descend_f32(
        rows.data_ptr(), M, RS * L, num_actions,
        *(getattr(root_state, name).data_ptr() for name, _ in _STATE_DTYPES),
        root_visit.data_ptr(), root_vsum.data_ptr(),
        c_puct, fpu_reduction, int(bool(fpu_reduction)), B, N,
        path_nodes.data_ptr(), path_actions.data_ptr(), depth.data_ptr(),
        needs_alloc.data_ptr(),
        *(getattr(leaf, name).data_ptr() for name, _ in _STATE_DTYPES),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_error(rc, "descend")
    descend.launches += 1
    return leaf, needs_alloc, depth, path_nodes, path_actions, None


descend.launches = 0
