"""The search tree's varying-index row accesses and the simulation's glue:
CUDA kernels and their plain PyTorch versions.

Port of ``alphazero_tpu/search/kernels.py``. The tree is one
(B, M, RS, 128) tensor; each simulation walks one path per game from the
root, reading and scoring one row per level (``descend``: the whole walk
of a simulation in one call, board stepping included), and adds three
scalars into one row per game on every backprop level (``commit_edges``,
which takes all levels of a backprop in one call; ``commit_path``, the
form the search calls, builds those levels itself from the descent's
outputs). ``fetch_rows`` is the row read of one level, the gather the JAX
package's kernel is; the plain per-level descent is built on it.

Between the descent and the backprop, the work that XLA fuses into the
JAX package's jitted simulation: ``encode_planes``, the leaves' network
input, and ``expand``, the evaluation's tail, the fresh row at the slot
and the root's stats.

MuZero's search (no JAX counterpart) walks the same rows without a board:
``descend_latent`` is ``descend`` without the env (a compile-time variant
of its kernel), ``gather_latent`` reads each leaf's parent state from the
tree's latent store, ``expand_latent`` writes the fresh row with every
action open and the slot's reward, and ``commit_rewards`` is the backup
with the stored rewards.

On a CUDA tensor each public function launches its hand-written kernel
from ``csrc/tree_kernels.cu`` (float32 trees only) or raises; it never
falls back. On a CPU tensor it runs the plain version beside it. Each
public function counts its kernel launches in ``<function>.launches``.
"""

from __future__ import annotations

import torch

from alphazero_torch import cuda_build
from alphazero_torch.cuda_build import F32, I, LL, P
from alphazero_torch.env import breakthrough as env

LIB = cuda_build.Library(
    "tree_kernels",
    fetch_rows_f32=[P, P, P, I, LL, I, P],
    commit_edges_f32=[P] * 4 + [I] * 7 + [LL, I, P],
    commit_path_f32=[P] * 7 + [I] * 5 + [LL, I, P],
    descend_f32=[P, LL, I, I] + [P] * 7 + [F32, F32, I, I, I] + [P] * 10,
    encode_planes_f32=[P, P, P, I, P],
    expand_f32=[P] * 17 + [LL, I, I, I, I, P],
    descend_latent_f32=[P, LL, I, I, P, P, F32, F32, I, I, I] + [P] * 5,
    gather_latent=[P] * 6 + [LL, I, I, I, P],
    expand_latent_f32=[P] * 15 + [LL, I, I, P],
    commit_rewards_f32=[P] * 9 + [I] * 5 + [LL, I, P],
    launch_floor=[P])

# Child-pointer sentinels (stored as floats; slots <= capacity are exactly
# representable in every value dtype used).
ILLEGAL = -2.0       # action illegal at this node
UNALLOCATED = -1.0   # legal action whose child node does not exist yet


def _check_tensors(operands, device: torch.device) -> None:
    # (name, tensor, dtype, shape) each, read with scalar loads: any
    # mismatch, the dtype's too, is a ValueError
    for name, t, dtype, shape in operands:
        cuda_build.check_operand(name, t, device, dtype, shape,
                                 aligned=False, dtype_error=ValueError)


def _check_tree(rows: torch.Tensor, *index: torch.Tensor,
                levels: tuple = ()) -> None:
    if rows.dtype != torch.float32:
        raise TypeError(f"the CUDA tree kernels take float32 trees, got "
                        f"{rows.dtype} (16-bit trees are CPU-only)")
    if not rows.is_contiguous():
        raise ValueError("the tree must be contiguous; it is never copied")
    shape = levels + (rows.shape[0],)
    _check_tensors([(name, t, torch.int32, shape)
                    for name, t in zip(("node", "act"), index)], rows.device)
    cuda_build.check_device(rows.device)


# -----------------------------------------------------------------------------
# fetch_rows: out[b] = rows[b, node[b]]
# -----------------------------------------------------------------------------

def _fetch_rows_plain(rows: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    B, M = rows.shape[:2]
    flat = rows.reshape(B, M, -1)
    idx = node.long().view(B, 1, 1).expand(B, 1, flat.shape[2])
    return flat.gather(1, idx).reshape(B, -1)


@cuda_build.counted
def fetch_rows(rows: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """(B, R) rows gathered from the (B, M, RS, 128) tree at per-game node
    indices (R = RS*128). ``node`` is (B,) int32 in [0, M): the kernel
    does not check the range."""
    if rows.device.type == "cpu":
        return _fetch_rows_plain(rows, node)
    _check_tree(rows, node)
    B, M, RS, L = rows.shape
    R = RS * L
    if R % 4 or rows.data_ptr() % 16:
        raise ValueError("fetch_rows kernel needs 16-byte aligned rows")
    out = torch.empty((B, R), dtype=rows.dtype, device=rows.device)
    cuda_build.launch(
        fetch_rows, LIB.fetch_rows_f32, rows.data_ptr(), node.data_ptr(),
        out.data_ptr(), B, M, R,
        torch.cuda.current_stream(rows.device).cuda_stream)
    return out


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


@cuda_build.counted
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
    _check_tree(rows, node, act, levels=levels)
    upd = upd.contiguous()
    if upd.device != rows.device:
        raise ValueError("upd must be on the tree's device")
    o = list(offsets) + [0] * (4 - len(offsets))
    cuda_build.launch(
        commit_edges, LIB.commit_edges_f32, rows.data_ptr(), node.data_ptr(),
        act.data_ptr(), upd.data_ptr(), levels[0] if levels else 1, B,
        len(offsets), o[0], o[1], o[2], o[3], M, RS * L,
        torch.cuda.current_stream(rows.device).cuda_stream)
    return rows


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
    _check_tensors((("path_nodes", path_nodes, torch.int32, (B, N)),
                    ("path_actions", path_actions, torch.int32, (B, N)),
                    ("depth", depth, torch.int32, (B,)),
                    ("needs_alloc", needs_alloc, torch.bool, (B,)),
                    ("value", value, rows.dtype, (B,)),
                    ("slot", slot, torch.int32, ())), rows.device)
    if rows.device.type == "cpu":
        return _commit_path_plain(rows, path_nodes, path_actions, depth,
                                  needs_alloc, value, slot, tuple(offsets))
    _check_tree(rows)
    cuda_build.launch(
        commit_edges, LIB.commit_path_f32, rows.data_ptr(),
        path_nodes.data_ptr(), path_actions.data_ptr(), depth.data_ptr(),
        needs_alloc.data_ptr(), value.data_ptr(), slot.data_ptr(), B, N,
        *offsets, M, RS * L,
        torch.cuda.current_stream(rows.device).cuda_stream)
    return rows


# -----------------------------------------------------------------------------
# descend: the PUCT walk of one simulation, root to leaf, for every game
# -----------------------------------------------------------------------------

def _descend_plain(rows: torch.Tensor, root_state: env.EnvState | None,
                   root_visit: torch.Tensor, root_vsum: torch.Tensor,
                   num_actions: int, c_puct: float, fpu_reduction: float,
                   out=None):
    # One level at a time for every game in lockstep: a ``fetch_rows``, the
    # scoring, an ``env.step`` and a read of "is any game still walking" by
    # the host. Returns ``descend``'s six results, the last the number of
    # levels run. Every level writes its column of the path buffers for
    # every game, so stopped games record garbage at d >= depth. Of ``out``
    # only the path buffers are recorded into; the rest is made anew. With
    # no ``root_state`` (``descend_latent``) nothing is stepped and the
    # leaf state is None.
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

        if state is not None:
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
    # no root state: descend_latent's walk, which reads no board
    states = _STATE_DTYPES if root_state is not None else ()
    operands = [(f"root_state.{name}", getattr(root_state, name), dtype,
                 (B, 8, 8) if name == "board" else (B,))
                for name, dtype in states]
    operands += [("root_visit", root_visit, torch.int32, (B,)),
                 ("root_vsum", root_vsum, torch.float32, (B,))]
    if out is not None:
        leaf, needs_alloc, depth, path_nodes, path_actions = out[:5]
        operands += [(f"out leaf_state.{name}", getattr(leaf, name), dtype,
                      (B, 8, 8) if name == "board" else (B,))
                     for name, dtype in states]
        operands += [("out needs_alloc", needs_alloc, torch.bool, (B,)),
                     ("out depth", depth, torch.int32, (B,)),
                     ("out path_nodes", path_nodes, torch.int32, (B, M - 1)),
                     ("out path_actions", path_actions, torch.int32,
                      (B, M - 1))]
    _check_tensors(operands, rows.device)
    cuda_build.check_device(rows.device)


@cuda_build.counted
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
    cuda_build.launch(
        descend, LIB.descend_f32, rows.data_ptr(), M, RS * L, num_actions,
        *(getattr(root_state, name).data_ptr() for name, _ in _STATE_DTYPES),
        root_visit.data_ptr(), root_vsum.data_ptr(),
        c_puct, fpu_reduction, int(bool(fpu_reduction)), B, N,
        path_nodes.data_ptr(), path_actions.data_ptr(), depth.data_ptr(),
        needs_alloc.data_ptr(),
        *(getattr(leaf, name).data_ptr() for name, _ in _STATE_DTYPES),
        torch.cuda.current_stream(dev).cuda_stream)
    return leaf, needs_alloc, depth, path_nodes, path_actions, None


# -----------------------------------------------------------------------------
# encode_planes and expand: the simulation's glue around its evaluation
# -----------------------------------------------------------------------------

@cuda_build.counted
def encode_planes(state: env.EnvState, out: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """(B, 3, 8, 8) float32 network input planes of the B games of
    ``state``: the mover's pieces, the opponent's and ones, in the mover's
    frame. ``env.encoded_state`` is its plain version. ``out``, if given,
    is written and returned.

    On a CUDA state one launch of ``encode_planes_kernel``, which reads
    only the board and the turn."""
    B = state.turn.shape[0]
    if state.board.device.type == "cpu":
        planes = env.encoded_state(state)
        return planes if out is None else out.copy_(planes)
    dev = state.board.device
    if out is None:
        out = torch.empty((B, env.NUM_PLANES, env.BOARD_SIZE, env.BOARD_SIZE),
                          dtype=torch.float32, device=dev)
    _check_tensors((("state.board", state.board, torch.int8, (B, 8, 8)),
                    ("state.turn", state.turn, torch.int8, (B,)),
                    ("out", out, torch.float32, (B, 3, 8, 8))), dev)
    cuda_build.check_device(dev)
    cuda_build.launch(
        encode_planes, LIB.encode_planes_f32, state.board.data_ptr(),
        state.turn.data_ptr(), out.data_ptr(), B,
        torch.cuda.current_stream(dev).cuda_stream)
    return out


def legal_mass(masked: torch.Tensor) -> torch.Tensor:
    """(B, 1) sums of the (B, 192) masked priors in ``expand_kernel``'s
    order: a warp's lane l adds the entries l, l + 32, ..., l + 160 in that
    order, then the 32 partial sums are halved five times (s[j] + s[j +
    16], ...). Float32 and float64 sum in their own type, 16-bit types in
    float32, rounded once."""
    B, A = masked.shape
    acc = masked.dtype if masked.dtype.itemsize >= 4 else torch.float32
    by_lane = masked.to(acc).view(B, A // 32, 32)
    s = by_lane[:, 0]
    for k in range(1, A // 32):
        s = s + by_lane[:, k]
    while s.shape[1] > 1:
        half = s.shape[1] // 2
        s = s[:, :half] + s[:, half:]
    return s.to(masked.dtype)


def renorm_priors(policy: torch.Tensor, legal: torch.Tensor,
                  vdt: torch.dtype) -> torch.Tensor:
    """Mask policy to legal actions and renormalise; uniform fallback when
    the legal mass is not > 0. The JAX package's ``_renorm_priors``
    (``alphazero_tpu/search/mcts.py:227``), the mass taken in
    ``legal_mass``'s order."""
    zero = torch.zeros((), dtype=vdt, device=policy.device)
    masked = torch.where(legal, policy.to(vdt), zero)
    total = legal_mass(masked)
    n_legal = legal.sum(-1, keepdim=True).clamp_min(1).to(vdt)
    return torch.where(total > 0, masked / total.clamp_min(1e-30),
                       legal.to(vdt) / n_legal)


def _expand_plain(tree, leaf_state, needs_alloc, depth, path_nodes, policy,
                  value, tree_reuse, depth_sum):
    # The search's steps between the evaluation and the backprop, as
    # ``mcts._simulate_once`` spelled them out. Nothing is read by the host.
    rows = tree.rows
    B, M = rows.shape[:2]
    A = env.NUM_ACTIONS
    vdt = rows.dtype
    dev = rows.device
    zero = torch.zeros((), dtype=vdt, device=dev)

    # the leaf's value: a terminal leaf's result, else the evaluator's
    is_term = leaf_state.done
    value = torch.where(
        is_term, env.terminal_value_for_player_to_move(leaf_state),
        value.float()).to(vdt)

    # expand the fresh slot (batch-uniform row write; games that did not
    # allocate write the slot's initial values back)
    legal = env.legal_action_mask(leaf_state)
    priors = renorm_priors(policy, legal, vdt)
    do_expand = (needs_alloc & ~is_term)[:, None]
    illegal = torch.full((), ILLEGAL, dtype=vdt, device=dev)
    child_row = torch.where(
        do_expand,
        torch.where(legal, torch.full((), UNALLOCATED, dtype=vdt,
                                      device=dev), illegal),
        illegal)
    prior_row = torch.where(do_expand, priors, zero)
    # the row write at the device slot (the JAX package's
    # dynamic_update_slice)
    flat = rows.view(B, M, -1)
    at = tree.next_slot.view(1).long()
    if tree_reuse:
        # Slots between a game's compacted node count and next_slot hold
        # stale rows from the compaction, so clear visit/vsum too.
        fresh_row = torch.cat(
            [child_row, prior_row,
             torch.zeros((B, flat.shape[2] - 2 * A), dtype=vdt,
                         device=dev)], dim=-1)
        flat.index_copy_(1, at, fresh_row[:, None])
        # Record the fresh slot's parent: the node the allocating edge
        # left from (path position depth-1); 0 for games that did not
        # allocate (self-excluding in advance_root).
        d_last = (depth - 1).clamp_min(0).long()[:, None]
        par = path_nodes.gather(1, d_last)[:, 0]
        tree.parents.index_copy_(
            1, at, torch.where(needs_alloc, par, 0)[:, None])
    else:
        flat[:, :, :2 * A].index_copy_(
            1, at, torch.cat([child_row, prior_row], dim=-1)[:, None])

    # Root stats: the value reaches the root flipped ``depth`` times.
    sign0 = torch.where(depth % 2 == 1, 1.0, -1.0).to(vdt)
    tree.root_visit += 1
    tree.root_vsum += -sign0 * value
    tree.node_count += needs_alloc.int()
    depth_sum += depth.sum()
    return value


@cuda_build.counted
def expand(tree, leaf_state: env.EnvState, needs_alloc: torch.Tensor,
           depth: torch.Tensor, path_nodes: torch.Tensor,
           policy: torch.Tensor, value: torch.Tensor, tree_reuse: bool,
           depth_sum: torch.Tensor) -> torch.Tensor:
    """A simulation's work between its evaluation and its backprop, in
    place; returns the (B,) leaf values, of the tree's dtype, that
    ``commit_path`` adds up the path.

    ``tree`` is the search's tree (``mcts.Tree``: rows, parents, root
    visit and vsum, node count and the device slot ``next_slot``);
    ``leaf_state``, ``needs_alloc``, ``depth`` and ``path_nodes`` are
    ``descend``'s results; ``policy`` (B, 192) and ``value`` (B,) the
    evaluator's. A terminal leaf's value is its result for the player to
    move; the fresh row at the slot is ``[legal ? UNALLOCATED : ILLEGAL |
    renormalised prior]`` where the game allocated a non-terminal leaf,
    else ``[ILLEGAL | 0]``; with ``tree_reuse`` the row's visit and vsum
    blocks are zeroed and the slot's parent recorded; the root's visit
    count gains one, its vsum the value flipped ``depth`` times, the node
    count ``needs_alloc``, and ``depth_sum`` (a () int64 tensor) the
    depths.

    On a CUDA tree (float32 only) one launch of ``expand_kernel``, which
    reads the slot where it lies; otherwise the plain version, whose
    legal mass is taken in the kernel's order (``legal_mass``), so the
    two are bit-equal. The slot's increment is the caller's: the backprop
    reads the slot after this."""
    rows = tree.rows
    if rows.device.type == "cpu":
        return _expand_plain(tree, leaf_state, needs_alloc, depth,
                             path_nodes, policy, value, tree_reuse,
                             depth_sum)
    if rows.dtype != torch.float32:
        raise TypeError(f"the CUDA tree kernels take float32 trees, got "
                        f"{rows.dtype} (other trees are CPU-only)")
    if rows.dim() != 4 or not rows.is_contiguous():
        raise ValueError("the tree must be a contiguous (B, M, RS, 128) "
                         "tensor; it is never copied")
    B, M, RS, L = rows.shape
    A = env.NUM_ACTIONS
    if RS * L < 4 * A:
        raise ValueError(f"a row of {RS * L} holds no four blocks of {A}")
    policy, value = policy.float().contiguous(), value.float().contiguous()
    _check_tensors((
        ("parents", tree.parents, torch.int32, (B, M)),
        ("root_visit", tree.root_visit, torch.int32, (B,)),
        ("root_vsum", tree.root_vsum, torch.float32, (B,)),
        ("node_count", tree.node_count, torch.int32, (B,)),
        ("next_slot", tree.next_slot, torch.int32, ()),
        ("leaf_state.board", leaf_state.board, torch.int8, (B, 8, 8)),
        ("leaf_state.turn", leaf_state.turn, torch.int8, (B,)),
        ("leaf_state.winner", leaf_state.winner, torch.int8, (B,)),
        ("leaf_state.done", leaf_state.done, torch.bool, (B,)),
        ("needs_alloc", needs_alloc, torch.bool, (B,)),
        ("depth", depth, torch.int32, (B,)),
        ("path_nodes", path_nodes, torch.int32, (B, M - 1)),
        ("policy", policy, torch.float32, (B, A)),
        ("value", value, torch.float32, (B,)),
        ("depth_sum", depth_sum, torch.int64, ())), rows.device)
    cuda_build.check_device(rows.device)
    value_out = torch.empty((B,), dtype=torch.float32, device=rows.device)
    cuda_build.launch(
        expand, LIB.expand_f32, rows.data_ptr(), tree.parents.data_ptr(),
        tree.root_visit.data_ptr(), tree.root_vsum.data_ptr(),
        tree.node_count.data_ptr(),
        tree.next_slot.data_ptr(), leaf_state.board.data_ptr(),
        leaf_state.turn.data_ptr(), leaf_state.winner.data_ptr(),
        leaf_state.done.data_ptr(), needs_alloc.data_ptr(),
        depth.data_ptr(), path_nodes.data_ptr(), policy.data_ptr(),
        value.data_ptr(), value_out.data_ptr(), depth_sum.data_ptr(),
        M, RS * L, B, M - 1, int(bool(tree_reuse)),
        torch.cuda.current_stream(rows.device).cuda_stream)
    return value_out


# -----------------------------------------------------------------------------
# MuZero's search: descend_latent, gather_latent, expand_latent,
# commit_rewards
# -----------------------------------------------------------------------------

@cuda_build.counted
def descend_latent(rows: torch.Tensor, root_visit: torch.Tensor,
                   root_vsum: torch.Tensor, num_actions: int, c_puct: float,
                   fpu_reduction: float = 0.0, out=None):
    """``descend`` over the tree alone: the same walk and scores, with no
    board, so no final position stops it (every action below the root is
    open). Returns ``(None, needs_alloc, depth, path_nodes, path_actions,
    levels)``, ``descend``'s results without the leaf state.

    On a CUDA tree one launch of ``descend_kernel<false>``, the
    compile-time variant that loads, steps and writes nothing of the
    board; on a CPU tree the plain per-level loop."""
    if rows.device.type == "cpu":
        return _descend_plain(rows, None, root_visit, root_vsum,
                              num_actions, c_puct, fpu_reduction, out)
    _check_descend_operands(rows, None, root_visit, root_vsum, num_actions,
                            out)
    B, M, RS, L = rows.shape
    N = M - 1
    dev = rows.device
    if out is not None:
        _, needs_alloc, depth, path_nodes, path_actions = out[:5]
    else:
        path_nodes, path_actions = (
            torch.zeros((B, N), dtype=torch.int32, device=dev),
            torch.zeros((B, N), dtype=torch.int32, device=dev))
        depth = torch.empty((B,), dtype=torch.int32, device=dev)
        needs_alloc = torch.empty((B,), dtype=torch.bool, device=dev)
    cuda_build.launch(
        descend_latent, LIB.descend_latent_f32, rows.data_ptr(), M, RS * L,
        num_actions, root_visit.data_ptr(), root_vsum.data_ptr(), c_puct,
        fpu_reduction, int(bool(fpu_reduction)), B, N, path_nodes.data_ptr(),
        path_actions.data_ptr(), depth.data_ptr(), needs_alloc.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    return None, needs_alloc, depth, path_nodes, path_actions, None


def _last_edge(depth: torch.Tensor, path: torch.Tensor) -> torch.Tensor:
    """(B,) ``path[b, depth[b] - 1]``, 0 where the depth is 0."""
    d = (depth.long() - 1).clamp_min(0)[:, None]
    return torch.where(depth > 0, path.gather(1, d)[:, 0], 0)


@cuda_build.counted
def gather_latent(latent: torch.Tensor, depth: torch.Tensor,
                  path_nodes: torch.Tensor, path_actions: torch.Tensor):
    """The state a simulation's leaf is reached from, and the action: of
    the (B, slots, 64, C) store, ``latent[b, p]`` as (B*64, C) rows with
    ``p = path_nodes[b, depth[b] - 1]``, and ``path_actions[b, depth[b] -
    1]`` as (B,) int32 (slot 0 and action 0 where the depth is 0). On a
    CUDA store one launch of ``gather_latent_kernel`` (any dtype; a row of
    a multiple of 16 bytes), which reads the depths and the path where they
    lie; on a CPU store the plain gather."""
    B, slots, S, C = latent.shape
    N = path_nodes.shape[1]
    _check_tensors((("depth", depth, torch.int32, (B,)),
                    ("path_nodes", path_nodes, torch.int32, (B, N)),
                    ("path_actions", path_actions, torch.int32, (B, N))),
                   latent.device)
    if latent.device.type == "cpu":
        node = _last_edge(depth, path_nodes).long()
        act = _last_edge(depth, path_actions).int()
        rows = latent[torch.arange(B), node]
        return rows.reshape(B * S, C), act
    row_bytes = S * C * latent.element_size()
    if row_bytes % 16 or not latent.is_contiguous() \
            or latent.data_ptr() % 16:
        raise ValueError("gather_latent takes a contiguous, 16-byte aligned "
                         "store whose rows are whole 16-byte vectors")
    cuda_build.check_device(latent.device)
    out = torch.empty((B * S, C), dtype=latent.dtype, device=latent.device)
    act = torch.empty((B,), dtype=torch.int32, device=latent.device)
    cuda_build.launch(
        gather_latent, LIB.gather_latent, latent.data_ptr(), depth.data_ptr(),
        path_nodes.data_ptr(), path_actions.data_ptr(), out.data_ptr(),
        act.data_ptr(), slots, B, N, row_bytes // 16,
        torch.cuda.current_stream(latent.device).cuda_stream)
    return out, act


def _expand_latent_plain(tree, needs_alloc, depth, policy, value, reward,
                         depth_sum):
    rows = tree.rows
    B, M = rows.shape[:2]
    A = env.NUM_ACTIONS
    dev = rows.device
    root = tree.root_state
    final_root = (depth == 0) & root.done
    value = torch.where(final_root,
                        env.terminal_value_for_player_to_move(root),
                        value.float()).float()
    everything = torch.ones((B, A), dtype=torch.bool, device=dev)
    priors = renorm_priors(policy, everything, torch.float32)
    alloc = needs_alloc[:, None]
    child_row = torch.where(alloc, UNALLOCATED, ILLEGAL).to(
        torch.float32).expand(B, A)
    prior_row = torch.where(alloc, priors, 0.0)
    at = tree.next_slot.view(1).long()
    rows.view(B, M, -1)[:, :, :2 * A].index_copy_(
        1, at, torch.cat([child_row, prior_row], dim=-1)[:, None])
    tree.reward.index_copy_(
        1, at, torch.where(needs_alloc, reward.float(), 0.0)[:, None])
    tree.root_visit += 1
    tree.node_count += needs_alloc.int()
    depth_sum += depth.sum()
    return value


@cuda_build.counted
def expand_latent(tree, needs_alloc: torch.Tensor, depth: torch.Tensor,
                  policy: torch.Tensor, value: torch.Tensor,
                  reward: torch.Tensor, depth_sum: torch.Tensor
                  ) -> torch.Tensor:
    """MuZero's ``expand``: returns the (B,) leaf values that
    ``commit_rewards`` backs up. The fresh row at the slot is ``[UNALLOCATED
    | prior]`` on every action where the game allocated (no mask and no
    final position below the root; the priors renormalised over all
    actions), else ``[ILLEGAL | 0]``; ``tree.reward`` at the slot takes
    g's reward (0 where nothing was allocated); the root's visit count
    gains one, the node count ``needs_alloc`` and ``depth_sum`` the depths.
    The root's value sum is the backup's. A walk of depth 0 stops only at a
    final root, whose result is its value.

    On a CUDA tree (float32) one launch of ``expand_latent_kernel``;
    otherwise the plain version, bit-equal (the legal mass in
    ``legal_mass``'s order)."""
    rows = tree.rows
    if rows.device.type == "cpu":
        return _expand_latent_plain(tree, needs_alloc, depth, policy, value,
                                    reward, depth_sum)
    if rows.dtype != torch.float32 or rows.dim() != 4 \
            or not rows.is_contiguous():
        raise ValueError("the CUDA tree kernels take a contiguous float32 "
                         "(B, M, RS, 128) tree")
    B, M, RS, L = rows.shape
    A = env.NUM_ACTIONS
    policy, value = policy.float().contiguous(), value.float().contiguous()
    reward = reward.float().contiguous()
    root = tree.root_state
    _check_tensors((
        ("reward store", tree.reward, torch.float32, (B, M)),
        ("root_visit", tree.root_visit, torch.int32, (B,)),
        ("node_count", tree.node_count, torch.int32, (B,)),
        ("next_slot", tree.next_slot, torch.int32, ()),
        ("root_state.turn", root.turn, torch.int8, (B,)),
        ("root_state.winner", root.winner, torch.int8, (B,)),
        ("root_state.done", root.done, torch.bool, (B,)),
        ("needs_alloc", needs_alloc, torch.bool, (B,)),
        ("depth", depth, torch.int32, (B,)),
        ("policy", policy, torch.float32, (B, A)),
        ("value", value, torch.float32, (B,)),
        ("reward", reward, torch.float32, (B,)),
        ("depth_sum", depth_sum, torch.int64, ())), rows.device)
    cuda_build.check_device(rows.device)
    value_out = torch.empty((B,), dtype=torch.float32, device=rows.device)
    cuda_build.launch(
        expand_latent, LIB.expand_latent_f32, rows.data_ptr(),
        tree.reward.data_ptr(), tree.root_visit.data_ptr(),
        tree.node_count.data_ptr(), tree.next_slot.data_ptr(),
        root.turn.data_ptr(), root.winner.data_ptr(), root.done.data_ptr(),
        needs_alloc.data_ptr(), depth.data_ptr(), policy.data_ptr(),
        value.data_ptr(), reward.data_ptr(), value_out.data_ptr(),
        depth_sum.data_ptr(), M, RS * L, B,
        torch.cuda.current_stream(rows.device).cuda_stream)
    return value_out


def _commit_rewards_plain(rows, reward, path_nodes, path_actions, depth,
                          needs_alloc, value, slot, root_vsum, offsets):
    # The kernel's walk for every game at once, a level at a time from the
    # deepest (one read of the largest depth by the host).
    B, M = rows.shape[:2]
    flat = rows.view(B, M, -1)
    b = torch.arange(B, device=rows.device)
    o0, o1, o2 = offsets
    G = value.float().clone()
    alloc = torch.where(needs_alloc, (slot + 1).float(), 0.0)
    for d in range(int(depth.max()) - 1, -1, -1):
        on = d < depth
        node = path_nodes[:, d].long()
        a = path_actions[:, d].long()
        ptr = flat[b, node, o0 + a]
        ptr = torch.where(on & (d == depth - 1), ptr + alloc, ptr)
        flat[b, node, o0 + a] = torch.where(on, ptr, flat[b, node, o0 + a])
        child = ptr.long()
        ok = (child > 0) & (child < M)
        r = torch.where(ok, reward[b, child.clamp(0, M - 1)], 0.0)
        G = torch.where(on, r - G, G)
        visit = flat[b, node, o1 + a]
        flat[b, node, o1 + a] = torch.where(on, visit + 1.0, visit)
        vsum = flat[b, node, o2 + a]
        flat[b, node, o2 + a] = torch.where(on, vsum + (-G), vsum)
    root_vsum += G
    return rows


@cuda_build.counted
def commit_rewards(rows: torch.Tensor, reward: torch.Tensor,
                   path_nodes: torch.Tensor, path_actions: torch.Tensor,
                   depth: torch.Tensor, needs_alloc: torch.Tensor,
                   value: torch.Tensor, slot: torch.Tensor,
                   root_vsum: torch.Tensor, offsets: tuple, num_actions: int
                   ) -> torch.Tensor:
    """MuZero's backup of a simulation, in place; returns ``rows``. From
    the leaf's value ``G`` (the player to move there), each walked edge d
    from the deepest up takes its child pointer (``slot + 1`` added on the
    last edge where ``needs_alloc``), reads its child's reward r from the
    (B, M) ``reward`` store (the player who took the edge's), sets ``G = r
    - G``, gains a visit and adds ``-G`` to its value sum, the sum kept for
    the child's mover as ``commit_path`` keeps it, so the descent's rule
    is unchanged; the root's value sum gains the last ``G``. With every
    reward 0 this is ``commit_path``'s sign flip, bit for bit.

    On a CUDA tree one launch of ``commit_rewards_kernel``, a thread a
    game, which reads the slot and the depths where they lie; on a CPU tree
    the plain version (float32 trees), bit-equal."""
    B, M, RS, L = rows.shape
    if len(offsets) != 3:
        raise ValueError(f"commit_rewards takes the three offsets (child "
                         f"ptr, visit, vsum), got {tuple(offsets)}")
    _check_offsets(offsets, num_actions, RS * L)
    if rows.dtype != torch.float32:
        raise TypeError(f"MuZero's search keeps a float32 tree, got "
                        f"{rows.dtype}")
    N = M - 1
    _check_tensors((("reward", reward, torch.float32, (B, M)),
                    ("path_nodes", path_nodes, torch.int32, (B, N)),
                    ("path_actions", path_actions, torch.int32, (B, N)),
                    ("depth", depth, torch.int32, (B,)),
                    ("needs_alloc", needs_alloc, torch.bool, (B,)),
                    ("value", value, torch.float32, (B,)),
                    ("slot", slot, torch.int32, ()),
                    ("root_vsum", root_vsum, torch.float32, (B,))),
                   rows.device)
    if rows.device.type == "cpu":
        return _commit_rewards_plain(rows, reward, path_nodes, path_actions,
                                     depth, needs_alloc, value, slot,
                                     root_vsum, tuple(offsets))
    _check_tree(rows)
    cuda_build.launch(
        commit_rewards, LIB.commit_rewards_f32, rows.data_ptr(),
        reward.data_ptr(), path_nodes.data_ptr(), path_actions.data_ptr(),
        depth.data_ptr(), needs_alloc.data_ptr(), value.data_ptr(),
        slot.data_ptr(), root_vsum.data_ptr(), B, N, *offsets, M, RS * L,
        torch.cuda.current_stream(rows.device).cuda_stream)
    return rows
