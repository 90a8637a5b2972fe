"""Batched PUCT MCTS on torch tensors.

Port of ``alphazero_tpu/search/mcts.py``, with the same tree layout so
that trees compare row for row with the JAX package's:

- node slots are allocated in simulation order: the slot of simulation
  ``i`` is ``i+1`` for every game, so the expansion write is one
  batch-uniform row write; the slot is a device scalar, as in the JAX
  package, so the host never needs to know it;
- per-node data is ONE fused row ``rows[b, n] : (RS, 128)`` whose flat
  view holds the [child ptr | prior | edge visit | edge vsum] blocks of
  width A. The two per-game varying-index accesses (the descent's row
  reads and the backprop's edge updates) go through ``search/kernels.py``,
  which launches hand-written CUDA kernels on the card: one for the whole
  descent of a simulation (``descend``), one for its whole backprop
  (``commit_path``);
- child pointers are additive: -1 (UNALLOCATED) becomes the slot index
  when the backprop update of the allocating edge adds ``s+1``;
- the descent path is recorded in (B, N) buffers and backprop walks it;
- no per-node game state is stored: the descent steps the root state
  along the walked edges, so the final state is the leaf state.

The search semantics are the JAX package's: FPU disabled by default
(unvisited q = 0), u = c_puct * prior * sqrt(max(1, N_parent)) /
(1 + N_child), priors renormalised over legal actions with a uniform
fallback, the value sign flips every ply, root expansion does not count a
visit, and scores tie-break to the lowest action index (``torch.argmax``
returns the first maximum, on the CPU and on CUDA).

Unlike the JAX package, ``search``, ``init_tree(..., tree=)`` and
``advance_root`` update the ``Tree`` they are given IN PLACE (the tensors
of its fields, which are never rebound) and return it: the tree is 1.26
GB at 512 games x 800 simulations and is never copied.

A simulation (``_simulate_once``) reads nothing back to the host: the
descent is one kernel on the card, the expansion writes at the device
slot, and the backprop walks each game's own depth in one kernel. The
JAX package compiles a move into one program (``selfplay_move`` is
jitted, the simulations a ``fori_loop``); the port's counterpart is a CUDA
graph: on a CUDA tree ``search`` captures one simulation and replays it
``num_simulations`` times (``search/graph.py``), and ``capture=False``
runs the same body eagerly. On a CPU tree the body runs eagerly through
the kernels' plain versions; of those, the per-level descent reads "is any
game still walking" once per level (``STATS.host_syncs``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Tuple

import torch
from torch.profiler import record_function

from alphazero_torch.env import breakthrough as env
from alphazero_torch.models.network import policy_value_apply
from alphazero_torch.search import kernels

Evaluator = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
# eval_fn(planes (B,3,8,8) f32) -> (policy_probs (B,192) f32, value (B,) f32)

# Child-pointer sentinels: ILLEGAL, an action illegal at this node, and
# UNALLOCATED, a legal action whose child node does not exist yet.
ILLEGAL = kernels.ILLEGAL
UNALLOCATED = kernels.UNALLOCATED


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """Static search hyperparameters."""

    num_simulations: int = 400
    num_actions: int = 192
    c_puct: float = 1.5
    # First-play urgency: unvisited children score q = parent_Q - reduction
    # instead of q = 0; 0.0 is the reference (FPU disabled).
    fpu_reduction: float = 0.0
    # Between-move tree reuse: advance_root() re-roots the tree at the
    # chosen child. Doubles tree capacity for headroom.
    tree_reuse: bool = False
    dirichlet_alpha: float = 0.35
    dirichlet_epsilon: float = 0.25
    value_dtype: torch.dtype = torch.float32

    @property
    def capacity(self) -> int:
        return (2 * self.num_simulations + 1 if self.tree_reuse
                else self.num_simulations + 1)


def _row_sublanes(A: int, vdt: torch.dtype) -> int:
    """Rows of 128 in the fused per-node row: ceil(4A/128), rounded up to
    a multiple of 8 for 16-bit dtypes (the JAX package's TPU tiling; kept
    so trees compare row for row)."""
    rs = -(-4 * A // 128)
    if vdt.itemsize < 4:
        rs = -(-rs // 8) * 8
    return rs


@dataclasses.dataclass
class Tree:
    """Batched search tree; B games, N = capacity node slots.

    rows:        (B, N+1, RS, 128) value_dtype fused per-node rows; the
                 flat view of a row holds [child ptr | prior | edge visit |
                 edge vsum] of width A (plus zero padding for 16-bit
                 dtypes). Slot N is a write-only trash row targeted by
                 masked updates.
    root_state:  EnvState with batch shape (B,), the search root
    root_visit:  (B,) int32 root visit count
    root_vsum:   (B,) value_dtype
    node_count:  (B,) int32 real allocated nodes (including the root)
    next_slot:   () int32 next fresh slot, advanced once per simulation
                 uniformly across the batch, on the device
    parents:     (B, N+1) int32 each slot's parent slot (0 for the root,
                 unallocated slots, and games that skipped an allocation)
    n_actions:   A (not recoverable from rows.shape for padded rows)
    slot_bound:  host int, a bound next_slot cannot pass, for the capacity
                 check of ``search``; it is never read from the card
    captured:    the simulation ``search/graph.py`` captured on this tree's
                 buffers, or None

    The tree owns its root state (contiguous copies); every field's tensor
    keeps its address for the tree's life, which a captured simulation
    relies on.
    """

    rows: torch.Tensor
    root_state: env.EnvState
    root_visit: torch.Tensor
    root_vsum: torch.Tensor
    node_count: torch.Tensor
    next_slot: torch.Tensor
    parents: torch.Tensor
    n_actions: int
    slot_bound: int = 1
    captured: object = dataclasses.field(default=None, repr=False,
                                         compare=False)

    @property
    def num_actions(self) -> int:
        return self.n_actions

    def _flat_rows(self) -> torch.Tensor:
        B, M = self.rows.shape[:2]
        return self.rows.view(B, M, -1)

    @property
    def prior(self) -> torch.Tensor:
        """(B, N, A) priors (0 on illegal actions)."""
        A = self.num_actions
        return self._flat_rows()[:, :-1, A:2 * A]


def _root_flat(tree: Tree) -> torch.Tensor:
    """(B, RS*128) view of the root rows; writes go into the tree."""
    return tree._flat_rows()[:, 0]


def _copy_state(dst: env.EnvState, src: env.EnvState) -> None:
    for f in dataclasses.fields(env.EnvState):
        getattr(dst, f.name).copy_(getattr(src, f.name))


def init_tree(root_states: env.EnvState, spec: SearchSpec,
              tree: Tree | None = None) -> Tree:
    """Fresh tree batch with the given root states at slot 0, on the
    states' device.

    ``tree``, a tree of the same shape, dtype and device, is reset in place
    and returned: its buffers, and the simulation captured on them, serve
    the next search (a move of fresh roots replays the last move's graph).
    Otherwise a new tree is made."""
    B = root_states.turn.shape[0]
    N, A = spec.capacity, spec.num_actions
    vdt = spec.value_dtype
    dev = root_states.device
    # The fused row stores child POINTERS and VISIT COUNTS in vdt, so vdt
    # must represent every integer up to capacity/num_simulations exactly:
    # float16 is exact to 2048, bfloat16 only to 256.
    if vdt.itemsize < 4:
        max_exact = 256 if vdt == torch.bfloat16 else 2048
        if N + 1 > max_exact or spec.num_simulations >= max_exact:
            raise ValueError(
                f"value_dtype={vdt} represents integers exactly only up to "
                f"{max_exact}; capacity {N + 1} / {spec.num_simulations} "
                f"sims would corrupt visit counts and child pointers")
    if dev.type == "cuda" and vdt != torch.float32:
        raise ValueError(
            f"value_dtype={vdt} on CUDA: the tree kernels take float32 "
            f"trees only; other dtypes are for CPU numerics tests")
    RS = _row_sublanes(A, vdt)
    shape = (B, N + 1, RS, 128)
    if tree is None or tuple(tree.rows.shape) != shape \
            or tree.rows.dtype != vdt or tree.rows.device != dev \
            or tree.n_actions != A:
        tree = Tree(
            rows=torch.empty(shape, dtype=vdt, device=dev),
            n_actions=A,
            root_state=env.EnvState(*(
                torch.empty(getattr(root_states, f.name).shape,
                            dtype=getattr(root_states, f.name).dtype,
                            device=dev)
                for f in dataclasses.fields(env.EnvState))),
            root_visit=torch.empty((B,), dtype=torch.int32, device=dev),
            root_vsum=torch.empty((B,), dtype=vdt, device=dev),
            node_count=torch.empty((B,), dtype=torch.int32, device=dev),
            next_slot=torch.empty((), dtype=torch.int32, device=dev),
            parents=torch.empty((B, N + 1), dtype=torch.int32, device=dev),
        )
    tree.rows.zero_()
    tree.rows.view(B, N + 1, -1)[:, :, :A] = ILLEGAL
    _copy_state(tree.root_state, root_states)
    tree.root_visit.zero_()
    tree.root_vsum.zero_()
    tree.node_count.fill_(1)
    tree.next_slot.fill_(1)
    tree.parents.zero_()
    tree.slot_bound = 1
    return tree


def _renorm_priors(policy: torch.Tensor, legal: torch.Tensor,
                   vdt: torch.dtype) -> torch.Tensor:
    """Mask policy to legal actions and renormalise; uniform fallback when
    the legal mass is zero."""
    zero = torch.zeros((), dtype=vdt, device=policy.device)
    masked = torch.where(legal, policy.to(vdt), zero)
    total = masked.sum(-1, keepdim=True)
    n_legal = legal.sum(-1, keepdim=True).clamp_min(1).to(vdt)
    return torch.where(total > 0, masked / total.clamp_min(1e-30),
                       legal.to(vdt) / n_legal)


@dataclasses.dataclass
class SearchStats:
    """Counters of the search loop, read by measurement scripts: simulations
    run (a replayed one counted by the host at its replay), the levels the
    per-level descent ran (CPU trees only: on a CUDA tree no one reads how
    deep a descent went), the host's reads of a device value inside
    simulations (one per level of the CPU's descent; none on a CUDA
    tree), and the per-game edge depth summed over games and simulations
    (``depth_sum``, read from one accumulator per device that the
    simulation adds to in place, so that a captured simulation adds to it
    on every replay)."""

    simulations: int = 0
    levels: int = 0
    host_syncs: int = 0
    depth: dict = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.simulations, self.levels, self.host_syncs = 0, 0, 0
        for acc in self.depth.values():
            acc.zero_()

    def add_depth(self, depth: torch.Tensor) -> None:
        acc = self.depth.get(depth.device)
        if acc is None:
            # a normal tensor, so that searches in and out of inference
            # mode both add to it in place
            with torch.inference_mode(False):
                acc = torch.zeros((), dtype=torch.int64, device=depth.device)
            self.depth[depth.device] = acc
        acc += depth.sum()

    @property
    def depth_sum(self) -> int:
        """The accumulators read by the host (a read of each device)."""
        return sum(int(acc) for acc in self.depth.values())


STATS = SearchStats()


# -----------------------------------------------------------------------------
# One simulation: descend -> evaluate -> expand -> backprop
# -----------------------------------------------------------------------------

def _descend(rows: torch.Tensor, root_state: env.EnvState,
             root_visit: torch.Tensor, root_vsum: torch.Tensor,
             spec: SearchSpec, out=None):
    """PUCT descent for every game in lockstep.

    The game state is stepped alongside the walk, so the final state IS
    the leaf state (for an allocating walk, the NEW child's state).
    Returns (leaf_state, needs_alloc, depth, path_nodes, path_actions,
    levels): the walked edges are (path_nodes[:, d], path_actions[:, d])
    for d < depth; when ``needs_alloc`` the last edge is the one that needs
    a new child, otherwise the walk stopped on an existing leaf (terminal
    node or unexpanded root). ``levels`` is the number of levels the plain
    per-level descent ran on a CPU tree, each one read of the device by
    the host, and None on a CUDA tree, where the kernel reads nothing.
    ``out`` is an earlier call's result, overwritten and returned
    (``kernels.descend``).
    """
    *out, levels = kernels.descend(rows, root_state, root_visit, root_vsum,
                                   spec.num_actions, spec.c_puct,
                                   spec.fpu_reduction, out)
    if levels is not None:
        STATS.levels += levels
        STATS.host_syncs += levels
    return (*out, levels)


def _simulate_once(tree: Tree, eval_fn: Evaluator, spec: SearchSpec,
                   out=None, eval_ctx=None):
    """One simulation for every game; updates ``tree`` in place. Returns
    its descent's results, which the next simulation takes as ``out`` and
    overwrites (``_descend``). ``eval_ctx``, if given, is passed to
    ``eval_fn`` as its second argument.

    Nothing in it is read back by the host on a CUDA tree, and nothing
    depends on a host value that changes between simulations (the slot
    lives on the device): it is what ``search/graph.py`` captures. Every
    tensor it writes outside ``out`` is a field of the tree, in place, or
    the depth accumulator of ``STATS``."""
    B = tree.root_visit.shape[0]
    A = spec.num_actions
    vdt = spec.value_dtype
    rows = tree.rows
    M = rows.shape[1]
    dev = rows.device
    slot = tree.next_slot                    # this simulation's fresh slot
    zero = torch.zeros((), dtype=vdt, device=dev)

    # (1) selection with in-loop state stepping
    with record_function("mcts.descend"):
        out = _descend(rows, tree.root_state, tree.root_visit,
                       tree.root_vsum, spec, out)
        leaf_state, needs_alloc, depth, path_nodes, path_actions, _ = out

    # (2) one batched network evaluation
    with record_function("mcts.evaluate"):
        planes = env.encoded_state(leaf_state)
        policy, value = (eval_fn(planes) if eval_ctx is None
                         else eval_fn(planes, eval_ctx))
        is_term = leaf_state.done
        value = torch.where(
            is_term, env.terminal_value_for_player_to_move(leaf_state),
            value.float()).to(vdt)

    # (3) expand the fresh slot (batch-uniform row write; games that did
    # not allocate write the slot's initial values back)
    with record_function("mcts.expand"):
        legal = env.legal_action_mask(leaf_state)
        priors = _renorm_priors(policy, legal, vdt)
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
        at = slot.view(1).long()
        if spec.tree_reuse:
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

    # (4) backprop: the recorded path top-down, every level at once; level
    # d commits [child ptr? | visit += 1 | vsum += signed value] for one
    # edge per game. Edge d's child accumulates value * (-1)^(depth-1-d)
    # (leaf mover's side at d = depth-1, flipping each ply toward the root),
    # and the allocating edge's child pointer becomes the slot.
    with record_function("mcts.backprop"):
        kernels.commit_path(rows, path_nodes, path_actions, depth,
                            needs_alloc, value, slot, (0, 2 * A, 3 * A), A)

    # Root stats: the value reaches the root flipped ``depth`` times.
    sign0 = torch.where(depth % 2 == 1, 1.0, -1.0).to(vdt)
    tree.root_visit += 1
    tree.root_vsum += -sign0 * value
    tree.node_count += needs_alloc.int()
    slot += 1

    STATS.simulations += 1
    STATS.add_depth(depth)
    return out


# -----------------------------------------------------------------------------
# Top-level search
# -----------------------------------------------------------------------------

def search(
    root_states: env.EnvState,
    eval_fn: Evaluator,
    spec: SearchSpec,
    generator: torch.Generator | None = None,
    add_noise: bool = False,
    tree: Tree | None = None,
    root_noise: torch.Tensor | None = None,
    eval_ctx=None,
    capture: bool | None = None,
) -> Tree:
    """Run ``spec.num_simulations`` simulations for a batch of games.

    ``eval_fn`` receives encoded planes and returns (policy_probs, scalar
    value). ``add_noise`` mixes Dirichlet noise drawn from ``generator``
    into the root priors; ``root_noise`` (B, A) overrides the draw
    (tests). Passing an existing ``tree`` (rooted at ``root_states``, whose
    own root state it keeps) continues it; it must have capacity for the
    total simulation count. ``eval_ctx`` (e.g. the arena's per-game
    "player A to move" flags) is passed to every ``eval_fn`` call as
    ``eval_fn(planes, eval_ctx)``. The tree is updated in place and
    returned.

    The root expansion and the noise run eagerly. On a CUDA tree the
    simulations are one captured simulation replayed ``num_simulations``
    times (``search/graph.py``; the capture is kept on the tree and
    replayed by later searches of the same tree, evaluator and spec);
    the host then reads nothing until the caller does. ``capture=False``
    runs them eagerly instead (the yardstick the captured path is held
    to); ``capture=True`` on a CPU tree raises, as a failed capture does:
    nothing falls back.
    """
    if tree is None:
        tree = init_tree(root_states, spec)
    on_card = tree.rows.device.type == "cuda"
    if capture and not on_card:
        raise ValueError(f"capture=True needs a CUDA tree; this one is on "
                         f"{tree.rows.device}")
    N = spec.num_simulations
    if tree.slot_bound + N > tree.rows.shape[1] - 1:
        raise ValueError(f"the tree has {tree.rows.shape[1] - 2} slots, its "
                         f"next fresh slot may be {tree.slot_bound}: no room "
                         f"for {N} more simulations")
    vdt = spec.value_dtype
    A = spec.num_actions

    # Root expansion (does not count a visit).
    root_planes = env.encoded_state(tree.root_state)
    policy, _ = (eval_fn(root_planes) if eval_ctx is None
                 else eval_fn(root_planes, eval_ctx))
    legal = env.legal_action_mask(tree.root_state)
    root_flat = _root_flat(tree)
    root_child = root_flat[:, :A]
    expanded = (root_child > (ILLEGAL + 0.5)).any(-1)
    need_root = (~expanded & ~tree.root_state.done)[:, None]
    child_row = torch.where(
        need_root,
        torch.where(legal, UNALLOCATED, ILLEGAL).to(vdt),
        root_child)
    prior_row = torch.where(need_root, _renorm_priors(policy, legal, vdt),
                            root_flat[:, A:2 * A])
    root_flat[:, :A] = child_row
    root_flat[:, A:2 * A] = prior_row

    if add_noise or root_noise is not None:
        if root_noise is None and generator is None:
            raise ValueError("add_noise requires a generator")
        _add_root_noise(tree, generator, spec, noise=root_noise)

    if on_card and capture is not False:
        from alphazero_torch.search import graph

        graph.run(tree, eval_fn, spec, eval_ctx)
    else:
        # One set of descent results for the whole search: the first
        # simulation makes them and every later one overwrites them, and
        # what a simulation leaves in the path past a game's depth is an
        # earlier simulation's node and action, so still in range.
        out = None
        for _ in range(N):
            out = _simulate_once(tree, eval_fn, spec, out, eval_ctx)
    tree.slot_bound += N
    return tree


def advance_root(
    tree: Tree,
    actions: torch.Tensor,
    new_root_state: env.EnvState,
    spec: SearchSpec,
    force_fresh: torch.Tensor | None = None,
) -> Tree:
    """Re-root the tree at the chosen child, preserving its subtree.

    A once-per-move compaction: mark the chosen child's subtree (binary
    lifting over the recorded parent pointers), renumber kept slots in
    ascending old-slot order (children stay after parents), and gather the
    kept rows to the front. Games whose chosen action has no allocated
    child, plus any ``force_fresh`` lanes, restart with an empty root. If
    the largest kept subtree plus the next search's allocations would
    overflow capacity, the WHOLE batch restarts from fresh roots (slot
    allocation is batch-uniform), chosen on the device as the JAX package
    chooses it. Updates ``tree`` in place (its tensors keep their
    addresses, so a captured simulation stays valid) and returns it; the
    host reads nothing.
    """
    if not spec.tree_reuse:
        raise ValueError("advance_root requires spec.tree_reuse")
    vdt = spec.value_dtype
    A = spec.num_actions
    B, M = tree.rows.shape[:2]
    dev = tree.rows.device
    slots = torch.arange(M, device=dev)
    bidx = torch.arange(B, device=dev)
    actions = actions.long()

    flat = tree.rows.view(B, M, -1)
    root_flat = flat[:, 0]
    child_a = root_flat[bidx, actions]
    ev_a = root_flat[bidx, 2 * A + actions]
    evs_a = root_flat[bidx, 3 * A + actions]

    fresh = ~(child_a > 0.5)              # no allocated child to reuse
    if force_fresh is not None:
        fresh = fresh | force_fresh
    r0 = torch.where(fresh, -1, child_a.long())

    # subtree membership: keep[s] iff the parent chain of s hits r0
    keep = slots[None, :] == r0[:, None]
    anc = tree.parents.long()
    for _ in range(max(1, (M - 1).bit_length())):
        keep = keep | keep.gather(1, anc)
        anc = anc.gather(1, anc)

    keepi = keep.long()
    new_idx = keepi.cumsum(1) - keepi                  # exclusive prefix
    new_count = keepi.sum(1)
    count_eff = torch.where(fresh, 1, new_count.clamp_min(1))

    # kept slots first, ascending old-slot order; r0 lands at slot 0
    old_of = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    new_flat = flat.gather(1, old_of[:, :, None].expand(B, M, flat.shape[2]))

    # remap child pointers (>0.5 = real slot) through the renumbering
    ptr = new_flat[:, :, :A]
    vi = ptr.clamp(0, M - 1).long()
    mapped = new_idx.gather(1, vi.reshape(B, -1)).reshape(B, M, A).to(vdt)
    new_flat[:, :, :A] = torch.where(ptr > 0.5, mapped, ptr)

    # fresh games restart with an empty, unexpanded root row
    empty_root = torch.zeros_like(new_flat[:, 0])
    empty_root[:, :A] = ILLEGAL
    new_flat[:, 0] = torch.where(fresh[:, None], empty_root, new_flat[:, 0])

    # compact + remap parent metadata; zero it beyond each game's count
    par_g = tree.parents.long().gather(1, old_of)
    par_new = new_idx.gather(1, par_g.clamp(0, M - 1))
    valid = slots[None, :] < torch.where(fresh, 1, new_count)[:, None]
    par_new = torch.where(valid, par_new, 0).int()

    next_slot = count_eff.max().clamp_min(1).int()     # () on the device
    # capacity: slots 0..M-2 usable (M-1 is the trash row); the next
    # search allocates num_simulations slots starting at next_slot; on
    # overflow every field takes its fresh tree's value
    overflow = next_slot + spec.num_simulations > M - 1
    empty_row = torch.zeros_like(flat[0, 0])
    empty_row[:A] = ILLEGAL
    torch.where(overflow, empty_row, new_flat, out=flat)
    restart = overflow | fresh
    tree.parents.copy_(torch.where(overflow, 0, par_new))
    tree.root_visit.copy_(torch.where(restart, 0, ev_a.int()))
    tree.root_vsum.copy_(torch.where(
        restart, torch.zeros((), dtype=vdt, device=dev), evs_a))
    tree.node_count.copy_(torch.where(overflow, 1, count_eff))
    tree.next_slot.copy_(torch.where(overflow, 1, next_slot))
    _copy_state(tree.root_state, new_root_state)
    # what the host knows without a read: either the search fits after the
    # kept subtrees, or the tree restarted at slot 1
    tree.slot_bound = max(1, M - 1 - spec.num_simulations)
    return tree


def sample_gamma(alpha: float, shape, generator: torch.Generator,
                 device) -> torch.Tensor:
    """Gamma(alpha, 1) float32 samples drawn from ``generator``.

    Marsaglia-Tsang (2000) for Gamma(alpha+1), times U^(1/alpha) for
    alpha < 1. Each round draws 4 candidates per element and keeps the
    first accepted; rounds repeat (one host sync each) until every
    element has one, which at alpha=0.35 almost always takes one round.
    """
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    out = torch.zeros(shape, dtype=torch.float32, device=device)
    done = torch.zeros(shape, dtype=torch.bool, device=device)
    while True:
        x = torch.randn((4,) + tuple(shape), generator=generator,
                        device=device)
        u = torch.rand((4,) + tuple(shape), generator=generator,
                       device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-30)))
        first = ok.int().argmax(0, keepdim=True)
        cand = (d * v).gather(0, first)[0]
        take = ok.any(0) & ~done
        out = torch.where(take, cand, out)
        done = done | take
        if bool(done.all()):
            break
    if alpha < 1.0:
        boost = torch.rand(shape, generator=generator, device=device)
        out = out * boost.clamp_min(1e-30) ** (1.0 / alpha)
    return out


def _add_root_noise(tree: Tree, generator: torch.Generator | None,
                    spec: SearchSpec, noise: torch.Tensor | None = None
                    ) -> Tree:
    """Mix Dirichlet(alpha) noise over legal root actions into the root
    priors, in place: prior <- (1-eps)*prior + eps*noise. Sampling
    gamma(alpha) per action and normalising over the legal subset is
    exactly a Dirichlet draw on that subset."""
    vdt = spec.value_dtype
    A = spec.num_actions
    B = tree.root_visit.shape[0]
    dev = tree.rows.device
    zero = torch.zeros((), dtype=vdt, device=dev)
    root_flat = _root_flat(tree)
    root_prior = root_flat[:, A:2 * A]
    legal = root_flat[:, :A] > (ILLEGAL + 0.5)
    if noise is None:
        gammas = sample_gamma(spec.dirichlet_alpha, (B, A), generator,
                              dev).to(vdt)
        gammas = torch.where(legal, gammas, zero)
        noise = gammas / gammas.sum(-1, keepdim=True).clamp_min(1e-30)
    else:
        noise = noise.to(device=dev, dtype=vdt)
    eps = spec.dirichlet_epsilon
    mixed = torch.where(legal, (1 - eps) * root_prior + eps * noise,
                        root_prior)
    root_flat[:, A:2 * A] = mixed
    return tree


# -----------------------------------------------------------------------------
# Reading results
# -----------------------------------------------------------------------------

def root_child_visits(tree: Tree) -> torch.Tensor:
    """(B, A) visit counts of the root's children (int32)."""
    A = tree.num_actions
    return _root_flat(tree)[:, 2 * A:3 * A].int()


def root_value(tree: Tree) -> torch.Tensor:
    """(B,) mean value of the root node (mover's side), float32."""
    v = tree.root_visit
    return torch.where(
        v > 0, tree.root_vsum / v.clamp_min(1).to(tree.root_vsum.dtype),
        torch.zeros((), dtype=tree.root_vsum.dtype,
                    device=v.device)).float()


def root_action_probs(tree: Tree, temperature) -> torch.Tensor:
    """Visit-count policy with temperature.

    ``temperature`` is a scalar or (B,): 0 -> one-hot argmax (first max),
    otherwise visits^(1/t) normalised; uniform over legal children when
    all visits are zero.
    """
    A = tree.num_actions
    root_flat = _root_flat(tree)
    visits = root_flat[:, 2 * A:3 * A].float()                 # (B, A)
    t = torch.as_tensor(temperature, dtype=torch.float32,
                        device=visits.device).expand(visits.shape[:1])[:, None]
    greedy = torch.nn.functional.one_hot(visits.argmax(-1), A).float()
    powed = visits.pow(1.0 / torch.where(t == 0, 1.0, t))
    total = powed.sum(-1, keepdim=True)
    legal = (root_flat[:, :A] > (ILLEGAL + 0.5)).float()
    n_legal = legal.sum(-1, keepdim=True).clamp_min(1)
    tempered = torch.where(total > 0, powed / total.clamp_min(1e-30),
                           legal / n_legal)
    return torch.where(t == 0, greedy, tempered)


def make_net_evaluator(net, dtype=torch.float32) -> Evaluator:
    """Evaluator closure over a net: softmax policy + WL scalar value.

    With ``dtype=torch.bfloat16`` the evaluator runs a bfloat16 copy of
    the net (activations and weights in bf16) and returns float32 policy
    and value, like the JAX package's bf16 inference.
    """
    model = net if dtype == torch.float32 else copy.deepcopy(net).to(dtype)
    model.eval()

    def eval_fn(planes: torch.Tensor):
        return policy_value_apply(model, planes.to(dtype))

    return eval_fn
