"""A search's simulation captured once as a CUDA graph and replayed.

The JAX package runs a self-play move as one compiled program:
``selfplay_move`` is jitted, the simulations are a ``lax.fori_loop``
(``alphazero_tpu/search/mcts.py:522-525``), and the host neither reads
nor dispatches anything per simulation. The port's counterpart: a
simulation (``mcts._simulate_once``) reads nothing back from the card and
depends on no host value that changes between simulations, so on a CUDA
tree it is captured once with ``torch.cuda.graph`` and replayed
``num_simulations`` times a move. A replay is one launch by the host for
the simulation's some 550 device kernels (bf16 evaluator) or some 280
(int8-static).

What a replay reads must lie where the capture found it:

- the tree's tensors (rows, parents, root visit and vsum, node count, the
  slot and the root state), which ``init_tree(..., tree=)`` and
  ``advance_root`` update in place and never rebind;
- the descent's results (``out``), made by the warm-up;
- a context buffer, into which every search copies its ``eval_ctx``;
- the evaluator's weights (held by the evaluator, kept alive here) and the
  depth accumulator of ``mcts.STATS`` (never rebound).

A capture is kept on the tree (``Tree.captured``) and replayed by every
later search whose key is the same: the addresses, shapes and types of
the tree's tensors, the spec, the evaluator (by identity), the context's
shape and type, the grad and inference modes and the current device.
When any of these changes, the old graph is dropped (after a device
synchronisation, so that its memory pool is not freed under a replay still
running) and the simulation is captured anew. A tree from a new
``init_tree`` call is a new capture: callers that play move after move
reset one tree in place instead.

Before a capture, ``WARMUP`` simulations of the search run eagerly on a
side stream (as PyTorch's graph notes ask, for the libraries' lazy
workspaces and the s8 conv kernel's one-time ``cudaFuncSetAttribute``);
they are real simulations, so the search still runs ``num_simulations``.
The capture is made with ``capture_error_mode="thread_local"``: the web
server captures in a handler thread while other threads run host work.

Launch counts: a replay does not pass through the kernels' Python
wrappers, so their ``.launches`` counters, as the wrappers counted them
during the capture, are taken back (a capture launches nothing) and added
once per replay. ``mcts.STATS.simulations`` is advanced by the host the
same way. The ``record_function`` spans of the stages are recorded only
at the capture.

A failed capture raises; nothing falls back to eager or to the CPU.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from alphazero_torch.env import breakthrough as env

WARMUP = 2

# the kernel wrappers whose ``.launches`` a replay adds to, by module
_COUNTED = {
    "alphazero_torch.search.kernels": ("fetch_rows", "commit_edges",
                                       "descend"),
    "alphazero_torch.models.quant": ("qconv3x3",),
    "alphazero_torch.models.fused": ("tower_forward",),
}


@dataclasses.dataclass
class GraphStats:
    """Captures made, replays launched, and the host seconds the captures
    took (each one's warm-up simulations excluded)."""

    captures: int = 0
    replays: int = 0
    capture_s: float = 0.0

    def reset(self) -> None:
        self.captures, self.replays, self.capture_s = 0, 0, 0.0


STATS = GraphStats()


def _counters() -> list:
    return [f for mod, names in _COUNTED.items() if mod in sys.modules
            for f in (getattr(sys.modules[mod], n) for n in names)
            if hasattr(f, "launches")]


def _state_tensors(state: env.EnvState) -> tuple:
    return tuple(getattr(state, f.name)
                 for f in dataclasses.fields(env.EnvState))


def _tree_tensors(tree) -> tuple:
    return (tree.rows, tree.parents, tree.root_visit, tree.root_vsum,
            tree.node_count, tree.next_slot, *_state_tensors(tree.root_state))


def _key(tree, eval_fn, spec, eval_ctx) -> tuple:
    ctx = (None if eval_ctx is None else
           (tuple(eval_ctx.shape), eval_ctx.dtype, eval_ctx.device))
    return (tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                  for t in _tree_tensors(tree)),
            spec, id(eval_fn), ctx, torch.is_grad_enabled(),
            torch.is_inference_mode_enabled(), torch.cuda.current_device())


@dataclasses.dataclass
class CapturedSimulation:
    """One captured simulation and everything its replays read."""

    key: tuple
    graph: torch.cuda.CUDAGraph
    ctx: torch.Tensor | None
    keep: tuple                  # tensors and evaluator the graph reads
    per_replay: list             # (wrapper, launches a replay makes)

    def replay(self, n: int) -> None:
        from alphazero_torch.search import mcts

        for _ in range(n):
            self.graph.replay()
        for f, k in self.per_replay:
            f.launches += n * k
        mcts.STATS.simulations += n
        STATS.replays += n


def _capture(tree, eval_fn, spec, eval_ctx, warmup: int):
    from alphazero_torch.search import mcts

    dev = tree.rows.device
    if tree.captured is not None:
        # the old graph's replays end before its memory pool is released
        torch.cuda.synchronize(dev)
        tree.captured = None
    ctx = None if eval_ctx is None else eval_ctx.clone()
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    out = None
    with torch.cuda.stream(side):
        for _ in range(warmup):
            out = mcts._simulate_once(tree, eval_fn, spec, out, ctx)
    cur.wait_stream(side)
    for t in (*_state_tensors(out[0]), *out[1:5]):
        t.record_stream(cur)

    counters = _counters()
    before = [f.launches for f in counters]
    simulations = mcts.STATS.simulations
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        mcts._simulate_once(tree, eval_fn, spec, out, ctx)
    STATS.capture_s += time.perf_counter() - t0
    STATS.captures += 1
    per_replay = [(f, f.launches - b) for f, b in zip(counters, before)]
    for f, b in zip(counters, before):
        f.launches = b
    mcts.STATS.simulations = simulations
    tree.captured = CapturedSimulation(
        key=_key(tree, eval_fn, spec, eval_ctx), graph=graph, ctx=ctx,
        keep=(_tree_tensors(tree), out, eval_fn), per_replay=per_replay)
    return tree.captured


def run(tree, eval_fn, spec, eval_ctx=None) -> None:
    """``spec.num_simulations`` simulations of the CUDA ``tree``: replays
    of its captured simulation, captured first (after ``WARMUP`` eager
    simulations of this search) if the tree has none for this key."""
    n = spec.num_simulations
    if n == 0:
        return
    cap = tree.captured
    done = 0
    if cap is None or cap.key != _key(tree, eval_fn, spec, eval_ctx):
        done = min(WARMUP, n)
        cap = _capture(tree, eval_fn, spec, eval_ctx, done)
    if cap.ctx is not None:
        cap.ctx.copy_(eval_ctx)
    cap.replay(n - done)
