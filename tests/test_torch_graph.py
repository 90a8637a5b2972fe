"""The port's simulation without host reads, its path-form backprop, and
its capture as a CUDA graph.

(a) ``_simulate_once`` on a CPU tree reads nothing back: with the
    tensor-to-host methods made to raise, it runs (the plain per-level
    descent, the CPU's stand-in for the descent kernel, excepted: it reads
    "is any game still walking" once per level, and the kernel reads
    nothing). That body is what the card captures.
(b) The search with the slot on the device equals the JAX package's
    ``search`` bit for bit, in float64 under the toy evaluators of
    ``tests/test_mcts.py`` and ``tests/test_torch_arena.py`` and the same
    injected root noise: fresh trees reset in place move after move, tree
    reuse through ``advance_root`` (with moves whose kept subtrees overflow
    the capacity, so that the whole batch restarts), and ``eval_ctx``.
(c) ``commit_path``'s plain version equals the JAX package's
    ``commit_edges`` called once per level, as its backprop loop calls it,
    for float32 and bfloat16 trees, with games of depth 0, terminal leaves
    and the allocating edge.
(d) Asking for a capture on a CPU tree raises.
(e) ``gpu``: the captured search against the eager one on the card, bit
    for bit over consecutive moves with different roots (fresh, reuse,
    ``eval_ctx``, the web bot's batch of one); launch counts advance by
    replays; a new evaluator recaptures; a host read in the body makes
    the capture fail; the path-form kernel against its plain version.

JAX is imported only inside the CPU cases' helpers, so on a machine with a
card and without JAX the ``gpu`` cases run with
``python -m pytest --noconftest -m gpu tests/test_torch_graph.py``.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

# tiny tensors: intra-op threads only add overhead beside xdist workers
torch.set_num_threads(1)

from alphazero_torch.env import breakthrough as tenv
from alphazero_torch.env.oracle import OracleGame, live_states
from alphazero_torch.search import graph
from alphazero_torch.search import kernels as K
from alphazero_torch.search import mcts as tmcts

A = tenv.NUM_ACTIONS
OFFSETS = (0, 2 * A, 3 * A)
F64 = torch.float64
# the toy evaluators' weights, made as tests/test_mcts.py and
# tests/test_torch_arena.py make them
_BASE_W = np.random.default_rng(12345).uniform(0.5, 2.0, A).astype(
    np.float32)
_BASE_W_B = ((np.arange(A) * 3) % 7 + 1).astype(np.float32)
_SQ = (np.arange(A) // 3).astype(np.int64)
STATE_FIELDS = ("board", "turn", "winner", "done", "move_count")


@functools.cache
def _weights(device):
    # on the device once: a copy from the host could not be captured
    return tuple(torch.from_numpy(a).to(device)
                 for a in (_BASE_W, _BASE_W_B, _SQ))


def toy_eval(planes, a_to_move=None):
    """``fake_eval_jax`` of tests/test_mcts.py in torch; with
    ``a_to_move``, ``ctx_eval_torch`` of tests/test_torch_arena.py."""
    B = planes.shape[0]
    mine = planes[:, 0].reshape(B, 64)
    theirs = planes[:, 1].reshape(B, 64)
    wa, wb, sq = _weights(planes.device)
    boost = 1.0 + mine[:, sq]
    value = (mine.sum(-1) - theirs.sum(-1)) / 16.0
    if a_to_move is None:
        return (wa * boost).float(), value.float()
    return (torch.where(a_to_move[:, None], wa * boost, wb * boost).float(),
            torch.where(a_to_move, value, -value / 2).float())


def _jax():
    import jax
    import jax.numpy as jnp

    from alphazero_tpu.env import breakthrough as jenv
    from alphazero_tpu.search import mcts as jmcts

    def jax_eval(planes, a_to_move=None):
        B = planes.shape[0]
        mine = planes[:, 0].reshape(B, 64)
        theirs = planes[:, 1].reshape(B, 64)
        boost = 1.0 + mine[:, jnp.asarray(_SQ.astype(np.int32))]
        value = (mine.sum(-1) - theirs.sum(-1)) / jnp.float32(16.0)
        if a_to_move is None:
            return ((jnp.asarray(_BASE_W) * boost).astype(jnp.float32),
                    value.astype(jnp.float32))
        return (jnp.where(a_to_move[:, None], jnp.asarray(_BASE_W) * boost,
                          jnp.asarray(_BASE_W_B) * boost).astype(jnp.float32),
                jnp.where(a_to_move, value, -value / 2).astype(jnp.float32))

    return jax, jnp, jenv, jmcts, jax_eval


def _midgames(seed, n, plies=30):
    rng = np.random.default_rng(seed)
    games = [OracleGame()]
    while len(games) < n:
        g = OracleGame()
        for _ in range(int(rng.integers(0, plies))):
            if g.is_terminal():
                break
            g.step_action(int(rng.choice(g.get_legal_actions())))
        if not g.is_terminal():
            games.append(g)
    return games


def _jax_states(jnp, jenv, states):
    return jenv.EnvState(*(jnp.asarray(getattr(states, f).numpy())
                           for f in STATE_FIELDS))


def _noise(seed, states):
    rng = np.random.default_rng(seed)
    legal = tenv.legal_action_mask(states).numpy()
    noise = np.zeros((len(legal), A), np.float64)
    for i, m in enumerate(legal):
        idx = np.flatnonzero(m)
        if len(idx):
            noise[i, idx] = rng.dirichlet([0.35] * len(idx))
    return noise


def _assert_trees_equal(got, want, what):
    """A port tree against a JAX (numpy) or another port tree, whole."""
    for name in ("rows", "root_visit", "root_vsum", "node_count", "parents",
                 "next_slot"):
        a = getattr(got, name)
        b = getattr(want, name)
        a = a.cpu().numpy() if torch.is_tensor(a) else a
        b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")


# -----------------------------------------------------------------------------
# (a) the simulation reads nothing back
# -----------------------------------------------------------------------------

READS = ("item", "__int__", "__float__", "__bool__", "__index__", "tolist",
         "numpy", "cpu")


@pytest.mark.parametrize("reuse,ctx", [(False, False), (True, True)],
                         ids=["fresh", "reuse-ctx"])
def test_simulation_reads_nothing_back(monkeypatch, reuse, ctx):
    states = live_states(_midgames(3, 6), "cpu")
    spec = tmcts.SearchSpec(num_simulations=12, tree_reuse=reuse)
    a_to_move = (torch.arange(6) % 3 != 0) if ctx else None
    eval_fn = toy_eval

    def grow(patched):
        tree = tmcts.init_tree(states, spec)
        # warm-up: root expansion and two simulations, then one more that
        # makes the descent's results
        tmcts.search(states, eval_fn, tmcts.SearchSpec(
            num_simulations=2, tree_reuse=reuse), tree=tree,
            eval_ctx=a_to_move)
        out = tmcts._simulate_once(tree, eval_fn, spec, None, a_to_move)
        with patched():
            for _ in range(6):
                out = tmcts._simulate_once(tree, eval_fn, spec, out,
                                           a_to_move)
        return tree

    allowed = [False]

    def refuse(name):
        real = getattr(torch.Tensor, name)

        def method(self, *a, **kw):
            if not allowed[0]:
                raise AssertionError(f"the simulation read a tensor back "
                                     f"(Tensor.{name})")
            return real(self, *a, **kw)
        return method

    real_descend = K.descend

    def descend(*a, **kw):
        allowed[0] = True
        try:
            return real_descend(*a, **kw)
        finally:
            allowed[0] = False

    class patched:
        def __enter__(self):
            for name in READS:
                monkeypatch.setattr(torch.Tensor, name, refuse(name))
            monkeypatch.setattr(K, "descend", descend)
            tmcts.STATS.reset()

        def __exit__(self, *exc):
            levels = tmcts.STATS.levels
            monkeypatch.undo()
            # the descent's reads were counted
            assert levels >= 6

    tree = grow(patched)
    want = grow(contextlib.nullcontext)
    _assert_trees_equal(tree, want, "patched run")
    assert int(tree.root_visit[0]) == 9


# -----------------------------------------------------------------------------
# (b) the search with its slot on the device against the JAX search
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["fresh", "ctx"])
def test_reset_tree_search_equals_jax_over_moves(variant):
    """Three moves with different roots on ONE tree reset in place: each
    equal, row for row, to the JAX package's search of a fresh tree."""
    jax, jnp, jenv, jmcts, jax_eval = _jax()
    states = live_states(_midgames(11, 8), "cpu")
    N = 24
    jspec = jmcts.SearchSpec(num_simulations=N,
                             value_dtype=jnp.dtype("float64"))
    tspec = tmcts.SearchSpec(num_simulations=N, value_dtype=F64)
    tree, ptr = None, None
    with jax.enable_x64():
        jsearch = jax.jit(lambda s, n, c: jmcts.search(
            s, jax_eval, jspec, root_noise=n,
            eval_ctx=None if variant == "fresh" else c))
        for move in range(3):
            noise = _noise(move, states)
            ctx = np.asarray([(i + move) % 3 != 0 for i in range(8)])
            jtree = jsearch(_jax_states(jnp, jenv, states),
                            jnp.asarray(noise), jnp.asarray(ctx))
            tree = tmcts.init_tree(states, tspec, tree=tree)
            ptr = ptr or tree.rows.data_ptr()
            assert tree.rows.data_ptr() == ptr        # the same buffers
            tree = tmcts.search(
                states, toy_eval, tspec, tree=tree,
                root_noise=torch.from_numpy(noise),
                eval_ctx=None if variant == "fresh" else
                torch.from_numpy(ctx))
            _assert_trees_equal(tree, jtree, f"move {move}")
            actions = np.argmax(np.asarray(jmcts.root_child_visits(jtree)),
                                -1).astype(np.int32)
            states = tenv.step(states, torch.from_numpy(actions))


def test_reuse_search_equals_jax_through_overflow():
    """Tree reuse over six moves: after every search and every
    ``advance_root`` the whole tree equals the JAX package's. First-play
    urgency makes the trees deep and narrow, so that kept subtrees pass the
    capacity and ``advance_root`` restarts the whole batch on the device."""
    jax, jnp, jenv, jmcts, jax_eval = _jax()
    states = live_states(_midgames(31, 6), "cpu")
    N, moves = 16, 6
    kw = dict(num_simulations=N, tree_reuse=True, fpu_reduction=1.0)
    jspec = jmcts.SearchSpec(**kw, value_dtype=jnp.dtype("float64"))
    tspec = tmcts.SearchSpec(**kw, value_dtype=F64)
    tree = tmcts.init_tree(states, tspec)
    ptrs = [t.data_ptr() for t in (tree.rows, tree.parents, tree.next_slot,
                                   tree.root_state.board)]
    overflows = 0
    with jax.enable_x64():
        jsearch = jax.jit(lambda s, t, n: jmcts.search(
            s, jax_eval, jspec, tree=t, root_noise=n))
        jadvance = jax.jit(lambda t, a, s: jmcts.advance_root(t, a, s,
                                                              jspec))
        jstates = _jax_states(jnp, jenv, states)
        jtree = jmcts.init_tree(jstates, jspec)
        for move in range(moves):
            noise = _noise(move + 7, states)
            jtree = jsearch(jstates, jtree, jnp.asarray(noise))
            tree = tmcts.search(states, toy_eval, tspec, tree=tree,
                                root_noise=torch.from_numpy(noise))
            _assert_trees_equal(tree, jtree, f"search {move}")
            actions = np.argmax(np.asarray(jmcts.root_child_visits(jtree)),
                                -1).astype(np.int32)
            jstates = jenv.step(jstates, jnp.asarray(actions))
            states = tenv.step(states, torch.from_numpy(actions))
            jtree = jadvance(jtree, jnp.asarray(actions), jstates)
            tree = tmcts.advance_root(tree, torch.from_numpy(actions),
                                      states, tspec)
            _assert_trees_equal(tree, jtree, f"advance_root {move}")
            for f in STATE_FIELDS:
                assert torch.equal(getattr(tree.root_state, f),
                                   getattr(states, f))
            overflows += int(jtree.next_slot) == 1 and bool(
                (np.asarray(jtree.node_count) == 1).all())
    assert overflows >= 2, "no move overflowed the capacity"
    assert ptrs == [t.data_ptr() for t in (tree.rows, tree.parents,
                                           tree.next_slot,
                                           tree.root_state.board)]


def test_init_tree_resets_in_place():
    """A reset tree is a fresh tree, bit for bit, in the old buffers; a
    tree of another shape is not reused. The tree owns its root state."""
    spec = tmcts.SearchSpec(num_simulations=8, tree_reuse=True)
    states = live_states(_midgames(5, 4), "cpu")
    tree = tmcts.search(states, toy_eval, spec,
                        tree=tmcts.init_tree(states, spec))
    assert tree.slot_bound == 9
    other = tenv.step(states, tmcts.root_child_visits(tree).argmax(-1))
    ptrs = [t.data_ptr() for t in (tree.rows, tree.root_state.board)]
    again = tmcts.init_tree(other, spec, tree=tree)
    assert again is tree and again.slot_bound == 1
    assert ptrs == [t.data_ptr() for t in (tree.rows, tree.root_state.board)]
    _assert_trees_equal(again, tmcts.init_tree(other, spec), "reset")
    assert again.root_state.board.data_ptr() != other.board.data_ptr()
    assert tmcts.init_tree(live_states(_midgames(5, 2), "cpu"), spec,
                           tree=tree) is not tree
    # no room for a second search without a reset
    tmcts.search(other, toy_eval, spec, tree=again)
    tmcts.search(other, toy_eval, spec, tree=again)
    with pytest.raises(ValueError, match="no room"):
        tmcts.search(other, toy_eval, spec, tree=again)


# -----------------------------------------------------------------------------
# (c) the path-form backprop against the JAX commit_edges per level
# -----------------------------------------------------------------------------

def _path_case(B, M, dtype, seed):
    """Rows, a path per game over distinct nodes, depths with 0 among them,
    terminal leaves (no allocation) and allocating walks."""
    rng = np.random.default_rng(seed)
    N = M - 1
    rows = torch.from_numpy(rng.standard_normal((B, M, 8, 128))).to(dtype)
    depth = rng.integers(0, 10, B).astype(np.int32)
    needs_alloc = rng.random(B) < 0.6
    if B >= 3:
        depth[:3] = (0, 1, 9)
        needs_alloc[1:3] = (True, False)           # alloc at depth 1; a leaf
    else:
        depth[:] = 9
    needs_alloc &= depth > 0
    nodes = np.stack([rng.permutation(N) for _ in range(B)]).astype(np.int32)
    acts = rng.integers(0, A, (B, N)).astype(np.int32)
    value = torch.from_numpy(rng.standard_normal(B)).to(dtype)
    slot = np.int32(rng.integers(1, N))
    return rows, nodes, acts, depth, needs_alloc, value, slot


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_commit_path_plain_equals_jax_commit_edges_per_level(dtype):
    jax, jnp, _, _, _ = _jax()
    from alphazero_tpu.search import kernels as jkernels

    B, M = 12, 17
    rows, nodes, acts, depth, needs_alloc, value, slot = _path_case(
        B, M, dtype, 3)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    # the JAX package's backprop loop (mcts.py:425-451), level by level
    want = jnp.asarray(rows.float().numpy()).astype(jdt)
    jvalue = jnp.asarray(value.float().numpy()).astype(jdt)
    s = jnp.int32(slot)
    sign0 = jnp.where(depth % 2 == 1, 1.0, -1.0).astype(jdt)
    flip = jnp.ones((), jdt)
    for d in range(max(int(depth.max()), 1)):
        active = d < depth
        tgt = np.where(active, nodes[:, d], M - 1).astype(np.int32)
        alloc = active & needs_alloc & (d == depth - 1)
        upd = jnp.stack([
            jnp.where(alloc, s.astype(jdt) + 1, jnp.zeros((), jdt)),
            jnp.asarray(active).astype(jdt),
            jnp.where(active, sign0 * flip * jvalue, jnp.zeros((), jdt)),
        ], axis=-1)
        want = jkernels.commit_edges(want, jnp.asarray(tgt),
                                     jnp.asarray(acts[:, d]), upd,
                                     offsets=OFFSETS)
        flip = -flip
    got = rows.clone()
    out = K.commit_path(got, torch.from_numpy(nodes), torch.from_numpy(acts),
                        torch.from_numpy(depth),
                        torch.from_numpy(needs_alloc), value,
                        torch.tensor(slot), OFFSETS, A)
    assert out is got
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # every walked edge moved, nothing else
    moved = (got != rows).view(B, M, -1).any(-1)
    walked = np.zeros((B, M), bool)
    for b in range(B):
        walked[b, nodes[b, :depth[b]]] = True
    assert not moved[~torch.from_numpy(walked)].any()


def test_commit_path_refuses_malformed_operands():
    rows, nodes, acts, depth, needs_alloc, value, slot = _path_case(
        4, 9, torch.float32, 5)
    ok = dict(rows=rows, path_nodes=torch.from_numpy(nodes),
              path_actions=torch.from_numpy(acts),
              depth=torch.from_numpy(depth),
              needs_alloc=torch.from_numpy(needs_alloc), value=value,
              slot=torch.tensor(slot), offsets=OFFSETS, num_actions=A)
    for name, bad in (("path_nodes", ok["path_nodes"][:, :4]),
                      ("depth", ok["depth"].long()),
                      ("needs_alloc", ok["needs_alloc"].int()),
                      ("value", value.double()),
                      ("slot", ok["slot"].view(1)),
                      ("offsets", OFFSETS[:2])):
        with pytest.raises(ValueError):
            K.commit_path(**{**ok, name: bad})


# -----------------------------------------------------------------------------
# (d) no capture on the CPU
# -----------------------------------------------------------------------------

def test_capture_on_a_cpu_tree_raises():
    states = live_states(_midgames(2, 3), "cpu")
    spec = tmcts.SearchSpec(num_simulations=4)
    with pytest.raises(ValueError, match="CUDA tree"):
        tmcts.search(states, toy_eval, spec, capture=True)
    eager = tmcts.search(states, toy_eval, spec, capture=False)
    _assert_trees_equal(eager, tmcts.search(states, toy_eval, spec),
                        "capture=False on the CPU")


# -----------------------------------------------------------------------------
# (e) on the card
# -----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(state, dev):
    return tenv.EnvState(*(getattr(state, f).to(dev) for f in STATE_FIELDS))


def _moves(dev, states, spec, capture, moves=3, ctx=False, eval_fn=toy_eval):
    """``moves`` consecutive moves on one tree (reset, or re-rooted with
    tree reuse), greedy; returns each move's tree as CPU tensors."""
    tree, trees = None, []
    states = _on(states, dev)
    for move in range(moves):
        a_to_move = ((torch.arange(states.turn.shape[0], device=dev) + move)
                     % 3 != 0) if ctx else None
        if tree is None or not spec.tree_reuse:
            tree = tmcts.init_tree(states, spec, tree=tree)
        tree = tmcts.search(states, eval_fn, spec, tree=tree,
                            eval_ctx=a_to_move, capture=capture)
        trees.append({name: getattr(tree, name).cpu().clone() for name in (
            "rows", "root_visit", "root_vsum", "node_count", "parents",
            "next_slot")})
        actions = tmcts.root_child_visits(tree).argmax(-1)
        states = tenv.step(states, actions)
        if spec.tree_reuse:
            tree = tmcts.advance_root(tree, actions, states, spec)
    torch.cuda.synchronize()
    return trees, tree


def _assert_same_moves(got, want):
    for move, (g, w) in enumerate(zip(got, want)):
        for name in g:
            assert torch.equal(g[name], w[name]), f"move {move}: {name}"


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fresh", "reuse", "ctx", "bot"])
def test_cuda_captured_search_equals_eager(cuda, kind):
    B, N = {"bot": (1, 200)}.get(kind, (16, 48))
    states = live_states(_midgames(17, B), "cpu")
    spec = tmcts.SearchSpec(num_simulations=N, tree_reuse=kind == "reuse")
    ctx = kind == "ctx"
    want, _ = _moves(cuda, states, spec, False, ctx=ctx)
    counts = (K.descend.launches, K.commit_edges.launches,
              K.fetch_rows.launches)
    graph.STATS.reset()
    tmcts.STATS.reset()
    got, tree = _moves(cuda, states, spec, None, ctx=ctx)
    _assert_same_moves(got, want)
    # one capture for the three moves; replays counted as launches
    assert graph.STATS.captures == 1 and tree.captured is not None
    assert graph.STATS.replays == 3 * N - graph.WARMUP
    assert (K.descend.launches, K.commit_edges.launches,
            K.fetch_rows.launches) == (counts[0] + 3 * N,
                                       counts[1] + 3 * N, counts[2])
    assert tmcts.STATS.simulations == 3 * N
    assert tmcts.STATS.levels == 0


@pytest.mark.gpu
def test_cuda_new_evaluator_recaptures(cuda):
    states = _on(live_states(_midgames(23, 8), "cpu"), cuda)
    spec = tmcts.SearchSpec(num_simulations=16)
    other = functools.partial(toy_eval)          # another evaluator
    graph.STATS.reset()
    tree = tmcts.search(states, toy_eval, spec)
    first = tree.captured
    tree = tmcts.search(states, other, spec,
                        tree=tmcts.init_tree(states, spec, tree=tree))
    assert graph.STATS.captures == 2 and tree.captured is not first
    eager = tmcts.search(states, other, spec, capture=False)
    torch.cuda.synchronize()
    assert torch.equal(tree.rows, eager.rows)
    # the same evaluator again replays
    tmcts.search(states, other, spec,
                 tree=tmcts.init_tree(states, spec, tree=tree))
    assert graph.STATS.captures == 2


@pytest.mark.gpu
def test_cuda_host_read_in_the_body_fails_the_capture(cuda):
    states = _on(live_states(_midgames(29, 4), "cpu"), cuda)
    spec = tmcts.SearchSpec(num_simulations=8)

    def reads(planes):
        if float(planes.sum()) < 0:                    # a host read
            raise AssertionError
        return toy_eval(planes)

    stream = torch.cuda.current_stream(cuda)
    with pytest.raises(RuntimeError):
        tmcts.search(states, reads, spec)
    torch.cuda.synchronize()
    tree = tmcts.search(states, reads, spec, capture=False)
    assert int(tree.root_visit[0]) == 8
    # the failed capture left the stream as it was and the default
    # generator usable
    assert torch.cuda.current_stream(cuda) == stream
    assert torch.randn(4, device=cuda).isfinite().all()


@pytest.mark.gpu
def test_cuda_commit_path_equals_plain(cuda):
    for B, M, seed in ((12, 17, 1), (512, 802, 2), (1, 202, 3)):
        rows, nodes, acts, depth, needs_alloc, value, slot = _path_case(
            B, M, torch.float32, seed)
        args = [torch.from_numpy(a) for a in (nodes, acts, depth,
                                              needs_alloc)]
        want = K.commit_path(rows.clone(), *args, value, torch.tensor(slot),
                             OFFSETS, A)
        got = rows.to(cuda)
        launches = K.commit_edges.launches
        K.commit_path(got, *(a.to(cuda) for a in args), value.to(cuda),
                      torch.tensor(slot, device=cuda), OFFSETS, A)
        torch.cuda.synchronize()
        assert K.commit_edges.launches == launches + 1
        assert torch.equal(got.cpu(), want), (B, M)
