"""PyTorch port's descent: one simulation's PUCT walk for every game.

``kernels.descend`` is one CUDA kernel launch on the card and the plain
per-level loop on the CPU. Here, on the CPU:

(a) the plain descent against the JAX package's ``_descend`` on trees
    that a seeded search grew from numpy-made positions;
(b) the contract of its results (the leaf state is the root state stepped
    along the recorded path);
(c) a per-game scalar transcription of the CUDA kernel's loop (numpy; the
    board from its 64 bytes into the kernel's two sets of squares, the
    kernel's thresholds, its ordered score keys reduced warp by warp as
    the kernel reduces them, its reply check) against the plain descent,
    so that the kernel's algorithm is tested where no card is;
(d) the wrapper's refusals.

Tests marked ``gpu`` hold the kernel itself against the plain descent on
the card and skip without one; they import no JAX, so on a machine with a
card and without JAX they run with
``python -m pytest --noconftest -m gpu tests/test_torch_descend.py``.

Tolerance: none. Every comparison in this file is exact (``depth``,
``needs_alloc``, every leaf-state field, and the path at ``d < depth``).
"""

import functools

import numpy as np
import pytest
import torch

# tiny tensors: intra-op threads only add overhead beside xdist workers
torch.set_num_threads(1)

from alphazero_torch.env import breakthrough as tenv
from alphazero_torch.search import kernels as K
from alphazero_torch.search import mcts as tmcts

A = 192
F32, F64 = torch.float32, torch.float64
STATE_FIELDS = ("board", "turn", "winner", "done", "move_count")


def _random_actions(rng, state):
    mask = tenv.legal_action_mask(state).numpy()
    return torch.from_numpy(np.array(
        [rng.choice(np.flatnonzero(m)) if m.any() else 0 for m in mask]))


def _positions(seed, n):
    """Positions made with numpy: the start, random midgames of up to 70
    plies, every fourth game played to its end (a finished root), and two
    boards one move from a win (terminal leaves at depth 1)."""
    rng = np.random.default_rng(seed)
    state = tenv.initial_state((n,), device="cpu")
    plies = torch.from_numpy(rng.integers(0, 70, n))
    plies[0] = 0
    to_the_end = torch.arange(n) % 4 == 1
    p = 0
    while True:
        go_on = ((p < plies) | to_the_end) & ~state.done
        if not go_on.any():
            break
        state = tenv.select_state(
            go_on, tenv.step(state, _random_actions(rng, state)), state)
        p += 1
    board = np.zeros((8, 8), np.int8)
    board[6, 3] = board[5, 6] = 1
    board[1, 0] = board[2, 5] = -1
    state.board[-2:] = torch.from_numpy(board)
    state.turn[-2:] = torch.tensor([1, -1], dtype=torch.int8)
    state.winner[-2:] = 0
    state.done[-2:] = False
    return state


_TIE_W = torch.tensor((np.arange(A) * 5) % 8 + 1, dtype=torch.float32)
_GENERIC_W = torch.from_numpy(
    np.random.default_rng(0).uniform(1, 9, A).astype(np.float32))


def _toy_eval(weights, planes: torch.Tensor):
    B = planes.shape[0]
    mine = planes[:, 0].reshape(B, 64)
    theirs = planes[:, 1].reshape(B, 64)
    # the index is made where the planes lie: a copy from the host could
    # not be captured in a CUDA graph
    w = weights * (1.0 + mine[:, torch.arange(A, device=planes.device) // 3])
    return w, (mine.sum(-1) - theirs.sum(-1)) / 16.0


# Toy evaluators with values that are multiples of 1/16: ``tie_eval`` has
# eight distinct policy weights over 192 actions, so that many legal
# siblings have equal priors; ``generic_eval`` has no two equal.
tie_eval = functools.partial(_toy_eval, _TIE_W)
generic_eval = functools.partial(_toy_eval, _GENERIC_W)


def _grown_tree(seed, n, sims, dtype, fpu, eval_fn=generic_eval):
    states = _positions(seed, n)
    spec = tmcts.SearchSpec(num_simulations=sims, fpu_reduction=fpu,
                            value_dtype=dtype)
    tree = tmcts.search(states, eval_fn, spec)
    return states, tree, spec


def _plain(tree, spec):
    return K._descend_plain(tree.rows, tree.root_state, tree.root_visit,
                            tree.root_vsum, spec.num_actions, spec.c_puct,
                            spec.fpu_reduction)


def _assert_same_descent(got, want, what=""):
    """(leaf_state, needs_alloc, depth, path_nodes, path_actions) twice,
    as numpy: equal, the paths at d < depth."""
    leaf_g, alloc_g, depth_g, nodes_g, acts_g = got
    leaf_w, alloc_w, depth_w, nodes_w, acts_w = want
    np.testing.assert_array_equal(depth_g, depth_w, err_msg=what)
    np.testing.assert_array_equal(alloc_g, alloc_w, err_msg=what)
    for name in STATE_FIELDS:
        np.testing.assert_array_equal(leaf_g[name], leaf_w[name],
                                      err_msg=f"{what} leaf {name}")
    walked = np.arange(nodes_g.shape[1])[None] < depth_g[:, None]
    np.testing.assert_array_equal(nodes_g[walked], nodes_w[walked],
                                  err_msg=what)
    np.testing.assert_array_equal(acts_g[walked], acts_w[walked],
                                  err_msg=what)


def _as_numpy(out):
    leaf, alloc, depth, nodes, acts = out[:5]
    return ({n: getattr(leaf, n).cpu().numpy() for n in STATE_FIELDS},
            alloc.cpu().numpy(), depth.cpu().numpy(), nodes.cpu().numpy(),
            acts.cpu().numpy())


# -----------------------------------------------------------------------------
# (a) the plain descent against the JAX package's _descend
# -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's search module and env, imported here so that the
    ``gpu`` cases of this file run where JAX is not installed."""
    import jax
    import jax.numpy as jnp

    from alphazero_tpu.env import breakthrough as jenv
    from alphazero_tpu.search import mcts as jmcts

    return jax, jnp, jenv, jmcts


@pytest.mark.parametrize("seed", [3, 8])
@pytest.mark.parametrize("fpu", [0.0, 0.2])
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_plain_descent_equals_jax_descend(jax_side, dtype, fpu, seed):
    jax, jnp, jenv, jmcts = jax_side
    states, tree, spec = _grown_tree(seed, 16, 40, dtype, fpu)
    root_done = states.done.numpy()
    assert root_done.any()                              # finished roots
    x64 = dtype == F64
    jspec = jmcts.SearchSpec(
        num_simulations=40, fpu_reduction=fpu,
        value_dtype=jnp.dtype("float64" if x64 else "float32"))
    with jax.enable_x64(x64):
        jstates = jenv.EnvState(**{n: jnp.asarray(getattr(states, n).numpy())
                                   for n in STATE_FIELDS})
        (_, jleaf, jalloc, jdepth, jnodes, jacts) = jax.jit(
            functools.partial(jmcts._descend, spec=jspec))(
            jnp.asarray(tree.rows.numpy()), jstates,
            jnp.asarray(tree.root_visit.numpy()),
            jnp.asarray(tree.root_vsum.numpy()))
        want = ({n: np.asarray(getattr(jleaf, n)) for n in STATE_FIELDS},
                np.asarray(jalloc), np.asarray(jdepth), np.asarray(jnodes),
                np.asarray(jacts))
    got = _as_numpy(_plain(tree, spec))
    _assert_same_descent(got, want)
    # the cases the trees must hold: walks that end on a finished game,
    # on a new edge, and on no edge at all (a finished root)
    leaf_done, alloc, depth = got[0]["done"], got[1], got[2]
    assert (leaf_done & ~root_done).any() and alloc.any()
    assert (depth[root_done] == 0).all() and (depth[~root_done] > 0).all()


# -----------------------------------------------------------------------------
# (b) the contract of descend's results, through the public wrapper
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("fpu", [0.0, 0.25])
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_leaf_state_is_root_state_stepped_along_the_path(dtype, fpu):
    _, tree, spec = _grown_tree(21, 24, 48, dtype, fpu)
    leaf, alloc, depth, nodes, acts, levels = K.descend(
        tree.rows, tree.root_state, tree.root_visit, tree.root_vsum,
        spec.num_actions, spec.c_puct, spec.fpu_reduction)
    assert levels >= int(depth.max())           # the per-level loop's count
    assert depth.dtype == torch.int32 and alloc.dtype == torch.bool
    assert nodes.shape == acts.shape == (24, spec.capacity)
    state = tree.root_state
    flat = tree.rows.view(24, spec.capacity + 1, -1)
    b = torch.arange(24)
    for d in range(int(depth.max())):
        on_path = d < depth
        # the path is a chain of child pointers from the root
        want_node = (torch.zeros(24, dtype=torch.int32) if d == 0 else
                     flat[b, nodes[:, d - 1].long(),
                          acts[:, d - 1].long()].int())
        assert torch.equal(nodes[on_path, d], want_node[on_path])
        child = flat[b, nodes[:, d].long(), acts[:, d].long()]
        assert (child[on_path] > K.ILLEGAL + 0.5).all()     # legal edges
        last = on_path & (d == depth - 1)
        assert torch.equal(child[last] == K.UNALLOCATED, alloc[last])
        state = tenv.select_state(on_path, tenv.step(state, acts[:, d]),
                                  state)
    for name in STATE_FIELDS:
        assert torch.equal(getattr(leaf, name), getattr(state, name)), name
    # a walk that did not end on a new edge ended on a finished game
    assert torch.equal(~alloc, leaf.done)


def test_descend_records_into_given_path_buffers():
    """One set of results for many calls: on the CPU the path buffers of
    ``out`` are recorded into and returned, and what lies past a game's
    depth is left as it was."""
    _, tree, spec = _grown_tree(5, 8, 24, F32, 0.0)
    args = (tree.rows, tree.root_state, tree.root_visit, tree.root_vsum,
            spec.num_actions, spec.c_puct)
    want = K.descend(*args)
    path = tuple(torch.full((8, spec.capacity), 7, dtype=torch.int32)
                 for _ in range(2))
    got = K.descend(*args, out=want[:3] + path + want[5:])
    assert got[3] is path[0] and got[4] is path[1]
    _assert_same_descent(_as_numpy(got), _as_numpy(want))
    levels = got[5]
    assert levels == want[5] >= 1
    assert (path[0][:, levels:] == 7).all() and (path[1][:, levels:] == 7).all()


def test_search_counts_levels_and_host_reads():
    """On a CPU tree every level of the plain descent is one read of a
    device value by the host; ``STATS`` counts the levels."""
    tmcts.STATS.reset()
    _grown_tree(13, 8, 16, F32, 0.0)
    st = tmcts.STATS
    assert st.simulations == 16 and st.levels >= 16


# -----------------------------------------------------------------------------
# (c) the CUDA kernel's loop, transcribed for one game, in numpy
# -----------------------------------------------------------------------------

WARP = 32
MASK64 = (1 << 64) - 1
NOT_FILE_A = 0xFEFEFEFEFEFEFEFE         # squares with col > 0
NOT_FILE_H = 0x7F7F7F7F7F7F7F7F         # squares with col < 7


def _order_keys(score):
    """The kernel's 32-bit keys, whose unsigned order is the float order of
    the scores; -0.0 is first made +0.0."""
    u = (score + np.float32(0)).astype(np.float32).view(np.uint32)
    return np.where(u >> 31 == 1, ~u, u | np.uint32(0x80000000))


def _block_argmax(score):
    """First maximum as the kernel's thread block finds it: in each warp of
    32 the maximum key and the lowest lane that holds it; then the warps in
    index order, a later one winning only with a strictly greater key."""
    keys = _order_keys(score).reshape(-1, WARP)
    best_key, best = None, None
    for w, warp in enumerate(keys):
        lane = int(np.flatnonzero(warp == warp.max())[0])
        if best_key is None or warp[lane] > best_key:
            best_key, best = warp[lane], w * WARP + lane
    return best


def _has_move(white, black, mover):
    """The kernel's reply check on whole sets of squares."""
    empty = ~(white | black) & MASK64
    if mover > 0:
        return bool(((white << 8) & empty)
                    | (((white & NOT_FILE_A) << 7) & ~white & MASK64)
                    | (((white & NOT_FILE_H) << 9) & ~white & MASK64))
    return bool(((black >> 8) & empty)
                | (((black & NOT_FILE_A) >> 9) & ~black)
                | (((black & NOT_FILE_H) >> 7) & ~black))


def _squares(board, value):
    return sum(1 << int(s) for s in np.flatnonzero(board == value))


def _kernel_move(a, turn):
    """An action as ``descend_kernel`` decodes it: the absolute squares it
    leaves and reaches, and whether it reaches the mover's far row. The
    action is (row*8 + col)*3 + dir in the mover's frame (dir 0 forward, 1
    diagonal left, 2 diagonal right); Black's frame is the board turned by
    180 degrees, square s at 63 - s."""
    sq, direction = a // 3, a % 3
    to = sq + 8 + (direction == 2) - (direction == 1)
    from_abs, to_abs = (63 - sq, 63 - to) if turn == -1 else (sq, to)
    return from_abs, to_abs, (sq >> 3) + 1 == 7


def _descend_scalar(rows, board, turn, winner, done, move_count, root_visit,
                    root_vsum, c_puct, fpu, path_width):
    """One game's walk as ``descend_kernel`` does it. rows: (M, R) float32;
    board: (64,) int8 absolute squares, kept as the kernel keeps it, as
    White's and Black's 64-bit sets of squares. Every float operation is
    one float32 operation, in the kernel's order."""
    f = np.float32
    white, black = _squares(board, 1), _squares(board, -1)
    M = rows.shape[0]
    turn, winner, done, move_count = (int(turn), int(winner), bool(done),
                                      int(move_count))
    cur, n_cur = 0, f(root_visit)
    parent_q = f(root_vsum) / f(root_visit) if root_visit > 0 else f(0)
    depth, needs_alloc, nodes, acts = 0, False, [], []
    for d in range(path_width):
        row = rows[cur]
        child, prior, ev, evs = (row[k * A:(k + 1) * A] for k in range(4))
        legal = child > f(-1.5)
        if not legal.any():
            break
        q_unvisited = parent_q - f(fpu) if fpu else f(0)
        with np.errstate(divide="ignore", invalid="ignore"):
            q = np.where(ev > 0, (-evs) / np.maximum(ev, f(1)), q_unvisited)
            cs = f(c_puct) * np.sqrt(np.maximum(n_cur, f(1)))
            u = (prior * cs) / (f(1) + ev)
            score = np.where(legal, q + u, f(-np.inf)).astype(f)
        assert q.dtype == u.dtype == f and type(cs) is f
        a = _block_argmax(score)
        nodes.append(cur)
        acts.append(a)
        alloc_here = child[a] < f(-0.5)
        if child[a] > f(-0.5):
            cur, n_cur = int(child[a]), ev[a]
            if fpu:
                parent_q = (evs[a] / np.maximum(ev[a], f(1)) if ev[a] > 0
                            else f(0))
        more = not alloc_here and d + 1 < path_width and 0 <= cur < M
        if not done:
            black_moves = turn == -1
            from_abs, to_abs, far_row = _kernel_move(a, turn)
            from_bit = 1 << from_abs
            to_bit = 1 << to_abs if 0 <= to_abs < 64 else 0
            mine, theirs = (black, white) if black_moves else (white, black)
            mine = (mine | to_bit) & ~from_bit
            theirs &= ~(to_bit | from_bit)
            white, black = (theirs, mine) if black_moves else (mine, theirs)
            mover = turn
            winner = mover if (far_row or theirs == 0) else 0
            turn = -mover
            move_count += 1
            if winner == 0 and not _has_move(white, black, turn):
                winner = mover
            done = winner != 0
        depth += 1
        if alloc_here:
            needs_alloc = True
            break
        if not more:
            break
    leaf = np.array([(white >> s & 1) - (black >> s & 1) for s in range(64)],
                    np.int8)
    return (leaf, turn, winner, done, move_count, needs_alloc, depth, nodes,
            acts)


def _scalar_descent_of_batch(tree, spec):
    B, M = tree.rows.shape[:2]
    rows = tree.rows.numpy().reshape(B, M, -1)
    s = tree.root_state
    out = [_descend_scalar(
        rows[b], s.board[b].numpy().reshape(64), s.turn[b], s.winner[b],
        s.done[b], s.move_count[b], int(tree.root_visit[b]),
        float(tree.root_vsum[b]), spec.c_puct, spec.fpu_reduction, M - 1)
        for b in range(B)]
    nodes = np.zeros((B, M - 1), np.int32)
    acts = np.zeros((B, M - 1), np.int32)
    for b, o in enumerate(out):
        nodes[b, :o[6]], acts[b, :o[6]] = o[7], o[8]
    leaf = {"board": np.stack([o[0] for o in out]).reshape(B, 8, 8),
            "turn": np.array([o[1] for o in out], np.int8),
            "winner": np.array([o[2] for o in out], np.int8),
            "done": np.array([o[3] for o in out]),
            "move_count": np.array([o[4] for o in out], np.int32)}
    return (leaf, np.array([o[5] for o in out]),
            np.array([o[6] for o in out], np.int32), nodes, acts)


@pytest.mark.parametrize("seed,sims,fpu,ties", [
    (1, 8, 0.0, True), (2, 40, 0.0, True), (4, 24, 0.25, True),
    (6, 56, 0.25, False)])
def test_kernel_transcription_equals_plain_descent(seed, sims, fpu, ties):
    """96 games a tree (384 in all); with ``ties`` the evaluator's equal
    priors tie unvisited siblings at every new node."""
    _, tree, spec = _grown_tree(seed, 96, sims, F32, fpu,
                                tie_eval if ties else generic_eval)
    want = _as_numpy(_plain(tree, spec))
    _assert_same_descent(_scalar_descent_of_batch(tree, spec), want)
    flat = tree.rows.view(96, -1, 4 * A)
    tied = sum(int(p[p > 0].unique().numel() < int((p > 0).sum()))
               for p in flat[:, 0, A:2 * A])
    assert (tied > 48) == ties           # equal priors among legal siblings


@pytest.mark.parametrize("case", ["all-equal", "two-warps", "last-lane",
                                  "visited-vs-unvisited", "none-legal"])
def test_first_maximum_on_ties(case):
    """Hand-made root rows: the plain descent and the transcription agree
    on the lowest index among equal scores, also across warps."""
    rows = torch.zeros((1, 3, 6, 128))
    flat = rows.view(1, 3, -1)
    flat[:, :, :A] = K.ILLEGAL
    # the start position, where White's legal actions leave from row 1
    # (squares 8..15, actions 24..47)
    legal = [24, 26, 31, 33, 40, 45, 46]            # 31: lane 31; 33: warp 1
    if case != "none-legal":
        flat[0, 0, legal] = K.UNALLOCATED
    want = {"all-equal": 24, "two-warps": 33, "last-lane": 31,
            "visited-vs-unvisited": 26, "none-legal": None}[case]
    if case == "all-equal":
        flat[0, 0, [A + a for a in legal]] = 0.125
    elif case == "two-warps":
        flat[0, 0, [A + a for a in legal]] = 0.05
        flat[0, 0, [A + 33, A + 40, A + 46]] = 0.25
    elif case == "last-lane":
        flat[0, 0, [A + a for a in legal]] = 0.05
        flat[0, 0, [A + 31, A + 45]] = 0.5
    elif case == "visited-vs-unvisited":
        # 24 visited with q < 0; the others unvisited and equal
        flat[0, 0, [A + a for a in legal]] = 0.125
        flat[0, 0, 2 * A + 24], flat[0, 0, 3 * A + 24] = 2.0, 1.0
    state = tenv.initial_state((1,), device="cpu")
    visit = torch.tensor([4], dtype=torch.int32)
    vsum = torch.tensor([0.5])
    leaf, alloc, depth, nodes, acts, _ = K.descend(rows, state, visit, vsum,
                                                   A, 1.5)
    scalar = _descend_scalar(flat[0].numpy(), state.board[0].numpy()
                             .reshape(64), 1, 0, False, 0, 4, 0.5, 1.5, 0.0,
                             2)
    if want is None:
        assert int(depth) == 0 == scalar[6] and not bool(alloc)
        assert torch.equal(leaf.board, state.board)
        return
    assert int(depth) == 1 == scalar[6] and bool(alloc) and scalar[5]
    assert int(acts[0, 0]) == want == scalar[8][0]
    assert int(leaf.move_count) == 1 == scalar[4] and int(leaf.turn) == -1


def test_kernel_constants_and_action_decoding_follow_the_env():
    """The kernel steps the board itself, so it carries the env's action
    encoding and board size as constants. Held against the env's own: the
    constants in the CUDA source, the file masks, and for every action and
    both sides the squares left and reached and the far-row test."""
    import pathlib
    import re

    source = (pathlib.Path(K.__file__).parents[1] / "csrc"
              / "tree_kernels.cu").read_text()
    const = {name: int(value, 0) for name, value in re.findall(
        r"constexpr \w+ (k\w+) = (0x[0-9A-Fa-f]+|\d+)", source)}
    side, squares = tenv.BOARD_SIZE, tenv.NUM_SQUARES
    assert const["kSquares"] == squares == side * side == 64
    assert const["kDescendThreads"] == tenv.NUM_ACTIONS == 3 * squares
    cols = np.arange(squares) % side
    assert const["kNotFileA"] == NOT_FILE_A == sum(
        1 << int(s) for s in np.flatnonzero(cols > 0))
    assert const["kNotFileH"] == NOT_FILE_H == sum(
        1 << int(s) for s in np.flatnonzero(cols < side - 1))
    assert (tenv.WHITE, tenv.BLACK, tenv.EMPTY) == (1, -1, 0)
    assert (K.ILLEGAL, K.UNALLOCATED) == (-2.0, -1.0)   # the -1.5 and -0.5
    on_board = 0
    for turn in (tenv.WHITE, tenv.BLACK):
        far = side - 1 if turn == tenv.WHITE else 0
        for a in range(tenv.NUM_ACTIONS):
            r, c, to_r, to_c = tenv.decode_action_to_move(a, turn)
            from_abs, to_abs, far_row = _kernel_move(a, turn)
            assert from_abs == r * side + c
            assert tenv.encode_move_to_action((r, c, to_r, to_c), turn) == a
            if 0 <= to_r < side and 0 <= to_c < side:
                on_board += 1
                assert to_abs == to_r * side + to_c
                assert far_row == (to_r == far)
    assert on_board == 2 * (side - 1) * (3 * side - 2)


def test_transcribed_reply_check_equals_legal_action_mask():
    """The kernel's reply check on sets of squares against the env's
    legal-move mask, for both sides, on random positions; and its score
    keys against the float order."""
    states = _positions(12, 64)
    mask = tenv.legal_action_mask(states).numpy()
    assert (states.turn == -1).any() and (states.turn == 1).any()
    for b in np.flatnonzero(~states.done.numpy()):
        board = states.board[b].numpy().reshape(64)
        for mover in (1, -1):
            other = tenv.EnvState(states.board[b], torch.tensor(
                mover, dtype=torch.int8), states.winner[b], states.done[b],
                states.move_count[b])
            want = bool(tenv.legal_action_mask(other).any())
            assert _has_move(_squares(board, 1), _squares(board, -1),
                             mover) == want
        assert mask[b].any()
    # a made-up position in which Black, to move, has no reply: its a2
    # is blocked by White's a1 and by its own b1, which stands on the edge
    board = np.zeros(64, np.int8)
    board[[0, 40]] = 1
    board[[8, 1]] = -1
    blocked = tenv.EnvState(
        torch.from_numpy(board.reshape(8, 8)),
        torch.tensor(-1, dtype=torch.int8), torch.tensor(0, dtype=torch.int8),
        torch.tensor(False), torch.tensor(0, dtype=torch.int32))
    assert not tenv.legal_action_mask(blocked).any()
    assert not _has_move(_squares(board, 1), _squares(board, -1), -1)
    assert _has_move(_squares(board, 1), _squares(board, -1), 1)
    s = np.array([-np.inf, -2.5, -0.0, 0.0, 1e-30, 0.75, 3.0], np.float32)
    k = _order_keys(s).astype(np.int64)
    assert (np.diff(k) >= 0).all() and k[2] == k[3]
    assert (np.diff(k) > 0).sum() == 5


# -----------------------------------------------------------------------------
# (d) what the wrapper refuses
# -----------------------------------------------------------------------------

def _meta_request(B=4, M=9):
    """A well-formed request whose tensors lie on no card: on the ``meta``
    device, which has shapes and dtypes and no storage."""
    z = functools.partial(torch.zeros, device="meta")
    state = tenv.EnvState(board=z((B, 8, 8), dtype=torch.int8),
                          turn=z((B,), dtype=torch.int8),
                          winner=z((B,), dtype=torch.int8),
                          done=z((B,), dtype=torch.bool),
                          move_count=z((B,), dtype=torch.int32))
    return {"rows": z((B, M, 6, 128)), "root_state": state,
            "root_visit": z((B,), dtype=torch.int32),
            "root_vsum": z((B,)), "num_actions": A, "c_puct": 1.5}


def _meta_out(req, **changed):
    """Well-formed results of an earlier call for ``_meta_request()``, to
    be overwritten, with the tensors of ``changed`` in their place."""
    B, M = req["rows"].shape[:2]
    z = functools.partial(torch.zeros, device="meta")
    out = {"leaf": req["root_state"],
           "needs_alloc": z((B,), dtype=torch.bool),
           "depth": z((B,), dtype=torch.int32),
           "path_nodes": z((B, M - 1), dtype=torch.int32),
           "path_actions": z((B, M - 1), dtype=torch.int32), **changed}
    return {**req, "out": tuple(out.values()) + (None,)}


def _with_state_field(req, name, value):
    fields = {n: getattr(req["root_state"], n) for n in STATE_FIELDS}
    fields[name] = value
    return {**req, "root_state": tenv.EnvState(**fields)}


REFUSED = {
    "float64-tree": (lambda r: {**r, "rows": r["rows"].double()}, TypeError,
                     "float32"),
    "bf16-tree": (lambda r: {**r, "rows": r["rows"].bfloat16()}, TypeError,
                  "float32"),
    "strided-tree": (lambda r: {**r, "rows": r["rows"][:, ::2]}, ValueError,
                     "contiguous"),
    "flat-tree": (lambda r: {**r, "rows": r["rows"].view(4, 9, -1)},
                  ValueError, "contiguous"),
    "strided-board": (lambda r: _with_state_field(
        r, "board", r["root_state"].board.transpose(1, 2)), ValueError,
        "root_state.board"),
    "done-as-bytes": (lambda r: _with_state_field(
        r, "done", r["root_state"].done.to(torch.uint8)), ValueError,
        "root_state.done"),
    "turn-int32": (lambda r: _with_state_field(
        r, "turn", r["root_state"].turn.int()), ValueError,
        "root_state.turn"),
    "visit-int64": (lambda r: {**r, "root_visit": r["root_visit"].long()},
                    ValueError, "root_visit"),
    "vsum-float64": (lambda r: {**r, "root_vsum": r["root_vsum"].double()},
                     ValueError, "root_vsum"),
    "vsum-batch": (lambda r: {**r, "root_vsum": r["root_vsum"][:3]},
                   ValueError, "root_vsum"),
    "too-many-actions": (lambda r: {**r, "num_actions": A + 1}, ValueError,
                         "num_actions"),
    "path-width": (lambda r: _meta_out(r, path_nodes=torch.zeros(
        (4, 9), dtype=torch.int32, device="meta")), ValueError,
        "out path_nodes"),
    "path-int64": (lambda r: _meta_out(r, path_actions=torch.zeros(
        (4, 8), dtype=torch.int64, device="meta")), ValueError,
        "out path_actions"),
    "out-depth-int64": (lambda r: _meta_out(r, depth=torch.zeros(
        (4,), dtype=torch.int64, device="meta")), ValueError, "out depth"),
    "out-alloc-as-bytes": (lambda r: _meta_out(r, needs_alloc=torch.zeros(
        (4,), dtype=torch.uint8, device="meta")), ValueError,
        "out needs_alloc"),
    "out-leaf-strided": (lambda r: _meta_out(r, leaf=_with_state_field(
        r, "board", r["root_state"].board.transpose(1, 2))["root_state"]),
        ValueError, "out leaf_state.board"),
    # well-formed results to overwrite are not what is refused
    "out-no-card": (_meta_out, ValueError, "CPU or CUDA"),
    "state-on-the-cpu": (lambda r: _with_state_field(
        r, "turn", torch.zeros((4,), dtype=torch.int8)), ValueError,
        "root_state.turn"),
    # well formed, but on no card: refused, never handed to the plain loop
    "no-card": (lambda r: r, ValueError, "CPU or CUDA"),
}


@pytest.mark.parametrize("bad", sorted(REFUSED))
def test_descend_refuses_off_cpu_requests_it_cannot_launch(bad, monkeypatch):
    change, exc, match = REFUSED[bad]
    plain_calls = []
    monkeypatch.setattr(K, "_descend_plain",
                        lambda *a, **k: plain_calls.append(a))
    launches = K.descend.launches
    with pytest.raises(exc, match=match):
        K.descend(**change(_meta_request()))
    assert K.descend.launches == launches and not plain_calls


def test_cuda_request_without_a_card_raises():
    """No operand of a request for the card can be made without one: the
    entry points raise, and nothing reaches ``descend``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    launches = K.descend.launches
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenv.initial_state((2,), device="cuda")
    assert K.descend.launches == launches


# -----------------------------------------------------------------------------
# (e) the kernel itself, on the card
# -----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(state, dev):
    return tenv.EnvState(*(getattr(state, n).to(dev) for n in STATE_FIELDS))


@pytest.mark.gpu
@pytest.mark.parametrize("n,sims", [(3, 24), (13, 40), (96, 56)])
@pytest.mark.parametrize("fpu", [0.0, 0.25])
@pytest.mark.parametrize("ties", [False, True])
def test_cuda_descend_equals_plain_descent(cuda, n, sims, fpu, ties):
    """A tree grown on the CPU, moved to the card: the kernel against the
    plain per-level descent there, and against the CPU's."""
    _, tree, spec = _grown_tree(n + sims, n, sims, F32, fpu,
                                tie_eval if ties else generic_eval)
    want_cpu = _as_numpy(_plain(tree, spec))
    rows = tree.rows.to(cuda)
    args = (rows, _on(tree.root_state, cuda), tree.root_visit.to(cuda),
            tree.root_vsum.to(cuda), A, spec.c_puct, spec.fpu_reduction)
    before = rows.clone()
    launches = K.descend.launches
    got = K.descend(*args)
    torch.cuda.synchronize()
    assert K.descend.launches == launches + 1
    assert torch.equal(rows, before)                    # read only
    assert got[5] is None                               # nothing was read
    _assert_same_descent(_as_numpy(got), _as_numpy(K._descend_plain(*args)))
    _assert_same_descent(_as_numpy(got), want_cpu)
    # results handed back are overwritten where they lie
    for t in (got[0].board, got[0].move_count, got[1], got[2]):
        t.fill_(1)
    again = K.descend(*args, out=got)
    assert all(a is g for a, g in zip(again, got))
    assert K.descend.launches == launches + 2
    _assert_same_descent(_as_numpy(again), want_cpu)


@pytest.mark.gpu
def test_cuda_search_is_one_descend_launch_per_simulation(cuda):
    """A search on the card: one ``descend`` and one path-form
    ``commit_edges`` launch a simulation (replays counted), no read of the
    card by the host inside it, and the CPU's tree."""
    states = _positions(2, 16)
    spec = tmcts.SearchSpec(num_simulations=32)
    cpu_tree = tmcts.search(states, tie_eval, spec)
    counts = (K.descend.launches, K.fetch_rows.launches,
              K.commit_edges.launches)
    weights = _TIE_W.to(cuda)
    tmcts.STATS.reset()
    tree = tmcts.search(_on(states, cuda),
                        lambda planes: _toy_eval(weights, planes), spec)
    torch.cuda.synchronize()
    assert (K.descend.launches, K.fetch_rows.launches,
            K.commit_edges.launches) == (counts[0] + 32, counts[1],
                                         counts[2] + 32)
    assert tmcts.STATS.simulations == 32 and tmcts.STATS.levels == 0
    assert tree.captured is not None
    assert torch.equal(tree.rows.cpu(), cpu_tree.rows)


@pytest.mark.gpu
def test_cuda_descend_raises_instead_of_falling_back(cuda, monkeypatch):
    _, tree, spec = _grown_tree(1, 4, 8, F32, 0.0)
    ok = {"rows": tree.rows.to(cuda),
          "root_state": _on(tree.root_state, cuda),
          "root_visit": tree.root_visit.to(cuda),
          "root_vsum": tree.root_vsum.to(cuda), "num_actions": A,
          "c_puct": 1.5}
    monkeypatch.setattr(K, "_descend_plain", None)
    launches = K.descend.launches
    for bad in ("float64-tree", "bf16-tree", "strided-tree", "strided-board",
                "visit-int64", "vsum-float64", "too-many-actions",
                "state-on-the-cpu"):
        change, exc, match = REFUSED[bad]
        with pytest.raises(exc, match=match):
            K.descend(**change(ok))
    assert K.descend.launches == launches
