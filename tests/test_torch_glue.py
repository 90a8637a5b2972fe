"""The simulation's glue around its evaluation: ``kernels.encode_planes``
(the leaves' network input) and ``kernels.expand`` (the evaluation's tail,
the fresh row at the device slot and the root's stats), held against the
JAX package.

(a) ``encode_planes``'s plain version equals the JAX package's
    ``encoded_state`` exactly on random-play positions, finished games
    among them.
(b) ``legal_mass`` is the kernel's order: a warp emulated lane by lane in
    numpy (six sums a lane, then xor shuffles) gives the same bits.
(c) ``renorm_priors`` against the JAX package's ``legal_action_mask`` and
    ``_renorm_priors``: the mask exactly; the priors exactly where every
    sum is exact (float64, policies of dyadic values), else within 2
    float32 or float64 ulps of the legal mass's rounding (another order of
    one sum of 192 terms), with the uniform fallback where the legal mass
    is 0.
(d) ``expand``'s plain version on numpy-drawn leaves (terminal leaves,
    games that did not allocate, zero legal mass, tree reuse on and off,
    float32 and float64 trees) against the same steps composed from the
    JAX package's functions: the written row, the parent, the root's visit
    and vsum, the node count, the depth sum and the leaf values exactly,
    the priors as in (c); nothing else in the tree moves.
(e) One simulation of a grown tree, the port's ``_simulate_once`` against
    the JAX package's, with tree reuse on and off: float64 trees equal row
    for row under the toy evaluator of ``tests/test_mcts.py``, float32
    trees equal but for the priors (as in (c)).
(f) Requests the kernels cannot take raise before any launch (meta
    tensors stand for the card's).
(g) ``gpu``: each kernel bit-equal to its plain version on the card at 1,
    2, 37 and 512 games, with tree reuse on and off; each launch counted;
    no fallback for a 16-bit tree.

JAX is imported only inside the CPU cases' helpers, so on a machine with a
card and without JAX the ``gpu`` cases run with
``python -m pytest --noconftest -m gpu tests/test_torch_glue.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

# tiny tensors: intra-op threads only add overhead beside xdist workers
torch.set_num_threads(1)

from alphazero_torch.env import breakthrough as tenv
from alphazero_torch.search import kernels as K
from alphazero_torch.search import mcts as tmcts
from alphazero_torch.strength.common import random_positions

A = tenv.NUM_ACTIONS
STATE_FIELDS = ("board", "turn", "winner", "done", "move_count")


def _jax():
    import jax
    import jax.numpy as jnp

    from alphazero_tpu.env import breakthrough as jenv
    from alphazero_tpu.search import mcts as jmcts

    return jax, jnp, jenv, jmcts


def _to_jax(state: tenv.EnvState):
    _, jnp, jenv, _ = _jax()
    return jenv.EnvState(*(jnp.asarray(getattr(state, f).numpy())
                           for f in STATE_FIELDS))


@functools.cache
def _positions(n: int, seed: int) -> tenv.EnvState:
    """``n`` random-play positions, every third played on to its end."""
    state = random_positions(n, seed, max_plies=60)
    rng = np.random.default_rng(seed + 1)
    finish = torch.from_numpy(np.arange(n) % 3 == 1)
    while bool((finish & ~state.done).any()):
        mask = tenv.legal_action_mask(state).numpy()
        acts = np.array([rng.choice(np.flatnonzero(m)) if m.any() else 0
                         for m in mask])
        state = tenv.select_state(finish & ~state.done,
                                  tenv.step(state, torch.from_numpy(acts)),
                                  state)
    return state


def _on(state: tenv.EnvState, dev) -> tenv.EnvState:
    return tenv.EnvState(*(getattr(state, f).to(dev) for f in STATE_FIELDS))


# -----------------------------------------------------------------------------
# (a) encode_planes
# -----------------------------------------------------------------------------

def test_encode_planes_plain_equals_jax_encoded_state():
    _, _, jenv, _ = _jax()
    state = _positions(48, 3)
    assert bool(state.done.any()) and bool((state.turn == -1).any())
    want = np.asarray(jenv.encoded_state(_to_jax(state)))
    got = K.encode_planes(state)
    assert got.dtype == torch.float32 and got.shape == (48, 3, 8, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    out = torch.full((48, 3, 8, 8), 7.0)
    assert K.encode_planes(state, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)


# -----------------------------------------------------------------------------
# (b) the legal mass's order
# -----------------------------------------------------------------------------

def _warp_mass(masked: np.ndarray) -> np.ndarray:
    """The kernel's sum, lane by lane: lane l adds entries l + 32k for
    k = 0..5, then five xor shuffles, each lane adding its partner's."""
    lanes = masked.reshape(masked.shape[0], A // 32, 32)
    s = lanes[:, 0].copy()
    for k in range(1, A // 32):
        s = s + lanes[:, k]
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, np.arange(32) ^ off]
    assert (s == s[:, :1]).all()                  # every lane agrees
    return s[:, :1]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_legal_mass_is_the_kernels_order(dtype):
    rng = np.random.default_rng(5)
    masked = (rng.random((64, A)) ** 8 * (rng.random((64, A)) < 0.3)
              ).astype(dtype)
    masked[:4] = 0
    got = K.legal_mass(torch.from_numpy(masked)).numpy()
    np.testing.assert_array_equal(got, _warp_mass(masked))
    # another order of the same sum: within a few ulps
    np.testing.assert_allclose(got[:, 0], masked.sum(-1, dtype=np.float64),
                               rtol=8 * np.finfo(dtype).eps)
    # 16-bit types sum in float32 and round once
    half = torch.from_numpy(masked).bfloat16()
    assert torch.equal(K.legal_mass(half),
                       K.legal_mass(half.float()).bfloat16())


# -----------------------------------------------------------------------------
# (c) renorm_priors against the JAX package
# -----------------------------------------------------------------------------

def _policies(B: int, seed: int, dyadic: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dyadic:
        policy = rng.integers(1, 9, (B, A)) / 16.0
    else:
        policy = rng.dirichlet([0.3] * A, B)
    policy[::5] = 0.0                                 # no legal mass
    return policy.astype(np.float32)


@pytest.mark.parametrize("dtype,dyadic", [(torch.float64, True),
                                          (torch.float64, False),
                                          (torch.float32, False)])
def test_renorm_priors_against_jax(dtype, dyadic):
    jax, jnp, jenv, jmcts = _jax()
    state = _positions(48, 7)
    policy = _policies(48, 8, dyadic)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    with jax.enable_x64(dtype == torch.float64):
        jlegal = jenv.legal_action_mask(_to_jax(state))
        want = np.asarray(jmcts._renorm_priors(jnp.asarray(policy), jlegal,
                                               jdt))
    legal = tenv.legal_action_mask(state)
    np.testing.assert_array_equal(legal.numpy(), np.asarray(jlegal))
    got = K.renorm_priors(torch.from_numpy(policy), legal, dtype).numpy()
    assert got.dtype == want.dtype
    if dyadic:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2 * np.finfo(got.dtype).eps,
                                   atol=0)
    # uniform over the legal actions where the mass is 0, none if finished
    ones = legal[::5].numpy().astype(got.dtype)
    np.testing.assert_array_equal(
        got[::5], ones / np.maximum(ones.sum(-1, keepdims=True), 1))


# -----------------------------------------------------------------------------
# (d) expand's plain version against the JAX package's steps
# -----------------------------------------------------------------------------

def _expand_case(B: int, M: int, dtype, tree_reuse: bool, seed: int,
                 dev="cpu"):
    """A tree with random rows and root stats, and one simulation's leaves:
    random-play positions (finished games among them), random
    ``needs_alloc`` (never for a finished leaf's own descent's sake: any
    game may be told it allocated), depths, paths, policies (some with no
    legal mass) and values."""
    rng = np.random.default_rng(seed)
    N = M - 1
    spec = tmcts.SearchSpec(num_simulations=(N - 1) // 2 if tree_reuse
                            else N - 1, tree_reuse=tree_reuse,
                            value_dtype=dtype)
    tree = tmcts.init_tree(_on(_positions(B, seed), dev), spec)
    assert tree.rows.shape[1] == M
    tree.rows.copy_(torch.from_numpy(rng.standard_normal(
        tuple(tree.rows.shape))).to(dtype))
    tree.parents.copy_(torch.from_numpy(rng.integers(0, N, (B, M))))
    tree.root_visit.copy_(torch.from_numpy(rng.integers(0, 90, B)))
    tree.root_vsum.copy_(torch.from_numpy(rng.standard_normal(B)))
    tree.node_count.copy_(torch.from_numpy(rng.integers(1, N, B)))
    tree.next_slot.fill_(int(rng.integers(1, N)))
    leaf = _on(_positions(B, seed + 11), dev)
    depth = rng.integers(0, 7, B).astype(np.int32)
    depth[:2] = (0, 1)[:B]
    needs_alloc = (rng.random(B) < 0.7) & (depth > 0)
    return dict(
        tree=tree, leaf_state=leaf,
        needs_alloc=torch.from_numpy(needs_alloc).to(dev),
        depth=torch.from_numpy(depth).to(dev),
        path_nodes=torch.from_numpy(
            rng.integers(0, N, (B, N)).astype(np.int32)).to(dev),
        policy=torch.from_numpy(_policies(B, seed + 3, False)).to(dev),
        value=torch.from_numpy(
            rng.uniform(-1, 1, B).astype(np.float32)).to(dev),
        tree_reuse=tree_reuse,
        depth_sum=torch.zeros((), dtype=torch.int64, device=dev))


def _snapshot(case):
    t = case["tree"]
    return {f: getattr(t, f).clone() for f in
            ("rows", "parents", "root_visit", "root_vsum", "node_count",
             "next_slot")} | {"depth_sum": case["depth_sum"].clone()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tree_reuse", [False, True])
def test_expand_plain_against_jax_steps(dtype, tree_reuse):
    jax, jnp, jenv, jmcts = _jax()
    B, M = 40, 14
    case = _expand_case(B, M, dtype, tree_reuse, 21)
    before = _snapshot(case)
    leaf = case["leaf_state"]
    needs_alloc = case["needs_alloc"].numpy()
    depth = case["depth"].numpy()
    assert leaf.done.any() and (~needs_alloc).any()
    assert (leaf.done.numpy() & needs_alloc).any()        # terminal + alloc

    got = K.expand(**case)

    # the JAX package's steps (mcts.py:371-420, 453-464)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    with jax.enable_x64(dtype == torch.float64):
        jleaf = _to_jax(leaf)
        is_term = np.asarray(jleaf.done)
        value = np.asarray(jnp.where(
            jleaf.done, jenv.terminal_value_for_player_to_move(jleaf),
            jnp.asarray(case["value"].numpy())).astype(jdt))
        legal = jenv.legal_action_mask(jleaf)
        priors = np.asarray(jmcts._renorm_priors(
            jnp.asarray(case["policy"].numpy()), legal, jdt))
        legal = np.asarray(legal)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), value)

    tree = case["tree"]
    s = int(before["next_slot"])
    flat = tree.rows.view(B, M, -1).numpy()
    old = before["rows"].view(B, M, -1).numpy()
    do_expand = (needs_alloc & ~is_term)[:, None]
    np.testing.assert_array_equal(
        flat[:, s, :A], np.where(do_expand & legal, -1.0, -2.0))
    want_prior = np.where(do_expand, priors, 0.0)
    np.testing.assert_allclose(flat[:, s, A:2 * A], want_prior,
                               rtol=2 * np.finfo(flat.dtype).eps, atol=0)
    np.testing.assert_array_equal(flat[:, s, A:2 * A] == 0, want_prior == 0)
    rest = flat[:, s, 2 * A:]
    np.testing.assert_array_equal(rest, 0 if tree_reuse else old[:, s, 2 * A:])
    others = np.arange(M) != s
    np.testing.assert_array_equal(flat[:, others], old[:, others])

    par = before["parents"].numpy().copy()
    if tree_reuse:
        nodes = case["path_nodes"].numpy()
        par[:, s] = np.where(needs_alloc,
                             nodes[np.arange(B), np.maximum(depth - 1, 0)], 0)
    np.testing.assert_array_equal(tree.parents.numpy(), par)
    np.testing.assert_array_equal(tree.root_visit.numpy(),
                                  before["root_visit"].numpy() + 1)
    sign0 = np.where(depth % 2 == 1, 1.0, -1.0).astype(value.dtype)
    np.testing.assert_array_equal(tree.root_vsum.numpy(),
                                  before["root_vsum"].numpy() - sign0 * value)
    np.testing.assert_array_equal(tree.node_count.numpy(),
                                  before["node_count"].numpy() + needs_alloc)
    assert int(case["depth_sum"]) == int(depth.sum())
    assert int(tree.next_slot) == s               # the caller's increment


# -----------------------------------------------------------------------------
# (e) one simulation against the JAX package's
# -----------------------------------------------------------------------------

def _fake_eval_torch(planes):
    from tests.test_torch_mcts import fake_eval_torch

    return fake_eval_torch(planes)


def _from_jax_tree(jtree, dtype) -> tmcts.Tree:
    t = lambda x, dt=None: torch.from_numpy(np.array(x)).to(
        dt) if dt else torch.from_numpy(np.array(x))
    return tmcts.Tree(
        rows=t(jtree.rows, dtype), n_actions=A,
        root_state=tenv.EnvState(*(t(getattr(jtree.root_state, f))
                                   for f in STATE_FIELDS)),
        root_visit=t(jtree.root_visit), root_vsum=t(jtree.root_vsum, dtype),
        node_count=t(jtree.node_count), next_slot=t(jtree.next_slot),
        parents=t(jtree.parents), slot_bound=int(jtree.next_slot))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("tree_reuse", [False, True])
def test_one_simulation_equals_jax_simulate_once(dtype, tree_reuse):
    jax, jnp, jenv, jmcts = _jax()
    from tests.test_mcts import fake_eval_jax

    games, sims = 24, 24
    state = _positions(games, 31)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    spec = jmcts.SearchSpec(num_simulations=sims, tree_reuse=tree_reuse,
                            value_dtype=jnp.dtype(jdt))
    with jax.enable_x64(dtype == torch.float64):
        # a tree with room for one simulation more than its search ran
        room = jmcts.init_tree(_to_jax(state), dataclasses.replace(
            spec, num_simulations=sims + 1))
        start = jax.jit(functools.partial(
            jmcts.search, eval_fn=fake_eval_jax, spec=spec))(
            _to_jax(state), tree=room)
        want = jax.jit(functools.partial(
            jmcts._simulate_once, eval_fn=fake_eval_jax, spec=spec))(start)
    tree = _from_jax_tree(start, dtype)
    tspec = tmcts.SearchSpec(num_simulations=sims, tree_reuse=tree_reuse,
                             value_dtype=dtype)
    out = tmcts._simulate_once(tree, _fake_eval_torch, tspec)
    leaf, needs_alloc = out[0], out[1]
    assert bool(leaf.done.any()) and bool((~needs_alloc).any())
    for f in ("parents", "root_visit", "node_count", "next_slot"):
        np.testing.assert_array_equal(getattr(tree, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_array_equal(tree.root_vsum.numpy(),
                                  np.asarray(want.root_vsum))
    rows = tree.rows.view(games, -1, tree.rows.shape[2] * 128).numpy()
    wrows = np.asarray(want.rows).reshape(rows.shape)
    if dtype == torch.float64:
        np.testing.assert_array_equal(rows, wrows)
    else:
        prior = np.zeros(rows.shape[2], bool)
        prior[A:2 * A] = True
        np.testing.assert_array_equal(rows[..., ~prior], wrows[..., ~prior])
        np.testing.assert_allclose(rows[..., prior], wrows[..., prior],
                                   rtol=2 * np.finfo(np.float32).eps, atol=0)


# -----------------------------------------------------------------------------
# (f) requests the kernels cannot take
# -----------------------------------------------------------------------------

def _meta(case):
    tree = case["tree"]
    meta = lambda t: t.to("meta")
    return dict(case, tree=dataclasses.replace(
        tree, rows=meta(tree.rows), parents=meta(tree.parents),
        root_visit=meta(tree.root_visit), root_vsum=meta(tree.root_vsum),
        node_count=meta(tree.node_count), next_slot=meta(tree.next_slot)),
        leaf_state=_on(case["leaf_state"], "meta"),
        **{k: meta(case[k]) for k in ("needs_alloc", "depth", "path_nodes",
                                      "policy", "value", "depth_sum")})


def _with_tree(case, **fields):
    return dict(case, tree=dataclasses.replace(case["tree"], **fields))


def _with_leaf(case, **fields):
    return dict(case, leaf_state=dataclasses.replace(case["leaf_state"],
                                                     **fields))


EXPAND_REFUSED = {
    "bf16-tree": (lambda c: _with_tree(c, rows=c["tree"].rows.bfloat16()),
                  TypeError, "float32"),
    "strided-tree": (lambda c: _with_tree(c, rows=c["tree"].rows[:, ::2]),
                     ValueError, "contiguous"),
    "short-rows": (lambda c: _with_tree(
        c, rows=c["tree"].rows[:, :, :2].contiguous()),
                   ValueError, "four blocks"),
    "parents-int64": (lambda c: _with_tree(c, parents=c["tree"].parents.long()),
                      ValueError, "parents"),
    "slot-shape": (lambda c: _with_tree(c, next_slot=c["tree"].next_slot.view(1)),
                   ValueError, "next_slot"),
    "done-as-bytes": (lambda c: _with_leaf(
        c, done=c["leaf_state"].done.to(torch.uint8)), ValueError,
        "leaf_state.done"),
    "strided-board": (lambda c: _with_leaf(
        c, board=c["leaf_state"].board.transpose(1, 2)), ValueError,
        "leaf_state.board"),
    "depth-int64": (lambda c: dict(c, depth=c["depth"].long()), ValueError,
                    "depth"),
    "path-width": (lambda c: dict(c, path_nodes=c["path_nodes"][:, :5]),
                   ValueError, "path_nodes"),
    "policy-width": (lambda c: dict(c, policy=c["policy"][:, :100]),
                     ValueError, "policy"),
    "depth-sum-int32": (lambda c: dict(c, depth_sum=c["depth_sum"].int()),
                        ValueError, "depth_sum"),
    "not-a-card": (lambda c: c, ValueError, "CPU or CUDA"),
}


@pytest.mark.parametrize("bad", sorted(EXPAND_REFUSED))
def test_expand_refuses_requests_it_cannot_launch(bad, monkeypatch):
    change, exc, match = EXPAND_REFUSED[bad]
    monkeypatch.setattr(K, "_expand_plain", None)
    case = _meta(_expand_case(4, 14, torch.float32, True, 61))
    launches = K.expand.launches
    with pytest.raises(exc, match=match):
        K.expand(**change(case))
    assert K.expand.launches == launches


@pytest.mark.parametrize("bad,match", [
    ("turn-int32", "state.turn"), ("strided-board", "state.board"),
    ("out-float64", "out"), ("not-a-card", "CPU or CUDA")])
def test_encode_planes_refuses_requests_it_cannot_launch(bad, match):
    state = _on(_positions(4, 3), "meta")
    out = None
    if bad == "turn-int32":
        state = dataclasses.replace(state, turn=state.turn.int())
    elif bad == "strided-board":
        state = dataclasses.replace(state, board=state.board.transpose(1, 2))
    elif bad == "out-float64":
        out = torch.empty((4, 3, 8, 8), dtype=torch.float64, device="meta")
    launches = K.encode_planes.launches
    with pytest.raises(ValueError, match=match):
        K.encode_planes(state, out=out)
    assert K.encode_planes.launches == launches


# -----------------------------------------------------------------------------
# (g) the kernels on the card
# -----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2, 37, 512])
def test_cuda_encode_planes_equals_plain(cuda, B):
    state = _on(_positions(B, 41), cuda)
    launches = K.encode_planes.launches
    got = K.encode_planes(state)
    torch.cuda.synchronize()
    assert K.encode_planes.launches == launches + 1
    assert torch.equal(got, tenv.encoded_state(state))
    out = torch.full_like(got, 7.0)
    assert K.encode_planes(state, out=out) is out
    assert torch.equal(out, got)


@pytest.mark.gpu
@pytest.mark.parametrize("tree_reuse", [False, True])
@pytest.mark.parametrize("B", [1, 2, 37, 512])
def test_cuda_expand_equals_plain(cuda, B, tree_reuse):
    kernel = _expand_case(B, 14, torch.float32, tree_reuse, 51, dev=cuda)
    plain = _expand_case(B, 14, torch.float32, tree_reuse, 51, dev=cuda)
    launches = K.expand.launches
    got = K.expand(**kernel)
    want = K._expand_plain(**plain)
    torch.cuda.synchronize()
    assert K.expand.launches == launches + 1
    assert got.dtype == torch.float32 and torch.equal(got, want)
    g, w = _snapshot(kernel), _snapshot(plain)
    for f in g:
        assert torch.equal(g[f], w[f]), f


@pytest.mark.gpu
def test_cuda_expand_raises_for_a_16_bit_tree(cuda, monkeypatch):
    monkeypatch.setattr(K, "_expand_plain", None)
    case = _expand_case(3, 14, torch.float32, False, 71, dev=cuda)
    launches = K.expand.launches
    with pytest.raises(TypeError, match="float32"):
        K.expand(**_with_tree(case, rows=case["tree"].rows.bfloat16()))
    assert K.expand.launches == launches


@functools.cache
def _dyadic_weights(device):
    return (torch.tensor((np.arange(A) * 5) % 8 + 1, dtype=torch.float32,
                         device=device),
            torch.arange(A, device=device) // 3)


def _dyadic_eval(planes):
    """A toy evaluator whose every sum the search takes is exact in any
    order (integer weights, values in sixteenths), its constants on the
    planes' device, so that a card's search equals the CPU's bit for bit."""
    B = planes.shape[0]
    mine = planes[:, 0].reshape(B, 64)
    theirs = planes[:, 1].reshape(B, 64)
    weights, squares = _dyadic_weights(planes.device)
    return (weights * (1.0 + mine[:, squares]),
            (mine.sum(-1) - theirs.sum(-1)) / 16.0)


@pytest.mark.gpu
def test_cuda_search_launches_each_glue_kernel_once_a_simulation(cuda):
    state = _positions(6, 81)
    spec = tmcts.SearchSpec(num_simulations=24, tree_reuse=True)
    cpu_tree = tmcts.search(state, _dyadic_eval, spec)
    counts = K.encode_planes.launches, K.expand.launches
    tree = tmcts.search(_on(state, cuda), _dyadic_eval, spec)
    torch.cuda.synchronize()
    assert (K.encode_planes.launches, K.expand.launches) == (
        counts[0] + 24, counts[1] + 24)
    assert tree.captured is not None
    for f in ("rows", "parents", "root_visit", "root_vsum", "node_count",
              "next_slot"):
        assert torch.equal(getattr(tree, f).cpu(), getattr(cpu_tree, f)), f
