"""PyTorch port's MCTS held against the JAX package's search.

Both searches run on the CPU in float64 under the same float32-exact toy
evaluator (tests/test_mcts.py) and the same injected root noise, made with
numpy; visit counts must be EQUAL, and fresh trees equal row for row.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# tiny tensors: intra-op threads only add overhead beside xdist workers
torch.set_num_threads(1)
from scipy import stats as sps

from alphazero_tpu.env import NUM_ACTIONS, OracleGame
from alphazero_tpu.env import breakthrough as jenv
from alphazero_tpu.search import mcts as jmcts
from tests.test_mcts import (
    _BASE_W,
    _SQ_OF_ACTION,
    fake_eval_jax,
    random_midgame,
    states_from_games,
)

from alphazero_torch.config import tiny_config
from alphazero_torch.env import breakthrough as tenv
from alphazero_torch.models.network import build_network
from alphazero_torch.search import mcts as tmcts

F64 = torch.float64


def fake_eval_torch(planes: torch.Tensor):
    """Torch twin of tests/test_mcts.py:fake_eval_jax."""
    B = planes.shape[0]
    mine = planes[:, 0].reshape(B, 64)
    theirs = planes[:, 1].reshape(B, 64)
    w = torch.from_numpy(_BASE_W).to(planes.device) * (
        1.0 + mine[:, torch.from_numpy(_SQ_OF_ACTION).long()])
    value = (mine.sum(-1) - theirs.sum(-1)) / 16.0
    return w.float(), value.float()


def torch_states_from_games(games) -> tenv.EnvState:
    return tenv.EnvState(
        board=torch.tensor(np.stack([g.board for g in games]),
                           dtype=torch.int8),
        turn=torch.tensor([g.turn for g in games], dtype=torch.int8),
        winner=torch.tensor([g.winner for g in games], dtype=torch.int8),
        done=torch.tensor([g.is_terminal() for g in games]),
        move_count=torch.tensor([g.move_count for g in games],
                                dtype=torch.int32),
    )


def _games(seed, n, plies=40):
    rng = np.random.default_rng(seed)
    games = [OracleGame()] + [random_midgame(rng, plies)
                              for _ in range(n - 1)]
    return [g if not g.is_terminal() else OracleGame() for g in games]


def _noise(seed, games):
    rng = np.random.default_rng(seed)
    noise = np.zeros((len(games), NUM_ACTIONS), np.float64)
    for i, g in enumerate(games):
        legal = np.flatnonzero(g.get_legal_action_mask())
        noise[i, legal] = rng.dirichlet([0.35] * len(legal))
    return noise


def _jax_search(games, num_sims, noise=None, fpu=0.0):
    spec = jmcts.SearchSpec(num_simulations=num_sims, fpu_reduction=fpu,
                            value_dtype=jnp.dtype("float64"))
    with jax.enable_x64():
        tree = jax.jit(functools.partial(
            jmcts.search, eval_fn=fake_eval_jax, spec=spec))(
            states_from_games(games),
            root_noise=None if noise is None else jnp.asarray(noise))
        return (np.asarray(jmcts.root_child_visits(tree)),
                np.asarray(tree.rows), np.asarray(tree.root_vsum))


def _torch_search(games, num_sims, noise=None, fpu=0.0):
    spec = tmcts.SearchSpec(num_simulations=num_sims, fpu_reduction=fpu,
                            value_dtype=F64)
    tree = tmcts.search(
        torch_states_from_games(games), fake_eval_torch, spec,
        root_noise=None if noise is None else torch.from_numpy(noise))
    return tree


@pytest.mark.parametrize("variant", ["plain", "noise", "fpu"])
def test_visit_counts_and_rows_equal_jax_search(variant):
    games = _games({"plain": 42, "noise": 7, "fpu": 11}[variant], 16)
    noise = _noise(3, games) if variant == "noise" else None
    fpu = 0.2 if variant == "fpu" else 0.0
    num_sims = 48
    j_visits, j_rows, j_vsum = _jax_search(games, num_sims, noise, fpu)
    tree = _torch_search(games, num_sims, noise, fpu)
    np.testing.assert_array_equal(
        tmcts.root_child_visits(tree).numpy(), j_visits)
    # the whole fused tree, trash row included, row for row
    np.testing.assert_array_equal(tree.rows.numpy(), j_rows)
    np.testing.assert_array_equal(tree.root_vsum.numpy(), j_vsum)
    assert (tree.root_visit == num_sims).all()


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_backprop_is_one_stacked_commit_per_simulation(monkeypatch, dtype):
    """A simulation's whole backprop is one ``commit_path`` call on the
    descent's own outputs (every level at once, the slot on the device),
    and the tree is the one that a ``commit_edges`` call per level leaves:
    the JAX package's backprop loop (mcts.py:425-451)."""
    games = _games(19, 8)
    spec = tmcts.SearchSpec(num_simulations=24, value_dtype=dtype)
    real = tmcts.kernels.commit_path
    calls = []

    def path(rows, nodes, acts, depth, needs_alloc, value, slot, offsets,
             num_actions):
        calls.append((tuple(nodes.shape), tuple(acts.shape), nodes.dtype,
                      depth.dtype, needs_alloc.dtype, value.dtype,
                      tuple(slot.shape), slot.dtype, tuple(offsets)))
        return real(rows, nodes, acts, depth, needs_alloc, value, slot,
                    offsets, num_actions)

    def per_level(rows, nodes, acts, depth, needs_alloc, value, slot,
                  offsets, num_actions):
        M = rows.shape[1]
        sign0 = torch.where(depth % 2 == 1, 1.0, -1.0).to(dtype)
        zero = torch.zeros((), dtype=dtype)
        flip = 1.0
        for d in range(int(depth.max())):
            active = d < depth
            is_alloc = active & needs_alloc & (depth - 1 == d)
            upd = torch.stack([
                torch.where(is_alloc, (slot + 1).to(dtype), zero),
                active.to(dtype),
                torch.where(active, sign0 * flip * value, zero)], dim=-1)
            tmcts.kernels.commit_edges(
                rows, torch.where(active, nodes[:, d], M - 1).int(),
                acts[:, d].contiguous(), upd, offsets, num_actions)
            flip = -flip
        return rows

    monkeypatch.setattr(tmcts.kernels, "commit_path", path)
    tmcts.STATS.reset()
    tree = tmcts.search(torch_states_from_games(games), fake_eval_torch, spec)
    st = tmcts.STATS
    assert len(calls) == 24 == st.simulations
    # on a CPU tree the plain descent reads once per level
    assert st.levels >= 24 and st.depth_sum > 0
    N = spec.capacity
    assert set(calls) == {((8, N), (8, N), torch.int32, torch.int32,
                           torch.bool, dtype, (), torch.int32,
                           (0, 2 * NUM_ACTIONS, 3 * NUM_ACTIONS))}
    monkeypatch.setattr(tmcts.kernels, "commit_path", per_level)
    tree_l = tmcts.search(torch_states_from_games(games), fake_eval_torch,
                          spec)
    assert torch.equal(tree.rows, tree_l.rows)
    assert torch.equal(tree.root_vsum, tree_l.root_vsum)


def test_multi_move_tree_reuse_equals_jax():
    """advance_root parity over 4 argmax moves with per-move noise
    (tests/test_tree_reuse.py protocol)."""
    games = _games(31, 8, plies=20)
    num_sims, num_moves = 32, 4
    rng = np.random.default_rng(5)
    noise = rng.dirichlet([0.35] * NUM_ACTIONS, size=(num_moves, len(games)))

    jspec = jmcts.SearchSpec(num_simulations=num_sims, tree_reuse=True,
                             value_dtype=jnp.dtype("float64"))
    tspec = tmcts.SearchSpec(num_simulations=num_sims, tree_reuse=True,
                             value_dtype=F64)
    jsearch = jax.jit(functools.partial(jmcts.search, eval_fn=fake_eval_jax,
                                        spec=jspec))
    jadvance = jax.jit(functools.partial(jmcts.advance_root, spec=jspec))
    jstep = jax.jit(jenv.step)

    tstates = torch_states_from_games(games)
    ttree = tmcts.init_tree(tstates, tspec)
    with jax.enable_x64():
        jstates = states_from_games(games)
        jtree = jmcts.init_tree(jstates, jspec)
        for mv in range(num_moves):
            jtree = jsearch(jstates, rng=None, tree=jtree,
                            root_noise=jnp.asarray(noise[mv]))
            ttree = tmcts.search(tstates, fake_eval_torch, tspec, tree=ttree,
                                 root_noise=torch.from_numpy(noise[mv]))
            jv = np.asarray(jmcts.root_child_visits(jtree))
            np.testing.assert_array_equal(
                tmcts.root_child_visits(ttree).numpy(), jv,
                err_msg=f"move {mv}")
            actions = np.argmax(jv, axis=-1).astype(np.int32)
            jstates = jstep(jstates, jnp.asarray(actions))
            tstates = tenv.step(tstates, torch.from_numpy(actions))
            jtree = jadvance(jtree, jnp.asarray(actions), jstates)
            ttree = tmcts.advance_root(ttree, torch.from_numpy(actions),
                                       tstates, tspec)
            np.testing.assert_array_equal(ttree.rows.numpy(),
                                          np.asarray(jtree.rows))
            np.testing.assert_array_equal(ttree.parents.numpy(),
                                          np.asarray(jtree.parents))
            np.testing.assert_array_equal(ttree.node_count.numpy(),
                                          np.asarray(jtree.node_count))
            assert ttree.next_slot == int(jtree.next_slot)


def test_force_fresh_resets_lane():
    games = _games(9, 4, plies=12)
    spec = tmcts.SearchSpec(num_simulations=16, tree_reuse=True)
    states = torch_states_from_games(games)
    tree = tmcts.search(states, fake_eval_torch, spec,
                        tree=tmcts.init_tree(states, spec))
    actions = tmcts.root_child_visits(tree).argmax(-1).int()
    new_states = tenv.step(states, actions)
    ff = torch.tensor([True, False, False, False])
    adv = tmcts.advance_root(tree, actions, new_states, spec, force_fresh=ff)
    assert int(adv.root_visit[0]) == 0 and int(adv.node_count[0]) == 1
    assert int(adv.node_count[1]) > 1


def test_init_tree_value_dtype_guards():
    states = tenv.initial_state((2,), device="cpu")
    with pytest.raises(ValueError, match="256"):
        tmcts.init_tree(states, tmcts.SearchSpec(
            num_simulations=400, value_dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="2048"):
        tmcts.init_tree(states, tmcts.SearchSpec(
            num_simulations=1200, tree_reuse=True,
            value_dtype=torch.float16))
    tree = tmcts.init_tree(states, tmcts.SearchSpec(
        num_simulations=100, value_dtype=torch.float16))
    assert tree.rows.shape == (2, 102, 8, 128)       # 16-bit rows pad to 8
    jtree = jmcts.init_tree(jenv.initial_state((2,)), jmcts.SearchSpec(
        num_simulations=100, value_dtype=jnp.float16))
    np.testing.assert_array_equal(tree.rows.float().numpy(),
                                  np.asarray(jtree.rows, np.float32))


def test_search_basics_and_action_probs():
    spec = tmcts.SearchSpec(num_simulations=24)
    tree = tmcts.search(tenv.initial_state((4,), device="cpu"),
                        fake_eval_torch, spec)
    visits = tmcts.root_child_visits(tree)
    assert (visits.sum(-1) == 24).all()
    legal = OracleGame().get_legal_action_mask()
    assert (visits.numpy()[:, ~legal] == 0).all()
    p1 = tmcts.root_action_probs(tree, 1.0)
    torch.testing.assert_close(p1.sum(-1), torch.ones(4))
    p0 = tmcts.root_action_probs(tree, torch.zeros(4))
    assert ((p0 == 0) | (p0 == 1)).all() and (p0.sum(-1) == 1).all()
    assert torch.equal(p0.argmax(-1), visits.argmax(-1))


def test_terminal_root_and_value_sign():
    rng = np.random.default_rng(3)
    g = OracleGame()
    while not g.is_terminal():
        g.step_action(int(rng.choice(g.get_legal_actions())))
    board = np.zeros((8, 8), np.int8)
    board[6, 3] = board[6, 6] = 1
    board[7, 0] = -1
    near_win = OracleGame(board, 1)
    spec = tmcts.SearchSpec(num_simulations=64)
    tree = tmcts.search(torch_states_from_games([g, OracleGame(), near_win]),
                        fake_eval_torch, spec)
    assert int(tree.root_visit[0]) == 64 and int(tree.node_count[0]) == 1
    assert int(tree.node_count[1]) > 1
    assert float(tmcts.root_value(tree)[2]) > 0.5


def test_dirichlet_noise_distribution():
    """Gamma draws from an explicit generator follow Gamma(0.35, 1) (a KS
    test), and the mixed root priors stay a distribution over legal
    actions that differs from the clean priors."""
    gen = torch.Generator().manual_seed(0)
    x = tmcts.sample_gamma(0.35, (20000,), gen, "cpu").double().numpy()
    assert sps.kstest(x, sps.gamma(0.35).cdf).pvalue > 1e-3
    assert abs(x.mean() - 0.35) < 0.02

    spec = tmcts.SearchSpec(num_simulations=2)
    s = tenv.initial_state((2,), device="cpu")
    clean = tmcts.search(s, fake_eval_torch, spec)
    noisy = tmcts.search(s, fake_eval_torch, spec, add_noise=True,
                         generator=torch.Generator().manual_seed(1))
    legal = OracleGame().get_legal_action_mask()
    prior = noisy.prior[:, 0].numpy()
    assert (prior[:, ~legal] == 0).all()
    np.testing.assert_allclose(prior.sum(-1), 1.0, atol=1e-6)
    assert not np.allclose(prior, clean.prior[:, 0].numpy())


def test_search_with_tiny_net():
    cfg = tiny_config()
    net = build_network(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    eval_fn = tmcts.make_net_evaluator(net)
    tree = tmcts.search(tenv.initial_state((8,), device="cpu"), eval_fn,
                        tmcts.SearchSpec(num_simulations=24))
    visits = tmcts.root_child_visits(tree).numpy()
    assert visits.sum() == 24 * 8
    assert (visits[:, ~OracleGame().get_legal_action_mask()] == 0).all()


def test_bf16_evaluator_search_is_inference_apply_search():
    """``make_net_evaluator(net, bfloat16)`` wires the JAX package's
    compiled forward (``models/inference.py``): a float64-tree search with
    it and one whose evaluator wraps ``inference_apply`` directly give the
    same visit counts."""
    from alphazero_torch.models import inference
    from alphazero_torch.models.network import wl_to_value

    cfg = tiny_config(num_blocks=2, num_filters=16)
    net = build_network(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    prep = inference.prepare_inference(net, torch.bfloat16)

    def direct(planes):
        logits, wl = inference.inference_apply(prep, planes)
        return torch.softmax(logits, -1), wl_to_value(wl)

    spec = tmcts.SearchSpec(num_simulations=32, value_dtype=F64)
    states = torch_states_from_games(_games(23, 6))
    visits = [tmcts.root_child_visits(tmcts.search(states, fn, spec))
              for fn in (tmcts.make_net_evaluator(net, torch.bfloat16),
                         direct)]
    assert torch.equal(visits[0], visits[1])
    assert int(visits[0].sum()) == 32 * 6
