"""PyTorch port's self-play: example emission held against the JAX
package's on the same numpy arrays, plus format and count invariants of
both game generators on the CPU."""

import numpy as np
import pytest
import torch

# tiny tensors: intra-op threads only add overhead beside xdist workers
torch.set_num_threads(1)

from alphazero_tpu.train import selfplay as jsp
from alphazero_torch.config import tiny_config
from alphazero_torch.env import breakthrough as tenv
from alphazero_torch.models.network import build_network
from alphazero_torch.search import SearchSpec, make_net_evaluator
from alphazero_torch.search import kernels
from alphazero_torch.train import selfplay as tsp


def test_emit_examples_equal_jax():
    rng = np.random.default_rng(0)
    M, B = 12, 6
    planes = rng.integers(0, 2, (M, B, 3, 8, 8)).astype(np.uint8)
    probs = rng.random((M, B, 192)).astype(np.float32)
    mover = rng.choice(np.array([1, -1], np.int8), (M, B))
    m_idx, g_idx = np.nonzero(rng.random((M, B)) > 0.4)
    winners = rng.choice(np.array([1, -1], np.int8), len(m_idx))
    got = tsp._emit_examples(planes, probs, mover, m_idx, g_idx, winners)
    want = jsp._emit_examples(planes, probs, mover, m_idx, g_idx, winners)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def net_eval():
    cfg = tiny_config(num_blocks=1, num_filters=8, num_simulations=8,
                      parallel_games=8, max_game_length=160)
    net = build_network(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    return cfg, make_net_evaluator(net)


def _check_examples(examples):
    for planes, probs, wl in examples:
        assert planes.dtype == np.uint8 and planes.shape == (3, 8, 8)
        assert set(np.unique(planes)) <= {0, 1} and (planes[2] == 1).all()
        assert probs.dtype == np.float32 and probs.shape == (192,)
        np.testing.assert_allclose(probs.sum(), 1.0, atol=1e-5)
        assert wl.dtype == np.float32 and sorted(wl.tolist()) == [0.0, 1.0]


@pytest.mark.parametrize("reuse", [False, True])
def test_selfplay_games_format_and_counts(net_eval, reuse):
    cfg, eval_fn = net_eval
    cfg = cfg.replace(tree_reuse=reuse)
    examples, stats = tsp.selfplay_games(
        eval_fn, cfg, torch.Generator().manual_seed(1), device="cpu")
    assert stats["games"] == 8
    assert stats["examples"] == stats["moves"] == len(examples) > 0
    # only live-lane simulations count
    assert stats["simulations"] == stats["moves"] * cfg.num_simulations
    _check_examples(examples)


@pytest.mark.parametrize("reuse", [False, True])
def test_selfplay_continuous_format_and_counts(net_eval, reuse):
    cfg, eval_fn = net_eval
    cfg = cfg.replace(tree_reuse=reuse)
    examples, stats = tsp.selfplay_games_continuous(
        eval_fn, cfg, torch.Generator().manual_seed(2), num_games=10,
        device="cpu")
    assert stats["games"] >= 10
    assert stats["examples"] == stats["moves"] == len(examples) > 0
    assert stats["simulations"] == (stats["moves_played"] * 8
                                    * cfg.num_simulations)
    _check_examples(examples)
    w = np.mean([e[2][0] for e in examples])
    assert 0.1 < w < 0.9


def test_selfplay_move_samples_legal_actions_and_cpu_uses_plain(net_eval):
    cfg, eval_fn = net_eval
    spec = tsp.search_spec(cfg)
    assert spec == SearchSpec(num_simulations=8)
    states = tenv.initial_state((8,), device="cpu")
    launches = (kernels.fetch_rows.launches, kernels.commit_edges.launches)
    gen = torch.Generator().manual_seed(3)
    for _ in range(20):
        legal = tenv.legal_action_mask(states)
        new_states, planes, probs, actions, values = tsp.selfplay_move(
            states, gen, eval_fn, spec, cfg.temperature_threshold)
        live = ~states.done
        assert legal[live, actions[live].long()].all()
        assert (probs[~legal] == 0).all()
        assert ((values >= -1) & (values <= 1)).all()
        states = new_states
    # CPU tensors never reach the CUDA kernels
    assert (kernels.fetch_rows.launches,
            kernels.commit_edges.launches) == launches
