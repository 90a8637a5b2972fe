"""PyTorch port's Breakthrough env held against the JAX package's env.

256 random-policy games with numpy-drawn legal actions are stepped in
lockstep through both envs and compared state for state every ply.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.env import breakthrough as jenv
from alphazero_torch.env import breakthrough as tenv

_FIELDS = ("board", "turn", "winner", "done", "move_count")


def _assert_same_state(t: tenv.EnvState, j: jenv.EnvState, ply: int):
    for f in _FIELDS:
        np.testing.assert_array_equal(
            getattr(t, f).numpy(), np.asarray(getattr(j, f)),
            err_msg=f"{f} at ply {ply}")


def test_random_games_match_jax_every_ply():
    B = 256
    rng = np.random.default_rng(2024)
    jstep = jax.jit(jenv.step)
    jmask = jax.jit(jenv.legal_action_mask)
    jenc = jax.jit(jenv.encoded_state)
    jstate = jenv.initial_state((B,))
    tstate = tenv.initial_state((B,), device="cpu")
    for ply in range(400):
        _assert_same_state(tstate, jstate, ply)
        mask = tenv.legal_action_mask(tstate).numpy()
        np.testing.assert_array_equal(mask, np.asarray(jmask(jstate)))
        np.testing.assert_array_equal(tenv.encoded_state(tstate).numpy(),
                                      np.asarray(jenc(jstate)))
        np.testing.assert_array_equal(
            tenv.terminal_value_for_player_to_move(tstate).numpy(),
            np.asarray(jenv.terminal_value_for_player_to_move(jstate)))
        if mask.any(-1).sum() == 0:
            break
        # numpy-drawn legal actions; finished games get action 0 (frozen)
        actions = np.array(
            [rng.choice(np.flatnonzero(m)) if m.any() else 0 for m in mask],
            np.int32)
        jstate = jstep(jstate, jnp.asarray(actions))
        tstate = tenv.step(tstate, torch.from_numpy(actions))
    assert bool(tstate.done.all())
    np.testing.assert_array_equal(tenv.result_wl(tstate).numpy(),
                                  np.asarray(jenv.result_wl(jstate)))
    # both colours win some games
    assert {1, -1} <= set(tstate.winner.tolist())


def test_initial_state_and_batch_shapes():
    t = tenv.initial_state((2, 3), device="cpu")
    j = jenv.initial_state((2, 3))
    _assert_same_state(t, j, 0)
    assert tenv.legal_action_mask(t).shape == (2, 3, 192)
    assert tenv.encoded_state(t, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("entry", ["env", "net", "archive", "selfplay"])
def test_entry_point_raises_without_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from alphazero_torch.config import tiny_config
    from alphazero_torch.models import convert, network
    from alphazero_torch.train import selfplay

    cfg = tiny_config()
    call = {
        "env": lambda: tenv.initial_state((2,)),
        "net": lambda: network.build_network(cfg),
        "archive": lambda: convert.load_archive("unread.npz"),
        "selfplay": lambda: selfplay.selfplay_games_continuous(
            None, cfg, torch.Generator()),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


@pytest.mark.parametrize("turn", [1, -1])
def test_action_encode_decode_round_trip(turn):
    for action in range(192):
        move = tenv.decode_action_to_move(action, turn)
        assert move == jenv.decode_action_to_move(action, turn)
        r, c, tr, tc = move
        if 0 <= tc < 8:
            assert tenv.encode_move_to_action(move, turn) == action
            assert jenv.encode_move_to_action(move, turn) == action
