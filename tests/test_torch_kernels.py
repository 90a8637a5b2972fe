"""PyTorch port's tree kernels.

On the CPU the public ``fetch_rows`` / ``commit_edges`` run their plain
versions, which must be bit-exact against the JAX package's XLA
fallbacks (``_fetch_rows_xla`` / ``_commit_edges_xla``), including
B < 16, B not a multiple of 16, and every game on one node; a stack of
levels given to ``commit_edges`` at once must equal one call of the JAX
package's ``commit_edges`` per level. Tests marked
``gpu`` hold the CUDA kernels against the plain versions on the card and
skip without one; they import no JAX, so on a machine with a card and
without JAX they run with
``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from alphazero_torch.search import kernels as K

RS, L, A = 6, 128, 192
OFFSETS = (0, 2 * A, 3 * A)


def _data(B, M, seed, dtype=np.float32, same_node=None):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((B, M, RS, L)).astype(dtype)
    node = (np.full(B, same_node, np.int32) if same_node is not None
            else rng.integers(0, M, B).astype(np.int32))
    act = rng.integers(0, A, B).astype(np.int32)
    upd = rng.standard_normal((B, 3)).astype(np.float32)
    return rows, node, act, upd


@pytest.fixture(scope="module")
def jax_kernels():
    from alphazero_tpu.search import kernels  # imports JAX

    return kernels


CASES = [(8, 17, None), (3, 9, None), (12, 9, None), (13, 17, None),
         (16, 5, 0), (5, 7, 6)]   # last two: one node for all; trash row


@pytest.mark.parametrize("B,M,same_node", CASES)
def test_fetch_rows_plain_matches_jax(jax_kernels, B, M, same_node):
    rows, node, _, _ = _data(B, M, B * 31 + M, same_node=same_node)
    want = np.asarray(jax_kernels._fetch_rows_xla(rows, node))
    got = K.fetch_rows(torch.from_numpy(rows), torch.from_numpy(node))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
@pytest.mark.parametrize("B,M,same_node", CASES)
def test_commit_edges_plain_matches_jax(jax_kernels, B, M, same_node, dtype):
    import jax

    rows, node, act, upd = _data(B, M, B * 7 + M, dtype, same_node)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax_kernels._commit_edges_xla(
            rows, node, act, upd, OFFSETS))
    t_rows = torch.from_numpy(rows.copy())
    ptr = t_rows.data_ptr()
    out = K.commit_edges(t_rows, torch.from_numpy(node),
                         torch.from_numpy(act), torch.from_numpy(upd),
                         OFFSETS, A)
    assert out is t_rows and t_rows.data_ptr() == ptr      # in place
    np.testing.assert_array_equal(t_rows.numpy(), want)


def _stacked(B, M, levels, seed, same_node=None):
    rng = np.random.default_rng(seed)
    node = (np.full((levels, B), same_node, np.int32)
            if same_node is not None
            else rng.integers(0, M, (levels, B)).astype(np.int32))
    act = rng.integers(0, A, (levels, B)).astype(np.int32)
    if same_node is not None:
        act[1::2] = act[0]              # levels that meet on one element
    upd = rng.standard_normal((levels, B, 3)).astype(np.float32)
    return node, act, upd


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
@pytest.mark.parametrize("levels", [1, 2, 5])
@pytest.mark.parametrize("B,M,same_node", [(8, 17, None), (13, 9, None),
                                           (16, 5, 0), (5, 7, 6)])
def test_commit_edges_stacked_levels_match_jax_calls(jax_kernels, B, M,
                                                     same_node, levels,
                                                     dtype):
    """(L, B) operands in one call against L calls of the JAX package's
    ``commit_edges`` (its CPU path), bit for bit: random nodes, every
    level on one node, every level on the last (trash) row."""
    import jax

    rows = np.random.default_rng(B + levels).standard_normal(
        (B, M, RS, L)).astype(dtype)
    node, act, upd = _stacked(B, M, levels, B * 11 + M + levels, same_node)
    with jax.enable_x64(dtype == np.float64):
        want = rows
        for l in range(levels):
            want = jax_kernels.commit_edges(want, node[l], act[l], upd[l],
                                            OFFSETS)
        want = np.asarray(want)
    t_rows = torch.from_numpy(rows.copy())
    out = K.commit_edges(t_rows, torch.from_numpy(node),
                         torch.from_numpy(act), torch.from_numpy(upd),
                         OFFSETS, A)
    assert out is t_rows
    np.testing.assert_array_equal(t_rows.numpy(), want)
    # and against the port's own single-level calls
    t_single = torch.from_numpy(rows.copy())
    for l in range(levels):
        K.commit_edges(t_single, torch.from_numpy(node[l]),
                       torch.from_numpy(act[l]), torch.from_numpy(upd[l]),
                       OFFSETS, A)
    assert torch.equal(t_rows, t_single)


def test_commit_edges_stacked_keeps_signed_zero():
    """-0.0 + 0.0 is +0.0: an element the levels past a game's depth touch
    with zero updates ends as the sequential calls leave it."""
    rows = torch.full((2, 3, RS, L), -0.0)
    node = torch.full((3, 2), 2, dtype=torch.int32)
    act = torch.zeros((3, 2), dtype=torch.int32)
    K.commit_edges(rows, node, act, torch.zeros((3, 2, 3)), OFFSETS, A)
    flat = rows.view(2, 3, -1)
    assert not torch.signbit(flat[:, 2, [0, 2 * A, 3 * A]]).any()
    assert torch.signbit(flat[:, 2, 1]).all() and torch.signbit(rows).sum() \
        == rows.numel() - 6


@pytest.mark.parametrize("bad", ["act-shape", "upd-levels", "upd-k",
                                 "three-dims", "node-batch"])
def test_commit_edges_rejects_malformed_stacks(bad):
    rows = torch.zeros((4, 5, RS, L))
    node = torch.zeros((2, 4), dtype=torch.int32)
    act = torch.zeros((2, 4), dtype=torch.int32)
    upd = torch.zeros((2, 4, 3))
    if bad == "act-shape":
        act = act[0]
    elif bad == "upd-levels":
        upd = upd[0]
    elif bad == "upd-k":
        upd = upd[..., :2]
    elif bad == "three-dims":
        node, act, upd = node[None], act[None], upd[None]
    elif bad == "node-batch":
        node, act, upd = node[:, :3], act[:, :3], upd[:, :3]
    before = rows.clone()
    with pytest.raises(ValueError, match="node and act"):
        K.commit_edges(rows, node, act, upd, OFFSETS, A)
    assert torch.equal(rows, before)


def test_commit_edges_known_update():
    rows = torch.zeros((2, 3, RS, L))
    K.commit_edges(rows, torch.tensor([1, 2], dtype=torch.int32),
                   torch.tensor([5, 191], dtype=torch.int32),
                   torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]),
                   OFFSETS, A)
    flat = rows.view(2, 3, -1)
    assert flat[0, 1, 5] == 1 and flat[0, 1, 2 * A + 5] == 2
    assert flat[0, 1, 3 * A + 5] == 3 and flat[1, 2, 191] == 4
    assert flat[1, 2, 3 * A + 191] == 6 and flat.sum() == 21


@pytest.mark.parametrize("offsets", [(0, 100, 3 * A), (0, 2 * A, 3 * A + 1),
                                     (0, 1, 2, 3, 4)])
def test_commit_edges_rejects_overlapping_offsets(offsets):
    rows, node, act, upd = _data(2, 3, 0)
    with pytest.raises(ValueError, match="offsets"):
        K.commit_edges(torch.from_numpy(rows), torch.from_numpy(node),
                       torch.from_numpy(act),
                       torch.zeros((2, len(offsets))), offsets, A)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,M,same_node", CASES + [(512, 802, None)])
def test_cuda_kernels_bit_exact_against_plain(cuda, B, M, same_node):
    rows, node, act, upd = (torch.from_numpy(a).to(cuda) for a in
                            _data(B, M, B + M, same_node=same_node))
    torch.testing.assert_close(K.fetch_rows(rows, node),
                               K._fetch_rows_plain(rows, node),
                               rtol=0, atol=0)
    want = K._commit_edges_plain(rows.clone(), node, act, upd, OFFSETS)
    got = rows.clone()
    ptr = got.data_ptr()
    K.commit_edges(got, node, act, upd, OFFSETS, A)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr
    assert torch.equal(got, want)
    assert int((got != rows).sum()) <= 3 * B


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [1, 2, 5])
@pytest.mark.parametrize("B,M,same_node", CASES + [(512, 802, None)])
def test_cuda_commit_edges_stacked_bit_exact(cuda, B, M, same_node, levels):
    """One launch for a stack of levels against the plain version and
    against one launch per level."""
    rows = torch.from_numpy(_data(B, M, B + M)[0]).to(cuda)
    node, act, upd = (torch.from_numpy(a).to(cuda) for a in
                      _stacked(B, M, levels, B + M + levels, same_node))
    want = K._commit_edges_plain(rows.clone(), node, act, upd, OFFSETS)
    single = rows.clone()
    launches = K.commit_edges.launches
    for l in range(levels):
        K.commit_edges(single, node[l], act[l], upd[l], OFFSETS, A)
    assert K.commit_edges.launches == launches + levels
    got = rows.clone()
    K.commit_edges(got, node, act, upd, OFFSETS, A)
    torch.cuda.synchronize()
    assert K.commit_edges.launches == launches + levels + 1
    assert torch.equal(got, want) and torch.equal(got, single)
    assert int((got != rows).sum()) <= 3 * B * levels


@pytest.mark.gpu
def test_cuda_commit_edges_rejects_malformed_stacks(cuda):
    rows, node, act, upd = (torch.from_numpy(a).to(cuda)
                            for a in _data(4, 5, 1))
    launches = K.commit_edges.launches
    with pytest.raises(ValueError, match="int32"):
        K.commit_edges(rows, node[None].long(), act[None].long(), upd[None],
                       OFFSETS, A)
    with pytest.raises(ValueError, match="contiguous"):
        K.commit_edges(rows, node[None].expand(2, 4), act[None].expand(2, 4),
                       upd[None].expand(2, 4, 3), OFFSETS, A)
    with pytest.raises(ValueError, match="node and act"):
        K.commit_edges(rows, node[None], act, upd[None], OFFSETS, A)
    assert K.commit_edges.launches == launches


@pytest.mark.gpu
def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    rows, node, act, upd = (torch.from_numpy(a).to(cuda)
                            for a in _data(4, 5, 1))
    launches = (K.fetch_rows.launches, K.commit_edges.launches)
    with pytest.raises(TypeError, match="float32"):
        K.fetch_rows(rows.double(), node)
    with pytest.raises(TypeError, match="float32"):
        K.commit_edges(rows.half(), node, act, upd, OFFSETS, A)
    with pytest.raises(ValueError, match="contiguous"):
        K.commit_edges(rows.transpose(0, 1), node[:1].expand(5).contiguous(),
                       act[:1].expand(5).contiguous(), upd[:1].expand(5, 3),
                       OFFSETS, A)
    with pytest.raises(ValueError, match="int32"):
        K.fetch_rows(rows, node.long())
    assert (K.fetch_rows.launches, K.commit_edges.launches) == launches
