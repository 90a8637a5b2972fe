"""PyTorch port's fused-tower path held against the JAX package's.

On the CPU ``tower_forward`` runs its plain version, which is compared
with the JAX package's Pallas tower in interpreter mode; ``pack_weights``
must give the JAX package's arrays bit for bit. Weights travel through
the archive key scheme, as in ``tests/test_torch_network.py``. The tests
marked ``gpu`` hold the CUDA kernel against the plain version on the
card and skip without one; they import no JAX (the JAX imports below are
made inside the other tests' helpers), so on a machine with a card and
without JAX it runs with
``python -m pytest --noconftest -m gpu tests/test_torch_fused.py``.
The image of the conv weights that the kernel's tensor cores read
(``wconv_smem_image``) is a layout made on the host, so it is inverted
here in numpy.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(1)

from alphazero_torch.models import convert, fused, inference
from alphazero_torch.models.network import AlphaZeroNet

BF16_STEP = 2.0 ** -7      # spacing of bf16 values, relative, at most


class _Jax:
    """The JAX side, imported at first use."""

    def __getattr__(self, name):
        import jax
        import jax.numpy as jnp
        from flax import traverse_util

        from alphazero_tpu.config import Config
        from alphazero_tpu.models import fused as jfused
        from alphazero_tpu.models.network import init_network

        self.__dict__.update(jax=jax, jnp=jnp, traverse_util=traverse_util,
                             Config=Config, fused=jfused,
                             init_network=init_network)
        return self.__dict__[name]


J = _Jax()


def _flat(variables):
    flat = {}
    for col in ("params", "batch_stats"):
        for path, leaf in J.traverse_util.flatten_dict(variables[col]).items():
            flat[col + "/" + "/".join(path)] = np.asarray(leaf)
    return flat


def _nets(blocks, seed, scan=False):
    """(flax net, variables with non-trivial BN statistics, the port's net
    loaded from them)."""
    cfg = J.Config(num_blocks=blocks, num_filters=128, scan_blocks=scan)
    net, variables = J.init_network(cfg, J.jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    variables = dict(variables)
    variables["batch_stats"] = J.jax.tree_util.tree_map(
        lambda a: J.jnp.asarray(rng.uniform(0.5, 1.5, a.shape), J.jnp.float32),
        variables["batch_stats"])
    tnet = convert.load_flat_into(AlphaZeroNet(blocks, 128, 8).eval(),
                                  _flat(variables))
    return net, variables, tnet


def _planes(rng, b):
    mine = rng.random((b, 1, 8, 8)) < 0.2
    theirs = (~mine) & (rng.random((b, 1, 8, 8)) < 0.2)
    return np.concatenate([mine, theirs, np.ones((b, 1, 8, 8))],
                          1).astype(np.float32)


def _f32(a):
    return np.asarray(J.jnp.asarray(a, J.jnp.float32))


@pytest.mark.parametrize("scan", [False, True], ids=["inlined", "scanned"])
def test_pack_weights_bit_equal_to_jax(scan):
    net, variables, tnet = _nets(3, 2, scan)
    want = J.fused.pack_weights(net, variables)
    got = fused.pack_weights(tnet)
    assert set(got) == set(want) | {"f32", "wconv_smem"}
    assert got["num_blocks"] == want["num_blocks"] == 3
    for key, w in want.items():
        if key == "num_blocks":
            continue
        g = got[key]
        assert str(g.dtype) == f"torch.{w.dtype}", key
        np.testing.assert_array_equal(g.float().numpy(), _f32(w), key)
    # the port's own entry: the same rounded values, in torch's layouts
    for key in ("k_in", "k_pol", "k_val"):
        np.testing.assert_array_equal(
            got["f32"][key].numpy(), _f32(want[key]).transpose(3, 2, 0, 1))
    for key in ("policy_fc", "value_fc1", "value_fc2"):
        np.testing.assert_array_equal(got["f32"][key].numpy(),
                                      _f32(want[key]))


def _smem_image_inverse(image: np.ndarray) -> np.ndarray:
    """numpy inverse of ``fused.wconv_smem_image``, written out element by
    element from the kernel's addressing: chunk (tap, half of cin), row
    cout of 64 values, the 8-value piece ``j`` of a row at ``j ^ (cout %
    8)``."""
    n = image.shape[0]
    out = np.zeros((n, 2, 9, 128, 128), image.dtype)
    cout = np.arange(128)
    for half in range(2):
        for kc in range(64):
            piece = (kc >> 3) ^ (cout & 7)
            out[:, :, :, half * 64 + kc, cout] = \
                image[:, :, :, half, cout, piece * 8 + (kc & 7)]
    return out


@pytest.mark.parametrize("blocks", [1, 3])
def test_wconv_smem_image_is_a_permutation_of_wconv(blocks):
    # every element once: the image of arange holds each index once
    count = blocks * 2 * 9 * 128 * 128
    index = torch.arange(count, dtype=torch.int32).view(blocks, 2, 9, 128,
                                                        128)
    image = fused.wconv_smem_image(index)
    assert image.shape == (blocks, 2, 9, 2, 128, 64) \
        and image.is_contiguous()
    np.testing.assert_array_equal(np.sort(image.numpy().ravel()),
                                  np.arange(count))
    np.testing.assert_array_equal(_smem_image_inverse(image.numpy()),
                                  index.numpy())
    # a chunk is one contiguous 16 KB block of one block's weights
    assert torch.equal(image[blocks - 1:], fused.wconv_smem_image(
        index[blocks - 1:]))

    # and the packed entry is that image of the packed weights, which are
    # still the JAX package's bit for bit
    net, variables, tnet = _nets(blocks, 20 + blocks)
    packed = fused.pack_weights(tnet)
    smem = packed["wconv_smem"]
    assert smem.dtype == torch.bfloat16 and smem.is_contiguous() \
        and tuple(smem.shape) == (blocks, 2, 9, 2, 128, 64)
    np.testing.assert_array_equal(
        _smem_image_inverse(smem.view(torch.int16).numpy()),
        packed["wconv"].view(torch.int16).numpy())
    np.testing.assert_array_equal(
        packed["wconv"].float().numpy(),
        _f32(J.fused.pack_weights(net, variables)["wconv"]))


def test_pack_weights_undoes_the_flatten_permutation():
    """``convert`` permutes ``policy_fc``/``value_fc1`` to (c, h, w) input
    order; packing them as they are would load and compute garbage."""
    _, _, tnet = _nets(1, 4)
    packed = fused.pack_weights(tnet)
    raw = tnet.policy_fc.weight.detach().T.to(torch.bfloat16)
    assert raw.shape == packed["policy_fc"].shape
    assert not torch.equal(raw, packed["policy_fc"])


@pytest.mark.parametrize("blocks", [2, 5])
def test_tower_plain_matches_pallas_interpret(blocks):
    net, variables, tnet = _nets(blocks, blocks)
    pj = J.fused.pack_weights(net, variables)
    pt = fused.pack_weights(tnet)
    B = J.fused.TB
    x = np.random.default_rng(blocks).standard_normal(
        (B * 64, 128)).astype(np.float32)
    want = _f32(J.fused.tower_forward(J.jnp.asarray(x, J.jnp.bfloat16), pj,
                                     num_blocks=blocks, interpret=True))
    got = fused.tower_forward(torch.from_numpy(x).to(torch.bfloat16), pt,
                              blocks)
    assert got.dtype == torch.bfloat16 and got.shape == (B * 64, 128)
    got = got.float().numpy()
    # Same operands and rounding points; only the order of the f32 sums
    # differs (nine K=128 dots added up in XLA, nine f32 matmuls here), so
    # a few elements land on the neighbouring bf16 value, and such a step
    # in the first conv's output moves the block's output by less than a
    # step again: 2 bf16 steps of max(|x|, 1), on under 1% of elements.
    diff = np.abs(got - want)
    assert (diff <= 2 * BF16_STEP * np.maximum(np.abs(want), 1.0)).all()
    assert (diff > 0).mean() < 0.01


@pytest.mark.parametrize("blocks,scan", [(2, False), (5, False), (3, True)])
def test_fused_apply_matches_jax_fused_and_flax(blocks, scan):
    net, variables, tnet = _nets(blocks, 10 + blocks, scan)
    pj = J.fused.pack_weights(net, variables)
    pt = fused.pack_weights(tnet)
    planes = _planes(np.random.default_rng(1), J.fused.TB)
    pol, wl = (t.numpy() for t in
               fused.fused_apply(pt, torch.from_numpy(planes)))
    assert pol.dtype == np.float32 and pol.shape == (J.fused.TB, 192)
    assert wl.shape == (J.fused.TB, 2)

    # against the JAX fused path: same rounding points, sums reordered
    pol_j, wl_j = (np.asarray(a) for a in J.fused.fused_apply(
        pj, J.jnp.asarray(planes), interpret=True))
    np.testing.assert_allclose(pol, pol_j, atol=0.02, rtol=0)
    np.testing.assert_allclose(wl, wl_j, atol=0.02, rtol=0)

    # against Flax bf16 inference, with the tolerances of the JAX
    # package's own fused test: logits differ by bf16 accumulation order
    # and BN folding; probabilities and win/loss shares by 0.02
    pol_r, wl_r = (np.asarray(a) for a in net.clone(
        dtype=J.jnp.bfloat16).apply(variables, J.jnp.asarray(planes),
                                    train=False))
    np.testing.assert_allclose(pol, pol_r, atol=0.15, rtol=0.05)
    np.testing.assert_allclose(wl, wl_r, atol=0.15, rtol=0.05)
    sm = lambda a: np.asarray(J.jax.nn.softmax(J.jnp.asarray(a), -1))
    np.testing.assert_allclose(sm(pol), sm(pol_r), atol=0.02)
    np.testing.assert_allclose(sm(wl), sm(wl_r), atol=0.02)


def test_fused_apply_close_to_the_ports_own_net():
    _, _, tnet = _nets(2, 7)
    planes = torch.from_numpy(_planes(np.random.default_rng(3), 8))
    pol, wl = fused.fused_apply(fused.pack_weights(tnet), planes)
    with torch.no_grad():
        pol32, wl32 = tnet(planes)
    # bf16 activations against the f32 net
    torch.testing.assert_close(pol, pol32, atol=0.05, rtol=0)
    torch.testing.assert_close(wl, wl32, atol=0.05, rtol=0)


def test_conv_masking_is_exact():
    """The nine-shift masked-matmul conv equals ``F.conv2d`` in f32: the
    same taps, so only the order of the sums differs."""
    rng = np.random.default_rng(5)
    B = 4
    x = torch.from_numpy(rng.standard_normal((B, 8, 8, 128))
                         .astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 128, 128)) * 0.05)
                         .astype(np.float32))                     # HWIO
    ref = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    got = fused._conv9(x.reshape(B * 64, 128), w.reshape(9, 128, 128))
    np.testing.assert_allclose(
        got.view(B, 8, 8, 128).permute(0, 3, 1, 2).numpy(), ref.numpy(),
        atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(fused._MASKS, J.fused._MASKS)


def test_tower_forward_refuses_what_the_kernel_does_not_take():
    _, _, tnet = _nets(1, 0)
    packed = fused.pack_weights(tnet)
    ok = torch.zeros((fused.TB * 64, 128), dtype=torch.bfloat16)
    assert fused.tower_forward(ok, packed, 1).shape == ok.shape
    with pytest.raises(ValueError, match="C=128"):
        fused.tower_forward(ok[:, :64], packed, 1)
    with pytest.raises(ValueError, match="multiple"):
        fused.tower_forward(
            torch.zeros(((fused.TB + 1) * 64, 128), dtype=torch.bfloat16),
            packed, 1)
    with pytest.raises(TypeError, match="bfloat16"):
        fused.tower_forward(ok.float(), packed, 1)
    with pytest.raises(ValueError, match="num_blocks"):
        fused.tower_forward(ok, packed, 2)
    with pytest.raises(ValueError, match="C=128"):
        fused.pack_weights(AlphaZeroNet(1, 32, 8))
    assert fused.tower_forward.launches == 0        # the CPU never launches


def test_bench_fused_runs_on_the_cpu():
    from alphazero_torch import bench_fused

    _, _, tnet = _nets(1, 1)
    out = bench_fused.bench_fused(tnet, bench_fused.random_planes(fused.TB),
                                  2)
    assert out["max_prob_diff"] < 0.02 and out["max_value_diff"] < 0.02
    assert out["fused_ms_per_eval"] > 0 and out["layers_ms_per_eval"] > 0
    assert out["tower_launches"] == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("tap", [0, 4, 8])
def test_cuda_tower_kernel_reads_its_weight_image(cuda, tap):
    """One block whose first conv permutes the channels of one tap and
    whose second conv is the identity, with every other weight zero: the
    output is ``relu(relu(shifted, permuted x) / 2 + x)``, exactly, unless
    the kernel's descriptor and the host-made image disagree on where a
    (cin, cout) pair or a tap lies."""
    gen = torch.Generator().manual_seed(tap)
    net = AlphaZeroNet(2, 128, 8).eval()
    packed = fused.pack_weights(net.to(cuda))
    for key, t in packed.items():
        if torch.is_tensor(t) and key not in ("wconv", "wconv_smem"):
            t.zero_()
    wconv = torch.zeros((2, 2, 9, 128, 128))
    rot = (torch.arange(128) * 37 + 5) % 128         # cin -> cout
    wconv[0, 0, tap, torch.arange(128), rot] = 1.0
    wconv[0, 1, 4] = torch.eye(128)                   # y = y1
    packed["wconv"] = wconv.to(cuda, torch.bfloat16)
    packed["wconv_smem"] = fused.wconv_smem_image(packed["wconv"])
    x = torch.randn((fused.TB * 64, 128), generator=gen) \
        .to(cuda, torch.bfloat16)
    got = fused.tower_forward(x, packed, 1).float()
    want = fused._tower_plain(x, packed, 1).float()
    torch.cuda.synchronize()
    # sigmoid(0) = 1/2 and every product is by 0 or 1: exact
    assert torch.equal(got, want)
    assert float(want.abs().max()) > 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("games,blocks", [(4, 1), (8, 2), (64, 3),
                                          (132, 20)])
def test_cuda_tower_kernel_against_plain(cuda, games, blocks):
    """Imports no JAX: random weights straight into the port's net."""
    gen = torch.Generator().manual_seed(games)
    net = AlphaZeroNet(max(3, blocks), 128, 8).eval()
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        for name, b in net.named_buffers():
            if name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    packed = fused.pack_weights(net.to(cuda))
    x = torch.randn((games * 64, 128), generator=gen).to(cuda, torch.bfloat16)
    launches = fused.tower_forward.launches
    got = fused.tower_forward(x, packed, blocks).float()
    want = fused._tower_plain(x, packed, blocks).float()
    torch.cuda.synchronize()
    assert fused.tower_forward.launches == launches + 1
    # sums reordered: one bf16 step per block, as on the CPU; through 20
    # blocks single steps grow like the bf16 net's own rounding, so there
    # the outputs are held to a mean difference of a step
    diff = (got - want).abs() / (BF16_STEP * want.abs().clamp_min(1.0))
    if blocks <= 3:
        assert bool((diff <= blocks).all())
    else:
        assert bool(torch.isfinite(got).all()) and float(diff.mean()) < 1.0
    with pytest.raises(ValueError, match="contiguous"):
        fused.tower_forward(x.repeat(2, 1)[::2], packed, 1)
    with pytest.raises(ValueError, match="multiple"):
        fused.tower_forward(x[:64], packed, 1)
    assert fused.tower_forward.launches == launches + 1


# -----------------------------------------------------------------------------
# The bf16 evaluator's choice of route for its tower
# -----------------------------------------------------------------------------

def _random_net(blocks, C, seed):
    """Imports no JAX: small random weights and BatchNorm variances."""
    gen = torch.Generator().manual_seed(seed)
    net = AlphaZeroNet(blocks, C, 8).eval()
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        for name, b in net.named_buffers():
            if name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    return net


@pytest.mark.parametrize("dev,dtype,C,want", [
    ("cuda", torch.bfloat16, 128, True),
    ("cuda", torch.bfloat16, 256, False),
    ("cuda", torch.bfloat16, 32, False),
    ("cuda", torch.float32, 128, False),
    ("cpu", torch.bfloat16, 128, False)])
def test_packs_tower_on_a_card_in_bf16_at_C_128(dev, dtype, C, want):
    assert inference.packs_tower(torch.device(dev), dtype, C) is want


@pytest.mark.parametrize("B,want", [
    (inference.B_MIN, True), (inference.B_MIN + fused.TB, True),
    (512, True), (1, False), (130, False),
    (inference.B_MIN - fused.TB, False), (inference.B_MIN + 2, False)])
def test_fused_tower_route_is_chosen_by_the_batch(B, want):
    """A card's prep has its tower operands; the route then takes whole
    thread blocks of ``fused.TB`` boards from ``B_MIN`` up."""
    assert inference.B_MIN % fused.TB == 0
    assert inference.fused_tower({"tower": {}}, B) is want


def test_cpu_prep_keeps_no_tower_and_takes_the_per_layer_route():
    prep = inference.prepare_inference(AlphaZeroNet(1, 128, 8).eval(),
                                       torch.bfloat16)
    assert prep["tower"] is None
    assert not inference.fused_tower(prep, 512)


def test_fused_route_of_inference_apply_on_the_cpu(monkeypatch):
    """The fused route's plumbing, at a batch lowered to 8 boards: the
    input conv's NHWC map goes through ``tower_forward`` (its plain
    version here) as ``(B*64, 128)`` rows and back, with no
    ``se_residual``, and the logits land within ``BF16_LIMITS`` of the
    per-layer route's."""
    import chip_smoke
    from alphazero_torch.models import epilogue

    net = _random_net(2, 128, 3)
    planes = torch.from_numpy(_planes(np.random.default_rng(4), 8))
    prep = inference.prepare_inference(net, torch.bfloat16)
    want = inference.inference_apply(prep, planes)
    calls, kernel = [], fused.tower_forward

    def tower_forward(x2d, packed, num_blocks):
        calls.append((tuple(x2d.shape), num_blocks))
        return kernel(x2d, packed, num_blocks)

    def se_residual(*args, **kw):
        raise AssertionError("the fused route ran a per-layer block")

    monkeypatch.setattr(inference, "B_MIN", 8)
    monkeypatch.setattr(fused, "tower_forward", tower_forward)
    monkeypatch.setattr(epilogue, "se_residual", se_residual)
    prep["tower"] = inference.tower_operands(net)
    got = inference.inference_apply(prep, planes)
    assert calls == [((8 * 64, 128), 2)]
    apart = _limits_apart(got, want)
    assert all(d <= lim for d, lim in zip(apart, chip_smoke.BF16_LIMITS))
    assert apart[0] > 0    # BatchNorm folded: the rounding points moved


def _archive_net(dev):
    import chip_smoke

    return convert.load_archive(chip_smoke.ARCHIVE, device=dev)


def _limits_apart(got, want):
    """(logit, probability, value) differences, as ``BF16_LIMITS`` has
    them."""
    value = lambda wl: torch.softmax(wl, -1)[:, 0] - torch.softmax(wl, -1)[:, 1]
    return (max(float((g - w).abs().max()) for g, w in zip(got, want)),
            float((torch.softmax(got[0], -1)
                   - torch.softmax(want[0], -1)).abs().max()),
            float((value(got[1]) - value(want[1])).abs().max()))


def _launches():
    from alphazero_torch.models import conv, epilogue

    return (fused.tower_forward.launches, conv.conv3x3.launches,
            epilogue.se_residual.launches)


@pytest.mark.gpu
def test_cuda_fused_route_within_bf16_limits_of_the_per_layer_route(
        cuda, monkeypatch):
    """The archived net's bf16 forward of 512 random-play positions on the
    card: the fused route (one ``tower_forward``, the policy head's one
    ``conv3x3``, no ``se_residual``) within ``BF16_LIMITS`` of the
    per-layer route's policy and value."""
    import chip_smoke
    from alphazero_torch.env import breakthrough as env

    prep = inference.prepare_inference(_archive_net(cuda), torch.bfloat16)
    planes = env.encoded_state(chip_smoke.random_positions(512, 19)) \
        .to(cuda)
    before = _launches()
    got = inference.inference_apply(prep, planes)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (1, 1, 0)
    monkeypatch.setattr(inference, "B_MIN", 10 ** 9)
    before = _launches()
    want = inference.inference_apply(prep, planes)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (0, 41, 20)
    apart = _limits_apart(got, want)
    assert all(d <= lim for d, lim in zip(apart, chip_smoke.BF16_LIMITS)), \
        apart


@pytest.mark.gpu
def test_cuda_captured_search_replays_the_fused_tower(cuda):
    """A 512-lane search of the archived net's bf16 evaluator, captured,
    then searched again from reset roots: every replay adds one
    ``tower_forward`` launch (and the eager root's forward one more), the
    policy head's ``conv3x3`` alone, and no ``se_residual``."""
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.search import graph, mcts

    states = env.initial_state((512,), device=cuda)
    spec = mcts.SearchSpec(num_simulations=8)
    eval_fn = mcts.make_net_evaluator(_archive_net(cuda), torch.bfloat16)
    tree = mcts.search(states, eval_fn, spec)
    captures, replays = graph.STATS.captures, graph.STATS.replays
    before = _launches()
    tree = mcts.search(states, eval_fn, spec,
                       tree=mcts.init_tree(states, spec, tree=tree))
    torch.cuda.synchronize()
    assert graph.STATS.captures == captures
    n = graph.STATS.replays - replays
    assert n == spec.num_simulations
    assert tuple(a - b for a, b in zip(_launches(), before)) == \
        (n + 1, n + 1, 0)
    assert bool((tree.root_visit == spec.num_simulations).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B,C", [(1, 128), (512, 256)])
def test_cuda_one_board_and_C_256_keep_the_per_layer_route(cuda, B, C):
    """At one board, and at C 256 (which the kernel does not take), the
    forward launches no ``tower_forward``: two ``conv3x3`` and one
    ``se_residual`` a block."""
    net = _archive_net(cuda) if C == 128 else _random_net(2, C, 5).to(cuda)
    prep = inference.prepare_inference(net, torch.bfloat16)
    assert (prep["tower"] is None) is (C != 128)
    planes = torch.from_numpy(_planes(np.random.default_rng(B), B)).to(cuda)
    before = _launches()
    inference.inference_apply(prep, planes)
    torch.cuda.synchronize()
    n = len(net.blocks)
    assert tuple(a - b for a, b in zip(_launches(), before)) == \
        (0, 2 * n + 1, n)
