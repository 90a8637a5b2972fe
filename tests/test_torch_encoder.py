"""The encoder body (``models/encoder.py``), its bf16 evaluator route
(``models/encoder_inference.py``) and its attention kernel's wrapper
(``models/attention.py``) against the plain reference
``benchmark/lib/refencoder.py``.

On the CPU at ``tiny_encoder_config``'s size, on seeded weights with every
parameter moved off DeepNet's initial values (so biases, LayerNorms and
gates all count): the float32 net, the bf16 route's CPU path, the
attention's plain version, a learner step's loss and gradients; the
yardstick's counts at BT4's widths. The tests marked ``gpu`` import no
JAX and hold the kernel and the captured evaluator on the card
(``python -m pytest --noconftest -m gpu tests/test_torch_encoder.py``).
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from alphazero_torch import cuda_build
from alphazero_torch.config import Config, tiny_encoder_config
from alphazero_torch.env import breakthrough as env
from alphazero_torch.models import (attention, encoder_epilogue,
                                    encoder_inference)
from alphazero_torch.models.encoder import EncoderNet, encoder_from_config
from alphazero_torch.models.network import build_network, count_params
from alphazero_torch.search import graph, mcts
from alphazero_torch.train.learner import loss_fn
from benchmark.lib import refencoder as ref

ROOT = Path(__file__).resolve().parent.parent


def _net(cfg=None, seed=0, device="cpu"):
    cfg = cfg or tiny_encoder_config()
    net = build_network(cfg, device, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(100 + seed)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g).to(p.device))
    return net


def _positions(n, seed=0, plies=12, device="cpu"):
    """``n`` positions ``plies`` random legal moves into their games."""
    g = torch.Generator().manual_seed(seed)
    st = env.initial_state((n,), device="cpu")
    for _ in range(plies):
        legal = env.legal_action_mask(st).float()
        a = torch.multinomial(legal + 1e-9, 1, generator=g)[:, 0]
        st = env.step(st, a)
    return (env.encoded_state(st).to(device),
            env.legal_action_mask(st).to(device))


def _weights(net):
    return {k: v.detach() for k, v in net.state_dict().items()}


def _priors_values(policy_logits, wl_logits, legal):
    p = torch.softmax(policy_logits.float(), -1) * legal
    p = p / p.sum(-1, keepdim=True)
    wl = torch.softmax(wl_logits.float(), -1)
    return p, wl[:, 0] - wl[:, 1]


def _tv(a, b):
    return 0.5 * (a - b).abs().sum(-1)


def test_the_float32_net_matches_the_reference():
    # the same equations in float32 on the CPU, the reference written
    # apart: only the order of a few sums may differ
    net = _net()
    planes, _ = _positions(16)
    p, wl = net(planes)
    p_ref, wl_ref = ref.forward(_weights(net), planes,
                                tiny_encoder_config().enc_heads)
    torch.testing.assert_close(p, p_ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(wl, wl_ref, atol=1e-4, rtol=0)


def test_the_attention_policy_reads_the_moves_of_the_env():
    """Action 3s + d reads the map at (s, target of the move), off-board
    targets masked: the net's table and the reference's agree with
    ``env.decode_action_to_move`` in the canonical (white) frame."""
    net = EncoderNet(1, 16, 2, 16, 2, 8, 8, 16)
    for a in range(192):
        fr_r, fr_c, to_r, to_c = env.decode_action_to_move(a, env.WHITE)
        on = 0 <= to_r < 8 and 0 <= to_c < 8
        assert bool(net.policy_valid[a]) == on
        if on:
            assert int(net.policy_index[a]) == (fr_r * 8 + fr_c) * 64 \
                + to_r * 8 + to_c
    index, valid = ref.action_targets()
    assert torch.equal(index, net.policy_index)
    assert torch.equal(valid, net.policy_valid)


def test_the_bf16_route_on_the_cpu_against_the_reference():
    """The evaluator's bf16 route (the attention's plain version on the
    CPU) against the float32 reference. Each operand rounded to bf16 (8
    bits) moves a 2-layer net's priors by some 0.006 in total variation on
    average (0.004-0.006 over three seeds) and its values by at most 0.03;
    the float8 control (4 bits) moves them by 0.036-0.054 and 0.34. The
    limits lie between: 0.015 and 0.06."""
    net = _net()
    planes, legal = _positions(64)
    w = _weights(net)
    heads = tiny_encoder_config().enc_heads
    p_ref, v_ref = ref.evaluate(w, planes, legal, heads)
    prep = encoder_inference.prepare(net, torch.bfloat16)
    p, v = _priors_values(*encoder_inference.apply(prep, planes), legal)
    assert float(_tv(p, p_ref).mean()) < 0.015
    assert float((v - v_ref).abs().max()) < 0.06
    p8, v8 = ref.evaluate(w, planes, legal, heads, fp8=True)
    assert float(_tv(p8, p_ref).mean()) > 0.015
    assert float((v8 - v_ref).abs().max()) > 0.06


def test_make_net_evaluator_takes_the_encoder_route_by_type():
    net = _net()
    planes, _ = _positions(8)
    eval_fn = mcts.make_net_evaluator(net, torch.bfloat16)
    prep = encoder_inference.prepare(net, torch.bfloat16)
    p, v = eval_fn(planes)
    logits, wl = encoder_inference.apply(prep, planes)
    torch.testing.assert_close(p, torch.softmax(logits, -1))
    p32, v32 = mcts.make_net_evaluator(net)(planes)
    torch.testing.assert_close(p32, torch.softmax(net(planes)[0], -1))
    assert attention.smolgen_attention in cuda_build.COUNTED


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smolgen_attention_plain_against_the_reference_attention(dtype):
    """The plain version (what the kernel computes) against a softmax
    written as the reference writes it, on the same operands: in float32
    they agree to rounding; in bf16 the plain version rounds the
    softmax's numerators before the product with V, as the kernel does,
    and its output, each a step of 2^-8 at most relative."""
    g = torch.Generator().manual_seed(3)
    B, H, D, G = 3, 4, 8, 16
    qkv = torch.randn(B * 64, 3 * H * D, generator=g).to(dtype)
    s = torch.randn(B, H, G, generator=g).to(dtype)
    wgen_t = (torch.randn(4096, G, generator=g) / 4).to(dtype)
    got = attention.smolgen_attention(qkv, s, wgen_t, H)
    assert got.dtype == dtype and got.shape == (B * 64, H * D)
    q, k, v = qkv.float().view(B, 64, 3, H, D).permute(2, 0, 3, 1, 4)
    bias = (s.float() @ wgen_t.float().T).view(B, H, 64, 64)
    a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(D) + bias, -1) @ v
    want = a.transpose(1, 2).reshape(B * 64, H * D)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


def _wgen_from_image(image, gen):
    """The (4096, ``gen``) matrix that ``attention.wgen_image`` packed: the
    packing's index map read backwards."""
    pb, kt = image.shape[:2]
    n = torch.arange(128)
    src = torch.arange(8)[None, :] ^ (n[:, None] % 8)
    w = image.reshape(pb, kt, 128, 8, 8)
    w = w.gather(-2, src[..., None].expand(w.shape)).transpose(1, 2)
    w = w.reshape(pb * 128, kt * 64)
    out = torch.empty_like(w)
    out[:, attention.k_order(kt * 64)] = w
    return out[:, :gen]


@pytest.mark.parametrize("gen", [256, 32])
def test_the_wgen_image_reads_back_through_its_inverse(gen):
    """``wgen_image`` at BT4's smolgen width and at
    ``tiny_encoder_config``'s (padded to one 64-wide k-tile): its inverse
    gives the (4096, G) matrix back, and each value lies where the
    kernel's descriptor reads it: k in ``k_order`` (place 16 h + 8 u + 2 t
    + e of each 32 holds k 8 t + 4 h + 2 u + e), then tile (position // 128,
    place // 64), row position % 128, 16-byte piece (place % 64 // 8) ^
    (position % 8)."""
    order = attention.k_order(64)
    assert sorted(order.tolist()) == list(range(64))
    assert order[:8].tolist() == [0, 1, 8, 9, 16, 17, 24, 25]
    assert order[8:16].tolist() == [2, 3, 10, 11, 18, 19, 26, 27]
    assert order[16:18].tolist() == [4, 5] and order[24:26].tolist() == [6, 7]
    g = torch.Generator().manual_seed(gen)
    w = torch.randn(4096, gen, generator=g).bfloat16()
    image = attention.wgen_image(w)
    assert image.shape == (32, -(-gen // 64), 128, 64) \
        and image.is_contiguous()
    assert torch.equal(_wgen_from_image(image, gen), w)
    p = torch.arange(4096)[:, None]
    place = torch.arange(-(-gen // 64) * 64)[None, :]
    at = image[p // 128, place // 64, p % 128,
               ((place % 64 // 8) ^ (p % 8)) * 8 + place % 8]
    k = attention.k_order(place.shape[1])
    padded = torch.nn.functional.pad(w, (0, place.shape[1] - gen))
    assert torch.equal(at, padded[:, k])
    # the padding of k past G is zeros
    assert torch.count_nonzero(image) == torch.count_nonzero(w)


def test_prepare_packs_the_wgen_image_only_on_a_card():
    """On the CPU no packed image is made: neither W_gen's nor
    ``dense_mish``'s of the feed-forward and the policy embedding, which
    keep their plain (in, out) matrices."""
    prep = encoder_inference.prepare(_net(), torch.bfloat16)
    assert prep["wgen_image"] is None
    assert prep["wgen_t"].shape == (4096, tiny_encoder_config().smolgen_gen)
    cfg = tiny_encoder_config()
    for w, b, image in [L["ffn1"] for L in prep["layers"]] \
            + [prep["policy_embed"]]:
        assert image is None and w.shape[0] == cfg.enc_embed
        assert b.shape == (w.shape[1],)


def test_smolgen_attention_refuses_operands_that_do_not_fit():
    qkv = torch.zeros(64, 3 * 64)
    with pytest.raises(ValueError, match="do not fit"):
        attention.smolgen_attention(qkv, torch.zeros(1, 4, 16),
                                    torch.zeros(4096, 8), 4)
    with pytest.raises(ValueError, match="qkv must be"):
        attention.smolgen_attention(torch.zeros(63, 192),
                                    torch.zeros(1, 4, 16),
                                    torch.zeros(4096, 16), 4)


def test_a_learner_step_against_autograd_through_the_reference():
    """``learner.loss_fn`` on the net, and its gradients, against the same
    loss through the reference with its weights as autograd leaves."""
    net = _net()
    net.train()
    planes, legal = _positions(32, seed=1)
    g = torch.Generator().manual_seed(5)
    pi = torch.rand(32, 192, generator=g) * legal
    pi = pi / pi.sum(-1, keepdim=True)
    wl = torch.softmax(torch.randn(32, 2, generator=g), -1)
    loss, loss_pi, loss_wl = loss_fn(net, planes, pi, wl)
    net.zero_grad()
    loss.backward()

    w = {k: v.detach().clone().requires_grad_(True)
         for k, v in net.state_dict().items()}
    p_ref, wl_ref = ref.forward(w, planes, tiny_encoder_config().enc_heads)
    ref_loss = (-(pi * torch.log_softmax(p_ref, -1)).sum(-1).mean()
                - (wl * torch.log_softmax(wl_ref, -1)).sum(-1).mean())
    ref_loss.backward()
    torch.testing.assert_close(loss, ref_loss, atol=1e-5, rtol=0)
    for name, p in net.named_parameters():
        torch.testing.assert_close(p.grad, w[name].grad, atol=1e-5,
                                   rtol=1e-4, msg=name)


def test_bt4_counts_are_pinned():
    """BT4's 155,148,450 parameters and 15.92 GFLOP a board: the program's
    module, the benchmark's leaves and the configuration file agree."""
    import json

    from benchmark.lib import encoder as bench_encoder

    with open(ROOT / "benchmark" / "configs"
              / "lc0-bt4-1024x15x32h.json") as f:
        cfg = json.load(f)
    with torch.device("meta"):
        net = encoder_from_config(Config(body="encoder"))
    assert count_params(net) == bench_encoder.count_params(cfg) \
        == cfg["parameters"] == 155_148_450
    # a layer: QKV 402,653,184, O 134,217,728, the feed-forward pair
    # 402,653,184, Q K^T and P V 16,777,216, smolgen 4,194,304 +
    # 1,048,576 + 4,194,304 + 67,108,864; the input stage 8,781,824; the
    # policy 134,217,728 + 268,435,456 + 8,388,608; the value 4,194,304 +
    # 524,288 + 512
    layer = (402_653_184 + 134_217_728 + 402_653_184 + 16_777_216
             + 4_194_304 + 1_048_576 + 4_194_304 + 67_108_864)
    want = (8_781_824 + 15 * layer + 134_217_728 + 268_435_456
            + 8_388_608 + 4_194_304 + 524_288 + 512)
    assert bench_encoder.forward_flops(cfg) == want == 15_917_253_120
    shapes = {k: s for k, s, _ in bench_encoder.leaf_shapes(cfg)}
    own = net.state_dict()
    assert set(shapes) == set(own)
    for k, kind in ((k, kind) for k, _, kind
                    in bench_encoder.leaf_shapes(cfg)):
        want_shape = shapes[k][::-1] if kind == "kernel" else shapes[k]
        assert tuple(own[k].shape) == tuple(want_shape), k


def test_the_smolgen_attention_roofline_counts():
    from benchmark.rooflines import smolgen_attention as roof

    # 512 boards x 32 heads x (2*256*64^2 + 4*64^2*32); Q, K, V and the
    # output 4 x 512*64*1024, the vectors 512*32*256, W_gen 256*4096, bf16
    assert roof.ops(512, 32, 32, 256) == 42_949_672_960
    assert roof.bytes_moved(512, 32, 32, 256) == 2 * (
        4 * 33_554_432 + 4_194_304 + 1_048_576) == 278_921_216


def test_the_int8_and_archive_paths_refuse_the_encoder(tmp_path):
    from alphazero_torch.models import convert, quant
    from alphazero_torch.train import Trainer

    net = _net()
    with pytest.raises(ValueError, match="SE-ResNet"):
        quant.quantize_network(net)
    with pytest.raises(ValueError, match="SE-ResNet"):
        convert.load_flat_into(net, {})
    with pytest.raises(ValueError, match="int8 evaluator"):
        Trainer(tiny_encoder_config(selfplay_quant="static",
                                    checkpoint_dir=str(tmp_path)),
                device="cpu")
    with pytest.raises(ValueError, match="body"):
        build_network(Config(body="transformer"), "cpu")


def test_the_config_round_trips_its_arch():
    enc = tiny_encoder_config()
    assert Config().with_arch(enc.arch()).arch() == enc.arch()
    assert enc.with_arch(Config().arch()).body == "se_resnet"
    assert set(Config().arch()) == {"num_blocks", "num_filters", "se_ratio"}


# -----------------------------------------------------------------------------
# On the card
# -----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("boards", [1, 3, 32, 129, 512])
def test_cuda_smolgen_attention_against_its_plain_version(cuda, boards):
    """The kernel against the plain version on the same bf16 operands at
    BT4's widths (3 and 129 boards leave the last cluster's second board
    missing). The two take float32 sums in other orders and exp2
    against exp, so a numerator may round to the neighbouring bf16 value
    (2^-8 of it) in one and not the other: an output may differ by that
    share of the attention's sum of |V| (the plain version with V's
    magnitudes), twice over, and by two steps of its own rounding; at most
    2% of the outputs unequal. A second launch gives the same bits, and a
    launch on the prepacked ``wgen_image`` the same again."""
    g = torch.Generator(device=cuda).manual_seed(boards)
    H, D, G = 32, 32, 256
    qkv = torch.randn(boards * 64, 3 * H * D, generator=g,
                      device=cuda).bfloat16()
    s = torch.randn(boards, H, G, generator=g, device=cuda).bfloat16()
    wgen_t = (torch.randn(4096, G, generator=g, device=cuda)
              / 16).bfloat16()
    before = attention.smolgen_attention.launches
    got = attention.smolgen_attention(qkv, s, wgen_t, H)
    torch.cuda.synchronize()
    assert attention.smolgen_attention.launches == before + 1
    want = attention.smolgen_attention_plain(qkv, s, wgen_t, H)
    qkv_abs = qkv.clone()
    qkv_abs[:, 2 * H * D:] = qkv_abs[:, 2 * H * D:].abs()
    terms = attention.smolgen_attention_plain(qkv_abs, s, wgen_t, H).float()
    m = torch.maximum(got.float().abs(), want.float().abs())
    step = 2.0 ** (torch.floor(torch.log2(m.clamp_min(2 ** -60))) - 7)
    far = (got.float() - want.float()).abs() > 2 * step + 2 ** -7 * terms
    assert not bool(far.any()), int(far.sum())
    assert float((got != want).float().mean()) < 0.02
    image = attention.wgen_image(wgen_t)
    assert torch.equal(attention.smolgen_attention(qkv, s, wgen_t, H), got)
    assert torch.equal(attention.smolgen_attention(qkv, s, wgen_t, H, image),
                       got)


@pytest.mark.gpu
def test_cuda_captured_bt4_evaluator_against_eager(cuda):
    """The BT4 evaluator at 512 boards captured in a CUDA graph, replayed
    on new planes, against the same evaluator run eagerly: bit for bit
    (the same kernels on the same operands), with one smolgen_attention
    launch a layer counted on each replay."""
    cfg = Config(body="encoder")
    with torch.device(cuda):
        net = build_network(cfg, cuda)
    eval_fn = mcts.make_net_evaluator(net, torch.bfloat16)
    planes, _ = _positions(512, seed=7, device=cuda)
    static = planes.clone()
    eval_fn(static)                                  # warm-up, eager
    torch.cuda.synchronize()
    graph_ = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph_):
        out = eval_fn(static)
    new, _ = _positions(512, seed=8, device=cuda)
    static.copy_(new)
    graph_.replay()
    want = eval_fn(new)
    torch.cuda.synchronize()
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    assert np.isfinite(out[0].cpu().numpy()).all()


@pytest.mark.gpu
def test_cuda_captured_bt4_search_against_eager(cuda, monkeypatch):
    """Eight simulations of 512 games through ``mcts.search``, captured
    (two eager warm-up simulations, then replays) and eager: the same
    trees bit for bit, and the replays count one smolgen_attention launch,
    two deepnorm_ln launches a layer a simulation and 16 dense_mish
    launches a simulation (the feed-forward's first product of each layer
    and the policy embedding); the forwards run in Python call PyTorch's
    ``mish`` only at the input stage and the value head, 3 a forward."""
    cfg = Config(body="encoder")
    with torch.device(cuda):
        net = build_network(cfg, cuda)
    eval_fn = mcts.make_net_evaluator(net, torch.bfloat16)
    spec = mcts.SearchSpec(num_simulations=8)
    st = env.initial_state((512,), device=cuda)
    eager = mcts.search(st, eval_fn, spec, capture=False)
    calls = {"dense_mish": 0, "mish": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(encoder_inference, "dense_mish",
                        counting("dense_mish", encoder_inference.dense_mish))
    monkeypatch.setattr(encoder_inference.F, "mish",
                        counting("mish", encoder_inference.F.mish))
    before = attention.smolgen_attention.launches
    before_ln = encoder_epilogue.deepnorm_ln.launches
    before_dm = encoder_epilogue.dense_mish.launches
    replays = graph.STATS.replays
    captured = mcts.search(st, eval_fn, spec, capture=True)
    torch.cuda.synchronize()
    assert torch.equal(eager.rows, captured.rows)
    done = graph.STATS.replays - replays
    assert done == 8 - graph.WARMUP
    # the root's evaluation, the warm-up and the replays: one a layer each
    assert attention.smolgen_attention.launches - before == 15 * (1 + 8)
    assert encoder_epilogue.deepnorm_ln.launches - before_ln \
        == 15 * 2 * (1 + 8)
    assert encoder_epilogue.dense_mish.launches - before_dm == 16 * (1 + 8)
    assert calls["dense_mish"] > 0
    assert calls["mish"] * 16 == calls["dense_mish"] * 3


@pytest.mark.gpu
def test_cuda_build_network_refuses_widths_the_kernel_lacks(cuda):
    """On the card the encoder takes the widths ``smolgen_attention`` is
    compiled for: a net of other heads is refused when it is built, not
    at its first forward."""
    with pytest.raises(ValueError, match="32 heads of 32"):
        build_network(tiny_encoder_config(), cuda)
