"""The nested-bottleneck body (``models/nbt.py``), its bf16 evaluator route
(``models/nbt_inference.py``) and its kernels' wrappers
(``models/nbt_epilogue.py``) against the plain reference
``benchmark/lib/refnbt.py``.

On the CPU at ``tiny_nbt_config``'s size (3 blocks on a trunk of 32, mid
16, the third block pooling 8 channels), on weights drawn as the
benchmark draws them (``benchmark/lib/nbt.py``: the norms calibrated,
their scales and biases drawn): the float32 net, the route's CPU path in
float32 and bfloat16, a halo case and a pool whose terms differ in sign,
the FLOP count against hooks on the module. The tests marked ``gpu``
import no JAX and hold the kernels, the padded conv and the captured
evaluator on the card (``python -m pytest --noconftest -m gpu
tests/test_torch_nbt.py``).
"""

import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(1)

from alphazero_torch.config import Config, tiny_nbt_config
from alphazero_torch.env import breakthrough as env
from alphazero_torch.models import conv, epilogue, nbt_epilogue, nbt_inference
from alphazero_torch.models.nbt import INNER, NbtNet
from alphazero_torch.models.network import build_network
from alphazero_torch.search import graph, mcts
from benchmark.drivers.selfplay_nbt import NBT_FIELDS
from benchmark.lib import nbt as bench_nbt
from benchmark.lib import refnbt as ref
from benchmark.rooflines import nbt as roof

def _bench_cfg(cfg: Config) -> dict:
    """The benchmark's configuration of the program's ``cfg``."""
    return {**{k: getattr(cfg, k) for k in NBT_FIELDS}, "nbt_inner": INNER,
            "input_planes": cfg.input_planes,
            "weights": {"seeded": True, "calibrated_positions": 4096}}


def _weights(cfg=None, seed=0, device="cpu", bias_at_least=0.0):
    """The benchmark's seeded, calibrated weights; with ``bias_at_least``
    every norm's bias is moved to at least that magnitude, its sign kept."""
    cfg = cfg or tiny_nbt_config()
    w = bench_nbt.seeded(_bench_cfg(cfg), seed, device)
    if bias_at_least:
        g = torch.Generator().manual_seed(seed)
        for k, v in w.items():
            if k.endswith(".bias") and f"{k[:-5]}.running_mean" in w:
                mag = bias_at_least + 0.5 * torch.rand(v.shape, generator=g)
                w[k] = torch.where(v < 0, -mag, mag).to(v)
    return w


def _net(w, cfg=None, device="cpu"):
    cfg = cfg or tiny_nbt_config()
    with torch.device(device):
        net = build_network(cfg, device)
    own = net.state_dict()
    net.load_state_dict({**w, **{k: v for k, v in own.items()
                                 if k.endswith("batches_tracked")}})
    return net.eval()


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


def _priors_values(policy_logits, wl_logits, legal):
    p = torch.softmax(policy_logits.float(), -1) * legal
    p = p / p.sum(-1, keepdim=True)
    wl = torch.softmax(wl_logits.float(), -1)
    return p, wl[:, 0] - wl[:, 1]


def _tv(a, b):
    return 0.5 * (a - b).abs().sum(-1)


def _rel(a, b):
    return float(((a - b).abs().max() / b.abs().max()).detach())


def test_the_float32_net_matches_the_reference():
    # the same equations in float32 on the CPU, the reference written
    # apart: BatchNorm's kernel against the reference's affine and the
    # order of a few sums may differ, some 1e-7 of the largest logit
    w = _weights()
    net = _net(w)
    planes, _ = _positions(16)
    p, wl = net(planes)
    rp, rwl = ref.forward(w, planes)
    assert _rel(p, rp) <= 1e-5 and _rel(wl, rwl) <= 1e-5


def test_the_route_on_the_cpu_against_the_reference():
    """The bf16 route's CPU path (the kernels' plain versions) in float32
    reads the reference's logits to float32 rounding (1e-5: the same sums,
    the norms as (mean, mul, beta) and the value head's pooled terms folded
    into one matrix); in bfloat16 its priors are within 0.03 in total
    variation on average and its values within 0.05 (bf16 rounding of
    every map over three blocks, well under a tenth of a uniform prior's
    spread), while the float8 control's priors read several times more."""
    w = _weights(seed=1)
    net = _net(w)
    planes, legal = _positions(64, seed=3)
    rp, rwl = ref.forward(w, planes)
    p32, wl32 = nbt_inference.apply(nbt_inference.prepare(net, torch.float32),
                                    planes)
    assert _rel(p32, rp) <= 1e-5 and _rel(wl32, rwl) <= 1e-5
    want_p, want_v = _priors_values(rp, rwl, legal)
    p16, wl16 = nbt_inference.apply(
        nbt_inference.prepare(net, torch.bfloat16), planes)
    got_p, got_v = _priors_values(p16, wl16, legal)
    tv = float(_tv(got_p, want_p).mean())
    assert tv < 0.03 and float((got_v - want_v).abs().max()) < 0.05
    p8, v8 = ref.evaluate(w, planes, legal, fp8=True)
    assert float(_tv(p8, want_p).mean()) > 2 * tv


def test_the_halo_reads_zeros_as_katago_pads():
    """KataGo pads the activated map with zeros: a 3x3 conv's halo is 0,
    not relu(N(0)). With every norm's bias 0.5 or more in magnitude the
    route matches the reference (float32, 1e-5), while a conv whose halo
    is relu(N(0)) (the norm-act taken as the conv's prologue over the
    zero-padded raw map) lands far from it."""
    w = _weights(seed=2, bias_at_least=0.5)
    net = _net(w)
    planes, _ = _positions(16, seed=4)
    rp, rwl = ref.forward(w, planes)
    p, wl = nbt_inference.apply(nbt_inference.prepare(net, torch.float32),
                                planes)
    assert _rel(p, rp) <= 1e-5 and _rel(wl, rwl) <= 1e-5

    real = F.conv2d
    name = "blocks.0.inner.0"
    mean, var = w[f"{name}.norm1.running_mean"], w[f"{name}.norm1.running_var"]
    halo = torch.relu(w[f"{name}.norm1.bias"] - mean * w[f"{name}.norm1.weight"]
                      / torch.sqrt(var + ref.EPS))
    target = w[f"{name}.conv1.weight"]
    assert float(halo.abs().max()) > 0.1

    def prologue_conv(x, weight, padding=0, **kw):
        if weight is target:
            x = F.pad(x - halo[:, None, None], (1, 1, 1, 1)) \
                + halo[:, None, None]
            return real(x, weight, **kw)
        return real(x, weight, padding=padding, **kw)

    try:
        ref.F.conv2d = prologue_conv
        bad, _ = ref.forward(w, planes)
    finally:
        ref.F.conv2d = real
    assert _rel(bad, rp) > 1e-2


def test_a_pool_whose_mean_and_max_terms_differ_in_sign():
    """``gpool_bias``'s plain version against the bias written out here in
    float64: g's mean is positive, its scaled mean (-0.6 mean) negative
    and its max positive and larger, and ``w`` weighs the three terms
    apart, so swapping a term or its sign moves the result."""
    g = torch.Generator().manual_seed(5)
    B, R, G = 3, 16, 8
    y = torch.randn(B, 64, R + G, generator=g)
    y[..., R:] += 0.5
    bn_g = (torch.zeros(G), torch.ones(G), torch.zeros(G))
    bn = (0.1 * torch.randn(R, generator=g), 1 + 0.1 * torch.rand(R,
                                                                  generator=g),
          0.1 * torch.randn(R, generator=g))
    w = torch.randn(3 * G, R, generator=g)
    got = nbt_epilogue.gpool_bias(y, bn_g, w, bn, R, R + 8)
    assert got.shape == (B, 64, R + 8) and not bool(got[..., R:].any())

    gv = torch.relu(y[..., R:].double())
    mean, mx = gv.mean(1), gv.amax(1)
    assert bool((mean > 0).all()) and bool((mx > mean).all())
    wd = w.double()

    def bias_of(t1, t2, t3):
        return t1 @ wd[:G] + t2 @ wd[G:2 * G] + t3 @ wd[2 * G:]

    def out_of(bias):
        m, k, b = (t.double() for t in bn)
        return torch.relu(((y[..., :R].double() + bias[:, None]) - m) * k
                          + b)

    want = out_of(bias_of(mean, -0.6 * mean, mx))
    assert float((got[..., :R].double() - want).abs().max()) < 1e-4
    for wrong in (bias_of(mx, -0.6 * mean, mean),
                  bias_of(mean, 0.6 * mean, mx)):
        assert float((out_of(wrong) - want).abs().max()) > 0.1


def test_residual_act_on_the_cpu_is_its_plain_version():
    g = torch.Generator().manual_seed(6)
    y = torch.randn(128, 32, generator=g).bfloat16()
    r = torch.randn(128, 32, generator=g).bfloat16()
    bn = (torch.randn(32, generator=g), torch.rand(32, generator=g) + 0.5,
          torch.randn(32, generator=g))
    s, a = nbt_epilogue.residual_act(y, bn, r)
    assert torch.equal(s, (r.float() + y.float()).bfloat16())
    m, k, b = bn
    assert torch.equal(a, torch.relu((s.float() - m) * k + b).bfloat16())
    with pytest.raises(ValueError, match="multiple of 8"):
        nbt_epilogue.residual_act(torch.zeros(4, 12), bn, torch.zeros(4, 12))
    with pytest.raises(ValueError, match="differ"):
        nbt_epilogue.residual_act(y, bn, r[:64])
    with pytest.raises(ValueError, match="do not fit"):
        nbt_epilogue.gpool_bias(torch.zeros(1, 64, 16), bn, torch.zeros(24, 8),
                                bn, 12, 12)


def test_the_flop_count_against_hooks_on_the_module():
    """``benchmark/lib/nbt.forward_flops`` against a count taken by hooks
    on every convolution and dense layer of the module's forward (2 a
    multiply-add), at the tiny size and at a mid size with two pooling
    blocks."""
    for cfg in (tiny_nbt_config(),
                tiny_nbt_config(nbt_blocks=6, nbt_trunk=48, nbt_mid=24,
                                nbt_gpool=8, nbt_head=16)):
        net = build_network(cfg, "cpu")
        counted = []

        def hook(m, inputs, out):
            if isinstance(m, torch.nn.Conv2d):
                k = m.kernel_size[0] * m.kernel_size[1]
                counted.append(2 * out.numel() * m.in_channels * k)
            else:
                counted.append(2 * out.numel() * m.in_features)

        for m in net.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.register_forward_hook(hook)
        with torch.no_grad():
            net(torch.zeros(1, 3, 8, 8))
        assert sum(counted) == bench_nbt.forward_flops(_bench_cfg(cfg))


def test_b28c512nbt_counts_are_pinned():
    cfg = _bench_cfg(Config(body="nbt"))
    assert bench_nbt.forward_flops(cfg) == 9_240_486_400
    assert bench_nbt.count_params(cfg) == 72_656_322
    assert len(roof.conv3x3_sites(cfg)) == 112
    assert roof.conv3x3_sites(cfg).count((192, 256)) == 9
    assert roof.gpool_sites(cfg) == [(192, 64)] * 9 + [(64, 64)]
    assert len(roof.residual_sites(cfg)) == 28 * 3
    assert roof.conv3x3_ops(512, 256, 256) == 2 * 512 * 64 * 9 * 256 * 256


def test_make_net_evaluator_takes_the_nbt_route_by_type():
    w = _weights()
    net = _net(w)
    assert isinstance(net, NbtNet)
    planes, legal = _positions(8, seed=9)
    got_p, got_v = mcts.make_net_evaluator(net, torch.float32)(planes)
    want = nbt_inference.apply(nbt_inference.prepare(net, torch.float32),
                               planes)
    want_p, want_v = _priors_values(*want, torch.ones_like(legal))
    assert torch.allclose(got_p, want_p, atol=1e-5)
    assert torch.allclose(got_v, want_v, atol=1e-5)
    before = nbt_epilogue.gpool_bias.launches
    mcts.make_net_evaluator(net, torch.bfloat16)(planes)
    assert nbt_epilogue.gpool_bias.launches == before   # the CPU's plain


def test_the_config_round_trips_its_arch_and_int8_refuses_it(tmp_path):
    from alphazero_torch.models import convert, quant
    from alphazero_torch.train import Trainer

    small = tiny_nbt_config()
    assert Config().with_arch(small.arch()).arch() == small.arch()
    assert small.with_arch(Config().arch()).body == "se_resnet"
    assert small.arch()["nbt_gpool"] == 8
    net = build_network(small, "cpu")
    with pytest.raises(ValueError, match="SE-ResNet"):
        quant.quantize_network(net)
    with pytest.raises(ValueError, match="SE-ResNet"):
        convert.load_flat_into(net, {})
    with pytest.raises(ValueError, match="int8 evaluator"):
        Trainer(tiny_nbt_config(selfplay_quant="static",
                                checkpoint_dir=str(tmp_path)), device="cpu")


def test_a_learner_step_against_autograd_through_the_reference():
    """The module's loss gradients in train mode are autograd's through
    the same equations: here the module's eval-mode forward and the
    reference's share their gradients to float32 rounding."""
    w = _weights(seed=4)
    net = _net(w)
    planes, _ = _positions(8, seed=10)
    p, wl = net(planes)
    (p.square().mean() + wl.square().mean()).backward()
    leaf = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    rp, rwl = ref.forward(leaf, planes)
    (rp.square().mean() + rwl.square().mean()).backward()
    grads = dict(net.named_parameters())
    for k in ("input_conv.weight", "blocks.2.inner.0.gpool_fc.weight",
              "blocks.1.inner.1.conv2.weight", "policy_gpool_fc.weight",
              "value_fc1.weight", "norm_final.weight"):
        assert _rel(grads[k].grad, leaf[k].grad) < 1e-4, k


# -----------------------------------------------------------------------------
# On the card
# -----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bn(C, g, dev):
    return (torch.randn(C, generator=g, device=dev),
            torch.rand(C, generator=g, device=dev) + 0.5,
            torch.randn(C, generator=g, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("boards", [1, 3, 32, 512])
@pytest.mark.parametrize("C", [64, 256, 512])
def test_cuda_residual_act_against_its_plain_version(cuda, boards, C):
    """Bit for bit: the kernel rounds where the plain version rounds and
    runs the affine without FMA; and ``epilogue.bn_act``, the body's
    norm-act without a residual, on the same rows as a (B, 8, 8, C) map."""
    g = torch.Generator(device=cuda).manual_seed(boards * C)
    y = torch.randn(boards * 64, C, generator=g, device=cuda).bfloat16()
    r = torch.randn(boards * 64, C, generator=g, device=cuda).bfloat16()
    bn = _bn(C, g, cuda)
    before = nbt_epilogue.residual_act.launches
    s, a = nbt_epilogue.residual_act(y, bn, r)
    a0 = epilogue.bn_act(y.view(boards, 8, 8, C), bn)
    torch.cuda.synchronize()
    assert nbt_epilogue.residual_act.launches == before + 1
    ws, wa = nbt_epilogue.residual_act_plain(y, bn, r)
    assert torch.equal(s, ws) and torch.equal(a, wa)
    assert torch.equal(a0.view(y.shape), epilogue.bn_act_plain(y, bn))


@pytest.mark.gpu
@pytest.mark.parametrize("boards", [1, 3, 32, 512])
@pytest.mark.parametrize("shape", [(192, 64, 256, 256), (64, 64, 128, 64)],
                         ids=["trunk", "policy"])
def test_cuda_gpool_bias_against_its_plain_version(cuda, boards, shape):
    """The trunk's pooling blocks (R 192, G 64, 256 in and out, zero
    padded) and the policy head's (64 and 64, 128 in, 64 out): within
    ``gpool_card_check``'s bound of the plain version (the pool's and the
    product's float32 sums in another order), the padding exactly 0, and
    the same bits on a second launch."""
    R, G, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(boards + cin)
    y = torch.randn(boards, 64, cin, generator=g, device=cuda).bfloat16()
    bn_g, bn = _bn(G, g, cuda), _bn(R, g, cuda)
    w = torch.randn(3 * G, R, generator=g, device=cuda) / (3 * G) ** 0.5
    got = nbt_epilogue.gpool_bias(y, bn_g, w, bn, R, cout)
    torch.cuda.synchronize()
    res = nbt_epilogue.gpool_card_check(y, bn_g, w, bn, R, cout, got)
    assert res["ok"], res
    assert torch.equal(nbt_epilogue.gpool_bias(y, bn_g, w, bn, R, cout), got)


@pytest.mark.gpu
@pytest.mark.parametrize("boards", [1, 512])
def test_cuda_conv3x3_on_the_padded_pooling_conv(cuda, boards):
    """The pooling block's 192 -> 256 conv as ``conv3x3`` runs it: the
    input zero-padded to 256 channels and the weights zero there, held by
    ``conv.card_check`` to the published conv of the 192 channels alone
    (the padding adds exact zeros to every sum), at most twice cuDNN's
    unequal share on the unpadded operands or ``CONV_UNEQUAL_SHARE``, as
    ``tests/test_torch_conv.py`` holds every conv3x3 site."""
    g = torch.Generator(device=cuda).manual_seed(boards)
    v = torch.randn(boards, 8, 8, 192, generator=g, device=cuda).bfloat16()
    w = (torch.randn(256, 192, 3, 3, generator=g, device=cuda)
         / 41.6).bfloat16()
    vp = F.pad(v, (0, 64)).contiguous()
    wp = F.pad(w, (0, 0, 0, 0, 0, 64)).contiguous()
    got = conv.conv3x3(vp, wp, image=conv.weight_image(wp))
    torch.cuda.synchronize()
    want = conv.conv3x3_plain(v, w, f64_sums=True)
    bn = tuple(torch.zeros(256, device=cuda) for _ in range(3))
    cudnn = F.conv2d(v.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    limit = max(conv.CONV_UNEQUAL_SHARE,
                2 * float((cudnn != want).float().mean()))
    res = conv.card_check(v, w, bn, {"none": got}, limit)
    assert res["ok"], res
    assert float((got.float() - want.float()).abs().max()) < 0.1


@pytest.mark.gpu
def test_cuda_nbt_evaluator_against_the_reference_and_captured(cuda):
    """Four blocks at b28c512nbt's widths (the second pooling), 512
    boards: the bf16 route's priors within 0.03 in total variation on
    average of the reference's in float32, and the route captured in a
    CUDA graph and replayed on new planes bit-equal to the route run
    eagerly, its kernels counted on each replay."""
    cfg = Config(body="nbt", nbt_blocks=4)
    w = _weights(cfg, seed=11, device=cuda)
    net = _net(w, cfg, cuda)
    eval_fn = mcts.make_net_evaluator(net, torch.bfloat16)
    planes, legal = _positions(512, seed=7, device=cuda)
    got_p, got_v = eval_fn(planes)
    want_p, want_v = ref.evaluate(w, planes, legal)
    got_p = got_p * legal
    got_p = got_p / got_p.sum(-1, keepdim=True)
    assert float(_tv(got_p, want_p).mean()) < 0.03
    assert float((got_v - want_v).abs().mean()) < 0.05
    static = planes.clone()
    torch.cuda.synchronize()
    graph_ = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph_):
        out = eval_fn(static)
    new, _ = _positions(512, seed=8, device=cuda)
    static.copy_(new)
    graph_.replay()
    again = eval_fn(new)
    torch.cuda.synchronize()
    assert torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])


@pytest.mark.gpu
def test_cuda_captured_nbt_search_counts_its_launches(cuda):
    """Eight simulations of 64 games through ``mcts.search``, captured and
    eager, at b28c512nbt's widths with 3 blocks: the same trees bit for
    bit, and each forward's launches counted: a gpool_bias a pooling
    block and the policy head's, 3 residual_act a block (the inner blocks'
    and the block's close) and 1 + 1 a block + 1 bn_act."""
    cfg = Config(body="nbt", nbt_blocks=3)
    w = _weights(cfg, seed=12, device=cuda)
    eval_fn = mcts.make_net_evaluator(_net(w, cfg, cuda), torch.bfloat16)
    spec = mcts.SearchSpec(num_simulations=8)
    st = env.initial_state((64,), device=cuda)
    eager = mcts.search(st, eval_fn, spec, capture=False)
    before = (nbt_epilogue.gpool_bias.launches,
              nbt_epilogue.residual_act.launches, epilogue.bn_act.launches)
    replays = graph.STATS.replays
    captured = mcts.search(st, eval_fn, spec, capture=True)
    torch.cuda.synchronize()
    assert torch.equal(eager.rows, captured.rows)
    assert graph.STATS.replays - replays == 8 - graph.WARMUP
    forwards = 1 + 8
    assert nbt_epilogue.gpool_bias.launches - before[0] == 2 * forwards
    assert nbt_epilogue.residual_act.launches - before[1] == 3 * 3 * forwards
    assert epilogue.bn_act.launches - before[2] == (1 + 3 + 1) * forwards


@pytest.mark.gpu
def test_cuda_build_network_refuses_a_mid_width_conv3x3_lacks(cuda):
    with pytest.raises(ValueError, match="mid width"):
        build_network(tiny_nbt_config(), cuda)
