"""The encoder body's fused DeepNorm residual and LayerNorm, and its
feed-forward's first product with the bias and Mish
(``models/encoder_epilogue.py``): on the CPU ``deepnorm_ln`` is the
``torch.add`` and ``F.layer_norm`` pair bit for bit and ``dense_mish`` is
Mish of a float32 ``addmm`` rounded once, both refuse what their kernels
do not take, and the bf16 evaluator's forward is what it was with the
pair. The tests marked ``gpu`` import no JAX and hold the kernels to their
plain versions on the card (``python -m pytest --noconftest -m gpu
tests/test_torch_encoder_epilogue.py``).
"""

import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(1)

from alphazero_torch import cuda_build
from alphazero_torch.config import Config, tiny_encoder_config
from alphazero_torch.env import breakthrough as env
from alphazero_torch.models import encoder_epilogue as ee
from alphazero_torch.models import encoder_inference
from alphazero_torch.models.encoder import LN_EPS, deepnorm_alpha
from alphazero_torch.models.network import build_network

ALPHA = deepnorm_alpha(15)


def _operands(rows, width, dtype, seed=0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    o, x = (torch.randn(rows, width, generator=g, device=device).to(dtype)
            for _ in range(2))
    gamma = (1 + 0.2 * torch.randn(width, generator=g, device=device)
             ).to(dtype)
    beta = (0.1 * torch.randn(width, generator=g, device=device)).to(dtype)
    return o, x, gamma, beta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deepnorm_ln_on_the_cpu_is_the_plain_pair(dtype):
    """On a CPU tensor, at BT4's width and at another, the wrapper is
    ``F.layer_norm(torch.add(o, x, alpha=alpha))`` bit for bit, and
    counts no launch."""
    before = ee.deepnorm_ln.launches
    for width in (1024, 48):
        o, x, gamma, beta = _operands(128, width, dtype)
        got = ee.deepnorm_ln(o, x, ALPHA, gamma, beta)
        want = F.layer_norm(torch.add(o, x, alpha=ALPHA), (width,), gamma,
                            beta, LN_EPS)
        assert got.dtype == dtype and torch.equal(got, want)
    assert ee.deepnorm_ln.launches == before


def _misaligned(t):
    """``t``'s values in a contiguous tensor that starts 2 bytes past a
    16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("case, error, match", [
    ("width", ValueError, "width 1024"),
    ("dtype", TypeError, "bfloat16"),
    ("gamma_dtype", TypeError, "gamma in bfloat16"),
    ("strided", ValueError, "contiguous"),
    ("misaligned", ValueError, "16-byte"),
    ("shapes", ValueError, "alike"),
    ("gamma_shape", ValueError, "do not fit"),
])
def test_deepnorm_ln_refuses_operands_that_do_not_fit(case, error, match):
    """What the kernel does not take raises before a launch: the checks of
    the card's path, run here on CPU tensors, and the shape checks of the
    CPU's path."""
    o, x, gamma, beta = _operands(64, 1024, torch.bfloat16)
    if case == "width":
        o, x, gamma, beta = _operands(64, 512, torch.bfloat16)
    elif case == "dtype":
        o, x = o.float(), x.float()
    elif case == "gamma_dtype":
        gamma = gamma.float()
    elif case == "strided":
        x = torch.cat([x, x], 1)[:, ::2]
    elif case == "misaligned":
        x = _misaligned(x)
        assert x.is_contiguous() and x.data_ptr() % 16
    elif case == "shapes":
        x = x[:32]
    elif case == "gamma_shape":
        gamma = gamma[:512]
    with pytest.raises(error, match=match):
        ee.check_kernel_operands(o, x, gamma, beta)
    if case in ("shapes", "gamma_shape"):
        with pytest.raises(error, match=match):
            ee.deepnorm_ln(o, x, ALPHA, gamma, beta)


def test_deepnorm_ln_is_counted_on_replays():
    assert ee.deepnorm_ln in cuda_build.COUNTED


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_evaluator_on_the_cpu_is_what_it_was(dtype, monkeypatch):
    """``encoder_inference.apply`` on the CPU against the same forward with
    each ``deepnorm_ln`` replaced by the pair it stands for: bit for bit."""
    net = build_network(tiny_encoder_config(), "cpu",
                        torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    st = env.initial_state((8,), device="cpu")
    for _ in range(3):
        st = env.step(st, torch.multinomial(
            env.legal_action_mask(st).float(), 1, generator=g)[:, 0])
    planes = env.encoded_state(st)
    prep = encoder_inference.prepare(net, dtype)
    got = encoder_inference.apply(prep, planes)

    def pair(o, x, alpha, gamma, beta):
        return F.layer_norm(torch.add(o, x, alpha=alpha), (o.shape[-1],),
                            gamma, beta, LN_EPS)

    monkeypatch.setattr(encoder_inference, "deepnorm_ln", pair)
    want = encoder_inference.apply(prep, planes)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _dense_operands(rows, N, dtype, seed=0, device="cpu", K=1024):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(rows, K, generator=g, device=device).to(dtype)
    w = (torch.randn(K, N, generator=g, device=device) / 32).to(dtype)
    b = (0.5 * torch.randn(N, generator=g, device=device)).to(dtype)
    return x, w, b


@pytest.mark.parametrize("N", [1536, 1024])
@pytest.mark.parametrize("boards", [1, 32, 512])
def test_dense_mish_plain_rounds_once(N, boards):
    """``dense_mish_plain`` at BT4's two sites (K 1024 into the
    feed-forward's 1536 and the policy embedding's 1024) is
    ``F.mish(torch.addmm(...))`` in float32 bit for bit, and in bf16 that
    float32 result rounded once: within half a bf16 step, plus the
    float32 sum's error (2^-16 of the sum of |x w| and |b|), of Mish of the
    float64 product."""
    x, w, b = _dense_operands(boards * 64, N, torch.bfloat16, seed=boards)
    want = F.mish(torch.addmm(b.float(), x.float(), w.float()))
    got32 = ee.dense_mish_plain(x.float(), w.float(), b.float())
    assert got32.dtype == torch.float32 and torch.equal(got32, want)
    got = ee.dense_mish_plain(x, w, b)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.bfloat16())
    for r in range(0, x.shape[0], 4096):        # float64 in blocks of rows
        xs = x[r:r + 4096].double()
        ref = F.mish(torch.addmm(b.double(), xs, w.double()))
        terms = torch.addmm(b.double().abs(), xs.abs(), w.double().abs())
        step = 2.0 ** (torch.floor(torch.log2(
            ref.abs().clamp_min(2 ** -60))) - 7)
        d = (got[r:r + 4096].double() - ref).abs()
        assert bool((d <= 0.5 * step + 2 ** -16 * terms).all())


def test_dense_mish_on_the_cpu_is_the_plain_version():
    """On a CPU tensor the wrapper is ``dense_mish_plain`` bit for bit in
    bf16 and float32, at BT4's width and at the tiny net's, and counts no
    launch."""
    before = ee.dense_mish.launches
    for dtype in (torch.float32, torch.bfloat16):
        for K, N in ((1024, 1536), (64, 96)):
            x, w, b = _dense_operands(128, N, dtype, K=K)
            got = ee.dense_mish(x, w, b)
            assert got.dtype == dtype
            assert torch.equal(got, ee.dense_mish_plain(x, w, b))
    assert ee.dense_mish.launches == before


@pytest.mark.parametrize("N", [1536, 1024, 512])
def test_the_dense_image_reads_back_through_its_inverse(N):
    """``dense_image`` is W^T cut into 256 x 64 tiles with each tile's
    16-byte pieces swizzled by row: undoing the swizzle and the tiling
    gives W back exactly."""
    K = 1024
    w = torch.randn(K, N).bfloat16()
    img = ee.dense_image(w)
    assert tuple(img.shape) == (N // 256, K // 64, 256, 64)
    assert img.is_contiguous()
    t = img.reshape(N // 256, K // 64, 256, 8, 8)
    r = torch.arange(256)
    # stored piece p of row r holds piece p ^ (r % 8)
    back = torch.empty_like(t)
    back[..., torch.arange(256)[:, None], torch.arange(8)[None, :] ^
         (r[:, None] % 8), :] = t
    back = back.transpose(1, 2).reshape(N, K)
    assert torch.equal(back.T, w)


@pytest.mark.parametrize("case, error, match", [
    ("k", ValueError, "K a multiple of 64"),
    ("n", ValueError, "N of 256"),
    ("dtype", TypeError, "x in bfloat16"),
    ("bias_dtype", TypeError, "b in bfloat16"),
    ("strided", ValueError, "contiguous"),
    ("misaligned", ValueError, "16-byte"),
    ("shapes", ValueError, "do not fit"),
    ("image", ValueError, r"image must be \(6, 16, 256, 64\)"),
])
def test_dense_mish_refuses_operands_that_do_not_fit(case, error, match):
    """What the kernel does not take raises before a launch: the checks of
    the card's path, run here on CPU tensors, and the shape check of the
    CPU's path."""
    x, w, b = _dense_operands(64, 1536, torch.bfloat16)
    image = None
    if case == "k":
        x, w, b = _dense_operands(64, 1536, torch.bfloat16, K=1000)
    elif case == "n":
        x, w, b = _dense_operands(64, 1000, torch.bfloat16)
    elif case == "dtype":
        x = x.float()
    elif case == "bias_dtype":
        b = b.float()
    elif case == "strided":
        x = torch.cat([x, x], 1)[:, ::2]
    elif case == "misaligned":
        x = _misaligned(x)
        assert x.is_contiguous() and x.data_ptr() % 16
    elif case == "shapes":
        x = x[:, :512]
    elif case == "image":
        image = ee.dense_image(w)[:, :8]
    with pytest.raises(error, match=match):
        ee.check_dense_kernel_operands(x, w, b, image)
    if case == "shapes":
        with pytest.raises(error, match=match):
            ee.dense_mish(x, w, b)


def test_dense_mish_is_counted_on_replays():
    assert ee.dense_mish in cuda_build.COUNTED


def test_the_evaluator_on_the_cpu_takes_dense_mish_at_its_16_sites(
        monkeypatch):
    """``encoder_inference.apply`` calls ``dense_mish`` at the
    feed-forward's first product of every layer and at the policy
    embedding (the tiny net's 2 layers: 3 calls), and PyTorch's ``mish``
    only at the input stage and the value head (3 calls)."""
    net = build_network(tiny_encoder_config(), "cpu",
                        torch.Generator().manual_seed(4))
    planes = env.encoded_state(env.initial_state((4,), device="cpu"))
    prep = encoder_inference.prepare(net, torch.bfloat16)
    calls = {"dense_mish": 0, "mish": 0}
    mish = F.mish

    def dense_mish(x, w, b, image=None):
        calls["dense_mish"] += 1
        return mish(torch.addmm(b.float(), x.float(), w.float())).to(x.dtype)

    def counted_mish(x):
        calls["mish"] += 1
        return mish(x)

    monkeypatch.setattr(encoder_inference, "dense_mish", dense_mish)
    monkeypatch.setattr(encoder_inference.F, "mish", counted_mish)
    encoder_inference.apply(prep, planes)
    assert calls == {"dense_mish": len(prep["layers"]) + 1, "mish": 3}


# -----------------------------------------------------------------------------
# On the card
# -----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _held(o, x, gamma, beta):
    before = ee.deepnorm_ln.launches
    got = ee.deepnorm_ln(o, x, ALPHA, gamma, beta)
    torch.cuda.synchronize()
    assert ee.deepnorm_ln.launches == before + 1
    assert got.shape == o.shape and got.dtype == torch.bfloat16
    r = ee.card_check(o, x, ALPHA, gamma, beta, got)
    assert r["ok"], r


@pytest.mark.gpu
@pytest.mark.parametrize("boards", [1, 32, 512])
def test_cuda_deepnorm_ln_against_its_plain_version(cuda, boards):
    """The kernel against ``deepnorm_ln_plain`` (PyTorch's ``add`` and
    ``layer_norm`` on the card) on random bf16 operands at 1, 32 and 512
    boards. Both round the sum and the output where the pair rounds and
    differ only in the order of the row's float32 sums and rsqrt's last
    bits, so an output may round to the neighbouring bf16 value:
    ``card_check`` allows two bf16 steps and, where the affine's terms
    cancel, 2^-16 of them, and at most ``UNEQUAL_SHARE`` unequal."""
    _held(*_operands(boards * 64, 1024, torch.bfloat16, seed=boards,
                     device=cuda))


@pytest.mark.gpu
def test_cuda_deepnorm_ln_on_a_seeded_bt4_layer(cuda):
    """The same check on both sites of a seeded BT4 net's first layer at
    512 boards: the attention's output projection and the feed-forward's
    second product, each with the rows it skipped over; and ``dense_mish``
    within ``dense_card_check`` on the same layer's feed-forward and on the
    policy embedding, each on its packed image."""
    from alphazero_torch.models.encoder_inference import _dense, _ln, prepare
    from alphazero_torch.models.attention import smolgen_attention

    B = 512
    net = build_network(Config(body="encoder"), cuda,
                        torch.Generator().manual_seed(21))
    prep = prepare(net)
    g = torch.Generator().manual_seed(22)
    st = env.initial_state((B,), device="cpu")
    for _ in range(10):
        st = env.step(st, torch.multinomial(
            env.legal_action_mask(st).float() + 1e-9, 1, generator=g)[:, 0])
    planes = env.encoded_state(st).to(cuda)
    H = prep["heads"]
    with torch.no_grad():
        tokens = planes.flatten(2).transpose(1, 2).bfloat16()
        x = F.mish(torch.matmul(tokens, prep["embed"]) + prep["position"])
        x = torch.addcmul(prep["gate_add"], x,
                          prep["gate_mult"]).reshape(B * 64, -1)
        L = prep["layers"][0]
        c = (x @ L["compress"]).view(B, -1)
        h = _ln(F.silu(_dense(c, L["sg1"])), L["sg_ln1"])
        s = _ln(F.silu(_dense(h, L["sg2"])), L["sg_ln2"]).view(B, H, -1)
        a = smolgen_attention(_dense(x, L["qkv"]), s.contiguous(),
                              prep["wgen_t"], H)
        o = _dense(a, L["o"])
        _held(o, x, *L["ln1"])
        x1 = ee.deepnorm_ln_plain(o, x, ALPHA, *L["ln1"])
        f = _dense(F.mish(_dense(x1, L["ffn1"])), L["ffn2"])
        _held(f, x1, *L["ln2"])
        # dense_mish at the same layer's feed-forward and at the policy
        # embedding, on the rows they read
        _dense_held(x1, *L["ffn1"])
        _dense_held(ee.deepnorm_ln_plain(f, x1, ALPHA, *L["ln2"]),
                    *prep["policy_embed"])


def _dense_held(x, w, b, image=None):
    before = ee.dense_mish.launches
    got = ee.dense_mish(x, w, b, image)
    torch.cuda.synchronize()
    assert ee.dense_mish.launches == before + 1
    assert got.shape == (x.shape[0], w.shape[1])
    assert got.dtype == torch.bfloat16
    r = ee.dense_card_check(x, w, b, got)
    assert r["ok"], r
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1536, 1024])
@pytest.mark.parametrize("boards", [1, 3, 32, 512])
def test_cuda_dense_mish_against_its_plain_version(cuda, N, boards):
    """The kernel against ``dense_mish_plain`` (float32 products on the
    card, TF32 off) on random bf16 operands at BT4's two sites and 1, 3
    (a tile's last 64 rows past the end), 32 and 512 boards. The sums are
    taken in another order and Mish from exp2 and a shared reciprocal, so
    an output may round to the neighbouring bf16 value: ``dense_card_check``
    allows two bf16 steps and, where the sum cancels, 2^-16 of the sum of
    |x w| and |b|, and at most ``DENSE_UNEQUAL_SHARE`` unequal. A second
    launch gives the same bits, and a launch on the prepacked image the
    same again."""
    assert not torch.backends.cuda.matmul.allow_tf32
    x, w, b = _dense_operands(boards * 64, N, torch.bfloat16,
                              seed=boards + N, device=cuda)
    got = _dense_held(x, w, b)
    assert torch.equal(ee.dense_mish(x, w, b), got)
    assert torch.equal(ee.dense_mish(x, w, b, ee.dense_image(w)), got)


@pytest.mark.gpu
def test_cuda_dense_mish_refuses_shapes_it_does_not_take(cuda):
    """On the card a K that is not a multiple of 64 or an N that is not a
    multiple of 256 raises before a launch, and the C entry itself refuses
    such an N: the launch raises, naming the kernel, and counts nothing."""
    for K, N in ((1000, 1536), (1024, 1000)):
        x, w, b = _dense_operands(64, N, torch.bfloat16, device=cuda, K=K)
        with pytest.raises(ValueError, match="the kernel takes K"):
            ee.dense_mish(x, w, b)
    x, w, b = _dense_operands(64, 1536, torch.bfloat16, device=cuda)
    image = ee.dense_image(w)
    out = torch.empty(64, 1536, dtype=torch.bfloat16, device=cuda)
    before = ee.dense_mish.launches
    with pytest.raises(RuntimeError, match="^dense_mish kernel launch "
                                           "failed: CUDA error"):
        cuda_build.launch(
            ee.dense_mish, ee.LIB.dense_mish_bf16, x.data_ptr(),
            image.data_ptr(), b.data_ptr(), out.data_ptr(), 64, 1024, 1000,
            ee.LIB.multiprocessors(cuda),
            torch.cuda.current_stream().cuda_stream)
    assert ee.dense_mish.launches == before
