"""The encoder body's fused DeepNorm residual and LayerNorm
(``models/encoder_epilogue.py``): on the CPU the wrapper is the
``torch.add`` and ``F.layer_norm`` pair bit for bit, it refuses what the
kernel does not take, and the bf16 evaluator's forward is what it was with
the pair. The tests marked ``gpu`` import no JAX and hold the kernel to its
plain version on the card (``python -m pytest --noconftest -m gpu
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
    second product, each with the rows it skipped over."""
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
