"""The bf16 evaluator's 3x3 convolutions (``models/conv.py``) held against
the JAX package and against their plain version.

On the CPU, where ``conv3x3`` runs its plain version:

- ``conv3x3_plain`` with float64 sums is Flax's ``nn.Conv(dtype=bf16)``
  of the same weights within one bf16 step an element (or, where the
  terms cancel, within the float32 sum's own bound beside it: Flax's sums
  are float32); without them it is the ``F.conv2d`` the evaluator ran
  before, bit for bit, and its epilogue is ``bn_act_plain`` of the conv;
- a block through ``conv3x3(bn2)`` and ``se_residual(bn=None)`` is the
  block through ``se_residual(..., bn2)`` bit for bit;
- ``weight_image`` is a permutation that ``image_weights`` inverts;
- ``card_check`` (what ``chip_smoke.py`` holds the kernel to) accepts
  float32 sums in the kernel's order on the archived net's sites and
  rejects an epilogue that runs the affine on the unrounded sum.

The tests marked ``gpu`` hold the kernel against its plain version on the
card and import no JAX: ``python -m pytest --noconftest -m gpu
tests/test_torch_conv.py``.
"""

import copy
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(1)

from alphazero_torch.models import conv, epilogue, inference
from alphazero_torch.models.network import AlphaZeroNet

ARCHIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts", "model_r5_latest.npz")
EPS = 1e-5
EPILOGUES = conv.EPILOGUES


def _inputs(B, C, seed, dev="cpu"):
    """An NHWC bf16 map and OIHW bf16 weights (channels-last) made from a
    seed with numpy, the weights scaled by the fan-in."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (B, 8, 8, C)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, (9 * C) ** -0.5, (C, C, 3, 3))
                         .astype(np.float32))
    return (x.to(dev, torch.bfloat16),
            w.to(dev, torch.bfloat16, memory_format=torch.channels_last))


def _bn(C, seed, dev="cpu"):
    rng = np.random.default_rng(seed)
    var = rng.uniform(0.05, 3.0, C)
    mul = (var + EPS) ** -0.5 * rng.normal(1, 0.5, C)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.normal(0, 0.5, C), mul, rng.normal(0, 0.5, C)))


# -----------------------------------------------------------------------------
# The plain version against Flax and against the old path
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("C,seed", [(8, 0), (32, 1), (128, 2)])
def test_conv3x3_plain_f64_is_flax_conv(C, seed):
    import flax.linen as nn
    import jax.numpy as jnp

    x, w = _inputs(6, C, seed)
    want = nn.Conv(C, (3, 3), padding="SAME", use_bias=False,
                   dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(
            w.float().permute(2, 3, 1, 0).numpy())}},
        jnp.asarray(x.float().numpy(), jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    want = torch.from_numpy(np.asarray(want, np.float32)).to(torch.bfloat16)
    assert conv.conv3x3_plain(x, w, f64_sums=True).shape == want.shape
    # card_check holds Flax's conv to the float64 sums as the card holds
    # the kernel: one step, or the float32 sum's bound where terms cancel;
    # most elements equal (they differ where a float32 sum rounds to the
    # other side)
    r = conv.card_check(x, w, None, {"none": want}, 1e-2)
    assert r["ok"] and r["outside_bound"] == 0, r


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3x3_plain_is_the_old_conv(dtype):
    """Without ``f64_sums`` the plain version is ``inference._conv`` (the
    ``F.conv2d`` on channels-last operands the evaluator ran before), bit
    for bit, and with a BatchNorm it is ``bn_act_plain`` of it."""
    x, w = _inputs(5, 32, 3)
    x, w = x.to(dtype), w.to(dtype)
    old = inference._conv(x, w)
    assert torch.equal(conv.conv3x3_plain(x, w), old)
    assert torch.equal(conv.conv3x3(x, w), old)
    bn = _bn(32, 4)
    for name, (_, relu) in list(EPILOGUES.items())[1:]:
        want = epilogue.bn_act_plain(old, bn, relu)
        assert torch.equal(conv.conv3x3_plain(x, w, bn, relu), want), name
        assert torch.equal(conv.conv3x3(x, w, bn, relu), want), name
    assert torch.equal(conv.conv3x3(x, w, bn, relu=True),
                       epilogue.bn_act(old, bn))


@pytest.mark.parametrize("C", [16, 128])
def test_block_through_conv3x3_is_the_old_block(C):
    """``conv3x3(y, w2, bn2)`` then ``se_residual(bn=None)`` is the old
    ``se_residual(conv(y, w2), x, fc1, fc2, bn2)``, and ``conv3x3(x, w1,
    bn1, relu=True)`` the old ``bn_act(conv(x, w1), bn1)``, bit for bit."""
    x, w1 = _inputs(7, C, 5)
    _, w2 = _inputs(1, C, 6)
    bn1, bn2 = _bn(C, 7), _bn(C, 8)
    g = torch.Generator().manual_seed(C)
    H = C // 8
    fc = lambda *s: (torch.randn(s, generator=g) * 0.3).to(torch.bfloat16)
    fc1, fc2 = (fc(C, H), fc(H)), (fc(H, 2 * C), fc(2 * C))
    x = x.relu()
    y_old = epilogue.bn_act(inference._conv(x, w1), bn1)
    out_old = epilogue.se_residual(inference._conv(y_old, w2), x, fc1, fc2,
                                   bn2)
    y = conv.conv3x3(x, w1, bn1, relu=True)
    out = epilogue.se_residual(conv.conv3x3(y, w2, bn2), x, fc1, fc2)
    assert torch.equal(y, y_old)
    assert torch.equal(out, out_old)


# -----------------------------------------------------------------------------
# The weight image
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("C", conv.CHANNELS)
def test_weight_image_inverts(C):
    """Every weight once in the image, zeros past 9C, each where the
    kernel's descriptor reads it; ``image_weights`` gives them back."""
    n = conv.tile_width(C)
    index = torch.arange(1, 9 * C * C + 1, dtype=torch.int32).view(
        C, C, 3, 3)
    image = conv.weight_image(index)
    chunks = -(-9 * C // conv.CHUNK_K)
    assert image.shape == (C // n, chunks, n, conv.CHUNK_K) \
        and image.is_contiguous()
    flat = np.sort(image.numpy().ravel())
    pad = image.numel() - 9 * C * C
    np.testing.assert_array_equal(flat[:pad], 0)
    np.testing.assert_array_equal(flat[pad:], np.arange(1, 9 * C * C + 1))
    assert torch.equal(conv.image_weights(image), index)
    # element [t, c, r, p*8 + e] is K value 64c + (p ^ (r % 8))*8 + e of
    # output channel t*n + r, k = tap*C + ci
    rng = np.random.default_rng(C)
    for _ in range(200):
        t, c, r, j = (int(rng.integers(s)) for s in image.shape)
        k = 64 * c + ((j >> 3) ^ (r % 8)) * 8 + (j & 7)
        want = 0 if k >= 9 * C else int(
            index[t * n + r, k % C, (k // C) // 3, (k // C) % 3])
        assert int(image[t, c, r, j]) == want


def test_weight_image_refuses_other_widths():
    for shape in ((64, 64, 3, 3), (32, 16, 3, 3), (128, 128, 1, 1)):
        with pytest.raises(ValueError, match="C one of"):
            conv.weight_image(torch.zeros(shape))


# -----------------------------------------------------------------------------
# The card's check
# -----------------------------------------------------------------------------

def _archive_sites(positions):
    """(x, w, bn, relu, image) of every conv3x3 call of one bf16 forward
    of the archived net over random-play positions, on the CPU, recorded
    as ``chip_smoke.py`` phase 17 records them."""
    import chip_smoke
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.models.convert import load_archive

    prep = inference.prepare_inference(
        load_archive(ARCHIVE, device="cpu"), torch.bfloat16)
    planes = env.encoded_state(chip_smoke.random_positions(positions, 81))
    return chip_smoke.conv_sites(prep, planes)


def test_card_check_accepts_kernel_order_sums_and_rejects_a_moved_rounding():
    """At all 41 sites of the archived net: float32 sums in the kernel's
    order, rounded to bf16, and the epilogue on that rounded output pass
    ``card_check``, at ``CONV_UNEQUAL_SHARE`` over all sites (as
    ``chip_smoke.py`` counts); the affine run on the unrounded float32 sum
    (the rounding point moved) fails it: over all sites, and at most of
    them alone."""
    sites = _archive_sites(6)
    assert len(sites) == 41
    unequal = elements = 0
    rejected = moved_unequal = 0
    for x, w, bn, _, _ in sites:
        sums = conv.conv3x3_kernel_order(x.float(), w)        # float32
        none = sums.to(torch.bfloat16)
        outs = {k: none if k == "none" else
                epilogue.bn_act_plain(none, bn, relu)
                for k, (_, relu) in EPILOGUES.items()}
        r = conv.card_check(x, w, bn, outs, 1.0)
        assert r["ok"] and r["outside_bound"] == 0, r
        unequal, elements = unequal + r["unequal"], elements + r["elements"]
        moved = dict(outs, affine=epilogue.bn_act_plain(sums, bn, False)
                     .to(torch.bfloat16))
        bad = conv.card_check(x, w, bn, moved, 1.0)
        rejected += not bad["ok"]
        moved_unequal += bad["epilogue_unequal"]
    assert unequal <= conv.CONV_UNEQUAL_SHARE * elements
    assert moved_unequal > 0 and rejected > len(sites) // 2


def test_card_check_rejects_sums_off_by_more_than_the_bound():
    x, w = _inputs(4, 32, 9)
    ref = conv.conv3x3_plain(x, w, f64_sums=True)
    outs = {"none": ref.clone()}
    assert conv.card_check(x, w, None, outs, 0.0)["ok"]
    outs["none"][0, 0, 0, 0] = ref[0, 0, 0, 0] * 1.5 + 1
    r = conv.card_check(x, w, None, outs, 1.0)
    assert not r["ok"] and r["outside_bound"] == 1
    # one element one step off: unequal, within the check, and over a
    # share of zero
    near = ref.clone()
    near.view(torch.int16).view(-1)[0] += 1          # the next bf16 value
    near_r = conv.card_check(x, w, None, {"none": near}, 0.0)
    assert near_r["unequal"] == 1 and not near_r["ok"]
    assert conv.card_check(x, w, None, {"none": near}, 1e-3)["ok"]


# -----------------------------------------------------------------------------
# Launch shape, refusals, the forward's sites
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("B,C,want", [
    # (grid, pieces, channels a piece, boards a piece), or on the
    # persistent path ("persistent", grid, groups of four boards, rounds)
    (512, 128, (128, 128, 128, 4)), (1, 128, (8, 8, 16, 1)),
    (2, 32, (2, 2, 32, 1)), (37, 128, (74, 74, 64, 1)),
    (128, 128, (128, 128, 128, 1)), (264, 128, (132, 132, 128, 2)),
    (268, 128, (90, 90, 128, 3)), (512, 256, ("persistent", 128, 128, 1)),
    (1, 256, (16, 16, 16, 1)), (1031, 128, (129, 258, 128, 4)),
    (512, 32, (128, 128, 32, 4)),
    # the gates' 32 boards, the web bot's 2, a wave and one past it
    (32, 128, (128, 128, 16, 2)), (2, 128, (16, 16, 16, 1)),
    (16, 128, (128, 128, 16, 1)), (17, 128, (72, 72, 16, 2)),
    (64, 128, (128, 128, 64, 1)), (67, 128, (67, 67, 128, 1)),
    (528, 128, (132, 132, 128, 4)), (529, 128, (89, 177, 128, 3)),
    (384, 256, (128, 256, 128, 3)),
    (384, 128, (128, 128, 128, 3)), (33, 128, (66, 66, 64, 1)),
    (133, 32, (67, 67, 32, 2)), (256, 256, (128, 128, 128, 4)),
    # C 256: the persistent path where it gives a block no more products
    # than the pieces would (397 to 528 boards, and 1,031, whose runs are
    # as long), else the pieces, as at C 32 and 128 at every batch
    (268, 256, (90, 180, 128, 3)), (396, 256, (132, 264, 128, 3)),
    (397, 256, ("persistent", 100, 100, 1)),
    (400, 256, ("persistent", 100, 100, 1)),
    (528, 256, ("persistent", 132, 132, 1)),
    (529, 256, (118, 354, 128, 3)), (600, 256, (100, 300, 128, 4)),
    (1031, 256, ("persistent", 129, 258, 2)), (2, 256, (32, 32, 16, 1)),
    (396, 128, (132, 132, 128, 3)), (600, 32, (100, 200, 32, 3)),
])
def test_conv_launch_shape(B, C, want):
    """A block's work as small as one wave allows, in ``SHAPES``'s order:
    one board and an eighth of a tile for the web bot, two boards and an
    eighth at the gates' 32, one board and a whole tile at the trainer's
    128, three boards at 384, four at 512; past one wave, the first shape
    with the fewest waves, in runs of consecutive pieces, as few blocks as
    give the shortest run; at C 256 the persistent path (four boards and
    both tiles a block) wherever a block's products are no more than
    there."""
    shape = conv.conv_launch_shape(B, C, 132)
    if want[0] == "persistent":
        assert shape == conv.persistent_launch(B, 132)
        assert (shape["path"], shape["grid"], shape["groups"],
                shape["rounds"]) == want
        assert shape["smem"] == conv.persistent_smem_bytes()
        assert conv.block_work(shape) <= conv.block_work(
            conv.wave_shape(B, C, 132))
        return
    assert shape["path"] == "waves"
    assert (shape["grid"], shape["pieces"], shape["np"],
            shape["per"]) == want
    assert (shape["np"], shape["per"]) in conv.SHAPES[C]
    assert shape["smem"] == conv.conv_smem_bytes(C, shape["np"],
                                                 shape["per"])
    if C == conv.PERSISTENT_C:
        assert conv.block_work(shape) < conv.block_work(
            conv.persistent_launch(B, 132))


@pytest.mark.parametrize("C", conv.CHANNELS)
@pytest.mark.parametrize("B", [1, 3, 31, 130, 131, 257, 600, 2000])
def test_every_shape_covers_its_pieces_once(B, C):
    """The kernel's blocks take runs of ``ceil(pieces / grid)``
    consecutive pieces: every piece falls in exactly one block's run, no
    block is empty, and no shape launches more blocks than the card has
    multiprocessors."""
    for np_, per in conv.SHAPES[C]:
        s = conv.launch_in_shape(B, C, np_, per, 132)
        assert s["pieces"] == -(-B // per) * (C // np_)
        run = -(-s["pieces"] // s["grid"])
        owners = [p // run for p in range(s["pieces"])]
        assert owners[-1] == s["grid"] - 1 and s["grid"] <= 132
        assert sorted(set(owners)) == list(range(s["grid"]))


@pytest.mark.parametrize("sms", [132, 114, 7])
@pytest.mark.parametrize("B", [1, 3, 397, 512, 528, 529, 1031, 2000])
def test_the_persistent_schedule_covers_every_group_once(B, sms):
    """The persistent path's blocks walk the groups of four boards in
    rounds: every group in exactly one (block, round), no block without
    one, no more blocks than multiprocessors, and each block's rounds the
    kernel's count, ``ceil((groups - block) / grid)``, at most the
    launch's."""
    s = conv.persistent_launch(B, sms)
    groups = -(-B // 4)
    assert s["groups"] == groups and s["grid"] <= sms
    # (block, round, group) as the kernel walks them
    walked = [(b, r, r * s["grid"] + b) for b in range(s["grid"])
              for r in range(-(-(groups - b) // s["grid"]))]
    assert sorted(g for _, _, g in walked) == list(range(groups))
    assert {b for b, _, _ in walked} == set(range(s["grid"]))
    for b in range(s["grid"]):
        rounds = [r for bb, r, _ in walked if bb == b]
        assert rounds == list(range(-(-(groups - b) // s["grid"])))
        assert len(rounds) <= s["rounds"]
    assert s["rounds"] == -(-groups // sms)


def test_the_persistent_layout_fits_the_shared_memory():
    """The persistent path's layout (``conv_kernels.cu:PSmem``, counted by
    hand): five 16 KB stages beside four boards' unpadded rows, the zero
    row, the BatchNorm constants, sixteen warps' 512-byte scratch and the
    mbarriers, within a block's opt-in shared memory; its width, boards,
    scratch and stage count as the kernel's source states them."""
    assert conv.persistent_stages() == 5
    size = (5 * (16_384 + 16) + 4 * 32_768 + 512 + 3 * 1_024 + 16 * 512
            + 8)
    assert conv.persistent_smem_bytes() == size + 1024
    assert conv.persistent_smem_bytes() <= epilogue.SMEM_PER_BLOCK
    assert size + 16_400 + 1024 > conv._SMEM_OPT_IN    # no sixth stage
    import re
    from alphazero_torch.cuda_build import CSRC

    src = (CSRC / "conv_kernels.cu").read_text()
    found = lambda name: int(re.search(
        rf"constexpr int {name} = (\d+);", src).group(1))
    assert found("kPC") == conv.PERSISTENT_C
    assert found("kMaxBoards") == 4
    assert found("kSmemOptIn") == conv._SMEM_OPT_IN
    assert found("kPScratch") == conv._SCRATCH_BYTES
    assert ("- 3 * kPC * 4 - kMaxBoards * 4 * kPScratch - 8)\n"
            "         / (kPChunkBytes + 16)") in src


def test_conv_widths_fit_the_shared_memory():
    """The layout of each shape (``conv_kernels.cu:Smem``, counted by
    hand) within a block's opt-in shared memory: pieces of 64 channels or
    fewer at C 128 hold every chunk of the weights at once, a whole tile
    12 stages for one board and 9 for four."""
    want = {  # (C, channels, boards): (stages, bytes without the slack)
        (128, 64, 1): (18, 18 * (8192 + 16) + 17_408 + 272 + 1_536 + 8),
        (128, 128, 1): (12, 12 * (16_384 + 16) + 17_408 + 272 + 1_536 + 8),
        (128, 128, 4): (9, 9 * (16_384 + 16) + 69_632 + 272 + 1_536 + 8),
        (128, 128, 3): (10, 10 * (16_384 + 16) + 52_224 + 272 + 1_536 + 8),
        (128, 16, 2): (18, 18 * (2_048 + 16) + 34_816 + 272 + 1_536 + 8),
        (256, 128, 4): (5, 5 * (16_384 + 16) + 135_168 + 528 + 3_072 + 8),
        (32, 32, 4): (5, 5 * (4_096 + 16) + 20_480 + 80 + 384 + 8),
    }
    for (C, np_, per), (stages, size) in want.items():
        assert conv.conv_stages(C, np_, per) == stages
        assert conv.conv_smem_bytes(C, np_, per) == size + 1024
    for C, shapes in conv.SHAPES.items():
        chunks = -(-9 * C // conv.CHUNK_K)
        for np_, per in shapes:
            stages = conv.conv_stages(C, np_, per)
            assert 4 <= stages <= chunks
            assert stages == chunks or np_ == 128 or (C, np_) == (256, 64)
            assert conv.conv_smem_bytes(C, np_, per) \
                <= epilogue.SMEM_PER_BLOCK


def test_wrapper_refuses_other_shapes():
    x, w = _inputs(2, 32, 10)
    with pytest.raises(ValueError, match=r"\(B, 8, 8, C\)"):
        conv.conv3x3(x.reshape(2, 64, 32), w)
    with pytest.raises(ValueError, match=r"w must be \(32, 32, 3, 3\)"):
        conv.conv3x3(x, w[:16])
    with pytest.raises(ValueError, match=r"w must be"):
        conv.conv3x3(x, torch.zeros(32, 32, 1, 1))
    with pytest.raises(ValueError, match="relu needs bn"):
        conv.conv3x3(x, w, relu=True)
    with pytest.raises(ValueError, match="relu needs bn"):
        conv.conv3x3_plain(x, w, relu=True)


def test_forward_runs_its_tower_and_policy_convs_through_conv3x3():
    """One bf16 forward of a 2 x 32 net: 5 ``conv3x3`` sites (two a block
    and the policy conv, the BatchNorms as epilogues), no weight images
    on the CPU, and the logits the old path gave."""
    gen = torch.Generator().manual_seed(11)
    net = AlphaZeroNet(2, 32, 8).eval()
    with torch.no_grad():
        for p in net.parameters():
            p.normal_(0, 0.2, generator=gen)
    prep = inference.prepare_inference(net, torch.bfloat16)
    assert all(prep["blocks"][0][k] is None
               for k in ("conv1_image", "conv2_image"))
    assert prep["policy_conv_image"] is None
    import chip_smoke

    x = torch.from_numpy((np.random.default_rng(12).random((9, 3, 8, 8))
                          > 0.5).astype(np.float32))
    sites = chip_smoke.conv_sites(prep, x)
    assert [(relu, bn is not None) for _, _, bn, relu, _ in sites] == \
        [(True, True), (False, True)] * 2 + [(True, True)]
    got = inference.inference_apply(prep, x)

    def old_apply(prep, planes):
        """The forward before conv3x3: F.conv2d and the two epilogues."""
        h = planes.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()
        h = epilogue.bn_act(inference._conv(h, prep["input_conv"]),
                            prep["input_bn"])
        for b in prep["blocks"]:
            y = epilogue.bn_act(inference._conv(h, b["conv1"]), b["bn1"])
            h = epilogue.se_residual(inference._conv(y, b["conv2"]), h,
                                     b["fc1"], b["fc2"], b["bn2"])
        B = h.shape[0]
        p = epilogue.bn_act(inference._conv(h, prep["policy_conv"]),
                            prep["policy_bn"])
        pl = inference._dense(p.reshape(B, -1), prep["policy_fc"])
        v = epilogue.bn_act(inference._conv(h, prep["value_conv"]),
                            prep["value_bn"])
        v = torch.relu(inference._dense(v.reshape(B, -1), prep["value_fc1"]))
        return pl.float(), inference._dense(v, prep["value_fc2"]).float()

    for g, w in zip(got, old_apply(prep, x)):
        assert torch.equal(g, w)


# -----------------------------------------------------------------------------
# On the card: the kernel against its plain version
# -----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cudnn_share(x, w):
    """cuDNN's unequal share against the float64 sums, same operands."""
    got = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    ref = conv.conv3x3_plain(x, w, f64_sums=True)
    return float((got != ref).float().mean())


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2, 37, 512])
@pytest.mark.parametrize("C", conv.CHANNELS)
def test_cuda_conv3x3_against_plain(cuda, B, C):
    """All three epilogues on the card, one launch each: the conv within
    ``card_check``'s bounds of the float64 sums, each epilogue bit-equal
    to ``bn_act_plain`` of the conv alone."""
    x, w = _inputs(B, C, B * C, cuda)
    bn = _bn(C, B + C, cuda)
    image = conv.weight_image(w)
    launches = conv.conv3x3.launches
    outs = {k: conv.conv3x3(x, w, bn if affine else None, relu, image)
            for k, (affine, relu) in EPILOGUES.items()}
    torch.cuda.synchronize()
    assert conv.conv3x3.launches == launches + 3
    assert all(o.dtype == torch.bfloat16 and o.is_contiguous()
               and o.shape == x.shape for o in outs.values())
    limit = max(conv.CONV_UNEQUAL_SHARE, 2 * _cudnn_share(x, w))
    r = conv.card_check(x, w, bn, outs, limit)
    assert r["ok"], r


@pytest.mark.gpu
@pytest.mark.parametrize("C", conv.CHANNELS)
def test_cuda_conv3x3_board_is_independent_of_the_batch(cuda, C):
    """Every board of a 512-board launch bit-equal to the same board sent
    alone, and the launch bit-equal when repeated."""
    x, w = _inputs(512, C, C + 1, cuda)
    bn = _bn(C, C, cuda)
    image = conv.weight_image(w)
    got = conv.conv3x3(x, w, bn, True, image)
    again = conv.conv3x3(x, w, bn, True, image)
    alone = torch.cat([conv.conv3x3(x[b:b + 1].contiguous(), w, bn, True,
                                    image) for b in range(512)])
    none = conv.conv3x3(x, w, image=image)
    none_alone = torch.cat([conv.conv3x3(x[b:b + 1].contiguous(), w,
                                         image=image) for b in (0, 257, 511)])
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, alone)
    assert torch.equal(none[[0, 257, 511]], none_alone)


@pytest.mark.gpu
def test_cuda_conv3x3_refuses_what_the_kernel_does_not_take(cuda):
    """Another dtype, another width, a map that is not contiguous, no
    image or one of another shape, constants on the host: each raises and
    nothing launches."""
    x, w = _inputs(4, 32, 0, cuda)
    bn = _bn(32, 0, cuda)
    image = conv.weight_image(w)
    before = conv.conv3x3.launches
    with pytest.raises(TypeError, match="bfloat16"):
        conv.conv3x3(x.float(), w.float(), bn, True, image)
    wide, ww = _inputs(1, 64, 0, cuda)
    with pytest.raises(ValueError, match="C one of"):
        conv.conv3x3(wide, ww, image=torch.zeros(1, device=cuda))
    strided = torch.randn((4, 8, 8, 64), device=cuda,
                          dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="contiguous"):
        conv.conv3x3(strided, w, image=image)
    with pytest.raises(ValueError, match="weight image"):
        conv.conv3x3(x, w, bn)
    with pytest.raises(ValueError, match="image must be"):
        conv.conv3x3(x, w, bn, image=image[:, :4].contiguous())
    with pytest.raises(TypeError, match="image in torch.bfloat16"):
        conv.conv3x3(x, w, bn, image=image.float())
    with pytest.raises(ValueError, match="mean on cpu"):
        conv.conv3x3(x, w, tuple(t.cpu() for t in bn), image=image)
    assert conv.conv3x3.launches == before


@pytest.mark.gpu
def test_cuda_shared_memory_layout_is_the_kernels(cuda):
    """``conv_smem_bytes`` counts what the kernel's ``Smem`` takes, shape
    by shape, the kernel has no shape that ``SHAPES`` lacks, and
    ``persistent_smem_bytes`` counts the persistent path's ``PSmem``."""
    lib = conv.LIB
    for C, shapes in conv.SHAPES.items():
        for np_, per in shapes:
            assert lib.conv3x3_smem_bytes(C, np_, per) == \
                conv.conv_smem_bytes(C, np_, per)
    assert lib.conv3x3_smem_bytes(128, 32, 1) == 0
    assert lib.conv3x3_smem_bytes(32, 16, 1) == 0
    assert lib.conv3x3_persistent_smem_bytes() == \
        conv.persistent_smem_bytes()


def _launch(x, image, bn, C, np_, per, epi=2):
    """One launch of the kernel in a shape of the caller's choosing."""
    lib = conv.LIB
    B = x.shape[0]
    s = conv.launch_in_shape(B, C, np_, per,
                             conv.LIB.multiprocessors(x.device))
    out = torch.empty_like(x)
    consts = (None,) * 3 if bn is None else tuple(t.data_ptr() for t in bn)
    rc = lib.conv3x3_bf16(x.data_ptr(), image.data_ptr(), *consts,
                          out.data_ptr(), B, C, epi, s["grid"], np_, per,
                          torch.cuda.current_stream(x.device).cuda_stream)
    assert rc == 0, rc
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("C", conv.CHANNELS)
@pytest.mark.parametrize("B", [1, 37, 300])
def test_cuda_every_shape_against_plain_and_the_ring(cuda, B, C):
    """Every launch shape on the card: the conv alone within
    ``card_check``'s bounds of the float64 sums, and every shape's output,
    in each epilogue, bit-equal to the four-board shape with a whole tile
    (the weights through the ring)."""
    x, w = _inputs(B, C, 3 * B + C, cuda)
    bn = _bn(C, B, cuda)
    image = conv.weight_image(w)
    ring = conv.SHAPES[C][-1]
    limit = max(conv.CONV_UNEQUAL_SHARE, 2 * _cudnn_share(x, w))
    for np_, per in conv.SHAPES[C]:
        outs = {k: _launch(x, image, bn if affine else None, C, np_, per,
                           epi)
                for epi, (k, (affine, relu)) in enumerate(EPILOGUES.items())}
        torch.cuda.synchronize()
        r = conv.card_check(x, w, bn, outs, limit)
        assert r["ok"], (np_, per, r)
        for epi, k in enumerate(EPILOGUES):
            want = _launch(x, image, bn if epi else None, C, *ring, epi)
            torch.cuda.synchronize()
            assert torch.equal(outs[k], want), (np_, per, k)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [397, 512, 1031])
def test_cuda_persistent_path_against_plain_and_the_four_board_launch(
        cuda, B):
    """C 256 on the persistent path (one round of groups, a last group of
    one board, two rounds with a last group of three): each epilogue one
    counted launch of it, the conv within ``card_check``'s bounds of the
    float64 sums, every output bit-equal to ``conv3x3_kernel<256, 128, 4>``,
    and a board's output the same as that board launched alone."""
    C = 256
    assert conv.conv_launch_shape(
        B, C, conv.LIB.multiprocessors(cuda))["path"] == "persistent"
    x, w = _inputs(B, C, 5 * B, cuda)
    bn = _bn(C, B, cuda)
    image = conv.weight_image(w)
    launches = (conv.conv3x3.launches, conv.conv3x3.persistent.launches)
    outs = {k: conv.conv3x3(x, w, bn if affine else None, relu, image)
            for k, (affine, relu) in EPILOGUES.items()}
    torch.cuda.synchronize()
    assert (conv.conv3x3.launches, conv.conv3x3.persistent.launches) == (
        launches[0] + 3, launches[1] + 3)
    limit = max(conv.CONV_UNEQUAL_SHARE, 2 * _cudnn_share(x, w))
    r = conv.card_check(x, w, bn, outs, limit)
    assert r["ok"], r
    for epi, k in enumerate(EPILOGUES):
        want = _launch(x, image, bn if epi else None, C, 128, 4, epi)
        torch.cuda.synchronize()
        assert torch.equal(outs[k], want), k
    # a board's output is the same launched alone (off the persistent path)
    for b in (0, B // 2, B - 1):
        alone = conv.conv3x3(x[b:b + 1].contiguous(), w, bn, True, image)
        assert torch.equal(alone, outs["affine_relu"][b:b + 1]), b


@pytest.mark.gpu
def test_cuda_captured_c256_forward_counts_its_persistent_launches(cuda):
    """The bf16 forward of a 2 x 256 net at 512 boards captured as a CUDA
    graph and replayed, bit-equal to the eager forward; each of them counts
    its 5 ``conv3x3`` launches on the persistent path; at 37 boards none
    takes it."""
    net = _net(2, 256, 22).to(cuda)
    prep = inference.prepare_inference(net, torch.bfloat16)
    path = conv.conv3x3.persistent
    for B, n in ((512, 5), (37, 0)):
        x = torch.from_numpy((np.random.default_rng(B).random(
            (B, 3, 8, 8)) > 0.5).astype(np.float32)).to(cuda)
        before = path.launches
        want = inference.inference_apply(prep, x)
        torch.cuda.synchronize()
        assert path.launches == before + n
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            inference.inference_apply(prep, x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = path.launches
        with torch.cuda.graph(graph):
            got = inference.inference_apply(prep, x)
        assert path.launches == before + n
        graph.replay()
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), B


@pytest.mark.gpu
def test_cuda_captured_forward_equals_the_eager_one(cuda):
    """The bf16 forward of a 2 x 128 net captured as a CUDA graph (each
    ``conv3x3`` a programmatic dependent launch, kept as such in the
    graph) and replayed twice, bit-equal to the same forward run eagerly,
    at 1, 32 and 128 boards."""
    net = _net(2, 128, 21).to(cuda)
    prep = inference.prepare_inference(net, torch.bfloat16)
    for B in (1, 32, 128):
        x = torch.from_numpy((np.random.default_rng(B).random(
            (B, 3, 8, 8)) > 0.5).astype(np.float32)).to(cuda)
        want = inference.inference_apply(prep, x)
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            inference.inference_apply(prep, x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = inference.inference_apply(prep, x)
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), B


def _net(blocks, C, seed):
    gen = torch.Generator().manual_seed(seed)
    net = AlphaZeroNet(blocks, C, 8).eval()
    with torch.no_grad():
        for p in net.parameters():
            p.normal_(0, 0.2 * (32 / C) ** 0.5, generator=gen)
    return net


@pytest.mark.gpu
@pytest.mark.parametrize("C", [32, 256])
def test_cuda_forward_against_the_cpu_with_its_launches(cuda, C):
    """The bf16 forward of a 2 x C net on the card against the same
    forward on the CPU: logits within 0.05; 5 ``conv3x3``, 2 ``bn_act``
    and 2 ``se_residual`` launches."""
    net = _net(2, C, 12)
    x = torch.from_numpy((np.random.default_rng(4).random((37, 3, 8, 8))
                          > 0.5).astype(np.float32))
    want = inference.inference_apply(
        inference.prepare_inference(net, torch.bfloat16), x)
    prep = inference.prepare_inference(copy.deepcopy(net).to(cuda),
                                       torch.bfloat16)
    before = (conv.conv3x3.launches, epilogue.bn_act.launches,
              epilogue.se_residual.launches)
    got = inference.inference_apply(prep, x.to(cuda))
    torch.cuda.synchronize()
    after = (conv.conv3x3.launches, epilogue.bn_act.launches,
             epilogue.se_residual.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (5, 2, 2)
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) < 0.05
