"""The bf16 evaluator's forward (``models/inference.py``) and its two
epilogues (``models/epilogue.py``) held against the JAX package.

The same numpy inputs go through Flax and the port on the CPU, where the
wrappers run their plain versions:

- ``bn_act_plain`` is Flax's inference BatchNorm (and ReLU) in Flax's
  order, so given Flax's ``mul`` it agrees bit for bit, in bfloat16 and in
  float32. The port computes ``mul = rsqrt(var + eps) * gamma`` with
  PyTorch's rsqrt, which differs from XLA's by up to two ulps (test
  below).
- ``se_residual_plain`` is the block tail of Flax's ``SEResBlock`` and of
  the JAX int8 net. The f32 sums of the pool and of the SE's two dense
  layers run in another order in XLA (and XLA's sigmoid is its own), so
  each rounded sum may land one step from the port's; the layers after it
  carry that step on. ``epilogue.se_residual_bound`` states how far that
  moves an element. On the card the kernel is held much closer, to the
  plain version with its sums in float64 (``f64_sums``): at most one bf16
  step an element and at most ``epilogue.SE_UNEQUAL_SHARE`` of them
  unequal. On the CPU that check passes the plain version's own float32
  sums and rejects a tail whose rounding points moved.
- ``inference_apply`` in float32 within 1e-4 of Flax's logits (tiny nets
  and the archive net); in bfloat16 within ``chip_smoke.BF16_LIMITS`` of
  the f32 net, as ``tests/test_torch_network.py`` holds the module, and
  of the JAX package's bf16 inference.
- the int8 forward's block tail, now ``se_residual``, is bit-equal on the
  CPU to the eager tail it replaced.

The tests marked ``gpu`` hold each kernel against its plain version on
the card and import no JAX: ``python -m pytest --noconftest -m gpu
tests/test_torch_epilogue.py``.
"""

import copy
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from alphazero_torch.models import convert, epilogue, inference
from alphazero_torch.models import quant as tq
from alphazero_torch.models.network import AlphaZeroNet, wl_to_value
from alphazero_torch.search import mcts

ARCHIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts", "model_r5_latest.npz")
EPS = 1e-5


class _Jax:
    """The JAX side, imported at first use."""

    def __getattr__(self, name):
        import flax.linen as nn
        import jax
        import jax.numpy as jnp
        from flax import traverse_util

        from alphazero_tpu.models import network
        from alphazero_tpu.models import quant

        self.__dict__.update(jax=jax, jnp=jnp, nn=nn, network=network,
                             quant=quant, traverse_util=traverse_util)
        return self.__dict__[name]


J = _Jax()
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jdt(name):
    return getattr(J.jnp, name)


def _t(a, dtype=torch.float32):
    """A JAX or numpy array as a torch tensor of ``dtype``."""
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)


def _np32(t):
    return t.detach().float().numpy()


def _bn_stats(rng, C):
    return {"mean": rng.normal(0, 0.5, C).astype(np.float32),
            "var": rng.uniform(0.05, 3.0, C).astype(np.float32)}


def _jax_mul(var, scale):
    """Flax's mul: XLA's rsqrt(var + eps) times the scale, in float32."""
    return J.jax.lax.rsqrt(J.jnp.asarray(var) + EPS) * J.jnp.asarray(scale)


def _flat(variables):
    flat = {}
    for col in ("params", "batch_stats"):
        for path, leaf in J.traverse_util.flatten_dict(
                variables[col]).items():
            flat[col + "/" + "/".join(path)] = np.asarray(leaf)
    return flat


def _planes(n, seed):
    x = (np.random.default_rng(seed).random((n, 3, 8, 8)) > 0.5).astype(
        np.float32)
    x[:, 2] = 1.0
    return x


def _archive_variables():
    with np.load(ARCHIVE) as data:
        flat = {k: data[k] for k in data.files}
    variables = {}
    for col in ("params", "batch_stats"):
        sub = {tuple(k.split("/")[1:]): J.jnp.asarray(v, J.jnp.float32)
               for k, v in flat.items() if k.startswith(col + "/")}
        variables[col] = J.traverse_util.unflatten_dict(sub)
    return variables


# -----------------------------------------------------------------------------
# bn_act
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("C", [8, 32])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bn_act_plain_is_flax_batchnorm(dtype, relu, C):
    """Flax's ``nn.BatchNorm(use_running_average=True)`` (then ``nn.relu``)
    on a conv output of ``dtype``: bit-equal in bfloat16, within 1e-6 in
    float32, given Flax's own ``mul``."""
    rng = np.random.default_rng(C + relu)
    y = (rng.standard_normal((5, 8, 8, C)) * 3).astype(np.float32)
    stats = _bn_stats(rng, C)
    params = {"scale": rng.normal(1, 0.5, C).astype(np.float32),
              "bias": rng.normal(0, 0.5, C).astype(np.float32)}
    yj = J.jnp.asarray(y).astype(_jdt(dtype))
    want = J.nn.BatchNorm(use_running_average=True, dtype=_jdt(dtype)).apply(
        {"params": params, "batch_stats": stats}, yj)
    if relu:
        want = J.nn.relu(want)
    bn = (_t(stats["mean"]), _t(_jax_mul(stats["var"], params["scale"])),
          _t(params["bias"]))
    got = epilogue.bn_act_plain(_t(yj, TDT[dtype]), bn, relu)
    assert got.dtype == TDT[dtype]
    want = np.asarray(want.astype(J.jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np32(got), want)
    else:
        np.testing.assert_allclose(_np32(got), want, atol=1e-6, rtol=0)
    # the wrapper (always with ReLU) on a CPU tensor is the plain version,
    # and counts nothing
    if relu:
        launches = epilogue.bn_act.launches
        assert torch.equal(epilogue.bn_act(_t(yj, TDT[dtype]), bn), got)
        assert epilogue.bn_act.launches == launches


def test_prepared_batchnorm_constants_follow_flax():
    """``prepare_inference``'s (mean, mul, beta): mean and beta exact, mul
    within two float32 ulps of Flax's (PyTorch's rsqrt is up to an ulp
    from XLA's, and the multiply by gamma rounds once more)."""
    rng = np.random.default_rng(3)
    net = AlphaZeroNet(1, 16, 8).eval()
    with torch.no_grad():
        for bn in (net.input_bn, net.blocks[0].bn2, net.value_bn):
            C = bn.num_features
            stats = _bn_stats(rng, C)
            bn.running_mean.copy_(_t(stats["mean"]))
            bn.running_var.copy_(_t(stats["var"]))
            bn.weight.copy_(_t(rng.normal(1, 0.5, C)))
            bn.bias.copy_(_t(rng.normal(0, 0.5, C)))
    prep = inference.prepare_inference(net, torch.bfloat16)
    for bn, (mean, mul, beta) in ((net.input_bn, prep["input_bn"]),
                                  (net.blocks[0].bn2, prep["blocks"][0]["bn2"]),
                                  (net.value_bn, prep["value_bn"])):
        assert mean.dtype == mul.dtype == beta.dtype == torch.float32
        assert torch.equal(mean, bn.running_mean) and torch.equal(beta,
                                                                  bn.bias)
        want = np.asarray(_jax_mul(bn.running_var.numpy(),
                                   bn.weight.detach().numpy()))
        ulps = np.abs(mul.numpy() - want) / np.spacing(np.abs(want))
        assert ulps.max() <= 2
    # a snapshot: training the net afterwards leaves it as it was
    before = prep["blocks"][0]["bn1"][0].clone()
    with torch.no_grad():
        net.blocks[0].bn1.running_mean.add_(1.0)
        net.blocks[0].conv1.weight.mul_(2.0)
    assert torch.equal(prep["blocks"][0]["bn1"][0], before)
    assert not torch.equal(prep["blocks"][0]["conv1"].float(),
                           net.blocks[0].conv1.weight)


# -----------------------------------------------------------------------------
# se_residual
# -----------------------------------------------------------------------------

def _assert_within(got, want, bound):
    got, want = got.float(), want.float()
    excess = (got - want).abs() - bound
    assert float(excess.max()) <= 0, (
        f"{int((excess > 0).sum())} elements past the bound; worst "
        f"{float(excess.max())}")


@pytest.mark.parametrize("sums", ["f32", "f64"])
@pytest.mark.parametrize("C,seed", [(16, 0), (32, 1)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_se_residual_plain_is_flax_block_tail(dtype, C, seed, sums):
    """``SEResBlock``'s tail (``bn2``, ``SqueezeExcite``, ``relu(y + x)``),
    driven from its own ``conv2`` output (captured as an intermediate):
    within ``se_residual_bound`` in bf16 and in float32, with the plain
    version's sums in float32 and in float64."""
    block = J.network.SEResBlock(C, 8, dtype=_jdt(dtype))
    rng = np.random.default_rng(seed)
    x = J.jnp.asarray(rng.standard_normal((6, 8, 8, C)) * 2,
                      J.jnp.float32).astype(_jdt(dtype))
    variables = dict(block.init(J.jax.random.PRNGKey(seed), x, False))
    variables["batch_stats"] = {
        k: _bn_stats(rng, C) for k in variables["batch_stats"]}
    want, inter = block.apply(variables, x, False, capture_intermediates=True,
                              mutable=["intermediates"])
    y = inter["intermediates"]["conv2"]["__call__"][0]
    p, s = variables["params"], variables["batch_stats"]["bn2"]
    tdt = TDT[dtype]
    bn = (_t(s["mean"]), _t(_jax_mul(s["var"], p["bn2"]["scale"])),
          _t(p["bn2"]["bias"]))
    fc = [(_t(p["se"][n]["kernel"], tdt), _t(p["se"][n]["bias"], tdt))
          for n in ("fc1", "fc2")]
    yt, xt = _t(y, tdt), _t(x, tdt)
    got = epilogue.se_residual_plain(yt, xt, *fc, bn,
                                     f64_sums=sums == "f64")
    assert got.dtype == tdt
    want = _t(want)
    _assert_within(got, want, epilogue.se_residual_bound(yt, xt, *fc, bn))
    if sums == "f32":
        assert torch.equal(epilogue.se_residual(yt, xt, *fc, bn), got)


def test_se_residual_plain_is_jax_int8_tail():
    """The JAX int8 net's block tail, ``relu(_se(y) + x)`` in bf16 with no
    BatchNorm, within ``se_residual_bound``."""
    C, H = 32, 4
    rng = np.random.default_rng(7)
    se_p = {n: {"kernel": rng.normal(0, 0.4, shape).astype(np.float32),
                "bias": rng.normal(0, 0.3, shape[1]).astype(np.float32)}
            for n, shape in (("fc1", (C, H)), ("fc2", (H, 2 * C)))}
    bf = J.jnp.bfloat16
    y = J.jnp.asarray(rng.standard_normal((9, 8, 8, C)) * 2).astype(bf)
    x = J.jnp.asarray(np.abs(rng.standard_normal((9, 8, 8, C)))).astype(bf)
    want = J.jax.nn.relu(J.quant._se(y, se_p, bf) + x)
    fc = [(_t(se_p[n]["kernel"], torch.bfloat16),
           _t(se_p[n]["bias"], torch.bfloat16)) for n in ("fc1", "fc2")]
    yt, xt = _t(y, torch.bfloat16), _t(x, torch.bfloat16)
    got = epilogue.se_residual_plain(yt, xt, *fc)
    _assert_within(got, _t(want.astype(J.jnp.float32)),
                   epilogue.se_residual_bound(yt, xt, *fc))


def _card_inputs(B, C, affine, dev="cpu"):
    """A block tail's inputs as the card's tests make them."""
    g = torch.Generator().manual_seed(B * C + affine)
    y = (torch.randn((B, 8, 8, C), generator=g) * 2).to(dev, torch.bfloat16)
    x = torch.randn((B, 8, 8, C), generator=g).relu().to(dev, torch.bfloat16)
    fc1, fc2 = _card_fc(C, C // 8, B + C, dev)
    return y, x, fc1, fc2, (_card_bn(C, B, dev) if affine else None)


def _card_check(got, ref):
    """The card's check of ``se_residual`` against its plain version with
    float64 sums: (unequal share within ``SE_UNEQUAL_SHARE``, every element
    within one step)."""
    share = float((got != ref).float().mean())
    return (share <= epilogue.SE_UNEQUAL_SHARE,
            float(epilogue.steps_apart(got, ref).max()) <= 1)


@pytest.mark.parametrize("affine", [True, False], ids=["bn", "no_bn"])
@pytest.mark.parametrize("C", [32, 128])
def test_card_check_passes_float32_sums(C, affine):
    """The plain version's own float32 sums (another order than the
    kernel's) pass the check the kernel is held to on the card."""
    y, x, fc1, fc2, bn = _card_inputs(64, C, affine)
    got = epilogue.se_residual_plain(y, x, fc1, fc2, bn)
    ref = epilogue.se_residual_plain(y, x, fc1, fc2, bn, f64_sums=True)
    assert _card_check(got, ref) == (True, True)


def _kernel_order_tail(y, x, fc1, fc2, bn=None, sums=torch.float64):
    """``se_residual`` with the kernel's order of the pool's and the dense
    layers' sums (``epilogue_kernels.cu:se_residual_kernel``), taken in
    ``sums``: a thread's column sums over its rows r0, r0 + R, ... in
    turn, in float32 (at most 16 bf16 terms); a column's R partial sums in
    four chains (r mod 4), added as (p0 + p1) + (p2 + p3); fc1 on
    ``lanes`` adjacent lanes a hidden unit,
    each lane two chains over the inputs l, l + 2 lanes, ... and l + lanes,
    l + 3 lanes, ..., then an xor shuffle tree; fc2 two chains over the
    even and the odd hidden units. Each sum is rounded through float32 to
    the maps' dtype. The kernel sums in float64; the products are of two
    bf16 values, exact in either type, so its FMA is a multiply and an
    add here."""
    if bn is not None:
        y = epilogue.bn_act_plain(y, bn, relu=False)
    B, C = y.shape[0], y.shape[3]
    H = fc1[0].shape[1]
    dt = y.dtype
    rnd = lambda t: t.float().to(dt)
    G = C // 8
    R = min(128 // G, 64)
    rows = y.float().reshape(B, 64, C)
    partial = []
    for r0 in range(R):
        s = torch.zeros(B, C)
        for r in range(r0, 64, R):
            s = s + rows[:, r]
        partial.append(s.to(sums))
    chains = [torch.zeros(B, C, dtype=sums) for _ in range(4)]
    for r in range(R):
        chains[r % 4] = chains[r % 4] + partial[r]
    total = (chains[0] + chains[1]) + (chains[2] + chains[3])
    pooled = rnd(total * (1.0 / 64.0)).to(sums)

    lanes = 32
    while lanes * H > 128:
        lanes //= 2
    w1 = fc1[0].to(sums)
    lane_sums = torch.zeros(B, H, lanes, dtype=sums)
    for l in range(lanes):
        s0 = torch.zeros(B, H, dtype=sums)
        s1 = torch.zeros(B, H, dtype=sums)
        for c in range(l, C, 2 * lanes):
            s0 = s0 + pooled[:, c, None] * w1[c]
            if c + lanes < C:
                s1 = s1 + pooled[:, c + lanes, None] * w1[c + lanes]
        lane_sums[:, :, l] = s0 + s1
    off = lanes // 2
    while off:
        lane_sums = lane_sums + lane_sums[:, :, torch.arange(lanes) ^ off]
        off //= 2
    hidden = torch.relu(rnd(lane_sums[:, :, 0]) + fc1[1]).to(sums)
    w2 = fc2[0].to(sums)
    s0 = torch.zeros(B, 2 * C, dtype=sums)
    s1 = torch.zeros(B, 2 * C, dtype=sums)
    for k in range(0, H - 1, 2):
        s0 = s0 + hidden[:, k, None] * w2[k]
        s1 = s1 + hidden[:, k + 1, None] * w2[k + 1]
    if H % 2:
        s0 = s0 + hidden[:, H - 1, None] * w2[H - 1]
    h = rnd(s0 + s1) + fc2[1]
    gate, shift = torch.sigmoid(h[:, :C]), h[:, C:]
    return torch.relu(y * gate[:, None, None, :] + shift[:, None, None, :]
                      + x)


@pytest.mark.parametrize("sums", ["f32", "f64"])
@pytest.mark.parametrize("affine", [True, False], ids=["bn", "no_bn"])
@pytest.mark.parametrize("C", [32, 128, 256])
def test_card_check_passes_the_kernel_order_of_sums(C, affine, sums):
    """The kernel's own order of the pool's and the dense layers' sums,
    emulated in float32 and in float64 (the kernel's), passes the card's
    check, and a board sent alone comes out bit-equal (the order is a
    function of C and H alone)."""
    dtype = {"f32": torch.float32, "f64": torch.float64}[sums]
    y, x, fc1, fc2, bn = _card_inputs(64, C, affine)
    got = _kernel_order_tail(y, x, fc1, fc2, bn, dtype)
    ref = epilogue.se_residual_plain(y, x, fc1, fc2, bn, f64_sums=True)
    assert _card_check(got, ref) == (True, True)
    alone = _kernel_order_tail(y[5:6], x[5:6], fc1, fc2, bn, dtype)
    assert torch.equal(alone, got[5:6])


def test_float32_sums_in_the_kernel_order_can_fail_the_card_check():
    """Why the kernel sums in float64: at C 256 (256 products a hidden
    unit) on the card test's 1031 boards with bn2, float32 sums in the
    kernel's order round a value the other way, which the next layers
    carry past one bf16 step; float64 sums, rounded through float32 as
    the plain version's, pass."""
    y, x, fc1, fc2, bn = _card_inputs(1031, 256, True)
    ref = epilogue.se_residual_plain(y, x, fc1, fc2, bn, f64_sums=True)
    f32 = _kernel_order_tail(y, x, fc1, fc2, bn, torch.float32)
    assert not _card_check(f32, ref)[1]
    f64 = _kernel_order_tail(y, x, fc1, fc2, bn, torch.float64)
    assert _card_check(f64, ref) == (True, True)


@pytest.mark.parametrize("B,C,H,want", [
    (512, 128, 16, (132, 4, 4)), (1031, 128, 16, (132, 4, 8)),
    (128, 128, 16, (128, 1, 1)), (1, 128, 16, (1, 1, 1)),
    (512, 256, 32, (132, 2, 4)), (1031, 32, 4, (132, 4, 8)),
    (1031, 8, 1, (132, 4, 8))])
def test_se_launch_shape(B, C, H, want):
    """The grid, warpgroups and stages of ``se_residual_kernel`` on a
    132-SM card: one block an SM at most, four warpgroups (two at C 256),
    as many stages for each warpgroup, none beyond its boards and eight a
    block at most, and a layout within a block's shared memory."""
    shape = epilogue.se_launch_shape(B, C, H, 132)
    assert (shape["grid"], shape["waves"], shape["stages"]) == want
    assert shape["smem"] <= epilogue.SMEM_PER_BLOCK
    assert shape["smem"] == epilogue.se_smem_bytes(C, H, want[1], want[2])


def test_se_widths_fit_the_shared_memory():
    """The widths the wrapper takes: at C 256 and H 32 (se_ratio 8 at 256
    filters) two warpgroups with two stages each fit, 203,520 bytes; past
    the layout's room ``se_launch_shape`` raises, naming the bytes."""
    assert epilogue.MAX_SE_CHANNELS == 256 and epilogue.MAX_SE_HIDDEN == 32
    assert epilogue.se_smem_bytes(256, 32, 2, 4) == 203_520
    assert epilogue.se_launch_shape(2000, 256, 32, 132)["stages"] == 4
    with pytest.raises(ValueError, match="shared memory"):
        epilogue.se_launch_shape(4, 1024, 32, 132)


def _moved_tail(y, x, fc1, fc2, bn, fault):
    """``se_residual_plain`` with one of its roundings left out:
    ``y * gate`` ("product") or ``y * gate + shift`` ("shift") kept in
    float32 until the next addition."""
    if bn is not None:
        y = epilogue.bn_act_plain(y, bn, relu=False)
    gate, shift = epilogue.se_gate_shift_plain(y, fc1, fc2, f64_sums=True)
    t = y.float() * gate.float()[:, None, None, :]
    if fault == "shift":
        t = t.to(y.dtype)
    t = t + shift.float()[:, None, None, :]
    if fault == "product":
        t = t.to(y.dtype)
    return torch.relu(t + x.float()).to(y.dtype)


@pytest.mark.parametrize("fault", ["product", "shift"])
def test_card_check_rejects_a_moved_rounding_point(fault):
    """A tail that rounds at other points than the plain version fails
    the card's check: far more than ``SE_UNEQUAL_SHARE`` of its elements
    differ."""
    y, x, fc1, fc2, bn = _card_inputs(64, 128, True)
    ref = epilogue.se_residual_plain(y, x, fc1, fc2, bn, f64_sums=True)
    got = _moved_tail(y, x, fc1, fc2, bn, fault)
    assert not _card_check(got, ref)[0]
    assert float((got != ref).float().mean()) > 1000 * \
        epilogue.SE_UNEQUAL_SHARE


def test_steps_apart():
    a = torch.tensor([1.0, 1.0, 0.0, -3.0, 256.0], dtype=torch.bfloat16)
    b = torch.tensor([1.0078125, 1.015625, 0.0, -3.0, 258.0],
                     dtype=torch.bfloat16)
    assert epilogue.steps_apart(a, b).tolist() == [1.0, 2.0, 0.0, 0.0, 1.0]


def _old_int8_tail(y, x, fc1, fc2, bn=None):
    """The int8 forward's block tail before ``se_residual``: the eager ops
    of ``quant._se`` and the residual."""
    assert bn is None
    h = torch.relu(y.mean(dim=(1, 2)) @ fc1[0] + fc1[1])
    h = h @ fc2[0] + fc2[1]
    gate, bias = h.chunk(2, dim=-1)
    se = y * torch.sigmoid(gate)[:, None, None, :] + bias[:, None, None, :]
    return torch.relu(se + x)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_int8_forward_tail_is_the_old_eager_tail(static, monkeypatch):
    """The int8 ``_forward`` with ``se_residual`` as its block tail: logits
    bit-equal on the CPU to the same forward with the eager tail."""
    gen = torch.Generator().manual_seed(4)
    net = AlphaZeroNet(2, 32, 8).eval()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.3, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    planes = torch.from_numpy(_planes(24, 5))
    qp = tq.quantize_network(net)
    act = tq.calibrate(qp, [planes]) if static else None
    got = tq.quant_apply(qp, planes, act_scales=act)
    monkeypatch.setattr(epilogue, "se_residual", _old_int8_tail)
    want = tq.quant_apply(qp, planes, act_scales=act)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# -----------------------------------------------------------------------------
# The forward
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("blocks,filters,seed", [(2, 32, 0), (1, 16, 1),
                                                 (2, 8, 2), (2, 256, 3)])
def test_inference_apply_f32_matches_flax(blocks, filters, seed):
    """Logits, probabilities and values within 1e-4 of Flax's f32 net."""
    from alphazero_tpu.config import tiny_config as jax_tiny_config

    cfg = jax_tiny_config(num_blocks=blocks, num_filters=filters)
    net, variables = J.network.init_network(cfg, J.jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    variables = dict(variables)
    variables["batch_stats"] = J.jax.tree_util.tree_map(
        lambda a: J.jnp.asarray(rng.uniform(0.5, 1.5, a.shape), J.jnp.float32),
        variables["batch_stats"])
    tnet = convert.load_flat_into(AlphaZeroNet(blocks, filters, 8).eval(),
                                  _flat(variables))
    x = _planes(16, seed)
    pj, wj = net.apply(variables, J.jnp.asarray(x), train=False)
    prep = inference.prepare_inference(tnet, torch.float32)
    pt, wt = inference.inference_apply(prep, torch.from_numpy(x))
    assert pt.dtype == wt.dtype == torch.float32
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4, rtol=0)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-4, rtol=0)
    jp, jv = J.network.policy_value_apply(net, variables, J.jnp.asarray(x))
    np.testing.assert_allclose(torch.softmax(pt, -1).numpy(), np.asarray(jp),
                               atol=1e-4)
    np.testing.assert_allclose(wl_to_value(wt).numpy(), np.asarray(jv),
                               atol=1e-4)


def test_inference_apply_f32_matches_flax_on_the_archive_net():
    variables = _archive_variables()
    tnet = convert.load_archive(ARCHIVE, device="cpu")
    x = _planes(4, 7)
    pj, wj = J.network.AlphaZeroNet(20, 128, 8).apply(
        variables, J.jnp.asarray(x), train=False)
    pt, wt = inference.inference_apply(
        inference.prepare_inference(tnet, torch.float32), torch.from_numpy(x))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4, rtol=0)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-4, rtol=0)


def test_inference_apply_bf16_within_bf16_limits():
    """The bf16 forward of the archive net on ``chip_smoke``'s 64
    positions: within each of ``BF16_LIMITS`` (logit, probability, value)
    of Flax's f32 net, as phase 2 holds it on the card, and of the JAX
    package's own bf16 inference."""
    import chip_smoke
    from alphazero_torch.env import breakthrough as tenv

    planes = tenv.encoded_state(chip_smoke.random_positions(64, 11))
    variables, x = _archive_variables(), J.jnp.asarray(planes.numpy())
    flax = {dt: [np.array(a, np.float32) for a in J.network.AlphaZeroNet(
        20, 128, 8, dtype=dt).apply(variables, x)]
        for dt in (J.jnp.float32, J.jnp.bfloat16)}
    prep = inference.prepare_inference(
        convert.load_archive(ARCHIVE, device="cpu"), torch.bfloat16)
    p16, w16 = (a.numpy() for a in inference.inference_apply(prep, planes))
    softmax = lambda a: torch.softmax(torch.from_numpy(a), -1).numpy()
    value = lambda w: wl_to_value(torch.from_numpy(w)).numpy()
    for p, w in flax.values():
        dev = (max(np.abs(p16 - p).max(), np.abs(w16 - w).max()),
               np.abs(softmax(p16) - softmax(p)).max(),
               np.abs(value(w16) - value(w)).max())
        assert all(d <= lim for d, lim in zip(dev, chip_smoke.BF16_LIMITS)), \
            dev


def test_flatten_order_of_the_heads_matters():
    """Without ``_hwc_dense`` (the module's (c, h, w) kernels on an NHWC
    flatten) the logits move: the heads' input order is not a no-op."""
    gen = torch.Generator().manual_seed(6)
    net = AlphaZeroNet(1, 8, 8).eval()
    with torch.no_grad():
        for p in net.parameters():
            p.normal_(0, 0.3, generator=gen)
    x = torch.from_numpy(_planes(4, 3))
    prep = inference.prepare_inference(net, torch.float32)
    good = inference.inference_apply(prep, x)
    with torch.no_grad():
        want = net(x)
    for g, w in zip(good, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    bad = dict(prep, policy_fc=(net.policy_fc.weight.detach().T.contiguous(),
                                prep["policy_fc"][1]))
    assert not torch.allclose(inference.inference_apply(bad, x)[0], good[0],
                              atol=1e-3)


def test_bf16_evaluator_runs_inference_apply():
    """``make_net_evaluator(net, bfloat16)`` is softmax and WL value over
    ``inference_apply`` of a snapshot of the weights; float32 keeps the
    module's forward."""
    gen = torch.Generator().manual_seed(8)
    net = AlphaZeroNet(2, 16, 8).eval()
    x = torch.from_numpy(_planes(6, 9))
    eval16 = mcts.make_net_evaluator(net, torch.bfloat16)
    pl, wl = inference.inference_apply(
        inference.prepare_inference(net, torch.bfloat16), x)
    probs, value = eval16(x)
    assert torch.equal(probs, torch.softmax(pl, -1))
    assert torch.equal(value, wl_to_value(wl))
    p32, v32 = mcts.make_net_evaluator(net)(x)
    with torch.no_grad():
        mp, mw = net(x)
    assert torch.equal(p32, torch.softmax(mp, -1))
    assert torch.equal(v32, wl_to_value(mw))
    with torch.no_grad():                  # later training: no effect
        for p in net.parameters():
            p.add_(torch.randn(p.shape, generator=gen))
    assert all(torch.equal(a, b) for a, b in zip(eval16(x), (probs, value)))


def test_wrappers_refuse_maps_of_other_shapes():
    bn = (torch.zeros(8), torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError, match=r"\(B, 8, 8, C\)"):
        epilogue.bn_act(torch.zeros(2, 64, 8), bn)
    fc1 = (torch.zeros(8, 1), torch.zeros(1))
    fc2 = (torch.zeros(1, 16), torch.zeros(16))
    with pytest.raises(ValueError, match="like"):
        epilogue.se_residual(torch.zeros(2, 8, 8, 8), torch.zeros(3, 8, 8, 8),
                             fc1, fc2)


# -----------------------------------------------------------------------------
# On the card: each kernel against its plain version
# -----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_bn(C, seed, dev):
    g = torch.Generator().manual_seed(seed)
    mean = torch.randn(C, generator=g) * 0.5
    var = torch.rand(C, generator=g) * 3 + 0.05
    gamma = torch.randn(C, generator=g) * 0.5 + 1
    mul = torch.rsqrt(var + EPS) * gamma
    return tuple(t.to(dev) for t in (mean, mul, torch.randn(C, generator=g)))


def _card_fc(C, H, seed, dev):
    g = torch.Generator().manual_seed(seed)
    w = lambda *s: (torch.randn(s, generator=g) * 0.3).to(dev, torch.bfloat16)
    return (w(C, H), w(H)), (w(H, 2 * C), w(2 * C))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2, 37, 512])
@pytest.mark.parametrize("C", [32, 128])
def test_cuda_bn_act_against_plain(cuda, B, C):
    """Bit-equal to ``bn_act_plain`` on the card: one launch."""
    g = torch.Generator().manual_seed(B * C)
    y = (torch.randn((B, 8, 8, C), generator=g) * 3).to(cuda, torch.bfloat16)
    bn = _card_bn(C, B + C, cuda)
    launches = epilogue.bn_act.launches
    got = epilogue.bn_act(y, bn)
    want = epilogue.bn_act_plain(y, bn)
    torch.cuda.synchronize()
    assert epilogue.bn_act.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2, 37, 133, 512, 1031])
@pytest.mark.parametrize("C", [32, 128, 256])
@pytest.mark.parametrize("affine", [True, False], ids=["bn", "no_bn"])
def test_cuda_se_residual_against_plain(cuda, B, C, affine):
    """``se_residual_plain`` with float64 sums on the card (the kernel's
    float32 sums of bf16 terms, in its own order, round the same but for
    a rare last bit): every element within one bf16 step, and at most
    ``SE_UNEQUAL_SHARE`` of them unequal."""
    y, x, fc1, fc2, bn = _card_inputs(B, C, affine, cuda)
    launches = epilogue.se_residual.launches
    got = epilogue.se_residual(y, x, fc1, fc2, bn)
    want = epilogue.se_residual_plain(y, x, fc1, fc2, bn, f64_sums=True)
    torch.cuda.synchronize()
    assert epilogue.se_residual.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert _card_check(got, want) == (True, True)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [128, 256])
@pytest.mark.parametrize("affine", [True, False], ids=["bn", "no_bn"])
def test_cuda_se_residual_board_is_independent_of_the_batch(cuda, C,
                                                           affine):
    """Every board of a 512-board call bit-equal to the same board sent
    alone, and the call bit-equal when repeated: the kernel's sums do not
    depend on the batch, the block or the warpgroup."""
    y, x, fc1, fc2, bn = _card_inputs(512, C, affine, cuda)
    got = epilogue.se_residual(y, x, fc1, fc2, bn)
    again = epilogue.se_residual(y, x, fc1, fc2, bn)
    alone = torch.cat([epilogue.se_residual(y[b:b + 1].contiguous(),
                                            x[b:b + 1].contiguous(), fc1,
                                            fc2, bn) for b in range(512)])
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, alone)


@pytest.mark.gpu
def test_cuda_epilogues_refuse_what_the_kernels_do_not_take(cuda):
    """A CUDA map of another dtype, a map that is not contiguous, constants
    on the host: each raises, and nothing launches."""
    bn = _card_bn(32, 0, cuda)
    fc1, fc2 = _card_fc(32, 4, 0, cuda)
    y = torch.randn((4, 8, 8, 32), device=cuda, dtype=torch.bfloat16)
    before = (epilogue.bn_act.launches, epilogue.se_residual.launches)
    with pytest.raises(TypeError, match="bfloat16"):
        epilogue.bn_act(y.float(), bn)
    with pytest.raises(TypeError, match="bfloat16"):
        epilogue.se_residual(y.float(), y.float(), fc1, fc2)
    strided = torch.randn((4, 8, 8, 64), device=cuda,
                          dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="contiguous"):
        epilogue.bn_act(strided, bn)
    with pytest.raises(ValueError, match="contiguous"):
        epilogue.se_residual(y, strided, fc1, fc2)
    with pytest.raises(ValueError, match="mean on cpu"):
        epilogue.bn_act(y, tuple(t.cpu() for t in bn))
    with pytest.raises(TypeError, match="float32"):
        epilogue.se_residual(y, y, fc1, fc2, tuple(t.double() for t in bn))
    wide = torch.zeros((1, 8, 8, 264), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="up to 256"):
        epilogue.se_residual(wide, wide, *_card_fc(264, 33, 0, cuda))
    widest = torch.zeros((1, 8, 8, 256), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="H up to 32"):
        epilogue.se_residual(widest, widest, *_card_fc(256, 33, 0, cuda))
    odd = torch.zeros((1, 8, 8, 36), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        epilogue.se_residual(odd, odd, *_card_fc(36, 4, 0, cuda))
    assert (epilogue.bn_act.launches, epilogue.se_residual.launches) == before


def _wide_net(seed):
    """A 2 x 256 net (se_ratio 8: 32 hidden units) with random weights,
    scaled by the fan-in so that its maps keep the 2 x 32 test's sizes."""
    gen = torch.Generator().manual_seed(seed)
    net = AlphaZeroNet(2, 256, 8).eval()
    with torch.no_grad():
        for p in net.parameters():
            p.normal_(0, 0.2 * (32 / 256) ** 0.5, generator=gen)
    return net


@pytest.mark.gpu
def test_cuda_forward_of_a_256_filter_net_against_the_cpu(cuda):
    """The bf16 forward of a 2 x 256 net on the card (two launches of
    ``se_residual_kernel`` at C 256, H 32) against the same forward on the
    CPU: logits within 0.05, as at 32 filters."""
    net = _wide_net(12)
    x = torch.from_numpy(_planes(37, 4))
    want = inference.inference_apply(
        inference.prepare_inference(net, torch.bfloat16), x)
    prep = inference.prepare_inference(copy.deepcopy(net).to(cuda),
                                       torch.bfloat16)
    launches = epilogue.se_residual.launches
    got = inference.inference_apply(prep, x.to(cuda))
    torch.cuda.synchronize()
    assert epilogue.se_residual.launches == launches + 2
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) < 0.05


@pytest.mark.gpu
def test_cuda_forward_against_the_cpu(cuda):
    """The bf16 forward of a 2 x 32 net on the card (the conv and epilogue
    kernels) against the same forward on the CPU (plain versions): logits
    within 0.05; the evaluator captures and replays in a CUDA graph."""
    gen = torch.Generator().manual_seed(2)
    net = AlphaZeroNet(2, 32, 8).eval()
    with torch.no_grad():
        for p in net.parameters():
            p.normal_(0, 0.2, generator=gen)
    x = torch.from_numpy(_planes(37, 4))
    want = inference.inference_apply(
        inference.prepare_inference(net, torch.bfloat16), x)
    prep = inference.prepare_inference(copy.deepcopy(net).to(cuda),
                                       torch.bfloat16)
    got = inference.inference_apply(prep, x.to(cuda))
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) < 0.05
    xs = x.to(cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        inference.inference_apply(prep, xs)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = inference.inference_apply(prep, xs)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, g) for o, g in zip(out, got))
