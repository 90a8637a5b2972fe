"""PyTorch port's int8 evaluator held against the JAX package's.

The tiny setup of ``tests/test_quant.py`` (3 blocks x 32 filters with
roughened BN statistics and kernels, sparse planes): the same numpy inputs
go through ``alphazero_tpu.models.quant`` and ``alphazero_torch.models.
quant``. QuantParams cross from JAX through ``convert.quant_params_from_
numpy``, so both packages run on the same int8 weights. The s32 sums of a
conv are exact in both; XLA fuses the dequantise into an FMA, the port
does not, so a float output may differ by one ulp, and through 7
quantisation steps such ulps may move an int8 step: the whole forward is
held to stated bounds. The tests marked ``gpu`` hold the CUDA kernel
against ``qconv_plain`` on the card bit for bit and import no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_quant.py``.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from alphazero_torch.models import convert
from alphazero_torch.models import quant as tq
from alphazero_torch.models.network import AlphaZeroNet


class _Jax:
    """The JAX side, imported at first use."""

    def __getattr__(self, name):
        import jax
        import jax.numpy as jnp

        from alphazero_tpu.models import quant as jquant
        from tests import test_quant

        self.__dict__.update(jax=jax, jnp=jnp, quant=jquant, tq=test_quant)
        return self.__dict__[name]


J = _Jax()


def _flat(variables):
    from tests.test_torch_fused import _flat as flat

    return flat(variables)


def _both(scan=False, seed=0):
    """(JAX cfg, net, variables; the port's net with the same weights)."""
    cfg, net, variables = J.tq._tiny(scan_blocks=scan, seed=seed)
    tnet = convert.load_flat_into(
        AlphaZeroNet(cfg.num_blocks, cfg.num_filters, cfg.se_ratio).eval(),
        _flat(variables))
    return cfg, net, variables, tnet


def _np(tree):
    return J.jax.tree_util.tree_map(np.asarray, tree)


def _planes(cfg, n=64, seed=1):
    return np.asarray(J.tq._planes(cfg, n=n, seed=seed))


def _ulps(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want) / np.spacing(np.abs(want))


# -----------------------------------------------------------------------------
# Folding and weight quantisation
# -----------------------------------------------------------------------------

def test_fold_within_two_ulp():
    rng = np.random.default_rng(0)
    kernel = rng.normal(0, 0.2, (3, 3, 16, 24)).astype(np.float32)
    bn_p = {"scale": rng.uniform(0.5, 2, 24).astype(np.float32),
            "bias": rng.normal(0, 0.3, 24).astype(np.float32)}
    bn_s = {"mean": rng.normal(0, 0.3, 24).astype(np.float32),
            "var": rng.uniform(0.3, 3, 24).astype(np.float32)}
    jk, jb = J.quant._fold(*(J.jax.tree_util.tree_map(J.jnp.asarray, a)
                             for a in (kernel, bn_p, bn_s)))
    tk, tb = tq._fold(*(J.jax.tree_util.tree_map(torch.from_numpy, a)
                        for a in (kernel, bn_p, bn_s)))
    assert _ulps(tk, jk).max() <= 2 and _ulps(tb, jb).max() <= 2


@pytest.mark.parametrize("scan", [False, True], ids=["inlined", "scanned"])
def test_quantize_network_matches_jax(scan):
    """Folded biases and weight scales within 2 ulp (XLA computes the
    fold's scale / sqrt(var + eps) in its own order, and a scale is a
    folded weight's amax / 127, so it inherits the fold's 2 ulp); int8
    weights equal but for at most 0.1% of entries, each one step off at
    most (a folded weight one ulp from a .5 step may round the other
    way)."""
    _, net, variables, tnet = _both(scan)
    want = _np(J.quant.quantize_network(net, variables))
    got = tq.quantize_network(tnet)

    def entries(qp):
        yield "input", qp["input"]
        for i, b in enumerate(qp["blocks"]):
            yield f"b{i}c1", b["conv1"]
            yield f"b{i}c2", b["conv2"]

    n = off = 0
    for (name, g), (_, w) in zip(entries(got), entries(want)):
        d = np.abs(g["qk"].numpy().astype(int) - w["qk"].astype(int))
        assert d.max() <= 1, name
        n, off = n + d.size, off + int((d > 0).sum())
        assert _ulps(g["scale"], w["scale"]).max() <= 2, name
        assert _ulps(g["bias"], w["bias"]).max() <= 2, name
        np.testing.assert_array_equal(
            _image_to_hwio(g["wk"].numpy(), g["qk"].shape[2]),
            g["qk"].numpy())
    assert off <= 1e-3 * n, (off, n)
    for key in ("policy", "value_conv"):
        for g, w in zip(got[key], want[key]):
            assert _ulps(g, w).max() <= 2, key
    for key in ("policy_fc", "value_fc1", "value_fc2"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got[key][leaf].numpy(),
                                          want[key][leaf])
    for g, w in zip(got["blocks"], want["blocks"]):
        for fc in ("fc1", "fc2"):
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(g["se"][fc][leaf].numpy(),
                                              w["se"][fc][leaf])


# -----------------------------------------------------------------------------
# One conv, and the whole forward, on the same int8 weights
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("point", ["input", "block"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_qconv_sums_equal_jax(point, static):
    """The same float input and scale: int32 sums EQUAL to the JAX
    package's s8 conv (``preferred_element_type=int32``), the dequantised
    output within one ulp (XLA's FMA)."""
    cfg, net, variables, _ = _both()
    qp = J.quant.quantize_network(net, variables)
    e = qp["input"] if point == "input" else qp["blocks"][1]["conv2"]
    tqp = convert.quant_params_from_numpy(_np(qp), device="cpu")
    te = tqp["input"] if point == "input" else tqp["blocks"][1]["conv2"]
    rng = np.random.default_rng(5)
    if point == "input":
        x = np.ascontiguousarray(_planes(cfg, 32).transpose(0, 2, 3, 1))
    else:
        x = rng.normal(0, 1.5, (32, 8, 8, 32)).astype(np.float32)
    xs = np.float32(np.abs(x).max() / 127.0 * (0.5 if static else 1.0))
    xq = J.jnp.clip(J.jnp.round(x / xs), -127, 127).astype(J.jnp.int8)
    want = J.jax.lax.conv_general_dilated(
        xq, e["qk"], (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO",
                                                        "NHWC"),
        preferred_element_type=J.jnp.int32)
    want_out = J.quant._qconv(J.jnp.asarray(x), e["qk"], e["scale"],
                              e["bias"], J.jnp.float32, xs=J.jnp.asarray(xs))
    tx = torch.from_numpy(x)
    if point == "input":                       # the planes' NCHW, read in place
        tx = torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1)
    out, sums = tq.qconv3x3(tx, torch.tensor(xs), te,
                            out_dtype=torch.float32, sums=True)
    np.testing.assert_array_equal(sums.numpy(), np.asarray(want))
    assert _ulps(out.numpy(), want_out).max() <= 1


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_quant_apply_matches_jax_on_carried_weights(static):
    """Whole int8 forward in f32 on QuantParams carried across from JAX:
    policy TV mean < 1e-3, value MAE < 1e-3, argmax agreement >= 0.98
    (measured: TV 3e-7 dynamic, 2e-5 static; agreement 1.0)."""
    cfg, net, variables, _ = _both()
    qp = J.quant.quantize_network(net, variables)
    tqp = convert.quant_params_from_numpy(_np(qp), device="cpu")
    planes = _planes(cfg, 64, seed=12)
    sc = None
    if static:
        sc = J.quant.calibrate(qp, [J.jnp.asarray(_planes(cfg, 64, seed=s))
                                    for s in (10, 11)])
    pl, wl = J.quant.quant_apply(qp, J.jnp.asarray(planes),
                                 dtype=J.jnp.float32, act_scales=sc)
    tpl, twl = tq.quant_apply(
        tqp, torch.tensor(planes), dtype=torch.float32,
        act_scales=None if sc is None else {k: float(v)
                                            for k, v in sc.items()})
    pj = np.asarray(J.jax.nn.softmax(pl, -1))
    pt = torch.softmax(tpl, -1).numpy()
    vj = np.asarray(J.quant.wl_to_value(wl))
    vt = tq.wl_to_value(twl).numpy()
    assert (0.5 * np.abs(pj - pt).sum(-1)).mean() < 1e-3
    assert np.abs(vj - vt).mean() < 1e-3
    assert (pj.argmax(-1) == pt.argmax(-1)).mean() >= 0.98


def test_calibrate_matches_jax():
    """The same points, in the same order, and scales within 1e-6
    relative (calibration runs the bf16 forward in both packages)."""
    cfg, net, variables, _ = _both()
    qp = J.quant.quantize_network(net, variables)
    tqp = convert.quant_params_from_numpy(_np(qp), device="cpu")
    cal = [_planes(cfg, 64, seed=s) for s in (10, 11)]
    want = J.quant.calibrate(qp, [J.jnp.asarray(c) for c in cal])
    got = tq.calibrate(tqp, [torch.from_numpy(c) for c in cal])
    assert list(got) == tq.scale_points(cfg.num_blocks)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == () and got[k].dtype == torch.float32
        assert abs(float(got[k]) - float(want[k])) <= 1e-6 * float(want[k])


@pytest.mark.parametrize("scan", [False, True], ids=["inlined", "scanned"])
def test_quant_tracks_the_ports_f32_net(scan):
    """The JAX test's own bounds (tests/test_quant.py:test_quant_tracks_f32)
    against the port's float32 net: TV < 0.02, agreement > 0.95, value MAE
    < 0.02."""
    cfg, _, _, tnet = _both(scan)
    planes = torch.from_numpy(_planes(cfg))
    with torch.no_grad():
        pol_f, wl_f = tnet(planes)
    pl, wl = tq.quant_apply(tq.quantize_network(tnet), planes,
                            dtype=torch.float32)
    pf, pq = torch.softmax(pol_f, -1), torch.softmax(pl, -1)
    tv = 0.5 * (pq - pf).abs().sum(-1)
    assert float(tv.mean()) < 0.02
    assert float((pq.argmax(-1) == pf.argmax(-1)).float().mean()) > 0.95
    vq, vf = tq.wl_to_value(wl), tq.wl_to_value(wl_f)
    assert float((vq - vf).abs().mean()) < 0.02


@pytest.mark.parametrize("value_dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_quant_evaluator_drives_search(value_dtype, static):
    """make_quant_evaluator satisfies the search's evaluator contract: a
    16-simulation search gives legal, normalised visits and counts every
    simulation at the root, with the f32 and the f16 tree."""
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.search import SearchSpec, root_child_visits, search

    cfg, _, _, tnet = _both()
    qp = tq.quantize_network(tnet)
    sc = (tq.calibrate(qp, [torch.from_numpy(_planes(cfg, 32, seed=3))])
          if static else None)
    eval_fn = tq.make_quant_evaluator(tnet, act_scales=sc, qp=qp)
    states = env.initial_state((4,), device="cpu")
    spec = SearchSpec(num_simulations=16, dirichlet_epsilon=0.0,
                      value_dtype=value_dtype)
    tree = search(states, eval_fn, spec)
    v = root_child_visits(tree).double()
    pi = v / v.sum(-1, keepdim=True)
    legal = env.legal_action_mask(states)
    assert bool((pi[~legal] == 0).all())
    assert torch.allclose(pi.sum(-1), torch.ones(4, dtype=torch.float64))
    assert int(v.sum(-1).max()) == 16 and bool((tree.root_visit == 16).all())


# -----------------------------------------------------------------------------
# The trainer's int8 self-play evaluator
# -----------------------------------------------------------------------------

def _examples(n, seed=0):
    rng = np.random.default_rng(seed)
    s = (rng.random((n, 3, 8, 8)) < 0.3).astype(np.float32)
    s[:, 2] = 1.0
    p = np.zeros((n, 192), np.float32)
    p[np.arange(n), rng.integers(0, 192, n)] = 1.0
    wl = np.tile(np.asarray([[1.0, 0.0]], np.float32), (n, 1))
    return s, p, wl


def test_calibration_draws_equal_jax(tmp_path, monkeypatch):
    """With a non-empty buffer both trainers draw the same 4096 rows with
    replacement from the same ``np_rng`` stream, in four batches of 1024,
    and leave the stream in the same state."""
    from alphazero_tpu.config import tiny_config as jtiny
    from alphazero_tpu.train import Trainer as JTrainer

    from alphazero_torch.config import tiny_config
    from alphazero_torch.train import Trainer

    seen = {}

    def spy(name):
        def calibrate(qp, batches, **kw):
            seen[name] = [np.asarray(b, np.float32) if not torch.is_tensor(b)
                          else b.numpy() for b in batches]
            return None
        return calibrate

    monkeypatch.setattr(J.quant, "calibrate", spy("jax"))
    monkeypatch.setattr(tq, "calibrate", spy("torch"))
    kw = dict(checkpoint_dir=str(tmp_path), num_blocks=1, num_filters=8,
              selfplay_quant="static", buffer_size=512)
    jt = JTrainer(jtiny(**kw), seed=4)
    tt = Trainer(tiny_config(**kw), seed=4, device="cpu")
    s, p, wl = _examples(300)
    jt.buffer.add_arrays(s, p, wl)
    tt.buffer.add_arrays(s.astype(np.uint8), p, wl)
    jt._selfplay_evaluator()
    tt._selfplay_evaluator()
    assert [b.shape for b in seen["torch"]] == [(1024, 3, 8, 8)] * 4
    for a, b in zip(seen["jax"], seen["torch"]):
        np.testing.assert_array_equal(a, b)
    assert jt.np_rng.bit_generator.state == tt.np_rng.bit_generator.state


@pytest.mark.parametrize("flavor", ["dynamic", "static"])
def test_trainer_runs_int8_selfplay(tmp_path, monkeypatch, flavor):
    """Two tiny iterations with the int8 self-play evaluator; the second
    static one calibrates on the buffer the first filled (the first, on
    an empty buffer, plays with dynamic scales, as in the JAX package)."""
    from alphazero_torch.config import tiny_config
    from alphazero_torch.train import Trainer

    calls = []
    real = tq.calibrate
    monkeypatch.setattr(tq, "calibrate", lambda qp, batches, **kw: (
        calls.append(len(batches)), real(qp, batches, **kw))[1])
    tr = Trainer(tiny_config(checkpoint_dir=str(tmp_path), num_blocks=1,
                             num_filters=8, num_simulations=2,
                             parallel_games=4, batch_size=16,
                             selfplay_batches=1, selfplay_quant=flavor),
                 seed=0, device="cpu")
    metrics = [tr.run_iteration() for _ in range(2)]
    assert [m["iteration"] for m in metrics] == [1, 2]
    assert all(m["examples_new"] > 0 and np.isfinite(m["loss"])
               for m in metrics)
    assert calls == ([4] if flavor == "static" else [])
    assert sorted(os.listdir(tmp_path)) == [
        "iteration_1", "iteration_2", "metrics.jsonl", "training_data.npz"]


# -----------------------------------------------------------------------------
# The kernel's wrapper
# -----------------------------------------------------------------------------

def _image_to_kmajor(img):
    """numpy inverse of ``wk_smem_image``: (chunks, cout, 128) -> (cout,
    chunks*128). Stored piece p of row n holds piece p ^ (n % 8), and the
    swizzle is its own inverse."""
    chunks, cout, _ = img.shape
    n = np.arange(cout)[:, None]
    pieces = img.reshape(chunks, cout, 8, 16)[:, n, np.arange(8) ^ (n % 8)]
    return pieces.transpose(1, 0, 2, 3).reshape(cout, chunks * 128)


def _image_to_hwio(img, cin):
    """The HWIO kernel back from the image; the padding past 9*cin is 0."""
    kmajor = _image_to_kmajor(img)
    assert not kmajor[:, 9 * cin:].any()
    return kmajor[:, :9 * cin].T.reshape(3, 3, cin, -1)


def _b_tile(img, step):
    """The 32 x cout s8 tile that the kernel's descriptor reads at k-step
    ``step``: chunk step // 4, logical pieces 2*(step % 4) and the next,
    found where the swizzle put them."""
    cout = img.shape[1]
    n = np.arange(cout)[:, None]
    logical = 2 * (step % 4) + np.arange(2)
    return img[step // 4].reshape(cout, 8, 16)[n, logical ^ (n % 8)] \
        .reshape(cout, 32)


def _kernel_sums(xq, img):
    """A numpy emulation of the kernel's products on quantised ``xq`` (B,
    8, 8, cin): the A rows built as the producer builds them (cin 3:
    im2col rows of k = tap*cin + ci from a padded board, zero from 27 to
    32; otherwise the square's s8 row, shifted by the tap as the
    consumer's ldmatrix addresses shift it, zero off the board) times the
    image's tiles, k-step by k-step in the kernel's order."""
    B, _, _, cin = xq.shape
    board = np.pad(xq.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    shifted = [board[:, t // 3:t // 3 + 8, t % 3:t % 3 + 8].reshape(B, 64,
                                                                    cin)
               for t in range(9)]
    acc = np.zeros((B, 64, img.shape[1]), np.int64)
    if cin < 32:
        rows = np.zeros((B, 64, 32), np.int64)
        for k in range(9 * cin):
            rows[:, :, k] = shifted[k // cin][:, :, k % cin]
        return acc + rows @ _b_tile(img, 0).T.astype(np.int64)
    step = 0
    for tap in range(9):
        for j in range(cin // 32):
            acc += shifted[tap][:, :, 32 * j:32 * j + 32] \
                @ _b_tile(img, step).T.astype(np.int64)
            step += 1
    return acc


@pytest.mark.parametrize("cin,cout", [(3, 128), (128, 128), (32, 32)])
def test_weight_image_inverts_to_qk(cin, cout):
    """``qconv_entry``'s image, un-swizzled and un-padded, is ``qk``
    exactly; its shape is what the kernel copies: ceil(9*cin/128) chunks
    of cout rows of 128 bytes."""
    qk = _random_entry(cin, cout, cin)["qk"]
    img = tq.qconv_entry(qk, torch.ones(cout), torch.zeros(cout))["wk"]
    assert img.dtype == torch.int8 and img.is_contiguous()
    assert tuple(img.shape) == (-(-9 * cin // 128), cout, 128)
    np.testing.assert_array_equal(_image_to_hwio(img.numpy(), cin),
                                  qk.numpy())


@pytest.mark.parametrize("cin,cout", [(3, 128), (128, 128), (32, 32)])
def test_kernel_k_order_sums_equal_plain(cin, cout):
    """The kernel's order of products (im2col rows at cin 3, shifted rows
    and k-steps of 32 otherwise, against the swizzled image) gives the
    s32 sums of ``qconv_plain`` exactly, at the board edges too."""
    e = _random_entry(cin, cout, 7 + cin)
    g = torch.Generator().manual_seed(cin)
    x = torch.randn((3, 8, 8, cin), generator=g) * 2
    xs = x.abs().amax() / 127.0
    _, want = tq.qconv_plain(x, xs, e, sums=True)
    xq = torch.clamp(torch.round(x / xs), -127, 127).to(torch.int8)
    got = _kernel_sums(xq.numpy(), e["wk"].numpy())
    np.testing.assert_array_equal(got.reshape(want.shape), want.numpy())


def _random_entry(cin, cout, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    folded = torch.randn((3, 3, cin, cout), generator=g) * 0.1
    qk, scale = tq._quant_weight(folded)
    bias = torch.randn((cout,), generator=g) * 0.2
    return {k: v.to(device) for k, v in
            tq.qconv_entry(qk, scale, bias).items()}


def test_qconv_wrapper_uses_the_plain_version_on_the_cpu():
    e = _random_entry(32, 16, 0)
    x = torch.randn((3, 8, 8, 32))
    xs = x.abs().amax() / 127.0
    launches = tq.qconv3x3.launches
    got = tq.qconv3x3(x, xs, e, relu=True, out_dtype=torch.float32)
    want = tq.qconv_plain(x, xs, e, relu=True, out_dtype=torch.float32)
    assert torch.equal(got, want) and tq.qconv3x3.launches == launches
    assert float(got.min()) == 0.0
    with pytest.raises(ValueError, match="activations"):
        tq.qconv3x3(x[..., :16], xs, e)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tq.qconv3x3(x.double(), xs, e)
    if not torch.cuda.is_available():
        from alphazero_torch import resolve_device

        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")


def test_qconv_plain_sums_are_exact_past_float32():
    """Sums past 2^24 (all-127 inputs and weights at 128 channels):
    float64 keeps them exact where float32 would not."""
    qk = torch.full((3, 3, 128, 8), 127, dtype=torch.int8)
    e = tq.qconv_entry(qk, torch.ones(8), torch.zeros(8))
    x = torch.full((1, 8, 8, 128), 127.0)
    _, sums = tq.qconv_plain(x, torch.tensor(1.0), e, sums=True)
    assert int(sums[0, 4, 4, 0]) == 9 * 128 * 127 * 127 > 2 ** 24
    assert int(sums[0, 0, 0, 0]) == 4 * 128 * 127 * 127


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout,positions", [
    (3, 128, 512), (128, 128, 512), (128, 128, 7), (32, 128, 5),
    # ragged, and past one wave of 132 blocks x 4 positions
    (128, 128, 1), (128, 128, 3), (128, 128, 129), (128, 128, 513),
    (128, 128, 2048), (3, 128, 2048),
    # the test configurations' widths
    (3, 32, 33), (32, 32, 130)])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
def test_cuda_qconv_against_plain(cuda, cin, cout, positions, static, relu):
    """The kernel's sums and outputs bit-equal to ``qconv_plain`` on the
    card, bf16 and f32 out; cin 3 reads f32 NCHW planes in place, the
    others bf16 NHWC."""
    e = _random_entry(cin, cout, cin + positions, cuda)
    g = torch.Generator().manual_seed(positions)
    if cin == 3:
        x = (torch.rand((positions, 3, 8, 8), generator=g) < 0.3).float()
        x = x.to(cuda).permute(0, 2, 3, 1)
    else:
        x = (torch.randn((positions, 8, 8, cin), generator=g) * 2).to(
            cuda, torch.bfloat16)
    amax = x.float().abs().amax()
    xs = (amax / 2 if static else torch.clamp_min(amax, 1e-6)) / 127.0
    for out_dtype in (torch.bfloat16, torch.float32):
        launches = tq.qconv3x3.launches
        got, gsum = tq.qconv3x3(x, xs, e, relu, out_dtype, sums=True)
        want, wsum = tq.qconv_plain(x, xs, e, relu, out_dtype, sums=True)
        torch.cuda.synchronize()
        assert tq.qconv3x3.launches == launches + 1
        assert torch.equal(gsum, wsum)
        assert got.dtype == out_dtype and torch.equal(got, want)
        assert bool(torch.isfinite(got.float()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("xs", [1e-3, 1.0 / 127, 0.0137, 3.1, 2.0 ** -20])
def test_cuda_qconv_quantises_every_bf16_as_plain(cuda, xs):
    """Every finite bf16 value (65,280 of the 65,536 bit patterns; NaN and
    infinities become 0) as the input of eight positions: the kernel's
    quantise (its division without __fdiv_rn's slow-path branch) gives
    sums and outputs bit-equal to ``qconv_plain``'s at several scales."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16).float()
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    x = x.to(torch.bfloat16).reshape(8, 8, 8, 128)
    perm = torch.randperm(x.numel(), generator=torch.Generator()
                          .manual_seed(3))       # mix magnitudes on a board
    x = x.reshape(-1)[perm].reshape(8, 8, 8, 128).to(cuda)
    e = _random_entry(128, 128, 11, cuda)
    xs_t = torch.tensor(xs, dtype=torch.float32, device=cuda)
    got, gsum = tq.qconv3x3(x, xs_t, e, sums=True)
    want, wsum = tq.qconv_plain(x, xs_t, e, sums=True)
    assert torch.equal(gsum, wsum) and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("layout,cin", [
    ("f32_nhwc", 32), ("bf16_nchw", 128),      # element by element
    ("f32_nhwc_strided", 3),                    # element by element
    ("bf16_nhwc", 3)])                          # staged, rows not planes
def test_cuda_qconv_reads_other_layouts(cuda, layout, cin):
    """Input other than the path's (bf16 NHWC rows at cin >= 32, f32 NCHW
    planes at cin 3): the producer reads element by element where a
    position is not contiguous, and stages it by bulk copy where it is;
    bit-equal to ``qconv_plain`` all the same."""
    e = _random_entry(cin, 128, 4 + cin, cuda)
    g = torch.Generator().manual_seed(9)
    x = torch.randn((130, 8, 8, cin + 1), generator=g) * 2
    if layout == "f32_nhwc_strided":
        x = x.to(cuda)[..., :cin]               # a channel stride of cin + 1
    elif layout == "bf16_nchw":
        x = x[..., :cin].permute(0, 3, 1, 2).contiguous() \
            .to(cuda, torch.bfloat16).permute(0, 2, 3, 1)
    else:
        x = x[..., :cin].contiguous().to(
            cuda, torch.float32 if layout == "f32_nhwc" else torch.bfloat16)
    xs = x.float().abs().amax() / 127.0
    got, gsum = tq.qconv3x3(x, xs, e, True, torch.float32, sums=True)
    want, wsum = tq.qconv_plain(x, xs, e, True, torch.float32, sums=True)
    assert torch.equal(gsum, wsum) and torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_qconv_refuses_what_the_kernel_does_not_take(cuda):
    e = _random_entry(128, 128, 1, cuda)
    x = torch.randn((4, 8, 8, 128), device=cuda, dtype=torch.bfloat16)
    xs = x.float().abs().amax() / 127.0
    launches = tq.qconv3x3.launches
    bad = dict(e, wk=e["wk"][:, :120])
    with pytest.raises(ValueError, match="int8 weights"):
        tq.qconv3x3(x, xs, bad)
    e32 = _random_entry(32, 128, 3, cuda)  # (9, cout, cin), not the image
    old_form = dict(e32, wk=e32["qk"].reshape(9, 32, 128).transpose(1, 2)
                    .contiguous())
    with pytest.raises(ValueError, match="wk_smem_image"):
        tq.qconv3x3(x[..., :32].contiguous(), xs, old_form)
    for cin, cout in ((16, 128), (64, 128), (128, 64)):  # not in the domain
        narrow = _random_entry(cin, cout, 2, cuda)
        with pytest.raises(ValueError, match=r"cin in \(3, 32"):
            tq.qconv3x3(x[..., :cin].contiguous(), xs, narrow)
    with pytest.raises(ValueError, match="xs"):
        tq.qconv3x3(x, xs.double(), e)
    with pytest.raises(ValueError, match="operand"):
        tq.qconv3x3(x, xs.cpu(), e)
    assert tq.qconv3x3.launches == launches

