"""PyTorch port's learner and replay held against the JAX package's.

The same weights (through the archive key scheme), the same batch and the
same mirror bits, made with numpy, go through ``_train_step_impl`` of the
JAX package and ``train_step`` of the port, in float32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(1)
from flax import traverse_util

from alphazero_tpu.config import tiny_config as jax_tiny_config
from alphazero_tpu.models.network import init_network
from alphazero_tpu.train import learner as jlearner
from alphazero_tpu.train import replay as jreplay

from alphazero_torch.config import tiny_config
from alphazero_torch.models import convert
from alphazero_torch.models.network import AlphaZeroNet
from alphazero_torch.train import learner, replay

BLOCKS, FILTERS, BATCH = 2, 16, 32


def _flat(params=None, batch_stats=None):
    flat = {}
    for col, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, leaf in traverse_util.flatten_dict(tree or {}).items():
            flat[col + "/" + "/".join(path)] = np.asarray(leaf)
    return flat


def _as_torch(params=None, batch_stats=None):
    """A Flax tree in the port's names and layouts (numpy arrays)."""
    return {k: v.numpy() for k, v in
            convert.state_dict_from_flat(_flat(params, batch_stats)).items()}


def _batch(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    states = (rng.random((n, 3, 8, 8)) < 0.3).astype(np.uint8)
    pi = rng.random((n, 192)).astype(np.float32) ** 4
    pi /= pi.sum(-1, keepdims=True)
    win = rng.random(n) < 0.5
    wl = np.stack([win, ~win], -1).astype(np.float32)
    mirror = rng.random(n) < 0.5
    return states, pi, wl, mirror


def test_mirror_permutation_and_gather_equal_jax():
    np.testing.assert_array_equal(learner.mirror_permutation(),
                                  jlearner.mirror_permutation())
    np.testing.assert_array_equal(learner._MIRROR_GATHER,
                                  jlearner._MIRROR_GATHER)


@pytest.mark.parametrize("t_max,calls", [(200, 0), (200, 1), (200, 77),
                                         (200, 200), (100, 50), (50, 75)])
def test_cosine_lr_equals_jax(t_max, calls):
    kw = dict(learning_rate=1e-3, lr_t_max=t_max, lr_eta_min=1e-5)
    want = float(jlearner.cosine_lr(jax_tiny_config(**kw),
                                    jnp.asarray(calls)))
    # the JAX package evaluates the closed form in float32
    assert learner.cosine_lr(tiny_config(**kw), calls) == pytest.approx(
        want, rel=1e-6)


@pytest.mark.parametrize("n,bs,steps", [(100, 32, None), (1, 16, None),
                                        (257, 64, 3), (40, 64, 5)])
def test_epoch_batches_bit_equal_under_the_same_seed(n, bs, steps):
    want = jreplay.epoch_batches(np.random.default_rng(n), n, bs, steps)
    got = replay.epoch_batches(np.random.default_rng(n), n, bs, steps)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _examples(seed, n):
    s, p, w, _ = _batch(seed, n)
    return [(s[i], p[i], w[i]) for i in range(n)]


@pytest.mark.parametrize("writer,reader", [(jreplay, replay),
                                           (replay, jreplay)],
                         ids=["jax-writes", "port-writes"])
def test_replay_files_cross_between_the_packages(tmp_path, writer, reader):
    path = str(tmp_path / "training_data.npz")
    assert writer.append_training_data(path, _examples(0, 5)) == 5
    # and each appends to the other's file
    assert reader.append_training_data(path, _examples(1, 7)) == 12
    with np.load(path) as data:
        assert sorted(data.files) == ["policies", "states", "wls"]
        assert data["states"].dtype == np.uint8
        assert data["policies"].dtype == data["wls"].dtype == np.float32
    bufs = []
    for mod in (jreplay, replay):
        buf = mod.ReplayBuffer(capacity=8)
        assert mod.load_training_data(path, buf) == 8      # newest 8 of 12
        bufs.append(buf)
    for field in ("states", "policies", "wls"):
        np.testing.assert_array_equal(getattr(bufs[0], field),
                                      getattr(bufs[1], field))
    want = np.stack([e[0] for e in _examples(0, 5) + _examples(1, 7)])[-8:]
    np.testing.assert_array_equal(bufs[1].states, want)


def test_replay_buffer_ring_and_write_spans_equal_jax():
    bufs = [mod.ReplayBuffer(capacity=10) for mod in (jreplay, replay)]
    spans = []
    for buf in bufs:
        log = [buf.consume_writes()]                 # None: full resync
        buf.add(_examples(2, 4))
        log.append(buf.consume_writes())
        s, p, w, _ = _batch(3, 9)
        buf.add_arrays(s, p, w)                      # wraps the ring
        log.append(buf.consume_writes())
        log.append(buf.consume_writes())             # nothing new
        buf.add_arrays(*_batch(4, 25)[:3])           # larger than capacity
        log.append(buf.consume_writes())
        spans.append(log)
    assert spans[0] == spans[1]
    assert spans[1][0] is None and spans[1][3] == [] and spans[1][4] is None
    a, b = bufs
    assert (len(a), a.cursor, a.version) == (len(b), b.cursor, b.version)
    for field in ("states", "policies", "wls"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    got = b.sample(np.random.default_rng(0), 4)
    want = a.sample(np.random.default_rng(0), 4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def both():
    """The JAX train state and the port's, on the same weights."""
    cfg = jax_tiny_config(num_blocks=BLOCKS, num_filters=FILTERS,
                          batch_size=BATCH)
    net, variables = init_network(cfg, jax.random.PRNGKey(0))
    jstate = jlearner.create_train_state(cfg, net, variables)
    step = jax.jit(jlearner._train_step_impl, static_argnames=("net", "cfg"))
    tcfg = tiny_config(num_blocks=BLOCKS, num_filters=FILTERS,
                       batch_size=BATCH)

    def fresh_port_state():
        tnet = convert.load_flat_into(AlphaZeroNet(BLOCKS, FILTERS, 8),
                                      _flat(**variables))
        return learner.create_train_state(tcfg, tnet, device="cpu")

    return cfg, net, jstate, step, tcfg, fresh_port_state


def _jax_step(both, jstate, seed):
    cfg, net, _, step, _, _ = both
    s, p, w, m = _batch(seed)
    return step(jstate, (jnp.asarray(s), jnp.asarray(p), jnp.asarray(w)),
                jnp.asarray(m), net, cfg)


def _port_step(both, tstate, seed):
    s, p, w, m = _batch(seed)
    return learner.train_step(
        tstate, (torch.from_numpy(s), torch.from_numpy(p),
                 torch.from_numpy(w)), torch.from_numpy(m), both[4])


def _adam(tstate):
    names = [n for n, _ in tstate.net.named_parameters()]
    st = [tstate.opt.state[p] for p in tstate.net.parameters()]
    return ({n: s["exp_avg"].numpy() for n, s in zip(names, st)},
            {n: s["exp_avg_sq"].numpy() for n, s in zip(names, st)})


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(both, steps):
    cfg, net, jstate, _, tcfg, fresh = both
    tstate = fresh()
    for i in range(steps):
        jstate, jm = _jax_step(both, jstate, 100 + i)
        tm = _port_step(both, tstate, 100 + i)
        # the loss sees the same weights up to the parameter tolerance below
        for key in ("loss", "loss_pi", "loss_wl"):
            assert float(tm[key]) == pytest.approx(float(jm[key]),
                                                   abs=1e-5)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)

    # the clipped gradient of the last step: only the order of the sums
    # differs between XLA's and PyTorch's CPU kernels
    adam = jstate.opt_state[2]            # (clip, decay, scale_by_adam)
    mu, nu = _as_torch(adam.mu), _as_torch(adam.nu)
    got_mu, got_nu = _adam(tstate)
    assert set(got_mu) == set(mu)
    # Adam moments: tight. After one step they are (1-b1)*g and (1-b2)*g^2
    # of the clipped, decayed gradient; after three they also carry the
    # first steps' parameter differences (below), hence the wider band
    tol = 1e-6 if steps == 1 else 1e-5
    for name in mu:
        scale = max(1.0, float(np.abs(mu[name]).max()) / 0.1)
        np.testing.assert_allclose(got_mu[name], mu[name],
                                   atol=tol * 0.1 * scale, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(got_nu[name], nu[name],
                                   atol=tol * 1e-3, rtol=1e-3, err_msg=name)
    if steps == 1:
        # gradients themselves, from the first moment: mu = 0.1 * g
        grads = {n: p.grad.numpy()
                 for n, p in tstate.net.named_parameters()}
        for name in mu:
            # p.grad is the clipped gradient; Adam added the weight decay
            want = mu[name] / 0.1 - tcfg.weight_decay * _as_torch(
                params=_train_params(both))[name]
            np.testing.assert_allclose(grads[name], want, atol=2e-5,
                                       rtol=0, err_msg=name)

    # BN statistics: Flax takes the batch variance as E[x^2] - E[x]^2,
    # PyTorch in two passes; both biased, momentum 0.99
    stats = _as_torch(batch_stats=jstate.batch_stats)
    sd = {k: v.numpy() for k, v in tstate.net.state_dict().items()}
    for name, want in stats.items():
        np.testing.assert_allclose(sd[name], want, atol=1e-6, rtol=1e-6,
                                   err_msg=name)

    # Parameters: loose. Adam's first steps move every weight by about
    # +-lr whatever its gradient's size, so where the two gradients are
    # noise around zero the updates can differ by up to 2*lr per step;
    # nearly all weights agree to a small fraction of lr
    want = _as_torch(params=jstate.params)
    lr = tcfg.learning_rate
    close, total = 0, 0
    for name, w in want.items():
        np.testing.assert_allclose(sd[name], w, atol=2.05 * lr * steps,
                                   rtol=0, err_msg=name)
        close += int((np.abs(sd[name] - w) <= 0.02 * lr).sum())
        total += w.size
    assert close / total > 0.999


def _train_params(both):
    return both[2].params


def test_flax_batchnorm_update_is_reproduced():
    """One train-mode forward: running statistics move by 1% of the
    BIASED batch statistics (PyTorch's defaults would move them by 10%
    of the unbiased ones)."""
    from alphazero_torch.models.network import BatchNorm2d

    bn = BatchNorm2d(4).train()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 4, 8, 8)).astype(np.float32)) * 3 + 1
    y = bn(x)
    mean = x.mean((0, 2, 3))
    var = x.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_mean, 0.01 * mean)
    torch.testing.assert_close(bn.running_var, 0.99 + 0.01 * var)
    torch.testing.assert_close(
        y, (x - mean[None, :, None, None])
        / torch.sqrt(var + 1e-5)[None, :, None, None], atol=1e-5, rtol=1e-5)
    bn.eval()
    before = bn.running_mean.clone()
    bn(x)
    assert torch.equal(bn.running_mean, before)


def test_clip_matches_optax_on_both_sides_of_the_limit():
    rng = np.random.default_rng(0)
    for scale in (0.01, 10.0):
        g = [rng.standard_normal(s).astype(np.float32) * scale
             for s in ((3, 4), (5,))]
        want, _ = optax.clip_by_global_norm(1.0).update(
            [jnp.asarray(a) for a in g], optax.EmptyState())
        params = [torch.nn.Parameter(torch.zeros(a.shape)) for a in g]
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a.copy())
        norm = learner.clip_by_global_norm_(params, 1.0)
        assert float(norm) == pytest.approx(
            float(np.sqrt(sum((a ** 2).sum() for a in g))), rel=1e-6)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=0)


def test_update_rows_and_train_epoch_equal_stepwise_training(both):
    """``train_epoch`` over a device-resident window is the same as
    ``train_step`` over ``buffer.get`` batches; ``update_rows`` writes in
    place."""
    tcfg, fresh = both[4], both[5]
    s, p, w, _ = _batch(7, 80)
    window = (torch.zeros((100, 3, 8, 8), dtype=torch.uint8),
              torch.zeros((100, 192)), torch.zeros((100, 2)))
    ptrs = [t.data_ptr() for t in window]
    out = learner.update_rows(*window, s, p, w, 10)
    assert [t.data_ptr() for t in out] == ptrs
    np.testing.assert_array_equal(window[0][10:90].numpy(), s)
    assert not window[1][:10].any() and not window[1][90:].any()

    base_idx, mirror = replay.epoch_batches(np.random.default_rng(1), 80,
                                            BATCH)
    a, b = fresh(), fresh()
    m_epoch = learner.train_epoch(a, window, torch.from_numpy(base_idx + 10),
                                  torch.from_numpy(mirror), tcfg)
    assert m_epoch["loss"].shape == (len(base_idx),)
    for i, (bi, mi) in enumerate(zip(base_idx, mirror)):
        m = learner.train_step(
            b, (torch.from_numpy(s[bi]).float(), torch.from_numpy(p[bi]),
                torch.from_numpy(w[bi])), torch.from_numpy(mi), tcfg)
        assert float(m["loss"]) == float(m_epoch["loss"][i])
    for (k, x), (_, y) in zip(a.net.state_dict().items(),
                              b.net.state_dict().items()):
        assert torch.equal(x, y), k
