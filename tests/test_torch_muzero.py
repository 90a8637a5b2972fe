"""MuZero's nets (``models/muzero.py``), their bf16 evaluator route and
kernels' wrappers (``models/muzero_inference.py``), the search over the
latent store (``search/mcts.py:_simulate_latent`` and the tree kernels'
MuZero variants) and the unrolled loss (``train/learner.py``) against the
plain reference ``benchmark/lib/refmuzero.py``.

On the CPU at a tiny size (two blocks of 32 a tower, or 16 blocks of 16
where the weights' calibration matters), on weights drawn as the benchmark
draws them (``benchmark/lib/muzero.py``). The tests marked ``gpu`` import
no JAX and hold the kernels and the captured search on the card
(``python -m pytest --noconftest -m gpu tests/test_torch_muzero.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(1)

from alphazero_torch.config import Config, tiny_muzero_config
from alphazero_torch.env import breakthrough as env
from alphazero_torch.models import muzero_inference as mi
from alphazero_torch.models.muzero import (ACTION_PLANES, MuZeroNet,
                                           action_planes, scale_state)
from alphazero_torch.models.network import build_network
from alphazero_torch.search import kernels, mcts
from alphazero_torch.train import learner
from alphazero_torch.train.replay import ReplayBuffer
from benchmark.drivers.selfplay_muzero import MZ_FIELDS
from benchmark.lib import muzero as bench_mz
from benchmark.lib import refmuzero as ref
from benchmark.rooflines import muzero as roof


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bench_cfg(cfg: Config, positions: int = 256) -> dict:
    return {**{k: getattr(cfg, k) for k in MZ_FIELDS},
            "mz_action_planes": ACTION_PLANES,
            "input_planes": cfg.input_planes,
            "num_actions": cfg.num_actions,
            "weights": {"seeded": True, "calibrated_positions": positions}}


def _weights(cfg=None, seed=0, device="cpu"):
    return bench_mz.seeded(_bench_cfg(cfg or tiny_muzero_config()), seed,
                           device)


def _net(w, cfg=None, device="cpu"):
    cfg = cfg or tiny_muzero_config()
    with torch.device(device):
        net = build_network(cfg, device)
    own = net.state_dict()
    net.load_state_dict({**w, **{k: v for k, v in own.items()
                                 if k.endswith("batches_tracked")}})
    return net.eval()


def _positions(n, seed=0, plies=12):
    g = torch.Generator().manual_seed(seed)
    st = env.initial_state((n,), device="cpu")
    for _ in range(plies):
        legal = env.legal_action_mask(st).float()
        a = torch.multinomial(legal + 1e-9, 1, generator=g)[:, 0]
        st = env.step(st, a)
    return env.encoded_state(st), env.legal_action_mask(st)


def _nchw(rows, B):
    return rows.view(B, 8, 8, -1).permute(0, 3, 1, 2)


def _rel(a, b):
    return float(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)))


# -----------------------------------------------------------------------------
# The nets against the reference
# -----------------------------------------------------------------------------

def test_the_float32_nets_match_the_reference():
    w = _weights()
    net = _net(w)
    planes, _ = _positions(16)
    acts = torch.arange(16) * 11 % 192
    with torch.no_grad(), ref.exact_float32():
        s = net.represent(planes)
        s_ref = ref.represent(w, planes)
        assert (s - s_ref).abs().max() < 1e-5
        assert float(s.amin()) >= 0 and float(s.amax()) <= 1
        s2, r = net.dynamics(s, acts)
        s2_ref, r_ref = ref.dynamics(w, s_ref, acts)
        assert (s2 - s2_ref).abs().max() < 1e-5
        assert (r - r_ref).abs().max() < 1e-5
        for got, want in zip(net.predict(s2), ref.predict(w, s2_ref)):
            assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 0.08)])
def test_the_route_on_the_cpu_against_the_reference(dtype, tol):
    """``prepare`` / ``initial_apply`` / ``recurrent_apply`` on the CPU: the
    kernels' plain versions, the padded input conv, the folded action term
    and the merged value and reward heads; float32 to the reference's
    rounding, bfloat16 to its own."""
    w = _weights()
    net = _net(w)
    prep = mi.prepare(net, dtype)
    planes, _ = _positions(8, seed=3)
    acts = torch.tensor([0, 2, 21, 23, 168, 170, 189, 191], dtype=torch.int32)
    with ref.exact_float32():
        pol, wl, rows = mi.initial_apply(prep, planes)
        s_ref = ref.represent(w, planes)
        p_ref, wl_ref = ref.predict(w, s_ref)
        assert _rel(_nchw(rows, 8).float(), s_ref) < tol
        assert _rel(pol, p_ref) < tol and _rel(wl, wl_ref) < tol
        pol, wl, r, rows2 = mi.recurrent_apply(prep, rows, acts)
        s2_ref, r_ref = ref.dynamics(w, _nchw(rows, 8).float(), acts)
        p2_ref, wl2_ref = ref.predict(w, s2_ref)
    assert _rel(_nchw(rows2, 8).float(), s2_ref) < tol
    assert _rel(pol, p2_ref) < tol and _rel(wl, wl2_ref) < tol
    assert (r - r_ref).abs().max() < tol


def _edge_actions():
    """Every action whose from-square lies on file a or h or on either end
    rank: all three directions, the off-board targets included."""
    out = []
    for sq in range(64):
        row, col = divmod(sq, 8)
        if col in (0, 7) or row in (0, 7):
            out += [3 * sq + d for d in range(3)]
    return torch.tensor(out, dtype=torch.int32)


def test_the_folded_action_term_is_the_literal_conv():
    """conv_{C+3}([s ; A(a)]) through the input norm and ReLU, against
    conv_C(s) and ``action_term``'s term gathered from the taps, for every
    action at the board's edges (where the padding clips the taps),
    including the targets off the board."""
    C = 16
    g = torch.Generator().manual_seed(5)
    w = torch.randn(C, C + 3, 3, 3, generator=g) / 12
    bn = (torch.randn(C, generator=g) * 0.1, 1 + torch.rand(C, generator=g),
          torch.randn(C, generator=g) * 0.1)
    acts = _edge_actions()
    B = acts.shape[0]
    s = torch.rand(B, C, 8, 8, generator=g)
    literal = F.conv2d(torch.cat([s, action_planes(acts)], 1), w, padding=1)
    mean, mul, beta = bn
    want = torch.relu((literal - mean[:, None, None]) * mul[:, None, None]
                      + beta[:, None, None])
    y = F.conv2d(s, w[:, :C], padding=1).permute(0, 2, 3, 1).reshape(-1, C)
    taps, ones = mi.action_tables(w[:, C:])
    got = mi.action_term(y, acts, taps, ones, bn)
    assert (_nchw(got, B) - want).abs().max() < 1e-5
    # the reference's planes are the program's, by an independent build
    assert torch.equal(ref.action_planes(acts), action_planes(acts))
    off = [a for a in acts.tolist()
           if a // 24 == 7 or (a % 3 == 1 and a // 3 % 8 == 0)
           or (a % 3 == 2 and a // 3 % 8 == 7)]
    assert off and all(action_planes(torch.tensor([a]))[0, 1:].sum() == 0
                       for a in off)


def test_scale_on_a_constant_map_and_its_range():
    x = torch.full((2 * 64, 16), 3.0)
    x[64:] = torch.linspace(-5, 7, 64 * 16).view(64, 16)
    got = mi.latent_scale(x)
    assert torch.equal(got[:64], torch.zeros(64, 16))
    assert float(got[64:].min()) == 0.0 and float(got[64:].max()) == 1.0
    assert torch.equal(scale_state(torch.full((1, 4, 8, 8), 2.0)),
                       torch.zeros(1, 4, 8, 8))
    store = torch.zeros(2, 3, 64, 16)
    mi.latent_scale(x, store, torch.tensor(1, dtype=torch.int32))
    assert torch.equal(store[:, 1].reshape(-1, 16), got)
    assert not store[:, 0].any() and not store[:, 2].any()


def test_the_flop_count_and_parameters():
    cfg = Config(body="muzero")
    c = {**_bench_cfg(cfg), "input_planes": 3, "num_actions": 192}
    net = MuZeroNet()
    assert bench_mz.count_params(c) == sum(p.numel()
                                           for p in net.parameters())
    assert bench_mz.count_params(c) == 42663875
    assert round(bench_mz.forward_flops(c) / 1e9, 3) == 2.577
    assert round(bench_mz.forward_flops(c, initial=True) / 1e9, 3) == 2.5
    # the roofline's sites: 34 conv3x3 a simulation, 34 at the root, and
    # 16 residual_act closes a simulation, 16 at the root
    sites = roof.conv3x3_sites(c, 800)
    assert len(sites) == 34 * 801 and sites[0] == (3, 256)
    assert roof.residual_sites(c, 800) == [(256,)] * (16 * 801)


# -----------------------------------------------------------------------------
# The search over the latent store
# -----------------------------------------------------------------------------

class RiggedEvaluator:
    """A recurrent evaluator of exact arithmetic, so that the card and the
    CPU give it the same bits: a state is one value a square a channel,
    each step a correctly rounded multiply-add and ``frac`` of it; the
    priors are small integers over their (exact) sum, the values and the
    rewards multiples of 1/16 read from single elements, and every
    transition's reward is nonzero."""

    recurrent_evaluator = True

    def __init__(self, C=8):
        self.latent_shape, self.dtype = (64, C), torch.float32

    def _out(self, rows, B):
        z = rows.view(B, -1)
        k = torch.arange(192, dtype=torch.float32, device=z.device)
        w = 1 + torch.remainder(torch.floor(z[:, :1] * 8) + k, 8)
        value = (torch.floor(z[:, 0] * 16) - 8) / 16
        return w / w.sum(-1, keepdim=True), value

    def _store(self, rows, store, slot):
        if store is not None:
            store.index_copy_(1, slot.view(1).long(),
                              rows.view(store.shape[0], 1, 64, -1))

    def initial(self, planes, store=None, slot=None):
        B = planes.shape[0]
        rows = planes.permute(0, 2, 3, 1).reshape(B, 64, 3).repeat(1, 1, 3)
        rows = rows[..., :self.latent_shape[1]].reshape(B * 64, -1) * 0.5
        self._store(rows, store, slot)
        return (*self._out(rows, B), rows)

    def recurrent(self, latent, action, store=None, slot=None):
        B = action.shape[0]
        a = action.float()[:, None, None]
        sq = torch.arange(64, dtype=torch.float32,
                          device=latent.device)[None, :, None]
        rows = torch.frac(latent.view(B, 64, -1) * 1.375 + a / 64
                          + sq / 256)
        rows = rows.reshape(B * 64, -1)
        z = latent.view(B, -1)
        reward = (torch.floor(torch.frac(z[:, 1] * 3 + a[:, 0, 0] / 8) * 14)
                  - 6.5) / 8
        self._store(rows, store, slot)
        return (*self._out(rows, B), reward, rows)


def _plain_search(ev, root_planes, legal, sims, c_puct):
    """MuZero's search spelled out per game, in float32: the pseudocode's
    run_mcts with the port's PUCT rule and the negamax backup."""
    B = root_planes.shape[0]
    results = []
    pol, _, rows = ev.initial(root_planes)
    for b in range(B):
        p = pol[b] * legal[b]
        p = (p / p.sum()).numpy().astype(np.float32)
        nodes = [{"prior": p, "legal": legal[b].numpy(), "children": {},
                  "state": rows.view(B, 64, -1)[b]}]
        N = np.zeros((sims + 1, 192), np.float32)
        W = np.zeros((sims + 1, 192), np.float32)
        root_n, root_w = 0, np.float32(0)
        for i in range(sims):
            node, path, n_cur = 0, [], np.float32(root_n)
            while True:
                ev_, ew = N[node], W[node]
                q = np.where(ev_ > 0, -ew / np.maximum(ev_, 1),
                             np.float32(0))
                u = (nodes[node]["prior"]
                     * (np.float32(c_puct) * np.sqrt(max(n_cur, 1.0)))
                     / (1 + ev_))
                score = np.where(nodes[node]["legal"], q + u, -np.inf)
                a = int(np.argmax(score))
                path.append((node, a))
                n_cur = N[node, a]
                if a not in nodes[node]["children"]:
                    break
                node = nodes[node]["children"][a]
            parent, a = path[-1]
            pp, v, r, new = ev.recurrent(
                nodes[parent]["state"].reshape(64, -1),
                torch.tensor([a], dtype=torch.int32))
            slot = len(nodes)
            nodes[parent]["children"][a] = slot
            pr = kernels.renorm_priors(pp, torch.ones_like(pp, dtype=bool),
                                       torch.float32)[0]
            nodes.append({"prior": pr.numpy().astype(np.float32),
                          "legal": np.ones(192, bool), "children": {},
                          "state": new.view(64, -1), "reward": float(r[0])})
            G = ref.backup(path, float(v[0]),
                           lambda nd, act: nodes[nodes[nd]["children"][act]]
                           ["reward"], N, W)
            root_n += 1
            root_w = np.float32(root_w + np.float32(G))
        results.append((N, W, root_n, root_w,
                        torch.stack([n["state"].reshape(64, -1)
                                     for n in nodes])))
    return results


def test_the_search_over_the_latent_store_against_a_plain_search():
    """Visits and value sums equal to a plain per-game search's with the
    same rigged recurrent net (rewards never 0): the root masked to its
    legal moves, every action open below it, the backup ``G <- r - G``,
    and each slot's stored state the plain search's."""
    B, sims = 3, 24
    states = env.initial_state((B,), device="cpu")
    for a in ([3 * 9, 3 * 10 + 1, 3 * 12 + 2], [3 * 8, 3 * 11, 3 * 13 + 1]):
        assert env.legal_action_mask(states)[torch.arange(B),
                                             torch.tensor(a)].all()
        states = env.step(states, torch.tensor(a))
    assert not states.done.any()
    ev = RiggedEvaluator()
    spec = mcts.SearchSpec(num_simulations=sims)
    tree = mcts.search(states, ev, spec)
    want = _plain_search(ev, env.encoded_state(states),
                         env.legal_action_mask(states), sims, spec.c_puct)
    flat = tree.rows.view(B, tree.rows.shape[1], -1)
    A = 192
    for b, (N, W, root_n, root_w, latent) in enumerate(want):
        assert np.array_equal(flat[b, :sims + 1, 2 * A:3 * A].numpy(), N)
        assert np.allclose(flat[b, :sims + 1, 3 * A:4 * A].numpy(), W,
                           atol=1e-5)
        assert int(tree.root_visit[b]) == root_n
        assert abs(float(tree.root_vsum[b]) - root_w) < 1e-5
        assert torch.equal(tree.latent[b, :sims + 1].float(), latent)
    child = flat[:, :sims + 1, :A]
    legal = env.legal_action_mask(states)
    assert torch.equal(child[:, 0] != kernels.ILLEGAL, legal)
    assert not (child[:, 1:] == kernels.ILLEGAL).any()
    assert (tree.reward[:, 1:sims + 1] != 0).all()


def test_the_backup_with_zero_rewards_is_the_sign_flip():
    """``commit_rewards`` with every reward 0 gives ``commit_path``'s bits
    and its root update."""
    g = torch.Generator().manual_seed(2)
    B, M, A = 4, 10, 192
    rows = torch.randn(B, M, 6, 128, generator=g)
    flat = rows.view(B, M, -1)
    flat[:, :, :A] = kernels.UNALLOCATED
    nodes = torch.tensor([[0, 1, 2, 3] + [0] * 5] * B, dtype=torch.int32)
    for b in range(B):
        for d in range(3):
            flat[b, nodes[b, d], 5] = float(nodes[b, d + 1])
    acts = torch.full((B, M - 1), 5, dtype=torch.int32)
    depth = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    alloc = torch.tensor([True, True, False, True])
    value = torch.randn(B, generator=g)
    slot = torch.tensor(7, dtype=torch.int32)
    a, b_ = rows.clone(), rows.clone()
    kernels.commit_path(a, nodes, acts, depth, alloc, value, slot,
                        (0, 2 * A, 3 * A), A)
    root = torch.zeros(B)
    kernels.commit_rewards(b_, torch.zeros(B, M), nodes, acts, depth, alloc,
                           value, slot, root, (0, 2 * A, 3 * A), A)
    assert torch.equal(a, b_)
    assert torch.equal(root, torch.where(depth % 2 == 1, -value, value))


def test_advance_root_refuses_the_latent_store():
    ev = RiggedEvaluator()
    spec = mcts.SearchSpec(num_simulations=4, tree_reuse=True)
    states = env.initial_state((2,), device="cpu")
    tree = mcts.search(states, ev, spec)
    with pytest.raises(ValueError, match="latent store"):
        mcts.advance_root(tree, torch.zeros(2, dtype=torch.int32), states,
                          spec)


def test_make_net_evaluator_gives_the_recurrent_evaluator():
    net = build_network(tiny_muzero_config(), "cpu")
    for dt in (torch.float32, torch.bfloat16):
        ev = mcts.make_net_evaluator(net, dt)
        assert mcts.is_recurrent(ev) and ev.dtype == dt
        assert ev.latent_shape == (64, 32)


# -----------------------------------------------------------------------------
# The unrolled loss
# -----------------------------------------------------------------------------

def _trajectory_buffer(K, seed=0):
    """Two short games (4 and 2 plies) in a buffer: samples near their
    ends unroll into absorbing steps."""
    g = np.random.default_rng(seed)
    buf = ReplayBuffer(16, trajectory=True)
    for plies in (4, 2):
        st = env.initial_state((1,), device="cpu")
        states, pis, wls, acts = [], [], [], []
        for m in range(plies):
            legal = env.legal_action_mask(st)[0].numpy()
            a = int(g.choice(np.flatnonzero(legal)))
            pi = g.random(192).astype(np.float32) * legal
            states.append(env.encoded_state(st)[0].numpy())
            pis.append(pi / pi.sum())
            win = float((plies - 1 - m) % 2 == 0)
            wls.append(np.array([win, 1 - win], np.float32))
            acts.append(a)
            st = env.step(st, torch.tensor([a]))
        buf.add_arrays(np.stack(states), np.stack(pis), np.stack(wls),
                       np.array(acts), plies - 1 - np.arange(plies))
    return buf


def test_unroll_gives_make_targets_absorbing_steps():
    buf = _trajectory_buffer(3)
    planes, acts, pi, wl, r, mask = buf.unroll(np.array([2, 4]), 3,
                                               np.random.default_rng(0))
    # sample 0: plies 2, 3 of the first game, then absorbing
    assert mask.tolist() == [[1, 1, 0, 0], [1, 1, 0, 0]]
    assert np.allclose(wl[0, 2:], 0.5) and not pi[0, 2:].any()
    assert r.tolist() == [[0, 1, 0], [0, 1, 0]]
    assert acts[0, 0] == buf.actions[2] and acts[0, 1] == buf.actions[3]
    assert np.array_equal(planes[1], buf.states[4].astype(np.float32))


def test_the_unrolled_loss_and_gradients_against_the_reference():
    """The learner's loss (train-mode norms, 1/K on each recurrent step's
    gradient, 1/2 on each state after g, absorbing targets) and its
    gradient with respect to every parameter, against autograd through
    the reference."""
    cfg = tiny_muzero_config(mz_blocks=2, mz_filters=16)
    w = _weights(cfg)
    net = _net(w, cfg).train()
    K = 3
    buf = _trajectory_buffer(K)
    batch = [torch.from_numpy(x) for x in
             buf.unroll(np.arange(6), K, np.random.default_rng(1))]
    net.zero_grad()
    loss, l_pi, l_wl, l_r = learner.muzero_loss_fn(net, *batch)
    loss.backward()
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in net.named_parameters()}
    with ref.exact_float32():
        got = ref.unrolled_loss(p, *batch)
    got["loss"].backward()
    assert abs(float(loss.detach()) - float(got["loss"].detach())) < 1e-4
    for a, b in ((l_pi, got["loss_pi"]), (l_wl, got["loss_wl"]),
                 (l_r, got["loss_r"])):
        assert abs(float(a) - float(b)) < 1e-4
    for k, v in net.named_parameters():
        assert _rel(v.grad, p[k].grad) < 1e-3, k
    # the scalings matter: without them the gradients differ
    p2 = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    saved = ref.scale_gradient
    try:
        ref.scale_gradient = lambda x, s: x
        with ref.exact_float32():
            ref.unrolled_loss(p2, *batch)["loss"].backward()
    finally:
        ref.scale_gradient = saved
    assert any(_rel(v.grad, p2[k].grad) > 1e-2
               for k, v in net.named_parameters())


# -----------------------------------------------------------------------------
# On the card
# -----------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("boards", [1, 5, 512])
def test_cuda_action_term_and_latent_scale_against_their_plain_versions(
        cuda, boards):
    g = torch.Generator(device=cuda).manual_seed(boards)
    C = 256
    y = (torch.randn(boards * 64, C, generator=g, device=cuda)).bfloat16()
    acts = torch.arange(boards, device=cuda, dtype=torch.int32) * 7 % 192
    w = torch.randn(C, 3, 3, 3, generator=g, device=cuda) / 10
    taps, ones = mi.action_tables(w)
    bn = (torch.randn(C, generator=g, device=cuda) * 0.1,
          1 + torch.rand(C, generator=g, device=cuda),
          torch.randn(C, generator=g, device=cuda) * 0.1)
    got = mi.action_term(y, acts, taps, ones, bn)
    want = mi.action_term_plain(y.cpu(), acts.cpu(), taps.cpu(), ones.cpu(),
                                tuple(t.cpu() for t in bn))
    assert torch.equal(got.cpu(), want)
    store = torch.zeros(boards, 4, 64, C, dtype=torch.bfloat16, device=cuda)
    slot = torch.tensor(3, dtype=torch.int32, device=cuda)
    got = mi.latent_scale(y, store, slot)
    cpu_store = torch.zeros(store.shape, dtype=torch.bfloat16)
    want = mi.latent_scale_plain(y.cpu(), cpu_store, slot.cpu())
    assert torch.equal(got.cpu(), want) and torch.equal(store.cpu(),
                                                        cpu_store)


@pytest.mark.gpu
def test_cuda_muzero_search_against_the_cpu(cuda):
    """The search over the latent store with the rigged net: the card's
    tree kernels (descend_latent, gather_latent, expand_latent,
    commit_rewards), eager and captured, against the CPU's plain
    versions, bit for bit."""
    B, sims = 8, 32
    states = env.initial_state((B,), device="cpu")
    ev = RiggedEvaluator()
    spec = mcts.SearchSpec(num_simulations=sims)
    want = mcts.search(states, ev, spec)
    on = env.EnvState(*(getattr(states, f).to(cuda) for f in
                        ("board", "turn", "winner", "done", "move_count")))
    for capture in (False, None):
        tree = mcts.search(on, ev, spec, capture=capture)
        assert torch.equal(tree.rows.cpu(), want.rows)
        assert torch.equal(tree.reward.cpu(), want.reward)
        assert torch.equal(tree.root_vsum.cpu(), want.root_vsum)
