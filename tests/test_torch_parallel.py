"""The port's data parallelism (``alphazero_torch/parallel``) on the CPU,
with two gloo ranks that this file launches as worker processes of
itself, held against the JAX package's two-device mesh and against the
port's own one-process step.

The workers import torch and ``alphazero_torch`` only: JAX makes the
weights and the batches in the test process, which hands them over as an
npz file, and compares what the workers write back.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from alphazero_torch.parallel import mesh as pmesh

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
BLOCKS, FILTERS, BATCH = 2, 16, 32       # as tests/test_torch_learner.py
STEPS = (1, 3)
BN_SHAPE = (8, 4, 8, 8)
GAMES, SIMS = 16, 16
LAUNCH_TIMEOUT = 300


def launch(script, mode, workdir, world=WORLD, timeout=LAUNCH_TIMEOUT):
    """Run ``world`` workers of ``mode`` (``script`` run as a script, whose
    ``__main__`` calls ``worker_main``), which rendezvous through a file in
    ``workdir``; fails the test when one exits non-zero or the launch
    outlasts ``timeout``, and kills every worker then."""
    workdir = Path(workdir)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    init = workdir / f"rendezvous_{mode}"
    procs = [subprocess.Popen(
        [sys.executable, str(script), mode, str(r), str(world), str(init),
         str(workdir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"{mode} workers outlasted {timeout} s (a deadlock?)")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" \
                                  f"{out[-4000:]}"
    return outs


# -----------------------------------------------------------------------------
# Worker side: torch and alphazero_torch only
# -----------------------------------------------------------------------------

def _bn_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(BN_SHAPE).astype(np.float32) * 2 + 0.5
    w = rng.standard_normal(BN_SHAPE).astype(np.float32)
    gamma = rng.random(BN_SHAPE[1]).astype(np.float32) + 0.5
    beta = rng.standard_normal(BN_SHAPE[1]).astype(np.float32)
    return x, w, gamma, beta


def _bn_run(group, x, w, gamma, beta):
    """One train-mode forward of ``BatchNorm2d`` and the backward of
    sum(y * w): (y, dx, dgamma, dbeta, running mean, running var)."""
    from alphazero_torch.models.network import BatchNorm2d

    bn = BatchNorm2d(x.shape[1]).train()
    bn.process_group = group
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(w)).sum().backward()
    return [t.detach().numpy().copy() for t in (
        y, xt.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
        bn.running_var)]


def _net(flat):
    from alphazero_torch.models import convert
    from alphazero_torch.models.network import AlphaZeroNet

    return convert.load_flat_into(AlphaZeroNet(BLOCKS, FILTERS, 8), flat)


def _state_out(prefix, state):
    out = {f"{prefix}sd/{k}": v.numpy().copy()
           for k, v in state.net.state_dict().items()}
    for name, p in state.net.named_parameters():
        st = state.opt.state[p]
        out[f"{prefix}mu/{name}"] = st["exp_avg"].numpy().copy()
        out[f"{prefix}nu/{name}"] = st["exp_avg_sq"].numpy().copy()
        out[f"{prefix}grad/{name}"] = p.grad.numpy().copy()
    return out


def _diverse_states(n, seed=0):
    """A batch of positions six random legal moves into the game."""
    from alphazero_torch.env import breakthrough as env

    gen = torch.Generator().manual_seed(seed)
    states = env.initial_state((n,), device="cpu")
    for _ in range(6):
        mask = env.legal_action_mask(states)
        u = torch.rand(mask.shape, generator=gen)
        states = env.step(states, torch.where(mask, u, -1.0).argmax(-1))
    return states


def env_planes(states):
    from alphazero_torch.env import breakthrough as env

    return env.encoded_state(states)


def _move_out(prefix, out):
    new_states, planes, probs, actions, values = out
    res = {f"{prefix}{f}": getattr(new_states, f).numpy().copy()
           for f in ("board", "turn", "winner", "done", "move_count")}
    res.update({f"{prefix}planes": planes.numpy().copy(),
                f"{prefix}probs": probs.numpy().copy(),
                f"{prefix}actions": actions.numpy().copy(),
                f"{prefix}values": values.float().numpy().copy()})
    return res


def worker_parallel(rank, world, workdir):
    """The cases of this file's tests, on this rank: BatchNorm with a
    group, the sharded train step (and rank 0's one-process step on the
    whole batch), the sharded self-play move (and the whole-batch move)."""
    import torch.distributed as dist

    from alphazero_torch.config import tiny_config
    from alphazero_torch.models import quant
    from alphazero_torch.search import SearchSpec, make_net_evaluator
    from alphazero_torch.train import learner
    from alphazero_torch.train.selfplay import selfplay_move

    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.rank, mesh.world, mesh.backend) == (rank, world, "gloo")
    data = dict(np.load(os.path.join(workdir, "inputs.npz")))
    flat = {k[5:]: v for k, v in data.items() if k.startswith("flat/")}
    out = {}

    x, w, gamma, beta = _bn_inputs()
    k = len(x) // world
    rows = slice(rank * k, (rank + 1) * k)
    for name, v in zip(("y", "dx", "dgamma", "dbeta", "rmean", "rvar"),
                       _bn_run(dist.group.WORLD, x[rows], w[rows], gamma,
                               beta)):
        out[f"bn/{name}"] = v

    cfg = tiny_config(num_blocks=BLOCKS, num_filters=FILTERS,
                      batch_size=BATCH)
    # replicate: weights from another seed on each rank, and Adam state
    # and counters from a step on each rank's own batch, become rank 0's
    from alphazero_torch.models.network import BatchNorm2d, build_network

    own = learner.create_train_state(cfg, build_network(
        cfg, device="cpu", generator=torch.Generator().manual_seed(rank)),
        device="cpu")
    s, p, wl, m = (torch.from_numpy(data[f"batch{rank}/{f}"])
                   for f in ("s", "p", "w", "m"))
    learner.train_step(own, (s, p, wl), m, cfg)
    own.learn_calls, own.iteration = 3 + rank, 5 + rank
    pmesh.replicate(mesh, own)
    out["rep/counters"] = np.array([own.learn_calls, own.iteration])
    out["rep/groups"] = np.array([bn.process_group is dist.group.WORLD
                                  for bn in own.net.modules()
                                  if isinstance(bn, BatchNorm2d)])
    out.update({k: v for k, v in _state_out("rep/", own).items()
                if not k.startswith("rep/grad/")})      # not state
    for steps in STEPS:
        state = pmesh.replicate(mesh, learner.create_train_state(
            cfg, _net(flat), device="cpu"))
        whole = learner.create_train_state(cfg, _net(flat), device="cpu")
        step = pmesh.sharded_train_step(mesh, cfg)
        for i in range(steps):
            s, p, wl, m = (torch.from_numpy(data[f"batch{i}/{f}"])
                           for f in ("s", "p", "w", "m"))
            tm = step(state, pmesh.shard_batch(mesh, (s, p, wl)),
                      pmesh.shard_batch(mesh, m))
            out[f"s{steps}/loss{i}"] = np.array(
                [float(tm[k]) for k in ("loss", "loss_pi", "loss_wl")]
                + [tm["lr"]])
            if rank == 0:
                wm = learner.train_step(whole, (s, p, wl), m, cfg)
                out[f"w{steps}/loss{i}"] = np.array(
                    [float(wm[k]) for k in ("loss", "loss_pi", "loss_wl")])
        out.update(_state_out(f"s{steps}/", state))
        if rank == 0:
            out.update(_state_out(f"w{steps}/", whole))

    net = _net(flat)
    states = _diverse_states(GAMES)
    # int8 with static scales, as the trainer's self-play calibrates them:
    # dynamic scales take the amax of the batch an evaluation sees, which
    # is the rank's own games (as on a JAX host's actor mesh)
    qp = quant.quantize_network(net)
    scales = quant.calibrate(qp, [env_planes(_diverse_states(64, seed=1))])
    evals = {"bf16": make_net_evaluator(net, torch.bfloat16),
             "int8": quant.make_quant_evaluator(net, act_scales=scales,
                                                qp=qp)}
    spec = SearchSpec(num_simulations=SIMS, dirichlet_epsilon=0.0)
    for name, eval_fn in evals.items():
        move = pmesh.sharded_selfplay_move(mesh, eval_fn, spec, 0)
        out.update(_move_out(f"move_{name}/", move(
            pmesh.shard_batch(mesh, states),
            torch.Generator().manual_seed(100 + rank))))
        if rank == 0:
            out.update(_move_out(f"move_{name}/whole_", selfplay_move(
                states, torch.Generator().manual_seed(7), eval_fn, spec, 0)))
    np.savez(os.path.join(workdir, f"out_rank{rank}.npz"), **out)


def worker_main(workers, argv):
    """A worker's entry: ``argv`` is (mode, rank, world, rendezvous file,
    workdir); joins the gloo group, runs ``workers[mode]``."""
    import torch.distributed as dist

    mode, rank, world, init_file, workdir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        workers[mode](rank, world, workdir)
    finally:
        dist.destroy_process_group()


# -----------------------------------------------------------------------------
# Test side
# -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's initial weights and batches (as ``test_torch_learner`` makes
    them), the two workers' outputs, and the JAX learner's pieces."""
    import jax

    from alphazero_tpu.config import tiny_config as jax_tiny_config
    from alphazero_tpu.models.network import init_network
    from test_torch_learner import _batch, _flat

    workdir = tmp_path_factory.mktemp("parallel")
    cfg = jax_tiny_config(num_blocks=BLOCKS, num_filters=FILTERS,
                          batch_size=BATCH)
    net, variables = init_network(cfg, jax.random.PRNGKey(0))
    inputs = {f"flat/{k}": v for k, v in _flat(**variables).items()}
    for i in range(max(STEPS)):
        for f, v in zip(("s", "p", "w", "m"), _batch(100 + i)):
            inputs[f"batch{i}/{f}"] = v
    np.savez(workdir / "inputs.npz", **inputs)
    launch(__file__, "parallel", workdir)
    outs = [dict(np.load(workdir / f"out_rank{r}.npz")) for r in range(WORLD)]
    return cfg, net, variables, outs


def _ranks_bit_equal(outs, prefix):
    keys = [k for k in outs[0] if k.startswith(prefix)]
    assert keys
    for k in keys:
        for o in outs[1:]:
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)


def test_batchnorm_with_a_group_equals_the_whole_batch(runs):
    outs = runs[3]
    want = _bn_run(None, *_bn_inputs())
    got = {n: [o[f"bn/{n}"] for o in outs]
           for n in ("y", "dx", "dgamma", "dbeta", "rmean", "rvar")}
    for name, w in zip(("y", "dx"), want[:2]):
        np.testing.assert_allclose(np.concatenate(got[name]), w, rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    # each rank holds its own shard's share of the affine gradients
    for name, w in zip(("dgamma", "dbeta"), want[2:4]):
        np.testing.assert_allclose(sum(got[name]), w, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    # running statistics: the global batch's, the same on every rank
    for name, w in zip(("rmean", "rvar"), want[4:]):
        for g in got[name]:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=name)


def _jax_steps(runs, steps):
    """``steps`` steps of the JAX package's ``sharded_train_step`` on a
    two-device mesh and of its one-device step from the same weights:
    (mesh state, mesh metrics, one-device state, one-device metrics)."""
    import jax
    import jax.numpy as jnp

    from alphazero_tpu.parallel.mesh import (
        make_mesh, replicate, shard_batch, sharded_train_step,
    )
    from alphazero_tpu.train.learner import (
        _train_step_impl, create_train_state,
    )
    from test_torch_learner import _batch

    cfg, net, variables, _ = runs
    fresh = lambda: create_train_state(
        cfg, net, jax.tree_util.tree_map(jnp.array, variables))
    mesh = make_mesh(jax.devices()[:WORLD])
    sharded = sharded_train_step(mesh, net, cfg)
    one = jax.jit(_train_step_impl, static_argnames=("net", "cfg"))
    state, single = replicate(mesh, fresh()), fresh()
    metrics, single_metrics = [], []
    for i in range(steps):
        batch = tuple(jnp.asarray(x) for x in _batch(100 + i))
        state, jm = sharded(state, shard_batch(mesh, batch[:3]),
                            shard_batch(mesh, batch[3]))
        single, sm = one(single, batch[:3], batch[3], net, cfg)
        metrics.append(jm)
        single_metrics.append(sm)
    return state, metrics, single, single_metrics


def _within(got, mesh_v, one_v, atol, rtol=0.0, what=""):
    """|got - mesh_v| <= atol + rtol |mesh_v| + |mesh_v - one_v|, element
    by element: a tolerance widened by the JAX mesh's own distance from
    the JAX package's one-device step on the same inputs."""
    got, mesh_v, one_v = (np.asarray(x, np.float64)
                          for x in (got, mesh_v, one_v))
    bound = atol + rtol * np.abs(mesh_v) + np.abs(mesh_v - one_v)
    excess = np.abs(got - mesh_v) - bound
    assert (excess <= 0).all(), (what, float(excess.max()))


def test_replicate_makes_every_rank_rank0s(runs):
    """Weights drawn from each rank's own seed, and Adam moments, steps
    and counters after a step on each rank's own batch, are rank 0's on
    both ranks after ``replicate``, which attaches the group to every
    BatchNorm."""
    outs = runs[3]
    _ranks_bit_equal(outs, "rep/")
    assert outs[0]["rep/counters"].tolist() == [3, 5]
    groups = outs[1]["rep/groups"]
    assert len(groups) == 2 * BLOCKS + 3 and groups.all()


@pytest.mark.parametrize("steps", STEPS)
def test_sharded_train_steps_match_the_jax_mesh(runs, steps):
    """Two gloo ranks against ``sharded_train_step`` on a two-device JAX
    mesh, with ``test_torch_learner.test_train_steps_match_jax``'s
    tolerances, each widened element by element by the distance of the
    JAX mesh's result from the JAX package's one-device step. That
    distance is nil after one step; after three it is itself many times
    those tolerances (float order through the global-batch statistics;
    its two-device loss is 1.0e-5 from its one-device loss, and one
    weight in thirty differs by more than 0.02 lr). The ranks' weights,
    moments and gradients are bit-equal."""
    from test_torch_learner import _as_torch

    outs = runs[3]
    _ranks_bit_equal(outs, f"s{steps}/")
    got = outs[0]
    jstate, jms, one, oms = _jax_steps(runs, steps)
    for i, (jm, om) in enumerate(zip(jms, oms)):
        loss = got[f"s{steps}/loss{i}"]
        for v, key in zip(loss, ("loss", "loss_pi", "loss_wl")):
            _within(v, jm[key], om[key], atol=1e-5, what=(i, key))
        assert loss[3] == pytest.approx(float(jm["lr"]), rel=1e-6)

    mus, nus = [], []
    for st in (jstate, one):
        adam = st.opt_state[2]            # (clip, decay, scale_by_adam)
        mus.append(_as_torch(adam.mu))
        nus.append(_as_torch(adam.nu))
    (mu, mu1), (nu, nu1) = mus, nus
    tol = 1e-6 if steps == 1 else 1e-5
    for name in mu:
        scale = max(1.0, float(np.abs(mu[name]).max()) / 0.1)
        _within(got[f"s{steps}/mu/{name}"], mu[name], mu1[name],
                atol=tol * 0.1 * scale, what=name)
        _within(got[f"s{steps}/nu/{name}"], nu[name], nu1[name],
                atol=tol * 1e-3, rtol=1e-3, what=name)
    if steps == 1:
        decay = runs[0].weight_decay
        start = _as_torch(params=runs[2]["params"])
        for name in mu:
            _within(got[f"s{steps}/grad/{name}"],
                    mu[name] / 0.1 - decay * start[name],
                    mu1[name] / 0.1 - decay * start[name], atol=2e-5,
                    what=name)

    stats1 = _as_torch(batch_stats=one.batch_stats)
    for name, want in _as_torch(batch_stats=jstate.batch_stats).items():
        _within(got[f"s{steps}/sd/{name}"], want, stats1[name], atol=1e-6,
                rtol=1e-6, what=name)
    lr = runs[0].learning_rate
    params1 = _as_torch(params=one.params)
    close = total = 0
    for name, w in _as_torch(params=jstate.params).items():
        g = got[f"s{steps}/sd/{name}"]
        _within(g, w, params1[name], atol=2.05 * lr * steps, what=name)
        close += int((np.abs(g - w)
                      <= 0.02 * lr + np.abs(w - params1[name])).sum())
        total += w.size
    assert close / total > 0.999


@pytest.mark.parametrize("steps", STEPS)
def test_sharded_train_steps_match_one_process(runs, steps):
    """Two ranks on half-batches against the port's one-process
    ``train_step`` on the whole batch, within the bounds of the JAX
    package's ``test_sharded_train_step_matches_unsharded``."""
    got = runs[3][0]
    for i in range(steps):
        np.testing.assert_allclose(got[f"s{steps}/loss{i}"][:3],
                                   got[f"w{steps}/loss{i}"], rtol=2e-5)
    names = [k[len(f"s{steps}/sd/"):] for k in got
             if k.startswith(f"s{steps}/sd/")]
    for name in names:
        a, b = got[f"s{steps}/sd/{name}"], got[f"w{steps}/sd/{name}"]
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0,
                                       err_msg=name)
        elif name.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=5e-4, rtol=5e-3,
                                       err_msg=name)


@pytest.mark.parametrize("evaluator", ["bf16", "int8"])
def test_sharded_selfplay_move_equals_the_whole_batch(runs, evaluator):
    """2 x 8 games through ``sharded_selfplay_move`` against 16 through
    ``selfplay_move`` (no Dirichlet noise, temperature 0: no draw of a
    generator enters the result)."""
    outs = runs[3]
    pre = f"move_{evaluator}/"
    for f in ("board", "turn", "winner", "done", "move_count", "planes",
              "probs", "actions"):
        np.testing.assert_array_equal(
            np.concatenate([o[pre + f] for o in outs]),
            outs[0][pre + "whole_" + f], err_msg=f)
    np.testing.assert_allclose(
        np.concatenate([o[pre + "values"] for o in outs]),
        outs[0][pre + "whole_values"], atol=1e-6, rtol=0)
    assert not outs[0][pre + "whole_done"].all()


def test_shard_batch_slices_and_refuses_an_indivisible_batch():
    from alphazero_torch.env import breakthrough as env

    states = env.initial_state((6,), device="cpu")
    states.move_count[:] = torch.arange(6, dtype=torch.int32)
    for rank in range(3):
        mesh = pmesh.Mesh(rank=rank, world=3, device=torch.device("cpu"),
                          backend="gloo")
        part = pmesh.shard_batch(mesh, {"s": states, "k": torch.tensor(5),
                                        "t": (torch.arange(12),)})
        assert part["s"].move_count.tolist() == [2 * rank, 2 * rank + 1]
        assert part["s"].board.shape == (2, 8, 8)
        assert part["t"][0].tolist() == [4 * rank + i for i in range(4)]
        assert int(part["k"]) == 5
        with pytest.raises(ValueError, match="does not divide"):
            pmesh.shard_batch(mesh, (torch.zeros(7, 2),))


@pytest.mark.parametrize("path", [
    "training_data.npz", "ckpt/training_data.npz", "/a/b.c/data.npz",
    "data", "data.tar.npz", "x/data.npz.npz"])
def test_host_data_path_equals_jax(path):
    from alphazero_tpu.train.replay import host_data_path as jax_path

    from alphazero_torch.train.replay import host_data_path

    for index in (0, 1, 2, 7, 12):
        assert host_data_path(path, index) == jax_path(path, index)


def test_runtime_without_a_process_group(monkeypatch):
    from alphazero_torch import utils

    assert utils.is_coordinator()
    with pytest.raises(ValueError, match="model"):
        pmesh.make_mesh(model=2)
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh()
    # a rank whose LOCAL_RANK names no card raises: no fallback to the CPU
    monkeypatch.setenv("LOCAL_RANK", "4096")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 4096"):
        utils.init_distributed()
    with pytest.raises(ValueError, match="NCCL"):
        utils.init_distributed(backend="nccl", device="cpu")


def test_debug_checks_turn_on_anomaly_detection():
    from alphazero_torch.utils import enable_debug_checks

    before = torch.is_anomaly_enabled()
    try:
        enable_debug_checks()
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(before)


if __name__ == "__main__":
    worker_main({"parallel": worker_parallel}, sys.argv[1:])
