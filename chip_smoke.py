#!/usr/bin/env python3
"""Drives the PyTorch port (``alphazero_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the tree kernels from ``alphazero_torch/csrc`` (into ``build/``),
holds each against its plain PyTorch version, loads the archived 20x128
net, runs the self-play search at full width (512 games x 800
simulations) through ``selfplay_move``, checks the card's search against
the CPU's, and runs continuous self-play. Each phase prints one line;
any failure raises and exits non-zero. The second-to-last lines are the
``kernels`` JSON object and the card's name and power limit; the last
line is ``{"ok": true, "device": {...}}``. A profile summary of one short
search goes to ``chiprun_out/chip_smoke_profile_<games>.txt``.
"""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ARCHIVE = os.path.join(ROOT, "artifacts", "model_r5_latest.npz")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
A = 192
OFFSETS = (0, 2 * A, 3 * A)
GAMES, SIMS = 512, 800             # the main path's width
CPU_GAMES, CPU_SIMS = 32, 64
CONT_LANES, CONT_SIMS, CONT_GAMES = 128, 64, 128
# bf16 forward of the archived net against its f32 forward: max difference
# in a logit, a probability and the value. The JAX package's own bf16
# inference stays within half of each (tests/test_torch_network.py).
BF16_LIMITS = (0.6, 0.1, 0.12)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=50, warmup=10, queued=True):
    """Mean time of ``fn(i)`` per call between two CUDA events.

    ``queued``: the stream first sleeps for ~20 ms on the device, so every
    launch of the ``iters`` calls is queued before the start event runs
    and the events measure device time alone. Otherwise the events also
    measure the host's launch cost, which bounds small kernels."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(40_000_000)                     # cycles
    t0 = time.time()
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    host_s = time.time() - t0
    torch.cuda.synchronize()
    check(not queued or host_s < 0.015,
          f"launches took {host_s} s to queue, past the device's sleep")
    return start.elapsed_time(end) / iters


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.time()
            out = fn(*a, **kw)
            print(f"[{name}] wall {time.time() - t0:.1f} s", flush=True)
            return out
        return run
    return wrap


# -----------------------------------------------------------------------------
# Phase 1: kernels against their plain versions
# -----------------------------------------------------------------------------

@phase("phase 1 kernels")
def phase_kernels(dev):
    from alphazero_torch.search import kernels as K

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [("main", GAMES, SIMS + 2, None), ("B3", 3, 9, None),
             ("B12", 12, 9, None), ("B13", 13, 17, None),
             ("same-node", 64, 33, 5), ("trash-row", 64, 33, 32)]
    err = {"fetch_rows": 0.0, "commit_edges": 0.0}
    for name, B, M, same in cases:
        rows = torch.randn((B, M, 6, 128), generator=gen, device=dev)
        node = (torch.full((B,), same, dtype=torch.int32, device=dev)
                if same is not None else
                torch.randint(0, M, (B,), generator=gen, device=dev,
                              dtype=torch.int32))
        act = torch.randint(0, A, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        upd = torch.randn((B, 3), generator=gen, device=dev)

        got = K.fetch_rows(rows, node)
        want = K._fetch_rows_plain(rows, node)
        torch.cuda.synchronize()
        err["fetch_rows"] = max(err["fetch_rows"],
                                float((got - want).abs().max()))
        check(torch.equal(got, want), f"fetch_rows differs ({name})")

        before = rows.clone()
        want = K._commit_edges_plain(rows.clone(), node, act, upd, OFFSETS)
        ptr = rows.data_ptr()
        K.commit_edges(rows, node, act, upd, OFFSETS, A)
        torch.cuda.synchronize()
        check(rows.data_ptr() == ptr, f"commit_edges moved the tree ({name})")
        err["commit_edges"] = max(err["commit_edges"],
                                  float((rows - want).abs().max()))
        check(torch.equal(rows, want), f"commit_edges differs ({name})")
        touched = torch.zeros(rows.numel(), dtype=torch.bool, device=dev)
        R = rows[0, 0].numel()
        base = (torch.arange(B, device=dev) * M + node.long()) * R
        for off in OFFSETS:
            touched[base + off + act.long()] = True
        check(torch.equal(rows.view(-1)[~touched], before.view(-1)[~touched]),
              f"commit_edges changed an untouched element ({name})")
        del rows, before, want, touched

    # timing at the main path's shape; 64 node vectors cycle through 96 MB
    # of rows per fetch round, so rows come from HBM, not the 50 MB L2
    B, M, R = GAMES, SIMS + 2, 6 * 128
    rows = torch.randn((B, M, 6, 128), generator=gen, device=dev)
    nodes = [torch.randint(0, M, (B,), generator=gen, device=dev,
                           dtype=torch.int32) for _ in range(64)]
    nodes_l = [n.long() for n in nodes]
    act = torch.randint(0, A, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    upd = torch.randn((B, 3), generator=gen, device=dev)
    ar = torch.arange(B, device=dev)
    offs = torch.tensor(OFFSETS, device=dev)[None, :] + act.long()[:, None]
    flat_idx = [(((ar * M + n) * R)[:, None] + offs).reshape(-1)
                for n in nodes_l]
    upd_flat = upd.reshape(-1)

    check(torch.equal(K.fetch_rows(rows, nodes[0]),
                      rows[ar, nodes_l[0]].reshape(B, -1)),
          "fetch_rows differs from rows[arange(B), node]")
    lib_rows = rows.clone()
    lib_rows.view(-1).index_put_((flat_idx[0],), upd_flat, accumulate=True)
    K.commit_edges(rows, nodes[0], act, upd, OFFSETS, A)
    check(torch.equal(rows, lib_rows), "commit_edges differs from index_put_")
    del lib_rows

    calls = {
        "fetch_rows": {
            "": lambda i: K.fetch_rows(rows, nodes[i % 64]),
            "plain_": lambda i: K._fetch_rows_plain(rows, nodes[i % 64]),
            "library_": lambda i: rows[ar, nodes_l[i % 64]]},
        "commit_edges": {
            "": lambda i: K.commit_edges(rows, nodes[i % 64], act, upd,
                                         OFFSETS, A),
            "plain_": lambda i: K._commit_edges_plain(
                rows, nodes[i % 64], act, upd, OFFSETS),
            "library_": lambda i: rows.view(-1).index_put_(
                (flat_idx[i % 64],), upd_flat, accumulate=True)},
    }
    # "ms": device time per call; "call_ms": per call with the host's
    # launch cost, as the search loop pays it
    t = {name: {f"{pre}{kind}": cuda_ms(fn, queued=(kind == "ms"))
                for pre, fn in fns.items() for kind in ("ms", "call_ms")}
         for name, fns in calls.items()}
    fetch_bytes = 2 * B * R * 4 + B * 4
    commit_bytes = 2 * B * 4 + B * 3 * 4 + 2 * B * 3 * 4
    bounds = {"fetch_rows": fetch_bytes / HBM_BYTES_PER_S * 1e3,
              "commit_edges": commit_bytes / HBM_BYTES_PER_S * 1e3}
    del rows
    torch.cuda.empty_cache()
    print(f"kernels bit-exact on {len(cases)} shapes; max_abs_err {err}; "
          f"times {json.dumps(t)}", flush=True)
    return err, t, bounds


# -----------------------------------------------------------------------------
# Phase 2: the archived net, bf16 on the card against f32 on the CPU
# -----------------------------------------------------------------------------

def random_positions(n, seed, max_plies=40):
    from alphazero_torch.env import breakthrough as env

    rng = np.random.default_rng(seed)
    state = env.initial_state((n,), device="cpu")
    plies = rng.integers(0, max_plies, n)
    for p in range(max_plies):
        mask = env.legal_action_mask(state).numpy()
        acts = np.array([rng.choice(np.flatnonzero(m)) if m.any() else 0
                         for m in mask])
        stepped = env.step(state, torch.from_numpy(acts))
        state = env.select_state(torch.from_numpy(p < plies) & ~stepped.done,
                                 stepped, state)
    return state


@phase("phase 2 network")
def phase_network(dev):
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.models.convert import load_archive
    from alphazero_torch.models.network import count_params

    net_cpu = load_archive(ARCHIVE, device="cpu")
    n_params = count_params(net_cpu)
    check(n_params == 8_027_970, f"count_params {n_params}")
    net = copy.deepcopy(net_cpu).to(dev)
    net_bf16 = copy.deepcopy(net).to(torch.bfloat16)
    planes = env.encoded_state(random_positions(64, 11))
    with torch.no_grad():
        p32, w32 = net_cpu(planes)
        pc, wc = (t.cpu() for t in net(planes.to(dev)))
        p16, w16 = (t.cpu() for t in net_bf16(planes.to(dev).bfloat16()))
    # float32 on the card (TF32 off) against float32 on the CPU: only the
    # summation order differs
    d32 = max(float((pc - p32).abs().max()), float((wc - w32).abs().max()))
    check(d32 <= 1e-3, f"f32 card logits differ from the CPU's by {d32}")
    # bf16 on the card against f32 on the CPU, within BF16_LIMITS
    wl = lambda w: torch.softmax(w, -1)[:, 0] - torch.softmax(w, -1)[:, 1]
    dl = max(float((p16 - p32).abs().max()), float((w16 - w32).abs().max()))
    dp = float((torch.softmax(p16, -1) - torch.softmax(p32, -1)).abs().max())
    dv = float((wl(w16) - wl(w32)).abs().max())
    check(all(d <= lim for d, lim in zip((dl, dp, dv), BF16_LIMITS)),
          f"bf16 logits/probs/value differ: {dl}, {dp}, {dv}")
    print(f"count_params == {n_params:,}; on 64 positions against f32 on "
          f"the CPU: f32 card max |d logit| {d32:.2e} (limit 1e-3); bf16 "
          f"card max |d logit| {dl:.4f}, |d prob| {dp:.5f}, |d value| "
          f"{dv:.5f} (limits {BF16_LIMITS})", flush=True)
    return net


# -----------------------------------------------------------------------------
# Phase 3: the main path, full-width self-play search
# -----------------------------------------------------------------------------

@phase("phase 3 full-width search")
def phase_search(dev, net, card):
    from alphazero_torch.config import Config
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.search import kernels as K
    from alphazero_torch.search import mcts
    from alphazero_torch.train import selfplay

    cfg = Config(num_simulations=SIMS, parallel_games=GAMES)
    eval_fn = mcts.make_net_evaluator(net, getattr(torch, cfg.inference_dtype))
    spec = selfplay.search_spec(cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    states = env.initial_state((GAMES,), device=dev)

    # warm-up move: checks on the searched tree
    legal = env.legal_action_mask(states)
    tree, _, probs, actions, states = selfplay._searched_move(
        states, None, gen, eval_fn, spec, cfg.temperature_threshold)
    torch.cuda.synchronize()
    check(bool((tree.root_visit == SIMS).all()), "root visits != sims")
    check(bool((mcts.root_child_visits(tree).sum(-1) == SIMS).all()),
          "root child visits do not sum to sims")
    check(bool(((probs.sum(-1) - 1).abs() < 1e-5).all()), "probs sum")
    check(bool(legal[torch.arange(GAMES, device=dev), actions.long()].all()),
          "illegal sampled action")
    del tree
    torch.cuda.empty_cache()

    # the main path, counted: 2 moves through selfplay_move
    torch.cuda.reset_peak_memory_stats()
    K.fetch_rows.launches = 0
    K.commit_edges.launches = 0
    mcts.STATS.reset()
    moves, live = 2, 0
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(moves):
        legal = env.legal_action_mask(states)
        live_now = ~states.done
        states, _, probs, actions, values = selfplay.selfplay_move(
            states, gen, eval_fn, spec, cfg.temperature_threshold)
        live += int(live_now.sum())
        check(bool(legal[live_now, actions[live_now].long()].all()),
              "illegal sampled action")
        check(bool(((probs.sum(-1) - 1).abs() < 1e-5).all()), "probs sum")
        check(bool(torch.isfinite(values).all()), "root values not finite")
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {"fetch_rows": K.fetch_rows.launches,
                "commit_edges": K.commit_edges.launches}
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the main path: {launches}")
    st = mcts.STATS
    depth = float(st.depth_sum) / (st.simulations * GAMES)
    out = {
        "games": GAMES, "sims": SIMS, "moves": moves,
        "sims_per_s": live * SIMS / dt, "move_s": dt / moves,
        "mean_edge_depth": depth,
        "levels_per_sim": st.levels / st.simulations,
        "launches_per_move": {k: v / moves for k, v in launches.items()},
        "host_syncs_per_sim": st.levels / st.simulations,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card,
    }
    print("main path " + json.dumps(out), flush=True)
    profile_search(states, eval_fn)
    return launches, out


STAGES = ("mcts.descend", "mcts.evaluate", "mcts.expand", "mcts.backprop")


def profile_search(states, eval_fn, sims=16):
    """One ``sims``-simulation search under ``torch.profiler``: wall time,
    device busy time (the sum of the kernels' own times; one stream, so
    they do not overlap), host and device time per simulation stage (the
    ``record_function`` spans of ``mcts._simulate_once``), the host syncs
    and the host time spent blocked in them (``aten::_local_scalar_dense``,
    the device-to-host read behind every ``bool()``/``int()`` of a CUDA
    tensor), and the kernels that took most device time. The whole table goes to
    ``chiprun_out/chip_smoke_profile_<games>.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from alphazero_torch.search import mcts

    B = states.turn.shape[0]
    spec = mcts.SearchSpec(num_simulations=sims)
    mcts.search(states, eval_fn, spec)                        # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        mcts.search(states, eval_fn, spec)
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = prof.key_averages()
    # a record_function span shows twice: as a host event and as a device
    # event that spans its kernels, gaps included (not busy time)
    kern = sorted(((e.self_device_time_total, e.key, e.count) for e in events
                   if e.device_type == DeviceType.CUDA
                   and e.key not in STAGES
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kern) / 1e6
    host = {e.key: e.cpu_time_total / 1e3 / sims for e in events
            if e.key in STAGES and e.device_type == DeviceType.CPU}
    span = {e.key: e.self_device_time_total / 1e3 / sims for e in events
            if e.key in STAGES and e.device_type == DeviceType.CUDA}
    stage = {k: (host.get(k, 0.0), span.get(k, 0.0)) for k in STAGES}
    syncs = [e for e in events if e.key == "aten::_local_scalar_dense"
             and e.device_type == DeviceType.CPU]
    n_sync = sum(e.count for e in syncs) / sims
    sync_ms = sum(e.cpu_time_total for e in syncs) / 1e3 / sims
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"chip_smoke_profile_{B}.txt"), "w") as f:
        f.write(f"one search, {B} games x {sims} sims: wall {wall:.4f} s, "
                f"device busy {busy:.4f} s\n")
        f.write(f"host syncs: {n_sync:.3f} per sim, host blocked in them "
                f"{sync_ms:.3f} ms/sim\n")
        for k, (h, d) in stage.items():
            f.write(f"{k}: host {h:.3f} ms/sim, device span {d:.3f} "
                    f"ms/sim\n")
        for us, key, count in kern[:40]:
            f.write(f"{us / 1e3:10.3f} ms  {count:7d}  {key}\n")
    check(kern, "profile: no device events")
    top = "; ".join(f"{k[:40]} {us / 1e3:.1f} ms x{c}"
                    for us, k, c in kern[:5])
    split = ", ".join(f"{k[5:]} {h:.2f}/{d:.2f}"
                      for k, (h, d) in stage.items())
    print(f"profile {B} games x {sims} sims: wall {wall * 1e3:.1f} ms, "
          f"device busy {busy * 1e3:.1f} ms (idle share "
          f"{1 - busy / wall:.3f}); per sim host/device-span ms: {split}; "
          f"host syncs per sim {n_sync:.3f}, host blocked in them "
          f"{sync_ms:.3f} ms/sim; top kernels: {top}", flush=True)


# -----------------------------------------------------------------------------
# Phase 4: the same search on the card (kernels) and the CPU (plain)
# -----------------------------------------------------------------------------

_W = torch.tensor((np.arange(A) * 5) % 8 + 1, dtype=torch.float32)
_SQ = torch.arange(A) // 3


def dyadic_eval(planes):
    """Toy evaluator whose every output and every sum the search takes is
    exact in float32 in any order: integer policy weights and values that
    are multiples of 1/16."""
    B = planes.shape[0]
    mine = planes[:, 0].reshape(B, 64)
    theirs = planes[:, 1].reshape(B, 64)
    w = _W.to(planes.device) * (1.0 + mine[:, _SQ.to(planes.device)])
    value = (mine.sum(-1) - theirs.sum(-1)) / 16.0
    return w, value


@phase("phase 4 card vs CPU")
def phase_card_vs_cpu(dev):
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.search import mcts

    states = random_positions(CPU_GAMES, 5)
    fresh = env.initial_state((CPU_GAMES,), device="cpu")
    states = env.select_state(states.done, fresh, states)
    legal = env.legal_action_mask(states).numpy()
    rng = np.random.default_rng(9)
    noise = np.zeros((CPU_GAMES, A), np.float32)
    for i in range(CPU_GAMES):
        idx = np.flatnonzero(legal[i])
        noise[i, idx] = rng.dirichlet([0.35] * len(idx))
    on = lambda s: env.EnvState(*(getattr(s, f).to(dev) for f in
                                  ("board", "turn", "winner", "done",
                                   "move_count")))
    # the search tie-breaks to the lowest action index (torch.argmax's
    # first maximum); hold that on the card at the search's widths
    gen = torch.Generator(device=dev).manual_seed(3)
    ties = torch.randint(0, 3, (GAMES, A), generator=gen, device=dev).float()
    first = torch.where(ties == ties.max(-1, keepdim=True).values,
                        torch.arange(A, device=dev), A).min(-1).values
    check(torch.equal(ties.argmax(-1), first)
          and bool((torch.zeros((GAMES, A), device=dev).argmax(-1) == 0).all()),
          "torch.argmax on the card does not return the first maximum")
    spec = mcts.SearchSpec(num_simulations=CPU_SIMS)
    report = []
    for label, nz in (("no noise", None), ("root noise", noise)):
        kw = {} if nz is None else {"root_noise": torch.from_numpy(nz)}
        t_cpu = mcts.search(states, dyadic_eval, spec, **kw)
        kw = {} if nz is None else {"root_noise": torch.from_numpy(nz).to(dev)}
        t_gpu = mcts.search(on(states), dyadic_eval, spec, **kw)
        v_cpu = mcts.root_child_visits(t_cpu)
        v_gpu = mcts.root_child_visits(t_gpu).cpu()
        check(torch.equal(v_cpu, v_gpu),
              f"card and CPU visit counts differ ({label}): "
              f"{int((v_cpu != v_gpu).sum())} entries")
        rows_equal = torch.equal(t_cpu.rows, t_gpu.rows.cpu())
        report.append(f"{label}: visits equal, whole tree bit-equal "
                      f"{rows_equal}")
    print(f"{CPU_GAMES} games x {CPU_SIMS} sims, card (kernels) vs CPU "
          f"(plain): " + "; ".join(report), flush=True)


# -----------------------------------------------------------------------------
# Phase 5: continuous self-play
# -----------------------------------------------------------------------------

@phase("phase 5 continuous self-play")
def phase_continuous(dev, net, card):
    from alphazero_torch.config import Config
    from alphazero_torch.search import kernels as K
    from alphazero_torch.search import mcts
    from alphazero_torch.train import selfplay

    cfg = Config(num_simulations=CONT_SIMS, parallel_games=CONT_LANES)
    eval_fn = mcts.make_net_evaluator(net, getattr(torch, cfg.inference_dtype))
    gen = torch.Generator(device=dev).manual_seed(2)
    K.fetch_rows.launches = 0
    K.commit_edges.launches = 0
    mcts.STATS.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    examples, stats = selfplay.selfplay_games_continuous(
        eval_fn, cfg, gen, num_games=CONT_GAMES, device=dev)
    dt = time.time() - t0
    st = mcts.STATS
    check(K.fetch_rows.launches > 0 and K.commit_edges.launches > 0,
          "continuous self-play did not launch both kernels")
    check(stats["games"] >= CONT_GAMES, f"games {stats['games']}")
    check(stats["examples"] == len(examples) > 0, "no examples")
    for planes, probs, wl in examples:
        check(planes.dtype == np.uint8 and planes.shape == (3, 8, 8)
              and planes.max() <= 1, "planes format")
        check(probs.dtype == np.float32 and probs.shape == (A,)
              and abs(float(probs.sum()) - 1) < 1e-4, "probs format")
        check(wl.dtype == np.float32 and sorted(wl.tolist()) == [0.0, 1.0],
              "wl format")
    out = {"lanes": CONT_LANES, "sims": CONT_SIMS, "games": stats["games"],
           "examples": stats["examples"],
           "moves_played": stats["moves_played"], "seconds": dt,
           "games_per_hour": stats["games"] / dt * 3600,
           "sims_per_s": stats["simulations"] / dt,
           "ms_per_sim": dt / st.simulations * 1e3,
           "mean_edge_depth": float(st.depth_sum) / (st.simulations
                                                     * CONT_LANES),
           "levels_per_sim": st.levels / st.simulations, "card": card}
    print("continuous " + json.dumps(out), flush=True)
    from alphazero_torch.env import breakthrough as env
    profile_search(env.initial_state((CONT_LANES,), device=dev), eval_fn)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from alphazero_torch import cuda_build

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    t0 = time.time()
    cuda_build.build(["tree_kernels"])
    build_s = time.time() - t0
    print(f"[phase 0] card: {card}; torch {torch.__version__} (CUDA "
          f"{torch.version.cuda}); kernel build {build_s:.1f} s", flush=True)

    err, times, bounds = phase_kernels(dev)
    net = phase_network(dev)
    launches, _ = phase_search(dev, net, card)
    phase_card_vs_cpu(dev)
    phase_continuous(dev, net, card)

    src = "alphazero_torch/csrc/tree_kernels.cu"
    replaces = {"fetch_rows": "alphazero_tpu/search/kernels.py:50",
                "commit_edges": "alphazero_tpu/search/kernels.py:127"}
    kernels = [{
        "name": name, "route": "cuda", "source": src,
        "replaces": replaces[name], "launches": launches[name],
        "max_abs_err": err[name], **times[name],
        "bound_ms": bounds[name], "bound_by": "bytes",
    } for name in ("fetch_rows", "commit_edges")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
