#!/usr/bin/env python3
"""Drives the PyTorch port (``alphazero_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``alphazero_torch/csrc`` (into ``build/``)
and then runs, each phase printing one line and any failure raising and
exiting non-zero:

Every search on the card replays a simulation captured as a CUDA graph
(``alphazero_torch/search/graph.py``) unless a phase asks for the eager
yardstick (``capture=False``); the kernels' launch counts include the
launches of the replays.

- phase 1: the tree kernels against their plain PyTorch versions
  (bit-exact): ``fetch_rows``; ``commit_edges``, also on 2 and 5 stacked
  levels against one call per level, and in its path form
  (``commit_path``, what the search launches) against its plain version,
  and on the descent of a grown 512-game tree against the stacked form,
  with its times beside its bound; ``descend`` against the plain
  per-level descent on trees that searches grew (512, 13 and 3 games,
  and 1 and 2 games at the web bot's 200 simulations; first-play urgency
  off and on, finished roots and terminal leaves);
  and their times beside the launch floor (a kernel with no body);
- phase 2: the archived 20x128 net on the card against the CPU;
- phase 6: the fused tower kernel (``wgmma`` on a ring of weight chunks
  in shared memory) against its plain version (1, 2 and 20 blocks, and
  every block alone) and against the layer-by-layer net, and its times at
  512 positions x 20 blocks beside its bound, its plain version and the
  bf16 net's tower blocks in eager mode;
- phase 3: the self-play search at full width (512 games x 800
  simulations) through ``selfplay_move`` on one tree: a warm-up move that
  captures the simulation, then one counted and timed move of 800
  replays, each one ``descend`` and one ``commit_edges`` launch and no
  read of the card; then one eager search and one captured from the same
  position, timed and bit-equal; profiles of both;
- phase 4: the card's search against the CPU's;
- phase 15 (``graph``): the captured search against the eager one, trees
  bit-equal over two consecutive moves each: bf16 and int8-static at 512
  games x 64 simulations, the web bot's batch of one at 200 simulations
  under inference mode, the arena's pair evaluator with its context;
  captures, replays and the seconds of each move;
- phase 5: continuous self-play (128 lanes x 16 simulations);
- phase 7: the fused path at full width (512 positions, 800 evaluations
  in a row) beside the layer-by-layer bf16 net;
- phase 8: the trainer at full width (20x128 net, 128 lanes x 32
  simulations, batch 1024): two ``run_iteration``s in a temporary
  directory, then a second trainer that resumes from disk, then one more
  iteration of the first with the int8-static self-play evaluator
  (``selfplay_quant="static"``, calibrated on the replay buffer; 16
  simulations, a reduced depth);
- phase 9: the s8 conv kernel (``qconv3x3``, ``csrc/qconv_kernel.cu``)
  against ``qconv_plain`` on every conv of the archived net at 512
  positions, with static and dynamic scales, ReLU on and off (the input
  conv reads the float32 planes, cin 3): sums and outputs bit-equal; the
  kernel's ptxas report; its times, in turns with cuDNN's bf16 conv of the
  same shape, beside its bound and ``torch._int_mm`` of the prebuilt s8
  im2col matrix (the s8 product alone), and the input conv's;
- phase 10: the int8-static evaluator (scales calibrated on positions from
  ``random_positions``) through ``selfplay_move`` at 512 games x 800
  simulations beside the bf16 evaluator: a warm-up move with each (a
  capture each), then timed moves in turns (int8, bf16, bf16, int8), then
  one eager and one captured search of each; launches per forward, the
  evaluate span, ``qconv3x3``'s device total in the profile; the
  card's int8 forward against the CPU's plain one and against the f32 net;
- phase 11: the arena, ``play_paired_matches`` with int8 static against
  bf16 on the archived weights, 16 openings x 2 games at 32 simulations (a
  reduced depth), until every game ends;
- phase 12: ``python3 -m alphazero_torch.bench`` at 128 games x 64
  simulations (a reduced size): stdout is exactly one JSON line;
- phase 13: the web server (``alphazero_torch/web``) with the archive as
  its ``model_best``, on 127.0.0.1 in a thread, driven over HTTP: the
  bot (batch 1, 200 simulations, 20x128 bf16) as White against the
  baseline engine (its budget cut to 150 ms a move, from 2000) for at
  most 40 plies; every move legal, ``/api/state`` equal to the last
  answer, each AlphaZero move 200 ``descend`` and 200 ``commit_edges``
  launches (their sums go into the ``kernels`` line as
  ``web_launches``); the seconds of both players' moves; then the bot's
  move on the initial position captured and eagerly, timed and
  bit-equal;
- phase 14: the distributed trainer (``alphazero_torch/parallel``) at
  full width, f32 learning with TF32 off, global batch 1024, in worker
  processes: (a) two ranks on the one card over gloo, 64 lanes x 32
  simulations each (phase 8's 128 lanes together): one ``run_iteration``,
  then fresh trainers ``resume()`` and run a second; weights bit-equal
  across ranks after each and equal to the saved ones, one metrics line
  an iteration, two replay shards that differ, one ``descend`` and one
  ``commit_edges`` launch a simulation on each rank; then one train step
  on a fixed global batch, each rank on its half, against the
  one-process ``train_step`` on the whole batch from the same weights
  (loss rtol 2e-5, weights atol 5e-4 rtol 5e-3, running statistics
  1e-5), both timed, and the all-reduces a step counted; (b) one rank
  over NCCL through ``init_distributed()`` from ``torchrun``'s
  variables: one iteration at the same shape, a step timed, the NCCL
  kernels of a step counted from a profile. Their launches go into the
  ``kernels`` line as ``dist_launches``.

The second-to-last lines are the ``kernels`` JSON object and the card's
name and power limit; the last line is ``{"ok": true, "device": {...}}``.
Profile summaries of short searches, captured and eager, go to
``chiprun_out/chip_smoke_profile_<tag>.txt``.
"""

import copy
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ARCHIVE = os.path.join(ROOT, "artifacts", "model_r5_latest.npz")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # H100 SXM data sheet, dense bf16
A = 192
OFFSETS = (0, 2 * A, 3 * A)
GAMES, SIMS = 512, 800             # the main path's width
CPU_GAMES, CPU_SIMS = 32, 64
CONT_LANES, CONT_SIMS, CONT_GAMES = 128, 16, 128
STATIC_TRAIN_SIMS = 16             # phase 8's int8-static iteration
ARENA_OPENINGS, ARENA_SIMS = 16, 32
# phase 13: plies of its game at most, and the baseline's budget a move,
# cut from the server's 2000 ms for this phase only
WEB_PLIES, WEB_BASELINE_MS = 40, 150
WEB_SIMS = 200                     # the bot's num_simulations_inference
BENCH_ENV = {"AZTPU_BENCH_GAMES": "128", "AZTPU_BENCH_SIMS": "64",
             "AZTPU_BENCH_REPS": "1"}
INT8_OPS_PER_S = 1979e12           # H100 SXM data sheet, dense int8
TOWER_BLOCKS = 20
TRAIN_LANES, TRAIN_SIMS, TRAIN_BATCH = 128, 32, 1024
# phase 14: lanes a rank (two ranks play phase 8's TRAIN_LANES), timed
# steps, and the seconds a launch of workers may take
DIST_LANES, DIST_TIMED_STEPS, DIST_TIMEOUT = 64, 3, 300
FUSED_EVALS = 800
# bf16 forward of the archived net against its f32 forward: max difference
# in a logit, a probability and the value. The JAX package's own bf16
# inference stays within half of each (tests/test_torch_network.py).
BF16_LIMITS = (0.6, 0.1, 0.12)
# the int8 forward on the card against the same forward on the CPU (plain
# s8 convs; bf16 SE, heads and residuals in another summation order): max
# difference in a logit, a probability and the value
INT8_LIMITS = (0.6, 0.1, 0.12)
# the int8-static forward against the f32 net on random-play positions:
# mean policy TV, argmax agreement, value MAE. On such positions the JAX
# package's own int8-static forward of the archived net is at TV 0.031,
# agreement 0.92, value MAE 0.055 on the CPU, the port's at 0.033, 0.93,
# 0.060 (scripts/int8_accuracy_torch_vs_jax.py); on replay positions both
# are nearer 0.015 (docs/quant-int8.md)
INT8_VS_F32 = (0.045, 0.88, 0.08)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters=50, warmup=10, queued=True, sleep_ms=60, what="fn"):
    """Mean time of ``fn(i)`` per call between two CUDA events.

    ``queued``: the stream first sleeps for about ``sleep_ms`` on the
    device, so every launch of the ``iters`` calls is queued before the
    start event runs and the events measure device time alone (the calls
    must stay under the stream's queue depth, about a thousand launches).
    Otherwise the events also measure the host's launch cost, which
    bounds small kernels."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(int(sleep_ms * 2_000_000))      # cycles
    t0 = time.time()
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    host_s = time.time() - t0
    torch.cuda.synchronize()
    check(not queued or host_s < 0.75e-3 * sleep_ms,
          f"{iters} launches of {what} took {host_s} s to queue, past the "
          f"device's sleep")
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

LEVELS = 5                         # a backprop's stacked levels, as timed


@phase("phase 1 kernels")
def phase_kernels(dev):
    from alphazero_torch.search import kernels as K

    gen = torch.Generator(device=dev).manual_seed(0)
    # B1 and B2: the web bot's tree, one game at WEB_SIMS simulations
    cases = [("main", GAMES, SIMS + 2, None), ("B1", 1, WEB_SIMS + 2, None),
             ("B2", 2, WEB_SIMS + 2, None), ("B3", 3, 9, None),
             ("B12", 12, 9, None), ("B13", 13, 17, None),
             ("same-node", 64, 33, 5), ("trash-row", 64, 33, 32)]
    err = {"fetch_rows": 0.0, "commit_edges": 0.0}
    for name, B, M, same in cases:
        rows = torch.randn((B, M, 6, 128), generator=gen, device=dev)
        node = (torch.full((B,), same, dtype=torch.int32, device=dev)
                if same is not None else
                torch.randint(0, M, (B,), generator=gen, device=dev,
                              dtype=torch.int32))
        got = K.fetch_rows(rows, node)
        want = K._fetch_rows_plain(rows, node)
        torch.cuda.synchronize()
        err["fetch_rows"] = max(err["fetch_rows"],
                                float((got - want).abs().max()))
        check(torch.equal(got, want), f"fetch_rows differs ({name})")
        del got, want

        # commit_edges on (B,) operands and on 2 and 5 stacked levels:
        # against the plain version, and the stack against one
        # single-level kernel call per level
        R = rows[0, 0].numel()
        for levels in (None, 2, LEVELS):
            name_l = f"{name}, {levels or 1} levels"
            lead = () if levels is None else (levels,)
            node = (torch.full(lead + (B,), same, dtype=torch.int32,
                               device=dev) if same is not None else
                    torch.randint(0, M, lead + (B,), generator=gen,
                                  device=dev, dtype=torch.int32))
            act = torch.randint(0, A, lead + (B,), generator=gen,
                                device=dev, dtype=torch.int32)
            upd = torch.randn(lead + (B, 3), generator=gen, device=dev)
            before = rows.clone()
            want = K._commit_edges_plain(rows.clone(), node, act, upd,
                                         OFFSETS)
            ptr = rows.data_ptr()
            K.commit_edges(rows, node, act, upd, OFFSETS, A)
            torch.cuda.synchronize()
            check(rows.data_ptr() == ptr,
                  f"commit_edges moved the tree ({name_l})")
            err["commit_edges"] = max(err["commit_edges"],
                                      float((rows - want).abs().max()))
            check(torch.equal(rows, want),
                  f"commit_edges differs ({name_l})")
            touched = torch.zeros(rows.numel(), dtype=torch.bool, device=dev)
            base = (torch.arange(B, device=dev) * M + node.long()) * R
            for off in OFFSETS:
                touched[(base + off + act.long()).reshape(-1)] = True
            check(torch.equal(rows.view(-1)[~touched],
                              before.view(-1)[~touched])
                  and int(touched.sum()) <= 3 * B * (levels or 1),
                  f"commit_edges changed an untouched element ({name_l})")
            if levels is not None:
                for l in range(levels):
                    K.commit_edges(before, node[l], act[l], upd[l], OFFSETS,
                                   A)
                check(torch.equal(rows, before),
                      f"stacked commit_edges differs from one call per "
                      f"level ({name_l})")
            del before, want, touched

        # the path form: walks over distinct nodes, depths from 0
        path = path_operands(B, M, gen, dev)
        want = K._commit_path_plain(rows.clone(), *path, OFFSETS)
        launches = K.commit_edges.launches
        K.commit_path(rows, *path, OFFSETS, A)
        torch.cuda.synchronize()
        check(K.commit_edges.launches == launches + 1,
              "commit_path did not count its launch")
        err["commit_edges"] = max(err["commit_edges"],
                                  float((rows - want).abs().max()))
        check(torch.equal(rows, want), f"commit_path differs ({name})")
        del rows, want

    # timing at the main path's shape; 64 node vectors cycle through 96 MB
    # of rows per fetch round, so rows come from HBM, not the 50 MB L2
    B, M, R = GAMES, SIMS + 2, 6 * 128
    rows = torch.randn((B, M, 6, 128), generator=gen, device=dev)
    nodes5 = [torch.randint(0, M, (LEVELS, B), generator=gen, device=dev,
                            dtype=torch.int32) for _ in range(64)]
    nodes = [n[0].contiguous() for n in nodes5]
    nodes_l = [n.long() for n in nodes]
    act5 = torch.randint(0, A, (LEVELS, B), generator=gen, device=dev,
                         dtype=torch.int32)
    upd5 = torch.randn((LEVELS, B, 3), generator=gen, device=dev)
    act, upd = act5[0].contiguous(), upd5[0].contiguous()
    ar = torch.arange(B, device=dev)
    offs = torch.tensor(OFFSETS, device=dev)[None, :] + act5.long()[..., None]
    flat_idx5 = [(((ar * M + n.long()) * R)[..., None] + offs).reshape(-1)
                 for n in nodes5]
    upd5_flat = upd5.reshape(-1)

    check(torch.equal(K.fetch_rows(rows, nodes[0]),
                      rows[ar, nodes_l[0]].reshape(B, -1)),
          "fetch_rows differs from rows[arange(B), node]")
    lib_rows = rows.clone()
    lib_rows.view(-1).index_put_((flat_idx5[0][:3 * B],), upd5_flat[:3 * B],
                                 accumulate=True)
    K.commit_edges(rows, nodes[0], act, upd, OFFSETS, A)
    check(torch.equal(rows, lib_rows), "commit_edges differs from index_put_")
    del lib_rows

    lib = K._lib()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def floor(i):
        check(lib.launch_floor(stream) == 0, "the empty kernel did not launch")

    calls = {
        "fetch_rows": {
            "": lambda i: K.fetch_rows(rows, nodes[i % 64]),
            "plain_": lambda i: K._fetch_rows_plain(rows, nodes[i % 64]),
            "library_": lambda i: rows[ar, nodes_l[i % 64]]},
        # the main path's call: a backprop of LEVELS stacked levels
        "commit_edges": {
            "": lambda i: K.commit_edges(rows, nodes5[i % 64], act5, upd5,
                                         OFFSETS, A),
            "single_": lambda i: K.commit_edges(rows, nodes[i % 64], act,
                                                upd, OFFSETS, A),
            "plain_": lambda i: K._commit_edges_plain(
                rows, nodes5[i % 64], act5, upd5, OFFSETS),
            "library_": lambda i: rows.view(-1).index_put_(
                (flat_idx5[i % 64],), upd5_flat, accumulate=True)},
        "launch_floor": {"": floor},
    }
    # "ms": device time per call; "call_ms": per call with the host's
    # launch cost, as the search loop pays it. The plain version of five
    # levels is about a hundred launches a call: few calls, so that they
    # stay under the stream's queue depth behind the device's sleep.
    # index_put_ over the 7,680 indices of five levels synchronises with
    # the host (over one level's 1,536 it does not), so it cannot queue
    # and both of its times are per call
    syncs = ("commit_edges", "library_")
    t = {name: {f"{pre}{kind}": cuda_ms(fn, queued=(kind == "ms"
                                                    and (name, pre) != syncs),
                                        iters=4 if pre == "plain_" else 50,
                                        what=f"{name} {pre}{kind}")
                for pre, fn in fns.items() for kind in ("ms", "call_ms")}
         for name, fns in calls.items()}
    floor_t = t.pop("launch_floor")
    for name in t:
        t[name]["floor_ms"] = floor_t["ms"]
        t[name]["floor_call_ms"] = floor_t["call_ms"]
    fetch_bytes = 2 * B * R * 4 + B * 4
    # per level: node and act, the three updates, and each touched element
    # read and written
    commit_bytes = LEVELS * (2 * B * 4 + B * 3 * 4 + 2 * B * 3 * 4)
    bounds = {"fetch_rows": fetch_bytes / HBM_BYTES_PER_S * 1e3}
    del rows
    torch.cuda.empty_cache()
    print(f"kernels bit-exact on {len(cases)} shapes x (1, 2, {LEVELS}) "
          f"levels; max_abs_err {err}; commit_edges timed at {LEVELS} "
          f"stacked levels (single_: one level); launch floor (an empty "
          f"kernel) {json.dumps(floor_t)}; times {json.dumps(t)}", flush=True)

    # descend against the plain per-level descent; the plain version's
    # row reads are the fetch_rows launches this run counts. The main path
    # launches commit_edges in its path form (commit_path): its times, on
    # the descent of the timing tree, are the kernel's, the stacked form's
    # beside them under "stacked_"
    K.fetch_rows.launches = 0
    (err["descend"], t["descend"], bounds["descend"], path_t,
     bounds["commit_edges"]) = check_descend(dev)
    t["commit_edges"] = {**path_t, **{f"stacked_{k}": v for k, v in
                                      t["commit_edges"].items()},
                         "stacked_bound_ms": commit_bytes / HBM_BYTES_PER_S
                         * 1e3, "floor_ms": floor_t["ms"],
                         "floor_call_ms": floor_t["call_ms"]}
    t["descend"]["floor_ms"] = floor_t["ms"]
    t["descend"]["floor_call_ms"] = floor_t["call_ms"]
    launches = {"fetch_rows": K.fetch_rows.launches}
    check(launches["fetch_rows"] > 0, "the plain descent did not launch "
                                      "fetch_rows")
    return err, t, bounds, launches


def path_operands(B, M, gen, dev, max_depth=10):
    """``commit_path``'s operands after ``kernels.commit_path``'s order
    (path nodes, actions, depth, needs_alloc, value, slot): every game's
    walk over distinct nodes, depths 0 to ``max_depth``, terminal leaves
    and allocating walks."""
    N = M - 1
    nodes = torch.argsort(torch.rand((B, N), generator=gen, device=dev),
                          dim=1).int()
    acts = torch.randint(0, A, (B, N), generator=gen, device=dev,
                         dtype=torch.int32)
    depth = torch.randint(0, min(max_depth, N) + 1, (B,), generator=gen,
                          device=dev, dtype=torch.int32)
    needs_alloc = (torch.rand((B,), generator=gen, device=dev) < 0.6) \
        & (depth > 0)
    value = torch.randn((B,), generator=gen, device=dev)
    slot = torch.randint(1, N, (), generator=gen, device=dev,
                         dtype=torch.int32)
    return nodes, acts, depth, needs_alloc, value, slot


def stacked_backprop(rows, nodes, acts, depth, needs_alloc, value, slot):
    """The backprop as the search built it before the path form: every
    level to the deepest game's (L = max(depth, 1), a host read) stacked
    into one ``commit_edges`` call, levels past a game's depth on the trash
    row. Returns ``rows``, updated in place."""
    from alphazero_torch.search import kernels as K

    B, M = rows.shape[:2]
    dev = rows.device
    levels = max(int(depth.max()), 1)
    lv = torch.arange(levels, dtype=torch.int32, device=dev)[:, None]
    active = lv < depth[None]
    zero = torch.zeros((), device=dev)
    sign0 = torch.where(depth % 2 == 1, 1.0, -1.0)
    tgt = torch.where(active, nodes[:, :levels].T,
                      torch.full((), M - 1, dtype=torch.int32,
                                 device=dev)).contiguous()
    alloc = active & needs_alloc[None] & (lv == depth[None] - 1)
    upd = torch.stack([
        torch.where(alloc, (slot + 1).float(), zero), active.float(),
        torch.where(active, (sign0 * value)[None] * (1 - 2 * (lv % 2)), zero),
    ], dim=-1)
    return K.commit_edges(rows, tgt, acts[:, :levels].T.contiguous(), upd,
                          OFFSETS, A)


def check_commit_path(dev, tree, out, copies):
    """The path-form ``commit_edges`` at the main path's shape, on the
    results of a descent of a grown tree: bit-equal to its plain version
    and to the stacked form the search used to build; its device and
    per-call times (cycling through ``copies`` of the tree, so that its
    rows come from device memory), the plain version's, one
    ``index_put_(accumulate=True)`` of the same updates, and its bound: the
    bytes it must move (depth, needs_alloc and value of every game, the
    slot, and per walked edge its node and action and three elements read
    and written)."""
    from alphazero_torch.search import kernels as K

    _, needs_alloc, depth, nodes, acts = out[:5]
    B, M = tree.rows.shape[:2]
    R = tree.rows[0, 0].numel()
    gen = torch.Generator(device=dev).manual_seed(5)
    value = torch.randn((B,), generator=gen, device=dev)
    args = (nodes, acts, depth, needs_alloc, value, tree.next_slot)
    got = K.commit_path(tree.rows.clone(), *args, OFFSETS, A)
    want = K._commit_path_plain(tree.rows.clone(), *args, OFFSETS)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "commit_path differs from its plain "
                                  "version on the grown tree")
    check(torch.equal(got, stacked_backprop(tree.rows.clone(), *args)),
          "commit_path differs from the stacked backprop")
    del got, want
    # the library call: the walked edges' elements and updates, flat
    walked = (torch.arange(M - 1, device=dev)[None] < depth[:, None])
    b, d = walked.nonzero(as_tuple=True)
    sign = torch.where((depth[b] % 2 == 1) == (d % 2 == 0), 1.0, -1.0)
    alloc = needs_alloc[b] & (d == depth[b] - 1)
    upd = torch.stack([torch.where(alloc, (tree.next_slot + 1).float(), 0.0),
                       torch.ones_like(sign), sign * value[b]], -1)
    idx = (((b * M + nodes[b, d].long()) * R + acts[b, d].long())[:, None]
           + torch.tensor(OFFSETS, device=dev)).reshape(-1)
    upd = upd.reshape(-1)
    flat = tree.rows.clone().view(-1)
    cold = lambda i: K.commit_path(copies[i % len(copies)], *args, OFFSETS,
                                   A)
    edges = int(depth.sum())
    nbytes = B * (4 + 1 + 4) + 4 + edges * (2 * 4 + 2 * 3 * 4)
    # the plain version (its offsets copied from the host) and index_put_
    # with accumulate over these indices synchronise with the host: their
    # times are per call
    t = {"ms": cuda_ms(cold, iters=48, warmup=12, what="commit_path"),
         "call_ms": cuda_ms(cold, iters=48, warmup=12, queued=False),
         "plain_ms": cuda_ms(lambda i: K._commit_path_plain(
             copies[i % len(copies)], *args, OFFSETS), iters=8, warmup=2,
             queued=False),
         "library_ms": cuda_ms(lambda i: flat.index_put_(
             (idx,), upd, accumulate=True), iters=8, warmup=2, queued=False),
         "edges": edges, "bound_bytes": nbytes}
    return t, nbytes / HBM_BYTES_PER_S * 1e3


DESCEND_CHUNKS = (0, 50, 150, 200)  # simulations between two comparisons
DESCEND_COPIES = 12                # trees cycled through when timing


def generic_eval(seed, dev):
    """Evaluator with generic float32 priors and values (a fixed random
    linear map of the planes): no two priors equal."""
    g = torch.Generator().manual_seed(seed)
    w1 = torch.randn((128, A), generator=g).to(dev)
    w2 = (torch.randn((128,), generator=g) / 8).to(dev)

    def eval_fn(planes):
        x = planes.reshape(planes.shape[0], -1)[:, :128]
        return torch.softmax(x @ w1, -1), torch.tanh(x @ w2)

    return eval_fn


def compare_descents(tree, spec, what):
    """``descend`` (the kernel) and the plain per-level descent on one
    tree: depth, needs_alloc, every field of the leaf state and the path
    at d < depth must be equal. Returns the kernel's results."""
    from alphazero_torch.search import kernels as K

    args = (tree.rows, tree.root_state, tree.root_visit, tree.root_vsum,
            spec.num_actions, spec.c_puct, spec.fpu_reduction)
    launches = K.descend.launches
    got = K.descend(*args)
    check(K.descend.launches == launches + 1, "descend did not count its "
                                              "launch")
    want = K._descend_plain(*args)
    torch.cuda.synchronize()
    leaf_g, alloc_g, depth_g, nodes_g, acts_g, _ = got
    leaf_w, alloc_w, depth_w, nodes_w, acts_w, _ = want
    check(depth_g.dtype == torch.int32 and alloc_g.dtype == torch.bool
          and torch.equal(depth_g, depth_w), f"descend: depth differs "
          f"({what}): {int((depth_g != depth_w).sum())} games")
    check(torch.equal(alloc_g, alloc_w), f"descend: needs_alloc differs "
                                         f"({what})")
    for name in ("board", "turn", "winner", "done", "move_count"):
        g, w = getattr(leaf_g, name), getattr(leaf_w, name)
        check(g.dtype == w.dtype and g.shape == w.shape
              and torch.equal(g, w), f"descend: leaf {name} differs ({what})")
    walked = (torch.arange(nodes_g.shape[1], device=depth_g.device)[None]
              < depth_g[:, None])
    check(torch.equal(nodes_g[walked], nodes_w[walked])
          and torch.equal(acts_g[walked], acts_w[walked]),
          f"descend: path differs ({what})")
    return got


def descend_bound_ms(depth, needs_alloc):
    """The bytes a descent of these depths must move, at the memory rate:
    one 4A-float row per game and level (a walk that does not end on a new
    edge reads one more row to find no legal action there), the root
    state, visit and vsum in, the walked path, depth, needs_alloc and the
    leaf state out."""
    B = depth.shape[0]
    rows_read = int(depth.sum()) + int((~needs_alloc).sum())
    state = 64 + 1 + 1 + 1 + 4
    nbytes = (rows_read * 4 * A * 4 + B * (state + 4 + 4)
              + 2 * 4 * int(depth.sum()) + B * (4 + 1 + state))
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def check_descend(dev):
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.search import kernels as K
    from alphazero_torch.search import mcts

    on = lambda s: env.EnvState(*(getattr(s, f).to(dev) for f in
                                  ("board", "turn", "winner", "done",
                                   "move_count")))
    evals = {"ties": dyadic_eval, "generic": generic_eval(17, dev)}
    report, compared = [], 0
    # (games, simulations between comparisons, evaluator, first-play
    # urgency); every fifth game is played to its end (finished roots),
    # and late positions give terminal leaves. One and two games at
    # WEB_SIMS simulations in all are the web bot's search
    web = (8, 24, 32, WEB_SIMS - 64)
    cases = [(GAMES, (40, 120), "ties", 0.0),
             (GAMES, (40, 120), "generic", 0.25),
             (13, (8, 24, 32), "ties", 0.25), (13, (8, 24, 32), "generic", 0.0),
             (3, (8, 24, 32), "generic", 0.25), (3, (8, 24, 32), "ties", 0.0),
             (1, web, "generic", 0.0), (1, web, "ties", 0.25),
             (2, web, "generic", 0.25), (2, web, "ties", 0.0)]
    for B, chunks, ev, fpu in cases:
        states = on(finish_games(
            random_positions(B, 100 + B, max_plies=60),
            torch.arange(B) % 5 == 2, B))
        tree = mcts.init_tree(states,
                              mcts.SearchSpec(num_simulations=sum(chunks)))
        finished = int(states.done.sum())
        terminal = deepest = 0
        for chunk in chunks:
            spec = mcts.SearchSpec(num_simulations=chunk, fpu_reduction=fpu)
            mcts.search(states, evals[ev], spec, tree=tree)
            before = tree.rows.clone() if B < GAMES else None
            leaf, _, depth, _, _, _ = compare_descents(
                tree, spec, f"{B} games, {ev}, fpu {fpu}, "
                f"{int(tree.root_visit[0])} sims")
            check(before is None or torch.equal(tree.rows, before),
                  "descend wrote into the tree")
            terminal = max(terminal, int((leaf.done & ~states.done).sum()))
            deepest = max(deepest, int(depth.max()))
            compared += 1
        check(B < GAMES or (finished > 0 and terminal > 0),
              f"descend check at {B} games saw {finished} finished roots "
              f"and {terminal} terminal leaves")
        report.append(f"{B} games/{ev}/fpu {fpu}: {finished} finished roots, "
                      f"up to {terminal} terminal leaves, depth up to "
                      f"{deepest}")
        del tree
    torch.cuda.empty_cache()

    # refused operands: raise, and count no launch
    states = env.initial_state((4,), device=dev)
    tree = mcts.init_tree(states, mcts.SearchSpec(num_simulations=8))
    ok = (tree.rows, states, tree.root_visit, tree.root_vsum, A, 1.5)
    turned = env.EnvState(states.board.transpose(1, 2), *(
        getattr(states, f) for f in ("turn", "winner", "done", "move_count")))
    refused = [((tree.rows.double(),) + ok[1:], TypeError),
               ((tree.rows[:, ::2],) + ok[1:], ValueError),
               (ok[:1] + (turned,) + ok[2:], ValueError),
               (ok[:2] + (tree.root_visit.long(),) + ok[3:], ValueError),
               (ok[:3] + (tree.root_vsum.double(),) + ok[4:], ValueError),
               (ok[:4] + (A + 1, 1.5), ValueError)]
    launches = K.descend.launches
    for bad, exc in refused:
        try:
            K.descend(*bad)
            took = True
        except exc:
            took = False
        check(not took, "descend took a malformed operand")
    check(K.descend.launches == launches, "a refused descend counted as a "
                                          "launch")
    del tree

    # times at the main path's shape, on a tree grown from early positions
    # by the kernel's own search, after 0 (every walk is the root's one new
    # edge), 50, 200 and 400 simulations. The
    # tree is cycled through DESCEND_COPIES copies, so that a launch finds
    # its rows in device memory and not in the 50 MB L2, as a simulation
    # does after the evaluator's traffic; "l2_" times are one tree again
    # and again. The plain version syncs with the host every level, so its
    # time is per call.
    states = on(random_positions(GAMES, 31, max_plies=16))
    spec = mcts.SearchSpec(num_simulations=SIMS)
    tree = mcts.init_tree(states, spec)
    timed = []
    for chunk in DESCEND_CHUNKS:
        mcts.search(states, evals["generic"],
                    mcts.SearchSpec(num_simulations=chunk), tree=tree)
        # timed as the search calls it: into one set of results
        out = compare_descents(
            tree, spec, f"timing tree, {int(tree.root_visit[0])} sims")
        _, alloc, depth = out[:3]
        compared += 1
        bound, nbytes = descend_bound_ms(depth, alloc)
        copies = [tree.rows] + [tree.rows.clone()
                                for _ in range(DESCEND_COPIES - 1)]
        run = lambda rows: K.descend(rows, states, tree.root_visit,
                                     tree.root_vsum, A, spec.c_puct, 0.0,
                                     out)
        cold = lambda i: run(copies[i % DESCEND_COPIES])
        hot = lambda i: run(tree.rows)
        plain = lambda i: K._descend_plain(
            tree.rows, states, tree.root_visit, tree.root_vsum, A,
            spec.c_puct, 0.0, out)
        timed.append({
            "sims": int(tree.root_visit[0]),
            "mean_depth": float(depth.float().mean()),
            "max_depth": int(depth.max()),
            "ms": cuda_ms(cold, iters=48, warmup=12, what="descend"),
            "call_ms": cuda_ms(cold, iters=48, warmup=12, queued=False),
            "l2_ms": cuda_ms(hot, what="descend l2"),
            "plain_ms": cuda_ms(plain, iters=4, warmup=2, queued=False),
            "bound_ms": bound, "bound_bytes": nbytes})
        if chunk == DESCEND_CHUNKS[-1]:
            path_t, path_bound = check_commit_path(dev, tree, out, copies)
        del copies
        torch.cuda.empty_cache()
    last = timed[-1]
    t = {"ms": last["ms"], "call_ms": last["call_ms"],
         "l2_ms": last["l2_ms"], "plain_ms": last["plain_ms"],
         "library_ms": None, "mean_depth": last["mean_depth"],
         "max_depth": last["max_depth"]}
    print(f"descend equal to the plain per-level descent on {compared} "
          f"trees ({'; '.join(report)}); at {GAMES} games by simulations "
          f"searched: {json.dumps(timed)}", flush=True)
    print(f"commit_path (the backprop, path form) equal to its plain "
          f"version and to the stacked form on the descent of the "
          f"{int(tree.root_visit[0])}-simulation tree: {json.dumps(path_t)}; "
          f"bound {path_bound:.7f} ms (bytes)", flush=True)
    return 0.0, t, last["bound_ms"], path_t, path_bound


# -----------------------------------------------------------------------------
# Phase 2: the archived net, bf16 on the card against f32 on the CPU
# -----------------------------------------------------------------------------

def random_positions(n, seed, max_plies=40):
    """``alphazero_torch.strength.common.random_positions``, kept under
    this name for ``tests/test_torch_network.py`` and
    ``scripts/int8_accuracy_torch_vs_jax.py``, which import it from here."""
    from alphazero_torch.strength.common import random_positions as made

    return made(n, seed, max_plies)


def finish_games(state, which, seed):
    """Plays the games of the mask ``which`` on with random legal moves
    until they are over (``random_positions`` stops short of the end)."""
    from alphazero_torch.env import breakthrough as env

    rng = np.random.default_rng(seed)
    while bool((which & ~state.done).any()):
        mask = env.legal_action_mask(state).numpy()
        acts = np.array([rng.choice(np.flatnonzero(m)) if m.any() else 0
                         for m in mask])
        state = env.select_state(which & ~state.done,
                                 env.step(state, torch.from_numpy(acts)),
                                 state)
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
    from alphazero_torch.search import graph
    from alphazero_torch.search import kernels as K
    from alphazero_torch.search import mcts
    from alphazero_torch.train import selfplay

    cfg = Config(num_simulations=SIMS, parallel_games=GAMES)
    eval_fn = mcts.make_net_evaluator(net, getattr(torch, cfg.inference_dtype))
    spec = selfplay.search_spec(cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    states = env.initial_state((GAMES,), device=dev)
    # the one tree of every move here, as selfplay_games keeps it
    tree = mcts.init_tree(states, spec)

    # warm-up move: it captures the simulation; checks on the searched tree
    legal = env.legal_action_mask(states)
    graph.STATS.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    tree, _, probs, actions, states = selfplay._searched_move(
        states, tree, gen, eval_fn, spec, cfg.temperature_threshold)
    torch.cuda.synchronize()
    first = {"first_move_s": time.time() - t0,
             "captures": graph.STATS.captures,
             "capture_s": graph.STATS.capture_s,
             "replays": graph.STATS.replays}
    check(graph.STATS.captures == 1, f"the first move made "
                                     f"{graph.STATS.captures} captures")
    check(bool((tree.root_visit == SIMS).all()), "root visits != sims")
    check(bool((mcts.root_child_visits(tree).sum(-1) == SIMS).all()),
          "root child visits do not sum to sims")
    check(bool(((probs.sum(-1) - 1).abs() < 1e-5).all()), "probs sum")
    check(bool(legal[torch.arange(GAMES, device=dev), actions.long()].all()),
          "illegal sampled action")

    # the main path, counted: one move through selfplay_move, which replays
    # the captured simulation SIMS times
    torch.cuda.reset_peak_memory_stats()
    K.fetch_rows.launches = 0
    K.descend.launches = 0
    K.commit_edges.launches = 0
    mcts.STATS.reset()
    graph.STATS.reset()
    moves, live = 1, 0
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(moves):
        legal = env.legal_action_mask(states)
        live_now = ~states.done
        states, _, probs, actions, values = selfplay.selfplay_move(
            states, gen, eval_fn, spec, cfg.temperature_threshold, tree)
        live += int(live_now.sum())
        check(bool(legal[live_now, actions[live_now].long()].all()),
              "illegal sampled action")
        check(bool(((probs.sum(-1) - 1).abs() < 1e-5).all()), "probs sum")
        check(bool(torch.isfinite(values).all()), "root values not finite")
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {"descend": K.descend.launches,
                "fetch_rows": K.fetch_rows.launches,
                "commit_edges": K.commit_edges.launches}
    check(launches["descend"] > 0 and launches["commit_edges"] > 0,
          f"a kernel was not launched on the main path: {launches}")
    st = mcts.STATS
    check(launches["descend"] == launches["commit_edges"] == moves * SIMS
          == st.simulations == graph.STATS.replays
          and graph.STATS.captures == 0 and st.host_syncs == 0
          and launches["fetch_rows"] == 0,
          f"{launches}, {st.host_syncs} host syncs, "
          f"{graph.STATS.captures} captures and {graph.STATS.replays} "
          f"replays for {moves * SIMS} simulations: a simulation is one "
          f"replay, one descend and one commit_edges launch, no host read")
    depth = st.depth_sum / (st.simulations * GAMES)
    out = {
        "games": GAMES, "sims": SIMS, "moves": moves,
        "sims_per_s": live * SIMS / dt, "move_s": dt / moves,
        "mean_edge_depth": depth,
        "launches_per_move": {k: v / moves for k, v in launches.items()},
        "host_syncs_per_sim": st.host_syncs / st.simulations,
        "replays_per_move": graph.STATS.replays / moves,
        "first_move": first,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card,
    }
    # the eager yardstick in the same call: one search of the next position
    # eagerly, then one captured (replays of the tree's capture), each tree
    # bit-equal to the other
    live = int((~states.done).sum())
    seconds = captured_against_eager(states, eval_fn, spec, 1, 11,
                                     tree=tree)["seconds"]
    out["search_sims_per_s"] = {m: live * SIMS / t[0] for m, t in
                                seconds.items()}
    out["captured_over_eager"] = seconds["eager"][0] / seconds["captured"][0]
    print("main path " + json.dumps(out), flush=True)
    out["profile"] = {mode: profile_search(states, eval_fn, capture=c,
                                           tag=f"{GAMES}_{mode}")
                      for mode, c in (("captured", None), ("eager", False))}
    return launches, out


STAGES = ("mcts.descend", "mcts.evaluate", "mcts.expand", "mcts.backprop")


def profile_search(states, eval_fn, sims=16, tag=None, capture=None):
    """One ``sims``-simulation search under ``torch.profiler``, captured
    (the default, on a tree that captured in a search before it, so
    that the profiled one only replays) or eager (``capture=False``): wall
    time; the host's time until the search returned, per simulation (on
    the captured path the host's cost of a replay); device busy time (the
    sum of the kernels' own times; one stream, so they do not overlap) and
    the idle share; host time and device span per simulation stage (the
    ``record_function`` spans of ``mcts._simulate_once``, which a replay
    does not record: eager only); the host syncs and the host time spent
    blocked in them (``aten::_local_scalar_dense``, the device-to-host read
    behind every ``bool()``/``int()`` of a CUDA tensor); and the kernels
    that took most device time. The whole table goes to
    ``chiprun_out/chip_smoke_profile_<tag or games>.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from alphazero_torch.search import mcts

    B = states.turn.shape[0]
    spec = mcts.SearchSpec(num_simulations=sims)
    tree = mcts.search(states, eval_fn, spec, capture=capture)   # warm
    tree = mcts.init_tree(states, spec, tree=tree)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        mcts.search(states, eval_fn, spec, tree=tree, capture=capture)
        host = time.time() - t0
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
    host_stage = {e.key: e.cpu_time_total / 1e3 / sims for e in events
                  if e.key in STAGES and e.device_type == DeviceType.CPU}
    span = {e.key: e.self_device_time_total / 1e3 / sims for e in events
            if e.key in STAGES and e.device_type == DeviceType.CUDA}
    stage = {k: (host_stage.get(k, 0.0), span.get(k, 0.0)) for k in STAGES}
    syncs = [e for e in events if e.key == "aten::_local_scalar_dense"
             and e.device_type == DeviceType.CPU]
    n_sync = sum(e.count for e in syncs) / sims
    sync_ms = sum(e.cpu_time_total for e in syncs) / 1e3 / sims
    mode = "eager" if capture is False else "captured"
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"chip_smoke_profile_{tag or B}.txt"), "w") as f:
        f.write(f"one {mode} search, {B} games x {sims} sims: wall "
                f"{wall:.4f} s, host until it returned {host:.4f} s, "
                f"device busy {busy:.4f} s\n")
        f.write(f"host syncs: {n_sync:.3f} per sim, host blocked in them "
                f"{sync_ms:.3f} ms/sim\n")
        for k, (h, d) in stage.items():
            f.write(f"{k}: host {h:.3f} ms/sim, device span {d:.3f} "
                    f"ms/sim\n")
        for us, key, count in kern[:40]:
            f.write(f"{us / 1e3:10.3f} ms  {count:7d}  {key}\n")
    check(kern, f"profile of the {mode} search: no device events")
    top = "; ".join(f"{k[:40]} {us / 1e3:.1f} ms x{c}"
                    for us, k, c in kern[:5])
    split = ", ".join(f"{k[5:]} {h:.2f}/{d:.2f}"
                      for k, (h, d) in stage.items())
    print(f"profile {tag or ''} {mode}, {B} games x {sims} sims: wall "
          f"{wall * 1e3:.1f} ms, host until it returned "
          f"{host * 1e3 / sims:.3f} ms/sim, device busy {busy * 1e3:.1f} ms "
          f"(idle share {1 - busy / wall:.3f}); per sim host/device-span "
          f"ms: {split}; host syncs per sim {n_sync:.3f}, host blocked in "
          f"them {sync_ms:.3f} ms/sim; top kernels: {top}", flush=True)
    return {"wall_s": wall, "busy_s": busy, "idle_share": 1 - busy / wall,
            "host_ms_per_sim": host * 1e3 / sims,
            "stages_host_device_ms_per_sim": stage,
            "kernels_ms": {key: us / 1e3 for us, key, _ in kern}}


# -----------------------------------------------------------------------------
# Phase 4: the same search on the card (kernels) and the CPU (plain)
# -----------------------------------------------------------------------------

_W = torch.tensor((np.arange(A) * 5) % 8 + 1, dtype=torch.float32)
_SQ = torch.arange(A) // 3
_DYADIC = {}


def dyadic_eval(planes):
    """Toy evaluator whose every output and every sum the search takes is
    exact in float32 in any order: integer policy weights and values that
    are multiples of 1/16. Its weights go to the device once (a copy from
    the host could not be captured)."""
    B = planes.shape[0]
    mine = planes[:, 0].reshape(B, 64)
    theirs = planes[:, 1].reshape(B, 64)
    if planes.device not in _DYADIC:
        _DYADIC[planes.device] = (_W.to(planes.device),
                                  _SQ.to(planes.device))
    weights, squares = _DYADIC[planes.device]
    w = weights * (1.0 + mine[:, squares])
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
    from alphazero_torch.search import graph
    from alphazero_torch.search import kernels as K
    from alphazero_torch.search import mcts
    from alphazero_torch.train import selfplay

    cfg = Config(num_simulations=CONT_SIMS, parallel_games=CONT_LANES)
    eval_fn = mcts.make_net_evaluator(net, getattr(torch, cfg.inference_dtype))
    gen = torch.Generator(device=dev).manual_seed(2)
    K.fetch_rows.launches = 0
    K.descend.launches = 0
    K.commit_edges.launches = 0
    mcts.STATS.reset()
    graph.STATS.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    examples, stats = selfplay.selfplay_games_continuous(
        eval_fn, cfg, gen, num_games=CONT_GAMES, device=dev)
    dt = time.time() - t0
    st = mcts.STATS
    check(K.descend.launches > 0 and K.commit_edges.launches > 0,
          "continuous self-play did not launch both kernels")
    check(K.descend.launches == K.commit_edges.launches == st.simulations
          and st.host_syncs == 0 and K.fetch_rows.launches == 0
          and graph.STATS.captures == 1,
          f"{K.descend.launches} descend, {K.commit_edges.launches} "
          f"commit_edges, {K.fetch_rows.launches} fetch_rows launches, "
          f"{st.host_syncs} host syncs and {graph.STATS.captures} captures "
          f"for {st.simulations} simulations: a simulation is one descend "
          f"and one commit_edges launch and no host read, and the run's "
          f"one tree is captured once")
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
           "mean_edge_depth": st.depth_sum / (st.simulations * CONT_LANES),
           "host_syncs_per_sim": st.host_syncs / st.simulations,
           "captures": graph.STATS.captures,
           "capture_s": graph.STATS.capture_s,
           "replays": graph.STATS.replays,
           "launches_per_sim": {
               "descend": K.descend.launches / st.simulations,
               "commit_edges": K.commit_edges.launches / st.simulations},
           "card": card}
    print("continuous " + json.dumps(out), flush=True)
    from alphazero_torch.env import breakthrough as env
    profile_search(env.initial_state((CONT_LANES,), device=dev), eval_fn,
                   tag=f"{CONT_LANES}_captured")


# -----------------------------------------------------------------------------
# Phase 6: the fused tower kernel against its plain version, and its times
# -----------------------------------------------------------------------------

def _heads_deviation(packed, got, want):
    """Largest difference in a logit, a probability and the value after
    the heads, between two tower outputs."""
    from alphazero_torch.models import fused
    from alphazero_torch.models.network import wl_to_value

    (pg, wg), (pw, ww) = fused.heads(packed, got), fused.heads(packed, want)
    return (max(float((pg - pw).abs().max()), float((wg - ww).abs().max())),
            float((torch.softmax(pg, -1) - torch.softmax(pw, -1)).abs().max()),
            float((wl_to_value(wg) - wl_to_value(ww)).abs().max()))


def tower_bound_ms(games, num_blocks, packed):
    """The least time the card could take for ``tower_forward``: its
    operations (two 3x3 convs and the three SE products per block, two
    operations per multiply-add) at the bf16 tensor-core rate, or its
    bytes (activations in and out, every weight once) at the memory rate,
    whichever is larger."""
    C = 128
    macs = num_blocks * games * (2 * 64 * 9 * C * C + 3 * C * 128)
    weights = sum(packed[k][:num_blocks].numel() * packed[k].element_size()
                  for k in ("wconv", "bconv", "wse1", "bse1", "wse2g",
                            "wse2b", "bse2g", "bse2b"))
    nbytes = 2 * games * 64 * C * 2 + weights
    by_ops = 2 * macs / BF16_FLOPS * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes"), 2 * macs, nbytes


@phase("phase 6 tower kernel")
def phase_tower(dev, net):
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.models import fused
    from alphazero_torch.models.network import wl_to_value

    packed = fused.pack_weights(net)
    n = packed["num_blocks"]
    check(n == TOWER_BLOCKS, f"archive has {n} blocks")
    planes = env.encoded_state(random_positions(GAMES, 21)).to(dev)
    x = fused.tower_input(packed, planes)
    check(x.shape == (GAMES * 64, 128) and x.dtype == torch.bfloat16,
          "tower input shape")
    step = 2.0 ** -7                     # one bf16 step, relative
    worst = 0.0
    for nb in (1, 2, TOWER_BLOCKS):
        for games in (fused.TB, GAMES):
            xin = x[:games * 64]
            before = xin.clone()
            got = fused.tower_forward(xin, packed, nb)
            want = fused._tower_plain(xin, packed, nb)
            torch.cuda.synchronize()
            check(torch.equal(xin, before), "tower_forward changed its input")
            check(got.shape == want.shape and got.dtype == torch.bfloat16
                  and bool(torch.isfinite(got.float()).all()),
                  f"tower output malformed ({nb} blocks, {games} games)")
            g, w = got.float(), want.float()
            diff = (g - w).abs()
            steps = float((diff / (step * w.abs().clamp_min(1.0))).max())
            worst = max(worst, float(diff.max()))
            dl, dp, dv = _heads_deviation(packed, got, want)
            print(f"tower kernel vs plain, {nb} blocks x {games} games: "
                  f"{int((diff > 0).sum())}/{diff.numel()} elements differ, "
                  f"max |d| {float(diff.max()):.4g} = {steps:.2f} steps, "
                  f"after the heads |d prob| {dp:.5f} |d value| {dv:.5f}",
                  flush=True)
            # the order of the f32 sums differs, so an element may land on
            # the next bf16 value. One block: at most one bf16 step (2^-7
            # of max(|x|, 1)); two blocks: at most four. Through 20 blocks
            # such steps grow like the bf16 net's own rounding against
            # f32, so there the heads' outputs are held to BF16_LIMITS
            if nb <= 2:
                check(steps <= (1.0 if nb == 1 else 4.0),
                      f"tower kernel differs from its plain version by "
                      f"{steps} bf16 steps at {nb} blocks, {games} games")
            check(dl <= BF16_LIMITS[0] and dp <= BF16_LIMITS[1]
                  and dv <= BF16_LIMITS[2],
                  f"tower kernel vs plain after the heads at {nb} blocks: "
                  f"|d logit| {dl}, |d prob| {dp}, |d value| {dv}")
    # every block's weights on their own: block i of the kernel against
    # block i of the plain version on the plain version's activations
    xi, forced = x, 0.0
    for i in range(n):
        one = {k: (v[i:i + 1] if torch.is_tensor(v) else v)
               for k, v in packed.items()}
        got = fused.tower_forward(xi, one, 1).float()
        xi = fused._tower_plain(xi, one, 1)
        w = xi.float()
        forced = max(forced, float(((got - w).abs()
                                    / (step * w.abs().clamp_min(1.0))).max()))
    check(forced <= 1.0, f"a single block of the tower kernel differs from "
                         f"its plain version by {forced} bf16 steps")
    print(f"each of the {n} blocks alone, on the plain version's "
          f"activations: at most {forced:.2f} bf16 steps", flush=True)
    launches = fused.tower_forward.launches
    refused = [(x[:3 * 64], ValueError), (x.float(), TypeError),
               (x[:, :64], ValueError)]
    if dev.type == "cuda":               # the kernel never copies its input
        refused.append((x[::2], ValueError))
    for bad, exc in refused:
        try:
            fused.tower_forward(bad, packed, 1)
        except exc:
            pass
        else:
            raise SmokeFailure(f"tower_forward took {tuple(bad.shape)} "
                               f"{bad.dtype}")
    check(fused.tower_forward.launches == launches,
          "a refused call counted as a launch")

    # fused_apply against the layer-by-layer net on phase 2's 64
    # positions: within BF16_LIMITS of the f32 net, as the bf16 net is,
    # and so within twice the limits of the bf16 net
    net_bf16 = copy.deepcopy(net).to(torch.bfloat16)
    planes64 = env.encoded_state(random_positions(64, 11)).to(dev)
    with torch.no_grad():
        pf, wf = fused.fused_apply(packed, planes64)
        p16, w16 = net_bf16(planes64.bfloat16())
        p32, w32 = net(planes64)
    dev_of = lambda p, w: (
        max(float((pf - p).abs().max()), float((wf - w).abs().max())),
        float((torch.softmax(pf, -1) - torch.softmax(p, -1)).abs().max()),
        float((wl_to_value(wf) - wl_to_value(w)).abs().max()))
    d16, d32 = dev_of(p16, w16), dev_of(p32, w32)
    check(all(d <= lim for d, lim in zip(d32, BF16_LIMITS)),
          f"fused_apply vs the f32 net: {d32}")
    check(all(d <= 2 * lim for d, lim in zip(d16, BF16_LIMITS)),
          f"fused_apply vs the bf16 net: {d16}")
    print(f"fused_apply on 64 positions, max |d logit|, |d prob|, "
          f"|d value|: vs the f32 net {d32} (limits {BF16_LIMITS}), vs the "
          f"bf16 net {d16} (twice the limits)", flush=True)

    # times at the path's shape; library: the tower blocks of the bf16
    # net in eager mode (cuDNN), which the fused path never calls
    x_nchw = x.view(GAMES, 8, 8, 128).permute(0, 3, 1, 2).contiguous()

    @torch.no_grad()
    def library(i):
        y = x_nchw
        for block in net_bf16.blocks:
            y = block(y)
        return y

    t = {"ms": cuda_ms(lambda i: fused.tower_forward(x, packed, n),
                       iters=20, warmup=3),
         "call_ms": cuda_ms(lambda i: fused.tower_forward(x, packed, n),
                            iters=20, warmup=3, queued=False),
         # the plain version issues thousands of launches per call, more
         # than a stream queues: its time is per call, host included
         "plain_ms": cuda_ms(lambda i: fused._tower_plain(x, packed, n),
                             iters=3, warmup=1, queued=False),
         # one call: three would pass the stream's queue depth
         "library_ms": cuda_ms(library, iters=1, warmup=3, sleep_ms=100),
         "library_call_ms": cuda_ms(library, iters=10, warmup=2,
                                    queued=False)}
    bound, bound_by, ops, nbytes = tower_bound_ms(GAMES, n, packed)
    t["tflops"] = ops / t["ms"] / 1e9
    # how the time scales: a thread block of four games on half of the
    # 132 SMs (264 games), on every SM (528), and two in turn on every SM
    # (1056); and one or two tower blocks against twenty
    x2 = torch.cat([x, x, x[:32 * 64]])
    scaling = {f"{g}x{nb}": cuda_ms(
        lambda i: fused.tower_forward(x2[:g * 64], packed, nb),
        iters=20, warmup=3)
        for g, nb in ((264, n), (528, n), (1056, n), (GAMES, 1),
                      (GAMES, 2))}
    print(f"tower_forward device ms by games x blocks: "
          f"{json.dumps(scaling)}", flush=True)
    print(f"tower_forward at {GAMES} positions x {n} blocks: "
          f"{json.dumps(t)}; bound {bound:.4f} ms by {bound_by} "
          f"({ops:.4g} operations, {nbytes:.4g} bytes)", flush=True)
    return worst, t, (bound, bound_by)


# -----------------------------------------------------------------------------
# Phase 7: the fused path at full width
# -----------------------------------------------------------------------------

@phase("phase 7 fused path")
def phase_fused(dev, net, card):
    from alphazero_torch import bench_fused
    from alphazero_torch.models import fused

    fused.tower_forward.launches = 0
    out = bench_fused.bench_fused(
        net, bench_fused.random_planes(GAMES).to(dev), FUSED_EVALS)
    launches = fused.tower_forward.launches
    # one evaluation for the numerics line, three to warm up, then the
    # timed ones
    check(launches == FUSED_EVALS + 4
          and out["tower_launches"] + 1 == launches,
          f"tower_forward launched {launches} times for {FUSED_EVALS} "
          f"evaluations")
    # random planes and 512 positions: further from the bf16 net than
    # phase 6's 64 real positions; a gross-error gate only
    check(out["max_prob_diff"] <= 0.5 and out["max_value_diff"] <= 0.5,
          f"fused path vs the bf16 net: {out}")
    out["card"] = card
    print("fused path " + json.dumps(out), flush=True)
    return launches


# -----------------------------------------------------------------------------
# Phase 8: the trainer at full width
# -----------------------------------------------------------------------------

def profile_train_steps(step, n=3):
    """``n`` train steps under ``torch.profiler``: the share of the wall
    time the device is busy (the sum of the kernels' own times over the
    wall) and the five kernels that took most of it. The whole table
    goes to ``chiprun_out/chip_smoke_profile_train_step.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.time()
        for i in range(n):
            step(i)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.time() - t0
    kern = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kern) / 1e6
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "chip_smoke_profile_train_step.txt"), "w") as f:
        f.write(f"{n} train steps: wall {wall:.4f} s, device busy "
                f"{busy:.4f} s\n")
        for us, key, count in kern[:40]:
            f.write(f"{us / 1e3 / n:10.3f} ms/step  {count // n:5d}  "
                    f"{key}\n")
    return busy / wall, [f"{k[:48]} {us / 1e3 / n:.2f} ms x{c // n}"
                         for us, k, c in kern[:5]]


@phase("phase 8 trainer")
def phase_trainer(dev, card):
    from alphazero_torch.models.convert import (
        config_from_archive,
        load_archive,
    )
    from alphazero_torch.search import graph
    from alphazero_torch.search import kernels as K
    from alphazero_torch.search import mcts
    from alphazero_torch.train import Trainer, cosine_lr
    from alphazero_torch.train import checkpoint as ckpt
    from alphazero_torch.train.learner import train_step

    with tempfile.TemporaryDirectory() as tmp:
        cfg = config_from_archive(ARCHIVE).replace(
            num_simulations=TRAIN_SIMS, parallel_games=TRAIN_LANES,
            selfplay_batches=1, batch_size=TRAIN_BATCH,
            checkpoint_dir=os.path.join(tmp, "checkpoints"))
        tr = Trainer(cfg, seed=0, net=load_archive(ARCHIVE, device=dev),
                     device=dev)
        K.fetch_rows.launches = 0
        K.descend.launches = 0
        K.commit_edges.launches = 0
        mcts.STATS.reset()
        graph.STATS.reset()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        metrics = [tr.run_iteration() for _ in range(2)]
        launches = {"descend": K.descend.launches,
                    "commit_edges": K.commit_edges.launches}
        st = mcts.STATS
        check(all(v > 0 for v in launches.values()),
              f"the trainer's self-play did not launch both kernels: "
              f"{launches}")
        check(launches["descend"] == launches["commit_edges"]
              == st.simulations and st.host_syncs == 0
              and K.fetch_rows.launches == 0 and graph.STATS.captures == 2,
              f"{launches}, {K.fetch_rows.launches} fetch_rows launches, "
              f"{st.host_syncs} host syncs and {graph.STATS.captures} "
              f"captures for {st.simulations} simulations: a simulation is "
              f"one descend and one commit_edges launch and no host read, "
              f"and each iteration's new evaluator one capture")
        search_stats = {
            "simulations": st.simulations,
            "host_syncs_per_sim": st.host_syncs / st.simulations,
            "captures": graph.STATS.captures,
            "capture_s": graph.STATS.capture_s,
            "mean_edge_depth": st.depth_sum / (st.simulations
                                               * TRAIN_LANES)}
        steps = []
        for i, m in enumerate(metrics):
            check(m["iteration"] == i + 1 and m["examples_new"] > 0,
                  f"iteration {i + 1}: {m}")
            check(all(np.isfinite(m[k]) for k in ("loss", "loss_pi",
                                                  "loss_wl")),
                  f"iteration {i + 1}: loss not finite: {m}")
            check(abs(m["lr"] - cosine_lr(cfg, i)) <= 1e-6 * m["lr"],
                  f"iteration {i + 1}: lr {m['lr']}, cosine_lr gives "
                  f"{cosine_lr(cfg, i)}")
            steps.append(-(-2 * m["buffer"] // cfg.batch_size))
        check(tr.state.learn_calls == 2, f"learn_calls "
                                         f"{tr.state.learn_calls}")
        check(sorted(ckpt.list_checkpoints(cfg)) == ["iteration_1",
                                                     "iteration_2"]
              and ckpt.get_latest_iteration(cfg) == 2,
              f"checkpoints on disk: {ckpt.list_checkpoints(cfg)}")
        with open(cfg.checkpoint_path("metrics.jsonl")) as f:
            check([json.loads(line)["iteration"] for line in f] == [1, 2],
                  "metrics.jsonl does not hold the two iterations")

        # a second trainer, from another seed, resumes from disk
        tr2 = Trainer(cfg, seed=1, device=dev)
        check(tr2.resume() == 2 and tr2.iteration == 2
              and tr2.state.learn_calls == 2, "resume: wrong iteration")
        check(len(tr2.buffer) == len(tr.buffer) == metrics[1]["buffer"],
              f"resume: buffer {len(tr2.buffer)} != {len(tr.buffer)}")
        sa, sb = tr.net.state_dict(), tr2.net.state_dict()
        check(sa.keys() == sb.keys()
              and all(torch.equal(sa[k], sb[k]) for k in sa),
              "resume: weights are not bit-equal")
        check(not os.path.exists(os.path.join(ROOT, "checkpoints")),
              "the trainer wrote into the source tree")

        # a train step alone, on one fixed batch of the replay window
        idx = torch.arange(cfg.batch_size, device=dev) % len(tr.buffer)
        batch = tuple(t[idx] for t in tr._device_replay())
        mirror = idx % 2 == 0
        step = lambda i: train_step(tr2.state, batch, mirror, cfg)
        step_ms = cuda_ms(step, iters=5, warmup=2, queued=False)
        busy_share, top = profile_train_steps(step)
        out = {
            "lanes": TRAIN_LANES, "sims": TRAIN_SIMS,
            "batch": cfg.batch_size, "f32_tf32": False,
            "iterations": [{k: m[k] for k in (
                "loss", "loss_pi", "loss_wl", "lr", "examples_new",
                "buffer", "selfplay_seconds", "learn_seconds",
                "sims_per_sec", "games_per_hour")} for m in metrics],
            "learn_steps": steps,
            "learn_ms_per_step": [m["learn_seconds"] * 1e3 / n
                                  for m, n in zip(metrics, steps)],
            "train_step_ms": step_ms,
            "train_step_device_busy_share": busy_share,
            "train_step_top_kernels": top,
            "max_memory_allocated_gb": (
                torch.cuda.max_memory_allocated() / 1e9
                if dev.type == "cuda" else None),
            "launches": launches, "search": search_stats, "card": card}
        print("trainer " + json.dumps(out), flush=True)

        # one more iteration of the first trainer with the int8-static
        # self-play evaluator: its calibration draws from the replay
        # buffer the first two iterations filled
        from alphazero_torch.models import quant

        tr.cfg = tr.cfg.replace(selfplay_quant="static",
                                num_simulations=STATIC_TRAIN_SIMS)
        quant.qconv3x3.launches = 0
        K.descend.launches = 0
        mcts.STATS.reset()
        m = tr.run_iteration()
        n_conv = 2 * cfg.num_blocks + 1
        check(m["iteration"] == 3 and m["examples_new"] > 0
              and all(np.isfinite(m[k]) for k in ("loss", "loss_pi",
                                                  "loss_wl")),
              f"int8-static iteration: {m}")
        # every simulation and every search's root expansion is one
        # forward of n_conv s8 convs; calibration adds four more forwards
        searches = mcts.STATS.simulations // STATIC_TRAIN_SIMS
        check(quant.qconv3x3.launches == n_conv * (
            mcts.STATS.simulations + searches + 4)
              and K.descend.launches == mcts.STATS.simulations > 0,
              f"int8-static iteration: {quant.qconv3x3.launches} qconv3x3 "
              f"launches for {mcts.STATS.simulations} simulations")
        print("trainer int8-static iteration " + json.dumps({
            "lanes": TRAIN_LANES, "sims": STATIC_TRAIN_SIMS,
            "qconv3x3_launches": quant.qconv3x3.launches,
            **{k: m[k] for k in ("loss", "examples_new", "buffer",
                                 "selfplay_seconds", "learn_seconds",
                                 "sims_per_sec", "games_per_hour")},
            "card": card}), flush=True)
    return launches, step_ms


# -----------------------------------------------------------------------------
# Phase 9: the s8 conv kernel against its plain version, and its times
# -----------------------------------------------------------------------------

def qconv_bound_ms(positions, cin, cout, in_bytes, out_bytes):
    """The least time the card could take for one ``qconv3x3``: its bytes
    (activations in and out once, the int8 weights, scales and biases) at
    the memory rate, or its int8 operations (two per multiply-add) at the
    dense int8 rate, whichever is larger."""
    nbytes = (positions * 64 * (cin * in_bytes + cout * out_bytes)
              + 9 * cin * cout + 8 * cout + 4)
    ops = 2 * positions * 64 * 9 * cin * cout
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT8_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations"), nbytes, ops


def ptxas_lines(stem, kernel):
    """What ``nvcc -Xptxas -v`` said of ``kernel``'s instantiations in
    ``csrc/<stem>.cu``: registers, barriers, stack and spills (the shared
    memory is dynamic and shows in none of them)."""
    from alphazero_torch import cuda_build

    log = cuda_build.library_path(stem).with_suffix(".log")
    lines, inside = [], False
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            inside = kernel in line
        if inside or "(C7" in line:
            lines.append(line.strip())
    return lines


def im2col_s8(x, xs, entry):
    """The s8 product inside ``qconv3x3``, laid out for one matrix
    multiply: (B*64, 9*cin) quantised im2col rows, k = tap*cin + ci, and
    the (9*cin, cout) weights (a column-major view)."""
    from alphazero_torch.models import quant

    B, cin = x.shape[0], x.shape[3]
    xq = torch.clamp(torch.round(x.float() / xs), -127, 127)
    xp = torch.nn.functional.pad(xq, (0, 0, 1, 1, 1, 1))
    cols = torch.stack([xp[:, t // 3:t // 3 + 8, t % 3:t % 3 + 8]
                        for t in range(9)], dim=3)
    cols = cols.reshape(B * 64, 9 * cin).to(torch.int8).contiguous()
    w = quant.kernel_weights(entry["qk"])[:, :9 * cin]
    return cols, w.contiguous().t()


@phase("phase 9 qconv kernel")
def phase_qconv(dev, net):
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.models import quant
    from alphazero_torch.strength.common import calibration_batches

    qp = quant.quantize_network(net)
    act = quant.calibrate(qp, calibration_batches(ARCHIVE, dev)[0])
    planes = env.encoded_state(random_positions(GAMES, 61)).to(dev)
    # the inputs every conv of the archived net sees in one static forward
    calls, real = [], quant._qconv

    def record(x, e, dtype, xs=None, relu=False):
        calls.append((x, xs, e, relu))
        return real(x, e, dtype, xs, relu)

    quant._qconv = record
    try:
        quant.make_quant_evaluator(net, act_scales=act, qp=qp)(planes)
    finally:
        quant._qconv = real
    n_conv = 2 * len(qp["blocks"]) + 1
    check(len(calls) == n_conv, f"{len(calls)} s8 convs in a forward")
    compared, differing, err = 0, 0, 0.0
    for x, xs_static, entry, _ in calls:
        xs_dyn = torch.clamp_min(x.float().abs().amax(), 1e-6) / 127.0
        for xs in (xs_static, xs_dyn):
            for relu in (False, True):
                got, gsum = quant.qconv3x3(x, xs, entry, relu, sums=True)
                want, wsum = quant.qconv_plain(x, xs, entry, relu, sums=True)
                torch.cuda.synchronize()
                err = max(err, float((got.float() - want.float()).abs()
                                     .max()))
                differing += int((gsum != wsum).sum()) + int(
                    (got != want).sum())
                compared += 1
    check(differing == 0, f"qconv3x3 differs from qconv_plain in "
                          f"{differing} sums and outputs")
    check(calls[0][0].dtype == torch.float32 and calls[0][0].shape[3] == 3
          and calls[1][0].dtype == torch.bfloat16, "conv inputs' types")
    print(f"qconv3x3 bit-equal to qconv_plain (s32 sums and outputs) on "
          f"{compared} cases: {n_conv} convs of the archived net at {GAMES} "
          f"positions x static/dynamic scales x ReLU off/on (cin 3: f32 "
          f"NCHW planes read in place; cin 128: bf16 NHWC)", flush=True)

    for line in ptxas_lines("qconv_kernel", "qconv3x3_kernel"):
        print(f"[phase 9] ptxas: {line}", flush=True)

    # times of a 128 -> 128 tower conv at the path's shape, and of the
    # input conv. Yardsticks the path never calls: the same conv in bf16
    # through F.conv2d (cuDNN), channels-last, timed in turns with the
    # kernel; and torch._int_mm, the s8 product alone, of the conv's
    # prebuilt (B*64, 9*cin) s8 im2col matrix by the (9*cin, cout) weights
    x, xs, entry, _ = calls[3]
    x_in, xs_in, entry_in, _ = calls[0]
    w_bf = entry["qk"].permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
    x_cl = x.permute(0, 3, 1, 2)
    library = lambda i: torch.nn.functional.conv2d(x_cl, w_bf, padding=1)
    kernel = lambda i: quant.qconv3x3(x, xs, entry, True)
    turns = [cuda_ms(kernel, what="qconv3x3"),
             cuda_ms(library, what="cuDNN bf16 conv"),
             cuda_ms(kernel, what="qconv3x3")]
    cols, w_cols = im2col_s8(x, xs, entry)
    check(torch.equal(torch._int_mm(cols, w_cols).reshape(GAMES, 8, 8, -1),
                      quant.qconv3x3(x, xs, entry, sums=True)[1]),
          "torch._int_mm of the im2col matrix differs from the kernel's sums")
    t = {"ms": (turns[0] + turns[2]) / 2, "ms_turns": turns,
         "call_ms": cuda_ms(kernel, queued=False),
         "plain_ms": cuda_ms(lambda i: quant.qconv_plain(x, xs, entry, True),
                             iters=10, warmup=2, queued=False),
         "library_ms": turns[1],
         "library_call_ms": cuda_ms(library, queued=False),
         "int_mm_ms": cuda_ms(lambda i: torch._int_mm(cols, w_cols),
                              what="torch._int_mm"),
         "input_conv_ms": cuda_ms(
             lambda i: quant.qconv3x3(x_in, xs_in, entry_in, True),
             what="qconv3x3 input conv")}
    bound, bound_by, nbytes, ops = qconv_bound_ms(GAMES, 128, 128, 2, 2)
    t["tops"] = ops / t["ms"] / 1e9
    print(f"qconv3x3 at {GAMES} positions, 128 -> 128, bf16 in and out: "
          f"{json.dumps(t)}; bound {bound:.7f} ms by {bound_by} ({nbytes} "
          f"bytes, {ops:.4g} int8 operations); the input conv's bound "
          f"{qconv_bound_ms(GAMES, 3, 128, 4, 2)[0]:.7f} ms", flush=True)
    return err, t, (bound, bound_by), qp, act


# -----------------------------------------------------------------------------
# Phase 10: the int8-static evaluator on the main path
# -----------------------------------------------------------------------------

def launches_per_forward(eval_fn, planes):
    """Device kernels one evaluation launches (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eval_fn(planes)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eval_fn(planes)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


@phase("phase 10 int8 search")
def phase_quant_search(dev, net, card, qp, act):
    from alphazero_torch.config import Config
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.models import quant
    from alphazero_torch.models.network import wl_to_value
    from alphazero_torch.search import graph
    from alphazero_torch.search import kernels as K
    from alphazero_torch.search import mcts
    from alphazero_torch.train import selfplay

    cfg = Config(num_simulations=SIMS, parallel_games=GAMES)
    evals = {"int8": quant.make_quant_evaluator(net, act_scales=act, qp=qp),
             "bf16": mcts.make_net_evaluator(net, torch.bfloat16)}
    spec = selfplay.search_spec(cfg)
    states = env.initial_state((GAMES,), device=dev)
    # a tree for each evaluator, and a warm-up move with each: it captures
    trees = {name: mcts.init_tree(states, spec) for name in evals}
    graph.STATS.reset()
    for name, fn in evals.items():
        gen = torch.Generator(device=dev).manual_seed(1)
        tree, _, probs, _, _ = selfplay._searched_move(
            states, trees[name], gen, fn, spec, cfg.temperature_threshold)
        torch.cuda.synchronize()
        check(bool((tree.root_visit == SIMS).all())
              and bool((mcts.root_child_visits(tree).sum(-1) == SIMS).all()),
              f"{name} search: root visits != sims")
        check(bool(((probs.sum(-1) - 1).abs() < 1e-5).all()), "probs sum")
    check(graph.STATS.captures == 2, f"{graph.STATS.captures} captures for "
                                     f"two evaluators")

    # the main path, counted, and timed in turns (int8, bf16, bf16, int8:
    # the host's speed drifts within a call), each move from the same
    # position and generator state, replays only; then one eager move of
    # each from the same position
    n_conv = 2 * len(qp["blocks"]) + 1
    out = {"games": GAMES, "sims": SIMS, "card": card,
           "capture_s": graph.STATS.capture_s,
           "int8_sims_per_s": [], "bf16_sims_per_s": []}
    for name in ("int8", "bf16", "bf16", "int8"):
        quant.qconv3x3.launches = 0
        K.descend.launches = 0
        K.commit_edges.launches = 0
        mcts.STATS.reset()
        graph.STATS.reset()
        gen = torch.Generator(device=dev).manual_seed(2)
        torch.cuda.synchronize()
        t0 = time.time()
        values = selfplay.selfplay_move(
            states, gen, evals[name], spec, cfg.temperature_threshold,
            trees[name])[4]
        torch.cuda.synchronize()
        dt = time.time() - t0
        check(bool(torch.isfinite(values).all()), "root values not finite")
        check(graph.STATS.captures == 0 and graph.STATS.replays == SIMS,
              f"{name} move: {graph.STATS.captures} captures, "
              f"{graph.STATS.replays} replays")
        out[f"{name}_sims_per_s"].append(GAMES * SIMS / dt)
        if name == "int8":
            launches = {"qconv3x3": quant.qconv3x3.launches,
                        "descend": K.descend.launches,
                        "commit_edges": K.commit_edges.launches}
            check(launches["qconv3x3"] == n_conv * (SIMS + 1)
                  and launches["descend"] == launches["commit_edges"]
                  == SIMS and mcts.STATS.host_syncs == 0,
                  f"int8 move: {launches}, {mcts.STATS.host_syncs} syncs")
        else:
            check(quant.qconv3x3.launches == 0, "bf16 move ran an s8 conv")
    out["int8_over_bf16"] = (sum(out["int8_sims_per_s"])
                             / sum(out["bf16_sims_per_s"]))
    out["launches_per_move"] = launches
    for name, fn in evals.items():
        seconds = captured_against_eager(states, fn, spec, 1, 2,
                                         tree=trees[name])["seconds"]
        out[f"{name}_search_sims_per_s"] = {m: GAMES * SIMS / t[0]
                                            for m, t in seconds.items()}
    out["eager_int8_over_bf16"] = (
        out["int8_search_sims_per_s"]["eager"]
        / out["bf16_search_sims_per_s"]["eager"])
    del trees
    torch.cuda.empty_cache()
    planes = env.encoded_state(random_positions(GAMES, 71)).to(dev)
    out["launches_per_forward"] = {
        name: launches_per_forward(fn, planes) for name, fn in evals.items()}
    for name, fn in evals.items():
        for mode, c in (("captured", None), ("eager", False)):
            p = profile_search(states, fn, tag=f"{name}_{GAMES}_{mode}",
                               capture=c)
            if mode == "eager":
                out[f"{name}_evaluate_host_ms_per_sim"] = \
                    p["stages_host_device_ms_per_sim"]["mcts.evaluate"][0]
            out[f"{name}_{mode}_host_ms_per_sim"] = p["host_ms_per_sim"]
            out[f"{name}_{mode}_idle_share"] = p["idle_share"]
            out[f"{name}_{mode}_busy_ms"] = p["busy_s"] * 1e3
            if (name, mode) == ("int8", "captured"):
                out["int8_qconv3x3_device_ms"] = sum(
                    ms for key, ms in p["kernels_ms"].items()
                    if "qconv3x3" in key)
    print("int8 search " + json.dumps(out), flush=True)

    # the card's int8 forward against the CPU's plain one (same static
    # scales) and against the f32 net, on 512 positions
    net_cpu = copy.deepcopy(net).cpu()
    qp_cpu = quant.quantize_network(net_cpu)
    act_cpu = {k: v.cpu() for k, v in act.items()}
    pl_g, wl_g = quant.quant_apply(qp, planes, act_scales=act)
    pl_c, wl_c = quant.quant_apply(qp_cpu, planes.cpu(), act_scales=act_cpu)
    with torch.no_grad():
        pl_f, wl_f = net(planes)
    pl_g, wl_g, pl_f, wl_f = (t.cpu() for t in (pl_g, wl_g, pl_f, wl_f))
    sm = lambda t: torch.softmax(t, -1)
    d_cpu = (max(float((pl_g - pl_c).abs().max()),
                 float((wl_g - wl_c).abs().max())),
             float((sm(pl_g) - sm(pl_c)).abs().max()),
             float((wl_to_value(wl_g) - wl_to_value(wl_c)).abs().max()))
    tv = 0.5 * (sm(pl_g) - sm(pl_f)).abs().sum(-1)
    d_f32 = (float(tv.mean()),
             float((pl_g.argmax(-1) == pl_f.argmax(-1)).float().mean()),
             float((wl_to_value(wl_g) - wl_to_value(wl_f)).abs().mean()))
    check(all(d <= lim for d, lim in zip(d_cpu, INT8_LIMITS)),
          f"int8 forward, card vs CPU: {d_cpu}")
    check(d_f32[0] < INT8_VS_F32[0] and d_f32[1] >= INT8_VS_F32[1]
          and d_f32[2] < INT8_VS_F32[2], f"int8 forward vs f32: {d_f32}")
    print(f"int8-static forward on {GAMES} positions: card vs CPU plain "
          f"max |d logit|, |d prob|, |d value| {d_cpu} (limits "
          f"{INT8_LIMITS}); vs the f32 net policy TV mean, argmax "
          f"agreement, value MAE {d_f32} (limits {INT8_VS_F32})",
          flush=True)
    return launches, evals, out


# -----------------------------------------------------------------------------
# Phase 11: the arena, int8 static against bf16 on the same weights
# -----------------------------------------------------------------------------

@phase("phase 11 arena")
def phase_arena(dev, evals, card):
    import random

    from alphazero_torch.arena import match
    from alphazero_torch.config import Config

    pair_eval_fn = match.select_evaluator(evals["int8"], evals["bf16"])
    rng = random.Random(0)
    openings = [match.random_opening(rng) for _ in range(ARENA_OPENINGS)]
    moves, real = [0], match._match_move

    def counted(*a):
        moves[0] += 1
        return real(*a)

    match._match_move = counted
    try:
        t0 = time.time()
        wins = match.play_paired_matches(
            None, None, openings, Config(), num_simulations=ARENA_SIMS,
            pair_eval_fn=pair_eval_fn, device=dev)
        dt = time.time() - t0
    finally:
        match._match_move = real
    check(sum(wins) == 2 * ARENA_OPENINGS,
          f"arena: {wins} wins in {2 * ARENA_OPENINGS} games (a game did "
          f"not end within max_game_length)")
    print("arena " + json.dumps({
        "openings": ARENA_OPENINGS, "games": 2 * ARENA_OPENINGS,
        "sims": ARENA_SIMS, "wins_int8_static": wins[0], "wins_bf16": wins[1],
        "lockstep_moves": moves[0], "seconds": dt, "card": card}),
          flush=True)


# -----------------------------------------------------------------------------
# Phase 12: the bench, once at a reduced size
# -----------------------------------------------------------------------------

@phase("phase 12 bench")
def phase_bench(card):
    run = subprocess.run(
        [sys.executable, "-m", "alphazero_torch.bench"], cwd=ROOT,
        env=dict(os.environ, **BENCH_ENV), capture_output=True, text=True,
        timeout=300)
    check(run.returncode == 0, f"bench exit {run.returncode}: "
                               f"{run.stderr[-2000:]}")
    lines = run.stdout.splitlines()
    check(len(lines) == 1, f"bench printed {len(lines)} lines on stdout")
    out = json.loads(lines[0])
    check(out["metric"] == "mcts_sims_per_sec_per_chip" and out["value"] > 0,
          f"bench: {out}")
    print(f"bench {json.dumps(BENCH_ENV)}: {lines[0]}; stderr: "
          f"{' | '.join(run.stderr.strip().splitlines()[-6:])}; card {card}",
          flush=True)


# -----------------------------------------------------------------------------
# Phase 13: the web server, its bot on the card, against the baseline
# -----------------------------------------------------------------------------

def http_json(base, path, body=None):
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, headers={
        "Content-Type": "application/json"}, method="GET" if body is None
        else "POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


@phase("phase 13 web server")
def phase_web(dev, net, card):
    import tempfile
    import threading
    from http.server import ThreadingHTTPServer

    from alphazero_torch.env import OracleGame
    from alphazero_torch.env.oracle import live_states
    from alphazero_torch.models.convert import config_from_archive
    from alphazero_torch.search import kernels as K
    from alphazero_torch.search import mcts
    from alphazero_torch.train import checkpoint as ckpt
    from alphazero_torch.train.learner import TrainState, make_optimizer
    from alphazero_torch.web import server

    sims = WEB_SIMS
    with tempfile.TemporaryDirectory() as tmp:
        # the archive as the port's model_best, which the bot loads first
        cfg = config_from_archive(ARCHIVE).replace(checkpoint_dir=tmp)
        check(cfg.num_simulations_inference == sims, "inference sims")
        ckpt.save_iteration_checkpoint(
            cfg, TrainState(net, make_optimizer(cfg, net)), 0,
            name=cfg.best_model)
        session = server.GameSession(cfg, device=dev)
        check(session.bot.model_name == cfg.best_model,
              f"the bot loaded {session.bot.model_name}")
        httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                    server.make_handler(session, cfg))
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        real_ms, server.BASELINE_TIME_MS = (server.BASELINE_TIME_MS,
                                            WEB_BASELINE_MS)
        az_s, base_s, base_nodes, evals = [], [], [], []
        total = {"descend": 0, "commit_edges": 0}
        try:
            check(http_json(base, "/api/models")["current"]
                  == cfg.best_model, "/api/models")
            legal = [list(m) for m in OracleGame().get_legal_moves()]
            request = ("/api/new", {"white_type": "alphazero",
                                    "black_type": "baseline"})
            plies = 0
            while plies < WEB_PLIES:
                az_turn = plies % 2 == 0          # AlphaZero plays White
                K.descend.launches = K.commit_edges.launches = 0
                torch.cuda.synchronize()
                t0 = time.time()
                r = http_json(base, *request)
                dt = time.time() - t0
                check(r["bot_move"] in legal,
                      f"ply {plies}: {r['bot_move']} not in the legal "
                      f"moves {legal}")
                check(-1.0 <= r["evaluation"] <= 1.0, f"evaluation {r}")
                launches = (K.descend.launches, K.commit_edges.launches)
                total["descend"] += launches[0]
                total["commit_edges"] += launches[1]
                if az_turn:
                    check(launches == (sims, sims) and "engine" not in r,
                          f"AlphaZero move {plies}: {launches} launches")
                    az_s.append(dt)
                    evals.append(r["evaluation"])
                else:
                    check(launches == (0, 0) and r["engine"]["nodes"] > 0,
                          f"baseline move {plies}: {launches}, {r}")
                    base_s.append(dt)
                    base_nodes.append(r["engine"]["nodes"])
                plies += 1
                legal = r["legal_moves"]
                if r["game_over"]:
                    break
                request = ("/api/bot_move", {})
            state = http_json(base, "/api/state")
            for key in ("board", "turn", "game_over", "result",
                        "legal_moves"):
                check(state[key] == r[key],
                      f"/api/state {key} {state[key]} != {r[key]}")
            # the bot's move on the initial position, in this thread:
            # captured (its tree's simulation, replayed) against one eager
            # search of the same position, bit for bit
            bot, game = session.bot, OracleGame()
            bot_s = {}
            torch.cuda.synchronize()
            t0 = time.time()
            bot.alphazero_move(game)
            torch.cuda.synchronize()
            bot_s["captured"] = time.time() - t0
            with torch.inference_mode():
                t0 = time.time()
                eager = mcts.search(live_states([game], dev), bot._eval_fn,
                                    bot._spec, capture=False)
                torch.cuda.synchronize()
                bot_s["eager"] = time.time() - t0
                check(torch.equal(eager.rows, bot._tree.rows)
                      and torch.equal(eager.root_vsum, bot._tree.root_vsum),
                      "the bot's captured search differs from the eager "
                      "one")
        finally:
            server.BASELINE_TIME_MS = real_ms
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)
    check(not thread.is_alive(), "the server thread did not stop")
    print("web " + json.dumps({
        "plies": plies, "game_over": r["game_over"], "result": r["result"],
        "alphazero": {"batch": 1, "sims": sims, "net": "20x128 bf16",
                      "moves": len(az_s),
                      "first_move_s": az_s[0],
                      "s_per_move_after_first": (sum(az_s[1:])
                                                 / max(len(az_s) - 1, 1)),
                      "min_s": min(az_s), "max_s": max(az_s),
                      "evaluations": evals,
                      "initial_position_move_s": bot_s},
        "baseline": {"ms": WEB_BASELINE_MS, "cut_from_ms": real_ms,
                     "moves": len(base_s),
                     "s_per_move": sum(base_s) / max(len(base_s), 1),
                     "nodes_per_s": sum(base_nodes) / max(sum(base_s),
                                                          1e-9)},
        "launches": total, "card": card}), flush=True)
    return total


# -----------------------------------------------------------------------------
# Phase 15: the captured simulation against the eager one
# -----------------------------------------------------------------------------

GRAPH_MOVES = 2


def captured_against_eager(states, eval_fn, spec, moves, seed, ctx=None,
                           tree=None):
    """``moves`` consecutive moves from ``states`` (greedy on the eager
    tree's visits, so both take the same path), each searched eagerly on a
    tree of its own and captured on one tree reset in place (``tree``, and
    the simulation it captured, if given), with root noise from generators
    of the same seed and ``ctx(states)`` as the evaluator's context. Fails
    unless every move's trees are bit-equal. Returns the host seconds of
    each move in each mode and the captures and replays of the captured
    moves."""
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.search import graph
    from alphazero_torch.search import mcts

    dev = states.turn.device
    fields = ("rows", "root_visit", "root_vsum", "node_count", "next_slot")
    seconds = {"eager": [], "captured": []}
    graph.STATS.reset()
    for move in range(moves):
        eval_ctx = None if ctx is None else ctx(states)
        trees = {}
        for mode in ("eager", "captured"):
            gen = torch.Generator(device=dev).manual_seed(seed + move)
            t = (mcts.init_tree(states, spec) if mode == "eager" else
                 mcts.init_tree(states, spec, tree=tree))
            torch.cuda.synchronize()
            t0 = time.time()
            trees[mode] = mcts.search(
                states, eval_fn, spec, generator=gen, add_noise=True, tree=t,
                eval_ctx=eval_ctx, capture=False if mode == "eager" else None)
            torch.cuda.synchronize()
            seconds[mode].append(time.time() - t0)
        tree = trees["captured"]
        differ = [f for f in fields if not torch.equal(
            getattr(trees["eager"], f), getattr(tree, f))]
        check(not differ, f"move {move}: the captured tree's {differ} differ "
                          f"from the eager tree's")
        actions = mcts.root_child_visits(trees["eager"]).argmax(-1)
        states = env.step(states, actions)
    return {"seconds": seconds, "captures": graph.STATS.captures,
            "replays": graph.STATS.replays,
            "capture_s": graph.STATS.capture_s}


@phase("phase 15 graph")
def phase_graph(dev, net, card):
    import contextlib
    import random

    from alphazero_torch.arena import match
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.models import quant
    from alphazero_torch.search import graph
    from alphazero_torch.search import mcts
    from alphazero_torch.strength.common import calibration_batches

    qp = quant.quantize_network(net)
    act = quant.calibrate(qp, calibration_batches(ARCHIVE, dev)[0])
    evals = {"bf16": mcts.make_net_evaluator(net, torch.bfloat16),
             "int8": quant.make_quant_evaluator(net, act_scales=act, qp=qp)}
    pair = match.select_evaluator(evals["int8"], evals["bf16"])
    rng = random.Random(0)
    arena_states = match.paired_states(
        [match.random_opening(rng) for _ in range(ARENA_OPENINGS)], dev)
    a_is_white = torch.arange(2 * ARENA_OPENINGS, device=dev) % 2 == 0
    # (name, states, evaluator, simulations, context, under inference mode)
    cases = [
        ("bf16", env.initial_state((GAMES,), device=dev), evals["bf16"], 64,
         None, False),
        ("int8_static", env.initial_state((GAMES,), device=dev),
         evals["int8"], 64, None, False),
        # the web bot's shape, as its handler runs it
        ("batch1_web", env.initial_state((1,), device=dev), evals["bf16"],
         WEB_SIMS, None, True),
        # the arena's pair evaluator and context, "player A to move", a new
        # tensor every move (arena/match.py)
        ("arena_eval_ctx", arena_states, pair, ARENA_SIMS,
         lambda st: torch.where(st.turn == env.WHITE, a_is_white,
                                ~a_is_white), False),
    ]
    out = {"moves_per_case": GRAPH_MOVES, "warmup_sims": graph.WARMUP,
           "card": card}
    for name, states, fn, sims, ctx, inference in cases:
        spec = mcts.SearchSpec(num_simulations=sims)
        mode = torch.inference_mode() if inference \
            else contextlib.nullcontext()
        with mode:
            r = captured_against_eager(states, fn, spec, GRAPH_MOVES, 7, ctx)
        check(r["captures"] == 1
              and r["replays"] == GRAPH_MOVES * sims - graph.WARMUP,
              f"{name}: {r['captures']} captures, {r['replays']} replays for "
              f"{GRAPH_MOVES} moves of {sims} simulations")
        B = states.turn.shape[0]
        r["games"], r["sims"] = B, sims
        r["sims_per_s"] = {m: [B * sims / t for t in ts]
                           for m, ts in r["seconds"].items()}
        out[name] = r
        print(f"graph {name}: {B} games x {sims} sims, {GRAPH_MOVES} moves "
              f"captured and eager, trees bit-equal: {json.dumps(r)}",
              flush=True)
    torch.cuda.empty_cache()
    return out


# -----------------------------------------------------------------------------
# Phase 14: the distributed trainer (worker processes)
# -----------------------------------------------------------------------------

def _state_digest(net) -> int:
    """63-bit digest of a net's parameters and buffers, in key order."""
    import hashlib

    h = hashlib.sha256()
    for k, v in sorted(net.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return int.from_bytes(h.digest()[:8], "big") >> 1


def _gather_ints(mesh, values):
    """Every rank's ``values`` (a list of ints), by rank."""
    import torch.distributed as dist

    from alphazero_torch.parallel import collective_device

    t = torch.tensor(values, dtype=torch.int64,
                     device=collective_device(mesh))
    out = [torch.zeros_like(t) for _ in range(mesh.world)]
    dist.all_gather(out, t, group=mesh.group)
    return [o.tolist() for o in out]


def _timed_steps(mesh, step, n):
    """Host ms of each of ``n`` calls of ``step()``, each between a
    device synchronisation (and, with ``mesh``, a barrier) and one."""
    from alphazero_torch.parallel import barrier

    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        if mesh is not None:
            barrier(mesh)
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def _stopwatch(t0):
    """(seconds, lap): ``lap(name)`` records the seconds since ``t0`` or
    the last lap under ``name``."""
    seconds, last = {}, [t0]

    def lap(name):
        now = time.time()
        seconds[name] = now - last[0]
        last[0] = now
    return seconds, lap


def _profiled_step(step):
    """One ``step()`` under ``torch.profiler``: all-reduces issued (the
    ``c10d::allreduce_`` operator), device kernels and NCCL kernels among
    them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    return {"all_reduces": sum(e.count for e in events
                               if e.key == "c10d::allreduce_"),
            "device_kernels": sum(e.count for e in device),
            "nccl_kernels": sum(e.count for e in device
                                if "nccl" in e.key.lower())}


def _dist_iteration(tr):
    """One ``run_iteration`` with the tree kernels' counts from 0; checks
    one ``descend`` and one ``commit_edges`` launch a simulation."""
    from alphazero_torch.parallel import broadcast_int
    from alphazero_torch.search import kernels as K
    from alphazero_torch.search import mcts

    K.descend.launches = K.commit_edges.launches = 0
    mcts.STATS.reset()
    m = tr.run_iteration()
    launches = {"descend": K.descend.launches,
                "commit_edges": K.commit_edges.launches}
    check(launches["descend"] == launches["commit_edges"]
          == mcts.STATS.simulations > 0,
          f"rank {tr.rank}: {launches} for {mcts.STATS.simulations} "
          f"simulations")
    check(all(np.isfinite(m[k]) for k in ("loss", "loss_pi", "loss_wl")),
          f"rank {tr.rank}: loss not finite: {m}")
    # every rank ran rank 0's step count (Trainer.learn)
    steps = broadcast_int(tr.mesh, max(1, -(-2 * m["buffer"] // (
        tr.cfg.batch_size // tr.world))))
    return {"launches": launches, "simulations": mcts.STATS.simulations,
            **{k: m[k] for k in ("loss", "examples_new", "buffer",
                                 "selfplay_seconds", "learn_seconds",
                                 "sims_per_sec")},
            "learn_steps": steps,
            "learn_ms_per_step": m["learn_seconds"] * 1e3 / steps}


def _dist_config(workdir):
    from alphazero_torch.models.convert import config_from_archive

    return config_from_archive(ARCHIVE).replace(
        num_simulations=TRAIN_SIMS, parallel_games=DIST_LANES,
        selfplay_batches=1, batch_size=TRAIN_BATCH,
        checkpoint_dir=os.path.join(workdir, "checkpoints"))


def _dist_gloo(mesh, workdir, lap):
    """Phase 14 (a) on one rank of two: iterations, resume, files, and one
    step against the one-process step."""
    from alphazero_torch.models.convert import load_archive
    from alphazero_torch.parallel import (
        barrier, shard_batch, sharded_train_step,
    )
    from alphazero_torch.train import Trainer
    from alphazero_torch.train.learner import (
        TrainState, make_optimizer, train_step,
    )
    from alphazero_torch.train.replay import host_data_path

    dev, rank = mesh.device, mesh.rank
    cfg = _dist_config(workdir)
    tr = Trainer(cfg, seed=0, net=load_archive(ARCHIVE, device=dev),
                 device=dev, mesh=mesh)
    lap("trainer")
    its = [_dist_iteration(tr)]
    lap("iteration_1")
    saved = _state_digest(tr.net)
    digests = [saved]

    tr = Trainer(cfg, seed=1, device=dev, mesh=mesh)
    check(tr.resume() == 1 and tr.iteration == 1,
          f"rank {rank}: resume found iteration {tr.iteration}")
    check(_state_digest(tr.net) == saved,
          f"rank {rank}: the resumed weights are not the saved ones")
    lap("resume")
    digests.append(_state_digest(tr.net))
    its.append(_dist_iteration(tr))
    lap("iteration_2")
    digests.append(_state_digest(tr.net))
    for i, row in enumerate(zip(*_gather_ints(mesh, digests))):
        check(len(set(row)) == 1, f"weights differ across ranks at point "
              f"{i} (after iteration 1, resume, iteration 2): {row}")
    barrier(mesh)
    with open(cfg.checkpoint_path("metrics.jsonl")) as f:
        lines = [json.loads(line)["iteration"] for line in f]
    check(lines == [1, 2], f"metrics.jsonl holds iterations {lines}")
    shards = [host_data_path(cfg.checkpoint_path(cfg.data_file), r)
              for r in range(mesh.world)]
    check(all(os.path.exists(p) for p in shards), f"shards: {shards}")
    pol = [np.load(p)["policies"] for p in shards]
    check(pol[0].shape != pol[1].shape or not np.array_equal(*pol),
          "the two ranks' replay shards are equal")

    # one fixed global batch: rank 0's first rows, on every rank
    n = cfg.batch_size
    src = tr._device_replay()
    idx = torch.arange(n, device=dev) % len(tr.buffer)
    batch = [src[0][idx].float(), src[1][idx].clone(), src[2][idx].clone()]
    mirror = (torch.arange(n, device=dev) % 2 == 0).to(torch.uint8)
    for t in batch + [mirror]:
        torch.distributed.broadcast(t, src=0, group=mesh.group)
    batch, mirror = tuple(batch), mirror.bool()
    one = None
    if rank == 0:
        net = copy.deepcopy(tr.net)          # a copy keeps no group
        one = TrainState(net=net, opt=make_optimizer(cfg, net),
                         learn_calls=tr.state.learn_calls,
                         mirror_gather=tr.state.mirror_gather)
        one.opt.load_state_dict(copy.deepcopy(tr.state.opt.state_dict()))
    step = sharded_train_step(mesh, cfg)
    local = shard_batch(mesh, batch), shard_batch(mesh, mirror)
    two = step(tr.state, *local)
    two = {k: float(two[k]) for k in ("loss", "loss_pi", "loss_wl")}
    row = _gather_ints(mesh, [_state_digest(tr.net)])
    check(len(set(r[0] for r in row)) == 1,
          f"weights differ across ranks after the compared step: {row}")
    out = {"rank": rank, "iterations": its, "step_loss": two}
    if rank == 0:
        whole = train_step(one, batch, mirror, cfg)
        check(abs(float(whole["loss"]) - two["loss"])
              <= 2e-5 * abs(float(whole["loss"])),
              f"loss: two ranks {two['loss']}, one process "
              f"{float(whole['loss'])}")
        sa, sb = tr.net.state_dict(), one.net.state_dict()
        worst = {}
        for k in sa:
            a, b = sa[k].double(), sb[k].double()
            if k.endswith(("running_mean", "running_var")):
                excess = ((a - b).abs() - 1e-5).max()
            elif k.endswith("num_batches_tracked"):
                excess = (a - b).abs().max()
            else:
                excess = ((a - b).abs() - 5e-4 - 5e-3 * b.abs()).max()
            worst[k] = float(excess)
        bad = {k: v for k, v in worst.items() if v > 0}
        check(not bad, f"two ranks against one process, past the bounds: "
              f"{dict(list(bad.items())[:5])}")
        out["one_process_loss"] = float(whole["loss"])
        out["max_param_diff"] = max(
            float((sa[k].double() - sb[k].double()).abs().max())
            for k in sa if not k.endswith(("running_mean", "running_var",
                                           "num_batches_tracked")))
    out["two_rank_step_ms"] = _timed_steps(
        mesh, lambda: step(tr.state, *local), DIST_TIMED_STEPS)
    if rank == 0:
        out["one_process_step_ms"] = _timed_steps(
            None, lambda: train_step(one, batch, mirror, cfg),
            DIST_TIMED_STEPS)
    barrier(mesh)
    lap("steps")
    out["profile"] = _profiled_step(lambda: step(tr.state, *local))
    lap("profile")
    return out


def _dist_nccl(mesh, workdir, lap):
    """Phase 14 (b): one rank over NCCL, one iteration, a step timed and
    profiled."""
    from alphazero_torch.models.convert import load_archive
    from alphazero_torch.parallel import shard_batch, sharded_train_step
    from alphazero_torch.train import Trainer

    check(mesh.backend == "nccl" and mesh.world == 1,
          f"mesh {mesh.backend} x {mesh.world}")
    dev = mesh.device
    cfg = _dist_config(workdir)
    tr = Trainer(cfg, seed=0, net=load_archive(ARCHIVE, device=dev),
                 device=dev, mesh=mesh)
    lap("trainer")
    it = _dist_iteration(tr)
    lap("iteration_1")
    check(tr.state.learn_calls == 1, f"learn_calls {tr.state.learn_calls}")
    src = tr._device_replay()
    idx = torch.arange(cfg.batch_size, device=dev) % len(tr.buffer)
    batch = shard_batch(mesh, tuple(t[idx] for t in src))
    mirror = idx % 2 == 0
    step = sharded_train_step(mesh, cfg)
    ms = _timed_steps(mesh, lambda: step(tr.state, batch, mirror),
                      1 + DIST_TIMED_STEPS)[1:]
    lap("steps")
    prof = _profiled_step(lambda: step(tr.state, batch, mirror))
    lap("profile")
    return {"rank": 0, "iterations": [it], "step_ms": ms, "profile": prof}


def dist_worker(rank, world, backend, port, workdir, t_launch):
    """A phase 14 worker: joins the group from ``torchrun``-style
    variables through ``init_distributed`` (LOCAL_RANK 0: both gloo ranks
    share the one card), runs its part and writes ``result_<rank>.json``
    with the seconds of its stages since ``t_launch``; exits non-zero on
    any failure."""
    seconds, lap = _stopwatch(t_launch)
    lap("start")
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.distributed as dist

    from alphazero_torch.parallel import make_mesh
    from alphazero_torch.utils import init_distributed

    init_distributed(backend=backend)
    try:
        mesh = make_mesh()
        lap("init")
        run = _dist_gloo if backend == "gloo" else _dist_nccl
        out = run(mesh, workdir, lap)
        out["seconds"] = seconds
        with open(os.path.join(workdir, f"result_{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def launch_workers(backend, world, workdir):
    """``world`` spawned ``dist_worker``s; fails the phase when one exits
    non-zero or the launch outlasts ``DIST_TIMEOUT`` (every worker is
    killed then). Returns their results by rank."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dist_worker,
                         args=(r, world, backend, port, workdir, time.time()))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + DIST_TIMEOUT
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.time()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    check(not alive, f"{backend} workers outlasted {DIST_TIMEOUT} s")
    codes = [p.exitcode for p in procs]
    check(codes == [0] * world, f"{backend} workers exited {codes}")
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"result_{r}.json")) as f:
            out.append(json.load(f))
    return out


@phase("phase 14 distributed trainer")
def phase_distributed(card, single_step_ms):
    """Two gloo ranks on the one card, then one NCCL rank; returns the
    launches of ``descend`` and ``commit_edges`` over all ranks."""
    import torch.distributed as dist

    check(dist.is_nccl_available(), "this PyTorch build has no NCCL")
    launches = {"descend": 0, "commit_edges": 0}
    summary = {"lanes_per_rank": DIST_LANES, "sims": TRAIN_SIMS,
               "global_batch": TRAIN_BATCH, "f32_tf32": False,
               "one_process_phase8_step_ms": single_step_ms, "card": card}
    for backend, world in (("gloo", 2), ("nccl", 1)):
        t0 = time.time()
        with tempfile.TemporaryDirectory() as tmp:
            res = launch_workers(backend, world, tmp)
        for r in res:
            for it in r["iterations"]:
                for k in launches:
                    launches[k] += it["launches"][k]
        summary[backend] = {"wall_s": time.time() - t0, "ranks": res}
    print("distributed " + json.dumps(summary), flush=True)
    return launches


def main(argv=None) -> int:
    """Runs every phase; ``python3 chip_smoke.py tower fused`` (any of
    kernels, search, cpu, graph, continuous, tower, fused, trainer, qconv,
    quant, arena, bench, web, dist) runs only those, for work on one of
    them, and then
    prints no ``kernels`` line (quant and arena run the qconv phase first,
    arena the quant phase)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from alphazero_torch import cuda_build

    only = set(sys.argv[1:] if argv is None else argv)
    want = lambda name: not only or name in only
    dev = torch.device("cuda")
    # float32 stays float32: no TF32 in cuDNN convs or in matmuls, for the
    # net's checks and for the trainer's steps alike
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from alphazero_torch.strength.common import device_line

    card = device_line(dev)
    t0 = time.time()
    libs = cuda_build.build(["tree_kernels", "tower_kernel", "qconv_kernel"])
    build_s = time.time() - t0
    print(f"[phase 0] card: {card}; torch {torch.__version__} (CUDA "
          f"{torch.version.cuda}); kernel build {build_s:.1f} s", flush=True)
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "(C7")):
                print(f"[phase 0] {lib.name}: {line.strip()}", flush=True)

    net = phase_network(dev)
    launches = {}
    if want("kernels"):
        err, times, bounds, kernel_launches = phase_kernels(dev)
    if want("tower"):
        tower_err, tower_t, tower_bound = phase_tower(dev, net)
    if want("search"):
        launches.update(phase_search(dev, net, card)[0])
    if want("cpu"):
        phase_card_vs_cpu(dev)
    if want("graph"):
        phase_graph(dev, net, card)
    if want("continuous"):
        phase_continuous(dev, net, card)
    if want("fused"):
        launches["tower_forward"] = phase_fused(dev, net, card)
    trainer_step_ms = None
    if want("trainer"):
        trainer_launches, trainer_step_ms = phase_trainer(dev, card)
    if want("qconv") or want("quant") or want("arena"):
        qconv_err, qconv_t, qconv_bound, qp, act = phase_qconv(dev, net)
    if want("quant") or want("arena"):
        quant_launches, evals, _ = phase_quant_search(dev, net, card, qp, act)
        launches["qconv3x3"] = quant_launches["qconv3x3"]
    if want("arena"):
        phase_arena(dev, evals, card)
    if want("bench"):
        phase_bench(card)
    if want("web"):
        web_launches = phase_web(dev, net, card)
    if want("dist"):
        dist_launches = phase_distributed(card, trainer_step_ms)

    if not only:
        # "launches" are the main path's own; fetch_rows is launched by the
        # plain descent that phase 1 holds descend against ("check_launches")
        # and nowhere on the search path
        on_path = ("descend", "commit_edges", "tower_forward", "qconv3x3")
        check(all(launches[k] > 0 for k in on_path)
              and all(v > 0 for v in trainer_launches.values())
              and all(v > 0 for v in web_launches.values())
              and all(v > 0 for v in dist_launches.values()),
              f"a kernel was not launched: {launches}, {trainer_launches}, "
              f"{web_launches}, {dist_launches}")
        src = "alphazero_torch/csrc/tree_kernels.cu"
        replaces = {"descend": "alphazero_tpu/search/kernels.py:50",
                    "fetch_rows": "alphazero_tpu/search/kernels.py:50",
                    "commit_edges": "alphazero_tpu/search/kernels.py:127"}
        kernels = [{
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": err[name], **times[name],
            "bound_ms": bounds[name], "bound_by": "bytes",
        } for name in ("descend", "fetch_rows", "commit_edges")]
        kernels[1]["check_launches"] = kernel_launches["fetch_rows"]
        # the web bot's path (phase 13), batch 1
        kernels[0]["web_launches"] = web_launches["descend"]
        kernels[2]["web_launches"] = web_launches["commit_edges"]
        # the distributed trainer's ranks (phase 14), all together
        kernels[0]["dist_launches"] = dist_launches["descend"]
        kernels[2]["dist_launches"] = dist_launches["commit_edges"]
        kernels.append({
            "name": "tower_forward", "route": "cuda",
            "source": "alphazero_torch/csrc/tower_kernel.cu",
            "replaces": "alphazero_tpu/models/fused.py:178",
            "launches": launches["tower_forward"],
            "max_abs_err": tower_err, **tower_t,
            "bound_ms": tower_bound[0], "bound_by": tower_bound[1]})
        # an XLA conv of the JAX package's int8 evaluator, not a Pallas
        # kernel; its path is phase 10's int8-static search
        kernels.append({
            "name": "qconv3x3", "route": "cuda",
            "source": "alphazero_torch/csrc/qconv_kernel.cu",
            "replaces": "alphazero_tpu/models/quant.py:84",
            "launches": launches["qconv3x3"], "max_abs_err": qconv_err,
            **qconv_t, "bound_ms": qconv_bound[0],
            "bound_by": qconv_bound[1]})
        print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
