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
- phase 2: the archived 20x128 net on the card against the CPU, and the
  bf16 search evaluator's forward (``models/inference.py``) on the card
  within ``BF16_LIMITS`` of the f32 net on the CPU;
- phase 6: the fused tower kernel (``wgmma`` on a ring of weight chunks
  in shared memory) against its plain version (1, 2 and 20 blocks, and
  every block alone) and against the layer-by-layer net, and its times at
  512 positions x 20 blocks beside its bound, its plain version and the
  bf16 net's tower blocks in eager mode;
- phase 16 (``epilogue``): the epilogue kernels of the evaluators'
  forwards (``csrc/epilogue_kernels.cu``) against their plain versions at
  every site of the archived net (the bf16 forward's 2 ``bn_act``, after
  the input and value convs, and 20 ``se_residual`` without an affine,
  each also with its block's BatchNorm, which the kernel still takes; the
  int8-static forward's 20 ``se_residual`` tails), at 512 boards and at
  the web bot's 1 and 2:
  ``bn_act`` bit-equal; ``se_residual`` against its plain version with
  float64 sums, every element within one bf16 step and at most
  ``epilogue.SE_UNEQUAL_SHARE`` of them unequal, and the same check at
  C 256 and H 32 (random maps and weights, 512 boards and one); their
  times beside their bounds, their plain versions, the launch floor and,
  for ``bn_act``, ``F.batch_norm`` and ``F.relu`` on channels-last maps;
  both ``se_residual`` tails also at 128 boards and at one, and the
  kernel's launch shape (grid, warpgroups, stages) at each batch;
- phase 17 (``conv``): the bf16 3x3 conv kernel (``conv3x3``,
  ``csrc/conv_kernels.cu``, ``wgmma`` with the BatchNorm as its epilogue)
  at every ``conv3x3`` site of one bf16 forward of the archived net (41:
  two a block and the policy conv) at 512 boards, the trainer's 128, the
  gates' 32 and the web bot's 1 and 2, in its three epilogues (none, affine, affine and ReLU): the conv
  against ``conv3x3_plain`` with float64 sums, every element within one
  bf16 step or, where the terms cancel, the float32 sum's bound beside it
  (``conv.card_check``), and at most ``max(2 x cuDNN's share,
  conv.CONV_UNEQUAL_SHARE)`` unequal, cuDNN's share measured on the same
  operands; each epilogue bit-equal to ``bn_act_plain`` of the conv
  alone; the smaller launches bit-equal to the 512-board launch's
  first boards, and one site's 512 boards each launched alone; the same
  at C 32 and 256 on random maps and weights; its ``ptxas`` report (no
  spill, no C75xx remark); its times at 512, 128, 32 and one boards, each
  in turns with ``F.conv2d`` (cuDNN, channels-last bf16) and beside its
  bound, and its plain version and the launch floor; then at C 256 every
  site of one 512-board forward of each C 256 net (the 20 x 256
  SE-ResNet, b28c512nbt, MuZero's h, g and f) on the persistent path,
  bit-equal in each epilogue to ``conv3x3_kernel<256, 128, 4>`` and each
  net's first site within ``conv.card_check``, and random maps at 512,
  384 and 268 boards timed in turns with cuDNN (at 512 also with the
  four-board launch) beside the bound;
- phase 3: the self-play search at full width (512 games x 800
  simulations) through ``selfplay_move`` on one tree: a warm-up move that
  captures the simulation, then one counted and timed move of 800
  replays, each one ``descend``, ``encode_planes``, ``expand`` and
  ``commit_edges`` launch and no read of the card, and each forward of
  the bf16 evaluator 41 ``conv3x3``, 2 ``bn_act`` and 20 ``se_residual``
  launches; then one eager search and one captured from the same
  position, timed and bit-equal; device kernels a forward; profiles of
  both, the captured one without cuDNN layout transposes or eager
  BatchNorm kernels, with 41 ``conv3x3_kernel`` a forward, at most two
  cuDNN convs (the input and value convs) and two memsets, and at most
  ``REST_LAUNCHES`` launches that are neither the port's hand kernels
  nor cuDNN's or cuBLAS's (every profile's kernels are so counted by
  class, launches and device ms);
- phase 4: the card's search against the CPU's;
- phase 15 (``graph``): the captured search against the eager one, trees
  bit-equal over two consecutive moves each: bf16 and int8-static at 512
  games x 64 simulations, the web bot's batch of one at 200 simulations
  under inference mode, the arena's pair evaluator with its context;
  captures, replays and the seconds of each move;
- phase 18 (``glue``): the simulation's glue kernels (``encode_planes``
  and ``expand``, ``csrc/tree_kernels.cu``) against their plain versions
  on the leaves of captured searches (48 simulations, with root noise)
  with the archive's bf16 and int8-static evaluators, at 512, 128, 32, 2
  and 1 games, tree reuse off and on (re-rooted trees), among them
  finished roots, terminal leaves, games that allocate nothing and
  policies with no legal mass: the planes, the leaf values, the depth sum
  and every field of the tree bit-equal; their times at 512 games and at
  one beside their byte bounds, their plain versions and the launch
  floor;
- phase 19 (``smolgen``): the encoder body's attention kernel
  (``smolgen_attention``, ``csrc/attention_kernels.cu``) at BT4's widths
  against its plain version, within the tolerance of its ``gpu`` test, on
  random operands at 1, 3, 32, 129 and 512 boards (3 and 129 leave a
  cluster's second board missing) and on the first layer's operands of a
  seeded BT4 net at 512 boards; its times at 512 boards beside its bound
  and its plain version, at 32 boards and one beside theirs (no slower than
  the design it replaced), and each half alone at 512 (builds with
  ``-DSMOLGEN_HALF``); the same for the fused DeepNorm
  residual and LayerNorm (``deepnorm_ln``, ``csrc/encoder_kernels.cu``)
  within ``encoder_epilogue.card_check``, on both sites of the seeded
  net's first layer, its times in turns with ``torch.add`` and
  ``F.layer_norm`` (its plain version, and the library's yardstick); the
  feed-forward's first product with its bias and Mish (``dense_mish``,
  the same source) within ``encoder_epilogue.dense_card_check`` on random
  operands at 1, 3, 32, 129 and 512 boards (N 1536 and 1024) and on the
  seeded net's feed-forward and policy embedding, its times on them at
  512, 32 and one board in turns with cuBLAS's ``addmm`` and PyTorch's
  ``mish`` (the pair it replaces) and with ``addmm`` alone, beside its
  bound (at 512 boards no more than 0.20 ms); a captured BT4 self-play
  move at 512 games x 400 simulations with the three kernels' launches
  counted (15, 30 and 16 a forward, no capture, no host read), and a
  profile of the captured search for their device time inside the
  replays;
- phase 20 (``nbt``): the nested-bottleneck body (KataGo's b28c512nbt,
  its norms set to one batch's statistics) at every site shape of a
  512-board forward: ``residual_act`` (C 256 and 512) and ``bn_act`` (C
  512, 256 and 64) bit-equal to their plain versions, ``gpool_bias`` (R
  192 | G 64 of 256, and the policy head's 64 | 64 of 128) within
  ``nbt_epilogue.gpool_card_check``, each timed in turns with its plain
  version beside its bound; a captured self-play move at 512 games x 400
  simulations with the launch counters zeroed just before it (84
  ``residual_act``, 10 ``gpool_bias``, 30 ``bn_act`` and 112 ``conv3x3``
  a forward, every ``conv3x3`` on its persistent path, no capture, no
  host read), and a profile of the captured
  search for both kernels' device time inside the replays;
- phase 21 (``muzero``): MuZero's board-game nets at the paper's widths
  (16 + 16 blocks of 256, the norms set to one batch's statistics): its
  two kernels at 512 boards, ``action_term`` over every action and
  ``latent_scale`` with its store write, bit-equal to their plain versions
  and timed beside their bounds; the four tree kernels of its search
  (``descend_latent``, ``gather_latent``, ``expand_latent``,
  ``commit_rewards``) on a searched tree bit-equal to their plain
  versions on the CPU; a captured 512 x 800 self-play move against the
  eager one from the same state (trees, stores and launches equal), with
  the launch counters zeroed before it (34 ``conv3x3``, all on its
  persistent path, 16 ``residual_act``, one ``action_term`` and one
  ``latent_scale`` a simulation, no capture in the counted move, no host
  read), and a
  profile of the captured search;
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
  launches and 201 forwards' ``conv3x3``, ``bn_act`` and ``se_residual``
  launches
  (their sums go into the ``kernels`` line as ``web_launches``); the
  seconds of both players' moves; then the bot's
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
import types

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

    lib = K.LIB
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
    from alphazero_torch.models import inference
    from alphazero_torch.models.convert import load_archive
    from alphazero_torch.models.network import count_params

    net_cpu = load_archive(ARCHIVE, device="cpu")
    n_params = count_params(net_cpu)
    check(n_params == 8_027_970, f"count_params {n_params}")
    net = copy.deepcopy(net_cpu).to(dev)
    # the bf16 search evaluator's forward (models/inference.py: NHWC, the
    # conv3x3 kernel with its BatchNorm epilogue, the epilogue kernels,
    # cuDNN for the input and value convs)
    prep = inference.prepare_inference(net, torch.bfloat16)
    planes = env.encoded_state(random_positions(64, 11))
    with torch.no_grad():
        p32, w32 = net_cpu(planes)
        pc, wc = (t.cpu() for t in net(planes.to(dev)))
        p16, w16 = (t.cpu() for t in inference.inference_apply(
            prep, planes.to(dev)))
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
          f"evaluator's forward on the card max |d logit| {dl:.4f}, |d "
          f"prob| {dp:.5f}, |d value| {dv:.5f} (limits {BF16_LIMITS})",
          flush=True)
    return net


# -----------------------------------------------------------------------------
# Phase 3: the main path, full-width self-play search
# -----------------------------------------------------------------------------

@phase("phase 3 full-width search")
def phase_search(dev, net, card):
    from alphazero_torch.config import Config
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.models import conv, epilogue, fused
    from alphazero_torch.search import graph
    from alphazero_torch.search import kernels as K
    from alphazero_torch.search import mcts
    from alphazero_torch.train import selfplay

    cfg = Config(num_simulations=SIMS, parallel_games=GAMES)
    eval_fn = mcts.make_net_evaluator(net, getattr(torch, cfg.inference_dtype))
    n_conv, n_bn, n_tail, n_tower = bf16_forward_launches(net, GAMES)
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
    K.encode_planes.launches = 0
    K.expand.launches = 0
    conv.conv3x3.launches = 0
    conv.conv3x3.persistent.launches = 0
    epilogue.bn_act.launches = 0
    epilogue.se_residual.launches = 0
    fused.tower_forward.launches = 0
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
                "commit_edges": K.commit_edges.launches,
                "encode_planes": K.encode_planes.launches,
                "expand": K.expand.launches,
                "conv3x3": conv.conv3x3.launches,
                "conv3x3_persistent": conv.conv3x3.persistent.launches,
                "bn_act": epilogue.bn_act.launches,
                "se_residual": epilogue.se_residual.launches,
                "tower_forward": fused.tower_forward.launches}
    check(launches["conv3x3_persistent"] == 0,
          f"{launches}: a C 128 forward took conv3x3's persistent path")
    check(launches["descend"] > 0 and launches["commit_edges"] > 0,
          f"a kernel was not launched on the main path: {launches}")
    # the root's evaluation and one a simulation, replays counted
    check(launches["conv3x3"] == n_conv * moves * (SIMS + 1)
          and launches["bn_act"] == n_bn * moves * (SIMS + 1)
          and launches["se_residual"] == n_tail * moves * (SIMS + 1)
          and launches["tower_forward"] == n_tower * moves * (SIMS + 1),
          f"{launches}: the bf16 evaluator's forward is {n_conv} conv3x3, "
          f"{n_bn} bn_act, {n_tail} se_residual and {n_tower} "
          f"tower_forward launches")
    st = mcts.STATS
    check(launches["descend"] == launches["commit_edges"] == moves * SIMS
          == launches["encode_planes"] == launches["expand"]
          == st.simulations == graph.STATS.replays
          and graph.STATS.captures == 0 and st.levels == 0
          and launches["fetch_rows"] == 0,
          f"{launches}, {st.levels} host-read levels, "
          f"{graph.STATS.captures} captures and {graph.STATS.replays} "
          f"replays for {moves * SIMS} simulations: a simulation is one "
          f"replay, one descend, encode_planes, expand and commit_edges "
          f"launch each, no host read")
    depth = st.depth_sum / (st.simulations * GAMES)
    out = {
        "games": GAMES, "sims": SIMS, "moves": moves,
        "sims_per_s": live * SIMS / dt, "move_s": dt / moves,
        "mean_edge_depth": depth,
        "launches_per_move": {k: v / moves for k, v in launches.items()},
        "levels_per_sim": st.levels / st.simulations,
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
    out["launches_per_forward"] = launches_per_forward(
        eval_fn, env.encoded_state(random_positions(GAMES, 71)).to(dev))
    print("main path " + json.dumps(out), flush=True)
    out["profile"] = {mode: profile_search(states, eval_fn, capture=c,
                                           tag=f"{GAMES}_{mode}")
                      for mode, c in (("captured", None), ("eager", False))}
    # the forward keeps NHWC and runs its BatchNorms in conv3x3 and bn_act:
    # no layout transposes and no eager BatchNorm are left; cuDNN runs the
    # input and value convs alone, each with its memset
    captured = out["profile"]["captured"]
    left = sorted(k for k in captured["kernels_ms"]
                  if any(w in k for w in LAYOUT_KERNELS))
    check(not left, f"the bf16 captured profile runs {left}")
    forwards = PROFILE_SIMS + 1
    calls = captured["kernel_calls"]
    cudnn = {k: n for k, n in calls.items() if is_library_conv(k)}
    helpers = sum(n for k, n in calls.items()
                  if "cudnn" in k.lower() and k not in cudnn)
    memsets = sum(n for k, n in calls.items() if "Memset" in k)
    ours = sum(n for k, n in calls.items() if "conv3x3_kernel" in k)
    towers = sum(n for k, n in calls.items() if "tower_kernel" in k)
    rest = captured["classes"]["rest"]["launches"]
    check(rest <= REST_LAUNCHES,
          f"the bf16 captured profile of {PROFILE_SIMS} simulations runs "
          f"{rest} launches that are neither hand kernels nor cuDNN's or "
          f"cuBLAS's, more than {REST_LAUNCHES}")
    out["profile_convs"] = {"conv3x3": ours, "tower": towers,
                            "cudnn": sum(cudnn.values()),
                            "cudnn_helpers": helpers, "memset": memsets,
                            "forwards": forwards}
    check(ours == n_conv * forwards and towers == n_tower * forwards
          and sum(cudnn.values()) <= 2 * forwards
          and memsets <= 2 * forwards,
          f"captured profile of {forwards} forwards: {ours} conv3x3_kernel, "
          f"{towers} tower_kernel, "
          f"cuDNN convs {cudnn}, {memsets} memsets (at most two a forward: "
          f"the input and value convs)")
    print(f"bf16 captured profile: {out['launches_per_forward']} device "
          f"kernels a forward; none of {LAYOUT_KERNELS}; over {forwards} "
          f"forwards {ours} conv3x3_kernel, {sum(cudnn.values())} cuDNN "
          f"convs ({sorted(cudnn)}), {helpers} other cuDNN kernels, "
          f"{memsets} memsets", flush=True)
    return launches, out


def bf16_forward_launches(net, B):
    """Launches of one bf16 forward of ``net`` at B boards on the card:
    (conv3x3, bn_act, se_residual, tower_forward). Both routes of the tower
    run ``bn_act`` after the input and value convs and ``conv3x3`` for the
    policy head, each with its BatchNorm; the tower is one
    ``tower_forward`` where ``inference.fused_tower`` takes the batch, else
    ``conv3x3`` twice a block and a tail a block."""
    from alphazero_torch.models import inference

    n = len(net.blocks)
    if inference.fused_tower(inference.prepare_inference(net), B):
        return 1, 2, 0, 1
    return 2 * n + 1, 2, n, 0


STAGES = ("mcts.descend", "mcts.evaluate", "mcts.expand", "mcts.backprop")
# kernels the bf16 forward ran before it kept NHWC and fused its BatchNorms
LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw", "batch_norm_transform_input")
PROFILE_SIMS = 16


def is_library_conv(name):
    """A cuDNN convolution's compute kernel, by its name (not its helpers,
    such as the padding kernel cuDNN runs before the input conv)."""
    low = name.lower()
    return "conv3x3_kernel" not in low and any(
        w in low for w in ("implicit_gemm", "fprop", "convolve"))


# words of cuDNN's and cuBLAS's kernels (the helpers and memsets of cuDNN's
# convs among them), by name; the port's own are cuda_build.kernel_names()
LIBRARY_WORDS = ("cudnn", "cublas", "nvjet", "cutlass", "gemm", "fprop",
                 "nhwcaddpadding", "memset")
# phase 3: the bf16 captured profile's launches that are neither the port's
# hand kernels nor cuDNN's or cuBLAS's, at most (16 simulations and the
# root's eager expansion; 1,304 before expand and encode_planes)
REST_LAUNCHES = 300


def launch_classes(kernel_calls, kernels_ms, sims):
    """A profile's device kernels in three classes, launches and device ms
    each: the port's hand kernels, the libraries' (cuDNN, cuBLAS), and the
    rest (PyTorch's own elementwise, reduction and copy kernels), with the
    rest's launches per simulation."""
    from alphazero_torch.cuda_build import kernel_names

    hand = kernel_names()
    out = {c: {"launches": 0, "ms": 0.0} for c in ("hand", "library", "rest")}
    for key, n in kernel_calls.items():
        low = key.lower()
        c = ("hand" if any(k in key for k in hand) else
             "library" if any(w in low for w in LIBRARY_WORDS) else "rest")
        out[c]["launches"] += n
        out[c]["ms"] += kernels_ms[key]
    out["rest_launches_per_sim"] = out["rest"]["launches"] / sims
    return out


def profile_search(states, eval_fn, sims=PROFILE_SIMS, tag=None,
                   capture=None):
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
    classes = launch_classes({key: c for _, key, c in kern},
                             {key: us / 1e3 for us, key, _ in kern}, sims)
    by_class = ", ".join(f"{c} {classes[c]['launches']} launches "
                         f"{classes[c]['ms']:.3f} ms"
                         for c in ("hand", "library", "rest"))
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
        f.write(f"by class: {by_class}; rest "
                f"{classes['rest_launches_per_sim']:.2f} launches/sim\n")
        for us, key, count in kern:
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
          f"them {sync_ms:.3f} ms/sim; by class: {by_class}; top "
          f"kernels: {top}", flush=True)
    return {"wall_s": wall, "busy_s": busy, "idle_share": 1 - busy / wall,
            "classes": classes,
            "host_ms_per_sim": host * 1e3 / sims,
            "stages_host_device_ms_per_sim": stage,
            "kernels_ms": {key: us / 1e3 for us, key, _ in kern},
            "kernel_calls": {key: count for _, key, count in kern}}


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
    from alphazero_torch.models import conv
    from alphazero_torch.search import graph
    from alphazero_torch.search import kernels as K
    from alphazero_torch.search import mcts
    from alphazero_torch.train import selfplay

    cfg = Config(num_simulations=CONT_SIMS, parallel_games=CONT_LANES)
    eval_fn = mcts.make_net_evaluator(net, getattr(torch, cfg.inference_dtype))
    gen = torch.Generator(device=dev).manual_seed(2)
    conv.conv3x3.launches = 0
    K.fetch_rows.launches = 0
    K.descend.launches = 0
    K.commit_edges.launches = 0
    K.encode_planes.launches = 0
    K.expand.launches = 0
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
          == K.encode_planes.launches == K.expand.launches
          and st.levels == 0 and K.fetch_rows.launches == 0
          and graph.STATS.captures == 1,
          f"{K.descend.launches} descend, {K.commit_edges.launches} "
          f"commit_edges, {K.fetch_rows.launches} fetch_rows launches, "
          f"{st.levels} host-read levels and {graph.STATS.captures} captures "
          f"for {st.simulations} simulations: a simulation is one descend, "
          f"encode_planes, expand and commit_edges launch each and no host "
          f"read, and the run's one tree is captured once")
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
           "levels_per_sim": st.levels / st.simulations,
           "captures": graph.STATS.captures,
           "capture_s": graph.STATS.capture_s,
           "replays": graph.STATS.replays,
           "launches_per_sim": {
               "descend": K.descend.launches / st.simulations,
               "commit_edges": K.commit_edges.launches / st.simulations,
               "encode_planes": K.encode_planes.launches / st.simulations,
               "expand": K.expand.launches / st.simulations},
           "conv3x3_launches": conv.conv3x3.launches,
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
    from alphazero_torch.models import conv
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
        conv.conv3x3.launches = 0
        K.fetch_rows.launches = 0
        K.descend.launches = 0
        K.commit_edges.launches = 0
        K.encode_planes.launches = 0
        K.expand.launches = 0
        mcts.STATS.reset()
        graph.STATS.reset()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        metrics = [tr.run_iteration() for _ in range(2)]
        launches = {"descend": K.descend.launches,
                    "commit_edges": K.commit_edges.launches,
                    "encode_planes": K.encode_planes.launches,
                    "expand": K.expand.launches,
                    "conv3x3": conv.conv3x3.launches}
        st = mcts.STATS
        check(all(v > 0 for v in launches.values()),
              f"the trainer's self-play did not launch both kernels: "
              f"{launches}")
        check(launches["descend"] == launches["commit_edges"]
              == launches["encode_planes"] == launches["expand"]
              == st.simulations and st.levels == 0
              and K.fetch_rows.launches == 0 and graph.STATS.captures == 2,
              f"{launches}, {K.fetch_rows.launches} fetch_rows launches, "
              f"{st.levels} host-read levels and {graph.STATS.captures} "
              f"captures for {st.simulations} simulations: a simulation is "
              f"one descend, encode_planes, expand and commit_edges launch "
              f"each and no host read, and each iteration's new evaluator "
              f"one capture")
        search_stats = {
            "simulations": st.simulations,
            "levels_per_sim": st.levels / st.simulations,
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
# Phase 16: the epilogue kernels of the evaluators' forwards
# -----------------------------------------------------------------------------

EPILOGUE_BATCHES = (GAMES, 1, 2)   # the main path's, and the web bot's
F32_OPS_PER_S = 67e12              # H100 SXM data sheet, f32 (no tensor cores)


def epilogue_bound_ms(kind, B, C, H=0, affine=True):
    """The least time the card could take for one ``bn_act`` or
    ``se_residual`` of B boards: its bytes (each map read once and written
    once, the float32 BatchNorm constants and the bf16 SE weights once) at
    the memory rate, or its float32 operations (bn_act: subtract, multiply,
    add and ReLU an element; se_residual: the affine's three, the pool's
    add, the multiply, two adds and ReLU an element, and the SE's dense
    layers, bias adds and sigmoid a board) at the rate outside the tensor
    cores, whichever is larger."""
    n = B * 64 * C
    consts = 3 * C * 4 if affine else 0
    if kind == "bn_act":
        nbytes, ops = 2 * n * 2 + consts, 4 * n
    else:
        nbytes = 3 * n * 2 + consts + 2 * (3 * C * H + H + 2 * C)
        ops = (n * ((3 if affine else 0) + 5)
               + B * (2 * C * H + 2 * H * 2 * C + 3 * H + 8 * C))
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations"), nbytes, ops


@phase("phase 16 epilogue kernels")
def phase_epilogue(dev, net):
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.models import epilogue, inference, quant
    from alphazero_torch.search import kernels as K
    from alphazero_torch.strength.common import calibration_batches

    kinds = ("bn_act", "se_residual")
    real = {k: getattr(epilogue, k) for k in kinds}
    plain = {"bn_act": epilogue.bn_act_plain,
             "se_residual": epilogue.se_residual_plain}
    # what each kernel is held to: the plain version, for se_residual with
    # its sums in float64 (rounded where the plain version rounds)
    reference = {"bn_act": epilogue.bn_act_plain,
                 "se_residual": lambda *a: epilogue.se_residual_plain(
                     *a, f64_sums=True)}
    # the inputs of every epilogue of the archived net in one forward of
    # each evaluator: bf16 (2 bn_act, after the input and value convs, and
    # 20 se_residual with no affine: bn2 is conv3x3's epilogue) and
    # int8-static (20 se_residual, no affine); the bf16 forward on its
    # per-layer route (no fused tower's operands), which the bot's batch and
    # C 256 take
    planes = env.encoded_state(random_positions(GAMES, 81)).to(dev)
    prep = {**inference.prepare_inference(net, torch.bfloat16), "tower": None}
    qp = quant.quantize_network(net)
    int8 = quant.make_quant_evaluator(net, qp=qp, act_scales=quant.calibrate(
        qp, calibration_batches(ARCHIVE, dev)[0]))
    sites = []

    def recorder(path, kind):
        def record(*args):
            sites.append((path, kind, args))
            return real[kind](*args)
        return record

    # the two forwards reach the wrappers as attributes of their modules'
    # ``epilogue``: a stand-in records each call's inputs and passes it on
    for path, run in (("bf16", lambda: inference.inference_apply(prep,
                                                                   planes)),
                      ("int8", lambda: int8(planes))):
        stand_in = types.SimpleNamespace(**{k: recorder(path, k)
                                            for k in kinds})
        inference.epilogue = quant.epilogue = stand_in
        try:
            run()
        finally:
            inference.epilogue = quant.epilogue = epilogue
    n_blocks = len(net.blocks)
    count = {(p, k): sum(1 for s in sites if s[:2] == (p, k))
             for p in ("bf16", "int8") for k in kinds}
    check(count == {("bf16", "bn_act"): 2,
                    ("bf16", "se_residual"): n_blocks,
                    ("int8", "bn_act"): 0, ("int8", "se_residual"): n_blocks},
          f"epilogue sites of the two forwards: {count}")
    # the affine the kernel still takes (se_residual's bn), held at the
    # net's sites as before: each bf16 tail's inputs with its block's bn2
    tails = [s[2] for s in sites if s[:2] == ("bf16", "se_residual")]
    sites += [("bf16+bn2", "se_residual", tuple(args) + (b["bn2"],))
              for args, b in zip(tails, prep["blocks"])]

    # each site at 512 boards and at the web bot's 1 and 2: bn_act
    # bit-equal; se_residual each element within one bf16 step and at most
    # SE_UNEQUAL_SHARE of them unequal
    err = {k: 0.0 for k in kinds}
    unequal = {k: 0 for k in kinds}
    elements = {k: 0 for k in kinds}
    steps = {k: 0.0 for k in kinds}
    for path, kind, args in sites:
        maps = 2 if kind == "se_residual" else 1
        for B in EPILOGUE_BATCHES:
            a = tuple(t[:B].contiguous() if i < maps else t
                      for i, t in enumerate(args))
            got, want = real[kind](*a), reference[kind](*a)
            torch.cuda.synchronize()
            err[kind] = max(err[kind], float(
                (got.float() - want.float()).abs().max()))
            unequal[kind] += int((got != want).sum())
            elements[kind] += got.numel()
            steps[kind] = max(steps[kind], float(
                epilogue.steps_apart(got, want).max()))
    share = unequal["se_residual"] / elements["se_residual"]
    check(unequal["bn_act"] == 0, f"bn_act differs from bn_act_plain in "
                                  f"{unequal['bn_act']} elements")
    check(steps["se_residual"] <= 1.0 and share <= epilogue.SE_UNEQUAL_SHARE,
          f"se_residual against its plain version with float64 sums: "
          f"{unequal['se_residual']} of {elements['se_residual']} elements "
          f"unequal (at most {epilogue.SE_UNEQUAL_SHARE} of them), up to "
          f"{steps['se_residual']} bf16 steps apart (at most 1)")
    print(f"epilogue kernels against their plain versions at "
          f"{len(sites)} sites x {EPILOGUE_BATCHES} boards: bn_act "
          f"bit-equal ({elements['bn_act']} elements); se_residual "
          f"against float64 sums {unequal['se_residual']} of "
          f"{elements['se_residual']} elements unequal, up to "
          f"{steps['se_residual']} bf16 steps, max |d| "
          f"{err['se_residual']}", flush=True)

    # times at 512 boards (and at 1) of block 0's sites; yardsticks the
    # path never calls: F.batch_norm (channels-last, f32 statistics) then
    # F.relu for bn_act; no one PyTorch call computes se_residual
    # the input's bn_act; block 0's tail with its bn2, the form the
    # kernel's earlier times took (the bf16 tail without it: bf16_tail_)
    bn_args = next(s[2] for s in sites if s[:2] == ("bf16", "bn_act"))
    tail_args = next(s[2] for s in sites if s[0] == "bf16+bn2")
    bf16_tail = tail_args[:4]
    int8_tail = next(s[2] for s in sites if s[0] == "int8")
    m = net.input_bn
    y_cl = bn_args[0].permute(0, 3, 1, 2)              # channels-last view
    library = lambda i: torch.nn.functional.relu(
        torch.nn.functional.batch_norm(y_cl, m.running_mean, m.running_var,
                                       m.weight, m.bias, False, 0.0, m.eps))
    lib_out = library(0).permute(0, 2, 3, 1).float()
    ker_out = real["bn_act"](*bn_args).float()
    check(bool(((lib_out - ker_out).abs()
                <= 2.0 ** -6 * ker_out.abs() + 2.0 ** -12).all()),
          "F.batch_norm + F.relu does not compute bn_act's function")
    lib = K.LIB
    stream = torch.cuda.current_stream(dev).cuda_stream
    floor = {"floor_ms": cuda_ms(lambda i: lib.launch_floor(stream),
                                 what="launch floor"),
             "floor_call_ms": cuda_ms(lambda i: lib.launch_floor(stream),
                                      queued=False)}
    out = {}
    for kind, args, n_maps in (("bn_act", bn_args, 1),
                               ("se_residual", tail_args, 2)):
        b1 = tuple(t[:1].contiguous() if i < n_maps else t
                   for i, t in enumerate(args))
        t = {"ms": cuda_ms(lambda i: real[kind](*args), what=kind),
             "call_ms": cuda_ms(lambda i: real[kind](*args), queued=False),
             "plain_ms": cuda_ms(lambda i: plain[kind](*args), iters=20,
                                 what=f"{kind} plain"),
             "plain_call_ms": cuda_ms(lambda i: plain[kind](*args),
                                      iters=20, queued=False),
             "b1_ms": cuda_ms(lambda i: real[kind](*b1), what=kind),
             "b1_call_ms": cuda_ms(lambda i: real[kind](*b1), queued=False),
             **floor}
        C = args[0].shape[3]
        H = args[2][0].shape[1] if kind == "se_residual" else 0
        bound, by, nbytes, ops = epilogue_bound_ms(kind, GAMES, C, H)
        t.update(bound_ms=bound, bound_by=by, bytes=nbytes, operations=ops,
                 b1_bound_ms=epilogue_bound_ms(kind, 1, C, H)[0],
                 max_abs_err=err[kind])
        out[kind] = t
    out["bn_act"]["library_ms"] = cuda_ms(library, what="F.batch_norm+relu")
    out["bn_act"]["library_call_ms"] = cuda_ms(library, queued=False)
    out["se_residual"]["library_ms"] = None
    C, H = int8_tail[0].shape[3], int8_tail[2][0].shape[1]
    out["se_residual"].update(
        int8_ms=cuda_ms(lambda i: real["se_residual"](*int8_tail),
                        what="se_residual int8"),
        bf16_tail_ms=cuda_ms(lambda i: real["se_residual"](*bf16_tail),
                             what="se_residual bf16 tail"),
        int8_bound_ms=epilogue_bound_ms("se_residual", GAMES, C, H,
                                        affine=False)[0],
        unequal=unequal["se_residual"], elements=elements["se_residual"],
        max_steps=steps["se_residual"])
    # both tails at the continuous self-play and trainer lanes' 128 boards
    # and at the web bot's one (bn2 at one board is timed above), beside
    # their bounds, with the launch shape each took
    sms = epilogue.LIB.multiprocessors(dev)
    se = out["se_residual"]
    se["shape"] = epilogue.se_launch_shape(GAMES, C, H, sms)
    for B in (128, 1):
        se[f"b{B}_shape"] = epilogue.se_launch_shape(B, C, H, sms)
        for tag, args, affine in (("", tail_args, True),
                                  ("int8_", int8_tail, False)):
            if f"{tag}b{B}_ms" in se:
                continue
            a = tuple(t[:B].contiguous() if i < 2 else t
                      for i, t in enumerate(args))
            se[f"{tag}b{B}_ms"] = cuda_ms(
                lambda i: real["se_residual"](*a), what=f"se_residual {B}")
            se[f"{tag}b{B}_bound_ms"] = epilogue_bound_ms(
                "se_residual", B, C, H, affine=affine)[0]
    se["wide"] = wide_se_check(dev, sms)
    print(f"epilogue kernels at {GAMES} boards, C 128 (se_residual with "
          f"block 0's bn2; bf16_tail_: the bf16 path's tail, no affine; "
          f"int8_: the int8 tail, no affine; b1_, b128_: one and 128 boards; "
          f"wide: C 256, H 32): {json.dumps(out)}", flush=True)
    print(f"se_residual launch shapes (grid, warpgroups, stages, shared "
          f"bytes): {GAMES} boards {se['shape']}, 128 {se['b128_shape']}, "
          f"1 {se['b1_shape']}; C 256 {se['wide']['shape']}", flush=True)
    return out


WIDE_C, WIDE_H = 256, 32          # 256 filters at se_ratio 8


def wide_se_check(dev, sms):
    """``se_residual`` at C 256 and H 32 on random maps and weights from a
    seed, with and without the BatchNorm, at 512 boards and at one, held
    as at the net's sites: every element within one bf16 step of the plain
    version with float64 sums, at most ``SE_UNEQUAL_SHARE`` unequal; and
    its time at 512 boards beside its bound."""
    from alphazero_torch.models import epilogue

    g = torch.Generator().manual_seed(256)
    C, H = WIDE_C, WIDE_H
    w = lambda *s: (torch.randn(s, generator=g) * 0.3).to(dev,
                                                          torch.bfloat16)
    y = (torch.randn((GAMES, 8, 8, C), generator=g) * 2).to(
        dev, torch.bfloat16)
    x = torch.randn((GAMES, 8, 8, C), generator=g).relu().to(
        dev, torch.bfloat16)
    fc1, fc2 = (w(C, H), w(H)), (w(H, 2 * C), w(2 * C))
    var = torch.rand(C, generator=g) * 3 + 0.05
    bn = tuple(t.to(dev) for t in (
        torch.randn(C, generator=g) * 0.5,
        torch.rsqrt(var + 1e-5) * (torch.randn(C, generator=g) * 0.5 + 1),
        torch.randn(C, generator=g)))
    unequal = elements = 0
    steps = 0.0
    for affine in (bn, None):
        for B in (GAMES, 1):
            a = (y[:B].contiguous(), x[:B].contiguous(), fc1, fc2, affine)
            got = epilogue.se_residual(*a)
            want = epilogue.se_residual_plain(*a, f64_sums=True)
            torch.cuda.synchronize()
            unequal += int((got != want).sum())
            elements += got.numel()
            steps = max(steps, float(epilogue.steps_apart(got, want).max()))
    check(steps <= 1.0 and unequal <= epilogue.SE_UNEQUAL_SHARE * elements,
          f"se_residual at C {C}, H {H} against its plain version with "
          f"float64 sums: {unequal} of {elements} elements unequal, up to "
          f"{steps} bf16 steps apart")
    return {"unequal": unequal, "elements": elements, "max_steps": steps,
            "ms": cuda_ms(lambda i: epilogue.se_residual(y, x, fc1, fc2, bn),
                          what="se_residual C 256"),
            "bound_ms": epilogue_bound_ms("se_residual", GAMES, C, H)[0],
            "shape": epilogue.se_launch_shape(GAMES, C, H, sms)}


# -----------------------------------------------------------------------------
# Phase 17: the bf16 evaluator's 3x3 convolutions on conv3x3_kernel
# -----------------------------------------------------------------------------

# the main path's, the trainer's, the gates', the web bot's, and two
CONV_BATCHES = (GAMES, 128, 32, 1, 2)
CONV_TIMED = (GAMES, 128, 32, 1)   # timed in turns with cuDNN
CONV_WIDE = (32, 256)              # the other widths the kernel takes


def conv_bound_ms(B, C, affine=True):
    """The least time the card could take for one ``conv3x3`` of B boards
    at width C: its bytes (the map read once and written once, the bf16
    weights and the float32 BatchNorm constants once) at the memory rate,
    or its bf16 operations (two per multiply-add) at the dense bf16 rate,
    whichever is larger."""
    n = B * 64 * C
    nbytes = 2 * n * 2 + 9 * C * C * 2 + (3 * C * 4 if affine else 0)
    ops = 2 * n * 9 * C
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / BF16_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations"), nbytes, ops


def conv_sites(prep, planes):
    """(x, w, bn, relu, image) of every ``conv3x3`` call of one bf16
    forward on the per-layer route (``prep`` without the fused tower's
    operands), at any batch: the forward reaches the wrapper as
    ``inference.cv.conv3x3``, and a stand-in records each call's inputs
    and passes it on."""
    from alphazero_torch.models import conv, inference

    sites = []

    def record(x, w, bn=None, relu=False, image=None):
        sites.append((x, w, bn, relu, image))
        return conv.conv3x3(x, w, bn, relu, image)

    inference.cv = types.SimpleNamespace(conv3x3=record)
    try:
        inference.inference_apply({**prep, "tower": None}, planes)
    finally:
        inference.cv = conv
    return sites


def conv_site_check(x, w, bn, image, full=None):
    """One site at ``x``'s boards: ``conv3x3`` in its three epilogues,
    ``conv.card_check``'s counts, cuDNN's (``F.conv2d`` on the same
    channels-last bf16 operands) against the same float64 sums, and, given
    the 512-board launch's outputs ``full``, the boards that differ from
    its first boards."""
    from alphazero_torch.models import conv, epilogue

    outs = {k: conv.conv3x3(x, w, bn if affine else None, relu, image)
            for k, (affine, relu) in conv.EPILOGUES.items()}
    torch.cuda.synchronize()
    r = conv.card_check(x, w, bn, outs, 1.0)
    ref = conv.conv3x3_plain(x, w, f64_sums=True)
    cudnn = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w,
                                       padding=1).permute(0, 2, 3, 1)
    r["cudnn_unequal"] = int((cudnn != ref).sum())
    r["cudnn_beyond_one_step"] = int(
        (epilogue.steps_apart(cudnn, ref) > 1).sum())
    plain = conv.conv3x3_plain(x, w, bn, True, f64_sums=True)
    r["max_abs_err"] = float((outs["affine_relu"].float() - plain.float())
                             .abs().max())
    B = x.shape[0]
    r["batch_unequal"] = 0 if full is None else sum(
        int((outs[k] != full[k][:B]).sum()) for k in outs)
    return r, outs


def add_counts(total, r):
    for k, v in r.items():
        if k in ("max_steps", "max_abs_err"):
            total[k] = max(total.get(k, 0.0), v)
        elif k != "ok":
            total[k] = total.get(k, 0) + v


def conv_verdict(total, what):
    """``conv.card_check``'s rule on counts summed over sites: nothing
    outside the float32 bound, at most ``max(2 x cuDNN's share,
    CONV_UNEQUAL_SHARE)`` unequal, epilogues and batches bit-equal."""
    from alphazero_torch.models import conv

    share = total["unequal"] / total["elements"]
    cudnn_share = total["cudnn_unequal"] / total["elements"]
    limit = max(2 * cudnn_share, conv.CONV_UNEQUAL_SHARE)
    total.update(share=share, cudnn_share=cudnn_share, limit=limit)
    check(total["outside_bound"] == 0 and share <= limit
          and total["epilogue_unequal"] == 0
          and total["batch_unequal"] == 0,
          f"conv3x3 against its plain version with float64 sums {what}: "
          f"{json.dumps(total)} (unequal share at most {limit}; none "
          f"outside the f32 bound; epilogues and batches bit-equal)")
    return total


@phase("phase 17 conv kernel")
def phase_conv(dev, net):
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.models import conv, inference
    from alphazero_torch.search import kernels as K

    lines = ptxas_lines("conv_kernels", "conv3x3_kernel")
    for line in lines:
        print(f"[phase 17] ptxas: {line}", flush=True)
    check(len(lines) >= 6 and not any("(C7" in l for l in lines)
          and all(" 0 bytes spill stores, 0 bytes spill loads" in l
                  for l in lines if "spill" in l),
          "conv3x3_kernel's ptxas report shows a spill or a C75xx remark")

    # every conv3x3 site of one bf16 forward of 512 random-play positions
    prep = inference.prepare_inference(net, torch.bfloat16)
    planes = env.encoded_state(random_positions(GAMES, 81)).to(dev)
    sites = conv_sites(prep, planes)
    check(len(sites) == 2 * len(net.blocks) + 1,
          f"{len(sites)} conv3x3 sites in a forward")
    total = {}
    for x, w, bn, _, image in sites:
        full = None
        for B in CONV_BATCHES:
            r, outs = conv_site_check(x[:B].contiguous(), w, bn, image, full)
            if full is None:
                full = outs
            add_counts(total, r)
    conv_verdict(total, f"at {len(sites)} sites x {CONV_BATCHES} boards")
    # one site's every board alone against the 512-board launch
    x, w, bn, relu, image = sites[0]
    got = conv.conv3x3(x, w, bn, relu, image)
    alone = torch.cat([conv.conv3x3(x[b:b + 1].contiguous(), w, bn, relu,
                                    image) for b in range(GAMES)])
    check(torch.equal(got, alone), "a board of the 512-board launch differs "
                                   "from the same board launched alone")
    print(f"conv3x3 against its plain version with float64 sums at "
          f"{len(sites)} sites x {CONV_BATCHES} boards, three epilogues: "
          f"{json.dumps(total)}; block 0's conv1 at {GAMES} boards "
          f"bit-equal to each board alone", flush=True)

    # the other widths on random maps and weights from a seed
    g = torch.Generator().manual_seed(17)
    wide = {}
    for C in CONV_WIDE:
        x = torch.randn((GAMES, 8, 8, C), generator=g).to(dev, torch.bfloat16)
        w = (torch.randn((C, C, 3, 3), generator=g) * (9 * C) ** -0.5).to(
            dev, torch.bfloat16, memory_format=torch.channels_last)
        var = torch.rand(C, generator=g) * 3 + 0.05
        bn = tuple(t.to(dev) for t in (
            torch.randn(C, generator=g) * 0.5,
            torch.rsqrt(var + 1e-5) * (torch.randn(C, generator=g) * 0.5 + 1),
            torch.randn(C, generator=g)))
        image = conv.weight_image(w)
        t, full = {}, None
        for B in (GAMES, 1):
            r, outs = conv_site_check(x[:B].contiguous(), w, bn, image, full)
            if full is None:
                full = outs
            add_counts(t, r)
        conv_verdict(t, f"at C {C}, {GAMES} and 1 boards")
        t["ms"] = cuda_ms(lambda i: conv.conv3x3(x, w, bn, True, image),
                          what=f"conv3x3 C {C}")
        t["bound_ms"] = conv_bound_ms(GAMES, C)[0]
        t["shape"] = conv.conv_launch_shape(GAMES, C,
                                            conv.LIB.multiprocessors(dev))
        wide[C] = t

    # times at block 0's conv1 (affine and ReLU), at each of CONV_TIMED
    # boards, in turns with F.conv2d (cuDNN, channels-last bf16): the call
    # this kernel took off the path, which the path never calls now
    x, w, bn, relu, image = sites[0]
    batches = {}
    for B in CONV_TIMED:
        xb = x[:B].contiguous()
        xb_cl = xb.permute(0, 3, 1, 2)
        kernel_b = lambda i: conv.conv3x3(xb, w, bn, True, image)
        library_b = lambda i: torch.nn.functional.conv2d(xb_cl, w, padding=1)
        turns_b = [cuda_ms(kernel_b, what=f"conv3x3 {B}"),
                   cuda_ms(library_b, what=f"cuDNN {B}"),
                   cuda_ms(library_b, what=f"cuDNN {B}"),
                   cuda_ms(kernel_b, what=f"conv3x3 {B}")]
        batches[B] = {
            "ms": (turns_b[0] + turns_b[3]) / 2, "ms_turns": turns_b,
            "library_ms": (turns_b[1] + turns_b[2]) / 2,
            "bound_ms": conv_bound_ms(B, 128)[0],
            "shape": conv.conv_launch_shape(B, 128,
                                            conv.LIB.multiprocessors(dev))}
        print(f"conv3x3 at {B} boards, C 128, affine and ReLU, in turns "
              f"with cuDNN: {json.dumps(batches[B])}", flush=True)
    x1 = x[:1].contiguous()
    x_cl, x1_cl = x.permute(0, 3, 1, 2), x1.permute(0, 3, 1, 2)
    kernel = lambda i: conv.conv3x3(x, w, bn, True, image)
    kernel1 = lambda i: conv.conv3x3(x1, w, bn, True, image)
    library = lambda i: torch.nn.functional.conv2d(x_cl, w, padding=1)
    library1 = lambda i: torch.nn.functional.conv2d(x1_cl, w, padding=1)
    turns, turns1 = (batches[GAMES]["ms_turns"], batches[1]["ms_turns"])
    lib = K.LIB
    stream = torch.cuda.current_stream(dev).cuda_stream
    plain = lambda i: conv.conv3x3_plain(x, w, bn, True)
    t = {"ms": (turns[0] + turns[3]) / 2, "ms_turns": turns,
         "call_ms": cuda_ms(kernel, queued=False),
         "none_ms": cuda_ms(lambda i: conv.conv3x3(x, w, image=image),
                            what="conv3x3 none"),
         "plain_ms": cuda_ms(plain, iters=20, what="conv3x3_plain"),
         "plain_call_ms": cuda_ms(plain, iters=20, queued=False),
         "library_ms": (turns[1] + turns[2]) / 2,
         "library_call_ms": cuda_ms(library, queued=False),
         "b1_ms": (turns1[0] + turns1[3]) / 2, "b1_ms_turns": turns1,
         "b1_call_ms": cuda_ms(kernel1, queued=False),
         "b1_library_ms": (turns1[1] + turns1[2]) / 2,
         "b1_library_call_ms": cuda_ms(library1, queued=False),
         "floor_ms": cuda_ms(lambda i: lib.launch_floor(stream),
                             what="launch floor"),
         "floor_call_ms": cuda_ms(lambda i: lib.launch_floor(stream),
                                  queued=False)}
    bound, by, nbytes, ops = conv_bound_ms(GAMES, 128)
    t.update(bound_ms=bound, bound_by=by, bytes=nbytes, operations=ops,
             tflops=ops / t["ms"] / 1e9,
             b1_bound_ms=conv_bound_ms(1, 128)[0],
             shape=conv.conv_launch_shape(GAMES, 128,
                                          conv.LIB.multiprocessors(dev)),
             max_abs_err=total["max_abs_err"], unequal=total["unequal"],
             elements=total["elements"], share=total["share"],
             cudnn_share=total["cudnn_share"],
             beyond_one_step=total["beyond_one_step"],
             cudnn_beyond_one_step=total["cudnn_beyond_one_step"],
             max_steps=total["max_steps"], wide=wide,
             batches={str(B): v for B, v in batches.items()})
    print(f"conv3x3 at {GAMES} boards, C 128, affine and ReLU (b1_: one "
          f"board; library: F.conv2d, cuDNN, in turns; wide: C 32 and 256 "
          f"at {GAMES} boards; batches: each of {CONV_TIMED} in turns): "
          f"{json.dumps(t)}", flush=True)
    t["c256"] = conv_c256(dev)
    return t


CONV_C256_TIMED = (GAMES, 384, 268)    # C 256, timed in turns with cuDNN


def c256_forwards(dev):
    """One bf16 forward of GAMES random-play positions through each of the
    port's C 256 nets at their widths, their norms set to one float32
    batch's statistics: the SE-ResNet of 20 x 256 (``lc0-20x256-se``'s),
    KataGo's b28c512nbt and MuZero's towers (h and f at the root, then g
    and f on one random action a board); ``{name: (run, module)}``, the
    module whose ``conv`` (``cv``) the forward calls ``conv3x3`` through."""
    from alphazero_torch.config import Config
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.models import inference
    from alphazero_torch.models import muzero_inference as mi
    from alphazero_torch.models import nbt_inference as ni
    from alphazero_torch.models.network import BatchNorm2d, build_network

    planes = env.encoded_state(random_positions(GAMES, 27)).to(dev)
    acts = torch.randint(0, 192, (GAMES,), device=dev, dtype=torch.int32,
                         generator=torch.Generator(dev).manual_seed(27))

    def calibrated(cfg, seed, run):
        net = build_network(cfg, dev, torch.Generator().manual_seed(seed))
        norms = [m for m in net.modules() if isinstance(m, BatchNorm2d)]
        for m in norms:
            m.momentum = 1.0
        net.train()
        with torch.no_grad():
            run(net)
        net.eval()
        return net

    se = calibrated(Config(num_blocks=20, num_filters=256), 27,
                    lambda n: n(planes))
    nbt = calibrated(Config(body="nbt"), 28, lambda n: n(planes))
    def muzero_batch(n):
        state = n.represent(planes)
        n.predict(state)
        n.dynamics(state, acts.long())

    mz = calibrated(Config(body="muzero"), 29, muzero_batch)
    se_prep = inference.prepare_inference(se, torch.bfloat16)
    nbt_prep, mz_prep = ni.prepare(nbt), mi.prepare(mz)

    def muzero():
        _, _, s = mi.initial_apply(mz_prep, planes)
        mi.recurrent_apply(mz_prep, s, acts)

    return {"lc0-20x256-se": (
                lambda: inference.inference_apply(se_prep, planes),
                inference),
            "katago-b28c512nbt": (lambda: ni.apply(nbt_prep, planes), ni),
            "muzero-16x256-board": (muzero, mi)}


def conv_c256(dev):
    """conv3x3 at C 256: every site of one forward of each C 256 net
    (``c256_forwards``) at GAMES boards, where the wrapper takes the
    persistent path, against ``conv3x3_kernel<256, 128, 4>`` (the launch
    below it, whose source the persistent path left unchanged) in each
    epilogue, bit for bit (random BatchNorm constants where the site's
    conv has none), every launch of the forward on the persistent path,
    and each net's first site within ``conv.card_check`` and bit-equal to
    each of its boards launched alone; then random maps at
    ``CONV_C256_TIMED`` boards
    timed in the wrapper's launch, in turns with cuDNN (and, at GAMES, with
    the four-board launch), beside the bound."""
    from alphazero_torch.models import conv

    sms = conv.LIB.multiprocessors(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    waves = conv.launch_in_shape(GAMES, 256, 128, 4, sms)

    def four_boards(x, image, bn, epi):
        out = torch.empty_like(x)
        consts = (None,) * 3 if bn is None else tuple(t.data_ptr()
                                                      for t in bn)
        rc = conv.LIB.conv3x3_bf16(
            x.data_ptr(), image.data_ptr(), *consts, out.data_ptr(),
            x.shape[0], 256, epi, waves["grid"], 128, 4, stream)
        check(rc == 0, f"conv3x3 launch failed: CUDA error {rc}")
        return out

    check(conv.conv_launch_shape(GAMES, 256, sms)["path"] == "persistent",
          f"conv3x3 at C 256 and {GAMES} boards is not on its persistent "
          f"path")
    real = conv.conv3x3
    # the affine epilogues' constants at a site whose conv has no
    # BatchNorm of its own (the nbt and MuZero convs hand theirs on)
    g = torch.Generator().manual_seed(2561)
    site_bn = tuple(t.to(dev) for t in (
        torch.randn(256, generator=g) * 0.5,
        torch.rand(256, generator=g) + 0.5, torch.randn(256, generator=g)))
    out = {"nets": {}}
    for name, (run, module) in c256_forwards(dev).items():
        sites = []

        def record(x, w, bn=None, relu=False, image=None):
            sites.append((x, w, bn, relu, image))
            return real(x, w, bn, relu, image)

        attr = "cv" if hasattr(module, "cv") else "conv"
        setattr(module, attr, types.SimpleNamespace(conv3x3=record))
        before = real.persistent.launches
        try:
            with torch.no_grad():
                run()
        finally:
            setattr(module, attr, conv)
        torch.cuda.synchronize()
        check(sites and all(x.shape == (GAMES, 8, 8, 256)
                            for x, *_ in sites),
              f"{name}: conv3x3 sites {[x.shape for x, *_ in sites]}")
        check(real.persistent.launches - before == len(sites),
              f"{name}: {real.persistent.launches - before} of "
              f"{len(sites)} conv3x3 launches took the persistent path")
        unequal, first = 0, None
        for x, w, bn, _, image in sites:
            bn = site_bn if bn is None else bn
            before = real.persistent.launches
            outs = {k: real(x, w, bn if affine else None, relu, image)
                    for k, (affine, relu) in conv.EPILOGUES.items()}
            torch.cuda.synchronize()
            check(real.persistent.launches == before + 3,
                  f"{name}: a C 256 launch at {GAMES} boards did not take "
                  f"the persistent path")
            for epi, k in enumerate(conv.EPILOGUES):
                want = four_boards(x, image, bn if epi else None, epi)
                torch.cuda.synchronize()
                unequal += int((outs[k] != want).sum())
            if first is None:
                ref = conv.conv3x3_plain(x, w, f64_sums=True)
                cudnn = torch.nn.functional.conv2d(
                    x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
                limit = max(2 * float((cudnn != ref).float().mean()),
                            conv.CONV_UNEQUAL_SHARE)
                first = dict(conv.card_check(x, w, bn, outs, limit),
                             limit=limit)
                # each board alone (a launch of one board, not on the
                # persistent path) as in the launch of GAMES
                alone = torch.cat([real(x[b:b + 1].contiguous(), w, bn,
                                        True, image)
                                   for b in range(GAMES)])
                check(torch.equal(alone, outs["affine_relu"]),
                      f"{name}: a board of the {GAMES}-board launch differs "
                      f"from the same board launched alone")
        out["nets"][name] = {"sites": len(sites), "unequal": unequal,
                             "first_site": first}
        check(unequal == 0, f"{name}: the persistent path differs from "
                            f"conv3x3_kernel<256, 128, 4> in {unequal} "
                            f"elements over {len(sites)} sites")
        check(first["ok"], f"{name}: the persistent path against float64 "
                           f"sums at its first site: {first}")
        print(f"conv3x3 at C 256, {name}: {len(sites)} sites at {GAMES} "
              f"boards, three epilogues, the persistent path bit-equal to "
              f"conv3x3_kernel<256, 128, 4>, the first site's boards to "
              f"each board alone; first site {json.dumps(first)}",
              flush=True)

    g = torch.Generator().manual_seed(256)
    out["batches"] = {}
    for B in CONV_C256_TIMED:
        x = torch.randn((B, 8, 8, 256), generator=g).to(dev, torch.bfloat16)
        w = (torch.randn((256, 256, 3, 3), generator=g) / 48).to(
            dev, torch.bfloat16, memory_format=torch.channels_last)
        bn = tuple(t.to(dev) for t in (
            torch.randn(256, generator=g) * 0.5,
            torch.rand(256, generator=g) + 0.5,
            torch.randn(256, generator=g)))
        image = conv.weight_image(w)
        x_cl = x.permute(0, 3, 1, 2)
        kernel = lambda i: conv.conv3x3(x, w, bn, True, image)
        library = lambda i: torch.nn.functional.conv2d(x_cl, w, padding=1)
        turns = [cuda_ms(kernel, what=f"conv3x3 C 256 {B}"),
                 cuda_ms(library, what=f"cuDNN C 256 {B}"),
                 cuda_ms(library, what=f"cuDNN C 256 {B}"),
                 cuda_ms(kernel, what=f"conv3x3 C 256 {B}")]
        r = {"ms": (turns[0] + turns[3]) / 2, "ms_turns": turns,
             "library_ms": (turns[1] + turns[2]) / 2,
             "bound_ms": conv_bound_ms(B, 256)[0],
             "shape": conv.conv_launch_shape(B, 256, sms)}
        if B == GAMES:
            old = lambda i: four_boards(x, image, bn, 2)
            r["four_board_ms_turns"] = [
                cuda_ms(old, what="conv3x3<256, 128, 4>"),
                cuda_ms(kernel, what="conv3x3 persistent"),
                cuda_ms(kernel, what="conv3x3 persistent"),
                cuda_ms(old, what="conv3x3<256, 128, 4>")]
            check(torch.equal(kernel(0), old(0)),
                  "the persistent path differs from the four-board launch")
        r["roofline_pct"] = 100 * r["bound_ms"] / r["ms"]
        out["batches"][str(B)] = r
        print(f"conv3x3 at C 256, {B} boards, affine and ReLU, in turns with "
              f"cuDNN: {json.dumps(r)}", flush=True)
    return out


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
    from alphazero_torch.models import conv, epilogue, fused, quant
    from alphazero_torch.models.network import wl_to_value
    from alphazero_torch.search import graph
    from alphazero_torch.search import kernels as K
    from alphazero_torch.search import mcts
    from alphazero_torch.train import selfplay

    cfg = Config(num_simulations=SIMS, parallel_games=GAMES)
    n_tail = len(net.blocks)                    # the int8 forward's
    b_conv, b_bn, b_tail, b_tower = bf16_forward_launches(net, GAMES)
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
        conv.conv3x3.launches = 0
        K.descend.launches = 0
        K.commit_edges.launches = 0
        K.encode_planes.launches = 0
        K.expand.launches = 0
        epilogue.bn_act.launches = 0
        epilogue.se_residual.launches = 0
        fused.tower_forward.launches = 0
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
                        "commit_edges": K.commit_edges.launches,
                        "encode_planes": K.encode_planes.launches,
                        "expand": K.expand.launches,
                        "se_residual": epilogue.se_residual.launches}
            check(launches["qconv3x3"] == n_conv * (SIMS + 1)
                  and launches["se_residual"] == n_tail * (SIMS + 1)
                  and epilogue.bn_act.launches == 0
                  and conv.conv3x3.launches == 0
                  and launches["descend"] == launches["commit_edges"]
                  == launches["encode_planes"] == launches["expand"]
                  == SIMS and mcts.STATS.levels == 0,
                  f"int8 move: {launches}, {epilogue.bn_act.launches} "
                  f"bn_act, {conv.conv3x3.launches} conv3x3, "
                  f"{mcts.STATS.levels} host-read levels")
        else:
            check(quant.qconv3x3.launches == 0, "bf16 move ran an s8 conv")
            check(conv.conv3x3.launches == b_conv * (SIMS + 1)
                  and epilogue.bn_act.launches == b_bn * (SIMS + 1)
                  and epilogue.se_residual.launches == b_tail * (SIMS + 1)
                  and fused.tower_forward.launches == b_tower * (SIMS + 1),
                  f"bf16 move: {conv.conv3x3.launches} conv3x3, "
                  f"{epilogue.bn_act.launches} bn_act, "
                  f"{epilogue.se_residual.launches} se_residual, "
                  f"{fused.tower_forward.launches} tower_forward launches")
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
            out[f"{name}_{mode}_classes"] = p["classes"]
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

    from alphazero_torch.models import conv

    pair_eval_fn = match.select_evaluator(evals["int8"], evals["bf16"])
    rng = random.Random(0)
    conv.conv3x3.launches = 0
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
        "lockstep_moves": moves[0], "seconds": dt,
        "bf16_conv3x3_launches": conv.conv3x3.launches, "card": card}),
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
    from alphazero_torch.models import conv, epilogue
    from alphazero_torch.models.convert import config_from_archive
    from alphazero_torch.search import kernels as K
    from alphazero_torch.search import mcts
    from alphazero_torch.train import checkpoint as ckpt
    from alphazero_torch.train.learner import TrainState, make_optimizer
    from alphazero_torch.web import server

    sims = WEB_SIMS
    n_bn, n_tail, n_conv = 2, len(net.blocks), 2 * len(net.blocks) + 1
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
        total = {"descend": 0, "commit_edges": 0, "encode_planes": 0,
                 "expand": 0, "bn_act": 0, "se_residual": 0, "conv3x3": 0}
        counted = (K.descend, K.commit_edges, K.encode_planes, K.expand,
                   epilogue.bn_act, epilogue.se_residual, conv.conv3x3)
        try:
            check(http_json(base, "/api/models")["current"]
                  == cfg.best_model, "/api/models")
            legal = [list(m) for m in OracleGame().get_legal_moves()]
            request = ("/api/new", {"white_type": "alphazero",
                                    "black_type": "baseline"})
            plies = 0
            while plies < WEB_PLIES:
                az_turn = plies % 2 == 0          # AlphaZero plays White
                for f in counted:
                    f.launches = 0
                torch.cuda.synchronize()
                t0 = time.time()
                r = http_json(base, *request)
                dt = time.time() - t0
                check(r["bot_move"] in legal,
                      f"ply {plies}: {r['bot_move']} not in the legal "
                      f"moves {legal}")
                check(-1.0 <= r["evaluation"] <= 1.0, f"evaluation {r}")
                launches = tuple(f.launches for f in counted)
                for key, n in zip(total, launches):
                    total[key] += n
                if az_turn:
                    # the root's evaluation and one a simulation
                    check(launches == (sims, sims, sims, sims,
                                       n_bn * (sims + 1),
                                       n_tail * (sims + 1),
                                       n_conv * (sims + 1))
                          and "engine" not in r,
                          f"AlphaZero move {plies}: {launches} launches")
                    az_s.append(dt)
                    evals.append(r["evaluation"])
                else:
                    check(launches == (0,) * len(counted)
                          and r["engine"]["nodes"] > 0,
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
# Phase 18: the simulation's glue, encode_planes and expand
# -----------------------------------------------------------------------------

GLUE_BATCHES = (GAMES, 128, 32, 2, 1)  # self-play, trainer, gates, web bot
GLUE_SIMS = 48                      # the searches whose leaves are taken
GLUE_TIMED = (GAMES, 1)


def glue_bytes(kind, B, R=4 * A, tree_reuse=False):
    """The bytes one ``encode_planes`` or ``expand`` of B games must move,
    each input read once and each output written once. ``encode_planes``:
    the board and the turn read, three planes of float32 written.
    ``expand``: the policy, the value, the leaf board, turn, winner, done,
    needs_alloc and depth read; the root's visit, vsum and node count read
    and written; the leaf value and the row at the slot written (its child
    and prior blocks, or the whole row and the parent, with the path entry
    it comes from, under tree reuse); the slot and the depth sum."""
    if kind == "encode_planes":
        return B * (64 + 1 + 3 * 64 * 4)
    row = (R * 4 + 4 + 4) if tree_reuse else 2 * A * 4
    return B * (A * 4 + 4 + 64 + 3 + 1 + 4 + 2 * 12 + 4 + row) + 4 + 2 * 8


def glue_leaves(states, fn, reuse, seed):
    """A captured search of ``GLUE_SIMS`` simulations from ``states`` on a
    tree with room for more (with ``reuse``, then re-rooted at each game's
    most visited child, as a self-play move leaves it), and the leaves of
    its next simulation: (tree, descent results, policy, value), every
    seventh game's policy zeroed (no legal mass)."""
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.search import kernels as K
    from alphazero_torch.search import mcts

    spec = mcts.SearchSpec(num_simulations=GLUE_SIMS, tree_reuse=reuse)
    tree = mcts.init_tree(states, mcts.SearchSpec(
        num_simulations=GLUE_SIMS + 1, tree_reuse=reuse))
    tree = mcts.search(states, fn, spec, tree=tree,
                       generator=torch.Generator(device=states.device)
                       .manual_seed(seed), add_noise=True)
    if reuse:
        actions = mcts.root_child_visits(tree).argmax(-1)
        tree = mcts.advance_root(tree, actions,
                                 env.step(tree.root_state, actions), spec)
        mcts.search(tree.root_state, fn, mcts.SearchSpec(
            num_simulations=GLUE_SIMS // 4, tree_reuse=True), tree=tree)
    out = mcts._descend(tree.rows, tree.root_state, tree.root_visit,
                        tree.root_vsum, spec)
    policy, value = fn(K.encode_planes(out[0]))
    policy = policy.clone()
    policy[::7] = 0.0
    return tree, out, policy, value


def _tree_copy(tree):
    from alphazero_torch.search import mcts

    return mcts.Tree(rows=tree.rows.clone(), root_state=tree.root_state,
                     root_visit=tree.root_visit.clone(),
                     root_vsum=tree.root_vsum.clone(),
                     node_count=tree.node_count.clone(),
                     next_slot=tree.next_slot.clone(),
                     parents=tree.parents.clone(), n_actions=tree.n_actions)


def glue_check(tree, out, policy, value, reuse):
    """``encode_planes`` and ``expand`` against their plain versions on one
    simulation's leaves, each on its own copy of the tree: every output
    and every field of the tree bit-equal. Returns each kernel's largest
    difference and what the leaves held."""
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.search import kernels as K

    leaf, needs_alloc, depth, path_nodes = out[:4]
    planes = K.encode_planes(leaf)
    want = env.encoded_state(leaf)
    encode_err = float((planes - want).abs().max())
    check(torch.equal(planes, want), "encode_planes differs from its plain "
                                     "version")
    got_t, want_t = _tree_copy(tree), _tree_copy(tree)
    acc = [torch.zeros((), dtype=torch.int64, device=value.device)
           for _ in range(2)]
    args = (leaf, needs_alloc, depth, path_nodes, policy, value, reuse)
    got = K.expand(got_t, *args, acc[0])
    want = K._expand_plain(want_t, *args, acc[1])
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    for name in ("rows", "parents", "root_visit", "root_vsum", "node_count",
                 "next_slot"):
        a, b = getattr(got_t, name), getattr(want_t, name)
        err = max(err, float((a.double() - b.double()).abs().max()))
        check(torch.equal(a, b), f"expand: the tree's {name} differs from "
                                 f"the plain version's")
    check(torch.equal(got, want) and torch.equal(acc[0], acc[1]),
          "expand: the leaf values or the depth sum differ")
    legal = env.legal_action_mask(leaf)
    return encode_err, err, {"terminal": int(leaf.done.sum()),
                 "terminal_alloc": int((leaf.done & needs_alloc).sum()),
                 "no_alloc": int((~needs_alloc).sum()),
                 "no_mass": int((((policy * legal).sum(-1) == 0)
                                 & ~leaf.done).sum())}


@phase("phase 18 glue")
def phase_glue(dev, net):
    """``encode_planes`` and ``expand`` against their plain versions on the
    leaves of captured searches with the archive's bf16 and int8-static
    evaluators, at 512, 128, 32, 2 and 1 games, tree reuse off and on;
    their times beside their bounds, their plain versions and the launch
    floor."""
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.models import quant
    from alphazero_torch.search import kernels as K
    from alphazero_torch.search import mcts
    from alphazero_torch.strength.common import calibration_batches

    qp = quant.quantize_network(net)
    evals = {"bf16": mcts.make_net_evaluator(net, torch.bfloat16),
             "int8": quant.make_quant_evaluator(
                 net, qp=qp, act_scales=quant.calibrate(
                     qp, calibration_batches(ARCHIVE, dev)[0]))}
    on = lambda s: env.EnvState(*(getattr(s, f).to(dev) for f in
                                  ("board", "turn", "winner", "done",
                                   "move_count")))
    err = {"encode_planes": 0.0, "expand": 0.0}
    seen = {}
    timed = {}
    for B in GLUE_BATCHES:
        # random-play positions, every fourth game played to its end (a
        # finished root: a terminal leaf that allocates nothing)
        states = random_positions(B, 90 + B, max_plies=60)
        states = on(finish_games(states, torch.arange(B) % 4 == 3, B))
        for name, fn in evals.items():
            for reuse in (False, True):
                tree, out, policy, value = glue_leaves(states, fn, reuse, B)
                *e, held = glue_check(tree, out, policy, value, reuse)
                for k, v in zip(err, e):
                    err[k] = max(err[k], v)
                seen[f"{name}_{B}_{'reuse' if reuse else 'fresh'}"] = held
                if name == "bf16" and not reuse and B in GLUE_TIMED:
                    timed[B] = (tree, out, policy, value)
                del tree, out
    total = {k: sum(h[k] for h in seen.values())
             for k in ("terminal", "terminal_alloc", "no_alloc", "no_mass")}
    check(total["terminal"] > 0 and total["no_alloc"] > 0
          and total["no_mass"] > 0,
          f"the leaves held no case of one kind: {total}")
    print(f"glue: encode_planes and expand bit-equal to their plain "
          f"versions at {GLUE_BATCHES} games, bf16 and int8 leaves, tree "
          f"reuse off and on: {json.dumps(seen)}", flush=True)

    lib = K.LIB
    stream = torch.cuda.current_stream(dev).cuda_stream
    times = {"floor_ms": cuda_ms(lambda i: lib.launch_floor(stream),
                                 what="launch floor"),
             "floor_call_ms": cuda_ms(lambda i: lib.launch_floor(stream),
                                      queued=False)}
    for B, (tree, out, policy, value) in timed.items():
        leaf, needs_alloc, depth, path_nodes = out[:4]
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        planes = torch.empty((B, 3, 8, 8), device=dev)
        kernel_t, plain_t = _tree_copy(tree), _tree_copy(tree)
        calls = {
            "encode_planes": (lambda i: K.encode_planes(leaf, out=planes),
                              lambda i: env.encoded_state(leaf)),
            "expand": (lambda i: K.expand(kernel_t, leaf, needs_alloc, depth,
                                          path_nodes, policy, value, False,
                                          acc),
                       lambda i: K._expand_plain(
                           plain_t, leaf, needs_alloc, depth, path_nodes,
                           policy, value, False, acc))}
        R = tree.rows[0, 0].numel()
        for kind, (kernel, plain) in calls.items():
            times[f"{kind}_{B}"] = {
                "ms": cuda_ms(kernel, what=kind),
                "call_ms": cuda_ms(kernel, queued=False),
                # the plain expand queues some 75 launches a call: eight
                # calls stay under the stream's queue depth
                "plain_ms": cuda_ms(plain, iters=8, sleep_ms=200,
                                    what=f"{kind} plain"),
                "plain_call_ms": cuda_ms(plain, iters=20, queued=False),
                "bytes": glue_bytes(kind, B, R),
                "bound_ms": glue_bytes(kind, B, R) / HBM_BYTES_PER_S * 1e3}
    del timed
    torch.cuda.empty_cache()
    print("glue times " + json.dumps(times), flush=True)
    return err, times, total


# -----------------------------------------------------------------------------
# Phase 19: the encoder body's attention kernel
# -----------------------------------------------------------------------------

BT4_SIMS = 400                     # the BT4 cell's simulations a move
SMOLGEN_BATCHES = (1, 32, GAMES)
SMOLGEN_RAGGED = (3, 129)          # a cluster's second board missing
# the mma.sync design that the kernel replaced, at one board and at 32
# (PERF.md section 6): the kernel may be no slower, within 5%
SMOLGEN_REPLACED_MS = {1: 0.0710, 32: 0.0712}


def smolgen_bound_ms(B, H=32, D=32, G=256):
    """The least time the card could take for one ``smolgen_attention`` of
    B boards: the larger of its bytes at the memory rate (Q, K, V and the
    output, the smolgen vectors and W_gen, once each, bf16) and its
    operations at the bf16 peak (the bias, Q K^T and P V)."""
    T, E = 64, H * D
    nbytes = 2 * (4 * B * T * E + B * H * G + G * T * T)
    ops = B * H * (2 * G * T * T + 4 * T * T * D)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / BF16_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations"), ops, nbytes


def smolgen_half_ms(half, qkv, s, image, B, H=32, D=32, G=256):
    """Device time of one half of ``smolgen_attention`` alone at B boards:
    ``csrc/attention_kernels.cu`` built with ``-DSMOLGEN_HALF=1`` (the bias
    product and its exchange, no attention) or ``=2`` (the attention on an
    unset bias, no bias product) into ``build/smolgen_half/``."""
    import ctypes

    from alphazero_torch.cuda_build import CSRC, NVCC_FLAGS, _nvcc

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "smolgen_half")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libsmolgen_half{half}.so")
    subprocess.run([_nvcc(), *NVCC_FLAGS, f"-DSMOLGEN_HALF={half}", "-o",
                    lib, str(CSRC / "attention_kernels.cu")], check=True,
                   capture_output=True)
    entry = ctypes.CDLL(lib).smolgen_attention_bf16
    entry.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    out = torch.empty(B * 64, H * D, dtype=torch.bfloat16,
                      device=qkv.device)

    def launch(i):
        rc = entry(qkv.data_ptr(), s.data_ptr(), image.data_ptr(),
                   out.data_ptr(), B, H, D, G,
                   torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"smolgen half {half}: CUDA error {rc}")

    return cuda_ms(launch, iters=20, warmup=3)


def deepnorm_bound_ms(rows, E=1024):
    """The least time the card could take for one ``deepnorm_ln`` of
    ``rows`` token rows: o and x read and the output written once, bf16
    (gamma and beta, 4 KB, left out); its few operations a byte are far
    below the bf16 peak's line."""
    nbytes = 3 * rows * E * 2
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def dense_mish_bound_ms(rows, K=1024, N=1536):
    """The least time the card could take for one ``dense_mish`` of
    ``rows`` token rows, K into N: the larger of its operations at the
    bf16 peak (2 rows K N) and its bytes at the memory rate (x and W read
    and the output written once, bf16; the bias left out)."""
    ops = 2 * rows * K * N
    nbytes = 2 * (rows * K + K * N + rows * N)
    by_ops = ops / BF16_FLOPS * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes"), ops, nbytes


def smolgen_far(qkv, s, wgen_t, H, got):
    """Outputs of the kernel (``got``) past the tolerance of
    ``tests/test_torch_encoder.py::
    test_cuda_smolgen_attention_against_its_plain_version``: the plain
    version may round a numerator to the neighbouring bf16 value (2^-8 of
    it) where the kernel does not, so an output may differ by that share of
    the attention's sum of |V|, twice over, and by two steps of its own
    rounding. Returns (far, share unequal, max |d|)."""
    from alphazero_torch.models import attention

    want = attention.smolgen_attention_plain(qkv, s, wgen_t, H)
    qkv_abs = qkv.clone()
    qkv_abs[:, 2 * qkv.shape[1] // 3:] = qkv_abs[:, 2 * qkv.shape[1] // 3:].abs()
    terms = attention.smolgen_attention_plain(qkv_abs, s, wgen_t, H).float()
    g, w = got.float(), want.float()
    m = torch.maximum(g.abs(), w.abs())
    step = 2.0 ** (torch.floor(torch.log2(m.clamp_min(2 ** -60))) - 7)
    far = int(((g - w).abs() > 2 * step + 2 ** -7 * terms).sum())
    return far, float((got != want).float().mean()), float((g - w).abs().max())


@phase("phase 19 smolgen")
def phase_smolgen(dev, card):
    """``smolgen_attention``, ``deepnorm_ln`` and ``dense_mish`` at BT4's
    widths against their plain versions (random operands at 1 to 512
    boards, and the first layer's operands of a seeded BT4 net on 512
    positions); their times at 512 boards beside their bounds, their plain
    versions and the library calls they replace; then a captured BT4
    search move at the cell's 512 x 400, with the kernels' launches
    counted (15, 30 and 16 a forward) and their device time inside the
    replays from a profile."""
    import torch.nn.functional as F

    from alphazero_torch.config import Config
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.models import attention, encoder_inference as ei
    from alphazero_torch.models import encoder_epilogue as ee
    from alphazero_torch.models.network import build_network
    from alphazero_torch.search import graph, mcts
    from alphazero_torch.train import selfplay

    H, D, G = (attention.KERNEL_HEADS, attention.KERNEL_DIM,
               attention.KERNEL_GEN)
    fn = attention.smolgen_attention
    out = {"checks": {}}
    g = torch.Generator(device=dev).manual_seed(19)
    operands = {}
    for B in SMOLGEN_BATCHES + SMOLGEN_RAGGED:
        qkv = torch.randn(B * 64, 3 * H * D, generator=g,
                          device=dev).bfloat16()
        s = torch.randn(B, H, G, generator=g, device=dev).bfloat16()
        wgen_t = (torch.randn(4096, G, generator=g, device=dev)
                  / 16).bfloat16()
        operands[f"random_{B}"] = (qkv, s, wgen_t)

    # the first layer's operands of a seeded BT4 net on random positions
    cfg = Config(body="encoder", num_simulations=BT4_SIMS,
                 parallel_games=GAMES)
    net = build_network(cfg, dev, torch.Generator().manual_seed(19))
    eval_fn = mcts.make_net_evaluator(net, torch.bfloat16)
    prep = ei.prepare(net)
    planes = env.encoded_state(random_positions(GAMES, 19)).to(dev)
    with torch.no_grad():
        tokens = planes.flatten(2).transpose(1, 2).bfloat16()
        x = torch.nn.functional.mish(torch.matmul(tokens, prep["embed"])
                                     + prep["position"])
        x = torch.addcmul(prep["gate_add"], x,
                          prep["gate_mult"]).reshape(GAMES * 64, -1)
        L = prep["layers"][0]
        c = (x @ L["compress"]).view(GAMES, -1)
        h = ei._ln(torch.nn.functional.silu(ei._dense(c, L["sg1"])),
                   L["sg_ln1"])
        s = ei._ln(torch.nn.functional.silu(ei._dense(h, L["sg2"])),
                   L["sg_ln2"]).view(GAMES, H, -1)
        operands[f"bt4_layer0_{GAMES}"] = (ei._dense(x, L["qkv"]),
                                           s.contiguous(), prep["wgen_t"])
        # deepnorm_ln's two sites of the same layer: the attention's output
        # projection and the feed-forward's second product, each with the
        # rows it skipped over
        alpha = prep["alpha"]
        o = ei._dense(attention.smolgen_attention(
            *operands[f"bt4_layer0_{GAMES}"], H), L["o"])
        x1 = ee.deepnorm_ln_plain(o, x, alpha, *L["ln1"])
        f = ei._dense(torch.nn.functional.mish(ei._dense(x1, L["ffn1"])),
                      L["ffn2"])
        ln_operands = {f"bt4_layer0_ln1_{GAMES}": (o, x, *L["ln1"]),
                       f"bt4_layer0_ln2_{GAMES}": (f, x1, *L["ln2"])}
        # dense_mish's two sites: the same layer's feed-forward on the rows
        # it reads, and the policy embedding on the layer's output
        dm_operands = {
            f"bt4_layer0_ffn1_{GAMES}": (x1, *L["ffn1"]),
            f"bt4_policy_embed_{GAMES}": (
                ee.deepnorm_ln_plain(f, x1, alpha, *L["ln2"]),
                *prep["policy_embed"])}
    ln_gen = torch.Generator(device=dev).manual_seed(21)
    for B in SMOLGEN_BATCHES:
        o_, x_ = (torch.randn(B * 64, H * D, generator=ln_gen,
                              device=dev).bfloat16() for _ in range(2))
        ln_operands[f"random_{B}"] = (
            o_, x_, (1 + 0.2 * torch.randn(H * D, generator=ln_gen,
                                           device=dev)).bfloat16(),
            (0.1 * torch.randn(H * D, generator=ln_gen,
                               device=dev)).bfloat16())
    for N in (1536, 1024):
        for B in SMOLGEN_BATCHES + SMOLGEN_RAGGED:
            xr = torch.randn(B * 64, H * D, generator=ln_gen,
                             device=dev).bfloat16()
            wr = (torch.randn(H * D, N, generator=ln_gen, device=dev)
                  / 32).bfloat16()
            br = (0.5 * torch.randn(N, generator=ln_gen,
                                    device=dev)).bfloat16()
            dm_operands[f"random_{N}_{B}"] = (xr, wr, br, ee.dense_image(wr))
    for tag, (qkv, s, wgen_t) in operands.items():
        before = fn.launches
        got = fn(qkv, s, wgen_t, H)
        torch.cuda.synchronize()
        check(fn.launches == before + 1, f"{tag}: launches not counted")
        check(got.shape == (qkv.shape[0], H * D)
              and got.dtype == torch.bfloat16
              and bool(torch.isfinite(got.float()).all()),
              f"smolgen_attention output malformed ({tag})")
        far, unequal, dmax = smolgen_far(qkv, s, wgen_t, H, got)
        out["checks"][tag] = {"far": far, "unequal_share": unequal,
                              "max_abs_err": dmax}
        check(far == 0 and unequal < 0.02,
              f"smolgen_attention against its plain version ({tag}): "
              f"{far} outputs past the tolerance, {unequal:.4f} unequal")
    print("smolgen_attention against its plain version "
          + json.dumps(out["checks"]), flush=True)
    ln = ee.deepnorm_ln
    out["ln_checks"] = {}
    for tag, (o, x, gamma, beta) in ln_operands.items():
        before = ln.launches
        got = ln(o, x, alpha, gamma, beta)
        torch.cuda.synchronize()
        check(ln.launches == before + 1, f"{tag}: launches not counted")
        check(got.shape == o.shape and got.dtype == torch.bfloat16
              and bool(torch.isfinite(got.float()).all()),
              f"deepnorm_ln output malformed ({tag})")
        r = ee.card_check(o, x, alpha, gamma, beta, got)
        out["ln_checks"][tag] = r
        check(r["ok"], f"deepnorm_ln against its plain version ({tag}): "
                       f"{r}")
    print("deepnorm_ln against its plain version "
          + json.dumps(out["ln_checks"]), flush=True)
    dm = ee.dense_mish
    out["dm_checks"] = {}
    for tag, (xd, wd, bd, image) in dm_operands.items():
        before = dm.launches
        got = dm(xd, wd, bd, image)
        torch.cuda.synchronize()
        check(dm.launches == before + 1, f"{tag}: launches not counted")
        check(got.shape == (xd.shape[0], wd.shape[1])
              and got.dtype == torch.bfloat16
              and bool(torch.isfinite(got.float()).all()),
              f"dense_mish output malformed ({tag})")
        r = ee.dense_card_check(xd, wd, bd, got)
        out["dm_checks"][tag] = r
        check(r["ok"], f"dense_mish against its plain version ({tag}): {r}")
    print("dense_mish against its plain version "
          + json.dumps(out["dm_checks"]), flush=True)

    # times at the main path's 512 boards, on the first layer's operands;
    # the plain version's some 15 launches a call: ten calls queue
    # (W_gen packed once, as encoder_inference.prepare packs it)
    qkv, s, wgen_t = operands[f"bt4_layer0_{GAMES}"]
    image = prep["wgen_image"]
    bound, bound_by, ops, nbytes = smolgen_bound_ms(GAMES, H, D, G)
    t = {"ms": cuda_ms(lambda i: fn(qkv, s, wgen_t, H, image), iters=20,
                       warmup=3),
         "call_ms": cuda_ms(lambda i: fn(qkv, s, wgen_t, H, image),
                            iters=20, warmup=3, queued=False),
         "plain_ms": cuda_ms(lambda i: attention.smolgen_attention_plain(
             qkv, s, wgen_t, H), iters=10, warmup=2, sleep_ms=200,
             what="smolgen_attention_plain"),
         "plain_call_ms": cuda_ms(lambda i: attention.smolgen_attention_plain(
             qkv, s, wgen_t, H), iters=10, warmup=2, queued=False),
         "bound_ms": bound, "bound_by": bound_by}
    t["roofline_pct"] = 100 * bound / t["ms"]
    t["by_batch_ms"] = {}
    for B in SMOLGEN_BATCHES:
        ob = operands[f"random_{B}"]
        ib = attention.wgen_image(ob[2])
        t["by_batch_ms"][B] = cuda_ms(lambda i: fn(*ob, H, ib), iters=20,
                                      warmup=3)
    t["by_batch_bound_ms"] = {B: smolgen_bound_ms(B, H, D, G)[0]
                              for B in SMOLGEN_BATCHES}
    t["half_ms"] = {"bias": smolgen_half_ms(1, qkv, s, image, GAMES),
                    "attention": smolgen_half_ms(2, qkv, s, image, GAMES)}
    for B, was in SMOLGEN_REPLACED_MS.items():
        check(t["by_batch_ms"][B] <= 1.05 * was,
              f"smolgen_attention at {B} boards: {t['by_batch_ms'][B]:.4f} "
              f"ms, slower than the replaced design's {was} ms")
    out["times"] = t
    print(f"smolgen_attention at {GAMES} boards: {json.dumps(t)}; bound "
          f"{bound:.4f} ms by {bound_by} ({ops:.4g} operations, "
          f"{nbytes:.4g} bytes)", flush=True)
    del operands, qkv, s, wgen_t, image, ob, ib

    # deepnorm_ln at 512 boards on the first layer's ln1 operands, in turns
    # with its plain version (torch.add then F.layer_norm, which is also
    # the library's yardstick: no one PyTorch call fuses the two)
    o, x, gamma, beta = ln_operands[f"bt4_layer0_ln1_{GAMES}"]
    kern = lambda i: ln(o, x, alpha, gamma, beta)
    plain = lambda i: ee.deepnorm_ln_plain(o, x, alpha, gamma, beta)
    turns = [cuda_ms(f, iters=50, warmup=5, what=w)
             for f, w in ((kern, "deepnorm_ln"), (plain, "plain"),
                          (kern, "deepnorm_ln"), (plain, "plain"))]
    bound, nbytes = deepnorm_bound_ms(GAMES * 64)
    t = {"ms": (turns[0] + turns[2]) / 2, "turns_ms": turns,
         "call_ms": cuda_ms(kern, iters=50, warmup=5, queued=False),
         "plain_ms": (turns[1] + turns[3]) / 2,
         "plain_call_ms": cuda_ms(plain, iters=50, warmup=5, queued=False),
         "bound_ms": bound, "bound_by": "bytes", "bytes": nbytes}
    t["library_ms"] = t["plain_ms"]
    t["roofline_pct"] = 100 * bound / t["ms"]
    t["by_batch_ms"] = {}
    for B in SMOLGEN_BATCHES:
        ob, xb, gb, bb = ln_operands[f"random_{B}"]
        t["by_batch_ms"][B] = cuda_ms(lambda i: ln(ob, xb, alpha, gb, bb),
                                      iters=50, warmup=5)
    out["ln_times"] = t
    print(f"deepnorm_ln at {GAMES} boards: {json.dumps(t)}", flush=True)
    del ln_operands, o, x, gamma, beta, ob, xb, gb, bb

    # dense_mish on the seeded layer's feed-forward at 512, 32 and one
    # board (its first rows), and on the policy embedding at 512, each in
    # turns with the pair it replaces (cuBLAS's addmm, then PyTorch's
    # mish: the library's yardstick) and with addmm alone
    def dm_turns(xd, wd, bd, image):
        kern = lambda i: dm(xd, wd, bd, image)
        pair = lambda i: F.mish(torch.addmm(bd, xd, wd))
        mm = lambda i: torch.addmm(bd, xd, wd)
        turns = {"dense_mish": [], "pair": [], "addmm": []}
        for _ in range(2):
            for name, f_ in (("dense_mish", kern), ("pair", pair),
                             ("addmm", mm)):
                turns[name].append(cuda_ms(f_, iters=50, warmup=5,
                                           what=name))
        return {k: sum(v) / len(v) for k, v in turns.items()}, turns

    xd, wd, bd, image = dm_operands[f"bt4_layer0_ffn1_{GAMES}"]
    mean, turns = dm_turns(xd, wd, bd, image)
    bound, bound_by, ops, nbytes = dense_mish_bound_ms(GAMES * 64)
    t = {"ms": mean["dense_mish"], "turns_ms": turns,
         "call_ms": cuda_ms(lambda i: dm(xd, wd, bd, image), iters=50,
                            warmup=5, queued=False),
         "plain_ms": cuda_ms(lambda i: ee.dense_mish_plain(xd, wd, bd),
                             iters=10, warmup=2, what="dense_mish_plain"),
         "library_ms": mean["pair"], "addmm_ms": mean["addmm"],
         "bound_ms": bound, "bound_by": bound_by, "ops": ops,
         "bytes": nbytes}
    t["roofline_pct"] = 100 * bound / t["ms"]
    xp, wp, bp, ip = dm_operands[f"bt4_policy_embed_{GAMES}"]
    pmean, _ = dm_turns(xp, wp, bp, ip)
    t["policy_embed_ms"] = {**pmean, "bound_ms": dense_mish_bound_ms(
        GAMES * 64, N=1024)[0]}
    t["by_batch_ms"] = {}
    for B in SMOLGEN_BATCHES[:-1]:       # the seeded layer's first rows
        t["by_batch_ms"][B] = dm_turns(xd[:B * 64], wd, bd, image)[0]
    t["by_batch_bound_ms"] = {B: dense_mish_bound_ms(B * 64)[0]
                              for B in SMOLGEN_BATCHES}
    check(t["ms"] <= 0.20,
          f"dense_mish at {GAMES} boards: {t['ms']:.4f} ms, past 0.20 ms")
    out["dm_times"] = t
    print(f"dense_mish at {GAMES} boards: {json.dumps(t)}", flush=True)
    del dm_operands, xd, wd, bd, image, xp, wp, bp, ip
    torch.cuda.empty_cache()

    # the main path: a warm-up move captures the simulation, then one
    # counted move of BT4_SIMS replays through selfplay_move
    spec = selfplay.search_spec(cfg)
    gen = torch.Generator(device=dev).manual_seed(19)
    states = env.initial_state((GAMES,), device=dev)
    tree = mcts.init_tree(states, spec)
    graph.STATS.reset()
    tree, _, _, _, states = selfplay._searched_move(
        states, tree, gen, eval_fn, spec, cfg.temperature_threshold)
    torch.cuda.synchronize()
    check(graph.STATS.captures == 1,
          f"the first BT4 move made {graph.STATS.captures} captures")
    graph.STATS.reset()
    mcts.STATS.reset()
    fn.launches = 0
    ln.launches = 0
    dm.launches = 0
    t0 = time.time()
    states, _, probs, _, values = selfplay.selfplay_move(
        states, gen, eval_fn, spec, cfg.temperature_threshold, tree)
    torch.cuda.synchronize()
    move_s = time.time() - t0
    launches, ln_launches = fn.launches, ln.launches
    dm_launches = dm.launches
    forwards = BT4_SIMS + 1               # the root's and one a simulation
    layers = cfg.enc_layers
    check(dm_launches == (layers + 1) * forwards,
          f"a captured BT4 move: {dm_launches} dense_mish launches (want "
          f"{layers + 1} a forward, {(layers + 1) * forwards})")
    check(launches == layers * forwards
          and ln_launches == 2 * layers * forwards
          and graph.STATS.captures == 0
          and graph.STATS.replays == BT4_SIMS
          and mcts.STATS.levels == 0,
          f"a captured BT4 move of {BT4_SIMS} simulations: {launches} "
          f"smolgen_attention launches (want {layers} a forward, "
          f"{layers * forwards}), {ln_launches} deepnorm_ln (want "
          f"{2 * layers * forwards}), {graph.STATS.captures} captures, "
          f"{graph.STATS.replays} replays, {mcts.STATS.levels} host-read "
          f"levels")
    check(bool(((probs.sum(-1) - 1).abs() < 1e-5).all())
          and bool(torch.isfinite(values).all()), "BT4 move's outputs")
    out["move"] = {"games": GAMES, "sims": BT4_SIMS, "move_s": move_s,
                   "launches": launches, "per_forward": launches / forwards,
                   "deepnorm_ln_launches": ln_launches,
                   "dense_mish_launches": dm_launches,
                   "sims_per_s": GAMES * BT4_SIMS / move_s}
    # the kernel inside the replays: a short captured search profiled
    prof = profile_search(states, eval_fn, tag=f"bt4_{GAMES}_captured")
    name = next((k for k in prof["kernel_calls"]
                 if "smolgen_attention_kernel" in k), None)
    check(name is not None, "no smolgen_attention_kernel in the profile")
    out["in_graph"] = {
        "launches": prof["kernel_calls"][name],
        "device_ms": prof["kernels_ms"][name],
        "ms_per_launch": prof["kernels_ms"][name] / prof["kernel_calls"][name]}
    check(out["in_graph"]["launches"] == layers * (PROFILE_SIMS + 1),
          f"profile: {out['in_graph']['launches']} smolgen_attention_kernel "
          f"launches in {PROFILE_SIMS + 1} forwards")
    name = next((k for k in prof["kernel_calls"]
                 if "deepnorm_ln_kernel" in k), None)
    check(name is not None, "no deepnorm_ln_kernel in the profile")
    n = prof["kernel_calls"][name]
    out["ln_in_graph"] = {"launches": n,
                          "device_ms": prof["kernels_ms"][name],
                          "ms_per_launch": prof["kernels_ms"][name] / n}
    check(n == 2 * layers * (PROFILE_SIMS + 1),
          f"profile: {n} deepnorm_ln_kernel launches in "
          f"{PROFILE_SIMS + 1} forwards")
    name = next((k for k in prof["kernel_calls"]
                 if "dense_mish_kernel" in k), None)
    check(name is not None, "no dense_mish_kernel in the profile")
    n = prof["kernel_calls"][name]
    out["dm_in_graph"] = {"launches": n,
                          "device_ms": prof["kernels_ms"][name],
                          "ms_per_launch": prof["kernels_ms"][name] / n}
    check(n == (layers + 1) * (PROFILE_SIMS + 1),
          f"profile: {n} dense_mish_kernel launches in "
          f"{PROFILE_SIMS + 1} forwards")
    out["card"] = card
    print("smolgen main path " + json.dumps(out["move"]) + "; in the "
          "replays " + json.dumps(out["in_graph"]) + "; deepnorm_ln in the "
          "replays " + json.dumps(out["ln_in_graph"]) + "; dense_mish in "
          "the replays " + json.dumps(out["dm_in_graph"]), flush=True)
    del eval_fn, net, prep, tree
    torch.cuda.empty_cache()
    return out


# -----------------------------------------------------------------------------
# Phase 20: the nested-bottleneck body's kernels and its captured move
# -----------------------------------------------------------------------------

NBT_SIMS = 400                     # the nbt cell's simulations a move


def nbt_bound_ms(kind, B, C, G=0, cout=0):
    """The least time the card could take for one launch at B boards:
    ``residual_act`` of C channels (y and the residual read, the sum and
    the norm-act written, bf16; four float32 operations an element),
    ``gpool_bias`` of C regular and G pooled channels into ``cout`` (the
    R + G channels read and ``cout`` written, bf16, the float32 matrix and
    norms once; the pool's norm, ReLU and sums, the (3G, R) product and
    the regular channels' add, norm and ReLU as float32 operations) or
    ``bn_act`` (``epilogue_bound_ms``): its bytes at the memory rate or its
    operations at the rate outside the tensor cores, whichever is
    larger."""
    if kind == "bn_act":
        return epilogue_bound_ms("bn_act", B, C)
    n = B * 64
    if kind == "residual_act":
        nbytes, ops = 4 * n * C * 2 + 3 * C * 4, 4 * n * C
    else:
        nbytes = (n * (C + G + cout) * 2
                  + (3 * G * C + 3 * (G + C)) * 4)
        ops = B * (4 * 64 * G + 2 * 3 * G * C + 4 * 64 * C)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations"), nbytes, ops


def nbt_sites(prep, planes):
    """The operands of each distinct site of ``nbt_inference.apply`` on
    ``planes``: the first call of ``residual_act``, ``gpool_bias`` and
    ``bn_act`` at each shape, under ``(kind, shape)``."""
    from alphazero_torch.models import nbt_inference as ni

    sites, saved = {}, {}

    def recorder(kind, fn):
        def record(*args):
            key = f"{kind}_{args[0].shape[-1]}"
            if kind == "gpool_bias":
                key += f"_R{args[4]}"
            sites.setdefault(key, (kind, args))
            return fn(*args)
        return record

    for kind in ("residual_act", "gpool_bias", "bn_act"):
        saved[kind] = getattr(ni, kind)
        setattr(ni, kind, recorder(kind, saved[kind]))
    try:
        ni.apply(prep, planes)
    finally:
        for kind, fn in saved.items():
            setattr(ni, kind, fn)
    torch.cuda.synchronize()
    return sites


@phase("phase 20 nbt")
def phase_nbt(dev, card):
    """The nested-bottleneck body at b28c512nbt's widths, its norms set to
    the statistics of 512 random-play positions: ``residual_act``,
    ``gpool_bias`` and ``bn_act`` at every site shape of a 512-board
    forward against their plain versions (bit-equal; ``gpool_bias``
    within ``gpool_card_check``) and timed beside their bounds and plain
    versions; then a captured 512 x 400 self-play move with the launch
    counters zeroed just before it (84 ``residual_act``, 10 ``gpool_bias``,
    30 ``bn_act`` and 112 ``conv3x3`` a forward, no capture, no host read)
    and a profile of the captured search for the two kernels' device time
    inside the replays."""
    from alphazero_torch.config import Config
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.models import conv, epilogue
    from alphazero_torch.models import nbt_epilogue as ne
    from alphazero_torch.models import nbt_inference as ni
    from alphazero_torch.models.nbt import INNER, is_gpool_block
    from alphazero_torch.models.network import BatchNorm2d, build_network
    from alphazero_torch.search import graph, mcts
    from alphazero_torch.train import selfplay

    cfg = Config(body="nbt", num_simulations=NBT_SIMS, parallel_games=GAMES)
    net = build_network(cfg, dev, torch.Generator().manual_seed(20))
    planes = env.encoded_state(random_positions(GAMES, 20)).to(dev)
    # the norms' running statistics := one float32 batch's, as trained
    # BatchNorms would hold them (an uncalibrated 28-block trunk grows)
    norms = [m for m in net.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.momentum = 1.0
    net.train()
    with torch.no_grad():
        net(planes)
    net.eval()
    for m in norms:
        m.momentum = 0.01
    prep = ni.prepare(net)
    sites = nbt_sites(prep, planes)
    out = {"checks": {}, "times": {}}
    for key, (kind, args) in sites.items():
        before = getattr(ne if kind != "bn_act" else epilogue, kind).launches
        if kind == "residual_act":
            got, want = ne.residual_act(*args), ne.residual_act_plain(*args)
            r = {"far": int(sum((g != w).sum() for g, w in zip(got, want))),
                 "max_abs_err": max(float((g.float() - w.float()).abs().max())
                                    for g, w in zip(got, want))}
            r["ok"] = r["far"] == 0
        elif kind == "bn_act":
            got = epilogue.bn_act(*args)
            want = epilogue.bn_act_plain(*args)
            r = {"far": int((got != want).sum()),
                 "max_abs_err": float((got.float() - want.float()).abs()
                                      .max())}
            r["ok"] = r["far"] == 0
        else:
            got = ne.gpool_bias(*args)
            r = ne.gpool_card_check(*args, got)
        torch.cuda.synchronize()
        after = getattr(ne if kind != "bn_act" else epilogue, kind).launches
        check(after == before + 1, f"{key}: launches not counted")
        out["checks"][key] = r
        check(r["ok"], f"{kind} against its plain version at {key}: {r}")
    check(len([k for k in sites if k.startswith("residual_act")]) == 2
          and len([k for k in sites if k.startswith("gpool_bias")]) == 2
          and len([k for k in sites if k.startswith("bn_act")]) == 3,
          f"the forward's sites: {sorted(sites)}")
    print("nbt kernels against their plain versions at every site of a "
          f"{GAMES}-board forward " + json.dumps(out["checks"]), flush=True)

    # times at every site, the kernel and its plain version in turns
    for key, (kind, args) in sites.items():
        if kind == "residual_act":
            kern = lambda i, a=args: ne.residual_act(*a)
            plain = lambda i, a=args: ne.residual_act_plain(*a)
            bound = nbt_bound_ms(kind, GAMES, args[0].shape[1])
        elif kind == "bn_act":
            kern = lambda i, a=args: epilogue.bn_act(*a)
            plain = lambda i, a=args: epilogue.bn_act_plain(*a)
            bound = nbt_bound_ms(kind, GAMES, args[0].shape[3])
        else:
            kern = lambda i, a=args: ne.gpool_bias(*a)
            plain = lambda i, a=args: ne.gpool_bias_plain(*a)
            bound = nbt_bound_ms(kind, GAMES, args[4], args[2].shape[0] // 3,
                                 args[5])
        turns = [cuda_ms(f, iters=20, warmup=3, sleep_ms=200, what=w)
                 for f, w in ((kern, kind), (plain, "plain"),
                              (kern, kind), (plain, "plain"))]
        t = {"ms": (turns[0] + turns[2]) / 2,
             "plain_ms": (turns[1] + turns[3]) / 2, "turns_ms": turns,
             "call_ms": cuda_ms(kern, iters=20, warmup=3, queued=False),
             "bound_ms": bound[0], "bound_by": bound[1], "bytes": bound[2],
             "ops": bound[3]}
        t["roofline_pct"] = 100 * t["bound_ms"] / t["ms"]
        out["times"][key] = t
    print(f"nbt kernels at {GAMES} boards: " + json.dumps(out["times"]),
          flush=True)
    del sites
    torch.cuda.empty_cache()

    # the main path: a warm-up move captures the simulation, then one
    # counted move of NBT_SIMS replays through selfplay_move
    eval_fn = mcts.make_net_evaluator(net, torch.bfloat16)
    spec = selfplay.search_spec(cfg)
    gen = torch.Generator(device=dev).manual_seed(20)
    states = env.initial_state((GAMES,), device=dev)
    tree = mcts.init_tree(states, spec)
    graph.STATS.reset()
    tree, _, _, _, states = selfplay._searched_move(
        states, tree, gen, eval_fn, spec, cfg.temperature_threshold)
    torch.cuda.synchronize()
    check(graph.STATS.captures == 1,
          f"the first nbt move made {graph.STATS.captures} captures")
    counted = {"residual_act": ne.residual_act, "gpool_bias": ne.gpool_bias,
               "bn_act": epilogue.bn_act, "conv3x3": conv.conv3x3,
               "conv3x3_persistent": conv.conv3x3.persistent}
    graph.STATS.reset()
    mcts.STATS.reset()
    for fn in counted.values():
        fn.launches = 0
    t0 = time.time()
    states, _, probs, _, values = selfplay.selfplay_move(
        states, gen, eval_fn, spec, cfg.temperature_threshold, tree)
    torch.cuda.synchronize()
    move_s = time.time() - t0
    got = {k: fn.launches for k, fn in counted.items()}
    forwards = NBT_SIMS + 1               # the root's and one a simulation
    blocks = cfg.nbt_blocks
    pooled = sum(is_gpool_block(b) for b in range(blocks))
    per_forward = {"residual_act": (INNER + 1) * blocks,
                   "gpool_bias": pooled + 1, "bn_act": 1 + blocks + 1,
                   "conv3x3": 2 * INNER * blocks,
                   "conv3x3_persistent": 2 * INNER * blocks}
    check(all(got[k] == n * forwards for k, n in per_forward.items())
          and graph.STATS.captures == 0
          and graph.STATS.replays == NBT_SIMS
          and mcts.STATS.levels == 0,
          f"a captured nbt move of {NBT_SIMS} simulations: launches {got} "
          f"(want {per_forward} a forward, {forwards} forwards), "
          f"{graph.STATS.captures} captures, {graph.STATS.replays} replays, "
          f"{mcts.STATS.levels} host-read levels")
    check(bool(((probs.sum(-1) - 1).abs() < 1e-5).all())
          and bool(torch.isfinite(values).all()), "nbt move's outputs")
    out["move"] = {"games": GAMES, "sims": NBT_SIMS, "move_s": move_s,
                   "launches": got,
                   "per_forward": {k: v / forwards for k, v in got.items()},
                   "sims_per_s": GAMES * NBT_SIMS / move_s}
    # the kernels inside the replays: a short captured search profiled
    prof = profile_search(states, eval_fn, tag=f"nbt_{GAMES}_captured")
    out["in_graph"] = {}
    for kind in ("residual_act", "gpool_bias"):
        name = next((k for k in prof["kernel_calls"]
                     if f"{kind}_kernel" in k), None)
        check(name is not None, f"no {kind}_kernel in the profile")
        n = prof["kernel_calls"][name]
        check(n == per_forward[kind] * (PROFILE_SIMS + 1),
              f"profile: {n} {kind}_kernel launches in {PROFILE_SIMS + 1} "
              "forwards")
        out["in_graph"][kind] = {"launches": n,
                                 "device_ms": prof["kernels_ms"][name],
                                 "ms_per_launch": prof["kernels_ms"][name] / n}
    out["card"] = card
    print("nbt main path " + json.dumps(out["move"]) + "; in the replays "
          + json.dumps(out["in_graph"]), flush=True)
    del eval_fn, net, prep, tree
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
    one ``descend``, ``encode_planes``, ``expand`` and ``commit_edges``
    launch a simulation."""
    from alphazero_torch.parallel import broadcast_int
    from alphazero_torch.search import kernels as K
    from alphazero_torch.search import mcts

    for f in (K.descend, K.commit_edges, K.encode_planes, K.expand):
        f.launches = 0
    mcts.STATS.reset()
    m = tr.run_iteration()
    launches = {"descend": K.descend.launches,
                "commit_edges": K.commit_edges.launches,
                "encode_planes": K.encode_planes.launches,
                "expand": K.expand.launches}
    check(launches["descend"] == launches["commit_edges"]
          == launches["encode_planes"] == launches["expand"]
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
    launches of the tree kernels over all ranks."""
    import torch.distributed as dist

    check(dist.is_nccl_available(), "this PyTorch build has no NCCL")
    launches = {"descend": 0, "commit_edges": 0, "encode_planes": 0,
                "expand": 0}
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


MZ_SIMS = 800                      # MuZero's board-game simulations


def muzero_bound_ms(kind, B, C):
    """(least ms, what binds it, bytes, operations) of one launch of
    MuZero's kernels at B boards of width C: ``action_term`` reads y and
    writes its output (bf16), a few operations an element;
    ``latent_scale`` reads x and writes it twice."""
    n = B * 64 * C
    moved = (2 if kind == "action_term" else 3) * n * 2
    ops = (6 if kind == "action_term" else 4) * n
    ms = max(moved / 3.35e12, ops / 989e12) * 1e3
    return ms, "bytes" if moved / 3.35e12 >= ops / 989e12 else "ops", \
        moved, ops


@phase("phase 21 muzero")
def phase_muzero(dev, card):
    """MuZero at the paper's widths: its kernels against their plain
    versions and timed, its tree kernels against theirs, and a captured
    512 x 800 move against the eager one (phase list above)."""
    from alphazero_torch.config import Config
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.models import conv
    from alphazero_torch.models import muzero_inference as mi
    from alphazero_torch.models.nbt_epilogue import residual_act
    from alphazero_torch.models.network import BatchNorm2d, build_network
    from alphazero_torch.search import graph, kernels, mcts
    from alphazero_torch.train import selfplay

    cfg = Config(body="muzero", num_simulations=MZ_SIMS,
                 parallel_games=GAMES)
    net = build_network(cfg, dev, torch.Generator().manual_seed(21))
    planes = env.encoded_state(random_positions(GAMES, 21)).to(dev)
    acts = torch.randint(0, 192, (GAMES,), device=dev,
                         generator=torch.Generator(dev).manual_seed(21))
    norms = [m for m in net.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.momentum = 1.0
    net.train()
    with torch.no_grad():
        s = net.represent(planes)
        net.predict(s)
        net.dynamics(s, acts)
    net.eval()
    for m in norms:
        m.momentum = 0.01
    prep = mi.prepare(net)
    C = cfg.mz_filters
    out = {"checks": {}, "times": {}}

    # the kernels against their plain versions: action_term over all 192
    # actions (every edge and corner of the padding), latent_scale with
    # its store write at a slot
    x = torch.rand((GAMES * 64, C), device=dev).to(torch.bfloat16) * 4 - 2
    every = torch.arange(GAMES, device=dev, dtype=torch.int32) % 192
    t = prep["dynamics"]
    args = (x, every, t["taps"], t["ones"], t["bn"])
    got = mi.action_term(*args)
    want = mi.action_term_plain(*(a.cpu() for a in args[:4]),
                                tuple(b.cpu() for b in args[4]))
    out["checks"]["action_term"] = {
        "unequal": int((got.cpu() != want).sum()),
        "max_abs_err": float((got.cpu().float() - want.float()).abs().max())}
    store = torch.zeros((GAMES, 3, 64, C), dtype=torch.bfloat16, device=dev)
    slot = torch.full((), 2, dtype=torch.int32, device=dev)
    got = mi.latent_scale(x, store, slot)
    cpu_store = torch.zeros(store.shape, dtype=torch.bfloat16)
    want = mi.latent_scale_plain(x.cpu(), cpu_store, slot.cpu())
    out["checks"]["latent_scale"] = {
        "unequal": int((got.cpu() != want).sum())
        + int((store.cpu() != cpu_store).sum()),
        "max_abs_err": float((got.cpu().float() - want.float()).abs().max())}
    for k, r in out["checks"].items():
        check(r["unequal"] == 0, f"{k} against its plain version: {r}")
    print("muzero kernels against their plain versions at "
          f"{GAMES} boards " + json.dumps(out["checks"]), flush=True)
    for kind, kern in (
            ("action_term", lambda i: mi.action_term(*args)),
            ("latent_scale", lambda i: mi.latent_scale(x, store, slot)),
            ("residual_act", lambda i: residual_act(x, prep["identity"], x))):
        turns = [cuda_ms(kern, iters=20, warmup=3, sleep_ms=200, what=kind)
                 for _ in range(2)]
        bound = muzero_bound_ms(kind, GAMES, C)
        tm = {"ms": sum(turns) / 2, "turns_ms": turns, "bound_ms": bound[0],
              "bound_by": bound[1], "bytes": bound[2], "ops": bound[3]}
        tm["roofline_pct"] = 100 * tm["bound_ms"] / tm["ms"]
        out["times"][kind] = tm
    print(f"muzero kernels at {GAMES} boards: " + json.dumps(out["times"]),
          flush=True)

    # the main path: a warm-up move captures the simulation; the counted
    # move replays it
    eval_fn = mcts.make_net_evaluator(net, torch.bfloat16)
    spec = selfplay.search_spec(cfg)
    gen = torch.Generator(device=dev).manual_seed(21)
    states = env.initial_state((GAMES,), device=dev)
    tree = mcts.init_tree(states, spec)
    graph.STATS.reset()
    _, _, _, _, states = selfplay._searched_move(
        states, tree, gen, eval_fn, spec, cfg.temperature_threshold)
    torch.cuda.synchronize()
    check(graph.STATS.captures == 1,
          f"the first muzero move made {graph.STATS.captures} captures")
    counted = {"conv3x3": conv.conv3x3,
               "conv3x3_persistent": conv.conv3x3.persistent,
               "residual_act": residual_act,
               "action_term": mi.action_term,
               "latent_scale": mi.latent_scale,
               "descend_latent": kernels.descend_latent,
               "gather_latent": kernels.gather_latent,
               "expand_latent": kernels.expand_latent,
               "commit_rewards": kernels.commit_rewards}
    graph.STATS.reset()
    mcts.STATS.reset()
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    states, _, probs, _, values = selfplay.selfplay_move(
        states, gen, eval_fn, spec, cfg.temperature_threshold, tree)
    torch.cuda.synchronize()
    move_s = time.time() - t0
    got = {k: fn.launches for k, fn in counted.items()}
    blocks = cfg.mz_blocks
    per_sim = {"conv3x3": 2 * blocks + 2,
               "conv3x3_persistent": 2 * blocks + 2, "residual_act": blocks,
               "action_term": 1, "latent_scale": 1, "descend_latent": 1,
               "gather_latent": 1, "expand_latent": 1, "commit_rewards": 1}
    root = {"conv3x3": 2 * blocks + 2, "conv3x3_persistent": 2 * blocks + 2,
            "residual_act": blocks, "latent_scale": 1}
    want = {k: n * MZ_SIMS + root.get(k, 0) for k, n in per_sim.items()}
    check(got == want and graph.STATS.captures == 0
          and graph.STATS.replays == MZ_SIMS
          and mcts.STATS.levels == 0,
          f"a captured muzero move of {MZ_SIMS} simulations: launches "
          f"{got} (want {want}), {graph.STATS.captures} captures, "
          f"{graph.STATS.replays} replays, {mcts.STATS.levels} host-read "
          "levels")
    check(bool(((probs.sum(-1) - 1).abs() < 1e-5).all())
          and bool(torch.isfinite(values).all()), "muzero move's outputs")
    out["move"] = {"games": GAMES, "sims": MZ_SIMS, "move_s": move_s,
                   "launches": got, "sims_per_s": GAMES * MZ_SIMS / move_s,
                   "memory_peak_bytes": torch.cuda.max_memory_allocated(),
                   "latent_bytes": tree.latent.numel() * 2}

    # the tree kernels against their plain versions on this searched tree:
    # one more simulation's steps, card against CPU copies
    cpu_tree = mcts.Tree(
        rows=tree.rows.cpu(), root_state=env.EnvState(*(
            getattr(tree.root_state, f).cpu() for f in
            ("board", "turn", "winner", "done", "move_count"))),
        root_visit=tree.root_visit.cpu(), root_vsum=tree.root_vsum.cpu(),
        node_count=tree.node_count.cpu(), next_slot=tree.next_slot.cpu(),
        parents=tree.parents.cpu(), n_actions=192)
    cpu_tree.latent, cpu_tree.reward = tree.latent.cpu(), tree.reward.cpu()
    # the tree is full after the move: run the step at its last slot
    tree.next_slot.fill_(MZ_SIMS)
    cpu_tree.next_slot.fill_(MZ_SIMS)
    A = 192
    d_card = kernels.descend_latent(tree.rows, tree.root_visit,
                                    tree.root_vsum, A, spec.c_puct)
    d_cpu = kernels.descend_latent(cpu_tree.rows, cpu_tree.root_visit,
                                   cpu_tree.root_vsum, A, spec.c_puct)
    # the path past a game's depth is unspecified (the plain loop writes
    # every level of every game)
    walked = (torch.arange(d_cpu[3].shape[1])[None] < d_cpu[2][:, None])
    diffs = {"descend_latent": sum(int((a.cpu() != b).sum())
                                   for a, b in zip(d_card[1:3], d_cpu[1:3]))
             + sum(int(((a.cpu() != b) & walked).sum())
                   for a, b in zip(d_card[3:5], d_cpu[3:5]))}
    g_card = kernels.gather_latent(tree.latent, *d_card[2:5])
    g_cpu = kernels.gather_latent(cpu_tree.latent, *d_cpu[2:5])
    diffs["gather_latent"] = sum(int((a.cpu() != b).sum())
                                 for a, b in zip(g_card, g_cpu))
    pol, val, rew, _ = eval_fn.recurrent(*g_card)
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    v_card = kernels.expand_latent(tree, d_card[1], d_card[2], pol, val,
                                   rew, acc)
    v_cpu = kernels.expand_latent(cpu_tree, d_cpu[1], d_cpu[2], pol.cpu(),
                                  val.cpu(), rew.cpu(),
                                  torch.zeros((), dtype=torch.int64))
    diffs["expand_latent"] = (int((v_card.cpu() != v_cpu).sum())
                              + int((tree.rows.cpu() != cpu_tree.rows).sum())
                              + int((tree.reward.cpu()
                                     != cpu_tree.reward).sum()))
    for tr, d, v in ((tree, d_card, v_card), (cpu_tree, d_cpu, v_cpu)):
        kernels.commit_rewards(tr.rows, tr.reward, d[3], d[4], d[2], d[1], v,
                               tr.next_slot, tr.root_vsum, (0, 2 * A, 3 * A),
                               A)
    diffs["commit_rewards"] = (
        int((tree.rows.cpu() != cpu_tree.rows).sum())
        + int((tree.root_vsum.cpu() != cpu_tree.root_vsum).sum()))
    check(all(v == 0 for v in diffs.values()),
          f"muzero tree kernels against their plain versions: {diffs}")
    out["tree_kernels_unequal"] = diffs
    del cpu_tree

    # the captured move against the eager one, from the same roots and
    # noise: trees and stores equal
    trees = {}
    for capture in (None, False):
        g = torch.Generator(device=dev).manual_seed(2121)
        tr = mcts.init_tree(states, spec, tree=tree if capture is None
                            else None)
        mcts.search(states, eval_fn, spec, generator=g, add_noise=True,
                    tree=tr, capture=capture)
        trees[capture] = (tr.rows.clone(), tr.root_vsum.clone(),
                          tr.latent[:, :MZ_SIMS // 8].clone())
        del tr
        torch.cuda.empty_cache()
    same = [int((a != b).sum()) for a, b in zip(trees[None], trees[False])]
    check(all(v == 0 for v in same),
          f"captured muzero search against the eager one: {same} unequal")
    del trees
    out["card"] = card
    print("muzero main path " + json.dumps(out["move"])
          + "; tree kernels unequal " + json.dumps(diffs), flush=True)
    prof = profile_search(states, eval_fn, tag=f"muzero_{GAMES}_captured")
    out["profile"] = {k: prof[k] for k in ("wall_s", "busy_s",
                                           "idle_share")}
    del eval_fn, net, prep, tree
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    """Runs every phase; ``python3 chip_smoke.py tower fused`` (any of
    kernels, tower, epilogue, conv, search, cpu, graph, glue, smolgen, nbt,
    muzero, continuous, fused, trainer, qconv, quant, arena, bench, web, dist) runs
    only those, for
    work on one of them, and then
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
    libs = cuda_build.build(sorted(p.stem
                                   for p in cuda_build.CSRC.glob("*.cu")))
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
    if want("epilogue"):
        epilogue_t = phase_epilogue(dev, net)
    if want("conv"):
        conv_t = phase_conv(dev, net)
    if want("search"):
        launches.update(phase_search(dev, net, card)[0])
    if want("cpu"):
        phase_card_vs_cpu(dev)
    if want("graph"):
        phase_graph(dev, net, card)
    if want("glue"):
        glue_err, glue_t, _ = phase_glue(dev, net)
    if want("smolgen"):
        smolgen = phase_smolgen(dev, card)
    if want("nbt"):
        nbt = phase_nbt(dev, card)
    if want("muzero"):
        muzero = phase_muzero(dev, card)
    if want("continuous"):
        phase_continuous(dev, net, card)
    if want("fused"):
        fused_launches = phase_fused(dev, net, card)
    trainer_step_ms = None
    if want("trainer"):
        trainer_launches, trainer_step_ms = phase_trainer(dev, card)
    if want("qconv") or want("quant") or want("arena"):
        qconv_err, qconv_t, qconv_bound, qp, act = phase_qconv(dev, net)
    if want("quant") or want("arena"):
        quant_launches, evals, _ = phase_quant_search(dev, net, card, qp, act)
        launches["qconv3x3"] = quant_launches["qconv3x3"]
        int8_tail_launches = quant_launches["se_residual"]
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
        # and nowhere on the search path; at 512 boards the bf16 forward
        # runs its tower as tower_forward, so se_residual's are the int8
        # forward's
        on_path = ("descend", "commit_edges", "encode_planes", "expand",
                   "tower_forward", "qconv3x3", "conv3x3", "bn_act")
        check(all(launches[k] > 0 for k in on_path)
              and int8_tail_launches > 0
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
        # the simulation's glue, XLA's fusions in the JAX package's jitted
        # simulation; launches are phase 3's bf16 move, int8_launches phase
        # 10's int8-static move, web_launches phase 13's bot,
        # trainer_launches phase 8's two iterations, dist_launches phase
        # 14's ranks; times at 512 games and, under one_game, at one
        replaces = {
            "encode_planes": "alphazero_tpu/env/breakthrough.py:231-236 "
                             "(encoded_state, at alphazero_tpu/search/"
                             "mcts.py:377)",
            "expand": "alphazero_tpu/search/mcts.py:380-420, 453-464"}
        for name in ("encode_planes", "expand"):
            t, t1 = glue_t[f"{name}_{GAMES}"], glue_t[f"{name}_1"]
            kernels.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces[name], "launches": launches[name],
                "int8_launches": quant_launches[name],
                "web_launches": web_launches[name],
                "trainer_launches": trainer_launches[name],
                "dist_launches": dist_launches[name],
                "tolerance": "bit-equal", "max_abs_err": glue_err[name],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": "bytes",
                "library_ms": None, "call_ms": t["call_ms"],
                "plain_call_ms": t["plain_call_ms"],
                "launch_floor_ms": glue_t["floor_ms"],
                "launch_floor_call_ms": glue_t["floor_call_ms"],
                "one_game": t1})
        kernels.append({
            "name": "tower_forward", "route": "cuda",
            "source": "alphazero_torch/csrc/tower_kernel.cu",
            "replaces": "alphazero_tpu/models/fused.py:178",
            "launches": launches["tower_forward"],
            "fused_path_launches": fused_launches,
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
        # XLA fusions of the JAX package's bf16 forward (and the int8
        # forward's block tail), not Pallas kernels; launches are phase
        # 3's bf16 move, int8_launches phase 10's int8-static move,
        # web_launches phase 13's bot
        replaces = {
            "bn_act": "alphazero_tpu/models/network.py:68-70",
            "se_residual": "alphazero_tpu/models/network.py:74-77, "
                           "alphazero_tpu/models/quant.py:185-186"}
        tolerance = {"bn_act": "bit-equal",
                     "se_residual": "float64 sums: 1 bf16 step, "
                                    "epilogue.SE_UNEQUAL_SHARE unequal"}
        for name in ("bn_act", "se_residual"):
            t = dict(epilogue_t[name])
            kernels.append({
                "name": name, "route": "cuda",
                "source": "alphazero_torch/csrc/epilogue_kernels.cu",
                "replaces": replaces[name], "launches": launches[name],
                "web_launches": web_launches[name],
                "tolerance": tolerance[name],
                "max_abs_err": t.pop("max_abs_err"), "ms": t.pop("ms"),
                "plain_ms": t.pop("plain_ms"), "bound_ms": t.pop("bound_ms"),
                "bound_by": t.pop("bound_by"),
                "library_ms": t.pop("library_ms"), **t})
        kernels[-1]["int8_launches"] = int8_tail_launches
        # the bf16 forward's 3x3 convs (XLA's, not a Pallas kernel; the
        # fused tower's TPU kernel computes the same conv in its body);
        # launches are phase 3's bf16 move, web_launches phase 13's bot
        t = dict(conv_t)
        kernels.append({
            "name": "conv3x3", "route": "cuda",
            "source": "alphazero_torch/csrc/conv_kernels.cu",
            "replaces": "alphazero_tpu/models/network.py:66-67, 71-72, "
                        "151-152; conv body of "
                        "alphazero_tpu/models/fused.py:202-213",
            "launches": launches["conv3x3"],
            "web_launches": web_launches["conv3x3"],
            "tolerance": "float64 sums: 1 bf16 step or the f32 sum's bound, "
                         "max(2 x cuDNN's share, conv.CONV_UNEQUAL_SHARE) "
                         "unequal; epilogue bit-equal",
            "max_abs_err": t.pop("max_abs_err"), "ms": t.pop("ms"),
            "plain_ms": t.pop("plain_ms"), "bound_ms": t.pop("bound_ms"),
            "bound_by": t.pop("bound_by"),
            "library_ms": t.pop("library_ms"), **t})
        # the encoder body's attention (no kernel of the JAX package);
        # launches are phase 19's captured BT4 move
        t = dict(smolgen["times"])
        kernels.append({
            "name": "smolgen_attention", "route": "cuda",
            "source": "alphazero_torch/csrc/attention_kernels.cu",
            "replaces": None, "launches": smolgen["move"]["launches"],
            "tolerance": "2^-8 of the sum of |V| twice and two bf16 steps; "
                         "under 2% unequal",
            "max_abs_err": max(c["max_abs_err"]
                               for c in smolgen["checks"].values()),
            "ms": t.pop("ms"), "plain_ms": t.pop("plain_ms"),
            "bound_ms": t.pop("bound_ms"), "bound_by": t.pop("bound_by"),
            "library_ms": None, "in_graph": smolgen["in_graph"], **t})
        # the encoder body's DeepNorm residual and LayerNorm (no kernel of
        # the JAX package); launches are phase 19's captured BT4 move
        t = dict(smolgen["ln_times"])
        kernels.append({
            "name": "deepnorm_ln", "route": "cuda",
            "source": "alphazero_torch/csrc/encoder_kernels.cu",
            "replaces": None,
            "launches": smolgen["move"]["deepnorm_ln_launches"],
            "tolerance": "encoder_epilogue.card_check: two bf16 steps and "
                         "2^-16 of the affine's terms; "
                         "encoder_epilogue.UNEQUAL_SHARE unequal",
            "max_abs_err": max(c["max_abs_err"]
                               for c in smolgen["ln_checks"].values()),
            "ms": t.pop("ms"), "plain_ms": t.pop("plain_ms"),
            "bound_ms": t.pop("bound_ms"), "bound_by": t.pop("bound_by"),
            "library_ms": t.pop("library_ms"),
            "in_graph": smolgen["ln_in_graph"], **t})
        # the encoder body's feed-forward product with its bias and Mish
        # (no kernel of the JAX package); launches are phase 19's move
        t = dict(smolgen["dm_times"])
        kernels.append({
            "name": "dense_mish", "route": "cuda",
            "source": "alphazero_torch/csrc/encoder_kernels.cu",
            "replaces": None,
            "launches": smolgen["move"]["dense_mish_launches"],
            "tolerance": "encoder_epilogue.dense_card_check: two bf16 steps "
                         "and 2^-16 of the sum of |x w|; "
                         "encoder_epilogue.DENSE_UNEQUAL_SHARE unequal",
            "max_abs_err": max(c["max_abs_err"]
                               for c in smolgen["dm_checks"].values()),
            "ms": t.pop("ms"), "plain_ms": t.pop("plain_ms"),
            "bound_ms": t.pop("bound_ms"), "bound_by": t.pop("bound_by"),
            "library_ms": t.pop("library_ms"),
            "in_graph": smolgen["dm_in_graph"], **t})
        # the nested-bottleneck body's residual closes and global-pooling
        # bias (no kernel of the JAX package); launches are phase 20's
        # captured move, times at the trunk's sites (C 512, and R 192 | G
        # 64 of 256), by_site at every site of a 512-board forward
        tolerance = {"residual_act": "bit-equal",
                     "gpool_bias": "nbt_epilogue.gpool_card_check: one bf16 "
                                   "step and 2^-18 of the norm's terms; "
                                   "GPOOL_UNEQUAL_SHARE unequal"}
        trunk = {"residual_act": "residual_act_512",
                 "gpool_bias": "gpool_bias_256_R192"}
        for name in ("residual_act", "gpool_bias"):
            t = dict(nbt["times"][trunk[name]])
            kernels.append({
                "name": name, "route": "cuda",
                "source": "alphazero_torch/csrc/nbt_kernels.cu",
                "replaces": None, "launches": nbt["move"]["launches"][name],
                "tolerance": tolerance[name],
                "max_abs_err": max(c["max_abs_err"]
                                   for k, c in nbt["checks"].items()
                                   if k.startswith(name)),
                "ms": t.pop("ms"), "plain_ms": t.pop("plain_ms"),
                "bound_ms": t.pop("bound_ms"), "bound_by": t.pop("bound_by"),
                "library_ms": None, "in_graph": nbt["in_graph"][name],
                "by_site": {k: v for k, v in nbt["times"].items()
                            if k.startswith(name)}, **t})
        # MuZero's dynamics input and scale (no kernel of the JAX
        # package); launches are phase 21's captured 512 x 800 move
        for name in ("action_term", "latent_scale"):
            t = dict(muzero["times"][name])
            kernels.append({
                "name": name, "route": "cuda",
                "source": "alphazero_torch/csrc/muzero_kernels.cu",
                "replaces": None, "launches": muzero["move"]["launches"][name],
                "tolerance": "bit-equal",
                "max_abs_err": muzero["checks"][name]["max_abs_err"],
                "ms": t.pop("ms"), "bound_ms": t.pop("bound_ms"),
                "bound_by": t.pop("bound_by"), "library_ms": None, **t})
        print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
