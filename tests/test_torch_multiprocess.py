"""The port's trainer under a process group: two gloo ranks on the CPU
that this file launches as worker processes of itself, the checks of the
JAX package's two-process harness (``tests/multiprocess_worker.py``):
lockstep iterations with unequal replay shards, coordinator-only writes,
per-rank shards, resume on every rank and the post-save barrier; and the
two refusals of a batch that does not divide over the ranks.

Each worker records its checks in ``result_rank<r>.json``; the tests read
them. The workers import torch and ``alphazero_torch`` only.
"""

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from test_torch_parallel import launch, worker_main

WORLD = 2
SECTIONS = {
    "lockstep": ["nproc_seen_by_trainer", "params_equal_after_iter1",
                 "buffer_sizes_iter1", "params_equal_after_iter2",
                 "buffer_sizes_iter2", "buffer_sizes_unequal_iter2"],
    "coordinator_writes": ["metrics_written_once_per_iteration",
                           "checkpoints_present", "no_stale_tmp_dirs",
                           "host_shards_present", "host_shards_disjoint"],
    "resume": ["resume_iteration", "resume_restores_saved_params",
               "params_equal_after_resume",
               "resume_reloads_host_local_buffer", "post_resume_iteration",
               "params_equal_after_post_resume_iter"],
    "post_save_barrier": ["immediate_resume_after_save_iteration",
                          "immediate_resume_after_save_params"],
    "refusals": ["indivisible_batch_size_refused",
                 "indivisible_learn_batch_refused"],
}


# -----------------------------------------------------------------------------
# Worker side: torch and alphazero_torch only
# -----------------------------------------------------------------------------

def params_digest(state) -> int:
    """63-bit digest of the net's parameters and buffers, in key order."""
    h = hashlib.sha256()
    for k, v in sorted(state.net.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return int.from_bytes(h.digest()[:8], "big") >> 1


def worker_trainer(rank, world, workdir):
    import torch.distributed as dist

    from alphazero_torch.config import tiny_config
    from alphazero_torch.parallel import barrier, make_mesh
    from alphazero_torch.train import Trainer
    from alphazero_torch.train.replay import host_data_path

    mesh = make_mesh(device="cpu")
    result = {"rank": rank, "checks": {}}

    def check(name, ok, detail=""):
        result["checks"][name] = {"ok": bool(ok), "detail": str(detail)}
        if not ok:
            print(f"rank {rank}: CHECK FAILED {name}: {detail}", flush=True)

    def gather(value: int):
        got = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
        dist.all_gather(got, torch.tensor([value]))
        return [int(t) for t in got]

    def same_across_ranks(name, value: int):
        got = gather(value)
        check(name, len(set(got)) == 1, got)

    # batch 128 (64 a rank) keeps each iteration to a few dozen steps
    cfg = tiny_config(
        checkpoint_dir=os.path.join(workdir, "checkpoints"),
        num_blocks=1, num_filters=8, num_simulations=8,
        parallel_games=4, batch_size=128, selfplay_batches=1,
        max_game_length=128)

    tr = Trainer(cfg, seed=0, device="cpu", mesh=mesh)
    check("nproc_seen_by_trainer", tr.world == 2 and tr.rank == rank,
          (tr.world, tr.rank))

    # --- two iterations in lockstep -----------------------------------------
    for it in (1, 2):
        if it == 2 and rank == 1:
            # unequal shard sizes: the step-count broadcast must reconcile
            # the ranks' own counts
            tr.buffer.add_arrays(
                np.zeros((50, 3, 8, 8), np.float32),
                np.full((50, 192), 1 / 192, np.float32),
                np.tile(np.array([1, 0], np.float32), (50, 1)))
        tr.run_iteration()
        same_across_ranks(f"params_equal_after_iter{it}",
                          params_digest(tr.state))
        sizes = gather(len(tr.buffer))
        result["checks"][f"buffer_sizes_iter{it}"] = {"ok": True,
                                                      "detail": str(sizes)}
        if it == 2:
            check("buffer_sizes_unequal_iter2", sizes[0] != sizes[1], sizes)
    digest_after_train = params_digest(tr.state)

    # --- coordinator-only writes and per-rank shards -------------------------
    barrier(mesh)
    ckpt_dir = cfg.checkpoint_dir
    with open(cfg.checkpoint_path("metrics.jsonl")) as f:
        n_lines = sum(1 for _ in f)
    check("metrics_written_once_per_iteration", n_lines == 2, n_lines)
    check("checkpoints_present",
          sorted(d for d in os.listdir(ckpt_dir)
                 if d.startswith("iteration_"))
          == ["iteration_1", "iteration_2"], sorted(os.listdir(ckpt_dir)))
    check("no_stale_tmp_dirs",
          not any(d.endswith(".tmp") for d in os.listdir(ckpt_dir)),
          sorted(os.listdir(ckpt_dir)))
    shards = [host_data_path(cfg.checkpoint_path(cfg.data_file), r)
              for r in range(world)]
    check("host_shards_present", all(os.path.exists(p) for p in shards),
          shards)
    if all(os.path.exists(p) for p in shards):
        d0, d1 = (np.load(p)["policies"] for p in shards)
        # every rank played its own games, from its own streams
        check("host_shards_disjoint",
              d0.shape != d1.shape or not np.array_equal(d0, d1),
              (d0.shape, d1.shape))

    # --- resume on every rank -----------------------------------------------
    tr2 = Trainer(cfg, seed=99, device="cpu", mesh=mesh)
    it = tr2.resume()
    check("resume_iteration", it == 2, it)
    check("resume_restores_saved_params",
          params_digest(tr2.state) == digest_after_train,
          (params_digest(tr2.state), digest_after_train))
    same_across_ranks("params_equal_after_resume", params_digest(tr2.state))
    loaded = gather(len(tr2.buffer))
    check("resume_reloads_host_local_buffer", all(v > 0 for v in loaded),
          loaded)
    tr2.run_iteration()
    check("post_resume_iteration", tr2.iteration == 3, tr2.iteration)
    same_across_ranks("params_equal_after_post_resume_iter",
                      params_digest(tr2.state))

    # --- the post-save barrier: a resume right after run_iteration's save,
    # with no other sync, sees the whole iteration_3 on every rank ---------
    tr3 = Trainer(cfg, seed=7, device="cpu", mesh=mesh)
    it3 = tr3.resume()
    check("immediate_resume_after_save_iteration", it3 == 3, it3)
    check("immediate_resume_after_save_params",
          params_digest(tr3.state) == params_digest(tr2.state), rank)

    # --- a batch that does not divide over the ranks is refused --------------
    try:
        Trainer(cfg.replace(batch_size=127), seed=0, device="cpu", mesh=mesh)
        check("indivisible_batch_size_refused", False, "no error")
    except ValueError as e:
        check("indivisible_batch_size_refused", "divisible" in str(e), e)
    try:
        tr2.learn(batch_size=127)
        check("indivisible_learn_batch_refused", False, "no error")
    except RuntimeError as e:
        check("indivisible_learn_batch_refused", "127" in str(e), e)

    result["ok"] = all(c["ok"] for c in result["checks"].values())
    with open(os.path.join(workdir, f"result_rank{rank}.json"), "w") as f:
        json.dump(result, f, indent=1)


# -----------------------------------------------------------------------------
# Test side
# -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def results(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("multiprocess")
    launch(__file__, "trainer", workdir)
    out = []
    for r in range(WORLD):
        with open(workdir / f"result_rank{r}.json") as f:
            out.append(json.load(f))
    return out


def test_every_check_was_recorded(results):
    """Exactly the JAX harness's 19 checks and the two refusals, on both
    ranks: a vanished check fails here, not under a looser count."""
    want = sorted(sum(SECTIONS.values(), []))
    assert len(want) == 21
    for res in results:
        assert sorted(res["checks"]) == want


@pytest.mark.parametrize("section", sorted(SECTIONS))
def test_two_rank_trainer(results, section):
    for res in results:
        failed = {k: res["checks"][k] for k in SECTIONS[section]
                  if not res["checks"][k]["ok"]}
        assert not failed, (res["rank"], failed)


if __name__ == "__main__":
    worker_main({"trainer": worker_trainer}, sys.argv[1:])
