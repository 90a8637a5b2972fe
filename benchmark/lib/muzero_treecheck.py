"""Judges a MuZero search's tree that the timed path left, against the
rules and the backup with rewards.

The tree is ``treecheck``'s layout (per slot a row of four blocks of 192,
[child | prior | edge visits | edge value sum]; the slot of simulation
``i`` is ``i + 1``) plus the search's stores: a reward per slot (the
transition into it, for the player who took it) and a hidden state per
slot ((64, C), the square-major rows the program keeps). Nothing of the
program is imported.

From the final tree alone the check works out:

- the structure: every slot 1..sims allocated exactly once, by one edge,
  after its parent; the root's children are its legal actions (legality
  is a root matter: below it every action is open, none ILLEGAL);
- each node's leaf value from the value sums with rewards: an edge's sum
  holds ``-G`` a simulation, ``G = r(child) - G(child)``, so ``v(s) =
  W(edge into s) + sum of W(edges out of s) + N(edge into s) r(s)`` over
  the one simulation that ended at s, with ``N(edge into s) = 1 + the
  visits out of s``;
- a replay of the simulations in order (every simulation allocates a
  slot, so its path is the chain of ancestors of slot ``i + 1``): at every
  level the chosen edge's PUCT score may lie below the best by rounding
  only (``select_gap``; past ``treecheck.SELECT_TOL`` a mismatch), and the
  replay's visits and value sums, backed up by ``refmuzero.backup``, must
  come out as the tree's.

The root's planes and state, and each node's parent state, edge action,
stored state, reward, priors and leaf value, go to
``muzero.evaluator_numbers``, which compares them with the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.lib import refenv, refmuzero, treecheck

A = refenv.NUM_ACTIONS
ILLEGAL = treecheck.ILLEGAL


@dataclasses.dataclass
class Judged:
    """What one tree says, and what it got wrong."""

    root_planes: np.ndarray   # (3, 8, 8)
    root_latent: np.ndarray   # (64, C) the stored root state
    parent_latent: np.ndarray  # (K, 64, C) each node's parent's state
    action: np.ndarray        # (K,) the edge into each node
    latent: np.ndarray        # (K, 64, C) each node's stored state
    prior: np.ndarray         # (K, 192) its priors
    value: np.ndarray         # (K,) its leaf value
    reward: np.ndarray        # (K,) its stored reward
    tree_mismatch: int = 0
    env_mismatch: int = 0
    select_gap: float = 0.0


def judge(rows: np.ndarray, reward: np.ndarray, latent: np.ndarray,
          board: np.ndarray, turn: int, root_visit: int, root_vsum: float,
          sims: int, c_puct: float) -> Judged:
    """Judge one game's tree: ``rows`` (M, >= 4 * 192) float32, ``reward``
    (M,), ``latent`` (>= sims + 1, 64, C) as float32; the root's
    ``board`` and ``turn``. The root's priors were mixed with noise: they
    are held only to being a distribution over its legal actions."""
    flat = rows.reshape(rows.shape[0], -1).astype(np.float32)
    child, prior = flat[:, :A], flat[:, A:2 * A]
    visits, vsum = flat[:, 2 * A:3 * A], flat[:, 3 * A:4 * A]
    M = sims + 1
    bad_tree = bad_env = 0

    parent = np.full(M, -1)
    pact = np.full(M, -1)
    for s in range(M):
        for a in np.flatnonzero(child[s] > 0.5):
            c = int(child[s, a])
            if c != child[s, a] or not s < c <= sims or parent[c] >= 0:
                bad_tree += 1
                continue
            parent[c], pact[c] = s, a
    nodes = np.arange(1, M)
    bad_tree += int((parent[1:] < 0).sum())          # every sim allocated
    walked_free = (visits[:M] != 0) & ~(child[:M] > 0.5)
    bad_tree += int(walked_free.sum())
    # below the root every action is open
    bad_tree += int((child[1:M] == ILLEGAL).sum())
    legal = refenv.legal_mask(board[None], np.array([turn], np.int8))[0]
    bad_env += int(((child[0] != ILLEGAL) != legal).sum())
    rp = prior[0]
    if abs(rp.sum() - 1) > 1e-4 or (rp < 0).any() or (rp[~legal] != 0).any():
        bad_tree += 1

    ok = parent[1:] >= 0
    nodes = nodes[ok]
    v = np.full(M, np.nan, np.float64)
    for s in nodes:
        p, a = parent[s], pact[s]
        out = child[s] > 0.5
        out_v = visits[s][out].astype(np.float64).sum()
        out_w = vsum[s][out].astype(np.float64).sum()
        if float(visits[p, a]) - out_v != 1:
            bad_tree += 1
        v[s] = float(vsum[p, a]) + out_w + float(visits[p, a]) * reward[s]
    if visits[0].sum() != root_visit or root_visit != sims:
        bad_tree += 1
    if abs(root_vsum + float(vsum[0].astype(np.float64).sum())) \
            > treecheck.VSUM_TOL:
        bad_tree += 1

    gap, replay_bad = _replay(child, prior, visits, vsum, reward, v, parent,
                              pact, sims, c_puct)
    bad_tree += replay_bad
    return Judged(
        root_planes=refenv.planes(board[None], np.array([turn]))[0],
        root_latent=latent[0], parent_latent=latent[parent[nodes]],
        action=pact[nodes].astype(np.int64), latent=latent[nodes],
        prior=prior[nodes], value=v[nodes],
        reward=reward[nodes].astype(np.float64),
        tree_mismatch=bad_tree, env_mismatch=bad_env, select_gap=gap)


def _replay(child, prior, visits, vsum, reward, v, parent, pact, sims,
            c_puct):
    """The simulations again, in order, from the tree's priors, leaf
    values and rewards. Returns (the widest score shortfall of a chosen
    edge, the mismatches)."""
    M = sims + 1
    if (parent[1:] < 0).any() or np.isnan(v[1:]).any():
        return float("inf"), 1
    legal = child[:M] != ILLEGAL
    rv = np.zeros((M, A), np.float32)
    rw = np.zeros((M, A), np.float32)
    gap = 0.0
    c = np.float32(c_puct)
    neg_inf = np.float32(-np.inf)
    for i in range(sims):
        path, n = [], i + 1
        while n > 0:
            path.append((parent[n], pact[n]))
            n = parent[n]
        path = path[::-1]
        n_cur = np.float32(i)
        for node, a in path:
            ev, ew = rv[node], rw[node]
            q = np.where(ev > 0, -ew / np.maximum(ev, 1), np.float32(0))
            u = (prior[node] * (c * np.sqrt(max(n_cur, np.float32(1))))
                 / (np.float32(1) + ev))
            score = np.where(legal[node], q + u, neg_inf).astype(np.float32)
            short = float(score.max() - score[a])
            gap = max(gap, short)
            if short > treecheck.SELECT_TOL:
                return gap, 1
            n_cur = rv[node, a]
        refmuzero.backup(path, v[i + 1],
                         lambda nd, a: reward[int(child[nd, a])], rv, rw)
    bad = int((rv != visits[:M]).sum())
    bad += int((np.abs(rw - vsum[:M]) > treecheck.VSUM_TOL).sum())
    return gap, bad
