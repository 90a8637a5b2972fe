"""Judges a searched tree that the timed path left, against the rules.

A tree is one game's rows as the program laid them out: per node slot a
row of four blocks of 192, [child | prior | edge visits | edge value
sum], a child being ILLEGAL (-2), UNALLOCATED (-1) or the child's slot.
The slot of simulation ``i`` is ``i + 1``. Nothing of the program is
imported: the layout is read as data.

From the final tree alone the check works out:

- each node's position, by the reference rules from the root along the
  child pointers, and so each node's legal actions, whether it is final,
  and the planes the reference net is given;
- each node's prior row, and each node's leaf value from the value sums:
  ``v(s) = W(edge into s) + sum of W(edges out of s)`` over the one
  simulation that ended at a new node, ``-1`` a visit at a final node;
- a replay of the simulations in order: simulation ``i``'s path is the
  chain of ancestors of slot ``i + 1`` where it allocated one, else a
  walk to a final node that follows the best PUCT score among the edges
  that final visits still owe. At every level the chosen edge's score may
  lie below the best by rounding only (``select_gap`` is the widest
  shortfall; one past ``SELECT_TOL`` is a mismatch), and the replay's
  visit counts and value sums must come out as the tree's.

The caller evaluates the listed positions with the reference net and
compares priors and values (``compare``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from benchmark.lib import refenv

ILLEGAL, UNALLOCATED = -2.0, -1.0
A = refenv.NUM_ACTIONS
VSUM_TOL = 1e-3          # a value sum worked out again in another order
# a chosen edge's PUCT score may lie below the best by the rounding of the
# leaf values worked out from value sums of up to a few hundred terms (on
# an H100, sound runs read at most 4.4e-5); beyond it the choice is wrong
SELECT_TOL = 1e-3
MAX_TRIES = 64


@dataclasses.dataclass
class Judged:
    """What one tree says, and what it got wrong by the rules."""

    planes: np.ndarray        # (K, 3, 8, 8) positions for the reference net
    legal: np.ndarray         # (K, 192) their legal actions
    prior: np.ndarray         # (K, 192) the program's priors there
    value: np.ndarray         # (K,) the leaf values (NaN: no value, root)
    tree_mismatch: int = 0    # structure, visits, value sums, final nodes
    env_mismatch: int = 0     # legal actions, final positions
    select_gap: float = 0.0   # the widest PUCT shortfall of a chosen edge
    root_visits: Optional[np.ndarray] = None


def judge(rows: np.ndarray, board: np.ndarray, turn: int, root_visit: int,
          root_vsum: float, sims: int, c_puct: float,
          root_noise: bool) -> Judged:
    """Judge one game's tree. ``rows`` (M, >= 4 * 192) float32; the root's
    ``board`` (8, 8) and ``turn``. ``root_noise``: the root's priors were
    mixed with noise, so they are held only to being a distribution over
    its legal actions, and the root is not among the positions listed."""
    flat = rows.reshape(rows.shape[0], -1).astype(np.float32)
    child, prior = flat[:, :A], flat[:, A:2 * A]
    visits, vsum = flat[:, 2 * A:3 * A], flat[:, 3 * A:4 * A]
    bad_tree = bad_env = 0

    # --- structure: who points at whom -------------------------------
    parent = np.full(sims + 1, -1)
    pact = np.full(sims + 1, -1)
    for s in range(sims + 1):
        for a in np.flatnonzero(child[s] > 0.5):
            c = int(child[s, a])
            if c != child[s, a] or not s < c <= sims or parent[c] >= 0:
                bad_tree += 1
                continue
            parent[c], pact[c] = s, a
    alloc = parent >= 0
    alloc[0] = False
    nodes = np.flatnonzero(alloc)
    # an edge was walked only if its child exists
    walked_free = (visits[:sims + 1] != 0) & ~(child[:sims + 1] > 0.5)
    bad_tree += int(walked_free.sum())

    # --- positions by the reference rules ------------------------------
    boards = np.zeros((sims + 1, 8, 8), np.int8)
    turns = np.zeros(sims + 1, np.int8)
    winner = np.zeros(sims + 1, np.int8)
    boards[0], turns[0] = board, turn
    for s in nodes:                 # children come after their parents
        p = parent[s]
        if winner[p]:
            bad_tree += 1           # a final position has no children
            continue
        b, t, w = refenv.step(boards[p:p + 1], turns[p:p + 1], pact[s:s + 1])
        boards[s], turns[s], winner[s] = b[0], t[0], w[0]
    live = [0] + [int(s) for s in nodes if not winner[s]]
    final = [int(s) for s in nodes if winner[s]]
    legal = refenv.legal_mask(boards[live], turns[live])
    bad_env += int(((child[live] != ILLEGAL) != legal).sum())
    bad_env += sum(int((child[s] != ILLEGAL).any() or (prior[s] != 0).any())
                   for s in final)

    # --- leaf values from the value sums --------------------------------
    v = np.full(sims + 1, np.nan, np.float64)
    for s in nodes:
        p, a = parent[s], pact[s]
        out_v = visits[s][child[s] > 0.5].astype(np.float64).sum()
        out_w = vsum[s][child[s] > 0.5].astype(np.float64).sum()
        k = float(visits[p, a]) - out_v
        if winner[s]:
            if k < 1 or vsum[p, a] != -visits[p, a]:
                bad_tree += 1
            v[s] = -1.0
        else:
            if k != 1:
                bad_tree += 1
            v[s] = float(vsum[p, a]) + out_w
    if visits[0].sum() != root_visit or root_visit != sims:
        bad_tree += 1
    if abs(root_vsum + float(vsum[0].astype(np.float64).sum())) > VSUM_TOL:
        bad_tree += 1

    # --- the replay -------------------------------------------------------
    gap, replay_bad = _replay(child, prior, visits, vsum, v, parent, pact,
                              alloc, winner, sims, c_puct)
    bad_tree += replay_bad

    if root_noise:
        rp = prior[0]
        lg = legal[0]
        if (abs(rp.sum() - 1) > 1e-4 or (rp < 0).any()
                or (rp[~lg] != 0).any()):
            bad_tree += 1
        listed = live[1:]
        return Judged(planes=refenv.planes(boards[listed], turns[listed]),
                      legal=legal[1:], prior=prior[listed], value=v[listed],
                      tree_mismatch=bad_tree, env_mismatch=bad_env,
                      select_gap=gap, root_visits=visits[0].copy())
    return Judged(planes=refenv.planes(boards[live], turns[live]),
                  legal=legal, prior=prior[live], value=v[live],
                  tree_mismatch=bad_tree, env_mismatch=bad_env,
                  select_gap=gap, root_visits=visits[0].copy())


def _replay(child, prior, visits, vsum, v, parent, pact, alloc, winner,
            sims, c_puct):
    """The simulations again, in order, from the tree's priors and leaf
    values. Returns (the widest score shortfall of a chosen edge, the
    mismatches).

    A simulation that ended at a final node left no slot, so its path is
    the replay's own: the best-scoring edge among those that such visits
    still owe. Where several lie within ``SELECT_TOL`` of the best (the
    leaf values, worked out from sums, carry rounding), the choice is
    ambiguous: a replay that fails later comes back to the last such
    choice and takes the next one, at most ``MAX_TRIES`` replays."""
    owed = visits[:sims + 1].astype(np.int64).copy()
    for s in np.flatnonzero(alloc):
        n = s
        while n > 0:
            owed[parent[n], pact[n]] -= 1
            n = parent[n]
    if (owed < 0).any():
        return float("inf"), 1
    paths = []
    for i in range(sims):
        fixed, n = [], (i + 1 if alloc[i + 1] else 0)
        while n > 0:
            fixed.append(pact[n])
            n = parent[n]
        paths.append(fixed[::-1] if alloc[i + 1] else None)
    args = (child, prior, visits, vsum, v, paths, winner, sims, c_puct)
    forced, first = {}, None
    for _ in range(MAX_TRIES):
        gap, bad, points = _replay_once(*args, owed.copy(), forced)
        first = first or (gap, bad)
        if not bad:
            return gap, 0
        for k in range(len(points) - 1, -1, -1):
            key, n_alts, idx = points[k]
            if idx + 1 < n_alts:
                for later, _, _ in points[k + 1:]:
                    forced.pop(later, None)
                forced[key] = idx + 1
                break
        else:
            break
    return first


def _replay_once(child, prior, visits, vsum, v, paths, winner, sims, c_puct,
                 owed, forced):
    """One replay. Returns (widest shortfall, mismatches, the ambiguous
    choices it made: ((simulation, level), choices, the one taken)); it
    stops at the first choice past ``SELECT_TOL``."""
    M = sims + 1
    legal = child[:M] != ILLEGAL
    rv = np.zeros((M, A), np.float32)
    rw = np.zeros((M, A), np.float32)
    gap, points = 0.0, []
    c = np.float32(c_puct)
    neg_inf = np.float32(-np.inf)
    for i in range(sims):
        fixed = paths[i]
        node, n_cur, path = 0, np.float32(i), []
        while True:
            ev, ew = rv[node], rw[node]
            q = np.where(ev > 0, -ew / np.maximum(ev, 1), np.float32(0))
            u = (prior[node] * (c * np.sqrt(max(n_cur, np.float32(1))))
                 / (np.float32(1) + ev))
            score = np.where(legal[node], q + u, neg_inf).astype(np.float32)
            best = score.max()
            if fixed is not None:
                a = fixed[len(path)]
            else:
                cand = np.where(legal[node] & (owed[node] > 0), score,
                                neg_inf)
                top = cand.max()
                if not np.isfinite(top):
                    return float("inf"), 1, points
                order = np.argsort(-cand, kind="stable")
                alts = [int(x) for x in order
                        if cand[x] >= top - np.float32(SELECT_TOL)]
                key = (i, len(path))
                idx = forced.get(key, 0)
                if len(alts) > 1:
                    points.append((key, len(alts), idx))
                a = alts[idx]
                owed[node, a] -= 1
            short = float(best - score[a])
            gap = max(gap, short)
            if short > SELECT_TOL:
                return gap, 1, points
            path.append((node, a))
            n_cur = rv[node, a]
            nxt = int(child[node, a])
            if fixed is not None and len(path) == len(fixed):
                break
            if not 0 < nxt <= i:        # no such node at simulation i
                return float("inf"), 1, points
            node = nxt
            if fixed is None and winner[node]:
                break
        leaf = path[-1]
        value = np.float32(v[int(child[leaf[0], leaf[1]])])
        for d, (nd, a) in enumerate(path):
            sign = np.float32(1 if (len(path) - 1 - d) % 2 == 0 else -1)
            rv[nd, a] += 1
            rw[nd, a] += sign * value
    bad = int((rv != visits[:M]).sum())
    bad += int((np.abs(rw - vsum[:M]) > VSUM_TOL).sum())
    return gap, bad, points


def compare(judged: List[Judged], ref_prior: np.ndarray,
            ref_value: np.ndarray) -> Dict[str, float]:
    """Priors and values of the judged trees' positions (in order) against
    the reference's: total variation distance of the priors and the
    values' absolute gap, mean and widest."""
    prior = np.concatenate([j.prior for j in judged])
    value = np.concatenate([j.value for j in judged])
    tv = 0.5 * np.abs(prior.astype(np.float64) - ref_prior).sum(-1)
    has_v = ~np.isnan(value)
    dv = np.abs(value[has_v] - ref_value[has_v])
    return {"policy_tv_mean": float(tv.mean()),
            "policy_tv_max": float(tv.max()),
            "value_err_mean": float(dv.mean()) if dv.size else 0.0,
            "value_err_max": float(dv.max()) if dv.size else 0.0,
            "positions": int(prior.shape[0])}
