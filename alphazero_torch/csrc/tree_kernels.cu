// Search-tree kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// The search tree is one float32 tensor rows[B, M, R] (R = RS*128 = 768 at
// 192 actions): per game b and node slot n, a fused row holding the blocks
// [child ptr | prior | edge visit | edge vsum], each of width A. Each
// simulation walks one path per game from the root (the descent: at every
// node score the row, take the best action, step the game's board) and then
// adds three scalars into every row of that path (the backprop).
//
// descend and fetch_rows both replace
// alphazero_tpu/search/kernels.py:_fetch_rows_tpu (pallas_call at
// kernels.py:80), the row read of the descent. fetch_rows is the gather as
// the TPU kernel has it, one launch per level; descend is its design for
// this card, the whole descent of a simulation in one launch, and it is
// what the search runs. fetch_rows stays as the row read of the plain
// per-level descent, which the CPU runs and which holds descend to account
// on the card.
//
// descend: for every game, the loop of alphazero_tpu/search/mcts.py:267-356.
//   Start at the root with the root's game state. Per level: read the row
//   rows[b, cur] where it lies; legal = child > -1.5; no legal action: stop.
//   Score q + u with q = ev > 0 ? -evs/ev : q_unvisited and
//   u = (prior * (c_puct * sqrt(max(n_cur, 1)))) / (1 + ev); take the first
//   maximum; record (cur, a) on the path; step the board by the canonical
//   action a (Breakthrough: move, capture by overwrite, win by far row, by
//   elimination, or because the opponent has no reply); if child[a] < -0.5
//   the edge needs a new node: stop; else go down to child[a].
//   Bound on an H100: the rows it must read, 3 KiB per game and level
//   (B x mean depth x 3 KiB: 7 MB at 512 games and 4.65 levels, 2.2 us at
//   3.35 TB/s), plus some 100 bytes of state and outputs per game. It
//   cannot come near that, and no design can: level d+1's row address is
//   level d's argmax, so the time is a chain of dependent loads, one
//   device-memory latency per level of the deepest game. What a design can
//   remove is everything else the per-level form paid: one fetch_rows
//   launch that wrote the row out again (half of its bytes), some fifteen
//   small launches that scored it, sixty more that stepped the env, and a
//   host sync, per level. (PERF.md has the measured time against mean and
//   maximum depth, the byte bound and the launch floor.)
//   Design: one thread block per game, 192 threads, one per action (six
//   warps; 512 blocks sit on 132 SMs at once), and ONE barrier a level.
//   A thread loads its action's four values straight into registers (four
//   coalesced 768-byte reads per block; the row is never written anywhere).
//   The argmax: the score becomes a 32-bit key whose unsigned order is the
//   float order, a warp finds its maximum with one redux.sync
//   (__reduce_max_sync) and its first maximum with one ballot (the lowest
//   lane whose key is the maximum), and that lane puts its action, with the
//   edge's child, visit and vsum, into shared memory; after the barrier
//   every thread reduces the six warps' entries for itself (warps in index
//   order, a later one wins only with a strictly greater key). So all 192
//   threads know the action and its edge without a second barrier, the
//   next row's loads are started at once, and they are in flight while the
//   board is stepped. The six entries are double-buffered by level, which
//   is what lets one barrier do. The board lives in registers: two 64-bit
//   sets of squares (White's, Black's) that every thread keeps and steps
//   for itself, so a move is a few bit operations, elimination is "the
//   opponent's set is empty" and "has the opponent a reply" is three
//   shifts and masks of the whole set at once; no shared memory, no
//   barrier and no per-square thread takes part. The loop is bounded by
//   the path width N and a child pointer is range-checked before it is
//   followed, so a malformed tree can neither hang the kernel nor make it
//   touch memory outside the tree. (The first design kept the board in
//   shared memory, a square per thread, reduced (score, index) by 25
//   shuffles a level and took three to four barriers a level; PERF.md has
//   both designs' times.)
//   Bit equality with the plain PyTorch version is part of the contract
//   (the search's trees are compared whole, card against CPU): every
//   float operation is an explicit round-to-nearest intrinsic in the plain
//   version's order, so nothing is contracted into a multiply-add and no
//   divide or square root is approximate; ties go to the lowest action
//   index, as torch.argmax's first maximum does; the thresholds on the
//   float child pointer come before its cast to an integer.
//
// fetch_rows: out[b] = rows[b, node[b]].
//   Bound on an H100: it moves 2 x B x 3 KiB (read the row, write the
//   output), 3.1 MB at B=512, i.e. about 1 us at 3.35 TB/s; it does no
//   arithmetic. At that size the launch dominates: its time is twice
//   that of a kernel with no body (launch_floor below; PERF.md).
//   Design: one block per game and 16-byte vector loads (a 3 KiB row is
//   192 float4, one per thread), so every row is one coalesced burst and
//   all B rows are in flight at once; the TPU kernel's 16-deep DMA
//   pipeline has no counterpart because the GPU keeps B blocks in flight.
//   The row offset is computed in 64 bits: B*M*R passes 2^31 as soon as
//   tree reuse doubles the capacity at 1024 games.
//
// commit_edges replaces alphazero_tpu/search/kernels.py:_commit_edges_tpu
// (pallas_call at kernels.py:205): in place,
//   rows[b, node[b], off[k] + act[b]] += upd[b, k]   for k < K,
// and, for L stacked levels (node, act of shape (L, B), upd (L, B, K)),
// the same for l = 0 .. L-1 in that order: a whole backprop of the search.
//   Bound on an H100: about 22 KB a level at B=512, K=3 (node, act, upd
//   read once, each touched element read and written once): a few ns of
//   bandwidth. Its time is the launch: a kernel with no body takes more
//   than half as long (launch_floor below; PERF.md has both times), and
//   the rest is the latency of two dependent loads. No design of one
//   launch per level can come near the bound, so the design's answer is
//   one launch per backprop: every level's operands are known when the
//   backprop starts, and the search stacks them.
//   Design: one thread per (game, k) that walks its L levels in order,
//   each a float32 read-add-write. No atomics: the offsets are at least
//   num_actions apart (the Python wrapper checks this), so threads of one
//   game never meet, and different games own different rows; levels that
//   meet on one element (the trash row of levels past a game's depth) are
//   applied by the one thread in order, so the result is deterministic and
//   equal, bit for bit, to L single-level launches. Adding the float32
//   update to the float32 element and storing is bit-identical to the TPU
//   kernel's "accumulate the row in f32, round once" rule for a float32
//   tree. The tree is updated in place; the kernel never copies it.
//
// commit_path is commit_edges in the form the search calls it: a whole
// backprop built from the descent's own outputs, the JAX package's
// backprop while_loop (alphazero_tpu/search/mcts.py:425-451) in one
// launch. For every game b and every level d < depth[b] it adds
//   [alloc edge ? slot + 1 : 0 | 1 | sign0 * (-1)^d * value[b]]
// at (path_nodes[b, d], path_actions[b, d]), offsets off[0..2], where
// sign0 = +1 for an odd depth and -1 for an even one, and the alloc edge
// is the last one when needs_alloc[b]. The slot is read from the device,
// so nothing about the backprop is known to the host: no read of the
// deepest game's depth sizes it, and a CUDA graph can replay it.
//   Bit for bit what the stacked form leaves with L = max(depth, 1): the
// same float32 adds in the same order per element, +0.0 where the stacked
// form adds a zero, and levels past a game's depth, which the stacked form
// sends to the trash row as zeros, skipped (the trash row is never
// written otherwise, so adding zeros there changes no bit).
//   Bound on an H100: the bytes it must move, B x (depth, needs_alloc,
// value) + the slot + 32 bytes per walked edge (its node and action, and
// three elements read and written): about 0.2 MB at 512 games and a mean
// depth of 6, under 0.1 us. Its time is the launch and two dependent loads
// (path entry, then the element).
//   Design: one warp per game, a lane per level (d = lane, lane + 32,
// ...): the levels of one game touch distinct nodes (a path never visits
// a node twice), so its lanes never meet, and different games own
// different rows; no atomics, no order between lanes needed.
//
// encode_planes and expand are the glue of a simulation around its
// evaluation, which the JAX package leaves to XLA: XLA fuses it into a few
// fusions of the jitted simulation (alphazero_tpu/search/mcts.py:362-464),
// where PyTorch spells it out as some eighty small launches.
//
// encode_planes: the network's input planes of the leaf states,
// alphazero_tpu/env/breakthrough.py:231 encoded_state. out[b] = (mine,
// theirs, ones) as float32 0/1 in the canonical frame: the board turned by
// 180 degrees (square s read at 63 - s) unless White is to move, mine the
// squares that hold the mover's value, theirs its negation.
//   Bound on an H100: its bytes, B x (64 + 1 read, 768 written), 0.43 MB
//   at 512 games, 0.13 us at 3.35 TB/s; the launch floor is above it.
//   Design: one thread a square, 64 a game, so that a warp writes 128
//   contiguous bytes of each plane; no shared memory, no barrier.
//
// expand: the tail of the evaluation, the expansion and the root's stats,
// alphazero_tpu/search/mcts.py:377-420 and 453-464, for every game b:
//   v = done ? terminal value for the player to move : value[b] (written
//   to value_out, what commit_path adds up the path); the legal mask of the
//   leaf board (192 canonical actions, none if done); the priors
//   policy[b] / mass over the legal actions, or 1 / n_legal on each legal
//   action when the mass is not > 0; the row at the device slot:
//   [legal ? -1 : -2 | prior] if needs_alloc and not done, else [-2 | 0],
//   with tree reuse also the visit and vsum blocks zeroed and parents[slot]
//   = needs_alloc ? path_nodes[depth - 1] : 0; root_visit += 1, root_vsum
//   += (odd depth ? -v : v), node_count += needs_alloc, and the depth to
//   the search's accumulator.
//   The one sum, the legal mass, is taken in a fixed order that the plain
//   version (search/kernels.py:legal_mass) writes out: lane l adds the
//   masked priors of actions l, l + 32, ..., l + 160 in that order, then
//   the warp halves its 32 partial sums five times (s[j] + s[j + 16], ...,
//   by xor shuffles, whose two operands commute). Every other float
//   operation is one round-to-nearest intrinsic, so the kernel is bit-equal
//   to the plain version.
//   Bound on an H100: its bytes, B x about 2.4 KB (the policy read, the
//   row written, some 60 bytes of state; 3.9 KB with tree reuse), 1.2 MB
//   at 512 games, 0.37 us at 3.35 TB/s; the launch floor is above it.
//   Design: one warp a game, six actions a lane; the leaf board becomes
//   two 64-bit sets of squares by two ballots (descend's bitboards), so
//   the legal mask is three shifts and masks of the whole set; one barrier
//   a block, for one atomic add of its games' depths.
//
// MuZero's search (no JAX counterpart; search/mcts.py:_simulate_latent)
// walks the same rows over stored hidden states instead of boards:
//   descend_kernel<false>: descend without the env, a compile-time variant,
//   so the real-position search's kernel (<true>) is the code it was; no
//   board is gathered, stepped or written and no final position stops a
//   walk (below the root every action is open).
//   gather_latent: each game's leaf parent state, latent[b, path_nodes[b,
//   depth - 1]], copied to a contiguous map for the dynamics net (16-byte
//   vectors, a block a game; 16.8 MB read and written at 512 games and C
//   256, some 10 us), and the walk's last action.
//   expand_latent: expand's row write with every action UNALLOCATED (no
//   mask and no final position inside the tree), the slot's reward, the
//   root's visit and node count and the depth sum; the leaf's value is a
//   final ROOT's result where the walk had depth 0, else the evaluator's.
//   commit_rewards: the backup with the stored rewards, a thread a game
//   walking its path up from the leaf: G = value; at each edge d (deepest
//   first) the child pointer of the allocating edge gains slot + 1, G =
//   reward[child] - G, the visit gains 1 and the value sum -G (kept for
//   the child's mover, as commit_path keeps it, so the descent's rule is
//   unchanged); the root's value sum gains the last G. With every reward
//   0 it is commit_path's sign flip bit for bit. Bound: as commit_path's,
//   the launch and a chain of dependent loads a level.
// Each is bit-equal to its plain version (search/kernels.py).
//
// A simulation is one descend launch, encode_planes, the evaluator, one
// expand launch, one commit_path launch and the slot's increment, none of
// which the host has to read for: the search captures it once as a CUDA
// graph and replays it (alphazero_torch/search/graph.py). Each entry point
// launches on the given stream and returns cudaGetLastError(); it never
// synchronises.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxOffsets = 4;

struct Offsets {
  int v[kMaxOffsets];
};

__global__ void fetch_rows_kernel(const float4* __restrict__ rows,
                                  const int32_t* __restrict__ node,
                                  float4* __restrict__ out,
                                  int64_t M, int R4) {
  const int64_t b = blockIdx.x;
  const float4* src = rows + (b * M + node[b]) * R4;
  float4* dst = out + b * R4;
  for (int i = threadIdx.x; i < R4; i += blockDim.x) dst[i] = src[i];
}

__global__ void commit_edges_kernel(float* rows,
                                    const int32_t* __restrict__ node,
                                    const int32_t* __restrict__ act,
                                    const float* __restrict__ upd,
                                    int L, int B, int K, Offsets off,
                                    int64_t M, int64_t R) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * K) return;
  const int b = t / K;
  const int k = t - b * K;
  float* game = rows + (int64_t)b * M * R + off.v[k];
  for (int l = 0; l < L; ++l) {
    const int i = l * B + b;
    float* x = game + node[i] * R + act[i];
    *x = *x + upd[(int64_t)i * K + k];
  }
}

constexpr int kPathGames = 4;          // games per block, one warp each

__global__ void __launch_bounds__(kPathGames * 32)
commit_path_kernel(float* rows, const int32_t* __restrict__ path_nodes,
                   const int32_t* __restrict__ path_actions,
                   const int32_t* __restrict__ depth,
                   const uint8_t* __restrict__ needs_alloc,
                   const float* __restrict__ value,
                   const int32_t* __restrict__ slot, int B, int N,
                   Offsets off, int64_t M, int64_t R) {
  const int b = blockIdx.x * kPathGames + threadIdx.x / 32;
  if (b >= B) return;
  const int lane = threadIdx.x % 32;
  const int D = min(depth[b], N);
  const float v = value[b];
  const bool odd = (D & 1) != 0;                 // sign0 = +1
  const float alloc = needs_alloc[b] ? (float)(slot[0] + 1) : 0.0f;
  float* game = rows + (int64_t)b * M * R;
  for (int d = lane; d < D; d += 32) {
    const int64_t i = (int64_t)b * N + d;
    float* x = game + (int64_t)path_nodes[i] * R + path_actions[i];
    // sign0 * (-1)^d * value: an exact sign flip, as the stacked form's
    // products by +-1 are
    const float u = (odd == ((d & 1) == 0)) ? v : -v;
    x[off.v[0]] = __fadd_rn(x[off.v[0]], d == D - 1 ? alloc : 0.0f);
    x[off.v[1]] = __fadd_rn(x[off.v[1]], 1.0f);
    x[off.v[2]] = __fadd_rn(x[off.v[2]], u);
  }
}

// ---- descend ---------------------------------------------------------------

constexpr int kDescendThreads = 192;  // one per canonical action: six warps
constexpr int kDescendWarps = kDescendThreads / 32;
constexpr int kSquares = 64;
constexpr uint64_t kNotFileA = 0xFEFEFEFEFEFEFEFEull;  // squares with col > 0
constexpr uint64_t kNotFileH = 0x7F7F7F7F7F7F7F7Full;  // squares with col < 7

struct DescendArgs {
  const float* rows;            // (B, M, R), read only
  int64_t M, R;
  int A, N;                     // actions per block of the row; path width
  const int8_t* board;          // root state: (B, 64) absolute squares
  const int8_t* turn;           // +1 white, -1 black
  const int8_t* winner;
  const uint8_t* done;
  const int32_t* move_count;
  const int32_t* root_visit;
  const float* root_vsum;
  float c_puct, fpu_reduction;
  int use_fpu;
  int32_t* path_nodes;          // (B, N); written at d < depth[b]
  int32_t* path_actions;
  int32_t* depth;
  uint8_t* needs_alloc;
  int8_t* leaf_board;           // leaf state, same layout as the root's
  int8_t* leaf_turn;
  int8_t* leaf_winner;
  uint8_t* leaf_done;
  int32_t* leaf_move_count;
};

// A warp's best action: its score as an ordered key, whether the warp has
// a legal action at all, and what the descent needs of the action's edge.
struct Pick {
  uint32_t key;
  int idx;
  int legal;
  float child, ev, evs;
};

// A key whose unsigned order is the float order of the scores (no NaN
// occurs: a row's values are finite). -0.0 is first made +0.0, so that
// equal floats have equal keys and a tie goes to the lower index.
__device__ __forceinline__ uint32_t order_key(float score) {
  const uint32_t u = __float_as_uint(__fadd_rn(score, 0.0f));
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

// Has the side `mover` (+1 White, toward row 7; -1 Black, toward row 0) a
// legal move: forward onto an empty square, or diagonally onto a square
// that is not its own.
__device__ __forceinline__ bool has_move(uint64_t white, uint64_t black,
                                         int mover) {
  const uint64_t empty = ~(white | black);
  if (mover > 0) {
    return (((white << 8) & empty) | (((white & kNotFileA) << 7) & ~white) |
            (((white & kNotFileH) << 9) & ~white)) != 0;
  }
  return (((black >> 8) & empty) | (((black & kNotFileA) >> 9) & ~black) |
          (((black & kNotFileH) >> 7) & ~black)) != 0;
}

// kStepEnv: the real-position search, which steps each game's board
// along the walk and stops at a final position; without it (MuZero's
// search over stored hidden states) the walk reads the tree alone, and
// nothing of the board is loaded, stepped or written.
template <bool kStepEnv>
__global__ void __launch_bounds__(kDescendThreads)
descend_kernel(const DescendArgs p) {
  __shared__ Pick s_pick[2][kDescendWarps];     // double-buffered by level
  __shared__ uint32_t s_squares[4];             // set-up only

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const bool on_row = t < p.A;
  const float* __restrict__ game = p.rows + (int64_t)b * p.M * p.R;

  float child, prior, ev, evs;
  auto load_row = [&](int node) {
    const float* __restrict__ row = game + (int64_t)node * p.R;
    child = on_row ? row[t] : -2.0f;
    prior = on_row ? row[p.A + t] : 0.0f;
    ev = on_row ? row[2 * p.A + t] : 0.0f;
    evs = on_row ? row[3 * p.A + t] : 0.0f;
  };
  int cur = 0;
  load_row(cur);

  // The game's state, whole in every thread (all threads take the same
  // branches): the scalars, and the board as White's and Black's sets of
  // squares, gathered once from one square a thread.
  int turn = 0, winner = 0, move_count = 0;
  bool done = false;
  uint64_t white = 0, black = 0;
  if constexpr (kStepEnv) {
    turn = p.turn[b];
    winner = p.winner[b];
    done = p.done[b] != 0;
    move_count = p.move_count[b];
    if (t < kSquares) {
      const int square = p.board[(int64_t)b * kSquares + t];
      const uint32_t w = __ballot_sync(0xffffffffu, square > 0);
      const uint32_t k = __ballot_sync(0xffffffffu, square < 0);
      if (lane == 0) {
        s_squares[warp] = w;
        s_squares[2 + warp] = k;
      }
    }
    __syncthreads();
    white = (uint64_t)s_squares[1] << 32 | s_squares[0];
    black = (uint64_t)s_squares[3] << 32 | s_squares[2];
  }

  const int root_visit = p.root_visit[b];
  float n_cur = (float)root_visit;
  float parent_q = root_visit > 0
      ? __fdiv_rn(p.root_vsum[b], (float)root_visit) : 0.0f;
  int depth = 0;
  bool needs_alloc = false;

  for (int d = 0; d < p.N; ++d) {
    // (1) score this thread's action
    const bool legal = child > -1.5f;
    float score = -INFINITY;
    if (legal) {
      const float q_unvisited =
          p.use_fpu ? __fsub_rn(parent_q, p.fpu_reduction) : 0.0f;
      const float q =
          ev > 0.0f ? __fdiv_rn(-evs, fmaxf(ev, 1.0f)) : q_unvisited;
      const float cs = __fmul_rn(p.c_puct, __fsqrt_rn(fmaxf(n_cur, 1.0f)));
      const float u = __fdiv_rn(__fmul_rn(prior, cs), __fadd_rn(1.0f, ev));
      score = __fadd_rn(q, u);
    }

    // (2) first maximum: the warp's by one redux and one ballot, the
    // block's from the six warps' entries, by every thread for itself
    const uint32_t key = order_key(score);
    const uint32_t warp_max = __reduce_max_sync(0xffffffffu, key);
    const uint32_t at_max = __ballot_sync(0xffffffffu, key == warp_max);
    const uint32_t warp_legal = __ballot_sync(0xffffffffu, legal);
    Pick* picks = s_pick[d & 1];
    if (lane == __ffs(at_max) - 1) {
      picks[warp] = Pick{key, t, warp_legal != 0, child, ev, evs};
    }
    __syncthreads();
    Pick best = picks[0];
    int live = best.legal;
#pragma unroll
    for (int w = 1; w < kDescendWarps; ++w) {
      const Pick o = picks[w];
      live |= o.legal;
      if (o.key > best.key) best = o;   // equal keys: the lower index stays
    }
    if (!live) break;             // no legal action here: the walk ends

    // (3) the edge: record it, decide where the walk goes, and start the
    // next row's loads before the board is stepped
    const int a = best.idx;
    if (t == 0) {
      p.path_nodes[(int64_t)b * p.N + d] = cur;
      p.path_actions[(int64_t)b * p.N + d] = a;
    }
    const bool alloc_here = best.child < -0.5f;
    if (best.child > -0.5f) {
      cur = (int)best.child;
      n_cur = best.ev;
      if (p.use_fpu) {
        parent_q = best.ev > 0.0f
            ? __fdiv_rn(best.evs, fmaxf(best.ev, 1.0f)) : 0.0f;
      }
    }
    // a pointer outside the tree (no well-formed tree has one) ends the
    // walk after this edge instead of being followed
    const bool more =
        !alloc_here && d + 1 < p.N && (uint64_t)(int64_t)cur < (uint64_t)p.M;
    if (more) load_row(cur);

    // (4) step the board along the edge; a finished game stays as it is.
    // action = (row*8 + col)*3 + dir in the mover's frame (dir 0 forward,
    // 1 diagonal left, 2 diagonal right); Black's frame is the board
    // turned by 180 degrees, square s at 63 - s.
    if (kStepEnv && !done) {
      const int sq = a / 3, dir = a - 3 * sq;
      const int to = sq + 8 + (dir == 2) - (dir == 1);
      const bool black_moves = turn == -1;
      const int from_abs = black_moves ? 63 - sq : sq;
      const int to_abs = black_moves ? 63 - to : to;
      const uint64_t from_bit = 1ull << from_abs;
      const uint64_t to_bit = (unsigned)to_abs < 64u ? 1ull << to_abs : 0ull;
      uint64_t mine = black_moves ? black : white;
      uint64_t theirs = black_moves ? white : black;
      mine = (mine | to_bit) & ~from_bit;        // the piece moves
      theirs &= ~(to_bit | from_bit);            // capture: overwrite
      white = black_moves ? theirs : mine;
      black = black_moves ? mine : theirs;
      const int mover = turn;
      winner = ((sq >> 3) + 1 == 7 || theirs == 0) ? mover : 0;
      turn = -mover;
      move_count += 1;
      // a player left without a legal reply loses
      if (winner == 0 && !has_move(white, black, turn)) winner = mover;
      done = winner != 0;
    }

    depth += 1;
    if (alloc_here) {
      needs_alloc = true;
      break;
    }
    if (!more) break;
  }

  if (t == 0) {
    p.depth[b] = depth;
    p.needs_alloc[b] = needs_alloc;
  }
  if constexpr (kStepEnv) {
    if (t == 0) {
      p.leaf_turn[b] = (int8_t)turn;
      p.leaf_winner[b] = (int8_t)winner;
      p.leaf_done[b] = done;
      p.leaf_move_count[b] = move_count;
    }
    if (t < kSquares) {
      p.leaf_board[(int64_t)b * kSquares + t] =
          (int8_t)((int)((white >> t) & 1) - (int)((black >> t) & 1));
    }
  }
}

// ---- encode_planes, expand -------------------------------------------------

constexpr int kEncodeGames = 4;       // games a block, a thread a square
constexpr int kExpandGames = 4;       // games a block, a warp each
constexpr int kActions = 192;         // canonical actions: 64 squares x 3
constexpr int kPerLane = kActions / 32;

__global__ void __launch_bounds__(kEncodeGames * kSquares)
encode_planes_kernel(const int8_t* __restrict__ board,
                     const int8_t* __restrict__ turn,
                     float* __restrict__ out, int B) {
  const int b = blockIdx.x * kEncodeGames + threadIdx.x / kSquares;
  if (b >= B) return;
  const int s = threadIdx.x % kSquares;
  const int8_t t = turn[b];
  const int8_t v =
      board[(int64_t)b * kSquares + (t == 1 ? s : kSquares - 1 - s)];
  float* o = out + (int64_t)b * 3 * kSquares + s;
  o[0] = v == t ? 1.0f : 0.0f;
  o[kSquares] = v == (int8_t)-t ? 1.0f : 0.0f;
  o[2 * kSquares] = 1.0f;
}

struct ExpandArgs {
  float* rows;                  // (B, M, R); the row at the slot is written
  int32_t* parents;             // (B, M)
  int32_t* root_visit;          // (B,)
  float* root_vsum;
  int32_t* node_count;
  const int32_t* slot;          // the simulation's fresh slot
  const int8_t* board;          // leaf state: (B, 64) absolute squares
  const int8_t* turn;
  const int8_t* winner;
  const uint8_t* done;
  const uint8_t* needs_alloc;   // descend's results
  const int32_t* depth;
  const int32_t* path_nodes;    // (B, N)
  const float* policy;          // (B, 192) the evaluator's probabilities
  const float* value;           // (B,) its values
  float* value_out;             // (B,) the leaf values commit_path adds
  unsigned long long* depth_sum;  // the search's depth accumulator
  int64_t M, R;
  int B, N, tree_reuse;
};

__global__ void __launch_bounds__(kExpandGames * 32)
expand_kernel(const ExpandArgs p) {
  __shared__ int s_depth[kExpandGames];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kExpandGames + warp;
  int depth = 0;
  if (b < p.B) {                        // the whole warp or none of it
    depth = p.depth[b];
    const int turn = p.turn[b];
    const int winner = p.winner[b];
    const bool done = p.done[b] != 0;
    const bool needs_alloc = p.needs_alloc[b] != 0;
    // the leaf's value for the player to move: a terminal leaf's result,
    // else the evaluator's
    const float white_value = __fsub_rn(winner == 1 ? 1.0f : 0.0f,
                                        winner == -1 ? 1.0f : 0.0f);
    const float v = done ? (turn == 1 ? white_value : -white_value)
                         : p.value[b];

    // the legal mask: the leaf board as White's and Black's sets of
    // squares, in the mover's frame (turned by 180 degrees, bit s to bit
    // 63 - s, unless White moves); forward onto an empty square, diagonally
    // onto one that is not the mover's
    const int8_t* squares = p.board + (int64_t)b * kSquares;
    const int8_t lo = squares[lane], hi = squares[32 + lane];
    const uint64_t white = (uint64_t)__ballot_sync(0xffffffffu, hi > 0) << 32
                           | __ballot_sync(0xffffffffu, lo > 0);
    const uint64_t black = (uint64_t)__ballot_sync(0xffffffffu, hi < 0) << 32
                           | __ballot_sync(0xffffffffu, lo < 0);
    const uint64_t mine = turn == 1 ? white : __brevll(black);
    const uint64_t theirs = turn == 1 ? black : __brevll(white);
    const uint64_t live = done ? 0ull : ~0ull;
    const uint64_t forward = live & mine & (~(mine | theirs) >> 8);
    const uint64_t left = live & mine & kNotFileA & (~mine >> 7);
    const uint64_t right = live & mine & kNotFileH & (~mine >> 9);
    const int n_legal = __popcll(forward) + __popcll(left) + __popcll(right);

    // the legal mass in the plain version's order: this lane's six actions
    // in turn, then the warp's 32 sums halved five times
    const float* policy = p.policy + (int64_t)b * kActions;
    bool legal[kPerLane];
    float prior[kPerLane];
    float mass = 0.0f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int a = lane + 32 * k;
      const int sq = a / 3, dir = a - 3 * sq;
      legal[k] = ((dir == 0 ? forward : dir == 1 ? left : right) >> sq) & 1;
      prior[k] = legal[k] ? policy[a] : 0.0f;
      mass = k == 0 ? prior[k] : __fadd_rn(mass, prior[k]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mass = __fadd_rn(mass, __shfl_xor_sync(0xffffffffu, mass, off));
    }
    const float uniform_den = (float)max(n_legal, 1);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      prior[k] = mass > 0.0f
          ? __fdiv_rn(prior[k], fmaxf(mass, 1e-30f))
          : __fdiv_rn(legal[k] ? 1.0f : 0.0f, uniform_den);
    }

    // the fresh row at the slot; a game that did not allocate (or reached
    // a terminal state) writes the slot's initial values back
    const int64_t slot = p.slot[0];
    if (slot >= 0 && slot < p.M) {      // no well-formed tree has another
      const bool expand = needs_alloc && !done;
      float* row = p.rows + ((int64_t)b * p.M + slot) * p.R;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int a = lane + 32 * k;
        row[a] = expand && legal[k] ? -1.0f : -2.0f;
        row[kActions + a] = expand ? prior[k] : 0.0f;
      }
      if (p.tree_reuse) {
        // a slot past a re-rooted game's nodes holds a stale row
        for (int64_t j = 2 * kActions + lane; j < p.R; j += 32) row[j] = 0.0f;
        if (lane == 0) {
          p.parents[(int64_t)b * p.M + slot] =
              needs_alloc ? p.path_nodes[(int64_t)b * p.N + max(depth - 1, 0)]
                          : 0;
        }
      }
    }

    // the root's stats: the value reaches it flipped depth times
    if (lane == 0) {
      p.value_out[b] = v;
      p.root_visit[b] += 1;
      p.root_vsum[b] = __fadd_rn(p.root_vsum[b], (depth & 1) ? -v : v);
      p.node_count[b] += needs_alloc;
    }
  }
  if (lane == 0) s_depth[warp] = depth;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < kExpandGames; ++w) sum += s_depth[w];
    if (sum != 0) atomicAdd(p.depth_sum, sum);
  }
}

// ---- MuZero's search: the latent store and the backup with rewards -------

constexpr int kGatherThreads = 256;
constexpr int kRewardGames = 128;     // games a commit_rewards block

__global__ void __launch_bounds__(kGatherThreads)
gather_latent_kernel(const uint4* __restrict__ latent,
                     const int32_t* __restrict__ depth,
                     const int32_t* __restrict__ path_nodes,
                     const int32_t* __restrict__ path_actions,
                     uint4* __restrict__ out, int32_t* __restrict__ act_out,
                     int64_t slots, int N, int vectors) {
  const int64_t b = blockIdx.x;
  const int d = depth[b];
  const bool walked = d > 0 && d <= N;
  int node = walked ? path_nodes[b * N + d - 1] : 0;
  if ((uint64_t)(int64_t)node >= (uint64_t)slots) node = 0;
  if (threadIdx.x == 0) act_out[b] = walked ? path_actions[b * N + d - 1] : 0;
  const uint4* src = latent + (b * slots + node) * vectors;
  uint4* dst = out + b * vectors;
  for (int i = threadIdx.x; i < vectors; i += kGatherThreads) dst[i] = src[i];
}

struct ExpandLatentArgs {
  float* rows;                  // (B, M, R); the row at the slot is written
  float* reward;                // (B, M); the slot's entry is written
  int32_t* root_visit;          // (B,)
  int32_t* node_count;
  const int32_t* slot;          // the simulation's fresh slot
  const int8_t* turn;           // the ROOT state (a walk of depth 0 stops
  const int8_t* winner;         // only at a final root)
  const uint8_t* done;
  const uint8_t* needs_alloc;   // descend's results
  const int32_t* depth;
  const float* policy;          // (B, 192) the evaluator's probabilities
  const float* value;           // (B,) its values
  const float* reward_in;       // (B,) g's rewards
  float* value_out;             // (B,) the leaf values commit_rewards adds
  unsigned long long* depth_sum;
  int64_t M, R;
  int B;
};

__global__ void __launch_bounds__(kExpandGames * 32)
expand_latent_kernel(const ExpandLatentArgs p) {
  __shared__ int s_depth[kExpandGames];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kExpandGames + warp;
  int depth = 0;
  if (b < p.B) {                        // the whole warp or none of it
    depth = p.depth[b];
    const bool needs_alloc = p.needs_alloc[b] != 0;
    // the leaf's value for the player to move: a final root's result (the
    // only walk that stops without a new node), else the evaluator's
    const int turn = p.turn[b], winner = p.winner[b];
    const float white_value = __fsub_rn(winner == 1 ? 1.0f : 0.0f,
                                        winner == -1 ? 1.0f : 0.0f);
    const float v = depth == 0 && p.done[b] != 0
        ? (turn == 1 ? white_value : -white_value) : p.value[b];
    // every action is open below the root: the priors renormalised over
    // all of them, the mass in expand_kernel's order
    const float* policy = p.policy + (int64_t)b * kActions;
    float prior[kPerLane];
    float mass = 0.0f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      prior[k] = policy[lane + 32 * k];
      mass = k == 0 ? prior[k] : __fadd_rn(mass, prior[k]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mass = __fadd_rn(mass, __shfl_xor_sync(0xffffffffu, mass, off));
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      prior[k] = mass > 0.0f ? __fdiv_rn(prior[k], fmaxf(mass, 1e-30f))
                             : __fdiv_rn(1.0f, (float)kActions);
    }
    const int64_t slot = p.slot[0];
    if (slot >= 0 && slot < p.M) {      // no well-formed tree has another
      float* row = p.rows + ((int64_t)b * p.M + slot) * p.R;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int a = lane + 32 * k;
        row[a] = needs_alloc ? -1.0f : -2.0f;
        row[kActions + a] = needs_alloc ? prior[k] : 0.0f;
      }
      if (lane == 0) {
        p.reward[(int64_t)b * p.M + slot] = needs_alloc ? p.reward_in[b]
                                                        : 0.0f;
      }
    }
    if (lane == 0) {
      p.value_out[b] = v;
      p.root_visit[b] += 1;
      p.node_count[b] += needs_alloc;
    }
  }
  if (lane == 0) s_depth[warp] = depth;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < kExpandGames; ++w) sum += s_depth[w];
    if (sum != 0) atomicAdd(p.depth_sum, sum);
  }
}

__global__ void __launch_bounds__(kRewardGames)
commit_rewards_kernel(float* rows, const float* __restrict__ reward,
                      const int32_t* __restrict__ path_nodes,
                      const int32_t* __restrict__ path_actions,
                      const int32_t* __restrict__ depth,
                      const uint8_t* __restrict__ needs_alloc,
                      const float* __restrict__ value,
                      const int32_t* __restrict__ slot, float* root_vsum,
                      int B, int N, Offsets off, int64_t M, int64_t R) {
  const int b = blockIdx.x * kRewardGames + threadIdx.x;
  if (b >= B) return;
  const int D = min(depth[b], N);
  const float alloc = needs_alloc[b] ? (float)(slot[0] + 1) : 0.0f;
  float* game = rows + (int64_t)b * M * R;
  const float* game_reward = reward + (int64_t)b * M;
  // G: the return of the edge's mover, from the leaf's value up
  float G = value[b];
  for (int d = D - 1; d >= 0; --d) {
    const int64_t i = (int64_t)b * N + d;
    float* x = game + (int64_t)path_nodes[i] * R + path_actions[i];
    if (d == D - 1) x[off.v[0]] = __fadd_rn(x[off.v[0]], alloc);
    const int child = (int)x[off.v[0]];
    const float r = child > 0 && child < M ? game_reward[child] : 0.0f;
    G = __fsub_rn(r, G);
    x[off.v[1]] = __fadd_rn(x[off.v[1]], 1.0f);
    // stored for the child's mover, as the descent reads it (q = -vsum/n)
    x[off.v[2]] = __fadd_rn(x[off.v[2]], -G);
  }
  root_vsum[b] = __fadd_rn(root_vsum[b], G);
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// rows: (B, M, R) float32, R % 4 == 0, 16-byte aligned; node: (B,) int32
// in [0, M); out: (B, R) float32, 16-byte aligned.
int fetch_rows_f32(const void* rows, const void* node, void* out,
                   int B, long long M, int R, void* stream) {
  if (B > 0) {
    const int R4 = R / 4;
    const int threads = R4 < 1024 ? ((R4 + 31) / 32) * 32 : 1024;
    fetch_rows_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
        (const float4*)rows, (const int32_t*)node, (float4*)out,
        (int64_t)M, R4);
  }
  return (int)cudaGetLastError();
}

// rows: (B, M, R) float32, updated in place; node, act: (L, B) int32;
// upd: (L, B, K) float32; K <= 4 offsets o0..o3 (unused ones ignored).
int commit_edges_f32(void* rows, const void* node, const void* act,
                     const void* upd, int L, int B, int K,
                     int o0, int o1, int o2, int o3,
                     long long M, int R, void* stream) {
  if (K < 1 || K > kMaxOffsets || L < 0) return (int)cudaErrorInvalidValue;
  const Offsets off = {{o0, o1, o2, o3}};
  const int n = B * K;
  if (n > 0 && L > 0) {
    const int threads = 256;
    commit_edges_kernel<<<(n + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
        (float*)rows, (const int32_t*)node, (const int32_t*)act,
        (const float*)upd, L, B, K, off, (int64_t)M, (int64_t)R);
  }
  return (int)cudaGetLastError();
}

// rows: (B, M, R) float32, updated in place; path_nodes, path_actions
// (B, N) int32, read at d < depth[b]; depth (B,) int32; needs_alloc (B,)
// one byte; value (B,) float32; slot: one int32 (the fresh slot); three
// in-row offsets o0 (child ptr), o1 (visit), o2 (vsum).
int commit_path_f32(void* rows, const void* path_nodes,
                    const void* path_actions, const void* depth,
                    const void* needs_alloc, const void* value,
                    const void* slot, int B, int N, int o0, int o1, int o2,
                    long long M, int R, void* stream) {
  if (B < 0 || N < 0) return (int)cudaErrorInvalidValue;
  const Offsets off = {{o0, o1, o2, 0}};
  if (B > 0) {
    commit_path_kernel<<<(B + kPathGames - 1) / kPathGames, kPathGames * 32,
                         0, (cudaStream_t)stream>>>(
        (float*)rows, (const int32_t*)path_nodes,
        (const int32_t*)path_actions, (const int32_t*)depth,
        (const uint8_t*)needs_alloc, (const float*)value,
        (const int32_t*)slot, B, N, off, (int64_t)M, (int64_t)R);
  }
  return (int)cudaGetLastError();
}

// The whole PUCT descent of one simulation, one block per game. rows:
// (B, M, R) float32, read only; the root state (board (B, 64) int8, turn,
// winner (B,) int8, done (B,) one byte, move_count (B,) int32), root_visit
// (B,) int32, root_vsum (B,) float32; outputs path_nodes, path_actions
// (B, N) int32 (written at d < depth[b]), depth (B,) int32, needs_alloc (B,)
// one byte, and the leaf state in the root state's layout.
int descend_f32(const void* rows, long long M, int R, int A,
                const void* board, const void* turn, const void* winner,
                const void* done, const void* move_count,
                const void* root_visit, const void* root_vsum,
                float c_puct, float fpu_reduction, int use_fpu, int B, int N,
                void* path_nodes, void* path_actions, void* depth,
                void* needs_alloc, void* leaf_board, void* leaf_turn,
                void* leaf_winner, void* leaf_done, void* leaf_move_count,
                void* stream) {
  if (A < 1 || A > kDescendThreads || 4 * A > R || M < 1 || N < 0 || B < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B > 0) {
    const DescendArgs args = {
        (const float*)rows, (int64_t)M, (int64_t)R, A, N,
        (const int8_t*)board, (const int8_t*)turn, (const int8_t*)winner,
        (const uint8_t*)done, (const int32_t*)move_count,
        (const int32_t*)root_visit, (const float*)root_vsum,
        c_puct, fpu_reduction, use_fpu,
        (int32_t*)path_nodes, (int32_t*)path_actions, (int32_t*)depth,
        (uint8_t*)needs_alloc, (int8_t*)leaf_board, (int8_t*)leaf_turn,
        (int8_t*)leaf_winner, (uint8_t*)leaf_done,
        (int32_t*)leaf_move_count};
    descend_kernel<true><<<B, kDescendThreads, 0, (cudaStream_t)stream>>>(
        args);
  }
  return (int)cudaGetLastError();
}

// MuZero's descent: descend_f32 without the board (nothing of the state is
// read or written).
int descend_latent_f32(const void* rows, long long M, int R, int A,
                       const void* root_visit, const void* root_vsum,
                       float c_puct, float fpu_reduction, int use_fpu, int B,
                       int N, void* path_nodes, void* path_actions,
                       void* depth, void* needs_alloc, void* stream) {
  if (A < 1 || A > kDescendThreads || 4 * A > R || M < 1 || N < 0 || B < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B > 0) {
    DescendArgs args = {};
    args.rows = (const float*)rows;
    args.M = (int64_t)M;
    args.R = (int64_t)R;
    args.A = A;
    args.N = N;
    args.root_visit = (const int32_t*)root_visit;
    args.root_vsum = (const float*)root_vsum;
    args.c_puct = c_puct;
    args.fpu_reduction = fpu_reduction;
    args.use_fpu = use_fpu;
    args.path_nodes = (int32_t*)path_nodes;
    args.path_actions = (int32_t*)path_actions;
    args.depth = (int32_t*)depth;
    args.needs_alloc = (uint8_t*)needs_alloc;
    descend_kernel<false><<<B, kDescendThreads, 0, (cudaStream_t)stream>>>(
        args);
  }
  return (int)cudaGetLastError();
}

// latent: (B, slots, vectors) 16-byte vectors, read at each game's leaf
// parent (path_nodes[b, depth - 1], slot 0 where depth is 0); out: (B,
// vectors); act_out (B,) int32: the walk's last action (0 where depth is 0).
int gather_latent(const void* latent, const void* depth,
                  const void* path_nodes, const void* path_actions, void* out,
                  void* act_out, long long slots, int B, int N, int vectors,
                  void* stream) {
  if (B < 0 || N < 0 || slots < 1 || vectors < 1)
    return (int)cudaErrorInvalidValue;
  if (B > 0) {
    gather_latent_kernel<<<B, kGatherThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)latent, (const int32_t*)depth,
        (const int32_t*)path_nodes, (const int32_t*)path_actions,
        (uint4*)out, (int32_t*)act_out, (int64_t)slots, N, vectors);
  }
  return (int)cudaGetLastError();
}

// MuZero's expansion, one warp a game: expand_f32's row write with every
// action UNALLOCATED, the slot's reward, the root's visit and node count and
// the depth sum; the root's value sum is commit_rewards_f32's. rows (B, M,
// R) float32, R >= 384; reward (B, M) float32; the root state's turn,
// winner (B,) int8 and done (B,) one byte; policy (B, 192), value and
// reward_in (B,) float32.
int expand_latent_f32(void* rows, void* reward, void* root_visit,
                      void* node_count, const void* slot, const void* turn,
                      const void* winner, const void* done,
                      const void* needs_alloc, const void* depth,
                      const void* policy, const void* value,
                      const void* reward_in, void* value_out, void* depth_sum,
                      long long M, int R, int B, void* stream) {
  if (B < 0 || M < 1 || R < 2 * kActions) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const ExpandLatentArgs args = {
        (float*)rows, (float*)reward, (int32_t*)root_visit,
        (int32_t*)node_count, (const int32_t*)slot, (const int8_t*)turn,
        (const int8_t*)winner, (const uint8_t*)done,
        (const uint8_t*)needs_alloc, (const int32_t*)depth,
        (const float*)policy, (const float*)value, (const float*)reward_in,
        (float*)value_out, (unsigned long long*)depth_sum, (int64_t)M,
        (int64_t)R, B};
    expand_latent_kernel<<<(B + kExpandGames - 1) / kExpandGames,
                           kExpandGames * 32, 0, (cudaStream_t)stream>>>(args);
  }
  return (int)cudaGetLastError();
}

// MuZero's backup, a thread a game: commit_path_f32's edge updates with
// the stored rewards, G <- reward(child) - G from the leaf's value up, each
// edge's value sum adding -G, and the root's value sum G.
int commit_rewards_f32(void* rows, const void* reward, const void* path_nodes,
                       const void* path_actions, const void* depth,
                       const void* needs_alloc, const void* value,
                       const void* slot, void* root_vsum, int B, int N,
                       int o0, int o1, int o2, long long M, int R,
                       void* stream) {
  if (B < 0 || N < 0) return (int)cudaErrorInvalidValue;
  const Offsets off = {{o0, o1, o2, 0}};
  if (B > 0) {
    commit_rewards_kernel<<<(B + kRewardGames - 1) / kRewardGames,
                            kRewardGames, 0, (cudaStream_t)stream>>>(
        (float*)rows, (const float*)reward, (const int32_t*)path_nodes,
        (const int32_t*)path_actions, (const int32_t*)depth,
        (const uint8_t*)needs_alloc, (const float*)value,
        (const int32_t*)slot, (float*)root_vsum, B, N, off, (int64_t)M,
        (int64_t)R);
  }
  return (int)cudaGetLastError();
}

// The network's input planes of B games: board (B, 64) int8 absolute
// squares, turn (B,) int8; out (B, 3, 64) float32.
int encode_planes_f32(const void* board, const void* turn, void* out, int B,
                      void* stream) {
  if (B < 0) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    encode_planes_kernel<<<(B + kEncodeGames - 1) / kEncodeGames,
                           kEncodeGames * kSquares, 0,
                           (cudaStream_t)stream>>>(
        (const int8_t*)board, (const int8_t*)turn, (float*)out, B);
  }
  return (int)cudaGetLastError();
}

// The expansion of one simulation, one warp a game. rows (B, M, R)
// float32, R >= 384 (768 with tree_reuse, which zeroes the visit and vsum
// blocks); parents (B, M) int32; root_visit, node_count (B,) int32,
// root_vsum (B,) float32, updated in place; slot: one int32; the leaf state
// (board (B, 64) int8, turn, winner (B,) int8, done (B,) one byte);
// needs_alloc (B,) one byte, depth (B,) int32, path_nodes (B, N) int32;
// policy (B, 192) and value (B,) float32; out: value_out (B,) float32;
// depth_sum: one 64-bit integer, added to.
int expand_f32(void* rows, void* parents, void* root_visit, void* root_vsum,
               void* node_count, const void* slot, const void* board,
               const void* turn, const void* winner, const void* done,
               const void* needs_alloc, const void* depth,
               const void* path_nodes, const void* policy, const void* value,
               void* value_out, void* depth_sum, long long M, int R, int B,
               int N, int tree_reuse, void* stream) {
  if (B < 0 || N < 1 || M < 1 || R < (tree_reuse ? 4 : 2) * kActions) {
    return (int)cudaErrorInvalidValue;
  }
  if (B > 0) {
    const ExpandArgs args = {
        (float*)rows, (int32_t*)parents, (int32_t*)root_visit,
        (float*)root_vsum, (int32_t*)node_count, (const int32_t*)slot,
        (const int8_t*)board, (const int8_t*)turn, (const int8_t*)winner,
        (const uint8_t*)done, (const uint8_t*)needs_alloc,
        (const int32_t*)depth, (const int32_t*)path_nodes,
        (const float*)policy, (const float*)value, (float*)value_out,
        (unsigned long long*)depth_sum, (int64_t)M, (int64_t)R, B, N,
        tree_reuse};
    expand_kernel<<<(B + kExpandGames - 1) / kExpandGames, kExpandGames * 32,
                    0, (cudaStream_t)stream>>>(args);
  }
  return (int)cudaGetLastError();
}

// The launch floor: one thread of a kernel with no body. What a launch
// costs on the device and on the host when the kernel does nothing.
int launch_floor(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
