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
// A simulation is one descend launch, the evaluator, the expansion's row
// write and one commit_path launch, none of which the host has to read
// for: the search captures it once as a CUDA graph and replays it
// (alphazero_torch/search/graph.py). Each entry point launches on the
// given stream and returns cudaGetLastError(); it never synchronises.

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
  int turn = p.turn[b];
  int winner = p.winner[b];
  bool done = p.done[b] != 0;
  int move_count = p.move_count[b];
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
  uint64_t white = (uint64_t)s_squares[1] << 32 | s_squares[0];
  uint64_t black = (uint64_t)s_squares[3] << 32 | s_squares[2];

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
    if (!done) {
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
    descend_kernel<<<B, kDescendThreads, 0, (cudaStream_t)stream>>>(args);
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
