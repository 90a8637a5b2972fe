// The encoder body's attention with its smolgen bias, for Hopper (sm_90a),
// bound to Python with ctypes (models/attention.py).
//
// Replaces no Pallas kernel: the JAX package has no attention. It is the
// one hand kernel of the encoder body's bf16 evaluator
// (models/encoder_inference.py), one launch a layer. For every board b and
// head h, with T = 64 tokens, D = 32, G = 256:
//   bias[i, j] = sum_c s[b, h, c] * W_gen[c, 64 i + j]     (smolgen's bias)
//   l[i, j]    = q_i . k_j / sqrt(D) + bias[i, j]
//   e[i, j]    = exp(l[i, j] - max_j l[i, j])
//   out[b, i, h D + d] = bf16(sum_j bf16(e[i, j]) v[j, d] / sum_j e[i, j])
// with q, k, v read from the QKV projection's packed bf16 output
// [boards * 64][3 * 1024] (Q | K | V, head h at columns h D ..), s the
// per-head smolgen vectors [boards][32][256], both bf16, and W_gen from
// its packed image (models/attention.py:wgen_image). Every product on
// tensor cores with float32 sums; the bias and the softmax in float32. The
// plain version is models/attention.py:smolgen_attention_plain.
//
// Bound on an H100 at 512 boards, one launch a layer: bytes. Q, K, V and
// the output, 4 x 67 MB, and the smolgen vectors and W_gen (8.4 MB, 2 MB)
// are 279 MB, 83.3 us at 3.35 TB/s; the 42.9 GFLOP (34.4 of them the
// bias: a 16,384 x 256 x 4,096 product) take 43.4 us at 989 TFLOP/s.
//
// Design. A thread-block cluster of four blocks takes two boards at a
// time, 64 (board, head) rows, and walks the pairs of boards as a
// persistent grid (as many clusters as the card holds at once: 30 on an
// H100, 120 blocks). Block r owns 16 of the 64 rows (board r / 2, heads
// 16 (r % 2) .. + 15); its eight attention warps take two of them each,
// and one warpgroup makes the bias. The bias is made and used in chunks of
// 8 query rows (512 positions) and never reaches device memory:
//   - The bias product. Each block's bias warpgroup computes all 64 rows
// of the pair over its quarter of the chunk's positions (query rows 2 r
// and 2 r + 1, 128 positions) as 16 wgmma.mma_async m64n128k16: A, the 64
// smolgen vectors, from registers (16-byte reads, once a pair); B, W_gen,
// from shared memory. So W_gen is read once a cluster a pair, each block
// a quarter of it: 0.5 GB from L2 a launch at 512 boards, against 1 GB when
// every block read all of it. Its 16 KB tiles (128 positions by 64 k,
// 128-byte swizzled rows, k in the order that makes A's reads 16 bytes)
// stream through a ring of four stages by bulk copies completing on
// mbarriers; the next tile's products are issued before the last ones are
// waited for.
//   - The exchange. The four quarters of a chunk meet in distributed shared
// memory: warp w of the bias warpgroup holds rows 16 w .. + 15, the rows
// block w owns, and stages them (float32, swizzled) in a slice for block w;
// one bulk copy a slice then moves it into block w's bias buffer and
// completes on block w's "full" mbarrier. A block's buffer holds two
// chunks, so the bias warpgroup makes chunk c + 1 while the attention
// works on chunk c, and waits on an "empty" mbarrier (that the owner's
// eight attention warps arrive on) before it sends into a half again.
//   - The attention. A chunk's logits are taken transposed, keys as the
// rows of the m16n8k16 tile and the 8 query rows as its columns: S^T =
// K Q^T with K in registers for the pair and Q read into registers a
// chunk ahead, the bias added, each query row's softmax down the eight
// lanes that share lane % 4, P^T rounded to bf16 and turned into the next
// product's B operand by movmatrix, and out^T = V^T P^T with V^T read by
// ldmatrix.trans from V staged in shared memory by cp.async (a swizzled
// layout free of bank conflicts). out^T turns back by movmatrix into rows
// of the output.
// Every sum is taken in an order fixed by the code, so the result does not
// depend on which block or warp finishes first. A pair whose second board
// is missing (an odd count) runs the same code with that board's smolgen
// rows read as zeros and its two blocks' attention skipped.
//   Tried and not kept: two pairs a cluster of eight sharing each W_gen
// tile by multicast (the two blocks of a tile then wait on each other
// before every refill of the ring: slower, with 16 KB and with 8 KB
// tiles), the bias stored straight into the owners' buffers with
// st.shared::cluster (its stores took longer than the product), Q staged
// in shared memory (its 16 KB went to the ring's fourth stage).
//   What bounds it: the attention warps, at some 2 us a chunk of 16 heads,
// latency-bound with two of them on each scheduler (registers: K takes 64
// of a thread's 168); the bias warpgroup, W_gen's tiles from L2 and the
// exchange, a little behind them.
//
// The entry point launches on the given stream and returns
// cudaGetLastError(); it never synchronises and allocates nothing.
// Compiled with -DSMOLGEN_HALF=1 the kernel makes and exchanges only the
// bias, with -DSMOLGEN_HALF=2 only the attention (on an unset bias): the
// halves that chip_smoke.py times alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SMOLGEN_HALF
#define SMOLGEN_HALF 0
#endif

namespace {

constexpr int kT = 64;                 // tokens (squares) a board
constexpr int kH = 32;                 // heads
constexpr int kD = 32;                 // a head's width
constexpr int kE = kH * kD;            // 1024
constexpr int kQKV = 3 * kE;           // a token's row of the packed QKV
constexpr int kG = 256;                // smolgen's width a head
constexpr int kCluster = 4;            // blocks a cluster
constexpr int kBoards = 2;             // boards a cluster takes at a time
constexpr int kHeadsCta = kBoards * kH / kCluster;   // 16 rows a block owns
constexpr int kQ = 8;                  // query rows a chunk
constexpr int kChunks = kT / kQ;
constexpr int kPos = kQ * kT / kCluster;     // a block's positions a chunk: 128
constexpr int kKTile = 64;             // k of a W_gen tile: a 128-byte row
constexpr int kKTiles = kG / kKTile;
constexpr int kTileBytes = kPos * kKTile * 2;        // 16 KB
constexpr int kTilesPair = kChunks * kKTiles;        // a block's tiles a pair
constexpr int kStages = 4;             // W_gen ring
constexpr int kAttnWarps = 8;
constexpr int kHeadsWarp = kHeadsCta / kAttnWarps;   // 2
constexpr int kThreads = 32 * kAttnWarps + 128;      // and the bias warpgroup
constexpr int kSlice = kHeadsCta * 2 * kT;   // floats a block sends a block
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
  unsigned char w[kStages][kTileBytes];    // W_gen ring, 1024-byte aligned
  // two chunks' bias: [writing block r][head][key][query row - 2 r], key j
  // at j ^ bias_swizzle(r + head)
  float bias[2][kCluster][kSlice];
  // this block's bias of a chunk, as it goes to each block
  float out[kCluster][kSlice];
  // a head's V: [key][32 dims], 16-byte piece p of key k at piece
  // p ^ ((k >> 1) & 3)
  __nv_bfloat16 v[kHeadsCta][kT * kD];
  uint64_t w_full[kStages];              // a W_gen tile has landed
  uint64_t w_empty[kStages];             // the bias warps have read it
  uint64_t full[2];                      // a chunk's bias is in
  uint64_t empty[2][kCluster];           // block r has read a chunk's bias
};
constexpr int kSmem = sizeof(Smem) + 1024;   // and the ring's alignment

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ int cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return (int)r;
}

// The address in block `rank`'s shared memory of this block's `addr`.
__device__ __forceinline__ uint32_t map_to(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Arrives on a barrier of any block of the cluster (a mapped address),
// ordering nothing: for a reader that is done with a buffer.
__device__ __forceinline__ void mbar_arrive_cluster_relaxed(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0];\n"
      :: "r"(bar) : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// The same, acquiring what other blocks of the cluster released.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One contiguous block from device memory into shared memory; its bytes
// count against the mbarrier's expected transactions.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// This block's `bytes` at `src` into a block of the cluster (`dst`, a
// mapped address), completing on that block's barrier `bar` (mapped).
__device__ __forceinline__ void bulk_copy_to_block(uint32_t dst, uint32_t src,
                                                   uint32_t bytes,
                                                   uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Returns once the committed bulk copies have read their sources.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's writes to shared memory before later bulk copies.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of the bias warpgroup's 128 threads alone.
__device__ __forceinline__ void warpgroup_barrier() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// Arrives on a barrier of any block of the cluster (a mapped address) and
// adds `bytes` to the transactions it waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx_cluster(uint32_t bar,
                                                              uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.relaxed.cluster.shared::cluster.b64 _, "
      "[%0], %1;\n"
      :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The 8 x 8 bf16 matrix whose row lane / 4 holds columns 2 (lane % 4) and
// + 1 in each lane, transposed, in the same layout.
__device__ __forceinline__ uint32_t transpose8x8(uint32_t v) {
  uint32_t r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(r) : "r"(v));
  return r;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// 2^x in float32, the special function unit's approximation (two ulps;
// results below 2^-126 flush to zero).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint4 ldg16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulators above a wait.
__device__ __forceinline__ void fence_accumulators(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Descriptor of a K-major operand in 128-byte swizzled rows: eight rows
// are 1024 bytes (the stride offset); the leading offset is not used in
// this mode. The address must lie in a 1024-byte aligned tile; a k-step
// of 16 bf16 moves it by 32 bytes.
__device__ __forceinline__ uint64_t swizzled_kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 128 f32) += a (this warp's m16k16 bf16 fragment) x b (16 x 128
// bf16 in shared memory).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// Where key j of a head's bias lies in a block's slice of the buffer (a
// float2 a key: its two query rows): j ^ bias_swizzle(r + head) for the
// slice of block r, so that the bias warps' stores (heads on lane / 4) and
// the attention's reads (blocks on lane % 4) are free of bank conflicts.
__device__ __forceinline__ int bias_swizzle(int s) {
  return (s & 1) * 5 + ((s >> 1) & 1) * 8;
}

// The bias warpgroup: for each pair of boards, the 64 rows' bias over this
// block's 128 positions of each chunk, sent to the blocks that own them.
__device__ __forceinline__ void make_bias(Smem& sm, const __nv_bfloat16* s,
                                          const unsigned char* wgen_image,
                                          int boards, uint32_t rank,
                                          int first, int step, int npairs) {
  const int wt = threadIdx.x - 32 * kAttnWarps;     // 0 .. 127
  const int w = wt / 32, lane = wt % 32, g = lane / 4, t = lane % 4;
  const int total = npairs * kTilesPair;
  // the block's tiles in order: chunk c of a pair takes the 128-position
  // block 4 c + rank, its k-tiles in order
  auto fetch_tile = [&](int i) {
    const int c = (i % kTilesPair) / kKTiles, kt = i % kKTiles;
    const int stage = i % kStages;
    mbar_arrive_expect_tx(smem_addr(&sm.w_full[stage]), kTileBytes);
    bulk_copy(smem_addr(sm.w[stage]),
              wgen_image + ((size_t)(c * kCluster + rank) * kKTiles + kt) *
                               kTileBytes,
              kTileBytes, smem_addr(&sm.w_full[stage]));
  };
  // tile i's stage is read: refill it with tile i + kStages
  auto release = [&](int i) {
    const int stage = i % kStages;
    if (lane == 0) mbar_arrive(smem_addr(&sm.w_empty[stage]));
    if (wt == 0 && i + kStages < total) {
      mbar_wait(smem_addr(&sm.w_empty[stage]), (i / kStages) & 1);
      fetch_tile(i + kStages);
    }
  };
  if (SMOLGEN_HALF != 2 && wt == 0)
    for (int i = 0; i < kStages && i < total; ++i) fetch_tile(i);

  // A: rows 16 w + g and + 8 of pair pi (board 2 pair + w / 2, heads
  // 16 (w % 2) + g and + 8), a 16-byte read of k 32 j + 8 t .. + 7 a row
  // giving k-steps 2 j and 2 j + 1 (the image's k order matches); a board
  // past the last reads as zeros
  uint32_t a[kG / 16][4];
  auto load_a = [&](int pi) {
    const int board = (first + pi * step) * kBoards + w / 2;
    const __nv_bfloat16* r0 =
        s + ((size_t)board * kH + 16 * (w % 2) + g) * kG;
    const bool present = pi < npairs && board < boards;
#pragma unroll
    for (int j = 0; j < kG / 32; ++j) {
      const uint4 lo = present ? ldg16(r0 + 32 * j + 8 * t) : uint4{};
      const uint4 hi = present ? ldg16(r0 + 8 * kG + 32 * j + 8 * t)
                               : uint4{};
      a[2 * j][0] = lo.x, a[2 * j][1] = hi.x;
      a[2 * j][2] = lo.y, a[2 * j][3] = hi.y;
      a[2 * j + 1][0] = lo.z, a[2 * j + 1][1] = hi.z;
      a[2 * j + 1][2] = lo.w, a[2 * j + 1][3] = hi.w;
    }
  };
  int tile = 0, chunk = 0;
  for (int pi = 0; pi < npairs; ++pi) {
    load_a(pi);
    for (int c = 0; c < kChunks; ++c, ++chunk) {
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      if (SMOLGEN_HALF != 2) {
        // one group of wgmma a tile, the next issued before the last is
        // waited for
#pragma unroll
        for (int kt = 0; kt < kKTiles; ++kt, ++tile) {
          const int stage = tile % kStages;
          mbar_wait(smem_addr(&sm.w_full[stage]), (tile / kStages) & 1);
          const uint64_t desc = swizzled_kmajor_desc(smem_addr(sm.w[stage]));
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kKTile / 16; ++ks)
            wgmma_m64n128k16(acc, a[kt * (kKTile / 16) + ks], desc + 2 * ks);
          wgmma_commit();
          if (kt > 0) {
            wgmma_wait<1>();
            release(tile - 1);
          }
        }
        wgmma_wait<0>();
        fence_accumulators(acc);
        release(tile - 1);
      }
      // the last chunk's copies have read sm.out
      if (wt < kCluster) bulk_wait_read();
      warpgroup_barrier();
      // rows 16 w + g (+ 8) are block w's heads g (+ 8); position 8 n + 2 t
      // (+ 1) is key 8 (n % 8) + 2 t (+ 1) of query row 2 rank + n / 8, so
      // n and n + 8 give one key's two query rows
      if (SMOLGEN_HALF != 2) {
        // heads g and g + 8 share the swizzle f: key 8 n + 2 t + e lies at
        // 8 (n ^ (f >> 3)) + ((2 t + e) ^ (f & 7)), so two row pointers
        // (n even, n odd) and constant offsets reach every store
        const int f = bias_swizzle(rank + g);
        float2* base = reinterpret_cast<float2*>(sm.out[w]) + g * kT;
        const int f3 = (f >> 3) & 1;
        float2* row[2] = {base + 8 * f3, base - 8 * f3};
#pragma unroll
        for (int n = 0; n < kPos / 16; ++n)
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              row[n & 1][8 * kT * half + 8 * n + ((2 * t + e) ^ (f & 7))] =
                  make_float2(acc[4 * n + 2 * half + e],
                              acc[4 * (n + 8) + 2 * half + e]);
      }
      fence_async_shared();
      warpgroup_barrier();
      // each block's slice, once that block has read the chunk before last
      // from the same buffer
      const int buf = chunk & 1, use = chunk >> 1;
      if (wt < kCluster) {
        if (use > 0)
          mbar_wait_cluster(smem_addr(&sm.empty[buf][wt]), (use - 1) & 1);
        const uint32_t full = map_to(smem_addr(&sm.full[buf]), wt);
        mbar_arrive_expect_tx_cluster(full, kSlice * 4);
        bulk_copy_to_block(map_to(smem_addr(sm.bias[buf][rank]), wt),
                           smem_addr(sm.out[wt]), kSlice * 4, full);
        bulk_commit();
      }
    }
  }
  if (wt < kCluster) bulk_wait_read();
}

// Logits of a warp's heads' 8 query rows of a chunk, in base 2, turned
// into P V's B operand (both heads at once, for the overlap of their
// latencies): S^T, keys 16 mt + g (+ 8) by query rows 2 t, 2 t + 1, from
// K's fragments (key 16 mt + g (+ 8), dims 8 t .. 8 t + 7: two k-steps' A in
// one 16-byte read) and Q's (query row g, the same dims, so the k order is
// the same in both); then the bias (rows 2 t, 2 t + 1 come from block t),
// each query row's softmax down the eight lanes that share t, and P^T in
// bf16 transposed by movmatrix: p[mt] holds keys 16 mt + 2 t (+ 1) and
// 16 mt + 8 + 2 t (+ 1) of query row g.
__device__ __forceinline__ void softmax_p(
    const uint4 (&k)[kHeadsWarp][4][2], const uint4 (&q)[kHeadsWarp],
    const float* bias, int local0, float inv_sqrt_d,
    uint32_t (&p)[kHeadsWarp][4][2], float (&sum)[kHeadsWarp][2]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float st[kHeadsWarp][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hh = 0; hh < kHeadsWarp; ++hh) {
      const uint4 ka = k[hh][mt][0], kb = k[hh][mt][1];
      float (&d)[4] = st[hh][mt];
      d[0] = d[1] = d[2] = d[3] = 0.f;
      mma(d, ka.x, kb.x, ka.y, kb.y, q[hh].x, q[hh].y);
      mma(d, ka.z, kb.z, ka.w, kb.w, q[hh].z, q[hh].w);
    }
  float mx[kHeadsWarp][2];
#pragma unroll
  for (int hh = 0; hh < kHeadsWarp; ++hh) {
    const int head = local0 + hh, sw = bias_swizzle(t + head);
    const float2* b =
        reinterpret_cast<const float2*>(bias + t * kSlice) + head * kT;
    mx[hh][0] = mx[hh][1] = -3.0e38f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 bb = b[(16 * mt + g + 8 * half) ^ sw];
        float& l0 = st[hh][mt][2 * half];
        float& l1 = st[hh][mt][2 * half + 1];
        l0 = fmaf(l0, inv_sqrt_d, bb.x) * kLog2e;
        l1 = fmaf(l1, inv_sqrt_d, bb.y) * kLog2e;
        mx[hh][0] = fmaxf(mx[hh][0], l0);
        mx[hh][1] = fmaxf(mx[hh][1], l1);
      }
  }
#pragma unroll
  for (int x = 4; x < 32; x *= 2)
#pragma unroll
    for (int hh = 0; hh < kHeadsWarp; ++hh)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mx[hh][r] =
            fmaxf(mx[hh][r], __shfl_xor_sync(0xffffffffu, mx[hh][r], x));
#pragma unroll
  for (int hh = 0; hh < kHeadsWarp; ++hh) {
    sum[hh][0] = sum[hh][1] = 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const float* l = st[hh][mt];
      const float e0 = fast_exp2(l[0] - mx[hh][0]);
      const float e1 = fast_exp2(l[1] - mx[hh][1]);
      const float e2 = fast_exp2(l[2] - mx[hh][0]);
      const float e3 = fast_exp2(l[3] - mx[hh][1]);
      sum[hh][0] += e0 + e2;
      sum[hh][1] += e1 + e3;
      p[hh][mt][0] = transpose8x8(pack(e0, e1));
      p[hh][mt][1] = transpose8x8(pack(e2, e3));
    }
  }
#pragma unroll
  for (int x = 4; x < 32; x *= 2)
#pragma unroll
    for (int hh = 0; hh < kHeadsWarp; ++hh)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        sum[hh][r] += __shfl_xor_sync(0xffffffffu, sum[hh][r], x);
}

// out^T = V^T P^T for the warp's heads: dims 16 dm + g (+ 8) by query rows
// 2 t, 2 t + 1, V^T's fragments by ldmatrix.trans of the stored [key][dim]
// tile (matrix j of lane 8 j + i reads key 16 ks + 8 (j / 2) + i, dims
// 16 dm + 8 (j % 2)); turned back by movmatrix into query row g, dims
// 16 dm + 8 half + 2 t (+ 1), and written to rows dst[0 ..), kE apart, the
// heads kD apart.
__device__ __forceinline__ void pv_out(const Smem& sm, int local0,
                                       const uint32_t (&p)[kHeadsWarp][4][2],
                                       const float (&sum)[kHeadsWarp][2],
                                       __nv_bfloat16* dst) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int j = lane / 8, i = lane % 8;
  float o[kHeadsWarp][2][4];
#pragma unroll
  for (int hh = 0; hh < kHeadsWarp; ++hh)
#pragma unroll
    for (int dm = 0; dm < 2; ++dm)
      o[hh][dm][0] = o[hh][dm][1] = o[hh][dm][2] = o[hh][dm][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int dm = 0; dm < 2; ++dm)
#pragma unroll
      for (int hh = 0; hh < kHeadsWarp; ++hh) {
        const int key = 16 * ks + 8 * (j >> 1) + i, piece = 2 * dm + (j & 1);
        uint32_t v[4];
        ldmatrix_x4_trans(v, smem_addr(sm.v[local0 + hh]) + key * 64 +
                                 16 * (piece ^ ((key >> 1) & 3)));
        mma(o[hh][dm], v[0], v[1], v[2], v[3], p[hh][ks][0], p[hh][ks][1]);
      }
#pragma unroll
  for (int hh = 0; hh < kHeadsWarp; ++hh) {
    const float inv0 = __frcp_rn(sum[hh][0]), inv1 = __frcp_rn(sum[hh][1]);
#pragma unroll
    for (int dm = 0; dm < 2; ++dm)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint32_t*>(dst + (size_t)g * kE + hh * kD +
                                     16 * dm + 8 * half + 2 * t) =
            transpose8x8(pack(o[hh][dm][2 * half] * inv0,
                              o[hh][dm][2 * half + 1] * inv1));
  }
}

// The attention warps: this block's 16 heads of each pair, two a warp. K
// stays in registers for the pair, V in shared memory; each chunk's Q is
// read into registers while the chunk before it runs.
__device__ __forceinline__ void run_attention(
    Smem& sm, const __nv_bfloat16* qkv, __nv_bfloat16* out, int boards,
    uint32_t rank, int first, int step, int npairs, float inv_sqrt_d) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int local0 = kHeadsWarp * warp;                 // of the block's 16
  const int head0 = 16 * (rank % 2) + local0;           // of the board's 32
  // the warp's Q rows of chunk c of pair pi: query row g, dims 8 t ..
  uint4 q[kHeadsWarp] = {};
  auto load_q = [&](int pi, int c) {
    const int board = (first + pi * step) * kBoards + rank / 2;
    if (SMOLGEN_HALF != 1 && pi < npairs && board < boards)
#pragma unroll
      for (int hh = 0; hh < kHeadsWarp; ++hh)
        q[hh] = ldg16(qkv + ((size_t)board * kT + c * kQ + g) * kQKV +
                      (head0 + hh) * kD + t * 8);
  };
  // K of pair pi in registers; V into shared memory, 16-byte pieces
  uint4 k[kHeadsWarp][4][2] = {};
  auto load_k = [&](int pi) {
    const int board = (first + pi * step) * kBoards + rank / 2;
    if (SMOLGEN_HALF != 1 && pi < npairs && board < boards)
#pragma unroll
      for (int hh = 0; hh < kHeadsWarp; ++hh)
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            k[hh][mt][half] =
                ldg16(qkv + ((size_t)board * kT + 16 * mt + g + 8 * half) *
                                kQKV +
                      kE + (head0 + hh) * kD + t * 8);
  };
  auto load_v = [&](int pi) {
    const int board = (first + pi * step) * kBoards + rank / 2;
    if (SMOLGEN_HALF != 1 && pi < npairs && board < boards)
#pragma unroll 4
      for (int idx = lane; idx < kHeadsWarp * kT * 4; idx += 32) {
        const int hh = idx / (kT * 4), key = (idx / 4) % kT, piece = idx % 4;
        cp_async16(smem_addr(sm.v[local0 + hh]) + key * 64 +
                       16 * (piece ^ ((key >> 1) & 3)),
                   qkv + ((size_t)board * kT + key) * kQKV + 2 * kE +
                       (head0 + hh) * kD + piece * 8);
      }
  };
  load_q(0, 0);
  int chunk = 0;
  for (int pi = 0; pi < npairs; ++pi) {
    const int board = (first + pi * step) * kBoards + rank / 2;
    const bool present = SMOLGEN_HALF != 1 && board < boards;
    __syncwarp();       // the pair before has read V
    load_k(pi);
    load_v(pi);
    for (int c = 0; c < kChunks; ++c, ++chunk) {
      const int buf = chunk & 1;
      mbar_wait_cluster(smem_addr(&sm.full[buf]), (chunk >> 1) & 1);
      uint32_t p[kHeadsWarp][4][2];
      float sum[kHeadsWarp][2];
      if (present)
        softmax_p(k, q, &sm.bias[buf][0][0], local0, inv_sqrt_d, p, sum);
      // the next chunk's Q (after the pair's last chunk, the next pair's)
      load_q(c + 1 < kChunks ? pi : pi + 1, (c + 1) % kChunks);
      // the bias is read: the buffer may be written again
      __syncwarp();
      if (lane < kCluster)
        mbar_arrive_cluster_relaxed(
            map_to(smem_addr(&sm.empty[buf][rank]), lane));
      if (present) {
        if (c == 0) {     // V has landed
          cp_async_wait_all();
          __syncwarp();
        }
        pv_out(sm, local0, p, sum,
               out + ((size_t)board * kT + c * kQ) * kE + head0 * kD);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
smolgen_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                         const __nv_bfloat16* __restrict__ s,
                         const unsigned char* __restrict__ wgen_image,
                         __nv_bfloat16* __restrict__ out, int boards,
                         float inv_sqrt_d) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of the address: the ring must start on a
  // 1024-byte boundary (the launch asks for 1024 bytes of slack); every
  // block of the cluster computes the same offset
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u));
  const uint32_t rank = cluster_rank();
  const int pairs = (boards + kBoards - 1) / kBoards;
  const int first = cluster_index(), step = cluster_count();
  const int npairs = (pairs - first + step - 1) / step;   // the grid: >= 1

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(smem_addr(&sm.w_full[i]), 1);
      mbar_init(smem_addr(&sm.w_empty[i]), 4);   // the bias warps
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(smem_addr(&sm.full[b]), kCluster);
      for (int r = 0; r < kCluster; ++r)
        mbar_init(smem_addr(&sm.empty[b][r]), kAttnWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();       // every block's barriers exist before any arrives

  if (threadIdx.x >= 32 * kAttnWarps)
    make_bias(sm, s, wgen_image, boards, rank, first, step, npairs);
  else
    run_attention(sm, qkv, out, boards, rank, first, step, npairs,
                  inv_sqrt_d);

  cluster_sync();       // no block leaves while another may write to it
}

cudaLaunchConfig_t launch_config(int clusters, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// qkv: bf16 [boards * 64][3072]; s: bf16 [boards][32][256]; wgen_image:
// W_gen packed by models/attention.py:wgen_image (2 MB); out: bf16
// [boards * 64][1024]; all contiguous and 16-byte aligned. heads, dim and
// gen must be the kernel's 32, 32 and 256.
int smolgen_attention_bf16(const void* qkv, const void* s,
                           const void* wgen_image, void* out, int boards,
                           int heads, int dim, int gen, void* stream) {
  if (boards < 0 || heads != kH || dim != kD || gen != kG)
    return (int)cudaErrorInvalidValue;
  // once a process, before the first launch (always eager: a search's
  // warm-up simulations run before its capture): the shared memory opt-in
  // and how many clusters the card holds at once, the persistent grid
  static int max_clusters = 0;
  cudaLaunchAttribute attr[1];
  if (max_clusters == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        smolgen_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return (int)err;
    const cudaLaunchConfig_t cfg = launch_config(1, nullptr, attr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, smolgen_attention_kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    max_clusters = n;
  }
  if (boards == 0) return (int)cudaGetLastError();
  const int pairs = (boards + kBoards - 1) / kBoards;
  const cudaLaunchConfig_t cfg =
      launch_config(pairs < max_clusters ? pairs : max_clusters,
                    (cudaStream_t)stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, smolgen_attention_kernel, static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(s),
      static_cast<const unsigned char*>(wgen_image),
      static_cast<__nv_bfloat16*>(out), boards, 0.17677669529663687f);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
