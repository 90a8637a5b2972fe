// bf16 3x3 SAME convolution with the BatchNorm as its epilogue, for Hopper
// (sm_90a), bound to Python with ctypes.
//
// Replaces the tower's bf16 convolutions of the JAX package's net,
// alphazero_tpu/models/network.py:66-67 (conv1), :71-72 (conv2) and
// :151-152 (policy_conv), which XLA compiles; the JAX package's one TPU
// kernel on this net computes the same conv in its body (the conv of
// _tower_kernel, alphazero_tpu/models/fused.py:202-213: nine shifted
// matmuls summed in f32). Per board b, square s = h*8 + w and output
// channel co of NHWC bf16 maps (B, 8, 8, C):
//   y[b,s,co]   = bf16(sum over the 3x3 taps and ci of x[b,s+tap,ci] *
//                 w[co,ci,tap])            (f32 sums, zero off the board)
//   out[b,s,co] = epi(y)
// with epi one of: none (y); affine (bf16(((f32(y) - mean) * mul) + beta));
// affine_relu (the same with ReLU before the cast). The conv's sum rounds
// to bf16 first and only then does the affine run, where Flax rounds
// (nn.Conv with dtype bf16, then nn.BatchNorm), and the affine is
// bn_act_kernel's (epilogue_kernels.cu), with __fsub_rn, __fmul_rn and
// __fadd_rn and no FMA: so the epilogue's output is bit-equal to
// models/epilogue.py:bn_act_plain of the conv alone. C is 32, 128 or 256,
// cin = cout = C.
//
// Bound on an H100, one 128 -> 128 conv at 512 boards: operations.
// 2 x 512 x 64 x 128 x 1152 = 9.664e9 at 989 TFLOP/s take 0.00977 ms; the
// bytes (8.39 MB in, 8.39 MB out, 294,912 of weights, 1,536 of BatchNorm
// constants) take 0.0051 ms at 3.35 TB/s. At one board the bound is 0.0001
// ms, and what binds is latency: a board's 72 k-steps are one chain of
// dependent wgmmas, 130 to 140 SM cycles a k-step whatever the N
// (scripts/conv_timeline.py), so one board takes at least some 5 us.
//
// Design. One board is 64 rows, the M of Hopper's warpgroup matrix
// multiply. The conv is a product of the board's 64 squares by K = 9 taps
// x C (k = tap*C + ci, zero past 9C) by the output channels, in tiles of N
// = 128 (C 32: one tile of 32; C 256: two). A piece of work is a group of
// PER boards (one to four, a consumer warpgroup each) and NP output
// channels of a tile: all of it (128), a half (64) or an eighth (16) at C
// 128 and 256. The launch (models/conv.py:conv_launch_shape) takes the
// first shape, in a measured order, that fills at most one wave: at one
// board eight blocks of 16 channels, so that a board's chain runs on eight
// SMs at once, each with a short epilogue; two boards a block at 32; one
// board and a whole tile at 128; three boards at 384, four at 512 (at C 256
// from 397 boards the persistent path below takes over). A block
// takes a run of consecutive pieces, so the tiles of one group of boards
// share the boards' rows. Whatever the piece, the products are one
// wgmma.mma_async m64nNk16 a k-step with N = NP into the f32 accumulators
// of the one warpgroup that holds the board, every k-step in k order: the
// order of each element's sums is fixed by C alone, so a board's output
// does not depend on the batch, the launch shape, the block or the
// warpgroup (no split of K, no atomics). The N of an instruction does not
// change its elements' sums: every shape is bit-equal to the earlier
// version of this kernel (commit 8aae90f), which ran m64n64k16 (m64n32k16
// at C 32) throughout, at every conv of the archived net
// (scripts/conv_against_parent.py); chip_smoke.py phase 17 and
// scripts/conv_launch_sweep.py hold the shapes bit-equal.
//   B, the weights, is read by the tensor cores from shared memory through
// a matrix descriptor. The host packs them once into the image the
// descriptor reads (models/conv.py:weight_image): chunks of 64 K values
// (128 bytes) for the tile's output channels, stored [n][64] (K-major)
// with the 128-byte swizzle (the 16-byte piece j of row n lies at piece j
// ^ (n % 8)); 16 KB a chunk at N 128, 18 chunks a tile at C 128 (one half
// of a tap each), 5 at C 32 (two taps each; the last half zero). A piece's
// part of a chunk is NP of its rows, contiguous. One thread of the
// producer warpgroup brings every chunk of the block's pieces by bulk
// copies (cp.async.bulk) that complete on the stage's full mbarrier,
// through a ring as deep as shared memory allows beside the boards' rows:
// at C 128 every chunk of a piece of 64 or fewer channels has a stage of
// its own (144 KB at 64), a whole tile has 12 stages for one board, 10 for
// three and 9 for four. (The earlier ring of four stages was not what
// bound it: no chunk waited for its copy. The depth lets every weight of
// a small piece arrive before the kernel ahead of it ends.) Every consumer warp arrives on the stage's empty mbarrier once
// the wgmma group that read it has completed (a warpgroup without a board
// frees each chunk as it lands).
//   The launch is a programmatic dependent one: every block lets the next
// kernel on the stream start at once (griddepcontrol.launch_dependents),
// and the kernel sets up its barriers and issues its weight copies before
// it waits for the kernel ahead of it (griddepcontrol.wait), which has
// written its x. The image must therefore be complete before the launch
// (models/conv.py:weight_image returns only once it is on the device); the
// BatchNorm constants, x and out are touched only after the wait. At
// small batches a launch's blocks start on SMs its predecessor leaves
// free, with their weights in, while the predecessor runs.
//   A, the activations, is fed from registers. A warpgroup brings its
// board's 64 rows of x into shared memory by 16-byte loads, all in flight
// at once, into rows padded by 16 bytes so that the eight row addresses
// of an ldmatrix fall in distinct banks. (One bulk copy a row instead,
// from a producer warp, took 0.0250 ms at 512 boards on an H100 against
// 0.0191 with these loads, chip_smoke.py phase 17: the 256 small copies
// of a block likely queue in the copy engine ahead of the weights.) For
// tap (dy, dx) each lane points its ldmatrix at row (h+dy, w+dx) of the
// board, or at a row of zeros off the board (and past tap 8), and the
// m16k16 fragment that ldmatrix.x4 gives is wgmma's A fragment. The k-steps
// go in commit groups of two with two sets of fragments, so one group's
// ldmatrix runs while the group before it multiplies; no wgmma sits in a
// branch (ptxas would serialise it): the piece's shape is a template
// parameter.
//   The epilogue runs on the accumulators: the four lanes of a quad trade
// packed pairs by three shuffles so that each lane stores 16 bytes and a
// warp's store covers 64 contiguous bytes of eight rows, whole 32-byte
// sectors (qconv_kernel.cu's store); at NP 16 each lane stores its pairs.
// A second producer warp brings the BatchNorm constants into shared memory
// while the products run; a lane reads a column pair's as float2.
//   The threads start with 96 registers (launch bounds of 640, four
// consumer warpgroups and the producer's; a launch has PER + 1
// warpgroups); setmaxnreg gives the consumers 112 and the producer 24.
// Above 48 KB of shared memory through the opt-in that conv3x3_init makes
// once a device.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 17,
// C 128 with the affine and ReLU, in turns with cuDNN's conv alone;
// PERF.md has the runs): 0.0195 ms at 512 boards (cuDNN 0.0255), 0.0102
// at 128 (0.0106), 0.0071 at 32 (0.0077), 0.0061 at one (0.0074). At one
// board 4.9 us of it is the chain.
//
// The persistent path (persistent_conv3x3_kernel): C 256 wherever it gives
// a block no more products than the pieces above (models/conv.py:
// conv_launch_shape: 397 to 528 boards on 132 SMs, and batches whose runs
// of pieces are as long, such as 1,031). A block takes a group of four
// boards, a consumer warpgroup each, and both tiles, tile after tile; the
// blocks walk the groups in rounds. Its timeline at 512 boards
// (scripts/conv_timeline.py; PERF.md) showed where the four-board shape's
// 0.064 ms went: 4 us loading the four boards' rows after the wait, some
// 28 us of products a tile (no chunk waited on its copy), and 3.5 and 2.5 us
// of epilogue a tile, in which every block's warpgroups reach their stores
// together and the tensor cores idle. Measured against it variant by
// variant (one NVIDIA H100 80GB HBM3, 700 W; PERF.md has the runs), what
// this path changes: the rows unpadded, their 16-byte pieces swizzled by
// the row (j ^ (m % 8)) in place of the 16-byte pad, which leaves room for
// a fifth stage beside the BatchNorm constants (read from device memory in
// the epilogue instead they cost 4 us); the rows copied asynchronously, all
// in flight at once; the second pair of warpgroups loading its rows only
// once the first pair's are in, so that the first pair starts sooner and
// the pairs reach their epilogues apart (0.7 us); each tap's row and
// swizzle worked out once a tap, the taps and a tap's chunks unrolled
// (some 5.5 us: the zero row's and a chunk's address arithmetic); and the
// epilogue's conversions halved (finish2: two sums rounded by one packed
// conversion) and its transposition made by stmatrix through a warp's
// 512-byte scratch (together 0.7 us). The products, their k order and the
// values stored are the four-board shape's, so the path is bit-equal to
// it: 0.0545-0.0553 ms against 0.0635-0.0655 at 512 boards.
//   Where the rest goes (each by a variant that leaves one part out): the
// two epilogues some 5.5 us (either one alone 3.3 us; their stores but
// 0.5 us of it: the epilogue is bound by its own latency, some 560
// instructions a thread, and the pairs' epilogues still overlap, the
// shared ring keeping the pairs within five chunks of each other), the
// rows' load 2 us, the weights' traffic from L2 0.7 us; one pair alone
// keeps the tensor cores 90% as busy as both. Tried and not kept: blocks
// paired in clusters sharing each chunk by multicast (0.084 ms: a stage is
// refilled only once both blocks have read it), the second pair held back
// one to three chunks more (slower by 0.4-1.2 us: the leading pair then
// waits on the ring), a sixth stage with the constants read from device
// memory (4 us slower), the rows loaded in four slices of channels for the
// first chunks (1.3 us slower), the epilogue specialised by its kind (2.7
// us slower), four k-steps a commit group (ptxas serialises the wgmma,
// C7512), half of the first tile's outputs kept in registers to be stored
// during the second tile (spills at 120 registers).
//
// The entry point launches on the given stream (cudaLaunchKernelEx) and
// returns the launch's error; it never synchronises, allocates nothing and
// queries nothing of the device.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBoards = 4;           // consumer warpgroups a block, at most
constexpr int kThreads = (kMaxBoards + 1) * 128;  // and the producer's
constexpr int kConsumerRegs = 112;      // 640 threads start with 96 each
constexpr int kProducerRegs = 24;
constexpr int kChunkK = 64;             // K values in a row of the image
constexpr int kSmemOptIn = 232448;      // a block's, after the opt-in

enum Epilogue { kNone = 0, kAffine = 1, kAffineRelu = 2 };

template <int C>
struct Shape {
  static constexpr int kTileN = C < 128 ? C : 128;     // image tile's rows
  static constexpr int kTiles = C / kTileN;
  static constexpr int kChunks = (9 * C + kChunkK - 1) / kChunkK;
  static constexpr int kChunkBytes = kTileN * kChunkK * 2;
  static constexpr int kStride = C + 8;                // padded row, bf16
  static constexpr int kRowBytes = kStride * 2;
};

// Stages of the weight ring for pieces of NP channels and PER boards: as
// many as fit beside the rows, the zero row, the constants and the
// barriers, and no more than a piece's chunks (models/conv.py:conv_stages
// counts the same).
template <int C, int NP, int PER>
constexpr int ring_stages() {
  constexpr int fixed = PER * 64 * Shape<C>::kRowBytes + Shape<C>::kRowBytes
                        + 3 * C * 4 + 8;
  constexpr int fit = (kSmemOptIn - 1024 - fixed) / (NP * kChunkK * 2 + 16);
  return fit < Shape<C>::kChunks ? fit : Shape<C>::kChunks;
}

template <int C, int NP, int PER>
struct Smem {
  static constexpr int kStages = ring_stages<C, NP, PER>();
  unsigned char w[kStages][NP * kChunkK * 2];         // 1024-byte aligned
  __nv_bfloat16 rows[PER][64 * Shape<C>::kStride];    // a board each
  __nv_bfloat16 zero[Shape<C>::kStride];  // the off-board source row
  float mean[C], mul[C], beta[C];       // the BatchNorm, if any
  uint64_t full[kStages];               // mbarriers: chunk has landed
  uint64_t empty[kStages];              // mbarriers: chunk has been read
  uint64_t consts;                      // the BatchNorm constants are in
};

template <int C, int NP, int PER>
constexpr int smem_bytes() {
  return (int)sizeof(Smem<C, NP, PER>) + 1024;  // and slack to align the ring
}

struct Args {
  const __nv_bfloat16* x;               // (boards, 64, C)
  const unsigned char* image;           // (tiles, chunks, N, 64) bf16
  const float* mean;                    // [C] each, or null (epi none)
  const float* mul;
  const float* beta;
  __nv_bfloat16* out;                   // (boards, 64, C)
  int boards, epi;
#ifdef CONV_TIMELINE
  unsigned long long* trace;            // (grid, kSlots, 2)
#endif
};

// Built with -DCONV_TIMELINE (scripts/conv_timeline.py), a block writes
// %globaltimer (ns) and clock64 (SM cycles) at the points it names, into
// slot k of its row of a.trace; otherwise the stamps are not compiled.
// Slots: 0-6 the first piece's phases, 8 + c its chunk c landed, 48 + c
// its copy issued, 96 + c the last piece's chunk c landed, 140-142 the
// last piece's start, products and stores; on the persistent path a piece
// is a tile, and 143-149 are the second pair's: its rows in, then for each
// tile its first chunk landed, its products and its stores.
#ifdef CONV_TIMELINE
constexpr int kSlots = 160;
__device__ __forceinline__ void stamp(unsigned long long* trace, int k) {
  unsigned long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g) :: "memory");
  const unsigned long long c = clock64();
  trace[(blockIdx.x * kSlots + k) * 2] = g;
  trace[(blockIdx.x * kSlots + k) * 2 + 1] = c;
}
#define STAMP(k) stamp(a.trace, (k))
#else
#define STAMP(k) ((void)0)
#endif

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Returns once the barrier's phase of the given parity has completed. A
// wait that cannot end (a fault in this kernel) traps after some 2^24
// tries, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}

// A consumer's wait for a weight chunk. In the -DCONV_TIMELINE build the
// SM cycles thread 0 spends in it, and the waits past 100 cycles, add up
// in slot 150 of its block's row.
#ifdef CONV_TIMELINE
__device__ __forceinline__ void chunk_wait(unsigned long long* trace,
                                           uint32_t bar, uint32_t parity) {
  if (threadIdx.x != 0) return mbar_wait(bar, parity);
  const unsigned long long c0 = clock64();
  mbar_wait(bar, parity);
  const unsigned long long d = clock64() - c0;
  trace[(blockIdx.x * kSlots + 150) * 2] += d;
  trace[(blockIdx.x * kSlots + 150) * 2 + 1] += d > 100;
}
#define CHUNK_WAIT(bar, parity) chunk_wait(a.trace, (bar), (parity))
#else
#define CHUNK_WAIT(bar, parity) mbar_wait((bar), (parity))
#endif

// One contiguous block from device memory into shared memory; its bytes
// count against the mbarrier's expected transactions.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void warpgroup_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// 16 bytes from device memory into shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A named barrier of `n` threads: some wait for it, the others arrive.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int W>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(W) : "memory");
}

// Keeps the compiler from moving reads of the accumulators above a wait.
template <int R>
__device__ __forceinline__ void fence_accumulators(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Descriptor of a K-major operand in 128-byte swizzled rows: eight rows
// are 1024 bytes (the stride offset); the leading offset is not used in
// this mode. The address must lie in a 1024-byte aligned tile; a k-step
// of 16 bf16 moves it by 32 bytes (2 in the descriptor's units).
__device__ __forceinline__ uint64_t swizzled_kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x N f32, this warpgroup's board) = a (this warp's m16k16 bf16
// fragment) x b (16 x N bf16 in shared memory) + (scale_d ? d : 0).
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The conv's output: its f32 sum rounded to bf16, where Flax's nn.Conv
// (dtype bf16) rounds, before any BatchNorm.
__device__ __forceinline__ float conv_value(float sum) {
  return round_bf16(sum);
}

// bn_act_kernel's BatchNorm: ((y - mean) * mul) + beta in f32, no FMA,
// then torch.relu's ReLU (NaN stays NaN) when asked
__device__ __forceinline__ float finish(float sum, float mean, float mul,
                                        float beta, int epi) {
  const float y = conv_value(sum);
  if (epi == kNone) return y;
  const float v = __fadd_rn(__fmul_rn(__fsub_rn(y, mean), mul), beta);
  return (epi == kAffineRelu && v < 0.0f) ? 0.0f : v;
}

__device__ __forceinline__ uint32_t pick(uint32_t p0, uint32_t p1, uint32_t p2,
                                         uint32_t p3, int i) {
  return i == 0 ? p0 : i == 1 ? p1 : i == 2 ? p2 : p3;
}

// Keeps the compiler from loading every column's constants at once (it
// would spill): the epilogue goes one group of 32 columns at a time.
__device__ __forceinline__ void compiler_barrier() {
  asm volatile("" ::: "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// Programmatic dependent launch: let the next kernel on the stream start,
// and wait until the kernel ahead of this one has finished and its
// writes are visible (a no-op when the launch has no such dependency).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_predecessor() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Rows c_row (at `out`, the piece's first column) and c_row + 8 of this
// warpgroup's board, from the accumulator elements nt*4 + half*2 + e
// (column nt*8 + 2t + e, row c_row + 8*half); rows are C apart. For N of
// 32 or more the quad's lanes trade packed pairs so that lane t writes
// columns (4q + t)*8 .. +7 of a row, 16 bytes; at N 16 each lane writes
// its own pairs. mean, mul, beta: the piece's.
template <int C, int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[N / 2], int t,
                                           const float* mean,
                                           const float* mul,
                                           const float* beta, int epi) {
  if constexpr (N == 16) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = nt * 8 + 2 * t;
      float2 m = {0.f, 0.f}, k = {0.f, 0.f}, b = {0.f, 0.f};
      if (epi != kNone) {               // col is even: 8-byte aligned
        m = *reinterpret_cast<const float2*>(mean + col);
        k = *reinterpret_cast<const float2*>(mul + col);
        b = *reinterpret_cast<const float2*>(beta + col);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            finish(acc[nt * 4 + half * 2], m.x, k.x, b.x, epi),
            finish(acc[nt * 4 + half * 2 + 1], m.y, k.y, b.y, epi));
        *reinterpret_cast<__nv_bfloat162*>(out + half * 8 * C + col) = v;
      }
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < N / 32; ++q) {
    uint32_t p[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nt = 4 * q + j, col = nt * 8 + 2 * t;
      float2 m = {0.f, 0.f}, k = {0.f, 0.f}, b = {0.f, 0.f};
      if (epi != kNone) {               // col is even: 8-byte aligned
        m = *reinterpret_cast<const float2*>(mean + col);
        k = *reinterpret_cast<const float2*>(mul + col);
        b = *reinterpret_cast<const float2*>(beta + col);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            finish(acc[nt * 4 + half * 2], m.x, k.x, b.x, epi),
            finish(acc[nt * 4 + half * 2 + 1], m.y, k.y, b.y, epi));
        p[half][j] = *reinterpret_cast<const uint32_t*>(&v);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // lane u's pair for columns (4q + t)*8 + 2u is its p[t]; it arrives
      // from lane t ^ k in r[k]
      const uint32_t* ph = p[half];
      uint32_t r[4];
      r[0] = pick(ph[0], ph[1], ph[2], ph[3], t);
#pragma unroll
      for (int k = 1; k < 4; ++k)
        r[k] = __shfl_xor_sync(0xffffffffu,
                               pick(ph[0], ph[1], ph[2], ph[3], t ^ k), k);
      *reinterpret_cast<uint4*>(out + half * 8 * C + (4 * q + t) * 8) =
          make_uint4(pick(r[0], r[1], r[2], r[3], t),
                     pick(r[0], r[1], r[2], r[3], t ^ 1),
                     pick(r[0], r[1], r[2], r[3], t ^ 2),
                     pick(r[0], r[1], r[2], r[3], t ^ 3));
    }
    compiler_barrier();
  }
}

// One launch: pieces of NP output channels of a tile, of groups of PER
// boards; a block takes a run of consecutive pieces.
template <int C, int NP, int PER>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_kernel(const Args a) {
  using S = Shape<C>;
  using L = Smem<C, NP, PER>;
  constexpr int kN = NP;                // a wgmma's N: one a k-step
  constexpr int kParts = S::kTileN / NP;  // pieces a tile
  constexpr int kPerGroup = S::kTiles * kParts;  // pieces a group of boards
  constexpr int kPieceBytes = NP * kChunkK * 2;  // of a chunk
  constexpr int kStages = L::kStages;
  constexpr int kConsumers = PER * 128;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of the address: the ring must start on a
  // 1024-byte boundary (the launch asks for 1024 bytes of slack)
  L& s = *reinterpret_cast<L*>(
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int pieces = (a.boards + PER - 1) / PER * kPerGroup;
  const int run = (pieces + gridDim.x - 1) / gridDim.x;
  const int first = blockIdx.x * run;
  const int last = first + run < pieces ? first + run : pieces;
  if (tid == 0) STAMP(0);
  launch_dependents();

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(smem_addr(&s.full[i]), 1);                // the producer
      mbar_init(smem_addr(&s.empty[i]), kConsumers / 32);  // every warp
    }
    mbar_init(smem_addr(&s.consts), 32);                  // a warp's lanes
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < S::kStride; i += blockDim.x)
    s.zero[i] = __float2bfloat16(0.0f);
  __syncthreads();                      // the only block-wide barrier
  if (tid == 0) STAMP(1);

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    const int pwarp = (tid - kConsumers) >> 5;
    if (pwarp == 0 && lane == 0) {
      // the weights: every chunk of the block's pieces through the ring,
      // as far ahead as the consumers have freed stages; they are
      // constants, so the first stages fill before the wait
      int q = 0;
      for (int piece = first; piece < last; ++piece) {
        const int sub = piece % kPerGroup;
        const unsigned char* src =
            a.image + ((size_t)(sub / kParts) * S::kChunks * S::kTileN +
                       (sub % kParts) * NP) * (kChunkK * 2);
        for (int c = 0; c < S::kChunks; ++c, ++q) {
          const int stage = q % kStages;
          if (q >= kStages)
            mbar_wait(smem_addr(&s.empty[stage]), ((q / kStages) - 1) & 1);
          const uint32_t full = smem_addr(&s.full[stage]);
          mbar_arrive_expect_tx(full, kPieceBytes);
          bulk_copy(smem_addr(s.w[stage]), src + (size_t)c * S::kChunkBytes,
                    kPieceBytes, full);
          if (piece == first) STAMP(48 + c);
        }
      }
    } else if (pwarp == 1) {
      // the BatchNorm constants, while the first products run
      wait_for_predecessor();
      if (a.epi != kNone)
        for (int c = lane; c < C; c += 32) {
          s.mean[c] = a.mean[c];
          s.mul[c] = a.mul[c];
          s.beta[c] = a.beta[c];
        }
      mbar_arrive(smem_addr(&s.consts));
    }
    return;
  }

  // Consumers: warpgroup wg takes board group*PER + wg of each piece.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs));
  const int wg = tid >> 7;
  const int ch = tid & 127;
  const int warp = ch >> 5;
  const int bar_id = wg + 1;            // named barrier of this warpgroup
  __nv_bfloat16* rows = s.rows[wg];
  const uint32_t src = smem_addr(rows);
  // ldmatrix lane roles for A: lane -> row (lane % 16) of the warp's 16
  // rows and the 8-column half (lane / 16) of a k-step
  const int a_m = warp * 16 + (lane & 15);
  const int a_h = a_m >> 3, a_w = a_m & 7;
  const uint32_t a_half = (lane >> 4) * 16;                 // bytes
  const uint32_t zero_addr = smem_addr(s.zero) + a_half;
  // this lane's A row for a tap: (h+dy, w+dx) of the board, or the zero
  // row off the board and past the ninth tap
  auto tap_row = [&](int tap) -> uint32_t {
    const int hs = a_h + tap / 3 - 1, ws = a_w + tap % 3 - 1;
    return (tap < 9 && hs >= 0 && hs < 8 && ws >= 0 && ws < 8)
               ? src + (hs * 8 + ws) * S::kRowBytes + a_half
               : zero_addr;
  };
  // accumulator element nt*4 + half*2 + e of a wgmma: row warp*16 +
  // lane/4 + half*8, column nt*8 + (lane%4)*2 + e of its kN
  const int c_row = warp * 16 + (lane >> 2);
  const int t = lane & 3;

  wait_for_predecessor();               // x is the kernel ahead's output
  if (tid == 0) STAMP(6);
  float acc[kN / 2];
  uint32_t frag[2][2][4];               // two sets of two k-steps
  int q = 0;                            // running weight chunk
  int held = -1;                        // the group whose rows are in
  for (int piece = first; piece < last; ++piece) {
    const int group = piece / kPerGroup;
    const int board = group * PER + wg;
    if (board >= a.boards) {
      // no board for this warpgroup: free each chunk as it lands
      for (int c = 0; c < S::kChunks; ++c, ++q) {
        const int stage = q % kStages;
        mbar_wait(smem_addr(&s.full[stage]), (q / kStages) & 1);
        if (lane == 0) mbar_arrive(smem_addr(&s.empty[stage]));
      }
      continue;
    }
    if (group != held) {
      // the board's 64 rows of x, C/8 16-byte pieces a row, into the
      // padded rows (the warpgroup's products of its last piece have
      // completed); the next tile of the same boards reuses them. (Two
      // cp.async groups instead, the channels of chunk 0 first, were no
      // faster on an H100 and spilled at C 256.)
      warpgroup_barrier(bar_id);
      constexpr int kSegs = C / 8;
      constexpr int kPer = 64 * kSegs / 128;        // pieces a thread
      const uint4* xb = reinterpret_cast<const uint4*>(
          a.x + (size_t)board * 64 * C);
      uint4 v[kPer < 8 ? kPer : 8];
#pragma unroll
      for (int i0 = 0; i0 < kPer; i0 += 8) {
#pragma unroll
        for (int i = 0; i < 8 && i0 + i < kPer; ++i)
          v[i] = __ldg(xb + (i0 + i) * 128 + ch);
#pragma unroll
        for (int i = 0; i < 8 && i0 + i < kPer; ++i) {
          const int p = (i0 + i) * 128 + ch;
          *reinterpret_cast<uint4*>(
              &rows[(p / kSegs) * S::kStride + (p % kSegs) * 8]) = v[i];
        }
      }
      warpgroup_barrier(bar_id);
      held = group;
    }
    const bool stamped = tid == 0 && piece == first;
    const bool stamped_last = tid == 0 && piece == last - 1 && piece != first;
    if (stamped) STAMP(2);
    if (stamped_last) STAMP(140);

    for (int c = 0; c < S::kChunks; ++c, ++q) {
      // this lane's A address for k-step m of the chunk, K values
      // 64c + 16m .. +15: tap (64c + 16m) / C, channel (64c + 16m) % C
      uint32_t r0, r1;
      if constexpr (C >= kChunkK) {     // a chunk within one tap
        constexpr int kPerTap = C / kChunkK;
        r0 = tap_row(c / kPerTap) + (c % kPerTap) * kChunkK * 2;
        r1 = r0 + 64;
      } else {                          // C 32: two taps a chunk
        r0 = tap_row(2 * c);
        r1 = tap_row(2 * c + 1);
      }
      const int stage = q % kStages;
      CHUNK_WAIT(smem_addr(&s.full[stage]), (q / kStages) & 1);
      if (stamped) STAMP(8 + c);
      if (stamped_last) STAMP(96 + c);
      // the stage's NP rows: 1024 bytes an eight rows
      const uint64_t desc = swizzled_kmajor_desc(smem_addr(s.w[stage]));

      // k-steps 0 and 1; the group before the last has completed, so its
      // fragments (set 0) are free
      ldmatrix_x4(frag[0][0], r0);
      ldmatrix_x4(frag[0][1], r0 + 32);
      wgmma_fence();
      wgmma_bf16<kN>(acc, frag[0][0], desc, c != 0);
      wgmma_bf16<kN>(acc, frag[0][1], desc + 2, 1);
      wgmma_commit();
      wgmma_wait<1>();                  // the previous chunk has been read
      if (c > 0 && lane == 0)
        mbar_arrive(smem_addr(&s.empty[(q - 1) % kStages]));

      // k-steps 2 and 3
      ldmatrix_x4(frag[1][0], r1);
      ldmatrix_x4(frag[1][1], r1 + 32);
      wgmma_fence();
      wgmma_bf16<kN>(acc, frag[1][0], desc + 4, 1);
      wgmma_bf16<kN>(acc, frag[1][1], desc + 6, 1);
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    if (stamped) STAMP(3);
    if (stamped_last) STAMP(141);
    if (lane == 0) mbar_arrive(smem_addr(&s.empty[(q - 1) % kStages]));
    fence_accumulators(acc);

    mbar_wait(smem_addr(&s.consts), 0);
    if (stamped) STAMP(4);
    const int sub = piece % kPerGroup;
    const int col0 = (sub / kParts) * S::kTileN + (sub % kParts) * NP;
    store_rows<C, kN>(a.out + ((size_t)board * 64 + c_row) * C + col0, acc,
                      t, s.mean + col0, s.mul + col0, s.beta + col0, a.epi);
    if (stamped) STAMP(5);
    if (stamped_last) STAMP(142);
  }
}

// ---------------------------------------------------------------------------
// The persistent path: C 256 at large batches
// ---------------------------------------------------------------------------

// finish() of two neighbouring columns, packed: both sums rounded to bf16 by
// one conversion (cvt.rn.bf16x2.f32 rounds each as cvt.rn.bf16.f32 does),
// then the BatchNorm and ReLU in f32 and the pair rounded again. The
// epilogue is bound by its conversions and their latency, so this halves
// the first rounding's conversions at no change of a bit.
__device__ __forceinline__ uint32_t finish2(float s0, float s1, float2 m,
                                            float2 k, float2 b, int epi) {
  const __nv_bfloat162 y = __floats2bfloat162_rn(s0, s1);
  if (epi == kNone) return *reinterpret_cast<const uint32_t*>(&y);
  float v0 = __fadd_rn(__fmul_rn(__fsub_rn(__low2float(y), m.x), k.x), b.x);
  float v1 = __fadd_rn(__fmul_rn(__fsub_rn(__high2float(y), m.y), k.y), b.y);
  if (epi == kAffineRelu) {
    v0 = v0 < 0.0f ? 0.0f : v0;
    v1 = v1 < 0.0f ? 0.0f : v1;
  }
  const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8 x 8 bf16 matrices into shared memory: lane l gives the address of
// row l % 8 of matrix l / 8, and holds columns 2 (l % 4), + 1 of row l / 4
// of each (the layout of a wgmma's accumulator).
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

// store_rows<C, 128> for a warp's 16 rows by way of its 512-byte scratch:
// each group of 32 columns of eight rows goes in by one stmatrix and comes
// back as 16 bytes a lane (row lane / 4, columns 8 (lane % 4) on), the
// transposition store_rows makes by shuffles and selects; the 16-byte
// pieces of a scratch row are swizzled by (row / 2) % 4 so that neither
// side meets a bank twice. The same values to the same addresses.
template <int C>
__device__ __forceinline__ void store_rows_staged(
    __nv_bfloat16* out, const float (&acc)[64], int t, const float* mean,
    const float* mul, const float* beta, int epi, uint32_t scratch) {
  const int lane = threadIdx.x & 31;
  const int wr = lane & 7, wj = lane >> 3;
  const uint32_t waddr = scratch + wr * 64 + (((wj ^ (wr >> 1)) & 3) << 4);
  const int rr = lane >> 2;
  const uint32_t raddr = scratch + rr * 64 + (((t ^ (rr >> 1)) & 3) << 4);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t p[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nt = 4 * q + j, col = nt * 8 + 2 * t;
      float2 m = {0.f, 0.f}, k = {0.f, 0.f}, b = {0.f, 0.f};
      if (epi != kNone) {               // col is even: 8-byte aligned
        m = *reinterpret_cast<const float2*>(mean + col);
        k = *reinterpret_cast<const float2*>(mul + col);
        b = *reinterpret_cast<const float2*>(beta + col);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half)
        p[half][j] = finish2(acc[nt * 4 + half * 2],
                             acc[nt * 4 + half * 2 + 1], m, k, b, epi);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      __syncwarp();                     // the lanes have read the last group
      stmatrix_x4(waddr, p[half][0], p[half][1], p[half][2], p[half][3]);
      __syncwarp();
      uint4 v;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(raddr) : "memory");
      *reinterpret_cast<uint4*>(out + half * 8 * C + (4 * q + t) * 8) = v;
    }
    compiler_barrier();
  }
}

constexpr int kPC = 256;                          // the width it takes
constexpr int kPTiles = 2;                        // tiles of 128 channels
constexpr int kPChunks = Shape<kPC>::kChunks;     // a tile's, 36
constexpr int kPChunkBytes = Shape<kPC>::kChunkBytes;   // 16 KB
constexpr int kPRowBytes = kPC * 2;               // a board row, unpadded
constexpr int kPBoardBytes = 64 * kPRowBytes;     // 32 KB
constexpr int kRowsBar = 5;             // named barrier: the first pair's
                                        // rows are in

constexpr int kPScratch = 512;           // a consumer warp's, bytes

// Stages of the persistent path's ring: as many as fit beside four boards'
// rows, the zero row, the BatchNorm constants, the consumer warps' scratch
// and the mbarriers (models/conv.py:persistent_stages counts the same).
constexpr int persistent_stages() {
  return (kSmemOptIn - 1024 - kMaxBoards * kPBoardBytes - kPRowBytes
          - 3 * kPC * 4 - kMaxBoards * 4 * kPScratch - 8)
         / (kPChunkBytes + 16);
}
constexpr int kPStages = persistent_stages();

struct PSmem {
  unsigned char w[kPStages][kPChunkBytes];        // 1024-byte aligned
  unsigned char rows[kMaxBoards][kPBoardBytes];   // a board each, swizzled
  unsigned char zero[kPRowBytes];                 // the off-board source row
  float mean[kPC], mul[kPC], beta[kPC];           // the BatchNorm, if any
  unsigned char scratch[kMaxBoards * 4][kPScratch];  // a consumer warp's
  uint64_t consts;                      // mbarrier: the constants are in
  uint64_t full[kPStages];              // mbarriers: chunk has landed
  uint64_t empty[kPStages];             // mbarriers: chunk has been read
};
constexpr int kPSmemBytes = (int)sizeof(PSmem) + 1024;
static_assert(kPSmemBytes <= kSmemOptIn, "layout too large");

// C 256 from some 400 boards up (models/conv.py:conv_launch_shape). A block
// takes a group of four boards, a consumer warpgroup each, and both tiles
// of their outputs, tile after tile; the blocks walk the groups in rounds
// (group r * grid + block in round r).
__global__ void __launch_bounds__(kThreads, 1)
    persistent_conv3x3_kernel(const Args a) {
  constexpr int S = kPStages;
  constexpr int kConsumers = kMaxBoards * 128;
  constexpr int kSegs = kPRowBytes / 16;          // 16-byte pieces a row
  constexpr int kPerTap = kPC / kChunkK;          // chunks a tap
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of the address: the ring must start on a
  // 1024-byte boundary (the launch asks for 1024 bytes of slack)
  PSmem& s = *reinterpret_cast<PSmem*>(
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) STAMP(0);
  launch_dependents();
  // a block's rounds, worked out in each role once its registers are set
  // (a value held across setmaxnreg spills)
  auto rounds = [&a]() {
    const int groups = (a.boards + kMaxBoards - 1) / kMaxBoards;
    return (groups - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  };

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(smem_addr(&s.full[i]), 1);                // the producer
      mbar_init(smem_addr(&s.empty[i]), kConsumers / 32);  // every warp
    }
    mbar_init(smem_addr(&s.consts), 32);                  // a warp's lanes
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < kSegs; i += blockDim.x)
    reinterpret_cast<uint4*>(s.zero)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();                      // the only block-wide barrier
  if (tid == 0) STAMP(1);

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    const int pwarp = (tid - kConsumers) >> 5;
    if (pwarp == 0 && lane == 0) {
      // every chunk of both tiles, round after round, as far ahead as the
      // consumers have freed stages; the weights are constants, so the
      // first stages fill before the wait
      const int n = rounds();
      int q = 0;
      for (int r = 0; r < n; ++r)
        for (int c = 0; c < kPTiles * kPChunks; ++c, ++q) {
          const int stage = q % S;
          if (q >= S)
            mbar_wait(smem_addr(&s.empty[stage]), ((q / S) - 1) & 1);
          const uint32_t full = smem_addr(&s.full[stage]);
          mbar_arrive_expect_tx(full, kPChunkBytes);
          bulk_copy(smem_addr(s.w[stage]),
                    a.image + (size_t)c * kPChunkBytes, kPChunkBytes, full);
          if (r == 0 && c < kPChunks) STAMP(48 + c);
        }
    } else if (pwarp == 1) {
      // the BatchNorm constants, while the first products run
      wait_for_predecessor();
      if (a.epi != kNone)
        for (int c = lane; c < kPC; c += 32) {
          s.mean[c] = a.mean[c];
          s.mul[c] = a.mul[c];
          s.beta[c] = a.beta[c];
        }
      mbar_arrive(smem_addr(&s.consts));
    }
    return;
  }

  // Consumers: warpgroup wg takes board group * 4 + wg of each round. The
  // second pair of warpgroups loads its rows once the first pair's are in,
  // so that the first pair starts its products sooner and the two pairs
  // reach their epilogues apart.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs));
  const int wg = tid >> 7;
  const int ch = tid & 127;
  const int warp = ch >> 5;
  const int bar_id = wg + 1;            // named barrier of this warpgroup
  const bool follows = wg >= kMaxBoards / 2;
  const uint32_t src = smem_addr(s.rows[wg]);
  // ldmatrix lane roles for A: lane -> row (lane % 16) of the warp's 16
  // rows and the 8-channel half (lane / 16) of a k-step
  const int a_m = warp * 16 + (lane & 15);
  const int half = lane >> 4;

  wait_for_predecessor();               // x is the kernel ahead's output
  if (tid == 0) STAMP(6);
  float acc[64];
  uint32_t frag[2][2][4];               // two sets of two k-steps
  int q = 0;                            // running weight chunk
  const int n = rounds();
  for (int r = 0; r < n; ++r) {
    const int group = r * gridDim.x + blockIdx.x;
    const int board = group * kMaxBoards + wg;
    const bool has = board < a.boards;
    if (r == 0 && follows) named_sync(kRowsBar, kConsumers);
    if (has) {
      // the board's rows into the warpgroup's buffer by asynchronous
      // copies, all in flight at once (its products of the last round have
      // completed), the 16-byte piece j of row m at piece j ^ (m % 8), so
      // that the eight rows of an ldmatrix fall in distinct banks
      warpgroup_barrier(bar_id);
      const uint4* xb = reinterpret_cast<const uint4*>(
          a.x + (size_t)board * 64 * kPC);
      constexpr int kPer = 64 * kSegs / 128;        // pieces a thread
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int p = i * 128 + ch;
        const int m = p / kSegs, j = p % kSegs;
        cp_async16(src + m * kPRowBytes + ((j ^ (m & 7)) << 4), xb + p);
      }
      cp_async_wait_all();
      warpgroup_barrier(bar_id);
    }
    if (r == 0 && !follows) named_arrive(kRowsBar, kConsumers);
    if (tid == 0 && r == 0) STAMP(2);
    const bool stamped_b = tid == 2 * 128 && r == 0;   // the second pair's
    if (stamped_b) STAMP(143);

    for (int tile = 0; tile < kPTiles; ++tile) {
      const bool stamped = tid == 0 && r == 0 && tile == 0;
      const bool stamped_last = tid == 0 && r == 0 && tile == 1;
      if (stamped_last) STAMP(140);
      if (!has) {
        // no board for this warpgroup: free each chunk as it lands
        for (int c = 0; c < kPChunks; ++c, ++q) {
          const int stage = q % S;
          mbar_wait(smem_addr(&s.full[stage]), (q / S) & 1);
          if (lane == 0) mbar_arrive(smem_addr(&s.empty[stage]));
        }
        continue;
      }
      // The taps unrolled, so that a tap's shift is a constant and this
      // lane's row for it, (h+dy, w+dx) or the zero row off the board, and
      // the row's swizzle are worked out once a tap, not a chunk (a chunk's
      // products took 7% longer with them worked out from its index).
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        // (at the tap, not hoisted above the taps before it: nine rows
        // held at once spill)
        int am = a_m;
        asm volatile("" : "+r"(am));
        const int hs = (am >> 3) + tap / 3 - 1, ws = (am & 7) + tap % 3 - 1;
        const bool on = hs >= 0 && hs < 8 && ws >= 0 && ws < 8;
        const int m = hs * 8 + ws;
        const uint32_t row = on ? src + m * kPRowBytes : smem_addr(s.zero);
        const int sw = on ? (m & 7) : 0;
#pragma unroll
        for (int cs = 0; cs < kPerTap; ++cs, ++q) {
          // the chunk's 64 channels: k-step j reads this lane's 16-byte
          // piece 2j + half of them
          const int c = tap * 4 + cs;
          const uint32_t base = row + cs * (kChunkK * 2);
          const int stage = q % S;
          CHUNK_WAIT(smem_addr(&s.full[stage]), (q / S) & 1);
          if (stamped) STAMP(8 + c);
          if (stamped_last) STAMP(96 + c);
          if (stamped_b && c == 0) STAMP(144 + 3 * tile);
          const uint64_t desc = swizzled_kmajor_desc(smem_addr(s.w[stage]));

          // k-steps 0 and 1; the group before the last has completed, so its
          // fragments (set 0) are free
          ldmatrix_x4(frag[0][0], base + (((0 + half) ^ sw) << 4));
          ldmatrix_x4(frag[0][1], base + (((2 + half) ^ sw) << 4));
          wgmma_fence();
          wgmma_bf16<128>(acc, frag[0][0], desc, c != 0);
          wgmma_bf16<128>(acc, frag[0][1], desc + 2, 1);
          wgmma_commit();
          wgmma_wait<1>();                // the previous chunk has been read
          if (c > 0 && lane == 0)
            mbar_arrive(smem_addr(&s.empty[(q - 1) % S]));

          // k-steps 2 and 3
          ldmatrix_x4(frag[1][0], base + (((4 + half) ^ sw) << 4));
          ldmatrix_x4(frag[1][1], base + (((6 + half) ^ sw) << 4));
          wgmma_fence();
          wgmma_bf16<128>(acc, frag[1][0], desc + 4, 1);
          wgmma_bf16<128>(acc, frag[1][1], desc + 6, 1);
          wgmma_commit();
          wgmma_wait<1>();
        }
      }
      wgmma_wait<0>();
      if (stamped) STAMP(3);
      if (stamped_last) STAMP(141);
      if (stamped_b) STAMP(145 + 3 * tile);
      if (lane == 0) mbar_arrive(smem_addr(&s.empty[(q - 1) % S]));
      fence_accumulators(acc);

      // accumulator element nt*4 + half*2 + e of a wgmma: row warp*16 +
      // lane/4 + half*8, column nt*8 + (lane%4)*2 + e
      mbar_wait(smem_addr(&s.consts), 0);
      const int col0 = tile * 128;
      store_rows_staged<kPC>(
          a.out + ((size_t)board * 64 + warp * 16 + (lane >> 2)) * kPC
              + col0,
          acc, lane & 3, s.mean + col0, s.mul + col0, s.beta + col0, a.epi,
          smem_addr(s.scratch[wg * 4 + warp]));
      if (stamped) STAMP(5);
      if (stamped_last) STAMP(142);
      if (stamped_b) STAMP(146 + 3 * tile);
    }
  }
}

template <int C, int NP, int PER>
cudaError_t opt_in() {
  static_assert(smem_bytes<C, NP, PER>() <= kSmemOptIn, "layout too large");
  return cudaFuncSetAttribute(conv3x3_kernel<C, NP, PER>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<C, NP, PER>());
}

template <int C, int NP, int PER>
int launch(const Args& a, int grid, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3((PER + 1) * 128);
  cfg.dynamicSmemBytes = smem_bytes<C, NP, PER>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, conv3x3_kernel<C, NP, PER>, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Every instantiation, in one list: (C, NP, PER), in the launch rule's
// order (models/conv.py:SHAPES).
#define CONV_SHAPES(X)                                                 \
  X(32, 32, 1) X(32, 32, 2) X(32, 32, 3) X(32, 32, 4)                  \
  X(128, 16, 1) X(128, 16, 2) X(128, 64, 1) X(128, 128, 1)             \
  X(128, 128, 2) X(128, 128, 3) X(128, 128, 4)                         \
  X(256, 16, 1) X(256, 16, 2) X(256, 64, 1) X(256, 128, 1)             \
  X(256, 128, 2) X(256, 128, 3) X(256, 128, 4)

}  // namespace

extern "C" {

// Once a device, before its first launch and outside any stream capture:
// lets every instantiation take its shared memory past 48 KB, and gives
// the device's multiprocessor count, which sizes the grid.
int conv3x3_init(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
#define X(C, NP, PER) \
  if (err == cudaSuccess) err = opt_in<C, NP, PER>();
  CONV_SHAPES(X)
#undef X
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(persistent_conv3x3_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kPSmemBytes);
  return (int)err;
}

// The persistent path's shared memory a block (models/conv.py checks its
// own count against it).
int conv3x3_persistent_smem_bytes() { return kPSmemBytes; }

// A block's dynamic shared memory for pieces of np channels and per boards
// at width C (0 for a shape the kernel does not have): models/conv.py
// checks its own count against it.
int conv3x3_smem_bytes(int C, int np, int per) {
#define X(CC, NP, PER) \
  if (C == CC && np == NP && per == PER) return smem_bytes<CC, NP, PER>();
  CONV_SHAPES(X)
#undef X
  return 0;
}

// x, out: bf16 NHWC maps (boards, 8, 8, C), 16-byte aligned; image: the
// weight image (models/conv.py:weight_image), (C / N, ceil(9C / 64), N, 64)
// bf16 with N = min(C, 128), 16-byte aligned and complete before the
// launch (the kernel reads it before it waits for the kernel ahead of it);
// mean, mul, beta: f32 [C], or null with epi 0 (none; 1 affine, 2 affine
// and ReLU). C is 32, 128 or 256; grid blocks, np (channels a piece) and
// per (boards a piece) as models/conv.py:conv_launch_shape gives them;
// conv3x3_init has run on the device.
int conv3x3_bf16(const void* x, const void* image, const void* mean,
                 const void* mul, const void* beta, void* out, int boards,
                 int C, int epi, int grid, int np, int per, void* stream
#ifdef CONV_TIMELINE
                 , void* trace
#endif
                 ) {
  if (boards < 0 || grid <= 0 || epi < kNone || epi > kAffineRelu ||
      (epi != kNone && (!mean || !mul || !beta)) ||
      conv3x3_smem_bytes(C, np, per) == 0)
    return (int)cudaErrorInvalidValue;
  if (boards == 0) return (int)cudaGetLastError();
  const Args a{static_cast<const __nv_bfloat16*>(x),
               static_cast<const unsigned char*>(image),
               static_cast<const float*>(mean), static_cast<const float*>(mul),
               static_cast<const float*>(beta),
               static_cast<__nv_bfloat16*>(out), boards, epi
#ifdef CONV_TIMELINE
               , static_cast<unsigned long long*>(trace)
#endif
  };
  const cudaStream_t st = (cudaStream_t)stream;
#define X(CC, NP, PER) \
  if (C == CC && np == NP && per == PER) return launch<CC, NP, PER>(a, grid, st);
  CONV_SHAPES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// The persistent path (C 256): x, image, mean, mul, beta, out and epi as
// conv3x3_bf16's; grid blocks, at most one an SM, as models/conv.py:
// persistent_launch gives them.
int conv3x3_persistent_bf16(const void* x, const void* image,
                            const void* mean, const void* mul,
                            const void* beta, void* out, int boards, int epi,
                            int grid, void* stream
#ifdef CONV_TIMELINE
                            , void* trace
#endif
                            ) {
  if (boards < 0 || grid <= 0 || epi < kNone || epi > kAffineRelu ||
      (epi != kNone && (!mean || !mul || !beta)))
    return (int)cudaErrorInvalidValue;
  if (boards == 0) return (int)cudaGetLastError();
  const Args a{static_cast<const __nv_bfloat16*>(x),
               static_cast<const unsigned char*>(image),
               static_cast<const float*>(mean), static_cast<const float*>(mul),
               static_cast<const float*>(beta),
               static_cast<__nv_bfloat16*>(out), boards, epi
#ifdef CONV_TIMELINE
               , static_cast<unsigned long long*>(trace)
#endif
  };
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kPSmemBytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, persistent_conv3x3_kernel,
                                             a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
