// Fused SE-ResNet tower for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces alphazero_tpu/models/fused.py:_tower_kernel (pallas_call at
// fused.py:258, inside tower_forward): the whole BN-folded tower in one
// launch. Per block, on (B*64, 128) bf16 rows (game-major, h*8+w):
//   y1 = bf16(relu(conv3x3(x,  w[0]) + b[0]))
//   y  =           conv3x3(y1, w[1]) + b[1]              (f32)
//   pooled = bf16(mean over the game's 64 rows of y)
//   h  = bf16(relu(pooled @ wse1 + bse1))                (fc1 padded to 128)
//   x  = bf16(relu(y * sigmoid(h @ wse2g + bse2g) + (h @ wse2b + bse2b) + x))
// with every sum in f32.
//
// Bound on an H100: operations. At 512 positions and 20 blocks the 40
// convs are 40 x (32768 x 1152 x 128) multiply-adds, 3.87e11 operations,
// 0.39 ms at the 989 TFLOP/s bf16 rate; the bytes (16.8 MB of activations
// in and out, 11.8 MB of weights) would take 0.009 ms.
//
// Design. One game is 64 rows, which is the M of Hopper's warpgroup matrix
// multiply: a consumer warpgroup (four warps) owns one game and computes a
// conv as 72 wgmma.mma_async m64n128k16 (nine taps x eight k-steps), the
// whole 64 x 128 f32 output in 64 registers a thread. A thread block is
// four consumer warpgroups, so four games (TB = 4), and one producer
// warpgroup; 512 positions are 128 thread blocks, one on each SM, in one
// wave. The block keeps its activations in shared memory from the first
// tower block to the last (x and y1, 2 x 68 KB with padded rows); only the
// weights are read from device memory. The 640 threads start with 96
// registers each; setmaxnreg moves the producer's to the consumers (24 and
// 112), which hold 64 accumulators and 16 fragment registers a thread.
//   B, the weights, is read by the tensor cores straight from shared memory
// through a matrix descriptor. The host packs the weights once into the
// image the descriptor reads (fused.py:wconv_smem_image): chunks of 64 input
// channels of one tap, 16 KB, stored [cout][cin] (K-major) in rows of 128
// bytes with the 128-byte swizzle (the 16-byte piece j of row n lies at
// piece j ^ (n % 8)). A chunk is one contiguous block that one thread of
// the producer warpgroup brings in with a bulk copy (cp.async.bulk) that
// completes on an mbarrier: no tensor map and no per-thread addresses. The
// ring has four stages with a full and an empty mbarrier each. The
// producer runs ahead across conv and block borders; consumers wait on
// full, start their wgmma, and each warp arrives on empty once the wgmma
// group that read the stage has completed. There is no block-wide barrier
// after the set-up: a game's rows are read and written by its own
// warpgroup alone, so the conv outputs and the SE are ordered by named
// barriers over the 128 threads of one warpgroup, and the four warpgroups
// drift against each other by up to the depth of the ring. All four read
// every chunk, which halves the L2 weight traffic of two games a block
// (11.8 MB x 128 blocks a launch).
//   A, the activations, comes from registers. The TPU kernel stages nine
// shifted, masked copies of the activations because its compiler has no
// bf16 row rotate. Here the shift costs nothing: ldmatrix takes one row
// address per lane, so for tap (dy, dx) each lane points at source row
// (h+dy, w+dx) of its game, or at a row of zeros when that square is off
// the board, and the m16k16 fragments it loads are what wgmma takes as A.
// Rows are padded to 272 bytes so that the eight row addresses of an
// ldmatrix fall in distinct banks. One ldmatrix.x4 a warp feeds a k-step of
// all 128 output columns. The k-steps go in groups of two with two sets of
// fragments, so that one group's fragments load while the group before it
// runs and at most two groups are in flight.
//   The SE multiply and add and the residual add use __fmul_rn/__fadd_rn so
// that they round as the plain version's separate operations do.
//
// Measured on an H100 80GB HBM3 at 700 W: 0.65-0.69 ms at 512 positions x
// 20 blocks, 564-592 TFLOP/s, 1.7-1.8 times the bound (PERF.md has the
// runs). What is left, by arithmetic and by how the time
// scales, not measured: a tower block takes 0.032 ms, of which the two convs are 0.020 ms at the full
// tensor-core rate; the four warpgroups reach the SE together, so the
// tensor cores idle through it (fc1 is 128 L2 loads a thread), and each
// wgmma re-reads its 4 KB of weights from shared memory for one game.
//
// The entry point launches on the given stream and returns
// cudaGetLastError(); it never synchronises and allocates nothing.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 128;                 // channels
constexpr int kGames = 4;               // games per thread block (TB)
constexpr int kConsumers = kGames * 128;
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kConsumerRegs = 112;      // 640 threads start with 96 each
constexpr int kProducerRegs = 24;
constexpr int kStride = kC + 8;         // padded row, in bf16 (272 bytes)
constexpr int kRowBytes = kStride * 2;
constexpr int kChunkK = 64;             // input channels per weight chunk
constexpr int kChunkBytes = kChunkK * kC * 2;             // 16 KB
constexpr int kChunksPerConv = 9 * kC / kChunkK;          // 18
constexpr int kStages = 4;              // weight ring

struct Smem {
  unsigned char w[kStages][kChunkBytes];  // weight ring, 1024-byte aligned
  __nv_bfloat16 x[kGames * 64 * kStride];   // block input, skip, output
  __nv_bfloat16 y1[kGames * 64 * kStride];  // first conv's output
  __nv_bfloat16 zero[kStride];          // the off-board source row
  float colsum[kGames][4][kC];          // per warp partial column sums
  float pooled[kGames][kC];             // bf16-rounded means
  float hidden[kGames][kC];             // bf16-rounded fc1 output
  float gate[kGames][kC];
  float shift[kGames][kC];
  uint64_t full[kStages];               // mbarriers: chunk has landed
  uint64_t empty[kStages];              // mbarriers: chunk has been read
};

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

// d (64 x 128 f32, this warpgroup's game) = a (this warp's m16k16 bf16
// fragment) x b (16 x 128 bf16 in shared memory) + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
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

__global__ void __launch_bounds__(kThreads, 1)
tower_kernel(const __nv_bfloat16* __restrict__ xin,
             __nv_bfloat16* __restrict__ xout,
             const unsigned char* __restrict__ wconv_smem,
             const float* __restrict__ bconv,
             const __nv_bfloat16* __restrict__ wse1,
             const float* __restrict__ bse1,
             const __nv_bfloat16* __restrict__ wse2g,
             const __nv_bfloat16* __restrict__ wse2b,
             const float* __restrict__ bse2g,
             const float* __restrict__ bse2b,
             int num_blocks) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of the address: the ring must start on a
  // 1024-byte boundary (the launch asks for 1024 bytes of slack)
  Smem& s = *reinterpret_cast<Smem*>(
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int total_chunks = num_blocks * 2 * kChunksPerConv;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(smem_addr(&s.full[i]), 1);                // the producer
      mbar_init(smem_addr(&s.empty[i]), kConsumers / 32);  // every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < kStride; i += kThreads)
    s.zero[i] = __float2bfloat16(0.0f);
  __syncthreads();                      // the only block-wide barrier

  // The two roles never meet again: the producer warpgroup hands most of
  // its registers to the consumers, whose accumulators need them.
  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    // Producer: one thread streams every chunk of the launch through the
    // ring, as far ahead as the consumers have freed stages.
    if (tid == kConsumers) {
      for (int q = 0; q < total_chunks; ++q) {
        const int stage = q % kStages;
        if (q >= kStages)
          mbar_wait(smem_addr(&s.empty[stage]), ((q / kStages) - 1) & 1);
        const uint32_t full = smem_addr(&s.full[stage]);
        mbar_arrive_expect_tx(full, kChunkBytes);
        bulk_copy(smem_addr(s.w[stage]),
                  wconv_smem + (size_t)q * kChunkBytes, kChunkBytes, full);
      }
    }
    return;
  }

  // Consumers: warpgroup `game` owns rows game*64 .. +64 of the block.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs));
  const int game = tid >> 7;
  const int ch = tid & 127;             // SE: one channel per thread
  const int warp = ch >> 5;             // warp of the warpgroup: 16 rows
  const int bar_id = game + 1;          // named barrier of this warpgroup
  __nv_bfloat16* xg = s.x + game * 64 * kStride;
  __nv_bfloat16* y1g = s.y1 + game * 64 * kStride;

  // this game's 64 rows: 1024 16-byte pieces, eight per thread
  const size_t row0 = ((size_t)blockIdx.x * kGames + game) * 64;
  for (int piece = ch; piece < 64 * (kC / 8); piece += 128) {
    const int row = piece >> 4, seg = piece & 15;
    *reinterpret_cast<uint4*>(&xg[row * kStride + seg * 8]) =
        *reinterpret_cast<const uint4*>(xin + (row0 + row) * kC + seg * 8);
  }
  warpgroup_barrier(bar_id);

  // ldmatrix lane roles for A: lane -> row (lane % 16) of the warp's 16
  // rows and the 8-column half (lane / 16) of a k-step.
  const int a_m = warp * 16 + (lane & 15);
  const int a_h = a_m >> 3, a_w = a_m & 7;
  const uint32_t a_half = (lane >> 4) * 16;                 // bytes
  const uint32_t zero_addr = smem_addr(s.zero) + a_half;
  // accumulator element nt*4 + half*2 + e: row warp*16 + lane/4 + half*8,
  // column nt*8 + (lane%4)*2 + e
  const int c_row = warp * 16 + (lane >> 2);
  const int c_col = (lane & 3) * 2;

  float acc[64];
  uint32_t a[2][2][4];                  // two sets of two k-steps
  int q = 0;                            // running weight chunk
  for (int blk = 0; blk < num_blocks; ++blk) {
    for (int conv = 0; conv < 2; ++conv) {
      const uint32_t src = smem_addr(conv == 0 ? xg : y1g);
      uint32_t a_addr = 0;
      for (int c = 0; c < kChunksPerConv; ++c, ++q) {
        if ((c & 1) == 0) {             // a new tap: gather the row address
          const int tap = c >> 1;
          const int hs = a_h + tap / 3 - 1, ws = a_w + tap % 3 - 1;
          const bool on_board = hs >= 0 && hs < 8 && ws >= 0 && ws < 8;
          a_addr = on_board ? src + (hs * 8 + ws) * kRowBytes + a_half
                            : zero_addr;
        }
        const uint32_t a_k = a_addr + (c & 1) * kChunkK * 2;
        const int stage = q % kStages;
        mbar_wait(smem_addr(&s.full[stage]), (q / kStages) & 1);
        const uint64_t desc = swizzled_kmajor_desc(smem_addr(s.w[stage]));

        // k-steps 0 and 1; the group before the last has completed, so
        // its fragments (set 0) are free
        ldmatrix_x4(a[0][0], a_k);
        ldmatrix_x4(a[0][1], a_k + 32);
        wgmma_fence();
        wgmma_m64n128k16(acc, a[0][0], desc, c != 0);
        wgmma_m64n128k16(acc, a[0][1], desc + 2, 1);
        wgmma_commit();
        wgmma_wait<1>();                // the previous chunk has been read
        if (c > 0 && lane == 0)
          mbar_arrive(smem_addr(&s.empty[(q - 1) % kStages]));

        // k-steps 2 and 3
        ldmatrix_x4(a[1][0], a_k + 64);
        ldmatrix_x4(a[1][1], a_k + 96);
        wgmma_fence();
        wgmma_m64n128k16(acc, a[1][0], desc + 4, 1);
        wgmma_m64n128k16(acc, a[1][1], desc + 6, 1);
        wgmma_commit();
        wgmma_wait<1>();
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(smem_addr(&s.empty[(q - 1) % kStages]));
      fence_accumulators(acc);

      const float* bias = bconv + (blk * 2 + conv) * kC;
      if (conv == 0) {
        // y1 = bf16(relu(acc + bias)); the second conv reads all 64 rows
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          const int col = c_col + nt * 8;
          const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = c_row + half * 8;
            const float v0 = fmaxf(__fadd_rn(acc[nt * 4 + half * 2], b0),
                                   0.0f);
            const float v1 = fmaxf(__fadd_rn(acc[nt * 4 + half * 2 + 1], b1),
                                   0.0f);
            *reinterpret_cast<__nv_bfloat162*>(&y1g[row * kStride + col]) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
        warpgroup_barrier(bar_id);
        continue;
      }

      // second conv: y = acc + bias stays in registers; column sums of
      // this warp's 16 rows go to colsum[game][warp]
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int col = c_col + nt * 8;
        const float b0 = bias[col], b1 = bias[col + 1];
        acc[nt * 4] = __fadd_rn(acc[nt * 4], b0);
        acc[nt * 4 + 1] = __fadd_rn(acc[nt * 4 + 1], b1);
        acc[nt * 4 + 2] = __fadd_rn(acc[nt * 4 + 2], b0);
        acc[nt * 4 + 3] = __fadd_rn(acc[nt * 4 + 3], b1);
        float s0 = acc[nt * 4] + acc[nt * 4 + 2];
        float s1 = acc[nt * 4 + 1] + acc[nt * 4 + 3];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        }
        if (lane < 4) {
          s.colsum[game][warp][col] = s0;
          s.colsum[game][warp][col + 1] = s1;
        }
      }
      warpgroup_barrier(bar_id);

      // SE of this game: one channel per thread
      s.pooled[game][ch] = __bfloat162float(__float2bfloat16(
          ((s.colsum[game][0][ch] + s.colsum[game][1][ch])
           + (s.colsum[game][2][ch] + s.colsum[game][3][ch]))
          * (1.0f / 64.0f)));
      warpgroup_barrier(bar_id);
      {
        const __nv_bfloat16* w1 = wse1 + (size_t)blk * kC * 128 + ch;
        float sum = 0.0f;
#pragma unroll 16
        for (int k = 0; k < kC; ++k)
          sum = fmaf(s.pooled[game][k], __bfloat162float(w1[k * 128]), sum);
        sum = fmaxf(__fadd_rn(sum, bse1[blk * 128 + ch]), 0.0f);
        s.hidden[game][ch] = __bfloat162float(__float2bfloat16(sum));
      }
      warpgroup_barrier(bar_id);
      {
        const __nv_bfloat16* wg = wse2g + (size_t)blk * 128 * kC + ch;
        const __nv_bfloat16* wb = wse2b + (size_t)blk * 128 * kC + ch;
        float sg = 0.0f, sb = 0.0f;
        for (int k = 0; k < 128; ++k) {
          // the padded part of the hidden vector is zero: a zero term
          // adds nothing, so its weights are not read
          const float h = s.hidden[game][k];
          if (h == 0.0f) continue;
          sg = fmaf(h, __bfloat162float(wg[k * kC]), sg);
          sb = fmaf(h, __bfloat162float(wb[k * kC]), sb);
        }
        sg = __fadd_rn(sg, bse2g[blk * kC + ch]);
        s.gate[game][ch] = 1.0f / (1.0f + expf(-sg));
        s.shift[game][ch] = __fadd_rn(sb, bse2b[blk * kC + ch]);
      }
      warpgroup_barrier(bar_id);

      // x = bf16(relu(y * gate + shift + x)), in place
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int col = c_col + nt * 8;
        const float g0 = s.gate[game][col], g1 = s.gate[game][col + 1];
        const float h0 = s.shift[game][col], h1 = s.shift[game][col + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = c_row + half * 8;
          __nv_bfloat162* px = reinterpret_cast<__nv_bfloat162*>(
              &xg[row * kStride + col]);
          const float2 skip = __bfloat1622float2(*px);
          const float v0 = __fadd_rn(__fadd_rn(
              __fmul_rn(acc[nt * 4 + half * 2], g0), h0), skip.x);
          const float v1 = __fadd_rn(__fadd_rn(
              __fmul_rn(acc[nt * 4 + half * 2 + 1], g1), h1), skip.y);
          *px = __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
        }
      }
      warpgroup_barrier(bar_id);        // the next conv reads all 64 rows
    }
  }

  for (int piece = ch; piece < 64 * (kC / 8); piece += 128) {
    const int row = piece >> 4, seg = piece & 15;
    *reinterpret_cast<uint4*>(xout + (row0 + row) * kC + seg * 8) =
        *reinterpret_cast<const uint4*>(&xg[row * kStride + seg * 8]);
  }
}

}  // namespace

extern "C" {

// x, out: (games*64, 128) bf16, 16-byte aligned; games a multiple of 4.
// wconv_smem (n,2,9,2,128,64) bf16, the conv weights in the shared-memory
// image described above, 16-byte aligned; bconv (n,2,128) f32; wse1
// (n,128,128), wse2g, wse2b (n,128,128) bf16; bse1, bse2g, bse2b (n,128)
// f32; num_blocks <= n.
int tower_forward_bf16(const void* x, void* out, const void* wconv_smem,
                       const void* bconv, const void* wse1, const void* bse1,
                       const void* wse2g, const void* wse2b,
                       const void* bse2g, const void* bse2b,
                       int games, int num_blocks, void* stream) {
  if (games % kGames != 0 || games < 0 || num_blocks < 0)
    return (int)cudaErrorInvalidValue;
  if (games == 0) return (int)cudaGetLastError();
  const int smem = (int)sizeof(Smem) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      tower_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tower_kernel<<<games / kGames, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)out,
      (const unsigned char*)wconv_smem, (const float*)bconv,
      (const __nv_bfloat16*)wse1, (const float*)bse1,
      (const __nv_bfloat16*)wse2g, (const __nv_bfloat16*)wse2b,
      (const float*)bse2g, (const float*)bse2b, num_blocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
