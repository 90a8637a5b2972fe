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
// Design. A thread block owns TB = 2 whole games (128 rows): every game is
// independent and the SE mean needs all 64 rows of a game. The block keeps
// its activations in shared memory from the first tower block to the last
// (x and y1, 2 x 34 KB with padded rows); only the weights are read from
// device memory. A conv is one 128 x 128 x 1152 product on the tensor
// cores (mma.sync m16n8k16, bf16 operands, f32 accumulators in registers):
// 8 warps as 4 (rows) x 2 (columns), each a 32 x 64 tile. The 295 KB of
// weights per tower block do not fit beside the activations, so they are
// streamed in chunks of 64 input channels of one tap (16 KB) through a
// two-stage cp.async ring that runs ahead across conv and block borders;
// every thread block reads the same weights, so they come from L2. With
// 108 KB of shared memory and 128 registers a thread, two thread blocks
// share an SM, and one's epilogue and barriers overlap the other's
// products.
//   The TPU kernel stages nine shifted, masked copies of the activations
// because its compiler has no bf16 row rotate. Here the shift costs
// nothing: ldmatrix takes one row address per lane, so for tap (dy, dx)
// each lane points at source row (h+dy, w+dx) of its game, or at a row of
// zeros when that square is off the board. Rows are padded to 272 bytes so
// that the eight row addresses of an ldmatrix fall in distinct banks.
//   The SE multiply and add and the residual add use __fmul_rn/__fadd_rn so
// that they round as the plain version's separate operations do.
//
// Measured on an H100 80GB HBM3 at 700 W: 1.24 ms at 512 positions x 20
// blocks, 3.2 times the bound (PERF.md). By arithmetic, not measured: an
// SM's two thread blocks load 141 MB through ldmatrix per launch (six
// ldmatrix.x4 for sixteen mma in each k-step of a warp), 1.1 M clocks at
// 128 bytes a clock, and issue 1.5e9 multiply-adds, 0.74 M clocks at the
// full tensor-core rate, of the 2.3 M clocks or so that a launch takes;
// with two barriers per chunk the two do not overlap fully. Making it
// faster (wgmma, which reads its operands from shared memory without
// passing registers, TMA multicast of the weights across a cluster, a
// deeper ring with one barrier per chunk) is later work.
// The entry point launches on the given stream and returns
// cudaGetLastError(); it never synchronises and allocates nothing.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 128;                 // channels
constexpr int kGames = 2;               // games per thread block (TB)
constexpr int kRows = kGames * 64;      // activation rows per thread block
constexpr int kThreads = 256;
constexpr int kStride = kC + 8;         // padded row, in bf16 (272 bytes)
constexpr int kRowBytes = kStride * 2;
constexpr int kChunkK = 64;             // weight rows (cin) per chunk
constexpr int kChunksPerConv = 9 * kC / kChunkK;          // 18

struct Smem {
  __nv_bfloat16 x[kRows * kStride];     // block input, skip, block output
  __nv_bfloat16 y1[kRows * kStride];    // first conv's output
  __nv_bfloat16 w[2][kChunkK * kStride];  // weight ring
  __nv_bfloat16 zero[kStride];          // the off-board source row
  float colsum[4][kC];                  // per warp-row partial column sums
  float pooled[kGames][kC];             // bf16-rounded means
  float hidden[kGames][kC];             // bf16-rounded fc1 output
  float gate[kGames][kC];
  float shift[kGames][kC];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Weight chunk q (64 rows of the (n*2*1152, 128) weight matrix) into ring
// slot q & 1: 1024 16-byte pieces, four per thread.
__device__ __forceinline__ void load_chunk(Smem& s,
                                           const __nv_bfloat16* wconv,
                                           int q, int tid) {
  const __nv_bfloat16* src = wconv + (size_t)q * kChunkK * kC;
  const uint32_t dst = smem_addr(s.w[q & 1]);
#pragma unroll
  for (int i = 0; i < kChunkK * (kC / 8) / kThreads; ++i) {
    const int piece = tid + i * kThreads;
    const int row = piece >> 4, seg = piece & 15;
    cp_async16(dst + row * kRowBytes + seg * 16, src + row * kC + seg * 8);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
tower_kernel(const __nv_bfloat16* __restrict__ xin,
             __nv_bfloat16* __restrict__ xout,
             const __nv_bfloat16* __restrict__ wconv,
             const float* __restrict__ bconv,
             const __nv_bfloat16* __restrict__ wse1,
             const float* __restrict__ bse1,
             const __nv_bfloat16* __restrict__ wse2g,
             const __nv_bfloat16* __restrict__ wse2b,
             const float* __restrict__ bse2g,
             const float* __restrict__ bse2b,
             int num_blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 1;         // 0..3: rows warp_m*32 .. +32
  const int warp_n = warp & 1;          // 0..1: columns warp_n*64 .. +64
  const int total_chunks = num_blocks * 2 * kChunksPerConv;

  if (total_chunks > 0) load_chunk(s, wconv, 0, tid);
  cp_async_commit();

  // this block's 128 rows: 2048 16-byte pieces, eight per thread
  const size_t row0 = (size_t)blockIdx.x * kRows;
  for (int piece = tid; piece < kRows * (kC / 8); piece += kThreads) {
    const int row = piece >> 4, seg = piece & 15;
    *reinterpret_cast<uint4*>(&s.x[row * kStride + seg * 8]) =
        *reinterpret_cast<const uint4*>(xin + (row0 + row) * kC + seg * 8);
  }
  for (int i = tid; i < kStride; i += kThreads)
    s.zero[i] = __float2bfloat16(0.0f);
  __syncthreads();

  // ldmatrix lane roles. A: lane -> row (lane % 16) of a 16-row tile and
  // the 8-column half (lane / 16). B (transposed load of [k][n] weights):
  // lane -> k row (lane % 16) and the 8-column half (lane / 16) of a
  // 16-column pair of n-tiles.
  const int a_row = lane & 15;
  const uint32_t a_half = (lane >> 4) * 16;                 // bytes
  const uint32_t b_lane = (lane & 15) * kRowBytes
                          + (warp_n * 64 + (lane >> 4) * 8) * 2;
  const uint32_t zero_addr = smem_addr(s.zero) + a_half;
  // accumulator element (mt, nt, e): row warp_m*32 + mt*16 + lane/4
  // (+8 for e >= 2), column warp_n*64 + nt*8 + (lane%4)*2 + (e & 1)
  const int c_row = warp_m * 32 + (lane >> 2);
  const int c_col = warp_n * 64 + (lane & 3) * 2;
  const int game = warp_m >> 1;

  float acc[2][8][4];
  int q = 0;                            // running weight chunk
  for (int blk = 0; blk < num_blocks; ++blk) {
    for (int conv = 0; conv < 2; ++conv) {
      const uint32_t src = smem_addr(conv == 0 ? s.x : s.y1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

      uint32_t a_addr[2] = {0, 0};
      for (int c = 0; c < kChunksPerConv; ++c, ++q) {
        // ring: start chunk q+1 (its slot was last read in iteration q-1,
        // which ended in a barrier), then wait for chunk q
        if (q + 1 < total_chunks) load_chunk(s, wconv, q + 1, tid);
        cp_async_commit();
        cp_async_wait_all_but_one();
        __syncthreads();

        if ((c & 1) == 0) {             // a new tap: gather row addresses
          const int tap = c >> 1;
          const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int m = warp_m * 32 + mt * 16 + a_row;
            const int hs = ((m >> 3) & 7) + dy, ws = (m & 7) + dx;
            const bool on_board = hs >= 0 && hs < 8 && ws >= 0 && ws < 8;
            a_addr[mt] = on_board
                ? src + ((m & 64) + hs * 8 + ws) * kRowBytes + a_half
                : zero_addr;
          }
        }
        const uint32_t k0 = (c & 1) * kChunkK * 2;          // bytes
        const uint32_t wbase = smem_addr(s.w[q & 1]) + b_lane;
#pragma unroll
        for (int kk = 0; kk < kChunkK / 16; ++kk) {
          uint32_t a[2][4];
          ldmatrix_x4(a[0], a_addr[0] + k0 + kk * 32);
          ldmatrix_x4(a[1], a_addr[1] + k0 + kk * 32);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, wbase + kk * 16 * kRowBytes + np * 32);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(acc[mt][np * 2], a[mt], b[0], b[1]);
              mma_bf16(acc[mt][np * 2 + 1], a[mt], b[2], b[3]);
            }
          }
        }
        __syncthreads();
      }

      const float* bias = bconv + (blk * 2 + conv) * kC;
      if (conv == 0) {
        // y1 = bf16(relu(acc + bias)); its first readers come after the
        // next chunk's barrier
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int col = c_col + nt * 8;
            const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int row = c_row + mt * 16 + half * 8;
              const float v0 = fmaxf(__fadd_rn(acc[mt][nt][half * 2], b0),
                                     0.0f);
              const float v1 = fmaxf(__fadd_rn(acc[mt][nt][half * 2 + 1],
                                               b1), 0.0f);
              *reinterpret_cast<__nv_bfloat162*>(
                  &s.y1[row * kStride + col]) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
        continue;
      }

      // second conv: y = acc + bias stays in registers; column sums of
      // this warp's 32 rows go to colsum[warp_m]
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = c_col + nt * 8;
        const float b0 = bias[col], b1 = bias[col + 1];
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            acc[mt][nt][half * 2] = __fadd_rn(acc[mt][nt][half * 2], b0);
            acc[mt][nt][half * 2 + 1] =
                __fadd_rn(acc[mt][nt][half * 2 + 1], b1);
            s0 += acc[mt][nt][half * 2];
            s1 += acc[mt][nt][half * 2 + 1];
          }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        }
        if (lane < 4) {
          s.colsum[warp_m][col] = s0;
          s.colsum[warp_m][col + 1] = s1;
        }
      }
      __syncthreads();

      // SE on 2 games x 128 channels: one (game, channel) per thread
      const int g = tid >> 7, ch = tid & 127;
      s.pooled[g][ch] = __bfloat162float(__float2bfloat16(
          (s.colsum[2 * g][ch] + s.colsum[2 * g + 1][ch]) * (1.0f / 64.0f)));
      __syncthreads();
      {
        const __nv_bfloat16* w1 = wse1 + (size_t)blk * kC * 128 + ch;
        float sum = 0.0f;
#pragma unroll 8
        for (int k = 0; k < kC; ++k)
          sum = fmaf(s.pooled[g][k], __bfloat162float(w1[k * 128]), sum);
        sum = fmaxf(__fadd_rn(sum, bse1[blk * 128 + ch]), 0.0f);
        s.hidden[g][ch] = __bfloat162float(__float2bfloat16(sum));
      }
      __syncthreads();
      {
        const __nv_bfloat16* wg = wse2g + (size_t)blk * 128 * kC + ch;
        const __nv_bfloat16* wb = wse2b + (size_t)blk * 128 * kC + ch;
        float sg = 0.0f, sb = 0.0f;
        for (int k = 0; k < 128; ++k) {
          // the padded part of the hidden vector is zero for every game:
          // a zero term adds nothing, so its weights are not read
          if (s.hidden[0][k] == 0.0f && s.hidden[1][k] == 0.0f) continue;
          const float h = s.hidden[g][k];
          sg = fmaf(h, __bfloat162float(wg[k * kC]), sg);
          sb = fmaf(h, __bfloat162float(wb[k * kC]), sb);
        }
        sg = __fadd_rn(sg, bse2g[blk * kC + ch]);
        s.gate[g][ch] = 1.0f / (1.0f + expf(-sg));
        s.shift[g][ch] = __fadd_rn(sb, bse2b[blk * kC + ch]);
      }
      __syncthreads();

      // x = bf16(relu(y * gate + shift + x)), in place
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = c_col + nt * 8;
          const float g0 = s.gate[game][col], g1 = s.gate[game][col + 1];
          const float h0 = s.shift[game][col], h1 = s.shift[game][col + 1];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = c_row + mt * 16 + half * 8;
            __nv_bfloat162* px = reinterpret_cast<__nv_bfloat162*>(
                &s.x[row * kStride + col]);
            const float2 skip = __bfloat1622float2(*px);
            const float v0 = __fadd_rn(__fadd_rn(
                __fmul_rn(acc[mt][nt][half * 2], g0), h0), skip.x);
            const float v1 = __fadd_rn(__fadd_rn(
                __fmul_rn(acc[mt][nt][half * 2 + 1], g1), h1), skip.y);
            *px = __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
          }
        }
      // the next conv's first barrier orders these writes before its reads
    }
  }

  __syncthreads();
  for (int piece = tid; piece < kRows * (kC / 8); piece += kThreads) {
    const int row = piece >> 4, seg = piece & 15;
    *reinterpret_cast<uint4*>(xout + (row0 + row) * kC + seg * 8) =
        *reinterpret_cast<const uint4*>(&s.x[row * kStride + seg * 8]);
  }
}

}  // namespace

extern "C" {

// x, out: (games*64, 128) bf16, 16-byte aligned; games a multiple of 2.
// wconv (n,2,9,128,128) bf16; bconv (n,2,128) f32; wse1 (n,128,128),
// wse2g, wse2b (n,128,128) bf16; bse1, bse2g, bse2b (n,128) f32;
// num_blocks <= n.
int tower_forward_bf16(const void* x, void* out, const void* wconv,
                       const void* bconv, const void* wse1, const void* bse1,
                       const void* wse2g, const void* wse2b,
                       const void* bse2g, const void* bse2b,
                       int games, int num_blocks, void* stream) {
  if (games % kGames != 0 || games < 0 || num_blocks < 0)
    return (int)cudaErrorInvalidValue;
  if (games == 0) return (int)cudaGetLastError();
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      tower_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tower_kernel<<<games / kGames, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)out,
      (const __nv_bfloat16*)wconv, (const float*)bconv,
      (const __nv_bfloat16*)wse1, (const float*)bse1,
      (const __nv_bfloat16*)wse2g, (const __nv_bfloat16*)wse2b,
      (const float*)bse2g, (const float*)bse2b, num_blocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
