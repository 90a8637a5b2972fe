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
// per-head smolgen vectors [boards][32][256] and W_gen^T [4096][256], both
// bf16. Every product on tensor cores (mma.sync m16n8k16, bf16 operands,
// float32 sums); the softmax in float32. The plain version is
// models/attention.py:smolgen_attention_plain.
//
// Bound on an H100 at 512 boards, one launch a layer: bytes. Q, K, V and
// the output, 4 x 67 MB, and the smolgen vectors and W_gen (8.4 MB, 2 MB)
// are 279 MB, 83.3 us at 3.35 TB/s; the 42.9 GFLOP (34.4 of them the
// bias: a 16,384 x 256 x 4,096 product) take 43.4 us at 989 TFLOP/s.
//   Design: a block a board, 8 warps. The 64 x 64 bias and logits never
// reach device memory: the bias is generated in shared memory, 16 query
// rows of all 32 heads at a time (a 32 x 256 x 1,024 product a chunk, the
// board's smolgen vectors as A from shared memory, W_gen^T as B straight
// from L2, where its 2 MB stay), then each warp takes four heads of the
// chunk: Q K^T for its 16 rows, the bias added, the softmax in registers
// (a row lies on the four lanes of a quad), and P V with P taken from the
// logits' accumulators as the next product's A operand. Within both the
// bias product and Q K^T the k order is permuted so that a lane's
// operands of two k-steps are one 16-byte load: lane t of a quad holds
// columns 8t .. 8t + 7 of a 32-wide slice, for A and B alike. The bias is
// kept in float32, padded so that neither its stores nor the attention's
// reads conflict on shared-memory banks.
//   What bounds it (0.40 ms at 512 boards, 21% of the bound above): L2.
// Every block reads all of W_gen (1 GB from L2 a launch) and each head's K
// and V once a chunk (four times, 0.5 GB). With the attention left out
// the bias alone takes 0.150 ms, L2's rate; the attention alone 0.254 ms,
// its loads' latency. Prefetching W_gen a k-step ahead, 16 warps a block,
// and V through a tile in shared memory read by ldmatrix.trans were each
// slower or no faster. More heads or boards a block would read W_gen less
// often but need a larger bias in shared memory, and fewer rows a chunk
// read K and V more often.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;                 // tokens (squares) a board
constexpr int kH = 32;                 // heads
constexpr int kD = 32;                 // a head's width
constexpr int kE = kH * kD;            // 1024
constexpr int kQKV = 3 * kE;           // a token's row of the packed QKV
constexpr int kG = 256;                // smolgen's width a head
constexpr int kRows = 16;              // query rows a chunk
constexpr int kChunks = kT / kRows;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kColsWarp = kRows * kT / kWarps;   // bias columns a warp: 128
constexpr int kBiasRow = kT + 8;                 // floats a bias row
constexpr int kBiasHead = kRows * kBiasRow + 8;  // floats a head's chunk
constexpr int kSRow = kG + 32;                   // bf16 a smolgen vector
constexpr int kBiasBytes = kH * kBiasHead * 4;
constexpr int kSmem = kBiasBytes + kH * kSRow * 2;   // 166,912
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint4 ldg16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__global__ void __launch_bounds__(kThreads, 1)
smolgen_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                         const __nv_bfloat16* __restrict__ s,
                         const __nv_bfloat16* __restrict__ wgen_t,
                         __nv_bfloat16* __restrict__ out, float inv_sqrt_d) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* bias = reinterpret_cast<float*>(smem);
  __nv_bfloat16* sv = reinterpret_cast<__nv_bfloat16*>(smem + kBiasBytes);
  const int board = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const uint4* src = reinterpret_cast<const uint4*>(s) +
                     (size_t)board * kH * kG / 8;
  for (int i = threadIdx.x; i < kH * kG / 8; i += kThreads)
    *reinterpret_cast<uint4*>(sv + (i / (kG / 8)) * kSRow + (i % (kG / 8)) * 8) =
        __ldg(src + i);
  __syncthreads();

  const __nv_bfloat16* rows = qkv + (size_t)board * kT * kQKV;
  const unsigned short* vraw =
      reinterpret_cast<const unsigned short*>(rows + 2 * kE);
  for (int chunk = 0; chunk < kChunks; ++chunk) {
    // -- the bias of query rows chunk*16 .. +15 of every head -------------
    for (int half = 0; half < kColsWarp / 64; ++half) {
      const int col0 = chunk * kRows * kT + warp * kColsWarp + half * 64;
      float acc[2][8][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
#pragma unroll
      for (int kp = 0; kp < kG / 32; ++kp) {
        uint4 b[8];
#pragma unroll
        for (int n = 0; n < 8; ++n)
          b[n] = ldg16(wgen_t + (size_t)(col0 + n * 8 + g) * kG + kp * 32 +
                       t * 8);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const uint4 lo = *reinterpret_cast<const uint4*>(
              sv + (m * 16 + g) * kSRow + kp * 32 + t * 8);
          const uint4 hi = *reinterpret_cast<const uint4*>(
              sv + (m * 16 + g + 8) * kSRow + kp * 32 + t * 8);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            mma(acc[m][n], lo.x, hi.x, lo.y, hi.y, b[n].x, b[n].y);
            mma(acc[m][n], lo.z, hi.z, lo.w, hi.w, b[n].z, b[n].w);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = col0 - chunk * kRows * kT + n * 8 + 2 * t;
          float* at = bias + (m * 16 + g) * kBiasHead + (col / kT) * kBiasRow +
                      col % kT;
          *reinterpret_cast<float2*>(at) = make_float2(acc[m][n][0],
                                                       acc[m][n][1]);
          *reinterpret_cast<float2*>(at + 8 * kBiasHead) =
              make_float2(acc[m][n][2], acc[m][n][3]);
        }
    }
    __syncthreads();

    // -- attention of the chunk's rows, four heads a warp -----------------
    const int row0 = chunk * kRows;
    for (int hh = 0; hh < kH / kWarps; ++hh) {
      const int h = warp + hh * kWarps;
      const uint4 q0 = ldg16(rows + (size_t)(row0 + g) * kQKV + h * kD + t * 8);
      const uint4 q1 =
          ldg16(rows + (size_t)(row0 + g + 8) * kQKV + h * kD + t * 8);
      float sc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint4 k =
            ldg16(rows + (size_t)(n * 8 + g) * kQKV + kE + h * kD + t * 8);
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        mma(sc[n], q0.x, q1.x, q0.y, q1.y, k.x, k.y);
        mma(sc[n], q0.z, q1.z, q0.w, q1.w, k.z, k.w);
      }
      // logits in base 2, each row's largest
      const float* bh = bias + h * kBiasHead;
      float mx0 = -3.0e38f, mx1 = -3.0e38f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 b0 =
            *reinterpret_cast<const float2*>(bh + g * kBiasRow + n * 8 + 2 * t);
        const float2 b1 = *reinterpret_cast<const float2*>(
            bh + (g + 8) * kBiasRow + n * 8 + 2 * t);
        sc[n][0] = fmaf(sc[n][0], inv_sqrt_d, b0.x) * kLog2e;
        sc[n][1] = fmaf(sc[n][1], inv_sqrt_d, b0.y) * kLog2e;
        sc[n][2] = fmaf(sc[n][2], inv_sqrt_d, b1.x) * kLog2e;
        sc[n][3] = fmaf(sc[n][3], inv_sqrt_d, b1.y) * kLog2e;
        mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
      }
#pragma unroll
      for (int x = 1; x < 4; x *= 2) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      float sum0 = 0.f, sum1 = 0.f;
      uint32_t p[8][2];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float e0 = exp2f(sc[n][0] - mx0), e1 = exp2f(sc[n][1] - mx0);
        const float e2 = exp2f(sc[n][2] - mx1), e3 = exp2f(sc[n][3] - mx1);
        sum0 += e0 + e1;
        sum1 += e2 + e3;
        p[n][0] = pack(e0, e1);
        p[n][1] = pack(e2, e3);
      }
#pragma unroll
      for (int x = 1; x < 4; x *= 2) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
      }
      // P V: k the keys (four steps of 16), n the head's 32 columns; B's
      // pairs of keys are two rows of V apart, read as two values
      float o[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int j = ks * 16 + 2 * t;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const unsigned short* v = vraw + h * kD + n * 8 + g;
          const uint32_t b0 = __ldg(v + (size_t)j * kQKV) |
                              ((uint32_t)__ldg(v + (size_t)(j + 1) * kQKV) << 16);
          const uint32_t b1 =
              __ldg(v + (size_t)(j + 8) * kQKV) |
              ((uint32_t)__ldg(v + (size_t)(j + 9) * kQKV) << 16);
          mma(o[n], p[2 * ks][0], p[2 * ks][1], p[2 * ks + 1][0],
              p[2 * ks + 1][1], b0, b1);
        }
      }
      const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
      __nv_bfloat16* dst = out + ((size_t)board * kT + row0 + g) * kE + h * kD;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        *reinterpret_cast<uint32_t*>(dst + n * 8 + 2 * t) =
            pack(o[n][0] * inv0, o[n][1] * inv0);
        *reinterpret_cast<uint32_t*>(dst + 8 * kE + n * 8 + 2 * t) =
            pack(o[n][2] * inv1, o[n][3] * inv1);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// qkv: bf16 [boards * 64][3072]; s: bf16 [boards][32][256]; wgen_t: bf16
// [4096][256]; out: bf16 [boards * 64][1024]; all contiguous and 16-byte
// aligned. heads, dim and gen must be the kernel's 32, 32 and 256.
int smolgen_attention_bf16(const void* qkv, const void* s, const void* wgen_t,
                           void* out, int boards, int heads, int dim, int gen,
                           void* stream) {
  if (boards < 0 || heads != kH || dim != kD || gen != kG)
    return (int)cudaErrorInvalidValue;
  // once a process, before the first launch (always eager: a search's
  // warm-up simulations run before its capture)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        smolgen_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  if (boards == 0) return (int)cudaGetLastError();
  smolgen_attention_kernel<<<boards, kThreads, kSmem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(s),
      static_cast<const __nv_bfloat16*>(wgen_t),
      static_cast<__nv_bfloat16*>(out), 0.17677669529663687f);
  return (int)cudaGetLastError();
}

}  // extern "C"
