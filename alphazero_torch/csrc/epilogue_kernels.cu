// The epilogues around the convolutions of the bf16 search evaluator's
// forward, for Hopper (sm_90a), bound to Python with ctypes.
//
// Replace no Pallas kernel: they are the fusions that XLA makes around the
// convolutions of the JAX package's bf16 net when the evaluator is traced
// inside the jitted move (alphazero_tpu/search/mcts.py:717-725). Maps are
// NHWC bf16, (boards, 8, 8, C), contiguous, C a multiple of 8; the plain
// versions are models/epilogue.py:bn_act_plain and se_residual_plain.
//
// bn_act: an inference BatchNorm and its ReLU
// (alphazero_tpu/models/network.py:68-70; also the input, policy and value
// BatchNorms). Per element of channel c:
//   out = bf16(relu(((f32(y) - mean[c]) * mul[c]) + beta[c]))
// in the order of flax.linen.normalization._normalize, with
// mul = rsqrt(var + eps) * gamma computed once on the host. __fsub_rn,
// __fmul_rn and __fadd_rn keep nvcc from contracting the multiply and add
// into an FMA, so the kernel and its plain version agree bit for bit.
//   Bound on an H100 at 512 boards, C = 128: bytes. 8.4 MB in and 8.4 MB
// out (16.78 MB) at 3.35 TB/s take 0.0050 ms. Design: a grid-stride loop
// over 16-byte vectors of eight channels, the channel constants read as
// float4 through the L1 cache.
//
// se_residual: the tail of a tower block (network.py:74-77 and
// quant.py:185-186). Per board, with s the 64 squares:
//   y'[s,c]  = y[s,c], or bn_act's affine of it without ReLU (bf16 net:
//              bn2; the int8 net's conv already added its bias)
//   pooled[c] = bf16(sum_s f32(y'[s,c]) / 64)
//   h[j]     = relu(bf16(bf16(pooled . w1[:,j]) + b1[j]))         j < H
//   g[o]     = bf16(bf16(h . w2[:,o]) + b2[o])                    o < 2C
//   gate[c]  = bf16(sigmoid(g[c])), shift[c] = g[C + c]
//   out[s,c] = relu(bf16(bf16(bf16(y'[s,c] * gate[c]) + shift[c]) + x[s,c]))
// Every bf16 rounding is where the plain version's separate bf16 operation
// rounds (the mean, each matrix product and each bias add, the sigmoid, the
// multiply and the two adds). Only the order of the f32 sums of the pool and
// of the two dense layers is the kernel's own.
//   Bound on an H100 at 512 boards, C = 128: bytes. y and x read and out
// written once, 25.2 MB, take 0.0075 ms; the SE's arithmetic is some 5,000
// operations a board. Design: one thread block of 256 threads walks over
// boards (at most four blocks an SM, so at 512 boards each block has one).
// It copies the SE weights into shared memory once; per board it stages
// y' there as bf16 (16 KB at C = 128), pools it column by column in fixed
// row partitions, computes fc1 with a group of adjacent lanes a hidden unit
// (a shuffle reduction), fc2 with one thread an output, and writes out in
// 16-byte vectors, reading x once. A block's shared memory stays within the
// default 48 KB (33 KB at C = 128, H = 16; C up to 128 and H up to 32 fit).
//
// The entry points launch on the given stream and return
// cudaGetLastError(); they never synchronise and allocate nothing.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
// a block's dynamic shared memory without an opt-in
constexpr int kMaxSmem = 48 * 1024;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// torch.relu's: NaN stays NaN
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

// Flax's inference BatchNorm: ((y - mean) * mul) + beta in f32, no FMA
__device__ __forceinline__ float affine(float y, float mean, float mul,
                                        float beta) {
  return __fadd_rn(__fmul_rn(__fsub_rn(y, mean), mul), beta);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__global__ void __launch_bounds__(kThreads)
    bn_act_kernel(const uint4* __restrict__ y, const float* __restrict__ mean,
                  const float* __restrict__ mul,
                  const float* __restrict__ beta, uint4* __restrict__ out,
                  long long vectors, int groups) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
       v < vectors; v += stride) {
    const int c0 = (int)(v % groups) * 8;
    float m[8], k[8], b[8];
    load8(mean + c0, m);
    load8(mul + c0, k);
    load8(beta + c0, b);
    const uint4 in = y[v];
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&in);
    uint4 res;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      o[i] = __floats2bfloat162_rn(
          relu(affine(f.x, m[2 * i], k[2 * i], b[2 * i])),
          relu(affine(f.y, m[2 * i + 1], k[2 * i + 1], b[2 * i + 1])));
    }
    out[v] = res;
  }
}

struct SeArgs {
  const __nv_bfloat16* y;
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  const float* mean;                    // mean, mul, beta: all null for no
  const float* mul;                     // affine
  const float* beta;
  const __nv_bfloat16* w1;              // [C][H]
  const __nv_bfloat16* b1;              // [H]
  const __nv_bfloat16* w2;              // [H][2C]
  const __nv_bfloat16* b2;              // [2C]
  int boards, C, H;
  int parts;                            // row partitions of the pool
  int lanes;                            // adjacent lanes a hidden unit
};

// Shared memory of a block, in bytes: the board y' (bf16, first, so that it
// is 16-byte aligned), then f32 [3C affine | C pooled | C gate | C shift |
// parts*C partial sums | H hidden], then the bf16 weights.
__host__ __device__ inline int se_smem_bytes(int C, int H, int parts) {
  return 128 * C + 4 * (6 * C + parts * C + H) + 2 * (3 * C * H + H + 2 * C);
}

__global__ void __launch_bounds__(kThreads) se_residual_kernel(SeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, H = a.H, tid = threadIdx.x;
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem);
  float* aff = reinterpret_cast<float*>(smem + 128 * C);
  float* pooled = aff + 3 * C;
  float* gate = pooled + C;
  float* shift = gate + C;
  float* red = shift + C;
  float* hidden = red + a.parts * C;
  __nv_bfloat16* w1 = reinterpret_cast<__nv_bfloat16*>(hidden + H);
  __nv_bfloat16* b1 = w1 + C * H;
  __nv_bfloat16* w2 = b1 + H;
  __nv_bfloat16* b2 = w2 + 2 * C * H;

  const bool has_affine = a.mean != nullptr;
  for (int i = tid; i < C * H; i += kThreads) w1[i] = a.w1[i];
  for (int i = tid; i < 2 * C * H; i += kThreads) w2[i] = a.w2[i];
  for (int i = tid; i < H; i += kThreads) b1[i] = a.b1[i];
  for (int i = tid; i < 2 * C; i += kThreads) b2[i] = a.b2[i];
  if (has_affine)
    for (int c = tid; c < C; c += kThreads) {
      aff[c] = a.mean[c];
      aff[C + c] = a.mul[c];
      aff[2 * C + c] = a.beta[c];
    }
  __syncthreads();

  const int groups = C / 8, vectors = 8 * C;  // 16-byte vectors of a board
  const int rows = 64 / a.parts;
  uint4* ysv = reinterpret_cast<uint4*>(ys);
  for (int board = blockIdx.x; board < a.boards; board += gridDim.x) {
    const size_t base = (size_t)board * 64 * C;

    // y' into shared memory
    const uint4* yv = reinterpret_cast<const uint4*>(a.y + base);
    for (int v = tid; v < vectors; v += kThreads) {
      uint4 in = yv[v];
      if (has_affine) {
        const int c0 = (v % groups) * 8;
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&in);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = c0 + 2 * i;
          const float2 f = __bfloat1622float2(e[i]);
          e[i] = __floats2bfloat162_rn(
              affine(f.x, aff[c], aff[C + c], aff[2 * C + c]),
              affine(f.y, aff[c + 1], aff[C + c + 1], aff[2 * C + c + 1]));
        }
      }
      ysv[v] = in;
    }
    __syncthreads();

    // the pool: partial column sums over `parts` runs of rows, then their
    // sum in order
    for (int i = tid; i < a.parts * C; i += kThreads) {
      const int p = i / C, c = i - p * C;
      float s = 0.0f;
      for (int r = p * rows; r < (p + 1) * rows; ++r)
        s += __bfloat162float(ys[r * C + c]);
      red[i] = s;
    }
    __syncthreads();
    for (int c = tid; c < C; c += kThreads) {
      float s = 0.0f;
      for (int p = 0; p < a.parts; ++p) s += red[p * C + c];
      pooled[c] = round_bf16(s * (1.0f / 64.0f));
    }
    __syncthreads();

    // fc1: hidden unit j on lanes j*lanes .. +lanes of one warp; every
    // thread runs the shuffles, so the full mask holds
    {
      const int j = tid / a.lanes, l = tid - j * a.lanes;
      float s = 0.0f;
      if (j < H)
        for (int k = l; k < C; k += a.lanes)
          s = fmaf(pooled[k], __bfloat162float(w1[k * H + j]), s);
      for (int off = a.lanes >> 1; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (j < H && l == 0)
        hidden[j] = relu(round_bf16(
            __fadd_rn(round_bf16(s), __bfloat162float(b1[j]))));
    }
    __syncthreads();

    // fc2, then the gate and the shift
    for (int o = tid; o < 2 * C; o += kThreads) {
      float s = 0.0f;
      for (int k = 0; k < H; ++k)
        s = fmaf(hidden[k], __bfloat162float(w2[k * 2 * C + o]), s);
      const float g =
          round_bf16(__fadd_rn(round_bf16(s), __bfloat162float(b2[o])));
      if (o < C)
        gate[o] = round_bf16(1.0f / (1.0f + expf(-g)));
      else
        shift[o - C] = g;
    }
    __syncthreads();

    // out = relu(y' * gate + shift + x), rounded after each operation
    const uint4* xv = reinterpret_cast<const uint4*>(a.x + base);
    uint4* ov = reinterpret_cast<uint4*>(a.out + base);
    for (int v = tid; v < vectors; v += kThreads) {
      const int c0 = (v % groups) * 8;
      const uint4 yy = ysv[v], xx = xv[v];
      const __nv_bfloat162* ye = reinterpret_cast<const __nv_bfloat162*>(&yy);
      const __nv_bfloat162* xe = reinterpret_cast<const __nv_bfloat162*>(&xx);
      uint4 res;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + 2 * i;
        const float2 yf = __bfloat1622float2(ye[i]);
        const float2 xf = __bfloat1622float2(xe[i]);
        float lo = round_bf16(__fmul_rn(yf.x, gate[c]));
        float hi = round_bf16(__fmul_rn(yf.y, gate[c + 1]));
        lo = round_bf16(__fadd_rn(lo, shift[c]));
        hi = round_bf16(__fadd_rn(hi, shift[c + 1]));
        o[i] = __floats2bfloat162_rn(relu(__fadd_rn(lo, xf.x)),
                                     relu(__fadd_rn(hi, xf.y)));
      }
      ov[v] = res;
    }
    __syncthreads();                    // the next board reuses the memory
  }
}

// of the current device
int multiprocessors(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

int largest_pow2_at_most(int n) {
  int p = 1;
  while (2 * p <= n) p *= 2;
  return p;
}

}  // namespace

extern "C" {

// y, out: bf16 NHWC maps of `elements` values, C channels innermost, 16-byte
// aligned; mean, mul, beta: f32 [C], 16-byte aligned. C is a multiple of 8.
int bn_act_bf16(const void* y, const void* mean, const void* mul,
                const void* beta, void* out, long long elements, int C,
                void* stream) {
  if (C <= 0 || C % 8 != 0 || elements < 0 || elements % C != 0)
    return (int)cudaErrorInvalidValue;
  const long long vectors = elements / 8;
  if (vectors == 0) return (int)cudaGetLastError();
  int sms = 0;
  const int err = multiprocessors(&sms);
  if (err != 0) return err;
  const long long want = (vectors + kThreads - 1) / kThreads;
  const int grid = (int)(want < 16LL * sms ? want : 16LL * sms);
  bn_act_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(y), static_cast<const float*>(mean),
      static_cast<const float*>(mul), static_cast<const float*>(beta),
      static_cast<uint4*>(out), vectors, C / 8);
  return (int)cudaGetLastError();
}

// y, x, out: bf16 [boards][64][C], 16-byte aligned; mean, mul, beta: f32
// [C], or all three null for no affine; w1 [C][H], b1 [H], w2 [H][2C],
// b2 [2C]: bf16. C is a multiple of 8, H at least 1, and a block's shared
// memory within the default 48 KB.
int se_residual_bf16(const void* y, const void* x, void* out,
                     const void* mean, const void* mul, const void* beta,
                     const void* w1, const void* b1, const void* w2,
                     const void* b2, int boards, int C, int H, void* stream) {
  if (boards < 0 || C <= 0 || C % 8 != 0 || H <= 0 ||
      (mean == nullptr) != (mul == nullptr) ||
      (mean == nullptr) != (beta == nullptr))
    return (int)cudaErrorInvalidValue;
  if (H > kThreads) return (int)cudaErrorInvalidValue;
  int parts = largest_pow2_at_most(C < kThreads ? kThreads / C : 1);
  if (parts > 64) parts = 64;
  const int lanes = largest_pow2_at_most(kThreads / H < 32 ? kThreads / H
                                                           : 32);
  const int smem = se_smem_bytes(C, H, parts);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (boards == 0) return (int)cudaGetLastError();
  int sms = 0;
  const int err = multiprocessors(&sms);
  if (err != 0) return err;
  const SeArgs a{static_cast<const __nv_bfloat16*>(y),
                 static_cast<const __nv_bfloat16*>(x),
                 static_cast<__nv_bfloat16*>(out),
                 static_cast<const float*>(mean),
                 static_cast<const float*>(mul),
                 static_cast<const float*>(beta),
                 static_cast<const __nv_bfloat16*>(w1),
                 static_cast<const __nv_bfloat16*>(b1),
                 static_cast<const __nv_bfloat16*>(w2),
                 static_cast<const __nv_bfloat16*>(b2),
                 boards, C, H, parts, lanes};
  const int grid = boards < kBlocksPerSm * sms ? boards : kBlocksPerSm * sms;
  se_residual_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
