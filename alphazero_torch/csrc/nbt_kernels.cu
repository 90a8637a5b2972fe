// The nested-bottleneck body's residual adds, norms and global pooling, for
// Hopper (sm_90a), bound to Python with ctypes (models/nbt_epilogue.py).
//
// Replaces no Pallas kernel: the JAX package has no nested-bottleneck net.
// The bf16 evaluator of KataGo's b28c512nbt (models/nbt_inference.py) runs
// its 3x3 convs on conv3x3 and its 1x1 convs as cuBLAS products; these two
// kernels are everything between them, on bf16 (rows, C) maps, a row a
// square of a board:
//
// residual_act_kernel: for each element of y and the residual r (rows, C),
// with a norm's f32 (mean, mul, beta) of C,
//   s   = bf16(f32(r) + f32(y))                          (stored)
//   out = bf16(relu(((f32(s) - mean) * mul) + beta))
// with __fadd_rn, __fsub_rn, __fmul_rn and no FMA, so both outputs are
// bit-equal to models/nbt_epilogue.py:residual_act_plain (the affine is
// bn_act_kernel's, epilogue_kernels.cu, which takes the norm-acts without
// a residual: after the input conv, each 1x1 conv down and the value
// head's conv). It closes every inner block (t + conv(...), then the next
// norm-act) and every outer block (x + conv1x1(...), then the next
// block's norm-act or the final one). Bound at 512 boards: bytes. The
// trunk's close reads y and r and writes s and out, 4 x 33.5 MB = 134 MB,
// 0.040 ms at 3.35 TB/s; the arithmetic is a few operations a byte.
// Design: a thread takes eight channels of a row, 16-byte loads and
// stores, the norm's constants from L1 (4 KB at C 512); a grid of one
// thread a vector.
//
// gpool_bias_kernel: KataGo's global-pooling bias, per board b over its 64
// squares s, with y (boards, 64, cin) holding R regular channels and then
// G pooled ones:
//   g[s, c]   = relu(N_g(y[s, R + c]))                   f32, not rounded
//   pool[k]   = [sum_s g / 64, that * -0.6, max_s g]     3G, f32
//   bias[o]   = sum_k pool[k] w[k, o]                    R, f32, k in order
//   out[s, o] = bf16(relu(N_2(f32(y[s, o]) + bias[o])))  o < R
//   out[s, o] = 0                                         R <= o < cout
// The zeros pad the R channels to the next conv's width (conv3x3 takes cin
// = cout), whose weights are zero there. Used in the first inner block of
// every third outer block (R 192, G 64, cin = cout = 256) and in the
// policy head (R = G = 64, cin 128, cout 64). The pool's sums are taken in
// another order than the plain version's, so an output may round to the
// neighbouring bf16 value (card_check). Bound at 512 boards with R 192, G
// 64: bytes, y read once and out written once, 2 x 16.8 MB, 0.010 ms at
// 3.35 TB/s; w (147 KB in f32) is read from L2 once a block. Design: a
// block of 256 threads takes kBoards boards: the pool of each (board,
// channel) in four partial runs of 16 squares, combined in a fixed order;
// then a thread an output channel takes the product for every board of the
// block, so w is read once for them; then a thread a 16-byte vector of
// the output. Three block-wide barriers, no atomics.
//
// Each entry point launches on the given stream and returns the launch's
// error; it never synchronises, allocates nothing and queries nothing of
// the device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;                 // bf16 values a 16-byte vector
constexpr int kThreads = 256;
constexpr int kBoards = 2;              // boards a gpool block
constexpr int kParts = 4;               // partial runs of a board's squares
constexpr int kSquares = 64;
constexpr int kMaxPooled = 128;         // G, at most
constexpr int kMaxRegular = 256;        // R, at most

__device__ __forceinline__ void unpack(uint4 v, float (&f)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 p = __bfloat1622float2(h[k]);
    f[2 * k] = p.x;
    f[2 * k + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[kVec]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k)
    h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bn_act_kernel's BatchNorm and torch.relu's ReLU (NaN stays NaN)
__device__ __forceinline__ float norm_relu(float v, float mean, float mul,
                                           float beta) {
  const float a = __fadd_rn(__fmul_rn(__fsub_rn(v, mean), mul), beta);
  return a < 0.0f ? 0.0f : a;
}

__global__ void __launch_bounds__(kThreads)
residual_act_kernel(const __nv_bfloat16* __restrict__ y,
                    const __nv_bfloat16* __restrict__ r,
                    const float* __restrict__ mean,
                    const float* __restrict__ mul,
                    const float* __restrict__ beta,
                    __nv_bfloat16* __restrict__ s_out,
                    __nv_bfloat16* __restrict__ out, long long vectors,
                    int channels) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= vectors) return;
  const int c0 = (int)(i % (channels / kVec)) * kVec;
  float s[kVec], rv[kVec];
  unpack(__ldg(reinterpret_cast<const uint4*>(y) + i), s);
  unpack(__ldg(reinterpret_cast<const uint4*>(r) + i), rv);
#pragma unroll
  for (int k = 0; k < kVec; ++k) s[k] = round_bf16(__fadd_rn(rv[k], s[k]));
  reinterpret_cast<uint4*>(s_out)[i] = pack(s);
  const float4* m4 = reinterpret_cast<const float4*>(mean + c0);
  const float4* k4 = reinterpret_cast<const float4*>(mul + c0);
  const float4* b4 = reinterpret_cast<const float4*>(beta + c0);
  float a[kVec];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 m = __ldg(m4 + h), k = __ldg(k4 + h), b = __ldg(b4 + h);
    a[4 * h] = norm_relu(s[4 * h], m.x, k.x, b.x);
    a[4 * h + 1] = norm_relu(s[4 * h + 1], m.y, k.y, b.y);
    a[4 * h + 2] = norm_relu(s[4 * h + 2], m.z, k.z, b.z);
    a[4 * h + 3] = norm_relu(s[4 * h + 3], m.w, k.w, b.w);
  }
  reinterpret_cast<uint4*>(out)[i] = pack(a);
}

struct GpoolArgs {
  const __nv_bfloat16* y;               // (boards, 64, cin)
  const float* g_mean;                  // N_g, [G] each
  const float* g_mul;
  const float* g_beta;
  const float* w;                       // (3G, R), row k the pool's term k
  const float* mean;                    // N_2, [R] each
  const float* mul;
  const float* beta;
  __nv_bfloat16* out;                   // (boards, 64, cout)
  int boards, regular, pooled, cin, cout;
};

__global__ void __launch_bounds__(kThreads)
gpool_bias_kernel(const GpoolArgs a) {
  __shared__ float part_sum[kBoards][kParts][kMaxPooled];
  __shared__ float part_max[kBoards][kParts][kMaxPooled];
  __shared__ float pool[kBoards][3 * kMaxPooled];
  __shared__ float bias[kBoards][kMaxRegular];
  const int tid = threadIdx.x;
  const int first = blockIdx.x * kBoards;
  const int G = a.pooled, R = a.regular;

  // the pool: (board, part, channel) runs of 16 squares, in square order
  for (int item = tid; item < kBoards * kParts * G; item += kThreads) {
    const int c = item % G, part = (item / G) % kParts,
              j = item / (G * kParts);
    const int b = first + j;
    float sum = 0.0f, mx = 0.0f;        // every g is >= 0
    if (b < a.boards) {
      const float m = __ldg(a.g_mean + c), k = __ldg(a.g_mul + c),
                  be = __ldg(a.g_beta + c);
      const __nv_bfloat16* src =
          a.y + ((size_t)b * kSquares + part * (kSquares / kParts)) * a.cin
          + R + c;
#pragma unroll 8
      for (int s = 0; s < kSquares / kParts; ++s) {
        const float g = norm_relu(__bfloat162float(src[(size_t)s * a.cin]),
                                  m, k, be);
        sum = __fadd_rn(sum, g);
        mx = fmaxf(mx, g);
      }
    }
    part_sum[j][part][c] = sum;
    part_max[j][part][c] = mx;
  }
  __syncthreads();
  for (int item = tid; item < kBoards * G; item += kThreads) {
    const int c = item % G, j = item / G;
    float sum = part_sum[j][0][c], mx = part_max[j][0][c];
#pragma unroll
    for (int part = 1; part < kParts; ++part) {
      sum = __fadd_rn(sum, part_sum[j][part][c]);
      mx = fmaxf(mx, part_max[j][part][c]);
    }
    const float mean = __fmul_rn(sum, 1.0f / kSquares);
    pool[j][c] = mean;
    pool[j][G + c] = __fmul_rn(mean, -0.6f);
    pool[j][2 * G + c] = mx;
  }
  __syncthreads();

  // the bias: a thread an output channel, every board of the block
  for (int o = tid; o < R; o += kThreads) {
    float acc[kBoards];
#pragma unroll
    for (int j = 0; j < kBoards; ++j) acc[j] = 0.0f;
    for (int k = 0; k < 3 * G; ++k) {
      const float wk = __ldg(a.w + (size_t)k * R + o);
#pragma unroll
      for (int j = 0; j < kBoards; ++j) acc[j] = fmaf(pool[j][k], wk, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kBoards; ++j) bias[j][o] = acc[j];
  }
  __syncthreads();

  // the output: a thread a 16-byte vector of a square's row
  const int vecs = a.cout / kVec;
  for (int item = tid; item < kBoards * kSquares * vecs; item += kThreads) {
    const int v = item % vecs, row = item / vecs;
    const int j = row / kSquares;
    const int b = first + j;
    if (b >= a.boards) break;           // rows of a board are contiguous
    const int c0 = v * kVec;
    float f[kVec];
    if (c0 < R) {
      unpack(__ldg(reinterpret_cast<const uint4*>(
                 a.y + ((size_t)first * kSquares + row) * a.cin + c0)),
             f);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int o = c0 + k;
        f[k] = norm_relu(__fadd_rn(f[k], bias[j][o]), __ldg(a.mean + o),
                         __ldg(a.mul + o), __ldg(a.beta + o));
      }
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) f[k] = 0.0f;
    }
    reinterpret_cast<uint4*>(a.out + ((size_t)first * kSquares + row)
                             * a.cout)[v] = pack(f);
  }
}

}  // namespace

extern "C" {

// y, r, s_out, out: bf16 (rows, channels), contiguous and 16-byte aligned;
// mean, mul, beta: f32 [channels], 16-byte aligned. channels a multiple of
// 8. No output may alias an input.
int residual_act_bf16(const void* y, const void* r, const void* mean,
                      const void* mul, const void* beta, void* s_out,
                      void* out, long long rows, int channels, void* stream) {
  if (rows < 0 || channels <= 0 || channels % kVec || r == nullptr ||
      s_out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  const long long vectors = rows * (channels / kVec);
  const long long blocks = (vectors + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  residual_act_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(y),
      static_cast<const __nv_bfloat16*>(r), static_cast<const float*>(mean),
      static_cast<const float*>(mul), static_cast<const float*>(beta),
      static_cast<__nv_bfloat16*>(s_out), static_cast<__nv_bfloat16*>(out),
      vectors, channels);
  return (int)cudaGetLastError();
}

// y: bf16 (boards, 64, cin) with cin >= regular + pooled; out: bf16
// (boards, 64, cout) with regular <= cout; both contiguous and 16-byte
// aligned, cin, cout and regular multiples of 8; pooled at most 128,
// regular at most 256. g_mean, g_mul, g_beta: f32 [pooled]; mean, mul,
// beta: f32 [regular]; w: f32 (3 pooled, regular), row-major.
int gpool_bias_bf16(const void* y, const void* g_mean, const void* g_mul,
                    const void* g_beta, const void* w, const void* mean,
                    const void* mul, const void* beta, void* out, int boards,
                    int regular, int pooled, int cin, int cout,
                    void* stream) {
  if (boards < 0 || regular <= 0 || pooled <= 0 || regular % kVec ||
      cin % kVec || cout % kVec || regular + pooled > cin ||
      regular > cout || pooled > kMaxPooled || regular > kMaxRegular)
    return (int)cudaErrorInvalidValue;
  if (boards == 0) return (int)cudaGetLastError();
  const GpoolArgs a{static_cast<const __nv_bfloat16*>(y),
                    static_cast<const float*>(g_mean),
                    static_cast<const float*>(g_mul),
                    static_cast<const float*>(g_beta),
                    static_cast<const float*>(w),
                    static_cast<const float*>(mean),
                    static_cast<const float*>(mul),
                    static_cast<const float*>(beta),
                    static_cast<__nv_bfloat16*>(out),
                    boards, regular, pooled, cin, cout};
  gpool_bias_kernel<<<(boards + kBoards - 1) / kBoards, kThreads, 0,
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
