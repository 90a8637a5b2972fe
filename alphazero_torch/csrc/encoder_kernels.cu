// The encoder body's DeepNorm residual and its LayerNorm as one kernel, for
// Hopper (sm_90a), bound to Python with ctypes (models/encoder_epilogue.py).
//
// Replaces no Pallas kernel: the JAX package has no encoder. It fuses the
// two PyTorch kernels that close both halves of every layer of the encoder
// body's bf16 evaluator (models/encoder_inference.py), torch.add(o, x,
// alpha=alpha) and F.layer_norm, two launches a layer. For each token row
// r of E = 1024 values, with o the sublayer's output and x the row it
// skipped over, all bf16:
//   s[i]   = bf16(o[r, i] + alpha x[r, i])          (f32, rounded once)
//   mean   = sum_i s[i] / E,  var = sum_i (s[i] - mean)^2 / E   (f32)
//   out[r, i] = bf16(gamma[i] (s[i] - mean) rsqrt(var + eps) + beta[i])
// rounded where the PyTorch pair rounds (the sum once to bf16, the normed
// row once), so the two differ only in the order of the row's sums and the
// last bits of rsqrt. The plain version is
// models/encoder_epilogue.py:deepnorm_ln_plain.
//
// Bound on an H100 at 512 boards (32,768 rows): bytes. o and x read once
// and out written once, 3 x 67.1 MB = 201,326,592 bytes, take 0.0601 ms at
// 3.35 TB/s; gamma and beta (4 KB) stay in L1 and L2, and the arithmetic is
// a few operations a byte. The PyTorch pair moves 335 MB: the sum is
// written by the add and read back by layer_norm.
//   Design: a warp a row, the row in registers. Lane l holds the four
// 16-byte vectors at elements 256 c + 8 l (c < 4), so each of a warp's
// loads and stores covers 512 contiguous bytes. The eight loads of o and x
// are all issued before the first use, the sum s stays in 32 float
// registers, and mean and variance are two warp-shuffle reductions over
// them (two passes over registers cost no bytes); the normed row goes
// straight back as four 16-byte stores. No shared memory, no block-wide
// barrier and no atomics: warps of a block never wait on each other, and
// at 64 registers a thread an SM keeps 32 rows (128 KB of loads) in
// flight, far more than HBM's latency needs. The grid is one block a
// kWarps rows, so it follows the row count: 8,192 blocks at 512 boards,
// 2,048 at the trainer's 128 lanes, 16 at one board.
//   Measured at 512 boards (chip_smoke.py smolgen): 0.070 ms, 86% of the
// bound. Tried and not kept, each timed in turns against this design: 2
// or 8 warps a block (no faster), loads that evict first (ld.global.cs,
// 2% slower), a persistent grid-stride loop of 8 or 16 blocks an SM (5%
// slower: 84 registers), 12 blocks an SM forced by launch bounds (40%
// slower: it spills). Stores that evict first (st.global.cs) were 1%
// faster alone and are left out: the feed-forward's first product and the
// next layer read the normed rows straight after.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kE = 1024;               // the row: BT4's embedding width
constexpr int kVec = 8;                // bf16 values a 16-byte vector
constexpr int kPer = kE / (32 * kVec); // vectors a lane: 4
constexpr int kWarps = 4;              // rows a block, one a warp
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ void unpack(uint4 v, float (&f)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 p = __bfloat1622float2(h[k]);
    f[2 * k] = p.x;
    f[2 * k + 1] = p.y;
  }
}

__global__ void __launch_bounds__(kThreads)
deepnorm_ln_kernel(const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ gamma,
                   const __nv_bfloat16* __restrict__ beta,
                   __nv_bfloat16* __restrict__ out, long long rows,
                   float alpha, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint4* o4 = reinterpret_cast<const uint4*>(o + row * kE) + lane;
  const uint4* x4 = reinterpret_cast<const uint4*>(x + row * kE) + lane;
  uint4 ov[kPer], xv[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    ov[c] = __ldg(o4 + 32 * c);
    xv[c] = __ldg(x4 + 32 * c);
  }

  float s[kPer][kVec];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    float of[kVec], xf[kVec];
    unpack(ov[c], of);
    unpack(xv[c], xf);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      // torch.add's a + alpha * b in f32 (one FMA), rounded to bf16 once
      s[c][k] = __bfloat162float(__float2bfloat16_rn(fmaf(alpha, xf[k],
                                                          of[k])));
      sum += s[c][k];
    }
  }
  const float mean = warp_sum(sum) * (1.f / kE);
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < kPer; ++c)
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float d = s[c][k] - mean;
      sq = fmaf(d, d, sq);
    }
  const float rstd = rsqrtf(warp_sum(sq) * (1.f / kE) + eps);

  const uint4* g4 = reinterpret_cast<const uint4*>(gamma) + lane;
  const uint4* b4 = reinterpret_cast<const uint4*>(beta) + lane;
  uint4* out4 = reinterpret_cast<uint4*>(out + row * kE) + lane;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    float gf[kVec], bf[kVec];
    unpack(__ldg(g4 + 32 * c), gf);
    unpack(__ldg(b4 + 32 * c), bf);
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) {
      // layer_norm's gamma * (x - mean) * rstd + beta, in that order
      const float lo = fmaf(gf[2 * k] * (s[c][2 * k] - mean), rstd,
                            bf[2 * k]);
      const float hi = fmaf(gf[2 * k + 1] * (s[c][2 * k + 1] - mean), rstd,
                            bf[2 * k + 1]);
      h[k] = __floats2bfloat162_rn(lo, hi);
    }
    out4[32 * c] = v;
  }
}

}  // namespace

extern "C" {

// o, x, out: bf16 [rows][width]; gamma, beta: bf16 [width]; all contiguous
// and 16-byte aligned. width must be the kernel's 1024. out may not alias o
// or x.
int deepnorm_ln_bf16(const void* o, const void* x, const void* gamma,
                     const void* beta, void* out, long long rows, int width,
                     float alpha, float eps, void* stream) {
  if (rows < 0 || width != kE) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  deepnorm_ln_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(gamma),
      static_cast<const __nv_bfloat16*>(beta),
      static_cast<__nv_bfloat16*>(out), rows, alpha, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
