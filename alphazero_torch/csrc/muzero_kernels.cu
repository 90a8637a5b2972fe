// MuZero's dynamics input and hidden-state scaling, for Hopper (sm_90a),
// bound to Python with ctypes (models/muzero_inference.py).
//
// Replaces no Pallas kernel: the JAX package has no MuZero net. The bf16
// evaluator runs every 3x3 conv of MuZero's two towers on conv3x3 and every
// residual close on residual_act (nbt_kernels.cu); these two kernels are
// what MuZero adds, on bf16 (rows, C) maps, a row a square of a board:
//
// action_term_kernel: the dynamics' input conv over [s ; A(a)], 259
// channels at C 256, which conv3x3 does not take. The conv is linear, so
// conv_{C+3}([s ; A(a)]) = conv_C(s) + conv_3(A(a)): conv3x3 gives y =
// bf16(conv_C(s)), and this kernel adds the action's term and the input
// norm's affine and ReLU. A(a) is three planes: a one-hot from-square f, a
// one-hot to-square t where the target lies on the board, and ones where
// it does. At output square q = (r, c) the term is
//   T[q, o] = W_f[tap(f - q), o] + W_t[tap(t - q), o] + ones[q, o]
// with tap(d) = (dr + 1) * 3 + (dc + 1) where |dr|, |dc| <= 1 (else no
// term), W_f and W_t the conv's taps on the two one-hot planes (f32, (9,
// C)) and ones[q, o] the conv of the plane of ones, its taps summed over
// those that fall on the board (f32, (64, C), made once). Zero padding is
// what makes the one-hot terms a single tap: an input square is on the
// board by definition, so only output squares off the board could read
// it, and there are none; the plane of ones is where the padding counts,
// and its table holds the clipped sums. Then
//   out[q, o] = bf16(relu(((f32(y) + ((tf + tt) + to)) - mean) * mul + beta))
// with __fadd_rn, __fsub_rn, __fmul_rn and absent terms 0, so it is
// bit-equal to models/muzero_inference.py:action_term_plain. Bound at 512
// boards, C 256: bytes, y read and out written once, 2 x 16.8 MB, 0.010 ms
// at 3.35 TB/s; the tables (74 KB) stay in L1 and L2. Design:
// residual_act_kernel's, a thread eight channels of a row, 16-byte loads
// and stores, a grid of one thread a vector.
//
// latent_scale_kernel: MuZero's min-max scaling of a hidden state to
// [0, 1] over a board's 64 x C values, written twice: into a contiguous
// map (the next net's input) and into the tree's latent store at the
// simulation's slot, store[b, slot], the slot read where it lies on the
// device, so that a captured search's replays write each its own slot.
//   lo, hi   = min, max over the board of f32(x)          exact
//   out[i]   = bf16((f32(x[i]) - lo) / max(hi - lo, 1e-5))
// with __fsub_rn and __fdiv_rn, bit-equal to latent_scale_plain. Bound at
// 512 boards, C 256: bytes, x read once and written twice, 3 x 16.8 MB,
// 0.015 ms at 3.35 TB/s. Design: a block of 256 threads a board, a thread
// holding its eight 16-byte vectors in registers (C up to 256), the min
// and max by warp shuffles and one barrier through shared memory.
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
constexpr int kSquares = 64;
constexpr int kMaxVectors = 8;          // a scale thread's, C up to 256
constexpr float kScaleEps = 1e-5f;

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

// adds eight f32 values of a table row, 16-byte aligned, to t
__device__ __forceinline__ void add_row(float (&t)[kVec],
                                        const float* __restrict__ row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4 a = __ldg(r4), b = __ldg(r4 + 1);
  t[0] = __fadd_rn(t[0], a.x);
  t[1] = __fadd_rn(t[1], a.y);
  t[2] = __fadd_rn(t[2], a.z);
  t[3] = __fadd_rn(t[3], a.w);
  t[4] = __fadd_rn(t[4], b.x);
  t[5] = __fadd_rn(t[5], b.y);
  t[6] = __fadd_rn(t[6], b.z);
  t[7] = __fadd_rn(t[7], b.w);
}

// the tap of input square `in` seen from output square `q`, or -1
__device__ __forceinline__ int tap_of(int in, int q) {
  const int dr = (in >> 3) - (q >> 3), dc = (in & 7) - (q & 7);
  return (dr < -1 || dr > 1 || dc < -1 || dc > 1) ? -1
                                                  : (dr + 1) * 3 + dc + 1;
}

__global__ void __launch_bounds__(kThreads)
action_term_kernel(const __nv_bfloat16* __restrict__ y,
                   const int32_t* __restrict__ action,
                   const float* __restrict__ taps,     // (2, 9, C)
                   const float* __restrict__ ones,     // (64, C)
                   const float* __restrict__ mean,
                   const float* __restrict__ mul,
                   const float* __restrict__ beta,
                   __nv_bfloat16* __restrict__ out, long long vectors,
                   int channels) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= vectors) return;
  const int per_row = channels / kVec;
  const long long row = i / per_row;
  const int c0 = (int)(i - row * per_row) * kVec;
  const int q = (int)(row % kSquares);
  const int a = action[row / kSquares];
  // from (row, col) to (row + 1, col + (0, -1, +1)[dir]) in the mover's
  // frame, the action's own
  const int from = a / 3, dir = a - 3 * from;
  const int to_col = (from & 7) + (dir == 2) - (dir == 1);
  const bool on = (from >> 3) + 1 < 8 && to_col >= 0 && to_col < 8;
  float t[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) t[k] = 0.0f;
  const int tf = tap_of(from, q);
  if (tf >= 0) add_row(t, taps + tf * channels + c0);
  if (on) {
    const int tt = tap_of(from + 8 + (dir == 2) - (dir == 1), q);
    if (tt >= 0) add_row(t, taps + (9 + tt) * channels + c0);
    add_row(t, ones + q * channels + c0);
  }
  float s[kVec];
  unpack(__ldg(reinterpret_cast<const uint4*>(y) + i), s);
  const float4* m4 = reinterpret_cast<const float4*>(mean + c0);
  const float4* k4 = reinterpret_cast<const float4*>(mul + c0);
  const float4* b4 = reinterpret_cast<const float4*>(beta + c0);
  float o[kVec];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 m = __ldg(m4 + h), k = __ldg(k4 + h), b = __ldg(b4 + h);
    const float mv[4] = {m.x, m.y, m.z, m.w};
    const float kv[4] = {k.x, k.y, k.z, k.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * h + e;
      const float v = __fadd_rn(
          __fmul_rn(__fsub_rn(__fadd_rn(s[j], t[j]), mv[e]), kv[e]), bv[e]);
      o[j] = v < 0.0f ? 0.0f : v;
    }
  }
  reinterpret_cast<uint4*>(out)[i] = pack(o);
}

__global__ void __launch_bounds__(kThreads)
latent_scale_kernel(const __nv_bfloat16* __restrict__ x,
                    __nv_bfloat16* __restrict__ out,
                    __nv_bfloat16* __restrict__ store,
                    const int32_t* __restrict__ slot, long long slots,
                    int vectors) {
  __shared__ float s_lo[kThreads / 32], s_hi[kThreads / 32];
  const long long b = blockIdx.x;
  const int t = threadIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(x) + b * vectors;
  uint4 v[kMaxVectors];
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int k = 0; k < kMaxVectors; ++k) {
    const int j = t + k * kThreads;
    if (j < vectors) {
      v[k] = __ldg(src + j);
      float f[kVec];
      unpack(v[k], f);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        lo = fminf(lo, f[e]);
        hi = fmaxf(hi, f[e]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if ((t & 31) == 0) {
    s_lo[t >> 5] = lo;
    s_hi[t >> 5] = hi;
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) {
    lo = fminf(lo, s_lo[w]);
    hi = fmaxf(hi, s_hi[w]);
  }
  const float den = fmaxf(__fsub_rn(hi, lo), kScaleEps);
  uint4* dst = reinterpret_cast<uint4*>(out) + b * vectors;
  uint4* kept = nullptr;
  if (store != nullptr) {
    const long long at = slot[0];
    if (at >= 0 && at < slots) {        // no well-formed tree has another
      kept = reinterpret_cast<uint4*>(store) + (b * slots + at) * vectors;
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxVectors; ++k) {
    const int j = t + k * kThreads;
    if (j < vectors) {
      float f[kVec];
      unpack(v[k], f);
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = __fdiv_rn(__fsub_rn(f[e], lo), den);
      const uint4 p = pack(f);
      dst[j] = p;
      if (kept != nullptr) kept[j] = p;
    }
  }
}

}  // namespace

extern "C" {

// y, out: bf16 (boards * 64, channels), contiguous and 16-byte aligned;
// action: int32 [boards], canonical actions in [0, 192); taps: f32 (2, 9,
// channels) (from-square, to-square); ones: f32 (64, channels); mean, mul,
// beta: f32 [channels]; all 16-byte aligned, channels a multiple of 8.
int action_term_bf16(const void* y, const void* action, const void* taps,
                     const void* ones, const void* mean, const void* mul,
                     const void* beta, void* out, long long boards,
                     int channels, void* stream) {
  if (boards < 0 || channels <= 0 || channels % kVec)
    return (int)cudaErrorInvalidValue;
  if (boards == 0) return (int)cudaGetLastError();
  const long long vectors = boards * kSquares * (channels / kVec);
  const long long blocks = (vectors + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  action_term_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(y),
      static_cast<const int32_t*>(action), static_cast<const float*>(taps),
      static_cast<const float*>(ones), static_cast<const float*>(mean),
      static_cast<const float*>(mul), static_cast<const float*>(beta),
      static_cast<__nv_bfloat16*>(out), vectors, channels);
  return (int)cudaGetLastError();
}

// x, out: bf16 (boards, 64, channels), contiguous and 16-byte aligned,
// channels a multiple of 8 up to 256; store: bf16 (boards, slots, 64,
// channels) or null; slot: one int32 on the device (a slot out of range
// writes no store).
int latent_scale_bf16(const void* x, void* out, void* store,
                      const void* slot, long long slots, long long boards,
                      int channels, void* stream) {
  if (boards < 0 || channels <= 0 || channels % kVec ||
      kSquares * channels > kMaxVectors * kThreads * kVec ||
      (store != nullptr && (slot == nullptr || slots <= 0)))
    return (int)cudaErrorInvalidValue;
  if (boards == 0) return (int)cudaGetLastError();
  if (boards > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  latent_scale_kernel<<<(unsigned)boards, kThreads, 0,
                        (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
      static_cast<__nv_bfloat16*>(store), static_cast<const int32_t*>(slot),
      slots, kSquares * channels / kVec);
  return (int)cudaGetLastError();
}

}  // extern "C"
