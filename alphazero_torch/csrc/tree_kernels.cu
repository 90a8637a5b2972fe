// Search-tree row kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// The search tree is one float32 tensor rows[B, M, R] (R = RS*128 = 768 at
// 192 actions): per game b and node slot n, a fused row holding the blocks
// [child ptr | prior | edge visit | edge vsum]. Each simulation reads one
// row per game at a per-game node index on every descent level, and adds
// three scalars into one row per game on every backprop level.
//
// fetch_rows replaces alphazero_tpu/search/kernels.py:_fetch_rows_tpu
// (pallas_call at kernels.py:80): out[b] = rows[b, node[b]].
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
// What is left over the bound is the launch itself, and the small PyTorch
// launches around the kernels in the search loop; fusing a whole descent
// level into fetch_rows and capturing a simulation in a CUDA graph would
// remove those. Each entry point launches on the given stream and returns
// cudaGetLastError(); it never synchronises.

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

// The launch floor: one thread of a kernel with no body. What a launch
// costs on the device and on the host when the kernel does nothing.
int launch_floor(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
