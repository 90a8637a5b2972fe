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
//   arithmetic. At that size the launch latency (a few us) dominates.
//   Design: one block per game and 16-byte vector loads (a 3 KiB row is
//   192 float4, one per thread), so every row is one coalesced burst and
//   all B rows are in flight at once; the TPU kernel's 16-deep DMA
//   pipeline has no counterpart because the GPU keeps B blocks in flight.
//   The row offset is computed in 64 bits: B*M*R passes 2^31 as soon as
//   tree reuse doubles the capacity at 1024 games.
//
// commit_edges replaces alphazero_tpu/search/kernels.py:_commit_edges_tpu
// (pallas_call at kernels.py:205): in place,
//   rows[b, node[b], off[k] + act[b]] += upd[b, k]   for k < K.
//   Bound on an H100: about 22 KB at B=512, K=3 (node, act, upd read once,
//   each touched element read and written once): a few ns of bandwidth,
//   so launch latency is all of its cost.
//   Design: one thread per (game, k) doing one float32 read-add-write.
//   No atomics: the offsets are at least num_actions apart (the Python
//   wrapper checks this), so within a game every element gets exactly one
//   update, and different games own different rows. Adding the float32
//   update to the float32 element and storing is bit-identical to the TPU
//   kernel's "accumulate the row in f32, round once" rule for a float32
//   tree. The tree is updated in place; the kernel never copies it.
//
// Making them faster (fusing a whole descent level, CUDA graphs over the
// simulation loop) is later work. Each entry point launches on the given
// stream and returns cudaGetLastError(); it never synchronises.

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

__global__ void commit_edges_kernel(float* __restrict__ rows,
                                    const int32_t* __restrict__ node,
                                    const int32_t* __restrict__ act,
                                    const float* __restrict__ upd,
                                    int B, int K, Offsets off,
                                    int64_t M, int64_t R) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * K) return;
  const int b = t / K;
  const int k = t - b * K;
  float* x = rows + ((int64_t)b * M + node[b]) * R + off.v[k] + act[b];
  *x = *x + upd[t];
}

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

// rows: (B, M, R) float32, updated in place; node, act: (B,) int32;
// upd: (B, K) float32; K <= 4 offsets o0..o3 (unused ones ignored).
int commit_edges_f32(void* rows, const void* node, const void* act,
                     const void* upd, int B, int K,
                     int o0, int o1, int o2, int o3,
                     long long M, int R, void* stream) {
  if (K < 1 || K > kMaxOffsets) return (int)cudaErrorInvalidValue;
  const Offsets off = {{o0, o1, o2, o3}};
  const int n = B * K;
  if (n > 0) {
    const int threads = 256;
    commit_edges_kernel<<<(n + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
        (float*)rows, (const int32_t*)node, (const int32_t*)act,
        (const float*)upd, B, K, off, (int64_t)M, (int64_t)R);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
