// The encoder body's DeepNorm residual and its LayerNorm as one kernel, and
// its feed-forward's first product with the bias and Mish as another (below,
// dense_mish), for Hopper (sm_90a), bound to Python with ctypes
// (models/encoder_epilogue.py).
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

#include <cuda.h>
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

// ---------------------------------------------------------------------------
// dense_mish: mish(x W + b), the feed-forward's first product with its bias
// and Mish as one kernel.
//
// Replaces no Pallas kernel: the JAX package has no encoder. It fuses the
// pair that follows the feed-forward's first product and the policy
// embedding in the encoder body's bf16 evaluator, torch.addmm (cuBLAS, its
// bias in the epilogue) and F.mish, 16 pairs a forward of BT4. For x bf16
// [rows][K], W bf16 (K, N) read from its packed image (models/
// encoder_epilogue.py:dense_image) and b bf16 [N]:
//   v[r, c]   = sum_k x[r, k] W[k, c] + b[c]       (f32 sums of bf16 products)
//   out[r, c] = bf16(v n / (n + 2)),  n = e^v (e^v + 2)
// which is v tanh(softplus(v)), taken in float32 on the accumulator and
// rounded to bf16 once (the pair rounds after the bias and again after
// Mish; mish4 below says how it is taken). The plain version is
// models/encoder_epilogue.py:dense_mish_plain.
//
// Bound on an H100 at 512 boards (32,768 rows), the feed-forward's K 1024
// -> N 1536: operations. 1.031e11 at 989 TFLOP/s take 0.104 ms; x read
// once, W and the output written once, 171 MB, take 0.051 ms at 3.35 TB/s.
// The pair moves 201 MB more: mish reads back the map addmm wrote and
// writes it again.
//   Design: the usual shape of a Hopper GEMM. A persistent grid, one block
// an SM, walks 128 x 256 tiles of the output (1,536 at 512 boards on 132
// SMs), N fastest, so the 6 tiles of a row block run side by side and x
// comes from device memory about once; the 3 MB image of W stays in L2.
// One producer thread keeps a ring of three stages filled, each a 64-deep
// slice of the tile's x rows (a TMA load of a 128 x 64 box, swizzled by
// the copy engine into the layout wgmma reads) and of W (a bulk copy of a
// 32 KB tile of the image, packed once in that layout), completing on the
// stage's "full" mbarrier. Two consumer warpgroups take 64 rows each as
// wgmma.mma_async m64n256k16 from shared memory into 128 float32
// accumulators a thread, the next slice's products issued before the last
// are waited for, and free each stage on its "empty" mbarrier. The
// epilogue adds the bias, takes Mish, rounds, and writes each warpgroup's
// 64 x 256 outputs by stmatrix into four swizzled 64 x 64 boxes in shared
// memory, which four TMA stores take to device memory while the next
// tile's products run (the producer has already filled the ring with its
// first slices). setmaxnreg gives the producer warpgroup 40 registers and
// the consumers 232. Rows past the end are read as zeros and not written
// (the TMA's bounds), so any row count runs.
//   Measured at 512 boards, N 1536 (one NVIDIA H100 80GB HBM3, 700 W; CUDA
// events over 50 queued launches, in turns): 0.170 ms, against 0.151 for
// cuBLAS's addmm alone and 0.245 for the addmm and mish pair; 0.146 with
// Mish left out. So the products run at cuBLAS's rate, and what is left is
// the epilogue, which the tensor cores wait for: Mish on the special
// function unit, about 2 us a tile. Tried and not kept: each pair of
// outputs stored from the registers as 4 bytes (0.210, and 0.153 with no
// stores at all: the stores, not the products, took the time), four stages
// with those stores (no faster than three), Mish with one exp2 and one
// reciprocal a value (0.175).
//
// The C entry encodes x's tensor map on the host at every launch (it is a
// kernel argument, so a captured launch keeps it); cuTensorMapEncodeTiled
// is looked up once through the runtime, which needs no link to the CUDA
// driver's library.

constexpr int kBM = 128;                 // a tile's rows: two warpgroups of 64
constexpr int kBN = 256;                 // its columns: one m64n256k16
constexpr int kBK = 64;                  // k a stage: one 128-byte row
constexpr int kStages = 3;
constexpr int kConsumers = 2;            // warpgroups
constexpr int kDenseThreads = 128 * (kConsumers + 1);   // and the producer's
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;       // 40 + 2 x 232 = 3 x 168
constexpr int kATile = kBM * kBK * 2;    // 16 KB
constexpr int kBTile = kBN * kBK * 2;    // 32 KB
constexpr int kCBox = 64 * 64 * 2;       // 8 KB: 64 rows of 64 outputs

struct DenseSmem {
  unsigned char a[kStages][kATile];      // 1024-byte aligned: the swizzle
  unsigned char b[kStages][kBTile];
  // a warpgroup's 64 x 256 outputs as four 64 x 64 boxes, 128-byte rows
  // swizzled, for its TMA stores
  unsigned char c[kConsumers][kBN / 64][kCBox];
  uint64_t full[kStages];                // a stage's x and W have landed
  uint64_t empty[kStages];               // every consumer warp has read it
};
constexpr int kDenseSmem = sizeof(DenseSmem) + 1024;   // and the alignment

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

// The box of the tensor map at (c0 innermost, c1) into shared memory,
// completing on the mbarrier; a box past the tensor's end reads zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar) : "memory");
}

// The box at (c0 innermost, c1) of the tensor map from shared memory; rows
// and columns past the tensor's end are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}],"
      " [%3];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(src)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Returns once the committed bulk stores have read their sources.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Returns once the committed bulk stores are done.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's writes to shared memory before later bulk copies.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of one warpgroup's 128 threads (named barrier 1 + wg).
__device__ __forceinline__ void warpgroup_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// Four 8 x 8 bf16 matrices into shared memory: lane l gives the address of
// row l % 8 of matrix l / 8, and holds columns 2 (l % 4), + 1 of row l / 4
// of each (the layout of an mma's accumulator).
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
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

// Keeps the compiler from moving uses of the accumulators across a
// wgmma's issue or wait.
__device__ __forceinline__ void fence_accumulators(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Descriptor of a K-major operand in 128-byte swizzled rows: eight rows
// are 1024 bytes (the stride offset); the leading offset is not used in
// this mode. The address must lie in a 1024-byte aligned tile; a k-step
// of 16 bf16 moves it by 32 bytes.
__device__ __forceinline__ uint64_t swizzled_kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 256 f32) += a (64 x 16 bf16) x b (16 x 256 bf16), both from
// shared memory.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b));
}

// Mish of four values in place: v n / (n + 2) with n = e^v (e^v + 2), e^v
// by the special function unit's exp2 at min(v, 10) (from 10 on n / (n + 2)
// rounds to 1 in float32), and the four reciprocals from one: 1 / d0 =
// d1 d2 d3 / (d0 d1 d2 d3), each d at most 4.9e8, so the product stays
// finite. The special function unit, at a sixteenth of the FMA rate, bounds
// the epilogue: one exp2 and a quarter of a reciprocal a value.
__device__ __forceinline__ void mish4(float* v) {
  float n[4], d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float e = __expf(fminf(v[i], 10.f));
    n[i] = e * (e + 2.f);
    d[i] = n[i] + 2.f;
  }
  const float d01 = d[0] * d[1], d23 = d[2] * d[3];
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d01 * d23));
  const float r01 = r * d23, r23 = r * d01;
  v[0] *= n[0] * (r01 * d[1]);
  v[1] *= n[1] * (r01 * d[0]);
  v[2] *= n[2] * (r23 * d[3]);
  v[3] *= n[3] * (r23 * d[2]);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(kDenseThreads, 1)
dense_mish_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap out_map,
                  const unsigned char* __restrict__ w_image,
                  const __nv_bfloat16* __restrict__ bias, int rows,
                  int k_tiles, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  DenseSmem& sm = *reinterpret_cast<DenseSmem*>(
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u));
  const int tiles = (rows + kBM - 1) / kBM * n_tiles;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(smem_addr(&sm.full[i]), 1);                // the producer
      mbar_init(smem_addr(&sm.empty[i]), 4 * kConsumers);  // every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();                      // the only block-wide barrier

  if (tid >= 128 * kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (tid == 128 * kConsumers) {
      int q = 0;                        // slices issued, over all tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * kBM;
        const unsigned char* src =
            w_image + (size_t)(tile % n_tiles) * k_tiles * kBTile;
        for (int kt = 0; kt < k_tiles; ++kt, ++q) {
          const int stage = q % kStages;
          if (q >= kStages)
            mbar_wait(smem_addr(&sm.empty[stage]), ((q / kStages) - 1) & 1);
          const uint32_t full = smem_addr(&sm.full[stage]);
          mbar_arrive_expect_tx(full, kATile + kBTile);
          tma_load_2d(smem_addr(sm.a[stage]), &x_map, kt * kBK, m0, full);
          bulk_copy(smem_addr(sm.b[stage]), src + (size_t)kt * kBTile,
                    kBTile, full);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg takes rows 64 wg .. + 63 of each tile. A
  // thread's accumulators 4 j + e and 4 j + 2 + e are row 16 warp + lane / 4
  // and that + 8, column 8 j + 2 (lane % 4) + e.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs));
  const int wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = tid & 31;
  // the staging row this lane addresses for stmatrix: row lane % 8 of
  // matrix lane / 8 (rows + 8 for odd matrices, the next 8 columns for the
  // last two); its 16-byte pieces lie at piece ^ (row % 8)
  const int mi = lane >> 3, ri = lane & 7;
  const uint32_t stage_row =
      smem_addr(sm.c[wg]) + (16 * warp + 8 * (mi & 1) + ri) * 128;
  int q = 0;                            // slices consumed, over all tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    fence_accumulators(acc);
    // one group of wgmma a slice, the next issued before the last is
    // waited for, then that slice's stage freed
    for (int kt = 0; kt < k_tiles; ++kt, ++q) {
      const int stage = q % kStages;
      mbar_wait(smem_addr(&sm.full[stage]), (q / kStages) & 1);
      const uint64_t da =
          swizzled_kmajor_desc(smem_addr(sm.a[stage]) + wg * (kATile / 2));
      const uint64_t db = swizzled_kmajor_desc(smem_addr(sm.b[stage]));
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks)
        wgmma_m64n256k16(acc, da + 2 * ks, db + 2 * ks);
      wgmma_commit();
      if (kt > 0) {
        wgmma_wait<1>();
        if (lane == 0)
          mbar_arrive(smem_addr(&sm.empty[(q - 1) % kStages]));
      }
    }
    wgmma_wait<0>();
    fence_accumulators(acc);
    if (lane == 0) mbar_arrive(smem_addr(&sm.empty[(q - 1) % kStages]));

    // the epilogue: bias and Mish in float32, bf16 into the staging boxes
    // (once the last tile's stores have read them), then four TMA stores
    // that run on while the next tile's products do
    const int m0 = tile / n_tiles * kBM + 64 * wg;
    const int n0 = tile % n_tiles * kBN;
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(
        bias + n0 + 2 * (lane % 4));
    if (t == 0) bulk_wait_read();
    warpgroup_barrier(wg);
#pragma unroll
    for (int j = 0; j < kBN / 8; j += 2) {
      const float2 b0 = __bfloat1622float2(__ldg(b2 + 4 * j));
      const float2 b1 = __bfloat1622float2(__ldg(b2 + 4 * j + 4));
      const float* a0 = acc + 4 * j;
      const int jj = j + (mi >> 1);     // this lane's 8 columns: 8 jj ..
      float v[8] = {a0[0] + b0.x, a0[1] + b0.y, a0[2] + b0.x, a0[3] + b0.y,
                    a0[4] + b1.x, a0[5] + b1.y, a0[6] + b1.x, a0[7] + b1.y};
      mish4(v);
      mish4(v + 4);
      stmatrix_x4(stage_row + (jj >> 3) * kCBox + (((jj & 7) ^ ri) << 4),
                  pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]),
                  pack(v[6], v[7]));
    }
    fence_async_shared();
    warpgroup_barrier(wg);
    if (t == 0 && m0 < rows) {
#pragma unroll
      for (int c = 0; c < kBN / 64; ++c)
        tma_store_2d(&out_map, smem_addr(sm.c[wg][c]), n0 + 64 * c, m0);
      bulk_commit();
    }
  }
  if (t == 0) bulk_wait();
}

// cuTensorMapEncodeTiled, looked up once by dense_mish_init
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled = nullptr;

// The tensor map of a bf16 [rows][cols] matrix at p, read or written in
// boxes of box_rows x box_cols (128 bytes a row) with the 128-byte swizzle.
bool encode_rows(CUtensorMap* map, const void* p, long long rows, int cols,
                 int box_cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                      const_cast<void*>(p), dims, strides, box, step,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// Once a device, before the first launch: the multiprocessor count (the
// persistent grid), the kernel's shared memory opt-in, and the CUDA
// driver's tensor-map encoder.
int dense_mish_init(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dense_mish_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDenseSmem);
  if (err == cudaSuccess && encode_tiled == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                           12000, cudaEnableDefault, &found);
#else
    err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                  cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found != cudaDriverEntryPointSuccess)
      err = cudaErrorSymbolNotFound;
    if (err == cudaSuccess) encode_tiled = reinterpret_cast<EncodeTiled>(fn);
  }
  return (int)err;
}

// x: bf16 [rows][k]; w_image: W (k, n) packed by models/encoder_epilogue.py:
// dense_image; bias: bf16 [n]; out: bf16 [rows][n]; all contiguous and
// 16-byte aligned. k must be a multiple of 64 and n of 256; sms is
// dense_mish_init's count. out may not alias x.
int dense_mish_bf16(const void* x, const void* w_image, const void* bias,
                    void* out, long long rows, int k, int n, int sms,
                    void* stream) {
  if (rows < 0 || rows > 0x7fffff00LL || k <= 0 || k % kBK || n <= 0 ||
      n % kBN || sms < 1 || encode_tiled == nullptr)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  CUtensorMap x_map, out_map;
  if (!encode_rows(&x_map, x, rows, k, kBK, kBM) ||
      !encode_rows(&out_map, out, rows, n, 64, 64))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (rows + kBM - 1) / kBM * (n / kBN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = tiles < sms ? (int)tiles : sms;
  dense_mish_kernel<<<grid, kDenseThreads, kDenseSmem,
                      (cudaStream_t)stream>>>(
      x_map, out_map, static_cast<const unsigned char*>(w_image),
      static_cast<const __nv_bfloat16*>(bias), (int)rows, k / kBK, n / kBN);
  return (int)cudaGetLastError();
}

}  // extern "C"
