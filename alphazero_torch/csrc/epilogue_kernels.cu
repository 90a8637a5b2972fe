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
// multiply and the two adds). The sums of the pool and of the two dense
// layers are the kernel's own: taken in float64, in a fixed order, and
// rounded through float32, as the plain version's f64_sums takes them. (In
// float32 a sum of 256 products may round to the neighbouring bf16 value,
// which the next layers carry past one step: tests/test_torch_epilogue.py
// finds one such board among 1031 at C = 256.)
//   Bound on an H100 at 512 boards, C = 128: bytes. y and x read and out
// written once, 25.2 MB, take 0.0075 ms; the SE's arithmetic is some 5,000
// operations a board. Design: persistent blocks, one an SM, each walking
// over every grid-th board with up to four warpgroups; a warpgroup takes
// every fourth board of its block and syncs only its own 128 threads (named
// barriers), so boards of one block never wait on each other. Thread t of a
// warpgroup keeps one channel group g = t % G (G = C / 8) for every board:
// its rows r0 + R k (r0 = t / G, R = min(128 / G, 64)) of y come straight
// from device memory into its registers, all its 16-byte loads in flight at
// once (the first board's before the block sets up), and stay there; bn2's
// constants for g sit in registers too, and its eight column sums grow as
// the rows pass; the R partial sums of a column then add in four fixed
// chains. x, read last, comes by a bulk async copy (cp.async.bulk: a board's
// x is one contiguous span of 128 C bytes) into the warpgroup's own ring of
// stages in shared memory, asked for by its thread 0 `own` boards ahead and
// completing the stage's mbarrier, so it lands while the board is pooled and
// excited. The SE weights come once a block, by two more bulk copies. fc1
// takes a group of adjacent lanes a hidden unit (two chains, then a shuffle
// tree), fc2 one thread an output (two chains of H / 2), and the output
// reads each vector of x from the stage and computes two channels an
// instruction in bf16x2 (each operation rounded once, as the f32 operation
// and its rounding to bf16 would), writing 16-byte vectors. Every sum's
// order depends on C and H alone, so a board's result depends on its own
// inputs only: not on the batch, the block or the warpgroup that takes it.
// The net's widths (C 128, H 16; C 256, H 32) have their own instantiations
// with C and H fixed at compile time, so that the dense layers' loops unroll
// in full; any other C and H run the same code with them at run time.
// Warpgroups and stages are sized from B, C and H at launch
// (models/epilogue.py:se_launch_shape): at C = 128, H = 16 and 512 boards
// four warpgroups with a stage each (117,504 bytes); at C = 256, H = 32 two
// with two stages each (203,520 bytes of the 232,448 a block may opt in
// to). C is at most 256, since a thread holds at most 16 vectors of y
// (KMAX), and H at most 32.
//
// The entry points launch on the given stream and return
// cudaGetLastError(); they never synchronise, allocate nothing and query
// nothing of the device: the multiprocessor count comes from
// se_residual_init, called once a device before the first launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;             // bn_act's block

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

// Shared memory, PTX helpers of the bulk copies and their barriers

// a block's dynamic shared memory after the opt-in (an H100 SM's 228 KB,
// less the 1 KB the hardware keeps per block)
constexpr int kSmemOptIn = 232448;
constexpr int kBarBytes = 256;          // the mbarriers, at the front

__host__ __device__ constexpr int align_up(int n, int a) {
  return (n + a - 1) / a * a;
}

// A block's shared memory, in bytes from its start: the mbarriers; the SE
// weights w1 [C][H] at kBarBytes and w2 [H][2C] at w2 (bf16); each
// warpgroup's scratch at scratch + wave * scratch_bytes (f64: 1024 partial
// column sums, pooled [C] and hidden [H]; then bf16 gate [C] at gate and
// shift [C] after it); the stages at stages, each a board's x (bf16, 128 C
// bytes). models/epilogue.py:se_smem_bytes computes `total` the same way.
struct SeLayout {
  int w2, scratch, gate, scratch_bytes, stages, total;
};

__host__ __device__ inline SeLayout se_layout(int C, int H, int waves,
                                              int stages) {
  SeLayout l;
  l.w2 = kBarBytes + align_up(2 * C * H, 16);
  l.scratch = l.w2 + align_up(4 * C * H, 16);
  l.gate = align_up(8 * (1024 + C + H), 16);
  l.scratch_bytes = l.gate + 4 * C;
  l.stages = align_up(l.scratch + waves * l.scratch_bytes, 128);
  l.total = l.stages + stages * 128 * C;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Returns once the barrier's phase of the given parity has completed. A
// wait that cannot end (a fault in this kernel) traps after some 2^24
// tries, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}

// One contiguous span from device memory into shared memory; its bytes
// count against the mbarrier's expected transactions.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// the 128 threads of one warpgroup; barrier 0 is __syncthreads'
__device__ __forceinline__ void wave_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// Two bf16 lanes at a time, each result rounded to nearest even once. On
// bf16 operands these are the f32 operation and its rounding to bf16: a
// product of two bf16 values is exact in f32, and a sum of two is rounded
// the same whether or not f32 rounds it first.
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// torch.relu's, lane by lane: NaN stays NaN
__device__ __forceinline__ uint32_t bf2_relu(uint32_t a) {
  uint32_t d;
  asm("max.NaN.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(0u));
  return d;
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
  int waves;                            // warpgroups a block
  int own;                              // stages a warpgroup
};

// A thread's rows of a board: the row sets R = min(128 / G, 64) of the G
// channel groups, and the rows of its set, ceil(64 / R)
__host__ __device__ inline int se_row_sets(int C) {
  const int G = C / 8;
  return 128 / G < 64 ? 128 / G : 64;
}

// the vectors of y' a thread holds, rounded up to a power of two
inline int se_kmax(int C) {
  const int R = se_row_sets(C);
  const int K = (64 + R - 1) / R;
  int k = 1;
  while (k < K) k *= 2;
  return k;
}

// warpgroups a block at most: four, or two where a thread holds 16
// vectors of y', which needs more registers than 512 threads may have
template <int KMAX>
constexpr int se_max_waves() { return KMAX <= 8 ? 4 : 2; }

__device__ __forceinline__ double shfl_xor(double v, int lane_mask) {
  return __shfl_xor_sync(0xffffffffu, v, lane_mask);
}

// CC and HH: C and H fixed at compile time (the loops then unroll in full),
// or 0 for any C and H of KMAX
template <int KMAX, int CC, int HH>
__global__ void __launch_bounds__(128 * se_max_waves<KMAX>(), 1)
    se_residual_kernel(SeArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = CC ? CC : a.C, H = HH ? HH : a.H;
  const int own = a.own, tid = threadIdx.x;
  const int S = a.waves * own;
  const SeLayout L = se_layout(C, H, a.waves, S);
  const int wave = tid >> 7, t = tid & 127, bar_id = 1 + wave;
  // This thread's roles, the same for every board: channel group g of
  // rows r0 + R k (the pool and the output); lane l of the `lanes` that
  // sum hidden unit j (fc1); outputs t + 128 q (fc2).
  const int G = C / 8, R = se_row_sets(C);
  const int g = t % G, r0 = t / G;
  const int K = t < G * R ? (64 - r0 + R - 1) / R : 0;

  // This warpgroup's i-th board is the block's board n = wave + waves i,
  // the grid's blockIdx.x + n gridDim.x. Its y goes straight from device
  // memory into the registers of the threads that pool it, 16-byte
  // vectors all in flight at once (the first board's before anything
  // else, so that they land while the block sets up); its x, read last,
  // comes by a bulk async copy into stage wave own + i % own, asked for
  // `own` boards ahead by the warpgroup's thread 0, and completes the
  // stage's mbarrier. Warpgroup 0's thread 0 also asks for the weights.
  auto board_of = [&](int i) {
    return blockIdx.x + ((long long)wave + (long long)a.waves * i) *
                            gridDim.x;
  };
  uint4 yv[KMAX];
  auto load_y = [&](int i) {
    const uint4* src = reinterpret_cast<const uint4*>(a.y) +
                       board_of(i) * 8 * C + r0 * G + g;
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      if (k < K) yv[k] = __ldg(src + R * k * G);
  };
  if (board_of(0) < a.boards) load_y(0);

  // the constants of this thread's roles, while y is in flight
  unsigned char* scratch = smem + L.scratch + wave * L.scratch_bytes;
  double* red = reinterpret_cast<double*>(scratch);
  double* pooled = red + 1024;
  double* hidden = pooled + C;
  __nv_bfloat16* gate = reinterpret_cast<__nv_bfloat16*>(scratch + L.gate);
  __nv_bfloat16* shift = gate + C;
  const bool has_affine = a.mean != nullptr;
  float am[8], ak[8], ab[8];
  if (has_affine) {
    load8(a.mean + 8 * g, am);
    load8(a.mul + 8 * g, ak);
    load8(a.beta + 8 * g, ab);
  }
  int lanes = 32;
  while (lanes * H > 128) lanes >>= 1;
  const int j = t / lanes, l = t % lanes;
  // the biases stay bf16 until used: converting them here would wait for
  // their loads before the block's set-up
  const __nv_bfloat16 b1j = a.b1[j < H ? j : 0];
  __nv_bfloat16 b2o[4];                 // 2C / 128 outputs at most
#pragma unroll
  for (int q = 0; q < 4; ++q)
    b2o[q] = a.b2[t + 128 * q < 2 * C ? t + 128 * q : 0];
  auto w = [](const __nv_bfloat16* p) {
    return (double)__bfloat162float(*p);
  };

  uint64_t* x_full = reinterpret_cast<uint64_t*>(smem);   // a stage's x
  uint64_t* w_full = x_full + S;                          // the weights
  const __nv_bfloat16* w1 =
      reinterpret_cast<const __nv_bfloat16*>(smem + kBarBytes);
  const __nv_bfloat16* w2 =
      reinterpret_cast<const __nv_bfloat16*>(smem + L.w2);
  const int board_bytes = 128 * C;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(smem_addr(&x_full[s]), 1);
    mbar_init(smem_addr(w_full), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();                      // the only block-wide barrier

  auto stage = [&](int i) {
    return smem + L.stages + (wave * own + i % own) * board_bytes;
  };
  auto fetch_x = [&](int i) {
    const uint32_t bar = smem_addr(&x_full[wave * own + i % own]);
    mbar_arrive_expect_tx(bar, board_bytes);
    bulk_copy(smem_addr(stage(i)), a.x + board_of(i) * 64 * C, board_bytes,
              bar);
  };
  if (t == 0) {
    if (wave == 0) {
      const uint32_t bar = smem_addr(w_full);
      mbar_arrive_expect_tx(bar, 6 * C * H);
      bulk_copy(smem_addr(w1), a.w1, 2 * C * H, bar);
      bulk_copy(smem_addr(w2), a.w2, 4 * C * H, bar);
    }
    for (int i = 0; i < own && board_of(i) < a.boards; ++i) fetch_x(i);
  }

  for (int i = 0;; ++i) {
    const long long board = board_of(i);
    if (board >= a.boards) break;
    const int s = wave * own + i % own;
    const uint32_t parity = (i / own) & 1;
    const uint4* xs = reinterpret_cast<const uint4*>(stage(i));

    // y' in registers, this thread's eight column sums as its rows pass
    // (f32, a few bf16 terms), then in f64 with the other row sets'
    if (i > 0) load_y(i);
    float cs[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) cs[e] = 0.0f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&yv[k]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (has_affine) {
            const float2 f = __bfloat1622float2(e[q]);
            e[q] = __floats2bfloat162_rn(
                affine(f.x, am[2 * q], ak[2 * q], ab[2 * q]),
                affine(f.y, am[2 * q + 1], ak[2 * q + 1], ab[2 * q + 1]));
          }
          const float2 f = __bfloat1622float2(e[q]);
          cs[2 * q] += f.x;
          cs[2 * q + 1] += f.y;
        }
      }
    }
    if (t < G * R) {                    // red[r0][8g + e]
      double2* dst = reinterpret_cast<double2*>(red + 8 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[e] = make_double2(cs[2 * e], cs[2 * e + 1]);
    }
    wave_sync(bar_id);

    // the pool: a column's R partial sums in four chains, then their sum
    for (int c = t; c < C; c += 128) {
      double p0 = 0.0, p1 = 0.0, p2 = 0.0, p3 = 0.0;
#pragma unroll
      for (int r = 0; r < R; r += 4) {
        p0 += red[r * C + c];
        if (r + 1 < R) p1 += red[(r + 1) * C + c];
        if (r + 2 < R) p2 += red[(r + 2) * C + c];
        if (r + 3 < R) p3 += red[(r + 3) * C + c];
      }
      pooled[c] = (double)round_bf16(
          __double2float_rn(((p0 + p1) + (p2 + p3)) * (1.0 / 64.0)));
    }
    wave_sync(bar_id);

    // fc1: hidden unit j on lanes j*lanes .. +lanes of one warp, each lane
    // two chains over its inputs (l, l + 2 lanes, ... and l + lanes, l + 3
    // lanes, ...), then a shuffle tree; every thread runs the shuffles, so
    // the full mask holds
    if (i == 0) mbar_wait(smem_addr(w_full), 0);
    {
      double s0 = 0.0, s1 = 0.0;
      if (j < H) {
        int c = l;
#pragma unroll
        for (; c + lanes < C; c += 2 * lanes) {
          s0 = fma(pooled[c], w(w1 + c * H + j), s0);
          s1 = fma(pooled[c + lanes], w(w1 + (c + lanes) * H + j), s1);
        }
        if (c < C) s0 = fma(pooled[c], w(w1 + c * H + j), s0);
      }
      double sum = s0 + s1;
#pragma unroll
      for (int off = lanes >> 1; off > 0; off >>= 1)
        sum += shfl_xor(sum, off);
      if (j < H && l == 0)
        hidden[j] = (double)relu(round_bf16(__fadd_rn(
            round_bf16(__double2float_rn(sum)), __bfloat162float(b1j))));
    }
    wave_sync(bar_id);

    // fc2, then the gate and the shift: output o in two chains over H (the
    // even and the odd hidden units)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = t + 128 * q;
      if (o < 2 * C) {
        double s0 = 0.0, s1 = 0.0;
        int k = 0;
#pragma unroll
        for (; k + 1 < H; k += 2) {
          s0 = fma(hidden[k], w(w2 + k * 2 * C + o), s0);
          s1 = fma(hidden[k + 1], w(w2 + (k + 1) * 2 * C + o), s1);
        }
        if (k < H) s0 = fma(hidden[k], w(w2 + k * 2 * C + o), s0);
        const float gv = round_bf16(__fadd_rn(
            round_bf16(__double2float_rn(s0 + s1)), __bfloat162float(b2o[q])));
        if (o < C)
          gate[o] = __float2bfloat16_rn(1.0f / (1.0f + expf(-gv)));
        else
          shift[o - C] = __float2bfloat16_rn(gv);
      }
    }
    wave_sync(bar_id);

    // out = relu(y' * gate + shift + x), two channels an instruction, each
    // operation rounded to bf16
    const uint4 gt = reinterpret_cast<const uint4*>(gate)[g];
    const uint4 sh = reinterpret_cast<const uint4*>(shift)[g];
    const uint32_t* gw = reinterpret_cast<const uint32_t*>(&gt);
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(&sh);
    uint4* ov = reinterpret_cast<uint4*>(a.out) + board * 8 * C;
    mbar_wait(smem_addr(&x_full[s]), parity);
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const int v = (r0 + R * k) * G + g;
        const uint4 xx = xs[v];
        const uint32_t* yw = reinterpret_cast<const uint32_t*>(&yv[k]);
        const uint32_t* xw = reinterpret_cast<const uint32_t*>(&xx);
        uint4 res;
        uint32_t* o = reinterpret_cast<uint32_t*>(&res);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          o[q] = bf2_relu(
              bf2_add(bf2_add(bf2_mul(yw[q], gw[q]), sw[q]), xw[q]));
        ov[v] = res;
      }
    }

    // the stage is read: the x of the board `own` ahead goes into it
    if (board_of(i + own) < a.boards) {
      wave_sync(bar_id);
      if (t == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        fetch_x(i + own);
      }
    }
  }
}

template <int KMAX, int CC = 0, int HH = 0>
int se_launch(const SeArgs& a, int grid, int smem, cudaStream_t stream) {
  if (a.waves > se_max_waves<KMAX>()) return (int)cudaErrorInvalidValue;
  se_residual_kernel<KMAX, CC, HH>
      <<<grid, 128 * a.waves, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int KMAX, int CC = 0, int HH = 0>
cudaError_t se_opt_in() {
  return cudaFuncSetAttribute(se_residual_kernel<KMAX, CC, HH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemOptIn);
}

}  // namespace

extern "C" {

// Once a device, before its first launch and outside any stream capture:
// lets every se_residual_kernel take the block's opt-in shared memory, and
// gives the device's multiprocessor count, which sizes both kernels' grids.
int se_residual_init(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = se_opt_in<1>();
  if (err == cudaSuccess) err = se_opt_in<2>();
  if (err == cudaSuccess) err = se_opt_in<4>();
  if (err == cudaSuccess) err = se_opt_in<8>();
  if (err == cudaSuccess) err = se_opt_in<16>();
  if (err == cudaSuccess) err = se_opt_in<8, 128, 16>();
  if (err == cudaSuccess) err = se_opt_in<16, 256, 32>();
  return (int)err;
}

// y, out: bf16 NHWC maps of `elements` values, C channels innermost, 16-byte
// aligned; mean, mul, beta: f32 [C], 16-byte aligned. C is a multiple of 8;
// sms the device's multiprocessors.
int bn_act_bf16(const void* y, const void* mean, const void* mul,
                const void* beta, void* out, long long elements, int C,
                int sms, void* stream) {
  if (C <= 0 || C % 8 != 0 || elements < 0 || elements % C != 0 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const long long vectors = elements / 8;
  if (vectors == 0) return (int)cudaGetLastError();
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
// b2 [2C]: bf16, w1 and w2 16-byte aligned. C a multiple of 8 up to 256, H
// from 1 to 32. grid blocks of `waves` warpgroups, with `stages` stages a
// block, a multiple of waves (models/epilogue.py:se_launch_shape), whose
// layout fits in the opt-in shared memory; se_residual_init has run on
// the device.
int se_residual_bf16(const void* y, const void* x, void* out,
                     const void* mean, const void* mul, const void* beta,
                     const void* w1, const void* b1, const void* w2,
                     const void* b2, int boards, int C, int H, int grid,
                     int waves, int stages, void* stream) {
  if (boards < 0 || C <= 0 || C % 8 != 0 || C > 256 || H <= 0 || H > 32 ||
      grid <= 0 || waves <= 0 || stages <= 0 || stages % waves != 0 ||
      (mean == nullptr) != (mul == nullptr) ||
      (mean == nullptr) != (beta == nullptr))
    return (int)cudaErrorInvalidValue;
  const int smem = se_layout(C, H, waves, stages).total;
  if (smem > kSmemOptIn || stages + 1 > kBarBytes / 8)
    return (int)cudaErrorInvalidValue;
  if (boards == 0) return (int)cudaGetLastError();
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
                 boards, C, H, waves, stages / waves};
  const cudaStream_t st = (cudaStream_t)stream;
  // the archived net's widths, and 256 filters at se_ratio 8
  if (C == 128 && H == 16) return se_launch<8, 128, 16>(a, grid, smem, st);
  if (C == 256 && H == 32) return se_launch<16, 256, 32>(a, grid, smem, st);
  switch (se_kmax(C)) {
    case 1: return se_launch<1>(a, grid, smem, st);
    case 2: return se_launch<2>(a, grid, smem, st);
    case 4: return se_launch<4>(a, grid, smem, st);
    case 8: return se_launch<8>(a, grid, smem, st);
    default: return se_launch<16>(a, grid, smem, st);
  }
}

}  // extern "C"
