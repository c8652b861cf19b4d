// The pipelined, register-blocked fp32 tile kernel of the decoder's row
// products, for Hopper (sm_90a): K4's LSTM cell and the h W2 product that K3
// and K4 hoist out of their attention. For a block tile of BM batch rows x
// BN units it computes
//
//   Y = [in0 | in1 | in2] W + bias                 (widths k0, k1, k2; K)
//
// with W's rows [0, ka) in wa and [ka, K) in wb, each of ld = G N columns,
// and one of two epilogues:
//   G = 4  the Keras LSTM cell: gate g of unit n at column g N + n, gates
//          [i | f | g | o]; reads the cell state from c_in, writes c' to
//          c_out, h' to out and, where z_out is not null, the gates'
//          pre-activations x W + bias to z_out (B, 4N);
//   G = 1  a dense layer: out = act(x W + bias, slope) (slope 1: identity).
//
// What bounds it. At K4's wide shape (B 256, U 2048, K 3200) a step's cell
// is 13.4 GFLOP of fp32 FMAs over 105 MB of Wx and Wh, more than the 50 MB
// L2: step_kernels.cuh's rows_kernel, 8 rows a block, streamed them once per
// 8 rows (3.4 GB a step) with every thread waiting on its own loads. Here a
// block takes 128 rows, so the weights stream twice a step, and the grid
// (2 x 64 blocks) fills the 132 SMs: the step is bound by the FMAs
// (~0.2 ms at 67 TFLOP/s) more than by the bytes (~63 us). At flagship
// (B 64, U 512) the step is 0.28 GFLOP: a wave of 128 blocks leaves each SM
// 256 of the batch's (row, unit) pairs, too few to fill its warps with
// register tiles, and the time goes to latency.
//
// The design. K is consumed a chunk at a time through a ring of STAGES
// shared-memory stages, each holding the chunk of X (the block's BM rows)
// and of W (the chunk's rows of G BN floats, the block's units of each gate
// side by side); STAGES - 1 chunks are in flight while the block computes
// on one. Each thread owns TM rows x TN units x G gates in registers and
// forms outer products from shared memory. Each tile has one feed:
//   - tile_kernel_tma, the one-slice tile of large batches: thread 0 issues
//     two bulk tensor copies a chunk of BK, X from its segment's (k_s, B)
//     map and W from a (N, G, rows) map of wa or wb, completing on the
//     stage's mbarrier; rows past B read as zeros. Every gate of a thread's
//     units is in its registers and the epilogue runs there. A chunk's
//     products are summed apart and then added to the total (two-level),
//     which keeps the rounding of K = 3200 near that of a chunk plus K / BK
//     partial sums. The feed needs every segment width (so ka) to be a
//     multiple of BK, N a multiple of 4 and 16-byte bases; a launch that
//     cannot have it fails. A per-thread feed cost the wide cell a third of
//     its time: each thread's 16-byte copies, with their address
//     arithmetic, did not hide under its FMAs.
//   - tile_kernel, the sliced tiles of small batches: every thread copies
//     its share by cp.async, 16 bytes where the caller says the widths and
//     bases allow (W, X), else 4; rows past B, units past N and K past its
//     end are zero-filled (src-size 0), and X rows are padded to BK + 4
//     floats. S slices of the block's threads split K by class, slice s
//     taking every k = s mod S, each in one fp32 chain; the slices' sums
//     meet in shared memory, where every thread of the block adds up one
//     (row, unit)'s in slice order, from zero, and applies the epilogue (so
//     the cell's transcendentals are spread over the whole block). A chunk
//     is BK less BK mod lcm(S, 4) k, so that every chunk starts on class 0
//     and on a 16-byte boundary. That is the order in which the kernels K2
//     runs sum the same products: rows_kernel in kKSlices classes and
//     block_vecmat, where it splits a column (N <= kThreads / 2), in
//     kThreads / N (ops/tiles.py sets S so), and so K4 on K2's words
//     reproduces K2's alphas bit for bit. S slices also give an SM S times
//     the warps to hide L2 latency with; a single chain over K (S = 1)
//     left a dense tile latency-bound, so where block_vecmat does not split
//     a column S is kKSlices as well.
//
// The tile, its feed and S are chosen in Python (ops/tiles.py: TILES is
// kTiles below, in order); tile_prepare refuses an index it does not know
// or of the wrong kind, and tile_launch refuses a feed or an S the tile
// does not have, 16-byte copies where the widths or bases do not allow
// them, and TMA maps that cannot be encoded. Nothing falls back to another
// kernel. All math is fp32 with fp32 accumulation. Kernels allocate
// nothing.

#pragma once

#include <cuda.h>            // CUtensorMap
#include <cudaTypedefs.h>    // PFN_cuTensorMapEncodeTiled
#include <cuda_runtime.h>

#include <cstdint>

#include "step_kernels.cuh"

namespace {

// the feed of a launch (ops/tiles.py's FEED_*)
constexpr int kFeedW16 = 1;    // cp.async: W by 16-byte copies, else 4
constexpr int kFeedX16 = 2;    // cp.async: X by 16-byte copies, else 4
constexpr int kFeedTMA = 4;    // TMA: the one-slice tile's feed

struct TileArgs {
  const float* in0;
  const float* in1;
  const float* in2;
  int k0, k1, k2;
  const float* wa;
  const float* wb;
  int ka;
  const float* bias;   // (G N,)
  int B, N;
  float slope;         // dense epilogue
  float* out;          // (B, N)
  float* c_out;        // (B, N), LSTM
  const float* c_in;   // (B, N), LSTM
  float* z_out;        // (B, 4N), LSTM, or null
  int feed;            // kFeed* bits (set by tile_launch)
  int slices;          // S, the sliced tiles' k classes (tile_launch)
  int chunk;           // k a chunk of the sliced tiles (tile_launch)
};

// the TMA feed's maps: in0, in1, in2 as (k_s, B); wa, wb as (N, G, rows)
struct TileMaps {
  CUtensorMap x[3];
  CUtensorMap w[2];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// x[m, k] of [in0 | in1 | in2]
__device__ __forceinline__ const float* x_at(const TileArgs& a, int m,
                                             int k) {
  if (k < a.k0) return a.in0 + (size_t)m * a.k0 + k;
  k -= a.k0;
  if (k < a.k1) return a.in1 + (size_t)m * a.k1 + k;
  return a.in2 + (size_t)m * a.k2 + (k - a.k1);
}

// W's row k
__device__ __forceinline__ const float* w_row(const TileArgs& a, int k,
                                              size_t ld) {
  return k < a.ka ? a.wa + (size_t)k * ld : a.wb + (size_t)(k - a.ka) * ld;
}

// n consecutive floats from shared memory (16-byte aligned for 4 and 8)
template <int n>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int i = 0; i < n; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else if constexpr (n == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// an int known at compile time (a chunk of BK k)
template <int V>
struct Fixed {
  __host__ __device__ constexpr operator int() const { return V; }
};

// One k's outer product for a thread: its TM rows' x (rows XS floats apart
// from xs) times its TN units of each gate (gates BN apart from ws).
template <int G, int BN, int TM, int TN, int XS>
__device__ __forceinline__ void k_product(const float* xs, const float* ws,
                                          float (&acc)[TM][G][TN]) {
  float x[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) x[i] = xs[i * XS];
  float w[G][TN];
#pragma unroll
  for (int g = 0; g < G; ++g) load_vec<TN>(ws + g * BN, w[g]);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][g][j] = fmaf(x[i], w[g][j], acc[i][g][j]);
}

// The epilogue for row m and unit n, given their G sums x W (no bias):
// the LSTM cell or the dense layer's activation. Rows past B and units
// past N write nothing.
template <int G>
__device__ __forceinline__ void epilogue(const TileArgs& a, int m, int n,
                                         const float* s) {
  if (m >= a.B || n >= a.N) return;
  const size_t o = (size_t)m * a.N + n;
  if constexpr (G == 4) {
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) z[g] = s[g] + a.bias[(size_t)g * a.N + n];
    if (a.z_out != nullptr) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        a.z_out[(size_t)m * 4 * a.N + (size_t)g * a.N + n] = z[g];
    }
    const float cn = sigmoid(z[1]) * a.c_in[o] + sigmoid(z[0]) * tanhf(z[2]);
    a.c_out[o] = cn;
    a.out[o] = sigmoid(z[3]) * tanhf(cn);
  } else {
    a.out[o] = lrelu(s[0] + a.bias[n], a.slope);
  }
}

// The sliced tiles' kernel, fed by cp.async. Block a.slices x (BM / TM) x
// (BN / TN) threads, flat, at most KS slices; grid (ceil(N / BN),
// ceil(B / BM)). Shared memory: TileConfig::smem.
template <int G, int BM, int BN, int TM, int TN, int BK, int STAGES, int KS>
__global__ void __launch_bounds__(KS * (BM / TM) * (BN / TN))
tile_kernel(TileArgs a) {
  constexpr int TX = BN / TN, ST = TX * (BM / TM);
  constexpr int E = TM * G * TN;               // sums a thread
  static_assert(BK % 4 == 0 && BN % 4 == 0 && BN % TN == 0 &&
                    BM % TM == 0 && (TN <= 2 || TN == 4) && ST % 32 == 0,
                "tile shape");
  constexpr int XS = BK + 4;                   // X stage: BM rows of BK
  constexpr int XSIZE = BM * XS;
  constexpr int WC = G * BN;                   // W stage: BK rows of G BN
  constexpr int STAGE = XSIZE + BK * WC;
  static_assert(KS * BM * BN * G <= STAGES * STAGE, "reduction");
  extern __shared__ __align__(16) float tile_sm[];
  const int S = a.slices, NT = S * ST, BKC = a.chunk;
  const int tid = threadIdx.x, ks = tid / ST, sid = tid % ST;
  const int tx = sid % TX, ty = sid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int K = a.k0 + a.k1 + a.k2;
  const int chunks = (K + BKC - 1) / BKC;
  const size_t ld = (size_t)G * a.N;

  // a chunk's copies; bkc is BKC, a compile-time BK where they are equal
  // (S a power of two), so that the copies' index arithmetic folds
  auto load = [&](int chunk, auto bkc) {
    float* xs = tile_sm + (chunk % STAGES) * STAGE;
    float* ws = xs + XSIZE;
    const int kc = chunk * bkc;
    if (a.feed & kFeedX16) {
      for (int i = tid; i < BM * (bkc / 4); i += NT) {
        const int r = i / (bkc / 4), q = (i % (bkc / 4)) * 4;
        const int m = m0 + r, k = kc + q;
        const bool in = m < a.B && k < K;
        cp_async16(xs + r * XS + q, in ? x_at(a, m, k) : a.in0, in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < BM * bkc; i += NT) {
        const int r = i / bkc, q = i % bkc;
        const int m = m0 + r, k = kc + q;
        const bool in = m < a.B && k < K;
        cp_async4(xs + r * XS + q, in ? x_at(a, m, k) : a.in0, in ? 4 : 0);
      }
    }
    if (a.feed & kFeedW16) {
      for (int i = tid; i < bkc * (WC / 4); i += NT) {
        const int kr = i / (WC / 4), col = (i % (WC / 4)) * 4;
        const int g = col / BN, n = n0 + col % BN, k = kc + kr;
        const bool in = k < K && n < a.N;
        cp_async16(ws + kr * WC + col,
                   in ? w_row(a, k, ld) + (size_t)g * a.N + n : a.wa,
                   in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < bkc * WC; i += NT) {
        const int kr = i / WC, col = i % WC;
        const int g = col / BN, n = n0 + col % BN, k = kc + kr;
        const bool in = k < K && n < a.N;
        cp_async4(ws + kr * WC + col,
                  in ? w_row(a, k, ld) + (size_t)g * a.N + n : a.wa,
                  in ? 4 : 0);
      }
    }
  };
  auto load_chunk = [&](int chunk) {
    if (BKC == BK)
      load(chunk, Fixed<BK>{});
    else
      load(chunk, BKC);
  };

  float acc[TM][G][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][g][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks) load_chunk(s);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();   // chunk c has landed
    __syncthreads();               // ... for every thread; chunk c - 1 done
    if (c + STAGES - 1 < chunks) load_chunk(c + STAGES - 1);
    cp_async_commit();             // (an empty group keeps the count)

    // this slice's class of the chunk: BKC is a multiple of S, so the
    // chunk's k = ks mod S are the slice's k, in order
    const float* xs = tile_sm + (c % STAGES) * STAGE + ty * TM * XS;
    const float* ws = tile_sm + (c % STAGES) * STAGE + XSIZE + tx * TN;
#pragma unroll 4
    for (int kk = ks; kk < BKC; kk += S)
      k_product<G, BN, TM, TN, XS>(xs + kk, ws + kk * WC, acc);
  }
  cp_async_wait<0>();

  // The slices' sums meet in shared memory; then every thread of the
  // block adds up one (row, unit)'s, slice by slice from zero, and applies
  // the epilogue.
  __syncthreads();                 // the ring is no longer read
  float* red = tile_sm;            // (S, E, ST)
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        red[(ks * E + (i * G + g) * TN + j) * ST + sid] = acc[i][g][j];
  __syncthreads();
  for (int p = tid; p < BM * BN; p += NT) {
    const int s = p % ST, rem = p / ST, i = rem / TN, j = rem % TN;
    float z[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      z[g] = 0.f;
      for (int k = 0; k < S; ++k)
        z[g] += red[(k * E + (i * G + g) * TN + j) * ST + s];
    }
    epilogue<G>(a, m0 + (s / TX) * TM + i, n0 + (s % TX) * TN + j, z);
  }
}

// The one-slice tile's kernel, fed by TMA: thread 0 issues a chunk's two
// box copies into the stage the block finished with, on that stage's
// mbarrier; every thread waits on the mbarrier of the chunk it computes.
// Block (BM / TM) x (BN / TN) threads, flat; grid as tile_kernel; shared
// memory: the ring (X rows unpadded, as the box lands), then one mbarrier
// a stage.
template <int G, int BM, int BN, int TM, int TN, int BK, int STAGES>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), 1)
tile_kernel_tma(TileArgs a, const __grid_constant__ TileMaps maps) {
  constexpr int TX = BN / TN;
  constexpr int XSIZE = BM * BK, WC = G * BN;
  constexpr int STAGE = XSIZE + BK * WC;
  static_assert(BK % 4 == 0 && BN % TN == 0 && BM % TM == 0 &&
                    (TN <= 2 || TN == 4),
                "tile shape");
  // no static shared memory: the ring starts 128-byte aligned, as the bulk
  // tensor copies need
  extern __shared__ __align__(128) float tile_sm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(tile_sm + STAGES * STAGE);
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int chunks = (a.k0 + a.k1 + a.k2) / BK;

  auto issue = [&](int c) {        // thread 0
    float* xs = tile_sm + (c % STAGES) * STAGE;
    const uint32_t bar = smem_u32(&full[c % STAGES]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     bar), "r"(4 * STAGE) : "memory");
    int kx = c * BK, seg = 0;      // the chunk lies in one segment
    if (kx >= a.k0) {
      kx -= a.k0;
      seg = 1;
      if (kx >= a.k1) {
        kx -= a.k1;
        seg = 2;
      }
    }
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(xs)),
        "l"(reinterpret_cast<uint64_t>(&maps.x[seg])), "r"(kx), "r"(m0),
        "r"(bar) : "memory");
    const int kw = c * BK, wi = kw >= a.ka;
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
            smem_u32(xs + XSIZE)),
        "l"(reinterpret_cast<uint64_t>(&maps.w[wi])), "r"(n0), "r"(0),
        "r"(wi ? kw - a.ka : kw), "r"(bar) : "memory");
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       smem_u32(&full[s])), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < STAGES - 1 && s < chunks; ++s) issue(s);
  }

  float acc[TM][G][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][g][j] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    __syncthreads();               // chunk c - 1's stage is read by no one
    if (tid == 0 && c + STAGES - 1 < chunks) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(c + STAGES - 1);
    }
    mbar_wait(&full[c % STAGES], (uint32_t)((c / STAGES) & 1));
    // the chunk's products apart, then added to the total (two-level)
    float part[TM][G][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][g][j] = 0.f;
    const float* xs = tile_sm + (c % STAGES) * STAGE + ty * TM * BK;
    const float* ws = tile_sm + (c % STAGES) * STAGE + XSIZE + tx * TN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float x[TM][4];              // the thread's rows at 4 k
#pragma unroll
      for (int i = 0; i < TM; ++i) load_vec<4>(xs + i * BK + kk, x[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float w[G][TN];
#pragma unroll
        for (int g = 0; g < G; ++g)
          load_vec<TN>(ws + (kk + q) * WC + g * BN, w[g]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              part[i][g][j] = fmaf(x[i][q], w[g][j], part[i][g][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][g][j] += part[i][g][j];
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float z[G];
#pragma unroll
      for (int g = 0; g < G; ++g) z[g] = acc[i][g][j];
      epilogue<G>(a, m0 + ty * TM + i, n0 + tx * TN + j, z);
    }
}

struct TileConfig {
  int gates, bm, bn, bk;
  int slice_threads;                  // threads a slice
  int max_slices;                     // 1: the TMA tile
  size_t smem;
  void (*sliced)(TileArgs);           // tile_kernel, or null
  void (*tma)(TileArgs, TileMaps);    // tile_kernel_tma, or null
};

template <int G, int BM, int BN, int TM, int TN, int BK, int STAGES, int KS>
TileConfig sliced_tile() {
  return {G, BM, BN, BK, (BM / TM) * (BN / TN), KS,
          sizeof(float) * STAGES * (BM * (BK + 4) + BK * G * BN),
          tile_kernel<G, BM, BN, TM, TN, BK, STAGES, KS>, nullptr};
}

template <int G, int BM, int BN, int TM, int TN, int BK, int STAGES>
TileConfig tma_tile() {
  return {G, BM, BN, BK, (BM / TM) * (BN / TN), 1,
          sizeof(float) * STAGES * (BM * BK + BK * G * BN) +
              sizeof(uint64_t) * STAGES,
          nullptr, tile_kernel_tma<G, BM, BN, TM, TN, BK, STAGES>};
}

// The instantiated tiles: <G, BM, BN, TM, TN, BK, STAGES> and, for a sliced
// one, its most slices KS; ops/tiles.py's TILES, in the same order (its
// index is the one passed here).
const TileConfig kTiles[] = {
    tma_tile<4, 128, 32, 8, 2, 32, 3>(),            // l128x32
    sliced_tile<4, 32, 8, 2, 4, 128, 3, 8>(),       // l32x8
    sliced_tile<1, 32, 16, 2, 4, 128, 3, 16>(),     // d32x16
    sliced_tile<1, 16, 8, 1, 4, 128, 3, 32>(),      // d16x8
};
constexpr int kNumTiles = sizeof(kTiles) / sizeof(kTiles[0]);

// Check that tile `index` exists and has `gates` gates, and let its kernel
// have its shared memory. Call once before launching it.
cudaError_t tile_prepare(int index, int gates) {
  if (index < 0 || index >= kNumTiles || kTiles[index].gates != gates)
    return cudaErrorInvalidValue;
  const TileConfig& t = kTiles[index];
  return t.tma != nullptr
             ? cudaFuncSetAttribute(t.tma,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)t.smem)
             : cudaFuncSetAttribute(t.sliced,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)t.smem);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda); null where the driver has none
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }();
  return fn;
}

// A row-major fp32 tensor of dims[0] innermost as a map of box boxes; rows
// outside dims read as zeros.
bool encode_map(CUtensorMap* map, const float* base, int rank,
                const cuuint64_t* dims, const cuuint32_t* box) {
  cuuint64_t strides[2];
  cuuint64_t pitch = 4;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = pitch *= dims[i];
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                        const_cast<float*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The TMA feed's maps for `a` on tile t, or false where its shapes or
// bases do not allow the feed or the driver cannot encode them.
bool tma_maps(const TileConfig& t, const TileArgs& a, TileMaps* maps) {
  const int K = a.k0 + a.k1 + a.k2;
  const float* in[3] = {a.in0, a.in1, a.in2};
  const int ks[3] = {a.k0, a.k1, a.k2};
  if (a.ka % t.bk || a.N % 4 || !aligned16(a.wa) ||
      (K > a.ka && !aligned16(a.wb)) || encode_tiled() == nullptr)
    return false;
  for (int i = 0; i < 3; ++i) {
    if (ks[i] == 0) continue;
    const cuuint64_t dims[2] = {(cuuint64_t)ks[i], (cuuint64_t)a.B};
    const cuuint32_t box[2] = {(cuuint32_t)t.bk, (cuuint32_t)t.bm};
    if (ks[i] % t.bk || !aligned16(in[i]) ||
        !encode_map(&maps->x[i], in[i], 2, dims, box))
      return false;
  }
  const float* w[2] = {a.wa, a.wb};
  const int rows[2] = {a.ka, K - a.ka};
  for (int i = 0; i < 2; ++i) {
    if (rows[i] == 0) continue;
    const cuuint64_t dims[3] = {(cuuint64_t)a.N, (cuuint64_t)t.gates,
                                (cuuint64_t)rows[i]};
    const cuuint32_t box[3] = {(cuuint32_t)t.bn, (cuuint32_t)t.gates,
                               (cuuint32_t)t.bk};
    if (!encode_map(&maps->w[i], w[i], 3, dims, box)) return false;
  }
  return true;
}

int igcd(int a, int b) { return b == 0 ? a : igcd(b, a % b); }

// Launch tile `index` (prepared) on `a` with the feed and slices the caller
// chose (ops/tiles.py's plan). Returns cudaErrorInvalidValue, launching
// nothing, where the tile has no such feed or slices, where 16-byte copies
// are asked for widths or bases that do not allow them, or where the TMA
// maps cannot be encoded; else the launch's error.
cudaError_t tile_launch(int index, int feed, int slices, TileArgs a,
                        cudaStream_t stream) {
  const TileConfig& t = kTiles[index];
  const dim3 grid(ceil_div(a.N, t.bn), ceil_div(a.B, t.bm));
  a.feed = feed;
  a.slices = slices;
  cudaError_t err;
  if (t.tma != nullptr) {
    TileMaps maps;
    if (feed != kFeedTMA || slices != 1 || !tma_maps(t, a, &maps))
      return cudaErrorInvalidValue;
    void* args[] = {&a, &maps};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(t.tma), grid,
                           dim3(t.slice_threads), args, t.smem, stream);
  } else {
    const bool w16 = a.N % 4 == 0 && aligned16(a.wa) &&
                     (a.wb == nullptr || aligned16(a.wb));
    const bool x16 = a.k0 % 4 == 0 && a.k1 % 4 == 0 && a.k2 % 4 == 0 &&
                     aligned16(a.in0) && (a.k1 == 0 || aligned16(a.in1)) &&
                     (a.k2 == 0 || aligned16(a.in2));
    if ((feed & ~(kFeedW16 | kFeedX16)) || ((feed & kFeedW16) && !w16) ||
        ((feed & kFeedX16) && !x16) || slices < 1 || slices > t.max_slices)
      return cudaErrorInvalidValue;
    // a chunk: a multiple of S (each starts on class 0) and of 4 (16 bytes)
    const int step = slices / igcd(slices, 4) * 4;
    a.chunk = t.bk - t.bk % step;
    if (a.chunk == 0) return cudaErrorInvalidValue;
    void* args[] = {&a};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(t.sliced), grid,
                           dim3(slices * t.slice_threads), args, t.smem,
                           stream);
  }
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace
