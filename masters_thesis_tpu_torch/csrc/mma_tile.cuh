// The bf16 tensor-core tile of the decoder's products, for Hopper (sm_90a):
// mma.sync.m16n8k16 with bf16 operands and fp32 sums, its operands loaded by
// ldmatrix from a ring of bf16 stages that cp.async fills. The bf16-weight
// K4 (fused_seq.cu) runs its h W2 and its flagship cell on it. For a block
// of BM rows x BU units it computes
//
//   Y = [in0 | in1 | in2] W + bias        (in0 fp32, rounded to bf16 as it
//                                          is staged; in1, in2 and W bf16)
//
// with one of two epilogues, by G, the gates a unit:
//   G = 4  the Keras LSTM cell: gates [i | f | g | o], c from c_in, writes
//          z, c', h' and h' rounded to bf16;
//   G = 1  a dense product, out = x W + bias.
//
// The epilogue of a (row, unit) has every gate's sum in one place, so the
// cell runs in registers; h' is rounded to bf16 once, where it is made, for
// the next products. Moved here from fused_seq.cu unchanged: the K4
// instantiations' machine code is that of fused_seq.cu before the move
// (scripts/port_sass_diff.py).

#pragma once

#include <cuda_bf16.h>

#include "step_kernels.cuh"
#include "tile_kernels.cuh"

namespace {

using bf16 = __nv_bfloat16;

// A bf16 tensor-core product's operands: x = [in0 | in1 | in2] (widths k0,
// k1, k2; in0 fp32, rounded to bf16 as it is staged; in1 and in2 bf16),
// rows contiguous, against W = [wa ; wb] bf16, W's rows [0, ka) in wa and
// [ka, K) in wb, each of G N columns (gate g of unit n at column g N + n).
struct MmaArgs {
  const float* in0;
  const bf16* in1;
  const bf16* in2;
  int k0, k1, k2;
  const bf16* wa;
  const bf16* wb;
  int ka;
  const float* bias;   // (G N,)
  int B, N;
  float* out;          // (B, N): the dense product, or the cell's h'
  bf16* h_out;         // (B, N), LSTM: h' rounded to bf16
  float* c_out;        // (B, N), LSTM
  const float* c_in;   // (B, N), LSTM
  float* z_out;        // (B, 4N), LSTM
  int feed;            // kFeedX16 | kFeedW16: 16-byte copies (mma_launch)
};

__device__ __forceinline__ void cp_async16_any(void* dst, const void* src,
                                               int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&b0)[2],
                                              uint32_t (&b1)[2],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&b)[2],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(smem_u32(p)));
}

// d += a b for one m16n8k16 tile: bf16 operands, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x[m, k] of the bf16 segments (k >= k0)
__device__ __forceinline__ const bf16* xb_at(const MmaArgs& a, int m,
                                             int k) {
  k -= a.k0;
  if (k < a.k1) return a.in1 + (size_t)m * a.k1 + k;
  return a.in2 + (size_t)m * a.k2 + (k - a.k1);
}

// W's row k
__device__ __forceinline__ const bf16* wb_row(const MmaArgs& a, int k,
                                              size_t ld) {
  return k < a.ka ? a.wa + (size_t)k * ld : a.wb + (size_t)(k - a.ka) * ld;
}

// a stage row of c bf16, padded so that its 16-byte units are odd: the 8
// rows an ldmatrix reads then fall in 8 different banks
constexpr int padded(int c) { return (c / 8) % 2 ? c : c + 8; }

// The epilogue of row m and unit n given their G pre-activations z (bias
// added) and, for the cell, the cell state c: the cell writes z, c', h'
// and h' rounded to bf16; a dense product writes z.
template <int G>
__device__ __forceinline__ void mma_store(const MmaArgs& a, int m, int n,
                                          const float* z, float c) {
  const size_t o = (size_t)m * a.N + n;
  if constexpr (G == 4) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
      a.z_out[(size_t)m * 4 * a.N + (size_t)g * a.N + n] = z[g];
    const float cn = sigmoid(z[1]) * c + sigmoid(z[0]) * tanhf(z[2]);
    const float h = sigmoid(z[3]) * tanhf(cn);
    a.c_out[o] = cn;
    a.out[o] = h;
    a.h_out[o] = __float2bfloat16_rn(h);
  } else {
    a.out[o] = z[0];
  }
}

// The bf16 tensor-core tile: G gates (4: the LSTM cell, 1: a dense product
// out = x W + bias), a block of BM = 16 MT rows x BU = 8 NU units of each
// gate. Each of its KS warps takes the whole tile, MT m16 tiles x NU n8
// tiles of each gate, on one k16 slice in KS of each chunk of BK k; the
// warps' sums meet in shared memory and are added in warp order, from warp
// 0's, before the epilogue. Grid (ceil(N / BU), ceil(B / BM)).
template <int G, int MT, int NU, int KS, int BK, int STAGES>
struct MmaTile {
  static constexpr int kThreads = 32 * KS;
  static constexpr int BM = 16 * MT, BU = 8 * NU, WC = G * BU;
  static constexpr int XS = padded(BK), WS = padded(WC);
  static constexpr int STAGE = BM * XS + BK * WS;      // bf16 a stage
  static constexpr int ACC = MT * G * NU * 4;          // sums a thread
  static constexpr size_t kRing = sizeof(bf16) * STAGES * STAGE;
  static constexpr size_t kRed = sizeof(float) * KS * ACC * 32;
  static constexpr size_t kSmem = kRing > kRed ? kRing : kRed;
  static_assert(BK % (16 * KS) == 0 && STAGES >= 2, "tile shape");
};

template <int G, int MT, int NU, int KS, int BK, int STAGES>
__global__ void __launch_bounds__(32 * KS)
mma_tile_kernel(MmaArgs a) {
  using T = MmaTile<G, MT, NU, KS, BK, STAGES>;
  constexpr int BM = T::BM, BU = T::BU, WC = T::WC, XS = T::XS, WS = T::WS;
  constexpr int NT = G * NU;                 // n8 tiles a warp
  extern __shared__ __align__(16) uint4 mma_sm[];
  bf16* ring = reinterpret_cast<bf16*>(mma_sm);
  const int tid = threadIdx.x, lane = tid % 32, ks = tid / 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BU;
  const int K = a.k0 + a.k1 + a.k2;
  const int chunks = (K + BK - 1) / BK;
  const size_t ld = (size_t)G * a.N;

  // chunk c's X (the block's rows, rounded to bf16) and W (its rows of the
  // G x BU columns of the block's units) into stage c % STAGES
  auto load = [&](int c) {
    bf16* xs = ring + (c % STAGES) * T::STAGE;
    bf16* ws = xs + BM * XS;
    const int kc = c * BK;
    if (a.feed & kFeedX16) {
      for (int i = tid; i < BM * (BK / 8); i += T::kThreads) {
        const int r = i / (BK / 8), q = i % (BK / 8) * 8;
        const int m = m0 + r, k = kc + q;
        bf16* dst = xs + r * XS + q;
        if (m < a.B && k < a.k0) {           // fp32: rounded here
          const float4* src =
              reinterpret_cast<const float4*>(a.in0 + (size_t)m * a.k0 + k);
          const float4 u = src[0], v = src[1];
          union {
            __nv_bfloat162 h[4];
            uint4 all;
          } pack;
          pack.h[0] = __floats2bfloat162_rn(u.x, u.y);
          pack.h[1] = __floats2bfloat162_rn(u.z, u.w);
          pack.h[2] = __floats2bfloat162_rn(v.x, v.y);
          pack.h[3] = __floats2bfloat162_rn(v.z, v.w);
          *reinterpret_cast<uint4*>(dst) = pack.all;
        } else {
          const bool in = m < a.B && k < K;
          cp_async16_any(dst, in ? xb_at(a, m, k) : a.wa, in ? 16 : 0);
        }
      }
    } else {
      for (int i = tid; i < BM * BK; i += T::kThreads) {
        const int r = i / BK, q = i % BK, m = m0 + r, k = kc + q;
        bf16 v = __float2bfloat16_rn(0.f);
        if (m < a.B && k < K)
          v = k < a.k0 ? __float2bfloat16_rn(a.in0[(size_t)m * a.k0 + k])
                       : *xb_at(a, m, k);
        xs[r * XS + q] = v;
      }
    }
    if (a.feed & kFeedW16) {
      for (int i = tid; i < BK * (WC / 8); i += T::kThreads) {
        const int kr = i / (WC / 8), col = i % (WC / 8) * 8;
        const int g = col / BU, n = n0 + col % BU, k = kc + kr;
        const bool in = k < K && n < a.N;
        cp_async16_any(ws + kr * WS + col,
                       in ? wb_row(a, k, ld) + (size_t)g * a.N + n : a.wa,
                       in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < BK * WC; i += T::kThreads) {
        const int kr = i / WC, col = i % WC;
        const int g = col / BU, n = n0 + col % BU, k = kc + kr;
        ws[kr * WS + col] = k < K && n < a.N
                                ? wb_row(a, k, ld)[(size_t)g * a.N + n]
                                : __float2bfloat16_rn(0.f);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // the stage column of n-tile j: gate j / NU, units 8 (j % NU) on
  auto tile_col = [&](int j) { return j / NU * BU + j % NU * 8; };
  // ldmatrix's row and column of this lane: A rows 0-15 at k 0 then 8;
  // B (.trans) k rows 0-15 of one n-tile, then of the next
  const int a_row = lane % 16, a_col = lane / 16 * 8;
  const int b_row = lane % 16, b_tile = lane / 16;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks) load(s);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();   // chunk c has landed
    __syncthreads();               // ... for every thread; chunk c - 1 done
    if (c + STAGES - 1 < chunks) load(c + STAGES - 1);
    cp_async_commit();             // (an empty group keeps the count)

    const bf16* xs = ring + (c % STAGES) * T::STAGE;
    const bf16* ws = ring + (c % STAGES) * T::STAGE + BM * XS;
#pragma unroll
    for (int step = 0; step < BK / 16 / KS; ++step) {
      const int k16 = (step * KS + ks) * 16;
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(af[i], xs + (i * 16 + a_row) * XS + k16 + a_col);
      uint32_t bfr[NT][2];
      const bf16* wk = ws + (k16 + b_row) * WS;
#pragma unroll
      for (int j = 0; j + 1 < NT; j += 2)
        ldsm_x4_trans(bfr[j], bfr[j + 1], wk + tile_col(j + b_tile));
      if constexpr (NT % 2) ldsm_x2_trans(bfr[NT - 1], wk + tile_col(NT - 1));
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
  }
  cp_async_wait<0>();

  // The warps' sums meet in shared memory, (KS, MT, NT, 4, 32); every
  // thread of the block then takes (row, unit) pairs, adds up their warps'
  // sums in warp order and applies the epilogue, so that the cell's
  // transcendentals are spread over the whole block. Accumulator e of an
  // m16n8 tile is its row lane / 4 (+ 8 for e >= 2) and column
  // lane % 4 * 2 + e % 2.
  __syncthreads();                 // the ring is no longer read
  float* red = reinterpret_cast<float*>(mma_sm);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(((ks * MT + i) * NT + j) * 4 + e) * 32 + lane] = acc[i][j][e];
  __syncthreads();
  for (int p = tid; p < 32 * MT * NU * 4; p += T::kThreads) {
    const int l = p % 32, e = p / 32 % 4, u = p / 128 % NU, i = p / 128 / NU;
    const int m = m0 + i * 16 + l / 4 + e / 2 * 8;
    const int n = n0 + u * 8 + l % 4 * 2 + e % 2;
    if (m >= a.B || n >= a.N) continue;
    float z[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      z[g] = 0.f;
      for (int q = 0; q < KS; ++q)
        z[g] += red[(((q * MT + i) * NT + g * NU + u) * 4 + e) * 32 + l];
      z[g] += a.bias[(size_t)g * a.N + n];
    }
    mma_store<G>(a, m, n, z, G == 4 ? a.c_in[(size_t)m * a.N + n] : 0.f);
  }
}

struct MmaConfig {
  int bm, bu, threads;
  size_t smem;
  void (*kernel)(MmaArgs);
};

template <int G, int MT, int NU, int KS, int BK, int STAGES>
MmaConfig mma_tile() {
  using T = MmaTile<G, MT, NU, KS, BK, STAGES>;
  return {T::BM, T::BU, T::kThreads, T::kSmem,
          mma_tile_kernel<G, MT, NU, KS, BK, STAGES>};
}

// Let tile t's kernel have its shared memory. Call once before launching.
cudaError_t mma_prepare(const MmaConfig& t) {
  return cudaFuncSetAttribute(t.kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)t.smem);
}

// Launch tile t on a, with 16-byte copies of X where every segment width is
// a multiple of 8 and the bases are 16-byte aligned, and of W where N is a
// multiple of 8 and wa and wb are; else element by element.
cudaError_t mma_launch(const MmaConfig& t, MmaArgs a, cudaStream_t stream) {
  const bool x16 = a.k0 % 8 == 0 && a.k1 % 8 == 0 && a.k2 % 8 == 0 &&
                   (a.k0 == 0 || aligned16(a.in0)) &&
                   (a.k1 == 0 || aligned16(a.in1)) &&
                   (a.k2 == 0 || aligned16(a.in2));
  const bool w16 = a.N % 8 == 0 && aligned16(a.wa) &&
                   (a.wb == nullptr || aligned16(a.wb));
  a.feed = (x16 ? kFeedX16 : 0) | (w16 ? kFeedW16 : 0);
  const dim3 grid(ceil_div(a.N, t.bu), ceil_div(a.B, t.bm));
  void* args[] = {&a};
  const cudaError_t err =
      cudaLaunchKernel(reinterpret_cast<const void*>(t.kernel), grid,
                       dim3(t.threads), args, t.smem, stream);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}


}  // namespace
