// The per-step kernels of the NIC decoder, shared by the whole greedy decode
// (K2 and K3, fused_decode.cu) and the teacher-forced sequence forward (K4,
// fused_seq.cu). One step, for every batch row b:
//
//   hw_pre = h W2 + b2,  hw = act(hw_pre, attn_slope)       (U -> A)
//   e_r    = tanh(pre_r + hw) . v + bv,  alpha = softmax_r(e)
//   ctx    = sum_r alpha_r features_r
//   x      = [ctx ; emb]
//   LSTM:  z = x Wx + h Wh + b, gates [i | f | g | o]
//          c, h = sig(f) c + sig(i) tanh(g),  sig(o) tanh(c)
//   GRU:   the Keras reset_after cell (see rows_kernel)
//
// act(x, s) is LeakyReLU with negative slope s: 0.2, 0 (relu) or 1 (linear).
//
//   attention_kernel   one block per batch row: scores, softmax, alphas,
//                      ctx; any A and D (a column loop where they exceed the
//                      block's threads). It reads hw_pre, which the tile
//                      kernel (tile_kernels.cuh) forms for the whole batch
//                      at once, in K2, K3 and K4 alike. attention_kernel<true>
//                      reads pre and features in bf16 (the bf16-weight
//                      decode's feat_bf16), widened, with fp32 sums;
//   rows_kernel<cell>  a block owns 32 output columns x 8 batch rows, its 8
//                      warps split the reduction axis [in0 | in1 | in2], each
//                      lane reads its column's weights coalesced and forms
//                      the epilogue itself (the GRU cell, or a dense layer's
//                      activation): K3's cell and head. K2 and K4 run their
//                      LSTM cell, and K2 its head, on the tile kernel, whose
//                      sliced tiles sum in this kernel's order.
// The row inputs of a tile are staged once in shared memory and broadcast to
// every lane, so the weights are the only stream from L2.
//
// All math is fp32 with fp32 accumulation. Kernels allocate nothing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;   // attention and argmax blocks
constexpr int kTileCols = 32;   // rows_kernel: one lane per output column
constexpr int kKSlices = 8;     // rows_kernel: warps splitting the K axis
constexpr int kTileRows = 8;    // rows_kernel: batch rows per block

// the decoder's cells (fused_decode.cu's run_decode) and rows_kernel's
// epilogues (kDense, kGRU)
constexpr int kDense = 0;       // act(z, slope)
constexpr int kLSTM = 1;        // Keras LSTM cell (on the tile kernel)
constexpr int kGRU = 2;         // Keras reset_after GRU cell

// rows_kernel's weight columns a unit, and accumulators a unit (the GRU's
// h~ gate has two: its input part and its recurrent part)
__host__ __device__ constexpr int gate_cols(int cell) {
  return cell == kDense ? 1 : 3;
}
__host__ __device__ constexpr int gate_sums(int cell) {
  return cell == kDense ? 1 : 4;
}

// the element type of a tensor that the bf16-weight decode may keep in bf16
// (pre, features, the embedding table), and its value widened to fp32
template <bool kBf16>
struct Elem {
  using type = float;
};
template <>
struct Elem<true> {
  using type = __nv_bfloat16;
};
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float lrelu(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions (blockDim.x a multiple of 32); every thread gets the
// result. `red` holds at least 32 floats.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // earlier readers of red are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f);
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_max(lane < (int)(blockDim.x >> 5) ? red[lane] : -INFINITY);
}

// out[n] = sum_k x[k] w[k * N + n] for n < N, by the whole block. A column
// narrower than the block gets blockDim.x / N threads, each summing every
// nsl-th k, and their partial sums are added in slice order; a wider one
// loops over passes of blockDim.x columns. `part` holds blockDim.x floats.
// Ends with a barrier, so `out` may be shared memory read next. w is fp32
// or bf16, widened.
template <typename W>
__device__ void block_vecmat(const float* __restrict__ x, int K,
                             const W* __restrict__ w, int N,
                             float* __restrict__ out, float* part) {
  const int tid = threadIdx.x;
  const int nsl = N < (int)blockDim.x ? (int)blockDim.x / N : 1;
  const int width = (int)blockDim.x / nsl;  // columns a pass
  const int sl = tid / width, j = tid % width;
  for (int n0 = 0; n0 < N; n0 += width) {
    const int n = n0 + j;
    if (sl < nsl && n < N) {
      float acc = 0.f;
      for (int k = sl; k < K; k += nsl)
        acc = fmaf(x[k], widen(w[(size_t)k * N + n]), acc);
      part[sl * width + j] = acc;
    }
    __syncthreads();
    if (tid < width && n0 + tid < N) {
      float s = 0.f;
      for (int i = 0; i < nsl; ++i) s += part[i * width + tid];
      out[n0 + tid] = s;
    }
    __syncthreads();
  }
}

size_t attention_smem_bytes(int A, int R) {
  return sizeof(float) * (size_t)(kThreads + A + R + 32);
}

// The attention of one step for batch row blockIdx.x, alphas (B, T, R) at
// step t (a time-major (T, B, R) buffer is, at step t, a (B, 1, R) one:
// T = 1, t = 0), from hw_pre = h W2 + b2 (B, A). Shared memory:
// attention_smem_bytes(A, R). attn_slope comes before T and t so that the
// compiler loads the same pairs of parameters together as when the kernel
// also took h, W2, b2 and U, and its machine code stays that one's. kBf16:
// pre and features in bf16.
template <bool kBf16 = false>
__global__ void attention_kernel(
    const typename Elem<kBf16>::type* __restrict__ pre,   // (B, R, A)
    const typename Elem<kBf16>::type* __restrict__ feat,  // (B, R, D)
    const float* __restrict__ v,      // (A,)
    const float* __restrict__ bv,     // (1,)
    float* __restrict__ ctx,          // (B, D)
    float* __restrict__ alphas,       // (B, T, R)
    const float* __restrict__ hw_pre, // (B, A)
    int R, int A, int D, float attn_slope, int T, int t) {
  extern __shared__ float sm[];
  float* sh_part = sm;
  float* sh_hw = sh_part + kThreads;
  float* sh_e = sh_hw + A;
  float* sh_red = sh_e + R;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  for (int a = tid; a < A; a += blockDim.x)
    sh_hw[a] = lrelu(hw_pre[(size_t)b * A + a], attn_slope);
  __syncthreads();

  // scores: one warp per region, lanes over the attention width
  const auto* pb = pre + (size_t)b * R * A;
  for (int r = warp; r < R; r += nwarps) {
    float s = 0.f;
    for (int a = lane; a < A; a += 32)
      s = fmaf(tanhf(widen(pb[(size_t)r * A + a]) + sh_hw[a]), v[a], s);
    s = warp_sum(s);
    if (lane == 0) sh_e[r] = s + bv[0];
  }
  __syncthreads();

  // softmax over regions
  float m = -INFINITY;
  for (int r = tid; r < R; r += blockDim.x) m = fmaxf(m, sh_e[r]);
  m = block_max(m, sh_red);
  float sum = 0.f;
  for (int r = tid; r < R; r += blockDim.x) {
    const float w = expf(sh_e[r] - m);
    sh_e[r] = w;
    sum += w;
  }
  sum = block_sum(sum, sh_red);
  float* ab = alphas + ((size_t)b * T + t) * R;
  for (int r = tid; r < R; r += blockDim.x) {
    const float alpha = sh_e[r] / sum;
    sh_e[r] = alpha;
    ab[r] = alpha;
  }
  __syncthreads();

  // ctx = alpha (R) times this row's features (R, D)
  block_vecmat(sh_e, R, feat + (size_t)b * R * D, D, ctx + (size_t)b * D,
               sh_part);
}

// A tile of kTileRows batch rows and kTileCols units. The input is
// x = [in0 | in1 | in2] (widths k0, k1, k2), the weights W have
// gate_cols(CELL) * N columns, rows [0, ka) in wa and [ka, K) in wb, with
// K = k0 + k1 + k2.
//   kDense: out[b, n] = act(x W + bias, slope)            (slope 1: identity)
//   kGRU:   gates [z | r | h~]; bias is b_in and bias2 b_rec; wa is Wx and
//           wb Wh, so rows >= ka are the recurrent part; in2 is the carried
//           h (k2 = N), or k2 = 0 under zero state, where h = 0. Writes h'.
// Block (kTileCols, kKSlices); grid (ceil(N / kTileCols), ceil(B / kTileRows)).
// Shared memory: rows_smem_bytes(K, CELL).
template <int CELL>
__global__ void rows_kernel(
    const float* __restrict__ in0, int k0,
    const float* __restrict__ in1, int k1,
    const float* __restrict__ in2, int k2,
    const float* __restrict__ wa, int ka,
    const float* __restrict__ wb,
    const float* __restrict__ bias,   // (gate_cols * N,)
    const float* __restrict__ bias2,  // (gate_cols * N,), kGRU only
    int B, int N, float slope,
    float* __restrict__ out) {        // (B, N)
  constexpr int NW = gate_cols(CELL);
  constexpr int NS = gate_sums(CELL);
  extern __shared__ float sm[];
  const int K = k0 + k1 + k2;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileCols + tx;
  const int row0 = blockIdx.y * kTileRows;
  const int col = blockIdx.x * kTileCols + tx;

  // stage the tile's input rows (kTileRows, K); rows past B are zeros
  for (int i = tid; i < kTileRows * K; i += kTileCols * kKSlices) {
    const int r = i / K, k = i - r * K, bb = row0 + r;
    float x = 0.f;
    if (bb < B) {
      if (k < k0) x = in0[(size_t)bb * k0 + k];
      else if (k < k0 + k1) x = in1[(size_t)bb * k1 + (k - k0)];
      else x = in2[(size_t)bb * k2 + (k - k0 - k1)];
    }
    sm[i] = x;
  }
  __syncthreads();

  float acc[NS][kTileRows];
#pragma unroll
  for (int g = 0; g < NS; ++g)
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) acc[g][r] = 0.f;

  // one k: the unit's NW weight columns times the tile's 8 inputs; the
  // GRU's h~ column goes to sum 3 in the recurrent rows
  auto step = [&](const float* wrow, int k, bool recurrent) {
    float w[NW];
#pragma unroll
    for (int g = 0; g < NW; ++g) w[g] = __ldg(wrow + (size_t)g * N + col);
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const float x = sm[r * K + k];
#pragma unroll
      for (int g = 0; g < NW; ++g) {
        if (CELL == kGRU && g == 2 && recurrent)
          acc[3][r] = fmaf(x, w[g], acc[3][r]);
        else
          acc[g][r] = fmaf(x, w[g], acc[g][r]);
      }
    }
  };
  if (col < N) {
    const size_t ld = (size_t)NW * N;
    int k = ty;
    for (; k < ka; k += kKSlices) step(wa + (size_t)k * ld, k, false);
    for (; k < K; k += kKSlices) step(wb + (size_t)(k - ka) * ld, k, true);
  }
  __syncthreads();  // staged inputs no longer read: reuse sm for the sums

  float* red = sm;  // (kKSlices, NS, kTileRows, kTileCols)
#pragma unroll
  for (int g = 0; g < NS; ++g)
#pragma unroll
    for (int r = 0; r < kTileRows; ++r)
      red[((ty * NS + g) * kTileRows + r) * kTileCols + tx] = acc[g][r];
  __syncthreads();

  for (int r = ty; r < kTileRows; r += kKSlices) {
    const int bb = row0 + r;
    if (bb >= B || col >= N) continue;
    float s[NS];
#pragma unroll
    for (int g = 0; g < NS; ++g) {
      s[g] = 0.f;
      for (int ks = 0; ks < kKSlices; ++ks)
        s[g] += red[((ks * NS + g) * kTileRows + r) * kTileCols + tx];
    }
    const size_t o = (size_t)bb * N + col;
    if constexpr (CELL == kGRU) {
      const float hp = k2 > 0 ? in2[(size_t)bb * k2 + col] : 0.f;
      const float z = sigmoid(s[0] + bias[col] + bias2[col]);
      const float rg = sigmoid(s[1] + bias[N + col] + bias2[N + col]);
      const float hh = tanhf(s[2] + bias[2 * N + col]
                             + rg * (s[3] + bias2[2 * N + col]));
      out[o] = z * hp + (1.f - z) * hh;
    } else {
      out[o] = lrelu(s[0] + bias[col], slope);
    }
  }
}

size_t rows_smem_bytes(int K, int cell) {
  const int staged = kTileRows * K;
  const int sums = kKSlices * gate_sums(cell) * kTileRows * kTileCols;
  return sizeof(float) * (size_t)(staged > sums ? staged : sums);
}

unsigned ceil_div(int n, int d) { return (unsigned)((n + d - 1) / d); }

}  // namespace
