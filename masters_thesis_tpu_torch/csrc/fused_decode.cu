// Whole greedy decode of the LcNIC caption decoder, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel masters_thesis_tpu/ops/fused_decode.py::
// fused_greedy_decode (body _decode_kernel, helpers _attention_step and
// _head_and_reembed). Per greedy step, for every batch row b:
//
//   hw     = lrelu(h W2 + b2)                              (U -> A)
//   e_r    = tanh(pre_r + hw) . v + bv,  alpha = softmax_r(e)
//   ctx    = sum_r alpha_r features_r
//   z      = [ctx ; emb] Wx + h Wh + b,  gates [i | f | g | o]
//   c, h   = sig(f) c + sig(i) tanh(g),  sig(o) tanh(c)
//   logits = lrelu(h Wi + bi) Wo + bo                      (padded ids: bo = -1e30)
//   word   = first argmax(logits),  emb = emb_table[word]
//
// What bounds it on this card. The TPU kernel keeps ~12.5 MB of bf16 weights
// resident in VMEM for the whole loop. An SM has 227 KB of shared memory, and
// the fp32 decode weights are ~15 MB at flagship width (Wx 544x2048, Wh
// 512x2048, Wi 512x256, Wo 256x5120, W2 512x32), so no block can hold them.
// They do fit in the 50 MB L2, so every step streams them from L2 once per
// batch-row tile: 8 tiles of 8 rows at B = 64, ~120 MB of L2 reads a step.
// Against that, the step's arithmetic is ~230 M fp32 FMAs (B x (1056 x 2048 +
// 512 x 256 + 256 x 5120)) on CUDA cores, with no tensor cores in this
// version. Steps are strictly sequential (each needs the previous word).
//
// What the design does about it. One C entry point loops over the T steps on
// the host and launches a fixed chain of five kernels per step on the caller's
// stream, without host synchronisation:
//   1. attention_kernel   one block per batch row: hw, scores, softmax,
//                         alphas[b, t, :], ctx;
//   2. rows_kernel<4>     LSTM gates and cell: a block owns 32 units x 8 rows,
//                         its 8 warps split the 1056-long reduction axis, each
//                         lane reads 4 coalesced weight columns (one per gate)
//                         and forms the cell update itself; h is double
//                         buffered because other blocks still read the old h;
//   3. rows_kernel<1>     lrelu(h Wi + bi);
//   4. rows_kernel<1>     logits over vocab tiles of 32 columns;
//   5. argmax_embed_kernel  one block per row: first-index argmax, words[b, t],
//                         and a direct row gather of the next embedding (the
//                         TPU kernel's one-hot matmul exists only for the MXU).
// The row inputs of a tile are staged once in shared memory and broadcast to
// every lane, so the weights are the only stream from L2. Tensor cores, bf16
// weights, a persistent kernel and CUDA graphs are left for later work.
//
// All math is fp32 with fp32 accumulation. Kernels allocate nothing; the
// Python wrapper passes outputs and scratch. Each launch is checked with
// cudaGetLastError, and the entry point returns the first error.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;   // attention and argmax blocks
constexpr int kTileCols = 32;   // rows_kernel: one lane per output column
constexpr int kKSlices = 8;     // rows_kernel: warps splitting the K axis
constexpr int kTileRows = 8;    // rows_kernel: batch rows per block
constexpr float kSlope = 0.2f;  // LeakyReLU(0.2) of lc_NIC

// Errors of the entry point's own, beside the (positive) CUDA error codes.
constexpr int kErrTooWide = -1;  // A or D > kThreads

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

// Step 1: attention for batch row blockIdx.x. Needs A <= blockDim.x and
// D <= blockDim.x. Shared memory: U + kThreads + A + R + 32 floats.
__global__ void attention_kernel(
    const float* __restrict__ pre,    // (B, R, A) lrelu(features W1 + b1)
    const float* __restrict__ feat,   // (B, R, D)
    const float* __restrict__ w2,     // (U, A)
    const float* __restrict__ b2,     // (A,)
    const float* __restrict__ v,      // (A,)
    const float* __restrict__ bv,     // (1,)
    const float* __restrict__ h,      // (B, U)
    float* __restrict__ ctx,          // (B, D)
    float* __restrict__ alphas,       // (B, T, R)
    int R, int A, int D, int U, int T, int t) {
  extern __shared__ float sm[];
  float* sh_h = sm;
  float* sh_part = sh_h + U;
  float* sh_hw = sh_part + kThreads;
  float* sh_e = sh_hw + A;
  float* sh_red = sh_e + R;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  for (int k = tid; k < U; k += blockDim.x) sh_h[k] = h[(size_t)b * U + k];
  __syncthreads();

  // hw: thread (slice, a) sums k = slice, slice + nsl, ... ; then one pass
  // over the slices per column
  {
    const int nsl = blockDim.x / A, a = tid % A, sl = tid / A;
    if (sl < nsl) {
      float acc = 0.f;
      for (int k = sl; k < U; k += nsl)
        acc = fmaf(sh_h[k], w2[(size_t)k * A + a], acc);
      sh_part[sl * A + a] = acc;
    }
    __syncthreads();
    if (tid < A) {
      float s = 0.f;
      for (int i = 0; i < nsl; ++i) s += sh_part[i * A + tid];
      sh_hw[tid] = lrelu(s + b2[tid], kSlope);
    }
    __syncthreads();
  }

  // scores: one warp per region, lanes over the attention width
  const float* pb = pre + (size_t)b * R * A;
  for (int r = warp; r < R; r += nwarps) {
    float s = 0.f;
    for (int a = lane; a < A; a += 32)
      s = fmaf(tanhf(pb[(size_t)r * A + a] + sh_hw[a]), v[a], s);
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

  // ctx: thread (slice, d) sums r = slice, slice + nsl, ...
  {
    const int nsl = blockDim.x / D, d = tid % D, sl = tid / D;
    const float* fb = feat + (size_t)b * R * D;
    if (sl < nsl) {
      float acc = 0.f;
      for (int r = sl; r < R; r += nsl)
        acc = fmaf(sh_e[r], fb[(size_t)r * D + d], acc);
      sh_part[sl * D + d] = acc;
    }
    __syncthreads();
    if (tid < D) {
      float s = 0.f;
      for (int i = 0; i < nsl; ++i) s += sh_part[i * D + tid];
      ctx[(size_t)b * D + tid] = s;
    }
  }
}

// Steps 2-4: out = x W + bias for a tile of kTileRows batch rows and
// kTileCols columns, where x = [in0 | in1 | in2] (widths k0, k1, k2) and W
// has NG * N columns, its rows [0, ka) in wa and [ka, K) in wb.
//   NG == 1: out[b, n] = lrelu(z, slope)            (slope 1: identity)
//   NG == 4: gates of unit n at columns g * N + n; the LSTM cell update
//            writes h' to out and updates c in place.
// Block (kTileCols, kKSlices); grid (ceil(N / kTileCols), ceil(B / kTileRows)).
// Shared memory: max(kTileRows * K, kKSlices * NG * kTileRows * kTileCols).
template <int NG>
__global__ void rows_kernel(
    const float* __restrict__ in0, int k0,
    const float* __restrict__ in1, int k1,
    const float* __restrict__ in2, int k2,
    const float* __restrict__ wa, int ka,
    const float* __restrict__ wb,
    const float* __restrict__ bias,   // (NG * N,)
    int B, int N, float slope,
    float* __restrict__ out,          // (B, N)
    float* __restrict__ c) {          // (B, N), NG == 4 only
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

  float acc[NG][kTileRows];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) acc[g][r] = 0.f;

  if (col < N) {
    const size_t ld = (size_t)NG * N;
    for (int k = ty; k < K; k += kKSlices) {
      const float* wrow = k < ka ? wa + (size_t)k * ld : wb + (size_t)(k - ka) * ld;
      float w[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) w[g] = __ldg(wrow + (size_t)g * N + col);
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        const float x = sm[r * K + k];
#pragma unroll
        for (int g = 0; g < NG; ++g) acc[g][r] = fmaf(x, w[g], acc[g][r]);
      }
    }
  }
  __syncthreads();  // staged inputs no longer read: reuse sm for the sums

  float* red = sm;  // (kKSlices, NG, kTileRows, kTileCols)
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int r = 0; r < kTileRows; ++r)
      red[((ty * NG + g) * kTileRows + r) * kTileCols + tx] = acc[g][r];
  __syncthreads();

  for (int r = ty; r < kTileRows; r += kKSlices) {
    const int bb = row0 + r;
    if (bb >= B || col >= N) continue;
    float z[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float s = 0.f;
      for (int ks = 0; ks < kKSlices; ++ks)
        s += red[((ks * NG + g) * kTileRows + r) * kTileCols + tx];
      z[g] = s + bias[(size_t)g * N + col];
    }
    const size_t o = (size_t)bb * N + col;
    if constexpr (NG == 4) {
      const float cn = sigmoid(z[1]) * c[o] + sigmoid(z[0]) * tanhf(z[2]);
      c[o] = cn;
      out[o] = sigmoid(z[3]) * tanhf(cn);
    } else {
      out[o] = lrelu(z[0], slope);
    }
  }
}

__device__ __forceinline__ void take_better(float& v, int& i, float v2, int i2) {
  // first index of the maximum; i < 0 marks "no candidate yet"
  if (i2 < 0) return;
  if (i < 0 || v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Step 5: one block per batch row.
__global__ void argmax_embed_kernel(
    const float* __restrict__ logits,     // (B, N)
    const float* __restrict__ emb_table,  // (V, E)
    float* __restrict__ emb,              // (B, E) next step's embedding
    int* __restrict__ words,              // (B, T)
    int N, int E, int T, int t) {
  __shared__ float s_val[32];
  __shared__ int s_idx[32];
  __shared__ int s_word;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const float* lb = logits + (size_t)b * N;

  float best = -INFINITY;
  int idx = -1;
  for (int j = tid; j < N; j += blockDim.x) take_better(best, idx, lb[j], j);
  for (int o = 16; o > 0; o >>= 1)
    take_better(best, idx, __shfl_xor_sync(0xffffffffu, best, o),
                __shfl_xor_sync(0xffffffffu, idx, o));
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = idx;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < nwarps ? s_val[lane] : -INFINITY;
    idx = lane < nwarps ? s_idx[lane] : -1;
    for (int o = 16; o > 0; o >>= 1)
      take_better(best, idx, __shfl_xor_sync(0xffffffffu, best, o),
                  __shfl_xor_sync(0xffffffffu, idx, o));
    if (lane == 0) {
      s_word = idx;
      words[(size_t)b * T + t] = idx;
    }
  }
  __syncthreads();
  const float* row = emb_table + (size_t)s_word * E;
  for (int e = tid; e < E; e += blockDim.x) emb[(size_t)b * E + e] = row[e];
}

size_t rows_smem_bytes(int K, int NG) {
  const int staged = kTileRows * K;
  const int sums = kKSlices * NG * kTileRows * kTileCols;
  return sizeof(float) * (size_t)(staged > sums ? staged : sums);
}

unsigned ceil_div(int n, int d) { return (unsigned)((n + d - 1) / d); }

}  // namespace

extern "C" {

// Runs all T greedy steps. emb (B, E) holds the start embedding on entry,
// h_a and c (B, U) the initial carry; h_b, ctx (B, D), hi (B, H) and logits
// (B, V) are scratch. Writes words (B, T) and alphas (B, T, R). Returns 0 on
// success, kErrTooWide if A or D exceeds a block's threads, else the first
// CUDA error (widths that need more shared memory than a block may have fail
// in cudaFuncSetAttribute).
int mtt_fused_greedy_decode(
    const float* pre, const float* features, const float* w2, const float* b2,
    const float* v, const float* bv, const float* wx, const float* wh,
    const float* b, const float* wi, const float* bi, const float* wo,
    const float* bo, const float* emb_table, float* emb, float* h_a,
    float* h_b, float* c, float* ctx, float* hi, float* logits, int* words,
    float* alphas, int B, int R, int A, int D, int E, int U, int H, int V,
    int T, int device, void* stream_ptr) {
  if (A > kThreads || D > kThreads) return kErrTooWide;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);

  const size_t attn_smem = sizeof(float) * (size_t)(U + kThreads + A + R + 32);
  const size_t lstm_smem = rows_smem_bytes(D + E + U, 4);
  const size_t inter_smem = rows_smem_bytes(U, 1);
  const size_t out_smem = rows_smem_bytes(H, 1);
  const size_t dense_smem = inter_smem > out_smem ? inter_smem : out_smem;
  if ((err = cudaFuncSetAttribute(attention_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)attn_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(rows_kernel<4>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)lstm_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(rows_kernel<1>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)dense_smem)) != cudaSuccess)
    return (int)err;

  const dim3 tile(kTileCols, kKSlices);
  const unsigned row_tiles = ceil_div(B, kTileRows);
  const dim3 lstm_grid(ceil_div(U, kTileCols), row_tiles);
  const dim3 inter_grid(ceil_div(H, kTileCols), row_tiles);
  const dim3 out_grid(ceil_div(V, kTileCols), row_tiles);

  float* h_cur = h_a;
  float* h_next = h_b;
  for (int t = 0; t < T; ++t) {
    attention_kernel<<<B, kThreads, attn_smem, stream>>>(
        pre, features, w2, b2, v, bv, h_cur, ctx, alphas, R, A, D, U, T, t);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rows_kernel<4><<<lstm_grid, tile, lstm_smem, stream>>>(
        ctx, D, emb, E, h_cur, U, wx, D + E, wh, b, B, U, 1.f, h_next, c);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rows_kernel<1><<<inter_grid, tile, inter_smem, stream>>>(
        h_next, U, nullptr, 0, nullptr, 0, wi, U, nullptr, bi, B, H, kSlope,
        hi, nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rows_kernel<1><<<out_grid, tile, out_smem, stream>>>(
        hi, H, nullptr, 0, nullptr, 0, wo, H, nullptr, bo, B, V, 1.f, logits,
        nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    argmax_embed_kernel<<<B, kThreads, 0, stream>>>(logits, emb_table, emb,
                                                    words, V, E, T, t);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    float* tmp = h_cur;
    h_cur = h_next;
    h_next = tmp;
  }
  return 0;
}

const char* mtt_error_string(int code) {
  if (code == kErrTooWide)
    return "attention width and feature width must be <= 256, one thread "
           "per column";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
