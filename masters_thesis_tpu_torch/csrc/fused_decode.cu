// Whole greedy decode of the NIC caption decoder, for Hopper (sm_90a): K2
// for the LSTM cell (LcNIC) and K3 for the GRU cell (CnnRnn). The two share
// every kernel but the cell's epilogue.
//
// K2 replaces the Pallas TPU kernel masters_thesis_tpu/ops/fused_decode.py::
// fused_greedy_decode (:211; body _decode_kernel). K3 replaces
// fused_greedy_decode_gru (:276; body _gru_decode_kernel at :233). Both
// share the TPU kernels' helpers _attention_step and _head_and_reembed. Per
// greedy step, for every batch row b:
//
//   hw     = act(h W2 + b2, attn_slope)                    (U -> A)
//   e_r    = tanh(pre_r + hw) . v + bv,  alpha = softmax_r(e)
//   ctx    = sum_r alpha_r features_r
//   x      = [ctx ; emb]
//   LSTM:  z = x Wx + h Wh + b, gates [i | f | g | o]
//          c, h = sig(f) c + sig(i) tanh(g),  sig(o) tanh(c)
//   GRU:   xz = x Wx + b_in,  hz = h Wh + b_rec, gates [z | r | h~]
//          h = z h + (1 - z) tanh(xz_h + sig(xz_r + hz_r) hz_h),
//          z = sig(xz_z + hz_z); under zero_state the cell starts from h = 0
//          (hz = b_rec), and the carried h feeds only the next attention
//   logits = act(h Wi + bi, slope) Wo + bo                 (padded ids: -1e30)
//   word   = first argmax(logits),  emb = emb_table[word]
//
// act(x, s) is LeakyReLU with negative slope s: 0.2, 0 (relu) or 1 (linear).
//
// What bounds it on this card. The TPU kernels keep their bf16 weights
// resident in VMEM for the whole loop. An SM has 227 KB of shared memory;
// the fp32 weights a step reads are ~15 MB for LcNIC (Wx 544x2048, Wh
// 512x2048, Wi 512x256, Wo 256x5120, W2 512x32) and ~18.5 MB for CnnRnn (Wx
// 512x1536, Wh 512x1536, Wi 512x512, Wo 512x5120, W2 512x512), so no block
// can hold them. They do fit in the 50 MB L2, so every step streams the
// cell's and the head's weights from L2 once per batch-row tile (8 tiles of
// 8 rows at B = 64), and W2 once per row: ~120 MB (LcNIC) and ~180 MB
// (CnnRnn, whose 1 MB W2 alone is 64 MB of it) of L2 reads a step. Against
// that, a step's arithmetic is B x (weights' elements) fp32 FMAs, ~0.23 G
// (LcNIC) and ~0.25 G (CnnRnn, zero-state), on CUDA cores, with no tensor
// cores in this version. Counting each input byte once, a decode is bound
// by operations (~7 GFLOP over 67 TFLOP/s, ~0.1 ms), but the step-to-step
// dependence and the per-tile weight streams make L2 latency the real
// limit. Steps are strictly sequential (each needs the previous word).
//
// What the design does about it. One C entry point a cell loops over the T
// steps on the host and launches a fixed chain of five kernels per step on
// the caller's stream, without host synchronisation:
//   1. attention_kernel   one block per batch row: hw, scores, softmax,
//                         alphas[b, t, :], ctx; any A and D (a column
//                         loop where they exceed the block's threads);
//   2. rows_kernel<cell>  the cell: a block owns 32 units x 8 rows, its 8
//                         warps split the reduction axis [ctx | emb | h],
//                         each lane reads the unit's gate columns coalesced
//                         and forms the cell update itself; the GRU keeps
//                         the h~ gate's input and recurrent sums apart
//                         (r multiplies only the recurrent one) and, in zero
//                         state, skips the Wh rows; h is double buffered
//                         because other blocks still read the old h;
//   3. rows_kernel<kDense> act(h Wi + bi);
//   4. rows_kernel<kDense> logits over vocab tiles of 32 columns;
//   5. argmax_embed_kernel  one block per row: first-index argmax,
//                         words[b, t], and a direct row gather of the next
//                         embedding (the TPU kernels' one-hot matmul exists
//                         only for the MXU).
// The row inputs of a tile are staged once in shared memory and broadcast to
// every lane, so the weights are the only stream from L2. Tensor cores, bf16
// weights, a persistent kernel and CUDA graphs are left for later work.
//
// All math is fp32 with fp32 accumulation. Kernels allocate nothing; the
// Python wrapper passes outputs and scratch. Each launch is checked with
// cudaGetLastError, and the entry points return the first error.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;   // attention and argmax blocks
constexpr int kTileCols = 32;   // rows_kernel: one lane per output column
constexpr int kKSlices = 8;     // rows_kernel: warps splitting the K axis
constexpr int kTileRows = 8;    // rows_kernel: batch rows per block

// rows_kernel epilogues
constexpr int kDense = 0;       // act(z, slope)
constexpr int kLSTM = 1;        // Keras LSTM cell, c updated in place
constexpr int kGRU = 2;         // Keras reset_after GRU cell

// weight columns a unit, and accumulators a unit (the GRU's h~ gate has
// two: its input part and its recurrent part)
__host__ __device__ constexpr int gate_cols(int cell) {
  return cell == kDense ? 1 : cell == kLSTM ? 4 : 3;
}
__host__ __device__ constexpr int gate_sums(int cell) {
  return cell == kDense ? 1 : 4;
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
// Ends with a barrier, so `out` may be shared memory read next.
__device__ void block_vecmat(const float* __restrict__ x, int K,
                             const float* __restrict__ w, int N,
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
        acc = fmaf(x[k], w[(size_t)k * N + n], acc);
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

// Step 1: attention for batch row blockIdx.x. Shared memory:
// U + kThreads + A + R + 32 floats.
__global__ void attention_kernel(
    const float* __restrict__ pre,    // (B, R, A) act(features W1 + b1)
    const float* __restrict__ feat,   // (B, R, D)
    const float* __restrict__ w2,     // (U, A)
    const float* __restrict__ b2,     // (A,)
    const float* __restrict__ v,      // (A,)
    const float* __restrict__ bv,     // (1,)
    const float* __restrict__ h,      // (B, U)
    float* __restrict__ ctx,          // (B, D)
    float* __restrict__ alphas,       // (B, T, R)
    int R, int A, int D, int U, int T, int t, float attn_slope) {
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

  block_vecmat(sh_h, U, w2, A, sh_hw, sh_part);
  for (int a = tid; a < A; a += blockDim.x)
    sh_hw[a] = lrelu(sh_hw[a] + b2[a], attn_slope);
  __syncthreads();

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

  // ctx = alpha (R) times this row's features (R, D)
  block_vecmat(sh_e, R, feat + (size_t)b * R * D, D, ctx + (size_t)b * D,
               sh_part);
}

// Steps 2-4: a tile of kTileRows batch rows and kTileCols units. The input
// is x = [in0 | in1 | in2] (widths k0, k1, k2), the weights W have
// gate_cols(CELL) * N columns, rows [0, ka) in wa and [ka, K) in wb, with
// K = k0 + k1 + k2.
//   kDense: out[b, n] = act(x W + bias, slope)            (slope 1: identity)
//   kLSTM:  gates of unit n at columns g * N + n; writes h' to out and
//           updates c in place.
//   kGRU:   gates [z | r | h~]; bias is b_in and bias2 b_rec; wa is Wx and
//           wb Wh, so rows >= ka are the recurrent part; in2 is the carried
//           h (k2 = N), or k2 = 0 under zero state, where h = 0. Writes h'.
// Block (kTileCols, kKSlices); grid (ceil(N / kTileCols), ceil(B / kTileRows)).
// Shared memory: max(kTileRows * K, kKSlices * gate_sums * kTileRows *
// kTileCols) floats.
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
    float* __restrict__ out,          // (B, N)
    float* __restrict__ c) {          // (B, N), kLSTM only
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
    if constexpr (CELL == kLSTM) {
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) z[g] = s[g] + bias[(size_t)g * N + col];
      const float cn = sigmoid(z[1]) * c[o] + sigmoid(z[0]) * tanhf(z[2]);
      c[o] = cn;
      out[o] = sigmoid(z[3]) * tanhf(cn);
    } else if constexpr (CELL == kGRU) {
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

size_t rows_smem_bytes(int K, int cell) {
  const int staged = kTileRows * K;
  const int sums = kKSlices * gate_sums(cell) * kTileRows * kTileCols;
  return sizeof(float) * (size_t)(staged > sums ? staged : sums);
}

unsigned ceil_div(int n, int d) { return (unsigned)((n + d - 1) / d); }

// Everything one decode reads and writes; the cell's own pointers are
// b (LSTM) or b_in and b_rec (GRU), and c (LSTM only).
struct Decode {
  const float *pre, *features, *w2, *b2, *v, *bv, *wx, *wh, *b, *b_rec, *wi,
      *bi, *wo, *bo, *emb_table;
  float *emb, *h_a, *h_b, *c, *ctx, *hi, *logits;
  int* words;
  float* alphas;
  int B, R, A, D, E, U, H, V, T;
  bool zero_state;
  float slope, attn_slope;
};

template <int CELL>
int run_decode(const Decode& d, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // the GRU in zero state reads no recurrent rows: K = D + E
  const bool recurrent = !(CELL == kGRU && d.zero_state);

  const size_t attn_smem =
      sizeof(float) * (size_t)(d.U + kThreads + d.A + d.R + 32);
  const size_t cell_smem =
      rows_smem_bytes(d.D + d.E + (recurrent ? d.U : 0), CELL);
  const size_t inter_smem = rows_smem_bytes(d.U, kDense);
  const size_t out_smem = rows_smem_bytes(d.H, kDense);
  const size_t dense_smem = inter_smem > out_smem ? inter_smem : out_smem;
  if ((err = cudaFuncSetAttribute(attention_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)attn_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(rows_kernel<CELL>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)cell_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(rows_kernel<kDense>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)dense_smem)) != cudaSuccess)
    return (int)err;

  const dim3 tile(kTileCols, kKSlices);
  const unsigned row_tiles = ceil_div(d.B, kTileRows);
  const dim3 cell_grid(ceil_div(d.U, kTileCols), row_tiles);
  const dim3 inter_grid(ceil_div(d.H, kTileCols), row_tiles);
  const dim3 out_grid(ceil_div(d.V, kTileCols), row_tiles);

  float* h_cur = d.h_a;
  float* h_next = d.h_b;
  for (int t = 0; t < d.T; ++t) {
    attention_kernel<<<d.B, kThreads, attn_smem, stream>>>(
        d.pre, d.features, d.w2, d.b2, d.v, d.bv, h_cur, d.ctx, d.alphas, d.R,
        d.A, d.D, d.U, d.T, t, d.attn_slope);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rows_kernel<CELL><<<cell_grid, tile, cell_smem, stream>>>(
        d.ctx, d.D, d.emb, d.E, recurrent ? h_cur : nullptr,
        recurrent ? d.U : 0, d.wx, d.D + d.E, d.wh, d.b, d.b_rec, d.B, d.U,
        1.f, h_next, d.c);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rows_kernel<kDense><<<inter_grid, tile, inter_smem, stream>>>(
        h_next, d.U, nullptr, 0, nullptr, 0, d.wi, d.U, nullptr, d.bi,
        nullptr, d.B, d.H, d.slope, d.hi, nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rows_kernel<kDense><<<out_grid, tile, out_smem, stream>>>(
        d.hi, d.H, nullptr, 0, nullptr, 0, d.wo, d.H, nullptr, d.bo, nullptr,
        d.B, d.V, 1.f, d.logits, nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    argmax_embed_kernel<<<d.B, kThreads, 0, stream>>>(
        d.logits, d.emb_table, d.emb, d.words, d.V, d.E, d.T, t);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    float* tmp = h_cur;
    h_cur = h_next;
    h_next = tmp;
  }
  return 0;
}

}  // namespace

extern "C" {

// K2: all T greedy steps of an LSTM NIC. emb (B, E) holds the start
// embedding on entry, h_a and c (B, U) the initial carry; h_b, ctx (B, D),
// hi (B, H) and logits (B, V) are scratch. Writes words (B, T) and alphas
// (B, T, R). slope and attn_slope are the head's and the attention's
// negative slopes. Returns 0 on success, else the first CUDA error (widths
// that need more shared memory than a block may have fail in
// cudaFuncSetAttribute).
int mtt_fused_greedy_decode(
    const float* pre, const float* features, const float* w2, const float* b2,
    const float* v, const float* bv, const float* wx, const float* wh,
    const float* b, const float* wi, const float* bi, const float* wo,
    const float* bo, const float* emb_table, float* emb, float* h_a,
    float* h_b, float* c, float* ctx, float* hi, float* logits, int* words,
    float* alphas, int B, int R, int A, int D, int E, int U, int H, int V,
    int T, float slope, float attn_slope, int device, void* stream_ptr) {
  const Decode d{pre, features, w2, b2, v, bv, wx, wh, b, nullptr, wi, bi,
                 wo, bo, emb_table, emb, h_a, h_b, c, ctx, hi, logits, words,
                 alphas, B, R, A, D, E, U, H, V, T, false, slope, attn_slope};
  return run_decode<kLSTM>(d, device, stream_ptr);
}

// K3: all T greedy steps of a GRU NIC, as mtt_fused_greedy_decode with the
// input and recurrent biases b_in, b_rec (3U) in place of b and no c.
// zero_state != 0 restarts the recurrence from zeros every step.
int mtt_fused_greedy_decode_gru(
    const float* pre, const float* features, const float* w2, const float* b2,
    const float* v, const float* bv, const float* wx, const float* wh,
    const float* b_in, const float* b_rec, const float* wi, const float* bi,
    const float* wo, const float* bo, const float* emb_table, float* emb,
    float* h_a, float* h_b, float* ctx, float* hi, float* logits, int* words,
    float* alphas, int B, int R, int A, int D, int E, int U, int H, int V,
    int T, int zero_state, float slope, float attn_slope, int device,
    void* stream_ptr) {
  const Decode d{pre, features, w2, b2, v, bv, wx, wh, b_in, b_rec, wi, bi,
                 wo, bo, emb_table, emb, h_a, h_b, nullptr, ctx, hi, logits,
                 words, alphas, B, R, A, D, E, U, H, V, T, zero_state != 0,
                 slope, attn_slope};
  return run_decode<kGRU>(d, device, stream_ptr);
}

const char* mtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
