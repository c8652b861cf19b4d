// Whole greedy decode of the NIC caption decoder, for Hopper (sm_90a): K2
// for the LSTM cell (LcNIC) and K3 for the GRU cell (CnnRnn). Both form
// h W2 + b2 for the whole batch on the tile kernel (tile_kernels.cuh) and
// then run the attention and argmax kernels of step_kernels.cuh; K2 runs
// its cell and head on the tile kernel too, K3 on step_kernels.cuh's row
// kernel.
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
// cell's and the head's weights from L2 once per batch-row tile. Against
// that, a step's arithmetic is B x (weights' elements) fp32 FMAs, ~0.23 G
// (LcNIC) and ~0.25 G (CnnRnn, zero-state), on CUDA cores, with no tensor
// cores in this version. Counting each input byte once, a decode is bound
// by operations (~7 GFLOP over 67 TFLOP/s, ~0.1 ms), but the step-to-step
// dependence and the per-tile weight streams make L2 latency the real
// limit. Steps are strictly sequential (each needs the previous word).
//
// What the design does about it. One C entry point a cell loops over the T
// steps on the host and launches a fixed chain of six kernels per step on
// the caller's stream, without host synchronisation:
//   1. tile_kernel, dense: hw_pre = h W2 + b2 for the whole batch into a
//                         (B, A) scratch, as the TPU kernels'
//                         _attention_step forms it, one product over the
//                         batch tile: W2 is read once a step, not once per
//                         row;
//   2. attention_kernel   (step_kernels.cuh) scores, softmax, alphas[b, t, :],
//                         ctx, from that scratch;
//   3. the cell over [ctx | emb | h]. K2: tile_kernel, LSTM, the cell in its
//                         epilogue; at B 64 a tile of 32 rows x 8 units
//                         streams Wx and Wh (8.65 MB) once per 32 rows
//                         instead of rows_kernel's once per 8. K3:
//                         rows_kernel<kGRU>, which keeps the h~ gate's input
//                         and recurrent sums apart (r multiplies only the
//                         recurrent one) and, in zero state, skips the Wh
//                         rows. h (and K2's c) is double buffered because
//                         other blocks still read the old one;
//   4. act(h Wi + bi):    K2 a dense tile (128 blocks at LcNIC's 512 -> 256
//                         where rows_kernel had 64); K3 rows_kernel<kDense>;
//   5. the logits:        K2 a dense tile of 32 rows x 16 units (Wo, 5.2 MB,
//                         staged twice a step instead of 8 times); K3
//                         rows_kernel<kDense> over vocab tiles of 32 columns;
//   6. argmax_embed_kernel  one block per row: first-index argmax,
//                         words[b, t], and a direct row gather of the next
//                         embedding (the TPU kernels' one-hot matmul exists
//                         only for the MXU).
// Each tile-kernel launch runs the plan (tile, feed, slices) that the
// Python wrapper made (ops/fused_decode.py, ops/tiles.py): tile_prepare
// refuses a tile that is unknown or of the wrong kind, tile_launch a feed or
// slices the tile cannot take, and nothing falls back to another kernel.
// K2's plans sum K in the order its row kernel and attention summed before
// it ran on the tile kernel: the cell and the head in rows_kernel's
// kKSlices classes, h W2 in block_vecmat's kThreads / A where that splits a
// column. Tensor cores, bf16 weights, a persistent kernel and CUDA graphs
// are left for later work.
//
// All math is fp32 with fp32 accumulation. Kernels allocate nothing; the
// Python wrapper passes outputs and scratch. Each launch is checked with
// cudaGetLastError, and the entry points return the first error.
//
// The bf16-weight K2 and K3 (the TPU kernels as the TPU runs them, with
// bf16 weights) are one persistent cooperative kernel of their own, in
// decode_bf16.cu.

#include "step_kernels.cuh"
#include "tile_kernels.cuh"

namespace {

__device__ __forceinline__ void take_better(float& v, int& i, float v2, int i2) {
  // first index of the maximum; i < 0 marks "no candidate yet"
  if (i2 < 0) return;
  if (i < 0 || v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Step 6: one block per batch row.
__global__ void argmax_embed_kernel(
    const float* __restrict__ logits,     // (B, N)
    const float* __restrict__ emb_table,  // (V, E)
    float* __restrict__ emb,              // (B, E), the next one
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

// A tile-kernel launch's plan: index in kTiles, feed, slices (ops/tiles.py)
struct Plan {
  int tile, feed, slices;
};

// Everything one decode reads and writes; the cell's own pointers are
// b and c_a, c_b (LSTM) or b_in and b_rec (GRU). hw (B, A) is h W2 + b2.
// The LSTM runs all four plans, the GRU only hw_plan.
struct Decode {
  const float *pre, *features, *w2, *b2, *v, *bv, *wx, *wh, *b, *b_rec, *wi,
      *bi, *wo, *bo, *emb_table;
  float *emb, *h_a, *h_b, *c_a, *c_b, *ctx, *hi, *logits, *hw;
  int* words;
  float* alphas;
  int B, R, A, D, E, U, H, V, T;
  bool zero_state;
  Plan hw_plan, cell_plan, inter_plan, out_plan;
  float slope, attn_slope;
};

cudaError_t launch(const Plan& p, const TileArgs& a, cudaStream_t stream) {
  return tile_launch(p.tile, p.feed, p.slices, a, stream);
}

template <int CELL>
int run_decode(const Decode& d, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  constexpr bool kLstm = CELL == kLSTM;
  // the GRU in zero state reads no recurrent rows: K = D + E
  const bool recurrent = !(CELL == kGRU && d.zero_state);

  const size_t attn_smem = attention_smem_bytes(d.A, d.R);
  if ((err = tile_prepare(d.hw_plan.tile, 1)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(attention_kernel<>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)attn_smem)) != cudaSuccess)
    return (int)err;
  size_t cell_smem = 0, inter_smem = 0, out_smem = 0;
  if constexpr (kLstm) {
    if ((err = tile_prepare(d.cell_plan.tile, 4)) != cudaSuccess ||
        (err = tile_prepare(d.inter_plan.tile, 1)) != cudaSuccess ||
        (err = tile_prepare(d.out_plan.tile, 1)) != cudaSuccess)
      return (int)err;
  } else {
    cell_smem = rows_smem_bytes(d.D + d.E + (recurrent ? d.U : 0), CELL);
    inter_smem = rows_smem_bytes(d.U, kDense);
    out_smem = rows_smem_bytes(d.H, kDense);
    const size_t dense_smem = inter_smem > out_smem ? inter_smem : out_smem;
    if ((err = cudaFuncSetAttribute(rows_kernel<CELL>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)cell_smem)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(rows_kernel<kDense>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)dense_smem)) != cudaSuccess)
      return (int)err;
  }

  const dim3 tile(kTileCols, kKSlices);
  const unsigned row_tiles = ceil_div(d.B, kTileRows);
  const dim3 cell_grid(ceil_div(d.U, kTileCols), row_tiles);
  const dim3 inter_grid(ceil_div(d.H, kTileCols), row_tiles);
  const dim3 out_grid(ceil_div(d.V, kTileCols), row_tiles);

  float* h_cur = d.h_a;
  float* h_next = d.h_b;
  float* c_cur = d.c_a;
  float* c_next = d.c_b;
  for (int t = 0; t < d.T; ++t) {
    // 1-2: h W2 + b2 for the whole batch, then the attention
    if ((err = launch(d.hw_plan,
                      {h_cur, nullptr, nullptr, d.U, 0, 0, d.w2, nullptr,
                       d.U, d.b2, d.B, d.A, 1.f, d.hw, nullptr, nullptr,
                       nullptr},
                      stream)) != cudaSuccess)
      return (int)err;
    attention_kernel<<<d.B, kThreads, attn_smem, stream>>>(
        d.pre, d.features, d.v, d.bv, d.ctx, d.alphas, d.hw, d.R, d.A, d.D,
        d.attn_slope, d.T, t);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    // 3-5: the cell, then the head
    if constexpr (kLstm) {
      if ((err = launch(d.cell_plan,
                        {d.ctx, d.emb, h_cur, d.D, d.E, d.U, d.wx, d.wh,
                         d.D + d.E, d.b, d.B, d.U, 1.f, h_next, c_next, c_cur,
                         nullptr},
                        stream)) != cudaSuccess ||
          (err = launch(d.inter_plan,
                        {h_next, nullptr, nullptr, d.U, 0, 0, d.wi, nullptr,
                         d.U, d.bi, d.B, d.H, d.slope, d.hi, nullptr, nullptr,
                         nullptr},
                        stream)) != cudaSuccess ||
          (err = launch(d.out_plan,
                        {d.hi, nullptr, nullptr, d.H, 0, 0, d.wo, nullptr,
                         d.H, d.bo, d.B, d.V, 1.f, d.logits, nullptr, nullptr,
                         nullptr},
                        stream)) != cudaSuccess)
        return (int)err;
      float* tmp = c_cur;
      c_cur = c_next;
      c_next = tmp;
    } else {
      rows_kernel<CELL><<<cell_grid, tile, cell_smem, stream>>>(
          d.ctx, d.D, d.emb, d.E, recurrent ? h_cur : nullptr,
          recurrent ? d.U : 0, d.wx, d.D + d.E, d.wh, d.b, d.b_rec, d.B, d.U,
          1.f, h_next);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      rows_kernel<kDense><<<inter_grid, tile, inter_smem, stream>>>(
          h_next, d.U, nullptr, 0, nullptr, 0, d.wi, d.U, nullptr, d.bi,
          nullptr, d.B, d.H, d.slope, d.hi);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      rows_kernel<kDense><<<out_grid, tile, out_smem, stream>>>(
          d.hi, d.H, nullptr, 0, nullptr, 0, d.wo, d.H, nullptr, d.bo, nullptr,
          d.B, d.V, 1.f, d.logits);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    // 6: the argmax and the next embedding
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
// embedding on entry, h_a and c_a (B, U) the initial carry; h_b, c_b,
// ctx (B, D), hi (B, H), logits (B, V) and hw (B, A) are scratch. Writes
// words (B, T) and alphas (B, T, R). hw_*, cell_*, inter_* and out_* are
// the plans of h W2, the cell, the first head layer and the logits: the
// index in kTiles, the feed and the slices. slope and attn_slope are the
// head's and the attention's negative slopes. Returns 0 on success, else
// the first CUDA error: cudaErrorInvalidValue for a plan the tile kernel
// cannot run (an unknown tile or one of the wrong kind before anything is
// launched; a feed or slices the tile has not at that product's first
// launch, which it does not make).
int mtt_fused_greedy_decode(
    const float* pre, const float* features, const float* w2, const float* b2,
    const float* v, const float* bv, const float* wx, const float* wh,
    const float* b, const float* wi, const float* bi, const float* wo,
    const float* bo, const float* emb_table, float* emb, float* h_a,
    float* h_b, float* c_a, float* c_b, float* ctx, float* hi, float* logits,
    float* hw, int* words, float* alphas, int B, int R, int A, int D, int E,
    int U, int H, int V, int T, int hw_tile, int hw_feed, int hw_slices,
    int cell_tile, int cell_feed, int cell_slices, int inter_tile,
    int inter_feed, int inter_slices, int out_tile, int out_feed,
    int out_slices, float slope, float attn_slope, int device,
    void* stream_ptr) {
  const Decode d{pre, features, w2, b2, v, bv, wx, wh, b, nullptr, wi, bi,
                 wo, bo, emb_table, emb, h_a, h_b, c_a, c_b, ctx, hi, logits,
                 hw, words, alphas, B, R, A, D, E, U, H, V, T, false,
                 {hw_tile, hw_feed, hw_slices},
                 {cell_tile, cell_feed, cell_slices},
                 {inter_tile, inter_feed, inter_slices},
                 {out_tile, out_feed, out_slices}, slope, attn_slope};
  return run_decode<kLSTM>(d, device, stream_ptr);
}

// K3: all T greedy steps of a GRU NIC, as mtt_fused_greedy_decode with the
// input and recurrent biases b_in, b_rec (3U) in place of b, no c and one
// plan, hw_*, that of h W2. zero_state != 0 restarts the recurrence from
// zeros every step.
int mtt_fused_greedy_decode_gru(
    const float* pre, const float* features, const float* w2, const float* b2,
    const float* v, const float* bv, const float* wx, const float* wh,
    const float* b_in, const float* b_rec, const float* wi, const float* bi,
    const float* wo, const float* bo, const float* emb_table, float* emb,
    float* h_a, float* h_b, float* ctx, float* hi, float* logits, float* hw,
    int* words, float* alphas, int B, int R, int A, int D, int E, int U,
    int H, int V, int T, int zero_state, int hw_tile, int hw_feed,
    int hw_slices, float slope, float attn_slope, int device,
    void* stream_ptr) {
  const Plan none{-1, 0, 0};
  const Decode d{pre, features, w2, b2, v, bv, wx, wh, b_in, b_rec, wi, bi,
                 wo, bo, emb_table, emb, h_a, h_b, nullptr, nullptr, ctx, hi,
                 logits, hw, words, alphas, B, R, A, D, E, U, H, V, T,
                 zero_state != 0, {hw_tile, hw_feed, hw_slices}, none, none,
                 none, slope, attn_slope};
  return run_decode<kGRU>(d, device, stream_ptr);
}

const char* mtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
