// Teacher-forced attention+LSTM sequence forward of the NIC decoder, with
// the residuals its custom backward reads, for Hopper (sm_90a): K4.
//
// K4 replaces the Pallas TPU kernel masters_thesis_tpu/ops/fused_seq.py::
// _forward_pallas (:204; body _seq_kernel at :148). For every batch row and
// t = 0..T-1, from h = c = 0:
//
//   hw_pre = h W2 + b2,  hw = act(hw_pre, attn_slope)
//   e_r    = tanh(pre_r + hw) . v + bv,  alpha = softmax_r(e)
//   ctx    = sum_r alpha_r features_r
//   z      = [ctx ; emb_t] Wx + h Wh + b,  gates [i | f | g | o]
//   c'     = sig(f) c + sig(i) tanh(g),  h' = sig(o) tanh(c')
//
// and it writes h', c', alpha, z and hw_pre of every step, time-major:
// (T, B, U) twice, (T, B, R), (T, B, 4U) and (T, B, A). The TPU kernel pads
// the regions to a multiple of 8 for its (8, 128) tiling and masks them to
// -1e30; a padded region's alpha is exactly 0, so here the regions are not
// padded and R is the true count.
//
// What bounds it on this card. The TPU kernel keeps Wx and Wh resident in
// VMEM (vmem_limit_bytes 100 MB). An SM has 227 KB of shared memory and the
// flagship's fp32 Wx and Wh alone are 8.7 MB (544 x 2048 and 512 x 2048);
// at the wide shape of scripts/fused_seq_probe.py (B 256, U 2048, E 1024,
// D 128) they are 105 MB, more than the 50 MB L2. Counting each input byte
// once, a flagship forward (B 64, T 15) moves ~30 MB (~9 us at 3.35 TB/s)
// and does ~4.2 GFLOP (~63 us at 67 TFLOP/s), the wide one 207 GFLOP
// (~3.1 ms): both are bound by operations. The steps are sequential, so at
// flagship the per-step L2 streams and launch gaps are the real limits.
//
// What the design does about it. One C entry point loops over T on the host
// and launches three kernels a step on the caller's stream, with no host
// synchronisation:
//   1. tile_kernel, dense (tile_kernels.cuh): hw_pre = h W2 + b2 for the
//                         whole batch, straight into hwps[t], as the TPU
//                         kernel forms it, one product over its batch tile;
//   2. attention_kernel (step_kernels.cuh): reads hwps[t], writes
//                         alphas[t] and ctx (B, D) scratch;
//   3. tile_kernel, LSTM: x = [ctx | emb[t] | h] times [Wx ; Wh], the cell
//                         in registers: reads c from cseq[t-1], writes
//                         z[t], cseq[t] and hseq[t].
// h is hseq[t-1] (h0 at t = 0), c cseq[t-1] (c0). Each step writes a fresh
// slot of the time-major outputs, which keeps every slice a contiguous
// (B, .) block, so the kernels need no row strides and the backward reads
// contiguous steps. The tile kernel streams the weights through a ring of
// shared-memory stages (filled by TMA for the wide shape's 128-row tile, by
// cp.async for the others), once per tile of rows. Each product's plan, its
// tile, feed and slices, is made in Python (ops/tiles.py) and passed in: an
// unknown tile or one of the wrong kind fails in tile_prepare, a feed or
// slices the tile cannot take in tile_launch. K2 runs its h W2 and its
// cell on the same tiles with the same plans, so K4 on K2's words gives
// K2's alphas. The attention's width is limited by its shared memory
// (A + R + 288 floats); one that cannot fit fails in
// cudaFuncSetAttribute. Tensor cores (wgmma, with bf16 or TF32 weights) and
// a CUDA graph are later work.
//
// All math is fp32 with fp32 accumulation. The Python wrapper passes outputs
// and scratch. Each launch is checked with cudaGetLastError, and the entry
// point returns the first error.
//
// The bf16-weight variant (mtt_fused_seq_forward_bf16) is the TPU kernel at
// compute dtype bf16 (_forward_pallas casts w2, wx and wh to bf16 at :228,
// and _seq_kernel casts h and x to the weights' dtype at :163-184): W2, Wx
// and Wh are read as bf16, h and [ctx ; emb_t] are rounded to bf16 (round to
// nearest even, as torch's .to(bfloat16)) before the products, and every
// product is summed in fp32; b2, v, bv, b, ctx, the carries and every output
// stay fp32. Its bound: the flagship forward reads its bf16 weights once
// (~4.4 MB) beside the same fp32 activations as the fp32 kernel (~26 MB all
// told, ~8 us at 3.35 TB/s) and does ~2.1 G multiply-adds (~4.3 us at the
// card's 989 TFLOP/s dense bf16 tensor-core peak, NVIDIA's H100 SXM data
// sheet), so bytes bound it. The design is the simple one: a step is
// bfloat_rows_kernel for h W2, the same attention_kernel as the fp32 kernel's,
// and bfloat_rows_kernel for the LSTM cell. A block of 256 threads owns 8 or
// 32 batch rows (8 up to B 128, so that the flagship's 64 rows still make
// 128 blocks of the cell) x 32 output units (x 4 gates for the cell); the
// rounded rows and the weights, widened to fp32, pass through shared memory
// 32 reduction rows at a time, and each thread sums 1 or 4 rows x its unit's
// gates in fp32 on the CUDA cores and forms the cell in registers. The fp32 kernels
// above (the tile kernel's instantiations) are untouched. wgmma and TMA for
// bf16 are later work.

#include <cuda_bf16.h>

#include "step_kernels.cuh"
#include "tile_kernels.cuh"

namespace {

constexpr int kBfUnits = 32;    // output units a block (one per lane)
constexpr int kBfK = 32;        // reduction rows a stage
constexpr int kBfThreads = 256; // 8 warps, each kRowsPer of the block's rows
constexpr int kBfWarps = kBfThreads / kBfUnits;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// out = round(x) W + bias for the rows of x = [x0 | x1 | x2] (widths k0, k1,
// k2, row-major, rows contiguous) against W = [w0 ; w1] bf16 ((k0 + k1, G N)
// and (k2, G N); w1 may be null when k2 is 0), G = 4 gates [i | f | g | o]
// of N units for the LSTM cell (kLstm), G = 1 for a dense product; a block
// owns 8 x kRowsPer rows. The cell writes z, the new c (from c_prev) and h;
// the dense product writes out.
template <bool kLstm, int kRowsPer>
__global__ void __launch_bounds__(kBfThreads) bfloat_rows_kernel(
    const float* __restrict__ x0, const float* __restrict__ x1,
    const float* __restrict__ x2, int k0, int k1, int k2,
    const __nv_bfloat16* __restrict__ w0,
    const __nv_bfloat16* __restrict__ w1, const float* __restrict__ bias,
    int B, int N, const float* __restrict__ c_prev, float* __restrict__ out,
    float* __restrict__ c_out, float* __restrict__ h_out) {
  constexpr int G = kLstm ? 4 : 1;
  constexpr int kBfRows = kBfWarps * kRowsPer;
  __shared__ float sx[kBfRows][kBfK + 1];
  __shared__ float sw[kBfK][G][kBfUnits];
  const int lane = threadIdx.x % kBfUnits;
  const int group = threadIdx.x / kBfUnits;
  const int row0 = blockIdx.y * kBfRows;
  const int unit0 = blockIdx.x * kBfUnits;
  const int K = k0 + k1 + k2;
  const int cols = G * N;

  float acc[kRowsPer][G];
#pragma unroll
  for (int r = 0; r < kRowsPer; ++r)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[r][g] = 0.f;

  for (int kb = 0; kb < K; kb += kBfK) {
    // the rounded inputs: the block's rows x 32 reduction rows
    for (int e = threadIdx.x; e < kBfRows * kBfK; e += kBfThreads) {
      const int r = e / kBfK, kk = e % kBfK, k = kb + kk, row = row0 + r;
      float v = 0.f;
      if (row < B && k < K) {
        v = k < k0 ? x0[(size_t)row * k0 + k]
            : k < k0 + k1 ? x1[(size_t)row * k1 + (k - k0)]
                          : x2[(size_t)row * k2 + (k - k0 - k1)];
      }
      sx[r][kk] = round_bf16(v);
    }
    // the weights, widened: 32 reduction rows x G gates x 32 units
    for (int e = threadIdx.x; e < kBfK * G * kBfUnits; e += kBfThreads) {
      const int j = e % kBfUnits, g = (e / kBfUnits) % G,
                kk = e / (kBfUnits * G), k = kb + kk, unit = unit0 + j;
      float v = 0.f;
      if (k < K && unit < N) {
        const size_t col = (size_t)g * N + unit;
        v = __bfloat162float(k < k0 + k1 ? w0[(size_t)k * cols + col]
                                         : w1[(size_t)(k - k0 - k1) * cols +
                                              col]);
      }
      sw[kk][g][j] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBfK; ++kk) {
      float w[G];
#pragma unroll
      for (int g = 0; g < G; ++g) w[g] = sw[kk][g][lane];
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r) {
        const float xv = sx[group * kRowsPer + r][kk];
#pragma unroll
        for (int g = 0; g < G; ++g) acc[r][g] = fmaf(xv, w[g], acc[r][g]);
      }
    }
    __syncthreads();
  }

  const int unit = unit0 + lane;
  if (unit >= N) return;
#pragma unroll
  for (int r = 0; r < kRowsPer; ++r) {
    const int row = row0 + group * kRowsPer + r;
    if (row >= B) continue;
    if constexpr (kLstm) {
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        z[g] = acc[r][g] + bias[g * N + unit];
        out[(size_t)row * cols + g * N + unit] = z[g];
      }
      const size_t at = (size_t)row * N + unit;
      const float c = sigmoid(z[1]) * c_prev[at] + sigmoid(z[0]) * tanhf(z[2]);
      c_out[at] = c;
      h_out[at] = sigmoid(z[3]) * tanhf(c);
    } else {
      out[(size_t)row * N + unit] = acc[r][0] + bias[unit];
    }
  }
}

// bfloat_rows_kernel on B rows and N units: 8 rows a block up to B 128,
// else 32.
template <bool kLstm>
cudaError_t launch_bfloat_rows(
    const float* x0, const float* x1, const float* x2, int k0, int k1, int k2,
    const __nv_bfloat16* w0, const __nv_bfloat16* w1, const float* bias,
    int B, int N, const float* c_prev, float* out, float* c_out,
    float* h_out, cudaStream_t stream) {
  const int units = (N + kBfUnits - 1) / kBfUnits;
  if (B <= 128) {
    const dim3 grid(units, (B + kBfWarps - 1) / kBfWarps);
    bfloat_rows_kernel<kLstm, 1><<<grid, kBfThreads, 0, stream>>>(
        x0, x1, x2, k0, k1, k2, w0, w1, bias, B, N, c_prev, out, c_out,
        h_out);
  } else {
    const dim3 grid(units, (B + 4 * kBfWarps - 1) / (4 * kBfWarps));
    bfloat_rows_kernel<kLstm, 4><<<grid, kBfThreads, 0, stream>>>(
        x0, x1, x2, k0, k1, k2, w0, w1, bias, B, N, c_prev, out, c_out,
        h_out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K4: the whole teacher-forced forward. pre (B, R, A), features (B, R, D),
// emb (T, B, E) time-major, w2 (U, A), b2 and v (A,), bv (1,), wx (D+E, 4U),
// wh (U, 4U), b (4U,), the initial carry h0 and c0 (B, U); ctx (B, D) is
// scratch. Writes hseq and cseq (T, B, U), alphas (T, B, R), zs (T, B, 4U)
// and hwps (T, B, A). cell_* and hw_* are the plans of the cell (an LSTM
// tile) and of h W2 (a dense one): the index in kTiles, the feed and the
// slices. Returns 0 on success, else the first CUDA error.
int mtt_fused_seq_forward(
    const float* pre, const float* features, const float* emb,
    const float* w2, const float* b2, const float* v, const float* bv,
    const float* wx, const float* wh, const float* b, const float* h0,
    const float* c0, float* ctx, float* hseq, float* cseq, float* alphas,
    float* zs, float* hwps, int B, int R, int A, int D, int E, int U, int T,
    float attn_slope, int cell_tile, int cell_feed, int cell_slices,
    int hw_tile, int hw_feed, int hw_slices, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);

  const size_t attn_smem = attention_smem_bytes(A, R);
  if ((err = tile_prepare(cell_tile, 4)) != cudaSuccess ||
      (err = tile_prepare(hw_tile, 1)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(attention_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)attn_smem)) != cudaSuccess)
    return (int)err;

  const size_t bu = (size_t)B * U;
  for (int t = 0; t < T; ++t) {
    const float* h = t == 0 ? h0 : hseq + (t - 1) * bu;
    const float* c = t == 0 ? c0 : cseq + (t - 1) * bu;
    float* hw = hwps + (size_t)t * B * A;
    // h W2 + b2 for the whole batch
    if ((err = tile_launch(hw_tile, hw_feed, hw_slices,
                           {h, nullptr, nullptr, U, 0, 0, w2, nullptr, U, b2,
                            B, A, 1.f, hw, nullptr, nullptr, nullptr},
                           stream)) != cudaSuccess)
      return (int)err;
    // step t's (B, R) block of the (T, B, R) alphas is a (B, 1, R) array
    attention_kernel<<<B, kThreads, attn_smem, stream>>>(
        pre, features, v, bv, ctx, alphas + (size_t)t * B * R, hw, R, A, D,
        attn_slope, 1, 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = tile_launch(cell_tile, cell_feed, cell_slices,
                           {ctx, emb + (size_t)t * B * E, h, D, E, U, wx, wh,
                            D + E, b, B, U, 1.f, hseq + t * bu, cseq + t * bu,
                            c, zs + (size_t)t * 4 * bu},
                           stream)) != cudaSuccess)
      return (int)err;
  }
  return 0;
}

// K4 with bf16 W2, Wx and Wh (the arguments of mtt_fused_seq_forward less
// the plans; w2, wx and wh point to bf16). Returns 0 on success, else the
// first CUDA error.
int mtt_fused_seq_forward_bf16(
    const float* pre, const float* features, const float* emb,
    const __nv_bfloat16* w2, const float* b2, const float* v, const float* bv,
    const __nv_bfloat16* wx, const __nv_bfloat16* wh, const float* b,
    const float* h0, const float* c0, float* ctx, float* hseq, float* cseq,
    float* alphas, float* zs, float* hwps, int B, int R, int A, int D, int E,
    int U, int T, float attn_slope, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);

  const size_t attn_smem = attention_smem_bytes(A, R);
  if ((err = cudaFuncSetAttribute(attention_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)attn_smem)) != cudaSuccess)
    return (int)err;

  const size_t bu = (size_t)B * U;
  for (int t = 0; t < T; ++t) {
    const float* h = t == 0 ? h0 : hseq + (t - 1) * bu;
    const float* c = t == 0 ? c0 : cseq + (t - 1) * bu;
    float* hw = hwps + (size_t)t * B * A;
    if ((err = launch_bfloat_rows<false>(h, nullptr, nullptr, U, 0, 0, w2,
                                         nullptr, b2, B, A, nullptr, hw,
                                         nullptr, nullptr, stream)) !=
        cudaSuccess)
      return (int)err;
    attention_kernel<<<B, kThreads, attn_smem, stream>>>(
        pre, features, v, bv, ctx, alphas + (size_t)t * B * R, hw, R, A, D,
        attn_slope, 1, 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = launch_bfloat_rows<true>(
             ctx, emb + (size_t)t * B * E, h, D, E, U, wx, wh, b, B, U, c,
             zs + (size_t)t * 4 * bu, cseq + t * bu, hseq + t * bu,
             stream)) != cudaSuccess)
      return (int)err;
  }
  return 0;
}

}  // extern "C"
