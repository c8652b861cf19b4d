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
// flagship's fp32 Wx and Wh alone are 8.7 MB (544 x 2048 and 512 x 2048), so
// every step streams them from the 50 MB L2, once per tile of 8 batch rows.
// Counting each input byte once, a flagship forward (B 64, T 15) moves
// ~30 MB (~9 us at 3.35 TB/s) and does ~4.2 GFLOP (~63 us at 67 TFLOP/s):
// bound by operations. The steps are sequential, so the real limits are the
// per-step L2 streams and launch gaps, as in K2.
//
// What the design does about it. One C entry point loops over T on the host
// and launches two kernels a step on the caller's stream, with no host
// synchronisation; both are K2's (step_kernels.cuh), so the three kernels
// share one proven attention and one proven cell:
//   1. attention_kernel   reads h from hseq[t-1] (h0 at t = 0), writes
//                         alphas[t] and hw_pre[t], and ctx (B, D) scratch;
//   2. rows_kernel<kLSTM, kSeq> on x = [ctx | emb[t] | h]: reads c from
//                         cseq[t-1] (c0 at t = 0), writes z[t], cseq[t] and
//                         hseq[t].
// Each step writes a fresh slot of the time-major outputs, which replaces
// K2's double-buffered h, and keeps every slice a contiguous (B, .) block, so
// K2's kernels need no row strides and the backward reads contiguous steps.
// Widths are limited only by shared memory: the cell tile stages 8 rows of
// K = D + E + U floats (102 KB at K = 3200); a width that cannot fit fails
// in cudaFuncSetAttribute. Tensor cores (wgmma), TMA, bf16 weights and a CUDA
// graph are later work.
//
// All math is fp32 with fp32 accumulation. The Python wrapper passes outputs
// and scratch. Each launch is checked with cudaGetLastError, and the entry
// point returns the first error.

#include "step_kernels.cuh"

extern "C" {

// K4: the whole teacher-forced forward. pre (B, R, A), features (B, R, D),
// emb (T, B, E) time-major, w2 (U, A), b2 and v (A,), bv (1,), wx (D+E, 4U),
// wh (U, 4U), b (4U,), the initial carry h0 and c0 (B, U); ctx (B, D) is
// scratch. Writes hseq and cseq (T, B, U), alphas (T, B, R), zs (T, B, 4U)
// and hwps (T, B, A). Returns 0 on success, else the first CUDA error.
int mtt_fused_seq_forward(
    const float* pre, const float* features, const float* emb,
    const float* w2, const float* b2, const float* v, const float* bv,
    const float* wx, const float* wh, const float* b, const float* h0,
    const float* c0, float* ctx, float* hseq, float* cseq, float* alphas,
    float* zs, float* hwps, int B, int R, int A, int D, int E, int U, int T,
    float attn_slope, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);

  const size_t attn_smem = attention_smem_bytes(U, A, R);
  const size_t cell_smem = rows_smem_bytes(D + E + U, kLSTM);
  if ((err = cudaFuncSetAttribute(attention_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)attn_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(rows_kernel<kLSTM, true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)cell_smem)) != cudaSuccess)
    return (int)err;

  const dim3 tile(kTileCols, kKSlices);
  const dim3 cell_grid(ceil_div(U, kTileCols), ceil_div(B, kTileRows));
  const size_t bu = (size_t)B * U;
  for (int t = 0; t < T; ++t) {
    const float* h = t == 0 ? h0 : hseq + (t - 1) * bu;
    const float* c = t == 0 ? c0 : cseq + (t - 1) * bu;
    // step t's (B, R) block of the (T, B, R) alphas is a (B, 1, R) array
    attention_kernel<true><<<B, kThreads, attn_smem, stream>>>(
        pre, features, w2, b2, v, bv, h, ctx, alphas + (size_t)t * B * R,
        hwps + (size_t)t * B * A, R, A, D, U, 1, 0, attn_slope);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rows_kernel<kLSTM, true><<<cell_grid, tile, cell_smem, stream>>>(
        ctx, D, emb + (size_t)t * B * E, E, h, U, wx, D + E, wh, b, nullptr, B,
        U, 1.f, hseq + t * bu, cseq + t * bu, c, zs + (size_t)t * 4 * bu);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
