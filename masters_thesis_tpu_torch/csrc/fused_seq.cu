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

#include "step_kernels.cuh"
#include "tile_kernels.cuh"

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

}  // extern "C"
