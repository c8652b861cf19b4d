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
// cudaFuncSetAttribute. Tensor cores for fp32 weights (TF32 would change
// its numbers) and a CUDA graph are later work.
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
// stay fp32.
//
// What bounds it. Counting each input byte once, the flagship forward reads
// its bf16 weights (~4.4 MB) beside the fp32 activations (~26 MB all told,
// ~8 us at 3.35 TB/s) and does ~2.1 G multiply-adds (~4.3 us at the card's
// 989 TFLOP/s dense bf16 tensor-core peak, NVIDIA's H100 SXM data sheet), so
// bytes bound it; the wide forward's 103 G multiply-adds (~0.21 ms) bound
// it by operations. A step's cell is the one large product: at the wide
// shape 13.4 GFLOP over 52.4 MB of Wx and Wh (more than the 50 MB L2 with
// everything else a step touches); at flagship 0.28 GFLOP over 4.3 MB. The
// steps are sequential, so at flagship the attention, L2 latency and launch
// gaps set the pace, as for the fp32 kernel.
//
// What the design does about it. A step is three launches on the caller's
// stream, with no host synchronisation: h W2 (mma_tile_kernel<1>), the
// same attention_kernel as the fp32 kernel's, and the cell (wgmma_cell_kernel
// at the wide shape, else mma_tile_kernel<4>). Every product runs on the
// bf16 tensor cores with fp32 sums, and the weights stay bf16 from HBM to
// the tensor cores: no widened copy, no per-element conversion. Each input
// is rounded once a step where it is staged: h by the cell that makes it
// (its epilogue writes h' twice, fp32 to hseq and bf16 to a (2, B, U)
// ping-pong scratch that the next step's h W2 and cell read), emb once a
// call by the wrapper into its time-major bf16 copy, and ctx, fp32 out of
// the attention, as the cell stages it. Every gate of a (row, unit) lands
// in one thread's accumulators, so the cell runs in registers, as the fp32
// tile kernel's G = 4 epilogue does.
//   - wgmma_cell_kernel, the cell of batches above 128 rows whose segment
//     widths are multiples of 64 (ops/fused_seq.py's wgmma_cell): a block
//     of 128 rows x 32 units (x 4 gates), two warpgroups each issuing
//     wgmma.m64n128k16 on 64 rows, K in 64-k chunks through a ring of six
//     stages that thread 0 fills by TMA in 128-byte swizzle, the layout
//     wgmma reads, each stage completing on its mbarrier; one chunk's
//     products stay in flight while the next chunk lands. x comes from
//     maps of emb and the h scratch, W from a K-major (4U, K) copy of
//     [Wx ; Wh] that the wrapper makes once a call (a block's four gate
//     slices of a row of the row-major (K, 4U) W are 64-byte pieces, too
//     narrow for the 128-byte swizzle; the copy makes each gate's 32 units
//     x 64 k one box row), ctx is rounded and swizzled into the first
//     stages by every thread. The
//     wide cell's grid is 64 x 2 blocks, so its weights stream from HBM at
//     most twice a step (the two row tiles of a column tile run side by
//     side and share them through L2).
//   - mma_tile_kernel (mma_tile.cuh, shared with the bf16-weight K2 and
//     K3), every other product: mma.sync.m16n8k16, operands
//     loaded by ldmatrix (.trans for the row-major (K, G N) weights) from a
//     ring of bf16 stages filled by cp.async, by 16-byte copies where every
//     segment width, N and the bases allow them, else element by element
//     (rows past B, units past N and K past its end zero-filled). A warp's
//     n-tiles are the same 8 units of each of the G gates. The cell takes
//     32 rows x 8 units, its K split over 8 warps, a k16 slice each per
//     128-k chunk; the warps' sums meet in shared memory, where every
//     thread of the block adds up one (row, unit)'s in warp order (a fixed
//     order) and applies the cell, so that its transcendentals are spread
//     over the block: the flagship's cell is a grid of 64 x 2 = 128
//     blocks, each streaming 1/64 of the weights. h W2 (N = A) takes 16
//     rows x 8 columns (B <= 128) or 32 x 16, K split the same way.
// The fp32 kernels above (the tile kernel's instantiations and
// attention_kernel) are untouched.
//
// What still bounds it. The wide cell's 128 x 128 block tiles read their
// rows of x and their columns of W through L2, x 64 times and W twice:
// ~210 MB a step for 13.4 GFLOP. TMA multicast across a cluster's blocks
// (one L2 read for several tiles) would cut that. At flagship the step is
// latency: the attention, L2 round trips and launch gaps, for which a
// persistent kernel or a CUDA graph is later work.

#include <cuda_bf16.h>

#include "mma_tile.cuh"
#include "step_kernels.cuh"
#include "tile_kernels.cuh"

namespace {

// <G, MT, NU, KS, BK, STAGES>
const MmaConfig kMmaTiles[] = {
    mma_tile<4, 2, 1, 8, 128, 4>(),   // the cell: 32 rows x 8 units
    mma_tile<1, 1, 1, 8, 128, 4>(),   // h W2, B <= 128: 16 x 8
    mma_tile<1, 2, 2, 8, 128, 4>(),   // h W2, B > 128: 32 x 16
};

// ---- the wide cell on wgmma, fed by TMA ----

constexpr int kWgRows = 128;     // rows a block: two warpgroups of 64
constexpr int kWgUnits = 32;     // units a block, x 4 gates: 128 columns
constexpr int kWgK = 64;         // k a chunk: one 128-byte swizzled row
constexpr int kWgStages = 6;
constexpr int kWgTile = kWgRows * kWgK;  // bf16 of a stage's x, or its W^T
constexpr size_t kWgSmem = 1024 + sizeof(bf16) * kWgStages * 2 * kWgTile +
                           sizeof(uint64_t) * kWgStages;

// the maps of x's bf16 segments (emb, h) as (k_s, B), and of W^T (4U, K)
// as (K, U, 4), each box one 128-byte-swizzled stage
struct WgMaps {
  CUtensorMap x[2];
  CUtensorMap w;
};

// A wgmma operand in shared memory: K-major rows of 128 bytes in 128-byte
// swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t wg_desc(const bf16* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// d += a b for a warpgroup: a 64 x 16 (a), b 128 x 16 (b), both K-major
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// The LSTM cell of 128 rows x 32 units (x 4 gates) on the bf16 tensor
// cores by wgmma: x = [in0 | in1 | in2] against W^T = wt (4N, K), K-major,
// every segment width a multiple of 64. Thread 0 feeds a ring of stages by
// TMA, 128-byte swizzled as wgmma reads them, each completing on its
// mbarrier; the fp32 segment (ctx) is rounded and swizzled into the first
// stages by every thread before the ring starts. Each warpgroup takes 64
// rows x the block's 128 columns (gate g of unit u at column 32 g + u), so
// that every gate of a (row, unit) is in one thread's accumulators. Grid
// (ceil(N / 32), ceil(B / 128)).
__global__ void __launch_bounds__(256, 1)
wgmma_cell_kernel(MmaArgs a, const __grid_constant__ WgMaps maps) {
  extern __shared__ __align__(1024) uint8_t wg_sm[];
  uint8_t* base = wg_sm + ((1024 - (smem_u32(wg_sm) & 1023)) & 1023);
  bf16* ring = reinterpret_cast<bf16*>(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      base + sizeof(bf16) * kWgStages * 2 * kWgTile);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.y * kWgRows, n0 = blockIdx.x * kWgUnits;
  const int chunks = (a.k0 + a.k1 + a.k2) / kWgK, ctx_chunks = a.k0 / kWgK;

  // the fp32 segment, rounded: 16-byte group q of row r lands at q ^ r % 8
  for (int c = 0; c < ctx_chunks; ++c) {
    bf16* xs = ring + c * 2 * kWgTile;
    for (int i = tid; i < kWgRows * 8; i += 256) {
      const int r = i / 8, q = i % 8, m = m0 + r;
      union {
        __nv_bfloat162 h[4];
        uint4 all;
      } pack;
      pack.all = make_uint4(0, 0, 0, 0);
      if (m < a.B) {
        const float4* src = reinterpret_cast<const float4*>(
            a.in0 + (size_t)m * a.k0 + c * kWgK + q * 8);
        const float4 u = src[0], v = src[1];
        pack.h[0] = __floats2bfloat162_rn(u.x, u.y);
        pack.h[1] = __floats2bfloat162_rn(u.z, u.w);
        pack.h[2] = __floats2bfloat162_rn(v.x, v.y);
        pack.h[3] = __floats2bfloat162_rn(v.z, v.w);
      }
      *reinterpret_cast<uint4*>(xs + r * kWgK + (q ^ r % 8) * 8) = pack.all;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");

  auto issue = [&](int c) {        // thread 0
    bf16* xs = ring + (c % kWgStages) * 2 * kWgTile;
    const uint32_t bar = smem_u32(&full[c % kWgStages]);
    const bool x_tma = c >= ctx_chunks;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     bar), "r"((int)sizeof(bf16) * kWgTile * (x_tma ? 2 : 1))
                 : "memory");
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
            smem_u32(xs + kWgTile)),
        "l"(reinterpret_cast<uint64_t>(&maps.w)), "r"(c * kWgK), "r"(n0),
        "r"(0), "r"(bar) : "memory");
    if (x_tma) {
      const int k = c * kWgK - a.k0, seg = k >= a.k1;
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(
              smem_u32(xs)),
          "l"(reinterpret_cast<uint64_t>(&maps.x[seg])),
          "r"(seg ? k - a.k1 : k), "r"(m0), "r"(bar) : "memory");
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       smem_u32(&full[s])), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < kWgStages - 1 && s < chunks; ++s) issue(s);
  }

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  const int wg = warp / 4;
  __syncthreads();                 // the barriers and ctx's stages are set
  for (int c = 0; c < chunks; ++c) {
    mbar_wait(&full[c % kWgStages], (uint32_t)((c / kWgStages) & 1));
    const bf16* xs = ring + (c % kWgStages) * 2 * kWgTile + wg * 64 * kWgK;
    const bf16* ws = ring + (c % kWgStages) * 2 * kWgTile + kWgTile;
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int k = 0; k < kWgK / 16; ++k)
      wgmma_m64n128k16(d, wg_desc(xs + k * 16), wg_desc(ws + k * 16));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // chunk c's products stay in flight; chunk c - 1's are done, in every
    // warpgroup once all have passed the barrier, so its stage is free
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    __syncthreads();
    if (tid == 0 && c + kWgStages - 1 < chunks) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(c + kWgStages - 1);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");

  // accumulator 4 j + e: row 16 (warp % 4) + lane / 4 (+ 8 for e >= 2) of
  // the warpgroup's 64, column 8 j + lane % 4 * 2 + e % 2: gate j / 4 of
  // unit 8 (j % 4) + lane % 4 * 2 + e % 2
  float bias[4][2][4], c_in[2][4][2];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + u * 8 + lane % 4 * 2 + e;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        bias[u][e][g] = n < a.N ? a.bias[(size_t)g * a.N + n] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wg * 64 + warp % 4 * 16 + lane / 4 + h * 8;
        c_in[h][u][e] =
            m < a.B && n < a.N ? a.c_in[(size_t)m * a.N + n] : 0.f;
      }
    }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + wg * 64 + warp % 4 * 16 + lane / 4 + h * 8;
        const int n = n0 + u * 8 + lane % 4 * 2 + e;
        if (m >= a.B || n >= a.N) continue;
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          z[g] = d[4 * (4 * g + u) + 2 * h + e] + bias[u][e][g];
        mma_store<4>(a, m, n, z, c_in[h][u][e]);
      }
}

// A row-major bf16 tensor of dims[0] innermost (strides in bytes, of dims
// 1 and 2) as a map of box boxes in 128-byte swizzle; rows outside dims
// read as zeros.
bool encode_bf16_map(CUtensorMap* map, const bf16* base, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides,
                     const cuuint32_t* box) {
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<bf16*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch wgmma_cell_kernel (prepared) on the cell's a, with wt the (4N, K)
// transpose of [wa ; wb]. Returns cudaErrorInvalidValue, launching
// nothing, where a segment width is not a multiple of 64, the fp32 segment
// does not fit the ring's first stages, a base is not 16-byte aligned or
// the maps cannot be encoded; else the launch's error.
cudaError_t wgmma_cell_launch(MmaArgs a, const bf16* wt,
                              cudaStream_t stream) {
  const int K = a.k0 + a.k1 + a.k2;
  if (a.k0 % kWgK || a.k1 % kWgK || a.k2 % kWgK || a.k1 == 0 ||
      a.k2 == 0 || a.k0 / kWgK > kWgStages - 1 ||
      (a.k0 && !aligned16(a.in0)) || !aligned16(a.in1) ||
      !aligned16(a.in2) || !aligned16(wt) || encode_tiled() == nullptr)
    return cudaErrorInvalidValue;
  WgMaps maps;
  const bf16* x[2] = {a.in1, a.in2};
  const int ks[2] = {a.k1, a.k2};
  for (int i = 0; i < 2; ++i) {
    const cuuint64_t dims[2] = {(cuuint64_t)ks[i], (cuuint64_t)a.B};
    const cuuint64_t strides[1] = {(cuuint64_t)ks[i] * sizeof(bf16)};
    const cuuint32_t box[2] = {kWgK, kWgRows};
    if (!encode_bf16_map(&maps.x[i], x[i], 2, dims, strides, box))
      return cudaErrorInvalidValue;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)a.N, 4};
  const cuuint64_t strides[2] = {(cuuint64_t)K * sizeof(bf16),
                                 (cuuint64_t)K * a.N * sizeof(bf16)};
  const cuuint32_t box[3] = {kWgK, kWgUnits, 4};
  if (!encode_bf16_map(&maps.w, wt, 3, dims, strides, box))
    return cudaErrorInvalidValue;
  const dim3 grid(ceil_div(a.N, kWgUnits), ceil_div(a.B, kWgRows));
  void* args[] = {&a, &maps};
  const cudaError_t err =
      cudaLaunchKernel(reinterpret_cast<const void*>(wgmma_cell_kernel),
                       grid, dim3(256), args, kWgSmem, stream);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
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
      (err = cudaFuncSetAttribute(attention_kernel<>,
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

// K4 with bf16 W2, Wx and Wh: the arguments of mtt_fused_seq_forward less
// the plans, but emb (T, B, E) is bf16 (rounded by the caller), w2, wx and
// wh point to bf16, and in h0's place hbuf is a (2, B, U) bf16 scratch
// whose first half is zeros (h0 rounded): step t reads h_{t-1} rounded from
// half t % 2 and its cell writes h_t rounded to the other. wt, where not
// null, is the (4U, D + E + U) transpose of [wx ; wh]: the cell then runs
// on wgmma_cell_kernel, which needs D, E and U to be multiples of 64 and D
// at most 320. Returns 0 on success, else the first CUDA error.
int mtt_fused_seq_forward_bf16(
    const float* pre, const float* features, const bf16* emb,
    const bf16* w2, const float* b2, const float* v, const float* bv,
    const bf16* wx, const bf16* wh, const float* b, bf16* hbuf,
    const float* c0, float* ctx, float* hseq, float* cseq, float* alphas,
    float* zs, float* hwps, const bf16* wt, int B, int R, int A, int D,
    int E, int U, int T, float attn_slope, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);

  const MmaConfig& cell = kMmaTiles[0];
  const MmaConfig& dense = kMmaTiles[B > 128 ? 2 : 1];
  const size_t attn_smem = attention_smem_bytes(A, R);
  if ((err = wt != nullptr
                 ? cudaFuncSetAttribute(
                       wgmma_cell_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kWgSmem)
                 : mma_prepare(cell)) != cudaSuccess ||
      (err = mma_prepare(dense)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(attention_kernel<>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)attn_smem)) != cudaSuccess)
    return (int)err;

  const size_t bu = (size_t)B * U;
  for (int t = 0; t < T; ++t) {
    const bf16* h = hbuf + (t % 2) * bu;
    const float* c = t == 0 ? c0 : cseq + (t - 1) * bu;
    float* hw = hwps + (size_t)t * B * A;
    // h W2 + b2 for the whole batch
    if ((err = mma_launch(dense,
                          {nullptr, nullptr, h, 0, 0, U, w2, nullptr, U, b2,
                           B, A, hw, nullptr, nullptr, nullptr, nullptr, 0},
                          stream)) != cudaSuccess)
      return (int)err;
    attention_kernel<<<B, kThreads, attn_smem, stream>>>(
        pre, features, v, bv, ctx, alphas + (size_t)t * B * R, hw, R, A, D,
        attn_slope, 1, 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const MmaArgs cell_args = {ctx, emb + (size_t)t * B * E, h, D, E, U,
                               wx, wh, D + E, b, B, U, hseq + t * bu,
                               hbuf + ((t + 1) % 2) * bu, cseq + t * bu, c,
                               zs + (size_t)t * 4 * bu, 0};
    if ((err = wt != nullptr ? wgmma_cell_launch(cell_args, wt, stream)
                             : mma_launch(cell, cell_args, stream)) !=
        cudaSuccess)
      return (int)err;
  }
  return 0;
}

}  // extern "C"
