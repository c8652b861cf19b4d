// The bf16-weight greedy decode for Hopper (sm_90a): K2 (LSTM, LcNIC) and
// K3 (GRU, CnnRnn) with bf16 weights, as ONE persistent cooperative launch
// for all T steps, the weights held in shared memory across the SMs.
//
// Replaces, as they run on the TPU (_fused_decode_call casts Wx, Wh, Wi, Wo
// and the embedding table to bf16 there, masters_thesis_tpu/ops/
// fused_decode.py:159-166): fused_greedy_decode (:211, body _decode_kernel)
// and fused_greedy_decode_gru (:276, body _gru_decode_kernel at :233). Per
// greedy step, for every batch row b (fused_decode.cu's header has the
// cells):
//
//   hw     = act(h W2 + b2, attn_slope)            (fp32 h and W2)
//   alpha  = softmax_r(tanh(pre_r + hw) . v + bv),  ctx = sum_r alpha_r f_r
//   the cell on [ctx ; emb] and h, rounded to bf16 (the GRU keeps its h~
//   gate's input and recurrent sums apart, and under zero_state starts
//   from h = 0)
//   logits = act(h Wi + bi, slope) Wo + bo         (h and act(hi) rounded)
//   word   = first argmax(logits),  emb = emb_table[word]  (the bf16 row)
//
// Every product with a bf16 weight is an fp32 sum of exact products of
// bf16 operands (mma.sync.m16n8k16, fp32 accumulators); W2, the biases, v,
// bv and the carries stay fp32; under feat_bf16 pre and features are read
// widened.
//
// What bounds it. A flagship decode (B 64, T 15) needs ~12 MB of bf16
// weights and table and ~6 MB of fp32 attention inputs read once (~5.4 us
// at 3.35 TB/s) and ~3.4 G multiply-adds on the tensor cores (~6.9 us):
// bound by operations at ~8 us. But the steps are strictly sequential, and
// a step is four dependent all-to-all exchanges (the attention's ctx feeds
// every unit, every unit's h feeds every head column, every head column
// every logit, every logit the argmax), so a step costs at least four
// grid-wide synchronisations plus the latency of each phase's reads.
//
// What the design does about it. The TPU kernel is one program for the
// whole loop with its weights resident in VMEM; no SM can hold them, but
// the H100's 132 SMs together can. So one block per SM (a cooperative
// launch: the runtime refuses a grid whose blocks cannot all be resident)
// loads its share of the weights into shared memory once and keeps it for
// all T steps; the steps run inside the kernel, separated by a grid
// barrier (a counter in global memory, release/acquire at GPU scope). The
// Python planner (ops/decode_plan.py) gives each block
//   - a range of units, all G gates of each (the cell's epilogue stays in
//     the block), in panels of up to 16 units (<= 64 columns);
//   - a range of Wi columns and of Wo columns, in panels of 64;
//   - a tile (rows x columns) of h W2, fp32 on the CUDA cores, on the
//     blocks that hold no Wi columns (phase C then costs the longer of
//     the two, not their sum);
//   - the attention of rows: blocks in groups of asplit share a row, each
//     making the scores and the softmax and its share of ctx's columns
//     (one SM alone pulls a CnnRnn row's 640 KB from L2 at ~30 GB/s);
//     where a block's rows of pre and features fit beside the weights
//     (LcNIC) they stay in shared memory for the whole decode, else they
//     stream from L2 every step;
// and, per operand, whether it is resident or streamed from L2 chunk by
// chunk; this file refuses a plan it cannot run (mtt_greedy_decode_bf16).
// A step is four phases and four barriers:
//   A  each row's argmax of the last step, reduced in block order over the
//      blocks' partial argmaxes (first index on a tie), words and the
//      re-embedding; then the attention: alphas, and ctx rounded to bf16
//      into the row's x = [ctx | emb | h] (bf16, double buffered by step);
//   B  the cell: x (streamed from L2 in 64-wide chunks through a cp.async
//      ring, each block in its own rotation of the chunks) times the
//      block's resident weight panel on the tensor cores, the cell in the
//      epilogue; h' in fp32 (carry), c' (LSTM), and h' rounded into the
//      next step's x;
//   C  the block's Wi columns, act(h' Wi + bi) rounded to bf16, and its
//      tile of h' W2 + b2 for the next step's attention;
//   D  the block's Wo columns and, per row, the first argmax over them,
//      written as a partial for phase A.
// No sum uses atomics: each is made by one thread or reduced in a fixed
// order, so the same inputs give the same words and alphas bit for bit
// from call to call. Rows past B, units past U, columns past N and K past
// its end are zero-filled; a padded vocab id has a zero Wo column and bias
// -1e30, so it never wins. With a non-null stamps buffer, block 0 writes
// %globaltimer at each phase boundary (--profile splits the step by it);
// serving passes null.
//
// What the card showed (PERF.md §5-6). A flagship step takes ~43 us, not
// the ~15 the design aimed at: the products, a third of it, are bound by
// every block reading the same x from L2 (~4 us for the cell's 17 MB at
// ~4.6 TB/s) and by the latency of the few mma.sync chains a block owns,
// and the two do not overlap; a deeper ring, a warp that only moves data
// and TMA copies each left them where they were. The step's four barriers
// take ~5 us; CnnRnn's attention, bound by L2 per SM, ~16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "step_kernels.cuh"

// The phases' bodies (product, attend, hw_tile, copy2d) are kept out of
// line: one copy of each serves every step, so that a step's code stays in
// the SMs' instruction caches (on an H100, K3 took 1.50 ms a CnnRnn decode
// against 1.70 ms with them inlined; PERF.md).

namespace {

using bf16 = __nv_bfloat16;

constexpr int kP = 256;            // threads a block
constexpr int kWarpsP = kP / 32;
constexpr int kMG = 64;            // rows a pass of a product (4 m16 tiles)
constexpr int kPW = 64;            // columns a panel (8 n8 tiles)
constexpr int kBK = 64;            // K a chunk of a product
constexpr int kMaxStages = 16;     // chunks of a product's rows in a ring
constexpr int kXSP = kBK + 8;      // a stage row: an odd number of 16 B
constexpr int kCellUnits = 16;     // units a cell panel
constexpr int kMaxSmemP = 232448;  // an H100 block's shared memory
constexpr int kMaxBlocks = 4096;
constexpr long long kSpinNs = 10000000000LL;  // a barrier that never opens

// The launch record (ops/decode_plan.py::DecodePlan.record): a header,
// then one row per block.
enum Header {
  HD_CELL, HD_B, HD_R, HD_A, HD_D, HD_E, HD_U, HD_H, HD_V, HD_T, HD_FEAT,
  HD_ZERO, HD_BLOCKS, HD_SMEM, HD_OEMB, HD_OH, HD_KX, HD_HP, HD_RES_ATTN,
  HD_RES_CELL, HD_RES_WI, HD_RES_WO, HD_RES_W2, HD_PS, HD_LPR, HD_STAGES,
  HD_ASPLIT, HD_SCRATCH, HD_WORDS
};
enum BlockRow {
  BR_U0, BR_U1, BR_I0, BR_I1, BR_O0, BR_O1, BR_R0, BR_R1, BR_A0, BR_A1,
  BR_ROWS, BR_OFF_CELL, BR_OFF_WI, BR_OFF_WO, BR_OFF_W2, BR_OFF_ATTN,
  BR_OFF_SCRATCH, BR_WORDS
};

struct Hd {
  int v[HD_WORDS];
};

// The tensors, in the order of ops/fused_decode.py's pointer array. b is
// the LSTM's (4U) or the GRU's b_in (3U); b_rec and c0, c are null where
// the cell has none; stamps may be null.
struct Ptrs {
  const void* pre;        // (B, R, A) fp32, or bf16 under feat_bf16
  const void* features;   // (B, R, D) likewise
  const float *w2, *b2, *v, *bv;
  const bf16 *wx, *wh;
  const float *b, *b_rec;
  const bf16* wi;
  const float* bi;
  const bf16* wo;
  const float* bo;
  const bf16* emb_table;
  const float *emb0, *h0, *c0;
  bf16* x;           // (2, B, kx): [ctx | emb | h] by step parity
  float* h;          // (B, U): the fp32 carry
  float* c;          // (B, U): the LSTM's cell state
  bf16* hi;          // (B, hp): act(h Wi + bi) rounded
  float* hw;         // (B, A): h W2 + b2
  float* pval;       // (B, blocks): each block's best logit of a row
  int* pidx;         // (B, blocks): and its id
  unsigned* bar;     // the barrier's counter, 0 on entry
  int* words;        // (B, T)
  float* alphas;     // (B, T, R)
  unsigned long long* stamps;  // 5 + 9 T, or null
};
constexpr int kNumPtrs = sizeof(Ptrs) / sizeof(void*);

__host__ __device__ constexpr int ru(int n, int m) {
  return (n + m - 1) / m * m;
}
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// ---- the sizes both sides compute (ops/decode_plan.py mirrors them) ----

// a cell panel's columns: G gates of n units, rounded to 8
__host__ __device__ inline int cell_width(int G, int n) { return ru(G * n, 8); }

// bytes of a block's resident cell panels for units [u0, u1), Kc rows each
__host__ __device__ inline long long cell_bytes(int G, int u0, int u1,
                                                int Kc) {
  long long n = 0;
  for (int ua = u0; ua < u1; ua += kCellUnits)
    n += (long long)Kc * cell_width(G, imin(kCellUnits, u1 - ua)) * 2;
  return n;
}

// the pitch, in floats, of a resident W2 column and a staged row of h: U
// rounded to 4, plus 4
__host__ __device__ inline int w2_pitch(int U) { return ru(U, 4) + 4; }

// bytes of a block's resident dense panels for columns [c0, c1), K rows
__host__ __device__ inline long long dense_bytes(int c0, int c1, int K) {
  long long n = 0;
  for (int ca = c0; ca < c1; ca += kPW)
    n += (long long)K * ru(imin(kPW, c1 - ca), 8) * 2;
  return n;
}

// ---- small device helpers ----

// the tensor-core primitives (as csrc/mma_tile.cuh uses them): a 16-byte
// cp.async that zero-fills past src_bytes, ldmatrix of four 8 x 8 tiles and
// of two transposed ones, and d += a b for one m16n8k16 tile in fp32
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// wait until at most n (< kMaxStages) groups are pending: the instruction
// takes its count as an immediate
__device__ __forceinline__ void cp_wait_n(int n) {
  switch (n) {
#define MTT_WAIT(k) \
  case k:           \
    cp_wait<k>();   \
    break;
    MTT_WAIT(0) MTT_WAIT(1) MTT_WAIT(2) MTT_WAIT(3) MTT_WAIT(4) MTT_WAIT(5)
    MTT_WAIT(6) MTT_WAIT(7) MTT_WAIT(8) MTT_WAIT(9) MTT_WAIT(10)
    MTT_WAIT(11) MTT_WAIT(12) MTT_WAIT(13) MTT_WAIT(14)
#undef MTT_WAIT
    default:
      cp_wait<0>();
  }
}
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p)));
}
__device__ __forceinline__ void ldsm2t(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(saddr(p)));
}
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  // the first index of the maximum; i < 0 marks "none yet"
  if (i2 < 0) return;
  if (i < 0 || v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_better(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1)
    better(v, i, __shfl_xor_sync(0xffffffffu, v, o),
           __shfl_xor_sync(0xffffffffu, i, o));
}

__device__ __forceinline__ bf16 bf16_zero() {
  return __float2bfloat16_rn(0.f);
}

// The grid barrier: every block adds one to the counter and waits until
// it reaches `target` (blocks x barriers so far), as CUTLASS's
// GenericBarrier does: the block's writes (ordered by __syncthreads before
// thread 0's fence) are released with its arrival, and acquired by every
// block whose load sees the count; what one block reads of another's
// writes it reads through L2 (cp.async.cg, __ldcg), never from L1. Block 0
// stamps its arrival and its exit. A barrier that has not opened in
// kSpinNs traps,
// which ends the launch with an error instead of a hang.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned target,
                                          unsigned long long* stamps,
                                          int slot) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (stamps != nullptr && blockIdx.x == 0) stamps[slot] = globaltimer();
    asm volatile("fence.acq_rel.gpu;\n"
                 "red.relaxed.gpu.global.add.u32 [%0], 1;\n" ::"l"(bar)
                 : "memory");
    const unsigned long long t0 = globaltimer();
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(bar)
                   : "memory");
      if (globaltimer() - t0 > (unsigned long long)kSpinNs) __trap();
    } while (seen < target);
    if (stamps != nullptr && blockIdx.x == 0)
      stamps[slot + 1] = globaltimer();
  }
  __syncthreads();
}

__device__ __forceinline__ void stamp(unsigned long long* stamps, int slot) {
  if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    stamps[slot] = globaltimer();
}

// Zero `bytes` (a multiple of 16) of shared memory at p, by the block.
__device__ void zero_smem(void* p, int bytes) {
  uint4* q = static_cast<uint4*>(p);
  for (int i = threadIdx.x; i < bytes / 16; i += kP)
    q[i] = make_uint4(0, 0, 0, 0);
}

// dst[k * lddst + c] = src[k * ldsrc + c] for k < rows, c < cols (elements
// of T), by the block: loads of V (16, 8 or 4 bytes, or one element, the
// widest the source and its pitch allow), eight a thread in flight, each
// stored whole where the destination and its pitch allow, else element by
// element.
template <typename T, typename V>
__device__ void copy2d_vec(T* dst, int lddst, const T* src, long long ldsrc,
                           int rows, int cols, bool whole) {
  constexpr int E = sizeof(V) / sizeof(T);
  const int per = cols / E;          // whole vectors a row
  const long long n = (long long)rows * per;
  for (long long i0 = threadIdx.x; i0 < n; i0 += 8LL * kP) {
    V v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long i = i0 + (long long)j * kP;
      if (i < n)
        v[j] = *reinterpret_cast<const V*>(src + i / per * ldsrc + i % per * E);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long i = i0 + (long long)j * kP;
      if (i >= n) continue;
      T* d = dst + i / per * lddst + i % per * E;
      if (whole) {
        *reinterpret_cast<V*>(d) = v[j];
      } else {
        const T* e = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
        for (int q = 0; q < E; ++q) d[q] = e[q];
      }
    }
  }
  // the columns past the last whole vector, one element each
  const int tail = cols - per * E;
  for (int i = threadIdx.x; i < rows * tail; i += kP) {
    const int k = i / tail, c = per * E + i % tail;
    dst[(long long)k * lddst + c] = src[k * ldsrc + c];
  }
}

template <typename T>
__device__ __noinline__ void copy2d(T* dst, int lddst, const T* src,
                                    long long ldsrc, int rows, int cols) {
  if (rows <= 0 || cols <= 0) return;
  const unsigned long long s = reinterpret_cast<uintptr_t>(src) |
                               ((unsigned long long)ldsrc * sizeof(T));
  const unsigned long long d = reinterpret_cast<uintptr_t>(dst) |
                               ((unsigned long long)lddst * sizeof(T));
  if (s % 16 == 0)
    copy2d_vec<T, uint4>(dst, lddst, src, ldsrc, rows, cols, d % 16 == 0);
  else if (s % 8 == 0)
    copy2d_vec<T, uint2>(dst, lddst, src, ldsrc, rows, cols, d % 8 == 0);
  else if (s % 4 == 0)
    copy2d_vec<T, unsigned>(dst, lddst, src, ldsrc, rows, cols, d % 4 == 0);
  else
    copy2d_vec<T, T>(dst, lddst, src, ldsrc, rows, cols, true);
}

// ---- the geometry a block works with, from the record ----

struct Geo {
  int cell, B, R, A, D, E, U, H, V, T, blocks, oemb, oh, kx, hp, ps, lpr,
      stages, asplit;
  int G, Kc;           // gates a unit; rows of a resident cell panel
  bool feat, zero, carried, res_attn, res_cell, res_wi, res_wo, res_w2;
};

__device__ __forceinline__ Geo geo_of(const Hd& h) {
  Geo g;
  g.cell = h.v[HD_CELL];
  g.B = h.v[HD_B];
  g.R = h.v[HD_R];
  g.A = h.v[HD_A];
  g.D = h.v[HD_D];
  g.E = h.v[HD_E];
  g.U = h.v[HD_U];
  g.H = h.v[HD_H];
  g.V = h.v[HD_V];
  g.T = h.v[HD_T];
  g.blocks = h.v[HD_BLOCKS];
  g.oemb = h.v[HD_OEMB];
  g.oh = h.v[HD_OH];
  g.kx = h.v[HD_KX];
  g.hp = h.v[HD_HP];
  g.ps = h.v[HD_PS];
  g.lpr = h.v[HD_LPR];
  g.stages = h.v[HD_STAGES];
  g.asplit = h.v[HD_ASPLIT];
  g.feat = h.v[HD_FEAT] != 0;
  g.zero = h.v[HD_ZERO] != 0;
  g.G = g.cell == kLSTM ? 4 : 3;
  g.carried = !(g.cell == kGRU && g.zero);
  g.Kc = g.carried ? g.kx : g.oh;
  g.res_attn = h.v[HD_RES_ATTN] != 0;
  g.res_cell = h.v[HD_RES_CELL] != 0;
  g.res_wi = h.v[HD_RES_WI] != 0;
  g.res_wo = h.v[HD_RES_WO] != 0;
  g.res_w2 = h.v[HD_RES_W2] != 0;
  return g;
}

// The cell's weight row k of x = [ctx | emb | h] (kx columns, each segment
// padded to 16), column gc of the G U gate columns: Wx's rows for ctx and
// emb, Wh's for h, zero in the pads.
__device__ __forceinline__ bf16 cell_weight(const Geo& g, const Ptrs& p,
                                            int k, int gc) {
  const long long ld = (long long)g.G * g.U;
  if (k < g.D) return p.wx[k * ld + gc];
  if (k >= g.oemb && k < g.oemb + g.E)
    return p.wx[(g.D + k - g.oemb) * ld + gc];
  if (k >= g.oh && k < g.oh + g.U) return p.wh[(k - g.oh) * ld + gc];
  return bf16_zero();
}

// The streamed weights of a product: element (k, c) of its panel, k from
// the product's first row.
struct CellW {
  const Geo* g;
  const Ptrs* p;
  int k0, ua, n;   // first row; the panel's units [ua, ua + n)
  __device__ bf16 operator()(int k, int c) const {
    const int gate = c / n, u = c % n;
    if (gate >= g->G) return bf16_zero();
    return cell_weight(*g, *p, k0 + k, gate * g->U + ua + u);
  }
};
struct DenseW {
  const bf16* w;
  int ld, rows, c0, cols;  // W (rows, ld); the panel's columns [c0, c0 + cols)
  __device__ bf16 operator()(int k, int c) const {
    return k < rows && c < cols ? w[(long long)k * ld + c0 + c] : bf16_zero();
  }
};

// Z[m][c] (fp32, shared, pitch pw) = sum_k A[m0 + m][acol + k] W[k][c] for
// m < 64, c < pw (a multiple of 8, at most 64), k < K (a multiple of 16):
// A bf16 in global memory (pitch lda; rows past B are zeros), W the
// block's resident panel (wres, pitch pw, from the product's first row) or,
// if wres is null, streamed chunk by chunk through wstage by wsrc. The
// chunks of A (kBK k each) come through a ring of `stages` cp.async stages,
// stages - 1 in flight; each block takes the chunks in its own rotation
// (from chunk rot), so that the blocks, which all read the same A, do not
// all ask L2 for the same lines at once. Each warp owns SLOTS of the
// (m16, n8) tiles (warp, warp + 8, ...); a tile's sum is four tensor-core
// chains (the k16 steps of a chunk taken in turn), over the chunks in the
// block's order, added at the end in a fixed order: no two warps share an
// accumulator. Ends with a barrier: Z is ready.
template <int SLOTS, class WSrc>
__device__ __noinline__ void product_slots(
    const bf16* A, int lda, int acol, int K, int m0, int B, const bf16* wres,
    const WSrc& wsrc, int pw, float* Z, bf16* ring, int stages, int rot,
    bf16* wstage) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = imin(4, (B - m0 + 15) / 16), nt = pw / 8, tiles = mt * nt;
  const int chunks = (K + kBK - 1) / kBK;
  rot %= chunks;
  float acc[4][SLOTS][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][s][e] = 0.f;
  // each slot's ldmatrix offsets in a stage of A and in a chunk of W:
  // A rows 0-15 of its m-tile at k 0 then 8; W k rows 0-15 of its n-tile
  int a_off[SLOTS], w_off[SLOTS];
  bool live[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int q = warp + kWarpsP * s, i = q / nt, j = q % nt;
    live[s] = q < tiles;
    a_off[s] = (i * 16 + lane % 16) * kXSP + lane / 16 * 8;
    w_off[s] = lane % 16 * pw + j * 8;
  }
  // the c-th chunk this block takes, into stage c % stages
  auto load = [&](int c) {
    bf16* xs = ring + (c % stages) * kMG * kXSP;
    const int cc = c + rot, kc = (cc < chunks ? cc : cc - chunks) * kBK;
    const int kw = imin(kBK, K - kc);
    for (int i = tid; i < kMG * (kBK / 8); i += kP) {
      const int r = i / (kBK / 8), q = i % (kBK / 8) * 8, m = m0 + r;
      const bool in = m < B && q < kw && r < mt * 16;
      cp16(xs + r * kXSP + q, in ? A + (long long)m * lda + acol + kc + q : A,
           in ? 16 : 0);
    }
  };
  for (int s = 0; s < stages - 1; ++s) {
    if (s < chunks) load(s);
    cp_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_wait_n(stages - 2);           // chunk c has landed
    __syncthreads();                 // ... for all; chunk c - 1 is done
    if (c + stages - 1 < chunks) load(c + stages - 1);
    cp_commit();
    const int cc = c + rot, kc = (cc < chunks ? cc : cc - chunks) * kBK;
    const int kw = imin(kBK, K - kc);
    const bf16* ws = wres;
    if (wres != nullptr) {
      ws = wres + (long long)kc * pw;
    } else {
      for (int i = tid; i < kw * pw; i += kP)
        wstage[i] = wsrc(kc + i / pw, i % pw);
      __syncthreads();
      ws = wstage;
    }
    const bf16* xs = ring + (c % stages) * kMG * kXSP;
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k) {
      if (16 * k < kw) {
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          if (live[s]) {
            uint32_t af[4], bfr[2];
            ldsm4(af, xs + a_off[s] + 16 * k);
            ldsm2t(bfr, ws + w_off[s] + 16 * k * pw);
            mma16816(acc[k % 4][s], af, bfr);
          }
        }
      }
    }
  }
  cp_wait<0>();
  // accumulator e of an m16n8 tile: row lane / 4 (+ 8 for e >= 2), column
  // lane % 4 * 2 + e % 2
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int q = warp + kWarpsP * s;
    if (live[s]) {
      const int i = q / nt, j = q % nt;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        Z[(i * 16 + lane / 4 + e / 2 * 8) * pw + j * 8 + lane % 4 * 2 +
          e % 2] = (acc[0][s][e] + acc[1][s][e]) +
                   (acc[2][s][e] + acc[3][s][e]);
    }
  }
  __syncthreads();
}

// product_slots with as many slots a warp as the tiles need (at most four:
// 4 m16 x 8 n8 tiles over 8 warps).
template <class WSrc>
__device__ __forceinline__ void product(const bf16* A, int lda, int acol,
                                        int K, int m0, int B,
                                        const bf16* wres, const WSrc& wsrc,
                                        int pw, float* Z, bf16* ring,
                                        int stages, int rot, bf16* wstage) {
  const int tiles = imin(4, (B - m0 + 15) / 16) * (pw / 8);
  switch ((tiles + kWarpsP - 1) / kWarpsP) {
#define MTT_SLOTS(n)                                                     \
  case n:                                                                \
    product_slots<n>(A, lda, acol, K, m0, B, wres, wsrc, pw, Z, ring,    \
                     stages, rot, wstage);                               \
    break;
    MTT_SLOTS(1) MTT_SLOTS(2) MTT_SLOTS(3)
#undef MTT_SLOTS
    default:
      product_slots<4>(A, lda, acol, K, m0, B, wres, wsrc, pw, Z, ring,
                       stages, rot, wstage);
  }
}

// The attention of row b at step t: the scores and the softmax, then the
// columns [d0, d1) of ctx into x's ctx segment; with `lead`, the alphas
// into alphas[b, t] (the row's other blocks make the same alphas and the
// other columns). pre and f are the row's (resident in shared memory, pre
// at pitch ps and f, its columns [d0, d1) only, at pitch fd; or in global
// memory, pre at pitch A and f at pitch D from column d0).
template <typename F>
__device__ __noinline__ void attend(const Geo& g, const Ptrs& p, const F* pre,
                                    int ps, const F* f, int fd, int d0,
                                    int d1, bool lead, int b, int t, bf16* x,
                                    float* sc, float attn_slope) {
  const int tid = threadIdx.x;
  float* s_hw = sc;
  float* s_v = s_hw + g.A;
  float* s_e = s_v + g.A;
  float* s_red = s_e + g.R;
  float* s_part = s_red + 32;
  for (int a = tid; a < g.A; a += kP) {
    s_hw[a] = lrelu(__ldcg(p.hw + (long long)b * g.A + a), attn_slope);
    s_v[a] = p.v[a];
  }
  __syncthreads();

  // scores: lpr lanes a region, each summing every lpr-th a in four
  // independent sums (four tanh in flight), then the lanes' sums added in
  // a butterfly
  const int lpr = g.lpr, per = kP / lpr, grp = tid / lpr, l = tid % lpr;
  auto term = [&](const F* pr, int a) {
    return tanhf(widen(pr[a]) + s_hw[a]) * s_v[a];
  };
  for (int r0 = 0; r0 < g.R; r0 += per) {
    const int r = r0 + grp;
    float s = 0.f;
    if (r < g.R) {
      const F* pr = pre + (long long)r * ps;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      int a = l;
      for (; a + 3 * lpr < g.A; a += 4 * lpr) {
        s0 += term(pr, a);
        s1 += term(pr, a + lpr);
        s2 += term(pr, a + 2 * lpr);
        s3 += term(pr, a + 3 * lpr);
      }
      for (; a < g.A; a += lpr) s0 += term(pr, a);
      s = (s0 + s1) + (s2 + s3);
    }
    for (int o = lpr / 2; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    if (l == 0 && r < g.R) s_e[r] = s + p.bv[0];
  }
  __syncthreads();

  // softmax over the regions
  float m = -INFINITY;
  for (int r = tid; r < g.R; r += kP) m = fmaxf(m, s_e[r]);
  m = block_max(m, s_red);
  float sum = 0.f;
  for (int r = tid; r < g.R; r += kP) {
    const float w = expf(s_e[r] - m);
    s_e[r] = w;
    sum += w;
  }
  sum = block_sum(sum, s_red);
  float* ab = p.alphas + ((long long)b * g.T + t) * g.R;
  for (int r = tid; r < g.R; r += kP) {
    const float alpha = s_e[r] / sum;
    s_e[r] = alpha;
    if (lead) ab[r] = alpha;
  }
  __syncthreads();

  // ctx = alpha (R) times the features (R, D): a column narrower than the
  // block gets kP / D threads, each summing every nsl-th region in four
  // independent sums (four loads in flight: streamed rows are bound by L2
  // latency), the threads' sums added in slice order; rounded to bf16
  // into x
  const int D = d1 - d0;
  if (D <= 0) return;
  bf16* out = x + (long long)b * g.kx + d0;
  const int nsl = D < kP ? kP / D : 1, width = kP / nsl;
  const int sl = tid / width, j = tid % width;
  for (int n0 = 0; n0 < D; n0 += width) {
    const int n = n0 + j;
    if (sl < nsl && n < D) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      int r = sl;
      for (; r + 3 * nsl < g.R; r += 4 * nsl)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          a[q] = fmaf(s_e[r + q * nsl],
                      widen(f[(long long)(r + q * nsl) * fd + n]), a[q]);
      for (; r < g.R; r += nsl)
        a[0] = fmaf(s_e[r], widen(f[(long long)r * fd + n]), a[0]);
      s_part[sl * width + j] = (a[0] + a[1]) + (a[2] + a[3]);
    }
    __syncthreads();
    if (tid < width && n0 + tid < D) {
      float s = 0.f;
      for (int i = 0; i < nsl; ++i) s += s_part[i * width + tid];
      out[n0 + tid] = __float2bfloat16_rn(s);
    }
    __syncthreads();
  }
}

// h W2 + b2 for the block's tile, rows [r0, r1) x columns [a0, a1), from
// the fp32 h: the tile's rows of h are staged in shared memory, then
// kP / (outputs) threads make an output where there are fewer than kP,
// each summing every nsl-th group of four units, in four independent sums,
// their sums added in slice order. w2t is the block's resident W2 slice,
// transposed, a column of U units at pitch w2_pitch(U) (16-byte aligned,
// and 8 columns' reads of a 16-byte group mostly in 8 different bank
// groups), or null for W2 read from global memory.
__device__ __noinline__ void hw_tile(const Geo& g, const Ptrs& p,
                                     const float* h, int r0, int r1, int a0,
                                     int a1, const float* w2t, float* sc) {
  const int na = a1 - a0, no = (r1 - r0) * na;
  if (no <= 0) return;
  const int tid = threadIdx.x, U = g.U, U4 = U / 4 * 4;
  float* part = sc;          // kP
  float* hs = sc + kP;       // (r1 - r0, w2_pitch(U)), 16-byte aligned rows
  const int hp = w2_pitch(U);
  const int n = (r1 - r0) * U;
  const float* src = h + (long long)r0 * U;
  for (int i0 = tid; i0 < n; i0 += 8 * kP) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * kP;
      v[j] = i < n ? __ldcg(src + i) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * kP;
      if (i < n) hs[i / U * hp + i % U] = v[j];
    }
  }
  __syncthreads();
  // output (r, a)'s units u = 4 (sl + nsl q) ... + 3, then the tail
  auto dot = [&](int r, int a, int sl, int nsl) {
    const float* hr = hs + r * hp;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    if (w2t != nullptr) {
      const float* wr = w2t + a * hp;
#pragma unroll 4
      for (int u = 4 * sl; u < U4; u += 4 * nsl) {
        const float4 x = *reinterpret_cast<const float4*>(hr + u);
        const float4 w = *reinterpret_cast<const float4*>(wr + u);
        s[0] = fmaf(x.x, w.x, s[0]);
        s[1] = fmaf(x.y, w.y, s[1]);
        s[2] = fmaf(x.z, w.z, s[2]);
        s[3] = fmaf(x.w, w.w, s[3]);
      }
      if (sl == 0)
        for (int u = U4; u < U; ++u) s[0] = fmaf(hr[u], wr[u], s[0]);
    } else {
      const float* wc = p.w2 + a0 + a;
      for (int u = 4 * sl; u < U4; u += 4 * nsl)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          s[q] = fmaf(hr[u + q], wc[(long long)(u + q) * g.A], s[q]);
      if (sl == 0)
        for (int u = U4; u < U; ++u)
          s[0] = fmaf(hr[u], wc[(long long)u * g.A], s[0]);
    }
    return (s[0] + s[1]) + (s[2] + s[3]);
  };
  if (no >= kP) {
    for (int o = tid; o < no; o += kP) {
      const int r = o / na, a = o % na;
      p.hw[(long long)(r0 + r) * g.A + a0 + a] = dot(r, a, 0, 1) + p.b2[a0 + a];
    }
    __syncthreads();
    return;
  }
  const int nsl = kP / no, sl = tid / no, o = tid % no;
  if (sl < nsl) part[sl * no + o] = dot(o / na, o % na, sl, nsl);
  __syncthreads();
  if (tid < no) {
    float s = 0.f;
    for (int i = 0; i < nsl; ++i) s += part[i * no + tid];
    const int r = tid / na, a = tid % na;
    p.hw[(long long)(r0 + r) * g.A + a0 + a] = s + p.b2[a0 + a];
  }
  __syncthreads();
}

template <int CELL, typename F>
__global__ void __launch_bounds__(kP, 1)
decode_bf16_kernel(Ptrs p, Hd hd, const int* __restrict__ plan, float slope,
                   float attn_slope) {
  extern __shared__ __align__(16) unsigned char dsm[];
  const Geo g = geo_of(hd);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x;
  int row[BR_WORDS];
#pragma unroll
  for (int i = 0; i < BR_WORDS; ++i)
    row[i] = plan[HD_WORDS + blk * BR_WORDS + i];
  const int u0 = row[BR_U0], u1 = row[BR_U1];
  const int i0 = row[BR_I0], i1 = row[BR_I1];
  const int o0 = row[BR_O0], o1 = row[BR_O1];
  const int r0 = row[BR_R0], r1 = row[BR_R1], a0 = row[BR_A0],
            a1 = row[BR_A1];
  bf16* cellw = reinterpret_cast<bf16*>(dsm + row[BR_OFF_CELL]);
  bf16* wis = reinterpret_cast<bf16*>(dsm + row[BR_OFF_WI]);
  bf16* wos = reinterpret_cast<bf16*>(dsm + row[BR_OFF_WO]);
  float* w2s = g.res_w2 ? reinterpret_cast<float*>(dsm + row[BR_OFF_W2])
                        : nullptr;
  F* attn = reinterpret_cast<F*>(dsm + row[BR_OFF_ATTN]);
  unsigned char* scratch = dsm + row[BR_OFF_SCRATCH];
  // the scratch of a product: the ring, the streamed weights' stage, Z
  bf16* ring = reinterpret_cast<bf16*>(scratch);
  bf16* wstage = ring + g.stages * kMG * kXSP;
  float* Z = reinterpret_cast<float*>(
      wstage + ((g.res_cell && g.res_wi && g.res_wo) ? 0 : kBK * kPW));
  float* sc = reinterpret_cast<float*>(scratch);   // attention, h W2
  __shared__ float s_best[kMG];
  __shared__ int s_besti[kMG];
  __shared__ int s_word;

  const long long xstep = (long long)g.B * g.kx;
  // the attention: rows grp + k groups of asplit blocks, this block the
  // share sh of their ctx columns, [d0, d1); the share 0 block leads (the
  // words, the embedding, the alphas, the rows' x)
  const int groups = g.blocks / g.asplit, grp = blk / g.asplit;
  const int sh = blk % g.asplit, dper = (g.D + g.asplit - 1) / g.asplit;
  const int d0 = imin(g.D, sh * dper), d1 = imin(g.D, d0 + dper);
  const bool lead = sh == 0;
  const int nrows = row[BR_ROWS];
  const int arow = ru(g.R * g.ps * (int)sizeof(F), 16) / (int)sizeof(F);
  const int frow = ru(g.R * (d1 - d0) * (int)sizeof(F), 16) / (int)sizeof(F);
  const F* pre = static_cast<const F*>(p.pre);
  const F* feat = static_cast<const F*>(p.features);
  unsigned nsync = 0;
  stamp(p.stamps, 0);

  // ---- prologue: the resident slices, the carries, each row's x ----
  {
    // zero the resident regions (pads, rows past K, columns past N)
    zero_smem(dsm + row[BR_OFF_CELL],
              row[BR_OFF_SCRATCH] - row[BR_OFF_CELL]);
    __syncthreads();
    if (g.res_cell) {
      bf16* panel = cellw;
      for (int ua = u0; ua < u1; ua += kCellUnits) {
        const int n = imin(kCellUnits, u1 - ua), pw = cell_width(g.G, n);
        const long long ld = (long long)g.G * g.U;
        for (int gate = 0; gate < g.G; ++gate) {
          const int c = gate * n, gc = gate * g.U + ua;
          copy2d(panel + c, pw, p.wx + gc, ld, g.D, n);
          copy2d(panel + (long long)g.oemb * pw + c, pw,
                 p.wx + (long long)g.D * ld + gc, ld, g.E, n);
          if (g.carried)
            copy2d(panel + (long long)g.oh * pw + c, pw, p.wh + gc, ld, g.U,
                   n);
        }
        panel += (long long)g.Kc * pw;
      }
    }
    if (g.res_wi) {
      bf16* panel = wis;
      for (int ca = i0; ca < i1; ca += kPW) {
        const int n = imin(kPW, i1 - ca), pw = ru(n, 8);
        copy2d(panel, pw, p.wi + ca, g.H, g.U, n);
        panel += (long long)ru(g.U, 16) * pw;
      }
    }
    if (g.res_wo) {
      bf16* panel = wos;
      for (int ca = o0; ca < o1; ca += kPW) {
        const int n = imin(kPW, o1 - ca), pw = ru(n, 8);
        copy2d(panel, pw, p.wo + ca, g.V, g.H, n);
        panel += (long long)g.hp * pw;
      }
    }
    if (w2s != nullptr)     // transposed: column a at a w2_pitch(U)
      for (int i = tid; i < g.U * (a1 - a0); i += kP) {
        const int u = i / (a1 - a0), a = i % (a1 - a0);
        w2s[a * w2_pitch(g.U) + u] = p.w2[(long long)u * g.A + a0 + a];
      }
    if (g.res_attn)
      for (int k = 0; k < nrows; ++k) {
        const long long b = grp + (long long)k * groups;
        F* dst = attn + (long long)k * (arow + frow);
        copy2d(dst, g.ps, pre + b * g.R * g.A, g.A, g.R, g.A);
        copy2d(dst + arow, d1 - d0, feat + b * g.R * g.D + d0, g.D, g.R,
               d1 - d0);
      }
    // the carries of the block's units, and its rows' x (both halves) and
    // act(hi) rows, pads zero: x0 = [0 | emb0 | h0] rounded
    for (int i = tid; i < g.B * (u1 - u0); i += kP) {
      const long long o = (long long)(i / (u1 - u0)) * g.U + u0 + i % (u1 - u0);
      p.h[o] = p.h0[o];
      if constexpr (CELL == kLSTM) p.c[o] = p.c0[o];
    }
    for (int k = 0; lead && k < nrows; ++k) {
      const long long b = grp + (long long)k * groups;
      for (int i = tid; i < g.kx; i += kP) {
        float v = 0.f;
        if (i >= g.oemb && i < g.oemb + g.E) v = p.emb0[i - g.oemb];
        else if (i >= g.oh && i < g.oh + g.U) v = p.h0[b * g.U + i - g.oh];
        p.x[b * g.kx + i] = __float2bfloat16_rn(v);
        p.x[xstep + b * g.kx + i] = bf16_zero();
      }
      for (int i = tid; i < g.hp; i += kP) p.hi[b * g.hp + i] = bf16_zero();
    }
    __syncthreads();
    stamp(p.stamps, 1);
    hw_tile(g, p, p.h0, r0, r1, a0, a1, w2s, sc);
  }
  grid_sync(p.bar, g.blocks * ++nsync, p.stamps, 2);

  for (int t = 0; t < g.T; ++t) {
    bf16* xcur = p.x + (t % 2) * xstep;
    bf16* xnext = p.x + ((t + 1) % 2) * xstep;
    const int slot = 4 + 9 * t;

    // ---- A: the last step's argmax and embedding, then the attention ----
    for (int k = 0; t > 0 && lead && k < nrows; ++k) {
      const long long b = grp + (long long)k * groups;
      if (warp == 0) {
        float best = -INFINITY;
        int idx = -1;
        for (int j = lane; j < g.blocks; j += 32)
          better(best, idx, __ldcg(p.pval + b * g.blocks + j),
                 __ldcg(p.pidx + b * g.blocks + j));
        warp_better(best, idx);
        if (lane == 0) {
          idx = idx < 0 ? 0 : idx;
          s_word = idx;
          p.words[b * g.T + t - 1] = idx;
        }
      }
      __syncthreads();
      const bf16* src = p.emb_table + (long long)s_word * g.E;
      for (int e = tid; e < g.E; e += kP) xcur[b * g.kx + g.oemb + e] = src[e];
      __syncthreads();
    }
    stamp(p.stamps, slot);
    for (int k = 0; k < nrows; ++k) {
      const long long b = grp + (long long)k * groups;
      const F* own = attn + (long long)k * (arow + frow);
      if (g.res_attn)
        attend<F>(g, p, own, g.ps, own + arow, d1 - d0, d0, d1, lead, (int)b,
                  t, xcur, sc, attn_slope);
      else
        attend<F>(g, p, pre + b * g.R * g.A, g.A,
                  feat + b * g.R * g.D + d0, g.D, d0, d1, lead, (int)b, t,
                  xcur, sc, attn_slope);
    }
    grid_sync(p.bar, g.blocks * ++nsync, p.stamps, slot + 1);

    // ---- B: the cell on the block's units ----
    for (int m0 = 0; u1 > u0 && m0 < g.B; m0 += kMG) {
      const bf16* panel = cellw;
      for (int ua = u0; ua < u1; ua += kCellUnits) {
        const int n = imin(kCellUnits, u1 - ua), pw = cell_width(g.G, n);
        const bf16* wres = g.res_cell ? panel : nullptr;
        float* Z2 = Z + kMG * pw;
        if constexpr (CELL == kLSTM) {
          product(xcur, g.kx, 0, g.kx, m0, g.B, wres, CellW{&g, &p, 0, ua, n},
                  pw, Z, ring, g.stages, blk, wstage);
        } else {
          product(xcur, g.kx, 0, g.oh, m0, g.B, wres, CellW{&g, &p, 0, ua, n},
                  pw, Z, ring, g.stages, blk, wstage);
          if (g.carried)
            product(xcur, g.kx, g.oh, g.kx - g.oh, m0, g.B,
                    wres != nullptr ? wres + (long long)g.oh * pw : nullptr,
                    CellW{&g, &p, g.oh, ua, n}, pw, Z2, ring, g.stages, blk,
                    wstage);
        }
        const int mrows = imin(kMG, g.B - m0);
        for (int i = tid; i < mrows * n; i += kP) {
          const int m = i / n, u = i % n, unit = ua + u;
          const long long o = (long long)(m0 + m) * g.U + unit;
          float hn;
          if constexpr (CELL == kLSTM) {
            float z[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              z[q] = Z[m * pw + q * n + u] + p.b[q * g.U + unit];
            const float cn =
                sigmoid(z[1]) * p.c[o] + sigmoid(z[0]) * tanhf(z[2]);
            hn = sigmoid(z[3]) * tanhf(cn);
            p.c[o] = cn;
          } else {
            float xz[3], hz[3];
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              xz[q] = Z[m * pw + q * n + u] + p.b[q * g.U + unit];
              hz[q] = (g.carried ? Z2[m * pw + q * n + u] : 0.f) +
                      p.b_rec[q * g.U + unit];
            }
            const float zg = sigmoid(xz[0] + hz[0]);
            const float r = sigmoid(xz[1] + hz[1]);
            const float hh = tanhf(xz[2] + r * hz[2]);
            hn = zg * (g.carried ? p.h[o] : 0.f) + (1.f - zg) * hh;
          }
          p.h[o] = hn;
          xnext[(long long)(m0 + m) * g.kx + g.oh + unit] =
              __float2bfloat16_rn(hn);
        }
        __syncthreads();
        panel += (long long)g.Kc * pw;
      }
    }
    grid_sync(p.bar, g.blocks * ++nsync, p.stamps, slot + 3);

    // ---- C: act(h' Wi + bi), and h' W2 + b2 for the next attention ----
    for (int m0 = 0; i1 > i0 && m0 < g.B; m0 += kMG) {
      const bf16* panel = wis;
      for (int ca = i0; ca < i1; ca += kPW) {
        const int n = imin(kPW, i1 - ca), pw = ru(n, 8);
        product(xnext, g.kx, g.oh, ru(g.U, 16), m0, g.B,
                g.res_wi ? panel : nullptr, DenseW{p.wi, g.H, g.U, ca, n}, pw,
                Z, ring, g.stages, blk, wstage);
        const int mrows = imin(kMG, g.B - m0);
        for (int i = tid; i < mrows * n; i += kP) {
          const int m = i / n, c = i % n;
          p.hi[(long long)(m0 + m) * g.hp + ca + c] = __float2bfloat16_rn(
              lrelu(Z[m * pw + c] + p.bi[ca + c], slope));
        }
        __syncthreads();
        panel += (long long)ru(g.U, 16) * pw;
      }
    }
    if (t + 1 < g.T) hw_tile(g, p, p.h, r0, r1, a0, a1, w2s, sc);
    grid_sync(p.bar, g.blocks * ++nsync, p.stamps, slot + 5);

    // ---- D: the logits of the block's vocab columns, a partial argmax ----
    for (int m0 = 0; m0 < g.B; m0 += kMG) {
      const int mrows = imin(kMG, g.B - m0);
      if (tid < kMG) {
        s_best[tid] = -INFINITY;
        s_besti[tid] = -1;
      }
      __syncthreads();
      const bf16* panel = wos;
      for (int ca = o0; ca < o1; ca += kPW) {
        const int n = imin(kPW, o1 - ca), pw = ru(n, 8);
        product(p.hi, g.hp, 0, g.hp, m0, g.B, g.res_wo ? panel : nullptr,
                DenseW{p.wo, g.V, g.H, ca, n}, pw, Z, ring, g.stages, blk,
                wstage);
        // four lanes a row, each scanning every fourth id in order, then
        // the four met in a butterfly (the first index on a tie)
        {
          const int m = tid / 4, l = tid % 4;
          float best = -INFINITY;
          int idx = -1;
          if (m < mrows)
            for (int c = l; c < n; c += 4)
              better(best, idx, Z[m * pw + c] + p.bo[ca + c], ca + c);
          for (int o = 1; o < 4; o <<= 1)
            better(best, idx, __shfl_xor_sync(0xffffffffu, best, o),
                   __shfl_xor_sync(0xffffffffu, idx, o));
          // the panels come in id order: a later one wins only if greater
          if (l == 0 && m < mrows && idx >= 0 &&
              (s_besti[m] < 0 || best > s_best[m])) {
            s_best[m] = best;
            s_besti[m] = idx;
          }
        }
        __syncthreads();
        panel += (long long)g.hp * pw;
      }
      for (int m = tid; m < mrows; m += kP) {
        p.pval[(long long)(m0 + m) * g.blocks + blk] = s_best[m];
        p.pidx[(long long)(m0 + m) * g.blocks + blk] = s_besti[m];
      }
      __syncthreads();
    }
    grid_sync(p.bar, g.blocks * ++nsync, p.stamps, slot + 7);
  }

  // ---- the last step's argmax ----
  for (int k = 0; lead && k < nrows; ++k) {
    const long long b = grp + (long long)k * groups;
    if (warp == 0) {
      float best = -INFINITY;
      int idx = -1;
      for (int j = lane; j < g.blocks; j += 32)
        better(best, idx, __ldcg(p.pval + b * g.blocks + j),
               __ldcg(p.pidx + b * g.blocks + j));
      warp_better(best, idx);
      if (lane == 0) p.words[b * g.T + g.T - 1] = idx < 0 ? 0 : idx;
    }
  }
  __syncthreads();
  stamp(p.stamps, 4 + 9 * g.T);
}

// ---- the host side: check the record, then one cooperative launch ----

// bytes of a row's resident attention inputs (pre at pitch ps, then the
// features), each rounded to 16
// bytes of a row's resident attention inputs: pre at pitch ps, then the
// block's dw columns of the features, each rounded to 16
long long attn_row_bytes(int R, int dw, int ps, int esz) {
  return (long long)ru(R * ps * esz, 16) + ru(R * dw * esz, 16);
}

long long scratch_bytes(const Hd& h, int pwc, int pwi, int pwo, int rmax) {
  const int A = h.v[HD_A], R = h.v[HD_R];
  const bool gru_carried = h.v[HD_CELL] == kGRU && !h.v[HD_ZERO];
  const bool streamed = !(h.v[HD_RES_CELL] && h.v[HD_RES_WI] &&
                          h.v[HD_RES_WO]);
  const long long attn = 4LL * (2 * A + R + 32 + kP);
  const long long zcols =
      imax(imax(pwc * (gru_carried ? 2 : 1), pwi), pwo);
  const long long prod = 2LL * h.v[HD_STAGES] * kMG * kXSP +
                         (streamed ? 2LL * kBK * kPW : 0) + 4LL * kMG * zcols;
  const long long hw = 4LL * (kP + (long long)rmax * w2_pitch(h.v[HD_U]));
  const long long m = attn > prod ? (attn > hw ? attn : hw)
                                  : (prod > hw ? prod : hw);
  return ru((int)m, 16);
}

// The record's check; returns false for a plan this kernel cannot run.
bool plan_ok(const int* rec) {
  Hd h;
  for (int i = 0; i < HD_WORDS; ++i) h.v[i] = rec[i];
  const int cell = h.v[HD_CELL], B = h.v[HD_B], R = h.v[HD_R],
            A = h.v[HD_A], D = h.v[HD_D], E = h.v[HD_E], U = h.v[HD_U],
            H = h.v[HD_H], V = h.v[HD_V], T = h.v[HD_T],
            blocks = h.v[HD_BLOCKS], smem = h.v[HD_SMEM];
  if ((cell != kLSTM && cell != kGRU) || B < 1 || R < 1 || A < 1 || D < 1 ||
      E < 1 || U < 1 || H < 1 || V < 1 || T < 1 || blocks < 1 ||
      blocks > kMaxBlocks || smem < 0 || smem > kMaxSmemP)
    return false;
  const int flags[] = {HD_FEAT, HD_ZERO, HD_RES_ATTN, HD_RES_CELL,
                       HD_RES_WI, HD_RES_WO, HD_RES_W2};
  for (int f : flags)
    if (h.v[f] != 0 && h.v[f] != 1) return false;
  if (cell == kLSTM && h.v[HD_ZERO]) return false;
  if (h.v[HD_OEMB] != ru(D, 16) || h.v[HD_OH] != h.v[HD_OEMB] + ru(E, 16) ||
      h.v[HD_KX] != h.v[HD_OH] + ru(U, 16) || h.v[HD_HP] != ru(H, 16))
    return false;
  const int lpr = h.v[HD_LPR], ps = h.v[HD_PS];
  const int asplit = h.v[HD_ASPLIT];
  if (lpr < 1 || lpr > 32 || (lpr & (lpr - 1)) || ps < A ||
      h.v[HD_STAGES] < 2 || h.v[HD_STAGES] > kMaxStages || asplit < 1 ||
      asplit > blocks)
    return false;
  const int groups = blocks / asplit, dper = (D + asplit - 1) / asplit;
  const int G = cell == kLSTM ? 4 : 3;
  const bool carried = !(cell == kGRU && h.v[HD_ZERO]);
  const int Kc = carried ? h.v[HD_KX] : h.v[HD_OH];
  const int esz = h.v[HD_FEAT] ? 2 : 4;
  // the ranges: units, Wi and Wo columns, each cut in block order
  int pwc = 0, pwi = 0, pwo = 0, rmax = 0;
  long long area = 0;
  int nu = 0, ni = 0, no = 0;
  for (int j = 0; j < blocks; ++j) {
    const int* r = rec + HD_WORDS + j * BR_WORDS;
    if (r[BR_U0] != nu || r[BR_U1] < r[BR_U0] || r[BR_U1] > U ||
        r[BR_I0] != ni || r[BR_I1] < r[BR_I0] || r[BR_I1] > H ||
        r[BR_O0] != no || r[BR_O1] < r[BR_O0] || r[BR_O1] > V)
      return false;
    nu = r[BR_U1];
    ni = r[BR_I1];
    no = r[BR_O1];
    if (r[BR_R0] < 0 || r[BR_R1] < r[BR_R0] || r[BR_R1] > B ||
        r[BR_A0] < 0 || r[BR_A1] < r[BR_A0] || r[BR_A1] > A)
      return false;
    area += (long long)(r[BR_R1] - r[BR_R0]) * (r[BR_A1] - r[BR_A0]);
    if (r[BR_A1] > r[BR_A0]) rmax = imax(rmax, r[BR_R1] - r[BR_R0]);
    for (int q = 0; q < j; ++q) {  // h W2 tiles do not overlap
      const int* s = rec + HD_WORDS + q * BR_WORDS;
      if (r[BR_R0] < s[BR_R1] && s[BR_R0] < r[BR_R1] && r[BR_A0] < s[BR_A1] &&
          s[BR_A0] < r[BR_A1])
        return false;
    }
    const int grp = j / asplit;
    const int rows =
        grp < groups && grp < B ? (B - grp + groups - 1) / groups : 0;
    if (r[BR_ROWS] != rows) return false;
    if (r[BR_U1] > r[BR_U0])
      pwc = imax(pwc, cell_width(G, imin(kCellUnits, r[BR_U1] - r[BR_U0])));
    if (r[BR_I1] > r[BR_I0])
      pwi = imax(pwi, ru(imin(kPW, r[BR_I1] - r[BR_I0]), 8));
    if (r[BR_O1] > r[BR_O0])
      pwo = imax(pwo, ru(imin(kPW, r[BR_O1] - r[BR_O0]), 8));
  }
  if (nu != U || ni != H || no != V || area != (long long)B * A) return false;
  if (scratch_bytes(h, pwc, pwi, pwo, rmax) != h.v[HD_SCRATCH]) return false;
  // each block's regions, in order, 16-aligned, within smem
  for (int j = 0; j < blocks; ++j) {
    const int* r = rec + HD_WORDS + j * BR_WORDS;
    const long long size[6] = {
        h.v[HD_RES_CELL] ? cell_bytes(G, r[BR_U0], r[BR_U1], Kc) : 0,
        h.v[HD_RES_WI] ? dense_bytes(r[BR_I0], r[BR_I1], ru(U, 16)) : 0,
        h.v[HD_RES_WO] ? dense_bytes(r[BR_O0], r[BR_O1], h.v[HD_HP]) : 0,
        h.v[HD_RES_W2] ? 4LL * w2_pitch(U) * (r[BR_A1] - r[BR_A0]) : 0,
        h.v[HD_RES_ATTN]
            ? r[BR_ROWS] *
                  attn_row_bytes(R,
                                 imin(D, imin(D, j % asplit * dper) + dper) -
                                     imin(D, j % asplit * dper),
                                 ps, esz)
            : 0,
        h.v[HD_SCRATCH]};
    const int offs[6] = {r[BR_OFF_CELL], r[BR_OFF_WI], r[BR_OFF_WO],
                         r[BR_OFF_W2], r[BR_OFF_ATTN], r[BR_OFF_SCRATCH]};
    long long end = 0;
    for (int k = 0; k < 6; ++k) {
      if (offs[k] % 16 || offs[k] < end) return false;
      end = offs[k] + size[k];
    }
    if (end > smem) return false;
  }
  return true;
}

using KernelFn = void (*)(Ptrs, Hd, const int*, float, float);

KernelFn kernel_for(int cell, bool feat) {
  KernelFn fn;
  if (cell == kLSTM)
    fn = feat ? &decode_bf16_kernel<kLSTM, bf16>
              : &decode_bf16_kernel<kLSTM, float>;
  else
    fn = feat ? &decode_bf16_kernel<kGRU, bf16>
              : &decode_bf16_kernel<kGRU, float>;
  return fn;
}

}  // namespace

extern "C" {

// The whole bf16-weight greedy decode of an LSTM (cell 1) or GRU (cell 2)
// NIC in one cooperative launch. ptrs: the kNumPtrs tensors of struct Ptrs
// in its order (ops/fused_decode.py); plan: the launch record on the host
// (ops/decode_plan.py: the header, then a row a block), checked here;
// plan_dev: the same record in device memory, which the blocks read.
// Returns 0, cudaErrorInvalidValue for a record this kernel cannot run
// (before anything is launched), the error of setting the block's shared
// memory (more than the card has), cudaErrorCooperativeLaunchTooLarge for
// more blocks than can all be resident, or the launch's error.
int mtt_greedy_decode_bf16(void* const* ptrs, const int* plan,
                           const int* plan_dev, float slope, float attn_slope,
                           int device, void* stream_ptr) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!plan_ok(plan)) return (int)cudaErrorInvalidValue;
  Ptrs p;
  void** dst = reinterpret_cast<void**>(&p);
  for (int i = 0; i < kNumPtrs; ++i) dst[i] = ptrs[i];
  Hd hd;
  for (int i = 0; i < HD_WORDS; ++i) hd.v[i] = plan[i];
  const int blocks = hd.v[HD_BLOCKS], smem = hd.v[HD_SMEM];
  KernelFn fn = kernel_for(hd.v[HD_CELL], hd.v[HD_FEAT] != 0);
  if ((err = cudaFuncSetAttribute(
           reinterpret_cast<const void*>(fn),
           cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
    return (int)err;
  int per_sm = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, kP, smem)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  if ((long long)per_sm * sms < blocks)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if ((err = cudaMemsetAsync(p.bar, 0, sizeof(unsigned), stream)) !=
      cudaSuccess)
    return (int)err;
  void* args[] = {&p, &hd, (void*)&plan_dev, &slope, &attn_slope};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn),
                                    dim3(blocks), dim3(kP), args, smem,
                                    stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // extern "C"
