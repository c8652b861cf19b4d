// Two other ways to split a gather of long rows, for Hopper (sm_90a),
// measured beside the store row gather K1 (csrc/gather.cu) by
// masters_thesis_tpu_torch/scripts/gather_probe.py.
//
// Replaces the Pallas TPU kernels of scripts/gather_probe.py:
//   P1  make_pallas_take (:44, body _gather_kernel :41): K1 with each row
//       cut into S / s_block chunks of s_block x 128 values, one chunk per
//       grid cell (row, chunk)                  -> gather_rows_chunked_kernel
//   P2  make_dma_take (:82): one program issuing HBM->HBM row copies with
//       nb DMAs in flight on a ring of semaphores -> gather_rows_bulk_kernel
//   P3  _check (:146): P2's body at nb = 4, returning the rows; here the
//       same kernel at 4 stages.
// Both compute, for a store (N, W) of any element type and B row ids,
//
//   out[i, :width] = store[clamp(idx[i], 0, N - 1), :width]
//
// with int32 or int64 ids clamped as K1 clamps them (the TPU DMA of P2
// checks nothing).
//
// What bounds them on this card. A copy does no arithmetic: B rows read and
// written once, 2 x 64 x 1,310,736 B for 64 raw fp32 rows of the probe's
// store, 50.1 us at 3.35 TB/s. Reaching that takes enough bytes in flight:
// by Little's law 3.35 TB/s over about a microsecond of memory latency wants
// a few MB outstanding across the 132 SMs.
//
// What the designs do about it.
// P1 is K1's copy idiom on a grid of (chunk, row) blocks: each block loads
// its id itself, clamps it, and loops over its chunk, every thread issuing
// kUnroll loads of the widest vector that divides both bases, both pitches,
// the width and the chunk before its first store (16 KB in flight a block).
// The chunk sets how many blocks share a row: the probe's s_block 8 is 4 KB
// a block and 20,544 blocks for 64 padded rows, its s_block 2568 one block
// a row, 64 blocks on 132 SMs with 1 MB in flight in all. The probe measures
// where the card stops filling; nothing here tunes it away.
// P2 has no global -> global DMA on a GPU, so its copies go through shared
// memory with Hopper's bulk copies (the TMA without a tensor map). A
// persistent grid of one block per SM walks the (row, piece) work list. In
// each block one elected thread keeps `stages` pieces in flight through a
// ring: cp.async.bulk global -> stage completing on the stage's own mbarrier
// (its phase parity flips on each reuse), cp.async.bulk stage -> global in a
// bulk group, and a stage is loaded again only after the store that read it
// has read it (wait_group.read). The stages fill the shared memory, so at 2
// stages ~113 KB and at 16 stages ~14 KB a piece, ~227 KB in flight per SM
// either way; a piece stays under the mbarrier's 2^20-byte transaction
// count. Bulk copies need 16-byte-aligned addresses and sizes: where a
// source row and its destination row share their alignment modulo 16, the
// aligned middle goes by bulk copies and the head and tail (under 16 B each)
// by ordinary loads; where they do not (a pitch that is not a multiple of
// 16, as a raw bf16 row's 655,368 B), the whole row goes by ordinary loads.
// Those loads run in the block's other warps, beside the ring.
// Row offsets are 64-bit: a store at NSD scale holds more than 2^31 elements.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // vectors in flight per thread (K1's)
constexpr int kMaxGridY = 65535;
constexpr int kBulkThreads = 128;  // warp 0 drives the ring, warps 1-3 copy
constexpr int kMaxStages = 32;
constexpr int64_t kMaxPiece = (1 << 20) - 16;  // mbarrier transaction count

template <typename Index>
__device__ __forceinline__ int64_t clamped_id(const Index* idx, int r,
                                              int64_t n_store) {
  const int64_t id = (int64_t)idx[r];
  return id < 0 ? 0 : (id >= n_store ? n_store - 1 : id);
}

// ---- P1: (chunk, row) blocks ----

template <typename Vec, typename Index>
__global__ void __launch_bounds__(kThreads)
    gather_rows_chunked_kernel(const char* __restrict__ store,
                               const Index* __restrict__ idx,
                               char* __restrict__ out, int64_t n_store,
                               int64_t src_pitch, int64_t dst_pitch,
                               int64_t row_vecs, int64_t chunk_vecs,
                               int n_rows) {
  const int64_t begin = (int64_t)blockIdx.x * chunk_vecs;
  const int64_t end =
      begin + chunk_vecs < row_vecs ? begin + chunk_vecs : row_vecs;
  for (int r = blockIdx.y; r < n_rows; r += gridDim.y) {
    const int64_t id = clamped_id(idx, r, n_store);
    const Vec* src = reinterpret_cast<const Vec*>(store + id * src_pitch);
    Vec* dst = reinterpret_cast<Vec*>(out + (int64_t)r * dst_pitch);
    for (int64_t first = begin + threadIdx.x; first < end;
         first += kThreads * kUnroll) {
      Vec v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = first + u * kThreads;
        if (i < end) v[u] = __ldg(src + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = first + u * kThreads;
        if (i < end) dst[i] = v[u];
      }
    }
  }
}

template <typename Vec, typename Index>
cudaError_t launch_chunked(const void* store, const void* idx, void* out,
                           int64_t n_store, int64_t src_pitch,
                           int64_t dst_pitch, int64_t row_bytes,
                           int64_t chunk_bytes, int n_rows,
                           cudaStream_t stream) {
  const int64_t row_vecs = row_bytes / (int64_t)sizeof(Vec);
  const int64_t chunk_vecs = chunk_bytes / (int64_t)sizeof(Vec);
  const int64_t chunks = (row_vecs + chunk_vecs - 1) / chunk_vecs;
  if (chunks > INT_MAX) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)chunks,
                  (unsigned)(n_rows < kMaxGridY ? n_rows : kMaxGridY));
  gather_rows_chunked_kernel<Vec, Index><<<grid, kThreads, 0, stream>>>(
      static_cast<const char*>(store), static_cast<const Index*>(idx),
      static_cast<char*>(out), n_store, src_pitch, dst_pitch, row_vecs,
      chunk_vecs, n_rows);
  return cudaGetLastError();
}

template <typename Index>
cudaError_t launch_chunked_widest(const void* store, const void* idx,
                                  void* out, int64_t n_store,
                                  int64_t src_pitch, int64_t dst_pitch,
                                  int64_t row_bytes, int64_t chunk_bytes,
                                  int n_rows, cudaStream_t stream) {
  const uint64_t align = (uint64_t)(uintptr_t)store |
                         (uint64_t)(uintptr_t)out | (uint64_t)src_pitch |
                         (uint64_t)dst_pitch | (uint64_t)row_bytes |
                         (uint64_t)chunk_bytes;
  if (align % 16 == 0)
    return launch_chunked<uint4, Index>(store, idx, out, n_store, src_pitch,
                                        dst_pitch, row_bytes, chunk_bytes,
                                        n_rows, stream);
  if (align % 8 == 0)
    return launch_chunked<uint2, Index>(store, idx, out, n_store, src_pitch,
                                        dst_pitch, row_bytes, chunk_bytes,
                                        n_rows, stream);
  if (align % 4 == 0)
    return launch_chunked<unsigned int, Index>(
        store, idx, out, n_store, src_pitch, dst_pitch, row_bytes,
        chunk_bytes, n_rows, stream);
  if (align % 2 == 0)
    return launch_chunked<unsigned short, Index>(
        store, idx, out, n_store, src_pitch, dst_pitch, row_bytes,
        chunk_bytes, n_rows, stream);
  return launch_chunked<unsigned char, Index>(store, idx, out, n_store,
                                              src_pitch, dst_pitch, row_bytes,
                                              chunk_bytes, n_rows, stream);
}

// ---- P2 and P3: bulk copies through a ring of shared-memory stages ----

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one arrival (the elected thread's expect_tx) a phase
__device__ __forceinline__ void mbarrier_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(1)
               : "memory");
}

__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> shared, completing `bytes` of the barrier's transaction count
__device__ __forceinline__ void bulk_load(uint32_t stage, const char* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(stage),
      "l"((uint64_t)(uintptr_t)src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared -> global, as one bulk group
__device__ __forceinline__ void bulk_store(char* dst, uint32_t stage,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          (uint64_t)(uintptr_t)dst),
      "r"(stage), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Where row r comes from and goes to, and which of its bytes the bulk
// copies carry: [head, head + body). A row whose source and destination
// differ in alignment modulo 16 has bulk == false and goes by ordinary loads.
struct Row {
  const char* src;
  char* dst;
  int64_t head, body;
  bool bulk;
};

template <typename Index>
__device__ __forceinline__ Row row_at(const char* store, const Index* idx,
                                      char* out, int64_t n_store,
                                      int64_t src_pitch, int64_t dst_pitch,
                                      int64_t row_bytes, int r) {
  Row row;
  row.src = store + clamped_id(idx, r, n_store) * src_pitch;
  row.dst = out + (int64_t)r * dst_pitch;
  const uintptr_t s = (uintptr_t)row.src, d = (uintptr_t)row.dst;
  row.bulk = ((s ^ d) & 15) == 0;
  int64_t head = (int64_t)((16 - (s & 15)) & 15);
  if (!row.bulk || head > row_bytes) head = row_bytes;
  row.head = head;
  row.body = (row_bytes - head) & ~(int64_t)15;
  return row;
}

template <typename Vec>
__device__ __forceinline__ void copy_vecs(char* dst, const char* src,
                                          int64_t n, int t, int nt) {
  const Vec* s = reinterpret_cast<const Vec*>(src);
  Vec* d = reinterpret_cast<Vec*>(dst);
  for (int64_t i = t; i < n / (int64_t)sizeof(Vec); i += nt) d[i] = s[i];
}

// n bytes by thread t of nt, in the widest vector the addresses allow
__device__ __forceinline__ void copy_bytes(char* dst, const char* src,
                                           int64_t n, int t, int nt) {
  if (n <= 0) return;
  const uint64_t a =
      (uint64_t)(uintptr_t)dst | (uint64_t)(uintptr_t)src | (uint64_t)n;
  if (a % 16 == 0)
    copy_vecs<uint4>(dst, src, n, t, nt);
  else if (a % 8 == 0)
    copy_vecs<uint2>(dst, src, n, t, nt);
  else if (a % 4 == 0)
    copy_vecs<unsigned int>(dst, src, n, t, nt);
  else if (a % 2 == 0)
    copy_vecs<unsigned short>(dst, src, n, t, nt);
  else
    copy_vecs<unsigned char>(dst, src, n, t, nt);
}

template <typename Index>
__global__ void __launch_bounds__(kBulkThreads)
    gather_rows_bulk_kernel(const char* __restrict__ store,
                            const Index* __restrict__ idx,
                            char* __restrict__ out, int64_t n_store,
                            int64_t src_pitch, int64_t dst_pitch,
                            int64_t row_bytes, int64_t piece_bytes,
                            int64_t pieces, int stages, int n_rows) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  const int64_t items = (int64_t)n_rows * pieces;
  const int64_t step = gridDim.x;

  if (threadIdx.x >= 32) {
    // warps 1-3: the bytes the bulk copies cannot carry. A bulk row's head
    // and tail go with its piece 0; a row that is not aligned like its
    // destination goes piece by piece.
    const int t = threadIdx.x - 32, nt = kBulkThreads - 32;
    for (int64_t item = blockIdx.x; item < items; item += step) {
      const int64_t p = item % pieces;
      const Row row = row_at(store, idx, out, n_store, src_pitch, dst_pitch,
                             row_bytes, (int)(item / pieces));
      if (!row.bulk) {
        const int64_t from = p * piece_bytes;
        const int64_t to =
            from + piece_bytes < row_bytes ? from + piece_bytes : row_bytes;
        copy_bytes(row.dst + from, row.src + from, to - from, t, nt);
      } else if (p == 0) {
        const int64_t tail = row.head + row.body;
        copy_bytes(row.dst, row.src, row.head, t, nt);
        copy_bytes(row.dst + tail, row.src + tail, row_bytes - tail, t, nt);
      }
    }
    return;
  }
  if (threadIdx.x != 0) return;

  // thread 0: the ring
  for (int s = 0; s < stages; ++s) mbarrier_init(shared_addr(&full[s]));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  const uint32_t ring0 = shared_addr(ring);

  // the next item of this block's share after `item` that has bulk bytes,
  // with its source, destination and size; `items` when there is none
  struct Piece {
    const char* src;
    char* dst;
    uint32_t bytes;
  };
  auto next_piece = [&](int64_t item, Piece* piece) -> int64_t {
    for (item += step; item < items; item += step) {
      const int64_t from = (item % pieces) * piece_bytes;
      const Row row = row_at(store, idx, out, n_store, src_pitch, dst_pitch,
                             row_bytes, (int)(item / pieces));
      if (!row.bulk || from >= row.body) continue;
      const int64_t to =
          from + piece_bytes < row.body ? from + piece_bytes : row.body;
      piece->src = row.src + row.head + from;
      piece->dst = row.dst + row.head + from;
      piece->bytes = (uint32_t)(to - from);
      return item;
    }
    return items;
  };
  auto load = [&](int s, const Piece& piece) {
    bulk_load(ring0 + (uint32_t)(s * piece_bytes), piece.src, piece.bytes,
              shared_addr(&full[s]));
  };

  Piece ld, st;
  const int64_t first = (int64_t)blockIdx.x - step;
  int64_t load_item = next_piece(first, &ld);
  int64_t store_item = next_piece(first, &st);
  for (int s = 0; s < stages && load_item < items; ++s) {
    load(s, ld);
    load_item = next_piece(load_item, &ld);
  }
  // Piece k sits in stage k % stages, the (k / stages)-th use of that stage.
  // After piece k's store, the stage of piece k - lag is loaded again with
  // piece k - lag + stages, once the stores before the last `lag` have read
  // their stages: with lag 1 the newest store overlaps that wait.
  const int lag = stages > 1 ? 1 : 0;
  for (int64_t k = 0; store_item < items; ++k) {
    const int s = (int)(k % stages);
    mbarrier_wait(shared_addr(&full[s]), (uint32_t)((k / stages) & 1));
    bulk_store(st.dst, ring0 + (uint32_t)(s * piece_bytes), st.bytes);
    store_item = next_piece(store_item, &st);
    if (load_item < items && k >= lag) {
      if (lag)
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      else
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      load((int)((k - lag) % stages), ld);
      load_item = next_piece(load_item, &ld);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The piece size of `stages` stages: the largest multiple of 16 bytes such
// that the stages fit in a block's shared memory beside the barriers, no
// larger than a row needs and under the mbarrier's transaction count.
cudaError_t piece_size(int stages, int64_t row_bytes, int device,
                       int64_t* piece_bytes) {
  if (stages < 1 || stages > kMaxStages || row_bytes <= 0)
    return cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, gather_rows_bulk_kernel<int32_t>);
  if (err != cudaSuccess) return err;
  int64_t piece = ((int64_t)optin - (int64_t)attr.sharedSizeBytes) / stages;
  piece &= ~(int64_t)15;
  const int64_t row16 = (row_bytes + 15) & ~(int64_t)15;
  if (piece > row16) piece = row16;
  if (piece > kMaxPiece) piece = kMaxPiece;
  if (piece < 16) return cudaErrorInvalidValue;
  *piece_bytes = piece;
  return cudaSuccess;
}

template <typename Index>
cudaError_t launch_bulk(const void* store, const void* idx, void* out,
                        int64_t n_store, int64_t src_pitch, int64_t dst_pitch,
                        int64_t row_bytes, int stages, int n_rows, int device,
                        cudaStream_t stream) {
  int64_t piece_bytes = 0;
  cudaError_t err = piece_size(stages, row_bytes, device, &piece_bytes);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t pieces = (row_bytes + piece_bytes - 1) / piece_bytes;
  const int64_t items = pieces * n_rows;
  const int blocks = (int)(items < sms ? items : sms);
  const size_t smem = (size_t)stages * (size_t)piece_bytes;
  err = cudaFuncSetAttribute(gather_rows_bulk_kernel<Index>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  gather_rows_bulk_kernel<Index><<<blocks, kBulkThreads, smem, stream>>>(
      static_cast<const char*>(store), static_cast<const Index*>(idx),
      static_cast<char*>(out), n_store, src_pitch, dst_pitch, row_bytes,
      piece_bytes, pieces, stages, n_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// P1. Copies row_bytes from the start of store row clamp(idx[r], 0,
// n_store - 1) to out row r, for r < n_rows, one block per chunk of
// chunk_bytes of a row. Pitches and sizes are in bytes; idx_bytes is 4
// (int32 ids) or 8 (int64 ids). Launches one kernel on the stream, without
// synchronising. Returns 0, or the CUDA error of the launch.
int mtt_gather_rows_chunked(const void* store, const void* idx, void* out,
                            long long n_store, long long src_pitch,
                            long long dst_pitch, long long row_bytes,
                            long long chunk_bytes, int n_rows, int idx_bytes,
                            int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows <= 0 || row_bytes <= 0) return 0;
  if (n_store <= 0 || chunk_bytes <= 0 || (idx_bytes != 4 && idx_bytes != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  err = idx_bytes == 8
            ? launch_chunked_widest<int64_t>(store, idx, out, n_store,
                                             src_pitch, dst_pitch, row_bytes,
                                             chunk_bytes, n_rows, stream)
            : launch_chunked_widest<int32_t>(store, idx, out, n_store,
                                             src_pitch, dst_pitch, row_bytes,
                                             chunk_bytes, n_rows, stream);
  return (int)err;
}

// P2 and P3. The same copy through `stages` (1 to 32) shared-memory stages
// of bulk copies in flight in each block of a grid of one block per SM.
// store and out must be 16-byte aligned for the bulk copies to reach rows
// that are. Returns 0, or the CUDA error of the set-up or the launch.
int mtt_gather_rows_bulk(const void* store, const void* idx, void* out,
                         long long n_store, long long src_pitch,
                         long long dst_pitch, long long row_bytes, int stages,
                         int n_rows, int idx_bytes, int device,
                         void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows <= 0 || row_bytes <= 0) return 0;
  if (n_store <= 0 || (idx_bytes != 4 && idx_bytes != 8) ||
      ((uintptr_t)store | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  err = idx_bytes == 8
            ? launch_bulk<int64_t>(store, idx, out, n_store, src_pitch,
                                   dst_pitch, row_bytes, stages, n_rows,
                                   device, stream)
            : launch_bulk<int32_t>(store, idx, out, n_store, src_pitch,
                                   dst_pitch, row_bytes, stages, n_rows,
                                   device, stream);
  return (int)err;
}

}  // extern "C"
