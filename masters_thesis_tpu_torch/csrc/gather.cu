// Batch row gather from a device-resident store, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel masters_thesis_tpu/ops/gather.py::
// _pallas_gather (body _gather_kernel). For a store (N, W) of any element
// type and B row ids:
//
//   out[i, :width] = store[clamp(idx[i], 0, N - 1), :width]
//
// The ids are int32 (the shared BatchPipeline) or int64 (torch indexing), and
// are clamped here, as the TPU path clamps before its DMA (gather.py:90).
//
// What bounds it on this card. It is a copy: no arithmetic, B rows read and
// written once. A flagship train batch is 64 pregathered rows of 472,576 fp32
// (1.89 MB a row, 121 MB a batch), so the bound is device-memory bandwidth
// (3.35 TB/s: ~72 us for the 242 MB read and written). The stores of the
// other models are narrower: 2 KB rows (ThinkAndTell's PCA pack), whose batch
// is 128 KB and takes a launch and one memory round trip, and 400-512 KB rows
// (img_nic, cnn_rnn), 15-20 us of bytes. The TPU kernel drives one DMA per
// row from a scalar-prefetched id and needs a lane-packed (N, S, 128) layout
// for it; the card needs neither.
//
// What the design does about it. The store stays 2-D. A (piece, row) grid:
// each row is cut into `pieces` pieces of piece_vecs vectors, and each block
// loads its row's id itself, clamps it in the ids' own type (a min and a max
// for int32 ids, on the path from the id's load to the row's), and copies
// one piece, every thread issuing its loads (up to kUnroll) before its first
// store, so that enough bytes are in flight to cover the memory latency.
// Neighbouring threads touch neighbouring vectors. The plan is made by ops/gather.py::gather_plan from
// the row's bytes, and each of its choices is the one that measured faster
// on an H100 at the port's store widths (PERF.md has the numbers):
//   - a row under a block's sweep (kThreads x kUnroll vectors) is one piece
//     for a block of a thread a vector (the 2 KB PCA row: 128 threads, 64
//     blocks for 64 rows). Such a batch takes a launch and one memory round
//     trip, and a row a block spreads it over the most SMs; several rows a
//     block, or several vectors a thread, measured slower;
//   - a longer row is cut into equal pieces, so that no row ends in a
//     half-empty block (a 401,408 B img_nic row: 25 pieces of 1,004
//     vectors, not 24.5 of 1,024): of at most a sweep under 1 MiB, with the
//     row loads marked evict-first (ld.global.cs: the batch is read once,
//     and its rows leave L2 to the output, which the model reads next),
//     and of at most half a sweep from 1 MiB, through the read-only path
//     (__ldg), where evict-first loads measured slower (the 1.6-1.9 MB
//     LcNIC rows).
// The host path before the launch is as much a part of the design as the
// kernel: on the narrow stores it is longer than the kernel. The entry point
// takes one launch record (sizes, device and plan, made once a shape in
// Python), sets the device only when it is not current, and launches. The
// vector is the widest of 16, 8, 4, 2 or 1 bytes that divides both base
// addresses, the store's row pitch and the copied width: a flagship raw bf16
// row is 655,368 B, a multiple of 8 but not of 16, so odd rows would
// misalign 16-byte vectors. Row offsets are 64-bit: a store at NSD scale
// holds more than 2^31 elements. TMA bulk copies (csrc/gather_probe.cu, P2)
// measured slower at the flagship row.

#include <cuda_runtime.h>

#include <cstdint>
#include <limits>

namespace {

constexpr int kThreads = 256;   // the most threads a block has
constexpr int kUnroll = 4;      // vectors in flight per thread
constexpr int kMaxGridY = 65535;

// kVecs: vectors a thread copies (1, or kUnroll); kStream: row loads marked
// evict-first (ld.global.cs), else through the read-only path (__ldg)
template <typename Vec, typename Index, int kVecs, bool kStream>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const char* __restrict__ store,
                       const Index* __restrict__ idx, char* __restrict__ out,
                       Index last, int64_t src_pitch, int64_t dst_pitch,
                       unsigned row_vecs, unsigned piece_vecs, int n_rows) {
  // offsets within a row fit 32 bits (the entry point checks row_vecs)
  const unsigned begin = blockIdx.x * piece_vecs;
  const unsigned end =
      begin + piece_vecs < row_vecs ? begin + piece_vecs : row_vecs;
  const unsigned first = begin + threadIdx.x;
  unsigned r = blockIdx.y;      // gridDim.y <= n_rows: every block has a row
  do {
    // the clamp in the ids' own type: a min and a max for int32 ids
    Index id = idx[r];
    id = id < Index(0) ? Index(0) : (id > last ? last : id);
    const Vec* src =
        reinterpret_cast<const Vec*>(store + (int64_t)id * src_pitch);
    Vec* dst = reinterpret_cast<Vec*>(out + (int64_t)r * dst_pitch);
    Vec v[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const unsigned i = first + u * blockDim.x;
      if (i < end) v[u] = kStream ? __ldcs(src + i) : __ldg(src + i);
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const unsigned i = first + u * blockDim.x;
      if (i < end) dst[i] = v[u];
    }
    r += gridDim.y;
  } while (r < (unsigned)n_rows);
}

// One launch's sizes and plan, as ops/gather.py::_pack lays them out
struct Launch {
  long long n_store, src_pitch, row_bytes, n_rows, idx_bytes, device;
  long long vec_bytes, threads, pieces, piece_vecs, stream;
};

template <typename Vec, typename Index, int kVecs, bool kStream>
cudaError_t launch(const void* store, const void* idx, void* out,
                   const Launch& a, cudaStream_t stream) {
  const dim3 grid((unsigned)a.pieces,
                  (unsigned)(a.n_rows < kMaxGridY ? a.n_rows : kMaxGridY));
  // the last row an id may name, within the ids' type (an int32 id cannot
  // pass a store of more rows than int32 holds)
  const long long top = (long long)std::numeric_limits<Index>::max();
  const Index last = (Index)(a.n_store - 1 < top ? a.n_store - 1 : top);
  gather_rows_kernel<Vec, Index, kVecs, kStream>
      <<<grid, (unsigned)a.threads, 0, stream>>>(
          static_cast<const char*>(store), static_cast<const Index*>(idx),
          static_cast<char*>(out), last, a.src_pitch, a.row_bytes,
          (unsigned)(a.row_bytes / (int64_t)sizeof(Vec)),
          (unsigned)a.piece_vecs, (int)a.n_rows);
  return cudaGetLastError();
}

// the kernel for a's vector, its vectors a thread and its loads
template <typename Vec, typename Index>
cudaError_t launch_plan(const void* store, const void* idx, void* out,
                        const Launch& a, cudaStream_t stream) {
  const bool one = a.piece_vecs <= a.threads;
  if (a.stream)
    return one ? launch<Vec, Index, 1, true>(store, idx, out, a, stream)
               : launch<Vec, Index, kUnroll, true>(store, idx, out, a,
                                                   stream);
  return one ? launch<Vec, Index, 1, false>(store, idx, out, a, stream)
             : launch<Vec, Index, kUnroll, false>(store, idx, out, a,
                                                  stream);
}

template <typename Index>
cudaError_t launch_vec(const void* store, const void* idx, void* out,
                       const Launch& a, cudaStream_t stream) {
  switch (a.vec_bytes) {
    case 16:
      return launch_plan<uint4, Index>(store, idx, out, a, stream);
    case 8:
      return launch_plan<uint2, Index>(store, idx, out, a, stream);
    case 4:
      return launch_plan<unsigned int, Index>(store, idx, out, a, stream);
    case 2:
      return launch_plan<unsigned short, Index>(store, idx, out, a, stream);
    default:
      return launch_plan<unsigned char, Index>(store, idx, out, a, stream);
  }
}

}  // namespace

extern "C" {

// Copies row_bytes from the start of store row clamp(idx[r], 0, n_store - 1)
// to row r of the contiguous out (pitch row_bytes), for r < n_rows, with the
// sizes and the plan in `args` (eleven long longs, in the order of struct
// Launch: ops/gather.py::_pack). Pitches and widths are in bytes; idx_bytes
// is 4 (int32 ids) or 8 (int64 ids). The plan (ops/gather.py::gather_plan):
// vec_bytes, one of 16, 8, 4, 2, 1, must divide both bases, the pitch and
// the width, and the row hold fewer than 2^31 vectors; each row is cut into
// `pieces` pieces of piece_vecs vectors (pieces x piece_vecs must cover the
// row, and every piece hold a vector of it), each piece copied by a block of
// `threads` threads (a multiple of 32, up to 256, with at most kUnroll
// vectors a thread), with row loads marked evict-first where `stream` is 1
// (0: the read-only path). A plan it cannot run is refused. Sets the device
// only when it is not the current one, and launches one kernel on the
// stream, without synchronising. Returns 0, or the CUDA error of the launch.
int mtt_gather_rows(const void* store, const void* idx, void* out,
                    const long long* args, void* stream_ptr) {
  const Launch a = *reinterpret_cast<const Launch*>(args);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != a.device)
    err = cudaSetDevice((int)a.device);
  if (err != cudaSuccess) return (int)err;
  if (a.n_rows <= 0 || a.row_bytes <= 0) return 0;
  const uint64_t align = (uint64_t)(uintptr_t)store |
                         (uint64_t)(uintptr_t)out | (uint64_t)a.src_pitch |
                         (uint64_t)a.row_bytes;
  const bool vec_ok = (a.vec_bytes == 16 || a.vec_bytes == 8 ||
                       a.vec_bytes == 4 || a.vec_bytes == 2 ||
                       a.vec_bytes == 1) &&
                      align % (uint64_t)a.vec_bytes == 0;
  const long long row_vecs = vec_ok ? a.row_bytes / a.vec_bytes : 0;
  if (a.n_store <= 0 || (a.idx_bytes != 4 && a.idx_bytes != 8) || !vec_ok ||
      row_vecs > 0x7fffffff ||
      a.threads < 32 || a.threads > kThreads || a.threads % 32 != 0 ||
      a.n_rows > 0x7fffffff || a.pieces < 1 || a.pieces > 0x7fffffff ||
      a.piece_vecs < 1 || a.piece_vecs > a.threads * kUnroll ||
      (a.stream != 0 && a.stream != 1) ||
      a.pieces * a.piece_vecs < row_vecs ||
      (a.pieces - 1) * a.piece_vecs >= row_vecs)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  err = a.idx_bytes == 8 ? launch_vec<int64_t>(store, idx, out, a, stream)
                         : launch_vec<int32_t>(store, idx, out, a, stream);
  return (int)err;
}

}  // extern "C"
