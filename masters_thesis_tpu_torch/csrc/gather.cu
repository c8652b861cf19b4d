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
// (3.35 TB/s: ~72 us for the 242 MB read and written). The TPU kernel drives
// one DMA per row from a scalar-prefetched id and needs a lane-packed
// (N, S, 128) layout for it; the card needs neither.
//
// What the design does about it. The store stays 2-D. A grid of (column chunk,
// row) blocks: each block loads its row's id itself, clamps it, and copies one
// chunk of kThreads x kUnroll vectors, every thread issuing kUnroll loads
// before its first store so that enough bytes are in flight to cover the
// memory latency. Neighbouring threads touch neighbouring vectors. The vector
// is the widest of 16, 8, 4, 2 or 1 bytes that divides both base addresses,
// both row pitches and the copied width: a flagship raw bf16 row is 655,368 B,
// a multiple of 8 but not of 16, so odd rows would misalign 16-byte vectors.
// Row offsets are 64-bit: a store at NSD scale holds more than 2^31 elements.
// TMA bulk copies and tuning are left for later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;      // vectors in flight per thread
constexpr int kMaxGridY = 65535;

template <typename Vec, typename Index>
__global__ void gather_rows_kernel(const char* __restrict__ store,
                                   const Index* __restrict__ idx,
                                   char* __restrict__ out, int64_t n_store,
                                   int64_t src_pitch, int64_t dst_pitch,
                                   int64_t row_vecs, int n_rows) {
  const int64_t first =
      (int64_t)blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  for (int r = blockIdx.y; r < n_rows; r += gridDim.y) {
    int64_t id = (int64_t)idx[r];
    id = id < 0 ? 0 : (id >= n_store ? n_store - 1 : id);
    const Vec* src = reinterpret_cast<const Vec*>(store + id * src_pitch);
    Vec* dst = reinterpret_cast<Vec*>(out + (int64_t)r * dst_pitch);
    Vec v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = first + u * kThreads;
      if (i < row_vecs) v[u] = __ldg(src + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = first + u * kThreads;
      if (i < row_vecs) dst[i] = v[u];
    }
  }
}

template <typename Vec, typename Index>
cudaError_t launch(const void* store, const void* idx, void* out,
                   int64_t n_store, int64_t src_pitch, int64_t dst_pitch,
                   int64_t row_bytes, int n_rows, cudaStream_t stream) {
  const int64_t row_vecs = row_bytes / (int64_t)sizeof(Vec);
  const int64_t per_block = kThreads * kUnroll;
  const dim3 grid((unsigned)((row_vecs + per_block - 1) / per_block),
                  (unsigned)(n_rows < kMaxGridY ? n_rows : kMaxGridY));
  gather_rows_kernel<Vec, Index><<<grid, kThreads, 0, stream>>>(
      static_cast<const char*>(store), static_cast<const Index*>(idx),
      static_cast<char*>(out), n_store, src_pitch, dst_pitch, row_vecs,
      n_rows);
  return cudaGetLastError();
}

template <typename Index>
cudaError_t launch_widest(const void* store, const void* idx, void* out,
                          int64_t n_store, int64_t src_pitch,
                          int64_t dst_pitch, int64_t row_bytes, int n_rows,
                          cudaStream_t stream) {
  const uint64_t align = (uint64_t)(uintptr_t)store | (uint64_t)(uintptr_t)out |
                         (uint64_t)src_pitch | (uint64_t)dst_pitch |
                         (uint64_t)row_bytes;
  if (align % 16 == 0)
    return launch<uint4, Index>(store, idx, out, n_store, src_pitch,
                                dst_pitch, row_bytes, n_rows, stream);
  if (align % 8 == 0)
    return launch<uint2, Index>(store, idx, out, n_store, src_pitch,
                                dst_pitch, row_bytes, n_rows, stream);
  if (align % 4 == 0)
    return launch<unsigned int, Index>(store, idx, out, n_store, src_pitch,
                                       dst_pitch, row_bytes, n_rows, stream);
  if (align % 2 == 0)
    return launch<unsigned short, Index>(store, idx, out, n_store, src_pitch,
                                         dst_pitch, row_bytes, n_rows,
                                         stream);
  return launch<unsigned char, Index>(store, idx, out, n_store, src_pitch,
                                      dst_pitch, row_bytes, n_rows, stream);
}

}  // namespace

extern "C" {

// Copies row_bytes from the start of store row clamp(idx[r], 0, n_store - 1)
// to out row r, for r < n_rows. Pitches and widths are in bytes; idx_bytes is
// 4 (int32 ids) or 8 (int64 ids). Launches one kernel on the stream, without
// synchronising. Returns 0, or the CUDA error of the launch.
int mtt_gather_rows(const void* store, const void* idx, void* out,
                    long long n_store, long long src_pitch,
                    long long dst_pitch, long long row_bytes, int n_rows,
                    int idx_bytes, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows <= 0 || row_bytes <= 0) return 0;
  if (n_store <= 0 || (idx_bytes != 4 && idx_bytes != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  err = idx_bytes == 8
            ? launch_widest<int64_t>(store, idx, out, n_store, src_pitch,
                                     dst_pitch, row_bytes, n_rows, stream)
            : launch_widest<int32_t>(store, idx, out, n_store, src_pitch,
                                     dst_pitch, row_bytes, n_rows, stream);
  return (int)err;
}

}  // extern "C"
