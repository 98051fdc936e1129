// Row gather for Hopper (sm_90a): out[j, :] = h[idx[j], :].
//
// Replaces graphconvgeo_tpu/ops/gather_pallas.py :: gather_rows_pallas (the
// Pallas kernel _gather_kernel_flat, a ring of one DMA per row). The copy is
// by bytes, so one kernel serves every element type whose row is a whole
// number of 16-byte vectors (float32 and bfloat16 rows among them). Valid
// indices are the caller's contract, as in the JAX package: nothing checks
// them on the device or the host.
//
// What bounds it on this card: bytes. It reads the index and writes M rows
// once; the table h is read once if it stays in the 50 MB L2 (rows that
// repeat are read again from L2, not from device memory). At M rows of F
// values the output write dominates: M * F * itemsize bytes at 3.35 TB/s.
//
// What the design does about that, simply first. One warp per output row,
// in a grid-stride loop over the rows; each lane copies 16-byte vectors of
// the row (neighbouring lanes on neighbouring addresses), the table read
// through the read-only cache. Several warps per SM keep many row copies in
// flight, which is what the TPU kernel's DMA ring did with its semaphores.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr long long kMaxBlocks = 8192;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint4* __restrict__ h,
                   const int* __restrict__ idx,
                   uint4* __restrict__ out,
                   long long m,
                   int row_vecs) {
  const int lane = threadIdx.x & 31;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  for (long long j = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32; j < m;
       j += n_warps) {
    const uint4* src = h + static_cast<size_t>(idx[j]) * row_vecs;
    uint4* dst = out + static_cast<size_t>(j) * row_vecs;
    for (int v = lane; v < row_vecs; v += 32) dst[v] = __ldg(src + v);
  }
}

}  // namespace

// C entry: out[m, row_bytes] = h[idx[j], row_bytes] for j < m, with
// row_bytes a multiple of 16 and h, out 16-byte aligned. Returns the
// launch's cudaGetLastError() as an int (0 = launched, or nothing to copy).
extern "C" int gather_rows_16b(const void* h, const int* idx, void* out, long long m,
                               int row_bytes, void* stream) {
  if (m < 0 || row_bytes <= 0 || row_bytes % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) {
    return 0;
  }
  const long long want = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  gather_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(h), idx, static_cast<uint4*>(out), m, row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}
