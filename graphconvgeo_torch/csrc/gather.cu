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
// What the design does about that. Each warp takes a contiguous run of
// about kWarpRows rows (a grid of ceil(M / (8 * kWarpRows)) blocks), so the
// runs are short and no warp trails the others. A warp loads the indices of
// its run with one coalesced load and hands them out with __shfl_sync (no
// lane waits on an index load per row), then copies kRows rows at a time:
// every lane issues its 16-byte loads of all kRows rows (neighbouring lanes
// on neighbouring addresses, through the read-only cache) before any store.
// The stores are evict-first (st.global.cs), so the output stream does not
// evict the table from L2. These choices won on an H100 against
// torch.index_select in turns (PERF.md: 0.92x at 606,400 rows of 384
// float32, 0.27x at 256 bfloat16); plain stores cost about 10%, longer runs
// a warp or a grid of the resident blocks 5-7%, fewer rows in flight under
// 1%.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kRows = 4;      // rows a warp loads before it stores any
constexpr int kWarpRows = 4;  // rows in a warp's run

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint4* __restrict__ h,
                   const int* __restrict__ idx,
                   uint4* __restrict__ out,
                   long long m,
                   int row_vecs) {
  const int lane = threadIdx.x & 31;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  const long long w = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  const long long end = (w + 1) * m / n_warps;
  for (long long j0 = w * m / n_warps; j0 < end; j0 += 32) {  // uniform across the warp
    const int n = static_cast<int>(end - j0 < 32 ? end - j0 : 32);
    const int mine = lane < n ? __ldg(idx + j0 + lane) : 0;
    for (int r0 = 0; r0 < n; r0 += kRows) {
      const uint4* src[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int row = __shfl_sync(0xffffffffu, mine, (r0 + q) & 31);
        src[q] = h + static_cast<size_t>(row) * row_vecs;
      }
      uint4* dst = out + static_cast<size_t>(j0 + r0) * row_vecs;
      for (int v = lane; v < row_vecs; v += 32) {
        uint4 val[kRows];
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          if (r0 + q < n) val[q] = __ldg(src[q] + v);
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          if (r0 + q < n) __stcs(dst + static_cast<size_t>(q) * row_vecs + v, val[q]);
      }
    }
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
  constexpr long long block_rows = static_cast<long long>(kWarpsPerBlock) * kWarpRows;
  long long blocks = (m + block_rows - 1) / block_rows;
  blocks = blocks > 0x7fffffffLL ? 0x7fffffffLL : blocks;
  gather_rows_kernel<<<static_cast<int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(h), idx, static_cast<uint4*>(out), m, row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}
