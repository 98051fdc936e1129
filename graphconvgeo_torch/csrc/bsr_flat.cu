// Flat-tile block-sparse × dense product for Hopper (sm_90a), float32.
//
// Replaces graphconvgeo_tpu/ops/spmm_pallas.py :: _bsr_flat_matmul (the
// Pallas kernel _flat_kernel). For each tile t, sorted by (row block, column
// block), it computes
//     out[rowblk[t]*B : +B, :] += tiles[t] @ h[colblk[t]*B : +B, :]
// and writes every output row block exactly once; a row block that owns no
// tile is written as zeros.
//
// What bounds it on this card. Counted by what the inputs need, the work is
// the tile bytes (n_tiles * B*B * 4 B read once, plus h and the output) at
// 3.35 TB/s: the sparse product itself is a few hundred MFLOP. But the
// dense-tile formulation does 2*B*B*F multiply-adds per tile whatever the
// tile's fill, and contracts in true float32 (FFMA, never TF32, which keeps
// only about three decimal digits). On the mention-graph operands the tiles
// are well under 1% full, so this kernel is bound by float32 FFMA issue
// (67 TFLOP/s peak), roughly ten times above its byte bound.
//
// What the design does about that, simply first. One CTA per (row block,
// 64-column chunk of F): the CTA walks its row block's run of tiles
// [row_ptr[r], row_ptr[r+1]), keeps the B x 64 accumulator in registers
// (an 8- or 4-row by 8-column micro-tile per thread), and writes its output
// block once — no atomics, no state carried between CTAs, and no dependence
// on the `first` flags beyond the run bounds. The inner loop is a classic
// shared-memory SGEMM: 32-column k-slices of the tile (stored transposed)
// and 32-row k-slices of h are staged in shared memory and read back as
// float4. Skipping all-zero k-slices, TMA loads and a tensor-core path are
// left for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;  // output columns per CTA
constexpr int kBK = 32;  // contraction depth per shared-memory stage
constexpr int kTN = 8;   // output columns per thread

template <int B>
__global__ void __launch_bounds__(kThreads)
bsr_flat_kernel(const float* __restrict__ tiles,
                const int* __restrict__ colblk,
                const int* __restrict__ row_ptr,
                const float* __restrict__ h,
                float* __restrict__ out,
                int f_pad) {
  constexpr int kTM = B / 32;     // output rows per thread (32 row groups)
  constexpr int kAP = B + 4;      // pitch of the transposed tile slice
  __shared__ __align__(16) float As[kBK][kAP];
  __shared__ __align__(16) float Hs[kBK][kBN];

  const int rb = blockIdx.x;
  const int f0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);  // column group, 0..7
  const int ty = tid / (kBN / kTN);  // row group, 0..31

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  const int start = row_ptr[rb];
  const int end = row_ptr[rb + 1];
  for (int t = start; t < end; ++t) {
    const float* tile = tiles + static_cast<size_t>(t) * B * B;
    const float* hb = h + static_cast<size_t>(colblk[t]) * B * f_pad + f0;
    for (int k0 = 0; k0 < B; k0 += kBK) {
      // tile[:, k0:k0+32] -> As[k][row]   (B*32/4 float4 loads)
#pragma unroll
      for (int i = 0; i < B * kBK / 4 / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / (kBK / 4);
        const int q = idx % (kBK / 4);
        const float4 v =
            *reinterpret_cast<const float4*>(tile + static_cast<size_t>(r) * B + k0 + 4 * q);
        As[4 * q + 0][r] = v.x;
        As[4 * q + 1][r] = v.y;
        As[4 * q + 2][r] = v.z;
        As[4 * q + 3][r] = v.w;
      }
      // h[k0:k0+32, f0:f0+64] -> Hs   (512 float4 loads)
#pragma unroll
      for (int i = 0; i < kBK * kBN / 4 / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / (kBN / 4);
        const int q = idx % (kBN / 4);
        *reinterpret_cast<float4*>(&Hs[r][4 * q]) =
            *reinterpret_cast<const float4*>(hb + static_cast<size_t>(k0 + r) * f_pad + 4 * q);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float a[kTM];
        float b[kTN];
#pragma unroll
        for (int i = 0; i < kTM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(&As[k][ty * kTM + i]);
          a[i + 0] = v.x;
          a[i + 1] = v.y;
          a[i + 2] = v.z;
          a[i + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < kTN; j += 4) {
          const float4 v = *reinterpret_cast<const float4*>(&Hs[k][tx * kTN + j]);
          b[j + 0] = v.x;
          b[j + 1] = v.y;
          b[j + 2] = v.z;
          b[j + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float* ob = out + (static_cast<size_t>(rb) * B + ty * kTM) * f_pad + f0 + tx * kTN;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; j += 4) {
      *reinterpret_cast<float4*>(ob + static_cast<size_t>(i) * f_pad + j) =
          make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
    }
  }
}

}  // namespace

// C entry: out[n_row_blocks*block, f_pad] = flat-tile BSR(tiles) @ h.
// Returns the launch's cudaGetLastError() as an int (0 = launched).
extern "C" int bsr_flat_matmul_f32(const float* tiles, const int* colblk, const int* row_ptr,
                                   const float* h, float* out, int n_row_blocks, int block,
                                   int f_pad, void* stream) {
  if (n_row_blocks <= 0 || f_pad <= 0 || f_pad % kBN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_row_blocks, f_pad / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block == 256) {
    bsr_flat_kernel<256><<<grid, kThreads, 0, s>>>(tiles, colblk, row_ptr, h, out, f_pad);
  } else if (block == 128) {
    bsr_flat_kernel<128><<<grid, kThreads, 0, s>>>(tiles, colblk, row_ptr, h, out, f_pad);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
