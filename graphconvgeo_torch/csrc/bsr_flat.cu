// Block-sparse × dense products for Hopper (sm_90a), float32: the flat-tile
// BSR (kernel 1) and the padded-list BSR (kernel 2), one shared body.
//
// Replaces graphconvgeo_tpu/ops/spmm_pallas.py :: _bsr_flat_matmul (the
// Pallas kernel _flat_kernel) and :: _bsr_matmul (the Pallas kernel
// _kernel). Both compute, for every output row block r,
//     out[r*B : +B, :] = sum over r's slots s of tiles[tile(s)] @ h[col(s)*B : +B, :]
// and write every output row block exactly once; a row block with no tile
// (or only padding slots, which point at the all-zero tile 0) is written as
// zeros. The two differ only in where a row block's slots lie and how a
// slot names its tile and column block — the index map, a template
// parameter of the one body, so the two products cannot drift apart:
//   FlatRuns     (BsrFlat)   r's slots are tiles [row_ptr[r], row_ptr[r+1]),
//                            sorted by (row block, column block); column
//                            block colblk[s].
//   PaddedLists  (BsrMatrix) r's slots are [r*k_max, (r+1)*k_max) of the
//                            padded lists; tile tile_idx[s], column block
//                            tile_col[s]. All k_max slots are walked, padding
//                            included, as the Pallas grid does.
//
// What bounds it on this card. Counted by what the inputs need, the work is
// the nonzeros' bytes plus h and the output at 3.35 TB/s: the sparse
// product itself is a few hundred MFLOP. But the dense-tile formulation
// does 2*B*B*F multiply-adds per slot whatever the tile's fill, and
// contracts in true float32 (FFMA, never TF32, which keeps only about three
// decimal digits). On the mention-graph operands the tiles are well under
// 1% full, so these kernels are bound by the float32 FFMA rate (67 TFLOP/s
// peak), two orders of magnitude above their byte bound.
//
// What the design does about that, simply first. One CTA per (row block,
// 64-column chunk of F): the CTA walks its row block's slots, keeps the
// B x 64 accumulator in registers (an 8- or 4-row by 8-column micro-tile per
// thread), and writes its output block once — no atomics, no state carried
// between CTAs. The inner loop is a classic shared-memory SGEMM: 32-column
// k-slices of the tile (stored transposed) and 32-row k-slices of h are
// staged in shared memory and read back as float4. Skipping padding slots
// and all-zero k-slices, TMA loads and a tensor-core path are left for a
// later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;  // output columns per CTA
constexpr int kBK = 32;  // contraction depth per shared-memory stage
constexpr int kTN = 8;   // output columns per thread

struct FlatRuns {
  const int* colblk;
  const int* row_ptr;
  __device__ int begin(int rb) const { return row_ptr[rb]; }
  __device__ int end(int rb) const { return row_ptr[rb + 1]; }
  __device__ int tile(int s) const { return s; }
  __device__ int col(int s) const { return colblk[s]; }
};

struct PaddedLists {
  const int* tile_idx;
  const int* tile_col;
  int k_max;
  __device__ int begin(int rb) const { return rb * k_max; }
  __device__ int end(int rb) const { return (rb + 1) * k_max; }
  __device__ int tile(int s) const { return tile_idx[s]; }
  __device__ int col(int s) const { return tile_col[s]; }
};

template <int B, class Map>
__global__ void __launch_bounds__(kThreads)
bsr_tile_kernel(const float* __restrict__ tiles,
                const Map map,
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

  const int start = map.begin(rb);
  const int end = map.end(rb);
  for (int s = start; s < end; ++s) {
    const float* tile = tiles + static_cast<size_t>(map.tile(s)) * B * B;
    const float* hb = h + static_cast<size_t>(map.col(s)) * B * f_pad + f0;
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

template <class Map>
int launch(const float* tiles, const Map& map, const float* h, float* out, int n_row_blocks,
           int block, int f_pad, void* stream) {
  if (n_row_blocks <= 0 || f_pad <= 0 || f_pad % kBN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_row_blocks, f_pad / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block == 256) {
    bsr_tile_kernel<256, Map><<<grid, kThreads, 0, s>>>(tiles, map, h, out, f_pad);
  } else if (block == 128) {
    bsr_tile_kernel<128, Map><<<grid, kThreads, 0, s>>>(tiles, map, h, out, f_pad);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry: out[n_row_blocks*block, f_pad] = flat-tile BSR(tiles) @ h.
// Returns the launch's cudaGetLastError() as an int (0 = launched).
extern "C" int bsr_flat_matmul_f32(const float* tiles, const int* colblk, const int* row_ptr,
                                   const float* h, float* out, int n_row_blocks, int block,
                                   int f_pad, void* stream) {
  return launch(tiles, FlatRuns{colblk, row_ptr}, h, out, n_row_blocks, block, f_pad, stream);
}

// C entry: out[n_row_blocks*block, f_pad] = padded-list BSR(tiles) @ h, with
// tile_idx / tile_col [n_row_blocks, k_max]. Returns cudaGetLastError().
extern "C" int bsr_matmul_f32(const float* tiles, const int* tile_idx, const int* tile_col,
                              const float* h, float* out, int n_row_blocks, int k_max, int block,
                              int f_pad, void* stream) {
  if (k_max <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(tiles, PaddedLists{tile_idx, tile_col, k_max}, h, out, n_row_blocks, block, f_pad,
                stream);
}
