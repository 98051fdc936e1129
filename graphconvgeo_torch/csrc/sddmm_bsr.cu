// Block-sparse SDDMM for Hopper (sm_90a), float32.
//
// Replaces graphconvgeo_tpu/ops/sddmm_pallas.py :: sddmm_bsr (the Pallas
// kernel _kernel). For every tile t >= 1 of a padded-list BSR pattern, with
// row block trow[t] and column block tcol[t],
//     S[t] = H1[trow[t]*B : +B, :] @ H2[tcol[t]*B : +B, :]^T      (B x B)
// in the pattern's tile layout [n_tiles + 1, B, B]; tile 0 (the pattern's
// zero padding tile) is written as zeros. Two functions, two kernels:
//
// * mask_pattern (sddmm_nz_kernel): only the pattern's nonzeros are scores,
//   every other entry of the layout is 0. What bounds it on this card:
//   bytes. The layout is written whole (4*B*B bytes a tile, 364.6 MB for the
//   GeoText pattern's 5,564 tiles of 128^2), while the scores need only
//   2*nnz*F flops and one row of h1 and one of h2 per nonzero (0.23% of the
//   entries there). The design: one CTA per tile writes its B x B zeros with
//   coalesced 16-byte evict-first stores (st.global.cs: the layout is a
//   write stream that L2 need not keep; plain stores measured 7% slower on
//   an H100, PERF.md), then its warps score the tile's nonzeros (the
//   pattern's TileEntries, indexed by tile), one warp per entry: the lanes
//   stride over F with float4 loads where F % 4 == 0 and h1, h2 are 16-byte
//   aligned (scalars otherwise), keep float32 FFMA partial sums, reduce them
//   with a shuffle tree and one lane stores the score. Each byte of the
//   layout is written once by the CTA that owns it; the scattered score
//   stores land on L2 lines that CTA has just written. Rows of h1 or h2
//   past the tensor's row count read as zero (the padding the JAX package
//   applies), so h1 and h2 are read in place, unpadded.
//   One stated difference from the dense route: where h holds Inf or NaN,
//   the dense product multiplies a non-finite score off the pattern by 0
//   and gives NaN there (as the JAX package does); this kernel writes an
//   exact 0 there. On finite inputs the two compute the same function.
//
// * every entry a score (sddmm_dense_kernel): 2*B*B*F flops a tile whatever
//   its fill, bound by the float32 FFMA rate (67 TFLOP/s peak, true float32:
//   TF32 would keep about three decimal digits). One CTA per (tile, 64x64
//   block of the B x B output): the CTA stages 32-deep k-slices of its 64
//   rows of h1 and 64 rows of h2 (both row-major [rows, F], an "NT"
//   product) in shared memory, transposed, and keeps a 4x4 register
//   micro-tile per thread; it reads h1 and h2 padded to the tile grid's rows
//   and a multiple of 32 columns. No atomics, no state between CTAs.

#include <cuda_runtime.h>

namespace {

// ---- mask_pattern: the nonzeros' scores in a zeroed tile layout ----------
constexpr int kNzThreads = 256;
constexpr int kNzWarps = kNzThreads / 32;

template <int B>
__global__ void __launch_bounds__(kNzThreads)
sddmm_nz_kernel(const float* __restrict__ h1,
                const float* __restrict__ h2,
                const int* __restrict__ tile_ptr,
                const int* __restrict__ pos,
                const int* __restrict__ trow,
                const int* __restrict__ tcol,
                float* __restrict__ out,
                int f,
                int n1,
                int n2,
                int vec4) {
  __shared__ int sp[kNzThreads];
  const int t = blockIdx.x;
  float* tile = out + static_cast<size_t>(t) * B * B;
  float4* tile4 = reinterpret_cast<float4*>(tile);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < B * B / 4 / kNzThreads; ++k) __stcs(tile4 + threadIdx.x + k * kNzThreads, zero);
  const int e0 = tile_ptr[t];
  const int e1 = tile_ptr[t + 1];
  // the zeros are written before any score: other threads store both
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r1_base = static_cast<long long>(trow[t]) * B;
  const long long r2_base = static_cast<long long>(tcol[t]) * B;
  for (int c0 = e0; c0 < e1; c0 += kNzThreads) {  // uniform across the CTA
    const int n = min(kNzThreads, e1 - c0);
    if (threadIdx.x < n) sp[threadIdx.x] = pos[c0 + threadIdx.x];
    __syncthreads();
    for (int k = warp; k < n; k += kNzWarps) {  // uniform across the warp
      const int p = sp[k];
      const long long r1 = r1_base + p / B;
      const long long r2 = r2_base + p % B;
      float s = 0.f;
      if (r1 < n1 && r2 < n2) {
        const float* a = h1 + r1 * f;
        const float* c = h2 + r2 * f;
        if (vec4) {
          const float4* a4 = reinterpret_cast<const float4*>(a);
          const float4* c4 = reinterpret_cast<const float4*>(c);
          for (int v = lane; v < f / 4; v += 32) {
            const float4 x = __ldg(a4 + v);
            const float4 y = __ldg(c4 + v);
            s = fmaf(x.x, y.x, s);
            s = fmaf(x.y, y.y, s);
            s = fmaf(x.z, y.z, s);
            s = fmaf(x.w, y.w, s);
          }
        } else {
          for (int v = lane; v < f; v += 32) s = fmaf(__ldg(a + v), __ldg(c + v), s);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) tile[p] = s;
    }
    __syncthreads();  // sp is refilled by the next chunk
  }
}

// ---- every entry a score: the dense-tile NT product ----------------------
constexpr int kThreads = 256;
constexpr int kBS = 64;      // output rows and columns per CTA
constexpr int kBK = 32;      // contraction depth per shared-memory stage
constexpr int kTS = 4;       // output rows and columns per thread
constexpr int kP = kBS + 4;  // pitch of a transposed k-slice

template <int B>
__global__ void __launch_bounds__(kThreads)
sddmm_dense_kernel(const float* __restrict__ h1,
                   const float* __restrict__ h2,
                   const int* __restrict__ trow,
                   const int* __restrict__ tcol,
                   float* __restrict__ out,
                   int f_pad) {
  constexpr int kSub = B / kBS;
  __shared__ __align__(16) float As[kBK][kP];
  __shared__ __align__(16) float Bs[kBK][kP];

  const int t = blockIdx.x;
  const int i0 = (blockIdx.y / kSub) * kBS;
  const int j0 = (blockIdx.y % kSub) * kBS;
  const int tid = threadIdx.x;
  const int tx = tid % (kBS / kTS);  // column group, 0..15
  const int ty = tid / (kBS / kTS);  // row group, 0..15
  float* ob = out + static_cast<size_t>(t) * B * B + static_cast<size_t>(i0 + ty * kTS) * B +
              j0 + tx * kTS;

  if (t == 0) {  // the zero padding tile (uniform across the CTA)
#pragma unroll
    for (int i = 0; i < kTS; ++i)
      *reinterpret_cast<float4*>(ob + static_cast<size_t>(i) * B) = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }

  const float* a = h1 + (static_cast<size_t>(trow[t]) * B + i0) * f_pad;
  const float* b = h2 + (static_cast<size_t>(tcol[t]) * B + j0) * f_pad;
  float acc[kTS][kTS];
#pragma unroll
  for (int i = 0; i < kTS; ++i)
#pragma unroll
    for (int j = 0; j < kTS; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < f_pad; k0 += kBK) {
    // rows [0, 64) x columns [k0, k0+32) of each operand -> [k][row]
#pragma unroll
    for (int i = 0; i < kBS * kBK / 4 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kBK / 4);
      const int q = idx % (kBK / 4);
      const size_t off = static_cast<size_t>(r) * f_pad + k0 + 4 * q;
      const float4 va = *reinterpret_cast<const float4*>(a + off);
      const float4 vb = *reinterpret_cast<const float4*>(b + off);
      As[4 * q + 0][r] = va.x;
      As[4 * q + 1][r] = va.y;
      As[4 * q + 2][r] = va.z;
      As[4 * q + 3][r] = va.w;
      Bs[4 * q + 0][r] = vb.x;
      Bs[4 * q + 1][r] = vb.y;
      Bs[4 * q + 2][r] = vb.z;
      Bs[4 * q + 3][r] = vb.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 va = *reinterpret_cast<const float4*>(&As[k][ty * kTS]);
      const float4 vb = *reinterpret_cast<const float4*>(&Bs[k][tx * kTS]);
      const float av[kTS] = {va.x, va.y, va.z, va.w};
      const float bv[kTS] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int i = 0; i < kTS; ++i)
#pragma unroll
        for (int j = 0; j < kTS; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTS; ++i)
    *reinterpret_cast<float4*>(ob + static_cast<size_t>(i) * B) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

}  // namespace

// C entry, mask_pattern: out[n_tiles, block, block] (tile 0 included) zero
// but at each tile's entries pos[tile_ptr[t] : tile_ptr[t+1]], which get
// <h1[trow[t]*block + i], h2[tcol[t]*block + j]> over f columns (rows at or
// past n1 / n2 read as zero). h1 [n1, f] and h2 [n2, f] row-major.
// Returns the launch's cudaGetLastError() as an int.
extern "C" int sddmm_bsr_nz_f32(const float* h1, const float* h2, const int* tile_ptr,
                                const int* pos, const int* trow, const int* tcol, float* out,
                                int n_tiles, int block, int f, int n1, int n2, void* stream) {
  if (n_tiles <= 0 || f <= 0 || n1 < 0 || n2 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec4 = f % 4 == 0 && reinterpret_cast<size_t>(h1) % 16 == 0 &&
                   reinterpret_cast<size_t>(h2) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block != 128 && block != 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = block == 256 ? sddmm_nz_kernel<256> : sddmm_nz_kernel<128>;
  kernel<<<n_tiles, kNzThreads, 0, s>>>(h1, h2, tile_ptr, pos, trow, tcol, out, f, n1, n2, vec4);
  return static_cast<int>(cudaGetLastError());
}

// C entry, every entry a score: out[n_tiles, block, block] (tile 0 zero) =
// per-tile h1[trow[t]] @ h2[tcol[t]]^T over f_pad columns, h1 and h2 padded
// to the tile grid's rows. Returns the launch's cudaGetLastError() as an int.
extern "C" int sddmm_bsr_dense_f32(const float* h1, const float* h2, const int* trow,
                                   const int* tcol, float* out, int n_tiles, int block, int f_pad,
                                   void* stream) {
  if (n_tiles <= 0 || f_pad <= 0 || f_pad % kBK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block == 256) {
    const dim3 grid(n_tiles, (256 / kBS) * (256 / kBS));
    sddmm_dense_kernel<256><<<grid, kThreads, 0, s>>>(h1, h2, trow, tcol, out, f_pad);
  } else if (block == 128) {
    const dim3 grid(n_tiles, (128 / kBS) * (128 / kBS));
    sddmm_dense_kernel<128><<<grid, kThreads, 0, s>>>(h1, h2, trow, tcol, out, f_pad);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
