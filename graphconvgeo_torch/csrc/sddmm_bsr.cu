// Block-sparse SDDMM for Hopper (sm_90a), float32.
//
// Replaces graphconvgeo_tpu/ops/sddmm_pallas.py :: sddmm_bsr (the Pallas
// kernel _kernel). For every tile t >= 1 of a padded-list BSR pattern, with
// row block trow[t] and column block tcol[t],
//     S[t] = H1[trow[t]*B : +B, :] @ H2[tcol[t]*B : +B, :]^T      (B x B)
// contracted over the padded feature width; tile 0 (the pattern's zero
// padding tile) is written as zeros. With `mask` the scores are multiplied
// by (pattern tile != 0), as the JAX package multiplies by its boolean mask:
// a multiply, not a select, so a non-finite score off the pattern gives NaN
// there exactly as in JAX.
//
// What bounds it on this card. Counted by what the inputs need — h1 and h2
// read once, the pattern's nonzeros in and their scores out, 2*nnz*F flops —
// it is bound by bytes, a small fraction of a millisecond. But the dense-
// tile formulation computes and writes every entry of every tile: 2*B*B*F
// flops and B*B*4 bytes a tile whatever its fill. On the mention-graph
// patterns (tiles under 1% full) that makes it bound by the float32 FFMA rate
// (67 TFLOP/s peak, true float32: TF32 would keep about three decimal
// digits), with the dense score write (4*B*B bytes a tile) next.
//
// What the design does about that, simply first. One CTA per (tile, 64x64
// block of the B x B output): the CTA stages 32-deep k-slices of its 64 rows
// of h1 and 64 rows of h2 — both row-major [rows, F], an "NT" product — in
// shared memory, transposed, and keeps a 4x4 register micro-tile per
// thread; the epilogue applies the mask and writes float4s. No atomics, no
// state between CTAs. Skipping all-zero 64x64 blocks of the pattern and
// writing only the nonzeros' scores are left for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBS = 64;      // output rows and columns per CTA
constexpr int kBK = 32;      // contraction depth per shared-memory stage
constexpr int kTS = 4;       // output rows and columns per thread
constexpr int kP = kBS + 4;  // pitch of a transposed k-slice

template <int B>
__global__ void __launch_bounds__(kThreads)
sddmm_bsr_kernel(const float* __restrict__ h1,
                 const float* __restrict__ h2,
                 const int* __restrict__ trow,
                 const int* __restrict__ tcol,
                 const float* __restrict__ pattern,
                 float* __restrict__ out,
                 int f_pad,
                 int mask) {
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

  const float* pb = pattern + (ob - out);
#pragma unroll
  for (int i = 0; i < kTS; ++i) {
    float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (mask) {
      const float4 p = *reinterpret_cast<const float4*>(pb + static_cast<size_t>(i) * B);
      v.x *= p.x != 0.f ? 1.f : 0.f;
      v.y *= p.y != 0.f ? 1.f : 0.f;
      v.z *= p.z != 0.f ? 1.f : 0.f;
      v.w *= p.w != 0.f ? 1.f : 0.f;
    }
    *reinterpret_cast<float4*>(ob + static_cast<size_t>(i) * B) = v;
  }
}

}  // namespace

// C entry: out[n_tiles, block, block] (tile 0 included) = per-tile
// h1[trow[t]] @ h2[tcol[t]]^T over f_pad columns, times (pattern != 0) when
// mask is set. Returns the launch's cudaGetLastError() as an int.
extern "C" int sddmm_bsr_f32(const float* h1, const float* h2, const int* trow, const int* tcol,
                             const float* pattern, float* out, int n_tiles, int block, int f_pad,
                             int mask, void* stream) {
  if (n_tiles <= 0 || f_pad <= 0 || f_pad % kBK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block == 256) {
    const dim3 grid(n_tiles, (256 / kBS) * (256 / kBS));
    sddmm_bsr_kernel<256><<<grid, kThreads, 0, s>>>(h1, h2, trow, tcol, pattern, out, f_pad, mask);
  } else if (block == 128) {
    const dim3 grid(n_tiles, (128 / kBS) * (128 / kBS));
    sddmm_bsr_kernel<128><<<grid, kThreads, 0, s>>>(h1, h2, trow, tcol, pattern, out, f_pad, mask);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
