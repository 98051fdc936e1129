// Block-sparse × dense products for Hopper (sm_90a): the flat-tile BSR
// (kernel 1) and the padded-list BSR (kernel 2), as one packed-row gather
// kernel, with a float32 or a bfloat16 contraction and h in float32 or
// bfloat16.
//
// Replaces graphconvgeo_tpu/ops/spmm_pallas.py :: _bsr_flat_matmul (line 171,
// the Pallas kernel _flat_kernel) and :: _bsr_matmul (line 58, the Pallas
// kernel _kernel). Both compute out = BSR(tiles) @ h: for every output row
// block r, the sum over r's slots s of tiles[tile(s)] @ h[col(s)*B : +B, :].
// The TPU kernels multiply whole dense B x B tiles because the TPU has no fast
// gather and its matrix unit wants dense 128 x 128 blocks. Both take an
// mxu_dtype: float32 (Precision.HIGHEST, true float32) or bfloat16, where the
// MXU rounds the tile and the h block to bf16 and sums the products in
// float32 (the factorized adjacency's tiles run so whenever its gathers are
// bf16).
//
// Here the operand reaches the kernel in its packed form (PackedRows in
// graphconvgeo_torch/sparse/formats.py): the tiles' nonzeros in rows,
// row_ptr / col / val, built once per operand on the device from the tiles
// and the index map (flat runs for BsrFlat, padded per-row-block lists for
// BsrMatrix). Within a row the entries are in slot order, then by column
// inside the tile, the order in which the dense product adds them; padding
// slots and zero filler tiles give no entries. So both products are this one
// kernel on their own packed arrays and cannot drift apart.
//
// The bf16 contraction. Each val and each gathered element of h is rounded
// to bf16 with round-to-nearest-even (__float2bfloat16_rn, what XLA's convert
// does), then multiplied and summed with float32 FMA. A product of two bf16
// values is exact in float32 (8 + 8 significant bits), so every term equals
// the MXU's; only the order of the float32 sum differs. An h given in bf16
// is exact already and is only widened. The output is float32 either way.
//
// What bounds it on this card. At the GeoText-scale operand the tiles are
// 0.23% full: the dense-tile formulation did ~550x the multiply-adds the
// nonzeros need and read 360 MB of tiles, and no skipping of all-zero blocks
// helps, because the nonzeros are spread evenly over nearly every tile.
// Counted by what the data needs, the product moves the nonzeros (8 bytes
// each: an int32 column and a float32 value), each distinct row of h once
// (4 bytes a column in float32, 2 in bf16) and the float32 output once
// (about 7 us at 3.35 TB/s at GeoText's F 300). This design reads each
// nonzero once but gathers one row of h per nonzero: nnz * F * 4 bytes (251
// MB at F 300; half that from a bf16 h). h (12 MB at F 300) fits in the
// 50 MB L2, so most of those gathers can be served from it. So it is bound
// by the gathers of h's rows, and at this size (one warp per row, ~1.15
// waves of 8-warp blocks) by the latency of those gathers and of the launch.
// F is padded only to a multiple of 4, so no gather reads padding columns.
//
// What the design does about it. One warp per output row, 8 warps a block.
// The 32 lanes cover 128 columns a pass, 4 a lane (one 16-byte load from a
// float32 h, one 8-byte load from a bf16 h), and a block column covers up
// to 4 passes (F up to 512; wider F takes more block columns), so a lane
// keeps its columns' sums in registers and writes its output row exactly
// once, with no atomics and no state shared between warps; a row with no
// entries (an empty row block, a padded row past n_rows) is written as zeros.
// The warp loads up to 32 (col, val) pairs coalesced, broadcasts each with
// __shfl_sync, and issues the row gathers of 4 nonzeros before their
// multiply-adds, so 4 x passes loads per lane are in flight; a row longer
// than 32 entries loops over batches. The float32 contraction is true
// float32 FFMA (never TF32), summed in the entry order above. Rows longer
// than a few hundred entries would leave one warp trailing; the factorized
// operands' longest rows hold 39-43 entries, GeoText's 59.
//
// One difference from the dense-tile product: it is the same function
// BSR(tiles) @ h, but where h holds a non-finite value the dense product
// spreads 0 * Inf = NaN over every row of a row block whose tiles touch that
// column block, while this kernel multiplies nonzeros only and gives the
// sparse answer (as the JAX package's spmm_oracle and ell backends and
// torch.sparse.mm do). Training inputs are finite.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPass = 128;     // columns a warp covers in one pass: 32 lanes x 4
constexpr int kMaxPasses = 4;  // passes a lane holds in registers
constexpr int kUnroll = 4;     // nonzeros whose row gathers are in flight together
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void fma4(float4& acc, float v, const float4& x) {
  acc.x = fmaf(v, x.x, acc.x);
  acc.y = fmaf(v, x.y, acc.y);
  acc.z = fmaf(v, x.z, acc.z);
  acc.w = fmaf(v, x.w, acc.w);
}

// Four consecutive columns of h, widened to float32 and, for a bf16
// contraction of a float32 h, rounded to bf16.
template <typename T, bool kBf16>
__device__ __forceinline__ float4 load4(const T* p);

template <>
__device__ __forceinline__ float4 load4<float, false>(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <>
__device__ __forceinline__ float4 load4<float, true>(const float* p) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(round_bf16(x.x), round_bf16(x.y), round_bf16(x.z), round_bf16(x.w));
}

__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p) {
  // a bf16 is the top half of a float32: little-endian, element 0 is low
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16, false>(const __nv_bfloat16* p) {
  return widen4(p);
}

template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16, true>(const __nv_bfloat16* p) {
  return widen4(p);
}

template <int NP, typename T, bool kBf16>
__device__ __forceinline__ void gather(const T* __restrict__ h, int c, int f_pad, int c0,
                                       const bool (&on)[NP], float4 (&x)[NP]) {
  const T* hr = h + static_cast<size_t>(c) * f_pad + c0;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    x[p] = on[p] ? load4<T, kBf16>(hr + p * kPass) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

template <int NP, typename T, bool kBf16>
__global__ void __launch_bounds__(kThreads)
packed_row_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                  const float* __restrict__ val, const T* __restrict__ h,
                  float* __restrict__ out, int n_rows, int f_pad) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp shares its row
  const int c0 = blockIdx.y * (NP * kPass) + 4 * lane;
  bool on[NP];
  float4 acc[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    on[p] = c0 + p * kPass < f_pad;
    acc[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const int begin = row_ptr[row];
  const int end = row_ptr[row + 1];
  for (int base = begin; base < end; base += 32) {
    const int n = min(32, end - base);
    int my_col = 0;
    float my_val = 0.0f;
    if (lane < n) {
      my_col = __ldg(col + base + lane);
      my_val = __ldg(val + base + lane);
      if (kBf16) my_val = round_bf16(my_val);
    }
    int k = 0;
    for (; k + kUnroll <= n; k += kUnroll) {
      float v[kUnroll];
      float4 x[kUnroll][NP];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = __shfl_sync(kFull, my_val, k + u);
        gather<NP, T, kBf16>(h, __shfl_sync(kFull, my_col, k + u), f_pad, c0, on, x[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int p = 0; p < NP; ++p) fma4(acc[p], v[u], x[u][p]);
      }
    }
    for (; k < n; ++k) {
      const float v = __shfl_sync(kFull, my_val, k);
      float4 x[NP];
      gather<NP, T, kBf16>(h, __shfl_sync(kFull, my_col, k), f_pad, c0, on, x);
#pragma unroll
      for (int p = 0; p < NP; ++p) fma4(acc[p], v, x[p]);
    }
  }
  float* o = out + static_cast<size_t>(row) * f_pad + c0;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    if (on[p]) *reinterpret_cast<float4*>(o + p * kPass) = acc[p];
  }
}

template <typename T, bool kBf16>
void launch(const int* row_ptr, const int* col, const float* val, const void* h_raw, float* out,
            int n_rows, int f_pad, cudaStream_t s) {
  const T* h = static_cast<const T*>(h_raw);
  const int passes = (f_pad + kPass - 1) / kPass;
  const int np = passes < kMaxPasses ? passes : kMaxPasses;
  const dim3 grid((n_rows + kWarps - 1) / kWarps, (f_pad + np * kPass - 1) / (np * kPass));
  switch (np) {
    case 1:
      packed_row_kernel<1, T, kBf16><<<grid, kThreads, 0, s>>>(row_ptr, col, val, h, out, n_rows, f_pad);
      break;
    case 2:
      packed_row_kernel<2, T, kBf16><<<grid, kThreads, 0, s>>>(row_ptr, col, val, h, out, n_rows, f_pad);
      break;
    case 3:
      packed_row_kernel<3, T, kBf16><<<grid, kThreads, 0, s>>>(row_ptr, col, val, h, out, n_rows, f_pad);
      break;
    default:
      packed_row_kernel<4, T, kBf16><<<grid, kThreads, 0, s>>>(row_ptr, col, val, h, out, n_rows, f_pad);
      break;
  }
}

}  // namespace

// C entry: out[n_rows_padded, f_pad] (float32) = BSR @ h from the operand's
// packed rows (row_ptr [n_rows_padded + 1], col and val [nnz]), for the
// flat-tile and the padded-list operand alike. h is [*, f_pad] float32
// (h_bf16 = 0) or bfloat16 (h_bf16 = 1); contract_bf16 = 1 rounds val and h
// to bf16 before the float32 FMA. Returns the launch's cudaGetLastError() as
// an int (0 = launched).
extern "C" int bsr_packed_matmul(const int* row_ptr, const int* col, const float* val,
                                 const void* h, float* out, int n_rows_padded, int f_pad,
                                 int h_bf16, int contract_bf16, void* stream) {
  if (n_rows_padded <= 0 || f_pad <= 0 || f_pad % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_bf16) {
    if (contract_bf16) {
      launch<__nv_bfloat16, true>(row_ptr, col, val, h, out, n_rows_padded, f_pad, s);
    } else {
      launch<__nv_bfloat16, false>(row_ptr, col, val, h, out, n_rows_padded, f_pad, s);
    }
  } else if (contract_bf16) {
    launch<float, true>(row_ptr, col, val, h, out, n_rows_padded, f_pad, s);
  } else {
    launch<float, false>(row_ptr, col, val, h, out, n_rows_padded, f_pad, s);
  }
  return static_cast<int>(cudaGetLastError());
}
