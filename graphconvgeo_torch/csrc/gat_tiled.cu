// GAT attention over a TiledAttentionPattern for Hopper (sm_90a), float32:
// the three sweeps of one attention layer over an edge list of the pattern
// (its tiled edges, or every edge: the layer's float32 path walks the tiled
// and the bucketed rest's edges in one sweep), each with float32 or
// bf16-operand contractions (BF16 below).
//
// Notation: H heads, f the head width, Fp = f padded to a multiple of 128.
// s [Npad,H], d [Mpad,H], z [Mpad,H,Fp], g [Npad,H,Fp]. The score of edge
// (i, j) in head h is LeakyReLU(s_i + d_j). Attention dropout keeps an
// entry iff wang(eid ^ wang(seed)) >> 1 >= thr, with the uint32-wrapped id
// eid = (row * n_cols + col + head * head_stride), and scales it by
// 1 / (1 - rate): bit-equal to graphconvgeo_torch/ops/dropout.py :: entry_keep.
//
// gat_tile_fwd replaces graphconvgeo_tpu/ops/attention_tiled.py ::
//   _tile_fwd_fused (kernel _fwd_fused_kernel): per row i, m_i = the max of
//   its listed edges' scores (kNeg = -1e30 if none), den_i = sum_j e_ij with
//   e = exp(sc - m_i), and o_i = sum_j kf_ij e_ij z_j.
// gat_tile_bwd_row replaces _tile_bwd_row (kernel _bwd_row_kernel): ds_i =
//   sum_j alpha (kf * (g_i . z_j) - c_i) * leaky'(raw) over row i's listed
//   edges, alpha = exp(sc - m) / den under the row's m and den.
// gat_tile_bwd_col replaces _tile_bwd_col (kernel _bwd_col_kernel): per
//   column j, dz_j = sum_i (kf*alpha)_ij g_i and dd_j = sum_i draw_ij.
//
// The TPU kernels multiply dense 128 x 128 mask tiles (e @ z, g @ z^T,
// (kf*alpha)^T @ g), because the TPU's matrix unit wants dense blocks and
// the TPU has no fast gather. On the card that is the wrong trade: the tiles
// are 1-3% full (GeoText 0.98%, the 32k operand 2.5%), so the dense products
// do 40-100x the work the edges need, and at the FFMA peak (67 TFLOP/s; never
// TF32, which keeps about three decimal digits) they bound the sweep.
//
// So all three kernels walk edge lists instead (TileEdges in
// graphconvgeo_torch/sparse/attention_tiles.py, built once per pattern: by
// row for the forward and ds sweeps, by column for dz/dd; edges / edges_t
// hold the tiled edges, all_edges / all_edges_t every edge of the pattern).
// Counted by what the data needs they move z (or g) rows once per edge and
// head, the [N,H] vectors and their outputs once: bound by the gathers of
// 16-byte rows and their latency, not by arithmetic. One warp per (row or
// column, head), 8 warps a block; the 32 lanes cover 128 columns of the head
// a pass in float4, up to 4 passes (f up to 512) held in registers, and
// gather only the head's f real columns (ceil(f/4) float4s; Fp's padding is
// zero, so the last float4 may read past f). Every output row is written
// once, with no atomics; columns past f are written as 0, and a row or
// column with no listed edge writes the neutral values (o = den = ds = 0,
// m = kNeg; dz = dd = 0). Only real edges are walked, so no masked slot's
// score can overflow the exp (the TPU kernels mask before the exp for that).
//   Forward: pass 1, 32 edges at a time, one a lane: scores and a shuffle
//   max; pass 2 recomputes each lane's e (den takes it undropped, then the
//   keep factor), broadcasts it with __shfl_sync and issues the z gathers of
//   4 edges before their FFMAs, as packed_row_kernel (csrc/bsr_flat.cu) does.
//   Row backward (ds): the warp keeps g_i and the row's s_i, m_i, den_i, c_i
//   in registers; per batch of 32 edges each lane forms its own edge's
//   alpha, kf and leaky'(raw) from the gathered d_j; then 4 edges at a time
//   it gathers z_j and reduces the 4 dot products g_i . z_j in one
//   interleaved shuffle tree, each lane keeping its own edge's; each lane
//   adds its edge's draw, and one warp sum gives ds_i.
//   Column backward: the warp keeps z_j and d_j in registers; per batch of
//   32 edges each lane forms its own edge's alpha, kf and leaky'(raw) from
//   the gathered s_i, m_i, den_i, c_i; then 4 edges at a time it gathers g_i,
//   adds kf*alpha*g_i into dz and reduces the 4 dot products g_i . z_j in
//   one interleaved shuffle tree; dd takes each lane's draw.
// The bf16-operand variant (template flag BF16; contract_bf16 = 1 in the C
// entries) replaces the same three TPU kernels called with
// mxu_precision=Precision.DEFAULT, where each tile product is one bf16 MXU
// pass: both operands rounded to bf16, the products summed in float32. Here
// the operands of exactly those products are rounded to bf16 with
// round-to-nearest-even (__float2bfloat16_rn, as in csrc/bsr_flat.cu) before
// the float32 FMA: the forward's kf*e weight and the gathered z (den keeps
// the unrounded e); the ds sweep's g_i and the gathered z of g_i . z_j; the
// column sweep's kf*alpha weight, the gathered g and the held z_j. A product
// of two bf16 values is exact in float32, so each term equals the MXU's and
// only the order of the float32 sums differs. Everything else (the max, exp,
// den, keep hash, alpha, leaky' and the ds / dd sums) stays float32. The
// rounding adds a few conversions to each gathered float4 and moves no
// other byte, so the variant has the float32 kernels' bound.
// On finite inputs the edge kernels and the dense-tile products compute the
// same function. Where z (or g) holds Inf or NaN in a column off a row's
// edges, the dense products spread 0 * Inf = NaN (e @ z, g @ z^T,
// alpha^T g) and the edge kernels give the sparse answer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kCols = 128;  // the head width Fp is a multiple of this
constexpr float kNeg = -1e30f;

struct Drop {
  int on;                // attention dropout active
  unsigned seed_h;       // wang_hash(seed)
  unsigned thr;          // keep iff (hash >> 1) >= thr
  float scale;           // 1 / (1 - rate)
  unsigned n_cols;
  unsigned head_stride;  // n_rows * n_cols, wrapped
};

__host__ __device__ __forceinline__ unsigned wang_hash(unsigned x) {
  x = (x ^ 61u) ^ (x >> 16);
  x *= 9u;
  x ^= x >> 4;
  x *= 0x27D4EB2Du;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ float keep_factor(const Drop& dp, unsigned row, unsigned col,
                                             unsigned head) {
  const unsigned eid = row * dp.n_cols + col + head * dp.head_stride;
  return ((wang_hash(eid ^ dp.seed_h) >> 1) >= dp.thr) ? dp.scale : 0.0f;
}

__device__ __forceinline__ float leaky(float x, float slope) { return x >= 0.0f ? x : slope * x; }

// An operand of a contraction: rounded to bf16 (nearest-even) under BF16.
template <bool BF16>
__device__ __forceinline__ float operand(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

template <bool BF16>
__device__ __forceinline__ float4 operand4(float4 v) {
  return make_float4(operand<BF16>(v.x), operand<BF16>(v.y), operand<BF16>(v.z),
                     operand<BF16>(v.w));
}

// ---- the edge kernels ------------------------------------------------------
constexpr int kEdgeWarps = 8;
constexpr int kEdgeThreads = 32 * kEdgeWarps;
constexpr int kPass = 128;     // columns of a head a warp covers in one pass: 32 lanes x float4
constexpr int kMaxPasses = 4;  // passes a lane holds in registers: f up to 512
constexpr int kUnroll = 4;     // edges whose gathers are in flight together
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void fma4(float4& acc, float v, const float4& x) {
  acc.x = fmaf(v, x.x, acc.x);
  acc.y = fmaf(v, x.y, acc.y);
  acc.z = fmaf(v, x.z, acc.z);
  acc.w = fmaf(v, x.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// a float4 of columns c..c+3 with the columns at or past f set to 0
__device__ __forceinline__ float4 clip4(float4 v, int c, int f) {
  return make_float4(c < f ? v.x : 0.0f, c + 1 < f ? v.y : 0.0f, c + 2 < f ? v.z : 0.0f,
                     c + 3 < f ? v.w : 0.0f);
}

// The columns a lane covers in head h (f real columns, padded to fp): pass
// p holds c = p * kPass + 4 * lane, at hc = h * fp + c in a row of z or g.
template <int NP>
__device__ __forceinline__ void head_columns(int h, int fp, int f, int (&c)[NP], int (&hc)[NP],
                                             bool (&on)[NP]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    c[p] = p * kPass + 4 * lane;
    hc[p] = h * fp + c[p];
    on[p] = c[p] < f;
  }
}

// the float4s of row r at the columns hc, or zeros past the head's f columns,
// as contraction operands (rounded to bf16 under BF16)
template <int NP, bool BF16>
__device__ __forceinline__ void gather_head(const float* __restrict__ base, int r, size_t row_stride,
                                            const int (&hc)[NP], const bool (&on)[NP],
                                            float4 (&x)[NP]) {
  const float* p0 = base + static_cast<size_t>(r) * row_stride;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    x[p] = on[p] ? operand4<BF16>(__ldg(reinterpret_cast<const float4*>(p0 + hc[p])))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// One warp per (row, head h); NP = Fp / 128 passes of the head; BF16 rounds
// the operands of o += (kf*e) z_j. grid (ceil(n_rows / 8), H).
template <int NP, bool BF16>
__global__ void __launch_bounds__(kEdgeThreads)
gat_edge_fwd_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                    const float* __restrict__ s, const float* __restrict__ d,
                    const float* __restrict__ z, float* __restrict__ o,
                    float* __restrict__ den_out, float* __restrict__ m_out, int n_rows, int heads,
                    int fp, int f, float slope, Drop dp) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kEdgeWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp shares its row
  const int h = blockIdx.y;
  const size_t zrow = static_cast<size_t>(heads) * fp;
  int c[NP], hc[NP];
  bool on[NP];
  head_columns<NP>(h, fp, f, c, hc, on);
  const float s_i = s[static_cast<size_t>(row) * heads + h];
  const int begin = row_ptr[row], end = row_ptr[row + 1];

  // pass 1: the max score over the row's edges
  float mx = kNeg;
  for (int k = begin + lane; k < end; k += 32)
    mx = fmaxf(mx, leaky(s_i + __ldg(d + static_cast<size_t>(__ldg(col + k)) * heads + h), slope));
  mx = warp_max(mx);

  // pass 2: den (undropped) and o = sum kf * e * z_j
  float part = 0.0f;  // this lane's share of den
  float4 acc[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) acc[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int base = begin; base < end; base += 32) {
    const int n = min(32, end - base);
    int my_j = 0;
    float my_e = 0.0f;
    if (lane < n) {
      my_j = __ldg(col + base + lane);
      my_e = expf(leaky(s_i + __ldg(d + static_cast<size_t>(my_j) * heads + h), slope) - mx);
      part += my_e;
      if (dp.on) my_e *= keep_factor(dp, row, my_j, h);
      my_e = operand<BF16>(my_e);
    }
    int k = 0;
    for (; k + kUnroll <= n; k += kUnroll) {
      float w[kUnroll];
      float4 x[kUnroll][NP];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        w[u] = __shfl_sync(kFull, my_e, k + u);
        gather_head<NP, BF16>(z, __shfl_sync(kFull, my_j, k + u), zrow, hc, on, x[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int p = 0; p < NP; ++p) fma4(acc[p], w[u], x[u][p]);
    }
    for (; k < n; ++k) {
      const float w = __shfl_sync(kFull, my_e, k);
      float4 x[NP];
      gather_head<NP, BF16>(z, __shfl_sync(kFull, my_j, k), zrow, hc, on, x);
#pragma unroll
      for (int p = 0; p < NP; ++p) fma4(acc[p], w, x[p]);
    }
  }

  float* orow = o + static_cast<size_t>(row) * zrow;
#pragma unroll
  for (int p = 0; p < NP; ++p) *reinterpret_cast<float4*>(orow + hc[p]) = clip4(acc[p], c[p], f);
  const float den = warp_sum(part);
  if (lane == 0) {
    den_out[static_cast<size_t>(row) * heads + h] = den;
    m_out[static_cast<size_t>(row) * heads + h] = mx;
  }
}

// One warp per (row i, head h); NP = Fp / 128 passes of the head; BF16 rounds
// the operands of g_i . z_j. grid (ceil(n_rows / 8), H).
template <int NP, bool BF16>
__global__ void __launch_bounds__(kEdgeThreads)
gat_edge_bwd_row_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                        const float* __restrict__ s, const float* __restrict__ d,
                        const float* __restrict__ m, const float* __restrict__ den,
                        const float* __restrict__ c_in, const float* __restrict__ z,
                        const float* __restrict__ g, float* __restrict__ ds_out, int n_rows,
                        int heads, int fp, int f, float slope, Drop dp) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kEdgeWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp shares its row
  const int h = blockIdx.y;
  const size_t zrow = static_cast<size_t>(heads) * fp;
  int c[NP], hc[NP];
  bool on[NP];
  head_columns<NP>(h, fp, f, c, hc, on);
  float4 gi[NP];
  gather_head<NP, BF16>(g, row, zrow, hc, on, gi);
  const size_t ki = static_cast<size_t>(row) * heads + h;
  const float s_i = s[ki], m_i = m[ki], den_i = den[ki], c_i = c_in[ki];
  float dsp = 0.0f;  // this lane's share of ds_i

  const int begin = row_ptr[row], end = row_ptr[row + 1];
  for (int base = begin; base < end; base += 32) {
    const int n = min(32, end - base);
    // lane k < n: edge (row, j) = base + k; its alpha, kf, leaky'(raw)
    int my_j = 0;
    float my_a = 0.0f, my_kf = 1.0f, my_lg = 0.0f;
    if (lane < n) {
      my_j = __ldg(col + base + lane);
      const float raw = s_i + __ldg(d + static_cast<size_t>(my_j) * heads + h);
      my_a = expf(leaky(raw, slope) - m_i) / den_i;
      if (dp.on) my_kf = keep_factor(dp, row, my_j, h);
      my_lg = raw >= 0.0f ? 1.0f : slope;
    }
    float my_da = 0.0f;  // g_i . z_j of this lane's edge
    int k = 0;
    for (; k + kUnroll <= n; k += kUnroll) {
      float dot[kUnroll];
      float4 x[kUnroll][NP];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        gather_head<NP, BF16>(z, __shfl_sync(kFull, my_j, k + u), zrow, hc, on, x[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        dot[u] = 0.0f;
#pragma unroll
        for (int p = 0; p < NP; ++p) dot[u] += dot4(x[u][p], gi[p]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) dot[u] += __shfl_xor_sync(kFull, dot[u], off);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (lane == k + u) my_da = dot[u];
    }
    for (; k < n; ++k) {
      float4 x[NP];
      gather_head<NP, BF16>(z, __shfl_sync(kFull, my_j, k), zrow, hc, on, x);
      float dot = 0.0f;
#pragma unroll
      for (int p = 0; p < NP; ++p) dot += dot4(x[p], gi[p]);
      dot = warp_sum(dot);
      if (lane == k) my_da = dot;
    }
    if (lane < n) dsp += my_a * (my_kf * my_da - c_i) * my_lg;
  }

  const float ds = warp_sum(dsp);
  if (lane == 0) ds_out[ki] = ds;
}

// One warp per (column j, head h); NP = Fp / 128 passes of the head; BF16
// rounds the operands of dz_j += (kf*alpha) g_i and of g_i . z_j.
// grid (ceil(n_cols / 8), H).
template <int NP, bool BF16>
__global__ void __launch_bounds__(kEdgeThreads)
gat_edge_bwd_col_kernel(const int* __restrict__ col_ptr, const int* __restrict__ row_idx,
                        const float* __restrict__ s, const float* __restrict__ d,
                        const float* __restrict__ m, const float* __restrict__ den,
                        const float* __restrict__ c_in, const float* __restrict__ z,
                        const float* __restrict__ g, float* __restrict__ dz_out,
                        float* __restrict__ dd_out, int n_cols, int heads, int fp, int f,
                        float slope, Drop dp) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kEdgeWarps + (threadIdx.x >> 5);
  if (col >= n_cols) return;  // the whole warp shares its column
  const int h = blockIdx.y;
  const size_t zrow = static_cast<size_t>(heads) * fp;
  int c[NP], hc[NP];
  bool on[NP];
  head_columns<NP>(h, fp, f, c, hc, on);
  float4 zj[NP], acc[NP];
  gather_head<NP, BF16>(z, col, zrow, hc, on, zj);
#pragma unroll
  for (int p = 0; p < NP; ++p) acc[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float d_j = d[static_cast<size_t>(col) * heads + h];
  float ddp = 0.0f;  // this lane's share of dd_j

  const int begin = col_ptr[col], end = col_ptr[col + 1];
  for (int base = begin; base < end; base += 32) {
    const int n = min(32, end - base);
    // lane k < n: edge (i, col) = base + k; its alpha, kf, c_i, leaky'(raw)
    int my_i = 0;
    float my_a = 0.0f, my_kf = 1.0f, my_c = 0.0f, my_lg = 0.0f;
    if (lane < n) {
      my_i = __ldg(row_idx + base + lane);
      const size_t k = static_cast<size_t>(my_i) * heads + h;
      const float raw = __ldg(s + k) + d_j;
      my_a = expf(leaky(raw, slope) - __ldg(m + k)) / __ldg(den + k);
      if (dp.on) my_kf = keep_factor(dp, my_i, col, h);
      my_c = __ldg(c_in + k);
      my_lg = raw >= 0.0f ? 1.0f : slope;
    }
    const float my_w = operand<BF16>(my_kf * my_a);  // the edge's weight in dz
    float my_da = 0.0f;               // g_i . z_j of this lane's edge
    int k = 0;
    for (; k + kUnroll <= n; k += kUnroll) {
      float w[kUnroll], dot[kUnroll];
      float4 x[kUnroll][NP];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        w[u] = __shfl_sync(kFull, my_w, k + u);
        gather_head<NP, BF16>(g, __shfl_sync(kFull, my_i, k + u), zrow, hc, on, x[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        dot[u] = 0.0f;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          dot[u] += dot4(x[u][p], zj[p]);
          fma4(acc[p], w[u], x[u][p]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) dot[u] += __shfl_xor_sync(kFull, dot[u], off);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (lane == k + u) my_da = dot[u];
    }
    for (; k < n; ++k) {
      const float w = __shfl_sync(kFull, my_w, k);
      float4 x[NP];
      gather_head<NP, BF16>(g, __shfl_sync(kFull, my_i, k), zrow, hc, on, x);
      float dot = 0.0f;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        dot += dot4(x[p], zj[p]);
        fma4(acc[p], w, x[p]);
      }
      dot = warp_sum(dot);
      if (lane == k) my_da = dot;
    }
    if (lane < n) ddp += my_a * (my_kf * my_da - my_c) * my_lg;
  }

  float* dzrow = dz_out + static_cast<size_t>(col) * zrow;
#pragma unroll
  for (int p = 0; p < NP; ++p) *reinterpret_cast<float4*>(dzrow + hc[p]) = clip4(acc[p], c[p], f);
  const float dd = warp_sum(ddp);
  if (lane == 0) dd_out[static_cast<size_t>(col) * heads + h] = dd;
}

Drop make_drop(int dropout, unsigned seed, unsigned keep_thr, float keep_scale, unsigned n_cols,
               unsigned head_stride) {
  Drop dp;
  dp.on = dropout != 0;
  dp.seed_h = wang_hash(seed);
  dp.thr = keep_thr;
  dp.scale = keep_scale;
  dp.n_cols = n_cols;
  dp.head_stride = head_stride;
  return dp;
}

bool bad_shape(int n_blocks, int heads, int fp) {
  return n_blocks <= 0 || heads <= 0 || heads > 65535 || fp <= 0 || fp % kCols != 0;
}

// the kernels hold a head's Fp / 128 passes in registers and gather its f
// real columns
bool bad_edge_shape(int n, int heads, int fp, int f) {
  return bad_shape(n, heads, fp) || fp > kMaxPasses * kPass || f <= 0 || f > fp;
}

// launch(std::integral_constant<int, NP>, std::bool_constant<BF16>) for
// NP = np in [1, kMaxPasses] and BF16 = bf16 != 0
template <class Launch>
void with_variant(int np, int bf16, Launch launch) {
  auto passes = [&](auto bf) {
    switch (np) {
      case 1: launch(std::integral_constant<int, 1>{}, bf); break;
      case 2: launch(std::integral_constant<int, 2>{}, bf); break;
      case 3: launch(std::integral_constant<int, 3>{}, bf); break;
      default: launch(std::integral_constant<int, 4>{}, bf); break;
    }
  };
  if (bf16) {
    passes(std::true_type{});
  } else {
    passes(std::false_type{});
  }
}

}  // namespace

// C entries. Each launches on `stream` and returns cudaGetLastError() as an
// int (0 = launched); a refused launch never runs. contract_bf16 = 1 takes
// the bf16-operand variant.

// o [n_rows, H, Fp], den and m [n_rows, H] from an edge list by row
// (row_ptr [n_rows + 1], col [nnz]).
extern "C" int gat_tile_fwd_f32(const int* row_ptr, const int* col, const float* s, const float* d,
                                const float* z, float* o, float* den, float* m, int n_rows,
                                int heads, int fp, int f, int contract_bf16, float slope,
                                int dropout, unsigned seed, unsigned keep_thr, float keep_scale,
                                unsigned n_cols, unsigned head_stride, void* stream) {
  if (bad_edge_shape(n_rows, heads, fp, f)) return static_cast<int>(cudaErrorInvalidValue);
  const Drop dp = make_drop(dropout, seed, keep_thr, keep_scale, n_cols, head_stride);
  const dim3 grid((n_rows + kEdgeWarps - 1) / kEdgeWarps, heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_variant(fp / kPass, contract_bf16, [&](auto np, auto bf) {
    gat_edge_fwd_kernel<decltype(np)::value, decltype(bf)::value><<<grid, kEdgeThreads, 0, st>>>(
        row_ptr, col, s, d, z, o, den, m, n_rows, heads, fp, f, slope, dp);
  });
  return static_cast<int>(cudaGetLastError());
}

// ds [n_rows, H] from an edge list by row (row_ptr [n_rows + 1], col
// [nnz]), the same lists gat_tile_fwd_f32 reads.
extern "C" int gat_tile_bwd_row_f32(const int* row_ptr, const int* col, const float* s,
                                    const float* d, const float* m, const float* den,
                                    const float* c, const float* z, const float* g, float* ds,
                                    int n_rows_padded, int heads, int fp, int f,
                                    int contract_bf16, float slope, int dropout, unsigned seed,
                                    unsigned keep_thr, float keep_scale, unsigned n_cols,
                                    unsigned head_stride, void* stream) {
  if (bad_edge_shape(n_rows_padded, heads, fp, f)) return static_cast<int>(cudaErrorInvalidValue);
  const Drop dp = make_drop(dropout, seed, keep_thr, keep_scale, n_cols, head_stride);
  const dim3 grid((n_rows_padded + kEdgeWarps - 1) / kEdgeWarps, heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_variant(fp / kPass, contract_bf16, [&](auto np, auto bf) {
    gat_edge_bwd_row_kernel<decltype(np)::value, decltype(bf)::value><<<grid, kEdgeThreads, 0, st>>>(
        row_ptr, col, s, d, m, den, c, z, g, ds, n_rows_padded, heads, fp, f, slope, dp);
  });
  return static_cast<int>(cudaGetLastError());
}

// dz [n_cols, H, Fp] and dd [n_cols, H] from an edge list by column
// (col_ptr [n_cols + 1], row [nnz]).
extern "C" int gat_tile_bwd_col_f32(const int* col_ptr, const int* row, const float* s,
                                    const float* d, const float* m, const float* den,
                                    const float* c, const float* z, const float* g, float* dz,
                                    float* dd, int n_cols_padded, int heads, int fp, int f,
                                    int contract_bf16, float slope, int dropout, unsigned seed,
                                    unsigned keep_thr, float keep_scale, unsigned n_cols,
                                    unsigned head_stride, void* stream) {
  if (bad_edge_shape(n_cols_padded, heads, fp, f)) return static_cast<int>(cudaErrorInvalidValue);
  const Drop dp = make_drop(dropout, seed, keep_thr, keep_scale, n_cols, head_stride);
  const dim3 grid((n_cols_padded + kEdgeWarps - 1) / kEdgeWarps, heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_variant(fp / kPass, contract_bf16, [&](auto np, auto bf) {
    gat_edge_bwd_col_kernel<decltype(np)::value, decltype(bf)::value><<<grid, kEdgeThreads, 0, st>>>(
        col_ptr, row, s, d, m, den, c, z, g, dz, dd, n_cols_padded, heads, fp, f, slope, dp);
  });
  return static_cast<int>(cudaGetLastError());
}
