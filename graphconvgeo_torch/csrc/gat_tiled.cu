// GAT attention over a TiledAttentionPattern for Hopper (sm_90a), float32:
// the three sweeps of one attention layer over an edge list of the pattern
// (its tiled edges, or every edge: the layer walks the tiled and the bucketed
// rest's edges in one sweep), each with float32 or bf16-operand contractions
// (BF16 below), and the scores s, d they read.
//
// Notation: H heads of f columns. The wide operands are the model's own
// float32 [rows, H*f] arrays, read and written in place: z [M, H*f] (M >= the
// pattern's n_cols and n_rows), g and out [n_rows, H*f], dz [M, H*f]; head h
// is columns [h*f, h*f + f) of a row. a_src, a_dst [H, f] are read as one row
// of H*f. The narrow vectors are padded to the block rows: s, m, den, c, ds
// [Npad,H]; d, dd [Mpad,H]. The score of edge (i, j) in head h is
// LeakyReLU(s_i + d_j). Attention dropout keeps an entry iff
// wang(eid ^ wang(seed)) >> 1 >= thr, with the uint32-wrapped id
// eid = (row * n_cols + col + head * head_stride), and scales it by
// 1 / (1 - rate): bit-equal to graphconvgeo_torch/ops/dropout.py :: entry_keep.
//
// gat_tile_fwd replaces graphconvgeo_tpu/ops/attention_tiled.py ::
//   _tile_fwd_fused (kernel _fwd_fused_kernel) and the normalisation after
//   it: per row i, m_i = the max of its listed edges' scores, den_i = sum_j
//   e_ij with e = exp(sc - m_i), and out_i = sum_j kf_ij e_ij z_j / den_i; a
//   row with no listed edge gets m = 0, den = 1, out = 0.
// gat_tile_bwd_row replaces _tile_bwd_row (kernel _bwd_row_kernel) and the
//   einsum of c before it: c_i = <g_i, out_i> per head, then ds_i =
//   sum_j alpha (kf * (g_i . z_j) - c_i) * leaky'(raw) over row i's listed
//   edges, alpha = exp(sc - m) / den under the row's m and den.
// gat_tile_bwd_col replaces _tile_bwd_col (kernel _bwd_col_kernel) and the
//   chain through s and d after it: per column j, dd_j = sum_i draw_ij and
//   dz_j = sum_i (kf*alpha)_ij g_i + dd_j a_dst[h] + (j < n_rows ? ds_j
//   a_src[h] : 0).
// gat_scores replaces no TPU kernel: s = z[:n_rows] . a_src and d = z . a_dst
//   per head were two XLA einsums in the JAX package (_prep). It reads z once
//   and writes s and d: bound by those bytes (5.04 GB at Twitter-World, 1.5
//   ms at 3.35 TB/s). One warp per head and a grid-stride run of rows holds
//   the head's a_src and a_dst in registers and reduces both dot products in
//   one shuffle tree. The sweeps need every neighbour's d before they start,
//   so s and d cannot come from inside them.
//
// The TPU kernels multiply dense 128 x 128 mask tiles (e @ z, g @ z^T,
// (kf*alpha)^T @ g), because the TPU's matrix unit wants dense blocks and
// the TPU has no fast gather. On the card that is the wrong trade: the tiles
// are 1-3% full (GeoText 0.98%, the 32k operand 2.5%), so the dense products
// do 40-100x the work the edges need, and at the FFMA peak (67 TFLOP/s; never
// TF32, which keeps about three decimal digits) they bound the sweep.
//
// So all three sweeps walk edge lists instead (TileEdges in
// graphconvgeo_torch/sparse/attention_tiles.py, built once per pattern: by
// row for the forward and ds sweeps, by column for dz/dd; edges / edges_t
// hold the tiled edges, all_edges / all_edges_t every edge of the pattern).
// Counted by what the data needs they move z (or g) rows once per edge and
// head, the [N,H] vectors and their outputs once: bound by the gathers of
// 16-byte pieces and their latency, not by arithmetic. One warp per (row or
// column, head), 8 warps a block. A head starts at column h*f, which need not
// be 16-byte aligned, so a lane covers quartets of columns of the head's span
// (Span): where H*f is a multiple of 4 and the bases are 16-byte aligned
// (VEC, chosen by the C entries from the shape and the pointers), the aligned
// float4s that hold the head's columns, read as float4; otherwise quartets
// from h*f, read one float at a time. The rows a warp holds (g_i, z_j, a)
// have the neighbouring heads' columns cleared to 0 once; the rows gathered
// per edge are used as loaded: their neighbouring heads' columns meet those
// zeros in a dot product or land in accumulators that are never written.
// Clearing them per edge cost the backward sweeps 6-12 ms each at
// Twitter-World size on an H100 (the selects), and a select that waits on its
// load, placed before the next edge's load, doubled the forward's time there:
// the gathers of a group of edges are all issued before any is used. Up to 4
// passes of 32 lanes are held in registers: f up to 509 (the aligned span of
// f columns holds at most ceil((f + 3) / 4) = 128 float4s). Every output row is written once, with no atomics; an output
// quartet that holds a neighbouring head's columns is written column by
// column, so no two warps write one float4. Only real edges are walked, so
// no masked slot's score can overflow the exp (the TPU kernels mask before
// the exp for that).
//   Forward: pass 1, 32 edges at a time, one a lane: scores and a shuffle
//   max; pass 2 recomputes each lane's e (den takes it undropped, then the
//   keep factor), broadcasts it with __shfl_sync and issues the z gathers of
//   4 edges before their FFMAs, as packed_row_kernel (csrc/bsr_flat.cu) does;
//   the epilogue divides by den and writes out's row.
//   Row backward (ds): the warp reads g_i and out_i once, forms c_i in a warp
//   sum, keeps g_i and the row's s_i, m_i, den_i, c_i in registers; per batch
//   of 32 edges each lane forms its own edge's alpha, kf and leaky'(raw) from
//   the gathered d_j; then 4 edges at a time it gathers z_j and reduces the 4
//   dot products g_i . z_j in one interleaved shuffle tree, each lane keeping
//   its own edge's; each lane adds its edge's draw, and one warp sum gives
//   ds_i. c goes out for the column sweep.
//   Column backward: the warp keeps z_j and d_j in registers; per batch of
//   32 edges each lane forms its own edge's alpha, kf and leaky'(raw) from
//   the gathered s_i, m_i, den_i, c_i; then 4 edges at a time it gathers g_i,
//   adds kf*alpha*g_i into dz and reduces the 4 dot products g_i . z_j in
//   one interleaved shuffle tree; dd takes each lane's draw. The epilogue
//   adds the chain dd_j a_dst + ds_j a_src as two FMAs a column.
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
// den, keep hash, alpha, leaky', the ds / dd sums, c, the chain, s and d)
// stays float32. The rounding adds a few conversions to each gathered float4
// and moves no other byte, so the variant has the float32 kernels' bound.
// On finite inputs the edge kernels and the dense-tile products compute the
// same function. Where z (or g) holds Inf or NaN in a column off a row's
// edges, the dense products spread 0 * Inf = NaN (e @ z, g @ z^T,
// alpha^T g) and the edge kernels give the sparse answer; a non-finite value
// in another head's columns of a row on the edges can reach the backward's
// dot products as 0 * Inf = NaN.
//
// The dot-product sweeps (dot_attn_*): the attention of UniMP's graph
// transformer layer (Shi et al., IJCAI 2021; graphconvgeo_torch/ops/
// attention_dot.py). They replace no TPU kernel: the JAX package has no such
// layer. Over the same edge lists, the score of edge (i, j) in head h is
// <q_i, k_j> * scale, alpha the softmax of the scores over row i's edges and
// kf the attention-dropout factor above (the same entry ids as the GAT's):
//   dot_attn_fwd: out_i = sum_j kf alpha_ij v_j, and the row's max m_i and
//     den_i = sum_j exp(score - m_i) (m = 0, den = 1, out = 0 for a row with
//     no edge).
//   dot_attn_bwd_row: c_i = <g_i, out_i>, ds_ij = alpha (kf <g_i, v_j> - c_i)
//     and dq_i = scale * sum_j ds_ij k_j.
//   dot_attn_bwd_col: dk_j = scale * sum_i ds_ij q_i and dv_j = sum_i kf
//     alpha_ij g_i.
// q, k, v [>= n, ld] and dq, dk, dv are column blocks of the layer's packed
// projection [q | k | v | r] and of its gradient, read and written in place
// with the row stride ld; out and g are [n_rows, H*f]; m, den, c [n_rows, H].
// Unlike the GAT's score, a sum of two per-node scalars, each score is a dot
// product of f columns, so every sweep gathers two wide rows an edge: k_j
// and v_j by row, q_i and g_i by column. Counted by what the data needs
// (each edge's index once, q, k, v, g, out read once, out or dq, dk, dv
// written once) the sweeps are bound by bytes; what bounds them in fact is
// the gathers of two rows an edge and their latency. Each sweep recomputes
// the scores from the rows it gathers or holds: the forward saves only m and
// den (2 floats a row and head), and no sweep reads a per-edge array. The
// row sweep gathers k_j and v_j anyway (for dq and <g_i, v_j>), the column
// sweep q_i and g_i (for dk and dv), so the recompute costs FMAs and shuffles
// and no byte; a saved [E, H] ds would cost a write, a read and a
// row-to-column map. The forward is an online softmax: U edges' k_j and v_j
// gathered before any is used, their U scores reduced in one interleaved
// shuffle tree, the running max raised and o rescaled once a group. The
// backward sweeps gather U edges' pairs of rows, reduce the 2U dot products
// in one tree (warp_sum2) and accumulate dq, or dk and dv. The warp holds q_i
// and g_i (by row) or k_j and v_j (by column) with the neighbouring heads'
// columns cleared; gathered rows are used as loaded, as in the GAT's sweeps.
// The column sweep holds four rows of accumulators and operands, so it keeps
// 2 edges in flight and the others 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

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
constexpr int kMaxPasses = 4;  // passes of 32 quartets a lane holds in registers
constexpr int kMaxF = 509;     // the widest head whose aligned span fits kMaxPasses
constexpr int kUnroll = 4;     // edges whose gathers are in flight together
constexpr int kScoreBlocks = 2048;  // gat_scores: blocks a head, each warp a run of rows
constexpr unsigned kFull = 0xffffffffu;

// Blocks a sweep kernel keeps resident on an SM where a head takes up to two
// passes (wider heads take the registers they need), so that enough gathers
// are in flight to hide device memory's latency: 4 (64 registers a thread)
// for the forward and ds sweeps, 3 (80) for the dz/dd sweep, which holds z_j
// and its dz row beside the gathers. Each count was the faster at
// Twitter-World size on an H100.
constexpr int min_blocks(int np, int blocks) { return np <= 2 ? blocks : 1; }

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

// The columns of head h (f of them, from h*f) that a lane covers in a row of
// H*f floats: pass p holds the quartet col(p) .. col(p) + 3, and in(p) has bit
// e set where column col(p) + e is the head's. VEC starts the quartets at the
// aligned column (h*f) & ~3, so that each is one aligned float4; the scalar
// path starts them at h*f. Two registers: the first column and the bits of
// every pass.
template <int NP, bool VEC>
struct Span {
  int c0;
  unsigned bits;

  __device__ __forceinline__ Span(int h, int f) {
    const int lo = h * f, hi = lo + f;
    c0 = (VEC ? (lo & ~3) : lo) + 4 * (threadIdx.x & 31);
    bits = 0u;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = col(p) + e;
        bits |= (c >= lo && c < hi) ? (1u << (4 * p + e)) : 0u;
      }
  }
  __device__ __forceinline__ int col(int p) const { return c0 + 128 * p; }
  __device__ __forceinline__ unsigned in(int p) const { return (bits >> (4 * p)) & 15u; }
};

// Row r's quartets of the head's span as they lie: VEC reads the aligned
// float4s, the neighbouring heads' columns included; the scalar path reads
// the head's columns and 0 past them. Loads only, with nothing that waits on
// them, so that the gathers of several edges are in flight together.
template <int NP, bool VEC>
__device__ __forceinline__ void load_span(const float* __restrict__ base, size_t r, int hf,
                                          const Span<NP, VEC>& sp, float4 (&x)[NP]) {
  const float* p0 = base + r * static_cast<size_t>(hf);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const unsigned m = sp.in(p);
    const float* q = p0 + sp.col(p);
    if (VEC) {
      x[p] = m ? __ldg(reinterpret_cast<const float4*>(q)) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      x[p] = make_float4(m & 1u ? __ldg(q) : 0.0f, m & 2u ? __ldg(q + 1) : 0.0f,
                         m & 4u ? __ldg(q + 2) : 0.0f, m & 8u ? __ldg(q + 3) : 0.0f);
    }
  }
}

// The head's columns of a row that a warp holds (g_i, out_i, z_j, a_src,
// a_dst), read once: 0 in the neighbouring heads' columns, rounded to bf16
// under BF16. A row gathered per edge is used as load_span leaves it: its
// neighbouring heads' columns meet these zeros.
template <int NP, bool VEC, bool BF16>
__device__ __forceinline__ void gather_span(const float* __restrict__ base, size_t r, int hf,
                                            const Span<NP, VEC>& sp, float4 (&x)[NP]) {
  load_span<NP, VEC>(base, r, hf, sp, x);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    float4 v = x[p];
    if (VEC) {
      const unsigned m = sp.in(p);
      v = make_float4(m & 1u ? v.x : 0.0f, m & 2u ? v.y : 0.0f, m & 4u ? v.z : 0.0f,
                      m & 8u ? v.w : 0.0f);
    }
    x[p] = operand4<BF16>(v);
  }
}

// Write the head's columns of row r: a quartet wholly the head's as one
// float4 (VEC), any other column by column.
template <int NP, bool VEC>
__device__ __forceinline__ void store_span(float* __restrict__ base, size_t r, int hf,
                                           const Span<NP, VEC>& sp, const float4 (&v)[NP]) {
  float* p0 = base + r * static_cast<size_t>(hf);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const unsigned m = sp.in(p);
    float* q = p0 + sp.col(p);
    if (VEC && m == 15u) {
      *reinterpret_cast<float4*>(q) = v[p];
    } else {
      if (m & 1u) q[0] = v[p].x;
      if (m & 2u) q[1] = v[p].y;
      if (m & 4u) q[2] = v[p].z;
      if (m & 8u) q[3] = v[p].w;
    }
  }
}

// One warp per (row, head h); NP passes of the head's span; BF16 rounds the
// operands of o += (kf*e) z_j. Rows below n_out write out. grid
// (ceil(n_rows / 8), H).
template <int NP, bool BF16, bool VEC>
__global__ void __launch_bounds__(kEdgeThreads, min_blocks(NP, 4))
gat_edge_fwd_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                    const float* __restrict__ s, const float* __restrict__ d,
                    const float* __restrict__ z, float* __restrict__ out,
                    float* __restrict__ den_out, float* __restrict__ m_out, int n_rows, int n_out,
                    int heads, int f, float slope, Drop dp) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kEdgeWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp shares its row
  const int h = blockIdx.y;
  const int hf = heads * f;
  const Span<NP, VEC> sp(h, f);
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
        load_span<NP, VEC>(z, __shfl_sync(kFull, my_j, k + u), hf, sp, x[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int p = 0; p < NP; ++p) fma4(acc[p], w[u], operand4<BF16>(x[u][p]));
    }
    for (; k < n; ++k) {
      const float w = __shfl_sync(kFull, my_e, k);
      float4 x[NP];
      load_span<NP, VEC>(z, __shfl_sync(kFull, my_j, k), hf, sp, x);
#pragma unroll
      for (int p = 0; p < NP; ++p) fma4(acc[p], w, operand4<BF16>(x[p]));
    }
  }

  // a row with no edge: den 1 and m 0, so out = 0 / 1
  const float den = warp_sum(part);
  const float den_w = den > 0.0f ? den : 1.0f;
  if (row < n_out) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
      acc[p] = make_float4(acc[p].x / den_w, acc[p].y / den_w, acc[p].z / den_w, acc[p].w / den_w);
    store_span<NP, VEC>(out, row, hf, sp, acc);
  }
  if (lane == 0) {
    den_out[static_cast<size_t>(row) * heads + h] = den_w;
    m_out[static_cast<size_t>(row) * heads + h] = mx > 0.5f * kNeg ? mx : 0.0f;
  }
}

// One warp per (row i, head h); NP passes of the head's span; BF16 rounds
// the operands of g_i . z_j. Rows below n_g read g and out (c_i = <g_i,
// out_i>); the others have no edge and write c = ds = 0. grid
// (ceil(n_rows / 8), H).
template <int NP, bool BF16, bool VEC>
__global__ void __launch_bounds__(kEdgeThreads, min_blocks(NP, 4))
gat_edge_bwd_row_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                        const float* __restrict__ s, const float* __restrict__ d,
                        const float* __restrict__ m, const float* __restrict__ den,
                        const float* __restrict__ z, const float* __restrict__ g,
                        const float* __restrict__ out, float* __restrict__ ds_out,
                        float* __restrict__ c_out, int n_rows, int n_g, int heads, int f,
                        float slope, Drop dp) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kEdgeWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp shares its row
  const int h = blockIdx.y;
  const int hf = heads * f;
  const Span<NP, VEC> sp(h, f);
  float4 gi[NP];
  float c_i = 0.0f;
  if (row < n_g) {
    float4 oi[NP];
    gather_span<NP, VEC, false>(g, row, hf, sp, gi);
    gather_span<NP, VEC, false>(out, row, hf, sp, oi);
    float cp = 0.0f;
#pragma unroll
    for (int p = 0; p < NP; ++p) cp += dot4(gi[p], oi[p]);
    c_i = warp_sum(cp);
#pragma unroll
    for (int p = 0; p < NP; ++p) gi[p] = operand4<BF16>(gi[p]);
  } else {
#pragma unroll
    for (int p = 0; p < NP; ++p) gi[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const size_t ki = static_cast<size_t>(row) * heads + h;
  const float s_i = s[ki], m_i = m[ki], den_i = den[ki];
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
        load_span<NP, VEC>(z, __shfl_sync(kFull, my_j, k + u), hf, sp, x[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        dot[u] = 0.0f;
#pragma unroll
        for (int p = 0; p < NP; ++p) dot[u] += dot4(operand4<BF16>(x[u][p]), gi[p]);
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
      load_span<NP, VEC>(z, __shfl_sync(kFull, my_j, k), hf, sp, x);
      float dot = 0.0f;
#pragma unroll
      for (int p = 0; p < NP; ++p) dot += dot4(operand4<BF16>(x[p]), gi[p]);
      dot = warp_sum(dot);
      if (lane == k) my_da = dot;
    }
    if (lane < n) dsp += my_a * (my_kf * my_da - c_i) * my_lg;
  }

  const float ds = warp_sum(dsp);
  if (lane == 0) {
    ds_out[ki] = ds;
    c_out[ki] = c_i;
  }
}

// One warp per (column j, head h); NP passes of the head's span; BF16 rounds
// the operands of dz_j += (kf*alpha) g_i and of g_i . z_j. Columns below n_z
// read z and write dz, those below n_s also take the chain's ds term. grid
// (ceil(n_cols / 8), H).
template <int NP, bool BF16, bool VEC>
__global__ void __launch_bounds__(kEdgeThreads, min_blocks(NP, 3))
gat_edge_bwd_col_kernel(const int* __restrict__ col_ptr, const int* __restrict__ row_idx,
                        const float* __restrict__ s, const float* __restrict__ d,
                        const float* __restrict__ m, const float* __restrict__ den,
                        const float* __restrict__ c_in, const float* __restrict__ ds_in,
                        const float* __restrict__ z, const float* __restrict__ g,
                        const float* __restrict__ a_src, const float* __restrict__ a_dst,
                        float* __restrict__ dz_out, float* __restrict__ dd_out, int n_cols,
                        int n_z, int n_s, int heads, int f, float slope, Drop dp) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kEdgeWarps + (threadIdx.x >> 5);
  if (col >= n_cols) return;  // the whole warp shares its column
  const int h = blockIdx.y;
  const int hf = heads * f;
  const Span<NP, VEC> sp(h, f);
  float4 zj[NP], acc[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    zj[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    acc[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (col < n_z) gather_span<NP, VEC, BF16>(z, col, hf, sp, zj);
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
        load_span<NP, VEC>(g, __shfl_sync(kFull, my_i, k + u), hf, sp, x[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        dot[u] = 0.0f;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float4 xp = operand4<BF16>(x[u][p]);
          dot[u] += dot4(xp, zj[p]);
          fma4(acc[p], w[u], xp);
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
      load_span<NP, VEC>(g, __shfl_sync(kFull, my_i, k), hf, sp, x);
      float dot = 0.0f;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const float4 xp = operand4<BF16>(x[p]);
        dot += dot4(xp, zj[p]);
        fma4(acc[p], w, xp);
      }
      dot = warp_sum(dot);
      if (lane == k) my_da = dot;
    }
    if (lane < n) ddp += my_a * (my_kf * my_da - my_c) * my_lg;
  }

  const float dd = warp_sum(ddp);  // every lane holds it
  if (col < n_z) {
    // the chain through d = z . a_dst and, on the first n_s rows, s = z . a_src
    float4 a[NP];
    gather_span<NP, VEC, false>(a_dst, 0, hf, sp, a);
#pragma unroll
    for (int p = 0; p < NP; ++p) fma4(acc[p], dd, a[p]);
    if (col < n_s) {
      const float ds_j = ds_in[static_cast<size_t>(col) * heads + h];
      gather_span<NP, VEC, false>(a_src, 0, hf, sp, a);
#pragma unroll
      for (int p = 0; p < NP; ++p) fma4(acc[p], ds_j, a[p]);
    }
    store_span<NP, VEC>(dz_out, col, hf, sp, acc);
  }
  if (lane == 0) dd_out[static_cast<size_t>(col) * heads + h] = dd;
}

// One warp per head h and a grid-stride run of rows: s_r = z_r . a_src[h]
// for r < n_s, d_r = z_r . a_dst[h] for r < n_z, 0 on the padding rows up to
// s_rows / d_rows. grid (min(ceil(rows / 8), kScoreBlocks), H).
template <int NP, bool VEC>
__global__ void __launch_bounds__(kEdgeThreads)
gat_scores_kernel(const float* __restrict__ z, const float* __restrict__ a_src,
                  const float* __restrict__ a_dst, float* __restrict__ s, float* __restrict__ d,
                  int n_z, int n_s, int s_rows, int d_rows, int heads, int f) {
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.y;
  const int hf = heads * f;
  const Span<NP, VEC> sp(h, f);
  float4 as[NP], ad[NP];
  gather_span<NP, VEC, false>(a_src, 0, hf, sp, as);
  gather_span<NP, VEC, false>(a_dst, 0, hf, sp, ad);
  const int rows = max(s_rows, d_rows);
  for (int r = blockIdx.x * kEdgeWarps + (threadIdx.x >> 5); r < rows;
       r += gridDim.x * kEdgeWarps) {
    float ps = 0.0f, pd = 0.0f;
    if (r < n_z) {  // the whole warp shares its row
      float4 x[NP];
      gather_span<NP, VEC, false>(z, r, hf, sp, x);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        ps += dot4(x[p], as[p]);
        pd += dot4(x[p], ad[p]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ps += __shfl_xor_sync(kFull, ps, off);
        pd += __shfl_xor_sync(kFull, pd, off);
      }
    }
    if (lane == 0) {
      const size_t k = static_cast<size_t>(r) * heads + h;
      if (r < s_rows) s[k] = r < n_s ? ps : 0.0f;
      if (r < d_rows) d[k] = pd;
    }
  }
}

// ---- the dot-product sweeps --------------------------------------------------
// The score of edge (i, j) in head h is <q_i, k_j> * scale over the head's f
// columns (module note at the end of this file's header). q, k, v and the
// gradients dq, dk, dv share one row stride ld (the columns of the packed
// projection they live in); out and g are [n_rows, H*f].
constexpr int kDotUnroll = 4;     // forward and row sweep: edges whose k_j, v_j are in flight
constexpr int kDotUnrollCol = 2;  // column sweep: edges whose q_i, g_i are in flight

// Reduce U dot products of each of two kinds across the warp in one
// interleaved shuffle tree: every lane ends with every sum.
template <int U>
__device__ __forceinline__ void warp_sum2(float (&a)[U], float (&b)[U]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      a[u] += __shfl_xor_sync(kFull, a[u], off);
      b[u] += __shfl_xor_sync(kFull, b[u], off);
    }
}

// One warp per (row i, head h): an online softmax over the row's edges, U
// edges at a time, the running max updated and o rescaled once a group.
// Writes out_i = o / den, and m_i, den_i of the final max (m = 0, den = 1,
// out = 0 for a row with no edge). grid (ceil(n_rows / 8), H).
template <int NP, bool VEC>
__global__ void __launch_bounds__(kEdgeThreads, min_blocks(NP, 2))
dot_attn_fwd_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                    const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ den_out, int n_rows, int ld,
                    int heads, int f, float scale, Drop dp) {
  constexpr int U = kDotUnroll;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kEdgeWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp shares its row
  const int h = blockIdx.y;
  const int hf = heads * f;
  const Span<NP, VEC> sp(h, f);
  float4 qi[NP], acc[NP];
  gather_span<NP, VEC, false>(q, row, ld, sp, qi);
#pragma unroll
  for (int p = 0; p < NP; ++p) acc[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float mx = kNeg, den = 0.0f;  // every lane holds both

  const int begin = row_ptr[row], end = row_ptr[row + 1];
  for (int base = begin; base < end; base += 32) {
    const int n = min(32, end - base);
    int my_j = 0;
    float my_kf = 1.0f;
    if (lane < n) {
      my_j = __ldg(col + base + lane);
      if (dp.on) my_kf = keep_factor(dp, row, my_j, h);
    }
    for (int k0 = 0; k0 < n; k0 += U) {
      const int cnt = min(U, n - k0);
      float sc[U];
      float4 xk[U][NP], xv[U][NP];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = __shfl_sync(kFull, my_j, min(k0 + u, n - 1));
        if (u < cnt) {
          load_span<NP, VEC>(k, j, ld, sp, xk[u]);
          load_span<NP, VEC>(v, j, ld, sp, xv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[u] = 0.0f;
        if (u < cnt) {
#pragma unroll
          for (int p = 0; p < NP; ++p) sc[u] += dot4(xk[u][p], qi[p]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u) sc[u] += __shfl_xor_sync(kFull, sc[u], off);
      float gm = mx;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[u] *= scale;
        if (u < cnt) gm = fmaxf(gm, sc[u]);
      }
      const float r = expf(mx - gm);  // 0 before the first edge, 1 where the max held
      den *= r;
#pragma unroll
      for (int p = 0; p < NP; ++p)
        acc[p] = make_float4(acc[p].x * r, acc[p].y * r, acc[p].z * r, acc[p].w * r);
      mx = gm;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float kf = __shfl_sync(kFull, my_kf, min(k0 + u, n - 1));
        if (u < cnt) {
          const float e = expf(sc[u] - mx);
          den += e;
#pragma unroll
          for (int p = 0; p < NP; ++p) fma4(acc[p], e * kf, xv[u][p]);
        }
      }
    }
  }

  const float den_w = den > 0.0f ? den : 1.0f;
#pragma unroll
  for (int p = 0; p < NP; ++p)
    acc[p] = make_float4(acc[p].x / den_w, acc[p].y / den_w, acc[p].z / den_w, acc[p].w / den_w);
  store_span<NP, VEC>(out, row, hf, sp, acc);
  if (lane == 0) {
    m_out[static_cast<size_t>(row) * heads + h] = mx > 0.5f * kNeg ? mx : 0.0f;
    den_out[static_cast<size_t>(row) * heads + h] = den_w;
  }
}

// One warp per (row i, head h): c_i = <g_i, out_i>, then over the row's
// edges, U at a time, the scores <q_i, k_j> and <g_i, v_j> in one shuffle
// tree, ds = alpha (kf <g_i, v_j> - c_i) and dq_i = scale * sum ds k_j.
// grid (ceil(n_rows / 8), H).
template <int NP, bool VEC>
__global__ void __launch_bounds__(kEdgeThreads, min_blocks(NP, 2))
dot_attn_bwd_row_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                        const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ out,
                        const float* __restrict__ g, const float* __restrict__ m,
                        const float* __restrict__ den, float* __restrict__ dq,
                        float* __restrict__ c_out, int n_rows, int ld, int heads, int f,
                        float scale, Drop dp) {
  constexpr int U = kDotUnroll;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kEdgeWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp shares its row
  const int h = blockIdx.y;
  const int hf = heads * f;
  const Span<NP, VEC> sp(h, f);
  float4 qi[NP], gi[NP], acc[NP];
  float c_i;
  {
    float4 oi[NP];
    gather_span<NP, VEC, false>(g, row, hf, sp, gi);
    gather_span<NP, VEC, false>(out, row, hf, sp, oi);
    float cp = 0.0f;
#pragma unroll
    for (int p = 0; p < NP; ++p) cp += dot4(gi[p], oi[p]);
    c_i = warp_sum(cp);
  }
  gather_span<NP, VEC, false>(q, row, ld, sp, qi);
#pragma unroll
  for (int p = 0; p < NP; ++p) acc[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const size_t ki = static_cast<size_t>(row) * heads + h;
  const float m_i = m[ki], inv_den = 1.0f / den[ki];

  const int begin = row_ptr[row], end = row_ptr[row + 1];
  for (int base = begin; base < end; base += 32) {
    const int n = min(32, end - base);
    int my_j = 0;
    float my_kf = 1.0f;
    if (lane < n) {
      my_j = __ldg(col + base + lane);
      if (dp.on) my_kf = keep_factor(dp, row, my_j, h);
    }
    for (int k0 = 0; k0 < n; k0 += U) {
      const int cnt = min(U, n - k0);
      float sc[U], gv[U];
      float4 xk[U][NP], xv[U][NP];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = __shfl_sync(kFull, my_j, min(k0 + u, n - 1));
        if (u < cnt) {
          load_span<NP, VEC>(k, j, ld, sp, xk[u]);
          load_span<NP, VEC>(v, j, ld, sp, xv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[u] = 0.0f;
        gv[u] = 0.0f;
        if (u < cnt) {
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            sc[u] += dot4(xk[u][p], qi[p]);
            gv[u] += dot4(xv[u][p], gi[p]);
          }
        }
      }
      warp_sum2<U>(sc, gv);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float kf = __shfl_sync(kFull, my_kf, min(k0 + u, n - 1));
        if (u < cnt) {
          const float a = expf(sc[u] * scale - m_i) * inv_den;
          const float ds = a * (kf * gv[u] - c_i) * scale;
#pragma unroll
          for (int p = 0; p < NP; ++p) fma4(acc[p], ds, xk[u][p]);
        }
      }
    }
  }

  store_span<NP, VEC>(dq, row, ld, sp, acc);
  if (lane == 0) c_out[ki] = c_i;
}

// One warp per (column j, head h): over the column's edges, U at a time, the
// scores <q_i, k_j> and <g_i, v_j> in one shuffle tree, alpha from row i's m
// and den, ds = alpha (kf <g_i, v_j> - c_i); dk_j = scale * sum ds q_i and
// dv_j = sum kf alpha g_i. grid (ceil(n_cols / 8), H).
template <int NP, bool VEC>
__global__ void __launch_bounds__(kEdgeThreads, min_blocks(NP, 2))
dot_attn_bwd_col_kernel(const int* __restrict__ col_ptr, const int* __restrict__ row_idx,
                        const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ g,
                        const float* __restrict__ m, const float* __restrict__ den,
                        const float* __restrict__ c_in, float* __restrict__ dk,
                        float* __restrict__ dv, int n_cols, int ld, int heads, int f,
                        float scale, Drop dp) {
  constexpr int U = kDotUnrollCol;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kEdgeWarps + (threadIdx.x >> 5);
  if (col >= n_cols) return;  // the whole warp shares its column
  const int h = blockIdx.y;
  const int hf = heads * f;
  const Span<NP, VEC> sp(h, f);
  float4 kj[NP], vj[NP], ak[NP], av[NP];
  gather_span<NP, VEC, false>(k, col, ld, sp, kj);
  gather_span<NP, VEC, false>(v, col, ld, sp, vj);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    ak[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    av[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  const int begin = col_ptr[col], end = col_ptr[col + 1];
  for (int base = begin; base < end; base += 32) {
    const int n = min(32, end - base);
    int my_i = 0;
    float my_kf = 1.0f, my_m = 0.0f, my_inv = 0.0f, my_c = 0.0f;
    if (lane < n) {
      my_i = __ldg(row_idx + base + lane);
      const size_t ki = static_cast<size_t>(my_i) * heads + h;
      my_m = __ldg(m + ki);
      my_inv = 1.0f / __ldg(den + ki);
      my_c = __ldg(c_in + ki);
      if (dp.on) my_kf = keep_factor(dp, my_i, col, h);
    }
    for (int k0 = 0; k0 < n; k0 += U) {
      const int cnt = min(U, n - k0);
      float sc[U], gv[U];
      float4 xq[U][NP], xg[U][NP];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = __shfl_sync(kFull, my_i, min(k0 + u, n - 1));
        if (u < cnt) {
          load_span<NP, VEC>(q, i, ld, sp, xq[u]);
          load_span<NP, VEC>(g, i, hf, sp, xg[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[u] = 0.0f;
        gv[u] = 0.0f;
        if (u < cnt) {
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            sc[u] += dot4(xq[u][p], kj[p]);
            gv[u] += dot4(xg[u][p], vj[p]);
          }
        }
      }
      warp_sum2<U>(sc, gv);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int src = min(k0 + u, n - 1);
        const float kf = __shfl_sync(kFull, my_kf, src);
        const float mi = __shfl_sync(kFull, my_m, src);
        const float inv = __shfl_sync(kFull, my_inv, src);
        const float ci = __shfl_sync(kFull, my_c, src);
        if (u < cnt) {
          const float a = expf(sc[u] * scale - mi) * inv;
          const float ds = a * (kf * gv[u] - ci) * scale;
          const float w = kf * a;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            fma4(ak[p], ds, xq[u][p]);
            fma4(av[p], w, xg[u][p]);
          }
        }
      }
    }
  }

  store_span<NP, VEC>(dk, col, ld, sp, ak);
  store_span<NP, VEC>(dv, col, ld, sp, av);
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

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0; }

// the heads' quartets take float4s where the row stride H*f is a multiple of
// 4 floats and every wide base is 16-byte aligned
template <class... Ptrs>
bool vector_rows(int heads, int f, Ptrs... ptrs) {
  return (heads * f) % 4 == 0 && (aligned16(ptrs) && ...);
}

// passes of 32 quartets that cover a head's span (aligned: ceil((f + 3) / 4)
// quartets at most; scalar: ceil(f / 4))
int passes_of(int f, bool vec) { return ((vec ? f + 6 : f + 3) / 4 + 31) / 32; }

bool bad_heads(int heads, int f) { return heads <= 0 || heads > 65535 || f <= 0 || f > kMaxF; }

// launch(std::integral_constant<int, NP>, std::bool_constant<BF16>,
// std::bool_constant<VEC>) for NP = passes_of(f, vec) in [1, kMaxPasses],
// BF16 = bf16 != 0 and VEC = vec
template <class Launch>
void with_variant(int f, bool vec, int bf16, Launch launch) {
  const int np = passes_of(f, vec);
  auto passes = [&](auto bf, auto vc) {
    switch (np) {
      case 1: launch(std::integral_constant<int, 1>{}, bf, vc); break;
      case 2: launch(std::integral_constant<int, 2>{}, bf, vc); break;
      case 3: launch(std::integral_constant<int, 3>{}, bf, vc); break;
      default: launch(std::integral_constant<int, kMaxPasses>{}, bf, vc); break;
    }
  };
  auto rows = [&](auto bf) {
    if (vec) {
      passes(bf, std::true_type{});
    } else {
      passes(bf, std::false_type{});
    }
  };
  if (bf16) {
    rows(std::true_type{});
  } else {
    rows(std::false_type{});
  }
}

}  // namespace

// C entries. Each launches on `stream` and returns cudaGetLastError() as an
// int (0 = launched); a refused launch never runs. contract_bf16 = 1 takes
// the bf16-operand variant.

// out [n_out, H*f], den and m [n_rows, H] from an edge list by row
// (row_ptr [n_rows + 1], col [nnz]); z [>= n_cols, H*f].
extern "C" int gat_tile_fwd_f32(const int* row_ptr, const int* col, const float* s, const float* d,
                                const float* z, float* out, float* den, float* m, int n_rows,
                                int n_out, int heads, int f, int contract_bf16, float slope,
                                int dropout, unsigned seed, unsigned keep_thr, float keep_scale,
                                unsigned n_cols, unsigned head_stride, void* stream) {
  if (n_rows <= 0 || n_out < 0 || n_out > n_rows || bad_heads(heads, f))
    return static_cast<int>(cudaErrorInvalidValue);
  const Drop dp = make_drop(dropout, seed, keep_thr, keep_scale, n_cols, head_stride);
  const dim3 grid((n_rows + kEdgeWarps - 1) / kEdgeWarps, heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_variant(f, vector_rows(heads, f, z, out), contract_bf16, [&](auto np, auto bf, auto vc) {
    gat_edge_fwd_kernel<decltype(np)::value, decltype(bf)::value, decltype(vc)::value>
        <<<grid, kEdgeThreads, 0, st>>>(row_ptr, col, s, d, z, out, den, m, n_rows, n_out, heads,
                                        f, slope, dp);
  });
  return static_cast<int>(cudaGetLastError());
}

// ds and c [n_rows, H] from an edge list by row (row_ptr [n_rows + 1], col
// [nnz]), the same lists gat_tile_fwd_f32 reads; g and out [n_g, H*f].
extern "C" int gat_tile_bwd_row_f32(const int* row_ptr, const int* col, const float* s,
                                    const float* d, const float* m, const float* den,
                                    const float* z, const float* g, const float* out, float* ds,
                                    float* c, int n_rows, int n_g, int heads, int f,
                                    int contract_bf16, float slope, int dropout, unsigned seed,
                                    unsigned keep_thr, float keep_scale, unsigned n_cols,
                                    unsigned head_stride, void* stream) {
  if (n_rows <= 0 || n_g < 0 || n_g > n_rows || bad_heads(heads, f))
    return static_cast<int>(cudaErrorInvalidValue);
  const Drop dp = make_drop(dropout, seed, keep_thr, keep_scale, n_cols, head_stride);
  const dim3 grid((n_rows + kEdgeWarps - 1) / kEdgeWarps, heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_variant(f, vector_rows(heads, f, z, g, out), contract_bf16, [&](auto np, auto bf, auto vc) {
    gat_edge_bwd_row_kernel<decltype(np)::value, decltype(bf)::value, decltype(vc)::value>
        <<<grid, kEdgeThreads, 0, st>>>(row_ptr, col, s, d, m, den, z, g, out, ds, c, n_rows,
                                        n_g, heads, f, slope, dp);
  });
  return static_cast<int>(cudaGetLastError());
}

// dz [n_z, H*f] and dd [n_cols, H] from an edge list by column (col_ptr
// [n_cols + 1], row [nnz]); the chain's ds term on the first n_s columns.
extern "C" int gat_tile_bwd_col_f32(const int* col_ptr, const int* row, const float* s,
                                    const float* d, const float* m, const float* den,
                                    const float* c, const float* ds, const float* z,
                                    const float* g, const float* a_src, const float* a_dst,
                                    float* dz, float* dd, int n_cols, int n_z, int n_s, int heads,
                                    int f, int contract_bf16, float slope, int dropout,
                                    unsigned seed, unsigned keep_thr, float keep_scale,
                                    unsigned n_cols_pattern, unsigned head_stride, void* stream) {
  if (n_cols <= 0 || n_z < 0 || n_z > n_cols || n_s < 0 || n_s > n_z || bad_heads(heads, f))
    return static_cast<int>(cudaErrorInvalidValue);
  const Drop dp = make_drop(dropout, seed, keep_thr, keep_scale, n_cols_pattern, head_stride);
  const dim3 grid((n_cols + kEdgeWarps - 1) / kEdgeWarps, heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_variant(f, vector_rows(heads, f, z, g, a_src, a_dst, dz), contract_bf16,
               [&](auto np, auto bf, auto vc) {
    gat_edge_bwd_col_kernel<decltype(np)::value, decltype(bf)::value, decltype(vc)::value>
        <<<grid, kEdgeThreads, 0, st>>>(col_ptr, row, s, d, m, den, c, ds, z, g, a_src, a_dst,
                                        dz, dd, n_cols, n_z, n_s, heads, f, slope, dp);
  });
  return static_cast<int>(cudaGetLastError());
}

// s [s_rows, H] (z's first n_s rows against a_src, 0 past them) and d
// [d_rows, H] (z's n_z rows against a_dst, 0 past them) from z [n_z, H*f].
extern "C" int gat_scores_f32(const float* z, const float* a_src, const float* a_dst, float* s,
                              float* d, int n_z, int n_s, int s_rows, int d_rows, int heads,
                              int f, void* stream) {
  if (n_z <= 0 || n_s < 0 || n_s > n_z || n_s > s_rows || n_z > d_rows || bad_heads(heads, f))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = s_rows > d_rows ? s_rows : d_rows;
  const int blocks = (rows + kEdgeWarps - 1) / kEdgeWarps;
  const dim3 grid(blocks < kScoreBlocks ? blocks : kScoreBlocks, heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_variant(f, vector_rows(heads, f, z, a_src, a_dst), 0, [&](auto np, auto, auto vc) {
    gat_scores_kernel<decltype(np)::value, decltype(vc)::value><<<grid, kEdgeThreads, 0, st>>>(
        z, a_src, a_dst, s, d, n_z, n_s, s_rows, d_rows, heads, f);
  });
  return static_cast<int>(cudaGetLastError());
}

// The dot-product sweeps' variants: NP passes of the head's span, float4
// quartets where the row strides ld and H*f are multiples of 4 and every
// wide base is 16-byte aligned.
template <class Launch>
void with_dot_variant(int f, bool vec, Launch launch) {
  with_variant(f, vec, 0, [&](auto np, auto, auto vc) { launch(np, vc); });
}

// out [n_rows, H*f], m and den [n_rows, H] from an edge list by row
// (row_ptr [n_rows + 1], col [nnz]); q, k, v with the row stride ld.
extern "C" int dot_attn_fwd_f32(const int* row_ptr, const int* col, const float* q,
                                const float* k, const float* v, float* out, float* m, float* den,
                                int n_rows, int ld, int heads, int f, float scale, int dropout,
                                unsigned seed, unsigned keep_thr, float keep_scale,
                                unsigned n_cols, unsigned head_stride, void* stream) {
  if (n_rows <= 0 || ld < heads * f || bad_heads(heads, f))
    return static_cast<int>(cudaErrorInvalidValue);
  const Drop dp = make_drop(dropout, seed, keep_thr, keep_scale, n_cols, head_stride);
  const dim3 grid((n_rows + kEdgeWarps - 1) / kEdgeWarps, heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = ld % 4 == 0 && vector_rows(heads, f, q, k, v, out);
  with_dot_variant(f, vec, [&](auto np, auto vc) {
    dot_attn_fwd_kernel<decltype(np)::value, decltype(vc)::value>
        <<<grid, kEdgeThreads, 0, st>>>(row_ptr, col, q, k, v, out, m, den, n_rows, ld, heads, f,
                                        scale, dp);
  });
  return static_cast<int>(cudaGetLastError());
}

// dq [n_rows, ld] (the head columns) and c [n_rows, H] from an edge list by
// row; g and out [n_rows, H*f].
extern "C" int dot_attn_bwd_row_f32(const int* row_ptr, const int* col, const float* q,
                                    const float* k, const float* v, const float* out,
                                    const float* g, const float* m, const float* den, float* dq,
                                    float* c, int n_rows, int ld, int heads, int f, float scale,
                                    int dropout, unsigned seed, unsigned keep_thr,
                                    float keep_scale, unsigned n_cols, unsigned head_stride,
                                    void* stream) {
  if (n_rows <= 0 || ld < heads * f || bad_heads(heads, f))
    return static_cast<int>(cudaErrorInvalidValue);
  const Drop dp = make_drop(dropout, seed, keep_thr, keep_scale, n_cols, head_stride);
  const dim3 grid((n_rows + kEdgeWarps - 1) / kEdgeWarps, heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = ld % 4 == 0 && vector_rows(heads, f, q, k, v, out, g, dq);
  with_dot_variant(f, vec, [&](auto np, auto vc) {
    dot_attn_bwd_row_kernel<decltype(np)::value, decltype(vc)::value>
        <<<grid, kEdgeThreads, 0, st>>>(row_ptr, col, q, k, v, out, g, m, den, dq, c, n_rows, ld,
                                        heads, f, scale, dp);
  });
  return static_cast<int>(cudaGetLastError());
}

// dk and dv [n_cols, ld] (the head columns) from an edge list by column
// (col_ptr [n_cols + 1], row [nnz]); g [n_rows, H*f]; m, den, c [n_rows, H].
extern "C" int dot_attn_bwd_col_f32(const int* col_ptr, const int* row, const float* q,
                                    const float* k, const float* v, const float* g,
                                    const float* m, const float* den, const float* c, float* dk,
                                    float* dv, int n_cols, int ld, int heads, int f, float scale,
                                    int dropout, unsigned seed, unsigned keep_thr,
                                    float keep_scale, unsigned n_cols_pattern,
                                    unsigned head_stride, void* stream) {
  if (n_cols <= 0 || ld < heads * f || bad_heads(heads, f))
    return static_cast<int>(cudaErrorInvalidValue);
  const Drop dp = make_drop(dropout, seed, keep_thr, keep_scale, n_cols_pattern, head_stride);
  const dim3 grid((n_cols + kEdgeWarps - 1) / kEdgeWarps, heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = ld % 4 == 0 && vector_rows(heads, f, q, k, v, g, dk, dv);
  with_dot_variant(f, vec, [&](auto np, auto vc) {
    dot_attn_bwd_col_kernel<decltype(np)::value, decltype(vc)::value>
        <<<grid, kEdgeThreads, 0, st>>>(col_ptr, row, q, k, v, g, m, den, c, dk, dv, n_cols, ld,
                                        heads, f, scale, dp);
  });
  return static_cast<int>(cudaGetLastError());
}
