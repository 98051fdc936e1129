// Tiled (flash-style) GAT attention for Hopper (sm_90a), float32: the three
// tile sweeps of one attention layer over bit-packed 128x128 mask tiles.
//
// Notation: B = 128 (tile edge), H heads, Fp = the head width padded to a
// multiple of 128. s [Npad,H], d [Mpad,H], z [Mpad,H,Fp], g [Npad,H,Fp].
// The score of edge (i, j) in head h is LeakyReLU(s_i + d_j), masked to
// kNeg = -1e30 outside the pattern (never -inf: -inf - -inf is NaN, and rows
// with no edge yet rely on exp(kNeg - kNeg) = 1 against zero accumulators).
// mask[i][j] = bit (i / 4) of bits[t][i % 4][j]. Attention dropout keeps an
// entry iff wang(eid ^ wang(seed)) >> 1 >= thr, with the uint32-wrapped id
// eid = (row * n_cols + col + head * head_stride), and scales it by
// 1 / (1 - rate): bit-equal to graphconvgeo_torch/ops/dropout.py :: entry_keep.
//
// gat_tile_fwd replaces graphconvgeo_tpu/ops/attention_tiled.py ::
//   _tile_fwd_fused (kernel _fwd_fused_kernel). Per row block, an online
//   softmax over its run of tiles: m_new = max(m, rowmax(sc)),
//   scale = exp(m - m_new), e = exp(sc - m_new) * mask, den = den*scale +
//   sum_j e, then the keep mask on e, then o = o*scale + e @ z[colblk].
// gat_tile_bwd_row replaces _tile_bwd_row (kernel _bwd_row_kernel): ds_i =
//   sum_j alpha (kf * (g_i . z_j) - c_i) * leaky'(raw), alpha =
//   exp(masked(sc) - m) / den under the merged m and den.
// gat_tile_bwd_col replaces _tile_bwd_col (kernel _bwd_col_kernel): the
//   transpose sweep over the column-major tile copies, dz_j = sum_i
//   (kf*alpha)_ij g_i and dd_j = sum_i draw_ij.
// Both backward kernels apply the mask BEFORE the exp, so a masked slot with
// a towering score never overflows to inf (inf * 0 would be NaN).
//
// What bounds them on this card. Counted by what the data needs, each sweep
// moves z (and g) once, its outputs once, the packed masks (2 KB a tile) and
// the narrow [N,H] vectors: tens to a few hundred MB, a few hundredths of a
// millisecond at 3.35 TB/s. The dense-tile products (e @ z, g @ z^T,
// (kf*alpha)^T @ g) cost 2*B*B*Fp multiply-adds per tile and head whatever
// the tile's fill, in true float32 (FFMA; never TF32, which keeps about three
// decimal digits): at 67 TFLOP/s that is the larger term on every operand
// with more than a few dozen tiles, so these kernels are bound by FFMA issue.
//
// What the design does about that, simply first. One CTA of 256 threads per
// (row block or column block, head, half block of 64 output rows, 128-column
// chunk): it walks its block's run [row_ptr[r], row_ptr[r+1]) (or col_ptr_t),
// keeps its accumulators in registers (a 4 x 8 micro-tile per thread) and
// writes its outputs once: no atomics, no state between CTAs, and an empty
// run writes the neutral values (o = den = 0, m = kNeg, ds = dz = dd = 0).
// The products are shared-memory SGEMMs over 32-deep k-slices read back as
// float4. Scores are recomputed per tile from s and d; nothing per edge is
// stored. Tensor cores, TMA and balancing runs of unequal length are left for
// a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kB = 128;          // tile edge
constexpr int kW = kB / 32;      // packed mask words per tile column
constexpr int kRows = 64;        // output rows per CTA (half a block)
constexpr int kCols = 128;       // output columns per CTA
constexpr int kThreads = 256;    // 16 row groups x 16 column groups
constexpr int kK = 32;           // contraction depth per shared-memory stage
constexpr int kTM = 4;           // output rows per thread
constexpr int kTN = 8;           // output columns per thread
constexpr int kAP = kRows + 4;   // pitch of a transposed 64-wide slice
constexpr int kBP = kB + 4;      // pitch of a transposed 128-wide slice
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

// bits: one tile's [kW][kB] words in shared memory; i, j in [0, kB)
__device__ __forceinline__ bool mask_bit(const unsigned* bits, int i, int j) {
  return (bits[(i % kW) * kB + j] >> (i / kW)) & 1u;
}

// acc[4][8] += sum_k As[k][ty*4 + 0..3] * Bs[k][tx*8 + 0..7], k in [0, kK)
template <int AP, int BP>
__device__ __forceinline__ void mma_slice(const float* As, const float* Bs, int ty, int tx,
                                          float (&acc)[kTM][kTN]) {
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(As + k * AP + ty * kTM);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * BP + tx * kTN);
    const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * BP + tx * kTN + 4);
    const float av[kTM] = {a.x, a.y, a.z, a.w};
    const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// dst[c][r] = src[r][c0 + c] for r < NR, c < kK, from rows src + r * stride
// (a transposed stage; NR * kK / 4 float4 loads over the CTA)
template <int NR, int PITCH>
__device__ __forceinline__ void load_transposed(float* dst, const float* src, size_t stride,
                                                int c0, int tid) {
#pragma unroll
  for (int n = 0; n < NR * kK / 4 / kThreads; ++n) {
    const int idx = tid + n * kThreads;
    const int r = idx / (kK / 4);
    const int q = idx % (kK / 4);
    const float4 v = *reinterpret_cast<const float4*>(src + r * stride + c0 + 4 * q);
    dst[(4 * q + 0) * PITCH + r] = v.x;
    dst[(4 * q + 1) * PITCH + r] = v.y;
    dst[(4 * q + 2) * PITCH + r] = v.z;
    dst[(4 * q + 3) * PITCH + r] = v.w;
  }
}

// dst[r][c] = src[r][c] for r < kK, c < kCols, from rows src + r * stride
template <int PITCH>
__device__ __forceinline__ void load_rows(float* dst, const float* src, size_t stride, int tid) {
#pragma unroll
  for (int n = 0; n < kK * kCols / 4 / kThreads; ++n) {
    const int idx = tid + n * kThreads;
    const int r = idx / (kCols / 4);
    const int q = idx % (kCols / 4);
    *reinterpret_cast<float4*>(dst + r * PITCH + 4 * q) =
        *reinterpret_cast<const float4*>(src + r * stride + 4 * q);
  }
}

__device__ __forceinline__ void zero(float (&acc)[kTM][kTN]) {
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
}

// out rows row0 + ty*4 + i, columns tx*8 + j, row stride `stride`
__device__ __forceinline__ void store(float* out, size_t stride, int ty, int tx,
                                      const float (&acc)[kTM][kTN]) {
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float* o = out + (ty * kTM + i) * stride + tx * kTN;
    *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(o + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// sum over the 16 column-group threads (tx = lane % 16) of each row group
__device__ __forceinline__ float sum_over_tx(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// grid (n_row_blocks, H, 2 * Fp / 128)
__global__ void __launch_bounds__(kThreads)
gat_fwd_kernel(const unsigned* __restrict__ mask_bits, const int* __restrict__ colblk,
               const int* __restrict__ row_ptr, const float* __restrict__ s,
               const float* __restrict__ d, const float* __restrict__ z, float* __restrict__ o,
               float* __restrict__ den_out, float* __restrict__ m_out, int heads, int fp,
               float slope, Drop dp) {
  __shared__ unsigned bits_s[kW * kB];
  __shared__ float d_s[kB];
  __shared__ float scale_s[kRows];
  __shared__ __align__(16) float e_s[kK * kAP];    // e^T slice: [j][row]
  __shared__ __align__(16) float z_s[kK * kCols];  // z slice: [j][column]

  const int rb = blockIdx.x;
  const int h = blockIdx.y;
  const int half = blockIdx.z & 1;
  const int f0 = (blockIdx.z >> 1) * kCols;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // product layout
  const int er = tid / 4, eq = tid % 4;    // softmax layout: row er, quarter eq
  const int i_blk = half * kRows + er;     // row within the block
  const int gi = rb * kB + i_blk;          // global row
  const size_t zrow = static_cast<size_t>(heads) * fp;

  const float s_i = s[static_cast<size_t>(gi) * heads + h];
  float m_i = kNeg;   // running max of row er (each of its 4 threads holds it)
  float den_i = 0.0f;
  float acc[kTM][kTN];
  zero(acc);

  const int start = row_ptr[rb], end = row_ptr[rb + 1];
  for (int t = start; t < end; ++t) {
    const int cb = colblk[t];
    for (int idx = tid; idx < kW * kB; idx += kThreads)
      bits_s[idx] = mask_bits[static_cast<size_t>(t) * kW * kB + idx];
    for (int idx = tid; idx < kB; idx += kThreads)
      d_s[idx] = d[static_cast<size_t>(cb * kB + idx) * heads + h];
    __syncthreads();

    float tmax = kNeg;
    for (int jj = 0; jj < kB / 4; ++jj) {
      const int j = eq * (kB / 4) + jj;
      if (mask_bit(bits_s, i_blk, j)) tmax = fmaxf(tmax, leaky(s_i + d_s[j], slope));
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_i, tmax);
    const float scale = expf(m_i - m_new);
    m_i = m_new;
    if (eq == 0) scale_s[er] = scale;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float sc = scale_s[ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] *= sc;
    }

    float part = 0.0f;  // this thread's share of the tile's denominator
    const float* zt = z + static_cast<size_t>(cb) * kB * zrow + static_cast<size_t>(h) * fp + f0;
    for (int k0 = 0; k0 < kB; k0 += kK) {
#pragma unroll
      for (int u = 0; u < kK / 4; ++u) {
        const int jl = eq * (kK / 4) + u;
        const int j = k0 + jl;
        float e = 0.0f;
        if (mask_bit(bits_s, i_blk, j)) {
          e = expf(leaky(s_i + d_s[j], slope) - m_i);
          part += e;  // denominators are undropped
          if (dp.on) e *= keep_factor(dp, gi, cb * kB + j, h);
        }
        e_s[jl * kAP + er] = e;
      }
      load_rows<kCols>(z_s, zt + static_cast<size_t>(k0) * zrow, zrow, tid);
      __syncthreads();
      mma_slice<kAP, kCols>(e_s, z_s, ty, tx, acc);
      __syncthreads();
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    den_i = den_i * scale + part;
  }

  store(o + static_cast<size_t>(rb * kB + half * kRows) * zrow + static_cast<size_t>(h) * fp + f0,
        zrow, ty, tx, acc);
  if (f0 == 0 && eq == 0) {
    den_out[static_cast<size_t>(gi) * heads + h] = den_i;
    m_out[static_cast<size_t>(gi) * heads + h] = m_i;
  }
}

// grid (n_row_blocks, H, 2)
__global__ void __launch_bounds__(kThreads)
gat_bwd_row_kernel(const unsigned* __restrict__ mask_bits, const int* __restrict__ colblk,
                   const int* __restrict__ row_ptr, const float* __restrict__ s,
                   const float* __restrict__ d, const float* __restrict__ m,
                   const float* __restrict__ den, const float* __restrict__ c,
                   const float* __restrict__ z, const float* __restrict__ g,
                   float* __restrict__ ds_out, int heads, int fp, float slope, Drop dp) {
  __shared__ unsigned bits_s[kW * kB];
  __shared__ float d_s[kB];
  __shared__ float s_s[kRows], m_s[kRows], den_s[kRows], c_s[kRows];
  __shared__ __align__(16) float g_s[kK * kAP];  // g^T slice: [feature][row]
  __shared__ __align__(16) float z_s[kK * kBP];  // z^T slice: [feature][column]

  const int rb = blockIdx.x;
  const int h = blockIdx.y;
  const int half = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = rb * kB + half * kRows;  // global first row of this CTA
  const size_t zrow = static_cast<size_t>(heads) * fp;

  if (tid < kRows) {
    const size_t k = static_cast<size_t>(row0 + tid) * heads + h;
    s_s[tid] = s[k];
    m_s[tid] = m[k];
    den_s[tid] = den[k];
    c_s[tid] = c[k];
  }
  float dsp[kTM] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc[kTM][kTN];
  const float* gb = g + static_cast<size_t>(row0) * zrow + static_cast<size_t>(h) * fp;

  const int start = row_ptr[rb], end = row_ptr[rb + 1];
  for (int t = start; t < end; ++t) {
    const int cb = colblk[t];
    for (int idx = tid; idx < kW * kB; idx += kThreads)
      bits_s[idx] = mask_bits[static_cast<size_t>(t) * kW * kB + idx];
    for (int idx = tid; idx < kB; idx += kThreads)
      d_s[idx] = d[static_cast<size_t>(cb * kB + idx) * heads + h];
    // dalpha[i][j] = g_i . z_j over the whole head width
    zero(acc);
    const float* zb = z + static_cast<size_t>(cb) * kB * zrow + static_cast<size_t>(h) * fp;
    for (int c0 = 0; c0 < fp; c0 += kK) {
      load_transposed<kRows, kAP>(g_s, gb, zrow, c0, tid);
      load_transposed<kB, kBP>(z_s, zb, zrow, c0, tid);
      __syncthreads();
      mma_slice<kAP, kBP>(g_s, z_s, ty, tx, acc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = ty * kTM + i;
#pragma unroll
      for (int jj = 0; jj < kTN; ++jj) {
        const int j = tx * kTN + jj;
        if (mask_bit(bits_s, half * kRows + r, j)) {
          const float raw = s_s[r] + d_s[j];
          const float alpha = expf(leaky(raw, slope) - m_s[r]) / den_s[r];
          float da = acc[i][jj];
          if (dp.on) da *= keep_factor(dp, row0 + r, cb * kB + j, h);
          dsp[i] += alpha * (da - c_s[r]) * (raw >= 0.0f ? 1.0f : slope);
        }
      }
    }
    __syncthreads();  // bits_s and d_s are restaged by the next tile
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const float v = sum_over_tx(dsp[i]);
    if (tx == 0) ds_out[static_cast<size_t>(row0 + ty * kTM + i) * heads + h] = v;
  }
}

// shared-memory layout of gat_bwd_col_kernel, in floats
constexpr int kColBits = 0;                       // kW * kB words
constexpr int kColRowVecs = kColBits + kW * kB;   // s, m, den, c: 4 * kB
constexpr int kColD = kColRowVecs + 4 * kB;       // kRows
constexpr int kColZt = kColD + kRows;             // z^T slice: kK * kAP
constexpr int kColGt = kColZt + kK * kAP;         // g^T slice kK * kBP, then g slice kK * kCols
constexpr int kColA = kColGt + kK * kBP;          // kf*alpha: [kB rows i][kAP]
constexpr int kColSmemFloats = kColA + kB * kAP;
static_assert(kColZt % 4 == 0 && kColGt % 4 == 0 && kColA % 4 == 0, "float4 alignment");
static_assert(kCols <= kBP, "the step-C g slice must fit the g^T buffer");

// grid (n_col_blocks, H, 2 * Fp / 128); dynamic shared memory kColSmemFloats
__global__ void __launch_bounds__(kThreads)
gat_bwd_col_kernel(const unsigned* __restrict__ mask_bits_t, const int* __restrict__ rowblk_t,
                   const int* __restrict__ col_ptr_t, const float* __restrict__ s,
                   const float* __restrict__ d, const float* __restrict__ m,
                   const float* __restrict__ den, const float* __restrict__ c,
                   const float* __restrict__ z, const float* __restrict__ g,
                   float* __restrict__ dz_out, float* __restrict__ dd_out, int heads, int fp,
                   float slope, Drop dp) {
  extern __shared__ __align__(16) float smem[];
  unsigned* bits_s = reinterpret_cast<unsigned*>(smem + kColBits);
  float* s_s = smem + kColRowVecs;
  float* m_s = s_s + kB;
  float* den_s = m_s + kB;
  float* c_s = den_s + kB;
  float* d_s = smem + kColD;
  float* zt_s = smem + kColZt;
  float* gt_s = smem + kColGt;
  float* a_s = smem + kColA;

  const int cb = blockIdx.x;
  const int h = blockIdx.y;
  const int half = blockIdx.z & 1;
  const int f0 = (blockIdx.z >> 1) * kCols;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int col0 = cb * kB + half * kRows;  // global first column (node) of this CTA
  const size_t zrow = static_cast<size_t>(heads) * fp;

  if (tid < kRows) d_s[tid] = d[static_cast<size_t>(col0 + tid) * heads + h];
  float ddp[kTM] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc[kTM][kTN];   // dalpha^T of one tile: [column jl][row i]
  float acc2[kTM][kTN];  // dz: [column jl][feature f0 + ...]
  zero(acc2);
  const float* zb = z + static_cast<size_t>(col0) * zrow + static_cast<size_t>(h) * fp;

  const int start = col_ptr_t[cb], end = col_ptr_t[cb + 1];
  for (int t = start; t < end; ++t) {
    const int rb = rowblk_t[t];
    for (int idx = tid; idx < kW * kB; idx += kThreads)
      bits_s[idx] = mask_bits_t[static_cast<size_t>(t) * kW * kB + idx];
    for (int idx = tid; idx < kB; idx += kThreads) {
      const size_t k = static_cast<size_t>(rb * kB + idx) * heads + h;
      s_s[idx] = s[k];
      m_s[idx] = m[k];
      den_s[idx] = den[k];
      c_s[idx] = c[k];
    }
    const float* gb = g + static_cast<size_t>(rb) * kB * zrow + static_cast<size_t>(h) * fp;
    // step A: acc[jl][i] = z_j . g_i over the whole head width
    zero(acc);
    for (int c0 = 0; c0 < fp; c0 += kK) {
      load_transposed<kRows, kAP>(zt_s, zb, zrow, c0, tid);
      load_transposed<kB, kBP>(gt_s, gb, zrow, c0, tid);
      __syncthreads();
      mma_slice<kAP, kBP>(zt_s, gt_s, ty, tx, acc);
      __syncthreads();
    }
    // step B: draw into dd, kf*alpha into a_s[i][jl]
#pragma unroll
    for (int jj = 0; jj < kTM; ++jj) {
      const int jl = ty * kTM + jj;
#pragma unroll
      for (int ii = 0; ii < kTN; ++ii) {
        const int i = tx * kTN + ii;
        float a = 0.0f;
        if (mask_bit(bits_s, i, half * kRows + jl)) {
          const float raw = s_s[i] + d_s[jl];
          const float alpha = expf(leaky(raw, slope) - m_s[i]) / den_s[i];
          const float kf = dp.on ? keep_factor(dp, rb * kB + i, col0 + jl, h) : 1.0f;
          ddp[jj] += alpha * (acc[jj][ii] * kf - c_s[i]) * (raw >= 0.0f ? 1.0f : slope);
          a = alpha * kf;
        }
        a_s[i * kAP + jl] = a;
      }
    }
    __syncthreads();
    // step C: acc2[jl][f] += sum_i a_s[i][jl] * g[rb*kB + i][f0 + f]
    for (int i0 = 0; i0 < kB; i0 += kK) {
      load_rows<kCols>(gt_s, gb + static_cast<size_t>(i0) * zrow + f0, zrow, tid);
      __syncthreads();
      mma_slice<kAP, kCols>(a_s + i0 * kAP, gt_s, ty, tx, acc2);
      __syncthreads();
    }
  }

  store(dz_out + static_cast<size_t>(col0) * zrow + static_cast<size_t>(h) * fp + f0, zrow, ty,
        tx, acc2);
  if (f0 == 0) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float v = sum_over_tx(ddp[i]);
      if (tx == 0) dd_out[static_cast<size_t>(col0 + ty * kTM + i) * heads + h] = v;
    }
  }
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

}  // namespace

// C entries. Each launches on `stream` and returns cudaGetLastError() as an
// int (0 = launched); a refused launch never runs.

extern "C" int gat_tile_fwd_f32(const unsigned* mask_bits, const int* colblk, const int* row_ptr,
                                const float* s, const float* d, const float* z, float* o,
                                float* den, float* m, int n_row_blocks, int heads, int fp,
                                float slope, int dropout, unsigned seed, unsigned keep_thr,
                                float keep_scale, unsigned n_cols, unsigned head_stride,
                                void* stream) {
  if (bad_shape(n_row_blocks, heads, fp)) return static_cast<int>(cudaErrorInvalidValue);
  const Drop dp = make_drop(dropout, seed, keep_thr, keep_scale, n_cols, head_stride);
  const dim3 grid(n_row_blocks, heads, 2 * (fp / kCols));
  gat_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mask_bits, colblk, row_ptr, s, d, z, o, den, m, heads, fp, slope, dp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gat_tile_bwd_row_f32(const unsigned* mask_bits, const int* colblk,
                                    const int* row_ptr, const float* s, const float* d,
                                    const float* m, const float* den, const float* c,
                                    const float* z, const float* g, float* ds, int n_row_blocks,
                                    int heads, int fp, float slope, int dropout, unsigned seed,
                                    unsigned keep_thr, float keep_scale, unsigned n_cols,
                                    unsigned head_stride, void* stream) {
  if (bad_shape(n_row_blocks, heads, fp)) return static_cast<int>(cudaErrorInvalidValue);
  const Drop dp = make_drop(dropout, seed, keep_thr, keep_scale, n_cols, head_stride);
  const dim3 grid(n_row_blocks, heads, 2);
  gat_bwd_row_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mask_bits, colblk, row_ptr, s, d, m, den, c, z, g, ds, heads, fp, slope, dp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gat_tile_bwd_col_f32(const unsigned* mask_bits_t, const int* rowblk_t,
                                    const int* col_ptr_t, const float* s, const float* d,
                                    const float* m, const float* den, const float* c,
                                    const float* z, const float* g, float* dz, float* dd,
                                    int n_col_blocks, int heads, int fp, float slope, int dropout,
                                    unsigned seed, unsigned keep_thr, float keep_scale,
                                    unsigned n_cols, unsigned head_stride, void* stream) {
  if (bad_shape(n_col_blocks, heads, fp)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kColSmemFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(gat_bwd_col_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Drop dp = make_drop(dropout, seed, keep_thr, keep_scale, n_cols, head_stride);
  const dim3 grid(n_col_blocks, heads, 2 * (fp / kCols));
  gat_bwd_col_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      mask_bits_t, rowblk_t, col_ptr_t, s, d, m, den, c, z, g, dz, dd, heads, fp, slope, dp);
  return static_cast<int>(cudaGetLastError());
}
