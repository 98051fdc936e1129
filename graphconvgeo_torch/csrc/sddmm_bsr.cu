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
//   its fill, so what bounds it is the tensor cores' rate. The JAX kernel
//   asks the MXU for Precision.HIGHEST, float32 accuracy from bf16 passes;
//   Hopper's counterpart is 3xTF32: each operand value x splits into
//   hi = tf32_rna(x) and lo = tf32_rna(x - hi), and lo*hi + hi*lo + hi*hi
//   accumulate in float32 on the tensor cores (one TF32 product keeps about
//   three decimal digits; the three keep about float32's, lo*lo dropped).
//   Bound: three TF32 products at 495 TFLOP/s. The design: one CTA of 8
//   warps per (tile, 128 x 128 output block), each warp a 64 x 32 piece of
//   it, mma.sync m16n8k8 tf32 (row.col) through inline PTX. h1 and h2 are
//   row-major [rows, F], K-major for both operands: 32-deep k-stages of the
//   block's 128 rows of each are copied by cp.async (16 bytes a thread) into
//   a 3-stage ring in shared memory, rows padded to a pitch of 36 floats so
//   the fragment loads hit 32 distinct banks; the hi/lo split is formed as
//   the fragments are loaded. cp.async's source size zero-fills the k tail
//   past F and the rows past n1 / n2, so h1 and h2 are read in place,
//   unpadded (F % 4 == 0, 16-byte aligned), and the k loop stops at
//   ceil(F/8)*8 columns. The epilogue goes through shared memory and stores
//   each 64 KB block with coalesced 16-byte evict-first stores (__stcs: the
//   layout is a write stream). Tile 0 is written as zeros. No atomics, no
//   state between CTAs. wgmma (B's hi and lo in shared memory behind
//   descriptors) is the lever left if this stays above half its bound.
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

// ---- every entry a score: the dense-tile NT product, 3xTF32 ---------------
constexpr int kThreads = 256;
constexpr int kBS = 128;             // output rows and columns per CTA
constexpr int kBK = 32;              // contraction depth per stage
constexpr int kPitch = kBK + 4;      // floats per staged row: conflict-free fragment loads
constexpr int kStages = 3;           // cp.async ring depth
constexpr int kStageFloats = 2 * kBS * kPitch;  // one stage: 128 rows of h1, 128 of h2
constexpr int kCPitch = kBS + 8;     // floats per row of the staged output block
constexpr int kSmemBytes = kStages * kStageFloats * 4;  // 110,592 bytes
static_assert(kBS * kCPitch <= kStages * kStageFloats, "the output block fits the ring");

__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about float32's precision, both TF32
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from src to shared dst; only src_bytes (0 or 16) are read, the
// rest is zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage k-columns [k0, k0 + 32) of the block's 128 rows of h1 and of h2:
// 2 x 1024 16-byte copies, 8 a thread; rows past n (or columns past f)
// zero-filled. a_row0 / b_row0 are the block's first global rows.
__device__ __forceinline__ void load_stage(float* st, const float* __restrict__ h1,
                                           const float* __restrict__ h2, long long a_row0,
                                           long long b_row0, int n1, int n2, int f, int k0,
                                           int tid) {
#pragma unroll
  for (int i = 0; i < kBS * kBK / 4 / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / (kBK / 4);
    const int q = idx % (kBK / 4);
    const int k = k0 + 4 * q;
    const long long ra = a_row0 + r, rb = b_row0 + r;
    const bool ka = k < f;
    const bool va = ka && ra < n1, vb = ka && rb < n2;
    cp_async16(st + r * kPitch + 4 * q, va ? h1 + ra * f + k : h1, va ? 16 : 0);
    cp_async16(st + (kBS + r) * kPitch + 4 * q, vb ? h2 + rb * f + k : h2, vb ? 16 : 0);
  }
}

// grid (n_tiles, (B / 128)^2); dynamic shared memory kSmemBytes
template <int B>
__global__ void __launch_bounds__(kThreads, 2)
sddmm_dense_kernel(const float* __restrict__ h1,
                   const float* __restrict__ h2,
                   const int* __restrict__ trow,
                   const int* __restrict__ tcol,
                   float* __restrict__ out,
                   int f,
                   int n1,
                   int n2) {
  constexpr int kSub = B / kBS;
  extern __shared__ __align__(16) float smem[];

  const int t = blockIdx.x;
  const int i0 = (blockIdx.y / kSub) * kBS;
  const int j0 = (blockIdx.y % kSub) * kBS;
  const int tid = threadIdx.x;
  float* ob = out + static_cast<size_t>(t) * B * B + static_cast<size_t>(i0) * B + j0;

  if (t == 0) {  // the zero padding tile (uniform across the CTA)
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int idx = tid; idx < kBS * kBS / 4; idx += kThreads)
      __stcs(reinterpret_cast<float4*>(ob + static_cast<size_t>(idx / (kBS / 4)) * B) + idx % (kBS / 4), zero);
    return;
  }

  const long long a_row0 = static_cast<long long>(trow[t]) * B + i0;
  const long long b_row0 = static_cast<long long>(tcol[t]) * B + j0;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;  // the fragments' groupID, threadID_in_group
  const int wm = (warp & 1) * 64;         // the warp's 64 rows
  const int wn = (warp >> 1) * 32;        // and 32 columns of the block

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  const int n_k = (f + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load_stage(smem + s * kStageFloats, h1, h2, a_row0, b_row0, n1, n2, f, s * kBK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed; every warp is done with stage kt - 1
    const int next = kt + kStages - 1;
    if (next < n_k)
      load_stage(smem + (next % kStages) * kStageFloats, h1, h2, a_row0, b_row0, n1, n2, f,
                 next * kBK, tid);
    cp_async_commit();

    const float* as = smem + (kt % kStages) * kStageFloats;
    const float* bs = as + kBS * kPitch;
    const int steps = min(kBK / 8, (f - kt * kBK + 7) / 8);  // ceil(F/8)*8 columns in all
    for (int ks = 0; ks < steps; ++ks) {
      const int kc = ks * 8 + q;
      unsigned b_hi[4][2], b_lo[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* br = bs + (wn + nt * 8 + g) * kPitch + kc;
        split(br[0], b_hi[nt][0], b_lo[nt][0]);
        split(br[4], b_hi[nt][1], b_lo[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float* ar = as + (wm + mt * 16 + g) * kPitch + kc;
        unsigned a_hi[4], a_lo[4];
        split(ar[0], a_hi[0], a_lo[0]);
        split(ar[8 * kPitch], a_hi[1], a_lo[1]);
        split(ar[4], a_hi[2], a_lo[2]);
        split(ar[8 * kPitch + 4], a_hi[3], a_lo[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(acc[mt][nt], a_lo, b_hi[nt]);
          mma_tf32(acc[mt][nt], a_hi, b_lo[nt]);
          mma_tf32(acc[mt][nt], a_hi, b_hi[nt]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the block's 128 x 128 scores there

  float* cs = smem;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = wm + mt * 16 + g, c = wn + nt * 8 + 2 * q;
      *reinterpret_cast<float2*>(cs + r * kCPitch + c) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(cs + (r + 8) * kCPitch + c) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
#pragma unroll 4
  for (int idx = tid; idx < kBS * kBS / 4; idx += kThreads) {
    const int r = idx / (kBS / 4), c4 = idx % (kBS / 4);
    __stcs(reinterpret_cast<float4*>(ob + static_cast<size_t>(r) * B) + c4,
           *reinterpret_cast<const float4*>(cs + r * kCPitch + 4 * c4));
  }
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
// per-tile h1[trow[t]] @ h2[tcol[t]]^T over f columns, h1 [n1, f] and
// h2 [n2, f] row-major, read in place (rows at or past n1 / n2 read as
// zero). Takes f % 4 == 0 and 16-byte aligned h1 and h2. Returns the
// launch's cudaGetLastError() as an int.
extern "C" int sddmm_bsr_dense_f32(const float* h1, const float* h2, const int* trow,
                                   const int* tcol, float* out, int n_tiles, int block, int f,
                                   int n1, int n2, void* stream) {
  if (n_tiles <= 0 || f <= 0 || f % 4 != 0 || n1 < 0 || n2 < 0 ||
      reinterpret_cast<size_t>(h1) % 16 != 0 || reinterpret_cast<size_t>(h2) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (block != 128 && block != 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = block == 256 ? sddmm_dense_kernel<256> : sddmm_dense_kernel<128>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_tiles, (block / kBS) * (block / kBS));
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(h1, h2, trow, tcol, out,
                                                                           f, n1, n2);
  return static_cast<int>(cudaGetLastError());
}
