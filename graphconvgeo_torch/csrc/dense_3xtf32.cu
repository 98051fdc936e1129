// Dense products on Hopper's tensor cores in 3xTF32 (sm_90a), float32 out.
//
// Replaces no TPU kernel: the JAX package leaves the model's dense products
// (the conv and gate products h @ w, the head h @ w_out, the input slab's
// slab @ W0[cols]) to XLA at float32 precision. On the H100 cuBLAS runs them
// on the FFMA units (67 TFLOP/s); the tensor cores give 495 TFLOP/s in TF32,
// which keeps only 10 mantissa bits. 3xTF32 keeps float32's accuracy: each
// float32 operand value x splits into hi = tf32_rna(x) and lo =
// tf32_rna(x - hi), and lo*hi + hi*lo + hi*hi accumulate in float32 on the
// tensor cores (lo*lo dropped), as csrc/sddmm_bsr.cu's sddmm_dense_kernel
// does with mma.sync. A bf16 operand is exact in TF32 and has no lo part,
// so the terms follow the dtypes: 3 for f32.f32, 2 for bf16.f32, 1 for
// bf16.bf16. Bound: those TF32 products at 495 TFLOP/s.
//
// Three products, for C = A @ B with A [M, K] the large operand (M rows,
// 10^4..10^6) and B [K, N] a weight (at most a few MB):
//
// * nn and nt (rows_kernel): C [M, N] = A @ W, W either B or, for the input
//   gradient, the transpose of the forward's weight. TF32 wgmma takes only
//   K-major operands from shared memory, so a pre-pass (split_weight_kernel)
//   writes W once per call as K-major W_hi and W_lo [N, Kp] (Kp = K rounded
//   up to 32; bf16 W: W_hi alone), with the contraction index permuted
//   inside each 32-block to match the A fragments below. The kernel is
//   persistent (one CTA an SM walks over 128 x BN output tiles, the N-tiles
//   of one row block on neighbouring CTAs, so A is read from device memory
//   about once), warp-specialised: one thread of a producer warpgroup keeps
//   a ring of stages in flight with TMA (A [128, 32] f32 with the 128-byte swizzle or
//   bf16 with the 64-byte one, W_hi and W_lo [BN, 32] with the 128-byte
//   swizzle), two consumer warpgroups run wgmma m64nBNk8 with A from
//   registers (the RS form): each thread reads the 8 consecutive values its
//   fragments need of each of its two rows (16-byte loads, conflict-free
//   under the swizzle), splits them into hi and lo there, and issues lo*hi,
//   hi*lo, hi*hi for each 8-deep step. The output goes from the
//   accumulators straight to device memory.
// * tn (tn_kernel + reduce_kernel): the weight gradient dW [K, N] = A^T @ G
//   sums over M = 10^4..10^6 rows, and A [M, K] and G [M, N] are both
//   MN-major. A's tile [32 rows, 128 columns] comes by TMA into shared memory
//   (128-byte swizzle) and each thread gathers its fragments from it
//   (transposed reads), so A^T enters the wgmma from registers; G's tile
//   [32, BN] comes unswizzled and three warps of the producer warpgroup
//   transpose it into K-major G_hi and G_lo (double-buffered) for the wgmma
//   to read. The M rows
//   are split over the SMs (split-K): each CTA writes its partial [128, BN]
//   tile into a workspace [S, K, N], and reduce_kernel adds the S partials in
//   a fixed order, so two calls give bitwise equal results (no atomics).
//
// The tensor cores add each step's products into the accumulator truncated,
// not rounded, so a long chain drifts (at K 900 about 6x torch.matmul's
// float32 error, measured on an H100). A chain of about 24 products (2
// stages of 3 terms, 3 of 2, 6 of 1) starts from zero in registers of its
// own and is then added, rounded to nearest, into the float32 sum: two
// accumulators a thread (setmaxnreg gives the consumers the producer
// warpgroup's registers), which sets the tile width. The N-tile BN (the wgmma's N) is chosen by the caller from the
// output width among 64, 128, 152 and 160 (900 columns: 6 x 152,
// 930: 6 x 160, 640: 4 x 160), which wastes 1-3% of the work where a 128-
// or 256-wide tile wastes 12-14%.
// TMA zero-fills the rows and columns past the operands' ends, the stores
// are masked, so every operand is read in place: the caller passes A with
// 16-byte aligned rows and base.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBM = 128;                 // output rows a tile: two warpgroups of 64
constexpr int kBK = 32;                  // contraction depth a stage: 128 bytes of f32
constexpr int kConsumers = 256;          // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup (one thread loads)
// setmaxnreg: the producer warpgroup gives registers to the consumers' two
// accumulators. A block starts at 168 a thread (65,536 over 384, in 8s), and
// the consumers can take only what the producer gave up.
constexpr int kLaunchRegs = 168;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert((kLaunchRegs - kProducerRegs) * 128 >= (kConsumerRegs - kLaunchRegs) * kConsumers,
              "the consumers take more registers than the producer gives up");
constexpr int kSmemMax = 232448;         // an H100 block's dynamic shared memory
constexpr int kAlign = 1024;             // the 128-byte swizzle's period

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Traps rather than hang if the phase has not completed after about ten
// seconds (a lost TMA or a miscounted arrival).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    if (clock64() - start > 20000000000LL) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void give_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void take_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Pins registers that an in-flight wgmma reads or writes: the compiler may
// neither move them nor reuse them before this point.
template <int R>
__device__ __forceinline__ void keep(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void keep(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// K-major operand in shared memory with the 128-byte swizzle: 8-row groups
// 1,024 bytes apart; a k8 step further along the row adds 32 bytes (2 in
// the descriptor's address field).
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  return ((static_cast<uint64_t>(smem_u32(p)) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about float32's precision, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t b) { return __uint_as_float(b << 16); }

// wgmma m64nNk8 .tf32 with A from registers, accumulating into d unless
// scale_d is 0: one specialisation a N-tile, since the instruction names
// each of its N / 2 accumulator registers
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<152> {
  static __device__ __forceinline__ void mma(float (&d)[76], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %81, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n152k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75"
        "}, {%76, %77, %78, %79}, %80, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<160> {
  static __device__ __forceinline__ void mma(float (&d)[80], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
        "}, {%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};


// ---- A's tiles in shared memory, by dtype ----------------------------------
// rows_kernel's A tile [128 rows, 32 columns]: float32 rows of 128 bytes under
// the 128-byte swizzle, bf16 rows of 64 bytes under the 64-byte one (16-byte
// chunk c of row r lies at chunk c ^ (r % 8), resp. c ^ ((r / 2) % 4)).
// load_row8 gives A[r][8q .. 8q + 7] as float32: the two (one) 16-byte
// chunks of a quarter-warp's 8 lanes fall in 32 distinct banks.
template <typename TA>
struct RowTile;

template <>
struct RowTile<float> {
  static constexpr int kBytes = kBM * kBK * 4;
  static __device__ __forceinline__ void load_row8(const uint8_t* t, int r, int q, float (&x)[8]) {
    const uint8_t* row = t + r * 128;
    const float4 u = *reinterpret_cast<const float4*>(row + (((2 * q) ^ (r & 7)) << 4));
    const float4 v = *reinterpret_cast<const float4*>(row + (((2 * q + 1) ^ (r & 7)) << 4));
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
    x[4] = v.x; x[5] = v.y; x[6] = v.z; x[7] = v.w;
  }
};

template <>
struct RowTile<__nv_bfloat16> {
  static constexpr int kBytes = kBM * kBK * 2;
  static __device__ __forceinline__ void load_row8(const uint8_t* t, int r, int q, float (&x)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(t + r * 64 + ((q ^ ((r >> 1) & 3)) << 4));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = bf16_bits_to_float(w[i] & 0xFFFFu);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};

// tn_kernel's A tile [32 rows, 128 columns]: boxes of [32 rows, 128 bytes]
// (32 float32 or 64 bf16 columns) 4,096 bytes apart, each under the 128-byte
// swizzle. at(r, k) reads A[r][k] as float32.
template <typename TA>
struct ColTile;

template <>
struct ColTile<float> {
  static constexpr int kBox = 32;  // columns a box
  static constexpr int kBytes = kBK * kBM * 4;
  static __device__ __forceinline__ float at(const uint8_t* t, int r, int k) {
    const int kk = k & 31;
    return *reinterpret_cast<const float*>(t + (k >> 5) * 4096 + r * 128 +
                                           ((((kk >> 2) ^ (r & 7)) << 4) | ((kk & 3) << 2)));
  }
};

template <>
struct ColTile<__nv_bfloat16> {
  static constexpr int kBox = 64;
  static constexpr int kBytes = kBK * kBM * 2;
  static __device__ __forceinline__ float at(const uint8_t* t, int r, int k) {
    const int kk = k & 63;
    const uint16_t b = *reinterpret_cast<const uint16_t*>(
        t + (k >> 6) * 4096 + r * 128 + ((((kk >> 3) ^ (r & 7)) << 4) | ((kk & 7) << 1)));
    return bf16_bits_to_float(b);
  }
};

// The contraction order inside a 32-block: step j (0..3) of 8 reads, at its
// position jj (0..7), the original index perm(j, jj). A thread of fragment
// column q holds A[r][8q + j] at column q and A[r][8q + 4 + j] at q + 4 of
// step j (rows_kernel); tn_kernel's fragments take rows 8j + 2q and
// 8j + 2q + 1 of its 32 (conflict-free gathers): position jj of step j is
// row 8j + 2jj (jj < 4) or 8j + 2(jj - 4) + 1. The other operand is laid out
// in the same order (split_weight_kernel, transpose_g).
__device__ __forceinline__ int rows_perm(int j, int jj) { return jj < 4 ? 8 * jj + j : 8 * (jj - 4) + 4 + j; }

__device__ __forceinline__ void store2(float* __restrict__ c, long long row, int col, float v0, float v1,
                                       int m_rows, int n, bool vec2) {
  if (row >= m_rows) return;
  float* p = c + row * n + col;
  if (vec2 && col + 1 < n) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (col < n) p[0] = v0;
    if (col + 1 < n) p[1] = v1;
  }
}

// ---- nn / nt: C [M, N] = A [M, K] @ W, W given split as W_hi, W_lo [N, Kp] -----
// grid min(tiles, SMs), kThreads threads, dynamic shared memory
// kAlign + stages * (A tile + W_hi tile [+ W_lo tile]) + barriers
template <int BN, typename TA>
__global__ void __launch_bounds__(kThreads, 1)
rows_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_wh,
            const __grid_constant__ CUtensorMap map_wl, float* __restrict__ c, int m_rows, int n,
            int k_tiles, int n_tiles, int tiles, int stages, int w_lo, int chain_tiles) {
  constexpr bool kSplitA = sizeof(TA) == 4;  // a bf16 A is exact in TF32
  constexpr int kA = RowTile<TA>::kBytes;
  constexpr int kW = BN * kBK * 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  const int stage_bytes = kA + (w_lo ? 2 : 1) * kW;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * stage_bytes);
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup
    give_regs<kProducerRegs>();
    if (warp == kConsumers / 32 && lane == 0) {
      int st = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / n_tiles) * kBM, n0 = (t % n_tiles) * BN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[st], phase ^ 1);
          uint8_t* s = smem + st * stage_bytes;
          mbar_expect_tx(&full[st], stage_bytes);
          tma_load(s, &map_a, &full[st], kt * kBK, m0);
          tma_load(s + kA, &map_wh, &full[st], kt * kBK, n0);
          if (w_lo) tma_load(s + kA + kW, &map_wl, &full[st], kt * kBK, n0);
          if (++st == stages) {
            st = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  take_regs<kConsumerRegs>();
  const int g = lane >> 2, q = lane & 3;
  const int r0 = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // the thread's rows r0 and r0 + 8
  const bool vec2 = (n & 1) == 0;
  float acc[BN / 2], part[BN / 2];
  uint32_t ah[2][4], al[2][4];
  int st = 0, pend = -1, in_chain = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / n_tiles) * kBM, n0 = (t % n_tiles) * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      mbar_wait(&full[st], phase);
      const uint8_t* s = smem + st * stage_bytes;
      float x0[8], x1[8];
      RowTile<TA>::load_row8(s, r0, q, x0);
      RowTile<TA>::load_row8(s, r0 + 8, q, x1);
      const uint64_t dh = kmajor_desc(s + kA), dl = kmajor_desc(s + kA + kW);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t(&h)[4] = ah[j & 1];
        uint32_t(&l)[4] = al[j & 1];
        // two steps in flight: the one two before this step is done, so
        // its fragments are free, and at step 1 the stage before this one
        wg_wait<1>();
        keep(h);
        keep(l);
        if (j == 1 && pend >= 0) {
          mbar_arrive(&empty[pend]);
          pend = -1;
        }
        if (kSplitA) {
          split(x0[j], h[0], l[0]);
          split(x1[j], h[1], l[1]);
          split(x0[4 + j], h[2], l[2]);
          split(x1[4 + j], h[3], l[3]);
        } else {
          h[0] = __float_as_uint(x0[j]);
          h[1] = __float_as_uint(x1[j]);
          h[2] = __float_as_uint(x0[4 + j]);
          h[3] = __float_as_uint(x1[4 + j]);
        }
        wg_fence();
        // a chain starts from zero: its first product does not add to part
        const int more = in_chain > 0 || j > 0;
        if (kSplitA) Wgmma<BN>::mma(part, l, dh + 2 * j, more);
        if (w_lo) Wgmma<BN>::mma(part, h, dl + 2 * j, kSplitA || more);
        Wgmma<BN>::mma(part, h, dh + 2 * j, kSplitA || w_lo || more);
        wg_commit();
      }
      pend = st;
      if (++st == stages) {
        st = 0;
        phase ^= 1;
      }
      // The tensor cores add each step's products to part truncated; a chain
      // of chain_tiles stages stays short, and acc takes it rounded to nearest.
      if (++in_chain == chain_tiles || kt + 1 == k_tiles) {
        wg_wait<0>();
        keep(part);
        mbar_arrive(&empty[pend]);
        pend = -1;
        in_chain = 0;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
      }
    }
    keep(ah[0]);
    keep(ah[1]);
    keep(al[0]);
    keep(al[1]);
    const long long row = m0 + r0;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * q;
      store2(c, row, col, acc[4 * i], acc[4 * i + 1], m_rows, n, vec2);
      store2(c, row + 8, col, acc[4 * i + 2], acc[4 * i + 3], m_rows, n, vec2);
    }
  }
}

// ---- tn: part[s] [K, N] = A[rows of split s]^T @ G[rows of split s] ---------
// grid (K tiles x N tiles, splits), kThreads threads, dynamic shared memory
// kAlign + 2 x (G_hi + G_lo tiles) + stages x (A tile + G tile) + barriers.
// Warp 8 loads the ring by TMA; warps 9-11 transpose each stage's G into the
// next free G_hi / G_lo pair; the consumers gather A's fragments and run the
// products, as rows_kernel's do.
constexpr int kTransposers = 96;          // warps 9-11
constexpr int kTnProducerRegs = 48;       // the loader and the transposers
constexpr int kTnConsumerRegs = 224;
static_assert((kLaunchRegs - kTnProducerRegs) * 128 >= (kTnConsumerRegs - kLaunchRegs) * kConsumers,
              "the consumers take more registers than the producer gives up");

// G's tile [32 rows, BN] into K-major G_hi, G_lo [BN, 32] (128-byte swizzle,
// tn_kernel's order): a task is one 16-byte chunk ch of a row nn of each, the
// rows 8 (ch / 2) + 2i + ch % 2 of G (i = 0..3)
template <int BN>
__device__ __forceinline__ void transpose_g(const float* __restrict__ graw, uint8_t* ghi, uint8_t* glo,
                                            int tid) {
  for (int task = tid; task < BN * 8; task += kTransposers) {
    const int nn = task % BN, ch = task / BN;
    const int j = ch >> 1, odd = ch & 1;
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(graw[(8 * j + 2 * i + odd) * BN + nn], h[i], l[i]);
    const int off = nn * 128 + ((ch ^ (nn & 7)) << 4);
    *reinterpret_cast<uint4*>(ghi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(glo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

template <int BN, typename TA>
__global__ void __launch_bounds__(kThreads, 1)
tn_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_g,
          float* __restrict__ part, int k_out, int n, int m_rows, int rows_per_split, int n_tiles,
          int stages, int chain_tiles) {
  constexpr bool kSplitA = sizeof(TA) == 4;
  constexpr int kA = ColTile<TA>::kBytes;
  constexpr int kG = BN * kBK * 4;      // one tile of G, of G_hi or of G_lo
  constexpr int kHiLo = 2 * kG;          // G_hi and G_lo of one tile
  constexpr int kRaw = kA + kG;          // a stage of the ring
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  uint8_t* ring = smem + 2 * kHiLo;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * kRaw);
  uint64_t* empty = full + stages;      // every consumer thread and each transposer warp
  uint64_t* tfull = empty + stages;     // a G_hi / G_lo pair written (transposer warps)
  uint64_t* tempty = tfull + 2;         // ... and read by both warpgroups' products (every thread)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = (blockIdx.x / n_tiles) * kBM, n0 = (blockIdx.x % n_tiles) * BN;
  const int m_lo = blockIdx.y * rows_per_split;
  const int k_tiles = (min(m_rows, m_lo + rows_per_split) - m_lo + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers + kTransposers / 32);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&tfull[b], kTransposers / 32);
      mbar_init(&tempty[b], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup
    give_regs<kTnProducerRegs>();
    int st = 0;
    uint32_t phase = 0;
    if (warp == kConsumers / 32) {  // the loader
      if (lane == 0) {
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[st], phase ^ 1);
          uint8_t* s = ring + st * kRaw;
          const int row = m_lo + kt * kBK;
          mbar_expect_tx(&full[st], kRaw);
#pragma unroll
          for (int b = 0; b < kBM / ColTile<TA>::kBox; ++b)
            tma_load(s + b * 4096, &map_a, &full[st], k0 + b * ColTile<TA>::kBox, row);
          tma_load(s + kA, &map_g, &full[st], n0, row);
          if (++st == stages) {
            st = 0;
            phase ^= 1;
          }
        }
      }
      return;
    }
    const int tid = threadIdx.x - kConsumers - 32;  // the transposers
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int b = kt & 1;
      mbar_wait(&tempty[b], ((kt >> 1) & 1) ^ 1);
      mbar_wait(&full[st], phase);
      uint8_t* hilo = smem + b * kHiLo;
      transpose_g<BN>(reinterpret_cast<const float*>(ring + st * kRaw + kA), hilo, hilo + kG, tid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&tfull[b]);
        mbar_arrive(&empty[st]);
      }
      if (++st == stages) {
        st = 0;
        phase ^= 1;
      }
    }
    return;
  }

  take_regs<kTnConsumerRegs>();
  const int g = lane >> 2, q = lane & 3;
  const int r0 = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // output rows r0 and r0 + 8 of the tile
  float acc[BN / 2], chain[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t ah[2][4], al[2][4];
  int st = 0, in_chain = 0, pend = -1;
  uint32_t phase = 0;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int b = kt & 1;
    mbar_wait(&full[st], phase);
    mbar_wait(&tfull[b], (kt >> 1) & 1);
    const uint8_t* s = ring + st * kRaw;
    const uint8_t* hilo = smem + b * kHiLo;
    const uint64_t dh = kmajor_desc(hilo), dl = kmajor_desc(hilo + kG);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t(&h)[4] = ah[j & 1];
      uint32_t(&l)[4] = al[j & 1];
      wg_wait<1>();  // two steps in flight, as in rows_kernel
      keep(h);
      keep(l);
      if (j == 1 && pend >= 0) {  // the previous tile's products are done
        mbar_arrive(&tempty[pend]);
        pend = -1;
      }
      const int ra = 8 * j + 2 * q;
      const float x[4] = {ColTile<TA>::at(s, ra, r0), ColTile<TA>::at(s, ra, r0 + 8),
                          ColTile<TA>::at(s, ra + 1, r0), ColTile<TA>::at(s, ra + 1, r0 + 8)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kSplitA) {
          split(x[i], h[i], l[i]);
        } else {
          h[i] = __float_as_uint(x[i]);
        }
      }
      wg_fence();
      const int more = in_chain > 0 || j > 0;
      if (kSplitA) Wgmma<BN>::mma(chain, l, dh + 2 * j, more);
      Wgmma<BN>::mma(chain, h, dl + 2 * j, kSplitA || more);
      Wgmma<BN>::mma(chain, h, dh + 2 * j, 1);
      wg_commit();
    }
    mbar_arrive(&empty[st]);  // the stage's A is in registers
    pend = b;
    if (++st == stages) {
      st = 0;
      phase ^= 1;
    }
    // a chain of chain_tiles stages, added to acc rounded to nearest (rows_kernel)
    if (++in_chain == chain_tiles || kt + 1 == k_tiles) {
      wg_wait<0>();
      keep(chain);
      mbar_arrive(&tempty[pend]);
      pend = -1;
      in_chain = 0;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += chain[i];
    }
  }
  keep(ah[0]);
  keep(ah[1]);
  keep(al[0]);
  keep(al[1]);
  float* out = part + static_cast<long long>(blockIdx.y) * k_out * n;
  const bool vec2 = (n & 1) == 0;
  const long long row = k0 + r0;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = n0 + 8 * i + 2 * q;
    store2(out, row, col, acc[4 * i], acc[4 * i + 1], k_out, n, vec2);
    store2(out, row + 8, col, acc[4 * i + 2], acc[4 * i + 3], k_out, n, vec2);
  }
}

// out[i] = part[0][i] + part[1][i] + ... in that order
__global__ void reduce_kernel(const float* __restrict__ part, float* __restrict__ out, long long count,
                              int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int p = 1; p < splits; ++p) s += part[p * count + i];
    out[i] = s;
  }
}

// W_hi, W_lo [no, kp] (K-major, rows_perm's order in each 32-block, zero past
// kc) of the logical weight W [kc, no] whose element (c, o) is w[c * s_c +
// o * s_o]; lo is skipped where it is null (a bf16 W is exact in TF32)
template <typename T>
__global__ void split_weight_kernel(const T* __restrict__ w, long long s_c, long long s_o, int kc, int no,
                                    int kp, float* __restrict__ hi, float* __restrict__ lo) {
  const long long count = static_cast<long long>(no) * kp;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; idx < count;
       idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int o = static_cast<int>(idx / kp), p = static_cast<int>(idx % kp);
    const int c = (p & ~31) + rows_perm((p & 31) >> 3, p & 7);
    float v = 0.f;
    if (c < kc) {
      if constexpr (sizeof(T) == 4) {
        v = w[c * s_c + o * s_o];
      } else {
        v = __bfloat162float(w[c * s_c + o * s_o]);
      }
    }
    const uint32_t h = tf32_rna(v);
    hi[idx] = __uint_as_float(h);
    if (lo != nullptr) lo[idx] = __uint_as_float(tf32_rna(v - __uint_as_float(h)));
  }
}

// ---- host side ----------------------------------------------------------------
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  }
  return fn;
}

// a 2-D map of a row-major [outer, inner] tensor with row stride
// stride_bytes, boxes of [box_outer, box_inner]; 0 or a negative CUresult
int make_map(CUtensorMap* map, bool bf16, const void* ptr, long long inner, long long outer,
             long long stride_bytes, int box_inner, int box_outer, CUtensorMapSwizzle swizzle) {
  const auto fn = encode_fn();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

// Stages a chain spans: about 24 products whatever the terms (3 terms: 2
// stages, 2: 3, 1: 6), so each chain stays short and the adds into the
// float32 sum stay few.
int chain_tiles(bool a_lo, bool b_lo) {
  const int terms = a_lo && b_lo ? 3 : (a_lo || b_lo ? 2 : 1);
  return 6 / terms;
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <int BN, typename TA>
int launch_rows(const void* a, long long lda, int m, int k, const float* w_hi, const float* w_lo, int kp,
                int n, float* c, cudaStream_t stream) {
  constexpr int kA = RowTile<TA>::kBytes;
  constexpr bool bf16 = sizeof(TA) == 2;
  CUtensorMap map_a, map_wh, map_wl;
  int r = make_map(&map_a, bf16, a, k, m, lda * static_cast<long long>(sizeof(TA)), kBK, kBM,
                   bf16 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == 0) r = make_map(&map_wh, false, w_hi, kp, n, kp * 4LL, kBK, BN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == 0) {
    r = make_map(&map_wl, false, w_lo != nullptr ? w_lo : w_hi, kp, n, kp * 4LL, kBK, BN,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (r != 0) return r;
  const int w_lo_on = w_lo != nullptr;
  const int stage_bytes = kA + (w_lo_on ? 2 : 1) * BN * kBK * 4;
  const int stages = std::min(8, (kSmemMax - kAlign - 128) / stage_bytes);
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kAlign + stages * stage_bytes + 16 * stages;
  const auto kernel = rows_kernel<BN, TA>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n + BN - 1) / BN;
  const int tiles = ((m + kBM - 1) / kBM) * n_tiles;
  const int grid = std::min(tiles, sm_count());
  kernel<<<grid, kThreads, smem, stream>>>(map_a, map_wh, map_wl, c, m, n, kp / kBK, n_tiles, tiles, stages,
                                           w_lo_on, chain_tiles(!bf16, w_lo_on));
  return static_cast<int>(cudaGetLastError());
}

template <int BN, typename TA>
int launch_tn(const void* a, long long lda, const float* g, long long ldg, int m, int k_out, int n,
              int splits, int rows_per_split, float* part, cudaStream_t stream) {
  constexpr bool bf16 = sizeof(TA) == 2;
  constexpr int kRaw = ColTile<TA>::kBytes + BN * kBK * 4;
  constexpr int kHiLo2 = 2 * 2 * BN * kBK * 4;
  CUtensorMap map_a, map_g;
  int r = make_map(&map_a, bf16, a, k_out, m, lda * static_cast<long long>(sizeof(TA)), ColTile<TA>::kBox,
                   kBK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == 0) r = make_map(&map_g, false, g, n, m, ldg * 4LL, BN, kBK, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (r != 0) return r;
  const int stages = std::min(4, (kSmemMax - kAlign - 96 - kHiLo2) / kRaw);
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kAlign + kHiLo2 + stages * kRaw + 16 * stages + 32;
  const auto kernel = tn_kernel<BN, TA>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n + BN - 1) / BN;
  const dim3 grid(((k_out + kBM - 1) / kBM) * n_tiles, splits);
  kernel<<<grid, kThreads, smem, stream>>>(map_a, map_g, part, k_out, n, m, rows_per_split, n_tiles, stages,
                                           chain_tiles(!bf16, true));
  return static_cast<int>(cudaGetLastError());
}

template <typename TA>
int rows_by_bn(int bn, const void* a, long long lda, int m, int k, const float* w_hi, const float* w_lo,
               int kp, int n, float* c, cudaStream_t s) {
  switch (bn) {
    case 64: return launch_rows<64, TA>(a, lda, m, k, w_hi, w_lo, kp, n, c, s);
    case 128: return launch_rows<128, TA>(a, lda, m, k, w_hi, w_lo, kp, n, c, s);
    case 152: return launch_rows<152, TA>(a, lda, m, k, w_hi, w_lo, kp, n, c, s);
    case 160: return launch_rows<160, TA>(a, lda, m, k, w_hi, w_lo, kp, n, c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TA>
int tn_by_bn(int bn, const void* a, long long lda, const float* g, long long ldg, int m, int k_out, int n,
             int splits, int rows_per_split, float* part, cudaStream_t s) {
  switch (bn) {
    case 64: return launch_tn<64, TA>(a, lda, g, ldg, m, k_out, n, splits, rows_per_split, part, s);
    case 128: return launch_tn<128, TA>(a, lda, g, ldg, m, k_out, n, splits, rows_per_split, part, s);
    case 152: return launch_tn<152, TA>(a, lda, g, ldg, m, k_out, n, splits, rows_per_split, part, s);
    case 160: return launch_tn<160, TA>(a, lda, g, ldg, m, k_out, n, splits, rows_per_split, part, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int blocks_for(long long count) {
  return static_cast<int>(std::min<long long>((count + 255) / 256, 8LL * sm_count()));
}

}  // namespace

// C entry: W_hi, W_lo [no, kp] of the weight W [kc, no] whose element (c, o)
// is w[c * s_c + o * s_o] (float32, or bf16 where w_bf16, then lo is null).
// Returns the launch's cudaGetLastError() as an int.
extern "C" int dense_split_weight(const void* w, int w_bf16, long long s_c, long long s_o, int kc, int no,
                                  int kp, float* hi, float* lo, void* stream) {
  if (kc <= 0 || no <= 0 || kp % kBK != 0 || kp < kc || (w_bf16 && lo != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long count = static_cast<long long>(no) * kp;
  if (w_bf16) {
    split_weight_kernel<__nv_bfloat16><<<blocks_for(count), 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(w), s_c, s_o, kc, no, kp, hi, lo);
  } else {
    split_weight_kernel<float><<<blocks_for(count), 256, 0, s>>>(static_cast<const float*>(w), s_c, s_o, kc,
                                                                  no, kp, hi, lo);
  }
  return static_cast<int>(cudaGetLastError());
}

// C entry, nn and nt: c [m, n] (row-major) = A [m, k] (row stride lda, float32
// or bf16 where a_bf16; 16-byte aligned base and rows) @ W, W given as
// dense_split_weight's W_hi, W_lo [n, kp] (w_lo null: no lo term), in N-tiles
// of bn. 0, a CUDA error, or a negative CUresult of a tensor map.
extern "C" int dense_rows(const void* a, int a_bf16, long long lda, int m, int k, const float* w_hi,
                          const float* w_lo, int kp, int n, int bn, float* c, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || kp % kBK != 0 || kp < k) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a_bf16 ? rows_by_bn<__nv_bfloat16>(bn, a, lda, m, k, w_hi, w_lo, kp, n, c, s)
                : rows_by_bn<float>(bn, a, lda, m, k, w_hi, w_lo, kp, n, c, s);
}

// C entry, tn: out [k_out, n] = A [m, k_out]^T @ G [m, n] (A float32 or bf16
// where a_bf16, G float32; row strides lda, ldg; 16-byte aligned bases and
// rows), in N-tiles of bn, the m rows in `splits` runs of rows_per_split (a
// multiple of 32; the last may be shorter). With splits > 1 the partial
// sums go to part [splits, k_out, n] and are added in order into out.
extern "C" int dense_tn(const void* a, int a_bf16, long long lda, const float* g, long long ldg, int m,
                        int k_out, int n, int bn, int splits, int rows_per_split, float* part, float* out,
                        void* stream) {
  if (m <= 0 || k_out <= 0 || n <= 0 || splits <= 0 || rows_per_split % kBK != 0 ||
      static_cast<long long>(splits - 1) * rows_per_split >= m ||
      static_cast<long long>(splits) * rows_per_split < m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? part : out;
  int r = a_bf16 ? tn_by_bn<__nv_bfloat16>(bn, a, lda, g, ldg, m, k_out, n, splits, rows_per_split, dst, s)
                 : tn_by_bn<float>(bn, a, lda, g, ldg, m, k_out, n, splits, rows_per_split, dst, s);
  if (r != 0 || splits == 1) return r;
  const long long count = static_cast<long long>(k_out) * n;
  reduce_kernel<<<blocks_for(count), 256, 0, s>>>(part, out, count, splits);
  return static_cast<int>(cudaGetLastError());
}
