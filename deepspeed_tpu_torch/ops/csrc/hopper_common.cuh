// Hopper (sm_90a) building blocks for the port's CUDA kernels: TMA tensor
// maps and loads, mbarrier pipelines, warpgroup matrix multiply (wgmma) and
// register reallocation (setmaxnreg), thread-block clusters and their
// distributed shared memory, and what the flash-attention kernels share
// (their constants and the live-tile table of the masked mode).  The
// forward (flash_attention_fwd.cu), both backward kernels
// (flash_attention_bwd.cu) and the paged decode kernel
// (decode_attention.cu) are built from them.
//
// wgmma m64nNk16 (fp32 accumulate), per warpgroup of 128 threads: warp w
// (0-3) owns rows 16w..16w+15; lane = 4 g + t4.  Accumulator d[i] of an
// m64nN product sits at row 16w + g + 8 ((i >> 1) & 1), column
// 8 (i / 4) + 2 t4 + (i & 1): the m16n8 C fragment of mma.sync, repeated
// over N / 8 column chunks.  An A operand from registers (RS) is the
// m16n8k16 A fragment of the warp's 16 rows, so the accumulator chunks
// 2kc, 2kc+1 of one product, rounded to 16 bits, are the A registers of k
// chunk kc of the next (pack_a below).
//
// Shared-memory operands use the 128-byte swizzle that a TMA box with
// CU_TENSOR_MAP_SWIZZLE_128B writes: rows of 128 bytes (64 16-bit
// elements), 16-byte chunk c of row r stored at chunk c ^ (r % 8), atoms of
// 8 rows = 1024 bytes, each atom 1024-byte aligned.  A tile wider than 64
// elements is several such boxes, one after another.
//   K-major operand (the contraction runs along the 128-byte row: Q and K
//   of Q.K^T): SBO = 1024 (next 8 rows), LBO unused; k step kk of 16
//   elements starts 32 kk bytes into the row (the hardware applies the
//   swizzle to the address it forms, so an offset inside the atom is fine).
//   MN-major operand (the contraction runs down the rows: V of P.V, with
//   the transpose bit): SBO = 1024 (next 8 rows of k), LBO = the byte
//   distance between two 64-column boxes along N, which is the tile's
//   height times 128 (16 KB for 128 rows, 8 KB for 64); k step kc of 16
//   rows starts 2048 kc bytes in.
// One swizzled tile can be read both ways: the backward reads Q, dO (and
// K) K-major as the B operand of a score product and MN-major as the B
// operand of a gradient product (kmajor_desc / mnmajor_desc below).
#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

constexpr float NEG_INF = -1e30f;   // ops/kernels/common.py NEG_INF
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Live-tile table of the block-sparse (masked) mode, one per kernel tiling,
// built by the wrapper (ops/kernels/flash_attention.py `live_tile_tables`):
// the CTA of tile t along its own axis visits the other axis' tiles
// idx[off[t] .. off[t+1]) in ascending order; bits[e * W ..] (W 32-bit words
// per entry) marks entry e's live 8x8 element groups, row group major (the
// mask ANDed with causal at group level; the diagonal groups are masked
// element by element as before); order[blockIdx.x] is the tile a CTA takes,
// longest list first.  Unmasked launches pass null pointers.
struct TileTable {
  const int* off;
  const int* idx;
  const uint32_t* bits;
  const int* order;
};

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

// Errors of the tensor-map encode, returned by the C entry points beside
// cudaError_t values (ds_cuda_error_string tells them apart).
constexpr int kEncodeMissing = 10000;   // no cuTensorMapEncodeTiled entry point found
constexpr int kEncodeFailed = 10001;    // + the CUresult it returned

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found once through the CUDA runtime so that the
// library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A map over a contiguous [B, S, H, D] tensor of 16-bit elements, as the
// 4-D (D, H, S, B) with its real strides, whose box is `rows` rows of 64
// elements of one (head, batch): coordinates (column, head, row, batch).
// 128-byte swizzle.  Returns 0 or one of the codes above.
inline int encode_bshd_map(CUtensorMap* map, const void* base, CUtensorMapDataType dt,
                           int B, int S, int H, int D, int rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return kEncodeMissing;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};   // bytes, dims 1..3
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, dt, 4, const_cast<void*>(base), dims, strides, box,
                         elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

// ---------------------------------------------------------------------------
// Device: mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)),
               "r"(count) : "memory");
}

// after the inits, before any thread (or the TMA unit) uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// arrive once and expect `bytes` more of transfers (TMA complete_tx)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// true once the phase of parity `parity` has completed.  A fresh barrier is
// in phase 0: waiting on parity 1 returns at once (the producer's first
// pass over its empty barriers).
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One box of a 4-D map into shared memory (1024-byte aligned for the
// 128-byte swizzle); completes `bytes` of the barrier's expected transfer.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A contiguous run of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) into shared memory by the bulk-copy unit (1-D, no tensor map):
// the fp32 lse / delta rows of a tile; completes on the barrier like a box.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(smem_u32(bar))
      : "memory");
}

// A barrier over `threads` threads (a multiple of 32) of the CTA, by id
// (0 is __syncthreads' own): the consumer warps of a warp-specialised
// kernel synchronise without the producer.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// Device: thread-block clusters and distributed shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster: shared-memory writes before it
// (to this CTA's or a peer's) are visible to the cluster's reads after it.
// All threads of a warp execute it together (.aligned).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The two halves of cluster_sync, for work between them: arrive (relaxed:
// orders nothing) and wait.  A CTA may touch a peer's shared memory only
// once every CTA of the cluster has started: an arrive at the start and a
// wait before the first access see to that.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Writes v at `p`'s offset in the shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ void st_dsmem(uint32_t* p, uint32_t rank, uint32_t v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" :: "r"(remote), "r"(v) : "memory");
}

// 2^x on the SFU with denormal results flushed to zero (ex2.approx.ftz:
// one MUFU.EX2; exp2f without -ftz adds a denormal range fix-up).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// Device: wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1 in bits
// 62-63); the base offset (bits 49-51) is 0 because every atom is
// 1024-byte aligned.  Addresses and offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// k step kk (16 elements) of a K-major tile: the contraction runs along the
// 128-byte rows, `box` bytes between its 64-column boxes (rows x 128).
__device__ __forceinline__ uint64_t kmajor_desc(const unsigned char* tile, uint32_t box,
                                                int kk) {
  return sw128_desc(tile + (kk / 4) * box + (kk % 4) * 32, 16, 1024);
}

// k step kc (16 rows) of an MN-major tile (use with the transpose bit): the
// contraction runs down the rows, N across the boxes, `box` bytes apart.
__device__ __forceinline__ uint64_t mnmajor_desc(const unsigned char* tile, uint32_t box,
                                                 int kc) {
  return sw128_desc(tile + kc * 2048, box, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins registers that a wgmma reads or writes: the front end may not move
// other accesses to them across this point (place after wgmma_wait and
// before wgmma_fence).  It emits no instruction, so it orders nothing for
// ptxas, which allocates and schedules the registers itself.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// Register reallocation between warpgroups (all 4 warps execute it).
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// The PTX of m64nNk16 with fp32 accumulators d[N / 2]; scale_d = 0 writes
// d = A.B, 1 accumulates.  TA / TB: the transpose bits (0 = K-major).

#define HOPPER_ACC64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define HOPPER_ACC128(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define HOPPER_WGMMA_SS_N128(TY, d, da, db, scale_d, TA, TB) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n" \
      : HOPPER_ACC128(d) \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))

#define HOPPER_WGMMA_SS_N64(TY, d, da, db, scale_d, TA, TB) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n" \
      : HOPPER_ACC64(d) \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))

#define HOPPER_WGMMA_RS_N64(TY, d, a, db, scale_d, TB) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
      : HOPPER_ACC64(d) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB))

#define HOPPER_WGMMA_RS_N128(TY, d, a, db, scale_d, TB) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n" \
      : HOPPER_ACC128(d) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB))


template <typename T> struct WgmmaType;
template <> struct WgmmaType<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <> struct WgmmaType<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// D[64 x N] (+)= A[64 x 16] . B[16 x N], both from shared memory.
template <typename T, int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  static_assert(N == 64 || N == 128, "m64nNk16 SS: N of 64 or 128");
  if constexpr (N == 64) {
    if constexpr (bf16) HOPPER_WGMMA_SS_N64("bf16", d, da, db, scale_d, TA, TB);
    else HOPPER_WGMMA_SS_N64("f16", d, da, db, scale_d, TA, TB);
  } else {
    if constexpr (bf16) HOPPER_WGMMA_SS_N128("bf16", d, da, db, scale_d, TA, TB);
    else HOPPER_WGMMA_SS_N128("f16", d, da, db, scale_d, TA, TB);
  }
}

// D[64 x N] (+)= A[64 x 16] . B[16 x N], A from registers (the m16n8k16 A
// fragment of the warp's 16 rows), B from shared memory.
template <typename T, int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  static_assert(N == 64 || N == 128, "m64nNk16: N of 64 or 128");
  if constexpr (N == 64) {
    if constexpr (bf16) HOPPER_WGMMA_RS_N64("bf16", d, a, db, scale_d, TB);
    else HOPPER_WGMMA_RS_N64("f16", d, a, db, scale_d, TB);
  } else {
    if constexpr (bf16) HOPPER_WGMMA_RS_N128("bf16", d, a, db, scale_d, TB);
    else HOPPER_WGMMA_RS_N128("f16", d, a, db, scale_d, TB);
  }
}

// The A registers of k chunk kc (16 columns) from the accumulator of a
// product whose columns are that contraction, rounded to T.
template <typename T, int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d)[N / 2], int kc) {
  a[0] = WgmmaType<T>::pack(d[8 * kc + 0], d[8 * kc + 1]);
  a[1] = WgmmaType<T>::pack(d[8 * kc + 2], d[8 * kc + 3]);
  a[2] = WgmmaType<T>::pack(d[8 * kc + 4], d[8 * kc + 5]);
  a[3] = WgmmaType<T>::pack(d[8 * kc + 6], d[8 * kc + 7]);
}

}  // namespace hopper
