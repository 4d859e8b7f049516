// Pieces shared by the flash-attention kernels: the constants and the
// live-tile table of both sources, and the warp-level building blocks of
// the backward kernels (flash_attention_bwd.cu): mma.sync m16n8k16 with
// fp32 accumulation, ldmatrix operand loads and cp.async copies.  The
// forward (flash_attention_fwd.cu) runs on wgmma and TMA from
// hopper_common.cuh.
//
// Fragment coordinates of m16n8k16 (g = lane / 4, t4 = lane % 4):
//   A 16x16 row-major: a[0] (g, 2t4..+1), a[1] (g+8, 2t4..), a[2] (g, 8+2t4..),
//                      a[3] (g+8, 8+2t4..)
//   B 16x8:            b0 (k 2t4..+1, n g), b1 (k 8+2t4..+1, n g)
//   C 16x8:            c[0..1] (g, 2t4..+1), c[2..3] (g+8, 2t4..+1)
// so the C fragments of two adjacent n-tiles re-pack in registers as the A
// fragment of a product that contracts over those 16 columns.
//
// Two ldmatrix patterns load every B operand (row addresses per lane, in
// elements, for a shared-memory tile with rows LD elements apart):
//   b_lane_rows_n: the tile's rows are the product's n index and its columns
//     the k index (K of Q.K^T); one ldmatrix.x4 gives the (b0, b1) pairs of
//     two 8-wide n-tiles over 16 k.
//   b_lane_rows_k: the tile's rows are the k index (V of P.V); the same via
//     ldmatrix.trans.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace flash {

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

template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// A fragment of k-columns [16 kc, 16 kc + 16) from two C fragments, rounded
// to T (the products' input dtype).
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = Mma<T>::pack(c0[0], c0[1]);
  a[1] = Mma<T>::pack(c0[2], c0[3]);
  a[2] = Mma<T>::pack(c1[0], c1[1]);
  a[3] = Mma<T>::pack(c1[2], c1[3]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

// Row address (elements) of this lane for an A fragment of rows
// [row0, row0 + 16): matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15).
__device__ __forceinline__ int a_lane(int row0, int lane, int ld) {
  return (row0 + (lane & 15)) * ld + (lane >> 4) * 8;
}

// B operand from a tile whose rows are n: matrices (n 0-7, k lo), (n 0-7,
// k hi), (n 8-15, k lo), (n 8-15, k hi) -> r[0], r[1] = (b0, b1) of n-tile
// 0, r[2], r[3] of n-tile 1.
__device__ __forceinline__ int b_lane_rows_n(int lane, int ld) {
  return ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
}

// B operand from a tile whose rows are k (load with ldsm_x4_trans):
// matrices (k lo, n 0-7), (k hi, n 0-7), (k lo, n 8-15), (k hi, n 8-15).
__device__ __forceinline__ int b_lane_rows_k(int lane, int ld) {
  return (((lane >> 3) & 1) * 8 + (lane & 7)) * ld + (lane >> 4) * 8;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Start copying a [ROWS x HD] tile whose rows are `row_stride` elements
// apart in global memory into shared memory rows of LD elements, with
// THREADS threads.
template <typename T, int HD, int LD, int ROWS, int THREADS>
__device__ __forceinline__ void cp_tile(T* dst, const T* src, int64_t row_stride) {
  constexpr int CHUNKS = HD / 8;   // 16-byte chunks per row
  static_assert((ROWS * CHUNKS) % THREADS == 0, "tile / thread mismatch");
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / CHUNKS, cc = c % CHUNKS;
    cp_async16(dst + r * LD + cc * 8, src + r * row_stride + cc * 8);
  }
}

}  // namespace flash
