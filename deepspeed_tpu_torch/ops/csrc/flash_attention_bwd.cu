// Flash-attention backward for Hopper (sm_90a): two kernels, bound through
// ctypes.
//
// Replaces the Pallas kernels `_bwd_dq_kernel` (K2) and `_bwd_dkv_kernel`
// (K3), launched by `_bwd` in deepspeed_tpu/ops/pallas/flash_attention.py.
// Both recompute the scores from q, k and the forward's lse (P is never
// stored):
//   p  = exp(s * scale - lse)          (0 above the diagonal when causal)
//   dp = dO . V^T
//   ds = p * (dp - delta) * scale      (delta = rowsum(dO * O), from the wrapper)
//   K2: dq  = ds . K                   ds rounded to the input dtype first
//   K3: dv += p^T . dO, dk += ds^T . Q p and ds rounded to the input dtype
// with fp32 accumulators, as the JAX kernels round (`p.astype(do.dtype)`,
// `ds.astype(k.dtype)`; a no-op for fp32).  As there, the design keeps two
// kernels and no atomics, so every gradient is written by exactly one CTA
// and the result is deterministic.
//
// Layout: q, dO, dq [B, S, Hq, hd]; k, v, dk, dv [B, S, Hkv, hd] (the model's
// own layout: no transposes around the calls); lse and delta fp32 [B, Hq, S].
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s) at the training
// shape (B=1, S=16384, 14 heads of 128, causal): K2 does 3 products over
// the S(S+1)/2 attended pairs, 1.44 TFLOP -> 1.46 ms; K3 does 4, 1.92 TFLOP
// -> 1.95 ms; against 5 (K2) or 6 (K3) [S, 14, 128] bf16 tensors of traffic
// (~0.1 ms): compute-bound, and Hopper reaches its tensor-core rate only
// through wgmma fed from shared memory by TMA.
//
// Design (bf16 / fp16).  On the TPU the sweep over the other sequence axis
// is the sequential innermost grid axis with the accumulator in VMEM
// scratch.  Hopper blocks run in parallel, so each CTA owns its output tile
// and loops, with the roles of K1 (flash_attention_fwd.cu): 384 threads, a
// producer warpgroup (setmaxnreg.dec to 24) whose thread 0 issues every TMA
// load into a ring of shared-memory stages with full barriers (the copy
// completes its bytes) and empty barriers (the 8 consumer warps arrive once
// the stage is read), and two consumer warpgroups (setmaxnreg.inc to 240)
// of 64 rows each.  Operands sit in 128-byte-swizzled boxes of 64 columns,
// and one tile is read K-major by a score product and MN-major (transpose
// bit) by a gradient product (hopper_common.cuh kmajor_desc/mnmajor_desc).
//   K2: one CTA per (b, q head, 128-row query tile); Q and dO are loaded
//       once and stay; the producer walks the 64-key K/V tiles up to the
//       diagonal.  Per tile a warpgroup issues S = Q K^T and dP = dO V^T
//       (wgmma m64n64k16, both operands from shared memory), computes P on
//       S's accumulator while dP still runs, then dS, packs dS (rounded to
//       the input dtype) into registers as the A operand of dQ += dS K
//       (wgmma m64n{hd}k16, K read MN-major).  The 64 x hd dq accumulator
//       stays in registers and is written once.
//   K3: one CTA per (b, kv head, 128-key tile); K and V are loaded once and
//       stay; the producer walks every (q head of the GQA group, 64-row
//       query tile) from the diagonal on, bringing Q, dO and the tile's 64
//       lse and delta values (1-D bulk copies) into the ring.  Everything
//       runs transposed: S^T = K Q^T and dP^T = V dO^T (m64n64k16, SS) put
//       keys on the accumulator's rows and queries on its columns, so each
//       column's lse and delta are read from shared memory, and P^T and dS^T
//       pack straight into the A operands of dV += P^T dO and dK += dS^T Q
//       (m64n{hd}k16, dO and Q read MN-major).  dS never touches shared
//       memory; the group sum stays in the dk/dv register accumulators (64
//       + 64 fp32 at hd 128, plus 32 + 32 of scores: about 200 of the 240).
// ptxas serialises every wgmma of a kernel (warning C7513) when a non-wgmma
// instruction writes a running wgmma's input registers, so each tile waits
// for its gradient products before the next scores are issued, every
// barrier wait comes before the wgmma.fence of the products it guards, and
// the warpgroup index is made warp-uniform.  With 64-row tiles aligned to
// the 128-row CTA tiles only the tiles that cut the diagonal mask element
// by element, through their own variant of the probabilities; a warpgroup
// whose rows lie wholly past the diagonal of a visited tile computes it
// with p = 0 (no warpgroup skips a tile the producer loaded).  Heavy causal
// tiles are launched first.
//
// Masked mode (`block_mask`, the block-sparse path; the Pallas kernels'
// `masked` skips at :202-207 and :254-259).  The producer walks only the
// live tiles of its CTA, from the wrapper's table (hopper_common.cuh
// TileTable) at the kernel's own tiling: K2 the live 64-key tiles of its
// 128-row query tile ("q"), K3 the live 64-row query tiles of its 128-key
// tile ("kv", times the G query heads of the group).  Dead tiles cost
// neither loads nor math.  An entry's live 8x8 groups are 4 words, 16 bits
// per consumer warp (its 16 rows: bit 8 r + group of the walked axis, r = 0
// for rows g, 1 for rows g + 8); only partly live tiles test elements.  p
// of a masked pair is 0 explicitly, never exp(s - lse): a row with no live
// key has lse = NEG_INF, where that would be 1.  A CTA whose list is empty
// loads nothing and writes zeros (dq of a dead row, dk/dv of keys no live
// query sees).  CTAs take the tiles with the longest lists first.
//
// fp32 inputs take separate CUDA-core (FMA) kernels, as K1 does (wgmma has
// only TF32 for them, which cannot meet the fp32 tolerance): 256 threads on
// a 64-row tile, operands in odd-stride shared memory, each thread a 4 x 4
// block of scores (every value read from shared memory feeds 4 FMAs) and 4
// rows x hd / 16 of the output; K2 walks 64-key tiles (the "f32" table of
// K1's fp32 variant), K3 64-row query tiles of a 64-key tile ("f32kv").
#include <cstdio>

#include "hopper_common.cuh"

namespace {

using hopper::LOG2E;
using hopper::NEG_INF;
using hopper::TileTable;

// tensor-core kernels (bf16 / fp16)
constexpr int NUM_THREADS = 384;    // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_REGS = 24;   // 128 x 24 + 256 x 240 <= 65536
constexpr int CONSUMER_REGS = 240;
constexpr int DQ_BLOCK_M = 128;     // K2: query rows per CTA (two warpgroups x 64)
constexpr int DQ_BLOCK_N = 64;      // K2: keys per K/V tile
constexpr int DKV_BLOCK_N = 128;    // K3: keys per CTA (two warpgroups x 64)
constexpr int DKV_BLOCK_M = 64;     // K3: query rows per Q/dO tile
constexpr int BOX_COLS = 64;        // 16-bit columns of one 128-byte swizzle box
constexpr int BOX_ROW_BYTES = 128;
constexpr int WG_ROWS = 64;         // rows of one consumer warpgroup
constexpr int TILE_WORDS = 4;       // 32-bit live-group words per table entry
static_assert(DQ_BLOCK_M % DQ_BLOCK_N == 0, "the causal diagonal must end a key tile");
static_assert(DKV_BLOCK_N % DKV_BLOCK_M == 0, "the causal diagonal must start a query tile");

// CUDA-core kernels (fp32)
constexpr int F32_BLOCK = 64;       // rows per CTA == rows per walked tile
constexpr int F32_THREADS = 256;    // a 16 x 16 grid of threads
constexpr int F32_R = 4;            // each: 4 x 4 scores, 4 rows x hd / 16 outputs

template <int HD>
struct Dq {
  static constexpr int STAGES = HD == 64 ? 4 : 3;
  static constexpr int BOXES = HD / BOX_COLS;
  static constexpr int Q_BOX = DQ_BLOCK_M * BOX_ROW_BYTES;    // bytes of one 64-column box
  static constexpr int KV_BOX = DQ_BLOCK_N * BOX_ROW_BYTES;
  static constexpr int Q_BYTES = BOXES * Q_BOX;              // Q or dO
  static constexpr int KV_BYTES = BOXES * KV_BOX;            // K or V, one stage
  // full q/dO; full and empty per stage
  static constexpr int N_BARRIERS = 1 + 2 * STAGES;
  // + 1024 bytes of slack to align the base (the swizzle atom)
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * N_BARRIERS;
};

template <int HD>
struct Dkv {
  static constexpr int STAGES = HD == 64 ? 3 : 2;
  static constexpr int BOXES = HD / BOX_COLS;
  static constexpr int KV_BOX = DKV_BLOCK_N * BOX_ROW_BYTES;
  static constexpr int Q_BOX = DKV_BLOCK_M * BOX_ROW_BYTES;
  static constexpr int KV_BYTES = BOXES * KV_BOX;            // K or V
  static constexpr int Q_BYTES = BOXES * Q_BOX;              // Q or dO, one stage
  static constexpr int ROW_BYTES = DKV_BLOCK_M * 4;          // lse or delta of one tile
  static constexpr int STAGE_TX = 2 * Q_BYTES + 2 * ROW_BYTES;
  // full k/v; full and empty per stage
  static constexpr int N_BARRIERS = 1 + 2 * STAGES;
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + STAGES * STAGE_TX + 8 * N_BARRIERS;
};

// lane 0 of each consumer warp arrives: the stage is read
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) hopper::mbar_arrive(empty);
}

// The consumer warpgroup (0 or 1), through a shuffle so that the compiler
// sees it uniform across the warp: the descriptors built from it then live
// in uniform registers, as wgmma wants them.
__device__ __forceinline__ int consumer_group() {
  return __shfl_sync(0xffffffff, threadIdx.x / 128, 0) - 1;
}

// D[64 x N] = A[64 x HD] . B[N x HD]^T, both K-major in swizzled shared
// memory (a_box / b_box: bytes between each tile's 64-column boxes).
// Issued and committed, not waited for.
template <typename T, int N, int HD>
__device__ __forceinline__ void issue_scores(float (&d)[N / 2], const unsigned char* a,
                                             int a_box, const unsigned char* b, int b_box) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    hopper::wgmma_ss<T, N, 0, 0>(d, hopper::kmajor_desc(a, a_box, kk),
                                 hopper::kmajor_desc(b, b_box, kk), kk > 0);
  hopper::wgmma_commit();
}

// D[64 x HD] += A[64 x 16 KC] . B[16 KC x HD]: A from registers (packed
// accumulator chunks), B an MN-major tile (transpose bit).  Issued, not
// committed.
template <typename T, int HD, int KC>
__device__ __forceinline__ void issue_grad(float (&d)[HD / 2], const uint32_t (&a)[KC][4],
                                           const unsigned char* b, int b_box) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    hopper::wgmma_rs<T, HD, 1>(d, a[kc], hopper::mnmajor_desc(b, b_box, kc), 1);
}

// An m64nN accumulator rounded to T, as the A registers of the next product
// (which contracts over its N columns).
template <typename T, int N>
__device__ __forceinline__ void pack_all(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) hopper::pack_a<T, N>(a[kc], d, kc);
}

// The m64n{HD} accumulator of a warp's 16 rows, rounded to T, into rows of
// a [.., HD] output (`row0`: the warp's first row, `stride` elements apart).
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* row0, int64_t stride, const float (&acc)[HD / 2]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    T* row = row0 + (int64_t)(g + 8 * r) * stride;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<uint32_t*>(row + 8 * c + 2 * t4) =
          hopper::WgmmaType<T>::pack(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// K2 (dq), bf16 / fp16
// ---------------------------------------------------------------------------

// P of one 64 x 64 tile on S's accumulator (rows: queries r0 + g + 8 hf;
// columns: keys k0 + 8 (i / 4) + 2 t4 + (i & 1), hf = (i >> 1) & 1):
// p = exp2(s scale log2(e) - lse log2(e)) as one FFMA and one MUFU.EX2; 0
// above the causal diagonal (DIAG) and in the dead groups of a partly live
// tile (PART: `live`, this warp's 16 bits, bit 8 hf + key group).
template <bool DIAG, bool PART>
__device__ __forceinline__ void dq_probs(float (&sc)[DQ_BLOCK_N / 2], const float (&neg_lse2)[2],
                                         int r0, int k0, uint32_t live, float scale_log2) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < DQ_BLOCK_N / 2; ++i) {
    const int hf = (i >> 1) & 1;
    float p = hopper::exp2_ftz(fmaf(sc[i], scale_log2, neg_lse2[hf]));
    if (DIAG && r0 + g + 8 * hf < k0 + 8 * (i / 4) + 2 * t4 + (i & 1)) p = 0.f;
    if (PART && !((live >> (hf * 8 + i / 4)) & 1)) p = 0.f;
    sc[i] = p;
  }
}

// The variant this warp's tile needs, chosen per tile: the element tests
// are compiled only into the variants that run them.
template <bool CAUSAL, bool MASKED>
__device__ __forceinline__ void dq_probs_tile(float (&sc)[DQ_BLOCK_N / 2],
                                              const float (&neg_lse2)[2], int r0, int k0,
                                              uint32_t live, float scale_log2) {
  const bool diag = CAUSAL && k0 + DQ_BLOCK_N - 1 > r0;
  const bool part = MASKED && live != 0xFFFFu;
  if (diag) {
    if (part) dq_probs<CAUSAL, MASKED>(sc, neg_lse2, r0, k0, live, scale_log2);
    else dq_probs<CAUSAL, false>(sc, neg_lse2, r0, k0, live, scale_log2);
  } else {
    if (part) dq_probs<false, MASKED>(sc, neg_lse2, r0, k0, live, scale_log2);
    else dq_probs<false, false>(sc, neg_lse2, r0, k0, live, scale_log2);
  }
}

template <int HD, bool MASKED>
__device__ __forceinline__ void dq_produce(const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                           const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                           unsigned char* Qs, unsigned char* dOs,
                                           unsigned char* Ks, unsigned char* Vs,
                                           uint64_t* full_q, uint64_t* full, uint64_t* empty,
                                           const int* idx, int n_tiles, int q0, int h, int hk,
                                           int b) {
  using C = Dq<HD>;
  hopper::mbar_arrive_expect_tx(full_q, 2 * C::Q_BYTES);
#pragma unroll
  for (int c = 0; c < C::BOXES; ++c) {
    hopper::tma_load_4d(Qs + c * C::Q_BOX, tm_q, full_q, c * BOX_COLS, h, q0, b);
    hopper::tma_load_4d(dOs + c * C::Q_BOX, tm_do, full_q, c * BOX_COLS, h, q0, b);
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % C::STAGES;
    const uint32_t phase = (j / C::STAGES) & 1;
    const int k0 = (MASKED ? idx[j] : j) * DQ_BLOCK_N;
    hopper::mbar_wait(&empty[s], phase ^ 1);   // the stage's last tile is read
    hopper::mbar_arrive_expect_tx(&full[s], 2 * C::KV_BYTES);
#pragma unroll
    for (int c = 0; c < C::BOXES; ++c) {
      hopper::tma_load_4d(Ks + s * C::KV_BYTES + c * C::KV_BOX, tm_k, &full[s],
                          c * BOX_COLS, hk, k0, b);
      hopper::tma_load_4d(Vs + s * C::KV_BYTES + c * C::KV_BOX, tm_v, &full[s],
                          c * BOX_COLS, hk, k0, b);
    }
  }
}

// A consumer warpgroup of K2: query rows 64 cg .. 64 cg + 63 of the tile.
template <typename T, int HD, bool CAUSAL, bool MASKED>
__device__ __forceinline__ void dq_consume(const unsigned char* Qs, const unsigned char* dOs,
                                           const unsigned char* Ks, const unsigned char* Vs,
                                           uint64_t* full_q, uint64_t* full, uint64_t* empty,
                                           TileTable tt, int e0, int n_tiles,
                                           const float* lse, const float* delta, T* dq, int S,
                                           int Hq, int q0, int h, int b, float scale,
                                           float scale_log2) {
  using C = Dq<HD>;
  const int cg = consumer_group();
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int cw = cg * 4 + w;                   // consumer warp: rows 16 cw .. 16 cw + 15
  const int g = lane >> 2;
  const int r0 = q0 + 16 * cw;                 // this warp's first row
  // rows r0 + g and r0 + g + 8: lse (negated, log2 domain) and delta
  const int64_t row = ((int64_t)b * Hq + h) * S + r0 + g;
  const float neg_lse2[2] = {-lse[row] * LOG2E, -lse[row + 8] * LOG2E};
  const float dlt[2] = {delta[row], delta[row + 8]};
  const unsigned char* q_rows = Qs + cg * WG_ROWS * BOX_ROW_BYTES;
  const unsigned char* do_rows = dOs + cg * WG_ROWS * BOX_ROW_BYTES;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  if (n_tiles > 0) hopper::mbar_wait(full_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % C::STAGES;
    const uint32_t phase = (j / C::STAGES) & 1;
    const int k0 = (MASKED ? tt.idx[e0 + j] : j) * DQ_BLOCK_N;
    const uint32_t live =
        MASKED ? (tt.bits[(int64_t)(e0 + j) * TILE_WORDS + (cw >> 1)] >> ((cw & 1) * 16)) &
                     0xFFFFu
               : 0xFFFFu;
    const unsigned char* Kt = Ks + s * C::KV_BYTES;
    const unsigned char* Vt = Vs + s * C::KV_BYTES;
    float sc[DQ_BLOCK_N / 2], dp[DQ_BLOCK_N / 2];
    hopper::mbar_wait(&full[s], phase);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    issue_scores<T, DQ_BLOCK_N, HD>(sc, q_rows, C::Q_BOX, Kt, C::KV_BOX);
    issue_scores<T, DQ_BLOCK_N, HD>(dp, do_rows, C::Q_BOX, Vt, C::KV_BOX);
    hopper::wgmma_wait<1>();                   // S done; dP may still run
    hopper::fence_regs(sc);
    dq_probs_tile<CAUSAL, MASKED>(sc, neg_lse2, r0, k0, live, scale_log2);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
#pragma unroll
    for (int i = 0; i < DQ_BLOCK_N / 2; ++i)
      dp[i] = sc[i] * (dp[i] - dlt[(i >> 1) & 1]) * scale;   // dS
    uint32_t da[DQ_BLOCK_N / 16][4];
    pack_all<T, DQ_BLOCK_N>(da, dp);
    hopper::wgmma_fence();
    issue_grad<T, HD, DQ_BLOCK_N / 16>(acc, da, Kt, C::KV_BOX);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    release(&empty[s]);
  }
  const int64_t stride = (int64_t)Hq * HD;
  store_rows<T, HD>(dq + ((int64_t)b * S + r0) * stride + (int64_t)h * HD, stride, acc);
}

template <typename T, int HD, bool CAUSAL, bool MASKED>
__global__ void __launch_bounds__(NUM_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, TileTable tt, int S,
                    int Hq, int Hkv, float scale, float scale_log2) {
  using C = Dq<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* dOs = Qs + C::Q_BYTES;
  unsigned char* Ks = dOs + C::Q_BYTES;                // STAGES tiles
  unsigned char* Vs = Ks + C::STAGES * C::KV_BYTES;    // STAGES tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + C::STAGES * C::KV_BYTES);
  uint64_t* full_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + C::STAGES;

  // heavy tiles first: the longest live lists, or the late causal rows
  const int qi = MASKED ? tt.order[blockIdx.x] : gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qi * DQ_BLOCK_M;
  // the key tiles visited: up to the diagonal when causal, or this query
  // tile's live list in the masked mode
  const int e0 = MASKED ? tt.off[qi] : 0;
  const int n_tiles = MASKED ? tt.off[qi + 1] - e0
                             : (CAUSAL ? (q0 + DQ_BLOCK_M) / DQ_BLOCK_N : S / DQ_BLOCK_N);

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_q, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0 && n_tiles > 0)
      dq_produce<HD, MASKED>(&tm_q, &tm_do, &tm_k, &tm_v, Qs, dOs, Ks, Vs, full_q, full,
                             empty, MASKED ? tt.idx + e0 : nullptr, n_tiles, q0, h, hk, b);
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    dq_consume<T, HD, CAUSAL, MASKED>(Qs, dOs, Ks, Vs, full_q, full, empty, tt, e0, n_tiles,
                                      lse, delta, dq, S, Hq, q0, h, b, scale, scale_log2);
  }
}

// ---------------------------------------------------------------------------
// K3 (dk, dv), bf16 / fp16
// ---------------------------------------------------------------------------

// P^T of one 64-key x 64-query tile on S^T's accumulator (rows: keys kr0 +
// g + 8 hf; columns: queries q0 + 8 n + 2 t4 + e % 2 for element i = 4 n +
// e, hf = e / 2), each column's lse read from shared memory; 0 where the
// query precedes the key (DIAG) and in the dead groups of a partly live
// tile (PART: this warp's 16 bits, bit 8 hf + query group).
template <bool DIAG, bool PART>
__device__ __forceinline__ void dkv_probs(float (&st)[DKV_BLOCK_M / 2], const float* lse_t,
                                          int kr0, int q0, uint32_t live, float scale_log2) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < DKV_BLOCK_M / 8; ++n) {
    const float2 l = *reinterpret_cast<const float2*>(lse_t + 8 * n + 2 * t4);
    const float neg_lse2[2] = {-l.x * LOG2E, -l.y * LOG2E};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * n + e, hf = e >> 1;
      float p = hopper::exp2_ftz(fmaf(st[i], scale_log2, neg_lse2[e & 1]));
      if (DIAG && q0 + 8 * n + 2 * t4 + (e & 1) < kr0 + g + 8 * hf) p = 0.f;
      if (PART && !((live >> (hf * 8 + n)) & 1)) p = 0.f;
      st[i] = p;
    }
  }
}

template <bool CAUSAL, bool MASKED>
__device__ __forceinline__ void dkv_probs_tile(float (&st)[DKV_BLOCK_M / 2], const float* lse_t,
                                               int kr0, int q0, uint32_t live,
                                               float scale_log2) {
  const bool diag = CAUSAL && q0 < kr0 + 15;   // some query of the tile precedes a key
  const bool part = MASKED && live != 0xFFFFu;
  if (diag) {
    if (part) dkv_probs<CAUSAL, MASKED>(st, lse_t, kr0, q0, live, scale_log2);
    else dkv_probs<CAUSAL, false>(st, lse_t, kr0, q0, live, scale_log2);
  } else {
    if (part) dkv_probs<false, MASKED>(st, lse_t, kr0, q0, live, scale_log2);
    else dkv_probs<false, false>(st, lse_t, kr0, q0, live, scale_log2);
  }
}

template <int HD, bool MASKED>
__device__ __forceinline__ void dkv_produce(const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                            const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                            const float* lse, const float* delta,
                                            unsigned char* Ks, unsigned char* Vs,
                                            unsigned char* Qs, unsigned char* dOs,
                                            float* lse_s, float* dlt_s, uint64_t* full_kv,
                                            uint64_t* full, uint64_t* empty, const int* idx,
                                            int nq, int qt0, int G, int k0, int hk, int b,
                                            int S, int Hq) {
  using C = Dkv<HD>;
  hopper::mbar_arrive_expect_tx(full_kv, 2 * C::KV_BYTES);
#pragma unroll
  for (int c = 0; c < C::BOXES; ++c) {
    hopper::tma_load_4d(Ks + c * C::KV_BOX, tm_k, full_kv, c * BOX_COLS, hk, k0, b);
    hopper::tma_load_4d(Vs + c * C::KV_BOX, tm_v, full_kv, c * BOX_COLS, hk, k0, b);
  }
  for (int j = 0; j < G * nq; ++j) {
    const int s = j % C::STAGES;
    const uint32_t phase = (j / C::STAGES) & 1;
    const int h = hk * G + j / nq;
    const int qs = (MASKED ? idx[j % nq] : qt0 + j % nq) * DKV_BLOCK_M;
    hopper::mbar_wait(&empty[s], phase ^ 1);
    hopper::mbar_arrive_expect_tx(&full[s], C::STAGE_TX);
#pragma unroll
    for (int c = 0; c < C::BOXES; ++c) {
      hopper::tma_load_4d(Qs + s * C::Q_BYTES + c * C::Q_BOX, tm_q, &full[s], c * BOX_COLS,
                          h, qs, b);
      hopper::tma_load_4d(dOs + s * C::Q_BYTES + c * C::Q_BOX, tm_do, &full[s],
                          c * BOX_COLS, h, qs, b);
    }
    const int64_t row = ((int64_t)b * Hq + h) * S + qs;
    hopper::bulk_load(lse_s + s * DKV_BLOCK_M, lse + row, C::ROW_BYTES, &full[s]);
    hopper::bulk_load(dlt_s + s * DKV_BLOCK_M, delta + row, C::ROW_BYTES, &full[s]);
  }
}

// A consumer warpgroup of K3: keys 64 cg .. 64 cg + 63 of the CTA's tile.
template <typename T, int HD, bool CAUSAL, bool MASKED>
__device__ __forceinline__ void dkv_consume(const unsigned char* Ks, const unsigned char* Vs,
                                            const unsigned char* Qs, const unsigned char* dOs,
                                            const float* lse_s, const float* dlt_s,
                                            uint64_t* full_kv, uint64_t* full, uint64_t* empty,
                                            TileTable tt, int e0, int nq, int qt0, int n_iters,
                                            T* dk, T* dv, int S, int Hkv, int k0, int hk, int b,
                                            float scale, float scale_log2) {
  using C = Dkv<HD>;
  const int cg = consumer_group();
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int cw = cg * 4 + w;                   // consumer warp: keys 16 cw .. 16 cw + 15
  const int t4 = lane & 3;
  const int kr0 = k0 + 16 * cw;                // this warp's first key
  const unsigned char* k_rows = Ks + cg * WG_ROWS * BOX_ROW_BYTES;
  const unsigned char* v_rows = Vs + cg * WG_ROWS * BOX_ROW_BYTES;
  float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  if (n_iters > 0) hopper::mbar_wait(full_kv, 0);
  for (int j = 0; j < n_iters; ++j) {
    const int s = j % C::STAGES;
    const uint32_t phase = (j / C::STAGES) & 1;
    const int jq = j % nq;
    const int q0 = (MASKED ? tt.idx[e0 + jq] : qt0 + jq) * DKV_BLOCK_M;
    const uint32_t live =
        MASKED ? (tt.bits[(int64_t)(e0 + jq) * TILE_WORDS + (cw >> 1)] >> ((cw & 1) * 16)) &
                     0xFFFFu
               : 0xFFFFu;
    const unsigned char* Qt = Qs + s * C::Q_BYTES;
    const unsigned char* dOt = dOs + s * C::Q_BYTES;
    const float* lse_t = lse_s + s * DKV_BLOCK_M;
    const float* dlt_t = dlt_s + s * DKV_BLOCK_M;
    float st[DKV_BLOCK_M / 2], dpt[DKV_BLOCK_M / 2];
    hopper::mbar_wait(&full[s], phase);
    hopper::fence_regs(acc_k);
    hopper::fence_regs(acc_v);
    hopper::wgmma_fence();
    issue_scores<T, DKV_BLOCK_M, HD>(st, k_rows, C::KV_BOX, Qt, C::Q_BOX);    // S^T
    issue_scores<T, DKV_BLOCK_M, HD>(dpt, v_rows, C::KV_BOX, dOt, C::Q_BOX);  // dP^T
    hopper::wgmma_wait<1>();                   // S^T done; dP^T may still run
    hopper::fence_regs(st);
    dkv_probs_tile<CAUSAL, MASKED>(st, lse_t, kr0, q0, live, scale_log2);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dpt);
#pragma unroll
    for (int n = 0; n < DKV_BLOCK_M / 8; ++n) {   // dS^T, each column's delta
      const float2 d = *reinterpret_cast<const float2*>(dlt_t + 8 * n + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e;
        dpt[i] = st[i] * (dpt[i] - ((e & 1) ? d.y : d.x)) * scale;
      }
    }
    uint32_t pa[DKV_BLOCK_M / 16][4], da[DKV_BLOCK_M / 16][4];
    pack_all<T, DKV_BLOCK_M>(pa, st);
    pack_all<T, DKV_BLOCK_M>(da, dpt);
    hopper::wgmma_fence();
    issue_grad<T, HD, DKV_BLOCK_M / 16>(acc_v, pa, dOt, C::Q_BOX);   // dV += P^T dO
    issue_grad<T, HD, DKV_BLOCK_M / 16>(acc_k, da, Qt, C::Q_BOX);    // dK += dS^T Q
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc_k);
    hopper::fence_regs(acc_v);
    release(&empty[s]);
  }
  const int64_t stride = (int64_t)Hkv * HD;
  const int64_t off = ((int64_t)b * S + kr0) * stride + (int64_t)hk * HD;
  store_rows<T, HD>(dk + off, stride, acc_k);
  store_rows<T, HD>(dv + off, stride, acc_v);
}

template <typename T, int HD, bool CAUSAL, bool MASKED>
__global__ void __launch_bounds__(NUM_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     TileTable tt, int S, int Hq, int Hkv, float scale, float scale_log2) {
  using C = Dkv<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Vs = Ks + C::KV_BYTES;
  unsigned char* Qs = Vs + C::KV_BYTES;                // STAGES tiles
  unsigned char* dOs = Qs + C::STAGES * C::Q_BYTES;    // STAGES tiles
  float* lse_s = reinterpret_cast<float*>(dOs + C::STAGES * C::Q_BYTES);   // STAGES rows
  float* dlt_s = lse_s + C::STAGES * DKV_BLOCK_M;
  uint64_t* bars = reinterpret_cast<uint64_t*>(dlt_s + C::STAGES * DKV_BLOCK_M);
  uint64_t* full_kv = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + C::STAGES;

  // causal: key tile 0 sees the most queries; masked: the longest lists first
  const int kt = MASKED ? tt.order[blockIdx.x] : blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int k0 = kt * DKV_BLOCK_N;
  // query tiles per head: from the diagonal on when causal, or this key
  // tile's live list in the masked mode; walked for each head of the group
  const int e0 = MASKED ? tt.off[kt] : 0;
  const int qt0 = CAUSAL ? k0 / DKV_BLOCK_M : 0;
  const int nq = MASKED ? tt.off[kt + 1] - e0 : S / DKV_BLOCK_M - qt0;
  const int n_iters = G * nq;

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_kv, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0 && n_iters > 0)
      dkv_produce<HD, MASKED>(&tm_q, &tm_do, &tm_k, &tm_v, lse, delta, Ks, Vs, Qs, dOs,
                              lse_s, dlt_s, full_kv, full, empty,
                              MASKED ? tt.idx + e0 : nullptr, nq, qt0, G, k0, hk, b, S, Hq);
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    dkv_consume<T, HD, CAUSAL, MASKED>(Ks, Vs, Qs, dOs, lse_s, dlt_s, full_kv, full, empty,
                                       tt, e0, nq, qt0, n_iters, dk, dv, S, Hkv, k0, hk, b,
                                       scale, scale_log2);
  }
}

// ---------------------------------------------------------------------------
// fp32 (CUDA cores)
// ---------------------------------------------------------------------------

// Copy F32_BLOCK rows of HD floats, `stride` apart, into shared rows of
// HD + 1.
template <int HD>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int64_t stride) {
  for (int c = threadIdx.x; c < F32_BLOCK * HD; c += F32_THREADS)
    dst[(c / HD) * (HD + 1) + c % HD] = src[(c / HD) * stride + c % HD];
}

// this row's live 8-column groups of a 64 x 64 entry: bit column / 8
__device__ __forceinline__ uint32_t live_f32(const TileTable& tt, int e, int r) {
  return (tt.bits[(int64_t)e * 2 + (r >> 5)] >> (((r >> 3) & 3) * 8)) & 0xFF;
}

// A = X Y^T for F32_R rows (x_rows: the thread's rows of X) by F32_R
// columns (rows tx + 16 c of Y), over HD, two such products at once:
// every shared-memory value read feeds F32_R FMAs.
template <int HD>
__device__ __forceinline__ void scores_f32(float (&s)[F32_R][F32_R], float (&dp)[F32_R][F32_R],
                                           const float* x0, const float* y0, const float* x1,
                                           const float* y1, int ty, int tx) {
  constexpr int LD = HD + 1;
#pragma unroll
  for (int i = 0; i < F32_R; ++i)
#pragma unroll
    for (int c = 0; c < F32_R; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a0[F32_R], a1[F32_R], b0[F32_R], b1[F32_R];
#pragma unroll
    for (int i = 0; i < F32_R; ++i) {
      a0[i] = x0[(F32_R * ty + i) * LD + d];
      a1[i] = x1[(F32_R * ty + i) * LD + d];
      b0[i] = y0[(tx + 16 * i) * LD + d];
      b1[i] = y1[(tx + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < F32_R; ++i)
#pragma unroll
      for (int c = 0; c < F32_R; ++c) {
        s[i][c] = fmaf(a0[i], b0[c], s[i][c]);
        dp[i][c] = fmaf(a1[i], b1[c], dp[i][c]);
      }
  }
}

// K2 fp32: one CTA per (b, q head, 64-row query tile), 256 threads in a
// 16 x 16 grid (ty, tx): per 64-key tile each computes S and dP for rows
// 4 ty .. 4 ty + 3 x keys tx + 16 c, writes dS to shared memory, then
// accumulates dq for the same rows x hd columns tx + 16 c.
template <int HD, bool CAUSAL, bool MASKED>
__global__ void __launch_bounds__(F32_THREADS)
flash_bwd_dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, TileTable tt, int S, int Hq, int Hkv,
                         float scale) {
  constexpr int LD = HD + 1;        // odd stride: rows read in parallel hit distinct banks
  constexpr int PLD = F32_BLOCK + 1;
  constexpr int NC = HD / 16;       // hd columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + F32_BLOCK * LD;
  float* Ks = dOs + F32_BLOCK * LD;
  float* Vs = Ks + F32_BLOCK * LD;
  float* dSs = Vs + F32_BLOCK * LD;

  const int qi = MASKED ? tt.order[blockIdx.x] : gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qi * F32_BLOCK;

  const int64_t q_stride = (int64_t)Hq * HD;
  const int64_t kv_stride = (int64_t)Hkv * HD;
  const int64_t q_off = ((int64_t)b * S + q0) * q_stride + (int64_t)h * HD;
  const float* kb = k + (int64_t)b * S * kv_stride + (int64_t)hk * HD;
  const float* vb = v + (int64_t)b * S * kv_stride + (int64_t)hk * HD;
  load_rows_f32<HD>(Qs, q + q_off, q_stride);
  load_rows_f32<HD>(dOs, dout + q_off, q_stride);
  float lse_r[F32_R], dlt_r[F32_R];
#pragma unroll
  for (int i = 0; i < F32_R; ++i) {
    const int64_t row = ((int64_t)b * Hq + h) * S + q0 + F32_R * ty + i;
    lse_r[i] = lse[row];
    dlt_r[i] = delta[row];
  }

  float acc[F32_R][NC];
#pragma unroll
  for (int i = 0; i < F32_R; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  const int e0 = MASKED ? tt.off[qi] : 0;
  const int n_tiles = MASKED ? tt.off[qi + 1] - e0 : (CAUSAL ? qi + 1 : S / F32_BLOCK);
  for (int kj = 0; kj < n_tiles; ++kj) {
    const int kt = MASKED ? tt.idx[e0 + kj] : kj;
    __syncthreads();   // every thread is done with the last tile
    load_rows_f32<HD>(Ks, kb + (int64_t)kt * F32_BLOCK * kv_stride, kv_stride);
    load_rows_f32<HD>(Vs, vb + (int64_t)kt * F32_BLOCK * kv_stride, kv_stride);
    __syncthreads();
    float s[F32_R][F32_R], dp[F32_R][F32_R];
    scores_f32<HD>(s, dp, Qs, Ks, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < F32_R; ++i) {
      const int r = F32_R * ty + i;
      const uint32_t live = MASKED ? live_f32(tt, e0 + kj, r) : 0xFF;
#pragma unroll
      for (int c = 0; c < F32_R; ++c) {
        const int key = tx + 16 * c;
        float p = expf(s[i][c] * scale - lse_r[i]);
        if (CAUSAL && kt == qi && r < key) p = 0.f;
        if (MASKED && !((live >> (key >> 3)) & 1)) p = 0.f;   // masked: 0, never exp
        dSs[r * PLD + key] = p * (dp[i][c] - dlt_r[i]) * scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int key = 0; key < F32_BLOCK; ++key) {
      float ds[F32_R];
#pragma unroll
      for (int i = 0; i < F32_R; ++i) ds[i] = dSs[(F32_R * ty + i) * PLD + key];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = Ks[key * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < F32_R; ++i) acc[i][c] = fmaf(ds[i], kv, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < F32_R; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dq[q_off + (int64_t)(F32_R * ty + i) * q_stride + tx + 16 * c] = acc[i][c];
}

// K3 fp32: one CTA per (b, kv head, 64-key tile), 256 threads in a 16 x 16
// grid: for each (q head of the group, 64-row query tile) each computes
// S^T and dP^T for keys 4 ty .. 4 ty + 3 x queries tx + 16 c, writes P^T
// and dS^T to shared memory, then accumulates dk and dv for the same keys
// x hd columns tx + 16 c.
template <int HD, bool CAUSAL, bool MASKED>
__global__ void __launch_bounds__(F32_THREADS)
flash_bwd_dkv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, TileTable tt, int S,
                          int Hq, int Hkv, float scale) {
  constexpr int LD = HD + 1;
  constexpr int PLD = F32_BLOCK + 1;
  constexpr int NC = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + F32_BLOCK * LD;
  float* Qs = Vs + F32_BLOCK * LD;
  float* dOs = Qs + F32_BLOCK * LD;
  float* Ps = dOs + F32_BLOCK * LD;
  float* dSs = Ps + F32_BLOCK * PLD;
  float* lse_s = dSs + F32_BLOCK * PLD;
  float* dlt_s = lse_s + F32_BLOCK;

  const int kt = MASKED ? tt.order[blockIdx.x] : blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = kt * F32_BLOCK;

  const int64_t q_stride = (int64_t)Hq * HD;
  const int64_t kv_stride = (int64_t)Hkv * HD;
  const int64_t kv_off = ((int64_t)b * S + k0) * kv_stride + (int64_t)hk * HD;
  load_rows_f32<HD>(Ks, k + kv_off, kv_stride);
  load_rows_f32<HD>(Vs, v + kv_off, kv_stride);

  float acc_k[F32_R][NC], acc_v[F32_R][NC];
#pragma unroll
  for (int i = 0; i < F32_R; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int e0 = MASKED ? tt.off[kt] : 0;
  const int qt0 = CAUSAL ? kt : 0;
  const int nq = MASKED ? tt.off[kt + 1] - e0 : S / F32_BLOCK - qt0;
  for (int it = 0; it < G * nq; ++it) {
    const int h = hk * G + it / nq;
    const int qt = MASKED ? tt.idx[e0 + it % nq] : qt0 + it % nq;
    const int q0 = qt * F32_BLOCK;
    __syncthreads();
    const int64_t q_off = ((int64_t)b * S + q0) * q_stride + (int64_t)h * HD;
    load_rows_f32<HD>(Qs, q + q_off, q_stride);
    load_rows_f32<HD>(dOs, dout + q_off, q_stride);
    const int64_t row = ((int64_t)b * Hq + h) * S + q0;
    if (threadIdx.x < F32_BLOCK) lse_s[threadIdx.x] = lse[row + threadIdx.x];
    else if (threadIdx.x < 2 * F32_BLOCK)
      dlt_s[threadIdx.x - F32_BLOCK] = delta[row + threadIdx.x - F32_BLOCK];
    __syncthreads();
    float s[F32_R][F32_R], dp[F32_R][F32_R];
    scores_f32<HD>(s, dp, Ks, Qs, Vs, dOs, ty, tx);
#pragma unroll
    for (int i = 0; i < F32_R; ++i) {
      const int r = F32_R * ty + i;   // the key
      const uint32_t live = MASKED ? live_f32(tt, e0 + it % nq, r) : 0xFF;
#pragma unroll
      for (int c = 0; c < F32_R; ++c) {
        const int qq = tx + 16 * c;
        float p = expf(s[i][c] * scale - lse_s[qq]);
        if (CAUSAL && qt == kt && qq < r) p = 0.f;   // the query precedes the key
        if (MASKED && !((live >> (qq >> 3)) & 1)) p = 0.f;
        Ps[r * PLD + qq] = p;
        dSs[r * PLD + qq] = p * (dp[i][c] - dlt_s[qq]) * scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < F32_BLOCK; ++qq) {
      float pr[F32_R], ds[F32_R];
#pragma unroll
      for (int i = 0; i < F32_R; ++i) {
        pr[i] = Ps[(F32_R * ty + i) * PLD + qq];
        ds[i] = dSs[(F32_R * ty + i) * PLD + qq];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float o = dOs[qq * LD + tx + 16 * c], qv = Qs[qq * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < F32_R; ++i) {
          acc_v[i][c] = fmaf(pr[i], o, acc_v[i][c]);
          acc_k[i][c] = fmaf(ds[i], qv, acc_k[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < F32_R; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int64_t off = kv_off + (int64_t)(F32_R * ty + i) * kv_stride + tx + 16 * c;
      dk[off] = acc_k[i][c];
      dv[off] = acc_v[i][c];
    }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  TileTable tt;
  int B, S, Hq, Hkv;
  float scale;
};

// The four tensor maps of a 16-bit launch: q and dO in boxes of q_rows
// rows, k and v of kv_rows.  Returns 0 or a hopper::kEncode* code.
template <typename T, int HD>
int encode_maps(CUtensorMap (&tm)[4], const BwdArgs& a, int q_rows, int kv_rows) {
  const CUtensorMapDataType dt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int err = hopper::encode_bshd_map(&tm[0], a.q, dt, a.B, a.S, a.Hq, HD, q_rows);
  if (err == 0) err = hopper::encode_bshd_map(&tm[1], a.dout, dt, a.B, a.S, a.Hq, HD, q_rows);
  if (err == 0) err = hopper::encode_bshd_map(&tm[2], a.k, dt, a.B, a.S, a.Hkv, HD, kv_rows);
  if (err == 0) err = hopper::encode_bshd_map(&tm[3], a.v, dt, a.B, a.S, a.Hkv, HD, kv_rows);
  return err;
}

template <typename T, int HD, bool CAUSAL, bool MASKED>
int launch_dq(const BwdArgs& a, cudaStream_t stream) {
  CUtensorMap tm[4];
  const int err = encode_maps<T, HD>(tm, a, DQ_BLOCK_M, DQ_BLOCK_N);
  if (err != 0) return err;
  const int smem = Dq<HD>::SMEM;
  auto kern = flash_bwd_dq_kernel<T, HD, CAUSAL, MASKED>;
  cudaError_t cerr = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          smem);
  if (cerr != cudaSuccess) return cerr;
  dim3 grid(a.S / DQ_BLOCK_M, a.Hq, a.B);
  kern<<<grid, NUM_THREADS, smem, stream>>>(tm[0], tm[1], tm[2], tm[3], a.lse, a.delta,
                                            static_cast<T*>(a.dq), a.tt, a.S, a.Hq, a.Hkv,
                                            a.scale, a.scale * LOG2E);
  return cudaGetLastError();
}

template <typename T, int HD, bool CAUSAL, bool MASKED>
int launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  CUtensorMap tm[4];
  const int err = encode_maps<T, HD>(tm, a, DKV_BLOCK_M, DKV_BLOCK_N);
  if (err != 0) return err;
  const int smem = Dkv<HD>::SMEM;
  auto kern = flash_bwd_dkv_kernel<T, HD, CAUSAL, MASKED>;
  cudaError_t cerr = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          smem);
  if (cerr != cudaSuccess) return cerr;
  dim3 grid(a.S / DKV_BLOCK_N, a.Hkv, a.B);
  kern<<<grid, NUM_THREADS, smem, stream>>>(tm[0], tm[1], tm[2], tm[3], a.lse, a.delta,
                                            static_cast<T*>(a.dk), static_cast<T*>(a.dv),
                                            a.tt, a.S, a.Hq, a.Hkv, a.scale, a.scale * LOG2E);
  return cudaGetLastError();
}

template <int HD, bool CAUSAL, bool MASKED>
int launch_dq_fp32(const BwdArgs& a, cudaStream_t stream) {
  const int smem =
      (4 * F32_BLOCK * (HD + 1) + F32_BLOCK * (F32_BLOCK + 1)) * (int)sizeof(float);
  auto kern = flash_bwd_dq_fp32_kernel<HD, CAUSAL, MASKED>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.S / F32_BLOCK, a.Hq, a.B);
  kern<<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dq), a.tt, a.S, a.Hq, a.Hkv, a.scale);
  return cudaGetLastError();
}

template <int HD, bool CAUSAL, bool MASKED>
int launch_dkv_fp32(const BwdArgs& a, cudaStream_t stream) {
  const int smem = (4 * F32_BLOCK * (HD + 1) + 2 * F32_BLOCK * (F32_BLOCK + 1) +
                    2 * F32_BLOCK) * (int)sizeof(float);
  auto kern = flash_bwd_dkv_fp32_kernel<HD, CAUSAL, MASKED>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.S / F32_BLOCK, a.Hkv, a.B);
  kern<<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.tt, a.S, a.Hq, a.Hkv,
      a.scale);
  return cudaGetLastError();
}

// which: 0 = K2 (dq), 1 = K3 (dk, dv); dtype: 0 fp32, 1 fp16, 2 bf16
template <int HD, bool CAUSAL, bool MASKED>
int launch(int which, int dtype, const BwdArgs& a, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return which == 0 ? launch_dq_fp32<HD, CAUSAL, MASKED>(a, stream)
                        : launch_dkv_fp32<HD, CAUSAL, MASKED>(a, stream);
    case 1:
      return which == 0 ? launch_dq<__half, HD, CAUSAL, MASKED>(a, stream)
                        : launch_dkv<__half, HD, CAUSAL, MASKED>(a, stream);
    case 2:
      return which == 0 ? launch_dq<__nv_bfloat16, HD, CAUSAL, MASKED>(a, stream)
                        : launch_dkv<__nv_bfloat16, HD, CAUSAL, MASKED>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int HD>
int dispatch_mode(int which, int dtype, int causal, const BwdArgs& a, cudaStream_t stream) {
  const bool masked = a.tt.off != nullptr;
  if (causal)
    return masked ? launch<HD, true, true>(which, dtype, a, stream)
                  : launch<HD, true, false>(which, dtype, a, stream);
  return masked ? launch<HD, false, true>(which, dtype, a, stream)
                : launch<HD, false, false>(which, dtype, a, stream);
}

int run(int which, const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dq, void* dk, void* dv,
        TileTable tt, int B, int S, int Hq, int Hkv, int hd, int dtype, int causal,
        float sm_scale, void* stream) {
  if (S % DKV_BLOCK_N != 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, dout, lse, delta, dq, dk, dv, tt, B, S, Hq, Hkv, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return dispatch_mode<64>(which, dtype, causal, a, st);
  if (hd == 128) return dispatch_mode<128>(which, dtype, causal, a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  off/idx/bits/order: the
// live-tile table of the masked mode (K2: the "q" table of 128-row query
// tiles x 64-key tiles, or "f32" for float32; K3: the "kv" table of 128-key
// tiles x 64-row query tiles, or "f32kv"), all null when unmasked.  Each
// returns 0 on success, else the cudaError_t of its launch or a tensor-map
// code (ds_cuda_error_string reads both).  The Python wrapper has checked
// shapes, dtypes, contiguity, 16-byte alignment and S % 128 == 0 before
// calling.
int ds_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, const int* off,
                              const int* idx, const uint32_t* bits,
                              const int* order, int B, int S, int Hq, int Hkv,
                              int hd, int dtype, int causal, float sm_scale,
                              void* stream) {
  return run(0, q, k, v, dout, lse, delta, dq, nullptr, nullptr,
             TileTable{off, idx, bits, order}, B, S, Hq, Hkv, hd, dtype, causal,
             sm_scale, stream);
}

int ds_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dk, void* dv,
                               const int* off, const int* idx,
                               const uint32_t* bits, const int* order, int B,
                               int S, int Hq, int Hkv, int hd, int dtype,
                               int causal, float sm_scale, void* stream) {
  return run(1, q, k, v, dout, lse, delta, nullptr, dk, dv,
             TileTable{off, idx, bits, order}, B, S, Hq, Hkv, hd, dtype, causal,
             sm_scale, stream);
}

const char* ds_cuda_error_string(int err) {
  static thread_local char buf[96];
  if (err == hopper::kEncodeMissing)
    return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
  if (err >= hopper::kEncodeFailed) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed (CUresult %d)",
             err - hopper::kEncodeFailed);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
