// Flash-attention forward for Hopper (sm_90a), bound through ctypes.
//
// Replaces the Pallas kernel `_fwd_kernel` (launched by `_fwd`) in
// deepspeed_tpu/ops/pallas/flash_attention.py: causal or full attention with
// an online softmax, GQA by indexing KV head h / (Hq / Hkv) (no repeat), the
// finite NEG_INF mask, the l == 0 guard, P rounded to the input dtype before
// P.V, and outputs `out` (input dtype) plus `lse = m + log(l)` (fp32).
//
// Layout: q [B, S, Hq, hd], k/v [B, S, Hkv, hd] (contiguous, the model's own
// layout: no transposes around the call), out [B, S, Hq, hd], lse [B, Hq, S].
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): the training
// launch (B=1, S=16384, 14 heads of 128, causal) does 2 * 2 * S(S+1)/2 * hd
// * H = 962 GFLOP of tensor-core work -> 0.973 ms, against 235 MB of
// q/k/v/out traffic -> 0.070 ms; the serving launch (S=4096, 32 heads)
// 0.139 ms against 0.040 ms.  Compute-bound: the time goes to the two
// products and to the softmax between them, and Hopper reaches its
// tensor-core rate only through wgmma, fed from shared memory by TMA.
//
// Design (bf16 / fp16).  On the TPU the key sweep is the sequential
// innermost grid axis and the running max/sum/accumulator live in VMEM
// scratch across grid steps.  Hopper blocks run in parallel and in no
// order, so one CTA owns one (b, q-head, 128-row query tile) and walks the
// 128-key K/V tiles in a loop, up to the diagonal when causal; the running
// state lives in registers.  384 threads in three warpgroups with their
// own roles (warp specialisation):
//   - the producer warpgroup gives its registers away (setmaxnreg.dec to
//     24) and one thread issues TMA loads: the Q tile once, then K and V
//     tiles into a ring of STAGES shared-memory stages, each operand with
//     a full barrier (TMA completes its bytes) and an empty barrier (the 8
//     consumer warps arrive: K once S has read it, V once P V has).  The
//     tensor maps are 4-D over (hd, H, S, B) with the real strides, so a
//     head and a GQA KV head are box coordinates; 128-byte swizzle, an
//     hd-128 tile as two 64-column boxes;
//   - two consumer warpgroups (setmaxnreg.inc to 240) own 64 query rows
//     each.  S = Q.K^T is a wgmma m64n128k16 chain with both operands
//     K-major in swizzled shared memory; the online softmax runs on its
//     accumulator in the log2 domain (the scale folded into one FFMA per
//     element before ex2.approx, the row max reduced over the four lanes
//     of a row, the row sum per lane until the epilogue); P, rounded to
//     the input dtype, stays in registers as the A operand of O += P.V
//     (wgmma m64n{hd}k16, RS), with V read MN-major through the
//     descriptor's transpose bit (no transpose in memory).  Inside a
//     warpgroup the products of one tile overlap the softmax of the next:
//     iteration j issues S_j and P_{j-1} V_{j-1} together, waits for S_j
//     alone and runs its softmax while P V runs (see consume()).
// One CTA per SM (160 KB of shared memory at hd 128 with two stages), no
// register cap of two CTAs: the consumer's S and O accumulators (64 + 64
// fp32 at hd 128) and P (32 registers) fit in 240.  With 128-key tiles
// aligned to the 128-row query tiles only the diagonal tile masks element
// by element; heavy causal tiles (large query index) are launched first to
// shorten the tail.  ptxas serialises every wgmma of a kernel (warning
// C7513, each HGMMA then waits for the last) when a non-wgmma instruction
// writes a running wgmma's input registers, so P is packed only after P
// V's wait and every barrier wait comes before the wgmma.fence of the
// products it guards.  fp32 inputs take a separate CUDA-core (FMA) kernel:
// wgmma has only TF32 for them, which cannot meet the fp32 tolerance.
//
// Masked mode (`block_mask`, the block-sparse path; the Pallas kernel's
// `masked` skip at :88-93).  The Pallas kernel still streams every dead
// block's K/V through its pipeline; here the producer walks only the live
// key tiles of this query tile, from the wrapper's table (hopper_common.cuh
// TileTable, the "fwd" table at this kernel's 128 x 128 tiles; fp32 its
// own 64 x 64 "f32" table), so dead tiles cost neither loads nor math.  A
// table entry carries its live 8x8 element groups as 256 bits, one 32-bit
// word per consumer warp (its 16 rows: bit 16 r + key group, r = 0 for
// rows g, 1 for rows g + 8); only partly live tiles test elements.  Both
// warpgroups compute every visited tile, so control flow around the
// wgmmas stays uniform.  A dead element's score is -inf, so its p is 0
// even in a row that has seen no live key (m = NEG_INF there, where
// exp(NEG_INF - m) would be 1), and a row with no live key at all writes
// out 0 and lse = NEG_INF, as the Pallas kernel's l == 0 guard does.  A
// query tile with an empty list loads nothing and writes zeros.  CTAs take
// the query tiles with the longest lists first.
#include <cstdio>

#include "hopper_common.cuh"

namespace {

using hopper::LN2;
using hopper::LOG2E;
using hopper::NEG_INF;
using hopper::TileTable;

// tensor-core kernel (bf16 / fp16)
constexpr int BLOCK_M = 128;        // query rows per CTA: two consumer warpgroups x 64
constexpr int BLOCK_N = 128;        // keys per K/V tile
constexpr int NUM_THREADS = 384;    // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_REGS = 24;   // 128 x 24 + 256 x 240 <= 65536
constexpr int CONSUMER_REGS = 240;
constexpr int BOX_COLS = 64;        // 16-bit columns of one 128-byte swizzle box
constexpr int BOX_ROW_BYTES = 128;
static_assert(BLOCK_M % BLOCK_N == 0, "the causal diagonal must end a key tile");

// CUDA-core kernel (fp32)
constexpr int F32_BLOCK = 64;       // query rows per CTA == keys per tile
constexpr int F32_THREADS = 128;    // two threads per query row

template <int HD>
struct Fwd {
  static constexpr int STAGES = HD == 64 ? 3 : 2;
  static constexpr int BOXES = HD / BOX_COLS;
  static constexpr int Q_BOX = BLOCK_M * BOX_ROW_BYTES;    // bytes of one 64-column box
  static constexpr int KV_BOX = BLOCK_N * BOX_ROW_BYTES;
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int KV_BYTES = BOXES * KV_BOX;           // K or V, one stage
  // full q; full k, full v, empty k, empty v per stage
  static constexpr int N_BARRIERS = 1 + 4 * STAGES;
  // + 1024 bytes of slack to align the base (the swizzle atom)
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * N_BARRIERS;
};

// The pipeline's barriers: TMA fills a stage's K and V (full, one arrival
// with its bytes); the 8 consumer warps release them (empty), K as soon as
// S = Q K^T has read it, V once P V has.
struct Barriers {
  uint64_t* full_q;
  uint64_t* full_k;    // [STAGES] each
  uint64_t* full_v;
  uint64_t* empty_k;
  uint64_t* empty_v;
};

// The producer: one thread issues every TMA load of the CTA.
template <int HD, bool MASKED>
__device__ __forceinline__ void produce(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, unsigned char* Qs,
                                        unsigned char* Ks, unsigned char* Vs, Barriers bar,
                                        const int* idx, int n_tiles, int q0, int h,
                                        int hk, int b) {
  using C = Fwd<HD>;
  hopper::mbar_arrive_expect_tx(bar.full_q, C::Q_BYTES);
#pragma unroll
  for (int c = 0; c < C::BOXES; ++c)
    hopper::tma_load_4d(Qs + c * C::Q_BOX, tm_q, bar.full_q, c * BOX_COLS, h, q0, b);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % C::STAGES;
    const uint32_t phase = (j / C::STAGES) & 1;
    const int k0 = (MASKED ? idx[j] : j) * BLOCK_N;
    // wait until the stage's last K (then V) is released
    hopper::mbar_wait(&bar.empty_k[s], phase ^ 1);
    hopper::mbar_arrive_expect_tx(&bar.full_k[s], C::KV_BYTES);
#pragma unroll
    for (int c = 0; c < C::BOXES; ++c)
      hopper::tma_load_4d(Ks + s * C::KV_BYTES + c * C::KV_BOX, tm_k, &bar.full_k[s],
                          c * BOX_COLS, hk, k0, b);
    hopper::mbar_wait(&bar.empty_v[s], phase ^ 1);
    hopper::mbar_arrive_expect_tx(&bar.full_v[s], C::KV_BYTES);
#pragma unroll
    for (int c = 0; c < C::BOXES; ++c)
      hopper::tma_load_4d(Vs + s * C::KV_BYTES + c * C::KV_BOX, tm_v, &bar.full_v[s],
                          c * BOX_COLS, hk, k0, b);
  }
}

// lane 0 of each consumer warp arrives: the stage's K or V is read
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) hopper::mbar_arrive(empty);
}

// O += P V for one tile: P (rounded to the input dtype) from registers, V
// [keys, hd] the MN-major B operand (transpose bit), k step kc = 16 keys =
// 2048 bytes, the two 64-column boxes of an hd-128 tile KV_BOX bytes apart
// along N.  Issued and committed, not waited for.
template <typename T, int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2],
                                         const uint32_t (&pa)[BLOCK_N / 16][4],
                                         const unsigned char* Vt) {
#pragma unroll
  for (int kc = 0; kc < BLOCK_N / 16; ++kc) {
    const uint64_t db =
        hopper::sw128_desc(Vt + kc * 16 * BOX_ROW_BYTES, Fwd<HD>::KV_BOX, 1024);
    hopper::wgmma_rs<T, HD, 1>(acc, pa[kc], db, 1);
  }
  hopper::wgmma_commit();
}

// Pins the registers P V reads: writes to them stay before wgmma.fence.
template <int HD>
__device__ __forceinline__ void fence_operands(float (&acc)[HD / 2],
                                               uint32_t (&pa)[BLOCK_N / 16][4]) {
  hopper::fence_regs(acc);
#pragma unroll
  for (int kc = 0; kc < BLOCK_N / 16; ++kc) hopper::fence_regs(pa[kc]);
}

// S = Q K^T for the warpgroup's 64 rows x 128 keys: hd / 16 k steps, 4 per
// 64-column box.  Issued and committed, not waited for.
template <typename T, int HD>
__device__ __forceinline__ void issue_s(float (&sc)[BLOCK_N / 2], const unsigned char* q_rows,
                                        const unsigned char* Kt) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = (kk % 4) * 32;   // bytes into the 128-byte row
    const uint64_t da =
        hopper::sw128_desc(q_rows + (kk / 4) * Fwd<HD>::Q_BOX + off, 16, 1024);
    const uint64_t db = hopper::sw128_desc(Kt + (kk / 4) * Fwd<HD>::KV_BOX + off, 16, 1024);
    hopper::wgmma_ss<T, BLOCK_N, 0, 0>(sc, da, db, kk > 0);
  }
  hopper::wgmma_commit();
}

// The online softmax of one tile on the S accumulator (log2 domain): mask
// the causal diagonal and, in partly live tiles, the dead groups (`live`:
// this warp's word, bit 16 hf + key group); update the running max m (taken
// on the raw scores: the scale is positive) and this lane's part of the sum
// l, with p = exp2(s scale log2(e) - m) as one FFMA and one MUFU.EX2 per
// element; return alpha = exp2(m_old - m_new) per row, and p in sc.
// sc[i]: row r0 + g + 8 hf, key k0 + 8 (i / 4) + 2 t4 + (i & 1), hf =
// (i >> 1) & 1.
template <bool DIAG, bool PART>
__device__ __forceinline__ void softmax_tile(float (&sc)[BLOCK_N / 2], float (&m_i)[2],
                                             float (&l_i)[2], float (&alpha)[2], int r0,
                                             int k0, uint32_t live, float scale_log2) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  constexpr bool diag = DIAG, part = PART;
  float mc[2] = {-CUDART_INF_F, -CUDART_INF_F};   // of the raw scores
#pragma unroll
  for (int i = 0; i < BLOCK_N / 2; ++i) {
    const int hf = (i >> 1) & 1;
    float x = sc[i];
    if (diag && r0 + g + 8 * hf < k0 + 8 * (i / 4) + 2 * t4 + (i & 1)) x = NEG_INF;
    // a dead group's score is -inf, not NEG_INF: m stays finite (it starts
    // at NEG_INF), so p = exp2(-inf - m) = 0 even in a row that has seen no
    // live key yet
    if (part && !((live >> (hf * 16 + i / 4)) & 1)) x = -CUDART_INF_F;
    sc[i] = x;
    mc[hf] = fmaxf(mc[hf], x);
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffff, mc[r], 1));
    mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffff, mc[r], 2));
    const float m_new = fmaxf(m_i[r], mc[r] * scale_log2);
    alpha[r] = hopper::exp2_ftz(m_i[r] - m_new);
    m_i[r] = m_new;
  }
  const float neg_m[2] = {-m_i[0], -m_i[1]};
#pragma unroll
  for (int i = 0; i < BLOCK_N / 2; ++i) {
    const int hf = (i >> 1) & 1;
    const float x = hopper::exp2_ftz(fmaf(sc[i], scale_log2, neg_m[hf]));
    sc[i] = x;
    rs[hf] += x;
  }
  // l per lane: summed over the row's four lanes in the epilogue (alpha is
  // the same on all four)
#pragma unroll
  for (int r = 0; r < 2; ++r) l_i[r] = alpha[r] * l_i[r] + rs[r];
}

// The softmax with the masks this warp's tile needs, chosen per tile: the
// element tests are compiled only into the variants that run them (on
// the diagonal tile, on partly live tiles), not predicated on every tile.
template <bool CAUSAL, bool MASKED>
__device__ __forceinline__ void softmax(float (&sc)[BLOCK_N / 2], float (&m_i)[2],
                                        float (&l_i)[2], float (&alpha)[2], int r0, int k0,
                                        uint32_t live, float scale_log2) {
  const bool diag = CAUSAL && k0 + BLOCK_N - 1 > r0;
  const bool part = MASKED && live != 0xFFFFFFFFu;
  if (diag) {
    if (part) softmax_tile<CAUSAL, MASKED>(sc, m_i, l_i, alpha, r0, k0, live, scale_log2);
    else softmax_tile<CAUSAL, false>(sc, m_i, l_i, alpha, r0, k0, live, scale_log2);
  } else {
    if (part) softmax_tile<false, MASKED>(sc, m_i, l_i, alpha, r0, k0, live, scale_log2);
    else softmax_tile<false, false>(sc, m_i, l_i, alpha, r0, k0, live, scale_log2);
  }
}

// P rounded to the input dtype, as the JAX kernel rounds it before its
// second dot, into the A registers of P V.
template <typename T>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BLOCK_N / 16][4],
                                       const float (&sc)[BLOCK_N / 2]) {
#pragma unroll
  for (int kc = 0; kc < BLOCK_N / 16; ++kc) hopper::pack_a<T, BLOCK_N>(pa[kc], sc, kc);
}

// A consumer warpgroup: rows 64 cg .. 64 cg + 63 of the query tile.  The
// products of one tile overlap the softmax of the next: iteration j issues
// S_j = Q K_j^T and then O += P_{j-1} V_{j-1} (the previous tile's P, still
// in registers), waits for S_j alone and runs tile j's softmax while P V
// runs on the tensor cores, then waits for P V and rescales O by tile j's
// alpha.  So O lags one tile behind m and l; tile 0 has no P V before it
// and the last tile's runs after the loop.  Every barrier wait comes before
// the wgmma.fence of its products, so nothing but wgmma runs between the
// fence and the waits.  Both warpgroups compute every visited tile (a row
// with no live key in it gets p = 0), so control flow is uniform.
template <typename T, int HD, bool CAUSAL, bool MASKED>
__device__ __forceinline__ void consume(const unsigned char* Qs, const unsigned char* Ks,
                                        const unsigned char* Vs, Barriers bar,
                                        TileTable tt, int e0, int n_tiles, T* o, float* lse,
                                        int S, int Hq, int q0, int h, int b,
                                        float scale_log2) {
  using C = Fwd<HD>;
  // the warpgroup, through a shuffle so that the compiler sees it uniform
  // across the warp: the descriptors built from it then live in uniform
  // registers, as wgmma wants them
  const int cg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0) - 1;
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int cw = cg * 4 + w;                   // consumer warp: rows 16 cw .. 16 cw + 15
  const int g = lane >> 2, t4 = lane & 3;      // fragment coordinates
  const int r0 = q0 + 16 * cw;                 // this warp's first row

  // rows r0 + g and r0 + g + 8: index 0 and 1
  float m_i[2] = {NEG_INF, NEG_INF};   // running max, log2 domain
  float l_i[2] = {0.f, 0.f};
  float alpha[2];
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  uint32_t pa[BLOCK_N / 16][4];        // P of the previous tile
  const unsigned char* q_rows = Qs + cg * 64 * BOX_ROW_BYTES;
  // key tile j: its first key, and this warp's live 8x8 groups of it (all
  // live when unmasked)
  auto key0 = [&](int j) { return (MASKED ? tt.idx[e0 + j] : j) * BLOCK_N; };
  auto live = [&](int j) { return MASKED ? tt.bits[(int64_t)(e0 + j) * 8 + cw] : 0xFFFFFFFFu; };

  if (n_tiles > 0) {
    hopper::mbar_wait(bar.full_q, 0);
    {   // tile 0: S and its softmax
      float sc[BLOCK_N / 2];
      hopper::mbar_wait(&bar.full_k[0], 0);
      hopper::wgmma_fence();
      issue_s<T, HD>(sc, q_rows, Ks);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      release(&bar.empty_k[0]);
      softmax<CAUSAL, MASKED>(sc, m_i, l_i, alpha, r0, key0(0), live(0), scale_log2);
      pack_p<T>(pa, sc);
    }
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % C::STAGES, ps = (j - 1) % C::STAGES;
      const uint32_t phase = (j / C::STAGES) & 1, pphase = ((j - 1) / C::STAGES) & 1;
      const int k0 = key0(j);
      const uint32_t lv = live(j);
      float sc[BLOCK_N / 2];
      hopper::mbar_wait(&bar.full_k[s], phase);
      hopper::mbar_wait(&bar.full_v[ps], pphase);
      fence_operands<HD>(acc, pa);   // O's rescale and P's copy come before the fence
      hopper::wgmma_fence();
      issue_s<T, HD>(sc, q_rows, Ks + s * C::KV_BYTES);
      issue_pv<T, HD>(acc, pa, Vs + ps * C::KV_BYTES);
      hopper::wgmma_wait<1>();       // S done; P V may still run
      hopper::fence_regs(sc);
      release(&bar.empty_k[s]);
      softmax<CAUSAL, MASKED>(sc, m_i, l_i, alpha, r0, k0, lv, scale_log2);
      // the previous tile's P V is done: only now may P's registers be
      // rewritten (a write to them while P V runs serialises every wgmma)
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release(&bar.empty_v[ps]);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack_p<T>(pa, sc);
    }
    {   // the last tile's P V
      const int ps = (n_tiles - 1) % C::STAGES;
      hopper::mbar_wait(&bar.full_v[ps], ((n_tiles - 1) / C::STAGES) & 1);
      fence_operands<HD>(acc, pa);
      hopper::wgmma_fence();
      issue_pv<T, HD>(acc, pa, Vs + ps * C::KV_BYTES);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release(&bar.empty_v[ps]);
    }
  }

  // epilogue: l summed over the row's lanes, normalise (l == 0 guard),
  // write out and lse (NEG_INF for a row with no live key)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffff, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffff, l_i[r], 2);
  }
  const int64_t q_stride = (int64_t)Hq * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = l_i[r] == 0.f ? 1.f : l_i[r];
    const int row = r0 + g + 8 * r;
    T* orow = o + ((int64_t)b * S + row) * q_stride + (int64_t)h * HD;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      *reinterpret_cast<uint32_t*>(orow + 8 * c + 2 * t4) = hopper::WgmmaType<T>::pack(
          acc[4 * c + 2 * r] / l_safe, acc[4 * c + 2 * r + 1] / l_safe);
    }
    if (t4 == 0)
      lse[((int64_t)b * Hq + h) * S + row] = l_i[r] == 0.f ? NEG_INF
                                                           : m_i[r] * LN2 + logf(l_safe);
  }
}

template <typename T, int HD, bool CAUSAL, bool MASKED>
__global__ void __launch_bounds__(NUM_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o,
                       float* __restrict__ lse, TileTable tt, int S, int Hq, int Hkv,
                       float scale_log2) {
  using C = Fwd<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = Qs + C::Q_BYTES;                 // STAGES tiles
  unsigned char* Vs = Ks + C::STAGES * C::KV_BYTES;    // STAGES tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + C::STAGES * C::KV_BYTES);
  const Barriers bar{bars, bars + 1, bars + 1 + C::STAGES, bars + 1 + 2 * C::STAGES,
                     bars + 1 + 3 * C::STAGES};

  // heavy tiles first: the longest live lists, or the late causal rows
  const int qi = MASKED ? tt.order[blockIdx.x] : gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qi * BLOCK_M;
  // the key tiles visited: 0 .. n_tiles - 1 (up to the diagonal when
  // causal), or this query tile's live list in the masked mode
  const int e0 = MASKED ? tt.off[qi] : 0;
  const int n_tiles = MASKED ? tt.off[qi + 1] - e0
                             : (CAUSAL ? (q0 + BLOCK_M) / BLOCK_N : S / BLOCK_N);

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar.full_q, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(&bar.full_k[s], 1);
      hopper::mbar_init(&bar.full_v[s], 1);
      hopper::mbar_init(&bar.empty_k[s], 8);   // one arrival per consumer warp
      hopper::mbar_init(&bar.empty_v[s], 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0 && n_tiles > 0)
      produce<HD, MASKED>(&tm_q, &tm_k, &tm_v, Qs, Ks, Vs, bar,
                          MASKED ? tt.idx + e0 : nullptr, n_tiles, q0, h, hk, b);
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    consume<T, HD, CAUSAL, MASKED>(Qs, Ks, Vs, bar, tt, e0, n_tiles, o, lse, S, Hq, q0, h,
                                   b, scale_log2);
  }
}

// fp32 inputs: 64-row tiles on CUDA cores.  Two threads per query row;
// each scores half of the tile's keys, then each accumulates half of hd.
template <int HD, bool CAUSAL, bool MASKED>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, TileTable tt, int S, int Hq, int Hkv,
                      float sm_scale) {
  constexpr int LD = HD + 1;        // odd stride: row-parallel reads hit distinct banks
  constexpr int PLD = F32_BLOCK + 1;
  constexpr int HALF_N = F32_BLOCK / 2, HALF_D = HD / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + F32_BLOCK * LD;
  float* Vs = Ks + F32_BLOCK * LD;
  float* Ps = Vs + F32_BLOCK * LD;

  const int qi = MASKED ? tt.order[blockIdx.x] : gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int q0 = qi * F32_BLOCK;

  const int64_t q_stride = (int64_t)Hq * HD;
  const int64_t kv_stride = (int64_t)Hkv * HD;
  const float* qb = q + ((int64_t)b * S + q0) * q_stride + (int64_t)h * HD;
  const float* kb = k + (int64_t)b * S * kv_stride + (int64_t)hk * HD;
  const float* vb = v + (int64_t)b * S * kv_stride + (int64_t)hk * HD;

  for (int c = threadIdx.x; c < F32_BLOCK * HD; c += F32_THREADS)
    Qs[(c / HD) * LD + c % HD] = qb[(c / HD) * q_stride + c % HD];

  float m_i = NEG_INF, l_i = 0.f;
  float acc[HALF_D];
#pragma unroll
  for (int d = 0; d < HALF_D; ++d) acc[d] = 0.f;

  const int e0 = MASKED ? tt.off[qi] : 0;
  const int n_tiles = MASKED ? tt.off[qi + 1] - e0 : (CAUSAL ? qi + 1 : S / F32_BLOCK);
  for (int kj = 0; kj < n_tiles; ++kj) {
    const int kt = MASKED ? tt.idx[e0 + kj] : kj;
    const int k0 = kt * F32_BLOCK;
    // this row's live 8-key groups of the tile: bit key / 8
    const uint32_t live =
        MASKED ? (tt.bits[(e0 + kj) * 2 + (r >> 5)] >> (((r >> 3) & 3) * 8)) & 0xFF : 0xFF;
    __syncthreads();
    for (int c = threadIdx.x; c < F32_BLOCK * HD; c += F32_THREADS) {
      const int64_t src = (int64_t)(k0 + c / HD) * kv_stride + c % HD;
      Ks[(c / HD) * LD + c % HD] = kb[src];
      Vs[(c / HD) * LD + c % HD] = vb[src];
    }
    __syncthreads();

    float s[HALF_N];
    float mc = NEG_INF;
#pragma unroll
    for (int j = 0; j < HALF_N; ++j) {
      const int key = 2 * j + half;
      float dot = 0.f;
      for (int d = 0; d < HD; ++d) dot = fmaf(Qs[r * LD + d], Ks[key * LD + d], dot);
      float x = dot * sm_scale;
      if (CAUSAL && kt == qi && r < key) x = NEG_INF;
      if (MASKED && !((live >> (key >> 3)) & 1)) x = -CUDART_INF_F;   // p = 0 (see above)
      s[j] = x;
      mc = fmaxf(mc, x);
    }
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffff, mc, 1));
    const float m_new = fmaxf(m_i, mc);
    const float alpha = expf(m_i - m_new);
    m_i = m_new;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < HALF_N; ++j) {
      const float p = expf(s[j] - m_new);
      rs += p;
      Ps[r * PLD + 2 * j + half] = p;
    }
    rs += __shfl_xor_sync(0xffffffff, rs, 1);
    l_i = alpha * l_i + rs;
    __syncwarp();   // the row's two threads are lanes of one warp
#pragma unroll
    for (int d = 0; d < HALF_D; ++d) acc[d] *= alpha;
    for (int key = 0; key < F32_BLOCK; ++key) {
      const float p = Ps[r * PLD + key];
      const float* vrow = Vs + key * LD + half * HALF_D;
#pragma unroll
      for (int d = 0; d < HALF_D; ++d) acc[d] = fmaf(p, vrow[d], acc[d]);
    }
  }

  const float l_safe = l_i == 0.f ? 1.f : l_i;
  float* orow = o + ((int64_t)b * S + q0 + r) * q_stride + (int64_t)h * HD + half * HALF_D;
#pragma unroll
  for (int d = 0; d < HALF_D; ++d) orow[d] = acc[d] / l_safe;
  if (half == 0)
    lse[((int64_t)b * Hq + h) * S + q0 + r] = l_i == 0.f ? NEG_INF : m_i + logf(l_safe);
}

struct FwdArgs {
  const void *q, *k, *v;
  void* o;
  float* lse;
  TileTable tt;
  int B, S, Hq, Hkv;
  float scale;
};

// Returns a cudaError_t, or a hopper::kEncode* code of the tensor maps.
template <typename T, int HD, bool CAUSAL, bool MASKED>
int launch_wgmma(const FwdArgs& a, cudaStream_t stream) {
  const CUtensorMapDataType dt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tm_q, tm_k, tm_v;
  int err = hopper::encode_bshd_map(&tm_q, a.q, dt, a.B, a.S, a.Hq, HD, BLOCK_M);
  if (err == 0) err = hopper::encode_bshd_map(&tm_k, a.k, dt, a.B, a.S, a.Hkv, HD, BLOCK_N);
  if (err == 0) err = hopper::encode_bshd_map(&tm_v, a.v, dt, a.B, a.S, a.Hkv, HD, BLOCK_N);
  if (err != 0) return err;
  const int smem = Fwd<HD>::SMEM;
  auto kern = flash_fwd_wgmma_kernel<T, HD, CAUSAL, MASKED>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return cerr;
  dim3 grid(a.S / BLOCK_M, a.Hq, a.B);
  kern<<<grid, NUM_THREADS, smem, stream>>>(tm_q, tm_k, tm_v, static_cast<T*>(a.o), a.lse,
                                            a.tt, a.S, a.Hq, a.Hkv, a.scale * LOG2E);
  return cudaGetLastError();
}

template <int HD, bool CAUSAL, bool MASKED>
int launch_fp32(const FwdArgs& a, cudaStream_t stream) {
  const int smem = (3 * F32_BLOCK * (HD + 1) + F32_BLOCK * (F32_BLOCK + 1)) *
                   (int)sizeof(float);
  auto kern = flash_fwd_fp32_kernel<HD, CAUSAL, MASKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.S / F32_BLOCK, a.Hq, a.B);
  kern<<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.tt, a.S,
      a.Hq, a.Hkv, a.scale);
  return cudaGetLastError();
}

template <int HD, bool CAUSAL, bool MASKED>
int dispatch_dtype(int dtype, const FwdArgs& a, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_fp32<HD, CAUSAL, MASKED>(a, stream);
    case 1: return launch_wgmma<__half, HD, CAUSAL, MASKED>(a, stream);
    case 2: return launch_wgmma<__nv_bfloat16, HD, CAUSAL, MASKED>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int HD>
int dispatch_mode(int dtype, int causal, const FwdArgs& a, cudaStream_t stream) {
  const bool masked = a.tt.off != nullptr;
  if (causal)
    return masked ? dispatch_dtype<HD, true, true>(dtype, a, stream)
                  : dispatch_dtype<HD, true, false>(dtype, a, stream);
  return masked ? dispatch_dtype<HD, false, true>(dtype, a, stream)
                : dispatch_dtype<HD, false, false>(dtype, a, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  off/idx/bits/order: the
// live-tile table of the masked mode (the "f32" table of 64 x 64 tiles for
// float32, the "fwd" table of 128 x 128 tiles otherwise), all null when
// unmasked.  Returns 0 on success, else the cudaError_t of the launch or a
// tensor-map code (ds_cuda_error_string reads both).  The Python wrapper
// has checked shapes, dtypes, contiguity, 16-byte alignment and
// S % 128 == 0 before calling.
int ds_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                           float* lse, const int* off, const int* idx,
                           const uint32_t* bits, const int* order, int B, int S,
                           int Hq, int Hkv, int hd, int dtype, int causal,
                           float sm_scale, void* stream) {
  if (S % BLOCK_M != 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const FwdArgs a{q, k, v, o, lse, TileTable{off, idx, bits, order}, B, S, Hq, Hkv,
                  sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return dispatch_mode<64>(dtype, causal, a, st);
  if (hd == 128) return dispatch_mode<128>(dtype, causal, a, st);
  return cudaErrorInvalidValue;
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
