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
// `ds.astype(k.dtype)`).  As there, the design keeps two kernels and no
// atomics, so every gradient is written by exactly one CTA and the result
// is deterministic.
//
// Layout: q, dO, dq [B, S, Hq, hd]; k, v, dk, dv [B, S, Hkv, hd] (the model's
// own layout: no transposes around the calls); lse and delta fp32 [B, Hq, S].
//
// Design.  On the TPU the sweep over the other sequence axis is the
// sequential innermost grid axis with the accumulator in VMEM scratch.
// Hopper blocks run in parallel, so each CTA owns its output tile and loops:
//   K2: one CTA per (b, q head, 128-row query tile), 8 warps x 16 rows,
//       walking 64-key K/V tiles up to the diagonal in a two-stage cp.async
//       pipeline (as K1).  S = Q K^T and dP = dO V^T share the loop over
//       hd; ds re-packs in registers as the A operand of ds . K, whose B
//       operand is K read with ldmatrix.trans.  The dq accumulator stays in
//       registers.
//   K3: one CTA per (b, kv head, 128-key tile), 8 warps x 16 keys, K and V
//       resident in shared memory; the loop walks every (q head of the GQA
//       group, 32-row query tile) pair from the diagonal on, with the Q, dO,
//       lse and delta tiles in a two-stage cp.async pipeline.  Everything
//       runs transposed (S^T = K Q^T, dP^T = V dO^T), so p^T and ds^T are
//       already in the accumulator layout that re-packs as the A operand of
//       p^T . dO and ds^T . Q (B operands dO and Q via ldmatrix.trans).  The
//       group sum stays in the dk/dv register accumulators: no [B, S, Hq, hd]
//       intermediate.  The two fp32 accumulators of 16 keys x hd take 128
//       registers a thread at hd = 128, so the kernel runs one CTA per SM
//       (__launch_bounds__(256, 1)) and keeps the score tiles at 32 queries.
// A warp skips a tile that lies wholly above the diagonal for its rows;
// heavy causal tiles are scheduled first.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s) at the training
// shape (B=1, S=16384, 14 heads of 128, causal): K2 does 3 products over
// the S(S+1)/2 attended pairs, 1.44 TFLOP -> 1.46 ms; K3 does 4, 1.92 TFLOP
// -> 1.95 ms; against 5 (K2) or 6 (K3) [S, 14, 128] bf16 tensors of traffic
// (~0.1 ms): compute-bound.  mma.sync cannot reach wgmma's rate; PERF.md
// records the measured times.  fp32 inputs are refused by the wrapper.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int NUM_THREADS = 256;   // 8 warps
constexpr int DQ_BLOCK_M = 128;    // K2: query rows per CTA (8 warps x 16)
constexpr int DQ_BLOCK_N = 64;     // K2: keys per K/V tile
constexpr int DKV_BLOCK_N = 128;   // K3: keys per CTA (8 warps x 16)
constexpr int DKV_BLOCK_M = 32;    // K3: query rows per tile

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(NUM_THREADS, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int S, int Hq, int Hkv, float scale,
                    float scale_log2) {
  constexpr int LD = HD + 8;   // padded shared-memory row, in elements
  constexpr int KV_TILE = DQ_BLOCK_N * LD;
  constexpr int SZ = (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + DQ_BLOCK_M * LD;
  T* Ks = dOs + DQ_BLOCK_M * LD;     // two stages
  T* Vs = Ks + 2 * KV_TILE;          // two stages

  const int qi = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp * 16;
  const int q0 = qi * DQ_BLOCK_M;

  const int64_t q_stride = (int64_t)Hq * HD;
  const int64_t kv_stride = (int64_t)Hkv * HD;
  const int64_t q_off = ((int64_t)b * S + q0) * q_stride + (int64_t)h * HD;
  const T* kb = k + (int64_t)b * S * kv_stride + (int64_t)hk * HD;
  const T* vb = v + (int64_t)b * S * kv_stride + (int64_t)hk * HD;

  const int n_tiles = CAUSAL ? (q0 + DQ_BLOCK_M) / DQ_BLOCK_N : S / DQ_BLOCK_N;
  cp_tile<T, HD, LD, DQ_BLOCK_M, NUM_THREADS>(Qs, q + q_off, q_stride);
  cp_tile<T, HD, LD, DQ_BLOCK_M, NUM_THREADS>(dOs, dout + q_off, q_stride);
  cp_tile<T, HD, LD, DQ_BLOCK_N, NUM_THREADS>(Ks, kb, kv_stride);
  cp_tile<T, HD, LD, DQ_BLOCK_N, NUM_THREADS>(Vs, vb, kv_stride);
  cp_async_commit();

  // this thread's rows (wr + g) and (wr + g + 8): lse (log2 domain), delta
  const int64_t row_off = ((int64_t)b * Hq + h) * S + q0 + wr + g;
  const float lse2[2] = {lse[row_off] * LOG2E, lse[row_off + 8] * LOG2E};
  const float dlt[2] = {delta[row_off], delta[row_off + 8]};

  const uint32_t q_base = smem_addr(Qs + a_lane(wr, lane, LD));
  const uint32_t do_base = smem_addr(dOs + a_lane(wr, lane, LD));
  const int n_lane = b_lane_rows_n(lane, LD);
  const int k_lane = b_lane_rows_k(lane, LD);

  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int kj = 0; kj < n_tiles; ++kj) {
    const int stage = kj & 1;
    if (kj + 1 < n_tiles) {   // prefetch the next tile into the other stage
      const int64_t next = (int64_t)(kj + 1) * DQ_BLOCK_N * kv_stride;
      cp_tile<T, HD, LD, DQ_BLOCK_N, NUM_THREADS>(Ks + (stage ^ 1) * KV_TILE,
                                                  kb + next, kv_stride);
      cp_tile<T, HD, LD, DQ_BLOCK_N, NUM_THREADS>(Vs + (stage ^ 1) * KV_TILE,
                                                  vb + next, kv_stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int k0 = kj * DQ_BLOCK_N;
    if (!(CAUSAL && k0 > q0 + wr + 15)) {
      const T* Kst = Ks + stage * KV_TILE;
      const T* Vst = Vs + stage * KV_TILE;
      const uint32_t kn_base = smem_addr(Kst + n_lane);   // K as B of Q K^T
      const uint32_t vn_base = smem_addr(Vst + n_lane);   // V as B of dO V^T
      const uint32_t kk_base = smem_addr(Kst + k_lane);   // K as B of ds K

      // S = Q K^T and dP = dO V^T: 16 rows x 64 keys each
      float s[DQ_BLOCK_N / 8][4], dp[DQ_BLOCK_N / 8][4];
#pragma unroll
      for (int nt = 0; nt < DQ_BLOCK_N / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t aq[4], ado[4];
        ldsm_x4(aq, q_base + kk * 16 * SZ);
        ldsm_x4(ado, do_base + kk * 16 * SZ);
#pragma unroll
        for (int np = 0; np < DQ_BLOCK_N / 16; ++np) {
          uint32_t bk[4], bv[4];
          ldsm_x4(bk, kn_base + (np * 16 * LD + kk * 16) * SZ);
          Mma<T>::run(s[2 * np], aq, bk[0], bk[1]);
          Mma<T>::run(s[2 * np + 1], aq, bk[2], bk[3]);
          ldsm_x4(bv, vn_base + (np * 16 * LD + kk * 16) * SZ);
          Mma<T>::run(dp[2 * np], ado, bv[0], bv[1]);
          Mma<T>::run(dp[2 * np + 1], ado, bv[2], bv[3]);
        }
      }

      // p = exp(s * scale - lse), 0 above the diagonal; ds into s
      const bool diag = CAUSAL && k0 + DQ_BLOCK_N - 1 > q0 + wr;
#pragma unroll
      for (int nt = 0; nt < DQ_BLOCK_N / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[nt][e] * scale_log2 - lse2[e >> 1]);
          if (diag) {
            const int row = q0 + wr + g + (e >= 2 ? 8 : 0);
            const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
            if (row < col) p = 0.f;
          }
          s[nt][e] = p * (dp[nt][e] - dlt[e >> 1]) * scale;
        }
      }

      // dq += ds K (contracting over this tile's 64 keys)
#pragma unroll
      for (int kc = 0; kc < DQ_BLOCK_N / 16; ++kc) {
        uint32_t da[4];
        pack_a<T>(da, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
        for (int d2 = 0; d2 < HD / 16; ++d2) {
          uint32_t bk[4];
          ldsm_x4_trans(bk, kk_base + (kc * 16 * LD + d2 * 16) * SZ);
          Mma<T>::run(acc[2 * d2], da, bk[0], bk[1]);
          Mma<T>::run(acc[2 * d2 + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage before reuse
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    T* row = dq + q_off + (int64_t)(wr + g + r * 8) * q_stride;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<uint32_t*>(row + dt * 8 + t4 * 2) =
          Mma<T>::pack(acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(NUM_THREADS, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int S, int Hq,
                     int Hkv, float scale, float scale_log2) {
  constexpr int LD = HD + 8;
  constexpr int Q_TILE = DKV_BLOCK_M * LD;
  constexpr int SZ = (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* lse_s = reinterpret_cast<float*>(smem_raw);   // two stages
  float* dlt_s = lse_s + 2 * DKV_BLOCK_M;               // two stages
  T* Ks = reinterpret_cast<T*>(dlt_s + 2 * DKV_BLOCK_M);
  T* Vs = Ks + DKV_BLOCK_N * LD;
  T* Qs = Vs + DKV_BLOCK_N * LD;                         // two stages
  T* dOs = Qs + 2 * Q_TILE;                              // two stages

  const int kt = blockIdx.x;   // causal: tile 0 sees the most queries
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp * 16;
  const int k0 = kt * DKV_BLOCK_N;

  const int64_t q_stride = (int64_t)Hq * HD;
  const int64_t kv_stride = (int64_t)Hkv * HD;
  const int64_t kv_off = ((int64_t)b * S + k0) * kv_stride + (int64_t)hk * HD;

  // query tiles per head: from the diagonal on when causal
  const int qt0 = CAUSAL ? k0 / DKV_BLOCK_M : 0;
  const int nq = S / DKV_BLOCK_M - qt0;
  const int n_iters = G * nq;

  // tile j: q head hk * G + j / nq, query tile qt0 + j % nq
  auto load_q_tile = [&](int j, int stage) {
    const int h = hk * G + j / nq;
    const int qs = (qt0 + j % nq) * DKV_BLOCK_M;
    const int64_t off = ((int64_t)b * S + qs) * q_stride + (int64_t)h * HD;
    cp_tile<T, HD, LD, DKV_BLOCK_M, NUM_THREADS>(Qs + stage * Q_TILE, q + off, q_stride);
    cp_tile<T, HD, LD, DKV_BLOCK_M, NUM_THREADS>(dOs + stage * Q_TILE, dout + off,
                                                 q_stride);
    const int64_t row = ((int64_t)b * Hq + h) * S + qs;
    constexpr int CH = DKV_BLOCK_M / 4;   // 16-byte chunks of one fp32 row
    if (threadIdx.x < CH)
      cp_async16(lse_s + stage * DKV_BLOCK_M + threadIdx.x * 4, lse + row + threadIdx.x * 4);
    else if (threadIdx.x < 2 * CH)
      cp_async16(dlt_s + stage * DKV_BLOCK_M + (threadIdx.x - CH) * 4,
                 delta + row + (threadIdx.x - CH) * 4);
  };

  cp_tile<T, HD, LD, DKV_BLOCK_N, NUM_THREADS>(Ks, k + kv_off, kv_stride);
  cp_tile<T, HD, LD, DKV_BLOCK_N, NUM_THREADS>(Vs, v + kv_off, kv_stride);
  load_q_tile(0, 0);
  cp_async_commit();

  const uint32_t ka_base = smem_addr(Ks + a_lane(wr, lane, LD));   // A = K rows
  const uint32_t va_base = smem_addr(Vs + a_lane(wr, lane, LD));   // A = V rows
  const int n_lane = b_lane_rows_n(lane, LD);
  const int k_lane = b_lane_rows_k(lane, LD);
  const int key_lo = k0 + wr + g;   // this thread's keys: key_lo, key_lo + 8

  float acc_k[HD / 8][4], acc_v[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[dt][e] = acc_v[dt][e] = 0.f;

  for (int j = 0; j < n_iters; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_iters) {
      load_q_tile(j + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int q0 = (qt0 + j % nq) * DKV_BLOCK_M;
    // a tile wholly above the diagonal for this warp's keys adds nothing
    if (!(CAUSAL && q0 + DKV_BLOCK_M - 1 < k0 + wr)) {
      const T* Qst = Qs + stage * Q_TILE;
      const T* dOst = dOs + stage * Q_TILE;
      const float* lse_t = lse_s + stage * DKV_BLOCK_M;
      const float* dlt_t = dlt_s + stage * DKV_BLOCK_M;
      const uint32_t qn_base = smem_addr(Qst + n_lane);    // Q as B of K Q^T
      const uint32_t don_base = smem_addr(dOst + n_lane);  // dO as B of V dO^T
      const uint32_t qk_base = smem_addr(Qst + k_lane);    // Q as B of ds^T Q
      const uint32_t dok_base = smem_addr(dOst + k_lane);  // dO as B of p^T dO

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries each
      float s[DKV_BLOCK_M / 8][4], dp[DKV_BLOCK_M / 8][4];
#pragma unroll
      for (int nt = 0; nt < DKV_BLOCK_M / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ak[4], av[4];
        ldsm_x4(ak, ka_base + kk * 16 * SZ);
        ldsm_x4(av, va_base + kk * 16 * SZ);
#pragma unroll
        for (int np = 0; np < DKV_BLOCK_M / 16; ++np) {
          uint32_t bq[4], bd[4];
          ldsm_x4(bq, qn_base + (np * 16 * LD + kk * 16) * SZ);
          Mma<T>::run(s[2 * np], ak, bq[0], bq[1]);
          Mma<T>::run(s[2 * np + 1], ak, bq[2], bq[3]);
          ldsm_x4(bd, don_base + (np * 16 * LD + kk * 16) * SZ);
          Mma<T>::run(dp[2 * np], av, bd[0], bd[1]);
          Mma<T>::run(dp[2 * np + 1], av, bd[2], bd[3]);
        }
      }

      // p^T into s, ds^T into dp (columns are queries)
      const bool diag = CAUSAL && q0 < k0 + wr + 15;
#pragma unroll
      for (int nt = 0; nt < DKV_BLOCK_M / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + t4 * 2 + (e & 1);
          float p = exp2f(s[nt][e] * scale_log2 - lse_t[col] * LOG2E);
          if (diag && q0 + col < key_lo + (e >= 2 ? 8 : 0)) p = 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - dlt_t[col]) * scale;
        }
      }

      // dv += p^T dO, dk += ds^T Q (contracting over this tile's 32 queries)
#pragma unroll
      for (int kc = 0; kc < DKV_BLOCK_M / 16; ++kc) {
        uint32_t pa[4], da[4];
        pack_a<T>(pa, s[2 * kc], s[2 * kc + 1]);
        pack_a<T>(da, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
        for (int d2 = 0; d2 < HD / 16; ++d2) {
          uint32_t bo[4], bq[4];
          ldsm_x4_trans(bo, dok_base + (kc * 16 * LD + d2 * 16) * SZ);
          Mma<T>::run(acc_v[2 * d2], pa, bo[0], bo[1]);
          Mma<T>::run(acc_v[2 * d2 + 1], pa, bo[2], bo[3]);
          ldsm_x4_trans(bq, qk_base + (kc * 16 * LD + d2 * 16) * SZ);
          Mma<T>::run(acc_k[2 * d2], da, bq[0], bq[1]);
          Mma<T>::run(acc_k[2 * d2 + 1], da, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t off = kv_off + (int64_t)(wr + g + r * 8) * kv_stride;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + off + dt * 8 + t4 * 2) =
          Mma<T>::pack(acc_k[dt][2 * r], acc_k[dt][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + dt * 8 + t4 * 2) =
          Mma<T>::pack(acc_v[dt][2 * r], acc_v[dt][2 * r + 1]);
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, S, Hq, Hkv;
  float scale;
};

template <typename T, int HD, bool CAUSAL>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  const int smem = (2 * DQ_BLOCK_M + 4 * DQ_BLOCK_N) * (HD + 8) * (int)sizeof(T);
  auto kern = flash_bwd_dq_kernel<T, HD, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.S / DQ_BLOCK_M, a.Hq, a.B);
  kern<<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(a.dq), a.S, a.Hq, a.Hkv, a.scale, a.scale * LOG2E);
  return cudaGetLastError();
}

template <typename T, int HD, bool CAUSAL>
cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  const int smem = 4 * DKV_BLOCK_M * (int)sizeof(float) +
                   (2 * DKV_BLOCK_N + 4 * DKV_BLOCK_M) * (HD + 8) * (int)sizeof(T);
  auto kern = flash_bwd_dkv_kernel<T, HD, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.S / DKV_BLOCK_N, a.Hkv, a.B);
  kern<<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S, a.Hq, a.Hkv, a.scale,
      a.scale * LOG2E);
  return cudaGetLastError();
}

// which: 0 = K2 (dq), 1 = K3 (dk, dv)
template <typename T, int HD, bool CAUSAL>
cudaError_t launch(int which, const BwdArgs& a, cudaStream_t stream) {
  return which == 0 ? launch_dq<T, HD, CAUSAL>(a, stream)
                    : launch_dkv<T, HD, CAUSAL>(a, stream);
}

template <typename T>
cudaError_t dispatch_shape(int which, int hd, int causal, const BwdArgs& a,
                           cudaStream_t stream) {
  if (hd == 64)
    return causal ? launch<T, 64, true>(which, a, stream)
                  : launch<T, 64, false>(which, a, stream);
  if (hd == 128)
    return causal ? launch<T, 128, true>(which, a, stream)
                  : launch<T, 128, false>(which, a, stream);
  return cudaErrorInvalidValue;
}

int run(int which, const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dq, void* dk, void* dv,
        int B, int S, int Hq, int Hkv, int hd, int dtype, int causal,
        float sm_scale, void* stream) {
  if (S % DKV_BLOCK_N != 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, dout, lse, delta, dq, dk, dv, B, S, Hq, Hkv, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return dispatch_shape<__half>(which, hd, causal, a, st);
    case 2: return dispatch_shape<__nv_bfloat16>(which, hd, causal, a, st);
    default: return cudaErrorInvalidValue;   // fp32: refused by the wrapper
  }
}

}  // namespace

extern "C" {

// dtype: 1 = float16, 2 = bfloat16.  Each returns the cudaError_t of its
// launch (0 on success).  The Python wrapper has checked shapes, dtypes,
// contiguity and S % 128 == 0 before calling.
int ds_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, int B, int S, int Hq,
                              int Hkv, int hd, int dtype, int causal,
                              float sm_scale, void* stream) {
  return run(0, q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, S, Hq, Hkv,
             hd, dtype, causal, sm_scale, stream);
}

int ds_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dk, void* dv, int B,
                               int S, int Hq, int Hkv, int hd, int dtype,
                               int causal, float sm_scale, void* stream) {
  return run(1, q, k, v, dout, lse, delta, nullptr, dk, dv, B, S, Hq, Hkv, hd,
             dtype, causal, sm_scale, stream);
}

const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
