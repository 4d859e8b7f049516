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
// Design.  On the TPU the key sweep is the sequential innermost grid axis
// and the running max/sum/accumulator live in VMEM scratch across grid
// steps.  Hopper blocks run in parallel and in no order, so here one CTA
// owns one (b, q-head, 128-row query tile) and walks the 64-key K/V tiles in
// a loop, stopping at the diagonal when causal; the running state lives in
// registers.  8 warps, 16 query rows each.  The Q tile and two K/V stages
// sit in shared memory (rows padded by 16 bytes so ldmatrix is
// conflict-free; 102 KB at hd = 128, two CTAs per SM, so the kernel needs
// dynamic shared memory above the 48 KB default): cp.async fetches tile
// j + 1 while tile j is computed.  Both products (S = Q K^T, O += P V) run
// on tensor cores via warp-level mma.sync m16n8k16 with fp32 accumulation,
// their operands loaded with ldmatrix (.trans for V); the S accumulator
// fragment is re-packed in registers as the A operand of P V.  The softmax
// runs in the log2 domain (exp2f, scale folded with log2 e).  A warp skips
// a K/V tile lying wholly above its rows; heavy causal tiles (large query
// index) are scheduled first to shorten the tail.  fp32 inputs take a
// separate CUDA-core (FMA) kernel: the JAX kernel accepts any float dtype.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): the causal main
// path launch (B=1, S=4096, 32 heads of 128) does 2 * 2 * S(S+1)/2 * hd * H
// = 137 GFLOP of tensor-core work -> 0.139 ms, against 134 MB of q/k/v/out
// traffic -> 0.040 ms: compute-bound.  mma.sync issues from one warp at a
// time and cannot reach wgmma's rate; PERF.md records the measured time.
#include "flash_common.cuh"

namespace {

using namespace flash;

// tensor-core kernel (bf16 / fp16)
constexpr int BLOCK_M = 128;        // query rows per CTA (S % 128 == 0)
constexpr int BLOCK_N = 64;         // keys per K/V tile
constexpr int NUM_THREADS = 256;    // 8 warps x 16 query rows

// CUDA-core kernel (fp32)
constexpr int F32_BLOCK = 64;       // query rows per CTA == keys per tile
constexpr int F32_THREADS = 128;    // two threads per query row

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(NUM_THREADS, 2)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int Hq, int Hkv,
                     float scale_log2) {
  constexpr int LD = HD + 8;   // padded shared-memory row, in elements
  constexpr int KV_TILE = BLOCK_N * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BLOCK_M * LD;         // two stages
  T* Vs = Ks + 2 * KV_TILE;          // two stages

  const int qi = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;      // mma fragment coordinates
  const int wr = warp * 16;                    // warp's first row in the tile
  const int q0 = qi * BLOCK_M;

  const int64_t q_stride = (int64_t)Hq * HD;
  const int64_t kv_stride = (int64_t)Hkv * HD;
  const T* qb = q + ((int64_t)b * S + q0) * q_stride + (int64_t)h * HD;
  const T* kb = k + (int64_t)b * S * kv_stride + (int64_t)hk * HD;
  const T* vb = v + (int64_t)b * S * kv_stride + (int64_t)hk * HD;

  const int n_tiles = CAUSAL ? (q0 + BLOCK_M) / BLOCK_N : S / BLOCK_N;
  cp_tile<T, HD, LD, BLOCK_M, NUM_THREADS>(Qs, qb, q_stride);
  cp_tile<T, HD, LD, BLOCK_N, NUM_THREADS>(Ks, kb, kv_stride);
  cp_tile<T, HD, LD, BLOCK_N, NUM_THREADS>(Vs, vb, kv_stride);
  cp_async_commit();

  // ldmatrix row addresses of this lane (bytes).  A (Q): matrices
  // (rows 0-7 | 8-15) x (k 0-7 | 8-15).  B of Q K^T (K rows = keys,
  // non-transposed): (n-tile, k half) pairs.  B of P V (V rows = keys,
  // transposed): (key half, d-tile) pairs.
  const uint32_t q_base = smem_addr(Qs + (wr + (lane & 15)) * LD + (lane >> 4) * 8);
  const int k_lane = ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
  const int v_lane = (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8;

  // rows (wr + g) and (wr + g + 8) of the tile: index 0 and 1
  float m_i[2] = {NEG_INF, NEG_INF};   // running max, log2 domain
  float l_i[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int kj = 0; kj < n_tiles; ++kj) {
    const int stage = kj & 1;
    if (kj + 1 < n_tiles) {   // prefetch the next tile into the other stage
      const int64_t next = (int64_t)(kj + 1) * BLOCK_N * kv_stride;
      cp_tile<T, HD, LD, BLOCK_N, NUM_THREADS>(Ks + (stage ^ 1) * KV_TILE, kb + next, kv_stride);
      cp_tile<T, HD, LD, BLOCK_N, NUM_THREADS>(Vs + (stage ^ 1) * KV_TILE, vb + next, kv_stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int k0 = kj * BLOCK_N;
    // a tile wholly above this warp's rows contributes nothing (JAX skips
    // such blocks too)
    if (!(CAUSAL && k0 > q0 + wr + 15)) {
      const uint32_t k_base = smem_addr(Ks + stage * KV_TILE + k_lane);
      const uint32_t v_base = smem_addr(Vs + stage * KV_TILE + v_lane);

      // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
      float s[BLOCK_N / 8][4];
#pragma unroll
      for (int nt = 0; nt < BLOCK_N / 8; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, q_base + kk * 16 * (int)sizeof(T));
#pragma unroll
        for (int np = 0; np < BLOCK_N / 16; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, k_base + (np * 16 * LD + kk * 16) * (int)sizeof(T));
          Mma<T>::run(s[2 * np], a, bk[0], bk[1]);
          Mma<T>::run(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }

      // scale into the log2 domain, mask the diagonal, running max
      const bool diag = CAUSAL && k0 + BLOCK_N - 1 > q0 + wr;
      float mc[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * scale_log2;
          if (diag) {
            const int row = q0 + wr + g + (e >= 2 ? 8 : 0);
            const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
            if (row < col) x = NEG_INF;
          }
          s[nt][e] = x;
          mc[e >> 1] = fmaxf(mc[e >> 1], x);
        }
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffff, mc[r], 1));
        mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffff, mc[r], 2));
        const float m_new = fmaxf(m_i[r], mc[r]);
        alpha[r] = exp2f(m_i[r] - m_new);
        m_i[r] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[nt][e] - m_i[e >> 1]);
          s[nt][e] = p;
          rs[e >> 1] += p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffff, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffff, rs[r], 2);
        l_i[r] = alpha[r] * l_i[r] + rs[r];
      }
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        acc[dt][0] *= alpha[0];
        acc[dt][1] *= alpha[0];
        acc[dt][2] *= alpha[1];
        acc[dt][3] *= alpha[1];
      }

      // O += P V: the S accumulator layout of key chunk kc (n-tiles 2kc,
      // 2kc+1) is exactly the A-operand layout of m16n8k16; P is rounded
      // to the input dtype here, as the JAX kernel does before its second
      // dot.
#pragma unroll
      for (int kc = 0; kc < BLOCK_N / 16; ++kc) {
        uint32_t pa[4];
        pa[0] = Mma<T>::pack(s[2 * kc][0], s[2 * kc][1]);
        pa[1] = Mma<T>::pack(s[2 * kc][2], s[2 * kc][3]);
        pa[2] = Mma<T>::pack(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        pa[3] = Mma<T>::pack(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, v_base + (kc * 16 * LD + dp * 16) * (int)sizeof(T));
          Mma<T>::run(acc[2 * dp], pa, bv[0], bv[1]);
          Mma<T>::run(acc[2 * dp + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage before reuse
  }

  // epilogue: normalise (l == 0 guard), write out and lse
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = l_i[r] == 0.f ? 1.f : l_i[r];
    const int row = q0 + wr + g + r * 8;
    T* orow = o + ((int64_t)b * S + row) * q_stride + (int64_t)h * HD;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + t4 * 2) =
          Mma<T>::pack(acc[dt][2 * r] / l_safe, acc[dt][2 * r + 1] / l_safe);
    }
    if (t4 == 0)
      lse[((int64_t)b * Hq + h) * S + row] = m_i[r] * LN2 + logf(l_safe);
  }
}

// fp32 inputs: 64-row tiles on CUDA cores.  Two threads per query row;
// each scores half of the tile's keys, then each accumulates half of hd.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int S, int Hq, int Hkv,
                      float sm_scale) {
  constexpr int LD = HD + 1;        // odd stride: row-parallel reads hit distinct banks
  constexpr int PLD = F32_BLOCK + 1;
  constexpr int HALF_N = F32_BLOCK / 2, HALF_D = HD / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + F32_BLOCK * LD;
  float* Vs = Ks + F32_BLOCK * LD;
  float* Ps = Vs + F32_BLOCK * LD;

  const int qi = gridDim.x - 1 - blockIdx.x;
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

  const int n_tiles = CAUSAL ? qi + 1 : S / F32_BLOCK;
  for (int kj = 0; kj < n_tiles; ++kj) {
    const int k0 = kj * F32_BLOCK;
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
      if (CAUSAL && kj == qi && r < key) x = NEG_INF;
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
  if (half == 0) lse[((int64_t)b * Hq + h) * S + q0 + r] = m_i + logf(l_safe);
}

template <typename T, int HD, bool CAUSAL>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int S, int Hq, int Hkv, float sm_scale,
                       cudaStream_t stream) {
  const int smem = (BLOCK_M + 4 * BLOCK_N) * (HD + 8) * (int)sizeof(T);
  auto kern = flash_fwd_mma_kernel<T, HD, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S / BLOCK_M, Hq, B);
  kern<<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, Hq, Hkv, sm_scale * LOG2E);
  return cudaGetLastError();
}

template <int HD, bool CAUSAL>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int S, int Hq, int Hkv, float sm_scale,
                        cudaStream_t stream) {
  const int smem = (3 * F32_BLOCK * (HD + 1) + F32_BLOCK * (F32_BLOCK + 1)) *
                   (int)sizeof(float);
  auto kern = flash_fwd_fp32_kernel<HD, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S / F32_BLOCK, Hq, B);
  kern<<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, Hq, Hkv,
      sm_scale);
  return cudaGetLastError();
}

template <int HD, bool CAUSAL>
cudaError_t dispatch_dtype(int dtype, const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int S, int Hq, int Hkv,
                           float sm_scale, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_fp32<HD, CAUSAL>(q, k, v, o, lse, B, S, Hq, Hkv, sm_scale, stream);
    case 1: return launch_mma<__half, HD, CAUSAL>(q, k, v, o, lse, B, S, Hq, Hkv, sm_scale, stream);
    case 2: return launch_mma<__nv_bfloat16, HD, CAUSAL>(q, k, v, o, lse, B, S, Hq, Hkv, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Returns the cudaError_t
// of the launch (0 on success).  The Python wrapper has checked shapes,
// dtypes, contiguity and S % 128 == 0 before calling.
int ds_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                           float* lse, int B, int S, int Hq, int Hkv, int hd,
                           int dtype, int causal, float sm_scale, void* stream) {
  if (S % BLOCK_M != 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return causal ? dispatch_dtype<64, true>(dtype, q, k, v, o, lse, B, S, Hq, Hkv, sm_scale, st)
                  : dispatch_dtype<64, false>(dtype, q, k, v, o, lse, B, S, Hq, Hkv, sm_scale, st);
  if (hd == 128)
    return causal ? dispatch_dtype<128, true>(dtype, q, k, v, o, lse, B, S, Hq, Hkv, sm_scale, st)
                  : dispatch_dtype<128, false>(dtype, q, k, v, o, lse, B, S, Hq, Hkv, sm_scale, st);
  return cudaErrorInvalidValue;
}

const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
