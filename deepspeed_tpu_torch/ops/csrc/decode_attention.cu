// Paged decode attention for Hopper (sm_90a), bound through ctypes.
//
// Replaces the Pallas kernel `_kernel` (launched by `flash_decode`) in
// tools/retired_decode_attention.py: one query token per row against a KV
// cache, online softmax with an fp32 accumulator, the finite NEG_INF mask,
// the GQA group of a KV head handled in the kernel (no repeat), P rounded to
// V's dtype before P.V, output in q's dtype.
//
// Layout: q [B, Hq, hd]; the layer's K and V pools [P, page, Hkv, hd] read in
// place through an int32 page table [B, maxp] (row t of slot b is pool row
// page_table[b, t / page] * page + t % page; a contiguous cache [B, T, Hkv,
// hd] is a pool of B pages of T rows with the identity table); an int32 mask
// [B, T] (nonzero = attendable), T <= maxp * page; out [B, Hq, hd].
//
// Design.  On the TPU one grid step holds a 512-key block of every KV head
// and the T sweep is a sequential grid axis carrying the running max, sum and
// accumulator in VMEM.  Here one CTA owns one (slot, KV head): its G query
// rows sit in registers, so each K/V row is read once for the whole group.
// The CTA's 256 threads form independent key streams of TPK = hd / VEC lanes
// (VEC elements = 16 bytes a lane: one vector load per lane per row); stream
// s takes keys s, s + NS, s + 2 NS, ... and keeps its own online-softmax
// state (m, l, acc) per query row; the streams are merged at the end through
// shared memory (the split-K of flash-decoding, inside one CTA).  Each stream
// issues UNROLL keys' K and V loads before using them, to keep bytes in
// flight.  A stream skips the loads of keys whose mask is zero, so a slot
// pays only for the rows it attends (the paged path's mask is t <= length).
// Scores and P.V accumulate in fp32 on CUDA cores: with G <= 8 rows per KV
// head this is a matrix-vector product, bound by memory, not by operations.
//
// Bound on an H100 SXM (3.35 TB/s): the serving decode tick at llama2-7b
// (8 slots, 32 heads of 128, bf16) reads 2 * 32 * 128 * 2 = 16 KiB of K and V
// per attended token and layer; ~2000 attended tokens per slot give ~0.08 ms
// per layer.  PERF.md records the measured time against this bound.
//
// A row with no attendable key is outside the contract (the caller always
// has the token it just wrote): the kernel writes zeros there.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;   // ops/kernels/common.py NEG_INF
constexpr int THREADS = 256;

template <typename T> struct Vec;

// 16 bytes = 8 bf16 / 8 fp16 / 4 fp32, widened to fp32; and rounding of p
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void widen(const uint4& r, float (&x)[N]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float round(float p) {
    return __bfloat162float(__float2bfloat16_rn(p));
  }
  static __device__ __forceinline__ __nv_bfloat16 cast(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <> struct Vec<__half> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void widen(const uint4& r, float (&x)[N]) {
    const __half2* h = reinterpret_cast<const __half2*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float round(float p) {
    return __half2float(__float2half_rn(p));
  }
  static __device__ __forceinline__ __half cast(float x) { return __float2half_rn(x); }
};

template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void widen(const uint4& r, float (&x)[N]) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ float round(float p) { return p; }
  static __device__ __forceinline__ float cast(float x) { return x; }
};

template <typename T, int HD, int G>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                        const T* __restrict__ vpool, const int* __restrict__ page_table,
                        const int* __restrict__ mask, T* __restrict__ out, int Hkv,
                        int T_len, int page, int maxp, float sm_scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int TPK = HD / VEC;          // lanes per key row
  constexpr int NS = THREADS / TPK;      // key streams per CTA
  constexpr int UNROLL = G <= 2 ? 4 : 2;
  static_assert(TPK <= 32 && 32 % TPK == 0, "a key row must sit inside one warp");

  __shared__ float sm_m[NS][G];
  __shared__ float sm_l[NS][G];
  __shared__ float sm_acc[NS][HD];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int li = threadIdx.x % TPK;      // lane within the stream
  const int st = threadIdx.x / TPK;      // stream
  const int warp_lane = threadIdx.x & 31;
  const unsigned smask = TPK == 32 ? 0xffffffffu
                                   : ((1u << TPK) - 1u) << (warp_lane & ~(TPK - 1));
  const int Hq = Hkv * G;

  // this CTA's G query rows (heads hk*G .. hk*G + G - 1), VEC dims per lane
  float qv[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4 r = *reinterpret_cast<const uint4*>(
        q + ((int64_t)b * Hq + hk * G + g) * HD + li * VEC);
    Vec<T>::widen(r, qv[g]);
  }

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[g][j] = 0.f;
  }

  const int64_t row_stride = (int64_t)Hkv * HD;
  const T* kb = kpool + (int64_t)hk * HD + li * VEC;
  const T* vb = vpool + (int64_t)hk * HD + li * VEC;
  const int* pt = page_table + (int64_t)b * maxp;
  const int* mk = mask + (int64_t)b * T_len;

  for (int t0 = st; t0 < T_len; t0 += NS * UNROLL) {
    bool ok[UNROLL];
    bool any = false;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u * NS;
      ok[u] = t < T_len && mk[t] != 0;
      any |= ok[u];
    }
    if (!any) continue;   // uniform within the stream: no shuffles skipped

    uint4 kr[UNROLL], vr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (ok[u]) {
        const int t = t0 + u * NS;
        const int64_t row = (int64_t)pt[t / page] * page + t % page;
        kr[u] = *reinterpret_cast<const uint4*>(kb + row * row_stride);
        vr[u] = *reinterpret_cast<const uint4*>(vb + row * row_stride);
      } else {
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }

    // scores s[u][g] = q_g . k_u, reduced over the stream's TPK lanes
    float s[UNROLL][G];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kx[VEC];
      Vec<T>::widen(kr[u], kx);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) d = fmaf(qv[g][j], kx[j], d);
        s[u][g] = d;
      }
    }
#pragma unroll
    for (int off = TPK / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int g = 0; g < G; ++g) s[u][g] += __shfl_xor_sync(smask, s[u][g], off);
      }
    }

    // online softmax over these UNROLL keys, then acc += round(p) * v
    float vx[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) Vec<T>::widen(vr[u], vx[u]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mc = NEG_INF;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        s[u][g] = ok[u] ? s[u][g] * sm_scale : NEG_INF;
        mc = fmaxf(mc, s[u][g]);
      }
      const float m_new = fmaxf(m[g], mc);
      const float alpha = expf(m[g] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[g][j] *= alpha;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float p = ok[u] ? expf(s[u][g] - m_new) : 0.f;
        rs += p;
        const float pr = Vec<T>::round(p);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[g][j] = fmaf(pr, vx[u][j], acc[g][j]);
      }
      l[g] = l[g] * alpha + rs;
      m[g] = m_new;
    }
  }

  // merge the streams: weight each by exp(m_s - M), one query row at a time
  if (li == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[st][g] = m[g];
      sm_l[st][g] = l[g];
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float M = NEG_INF;
    for (int i = 0; i < NS; ++i) M = fmaxf(M, sm_m[i][g]);
    const float w = expf(m[g] - M);
#pragma unroll
    for (int j = 0; j < VEC; ++j) sm_acc[st][li * VEC + j] = acc[g][j] * w;
    __syncthreads();
    if (threadIdx.x < HD) {
      float L = 0.f, o = 0.f;
      for (int i = 0; i < NS; ++i) {
        L += sm_l[i][g] * expf(sm_m[i][g] - M);
        o += sm_acc[i][threadIdx.x];
      }
      out[((int64_t)b * Hq + hk * G + g) * HD + threadIdx.x] =
          Vec<T>::cast(L == 0.f ? 0.f : o / L);
    }
    __syncthreads();
  }
}

template <typename T, int HD, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pt,
                   const int* mask, void* o, int B, int Hkv, int T_len, int page,
                   int maxp, float sm_scale, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  decode_attention_kernel<T, HD, G><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      pt, mask, static_cast<T*>(o), Hkv, T_len, page, maxp, sm_scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_group(int G, const void* q, const void* k, const void* v,
                           const int* pt, const int* mask, void* o, int B, int Hkv,
                           int T_len, int page, int maxp, float sm_scale,
                           cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, HD, 1>(q, k, v, pt, mask, o, B, Hkv, T_len, page, maxp, sm_scale, st);
    case 2: return launch<T, HD, 2>(q, k, v, pt, mask, o, B, Hkv, T_len, page, maxp, sm_scale, st);
    case 4: return launch<T, HD, 4>(q, k, v, pt, mask, o, B, Hkv, T_len, page, maxp, sm_scale, st);
    case 8: return launch<T, HD, 8>(q, k, v, pt, mask, o, B, Hkv, T_len, page, maxp, sm_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int HD>
cudaError_t dispatch_dtype(int dtype, int G, const void* q, const void* k,
                           const void* v, const int* pt, const int* mask, void* o,
                           int B, int Hkv, int T_len, int page, int maxp,
                           float sm_scale, cudaStream_t st) {
  switch (dtype) {
    case 0: return dispatch_group<float, HD>(G, q, k, v, pt, mask, o, B, Hkv, T_len, page, maxp, sm_scale, st);
    case 1: return dispatch_group<__half, HD>(G, q, k, v, pt, mask, o, B, Hkv, T_len, page, maxp, sm_scale, st);
    case 2: return dispatch_group<__nv_bfloat16, HD>(G, q, k, v, pt, mask, o, B, Hkv, T_len, page, maxp, sm_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Returns the cudaError_t of
// the launch (0 on success).  The Python wrapper has checked shapes, dtypes,
// contiguity, alignment and T <= maxp * page before calling.
int ds_decode_attention(const void* q, const void* k, const void* v,
                        const int* page_table, const int* mask, void* o, int B,
                        int Hq, int Hkv, int hd, int T_len, int page, int maxp,
                        int dtype, float sm_scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || page <= 0 || T_len > maxp * page)
    return cudaErrorInvalidValue;
  if (B == 0 || T_len == 0) return cudaSuccess;
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return dispatch_dtype<64>(dtype, G, q, k, v, page_table, mask, o, B, Hkv, T_len, page, maxp, sm_scale, st);
  if (hd == 128)
    return dispatch_dtype<128>(dtype, G, q, k, v, page_table, mask, o, B, Hkv, T_len, page, maxp, sm_scale, st);
  return cudaErrorInvalidValue;
}

const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
