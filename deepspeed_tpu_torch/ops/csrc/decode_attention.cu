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
// What bounds it: bytes.  Each attended key costs 2 * Hkv * hd elements of K
// and V and 4 * Hq * hd operations, so with G = Hq / Hkv <= 8 query rows per
// KV head the work is a matrix-vector product far below the card's ridge.
// The serving decode tick at llama2-7b (8 slots, 32 heads of 128, bf16,
// ~3,450 attended keys) moves ~57 MB per layer: 0.017 ms at 3.35 TB/s.
//
// Design.  On the TPU one grid step holds a 512-key block of every KV head
// and the T sweep is a sequential grid axis carrying the running max, sum
// and accumulator in VMEM.  Here:
//  - The keys of one (slot, KV head) are split over a thread-block cluster
//    of NSPLIT CTAs (grid (Hkv, B, NSPLIT), cluster (1, 1, NSPLIT)).  The
//    keys are cut into tiles of R rows inside one page (R x hd of K at most
//    8 KB); CTA rank r takes tiles r, r + NSPLIT, r + 2 NSPLIT, ...
//    Interleaved rather than contiguous (contiguous ranges measured up to 2.3x
//    slower): the paged path's mask is a prefix (t <= length), so every
//    rank of a long slot gets a share of its live tiles.
//  - NSPLIT is the largest of 1, 2, 4, 8 not above the tile count, so a
//    short cache launches no empty CTAs; it comes from the shapes alone, so
//    a captured CUDA graph stays valid as the lengths change.  Every CTA
//    pays a fixed chain (launch, mask, list, barriers, merge) of a few
//    microseconds a wave of resident CTAs, as much as a short slot's
//    streaming (PERF.md, PR 7): the chain is kept short (one cluster
//    barrier) and the CTA small (34 KB of shared memory: 6 an SM).
//  - The mask decides what is loaded.  All five warps first read the mask
//    words (coalesced, lane = row) and page ids of the rank's tiles, every
//    load in flight together, and the tiles holding a live key are
//    compacted into a list in shared memory behind a CTA barrier; the
//    producer and the consumers walk that one list.  Dead tiles cost no K/V
//    bytes.  (A producer that read the mask itself, chunk by chunk, paid a
//    round trip a chunk of dead tiles: 1.3x slower at `serve`.)
//  - One producer warp keeps a ring of 2-8 stages (32 KB) of K and V tiles
//    in flight by TMA (`cp.async.bulk.tensor`, box (hd, 1, R, 1) of the 4-D
//    pool (hd, Hkv, page, P) at (0, kv head, row in page, page id)),
//    completing on mbarriers: no dependent load chain per key.
//  - Four consumer warps keep the G query rows in registers and form
//    independent key streams of TPK lanes (16 or 8 bytes a lane per row);
//    each stream runs its own online softmax in fp32 (exp2 with the scale
//    folded in) over its rows of each tile, P rounded to V's dtype, on CUDA
//    cores.  The streams are merged in shared memory in stream order.
//  - The CTAs of the cluster merge through distributed shared memory: each
//    rank stores its (m, l, acc) slices into the inbox of the rank that
//    owns those columns (rank c: [c hd / NSPLIT, (c + 1) hd / NSPLIT)), one
//    cluster barrier, then each rank merges its inbox in rank order and
//    writes its slice of out.  No rank reads a peer's shared memory, so
//    none waits for another before leaving.  One launch, no workspace, no
//    atomics: reruns are bit-identical.
//
// The int8 mode (ds_decode_attention_q8): the pools hold int8 codes
// (kv_dtype="int8" pages) and two fp32 scale planes [P, page], one scale a
// pool row.  The TMA ring carries the int8 tiles as bytes (a tile is 64 rows
// at hd 64 and 128: 4 or 8 KB of K, 8-byte or 4-byte lane loads), and beside
// each tile the tile's K and V scale rows (up to 256 bytes each, one 1-D bulk
// copy each, completing on the tile's barrier: page % 4 == 0 keeps them
// 16-byte aligned).  A consumer widens each element as
// round_T(float(code) * scale), the scale read from the ring stage: exactly
// the compute-dtype value kv_dequantize makes, so the rest is the same
// online softmax.  No dequantized copy of the cache exists: the narrow pages
// are what crosses HBM (1 byte an element plus 4 bytes a row for K and V).
//
// A rank without a live tile still pushes (NEG_INF, 0, 0), which weighs
// nothing.  A row with no attendable key is outside the contract (the
// caller always has the token it just wrote): the kernel writes zeros
// there.  Page ids are trusted as before: the pool's page count is not an
// argument, so the tensor map's page extent is the largest TMA coordinate.
#include "hopper_common.cuh"

#include <stdint.h>

#include <algorithm>
#include <cstdio>
#include <mutex>
#include <type_traits>

namespace {

using hopper::exp2_ftz;
using hopper::NEG_INF;

constexpr int CONSUMER_WARPS = 4;
constexpr int NC = CONSUMER_WARPS * 32;   // consumer threads
constexpr int THREADS = NC + 32;          // + the producer warp
constexpr int MAX_SPLIT = 8;              // the portable cluster size
constexpr int RING_BYTES = 32 * 1024;     // K and V tiles in flight per CTA
constexpr int MAX_STAGES = 8;
constexpr int TILE_BYTES = 8 * 1024;      // of K (V the same) at the widest tile
constexpr int MAX_ROWS = 64;              // a tile's live keys fit one 64-bit word
constexpr int WARPS = THREADS / 32;
constexpr int LIST_TILES = 8;             // tiles a warp reads per round of the list

template <typename T> struct Num;

template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float2 pair(uint32_t w) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  }
  static __device__ __forceinline__ float round(float p) {
    return __bfloat162float(__float2bfloat16_rn(p));
  }
  static __device__ __forceinline__ __nv_bfloat16 cast(float x) {
    return __float2bfloat16_rn(x);
  }
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

template <> struct Num<__half> {
  static __device__ __forceinline__ float2 pair(uint32_t w) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  }
  static __device__ __forceinline__ float round(float p) {
    return __half2float(__float2half_rn(p));
  }
  static __device__ __forceinline__ __half cast(float x) { return __float2half_rn(x); }
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

template <> struct Num<float> {
  static __device__ __forceinline__ float round(float p) { return p; }
  static __device__ __forceinline__ float cast(float x) { return x; }
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

// The pools' element type as TMA moves it (int8 codes as bytes).
template <typename KV> struct Tma { static constexpr CUtensorMapDataType TYPE = Num<KV>::TMA; };
template <> struct Tma<int8_t> {
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

// VEC consecutive elements (8 or 16 bytes, aligned) at p, widened to fp32.
template <typename T, int VEC>
__device__ __forceinline__ void widen(const T* p, float (&x)[VEC]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (VEC == 4) {
      const float4 r = *reinterpret_cast<const float4*>(p);
      x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
    } else {
      static_assert(VEC == 2, "8 or 16 bytes a lane");
      const float2 r = *reinterpret_cast<const float2*>(p);
      x[0] = r.x; x[1] = r.y;
    }
  } else {
    constexpr int W = VEC / 2;   // 32-bit words of two elements
    static_assert(W == 2 || W == 4, "8 or 16 bytes a lane");
    uint32_t w[W];
    if constexpr (W == 4) {
      const uint4 r = *reinterpret_cast<const uint4*>(p);
      w[0] = r.x; w[1] = r.y; w[2] = r.z; w[3] = r.w;
    } else {
      const uint2 r = *reinterpret_cast<const uint2*>(p);
      w[0] = r.x; w[1] = r.y;
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float2 f = Num<T>::pair(w[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
}

// VEC int8 codes at p (2, 4 or 8 bytes, aligned), each widened to the
// compute dtype's value of code * scale (the product in fp32, rounded to T,
// as kv_dequantize does) and held in fp32.
template <typename T, int VEC>
__device__ __forceinline__ void widen_q8(const int8_t* p, float scale, float (&x)[VEC]) {
  uint32_t w[(VEC + 3) / 4];
  if constexpr (VEC == 8) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    w[0] = r.x; w[1] = r.y;
  } else if constexpr (VEC == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    static_assert(VEC == 2, "2, 4 or 8 codes a lane");
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int code = static_cast<int8_t>(static_cast<uint8_t>(w[j / 4] >> (8 * (j % 4))));
    x[j] = Num<T>::round(__fmul_rn(static_cast<float>(code), scale));
  }
}

// One key or value row's VEC elements of this lane, widened to fp32: as
// they lie (KV == T), or dequantized from int8 codes with the row's scale.
template <typename T, typename KV, int VEC>
__device__ __forceinline__ void load_row(const KV* p, float scale, float (&x)[VEC]) {
  if constexpr (std::is_same<KV, int8_t>::value) {
    widen_q8<T, VEC>(p, scale, x);
  } else {
    widen<T, VEC>(p, x);
  }
}

// Per instantiation: TPK lanes hold one key row (16 bytes a lane, or 8 at
// G >= 4 where a row still fits one warp, halving the registers of the G
// query rows and accumulators); NS streams in the CTA; U rows a stream
// takes per step.
template <typename T, int HD, int G>
struct Cfg {
  static constexpr int ES = sizeof(T);
  static constexpr int TPK16 = HD * ES / 16;
  static constexpr int TPK = (G >= 4 && 2 * TPK16 <= 32) ? 2 * TPK16 : TPK16;
  static constexpr int VEC = HD / TPK;
  static constexpr int NS = NC / TPK;
  static constexpr int U = G <= 2 ? 4 : 2;
  // the stream merge's (m, l) and accumulators, laid over the ring
  static constexpr int SCRATCH = NS * G * (2 + HD) * 4;
  static_assert(TPK <= 32 && 32 % TPK == 0 && NC % TPK == 0, "a key row inside one warp");
};

// One tile of the CTA's list: R rows of one page.
struct Tile {
  int page;                  // physical page (pool index)
  int row0;                  // first row of the tile within its page
  int nkeys;                 // rows of the tile below T (<= R)
  unsigned long long live;   // bit i: row i of the tile is attendable
};

struct DecodeArgs {
  const void* q;
  void* out;
  const int* page_table;   // [B, maxp]
  const int* mask;         // [B, T]
  const float* k_scale;    // int8 mode: the layer's scale planes [P, page]
  const float* v_scale;
  int Hkv, T, page, maxp;
  int rows;                // R
  int tiles_per_page;
  int ntiles;              // tiles holding a key below T
  int stages;
  float scale_log2;        // sm_scale * log2(e)
  int off_scales;          // int8 mode: [stages][2][rows] fp32 scale rows
  int off_bars, off_list, off_count, off_inbox;   // shared-memory byte offsets
};

// T: q's and out's dtype (the compute dtype); KV: the pools' (T, or int8).
template <typename T, typename KV, int HD, int G>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const DecodeArgs a) {
  using C = Cfg<T, HD, G>;
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  constexpr int VEC = C::VEC, TPK = C::TPK, NS = C::NS, U = C::U;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.off_bars);
  uint64_t* empty = full + a.stages;
  Tile* list = reinterpret_cast<Tile*>(smem + a.off_list);
  int* count = reinterpret_cast<int*>(smem + a.off_count);
  float* inbox = reinterpret_cast<float*>(smem + a.off_inbox);   // [nsplit][G][2 + cols]

  const int hk = blockIdx.x, b = blockIdx.y;
  const int rank = (int)hopper::cluster_ctarank();
  const int nsplit = (int)hopper::cluster_nctarank();
  const int cols = HD / nsplit;   // output columns a rank merges and writes
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int Hq = a.Hkv * G;
  const uint32_t tile_bytes = (uint32_t)a.rows * HD * sizeof(KV);

  hopper::cluster_arrive_relaxed();   // waited on before the first store to a peer
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, CONSUMER_WARPS);
    }
    hopper::mbar_fence_init();
  }

  // 1. This rank's candidate tiles rank, rank + nsplit, ...: warp w reads
  //    the mask words (coalesced, lane = row) and page ids of tiles w, w +
  //    WARPS, ..., LIST_TILES of them before it uses any, so the loads are
  //    in flight together.
  const int* mrow = a.mask + (int64_t)b * a.T;
  const int* prow = a.page_table + (int64_t)b * a.maxp;
  const int ncand = rank < a.ntiles ? (a.ntiles - rank + nsplit - 1) / nsplit : 0;
  for (int base = warp; base < ncand; base += WARPS * LIST_TILES) {
    int lo[LIST_TILES], hi[LIST_TILES], pg[LIST_TILES];
#pragma unroll
    for (int j = 0; j < LIST_TILES; ++j) {
      const int i = base + j * WARPS;
      lo[j] = hi[j] = pg[j] = 0;
      if (i < ncand) {
        const int tile = rank + i * nsplit;
        const int pi = tile / a.tiles_per_page;
        const int key0 = pi * a.page + (tile - pi * a.tiles_per_page) * a.rows;
        const int nkeys = min(a.rows, min((pi + 1) * a.page, a.T) - key0);
        if (lane < nkeys) lo[j] = mrow[key0 + lane];
        if (lane + 32 < nkeys) hi[j] = mrow[key0 + 32 + lane];
        if (lane == 0) pg[j] = prow[pi];
      }
    }
#pragma unroll
    for (int j = 0; j < LIST_TILES; ++j) {
      const int i = base + j * WARPS;
      const unsigned blo = __ballot_sync(0xffffffffu, lo[j] != 0);
      const unsigned bhi = __ballot_sync(0xffffffffu, hi[j] != 0);
      if (lane == 0 && i < ncand) {
        const int tile = rank + i * nsplit;
        const int pi = tile / a.tiles_per_page;
        const int row0 = (tile - pi * a.tiles_per_page) * a.rows;
        const int nkeys = min(a.rows, min(a.page, a.T - pi * a.page) - row0);
        list[i] = Tile{pg[j], row0, nkeys, ((unsigned long long)bhi << 32) | blo};
      }
    }
  }
  __syncthreads();

  // 2. Keep the tiles holding a live key, in order (warp 0, in place).
  if (warp == 0) {
    int n = 0;
    for (int c0 = 0; c0 < ncand; c0 += 32) {
      const int i = c0 + lane;
      Tile t{};
      if (i < ncand) t = list[i];
      const bool live = i < ncand && t.live != 0ull;
      const unsigned bal = __ballot_sync(0xffffffffu, live);
      __syncwarp();   // the chunk is read before any of it is overwritten
      if (live) list[n + __popc(bal & ((1u << lane) - 1u))] = t;
      n += __popc(bal);
      __syncwarp();
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  const int nlive = *count;

  if (warp == CONSUMER_WARPS) {
    // 3a. The producer: K and V tiles of the list into the ring by TMA.
    if (lane == 0) {
      for (int t = 0; t < nlive; ++t) {
        const int s = t % a.stages;
        hopper::mbar_wait(empty + s, ((t / a.stages) & 1) ^ 1);
        const int pg = list[t].page, row0 = list[t].row0;
        // int8 mode: the tile's rows inside its page (a multiple of 4)
        const uint32_t scale_bytes = Q8 ? (uint32_t)min(a.rows, a.page - row0) * 4u : 0u;
        hopper::mbar_arrive_expect_tx(full + s, 2 * tile_bytes + 2 * scale_bytes);
        unsigned char* dst = smem + (size_t)s * 2 * tile_bytes;
        hopper::tma_load_4d(dst, &tm_k, full + s, 0, hk, row0, pg);
        hopper::tma_load_4d(dst + tile_bytes, &tm_v, full + s, 0, hk, row0, pg);
        if constexpr (Q8) {
          float* sdst = reinterpret_cast<float*>(smem + a.off_scales) + s * 2 * a.rows;
          const int64_t srow = (int64_t)pg * a.page + row0;
          hopper::bulk_load(sdst, a.k_scale + srow, scale_bytes, full + s);
          hopper::bulk_load(sdst + a.rows, a.v_scale + srow, scale_bytes, full + s);
        }
      }
    }
    __syncwarp();
    hopper::cluster_wait();
  } else {
    // 3b. The consumers: stream st takes rows st, st + NS, ... of each tile.
    const T* q = static_cast<const T*>(a.q);
    const int li = threadIdx.x % TPK, st = threadIdx.x / TPK;
    const unsigned smask = TPK == 32 ? 0xffffffffu
                                     : ((1u << TPK) - 1u) << (lane & ~(TPK - 1));
    float qv[G][VEC];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      widen<T, VEC>(q + ((int64_t)b * Hq + hk * G + g) * HD + li * VEC, qv[g]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) qv[g][j] *= a.scale_log2;
    }
    float m[G], l[G], acc[G][VEC];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[g][j] = 0.f;
    }

    for (int t = 0; t < nlive; ++t) {
      const int s = t % a.stages;
      hopper::mbar_wait(full + s, (t / a.stages) & 1);
      const int nkeys = list[t].nkeys;
      const unsigned long long live = list[t].live;
      const KV* kt = reinterpret_cast<const KV*>(smem + (size_t)s * 2 * tile_bytes) + li * VEC;
      const KV* vt = kt + a.rows * HD;
      // int8 mode: the tile's K and V scale rows, in the ring stage
      const float* ks = reinterpret_cast<const float*>(smem + a.off_scales) + s * 2 * a.rows;
      const float* vs = ks + a.rows;
      for (int r0 = st; r0 < nkeys; r0 += NS * U) {   // uniform within the stream
        bool ok[U];
        float sc[U][G];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int r = r0 + u * NS;
          ok[u] = r < nkeys && ((live >> r) & 1ull);
          float kx[VEC];
          if (r < nkeys) {
            load_row<T, KV, VEC>(kt + r * HD, Q8 ? ks[r] : 1.f, kx);
          } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j) kx[j] = 0.f;
          }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float d = 0.f;
#pragma unroll
            for (int j = 0; j < VEC; ++j) d = fmaf(qv[g][j], kx[j], d);
            sc[u][g] = d;
          }
        }
#pragma unroll
        for (int off = TPK / 2; off > 0; off >>= 1) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int g = 0; g < G; ++g) sc[u][g] += __shfl_xor_sync(smask, sc[u][g], off);
          }
        }
        // online softmax over these U rows (log2 domain); sc becomes p
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float mc = NEG_INF;
#pragma unroll
          for (int u = 0; u < U; ++u) mc = fmaxf(mc, ok[u] ? sc[u][g] : NEG_INF);
          const float mn = fmaxf(m[g], mc);
          const float alpha = exp2_ftz(m[g] - mn);
          l[g] *= alpha;
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[g][j] *= alpha;
          m[g] = mn;
#pragma unroll
          for (int u = 0; u < U; ++u) sc[u][g] = ok[u] ? exp2_ftz(sc[u][g] - mn) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (!ok[u]) continue;   // a dead row's V (any bits) is never read into acc
          float vx[VEC];
          const int r = r0 + u * NS;
          load_row<T, KV, VEC>(vt + r * HD, Q8 ? vs[r] : 1.f, vx);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            l[g] += sc[u][g];
            const float pr = Num<T>::round(sc[u][g]);
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[g][j] = fmaf(pr, vx[j], acc[g][j]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + s);
    }

    // 4. Merge the streams (the ring is free: every load was waited for)
    //    and push this rank's (m, l, acc) into the inbox of the rank that
    //    owns each column: owner c merges columns [c cols, (c + 1) cols).
    hopper::named_barrier(1, NC);
    float* sc_ml = reinterpret_cast<float*>(smem);   // [NS][G][2]
    float* sc_acc = sc_ml + NS * G * 2;              // [NS][G][HD]
    if (li == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        sc_ml[(st * G + g) * 2] = m[g];
        sc_ml[(st * G + g) * 2 + 1] = l[g];
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) sc_acc[(st * G + g) * HD + li * VEC + j] = acc[g][j];
    }
    hopper::named_barrier(1, NC);
    hopper::cluster_wait();   // every CTA of the cluster has started
    for (int i = threadIdx.x; i < G * HD; i += NC) {
      const int g = i / HD, d = i - g * HD;
      float M = NEG_INF;
      for (int s = 0; s < NS; ++s) M = fmaxf(M, sc_ml[(s * G + g) * 2]);
      float L = 0.f, A = 0.f;
      for (int s = 0; s < NS; ++s) {
        const float w = exp2_ftz(sc_ml[(s * G + g) * 2] - M);
        L = fmaf(sc_ml[(s * G + g) * 2 + 1], w, L);
        A = fmaf(sc_acc[(s * G + g) * HD + d], w, A);
      }
      const int owner = d / cols, dd = d - owner * cols;
      uint32_t* box = reinterpret_cast<uint32_t*>(inbox + (rank * G + g) * (2 + cols));
      hopper::st_dsmem(box + 2 + dd, owner, __float_as_uint(A));
      if (dd == 0) {
        hopper::st_dsmem(box, owner, __float_as_uint(M));
        hopper::st_dsmem(box + 1, owner, __float_as_uint(L));
      }
    }
  }
  __syncwarp();
  hopper::cluster_sync();   // every rank's state is in its owners' inboxes

  // 5. Merge the ranks' states for this rank's columns, in rank order.
  if (warp < CONSUMER_WARPS) {
    T* out = static_cast<T*>(a.out);
    for (int i = threadIdx.x; i < G * cols; i += NC) {
      const int g = i / cols, dd = i - g * cols;
      float M = NEG_INF;
      for (int r = 0; r < nsplit; ++r) M = fmaxf(M, inbox[(r * G + g) * (2 + cols)]);
      float L = 0.f, O = 0.f;
      for (int r = 0; r < nsplit; ++r) {
        const float* box = inbox + (r * G + g) * (2 + cols);
        const float w = exp2_ftz(box[0] - M);
        L = fmaf(box[1], w, L);
        O = fmaf(box[2 + dd], w, O);
      }
      out[((int64_t)b * Hq + hk * G + g) * HD + rank * cols + dd] =
          Num<T>::cast(L == 0.f ? 0.f : O / L);
    }
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

struct LaunchIn {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;   // int8 mode only
  const int *page_table, *mask;
  void* o;
  int B, Hkv, T, page, maxp;
  float sm_scale;
};

// The pool [P, page, Hkv, hd] as the 4-D (hd, Hkv, page, P), box (hd, 1,
// rows, 1), no swizzle (rows of up to 512 bytes); rows past the page's end
// read as zeros (they hold keys of no tile).
template <typename KV>
int encode_pool_map(CUtensorMap* map, const void* base, int Hkv, int HD, int page,
                    int rows) {
  const hopper::EncodeTiledFn enc = hopper::encode_tiled();
  if (enc == nullptr) return hopper::kEncodeMissing;
  const cuuint64_t es = sizeof(KV);
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)Hkv, (cuuint64_t)page,
                              (cuuint64_t)INT32_MAX};
  const cuuint64_t strides[3] = {HD * es, (cuuint64_t)Hkv * HD * es,
                                 (cuuint64_t)page * Hkv * HD * es};
  const cuuint32_t box[4] = {(cuuint32_t)HD, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, Tma<KV>::TYPE, 4, const_cast<void*>(base), dims, strides, box,
                         elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : hopper::kEncodeFailed + (int)r;
}

// What a launch has settled per instantiation: the dynamic shared memory
// allowed so far and the (bytes, cluster size) whose occupancy was checked.
struct Settled {
  std::mutex mu;
  int smem_allowed = 0;
  int checked_smem = -1, checked_split = -1;
};

constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

// Tile rows: a tile holds at most TILE_BYTES of K, MAX_ROWS keys, and keys
// of one page.  With int8 pools (1-byte rows) MAX_ROWS decides at hd 64 and
// 128: 64 rows, 4 or 8 KB of K a tile, a ring of 4 or 2 stages.
int tile_rows(int hd, int esize, int page) {
  return std::max(1, std::min(std::min(TILE_BYTES / (hd * esize), MAX_ROWS), page));
}

template <typename T, typename KV, int HD, int G>
int launch(const LaunchIn& in, cudaStream_t stream) {
  using C = Cfg<T, HD, G>;
  const int R = tile_rows(HD, (int)sizeof(KV), in.page);
  const int tpp = (in.page + R - 1) / R;
  const int ntiles = (in.T / in.page) * tpp + (in.T % in.page + R - 1) / R;
  // The cluster: the largest of 1, 2, 4, 8 not above the tile count.
  int nsplit = 1;
  while (nsplit * 2 <= std::min(MAX_SPLIT, ntiles)) nsplit *= 2;
  const int tile_bytes = R * HD * (int)sizeof(KV);
  const int stages = std::max(2, std::min(MAX_STAGES, RING_BYTES / (2 * tile_bytes)));

  DecodeArgs a{};
  a.q = in.q;
  a.out = in.o;
  a.page_table = in.page_table;
  a.mask = in.mask;
  a.k_scale = in.k_scale;
  a.v_scale = in.v_scale;
  a.Hkv = in.Hkv;
  a.T = in.T;
  a.page = in.page;
  a.maxp = in.maxp;
  a.rows = R;
  a.tiles_per_page = tpp;
  a.ntiles = ntiles;
  a.stages = stages;
  a.scale_log2 = in.sm_scale * hopper::LOG2E;
  int off = round_up(std::max(stages * 2 * tile_bytes, C::SCRATCH), 128);
  a.off_scales = off;
  if (std::is_same<KV, int8_t>::value) off += round_up(stages * 2 * R * (int)sizeof(float), 128);
  a.off_bars = off;
  off += 2 * stages * (int)sizeof(uint64_t);
  a.off_list = off;
  off += std::max(1, (ntiles + nsplit - 1) / nsplit) * (int)sizeof(Tile);
  a.off_count = off;
  off += 16;
  a.off_inbox = off;
  const int smem = off + nsplit * G * (2 + HD / nsplit) * (int)sizeof(float);

  CUtensorMap tm_k, tm_v;
  int err = encode_pool_map<KV>(&tm_k, in.k, in.Hkv, HD, in.page, R);
  if (err == 0) err = encode_pool_map<KV>(&tm_v, in.v, in.Hkv, HD, in.page, R);
  if (err != 0) return err;

  auto kern = decode_attention_kernel<T, KV, HD, G>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = nsplit;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(in.Hkv, in.B, nsplit);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  {
    // settled once per shape (before a CUDA graph captures the launch)
    static Settled settled;
    std::lock_guard<std::mutex> lock(settled.mu);
    if (smem > settled.smem_allowed) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      settled.smem_allowed = smem;
    }
    if (smem != settled.checked_smem || nsplit != settled.checked_split) {
      int clusters = 0;
      const cudaError_t e =
          cudaOccupancyMaxActiveClusters(&clusters, (const void*)kern, &cfg);
      if (e != cudaSuccess) return e;
      if (clusters == 0) return cudaErrorLaunchOutOfResources;
      settled.checked_smem = smem;
      settled.checked_split = nsplit;
    }
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, tm_k, tm_v, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, bool Q8, int HD>
int dispatch_group(int G, const LaunchIn& in, cudaStream_t st) {
  using KV = typename std::conditional<Q8, int8_t, T>::type;
  switch (G) {
    case 1: return launch<T, KV, HD, 1>(in, st);
    case 2: return launch<T, KV, HD, 2>(in, st);
    case 4: return launch<T, KV, HD, 4>(in, st);
    case 8: return launch<T, KV, HD, 8>(in, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool Q8, int HD>
int dispatch_dtype(int dtype, int G, const LaunchIn& in, cudaStream_t st) {
  switch (dtype) {
    case 0: return dispatch_group<float, Q8, HD>(G, in, st);
    case 1: return dispatch_group<__half, Q8, HD>(G, in, st);
    case 2: return dispatch_group<__nv_bfloat16, Q8, HD>(G, in, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool Q8>
int dispatch(const LaunchIn& in, int Hq, int hd, int dtype, cudaStream_t st) {
  const int G = Hq / in.Hkv;
  if (hd == 64) return dispatch_dtype<Q8, 64>(dtype, G, in, st);
  if (hd == 128) return dispatch_dtype<Q8, 128>(dtype, G, in, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Returns 0 on success,
// else the cudaError_t of the launch (a cluster that cannot be scheduled at
// this shared memory is cudaErrorLaunchOutOfResources) or a tensor-map code
// (ds_cuda_error_string reads both).  The Python wrapper has checked
// shapes, dtypes, contiguity, 16-byte alignment and T <= maxp * page before
// calling.  T = 0 writes zeros (no row has a key).
int ds_decode_attention(const void* q, const void* k, const void* v,
                        const int* page_table, const int* mask, void* o, int B,
                        int Hq, int Hkv, int hd, int T_len, int page, int maxp,
                        int dtype, float sm_scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || page <= 0 || T_len < 0 || T_len > maxp * page)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const LaunchIn in{q, k, v, nullptr, nullptr, page_table, mask, o,
                    B, Hkv, T_len, page, maxp, sm_scale};
  return dispatch<false>(in, Hq, hd, dtype, static_cast<cudaStream_t>(stream));
}

// The int8 mode: k and v are int8 pools [P, page, Hkv, hd] with fp32 scale
// planes k_scale, v_scale [P, page] (one scale a pool row, page % 4 == 0,
// 16-byte aligned); q, out and the arithmetic in dtype, as above.  The
// wrapper has checked the planes' shapes, dtypes and alignment.
int ds_decode_attention_q8(const void* q, const void* k, const void* v,
                           const float* k_scale, const float* v_scale,
                           const int* page_table, const int* mask, void* o, int B,
                           int Hq, int Hkv, int hd, int T_len, int page, int maxp,
                           int dtype, float sm_scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || page <= 0 || T_len < 0 || T_len > maxp * page ||
      k_scale == nullptr || v_scale == nullptr)
    return cudaErrorInvalidValue;
  // a tile's scale rows are one bulk copy: 16-byte aligned, whole 16 bytes
  if (page % 4 != 0 || reinterpret_cast<uintptr_t>(k_scale) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_scale) % 16 != 0)
    return cudaErrorMisalignedAddress;
  if (B == 0) return cudaSuccess;
  const LaunchIn in{q, k, v, k_scale, v_scale, page_table, mask, o,
                    B, Hkv, T_len, page, maxp, sm_scale};
  return dispatch<true>(in, Hq, hd, dtype, static_cast<cudaStream_t>(stream));
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
