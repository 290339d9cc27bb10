// Segment count-sort (K1) and segment rank-map (K2) for Hopper (sm_90a).
//
// Both kernels work on a row-major (B, G*L) float32 array cut into B*G
// contiguous segments of length L (segment s starts at element s*L).
//
// K1 replaces count_sort_segments / count_sort_rows
// (skdownscale_tpu/ops/pallas/rank_map_kernel.py) and sorts each segment
// on order-isomorphic int32 keys, bitwise, in the order
// -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN.  Tied keys carry
// identical bits, so any slot a tied key lands in holds the same value.
//
// K2 replaces rank_map_segments / rank_map_rows (same file).  With float
// compares (-0 == +0, NaN compares false),
//     rank_t = #{s : x_s <= x_t} - 1,   out_t = res[rank_t]  (NaN if -1),
// so tied queries take the run-end rank and a NaN query gives NaN.
//
// The TPU kernels compare every element with every member of its segment
// (L^2 broadcast compares a segment).  Here the launcher picks one of four
// routes by L before any launch (k1_route / k2_route below; the Python
// mirror is kernels/rank_map.py's route()).  Every route is a kernel of
// this file.
//
// * packed (K1: L <= 64; K2: L <= 256): whole segments packed end to end,
//   four keys of one segment a thread.  A tile is P whole segments (U =
//   ceil(L / 4) threads each, P = 256 / U: at L = 40, 25 segments on 250 of
//   256 threads), staged in shared memory with each segment at a stride of
//   round_up(L, 4) words, so that every segment starts on a 16-byte line
//   and is read 4 keys a load (ld.shared.v4); pad slots hold a key that
//   never counts.  Thread t takes segment t / U and its places u, u + U,
//   u + 2U, u + 3U (u = t % U), so each key read from shared memory is
//   compared with four of the thread's own keys held in registers, each
//   compare a predicate and an add under it.  No lane idles at a ragged
//   segment end: a segment idles at most 3 places, and only a tile's last
//   warp has idle lanes.  At L = 40 a warp spans at most 4 segments whose
//   16-byte reads are 10 lines apart, on different banks; lanes of one
//   segment read one address (a broadcast).  The grid is persistent (the
//   resident blocks, each walking tiles b, b + gridDim.x, ...): cp.async
//   brings the next tile into a second buffer while the block counts this
//   one, which overlaps the loads with the count (with a block a tile they
//   ran one after the other: too few loads were in flight an SM while its
//   blocks counted).
//   K2: c = #{s : q_s <= q_t} over the staged segment, out = res[c - 1]
//   (res staged beside the keys) into a shared row, stored coalesced.
//   K1: c = #{s : k_s <= k_t} (the run end), sorted[c - 1] = k_t into a
//   shared row preset to the largest key; at the coalesced store each slot
//   left unset (a tie hole) takes the next set slot's key, by a walk as long
//   as the tie run.  The stable rank, #{k_s < k_t} + #{s < t : k_s ==
//   k_t}, fills every slot once but costs three compares a member
//   (SDT_K1_STABLE=1 builds it).
// * warp (above the packed route, L <= 1,024): a warp a segment, four a
//   block.  K1 sorts the segment with the stable LSD radix sort of
//   radix_sort.cuh (K9's warp route; K1 takes L <= 256).  K2 folds each
//   query to a 32-bit key (-0 onto +0, every NaN onto 0xffffffff, above
//   +inf's 0xff800000) and sorts (key, position) with the same sort; a
//   slot's run end j is the highest lane of its item holding its key
//   (__match_any_sync), or, where the run goes on past lane 31, the next
//   item's lane 0's run end, carried from the last item to the first;
//   out[pos] = res[j] (NaN for the NaN key) goes into the warp's key buffer
//   by position and out as one coalesced row.  This is the JAX package's
//   non-kernel route (grouped.py _rank_fill_unsort) on the warp's
//   registers.
// * block (1,024 < L <= 16,384, K2): a block a segment, 8 to 16 warps, the
//   block route of the same radix sort; the run ends are found in each
//   warp's chunk, the first key and the first run end of each chunk are
//   exchanged through shared memory (two barriers), and the row goes out
//   through the key buffer as on the warp route.
// * search (L > 16,384, K2): positions no longer fit 16 bits and a row no
//   longer fits shared memory, so a first kernel sorts the folded keys of
//   each chunk of at most 16,384 (a block a chunk, the block sort) into a
//   device-memory scratch row, and a second gives each query
//   c = sum over chunks of upper_bound(chunk, key), out = res[c - 1].  Any
//   L takes it (a daily series of 1950-2100 has L = 55,152).
//
// What bounds them on the H100.  The compulsory traffic is 8 B an element
// for K1 and 12 B for K2 (0.15 / 0.23 ms at config 2's 6.3e7 elements at
// 3.35 TB/s).  The packed route does L compares an element, two
// instructions each: about 1.6e8 warp instructions at L = 40, some 0.2 ms
// of the SMs' issue, so issue and the bytes are of the same size, and the
// pipeline overlaps the two.  The radix routes spend some 60 warp
// instructions a pass on 32 items (radix_sort.cuh), so issue and
// shared-memory latency bound them, far above the bytes.  The search
// route is a repair: a binary search of device memory a chunk a query.
//
// Trial switches (chip_smoke.py --trials builds each and times it against
// the default): SDT_K1_SHORT_MAX / SDT_K2_SHORT_MAX (the packed route's
// longest L; 0 sends every L to the radix routes), SDT_RANK_PACKED_ITEMS
// (keys a thread counts on the packed route), SDT_RANK_PACKED_THREADS
// (threads a packed block), SDT_RANK_COUNT (1: the compiler's form of the
// compare), SDT_RANK_RUN_END (0: run ends by a reverse min-scan of
// shuffles), SDT_RANK_WARP_MIN_BLOCKS (K2's warp route's floor on resident
// blocks an SM up to 24 keys a lane, 8, which caps its registers), SDT_K1_STABLE (K1's stable
// rank), SDT_K2_SEARCH_MIN (the shortest L of the search route).
//
// The C entry points take plain pointers, sizes and the CUDA stream, launch
// on that stream without synchronising, and return cudaGetLastError();
// sdt_rank_map_route and sdt_rank_map_geometry report the route and launch
// a length takes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "radix_sort.cuh"

#ifndef SDT_K1_SHORT_MAX
#define SDT_K1_SHORT_MAX 64
#endif
#ifndef SDT_K2_SHORT_MAX
#define SDT_K2_SHORT_MAX 256
#endif
#ifndef SDT_RANK_PACKED_ITEMS
#define SDT_RANK_PACKED_ITEMS 4
#endif
#ifndef SDT_RANK_PACKED_THREADS
#define SDT_RANK_PACKED_THREADS 256
#endif
#ifndef SDT_RANK_COUNT
#define SDT_RANK_COUNT 0
#endif
#ifndef SDT_RANK_RUN_END
#define SDT_RANK_RUN_END 1
#endif
#ifndef SDT_RANK_WARP_MIN_BLOCKS
#define SDT_RANK_WARP_MIN_BLOCKS 8
#endif
#ifndef SDT_K1_STABLE
#define SDT_K1_STABLE 0
#endif
#ifndef SDT_K2_SEARCH_MIN
#define SDT_K2_SEARCH_MIN 16385
#endif

namespace {

using namespace radix;

constexpr int kK1ShortMax = SDT_K1_SHORT_MAX;  // longest L of K1's packed route
constexpr int kK2ShortMax = SDT_K2_SHORT_MAX;  // longest L of K2's packed route
constexpr int kPackedThreads = SDT_RANK_PACKED_THREADS;  // most threads a packed block
constexpr int kPackedItems = SDT_RANK_PACKED_ITEMS;  // keys a thread counts on the packed route
constexpr int kRowsPerBlock = 4;               // warps (segments) a block on the warp route
constexpr int kK1MaxLen = 256;                 // COUNT_SORT_MAX_LEN of kernels/rank_map.py
constexpr int kBlockMaxLen = 16384;            // longest L of the block route (and a chunk)
constexpr int kSearchMin = SDT_K2_SEARCH_MIN;  // shortest L of the search route
constexpr int kSearchThreads = 256;
constexpr uint32_t kNanKey = 0xffffffffu;  // every NaN query's folded key
static_assert(kK1ShortMax <= kPackedThreads * kPackedItems &&
                  kK2ShortMax <= kPackedThreads * kPackedItems,
              "a packed block holds a segment");

enum Route { kPacked = 0, kWarp = 1, kBlock = 2, kSearch = 3 };

int k1_route(int L) { return L <= kK1ShortMax ? kPacked : kWarp; }

int k2_route(int L) {
  if (L <= kK2ShortMax) return kPacked;
  if (L >= kSearchMin) return kSearch;
  return L <= kWarpRouteMaxLen ? kWarp : L <= kBlockMaxLen ? kBlock : kSearch;
}

__device__ __forceinline__ int32_t ordered_key(float v) {
  const int32_t b = __float_as_int(v);
  return b >= 0 ? b : (~b) ^ INT32_MIN;
}

__device__ __forceinline__ float key_to_float(int32_t k) {
  const int32_t b = k >= 0 ? k : ~(k ^ INT32_MIN);
  return __int_as_float(b);
}

// K2's key: the unsigned order is the float order, -0 and +0 share +0's
// key, and every NaN has the key 0xffffffff, above +inf's, so no query
// counts a NaN member
__device__ __forceinline__ uint32_t folded_ukey(float v) {
  if (v != v) return kNanKey;
  if ((__float_as_uint(v) << 1) == 0u) return 0x80000000u;  // ordered_ukey(+0)
  return ordered_ukey(v);
}

__device__ __forceinline__ float nan_value() { return __int_as_float(0x7fc00000); }

// c + (a <= b) (false where a or b is NaN): the packed route's compare, a
// compare into a predicate and an add under it, two instructions.  The
// compiler's own form of `c += (a <= b)` (SDT_RANK_COUNT=1) takes three: a
// compare, an add and a move under the predicate.
__device__ __forceinline__ int count_le(int c, float a, float b) {
#if SDT_RANK_COUNT == 0
  asm("{\n\t.reg .pred p;\n\tsetp.le.f32 p, %1, %2;\n\t@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(c) : "f"(a), "f"(b));
  return c;
#else
  return c + (a <= b);
#endif
}

__device__ __forceinline__ int count_le(int c, int32_t a, int32_t b) {
#if SDT_RANK_COUNT == 0
  asm("{\n\t.reg .pred p;\n\tsetp.le.s32 p, %1, %2;\n\t@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(c) : "r"(a), "r"(b));
  return c;
#else
  return c + (a <= b);
#endif
}

// c + #{w.x, w.y, w.z, w.w <= b}
template <class V, class T>
__device__ __forceinline__ int count_le4(int c, const V& w, T b) {
  return count_le(count_le(count_le(count_le(c, w.x, b), w.y, b), w.z, b), w.w, b);
}

// ---------------------------------------------------------------------------
// packed route
// ---------------------------------------------------------------------------

// threads a segment (each holds kPackedItems of its places) and segments
// a block on the packed route
__host__ __device__ inline int packed_threads_per_segment(int L) {
  return (L + kPackedItems - 1) / kPackedItems;
}
__host__ __device__ inline int packed_segments(int L) {
  const int p = kPackedThreads / packed_threads_per_segment(L);
  return p < 1 ? 1 : p;
}

__host__ __device__ inline int padded_len(int L) { return (L + 3) & ~3; }

// Every kernel of the file takes these arguments (one launch path); each
// reads the ones it needs.
#define RANK_MAP_ARGS                                                                   \
  const float *__restrict__ x, const float *__restrict__ res, float *__restrict__ out, \
      uint32_t *__restrict__ scratch, int64_t n_seg, int L

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A persistent grid: block b takes tiles b, b + gridDim.x, ..., tile i being
// segments [i*P, i*P + P) (fewer in the last), the run of n = segments * L
// elements at element i*P*L.  Staging: cp.async brings tile i + gridDim.x
// into the other buffer while the block counts tile i, element e of the run
// to slot (e / L) * Lp + e % L of the staged keys (e / L by a
// multiply-high) and (K2) res[e] to slot e of the staged res.  Counting:
// thread t takes segment s = t / U and the places u + r*U (r <
// kPackedItems, u = t % U) of it, so every key read from shared memory is
// compared with kPackedItems of the thread's own keys.  Writing: through a
// shared row (K2: the output; K1: the sorted slots), coalesced.  Shared
// memory, P * Lp words each: two staged key buffers, (K2) two res buffers,
// and the row out.  Three barriers a tile: the tile in, the row written, the
// row read.
template <bool kSort>
__global__ void __launch_bounds__(kPackedThreads) packed_kernel(RANK_MAP_ARGS) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = kPackedItems;
  const int U = packed_threads_per_segment(L);
  const int P = packed_segments(L), Lp = padded_len(L), PL = P * Lp;
  const int64_t tiles = (n_seg + P - 1) / P;
  // e / L == umulhi(e, ceil(2^32 / L)) for e * L < 2^32 (L = 1: e)
  const uint32_t inv_L = L == 1 ? 0u : 0xffffffffu / (uint32_t)L + 1u;
  auto seg_of = [L, inv_L](int e) { return L == 1 ? e : (int)__umulhi((uint32_t)e, inv_L); };
  auto tile_len = [&](int64_t tile) { return (int)min((int64_t)P, n_seg - tile * P) * L; };
  float* stage = reinterpret_cast<float*>(smem);  // [2][PL] keys, then (K2) [2][PL] res
  float* res_stage = stage + 2 * PL;
  int32_t* row_out = reinterpret_cast<int32_t*>(stage + (kSort ? 2 : 4) * PL);  // [PL]

  // the pads of both key buffers: a key that never counts
  for (int e = threadIdx.x; e < 2 * P * (Lp - L); e += blockDim.x) {
    const int at = (e / (Lp - L)) * Lp + L + e % (Lp - L);
    if (kSort) reinterpret_cast<int32_t*>(stage)[at] = INT32_MAX;  // the largest key
    else stage[at] = nan_value();                                 // NaN <= v is false
  }
  auto prefetch = [&](int64_t tile, int b) {
    if (tile < tiles) {
      const int n = tile_len(tile);
      const int64_t base = tile * P * L;
      for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int se = seg_of(e);
        cp_async4(stage + b * PL + se * Lp + e - se * L, x + base + e);
        if (!kSort) cp_async4(res_stage + b * PL + e, res + base + e);
      }
    }
    cp_async_commit();
  };

  const int s = threadIdx.x / U, u = threadIdx.x - s * U;
  prefetch(blockIdx.x, 0);
  int b = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, b ^= 1) {
    prefetch(tile + gridDim.x, b ^ 1);
    cp_async_wait_one();  // this thread's copies of this tile are in
    const int n = tile_len(tile), segs = n / L;
    const int64_t base = tile * P * L;
    if (kSort) {
      // each thread maps the floats it copied to keys, and presets the slots
      int32_t* keys = reinterpret_cast<int32_t*>(stage + b * PL);
      for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int se = seg_of(e), at = se * Lp + e - se * L;
        keys[at] = ordered_key(__int_as_float(keys[at]));
        row_out[at] = INT32_MAX;  // unset
      }
    }
    __syncthreads();  // the tile is in
    if (s < segs) {
      if (kSort) {
        const int32_t* row = reinterpret_cast<const int32_t*>(stage + b * PL) + s * Lp;
        int32_t kt[R];
        int c[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          kt[r] = u + r * U < L ? row[u + r * U] : INT32_MIN;
          c[r] = 0;
        }
        const int4* seg = reinterpret_cast<const int4*>(row);
        for (int k = 0; k < Lp / 4; ++k) {
          const int4 w = seg[k];
#if SDT_K1_STABLE
          // stable rank: #{k_s < k_t} + #{s < t : k_s == k_t}; a pad
          // (INT32_MAX, place >= L) never counts
          const int p0 = 4 * k;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int t = u + r * U;
            c[r] += (w.x < kt[r]) | ((w.x == kt[r]) & (p0 < t));
            c[r] += (w.y < kt[r]) | ((w.y == kt[r]) & (p0 + 1 < t));
            c[r] += (w.z < kt[r]) | ((w.z == kt[r]) & (p0 + 2 < t));
            c[r] += (w.w < kt[r]) | ((w.w == kt[r]) & (p0 + 3 < t));
          }
#else
#pragma unroll
          for (int r = 0; r < R; ++r) c[r] = count_le4(c[r], w, kt[r]);
#endif
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (u + r * U >= L) continue;
#if SDT_K1_STABLE
          row_out[s * Lp + c[r]] = kt[r];
#else
          if (kt[r] == INT32_MAX) c[r] -= Lp - L;  // the pads' key is the largest key
          row_out[s * Lp + c[r] - 1] = kt[r];      // the run end; tied keys write the same bits
#endif
        }
      } else {
        const float* row = stage + b * PL + s * Lp;
        const float* rs = res_stage + b * PL + s * L;
        float v[R];
        int c[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          v[r] = u + r * U < L ? row[u + r * U] : nan_value();
          c[r] = 0;
        }
        const float4* seg = reinterpret_cast<const float4*>(row);
        for (int k = 0; k < Lp / 4; ++k) {
          const float4 w = seg[k];
#pragma unroll
          for (int r = 0; r < R; ++r) c[r] = count_le4(c[r], w, v[r]);
        }
        float* o = reinterpret_cast<float*>(row_out);
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (u + r * U < L) o[s * L + u + r * U] = c[r] > 0 ? rs[c[r] - 1] : nan_value();
      }
    }
    __syncthreads();  // the row is written
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      if (kSort) {
        // a tie hole takes the next set slot's key: every slot before the
        // last that holds INT32_MAX is unset (the largest key's run ends at
        // the last slot), and the last slot is always set
        const int se = seg_of(e), p = e - se * L;
        const int32_t* row = row_out + se * Lp;
        int j = p;
        while (j < L - 1 && row[j] == INT32_MAX) ++j;
        out[base + e] = key_to_float(row[j]);
      } else {
        out[base + e] = reinterpret_cast<const float*>(row_out)[e];
      }
    }
    __syncthreads();  // the row is read; the next tile may write it
  }
}

// ---------------------------------------------------------------------------
// radix routes
// ---------------------------------------------------------------------------

// The run end of sorted slot m = (item start) + lane by a reverse min-scan
// (SDT_RANK_RUN_END=0): the least end slot >= m, an end being the row's
// last slot (or a slot past it) or a slot whose key differs from the next
// slot's.  `after` is the key of the slot after the item's lane 31,
// `carry` the least end after the item (INT_MAX if none is known).  Every
// lane of the warp calls it.
__device__ __forceinline__ int run_end(uint32_t key, uint32_t after, int m, int last, int carry,
                                       int lane) {
  uint32_t next = __shfl_down_sync(kFull, key, 1);
  if (lane == 31) next = after;
  int j = (m >= last || key != next) ? m : INT_MAX;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_down_sync(kFull, j, d);
    if (lane + d < 32) j = min(j, o);
  }
  return min(j, carry);
}

// The same run end from the lanes that hold the item's key
// (__match_any_sync, the default): the highest of them, or `carry` (the next item's
// lane 0's run end) where the run goes on past lane 31 into the next slot,
// which is in the row when `more`.  A NaN key's run may take pad lanes;
// its run end is not used.
__device__ __forceinline__ int run_end_match(uint32_t key, uint32_t after, bool more, int base,
                                             int carry) {
  const int hi = 31 - __clz(__match_any_sync(kFull, key));
  return (hi == 31 && more && key == after) ? carry : base + hi;
}

// K1, warp route: warp w of the block sorts segment blockIdx.x *
// kRowsPerBlock + w (L <= ITEMS * 32) as K9's warp route does, without
// positions.
template <int ITEMS>
__global__ void __launch_bounds__(32 * kRowsPerBlock) count_sort_warp_kernel(RANK_MAP_ARGS) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t seg = (int64_t)blockIdx.x * kRowsPerBlock + warp;
  if (seg >= n_seg) return;  // no block barrier follows
  unsigned char* slice = smem + warp * (kBuckets * 4 + buffer_bytes(L, false));
  unsigned* counts = reinterpret_cast<unsigned*>(slice);
  uint32_t* skey = reinterpret_cast<uint32_t*>(slice + kBuckets * 4);
  const float* src = x + seg * L;
  uint32_t key[ITEMS], pr[ITEMS];
  unsigned all, any;
  load_keys<ITEMS>([src](int j) { return ordered_ukey(src[j]); }, L, 0, lane, key, pr, all, any);
  warp_radix_sort<ITEMS, false>(key, pr, all ^ any, counts, skey, nullptr, L, lane);
  float* dst = out + seg * L;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = i * 32 + lane;
    if (j < L) dst[j] = ukey_to_float(key[i]);
  }
}

// K2, warp route: warp w sorts segment blockIdx.x * kRowsPerBlock + w by
// folded key with positions, finds each slot's run end, and writes the row
// out through its key buffer.  Up to 24 keys a lane the launch bounds ask
// for 8 resident blocks (32 warps) an SM, which holds a thread to 64
// registers (a few spill at 24 keys): at config 9a's L = 730 the latency
// the extra warps hide is worth more than the spills (PERF.md, the
// trials).
template <int ITEMS>
__global__ void __launch_bounds__(32 * kRowsPerBlock, ITEMS <= 24 ? SDT_RANK_WARP_MIN_BLOCKS : 1)
    rank_map_warp_kernel(RANK_MAP_ARGS) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t seg = (int64_t)blockIdx.x * kRowsPerBlock + warp;
  if (seg >= n_seg) return;  // no block barrier follows
  unsigned char* slice = smem + warp * (kBuckets * 4 + buffer_bytes(L, true));
  unsigned* counts = reinterpret_cast<unsigned*>(slice);
  uint32_t* skey = reinterpret_cast<uint32_t*>(slice + kBuckets * 4);
  uint16_t* spos = reinterpret_cast<uint16_t*>(slice + kBuckets * 4 + align16((size_t)L * 4));
  const float* src = x + seg * L;
  uint32_t key[ITEMS], pr[ITEMS];
  unsigned all, any;
  load_keys<ITEMS>([src](int j) { return folded_ukey(src[j]); }, L, 0, lane, key, pr, all, any);
  warp_radix_sort<ITEMS, true>(key, pr, all ^ any, counts, skey, spos, L, lane);
  // the sort's last reads of its buffers are behind it (__syncwarp)
  float* buf = reinterpret_cast<float*>(skey);
  const float* r = res + seg * L;
  int carry = INT_MAX;
  uint32_t after = 0;
#pragma unroll
  for (int i = ITEMS - 1; i >= 0; --i) {
    if (i * 32 >= L) continue;  // the same for every lane
    const int m = i * 32 + lane;
#if SDT_RANK_RUN_END
    const int j = run_end_match(key[i], after, i * 32 + 32 < L, i * 32, carry);
#else
    const int j = run_end(key[i], after, m, L - 1, carry, lane);
#endif
    carry = __shfl_sync(kFull, j, 0);
    after = __shfl_sync(kFull, key[i], 0);
    if (m < L) buf[pr[i] >> 16] = key[i] == kNanKey ? nan_value() : r[min(j, L - 1)];
  }
  __syncwarp();
  float* dst = out + seg * L;
  for (int t = lane; t < L; t += 32) dst[t] = buf[t];
}

// K2, block route: block b takes segment b (1,024 < L <= 16,384) with
// blockDim.x / 32 warps, warp w holding the chunk at c0 = w * ITEMS * 32.
// After the sort the counters' space holds each chunk's first key and
// least run end; each slot's run end rides in the low half of pr (0xffff:
// none in the chunk) until the later chunks' least run end is known.
template <int ITEMS>
__global__ void __launch_bounds__(32 * kBlockRouteMaxWarps) rank_map_block_kernel(RANK_MAP_ARGS) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * L;
  const int c0 = warp * ITEMS * 32;
  const int n = min(ITEMS * 32, L - c0);  // <= 0 for a warp past the row
  const float* src = x + base + c0;
  uint32_t key[ITEMS], pr[ITEMS];
  unsigned all, any;
  load_keys<ITEMS>([src](int j) { return folded_ukey(src[j]); }, n, c0, lane, key, pr, all, any);
  block_radix_sort<ITEMS, true>(key, pr, all, any, smem, L, n, c0);

  uint32_t* first_key = reinterpret_cast<uint32_t*>(smem);              // [kBlockRouteMaxWarps]
  int* first_end = reinterpret_cast<int*>(smem) + kBlockRouteMaxWarps;  // [kBlockRouteMaxWarps]
  if (lane == 0) first_key[warp] = key[0];
  __syncthreads();  // first keys in; every warp is past the sort's last reads
  int carry = INT_MAX;
  uint32_t after = warp + 1 < n_warps ? first_key[warp + 1] : 0u;
#pragma unroll
  for (int i = ITEMS - 1; i >= 0; --i) {
    if (i * 32 >= n) continue;  // the same for every lane of the warp
#if SDT_RANK_RUN_END
    const int j = run_end_match(key[i], after, c0 + i * 32 + 32 < L, c0 + i * 32, carry);
#else
    const int j = run_end(key[i], after, c0 + i * 32 + lane, L - 1, carry, lane);
#endif
    carry = __shfl_sync(kFull, j, 0);
    after = __shfl_sync(kFull, key[i], 0);
    pr[i] = (pr[i] & 0xffff0000u) | (uint32_t)min(j, 0xffff);
  }
  if (lane == 0) first_end[warp] = n > 0 ? carry : INT_MAX;
  __syncthreads();
  int later = INT_MAX;  // the least run end after this warp's chunk
  for (int w = warp + 1; w < n_warps; ++w) later = min(later, first_end[w]);
  float* buf = reinterpret_cast<float*>(smem + block_header_bytes(n_warps));  // the key buffer
  const float* r = res + base;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (i * 32 >= n) break;
    if (i * 32 + lane < n) {
      int j = (int)(pr[i] & 0xffffu);
      if (j == 0xffff) j = later;
      buf[pr[i] >> 16] = key[i] == kNanKey ? nan_value() : r[min(j, L - 1)];
    }
  }
  __syncthreads();
  float* dst = out + base;
  for (int t = threadIdx.x; t < L; t += blockDim.x) dst[t] = buf[t];
}

// the search route's chunks: C = ceil(L / kBlockMaxLen) of Lc = ceil(L / C)
__host__ __device__ inline int search_chunks(int L) { return (L + kBlockMaxLen - 1) / kBlockMaxLen; }
__host__ __device__ inline int search_chunk_len(int L) {
  const int C = search_chunks(L);
  return (L + C - 1) / C;
}

// K2, search route, first kernel: block b sorts chunk b % C of segment b / C
// by folded key (the block sort, no positions) into the scratch row.
template <int ITEMS>
__global__ void __launch_bounds__(32 * kBlockRouteMaxWarps) sort_chunks_kernel(RANK_MAP_ARGS) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = search_chunks(L), Lc = search_chunk_len(L);
  const int64_t seg = blockIdx.x / C;
  const int start = (int)(blockIdx.x % C) * Lc;
  const int len = min(Lc, L - start);
  const int64_t base = seg * L + start;
  const int c0 = warp * ITEMS * 32;
  const int n = min(ITEMS * 32, len - c0);
  const float* src = x + base + c0;
  uint32_t key[ITEMS], pr[ITEMS];
  unsigned all, any;
  load_keys<ITEMS>([src](int j) { return folded_ukey(src[j]); }, n, c0, lane, key, pr, all, any);
  block_radix_sort<ITEMS, false>(key, pr, all, any, smem, len, n, c0);
  uint32_t* dst = scratch + base + c0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = i * 32 + lane;
    if (j < n) dst[j] = key[i];
  }
}

// K2, search route, second kernel: thread t of block b takes query
// (b % tiles) * kSearchThreads + t of segment b / tiles.
__global__ void __launch_bounds__(kSearchThreads) search_kernel(RANK_MAP_ARGS) {
  const int tiles = (L + kSearchThreads - 1) / kSearchThreads;
  const int64_t seg = blockIdx.x / tiles;
  const int t = (int)(blockIdx.x % tiles) * kSearchThreads + threadIdx.x;
  if (t >= L) return;
  const int64_t base = seg * L;
  const uint32_t k = folded_ukey(x[base + t]);
  if (k == kNanKey) {
    out[base + t] = nan_value();
    return;
  }
  const int C = search_chunks(L), Lc = search_chunk_len(L);
  int c = 0;
  for (int ch = 0; ch < C; ++ch) {
    const uint32_t* a = scratch + base + ch * Lc;
    int lo = 0, hi = min(Lc, L - ch * Lc);
    while (lo < hi) {  // upper bound: the first key above k
      const int mid = (lo + hi) >> 1;
      if (a[mid] <= k) lo = mid + 1;
      else hi = mid;
    }
    c += lo;
  }
  out[base + t] = res[base + c - 1];
}

#undef RANK_MAP_ARGS

// ---------------------------------------------------------------------------
// launch plans
// ---------------------------------------------------------------------------

struct Launch {
  int route;
  const void* kernel;  // the (first) kernel
  int threads, items;  // items: keys a lane (radix routes), elements a thread (packed)
  size_t smem;
  int64_t blocks;
};

// a template instance by keys a lane: the warp route takes the least
// multiple of 4 that holds the row (K9's rule)
template <class F>
Launch with_warp_items(int L, F f) {
  switch ((L + 127) / 128) {
    case 1: return f(std::integral_constant<int, 4>{});
    case 2: return f(std::integral_constant<int, 8>{});
    case 3: return f(std::integral_constant<int, 12>{});
    case 4: return f(std::integral_constant<int, 16>{});
    case 5: return f(std::integral_constant<int, 20>{});
    case 6: return f(std::integral_constant<int, 24>{});
    case 7: return f(std::integral_constant<int, 28>{});
    default: return f(std::integral_constant<int, 32>{});
  }
}

// the block route (and a search chunk) takes 4 keys a lane up to 2,048, 12
// up to 4,096, 16 up to 8,192 (K9's choice) and 32 up to 16,384
template <class F>
Launch with_block_items(int L, F f) {
  if (L <= 2048) return f(std::integral_constant<int, 4>{});
  if (L <= 4096) return f(std::integral_constant<int, 12>{});
  if (L <= 8192) return f(std::integral_constant<int, 16>{});
  return f(std::integral_constant<int, 32>{});
}

// a persistent grid: as many blocks as are resident on the card, at most
// one a tile
Launch packed_plan(bool sort, int64_t n_seg, int L) {
  const int P = packed_segments(L);
  Launch l;
  l.route = kPacked;
  l.kernel = sort ? (const void*)packed_kernel<true> : (const void*)packed_kernel<false>;
  l.threads = (P * packed_threads_per_segment(L) + 31) / 32 * 32;
  l.items = kPackedItems;
  l.smem = (sort ? 3 : 5) * (size_t)P * padded_len(L) * 4;
  l.blocks = (n_seg + P - 1) / P;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) == cudaSuccess &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, l.kernel, l.threads, l.smem) ==
          cudaSuccess &&
      (int64_t)sms * per_sm > 0 && (int64_t)sms * per_sm < l.blocks)
    l.blocks = (int64_t)sms * per_sm;
  return l;
}

Launch warp_plan(const void* kernel, bool with_pos, int items, int64_t n_seg, int L) {
  Launch l;
  l.route = kWarp;
  l.kernel = kernel;
  l.threads = 32 * kRowsPerBlock;
  l.items = items;
  l.smem = kRowsPerBlock * (kBuckets * 4 + buffer_bytes(L, with_pos));
  l.blocks = (n_seg + kRowsPerBlock - 1) / kRowsPerBlock;
  return l;
}

// a block of at least 8 warps (a thread a digit for the scan), as many as
// the row's chunks need
Launch block_plan(int route, const void* kernel, bool with_pos, int items, int64_t blocks,
                  int len) {
  int n_warps = (len + items * 32 - 1) / (items * 32);
  if (n_warps < kBuckets / 32) n_warps = kBuckets / 32;
  Launch l;
  l.route = route;
  l.kernel = kernel;
  l.threads = 32 * n_warps;
  l.items = items;
  l.smem = block_header_bytes(n_warps) + buffer_bytes(len, with_pos);
  l.blocks = blocks;
  return l;
}

Launch k1_plan(int64_t n_seg, int L) {
  if (k1_route(L) == kPacked) return packed_plan(true, n_seg, L);
  return with_warp_items(L, [&](auto ic) {
    constexpr int I = decltype(ic)::value;
    return warp_plan((const void*)count_sort_warp_kernel<I>, false, I, n_seg, L);
  });
}

Launch k2_plan(int64_t n_seg, int L) {
  switch (k2_route(L)) {
    case kPacked: return packed_plan(false, n_seg, L);
    case kWarp:
      return with_warp_items(L, [&](auto ic) {
        constexpr int I = decltype(ic)::value;
        return warp_plan((const void*)rank_map_warp_kernel<I>, true, I, n_seg, L);
      });
    case kBlock:
      return with_block_items(L, [&](auto ic) {
        constexpr int I = decltype(ic)::value;
        return block_plan(kBlock, (const void*)rank_map_block_kernel<I>, true, I, n_seg, L);
      });
    default: {
      const int Lc = search_chunk_len(L);
      return with_block_items(Lc, [&](auto ic) {
        constexpr int I = decltype(ic)::value;
        return block_plan(kSearch, (const void*)sort_chunks_kernel<I>, false, I,
                          n_seg * search_chunks(L), Lc);
      });
    }
  }
}

cudaError_t launch(const Launch& l, const float* x, const float* res, float* out,
                   uint32_t* scratch, int64_t n_seg, int L, cudaStream_t stream) {
  if (l.blocks > 0x7fffffff) return cudaErrorInvalidValue;
  if (l.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    if (err != cudaSuccess) return err;
  }
  void* args[] = {&x, &res, &out, &scratch, &n_seg, &L};
  cudaError_t err =
      cudaLaunchKernel(l.kernel, dim3((unsigned)l.blocks), dim3(l.threads), args, l.smem, stream);
  if (err != cudaSuccess || l.route != kSearch) return err;
  const int64_t blocks = n_seg * ((L + kSearchThreads - 1) / kSearchThreads);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  return cudaLaunchKernel((const void*)search_kernel, dim3((unsigned)blocks), dim3(kSearchThreads),
                          args, 0, stream);
}

}  // namespace

extern "C" {

// K1: sorts each length-L segment (L <= 256) of x into out.
int sdt_count_sort_segments(const float* x, float* out, int64_t n_seg, int L, void* stream) {
  if (n_seg <= 0 || L <= 0 || L > kK1MaxLen) return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch(k1_plan(n_seg, L), x, nullptr, out, nullptr, n_seg, L,
                                 (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// K2: the rank-map of each length-L segment; scratch holds n_seg * L
// 32-bit words where sdt_rank_map_route(2, L) is 3 (the search route) and
// may be null otherwise.
int sdt_rank_map_segments(const float* xq, const float* res, float* out, uint32_t* scratch,
                          int64_t n_seg, int L, void* stream) {
  if (n_seg <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  if (k2_route(L) == kSearch && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch(k2_plan(n_seg, L), xq, res, out, scratch, n_seg, L,
                                 (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The route kernel (1: K1, 2: K2) takes for length L: 0 packed, 1 warp,
// 2 block, 3 search; -1 for a length it does not take.
int sdt_rank_map_route(int kernel, int L) {
  if (L <= 0 || (kernel == 1 && L > kK1MaxLen) || (kernel != 1 && kernel != 2)) return -1;
  return kernel == 1 ? k1_route(L) : k2_route(L);
}

// The launch of kernel (1: K1, 2: K2) at length L, launching nothing: res
// gets the route, threads a block, keys a lane (elements a thread on the
// packed route), shared bytes a block and resident blocks an SM.
int sdt_rank_map_geometry(int kernel, int L, int* res) {
  if (sdt_rank_map_route(kernel, L) < 0) return (int)cudaErrorInvalidValue;
  const Launch l = kernel == 1 ? k1_plan(1, L) : k2_plan(1, L);
  cudaError_t err = cudaSuccess;
  if (l.smem > 48 * 1024)
    err = cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.kernel, l.threads, l.smem);
  if (err != cudaSuccess) return (int)err;
  const int vals[5] = {l.route, l.threads, l.items, (int)l.smem, blocks};
  for (int i = 0; i < 5; ++i) res[i] = vals[i];
  return 0;
}

const char* sdt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
