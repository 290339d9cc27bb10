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
//   as the tie run.  (The stable rank, #{k_s < k_t} + #{s < t : k_s ==
//   k_t}, fills every slot once but costs three compares a member: 0.8405
//   ms against 0.5556 at config 2 in --trials on an H100 at 700 W.)
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
// * staged (L > 16,384, K2): positions no longer fit 16 bits and a row no
//   longer fits shared memory, so the row is cut into C = ceil(L / 16,384)
//   chunks of Lc = ceil(L / C) (the last shorter).  A first kernel sorts
//   the folded keys of each chunk (a block a chunk, the block sort on 16
//   keys a lane, up to 32 warps) into a 64 KB slot of a device-memory
//   scratch row, laid out as a search tree (below), each slot word written
//   in order from the sorted chunk in shared memory; a second takes a
//   block a (row, chunk of queries), holds its
//   queries in registers in element order, stages the row's sorted chunks
//   one after another into shared memory (cp.async, two buffers: the next
//   chunk comes in while the block searches this one), and every query
//   searches each staged chunk there:
//   c = sum over chunks of #{member <= key}, out = res[c - 1], stored in
//   element order.  Any L takes it (a daily series of 1950-2100 has L =
//   55,152: 4 chunks of 13,788).
//
// What bounds them on the H100.  The compulsory traffic is 8 B an element
// for K1 and 12 B for K2 (0.15 / 0.23 ms at config 2's 6.3e7 elements at
// 3.35 TB/s).  The packed route does L compares an element, two
// instructions each: about 1.6e8 warp instructions at L = 40, some 0.2 ms
// of the SMs' issue, so issue and the bytes are of the same size, and the
// pipeline overlaps the two.  The radix routes spend some 57 warp
// instructions a pass to rank 32 items, and more to scatter and read them
// back (radix_sort.cuh), so instruction issue bounds them, far above the
// bytes.
//   The staged route does C searches of 14 probes a query, so it grows as
// L^2 / 16,384: at L = 55,152, 56 probes a query.  On the search route
// that it replaces (the trial switch below) those probes are dependent
// loads of device memory, a 32 B sector for 4 B used, with nothing shared
// between the threads that search one chunk.  Here each sorted chunk
// crosses to an SM once a block that uses it (C times a row, 16 B an
// element at C = 4, mostly from L2: the row's C blocks run side by side),
// and the probes are shared-memory loads, which bank conflicts bound.  A
// sorted array searched by halving puts every probe of a level with a
// step of 32 or more in one bank (index = 31 mod 32): up to 32 ways.  So a
// chunk is stored as an implicit search tree in breadth-first order
// (slot 1 the root, node i's children 2i and 2i + 1, the 14 levels of a
// perfect tree of 16,383 members; slot 0 the 16,384th sorted slot):
// level d is 2^d contiguous words, so levels below 6 never conflict and
// deeper ones conflict as random addresses do (about 3.5 ways).  The
// 16,384th member (a chunk of exactly 16,384) is slot 0: the tree counts
// the first 16,383, and the count takes one more where slot 0 <= key.
// Pads (0xffffffff, NaN's key) never count.  res[c - 1] stays a gather
// of 4 B (mostly L2 hits: a row's res is 220 KB).  At large L the staged
// chunks are C^2 x 64 KB a row (at L = 10^6, 61 chunks, 14 probes of
// shared memory each, against 61 x 14 dependent device-memory loads).  On
// an H100 (700 W) at 8,192 x 55,152 the chunk sort took 17.6 ms of 29.1
// (39 ps an element) on the first core, one block of 14 warps of 32 keys an SM
// at 115 registers; on the new core, 27 warps of 16 keys at 63 registers
// (still one block an SM: two would need 37 registers a thread), 11.1 ms,
// the search 11.5 (chip_smoke.py --trials).
//
// The trial switches (chip_smoke.py --trials builds each and times it
// against the default): SDT_K2_SEARCH_ROUTE=1 takes the route above 16,384
// that came before this one (the "search" route), for a same-call
// comparison: the same chunk sort, written in sorted order, then a thread
// a query searching each chunk in device memory; SDT_RADIX_CORE_PR6=1
// (radix_sort.cuh) takes the first radix core and chunk sort.  No default
// build takes either.  The other knobs that the trials settled are constants below, each
// with its trial result (config 2's K1 / K2 ms unless said otherwise; H100
// 80GB HBM3, 700 W).
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

#ifndef SDT_K2_SEARCH_ROUTE
#define SDT_K2_SEARCH_ROUTE 0
#endif

namespace {

using namespace radix;

// longest L of K1's packed route (K1 packed at config 5's L = 240: 1.5669
// ms, against 1.2440 on the warp route)
constexpr int kK1ShortMax = 64;
// longest L of K2's packed route (K2's warp route at config 5's L = 240:
// 1.5592 ms, against 1.2731 packed)
constexpr int kK2ShortMax = 256;
// most threads a packed block (512 ran the same)
constexpr int kPackedThreads = 256;
// keys a thread counts on the packed route (1 key: 0.8147 / 0.5973 ms; 2
// keys: 0.6626 / 0.4518; 4 keys: 0.5556 / 0.3673)
constexpr int kPackedItems = 4;
// K2's warp route's floor on resident blocks an SM up to 24 keys a lane,
// which caps its registers (config 9a's rows, L = 730: no floor 1.8036 ms,
// a floor of 6 1.4137, of 8 1.3022)
constexpr int kWarpMinBlocks = 8;
constexpr int kRowsPerBlock = 4;               // warps (segments) a block on the warp route
constexpr int kK1MaxLen = 256;                 // COUNT_SORT_MAX_LEN of kernels/rank_map.py
constexpr int kBlockMaxLen = 16384;            // longest L of the block route (and of a chunk)
constexpr int kChunkSlots = kBlockMaxLen;      // words of a chunk's slot, in scratch and staged
constexpr int kTreeLevels = 14;                // levels of a chunk's search tree (2^14 - 1 members)
constexpr int kStagedItems = 16;               // queries a thread on the staged route
// Every radix route, K1's and K2's, runs the new radix core (radix_sort.cuh;
// kFirstCoreTrial, true only in the trial build SDT_RADIX_CORE_PR6=1, gives
// them the first: its ranking, and the chunk sort's 32 keys a lane on at
// most 16 warps with each member stored from registers).  chip_smoke.py
// --trials rank_map found the new one the faster at config 9a's L = 730
// (K2's warp route) and the 1950-2100 rows (the chunk sort; K2's block
// route shares its code), and --rank-map-times K1 no slower on it than on
// the first (PERF.md).
// keys a lane of the chunk sort on the new core, and its most warps (K2 at
// the 1950-2100 grid's 8,192 x 55,152, chunks of 13,788, with the counters
// read and written back but the first core's ballots: 16 keys a lane, 27 warps,
// 24.8387 ms; 32 keys, 14 warps, 27.9084; H100 80GB HBM3, 700 W)
constexpr int kChunkItems = 16;
constexpr int kChunkMaxWarps = kChunkSlots / (kChunkItems * 32);
static_assert(kChunkMaxWarps <= 32, "a chunk sort block holds at most 1,024 threads");
constexpr int kStagedMaxThreads = kChunkSlots / kStagedItems;
constexpr int kSearchThreads = 256;            // threads a block of the search trial
constexpr bool kSearchTrial = SDT_K2_SEARCH_ROUTE != 0;
constexpr uint32_t kNanKey = 0xffffffffu;  // every NaN query's folded key
static_assert(kK1ShortMax <= kPackedThreads * kPackedItems &&
                  kK2ShortMax <= kPackedThreads * kPackedItems,
              "a packed block holds a segment");
static_assert(kChunkSlots == 1 << kTreeLevels, "a chunk's slot is slot 0 and a perfect tree");

enum Route { kPacked = 0, kWarp = 1, kBlock = 2, kStaged = 3, kSearch = 4 };

int k1_route(int L) { return L <= kK1ShortMax ? kPacked : kWarp; }

int k2_route(int L) {
  if (L <= kK2ShortMax) return kPacked;
  if (L <= kWarpRouteMaxLen) return kWarp;
  if (L <= kBlockMaxLen) return kBlock;
  return kSearchTrial ? kSearch : kStaged;
}

bool long_route(int route) { return route == kStaged || route == kSearch; }

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
// compiler's own form of `c += (a <= b)` takes three: a compare, an add and
// a move under the predicate (0.6532 / 0.4401 ms against 0.5556 / 0.3673).
__device__ __forceinline__ int count_le(int c, float a, float b) {
  asm("{\n\t.reg .pred p;\n\tsetp.le.f32 p, %1, %2;\n\t@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(c) : "f"(a), "f"(b));
  return c;
}

__device__ __forceinline__ int count_le(int c, int32_t a, int32_t b) {
  asm("{\n\t.reg .pred p;\n\tsetp.le.s32 p, %1, %2;\n\t@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(c) : "r"(a), "r"(b));
  return c;
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
#pragma unroll
          for (int r = 0; r < R; ++r) c[r] = count_le4(c[r], w, kt[r]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (u + r * U >= L) continue;
          if (kt[r] == INT32_MAX) c[r] -= Lp - L;  // the pads' key is the largest key
          row_out[s * Lp + c[r] - 1] = kt[r];      // the run end; tied keys write the same bits
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

// The run end of sorted slot (item start) + lane from the lanes that hold
// the item's key (__match_any_sync): the highest of them, or `carry` (the
// next item's lane 0's run end) where the run goes on past lane 31 into the
// next slot, which is in the row when `more`.  A NaN key's run may take pad
// lanes; its run end is not used.  (A reverse min-scan of shuffles took
// 1.3631 ms at config 9a's rows, against 1.3022.)
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
  warp_radix_sort<ITEMS, false, kFirstCoreTrial>(key, pr, all ^ any, counts, skey, nullptr, L, lane);
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
__global__ void __launch_bounds__(32 * kRowsPerBlock, ITEMS <= 24 ? kWarpMinBlocks : 1)
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
  warp_radix_sort<ITEMS, true, kFirstCoreTrial>(key, pr, all ^ any, counts, skey, spos, L, lane);
  // the sort's last reads of its buffers are behind it (__syncwarp)
  float* buf = reinterpret_cast<float*>(skey);
  const float* r = res + seg * L;
  int carry = INT_MAX;
  uint32_t after = 0;
#pragma unroll
  for (int i = ITEMS - 1; i >= 0; --i) {
    if (i * 32 >= L) continue;  // the same for every lane
    const int m = i * 32 + lane;
    const int j = run_end_match(key[i], after, i * 32 + 32 < L, i * 32, carry);
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
  block_radix_sort<ITEMS, true, kFirstCoreTrial>(key, pr, all, any, smem, L, n, c0);

  uint32_t* first_key = reinterpret_cast<uint32_t*>(smem);              // [kBlockRouteMaxWarps]
  int* first_end = reinterpret_cast<int*>(smem) + kBlockRouteMaxWarps;  // [kBlockRouteMaxWarps]
  if (lane == 0) first_key[warp] = key[0];
  __syncthreads();  // first keys in; every warp is past the sort's last reads
  int carry = INT_MAX;
  uint32_t after = warp + 1 < n_warps ? first_key[warp + 1] : 0u;
#pragma unroll
  for (int i = ITEMS - 1; i >= 0; --i) {
    if (i * 32 >= n) continue;  // the same for every lane of the warp
    const int j = run_end_match(key[i], after, c0 + i * 32 + 32 < L, c0 + i * 32, carry);
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

// ---------------------------------------------------------------------------
// long routes (L > kBlockMaxLen): staged, or the search trial
// ---------------------------------------------------------------------------

// C = ceil(L / kBlockMaxLen) chunks of Lc = ceil(L / C), the last shorter
// (none empty); chunk j of segment s has the scratch slot of kChunkSlots
// words at (s * C + j) * kChunkSlots
__host__ __device__ inline int long_chunks(int L) { return (L - 1) / kBlockMaxLen + 1; }
__host__ __device__ inline int long_chunk_len(int L) { return (L - 1) / long_chunks(L) + 1; }

// The slot of a chunk's sorted member p (0 <= p < kChunkSlots; members past
// the chunk are pads): member kChunkSlots - 1 goes to slot 0, member p below
// it to its node of the perfect tree in breadth-first order: in-order node
// q = p + 1 lies z = (trailing zeros of q) levels above the leaves, at index
// q >> (z + 1) within its level.  The search trial keeps sorted order.
__device__ __forceinline__ int tree_slot(int p) {
  if (kSearchTrial) return p;
  if (p == kChunkSlots - 1) return 0;
  const int q = p + 1, z = __ffs(q) - 1;
  return (1 << (kTreeLevels - 1 - z)) + (q >> (z + 1));
}

// The sorted member of a chunk that slot s holds (tree_slot's inverse):
// slot 0 the last member, slot s >= 1 at level v = floor(log2 s) (2^v
// slots) the in-order node q = (2 (s - 2^v) + 1) << (kTreeLevels - 1 - v),
// member q - 1.
__device__ __forceinline__ int slot_member(int s) {
  if (s == 0) return kChunkSlots - 1;
  const int v = 31 - __clz(s);
  return ((2 * (s - (1 << v)) + 1) << (kTreeLevels - 1 - v)) - 1;
}

// K2, long routes, first kernel: block b sorts chunk b % C of segment b / C
// by folded key (the block sort, no positions) into scratch slot b, pads
// (0xffffffff, which no query counts) after the chunk's members.  The
// first core's (kFirstCoreTrial) stores each member from registers at its
// tree slot, a scattered 4 B store; the new core's leaves the sorted chunk
// in the block's key buffer, and the block writes the slot in slot order, each
// thread reading the member its slot holds from shared memory: coalesced
// stores, and the last pass's read-back to registers is skipped.
template <int ITEMS>
__global__ void __launch_bounds__(32 * (kFirstCoreTrial ? kBlockRouteMaxWarps : kChunkMaxWarps))
    sort_chunks_kernel(RANK_MAP_ARGS) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = long_chunks(L), Lc = long_chunk_len(L);
  const int64_t seg = blockIdx.x / C;
  const int start = (int)(blockIdx.x % C) * Lc;
  const int len = min(Lc, L - start);
  const int c0 = warp * ITEMS * 32;
  const int n = min(ITEMS * 32, len - c0);
  const float* src = x + seg * L + start + c0;
  uint32_t key[ITEMS], pr[ITEMS];
  unsigned all, any;
  load_keys<ITEMS>([src](int j) { return folded_ukey(src[j]); }, n, c0, lane, key, pr, all, any);
  uint32_t* dst = scratch + (int64_t)blockIdx.x * kChunkSlots;
  if constexpr (kFirstCoreTrial) {
    block_radix_sort<ITEMS, false, true>(key, pr, all, any, smem, len, n, c0);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = i * 32 + lane;
      if (j < n) dst[tree_slot(c0 + j)] = key[i];
    }
    for (int p = len + threadIdx.x; p < kChunkSlots; p += blockDim.x) dst[tree_slot(p)] = kNanKey;
    return;
  }
  const int n_warps = blockDim.x >> 5;
  uint32_t* skey = reinterpret_cast<uint32_t*>(smem + block_header_bytes(n_warps));
  if (!block_radix_sort<ITEMS, false, false, false>(key, pr, all, any, smem, len, n, c0)) {
    // no pass ran (one key holds the chunk): the registers hold it in order
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = i * 32 + lane;
      if (j < n) skey[c0 + j] = key[i];
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < kChunkSlots; t += blockDim.x) {
    const int p = kSearchTrial ? t : slot_member(t);
    dst[t] = p < len ? skey[p] : kNanKey;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// K2, staged route, second kernel: block b takes the queries of chunk b % C
// of segment b / C (item i of thread t: query i * blockDim.x + t of the
// chunk, so loads and stores are coalesced) and stages the segment's C
// chunk slots in turn into two buffers of kChunkSlots words, chunk ch + 1
// coming in by cp.async while the block searches chunk ch.  A query's count
// in a chunk: the leaf its 14 steps down the tree reach, less 2^14, plus one
// where slot 0 (the 16,384th member) <= key.  Two barriers a chunk: the
// chunk in, and the buffer free for chunk ch + 2.
__global__ void __launch_bounds__(kStagedMaxThreads, 1) staged_search_kernel(RANK_MAP_ARGS) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem);  // [2][kChunkSlots]
  const int C = long_chunks(L), Lc = long_chunk_len(L);
  const int64_t seg = blockIdx.x / C;
  const int start = (int)(blockIdx.x % C) * Lc;
  const int len = min(Lc, L - start);
  const uint32_t* slots = scratch + seg * C * kChunkSlots;
  auto fetch = [&](int ch) {  // chunk ch into buffer ch & 1, one cp.async group
    const uint4* src = reinterpret_cast<const uint4*>(slots + (int64_t)ch * kChunkSlots);
    uint4* dst = reinterpret_cast<uint4*>(stage + (ch & 1) * kChunkSlots);
    for (int v = threadIdx.x; v < kChunkSlots / 4; v += blockDim.x) cp_async16(dst + v, src + v);
    cp_async_commit();
  };
  fetch(0);
  const float* q = x + seg * L + start;
  uint32_t key[kStagedItems];
  int count[kStagedItems];
#pragma unroll
  for (int i = 0; i < kStagedItems; ++i) {
    const int t = i * blockDim.x + threadIdx.x;
    key[i] = t < len ? folded_ukey(q[t]) : kNanKey;
    count[i] = 0;
  }
  for (int ch = 0; ch < C; ++ch) {
    if (ch + 1 < C) fetch(ch + 1);
    else cp_async_commit();  // an empty group: the wait below is for chunk ch
    cp_async_wait_one();
    __syncthreads();  // chunk ch is in, from every thread's copies
    const uint32_t* tree = stage + (ch & 1) * kChunkSlots;
    int node[kStagedItems];
#pragma unroll
    for (int i = 0; i < kStagedItems; ++i) node[i] = 1;
#pragma unroll
    for (int d = 0; d < kTreeLevels; ++d) {
#pragma unroll
      for (int i = 0; i < kStagedItems; ++i) node[i] = 2 * node[i] + (tree[node[i]] <= key[i]);
    }
    const uint32_t top = tree[0];
#pragma unroll
    for (int i = 0; i < kStagedItems; ++i) count[i] += node[i] - kChunkSlots + (top <= key[i]);
    __syncthreads();  // every thread is past this buffer before chunk ch + 2 comes into it
  }
  const float* r = res + seg * L;
  float* o = out + seg * L + start;
#pragma unroll
  for (int i = 0; i < kStagedItems; ++i) {
    const int t = i * blockDim.x + threadIdx.x;
    if (t < len) {
      const bool nan = key[i] == kNanKey;
      const float v = r[nan ? 0 : count[i] - 1];  // a non-NaN query counts itself
      o[t] = nan ? nan_value() : v;
    }
  }
}

// K2, search trial, second kernel: thread t of block b takes query
// (b % tiles) * kSearchThreads + t of segment b / tiles and searches each
// chunk slot (in sorted order) in device memory.
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
  const int C = long_chunks(L), Lc = long_chunk_len(L);
  int c = 0;
  for (int ch = 0; ch < C; ++ch) {
    const uint32_t* a = scratch + (seg * C + ch) * kChunkSlots;
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
    default: {  // a long route: the chunk sort first
      const int Lc = long_chunk_len(L);
      return with_block_items(Lc, [&](auto ic) {  // the first core's; else kChunkItems
        constexpr int I = kFirstCoreTrial ? decltype(ic)::value : kChunkItems;
        return block_plan(k2_route(L), (const void*)sort_chunks_kernel<I>, false, I,
                          n_seg * long_chunks(L), Lc);
      });
    }
  }
}

// the second kernel of a long route: a block a (segment, chunk of queries)
// of kStagedItems queries a thread, or the search trial's thread a query
Launch k2_search_plan(int64_t n_seg, int L) {
  Launch l;
  l.route = k2_route(L);
  if (l.route == kStaged) {
    const int Lc = long_chunk_len(L);
    l.kernel = (const void*)staged_search_kernel;
    l.threads = ((Lc + kStagedItems - 1) / kStagedItems + 31) / 32 * 32;
    l.items = kStagedItems;
    l.smem = 2 * (size_t)kChunkSlots * 4;
    l.blocks = n_seg * long_chunks(L);
  } else {
    l.kernel = (const void*)search_kernel;
    l.threads = kSearchThreads;
    l.items = 1;
    l.smem = 0;
    l.blocks = n_seg * ((L + kSearchThreads - 1) / kSearchThreads);
  }
  return l;
}

// 32-bit words of scratch a segment takes: the chunk slots of a long route
int64_t scratch_words(int L) {
  return long_route(k2_route(L)) ? (int64_t)long_chunks(L) * kChunkSlots : 0;
}

cudaError_t launch_one(const Launch& l, void** args, cudaStream_t stream) {
  if (l.blocks > 0x7fffffff) return cudaErrorInvalidValue;
  if (l.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    if (err != cudaSuccess) return err;
  }
  return cudaLaunchKernel(l.kernel, dim3((unsigned)l.blocks), dim3(l.threads), args, l.smem, stream);
}

cudaError_t launch(const Launch& l, const float* x, const float* res, float* out,
                   uint32_t* scratch, int64_t n_seg, int L, cudaStream_t stream) {
  void* args[] = {&x, &res, &out, &scratch, &n_seg, &L};
  const cudaError_t err = launch_one(l, args, stream);
  if (err != cudaSuccess || !long_route(l.route)) return err;
  return launch_one(k2_search_plan(n_seg, L), args, stream);
}

// res[0..3]: threads a block, items, shared bytes and resident blocks an SM
// of launch l
cudaError_t geometry(const Launch& l, int* res) {
  cudaError_t err = cudaSuccess;
  if (l.smem > 48 * 1024)
    err = cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.kernel, l.threads, l.smem);
  if (err != cudaSuccess) return err;
  const int vals[4] = {l.threads, l.items, (int)l.smem, blocks};
  for (int i = 0; i < 4; ++i) res[i] = vals[i];
  return cudaSuccess;
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

// K2: the rank-map of each length-L segment; scratch holds n_seg *
// sdt_rank_map_scratch_words(L) 32-bit words (none, and may be null, below
// the long routes).
int sdt_rank_map_segments(const float* xq, const float* res, float* out, uint32_t* scratch,
                          int64_t n_seg, int L, void* stream) {
  if (n_seg <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  if (scratch_words(L) > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch(k2_plan(n_seg, L), xq, res, out, scratch, n_seg, L,
                                 (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// 32-bit words of scratch a segment of length L takes in K2 (-1 for L <= 0).
int64_t sdt_rank_map_scratch_words(int L) { return L <= 0 ? -1 : scratch_words(L); }

// The route kernel (1: K1, 2: K2) takes for length L: 0 packed, 1 warp,
// 2 block, 3 staged, 4 search (the trial build); -1 for a length it does
// not take.
int sdt_rank_map_route(int kernel, int L) {
  if (L <= 0 || (kernel == 1 && L > kK1MaxLen) || (kernel != 1 && kernel != 2)) return -1;
  return kernel == 1 ? k1_route(L) : k2_route(L);
}

// The launch of kernel (1: K1, 2: K2) at length L, launching nothing: res
// gets the route, then threads a block, keys a lane (elements a thread on
// the packed route, queries a thread on the staged route's second kernel),
// shared bytes a block and resident blocks an SM of the first kernel, then
// the same four of a long route's second kernel (zeros on the other routes).
int sdt_rank_map_geometry(int kernel, int L, int* res) {
  if (sdt_rank_map_route(kernel, L) < 0) return (int)cudaErrorInvalidValue;
  const Launch l = kernel == 1 ? k1_plan(1, L) : k2_plan(1, L);
  int vals[9] = {l.route};
  cudaError_t err = geometry(l, vals + 1);
  if (err == cudaSuccess && long_route(l.route)) err = geometry(k2_search_plan(1, L), vals + 5);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < 9; ++i) res[i] = vals[i];
  return 0;
}

const char* sdt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
