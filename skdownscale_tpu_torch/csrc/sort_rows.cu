// Row sort, stable row sort with positions, and unsort (K9) for Hopper
// (sm_90a).
//
// Replaces sort_rows, sort_rows_with_positions and unsort_rows of
// skdownscale_tpu/ops/pallas/sort_kernel.py (an in-VMEM bitonic network on
// rows laid across the TPU's lanes), on row-major (B, L) float32 arrays.
//
// The sort is the stable LSD radix sort of radix_sort.cuh (shared with the
// sliding window K5): 32-bit keys ordered_ukey in the total order
// -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN, four passes of 8-bit
// digits, low digit first.  The input is in position order, so the
// positions come out as those of a STABLE sort, torch.sort(keys,
// stable=True), with no padding and no tie-break folded into the key.  The
// TPU kernel pads its rows to a power of two with the key INT32_MAX, which
// is also the key of the NaN whose bits are 0x7fffffff, and its network is
// not stable, so it can return a pad position >= L (ROADMAP F8).  A pass
// whose byte is the same in every key of the row is skipped: temperatures
// near 283 K share their top byte, and an all-equal row skips every pass.
//
// Five shapes of the one sort, chosen by L in the launcher (a route by
// shape, sort_route(L, with_pos), mirrored by kernels/sort_rows.sort_route;
// all are this kernel):
// * L <= 1,024: a warp a row, four rows a block, ceil(L / 128) * 4 items a
//   lane.  Each warp has its own slice of shared memory (counters, keys,
//   positions), so a pass has only __syncwarp and no block barrier.  Rows of
//   304 (monthly MBCn) and 620 (daily fit windows) take this shape.
// * 1,024 < L <= 8,192 (kMaxLen, K9_MAX_LEN of kernels/sort_rows.py): a
//   block a row, 8 to 16 warps, each holding a contiguous chunk of 4, 12 or
//   16 items a lane (a warp past the row holds none).  One __syncthreads
//   after the load and three a pass that is not skipped (counters in, scan
//   done, scatter done): thirteen at most.  Config 8's rows of 3,650 take
//   10 warps of 12 items a lane.
// On these two the items live in registers between passes, the position
// travels as a 16-bit payload (L <= 8,192 < 2^16), widened to int32 at the
// store, and the final order is stored from registers, striped.
// * 8,192 < L <= K9_SMEM_MAX (the shared-memory route; 16,280 with
//   positions and 24,424 without, the most that kSmemLimit holds, see
//   row_capacity): a block of kSmemWarps warps a row.  The block brings its
//   row into shared memory once by cp.async (16 bytes where the row base is
//   aligned, as for L a multiple of 4, else 4), and one sweep there turns
//   the bits into keys and takes their AND / OR.  A pass walks the row in
//   tiles of kSmemWarps * kSmemItems * 32 = 12,288 elements, from one key
//   buffer (and 16-bit position buffer) to the other: each warp ranks its
//   items with rank_digits, thread d turns the warps' counts of digit d
//   into their places from the pass's running place of d ((digit, warp)
//   order, stable), and each item is written at its place; the tiles go in
//   order, so the pass is stable.  Where the row is one tile (30 years of
//   days), the pass's counts are the tile's and the running place of d
//   starts at the tile's exclusive scan; a longer row takes each pass's
//   starting places from the sweep, which then also counts all four
//   digits (per group of four warps, the lanes of a digit found by nine
//   ballots, peers_of_bfe<9> on the new core: __match_any_sync ran slower
//   on the card).  The last pass's
//   buffer goes out once, 16-byte stores where aligned, positions widened
//   to int32: the device-memory traffic is the compulsory 8 B an element
//   (12 with positions).  Taking each pass's places from the sweep's
//   counts at every length ran slower on the card (2.94 against 1.86 ms
//   at 10,957), so a row of one tile counts in the tile.
//   A warp reads its own counters in a tile's scatter and zeroes them for
//   the next tile: a __syncwarp between the two keeps lanes that diverged
//   in the scatter from zeroing a counter another lane has yet to read.
// * K9_SMEM_MAX < L <= 55,296 (the cluster route): a thread-block cluster
//   of c = max(2, ceil(L / 13,824)) blocks of kClusterWarps warps, 2 to
//   kClusterMax = 4, launched by cudaLaunchKernelEx as B * c blocks, so
//   that each block's elements make one tile of kClusterWarps *
//   kClusterItems * 32 = 24 * 18 * 32 = 13,824 (two blocks at 1950-2014
//   daily, four at 1950-2100).  Block r holds elements [r * m, r * m + m) of
//   the row, m = ceil(L / c).  Each pass: each block ranks its tile,
//   cluster.sync, each reads every block's counts of the pass's digits
//   through distributed shared memory and takes its (digit, block) places,
//   and writes each item into the buffer of the block that holds its place
//   (mapa and st.shared::cluster), cluster.sync.  The keys stay in the
//   cluster's shared memory from the load to the store.  A lane holds only
//   its items' ranks and positions in registers and reads each key from
//   shared memory where it needs it (the rank, the scatter): so 24 warps of
//   18 items fit the 80 registers a thread that 768 threads leave, with no
//   spill (16 warps of 28 items spill 48-52 B with positions and ran 4-9%
//   slower at 23,741 and 55,152).  Past 55,296 the blocks would walk several
//   tiles, and the device-memory route ran faster on the card at 65,536;
//   clusters of at least 3 blocks ran slower at 23,741 (4.00 against 2.77
//   ms).
// * above (and every L > 8,192 in the trial build SDT_K9_LONG_ROUTE=1):
//   the device-memory route (any L < 2^31): a block a row walks the row in
//   tiles of kLongWarps * kLongItems * 32 elements.  One sweep reads the
//   row once and counts all four digits (warp-aggregated shared atomics)
//   and the AND / OR of its keys; an exclusive scan of each count gives
//   every pass its starting offset per digit.  Each pass that is not
//   skipped takes the tiles in order: it ranks a tile with the block
//   machinery of radix_sort.cuh (rank_digits, the (digit, warp) scan, the
//   scatter into shared memory, which orders the tile by digit), writes
//   the tile out digit run by digit run at the pass's running offset of
//   each digit, and advances those offsets by the tile's counts.  Keys and
//   int32 positions travel between passes through device memory: a
//   workspace from the wrapper and the outputs themselves, in turns, so
//   that the last pass lands in the outputs (the first pass writes the
//   outputs when an odd number of passes run).  Each pass moves 8 B an
//   element (16 with positions) through the L2 and, for the rows in flight
//   across the card (70-93 MB at 10,957 days), through device memory.
//
// Unsort.  The positions of a row are a permutation of 0..L-1, so the
// unsort is a scatter, out[b, pos[b, i]] = vals[b, i]; a position outside
// [0, L) is skipped, so nothing is written outside the row.  Three routes:
// * a warp a row, kUnsortWarps rows a block, each warp with its own slice
//   of shared memory and __syncwarp alone: the warp reads positions and
//   values (16 bytes a lane where L is a multiple of 4 and the row bases
//   are 16-byte aligned, as at 304 and 620), writes smem[pos[i]] =
//   vals[i], and writes the row out the same way;
// * a block a row: the same through a block's shared memory, one
//   __syncthreads, for every row of floats that a block's shared memory
//   holds (L <= kUnsortBlockMax = 58,112), with 16-byte reads and writes
//   on the same condition, else four elements a thread in flight;
// * a straight scatter in device memory, a thread per 4 elements (16-byte
//   reads where L is a multiple of 4), as torch's scatter_ does: random
//   4-byte writes.  Rows above kUnsortBlockMax take it.
// By default the launcher takes the warp route up to kUnsortWarpMax, the
// block route up to kUnsortBlockMax and the scatter above (chip_smoke.py
// --trials sort_rows times the routes).
//
// What bounds them on the H100.  The compulsory traffic is 8 B an element
// for the sort (12 with positions and for the unsort), 0.05-0.08 ms at
// config 8's (6144, 3650) rows.  The bitonic network this replaces did 78
// stages over 4,096 8-byte words a row, about 5.1 MB of shared-memory
// traffic, with a block barrier a stage.  The radix sort moves each element
// through shared memory once a pass (4 + 2 B written and read, about 175 KB
// a row of 3,650 in four passes).  Its instructions bound it, far above the
// bytes: the first core took some 86 warp instructions a pass to rank each
// 32 items at 3,650, the new core of radix_sort.cuh some 57 (chip_smoke.py
// --sass), and the scatter, the read-back and the scan add to both.  The
// counter updates and the scatter land on random banks.  Latency was not
// the bound: four items' counter updates in flight before any broadcast
// ran 3-12% slower (chip_smoke.py --trials), and cutting two of the
// shared-memory route's five barriers a pass changed nothing (1.8867
// against 1.8901 ms at 10,957).  The shared-memory and cluster routes add
// the barriers of each tile (two, and one a pass; a cluster.sync or two a
// pass) and, for rows of more than one tile, a count of each digit (36
// ballots an element for the four); the cluster route's places in other
// blocks are remote shared-memory stores.  TMA is not used: a row of 3,650
// or 10,957 floats is not a multiple of 16 bytes, odd rows start
// unaligned, and the compulsory bytes are a small part of the time.
//
// Resources (nvcc -Xptxas -v for sm_90a, the new core; resident blocks per
// SM from the 65,536 registers and 228 KB of shared memory of an SM), with
// positions / without: at 3,650 (12 items a lane, 10 warps) 40 / 40
// registers a thread under the floor of 4 blocks (12 / 8 B of spill
// stores) and 32,272 / 24,960 B of shared memory a block: 4 blocks (40
// warps) an SM, against the first core's 64 registers and 3 blocks; at
// 620 (20 items
// a lane) 64 / 64 registers under the floor of 8 blocks (24 / 8 B of spill
// stores), 8 blocks (32 warps), against the first core's 80 and 6; at 304 (12
// items) 55 / 53 registers, 9 blocks (36 warps).  Registers, not shared
// memory, set the resident blocks at every shape.  The shared-memory
// route (32 warps of 12 items) takes 63 / 63 registers and
// row_smem_bytes(L) of shared memory (168,576 / 124,736 B at 10,957): one
// block, 32 warps, an SM.  The cluster route (24 warps of 18 items) takes
// 80 / 66 registers and 194,752 / 139,456 B a block of one full tile: one
// block, 24 warps, an SM.  Neither spills; chip_smoke.py prints each
// instance's registers and spills.
//
// The C entry points take plain pointers, sizes and the CUDA stream, launch
// on that stream without synchronising, and return cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_sort.cuh"

namespace cg = cooperative_groups;

// The one trial switch (chip_smoke.py --trials sort_rows builds and times
// it against the default): SDT_K9_LONG_ROUTE=1 takes the device-memory route
// (and the unsort's scatter) for every row above 8,192, so that its time
// stays beside the shared-memory and cluster routes'.  The trial build
// SDT_RADIX_CORE_PR6=1 of radix_sort.cuh takes the first core (its ranking
// and launch bounds) at every route.  The knobs the trials settled are
// constants below, each with its trial result (H100 80GB HBM3, 700 W).
#ifndef SDT_K9_LONG_ROUTE
#define SDT_K9_LONG_ROUTE 0
#endif

namespace {

using namespace radix;

constexpr int kMaxLen = 8192;      // K9_MAX_LEN of kernels/sort_rows.py
constexpr int kMaxThreads = 1024;  // the unsort's block
constexpr int kRowsPerBlock = 4;  // warps (rows) a block on the warp route
// the device-memory route: 8 warps (a thread per digit), a tile of 4,096
constexpr int kLongWarps = kBuckets / 32;
constexpr int kLongItems = 16;  // 8, 24 and 32 ran slower on the card
constexpr int kTile = kLongWarps * kLongItems * 32;
static_assert(kTile <= 65536, "tile indices travel as 16-bit payloads");
// the shared-memory and cluster routes (kernels/sort_rows.py mirrors these)
constexpr int kSmemLimit = 232448;     // shared memory a block may use
// warps a block and items a lane of the shared-memory route (6,144 x 10,957,
// sort / with positions, in the trials: 32 x 12 1.8757 / 2.0602 ms, 16 x
// 24 2.1011 / 2.2305, 32 x 8 3.0920 / 3.2783)
constexpr int kSmemWarps = 32;
constexpr int kSmemItems = 12;
// the same of the cluster route (2,048 x 23,741 with positions and 512 x
// 55,152 both forms, in the trials: 24 x 18 2.6191 / 1.3799 / 1.9787 ms,
// 16 x 28 2.8471 / 1.4882 / 2.0572, which spilled 48 B)
constexpr int kClusterWarps = 24;
constexpr int kClusterItems = 18;
constexpr int kClusterMin = 2;  // 3 ran slower at 23,741 (4.00 against 2.77 ms)
constexpr int kClusterMax = 4;
constexpr int kClusterTile = kClusterWarps * kClusterItems * 32;
static_assert(kClusterMax * kClusterTile <= 65536, "positions travel as 16-bit payloads");
// the unsort's warp route: rows (warps) a block, and the longest row (it
// ran faster than a block a row at 304 and 620 in the trials; a block a
// row ran faster at 3,650)
constexpr int kUnsortWarps = 8;
constexpr int kUnsortWarpMax = 1024;
// the block route's longest row: a row of floats in a block's shared memory
// (at 6,144 x 10,957 0.2675 ms against the straight scatter's 1.0413, PR
// 15's trials)
constexpr int kUnsortBlockMax = kSmemLimit / 4;
constexpr int kScatterThreads = 256;

// Every route runs the new radix core (radix_sort.cuh; kFirstCoreTrial,
// true only in the trial build SDT_RADIX_CORE_PR6=1, gives them the first):
// chip_smoke.py --trials sort_rows found the new one the faster at 6,144
// rows of 304 (the warp route), 3,650 (block) and 10,957 (shared memory);
// the cluster route shares the shared-memory route's code, the
// device-memory route the block route's.
// The new core's floors on resident blocks an SM, which cap registers: the
// warp route up to 24 items a lane at 8 (6,144 x 620 rows, sort / with
// positions: 1.7495 / 1.8419 ms at 64 registers, 1.8533 / 1.9600 with no
// floor at 89 / 90, 1.7417 / 1.8779 at 6), the block route of 12 items a
// lane (2,048 < L <= 4,096: at most 11 warps) at 4 (6,144 x 3,650: 0.4203 /
// 0.4546 ms at 40 registers, 0.4973 / 0.5699 with no floor, 0.4199 /
// 0.4736 at 5 with 32 and 40-56 B of spill; H100 80GB HBM3, 700 W).  The
// first core's build keeps its bounds.
constexpr int kWarpMinBlocks = 8;
constexpr int kBlock12Threads = 11 * 32;
constexpr int kBlock12MinBlocks = 4;
#if SDT_RADIX_CORE_PR6
#define SDT_K9_WARP_BOUNDS __launch_bounds__(32 * kRowsPerBlock)
#define SDT_K9_BLOCK_BOUNDS __launch_bounds__(32 * kBlockRouteMaxWarps)
#else
#define SDT_K9_WARP_BOUNDS __launch_bounds__(32 * kRowsPerBlock, ITEMS <= 24 ? kWarpMinBlocks : 1)
#define SDT_K9_BLOCK_BOUNDS                                                           \
  __launch_bounds__(ITEMS == 12 ? kBlock12Threads : 32 * kBlockRouteMaxWarps, \
                    ITEMS == 12 ? kBlock12MinBlocks : 1)
#endif

enum UnsortRoute { kUnsortWarp = 0, kUnsortBlock = 1, kUnsortScatter = 2 };
enum SortRoute { kRouteWarp = 0, kRouteBlock = 1, kRouteSmem = 2, kRouteCluster = 3, kRouteDevice = 4 };

// Writes the warp's n sorted items, striped, at element c0 of the row.
template <int ITEMS, bool kWithPos>
__device__ __forceinline__ void store_chunk(const uint32_t (&key)[ITEMS],
                                            const uint32_t (&pr)[ITEMS], float* __restrict__ out,
                                            int32_t* __restrict__ pos_out, int c0, int n,
                                            int lane) {
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (i * 32 >= n) break;
    const int j = i * 32 + lane;
    if (j < n) {
      out[c0 + j] = ukey_to_float(key[i]);
      if (kWithPos) pos_out[c0 + j] = (int32_t)(pr[i] >> 16);
    }
  }
}

// Warp route: warp w of the block sorts row blockIdx.x * kRowsPerBlock + w
// (L <= 1,024 <= ITEMS * 32) in its own slice of shared memory: 256
// counters, then the row's key and position buffers.
template <bool kWithPos, int ITEMS>
__global__ void SDT_K9_WARP_BOUNDS
    sort_rows_warp_kernel(const float* __restrict__ x, float* __restrict__ out,
                          int32_t* __restrict__ pos_out, int64_t B, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + warp;
  if (row >= B) return;  // no block barrier follows
  unsigned char* slice = smem + warp * (kBuckets * 4 + buffer_bytes(L, kWithPos));
  unsigned* counts = reinterpret_cast<unsigned*>(slice);
  uint32_t* skey = reinterpret_cast<uint32_t*>(slice + kBuckets * 4);
  uint16_t* spos = reinterpret_cast<uint16_t*>(slice + kBuckets * 4 + align16((size_t)L * 4));
  const float* src = x + row * L;

  uint32_t key[ITEMS], pr[ITEMS];
  unsigned all, any;
  load_keys<ITEMS>([src](int j) { return ordered_ukey(src[j]); }, L, 0, lane, key, pr, all, any);
  warp_radix_sort<ITEMS, kWithPos, kFirstCoreTrial>(key, pr, all ^ any, counts, skey, spos, L, lane);
  store_chunk<ITEMS, kWithPos>(key, pr, out + row * L, kWithPos ? pos_out + row * L : nullptr, 0,
                               L, lane);
}

// Block route: block b sorts row b (1,024 < L <= 8,192) with blockDim.x / 32
// warps, 8 to 16, warp w holding elements [w * ITEMS * 32, (w + 1) * ITEMS *
// 32) of the row (none for a warp past it); shared memory as
// block_radix_sort lays it out.
template <bool kWithPos, int ITEMS>
__global__ void SDT_K9_BLOCK_BOUNDS
    sort_rows_block_kernel(const float* __restrict__ x, float* __restrict__ out,
                           int32_t* __restrict__ pos_out, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t base = (int64_t)blockIdx.x * L;
  const int c0 = warp * ITEMS * 32;
  const int n = min(ITEMS * 32, L - c0);  // <= 0 for a warp past the row
  const float* src = x + base + c0;

  uint32_t key[ITEMS], pr[ITEMS];
  unsigned all, any;
  load_keys<ITEMS>([src](int j) { return ordered_ukey(src[j]); }, n, c0, lane, key, pr, all, any);
  block_radix_sort<ITEMS, kWithPos, kFirstCoreTrial>(key, pr, all, any, smem, L, n, c0);
  store_chunk<ITEMS, kWithPos>(key, pr, out + base, kWithPos ? pos_out + base : nullptr, c0, n,
                               lane);
}

// -- the device-memory route (L > 55,296) ------------------------------------

// Shared memory of a device-memory-route block.
struct LongSmem {
  unsigned counts[kLongWarps * kBuckets];  // per warp, then its tile offsets
  unsigned hist[kPasses][kBuckets];        // per pass: digit counts, then running offsets
  unsigned group_sum[kPasses][kLongWarps];
  int gofs[kBuckets];  // a tile's digit d: row index minus tile-sorted index
  unsigned bits[2];    // AND, OR of the row's keys
  uint32_t skey[kTile];
  int32_t spos[kTile];   // the tile's incoming positions, by tile index
  uint16_t sidx[kTile];  // tile index of each tile-sorted item
};

// One pass over one tile of elements [t0, t0 + tn) of the row.  src_key /
// src_pos: the previous pass's output (null on the first pass, which reads
// the input x and takes positions t0 + index).  The tile is placed at the
// running offsets hist[pass] and written as floats to out / pos_out on the
// last pass, else as raw keys to dst_key / dst_pos.
template <bool kWithPos>
__device__ __forceinline__ void long_tile(LongSmem& sm, const float* x, const uint32_t* src_key,
                                          const int32_t* src_pos, uint32_t* dst_key,
                                          int32_t* dst_pos, bool last, int pass, int t0, int tn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int shift = 8 * pass;
  const int c0 = warp * kLongItems * 32;  // the warp's chunk within the tile
  const int n = min(kLongItems * 32, tn - c0);
  uint32_t key[kLongItems], pr[kLongItems];
#pragma unroll
  for (int i = 0; i < kLongItems; ++i) {
    const int j = i * 32 + lane;
    key[i] = 0xffffffffu;
    pr[i] = (uint32_t)(c0 + j) << 16;  // the tile index
    if (j < n) {
      const int e = t0 + c0 + j;
      key[i] = src_key ? src_key[e] : ordered_ukey(x[e]);
      if (kWithPos && src_pos) sm.spos[c0 + j] = src_pos[e];
    }
  }
  unsigned* mine = sm.counts + warp * kBuckets;
  zero_counts(mine, lane);
  __syncwarp();
  rank_digits<kFirstCoreTrial, kLongItems>(key, pr, mine, shift, n, lane);
  __syncthreads();  // every warp's counts are in
  // thread d: digit d's tile total, its exclusive scan within its group of
  // 32 digits, and each warp's offset for it (as block_radix_sort)
  const int d = threadIdx.x;
  unsigned total = 0;
  for (int w = 0; w < kLongWarps; ++w) total += sm.counts[w * kBuckets + d];
  const unsigned incl = warp_inclusive_scan(total, lane);
  if (lane == 31) sm.group_sum[0][warp] = incl;
  unsigned run = incl - total;
  for (int w = 0; w < kLongWarps; ++w) {
    const unsigned c = sm.counts[w * kBuckets + d];
    sm.counts[w * kBuckets + d] = run;
    run += c;
  }
  __syncthreads();  // offsets and group sums are in
  const unsigned g = lane < kLongWarps ? sm.group_sum[0][lane] : 0u;
  const unsigned group_base = warp_inclusive_scan(g, lane) - g;
  // digit d starts at tile-sorted index start; its run goes to the row at
  // the pass's running offset
  const unsigned start = __shfl_sync(kFull, group_base, d >> 5) + incl - total;
  sm.gofs[d] = (int)sm.hist[pass][d] - (int)start;
  sm.hist[pass][d] += total;
  scatter<kLongItems, kWithPos, true, kFirstCoreTrial>(key, pr, mine, group_base, sm.skey, sm.sidx,
                                                       shift, n, lane);
  __syncthreads();  // the tile is in shared memory, ordered by digit
  for (int t = threadIdx.x; t < tn; t += blockDim.x) {
    const uint32_t k = sm.skey[t];
    const int r = sm.gofs[(k >> shift) & 0xffu] + t;
    if (last) reinterpret_cast<float*>(dst_key)[r] = ukey_to_float(k);
    else dst_key[r] = k;
    if (kWithPos) {
      const int idx = sm.sidx[t];
      dst_pos[r] = src_pos ? sm.spos[idx] : t0 + idx;
    }
  }
  __syncthreads();  // shared memory is refilled by the next tile
}

// Block b sorts row b (L > 8,192) with kLongWarps warps.  work holds a row's
// keys (and positions) between passes: B * L uint32 (then B * L int32).
// Not __restrict__: the passes read what other threads of the block wrote
// through the same buffers.
template <bool kWithPos>
__global__ void __launch_bounds__(32 * kLongWarps)
    sort_rows_long_kernel(const float* x, float* out, int32_t* pos_out, uint32_t* work,
                          int64_t B, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  LongSmem& sm = *reinterpret_cast<LongSmem*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = threadIdx.x;  // a thread per digit
  const int64_t base = (int64_t)blockIdx.x * L;
  const float* xr = x + base;

  // the sweep: all four digit counts and the AND / OR of the keys
  for (int p = 0; p < kPasses; ++p) sm.hist[p][d] = 0;
  if (threadIdx.x == 0) {
    sm.bits[0] = kFull;
    sm.bits[1] = 0;
  }
  __syncthreads();
  unsigned all = kFull, any = 0;
  for (int64_t j0 = warp * 32; j0 < L; j0 += blockDim.x) {  // warp-uniform
    const int j = (int)j0 + lane;
    const bool valid = j < L;
    const uint32_t k = valid ? ordered_ukey(xr[j]) : 0u;
    if (valid) {
      all &= k;
      any |= k;
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const unsigned dig = (k >> (8 * p)) & 0xffu;
      const unsigned peers = __match_any_sync(kFull, valid ? dig : 0x100u);
      if (valid && lane == __ffs(peers) - 1) atomicAdd(&sm.hist[p][dig], (unsigned)__popc(peers));
    }
  }
  all = __reduce_and_sync(kFull, all);
  any = __reduce_or_sync(kFull, any);
  if (lane == 0) {
    atomicAnd(&sm.bits[0], all);
    atomicOr(&sm.bits[1], any);
  }
  __syncthreads();
  // each pass's exclusive scan of its counts, in digit order
  unsigned c[kPasses], incl[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    c[p] = sm.hist[p][d];
    incl[p] = warp_inclusive_scan(c[p], lane);
    if (lane == 31) sm.group_sum[p][warp] = incl[p];
  }
  const unsigned varying = sm.bits[0] ^ sm.bits[1];
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    unsigned before = 0;
    for (int w = 0; w < warp; ++w) before += sm.group_sum[p][w];
    sm.hist[p][d] = before + incl[p] - c[p];
  }
  __syncthreads();

  int n_active = 0;
  for (int p = 0; p < kPasses; ++p) n_active += ((varying >> (8 * p)) & 0xffu) != 0;
  if (n_active == 0) {  // every key equal: the row and its positions as they are
    for (int j = threadIdx.x; j < L; j += blockDim.x) {
      out[base + j] = xr[j];
      if (kWithPos) pos_out[base + j] = j;
    }
    return;
  }
  // pass i of the n_active writes the outputs when n_active - 1 - i is even,
  // else the workspace; pass i + 1 reads what pass i wrote
  uint32_t* const wkey = work + base;
  int32_t* const wpos = kWithPos ? reinterpret_cast<int32_t*>(work + B * L) + base : nullptr;
  uint32_t* const okey = reinterpret_cast<uint32_t*>(out + base);
  int32_t* const opos = kWithPos ? pos_out + base : nullptr;
  const uint32_t* src_key = nullptr;
  const int32_t* src_pos = nullptr;
  for (int p = 0, i = 0; p < kPasses; ++p) {
    if (((varying >> (8 * p)) & 0xffu) == 0) continue;  // one digit holds the row: order kept
    const bool to_out = ((n_active - 1 - i) & 1) == 0;
    uint32_t* dk = to_out ? okey : wkey;
    int32_t* dp = to_out ? opos : wpos;
    const bool last = i == n_active - 1;
    for (int64_t t0 = 0; t0 < L; t0 += kTile) {
      long_tile<kWithPos>(sm, xr, src_key, src_pos, dk, dp, last, p, (int)t0,
                          (int)min((int64_t)kTile, L - t0));
    }
    src_key = dk;
    src_pos = dp;
    ++i;
  }
}

// -- the shared-memory route and the cluster route (8,192 < L <= 55,296) -----

// Shared memory of a block of W warps holding n elements of a row: the
// warps' counters (warp-major, 256 each; the load's sweep uses them as W / 4
// groups of four passes' counters), each pass's starting offsets per digit
// (on the cluster route the block's count of the pass's digits, which the
// other blocks read), kMisc words (group sums, AND / OR), then two key
// buffers and, with positions, two 16-bit position buffers.
constexpr int kMisc = 48;
__host__ __device__ constexpr size_t row_header_bytes(int warps) {
  return ((size_t)warps * kBuckets + kPasses * kBuckets + kMisc) * 4;
}
__host__ __device__ constexpr size_t row_smem_bytes(int n, int warps, bool with_pos) {
  return row_header_bytes(warps) + 2 * align16((size_t)n * 4) +
         (with_pos ? 2 * align16((size_t)n * 2) : 0);
}
static_assert(row_header_bytes(kSmemWarps) % 16 == 0 && row_header_bytes(kClusterWarps) % 16 == 0,
              "the key buffers start 16-byte aligned");
static_assert(kSmemWarps % 4 == 0 && kSmemWarps >= 8 && kSmemWarps <= 32 &&
                  kClusterWarps % 4 == 0 && kClusterWarps >= 8 && kClusterWarps <= 32,
              "a thread per digit; the sweep's counter groups take four warps' counters");

// the most elements a block of `warps` warps holds in kSmemLimit bytes
constexpr int row_capacity(int warps, bool with_pos) {
  int n = (int)((kSmemLimit - row_header_bytes(warps)) / (with_pos ? 12 : 8));
  while (row_smem_bytes(n + 1, warps, with_pos) <= (size_t)kSmemLimit) ++n;
  while (row_smem_bytes(n, warps, with_pos) > (size_t)kSmemLimit) --n;
  return n;
}

static_assert(kClusterTile <= row_capacity(kClusterWarps, true),
              "a cluster block holds one tile of keys and positions");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The first core's: the lanes of the warp whose v (< 512: a digit, or 0x100
// for no item) equals this lane's, by nine ballots (__match_any_sync ran
// slower on the card: 2.48 against 2.08 ms at 2,048 x 23,741)
__device__ __forceinline__ unsigned match_peers(unsigned v) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < 9; ++b) {
    const bool bit = (v >> b) & 1u;
    const unsigned set = __ballot_sync(kFull, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// The 32-bit shared::cluster address of p (in this block's shared memory)
// in block `rank` of the cluster, and stores there: 32-bit addresses keep
// the cluster route's scatter in fewer registers than generic pointers.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster_u32(unsigned addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_cluster_u16(unsigned addr, uint16_t v) {
  asm volatile("st.shared::cluster.u16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}

// Exclusive scan of v over the digits held by threads 0..255 (thread d
// holds digit d): the sum of v over the digits before d.  gs: 8 words.
// Every thread of the block calls it; it ends with a __syncthreads.
__device__ __forceinline__ unsigned digit_exclusive_scan(unsigned v, unsigned* gs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned incl = 0;
  if (threadIdx.x < kBuckets) {
    incl = warp_inclusive_scan(v, lane);
    if (lane == 31) gs[warp] = incl;
  }
  __syncthreads();
  unsigned before = 0;
  if (threadIdx.x < kBuckets)
    for (int w = 0; w < warp; ++w) before += gs[w];
  __syncthreads();  // gs is free again
  return before + incl - v;
}

// digit_exclusive_scan of the four passes' counts at once, in place; gs:
// 4 x 8 words.
__device__ __forceinline__ void digit_exclusive_scan4(unsigned (&v)[kPasses], unsigned* gs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned incl[kPasses];
  if (threadIdx.x < kBuckets) {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      incl[p] = warp_inclusive_scan(v[p], lane);
      if (lane == 31) gs[p * 8 + warp] = incl[p];
    }
  }
  __syncthreads();
  if (threadIdx.x < kBuckets) {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      unsigned before = 0;
      for (int w = 0; w < warp; ++w) before += gs[p * 8 + w];
      v[p] = before + incl[p] - v[p];
    }
  }
  __syncthreads();  // gs is free again
}

// Shared-memory route, 8,192 < L <= K9_SMEM_MAX (kCluster false): block b
// sorts row b in its own shared memory, m = L.  Cluster route (kCluster
// true): the c blocks of a cluster sort one row, block r holding elements
// [r * m, r * m + m) of it (fewer in the last; m <= one tile, which the
// launcher's cluster_size ensures), and each pass places every item in the
// buffer of the block that holds its place, through distributed shared
// memory.  W warps, ITEMS items a lane; a tile is W * ITEMS * 32 of the
// block's elements.
template <int W, int ITEMS, bool kWithPos, bool kCluster>
__global__ void __launch_bounds__(32 * W)
    sort_rows_smem_kernel(const float* __restrict__ x, float* __restrict__ out,
                          int32_t* __restrict__ pos_out, int L, int m) {
  constexpr int kTileN = W * ITEMS * 32;
  constexpr int kGroups = W / 4;  // the sweep's counter groups
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned* const counts = reinterpret_cast<unsigned*>(smem_raw);  // [W][256]
  unsigned* const offs = counts + W * kBuckets;                     // [4][256]
  unsigned* const gs = offs + kPasses * kBuckets;                   // [4][8]
  unsigned* const bits = gs + 32;                                   // AND, OR
  uint32_t* const keys0 = reinterpret_cast<uint32_t*>(smem_raw + row_header_bytes(W));
  uint32_t* const keys1 = keys0 + align16((size_t)m * 4) / 4;
  uint16_t* const pos0 = reinterpret_cast<uint16_t*>(keys1 + align16((size_t)m * 4) / 4);
  uint16_t* const pos1 = pos0 + align16((size_t)m * 2) / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = threadIdx.x;  // the digit of threads 0..255

  int rank = 0, c = 1;
  if (kCluster) {
    rank = (int)cg::this_cluster().block_rank();
    c = (int)cg::this_cluster().num_blocks();
  }
  const int64_t row = blockIdx.x / c;
  const int e0 = rank * m;               // the block's first element of the row
  const int n = max(0, min(m, L - e0));  // the elements it holds
  const float* src = x + row * L + e0;
  // a block whose elements make one tile (every cluster block) takes each
  // pass's counts from the tile's ranking, and the sweep counts nothing
  const bool one_tile = kCluster || m <= kTileN;

  // the load: the block's elements as raw bits, by cp.async (16 bytes
  // where the row base is aligned); the counters zeroed meanwhile
  if (((uintptr_t)src & 15) == 0) {
    const int n4 = n >> 2;
    for (int t = threadIdx.x; t < n4; t += blockDim.x) cp_async16(keys0 + 4 * t, src + 4 * t);
    for (int t = 4 * n4 + threadIdx.x; t < n; t += blockDim.x) cp_async4(keys0 + t, src + t);
  } else {
    for (int t = threadIdx.x; t < n; t += blockDim.x) cp_async4(keys0 + t, src + t);
  }
  for (int t = threadIdx.x; t < W * kBuckets; t += blockDim.x) counts[t] = 0;
  if (threadIdx.x == 0) {
    bits[0] = kFull;
    bits[1] = 0;
  }
  cp_async_wait_all();
  __syncthreads();

  // the sweep: raw bits to keys, their AND / OR and (a block a row) all
  // four passes' digit counts, which no pass changes
  {
    unsigned all = kFull, any = 0;
    unsigned* grp = counts + (warp % kGroups) * (kPasses * kBuckets);
    for (int j0 = warp * 32; j0 < n; j0 += blockDim.x) {  // warp-uniform
      const int j = j0 + lane;
      const bool valid = j < n;
      uint32_t k = 0;
      if (valid) {
        k = ordered_ukey(__uint_as_float(keys0[j]));
        keys0[j] = k;
        all &= k;
        any |= k;
      }
      if (!one_tile) {
#pragma unroll
        for (int p = 0; p < kPasses; ++p) {
          const unsigned dig = valid ? (k >> (8 * p)) & 0xffu : 0x100u;
          const unsigned peers = kFirstCoreTrial ? match_peers(dig) : peers_of_bfe<9>(dig);
          if (valid && lane == __ffs(peers) - 1)
            atomicAdd(&grp[p * kBuckets + dig], (unsigned)__popc(peers));
        }
      }
    }
    all = __reduce_and_sync(kFull, all);
    any = __reduce_or_sync(kFull, any);
    if (lane == 0) {
      atomicAnd(&bits[0], all);
      atomicOr(&bits[1], any);
    }
  }
  unsigned varying;
  if (kCluster) {
    cg::this_cluster().sync();  // every block's bits are in
    unsigned all = kFull, any = 0;
    for (int b = 0; b < c; ++b) {
      const unsigned* rb = cg::this_cluster().map_shared_rank(bits, b);
      all &= rb[0];
      any |= rb[1];
    }
    varying = all ^ any;
  } else {
    __syncthreads();  // the counts and the bits are in
    varying = bits[0] ^ bits[1];
    if (!one_tile) {  // each pass's starting place of digit d in the row
      unsigned cnt[kPasses] = {0, 0, 0, 0};
      if (threadIdx.x < kBuckets)
        for (int g = 0; g < kGroups; ++g)
#pragma unroll
          for (int p = 0; p < kPasses; ++p) cnt[p] += counts[(g * kPasses + p) * kBuckets + d];
      digit_exclusive_scan4(cnt, gs);
      if (threadIdx.x < kBuckets)
#pragma unroll
        for (int p = 0; p < kPasses; ++p) offs[p * kBuckets + d] = cnt[p];
    }
  }
  int n_active = 0;
  for (int p = 0; p < kPasses; ++p) n_active += ((varying >> (8 * p)) & 0xffu) != 0;
  if (kCluster && n_active == 0) cg::this_cluster().sync();  // no block reads the bits after this

  uint32_t* sk = keys0;
  uint32_t* dk = keys1;
  uint16_t* sp = pos0;
  uint16_t* dp = pos1;
  bool first = true;  // the positions are still the elements' own
  for (int p = 0; p < kPasses; ++p) {
    const int shift = 8 * p;
    if (((varying >> shift) & 0xffu) == 0) continue;  // one digit holds the row: order kept
    // thread d: the place in the row of the next item of digit d (set in
    // the tile where the block's elements make one)
    unsigned run = 0;
    if (!one_tile && threadIdx.x < kBuckets) run = offs[p * kBuckets + d];
    // the tile walk: tiles in order, each ranked by (digit, warp) and
    // placed at the running places, which advance by the tile's counts
    unsigned* const mine = counts + warp * kBuckets;
    const int n_tiles = one_tile ? 1 : (n + kTileN - 1) / kTileN;
    for (int t0 = 0; t0 < n_tiles * kTileN; t0 += kTileN) {
      const int c0 = t0 + warp * ITEMS * 32;
      const int wn = min(ITEMS * 32, n - c0);  // <= 0 for a warp past the block's elements
      // the cluster route reads each key from sk where it needs it (the
      // rank, the scatter) and holds only pr in registers
      uint32_t key[kCluster ? 1 : ITEMS], pr[ITEMS];
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int j = i * 32 + lane;
        if (!kCluster) key[kCluster ? 0 : i] = 0xffffffffu;
        pr[i] = 0;
        if (j < wn) {
          if (!kCluster) key[kCluster ? 0 : i] = sk[c0 + j];
          if (kWithPos) pr[i] = (uint32_t)(first ? e0 + c0 + j : (int)sp[c0 + j]) << 16;
        }
      }
      auto key_of = [&](int i) {  // 0xffffffff past the warp's elements
        const int j = i * 32 + lane;
        if (!kCluster) return key[kCluster ? 0 : i];
        return j < wn ? sk[c0 + j] : 0xffffffffu;
      };
      __syncwarp();  // the warp's reads of mine in the last tile's scatter are done
      zero_counts(mine, lane);
      __syncwarp();
      rank_digits_of<kFirstCoreTrial, ITEMS>(key_of, pr, mine, shift, wn, lane);
      __syncthreads();  // every warp's counts are in
      if (one_tile) {  // the pass's counts are the tile's
        unsigned total = 0, before = 0;
        if (threadIdx.x < kBuckets)
          for (int w = 0; w < W; ++w) total += counts[w * kBuckets + d];
        if (kCluster) {
          if (threadIdx.x < kBuckets) offs[d] = total;
          cg::this_cluster().sync();  // every block's counts are in
          total = 0;
          if (threadIdx.x < kBuckets) {
            for (int b = 0; b < c; ++b) {
              const unsigned hb = cg::this_cluster().map_shared_rank(offs, b)[d];
              total += hb;
              if (b < rank) before += hb;
            }
          }
        }
        run = digit_exclusive_scan(total, gs) + before;
      }
      if (threadIdx.x < kBuckets) {
#pragma unroll 8
        for (int w = 0; w < W; ++w) {
          const unsigned cw = counts[w * kBuckets + d];
          counts[w * kBuckets + d] = run;
          run += cw;
        }
      }
      __syncthreads();  // each warp's places are in
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        if (i * 32 >= wn) break;
        if (i * 32 + lane < wn) {
          const uint32_t k = key_of(i);
          const unsigned dig = digit_of<kFirstCoreTrial>(k, shift);
          const int r = (int)(mine[dig] + (pr[i] & 0xffffu));  // the item's place in the row
          if (kCluster) {
            const int b = (r >= m) + (r >= 2 * m) + (r >= 3 * m);
            const int lr = r - b * m;
            st_cluster_u32(cluster_addr(dk + lr, b), k);
            if (kWithPos) st_cluster_u16(cluster_addr(dp + lr, b), (uint16_t)(pr[i] >> 16));
          } else {
            dk[r] = k;
            if (kWithPos) dp[r] = (uint16_t)(pr[i] >> 16);
          }
        }
      }
    }
    if (kCluster) cg::this_cluster().sync();  // every block's buffer is filled
    else __syncthreads();
    uint32_t* const tk = sk;
    sk = dk;
    dk = tk;
    uint16_t* const tp = sp;
    sp = dp;
    dp = tp;
    first = false;
  }

  // the store: floats, and positions widened to int32, coalesced
  float* const o = out + row * L + e0;
  int32_t* const po = kWithPos ? pos_out + row * L + e0 : nullptr;
  int t_scalar = 0;
  if (((uintptr_t)o & 15) == 0 && (!kWithPos || ((uintptr_t)po & 15) == 0)) {
    const int n4 = n >> 2;
    for (int t = threadIdx.x; t < n4; t += blockDim.x) {
      const uint4 k = reinterpret_cast<const uint4*>(sk)[t];
      reinterpret_cast<float4*>(o)[t] =
          make_float4(ukey_to_float(k.x), ukey_to_float(k.y), ukey_to_float(k.z), ukey_to_float(k.w));
      if (kWithPos) {
        const int j = 4 * t;
        reinterpret_cast<int4*>(po)[t] =
            first ? make_int4(e0 + j, e0 + j + 1, e0 + j + 2, e0 + j + 3)
                  : make_int4(sp[j], sp[j + 1], sp[j + 2], sp[j + 3]);
      }
    }
    t_scalar = 4 * n4;
  }
  for (int t = t_scalar + threadIdx.x; t < n; t += blockDim.x) {
    o[t] = ukey_to_float(sk[t]);
    if (kWithPos) po[t] = first ? e0 + t : (int32_t)sp[t];
  }
}

// -- the unsort ---------------------------------------------------------------

// a block a row, the row of floats in shared memory; kVec: 16-byte reads
// and writes (L a multiple of 4, bases aligned), else four elements a
// thread in flight
template <bool kVec>
__global__ void unsort_rows_kernel(const float* __restrict__ vals,
                                   const int32_t* __restrict__ pos,
                                   float* __restrict__ out, int L) {
  extern __shared__ __align__(16) float buf[];
  const int64_t base = (int64_t)blockIdx.x * L;
  if (kVec) {
    const int n4 = L >> 2;
    const int4* p4 = reinterpret_cast<const int4*>(pos + base);
    const float4* v4 = reinterpret_cast<const float4*>(vals + base);
    for (int t = threadIdx.x; t < n4; t += blockDim.x) {
      const int4 p = p4[t];
      const float4 v = v4[t];
      if ((uint32_t)p.x < (uint32_t)L) buf[p.x] = v.x;
      if ((uint32_t)p.y < (uint32_t)L) buf[p.y] = v.y;
      if ((uint32_t)p.z < (uint32_t)L) buf[p.z] = v.z;
      if ((uint32_t)p.w < (uint32_t)L) buf[p.w] = v.w;
    }
    __syncthreads();
    float4* o4 = reinterpret_cast<float4*>(out + base);
    const float4* b4 = reinterpret_cast<const float4*>(buf);
    for (int t = threadIdx.x; t < n4; t += blockDim.x) o4[t] = b4[t];
    return;
  }
  const int stride = blockDim.x;
  for (int t0 = threadIdx.x; t0 < L; t0 += 4 * stride) {
    int32_t p[4];
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t0 + u * stride;
      p[u] = -1;
      if (t < L) {
        p[u] = pos[base + t];
        v[u] = vals[base + t];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if ((uint32_t)p[u] < (uint32_t)L) buf[p[u]] = v[u];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < L; t += stride) out[base + t] = buf[t];
}

// a warp a row, kUnsortWarps rows a block, each warp in its own slice of L
// floats; kVec: 16-byte reads and writes (L a multiple of 4, bases aligned)
template <bool kVec>
__global__ void __launch_bounds__(32 * kUnsortWarps)
    unsort_rows_warp_kernel(const float* __restrict__ vals, const int32_t* __restrict__ pos,
                            float* __restrict__ out, int64_t B, int L) {
  extern __shared__ __align__(16) float wbuf[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kUnsortWarps + warp;
  if (row >= B) return;  // no block barrier follows
  float* buf = wbuf + (size_t)warp * L;
  const int64_t base = row * L;
  if (kVec) {
    const int n4 = L >> 2;
    const int4* p4 = reinterpret_cast<const int4*>(pos + base);
    const float4* v4 = reinterpret_cast<const float4*>(vals + base);
    for (int t = lane; t < n4; t += 32) {
      const int4 p = p4[t];
      const float4 v = v4[t];
      if ((uint32_t)p.x < (uint32_t)L) buf[p.x] = v.x;
      if ((uint32_t)p.y < (uint32_t)L) buf[p.y] = v.y;
      if ((uint32_t)p.z < (uint32_t)L) buf[p.z] = v.z;
      if ((uint32_t)p.w < (uint32_t)L) buf[p.w] = v.w;
    }
    __syncwarp();
    float4* o4 = reinterpret_cast<float4*>(out + base);
    const float4* b4 = reinterpret_cast<const float4*>(buf);
    for (int t = lane; t < n4; t += 32) o4[t] = b4[t];
  } else {
    for (int t = lane; t < L; t += 32) {
      const int32_t p = pos[base + t];
      if ((uint32_t)p < (uint32_t)L) buf[p] = vals[base + t];
    }
    __syncwarp();
    for (int t = lane; t < L; t += 32) out[base + t] = buf[t];
  }
}

// a straight scatter in device memory: thread t takes elements 4t..4t+3 of
// the (B * L) array (one row when kVec: L a multiple of 4, bases aligned)
template <bool kVec>
__global__ void __launch_bounds__(kScatterThreads)
    unsort_rows_scatter_kernel(const float* __restrict__ vals, const int32_t* __restrict__ pos,
                               float* __restrict__ out, int64_t n, int L) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; 4 * t < n; t += stride) {
    const int64_t e0 = 4 * t;
    if (kVec) {
      const int64_t base = e0 - e0 % L;
      const int4 p = reinterpret_cast<const int4*>(pos)[t];
      const float4 v = reinterpret_cast<const float4*>(vals)[t];
      if ((uint32_t)p.x < (uint32_t)L) out[base + p.x] = v.x;
      if ((uint32_t)p.y < (uint32_t)L) out[base + p.y] = v.y;
      if ((uint32_t)p.z < (uint32_t)L) out[base + p.z] = v.z;
      if ((uint32_t)p.w < (uint32_t)L) out[base + p.w] = v.w;
    } else {
      int64_t base = e0 - e0 % L;
      for (int64_t e = e0; e < e0 + 4 && e < n; ++e) {
        if (e - base == L) base += L;
        const int32_t p = pos[e];
        if ((uint32_t)p < (uint32_t)L) out[base + p] = vals[e];
      }
    }
  }
}

// a multiple of the warp, at least one warp, at most kMaxThreads
int block_threads(int work) {
  int t = (work + 31) / 32 * 32;
  if (t < 32) t = 32;
  if (t > kMaxThreads) t = kMaxThreads;
  return t;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  return cudaSuccess;
}

template <bool kWithPos, int ITEMS>
cudaError_t launch_warp_route(const float* x, float* out, int32_t* pos, int64_t B, int L,
                              cudaStream_t stream) {
  const size_t smem = kRowsPerBlock * (kBuckets * 4 + buffer_bytes(L, kWithPos));
  const int64_t blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  sort_rows_warp_kernel<kWithPos, ITEMS>
      <<<(unsigned)blocks, 32 * kRowsPerBlock, smem, stream>>>(x, out, pos, B, L);
  return cudaGetLastError();
}

template <bool kWithPos, int ITEMS>
cudaError_t launch_block_route(const float* x, float* out, int32_t* pos, int64_t B, int L,
                               cudaStream_t stream) {
  // at least 8 warps, so that a thread per digit does the scan; a warp past
  // the row holds no item and only takes part in the barriers
  int n_warps = (L + ITEMS * 32 - 1) / (ITEMS * 32);
  if (n_warps < kBuckets / 32) n_warps = kBuckets / 32;
  if (ITEMS == 12 && 32 * n_warps > kBlock12Threads) return cudaErrorInvalidValue;  // its bounds
  const size_t smem = block_header_bytes(n_warps) + buffer_bytes(L, kWithPos);
  cudaError_t err = allow_smem(sort_rows_block_kernel<kWithPos, ITEMS>, smem);
  if (err != cudaSuccess) return err;
  sort_rows_block_kernel<kWithPos, ITEMS>
      <<<(unsigned)B, 32 * n_warps, smem, stream>>>(x, out, pos, L);
  return cudaGetLastError();
}

template <bool kWithPos>
cudaError_t launch_long_route(const float* x, float* out, int32_t* pos, uint32_t* work, int64_t B,
                              int L, cudaStream_t stream) {
  if (work == nullptr) return cudaErrorInvalidValue;
  const size_t smem = sizeof(LongSmem);
  cudaError_t err = allow_smem(sort_rows_long_kernel<kWithPos>, smem);
  if (err != cudaSuccess) return err;
  sort_rows_long_kernel<kWithPos><<<(unsigned)B, 32 * kLongWarps, smem, stream>>>(x, out, pos, work,
                                                                                  B, L);
  return cudaGetLastError();
}

// The cluster route's blocks a row at L: the least number, at least
// kClusterMin, whose blocks each hold one tile of the row.
int cluster_size(int L) {
  const int c = (L + kClusterTile - 1) / kClusterTile;
  return c > kClusterMin ? c : kClusterMin;
}

// The sort's route at L (the trial switch may force the device-memory
// route).  The cluster route takes the rows
// that kClusterMax blocks of one tile each hold (55,296): past them its
// blocks would walk several tiles, each pass counting its digits, and the
// device-memory route ran faster on the card.
SortRoute sort_route(int L, bool with_pos) {
  if (L <= kWarpRouteMaxLen) return kRouteWarp;
  if (L <= kMaxLen) return kRouteBlock;
  if (SDT_K9_LONG_ROUTE == 1) return kRouteDevice;
  if (L <= row_capacity(kSmemWarps, with_pos)) return kRouteSmem;
  if (cluster_size(L) <= kClusterMax) return kRouteCluster;
  return kRouteDevice;
}

// The shared-memory route (c = 1, a block a row) and the cluster route
// (c blocks a row, one cluster a row).
template <bool kWithPos, int W, int ITEMS, bool kCluster>
cudaError_t launch_rows_in_smem(const float* x, float* out, int32_t* pos, int64_t B, int L, int c,
                                cudaStream_t stream) {
  if (B * c > 0x7fffffff) return cudaErrorInvalidValue;
  const int m = (L + c - 1) / c;
  const size_t smem = row_smem_bytes(m, W, kWithPos);
  auto kernel = sort_rows_smem_kernel<W, ITEMS, kWithPos, kCluster>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (!kCluster) {
    kernel<<<(unsigned)B, 32 * W, smem, stream>>>(x, out, pos, L, m);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * c), 1, 1);
  cfg.blockDim = dim3(32 * W, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, out, pos, L, m);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Items a lane, chosen by L.  The warp route takes the least multiple of 4
// that holds the row (registers are sized by it).  The block route takes 4
// items a lane up to 2,048, 12 up to 4,096 and 16 up to 8,192, 8 to 16
// warps: at config 8's 3,650, 10 warps of 12 items ran faster on the card
// than 15 of 8 or 8 of 16.  Above 8,192 the route of sort_route.
template <bool kWithPos>
int launch_sort(const float* x, float* out, int32_t* pos, uint32_t* work, int64_t B, int L,
                void* stream) {
  if (B <= 0 || L <= 0 || B > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (sort_route(L, kWithPos)) {
    case kRouteSmem:
      return (int)launch_rows_in_smem<kWithPos, kSmemWarps, kSmemItems, false>(x, out, pos, B, L, 1, s);
    case kRouteCluster:
      return (int)launch_rows_in_smem<kWithPos, kClusterWarps, kClusterItems, true>(
          x, out, pos, B, L, cluster_size(L), s);
    case kRouteDevice:
      return (int)launch_long_route<kWithPos>(x, out, pos, work, B, L, s);
    default:
      break;
  }
  cudaError_t err;
  switch (L <= kWarpRouteMaxLen ? (L + 127) / 128 : 0) {
    case 1: err = launch_warp_route<kWithPos, 4>(x, out, pos, B, L, s); break;
    case 2: err = launch_warp_route<kWithPos, 8>(x, out, pos, B, L, s); break;
    case 3: err = launch_warp_route<kWithPos, 12>(x, out, pos, B, L, s); break;
    case 4: err = launch_warp_route<kWithPos, 16>(x, out, pos, B, L, s); break;
    case 5: err = launch_warp_route<kWithPos, 20>(x, out, pos, B, L, s); break;
    case 6: err = launch_warp_route<kWithPos, 24>(x, out, pos, B, L, s); break;
    case 7: err = launch_warp_route<kWithPos, 28>(x, out, pos, B, L, s); break;
    case 8: err = launch_warp_route<kWithPos, 32>(x, out, pos, B, L, s); break;
    default:
      if (L <= 2048) err = launch_block_route<kWithPos, 4>(x, out, pos, B, L, s);
      else if (L <= 4096) err = launch_block_route<kWithPos, 12>(x, out, pos, B, L, s);
      else err = launch_block_route<kWithPos, 16>(x, out, pos, B, L, s);
  }
  return (int)err;
}

// The unsort's route at L (the trial switch takes the scatter above 8,192).
UnsortRoute unsort_route(int L) {
  if (L > kUnsortBlockMax || (L > kMaxLen && SDT_K9_LONG_ROUTE == 1)) return kUnsortScatter;
  return L <= kUnsortWarpMax ? kUnsortWarp : kUnsortBlock;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// work: null unless L takes the device-memory route (sdt_sort_route);
// there, B * L uint32 (sort_rows) or B * L uint32 then B * L int32 (with
// positions), on the launch's stream.
int sdt_sort_rows(const float* x, float* out, void* work, int64_t B, int L, void* stream) {
  return launch_sort<false>(x, out, nullptr, (uint32_t*)work, B, L, stream);
}

int sdt_sort_rows_with_positions(const float* x, float* out, int32_t* pos, void* work, int64_t B,
                                 int L, void* stream) {
  return launch_sort<true>(x, out, pos, (uint32_t*)work, B, L, stream);
}

int sdt_unsort_rows(const float* vals, const int32_t* pos, float* out, int64_t B, int L,
                    void* stream) {
  if (B <= 0 || L <= 0 || B > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (L & 3) == 0 && aligned16(vals) && aligned16(pos) && aligned16(out);
  cudaError_t err = cudaSuccess;
  switch (unsort_route(L)) {
    case kUnsortWarp: {
      const size_t smem = (size_t)kUnsortWarps * L * sizeof(float);
      const int64_t blocks = (B + kUnsortWarps - 1) / kUnsortWarps;
      if (vec) {
        err = allow_smem(unsort_rows_warp_kernel<true>, smem);
        if (err == cudaSuccess)
          unsort_rows_warp_kernel<true><<<(unsigned)blocks, 32 * kUnsortWarps, smem, s>>>(vals, pos, out, B, L);
      } else {
        err = allow_smem(unsort_rows_warp_kernel<false>, smem);
        if (err == cudaSuccess)
          unsort_rows_warp_kernel<false><<<(unsigned)blocks, 32 * kUnsortWarps, smem, s>>>(vals, pos, out, B, L);
      }
      break;
    }
    case kUnsortBlock: {
      const size_t smem = (size_t)L * sizeof(float);
      const int threads = block_threads(vec ? L / 4 : L);
      if (vec) {
        err = allow_smem(unsort_rows_kernel<true>, smem);
        if (err == cudaSuccess)
          unsort_rows_kernel<true><<<(unsigned)B, threads, smem, s>>>(vals, pos, out, L);
      } else {
        err = allow_smem(unsort_rows_kernel<false>, smem);
        if (err == cudaSuccess)
          unsort_rows_kernel<false><<<(unsigned)B, threads, smem, s>>>(vals, pos, out, L);
      }
      break;
    }
    case kUnsortScatter: {
      const int64_t n = B * (int64_t)L;
      int64_t blocks = ((n + 3) / 4 + kScatterThreads - 1) / kScatterThreads;
      if (blocks > 0x7fffffff) blocks = 0x7fffffff;
      if (vec) {
        unsort_rows_scatter_kernel<true><<<(unsigned)blocks, kScatterThreads, 0, s>>>(vals, pos, out, n, L);
      } else {
        unsort_rows_scatter_kernel<false><<<(unsigned)blocks, kScatterThreads, 0, s>>>(vals, pos, out, n, L);
      }
      break;
    }
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The unsort's route at L in this build: 0 a warp a row, 1 a block a row,
// 2 the straight scatter.
int sdt_unsort_route(int L) { return (int)unsort_route(L); }

// The sort's route at L in this build: 0 a warp a row, 1 a block a row, 2
// shared memory, 3 a cluster, 4 device memory; cluster: its blocks a row
// (0 on the other routes).
int sdt_sort_route(int L, int with_pos, int* cluster) {
  if (L <= 0) return -1;
  const SortRoute r = sort_route(L, with_pos != 0);
  if (cluster) *cluster = r == kRouteCluster ? cluster_size(L) : 0;
  return (int)r;
}

const char* sdt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
