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
// Three shapes of the one sort, chosen by L in the launcher (a route by
// shape; all are this kernel):
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
// On these two the row lives in shared memory, the position travels as a
// 16-bit payload (L <= 8,192 < 2^16), widened to int32 at the store, and
// the final order is stored from registers, striped, so the stores are
// coalesced.
// * L > 8,192 (the long route, any L < 2^31): a block a row walks the row
//   in tiles of kLongWarps * kLongItems * 32 elements.  One sweep reads the
//   row once and counts all four digits (warp-aggregated shared atomics)
//   and the AND / OR of its keys; an exclusive scan of each count gives
//   every pass its starting offset per digit.  Each pass that is not
//   skipped takes the tiles in order: it ranks a tile with the block
//   machinery of radix_sort.cuh (rank_digits, the (digit, warp) scan, the
//   scatter into shared memory, which orders the tile by digit), writes
//   the tile out digit run by digit run at the pass's running offset of
//   each digit, and advances those offsets by the tile's counts.  The tiles
//   go in order and each is placed stably, so the pass is stable.  Keys and
//   int32 positions travel between passes through device memory: a
//   workspace from the wrapper and the outputs themselves, in turns, so
//   that the last pass lands in the outputs (the first pass writes the
//   outputs when an odd number of passes run).  A row of 10,957 days holds
//   88 KB of keys and positions, which L2 keeps between passes.
//
// Unsort.  The positions of a row are a permutation of 0..L-1, so the
// unsort is a scatter, out[b, pos[b, i]] = vals[b, i]; a position outside
// [0, L) is skipped, so nothing is written outside the row.  Three routes
// (the trial switch SDT_K9_UNSORT_ROUTE forces one):
// * a warp a row, kUnsortWarps rows a block, each warp with its own slice
//   of shared memory and __syncwarp alone: the warp reads positions and
//   values (16 bytes a lane where L is a multiple of 4 and the row bases
//   are 16-byte aligned, as at 304 and 620), writes smem[pos[i]] =
//   vals[i], and writes the row out the same way;
// * a block a row (the first port's kernel): the same through a block's
//   shared memory, one __syncthreads;
// * a straight scatter in device memory, a thread per 4 elements (16-byte
//   reads where L is a multiple of 4), as torch's scatter_ does.  Rows
//   above 8,192 always take it.
// By default the launcher takes the warp route up to kUnsortWarpMax, the
// block route up to 8,192 and the scatter above (chip_smoke.py --trials
// sort_rows times the three).
//
// What bounds them on the H100.  The compulsory traffic is 8 B an element
// for the sort (12 with positions and for the unsort), 0.05-0.08 ms at
// config 8's (6144, 3650) rows.  The bitonic network this replaces did 78
// stages over 4,096 8-byte words a row, about 5.1 MB of shared-memory
// traffic, with a block barrier a stage.  The radix sort moves each element
// through shared memory once a pass (4 + 2 B written and read, about 175 KB
// a row of 3,650 in four passes) and spends some 60 warp instructions a
// pass on each 32 items (8 ballots and their masks, the counter update, the
// scatter and the read-back); the counter updates and the scatter land on
// random banks.  So instruction issue, shared-memory bank conflicts and
// their latency bound it, hidden as far as the resident warps allow, far
// above the bytes.  The long route adds each pass's 8 B (16 with
// positions) an element written and read back through L2.  TMA is not
// used: a row of 3,650 floats is 14,600 B, not a multiple of 16, and the
// compulsory bytes are a small part of the time.
//
// Resources (nvcc -Xptxas -v for sm_90a; resident blocks per SM from the
// 65,536 registers and 228 KB of shared memory of an SM), with positions /
// without: at 3,650 (12 items a lane, 10 warps) 63 / 63 registers a thread
// and 32,320 / 25,008 B of shared memory a block, so the registers hold 3
// blocks (30 warps) an SM; at 620 (20 items a lane) 80 / 80 registers and
// 19,008 / 14,016 B a block of four rows, 6 blocks (24 warps); at 304 (12
// items) 55 / 55 registers and 11,392 / 8,960 B, 9 blocks (36 warps).
// Registers, not shared memory, set the resident blocks at every shape; a
// few instances (16 to 32 items a lane) spill 8-20 B a thread.
//
// The C entry points take plain pointers, sizes and the CUDA stream, launch
// on that stream without synchronising, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_sort.cuh"

// Trial switches (chip_smoke.py --trials sort_rows builds and times each
// against the default): the unsort's route (0: chosen by L; 1: a block a
// row up to 8,192; 2: a warp a row up to 1,024, a block a row to 8,192; 3:
// the straight scatter at every L) and the long route's items a lane.
#ifndef SDT_K9_UNSORT_ROUTE
#define SDT_K9_UNSORT_ROUTE 0
#endif
#ifndef SDT_K9_LONG_ITEMS
#define SDT_K9_LONG_ITEMS 16
#endif

namespace {

using namespace radix;

constexpr int kMaxLen = 8192;      // K9_MAX_LEN of kernels/sort_rows.py
constexpr int kMaxThreads = 1024;  // the unsort's block
constexpr int kRowsPerBlock = 4;  // warps (rows) a block on the warp route
// the long route: 8 warps (a thread per digit), a tile of 4,096 elements
constexpr int kLongWarps = kBuckets / 32;
constexpr int kLongItems = SDT_K9_LONG_ITEMS;
constexpr int kTile = kLongWarps * kLongItems * 32;
static_assert(kTile <= 65536, "tile indices travel as 16-bit payloads");
// the unsort's warp route: rows (warps) a block, and the longest row
constexpr int kUnsortWarps = 8;
constexpr int kUnsortWarpMax = 1024;
constexpr int kScatterThreads = 256;

enum UnsortRoute { kUnsortWarp = 0, kUnsortBlock = 1, kUnsortScatter = 2 };

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
__global__ void __launch_bounds__(32 * kRowsPerBlock)
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
  warp_radix_sort<ITEMS, kWithPos>(key, pr, all ^ any, counts, skey, spos, L, lane);
  store_chunk<ITEMS, kWithPos>(key, pr, out + row * L, kWithPos ? pos_out + row * L : nullptr, 0,
                               L, lane);
}

// Block route: block b sorts row b (1,024 < L <= 8,192) with blockDim.x / 32
// warps, 8 to 16, warp w holding elements [w * ITEMS * 32, (w + 1) * ITEMS *
// 32) of the row (none for a warp past it); shared memory as
// block_radix_sort lays it out.
template <bool kWithPos, int ITEMS>
__global__ void __launch_bounds__(32 * kBlockRouteMaxWarps)
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
  block_radix_sort<ITEMS, kWithPos>(key, pr, all, any, smem, L, n, c0);
  store_chunk<ITEMS, kWithPos>(key, pr, out + base, kWithPos ? pos_out + base : nullptr, c0, n,
                               lane);
}

// -- the long route (L > 8,192) -----------------------------------------------

// Shared memory of a long-route block.
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
  rank_digits<kLongItems>(key, pr, mine, shift, n, lane);
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
  scatter<kLongItems, kWithPos, true>(key, pr, mine, group_base, sm.skey, sm.sidx, shift, n, lane);
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

// -- the unsort ---------------------------------------------------------------

// a block a row
__global__ void unsort_rows_kernel(const float* __restrict__ vals,
                                   const int32_t* __restrict__ pos,
                                   float* __restrict__ out, int L) {
  extern __shared__ float buf[];
  const int64_t base = (int64_t)blockIdx.x * L;
  for (int t = threadIdx.x; t < L; t += blockDim.x) {
    const int32_t p = pos[base + t];
    if ((uint32_t)p < (uint32_t)L) buf[p] = vals[base + t];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < L; t += blockDim.x) out[base + t] = buf[t];
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

// Items a lane, chosen by L.  The warp route takes the least multiple of 4
// that holds the row (registers are sized by it).  The block route takes 4
// items a lane up to 2,048, 12 up to 4,096 and 16 up to 8,192, 8 to 16
// warps: at config 8's 3,650, 10 warps of 12 items ran faster on the card
// than 15 of 8 or 8 of 16.  Above 8,192 the long route.
template <bool kWithPos>
int launch_sort(const float* x, float* out, int32_t* pos, uint32_t* work, int64_t B, int L,
                void* stream) {
  if (B <= 0 || L <= 0 || B > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (L > kMaxLen) return (int)launch_long_route<kWithPos>(x, out, pos, work, B, L, s);
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

// The unsort's route at L (the trial switch may force one).
UnsortRoute unsort_route(int L) {
  if (L > kMaxLen || SDT_K9_UNSORT_ROUTE == 3) return kUnsortScatter;
  if (SDT_K9_UNSORT_ROUTE == 1) return kUnsortBlock;
  const int warp_max = SDT_K9_UNSORT_ROUTE == 2 ? 1024 : kUnsortWarpMax;
  return L <= warp_max ? kUnsortWarp : kUnsortBlock;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// work: null for L <= 8,192; above, B * L uint32 (sort_rows) or B * L
// uint32 then B * L int32 (with positions), on the launch's stream.
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
      err = allow_smem(unsort_rows_kernel, smem);
      if (err == cudaSuccess)
        unsort_rows_kernel<<<(unsigned)B, block_threads(L), smem, s>>>(vals, pos, out, L);
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

const char* sdt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
