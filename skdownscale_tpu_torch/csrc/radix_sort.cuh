// Stable LSD radix sort of float32 keys, by a warp or by a block, for
// Hopper (sm_90a).  Shared by the row sort K9 (sort_rows.cu), the segment
// sorts K1 / K2 (rank_map.cu) and the sliding sorted window K5
// (slide_sort.cu, which sorts each cell's first window with it).
//
// Keys.  Each float becomes the 32-bit key ordered_ukey: the
// order-isomorphic int32 key of ops/keys.py (sort_kernel.py:60-73) with its
// sign bit flipped, so the unsigned order is the total order
// -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN.  Every float has a key of
// its own, so the sorted keys mapped back are the sorted values, bitwise.
//
// Sort: four passes of 8-bit digits, low digit first, with the position as
// a 16-bit payload (L < 2^16).  A pass puts each item at (items of smaller
// digit) + (items of its digit before it), so ties keep their order; the
// input is in position order, so the positions come out as those of a
// STABLE sort, torch.sort(keys, stable=True).
//
// Items live in registers, warp-striped: item i of lane l is element
// i*32 + l of its warp's chunk of the row, so (i, l) order is position order
// within the chunk, and the chunks follow each other in warp order.  A pass:
//   1. each warp ranks its items among its own by digit, item by item: the
//      lanes that hold the same digit in item i (its peers) come from 8
//      ballots, and each item's rank is the warp's count of its digit in
//      the items before (its counter in shared memory) plus its peers on
//      lower lanes;
//   2. an exclusive scan of the counters in (digit, warp) order gives each
//      warp its base per digit;
//   3. each item goes to base + rank in a shared buffer of keys (4 B) and
//      positions (2 B), and every lane reads its items back striped.
// A pass whose byte is the same in every key of the row would keep the
// order, so it is skipped, ranking included: the AND and the OR of the
// row's keys, taken at the load, differ in no bit of that byte.
//
// Two versions of step 1 (the template flag kFirst below): the new core,
// which every caller takes, and the first core, written with K9's first
// radix sort, which only the trial build SDT_RADIX_CORE_PR6=1 takes
// (kFirstCoreTrial), for chip_smoke.py --trials to time beside the new:
// * the first (peers_of, rank_digits_first): the peers by a C++ loop of
//   ballots, then the lowest peer's atomicAdd on its counter, the old count
//   broadcast by __shfl_sync, a __syncwarp.  On sm_90a the loop compiles to
//   about seven instructions a bit (the bit is shifted out and compared for
//   the ballot, and tested again to select the ballot or its complement),
//   and an item of the block route took some 86 instructions to rank
//   (chip_smoke.py --sass: a ballot every 6.9).
// * the new core (peers_of_bfe, rank_digits_rmw): the peers in one block of
//   PTX (the ballot of each bit, the bit sign-extended, one AND of the
//   peers with the complement of their XOR), and the counter read by every
//   lane (the lanes of one digit read one word) and written back by the
//   lowest peer alone after a __syncwarp, as cub's BlockRadixRankMatch
//   does: no atomic, no shuffle, no find-first-set; the digit is one byte
//   permutation.  An item of the block route now takes some 57
//   instructions to rank (a ballot every 4.3).  The kernels are bound by
//   instruction issue, so these count: on the card the new core ran 9-31%
//   faster than the first at every route of K9 and K2 (the least on the
//   cluster route; chip_smoke.py --trials, PERF.md).  Tried on the card and
//   dropped: four items' counter updates in flight before any broadcast
//   (3-12% slower than the first: the latency was hidden, the extra
//   instructions were not); __match_any_sync for the peers (17-33%
//   slower); a NOT or a select under the ballot's predicate (ptxas fails
//   to allocate predicates, C7600, in the shared-memory route's kernel
//   with positions).
//
// Two shapes of the one sort:
// * warp_radix_sort: a warp sorts a row of L <= ITEMS * 32 <=
//   kWarpRouteMaxLen in its own slice of shared memory (256 counters and
//   the key / position buffers), with __syncwarp only.
// * block_radix_sort: the warps of a block (8 to 32) each hold a
//   contiguous chunk of ITEMS * 32 elements; one __syncthreads after the
//   load and three a pass that is not skipped (counters in, scan done,
//   scatter done).
// Either way the sorted keys end in the registers, striped (and, after a
// pass that was not skipped, in the key buffer in order).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SDT_RADIX_CORE_PR6
#define SDT_RADIX_CORE_PR6 0
#endif

namespace radix {

constexpr int kWarpRouteMaxLen = 1024;  // 32 items a lane
constexpr int kBlockRouteMaxWarps = 16;  // most warps a block of K9's and K5's block routes
constexpr int kBuckets = 256;
constexpr int kPasses = 4;
constexpr unsigned kFull = 0xffffffffu;
// the trial build: the first core (its ranking and the code around it) at
// every route
constexpr bool kFirstCoreTrial = SDT_RADIX_CORE_PR6 != 0;

__device__ __forceinline__ uint32_t ordered_ukey(float v) {
  const int32_t b = __float_as_int(v);
  const int32_t k = b >= 0 ? b : (~b) ^ INT32_MIN;
  return (uint32_t)k ^ 0x80000000u;  // signed key order -> unsigned order
}

__device__ __forceinline__ float ukey_to_float(uint32_t u) {
  const int32_t k = (int32_t)(u ^ 0x80000000u);
  const int32_t b = k >= 0 ? k : ~(k ^ INT32_MIN);
  return __int_as_float(b);
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// bytes of the key buffer and, with positions, the position buffer of a row
__host__ __device__ constexpr size_t buffer_bytes(int L, bool with_pos) {
  return align16((size_t)L * 4) + (with_pos ? align16((size_t)L * 2) : 0);
}

// bytes before the buffers on the block route: counters, group sums, bits
__host__ __device__ constexpr size_t block_header_bytes(int n_warps) {
  return align16(((size_t)n_warps * kBuckets + 8 + 2 * (size_t)n_warps) * 4);
}

// the lanes whose digit equals this lane's (8-bit digits), as
// __match_any_sync would return them, from one ballot a bit
__device__ __forceinline__ unsigned peers_of(unsigned digit) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (digit >> b) & 1u;
    const unsigned set = __ballot_sync(kFull, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// The same peers, in one block of PTX: for each bit the ballot of the bit
// (an AND that sets the predicate, the vote) and the bit sign-extended
// (bfe.s32), then one AND of the peers with the complement of their XOR.
// The predicate feeds the vote alone.  The first core's C++ loop above
// compiles to about seven instructions a bit on sm_90a (the bit shifted
// out and compared for the ballot, and tested again for the select), and
// so does the loop written with one test a bit; a NOT or a select under the predicate
// (cub's MatchAny) makes ptxas fail to allocate predicates (C7600) in the
// shared-memory route's kernel with positions.
#define SDT_PEERS_BIT(m, b)                      \
  "and.b32 t, %1, " #m ";\n\t"                   \
  "setp.ne.u32 p, t, 0;\n\t"                     \
  "vote.sync.ballot.b32 s, p, 0xffffffff;\n\t"   \
  "bfe.s32 t, %1, " #b ", 1;\n\t"                \
  "xor.b32 s, s, t;\n\t"                         \
  "not.b32 s, s;\n\t"                            \
  "and.b32 %0, %0, s;\n\t"
// kBits 8 (a digit) or 9 (a digit, or 0x100 for no item)
template <int kBits = 8>
__device__ __forceinline__ unsigned peers_of_bfe(unsigned digit) {
  static_assert(kBits == 8 || kBits == 9, "8 or 9 bits");
  unsigned peers;
  if constexpr (kBits == 8) {
    asm("{\n\t.reg .pred p;\n\t.reg .b32 t, s;\n\t"
        "mov.b32 %0, 0xffffffff;\n\t"
        SDT_PEERS_BIT(1, 0) SDT_PEERS_BIT(2, 1) SDT_PEERS_BIT(4, 2) SDT_PEERS_BIT(8, 3)
        SDT_PEERS_BIT(16, 4) SDT_PEERS_BIT(32, 5) SDT_PEERS_BIT(64, 6) SDT_PEERS_BIT(128, 7)
        "}"
        : "=r"(peers)
        : "r"(digit));
  } else {
    asm("{\n\t.reg .pred p;\n\t.reg .b32 t, s;\n\t"
        "mov.b32 %0, 0xffffffff;\n\t"
        SDT_PEERS_BIT(1, 0) SDT_PEERS_BIT(2, 1) SDT_PEERS_BIT(4, 2) SDT_PEERS_BIT(8, 3)
        SDT_PEERS_BIT(16, 4) SDT_PEERS_BIT(32, 5) SDT_PEERS_BIT(64, 6) SDT_PEERS_BIT(128, 7)
        SDT_PEERS_BIT(256, 8)
        "}"
        : "=r"(peers)
        : "r"(digit));
  }
  return peers;
}
#undef SDT_PEERS_BIT

__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned v, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const unsigned t = __shfl_up_sync(kFull, v, s);
    if (lane >= s) v += t;
  }
  return v;
}

// Loads a warp's chunk of n elements (none if n <= 0), striped, as keys:
// fetch(j) is the key of element j of the chunk, j < n; an element past the
// chunk gets key 0xffffffff and is never stored.  The high half of pr[i] is
// the element's position in the row (c0 + index).  all / any: the AND / OR
// of the chunk's keys, on every lane.
template <int ITEMS, class Fetch>
__device__ __forceinline__ void load_keys(Fetch fetch, int n, int c0, int lane,
                                          uint32_t (&key)[ITEMS], uint32_t (&pr)[ITEMS],
                                          unsigned& all, unsigned& any) {
  all = kFull;
  any = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = i * 32 + lane;
    key[i] = j < n ? fetch(j) : 0xffffffffu;
    pr[i] = (uint32_t)(c0 + j) << 16;
    all &= key[i];
    any |= j < n ? key[i] : 0u;
  }
  all = __reduce_and_sync(kFull, all);
  any = __reduce_or_sync(kFull, any);
}

// The digit of a pass (shift 0, 8, 16 or 24): a shift and a mask in the
// first core, one byte permutation (__byte_perm, byte shift / 8, zeros
// above) in the new one.
template <bool kFirst>
__device__ __forceinline__ unsigned digit_of(uint32_t key, int shift) {
  if constexpr (kFirst) return (key >> shift) & 0xffu;
  else return __byte_perm(key, 0, 0x4440u | (unsigned)(shift >> 3));
}

// Both rankings count the digits (key_of(i) >> shift) & 255 of the warp's n
// items into counts[256] (zeroed by the caller) and set the low half of
// pr[i] to the item's rank among the warp's items of its digit that come
// before it in (i, l) order.  key_of(i): this lane's key of item i
// (0xffffffff for a lane past the chunk).

// The first core's: item after item.
template <int ITEMS, class Key>
__device__ __forceinline__ void rank_digits_first(Key key_of, uint32_t (&pr)[ITEMS],
                                                unsigned* counts, int shift, int n, int lane) {
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int left = n - i * 32;
    if (left <= 0) break;  // the same for every lane
    const unsigned valid = left >= 32 ? kFull : (1u << left) - 1u;
    const unsigned d = (key_of(i) >> shift) & 0xffu;
    const unsigned peers = peers_of(d) & valid;
    const int first = __ffs(peers) - 1;  // -1 for a lane past the chunk
    unsigned before = 0;
    if (lane == first) before = atomicAdd(&counts[d], (unsigned)__popc(peers));
    before = __shfl_sync(kFull, before, first & 31);
    pr[i] = (pr[i] & 0xffff0000u) | (before + __popc(peers & below));
    __syncwarp();  // the next item's counter updates see this one's
  }
}

// Read and write back (as cub's BlockRadixRankMatch): every lane reads its
// digit's counter (the lanes of one digit read one word, a broadcast), and
// after a __syncwarp the lowest peer writes it back advanced by the peers'
// number: only that lane writes the word in this item, so no atomic is
// needed, and each lane has its old count without a shuffle.  The peers
// come from peers_of_bfe.
template <int ITEMS, class Key>
__device__ __forceinline__ void rank_digits_rmw(Key key_of, uint32_t (&pr)[ITEMS],
                                                unsigned* counts, int shift, int n, int lane) {
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int left = n - i * 32;
    if (left <= 0) break;  // the same for every lane
    const unsigned valid = left >= 32 ? kFull : (1u << left) - 1u;
    const unsigned d = digit_of<false>(key_of(i), shift);
    const unsigned peers = peers_of_bfe<8>(d) & valid;
    const unsigned before = counts[d];
    __syncwarp();  // every lane has read its counter before the lowest peers write
    const unsigned lower = __popc(peers & below);
    if (lane < left && lower == 0) counts[d] = before + __popc(peers);
    __syncwarp();  // the next item reads what this one wrote
    pr[i] = (pr[i] & 0xffff0000u) | (before + lower);
  }
}

// the ranking of kFirst on keys from key_of
template <bool kFirst, int ITEMS, class Key>
__device__ __forceinline__ void rank_digits_of(Key key_of, uint32_t (&pr)[ITEMS], unsigned* counts,
                                               int shift, int n, int lane) {
  if constexpr (kFirst) rank_digits_first<ITEMS>(key_of, pr, counts, shift, n, lane);
  else rank_digits_rmw<ITEMS>(key_of, pr, counts, shift, n, lane);
}

// the same on keys held in registers
template <bool kFirst, int ITEMS>
__device__ __forceinline__ void rank_digits(const uint32_t (&key)[ITEMS], uint32_t (&pr)[ITEMS],
                                            unsigned* counts, int shift, int n, int lane) {
  rank_digits_of<kFirst, ITEMS>([&](int i) { return key[i]; }, pr, counts, shift, n, lane);
}

// Stores each of the warp's n items at offsets[digit] (+ the base of the
// digit's group of 32, held by lane digit >> 5 in group_base, on the block
// route) + its rank, into the row's key and position buffers.
template <int ITEMS, bool kWithPos, bool kGroupBase, bool kFirst>
__device__ __forceinline__ void scatter(const uint32_t (&key)[ITEMS], const uint32_t (&pr)[ITEMS],
                                        const unsigned* offsets, unsigned group_base,
                                        uint32_t* skey, uint16_t* spos, int shift, int n,
                                        int lane) {
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (i * 32 >= n) break;
    const unsigned d = digit_of<kFirst>(key[i], shift);
    unsigned r = offsets[d] + (pr[i] & 0xffffu);
    if (kGroupBase) r += __shfl_sync(kFull, group_base, d >> 5);
    if (i * 32 + lane < n) {
      skey[r] = key[i];
      if (kWithPos) spos[r] = (uint16_t)(pr[i] >> 16);
    }
  }
}

// Reads the warp's n items back, striped, from the buffers at c0.
template <int ITEMS, bool kWithPos>
__device__ __forceinline__ void gather(uint32_t (&key)[ITEMS], uint32_t (&pr)[ITEMS],
                                       const uint32_t* skey, const uint16_t* spos, int c0, int n,
                                       int lane) {
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (i * 32 >= n) break;
    const int j = i * 32 + lane;
    if (j < n) {
      key[i] = skey[c0 + j];
      if (kWithPos) pr[i] = (uint32_t)spos[c0 + j] << 16;
    }
  }
}

__device__ __forceinline__ void zero_counts(unsigned* counts, int lane) {
  reinterpret_cast<uint4*>(counts)[2 * lane] = make_uint4(0, 0, 0, 0);
  reinterpret_cast<uint4*>(counts)[2 * lane + 1] = make_uint4(0, 0, 0, 0);
}

// A warp sorts its L loaded items (L <= ITEMS * 32) in place, with 256
// counters and the key / position buffers of its own; `varying` holds the
// key bits that are not the same in the whole row (all ^ any of load_keys).
template <int ITEMS, bool kWithPos, bool kFirst>
__device__ __forceinline__ void warp_radix_sort(uint32_t (&key)[ITEMS], uint32_t (&pr)[ITEMS],
                                                unsigned varying, unsigned* counts,
                                                uint32_t* skey, uint16_t* spos, int L, int lane) {
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 8 * pass;
    if (((varying >> shift) & 0xffu) == 0) continue;  // one digit holds the row: order kept
    zero_counts(counts, lane);
    __syncwarp();
    rank_digits<kFirst, ITEMS>(key, pr, counts, shift, L, lane);
    // exclusive scan of the 256 counts in digit order, digits 8l..8l+7 on
    // lane l
    const uint4 lo = reinterpret_cast<const uint4*>(counts)[2 * lane];
    const uint4 hi = reinterpret_cast<const uint4*>(counts)[2 * lane + 1];
    const unsigned c[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    unsigned e[8], sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      e[j] = sum;
      sum += c[j];
    }
    const unsigned before = warp_inclusive_scan(sum, lane) - sum;
    reinterpret_cast<uint4*>(counts)[2 * lane] =
        make_uint4(e[0] + before, e[1] + before, e[2] + before, e[3] + before);
    reinterpret_cast<uint4*>(counts)[2 * lane + 1] =
        make_uint4(e[4] + before, e[5] + before, e[6] + before, e[7] + before);
    __syncwarp();
    scatter<ITEMS, kWithPos, false, kFirst>(key, pr, counts, 0, skey, spos, shift, L, lane);
    __syncwarp();
    gather<ITEMS, kWithPos>(key, pr, skey, spos, 0, L, lane);
    __syncwarp();  // the next pass's counters and scatter follow these reads
  }
}

// The block's warps sort a row of L elements, warp w holding the n (<= 0
// for a warp past the row) loaded items of the chunk at c0 = w * ITEMS *
// 32; all / any are the warp's from load_keys.  Every thread of the block
// calls it.  Shared memory: the warps' counters (warp-major, 256 each), 8
// group sums, each warp's AND and OR of its keys (block_header_bytes), then
// the row's key and position buffers.  Returns whether a pass ran, that
// is, whether the key buffer holds the sorted row; kGatherLast false: the
// last pass leaves its result in the buffers alone (the registers keep the
// previous order).
template <int ITEMS, bool kWithPos, bool kFirst, bool kGatherLast = true>
__device__ __forceinline__ bool block_radix_sort(uint32_t (&key)[ITEMS], uint32_t (&pr)[ITEMS],
                                                 unsigned all, unsigned any, unsigned char* smem,
                                                 int L, int n, int c0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  unsigned* counts = reinterpret_cast<unsigned*>(smem);  // [n_warps][256]
  unsigned* group_sum = counts + n_warps * kBuckets;     // [8]
  unsigned* warp_bits = group_sum + 8;                   // [2][n_warps]
  uint32_t* skey = reinterpret_cast<uint32_t*>(smem + block_header_bytes(n_warps));
  uint16_t* spos = reinterpret_cast<uint16_t*>(reinterpret_cast<unsigned char*>(skey) +
                                               align16((size_t)L * 4));
  unsigned* mine = counts + warp * kBuckets;
  if (lane == 0) {
    warp_bits[warp] = all;
    warp_bits[n_warps + warp] = any;
  }
  __syncthreads();
  for (int w = 0; w < n_warps; ++w) {
    all &= warp_bits[w];
    any |= warp_bits[n_warps + w];
  }
  const unsigned varying = all ^ any;  // key bits that are not the same in the whole row
  int last = -1;
  for (int pass = 0; pass < kPasses; ++pass)
    if ((varying >> (8 * pass)) & 0xffu) last = pass;
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 8 * pass;
    if (((varying >> shift) & 0xffu) == 0) continue;  // one digit holds the row: order kept
    zero_counts(mine, lane);
    __syncwarp();
    rank_digits<kFirst, ITEMS>(key, pr, mine, shift, n, lane);
    __syncthreads();  // every warp's counts are in
    if (threadIdx.x < kBuckets) {
      // thread d: digit d's total over the warps, its exclusive scan within
      // the digit's group of 32, and each warp's offset for it: the digits
      // before it in the group, then the warps before that warp
      const int d = threadIdx.x;
      unsigned total = 0;
      for (int w = 0; w < n_warps; ++w) total += counts[w * kBuckets + d];
      const unsigned incl = warp_inclusive_scan(total, lane);
      if (lane == 31) group_sum[warp] = incl;
      unsigned run = incl - total;
      for (int w = 0; w < n_warps; ++w) {
        const unsigned c = counts[w * kBuckets + d];
        counts[w * kBuckets + d] = run;
        run += c;
      }
    }
    __syncthreads();  // offsets and group sums are in
    // lane g < 8 holds the base of digit group g: the sums of groups < g
    const unsigned g = lane < 8 ? group_sum[lane] : 0u;
    const unsigned group_base = warp_inclusive_scan(g, lane) - g;
    scatter<ITEMS, kWithPos, true, kFirst>(key, pr, mine, group_base, skey, spos, shift, n, lane);
    __syncthreads();  // the row is in the buffers
    if (kGatherLast || pass != last) gather<ITEMS, kWithPos>(key, pr, skey, spos, c0, n, lane);
  }
  return last >= 0;
}

}  // namespace radix
