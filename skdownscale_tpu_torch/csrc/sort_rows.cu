// Row sort, stable row sort with positions, and unsort (K9) for Hopper
// (sm_90a).
//
// Replaces sort_rows, sort_rows_with_positions and unsort_rows of
// skdownscale_tpu/ops/pallas/sort_kernel.py (an in-VMEM bitonic network on
// rows laid across the TPU's lanes), on row-major (B, L) float32 arrays.
//
// Keys.  Each float becomes the 32-bit key ordered_ukey: the
// order-isomorphic int32 key of ops/keys.py (sort_kernel.py:60-73) with its
// sign bit flipped, so the unsigned order is the total order
// -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN.  Every float has a key of
// its own, so the sorted keys mapped back are the sorted values, bitwise.
//
// Sort: a stable LSD radix sort, four passes of 8-bit digits, low digit
// first, with the position as a 16-bit payload (L <= 8,192 < 2^16) widened
// to int32 at the store.  A pass puts each item at (items of smaller digit)
// + (items of its digit before it), so ties keep their order; the input is
// in position order, so the positions come out as those of a STABLE sort,
// torch.sort(keys, stable=True), with no padding and no tie-break folded
// into the key.  The TPU kernel pads its rows to a power of two with the
// key INT32_MAX, which is also the key of the NaN whose bits are
// 0x7fffffff, and its network is not stable, so it can return a pad position
// >= L (ROADMAP F8).
//
// Items live in registers, warp-striped: item i of lane l is element
// i*32 + l of its warp's chunk of the row, so (i, l) order is position order
// within the chunk, and the chunks follow each other in warp order.  A pass:
//   1. each warp ranks its items among its own by digit.  The lanes that
//      hold the same digit in item i (its peers) come from 8 ballots, as
//      cub's MatchAny computes them; the lowest peer adds their number to the
//      warp's 256 counters in shared memory and hands the old count to the
//      others, and each adds the peers on lower lanes.  Per-thread packed
//      counters, cub's other ranking, would take 256 x 32 x 2 B = 16 KB a
//      warp at 8-bit digits.  __match_any_sync gives the same peers in one
//      instruction; on the card neither was the faster at every shape, and
//      the ballots are what cub runs;
//   2. an exclusive scan of the counters in (digit, warp) order gives each
//      warp its base per digit;
//   3. each item goes to base + rank in a shared buffer of keys (4 B) and
//      positions (2 B), and every lane reads its items back striped.
// A pass whose byte is the same in every key of the row would keep the
// order, so it is skipped, ranking included: the AND and the OR of the
// row's keys, taken at the load, differ in no bit of that byte.
// Temperatures near 283 K share their top byte, and an all-equal row skips
// every pass.  The final order is stored from registers, striped, so the
// stores are coalesced.
//
// Two shapes of the one sort, chosen by L in the launcher (a route by shape;
// both are this kernel):
// * L <= 1,024: a warp a row, four rows a block, ceil(L / 128) * 4 items a
//   lane.  Each warp has its own slice of shared memory (counters, keys,
//   positions), so a pass has only __syncwarp and no block barrier.  Rows of
//   304 (monthly MBCn) and 620 (daily fit windows) take this shape.
// * 1,024 < L <= 8,192: a block a row, 8 to 16 warps, each holding a
//   contiguous chunk of 4, 12 or 16 items a lane (a warp past the row holds
//   none).  One __syncthreads after the load and three a pass that is not
//   skipped (counters in, scan done, scatter done): thirteen at most.
//   Config 8's rows of 3,650 take 10 warps of 12 items a lane.
//
// Unsort.  The positions of a row are a permutation of 0..L-1, so the
// unsort is a scatter through shared memory: read positions and values
// coalesced, write smem[pos[i]] = vals[i], then write the row out
// coalesced.  A position outside [0, L) is skipped, so nothing is written
// outside the row.  It moves its compulsory 12 B an element once and ran at
// 1.7x its bound, so it stays as it was.
//
// What bounds them on the H100.  The compulsory traffic is 8 B an element
// for the sort (12 with positions), 0.05-0.08 ms at config 8's (6144, 3650)
// rows.  The bitonic network this replaces did 78 stages over 4,096 8-byte
// words a row, about 5.1 MB of shared-memory traffic, with a block barrier
// a stage.  The radix sort moves each element through shared memory once a
// pass (4 + 2 B written and read, about 175 KB a row of 3,650 in four
// passes) and spends some 60 warp instructions a pass on each 32 items (8
// ballots and their masks, the counter update, the scatter and the
// read-back); the counter updates and the scatter land on random banks.  So
// instruction issue, shared-memory bank conflicts and their latency bound
// it, hidden as far as the resident warps allow, far above the bytes.  TMA
// is not used: a row of 3,650 floats is 14,600 B, not a multiple of 16, and
// the compulsory bytes are a small part of the time.
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

namespace {

constexpr int kMaxLen = 8192;      // K9_MAX_LEN of kernels/sort_rows.py
constexpr int kMaxThreads = 1024;  // the unsort's block
constexpr int kWarpRouteMaxLen = 1024;
constexpr int kRowsPerBlock = 4;  // warps (rows) a block on the warp route
constexpr int kBlockRouteMaxWarps = 16;
constexpr int kBuckets = 256;
constexpr int kPasses = 4;
constexpr unsigned kFull = 0xffffffffu;

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
  return align16(((size_t)n_warps * kBuckets + 8 + 2 * kBlockRouteMaxWarps) * 4);
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

__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned v, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const unsigned t = __shfl_up_sync(kFull, v, s);
    if (lane >= s) v += t;
  }
  return v;
}

// Loads a warp's chunk of n elements starting at src (none if n <= 0),
// striped, as keys; an element past the chunk gets key 0xffffffff and is
// never stored.
// The high half of pr[i] is the element's position in the row (c0 + index).
// all / any: the AND / OR of the chunk's keys, on every lane.
template <int ITEMS>
__device__ __forceinline__ void load_chunk(const float* __restrict__ src, int n, int c0, int lane,
                                           uint32_t (&key)[ITEMS], uint32_t (&pr)[ITEMS],
                                           unsigned& all, unsigned& any) {
  all = kFull;
  any = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = i * 32 + lane;
    key[i] = j < n ? ordered_ukey(src[j]) : 0xffffffffu;
    pr[i] = (uint32_t)(c0 + j) << 16;
    all &= key[i];
    any |= j < n ? key[i] : 0u;
  }
  all = __reduce_and_sync(kFull, all);
  any = __reduce_or_sync(kFull, any);
}

// Counts the digits (key >> shift) & 255 of the warp's n items into
// counts[256] (zeroed by the caller) and sets the low half of pr[i] to the
// item's rank among the warp's items of its digit that come before it in
// (i, l) order.
template <int ITEMS>
__device__ __forceinline__ void rank_digits(const uint32_t (&key)[ITEMS], uint32_t (&pr)[ITEMS],
                                            unsigned* counts, int shift, int n, int lane) {
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int left = n - i * 32;
    if (left <= 0) break;  // the same for every lane
    const unsigned valid = left >= 32 ? kFull : (1u << left) - 1u;
    const unsigned d = (key[i] >> shift) & 0xffu;
    const unsigned peers = peers_of(d) & valid;
    const int first = __ffs(peers) - 1;  // -1 for a lane past the chunk
    unsigned before = 0;
    if (lane == first) before = atomicAdd(&counts[d], (unsigned)__popc(peers));
    before = __shfl_sync(kFull, before, first & 31);
    pr[i] = (pr[i] & 0xffff0000u) | (before + __popc(peers & below));
    __syncwarp();  // the next item's counter updates see this one's
  }
}

// Stores each of the warp's n items at offsets[digit] (+ the base of the
// digit's group of 32, held by lane digit >> 5 in group_base, on the block
// route) + its rank, into the row's key and position buffers.
template <int ITEMS, bool kWithPos, bool kGroupBase>
__device__ __forceinline__ void scatter(const uint32_t (&key)[ITEMS], const uint32_t (&pr)[ITEMS],
                                        const unsigned* offsets, unsigned group_base,
                                        uint32_t* skey, uint16_t* spos, int shift, int n,
                                        int lane) {
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (i * 32 >= n) break;
    const unsigned d = (key[i] >> shift) & 0xffu;
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

__device__ __forceinline__ void zero_counts(unsigned* counts, int lane) {
  reinterpret_cast<uint4*>(counts)[2 * lane] = make_uint4(0, 0, 0, 0);
  reinterpret_cast<uint4*>(counts)[2 * lane + 1] = make_uint4(0, 0, 0, 0);
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
  const int64_t base = row * L;

  uint32_t key[ITEMS], pr[ITEMS];
  unsigned all, any;
  load_chunk<ITEMS>(x + base, L, 0, lane, key, pr, all, any);
  const unsigned varying = all ^ any;  // key bits that are not the same in the whole row
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 8 * pass;
    if (((varying >> shift) & 0xffu) == 0) continue;  // one digit holds the row: order kept
    zero_counts(counts, lane);
    __syncwarp();
    rank_digits<ITEMS>(key, pr, counts, shift, L, lane);
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
    scatter<ITEMS, kWithPos, false>(key, pr, counts, 0, skey, spos, shift, L, lane);
    __syncwarp();
    gather<ITEMS, kWithPos>(key, pr, skey, spos, 0, L, lane);
    __syncwarp();  // the next pass's counters and scatter follow these reads
  }
  store_chunk<ITEMS, kWithPos>(key, pr, out + base, kWithPos ? pos_out + base : nullptr, 0, L,
                               lane);
}

// Block route: block b sorts row b (1,024 < L <= 8,192) with blockDim.x / 32
// warps, 8 to 16, warp w holding elements [w * ITEMS * 32, (w + 1) * ITEMS *
// 32) of the row (none for a warp past it).  Shared memory: the
// warps' counters (warp-major, 256 each), 8 group sums, each warp's AND and
// OR of its keys, then the row's key and position buffers.
template <bool kWithPos, int ITEMS>
__global__ void __launch_bounds__(32 * kBlockRouteMaxWarps)
    sort_rows_block_kernel(const float* __restrict__ x, float* __restrict__ out,
                           int32_t* __restrict__ pos_out, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  unsigned* counts = reinterpret_cast<unsigned*>(smem);  // [n_warps][256]
  unsigned* group_sum = counts + n_warps * kBuckets;     // [8]
  unsigned* warp_bits = group_sum + 8;                   // [2][kBlockRouteMaxWarps]
  uint32_t* skey = reinterpret_cast<uint32_t*>(smem + block_header_bytes(n_warps));
  uint16_t* spos = reinterpret_cast<uint16_t*>(reinterpret_cast<unsigned char*>(skey) +
                                               align16((size_t)L * 4));
  unsigned* mine = counts + warp * kBuckets;
  const int64_t base = (int64_t)blockIdx.x * L;
  const int c0 = warp * ITEMS * 32;
  const int n = min(ITEMS * 32, L - c0);  // <= 0 for a warp past the row

  uint32_t key[ITEMS], pr[ITEMS];
  unsigned all, any;
  load_chunk<ITEMS>(x + base + c0, n, c0, lane, key, pr, all, any);
  if (lane == 0) {
    warp_bits[warp] = all;
    warp_bits[kBlockRouteMaxWarps + warp] = any;
  }
  __syncthreads();
  for (int w = 0; w < n_warps; ++w) {
    all &= warp_bits[w];
    any |= warp_bits[kBlockRouteMaxWarps + w];
  }
  const unsigned varying = all ^ any;  // key bits that are not the same in the whole row
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 8 * pass;
    if (((varying >> shift) & 0xffu) == 0) continue;  // one digit holds the row: order kept
    zero_counts(mine, lane);
    __syncwarp();
    rank_digits<ITEMS>(key, pr, mine, shift, n, lane);
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
    scatter<ITEMS, kWithPos, true>(key, pr, mine, group_base, skey, spos, shift, n, lane);
    __syncthreads();  // the row is in the buffers
    gather<ITEMS, kWithPos>(key, pr, skey, spos, c0, n, lane);
  }
  store_chunk<ITEMS, kWithPos>(key, pr, out + base, kWithPos ? pos_out + base : nullptr, c0, n,
                               lane);
}

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

// Items a lane, chosen by L.  The warp route takes the least multiple of 4
// that holds the row (registers are sized by it).  The block route takes 4
// items a lane up to 2,048, 12 up to 4,096 and 16 up to 8,192, 8 to 16
// warps: at config 8's 3,650, 10 warps of 12 items ran faster on the card
// than 15 of 8 or 8 of 16.
template <bool kWithPos>
int launch_sort(const float* x, float* out, int32_t* pos, int64_t B, int L, void* stream) {
  if (B <= 0 || L <= 0 || L > kMaxLen || B > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
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

}  // namespace

extern "C" {

int sdt_sort_rows(const float* x, float* out, int64_t B, int L, void* stream) {
  return launch_sort<false>(x, out, nullptr, B, L, stream);
}

int sdt_sort_rows_with_positions(const float* x, float* out, int32_t* pos, int64_t B, int L,
                                 void* stream) {
  return launch_sort<true>(x, out, pos, B, L, stream);
}

int sdt_unsort_rows(const float* vals, const int32_t* pos, float* out, int64_t B, int L,
                    void* stream) {
  if (B <= 0 || L <= 0 || L > kMaxLen || B > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)L * sizeof(float);
  cudaError_t err = allow_smem(unsort_rows_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  unsort_rows_kernel<<<(unsigned)B, block_threads(L), smem, (cudaStream_t)stream>>>(vals, pos, out, L);
  return (int)cudaGetLastError();
}

const char* sdt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
