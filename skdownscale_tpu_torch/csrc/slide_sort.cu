// Sliding sorted window (K5) for Hopper (sm_90a).
//
// Replaces slide_sorted_windows (skdownscale_tpu/ops/pallas/slide_sort_kernel.py).
// The daily BCSD predict consults n_windows overlapping fit windows (31
// +-15-day day-of-year windows); adjacent windows share all but one leaving
// and one entering day-bucket.  For each cell this kernel sorts window 0
// once and then slides: each step removes the leaving keys by value and
// merges the entering keys in.  Row s of a cell's output holds window s's
// values in ascending order of their order-isomorphic keys
// (-NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN), then +inf up to Lto;
// rows n_windows..n_rows-1 are all +inf.  A key equal to the pad key (the
// int32 key INT32_MAX, which is also the key of the NaN 0x7fffffff) is
// written as +inf, as the TPU kernel does.  Keys here are radix_sort.cuh's
// unsigned ordered_ukey, in which the pad key is 0xffffffff.
//
// Design: a warp per cell, kCellsPerBlock cells a block, and no block
// barrier.  Each warp keeps its cell's window in shared memory, ascending,
// double-buffered (2 x Wp keys: 5.2 KB at config 5's Wp = 648), and its
// size n as a count, so nothing depends on the pad key's place in the
// order.
//   window 0   gathered from the cell's series and sorted by the warp radix
//              sort of radix_sort.cuh (the one K9 runs); the sorted keys
//              land in the window buffer;
//   each step  1. the leaving and entering buckets (BW <= 128 keys each,
//                 one to four a lane) are gathered and sorted in registers
//                 by a bitonic network of shuffles, then kept in a small
//                 scratch of shared memory (the other resident warps hide
//                 the gathers' latency: loading them a step ahead costs
//                 registers and a resident block, and ran slower);
//              2. lane k places leaving key r_k at
//                     pos_k = #{W <= r_k} - #{R <= r_k} + k
//                 by one search in W and one in R.  This is exact for
//                 multisets: tied leaving keys take the last copies of their
//                 value, and copies are indistinguishable;
//              3. each lane owns a contiguous strip of the merged sequence
//                 of W (removed keys included) and the entering keys A.  One
//                 merge-path search finds where its strip starts in W and A
//                 (W first on ties), one search in pos counts the removed
//                 keys before it, and the lane then walks its strip,
//                 advancing the two counts and the next removed position
//                 instead of searching for each key, and writes each kept
//                 key to its place in the other buffer;
//              4. the new window goes out as one row of 16-byte streaming
//                 stores (Lto x 4 = 2,496 B at config 5), +inf past n.
//   Only __syncwarp separates the phases.
// Windows longer than 1,024 keys (plans of more than about 32 years of
// daily data) do not fit the warp sort's registers: a cell then takes a
// block, whose warps sort window 0 together with radix_sort.cuh's block
// sort, after which warp 0 alone slides.
//
// What bounds it on the H100: the output, n_rows * Lto * 4 bytes per cell
// (80 KB a cell, 2.6 GB at config 5's 32,768 cells: 0.78 ms of the 1.07 ms
// bound at 3.35 TB/s, the series' read the rest).  The kernel this replaces
// took a 256-thread block a cell, sorted window 0 by a 55-stage block
// bitonic network, and ran every step in four __syncthreads() phases with
// two dependent binary searches a survivor; barriers and those searches,
// not bytes, set its time.  Here a step costs the warp some 500-1,000
// instructions (counted from the code: the two bucket networks, one search
// a leaving key, one merge-path search and a walk of about 21 keys a lane,
// five 16-byte stores a lane), so the steps' issue and latency and the
// window-0 sort share the time with the stores: 2.3292 ms at config 5,
// 2.2x the bound, 1.12 TB/s written (H100 80GB HBM3 at 700 W,
// chip_smoke.py).  Registers set the resident warps: the launch bounds ask
// for 6 blocks an SM (80 registers at 24 window-0 keys a lane, no spills;
// without the floor 102 registers leave 4 blocks and 2.9 ms).
//
// The C entry point takes plain pointers, sizes and the CUDA stream,
// launches on that stream without synchronising, and returns
// cudaGetLastError(); sdt_slide_geometry reports the launch it would take.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "radix_sort.cuh"

namespace {

using namespace radix;

// Trial switches (chip_smoke.py --trials builds and times each against
// the default): cells a block on the warp route, whether the buckets are
// loaded a step ahead (their 16 registers cost a resident block an SM),
// and the floor on resident blocks an SM of the warp route's launch bounds
// up to 24 window-0 keys a lane, which caps the registers (6: 80 a thread,
// no spills at 24 keys; none: 102, 4 blocks an SM).
#ifndef SDT_K5_CELLS_PER_BLOCK
#define SDT_K5_CELLS_PER_BLOCK 4
#endif
#ifndef SDT_K5_PREFETCH
#define SDT_K5_PREFETCH 0
#endif
#ifndef SDT_K5_MIN_BLOCKS
#define SDT_K5_MIN_BLOCKS 6
#endif

constexpr uint32_t kPadKey = 0xffffffffu;  // ordered_ukey of the int32 pad key INT32_MAX
constexpr int kCellsPerBlock = SDT_K5_CELLS_PER_BLOCK;  // warps (cells) a block on the warp route
constexpr int kMaxBW = 128;                // bucket width the kernel takes
constexpr int kMaxSlots = kMaxBW / 32;     // bucket keys a lane
constexpr int kMaxWp = 16384;              // window width the block route's sort holds

// the float of key k (ukey_to_float's map: flip the sign bit of a
// non-negative float's key, every bit of a negative one's), +inf for the
// pad key
__device__ __forceinline__ float out_value(uint32_t k) {
  const uint32_t bits = k ^ (~(uint32_t)((int32_t)k >> 31) | 0x80000000u);
  return k == kPadKey ? __int_as_float(0x7f800000) : __uint_as_float(bits);
}

// number of leading non-negative entries of a row listing its members
// first and its -1 pads after them
__device__ __forceinline__ int count_members(const int32_t* idx, int width) {
  int lo = 0, hi = width;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (idx[mid] >= 0) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #{i < n : a[i] <= v} for ascending a
__device__ __forceinline__ int upper_bound(const uint32_t* a, int n, uint32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #{i < n : a[i] < v} for ascending a
__device__ __forceinline__ int lower_bound(const int32_t* a, int n, int32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// bucket keys a lane: 1, 2 or 4 (the bitonic network wants a power of two)
__host__ __device__ __forceinline__ int bucket_slots(int BW) {
  return BW <= 32 ? 1 : BW <= 64 ? 2 : 4;
}

__device__ __forceinline__ void compare_swap(uint32_t& a, uint32_t& b, bool ascending) {
  if ((a > b) == ascending) {
    const uint32_t t = a;
    a = b;
    b = t;
  }
}

// Sorts the warp's 32*K keys ascending, key e = r*32 + lane in v[r]
// (K = 1, 2 or 4; slots r >= K hold kPadKey and are never paired with a
// used one), by a bitonic network: distances below 32 through shuffles, 32
// and 64 between a lane's own slots.
__device__ __forceinline__ void warp_bitonic(uint32_t (&v)[kMaxSlots], int K, int lane) {
  const int n = 32 * K;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 64) {
        compare_swap(v[0], v[2], (lane & k) == 0);
        compare_swap(v[1], v[3], ((32 + lane) & k) == 0);
      } else if (j == 32) {
        compare_swap(v[0], v[1], (lane & k) == 0);
        compare_swap(v[2], v[3], ((64 + lane) & k) == 0);
      } else {
        const bool lower = (lane & j) == 0;
#pragma unroll
        for (int r = 0; r < kMaxSlots; ++r) {
          if (r < K) {
            const uint32_t o = __shfl_xor_sync(kFull, v[r], j);
            const bool ascending = ((r * 32 + lane) & k) == 0;
            v[r] = (lower == ascending) ? min(v[r], o) : max(v[r], o);
          }
        }
      }
    }
  }
}

// The same network for K = 1, unrolled, on two buckets at once (a and b,
// one key a lane each).
__device__ __forceinline__ void warp_bitonic32x2(uint32_t& a, uint32_t& b, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const uint32_t oa = __shfl_xor_sync(kFull, a, j);
      const uint32_t ob = __shfl_xor_sync(kFull, b, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      a = keep_min ? min(a, oa) : max(a, oa);
      b = keep_min ? min(b, ob) : max(b, ob);
    }
  }
}

// Writes one output row of Lto values: the window's n keys, then +inf;
// 16-byte streaming stores when vec (Lto % 4 == 0 and dst 16-byte
// aligned).  w is 16-byte aligned and readable up to n rounded up to 4.
__device__ __forceinline__ void write_row(float* __restrict__ dst, const uint32_t* w, int n,
                                          int Lto, bool vec, int lane) {
  const float inf = __int_as_float(0x7f800000);
  if (vec) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int q = lane; q < (Lto >> 2); q += 32) {
      const int j = 4 * q;
      float4 v = make_float4(inf, inf, inf, inf);
      if (j + 3 < n) {
        const uint4 k = reinterpret_cast<const uint4*>(w)[q];
        v = make_float4(out_value(k.x), out_value(k.y), out_value(k.z), out_value(k.w));
      } else if (j < n) {  // the quad where the window ends
        const uint4 k = reinterpret_cast<const uint4*>(w)[q];
        v.x = out_value(k.x);
        if (j + 1 < n) v.y = out_value(k.y);
        if (j + 2 < n) v.z = out_value(k.z);
      }
      __stcs(d4 + q, v);
    }
  } else {
    for (int j = lane; j < Lto; j += 32) dst[j] = j < n ? out_value(w[j]) : inf;
  }
}

// One step's bucket indices: the leaving (ri) and entering (ai) members of
// step s, one a slot, -1 past the row or past the last step.
__device__ __forceinline__ void load_indices(const int32_t* __restrict__ rem_idx,
                                             const int32_t* __restrict__ add_idx, int BW, int K,
                                             int s, int n_windows, int lane,
                                             int32_t (&ri)[kMaxSlots], int32_t (&ai)[kMaxSlots]) {
#pragma unroll
  for (int r = 0; r < kMaxSlots; ++r) {
    const int e = r * 32 + lane;
    const bool in = r < K && e < BW && s < n_windows;
    const int64_t at = (int64_t)(s - 1) * BW + e;
    ri[r] = in ? rem_idx[at] : -1;
    ai[r] = in ? add_idx[at] : -1;
  }
}

// The keys of a step's members (kPadKey for a pad) and their counts.
__device__ __forceinline__ void load_keys_of(const float* __restrict__ yc,
                                             const int32_t (&ri)[kMaxSlots],
                                             const int32_t (&ai)[kMaxSlots],
                                             uint32_t (&rv)[kMaxSlots], uint32_t (&av)[kMaxSlots],
                                             int& nr, int& na) {
  nr = 0;
  na = 0;
#pragma unroll
  for (int r = 0; r < kMaxSlots; ++r) {
    rv[r] = ri[r] >= 0 ? ordered_ukey(yc[ri[r]]) : kPadKey;
    av[r] = ai[r] >= 0 ? ordered_ukey(yc[ai[r]]) : kPadKey;
    nr += __popc(__ballot_sync(kFull, ri[r] >= 0));
    na += __popc(__ballot_sync(kFull, ai[r] >= 0));
  }
}

// Slides one cell's window over steps 1..n_windows-1, starting from the
// sorted window 0 (n keys) in W, writing each new window's row of oc.  One
// warp; N is the other window buffer, scratch holds 3 * 32 * K words.
__device__ __forceinline__ void slide(const float* __restrict__ yc, uint32_t* W, uint32_t* N,
                                      uint32_t* scratch, int n,
                                      const int32_t* __restrict__ add_idx,
                                      const int32_t* __restrict__ rem_idx, int BW, int n_windows,
                                      int Lto, bool vec, float* __restrict__ oc, int lane) {
  const int K = bucket_slots(BW);
  uint32_t* R = scratch;                               // leaving keys, ascending
  uint32_t* A = scratch + 32 * K;                      // entering keys, ascending
  int32_t* P = reinterpret_cast<int32_t*>(A + 32 * K);  // leaving keys' places in W

  int32_t ri[kMaxSlots], ai[kMaxSlots];
#if SDT_K5_PREFETCH
  uint32_t rv[kMaxSlots], av[kMaxSlots];
  int nr_next, na_next;
  load_indices(rem_idx, add_idx, BW, K, 1, n_windows, lane, ri, ai);
  load_keys_of(yc, ri, ai, rv, av, nr_next, na_next);
  load_indices(rem_idx, add_idx, BW, K, 2, n_windows, lane, ri, ai);
#endif

  for (int s = 1; s < n_windows; ++s) {
    uint32_t rk[kMaxSlots], ak[kMaxSlots];
    int nr, na;
#if SDT_K5_PREFETCH
    // this step's keys; then the next step's keys and the one after's
    // indices are requested, to arrive while this step runs
#pragma unroll
    for (int r = 0; r < kMaxSlots; ++r) {
      rk[r] = rv[r];
      ak[r] = av[r];
    }
    nr = nr_next;
    na = na_next;
    load_keys_of(yc, ri, ai, rv, av, nr_next, na_next);
    load_indices(rem_idx, add_idx, BW, K, s + 2, n_windows, lane, ri, ai);
#else
    load_indices(rem_idx, add_idx, BW, K, s, n_windows, lane, ri, ai);
    load_keys_of(yc, ri, ai, rk, ak, nr, na);
#endif

    // 1. sort both buckets in registers, keep them in scratch
    if (K == 1) {
      warp_bitonic32x2(rk[0], ak[0], lane);
    } else {
      warp_bitonic(rk, K, lane);
      warp_bitonic(ak, K, lane);
    }
#pragma unroll
    for (int r = 0; r < kMaxSlots; ++r) {
      if (r < K) {
        R[r * 32 + lane] = rk[r];
        A[r * 32 + lane] = ak[r];
      }
    }
    __syncwarp();

    // 2. the place of each leaving key's copy in W.  With one key a lane,
    // #{R <= r_k} is one past the last lane that holds r_k (R is sorted).
    if (K == 1) {
      const unsigned members = nr >= 32 ? kFull : (1u << nr) - 1u;
      const unsigned same = __match_any_sync(kFull, rk[0]) & members;
      if (lane < nr) P[lane] = upper_bound(W, n, rk[0]) - (32 - __clz(same)) + lane;
    } else {
#pragma unroll
      for (int r = 0; r < kMaxSlots; ++r) {
        const int e = r * 32 + lane;
        if (r < K && e < nr) P[e] = upper_bound(W, n, rk[r]) - upper_bound(R, nr, rk[r]) + e;
      }
    }
    __syncwarp();

    // 3. each lane walks its strip of the merged (W, A) sequence
    const int M = n + na;
    const int per = (M + 31) >> 5;
    const int o0 = min(lane * per, M), o1 = min(o0 + per, M);
    int i = max(0, o0 - na), hi = min(o0, n);
    while (i < hi) {  // merge path: W's keys among the first o0, W first on ties
      const int mid = (i + hi) >> 1;
      if (W[mid] <= A[o0 - 1 - mid]) i = mid + 1; else hi = mid;
    }
    int j = o0 - i;
    int kr = lower_bound(P, nr, i);  // removed keys before W[i]
    int dst = i - kr + j;
    // W[n] and A[na] are read but never taken: the buffers hold n + BW and
    // 32 * K + nr slots
    uint32_t wi = W[i], aj = A[j];
    int pk = kr < nr ? P[kr] : INT_MAX;
    for (int o = o0; o < o1; ++o) {
      const bool take_w = i < n && (j >= na || wi <= aj);
      const bool leaves = take_w && i == pk;
      if (!leaves) N[dst++] = take_w ? wi : aj;
      if (take_w) {
        wi = W[++i];
      } else {
        aj = A[++j];
      }
      if (leaves) {
        ++kr;
        pk = kr < nr ? P[kr] : INT_MAX;
      }
    }
    __syncwarp();
    n = n - nr + na;

    // 4. the new window's row
    write_row(oc + (int64_t)s * Lto, N, n, Lto, vec, lane);
    uint32_t* t = W;
    W = N;
    N = t;
  }
}

// Warp route (kBlockSort false): warp w of block b takes cell b *
// kCellsPerBlock + w; its slice of shared memory holds W, N (Wq words each)
// and a scratch of S words, the warp sort's 256 counters first and the
// slide's buckets after it.  Block route (kBlockSort true): block b takes
// cell b; shared memory is the block sort's header, W (the sort's key
// buffer), N and the slide's scratch.
template <int ITEMS, bool kBlockSort>
__global__ void __launch_bounds__(kBlockSort ? 32 * kBlockRouteMaxWarps : 32 * kCellsPerBlock,
                                  kBlockSort || ITEMS > 24 ? 1 : SDT_K5_MIN_BLOCKS)
    slide_sorted_windows_kernel(const float* __restrict__ y, int64_t C, int64_t T,
                                const int32_t* __restrict__ w0_idx, int Wp,
                                const int32_t* __restrict__ add_idx,
                                const int32_t* __restrict__ rem_idx, int BW, int n_windows,
                                int Lto, int n_rows, bool vec, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Wq = (Wp + 3) & ~3;
  const int S = max(kBuckets, 3 * 32 * bucket_slots(BW));
  const int64_t cell = kBlockSort ? (int64_t)blockIdx.x : (int64_t)blockIdx.x * kCellsPerBlock + warp;
  if (!kBlockSort && cell >= C) return;  // no block barrier follows
  uint32_t* W;
  if (kBlockSort) {
    W = reinterpret_cast<uint32_t*>(smem + block_header_bytes(blockDim.x >> 5));
  } else {
    W = reinterpret_cast<uint32_t*>(smem) + (size_t)warp * (2 * Wq + S);
  }
  uint32_t* N = W + Wq;
  uint32_t* scratch = N + Wq;
  const float* yc = y + cell * T;
  float* oc = out + cell * n_rows * Lto;

  // -- window 0: gather and sort -------------------------------------------
  const int n = count_members(w0_idx, Wp);
  {
    uint32_t key[ITEMS], pr[ITEMS];
    unsigned all, any;
    const int c0 = kBlockSort ? warp * ITEMS * 32 : 0;
    const int m = kBlockSort ? min(ITEMS * 32, n - c0) : n;  // <= 0 past the window
    load_keys<ITEMS>([=](int j) { return ordered_ukey(yc[w0_idx[c0 + j]]); }, m, c0, lane, key,
                     pr, all, any);
    if (kBlockSort) {
      block_radix_sort<ITEMS, false>(key, pr, all, any, smem, n, m, c0);
    } else {
      warp_radix_sort<ITEMS, false>(key, pr, all ^ any, scratch, W, nullptr, n, lane);
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = i * 32 + lane;
      if (j < m) W[c0 + j] = key[i];
    }
    if (kBlockSort) {
      __syncthreads();
      if (warp != 0) return;  // warp 0 slides
    } else {
      __syncwarp();
    }
  }
  write_row(oc, W, n, Lto, vec, lane);

  // -- slide ----------------------------------------------------------------
  slide(yc, W, N, scratch, n, add_idx, rem_idx, BW, n_windows, Lto, vec, oc, lane);

  for (int s = n_windows; s < n_rows; ++s) write_row(oc + (int64_t)s * Lto, W, 0, Lto, vec, lane);
}

using Kernel = void (*)(const float*, int64_t, int64_t, const int32_t*, int, const int32_t*,
                        const int32_t*, int, int, int, int, bool, float*);

struct Launch {
  Kernel kernel;
  bool block_route;
  int threads;          // a block
  int cells_per_block;  // 1 on the block route
  size_t smem;          // bytes a block
  int items;            // window-0 keys a lane
};

// The launch for a plan of window width Wp and bucket width BW.  Warp
// route up to Wp = 1,024: ceil(Wp / 128) * 4 items a lane.  Block route
// above: 4 items a lane up to 2,048, 12 up to 4,096, 16 up to 8,192 and 32
// up to 16,384, 8 to 16 warps (K9's block shapes, and one more).
Launch plan_launch(int Wp, int BW) {
  const int Wq = (Wp + 3) & ~3;
  const int slots = bucket_slots(BW);
  Launch l{};
  if (Wp <= kWarpRouteMaxLen) {
    const int S = kBuckets > 96 * slots ? kBuckets : 96 * slots;
    l.block_route = false;
    l.items = (Wp + 127) / 128 * 4;
    l.threads = 32 * kCellsPerBlock;
    l.cells_per_block = kCellsPerBlock;
    l.smem = (size_t)kCellsPerBlock * (2 * Wq + S) * 4;
    switch (l.items) {
      case 4: l.kernel = slide_sorted_windows_kernel<4, false>; break;
      case 8: l.kernel = slide_sorted_windows_kernel<8, false>; break;
      case 12: l.kernel = slide_sorted_windows_kernel<12, false>; break;
      case 16: l.kernel = slide_sorted_windows_kernel<16, false>; break;
      case 20: l.kernel = slide_sorted_windows_kernel<20, false>; break;
      case 24: l.kernel = slide_sorted_windows_kernel<24, false>; break;
      case 28: l.kernel = slide_sorted_windows_kernel<28, false>; break;
      default: l.kernel = slide_sorted_windows_kernel<32, false>; break;
    }
    return l;
  }
  l.block_route = true;
  l.cells_per_block = 1;
  if (Wp <= 2048) {
    l.items = 4;
    l.kernel = slide_sorted_windows_kernel<4, true>;
  } else if (Wp <= 4096) {
    l.items = 12;
    l.kernel = slide_sorted_windows_kernel<12, true>;
  } else if (Wp <= 8192) {
    l.items = 16;
    l.kernel = slide_sorted_windows_kernel<16, true>;
  } else {
    l.items = 32;
    l.kernel = slide_sorted_windows_kernel<32, true>;
  }
  // at least 8 warps, so that a thread per digit does the block sort's scan
  int n_warps = (Wp + l.items * 32 - 1) / (l.items * 32);
  if (n_warps < kBuckets / 32) n_warps = kBuckets / 32;
  l.threads = 32 * n_warps;
  l.smem = block_header_bytes(n_warps) + (size_t)(2 * Wq + 96 * slots) * 4;
  return l;
}

bool plan_ok(int Wp, int BW) { return Wp > 0 && Wp <= kMaxWp && BW > 0 && BW <= kMaxBW; }

}  // namespace

extern "C" {

int sdt_slide_sorted_windows(const float* y, int64_t C, int64_t T, const int32_t* w0_idx,
                             int Wp, const int32_t* add_idx, const int32_t* rem_idx, int BW,
                             int n_windows, int Lto, int n_rows, float* out, void* stream) {
  if (C <= 0 || C > INT32_MAX || T <= 0 || !plan_ok(Wp, BW) || n_windows <= 0 ||
      n_rows < n_windows || Lto <= 0)
    return (int)cudaErrorInvalidValue;
  const Launch l = plan_launch(Wp, BW);
  if (l.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = (Lto & 3) == 0 && ((uintptr_t)out & 15) == 0;
  const int64_t blocks = (C + l.cells_per_block - 1) / l.cells_per_block;
  l.kernel<<<(unsigned)blocks, l.threads, l.smem, (cudaStream_t)stream>>>(
      y, C, T, w0_idx, Wp, add_idx, rem_idx, BW, n_windows, Lto, n_rows, vec, out);
  return (int)cudaGetLastError();
}

// The launch a plan of these widths takes, launching nothing: res =
// [block route, threads a block, cells a block, shared bytes a block,
// resident blocks an SM, window-0 keys a lane].
int sdt_slide_geometry(int Wp, int BW, int* res) {
  if (!plan_ok(Wp, BW)) return (int)cudaErrorInvalidValue;
  const Launch l = plan_launch(Wp, BW);
  cudaError_t err = cudaSuccess;
  if (l.smem > 48 * 1024)
    err = cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.kernel, l.threads, l.smem);
  if (err != cudaSuccess) return (int)err;
  const int vals[6] = {l.block_route ? 1 : 0, l.threads, l.cells_per_block, (int)l.smem, blocks,
                       l.items};
  for (int i = 0; i < 6; ++i) res[i] = vals[i];
  return 0;
}

const char* sdt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
