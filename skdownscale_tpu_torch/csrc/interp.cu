// Batched monotone-table interpolation (K6) for Hopper (sm_90a).
//
//     out[b, i] = interp(q[b, i], xp[b, :], fp[b, :])
//
// with np.interp's clamped ends on monotone non-decreasing rows (ragged rows
// padded with +inf knots and the last valid fp), in the semantics of
// interp_ramp (skdownscale_tpu/ops/interp.py):
//   * x0/f0 is the last knot with xp <= q (ties resolve to the last tie),
//     x1/f1 the first knot with xp > q; -inf / +inf where there is none;
//   * x0, x1 are clipped to [-big, big] and f1 above at big,
//     big = FLT_MAX / 8;
//   * a zero-width interval has slope 0;
//   * the value is evaluated from the nearer knot,
//     use_right = (q - x0) > (x1 - q);
//   * q < xp[0] gives fp[0], then q > xp[L-1] gives fp[L-1].
// A NaN query gives the query itself.  NaN knots follow interp_ramp's
// reductions, which carry any NaN of a row's xp or fp into the bracket of
// every query: a row whose xp or fp holds a NaN gives NaN (0x7fc00000) for
// every non-NaN query that the two end clamps do not catch.  (The TPU
// kernel's min-update skips a NaN knot instead; the port follows
// interp_ramp.)  Each of xp, fp and q takes a row stride; 0 means one row
// shared by every output row (the plotting-position vector of the quantile
// paths).
//
// It replaces batched_interp of skdownscale_tpu/ops/pallas/interp_kernel.py,
// which runs a scan over the knots with rows on the TPU's lanes.
//
// What bounds it on the H100: it reads each table row and query once and
// writes each output once, about log2(L) + 15 operations a query, so the
// bytes bound it (config 8's fut block, 6,144 rows of 3,650 knots, values
// and queries: 0.36 GB, 0.107 ms at 3.35 TB/s).  The kernel this replaces
// took a block a row and searched the row in device memory: a NaN scan
// read it once, then each query's binary search made about 12 dependent
// loads that L1 served only while the row stayed there (up to 8 blocks an
// SM want 234 KB of rows at L = 3,650), with nothing overlapping one row's
// loads and the previous row's searches.
//
// Design: a persistent grid (as many blocks as fit on the card, each
// walking rows b, b + gridDim.x, ...) that stages each row's xp, fp and
// queries in shared memory, double-buffered: while the block searches row
// r, cp.async brings row r + gridDim.x into the other buffers, so neither
// the table's nor the queries' latency is paid a row.  A row shared by
// every output row (stride 0) is staged once a block.  A row starts at any
// 4-byte boundary (L = 3,650 or 1,462 rows are not 16-byte aligned), so it
// is staged at the same offset modulo 16 bytes in shared memory: the
// aligned middle goes as 16-byte copies, the head and tail as 4-byte ones.
// Each thread takes the NaN flag from the knots it staged itself, and one
// __syncthreads_or combines them and releases the row.  Each query then
// finds #{l : xp[l] <= q} by a binary search in shared memory (float
// compares, so -0 == +0, and +inf pads are knots like any other) and
// applies the closed form.  The staged route takes 512 threads a block
// where shared memory holds two blocks an SM (config 8: 0.2614 ms against
// 0.3475 with 256 on an H100 80GB HBM3 at 700 W, chip_smoke.py --trials).
//
// The route through device memory (a block a row, a thread a query, the
// row searched through L1) stays for rows too long to stage twice (227 KB
// a block: above about 9,000 knots and queries with all three per row), and
// for rows short enough that L1 holds the per-row tables of every resident
// block (at most 128 KB together): there L1 serves the searches, and the
// staged route's copies and two barriers a row cost more than they save
// (config 9b: 0.5241 ms through device memory against 0.5650 staged, the
// same card and script).
//
// The long-row route, for rows of L >= SDT_K6_LONG_MIN knots (a choice by
// length alone, mirrored by kernels/interp.LONG_ROW_MIN).  On the
// device-memory route one block would scan such a row for NaN and then run
// every search alone: config G's pooled ladder, one row of 239,206,400
// knots and 2,048 queries, took 382.9 ms there against a 0.57 ms bound.
// This route makes two launches on the caller's stream:
//   1. a grid-wide NaN reduction: a few blocks an SM, each striding over
//      chunks of kScanChunk knots of every long row's xp and fp (a shared
//      table, stride 0, once), 16-byte loads of the chunk's aligned middle,
//      kScanUnroll in flight a thread; a chunk that holds a NaN sets its
//      row's flag by atomicOr in an int32 workspace of rows + 1 flags (the
//      last for the shared tables) that the wrapper allocates and zeroes on
//      the stream;
//   2. the search, a block per (row, chunk of kLongThreads queries), a
//      thread a query: the binary search of device memory (28 steps at
//      2.4e8 knots, the top of the tree shared by every query in L2) and
//      the closed form, with ends_of / upper_bound / finish as on the other
//      routes, so the bits are the same.
// The scan moves the row's 1.91 GB at the card's memory rate; the searches
// are some 28 dependent loads a query, spread over the card.  On an H100
// 80GB HBM3 at 700 W (chip_smoke.py --trials interp) the ladder row took
// 0.6152 ms (384.2379 by one block), and mesh G's merged sketch row of
// 32,768 knots 0.0347 ms (0.0417 by one block), which sets SDT_K6_LONG_MIN.
//
// The closed form is written with __fsub_rn / __fmul_rn / __fadd_rn /
// __fdiv_rn so that nvcc does not contract it into FMAs: the plain PyTorch
// version runs each operation as its own kernel, and the two are held
// bitwise equal.
//
// The C entry point takes plain pointers, sizes, strides and the CUDA
// stream, launches on that stream without synchronising, and returns
// cudaGetLastError(); sdt_interp_geometry reports the launch it would take.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

// Trial switches (chip_smoke.py --trials builds and times each against
// the default): the route (0: chosen by size, 1: staged wherever it fits,
// 2: device memory at every shape) and the staged route's threads a block
// (0: chosen by residency, else that many at every shape).
#ifndef SDT_K6_ROUTE
#define SDT_K6_ROUTE 0
#endif
#ifndef SDT_K6_THREADS
#define SDT_K6_THREADS 0
#endif
// rows of at least this many knots take the long-row route; 0: no such route
// (kernels/interp.LONG_ROW_MIN mirrors it)
#ifndef SDT_K6_LONG_MIN
#define SDT_K6_LONG_MIN 32768
#endif

constexpr int kMaxThreads = 512;  // the staged route's largest block
// the per-row table bytes that the device-memory route's resident blocks
// may hold in L1 together before rows are staged instead (of the SM's 256 KB
// of L1 and shared memory)
constexpr size_t kL1RowBytes = 128 * 1024;

// a row's first and last knots and values
struct Ends {
  float x_first, f_first, x_last, f_last;
};

__device__ __forceinline__ Ends ends_of(const float* xr, const float* fr, int L) {
  return {xr[0], fr[0], xr[L - 1], fr[L - 1]};
}

// The interp of query qi, given lo = #{l : xr[l] <= qi}, against a row (in
// shared or device memory) whose NaN flag is has_nan.
__device__ __forceinline__ float finish(const float* xr, const float* fr, int L, Ends e, float qi,
                                        int lo, bool has_nan) {
  if (isnan(qi)) return qi;
  if (qi > e.x_last) return e.f_last;
  if (qi < e.x_first) return e.f_first;
  if (has_nan) return __int_as_float(0x7fc00000);
  const float inf = __int_as_float(0x7f800000);
  const float big = FLT_MAX / 8.0f;
  const float x0 = lo > 0 ? xr[lo - 1] : -inf;
  const float f0 = lo > 0 ? fr[lo - 1] : -inf;
  const float x1 = lo < L ? xr[lo] : inf;
  const float f1 = lo < L ? fr[lo] : inf;
  const float x0c = x0 < -big ? -big : (x0 > big ? big : x0);
  const float x1c = x1 < -big ? -big : (x1 > big ? big : x1);
  const float f1c = f1 > big ? big : f1;
  const float dx = __fsub_rn(x1c, x0c);
  float slope = __fdiv_rn(__fsub_rn(f1c, f0), dx != 0.0f ? dx : 1.0f);
  if (!(dx != 0.0f)) slope = 0.0f;
  const float from_left = __fsub_rn(qi, x0c);
  const bool use_right = from_left > __fsub_rn(x1c, qi);
  return use_right ? __fadd_rn(f1c, __fmul_rn(__fsub_rn(qi, x1c), slope))
                   : __fadd_rn(f0, __fmul_rn(from_left, slope));
}

// #{l < L : xr[l] <= q}, for ascending xr.  The midpoint is lo + (hi - lo)
// / 2: lo + hi overflows int for a row above 2^30 knots.
__device__ __forceinline__ int upper_bound(const float* xr, int L, float q) {
  int lo = 0, hi = L;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (xr[mid] <= q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// out[i] = interp(qr[i]) for the row's Q queries, a query a thread
__device__ __forceinline__ void interp_row(const float* xr, const float* fr, int L,
                                           const float* qr, float* __restrict__ orow, int Q,
                                           bool has_nan) {
  const Ends e = ends_of(xr, fr, L);
  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    const float qi = qr[i];
    const bool search = !(isnan(qi) || qi > e.x_last || qi < e.x_first || has_nan);
    orow[i] = finish(xr, fr, L, e, qi, search ? upper_bound(xr, L, qi) : 0, has_nan);
  }
}

// -- the route through device memory (rows too long to stage, or short
// enough for L1) --------------------------------------------------------------

__global__ void batched_interp_global_kernel(const float* __restrict__ xp,
                                             const float* __restrict__ fp,
                                             const float* __restrict__ q,
                                             float* __restrict__ out, int L, int Q,
                                             int64_t xp_stride, int64_t fp_stride,
                                             int64_t q_stride) {
  const int64_t row = blockIdx.x;
  const float* xr = xp + row * xp_stride;
  const float* fr = fp + row * fp_stride;
  const float* qr = q + row * q_stride;
  float* orow = out + row * (int64_t)Q;
  int has_nan = 0;
  for (int l = threadIdx.x; l < L; l += blockDim.x) has_nan |= isnan(xr[l]) | isnan(fr[l]);
  has_nan = __syncthreads_or(has_nan);
  interp_row(xr, fr, L, qr, orow, Q, has_nan);
}

// -- the long-row route -------------------------------------------------------

constexpr int kScanThreads = 256;
constexpr int kScanUnroll = 4;  // 16-byte loads in flight a thread
constexpr int kScanChunk = kScanThreads * kScanUnroll * 4;  // knots a block takes at a time
constexpr int kScanBlocksPerSm = 8;
constexpr int kLongThreads = 128;  // queries a search block

// Whether src[0, n) holds a NaN, on this thread's share: the aligned middle
// as float4 loads, kScanUnroll issued before any is tested, the head and
// tail as floats.  n <= kScanChunk.
__device__ __forceinline__ bool chunk_has_nan(const float* __restrict__ src, int n) {
  const int head = min(n, (int)((16 - ((uintptr_t)src & 15)) & 15) >> 2);
  const int n4 = (n - head) >> 2;
  const int tail = n - head - 4 * n4;
  const int t = threadIdx.x;
  bool nan = (t < head && isnan(src[t])) || (t < tail && isnan(src[head + 4 * n4 + t]));
  const float4* v = reinterpret_cast<const float4*>(src + head);
  float4 r[kScanUnroll];
#pragma unroll
  for (int u = 0; u < kScanUnroll; ++u) {
    const int i = t + u * kScanThreads;
    r[u] = i < n4 ? v[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int u = 0; u < kScanUnroll; ++u) nan |= isnan(r[u].x) | isnan(r[u].y) | isnan(r[u].z) | isnan(r[u].w);
  return nan;
}

// Launch 1: flags[r] |= 1 when row r of xp or fp holds a NaN; flags[rows]
// for a table shared by every row (stride 0), scanned once.  Segment s <
// nx is row s of xp, the rest the rows of fp.
__global__ void __launch_bounds__(kScanThreads)
    long_row_nan_kernel(const float* __restrict__ xp, const float* __restrict__ fp,
                        int* __restrict__ flags, int64_t rows, int L, int64_t xp_stride,
                        int64_t fp_stride) {
  const int64_t nx = xp_stride == 0 ? 1 : rows;
  const int64_t nf = fp_stride == 0 ? 1 : rows;
  const int64_t per_row = (L + (int64_t)kScanChunk - 1) / kScanChunk;
  const int64_t total = (nx + nf) * per_row;
  for (int64_t c = blockIdx.x; c < total; c += gridDim.x) {  // block-uniform
    const int64_t seg = c / per_row;
    const int64_t k0 = (c - seg * per_row) * kScanChunk;
    const bool is_x = seg < nx;
    const int64_t r = is_x ? seg : seg - nx;
    const int64_t stride = is_x ? xp_stride : fp_stride;
    const float* src = (is_x ? xp : fp) + r * stride + k0;
    const bool nan = chunk_has_nan(src, (int)min((int64_t)kScanChunk, L - k0));
    if (__syncthreads_or(nan) && threadIdx.x == 0) atomicOr(&flags[stride == 0 ? rows : r], 1);
  }
}

// Launch 2: block b searches queries [chunk * kLongThreads, ...) of row
// b / chunks, a thread a query.
__global__ void __launch_bounds__(kLongThreads)
    long_row_search_kernel(const float* __restrict__ xp, const float* __restrict__ fp,
                           const float* __restrict__ q, float* __restrict__ out,
                           const int* __restrict__ flags, int64_t rows, int L, int Q,
                           int64_t xp_stride, int64_t fp_stride, int64_t q_stride) {
  const int64_t chunks = (Q + kLongThreads - 1) / kLongThreads;
  const int64_t row = blockIdx.x / chunks;
  const int i = (int)(blockIdx.x - row * chunks) * kLongThreads + threadIdx.x;
  if (i >= Q) return;
  const float* xr = xp + row * xp_stride;
  const float* fr = fp + row * fp_stride;
  const bool has_nan = (flags[row] | flags[rows]) != 0;
  const Ends e = ends_of(xr, fr, L);
  const float qi = q[row * q_stride + i];
  const bool search = !(isnan(qi) || qi > e.x_last || qi < e.x_first || has_nan);
  out[row * (int64_t)Q + i] = finish(xr, fr, L, e, qi, search ? upper_bound(xr, L, qi) : 0, has_nan);
}

// -- the staged route ---------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// waits until at most one group (the row being prefetched) is in flight
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// the element offset of src within its 16-byte line: a row is staged at
// buf + offset, so that src and its copy share their 16-byte alignment
__device__ __forceinline__ int line_offset(const float* src) {
  return (int)(((uintptr_t)src >> 2) & 3);
}

// words of one staged row: the row, its offset, rounded up to 16 bytes
__host__ __device__ __forceinline__ int staged_words(int L) { return (L + 3 + 3) & ~3; }

// Requests the copy of src[0, L) to buf[a, a + L), a = line_offset(src), by
// this thread's share of the 16-byte lines: 16-byte copies for whole lines,
// 4-byte copies for the partial first and last ones.  With scan, instead
// of copying, returns whether this thread's share (already in buf) holds
// a NaN.
template <bool kScan>
__device__ __forceinline__ bool stage_row(float* buf, const float* src, int L) {
  const int a = line_offset(src);
  const float* line = src - a;  // 16-byte aligned; read only from element a on
  const int lines = (a + L + 3) >> 2;
  bool nan = false;
  for (int c = threadIdx.x; c < lines; c += blockDim.x) {
    const int e0 = 4 * c;
    if (e0 >= a && e0 + 4 <= a + L) {
      if (kScan) {
        const float4 v = *reinterpret_cast<const float4*>(buf + e0);
        nan |= isnan(v.x) | isnan(v.y) | isnan(v.z) | isnan(v.w);
      } else {
        cp_async16(buf + e0, line + e0);
      }
    } else {
      const int e1 = min(e0 + 4, a + L);
      for (int e = max(e0, a); e < e1; ++e) {
        if (kScan) nan |= isnan(buf[e]);
        else cp_async4(buf + e, line + e);
      }
    }
  }
  return nan;
}

// Shared memory: xp's two buffers (one when xp is shared), then fp's, then
// q's.
__global__ void __launch_bounds__(kMaxThreads)
    batched_interp_staged_kernel(const float* __restrict__ xp, const float* __restrict__ fp,
                                 const float* __restrict__ q, float* __restrict__ out,
                                 int64_t rows, int L, int Q, int64_t xp_stride,
                                 int64_t fp_stride, int64_t q_stride) {
  extern __shared__ __align__(16) float smem[];
  const int Ls = staged_words(L), Qs = staged_words(Q);
  const bool x_shared = xp_stride == 0, f_shared = fp_stride == 0, q_shared = q_stride == 0;
  float* const xbuf = smem;
  float* const fbuf = xbuf + (x_shared ? 1 : 2) * Ls;
  float* const qbuf = fbuf + (f_shared ? 1 : 2) * Ls;
  int64_t row = blockIdx.x;
  if (row >= rows) return;  // the grid is at most rows; no barrier skipped

  // group 0: the shared rows and the first row
  stage_row<false>(xbuf, xp + row * xp_stride, L);
  stage_row<false>(fbuf, fp + row * fp_stride, L);
  stage_row<false>(qbuf, q + row * q_stride, Q);
  cp_async_commit();
  bool shared_nan = false;
  for (int it = 0; row < rows; ++it, row += gridDim.x) {
    const int b = it & 1;
    const int64_t next = row + gridDim.x;
    if (next < rows) {
      if (!x_shared) stage_row<false>(xbuf + (b ^ 1) * Ls, xp + next * xp_stride, L);
      if (!f_shared) stage_row<false>(fbuf + (b ^ 1) * Ls, fp + next * fp_stride, L);
      if (!q_shared) stage_row<false>(qbuf + (b ^ 1) * Qs, q + next * q_stride, Q);
    }
    cp_async_commit();
    cp_async_wait_one();  // this row's copies (and the shared rows) are in
    const float* xsrc = xp + row * xp_stride;
    const float* fsrc = fp + row * fp_stride;
    const float* qsrc = q + row * q_stride;
    float* xb = xbuf + (x_shared ? 0 : b * Ls);
    float* fb = fbuf + (f_shared ? 0 : b * Ls);
    bool nan = false;
    if (it == 0) {  // a shared table's flag is taken once
      if (x_shared) shared_nan |= stage_row<true>(xb, xsrc, L);
      if (f_shared) shared_nan |= stage_row<true>(fb, fsrc, L);
    }
    if (!x_shared) nan |= stage_row<true>(xb, xsrc, L);
    if (!f_shared) nan |= stage_row<true>(fb, fsrc, L);
    const bool has_nan = __syncthreads_or(nan | shared_nan);  // also: every copy is visible
    const float* xr = xb + line_offset(xsrc);
    const float* fr = fb + line_offset(fsrc);
    const float* qr = qbuf + (q_shared ? 0 : b * Qs) + line_offset(qsrc);
    float* orow = out + row * (int64_t)Q;
    interp_row(xr, fr, L, qr, orow, Q, has_nan);
    __syncthreads();  // the buffers of this row are refilled next
  }
}

size_t staged_bytes(int L, int Q, bool x_shared, bool f_shared, bool q_shared) {
  return ((size_t)((x_shared ? 1 : 2) + (f_shared ? 1 : 2)) * staged_words(L) +
          (size_t)(q_shared ? 1 : 2) * staged_words(Q)) *
         sizeof(float);
}

enum Route { kDeviceMemory = 0, kStaged = 1, kLongRow = 2 };

struct Geometry {
  Route route;
  int threads;
  size_t smem;
  int blocks_per_sm;
  int64_t grid;
};

// The route and shape of a launch.  The device-memory route takes a block
// a row, a thread a query (at most 256).  Rows are staged when they fit
// twice in a block's shared memory and the per-row tables of the
// device-memory route's resident blocks would not fit kL1RowBytes of L1
// together (config 9b's rows of 1,462 do, and L1 serves their searches
// faster than staging; config 8's of 3,650 knots and values do not).  The
// staged route takes 256 or 512 threads a block, whichever keeps more
// warps resident (512 where shared memory holds only two blocks an SM).
cudaError_t plan_launch(int64_t rows, int L, int Q, bool x_shared, bool f_shared, bool q_shared,
                        Geometry* g) {
  int dev, optin, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (SDT_K6_LONG_MIN > 0 && L >= SDT_K6_LONG_MIN) {
    // the search grid; blocks_per_sm and smem describe the scan
    const int64_t chunks = ((int64_t)Q + kLongThreads - 1) / kLongThreads;
    if (rows * chunks > 0x7fffffff) return cudaErrorInvalidValue;
    g->route = kLongRow;
    g->threads = kLongThreads;
    g->smem = 0;
    g->blocks_per_sm = kScanBlocksPerSm;
    g->grid = rows * chunks;
    return cudaSuccess;
  }
  int threads = ((Q + 31) / 32) * 32;
  threads = threads < 64 ? 64 : threads > 256 ? 256 : threads;
  int global_blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&global_blocks, batched_interp_global_kernel,
                                                      threads, 0);
  if (err != cudaSuccess) return err;
  const size_t row_bytes = ((x_shared ? 0 : 1) + (f_shared ? 0 : 1)) * (size_t)L * sizeof(float);
  const size_t smem = staged_bytes(L, Q, x_shared, f_shared, q_shared);
  const bool fits = smem <= (size_t)optin;
  const bool staged = fits && (SDT_K6_ROUTE == 1 ||
                               (SDT_K6_ROUTE == 0 && row_bytes * global_blocks > kL1RowBytes));
  g->route = staged ? kStaged : kDeviceMemory;
  if (!staged) {
    g->threads = threads;
    g->smem = 0;
    g->blocks_per_sm = global_blocks;
    g->grid = rows;
    return cudaSuccess;
  }
  g->smem = smem;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(batched_interp_staged_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int best_warps = -1;
  for (int t = 256; t <= kMaxThreads; t *= 2) {
    if (SDT_K6_THREADS && t != SDT_K6_THREADS) continue;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, batched_interp_staged_kernel, t,
                                                        smem);
    if (err != cudaSuccess) return err;
    if (blocks * t / 32 > best_warps) {
      best_warps = blocks * t / 32;
      g->threads = t;
      g->blocks_per_sm = blocks;
    }
  }
  const int64_t resident = (int64_t)g->blocks_per_sm * sms;
  g->grid = rows < resident ? rows : resident;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// flags: rows + 1 zeroed int32 on the stream where the rows take the
// long-row route (L >= sdt_interp_long_min()), else unused (may be null).
int sdt_batched_interp(const float* xp, const float* fp, const float* q,
                       float* out, int* flags, int64_t rows, int L, int Q,
                       int64_t xp_stride, int64_t fp_stride, int64_t q_stride,
                       void* stream) {
  if (rows <= 0 || rows > 0x7fffffff || L <= 0 || Q <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Geometry g;
  cudaError_t err = plan_launch(rows, L, Q, xp_stride == 0, fp_stride == 0, q_stride == 0, &g);
  if (err != cudaSuccess) return (int)err;
  if (g.route == kLongRow) {
    if (flags == nullptr) return (int)cudaErrorInvalidValue;
    int dev, sms;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const int64_t per_row = (L + (int64_t)kScanChunk - 1) / kScanChunk;
    const int64_t work = ((xp_stride == 0 ? 1 : rows) + (fp_stride == 0 ? 1 : rows)) * per_row;
    const int64_t scan_grid = work < (int64_t)kScanBlocksPerSm * sms ? work : (int64_t)kScanBlocksPerSm * sms;
    long_row_nan_kernel<<<(unsigned)scan_grid, kScanThreads, 0, (cudaStream_t)stream>>>(
        xp, fp, flags, rows, L, xp_stride, fp_stride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    long_row_search_kernel<<<(unsigned)g.grid, g.threads, 0, (cudaStream_t)stream>>>(
        xp, fp, q, out, flags, rows, L, Q, xp_stride, fp_stride, q_stride);
  } else if (g.route == kStaged) {
    batched_interp_staged_kernel<<<(unsigned)g.grid, g.threads, g.smem, (cudaStream_t)stream>>>(
        xp, fp, q, out, rows, L, Q, xp_stride, fp_stride, q_stride);
  } else {
    batched_interp_global_kernel<<<(unsigned)rows, g.threads, 0, (cudaStream_t)stream>>>(
        xp, fp, q, out, L, Q, xp_stride, fp_stride, q_stride);
  }
  return (int)cudaGetLastError();
}

// The launch these sizes take, launching nothing: res = [route (0 device
// memory, 1 staged, 2 long row), threads a block, shared bytes a block,
// resident blocks an SM, blocks in the grid]; on the long-row route the
// last three describe the scan's blocks an SM and the search's grid.
int sdt_interp_geometry(int64_t rows, int L, int Q, int x_shared, int f_shared, int q_shared,
                        int64_t* res) {
  if (rows <= 0 || rows > 0x7fffffff || L <= 0 || Q <= 0) return (int)cudaErrorInvalidValue;
  Geometry g;
  const cudaError_t err = plan_launch(rows, L, Q, x_shared != 0, f_shared != 0, q_shared != 0, &g);
  if (err != cudaSuccess) return (int)err;
  const int64_t vals[5] = {(int64_t)g.route, g.threads, (int64_t)g.smem, g.blocks_per_sm, g.grid};
  for (int i = 0; i < 5; ++i) res[i] = vals[i];
  return 0;
}

// SDT_K6_LONG_MIN of this build: rows of at least this many knots take the
// long-row route (0: none do).
int sdt_interp_long_min() { return SDT_K6_LONG_MIN; }

const char* sdt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
