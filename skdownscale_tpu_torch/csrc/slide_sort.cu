// Sliding sorted window (K5) for Hopper (sm_90a).
//
// Replaces slide_sorted_windows (skdownscale_tpu/ops/pallas/slide_sort_kernel.py).
// The daily BCSD predict consults n_windows overlapping fit windows (31
// +-15-day day-of-year windows); adjacent windows share all but one leaving
// and one entering day-bucket.  For each cell this kernel sorts window 0
// once and then slides: each step removes the leaving keys by value and
// merges the entering keys in.  Row s of a cell's output holds window s's
// values in ascending order of their order-isomorphic int32 keys
// (-NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN), then +inf up to Lto;
// rows n_windows..n_rows-1 are all +inf.  A key equal to INT32_MAX (the pad
// key, also the key of the NaN 0x7fffffff) is written as +inf, as the TPU
// kernel does.
//
// Design: one thread block per cell, the window in shared memory, double
// buffered (two int32 arrays of P2 = next power of two >= Wp: 8 KB at
// Wp = 648), plus the two sorted buckets (BW keys each) and the leaving
// keys' positions.
//   window 0   gather its keys from the cell's row of y, pad with INT32_MAX
//              to P2 and bitonic-sort in shared memory (sorted inside the
//              kernel: no separate sort launch and no int64 index tensor);
//   each step  1. gather the two buckets and rank-sort each (one thread per
//                 key, stable count over BW keys);
//              2. place every leaving key r_k at
//                     pos_k = #{W <= r_k} - #{R <= r_k} + k
//                 (binary searches in the sorted W and R).  This is exact for
//                 multisets: tied leaving keys take the last copies of their
//                 value, and copies are indistinguishable;
//              3. a survivor at p goes to p - #{pos < p} + #{A < W[p]}, an
//                 entering a_k to u - #{pos < u} + k with u = #{W <= a_k}:
//                 the compaction and the merge are one scatter into the
//                 other buffer (survivors stay before equal entering keys);
//              then the new window's first Lto keys go out with coalesced
//              writes.
//   Each phase ends in __syncthreads().  The window's size n is tracked as
//   a count, so nothing depends on the pad key's place in the order.
//
// What bounds it on the H100: the output, n_rows * Lto * 4 bytes per cell
// (32 x 624 x 4 B = 80 KB per cell, 2.6 GB at 32,768 cells, 0.78 ms at
// 3.35 TB/s), against about 2 x n_windows x BW gathered reads and, per step,
// about Lt x (log2 BW + log2 BW) shared-memory reads of binary searches per
// cell.  The searches and the four barriers a step are the likely bound;
// register-resident windows, several cells per block and TMA gathers are
// left for later work.
//
// The C entry point takes plain pointers, sizes and the CUDA stream,
// launches on that stream without synchronising, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kPad = INT32_MAX;
constexpr int kThreads = 256;

__device__ __forceinline__ int32_t ordered_key(float v) {
  const int32_t b = __float_as_int(v);
  return b >= 0 ? b : (~b) ^ INT32_MIN;
}

__device__ __forceinline__ float out_value(int32_t k) {
  if (k == kPad) return __int_as_float(0x7f800000);
  const int32_t b = k >= 0 ? k : ~(k ^ INT32_MIN);
  return __int_as_float(b);
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
__device__ __forceinline__ int upper_bound(const int32_t* a, int n, int32_t v) {
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

__device__ __forceinline__ void write_row(float* dst, const int32_t* w, int n, int Lto) {
  for (int j = threadIdx.x; j < Lto; j += blockDim.x)
    dst[j] = j < n ? out_value(w[j]) : __int_as_float(0x7f800000);
}

__global__ void __launch_bounds__(kThreads)
slide_sorted_windows_kernel(const float* __restrict__ y, int64_t T,
                            const int32_t* __restrict__ w0_idx, int Wp, int P2,
                            const int32_t* __restrict__ add_idx,
                            const int32_t* __restrict__ rem_idx, int BW,
                            int n_windows, int Lto, int n_rows,
                            float* __restrict__ out) {
  extern __shared__ int32_t smem[];
  int32_t* W = smem;         // current window, ascending, n keys
  int32_t* nxt = W + P2;     // next window
  int32_t* raw = nxt + P2;   // 2*BW: leaving then entering keys as gathered
  int32_t* rem = raw + 2 * BW;  // BW: leaving keys, ascending
  int32_t* add = rem + BW;      // BW: entering keys, ascending
  int32_t* pos = add + BW;      // BW: positions of the leaving keys in W

  const int tid = threadIdx.x;
  const float* yc = y + (int64_t)blockIdx.x * T;
  float* oc = out + (int64_t)blockIdx.x * n_rows * Lto;

  // -- window 0: gather, pad, bitonic sort ---------------------------------
  int n = count_members(w0_idx, Wp);
  for (int i = tid; i < P2; i += blockDim.x) {
    const int32_t t = i < n ? w0_idx[i] : -1;
    W[i] = t >= 0 ? ordered_key(yc[t]) : kPad;
  }
  for (int k = 2; k <= P2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      __syncthreads();
      for (int i = tid; i < P2; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const int32_t a = W[i], b = W[ixj];
          if ((a > b) == ((i & k) == 0)) {
            W[i] = b;
            W[ixj] = a;
          }
        }
      }
    }
  }
  __syncthreads();
  write_row(oc, W, n, Lto);

  // -- slide ------------------------------------------------------------
  for (int s = 1; s < n_windows; ++s) {
    const int32_t* ri = rem_idx + (int64_t)(s - 1) * BW;
    const int32_t* ai = add_idx + (int64_t)(s - 1) * BW;
    const int nr = count_members(ri, BW);
    const int na = count_members(ai, BW);

    // 1. gather both buckets, then rank-sort each
    if (tid < 2 * BW) {
      const int32_t t = tid < BW ? ri[tid] : ai[tid - BW];
      raw[tid] = t >= 0 ? ordered_key(yc[t]) : kPad;
    }
    __syncthreads();
    if (tid < 2 * BW) {
      const int base = tid < BW ? 0 : BW;
      const int i = tid - base;
      const int32_t v = raw[tid];
      int r = 0;
      for (int j = 0; j < BW; ++j) {
        const int32_t u = raw[base + j];
        r += (u < v) | ((u == v) & (j < i));
      }
      (tid < BW ? rem : add)[r] = v;
    }
    __syncthreads();

    // 2. position of each leaving key's copy in W
    if (tid < nr) {
      const int32_t v = rem[tid];
      pos[tid] = upper_bound(W, n, v) - upper_bound(rem, nr, v) + tid;
    }
    __syncthreads();

    // 3. compact and merge in one scatter
    for (int p = tid; p < n; p += blockDim.x) {
      const int d = lower_bound(pos, nr, p);
      if (d < nr && pos[d] == p) continue;  // leaves the window
      const int32_t v = W[p];
      nxt[p - d + lower_bound(add, na, v)] = v;
    }
    if (tid < na) {
      const int32_t v = add[tid];
      const int u = upper_bound(W, n, v);
      nxt[u - lower_bound(pos, nr, u) + tid] = v;
    }
    n = n - nr + na;
    __syncthreads();

    write_row(oc + (int64_t)s * Lto, nxt, n, Lto);
    int32_t* t = W;
    W = nxt;
    nxt = t;
  }

  for (int s = n_windows; s < n_rows; ++s) write_row(oc + (int64_t)s * Lto, W, 0, Lto);
}

}  // namespace

extern "C" {

int sdt_slide_sorted_windows(const float* y, int64_t C, int64_t T, const int32_t* w0_idx,
                             int Wp, const int32_t* add_idx, const int32_t* rem_idx, int BW,
                             int n_windows, int Lto, int n_rows, float* out, void* stream) {
  if (C <= 0 || C > INT32_MAX || T <= 0 || Wp <= 0 || BW <= 0 || 2 * BW > kThreads ||
      n_windows <= 0 || n_rows < n_windows || Lto <= 0)
    return (int)cudaErrorInvalidValue;
  int P2 = 1;
  while (P2 < Wp) P2 <<= 1;
  const size_t smem = (size_t)(2 * P2 + 5 * BW) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        slide_sorted_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  slide_sorted_windows_kernel<<<(unsigned)C, kThreads, smem, (cudaStream_t)stream>>>(
      y, T, w0_idx, Wp, P2, add_idx, rem_idx, BW, n_windows, Lto, n_rows, out);
  return (int)cudaGetLastError();
}

const char* sdt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
