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
// interp_ramp.)
//
// It replaces batched_interp of skdownscale_tpu/ops/pallas/interp_kernel.py,
// which runs a scan over the knots with rows on the TPU's lanes.  Here one
// block owns one row and one thread one query: the block first reads the
// row's xp and fp once, coalesced, to find NaN knots (which also brings the
// row into L1), then each thread finds its bracket by an upper-bound binary
// search over the row's knots, #{l : xp[l] <= q}, and applies the closed
// form.  Each of xp, fp and q takes a row stride; 0 means one row shared by
// every output row (the plotting-position vector of the quantile paths).
//
// What bounds it on the H100: it reads each table row and query once and
// writes each output once, and does about log2(L) + 15 operations a query,
// so the bytes bound it (at the quantile path's 65,536 rows x 1,462 knots x
// 732 queries, about 0.77 GB, 0.23 ms at 3.35 TB/s).  The binary search's
// dependent loads are served from L1 after the NaN scan; staging the row
// in shared memory is left for later work.
//
// The closed form is written with __fsub_rn / __fmul_rn / __fadd_rn /
// __fdiv_rn so that nvcc does not contract it into FMAs: the plain PyTorch
// version runs each operation as its own kernel, and the two are held
// bitwise equal.
//
// The C entry point takes plain pointers, sizes, strides and the CUDA
// stream, launches on that stream without synchronising, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void batched_interp_kernel(const float* __restrict__ xp,
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
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    has_nan |= isnan(xr[l]) | isnan(fr[l]);
  }
  has_nan = __syncthreads_or(has_nan);

  const float inf = __int_as_float(0x7f800000);
  const float big = FLT_MAX / 8.0f;
  const float x_first = xr[0], f_first = fr[0];
  const float x_last = xr[L - 1], f_last = fr[L - 1];

  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    const float qi = qr[i];
    float r;
    if (isnan(qi)) {
      r = qi;
    } else if (qi > x_last) {
      r = f_last;
    } else if (qi < x_first) {
      r = f_first;
    } else if (has_nan) {
      r = __int_as_float(0x7fc00000);
    } else {
      int lo = 0, hi = L;  // upper bound: lo = #{l : xr[l] <= qi}
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (xr[mid] <= qi) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
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
      r = use_right ? __fadd_rn(f1c, __fmul_rn(__fsub_rn(qi, x1c), slope))
                    : __fadd_rn(f0, __fmul_rn(from_left, slope));
    }
    orow[i] = r;
  }
}

}  // namespace

extern "C" {

int sdt_batched_interp(const float* xp, const float* fp, const float* q,
                       float* out, int64_t rows, int L, int Q,
                       int64_t xp_stride, int64_t fp_stride, int64_t q_stride,
                       void* stream) {
  if (rows <= 0 || rows > 0x7fffffff || L <= 0 || Q <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  int threads = ((Q + 31) / 32) * 32;
  if (threads < 64) threads = 64;
  if (threads > 256) threads = 256;
  batched_interp_kernel<<<(unsigned)rows, threads, 0, (cudaStream_t)stream>>>(
      xp, fp, q, out, L, Q, xp_stride, fp_stride, q_stride);
  return (int)cudaGetLastError();
}

const char* sdt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
