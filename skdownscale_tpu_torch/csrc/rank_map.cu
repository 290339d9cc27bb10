// Segment count-sort (K1) and segment rank-map (K2) for Hopper (sm_90a).
//
// Both kernels work on a row-major (B, G*L) float32 array cut into B*G
// contiguous segments of length L: one warp owns one segment.  The warp
// loads its segment into shared memory with coalesced reads; every lane then
// counts, for each of its elements, the segment members that order before
// it (L broadcast reads of shared memory, no bank conflicts), and the
// result goes back with coalesced writes.
//
// K1 replaces count_sort_segments / count_sort_rows
// (skdownscale_tpu/ops/pallas/rank_map_kernel.py).  It counts a STABLE rank
// on order-isomorphic int32 keys,
//     rank_t = #{s : k_s < k_t} + #{s < t : k_s == k_t},
// which is a permutation of 0..L-1, so each key lands in its own slot and
// the TPU kernel's suffix-min fill of tie holes is not needed.  Tied keys
// carry identical bits, so the output is the bitwise sort in the order
// -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN.
//
// K2 replaces rank_map_segments / rank_map_rows (same file).  With float
// compares (-0 == +0, NaN compares false),
//     rank_t = #{s : x_s <= x_t} - 1,   out_t = res[rank_t]  (NaN if -1),
// so tied queries take the run-end rank and a NaN query gives NaN.
//
// What bounds them on the H100: each reads and writes about 4 bytes per
// element per array, and does O(L) compares per element.  By bytes alone
// the main path's (131072, 12*40) float32 array would take about 0.15 ms
// at 3.35 TB/s; its L=40 compares per element, each one shared-memory load
// by every lane, cost more than that, so the compare loop bounds both
// kernels already at L=40, and more so towards L=256 (L^2 compares per
// segment).  The design keeps every device-memory access coalesced and
// the compare loop in shared memory, so the bytes stay at the minimum;
// blocking several elements per lane, or packing several short segments
// per warp (lanes 8-31 idle through the second pass at L=40), is left for
// later work.
//
// The C entry points take plain pointers, sizes and the CUDA stream, launch
// on that stream without synchronising, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ int32_t ordered_key(float v) {
  const int32_t b = __float_as_int(v);
  return b >= 0 ? b : (~b) ^ INT32_MIN;
}

__device__ __forceinline__ float key_to_float(int32_t k) {
  const int32_t b = k >= 0 ? k : ~(k ^ INT32_MIN);
  return __int_as_float(b);
}

__global__ void count_sort_segments_kernel(const float* __restrict__ x,
                                           float* __restrict__ out,
                                           int64_t n_seg, int L) {
  extern __shared__ int32_t smem_i[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t seg = (int64_t)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (seg >= n_seg) return;
  int32_t* keys = smem_i + (size_t)warp * 2 * L;
  int32_t* sorted = keys + L;
  const float* src = x + seg * L;
  for (int t = lane; t < L; t += kWarp) keys[t] = ordered_key(src[t]);
  __syncwarp();
  for (int t = lane; t < L; t += kWarp) {
    const int32_t kt = keys[t];
    int r = 0;
    for (int s = 0; s < L; ++s) {
      const int32_t ks = keys[s];
      r += (ks < kt) | ((ks == kt) & (s < t));
    }
    sorted[r] = kt;
  }
  __syncwarp();
  float* dst = out + seg * L;
  for (int t = lane; t < L; t += kWarp) dst[t] = key_to_float(sorted[t]);
}

__global__ void rank_map_segments_kernel(const float* __restrict__ xq,
                                         const float* __restrict__ res,
                                         float* __restrict__ out,
                                         int64_t n_seg, int L) {
  extern __shared__ float smem_f[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t seg = (int64_t)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (seg >= n_seg) return;
  float* q = smem_f + (size_t)warp * 2 * L;
  float* r = q + L;
  const float* qs = xq + seg * L;
  const float* rs = res + seg * L;
  for (int t = lane; t < L; t += kWarp) {
    q[t] = qs[t];
    r[t] = rs[t];
  }
  __syncwarp();
  float* dst = out + seg * L;
  for (int t = lane; t < L; t += kWarp) {
    const float qt = q[t];
    int c = 0;
    for (int s = 0; s < L; ++s) c += (q[s] <= qt);
    dst[t] = c > 0 ? r[c - 1] : __int_as_float(0x7fc00000);
  }
}

// Warps per block so that a block's shared memory (two L-long 4-byte
// arrays per warp) stays within the 48 KB a block gets without opting in;
// longer segments opt in, up to the H100's 227 KB for one warp.
int warps_per_block(int L) {
  const int per_warp = 2 * L * 4;
  int w = (48 * 1024) / per_warp;
  if (w > 8) w = 8;
  if (w < 1) w = 1;
  return w;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int L, int* wpb, size_t* smem) {
  *wpb = warps_per_block(L);
  *smem = (size_t)(*wpb) * 2 * L * 4;
  if (*smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem);
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

int sdt_count_sort_segments(const float* x, float* out, int64_t n_seg, int L,
                            void* stream) {
  if (n_seg <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  int wpb;
  size_t smem;
  cudaError_t err = prepare(count_sort_segments_kernel, L, &wpb, &smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (n_seg + wpb - 1) / wpb;
  count_sort_segments_kernel<<<(unsigned)blocks, wpb * kWarp, smem,
                               (cudaStream_t)stream>>>(x, out, n_seg, L);
  return (int)cudaGetLastError();
}

int sdt_rank_map_segments(const float* xq, const float* res, float* out,
                          int64_t n_seg, int L, void* stream) {
  if (n_seg <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  int wpb;
  size_t smem;
  cudaError_t err = prepare(rank_map_segments_kernel, L, &wpb, &smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (n_seg + wpb - 1) / wpb;
  rank_map_segments_kernel<<<(unsigned)blocks, wpb * kWarp, smem,
                             (cudaStream_t)stream>>>(xq, res, out, n_seg, L);
  return (int)cudaGetLastError();
}

const char* sdt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
