// Row sort, stable row sort with positions, and unsort (K9) for Hopper
// (sm_90a).
//
// Replaces sort_rows, sort_rows_with_positions and unsort_rows of
// skdownscale_tpu/ops/pallas/sort_kernel.py (an in-VMEM bitonic network on
// rows laid across the TPU's lanes).  Here one thread block owns one row of a
// row-major (B, L) float32 array.
//
// Sort (with or without positions).  The block loads its row into dynamic
// shared memory as one 64-bit word per element,
//     word = (ordered key ^ 0x80000000) << 32 | position,
// where the ordered key is the order-isomorphic int32 key of the float
// (ops/keys.py; sort_kernel.py:60-73), so the unsigned word order is the
// total order -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN, ties broken
// by position.  The row is padded to Lp, the next power of two, with
// (INT32_MAX, position >= L), which sorts after every real element, a NaN
// whose key is INT32_MAX included.  A bitonic network over Lp runs in shared
// memory with a barrier between stages.  Every word is distinct, so the
// result is the one sorted order of the words: the values come out bitwise
// equal to a sort of the ordered keys, and the positions equal those of a
// STABLE sort.  (The TPU kernel leaves tie order unspecified, and its pads
// tie with such a NaN, so it can return a pad position >= L; ROADMAP F8.)
//
// Unsort.  The positions of a row are a permutation of 0..L-1, so the
// unsort is a scatter through shared memory: read positions and values
// coalesced, write smem[pos[i]] = vals[i], then write the row out
// coalesced.  A position outside [0, L) is skipped, so nothing is written
// outside the row.
//
// What bounds them on the H100: the compulsory traffic is 8 bytes an
// element for the sort (12 with positions, 12 for the unsort), 0.05-0.08 ms
// at MBCn's (6144, 3650) rows.  The sort does far more work than that: a
// bitonic network over Lp = 4096 has 78 stages of Lp/2 compare-exchanges,
// each reading and writing 8-byte words in shared memory, with a block-wide
// barrier after each, so shared-memory traffic and barriers bound it, tens
// of times above the bytes.  This first design keeps every device-memory
// access coalesced and the network in shared memory; doing the stages of
// stride < 32 in registers with warp shuffles, 32-bit keys with a separate
// position array, and several short rows a block are left for later work.
//
// The C entry points take plain pointers, sizes and the CUDA stream, launch
// on that stream without synchronising, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLen = 8192;  // K9_MAX_LEN of kernels/sort_rows.py
constexpr int kMaxThreads = 1024;

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

template <bool kWithPos>
__global__ void sort_rows_kernel(const float* __restrict__ x,
                                 float* __restrict__ out,
                                 int32_t* __restrict__ pos_out, int L, int Lp) {
  extern __shared__ unsigned long long words[];
  const int64_t base = (int64_t)blockIdx.x * L;
  const float* src = x + base;
  for (int t = threadIdx.x; t < Lp; t += blockDim.x) {
    const uint32_t key = t < L ? ordered_ukey(src[t]) : 0xFFFFFFFFu;
    words[t] = ((unsigned long long)key << 32) | (uint32_t)t;
  }
  __syncthreads();
  const int half = Lp >> 1;
  for (int k = 2; k <= Lp; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));  // lower member of the pair
        const int p = i + j;
        const unsigned long long a = words[i];
        const unsigned long long b = words[p];
        const bool ascending = (i & k) == 0;
        if ((a > b) == ascending) {
          words[i] = b;
          words[p] = a;
        }
      }
      __syncthreads();
    }
  }
  float* dst = out + base;
  for (int t = threadIdx.x; t < L; t += blockDim.x) {
    const unsigned long long w = words[t];
    dst[t] = ukey_to_float((uint32_t)(w >> 32));
    if (kWithPos) pos_out[base + t] = (int32_t)(uint32_t)w;
  }
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

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
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

template <bool kWithPos>
int launch_sort(const float* x, float* out, int32_t* pos, int64_t B, int L, void* stream) {
  if (B <= 0 || L <= 0 || L > kMaxLen || B > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int Lp = next_pow2(L);
  const size_t smem = (size_t)Lp * sizeof(unsigned long long);
  cudaError_t err = allow_smem(sort_rows_kernel<kWithPos>, smem);
  if (err != cudaSuccess) return (int)err;
  sort_rows_kernel<kWithPos><<<(unsigned)B, block_threads(Lp / 2), smem, (cudaStream_t)stream>>>(
      x, out, pos, L, Lp);
  return (int)cudaGetLastError();
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
