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
// digits, low digit first, with the position as a 16-bit payload (L <=
// 8,192 < 2^16) widened to int32 at the store.  The input is in position
// order, so the positions come out as those of a STABLE sort,
// torch.sort(keys, stable=True), with no padding and no tie-break folded
// into the key.  The TPU kernel pads its rows to a power of two with the
// key INT32_MAX, which is also the key of the NaN whose bits are
// 0x7fffffff, and its network is not stable, so it can return a pad position
// >= L (ROADMAP F8).  A pass whose byte is the same in every key of the row
// is skipped: temperatures near 283 K share their top byte, and an
// all-equal row skips every pass.  The final order is stored from
// registers, striped, so the stores are coalesced.
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

#include "radix_sort.cuh"

namespace {

using namespace radix;

constexpr int kMaxLen = 8192;      // K9_MAX_LEN of kernels/sort_rows.py
constexpr int kMaxThreads = 1024;  // the unsort's block
constexpr int kRowsPerBlock = 4;  // warps (rows) a block on the warp route

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
