// Fused analog selection and statistics for GARD (K7, K8) on Hopper (sm_90a).
//
// Per query of a cell: the exact k nearest training rows, in the
// lexicographic (squared distance, training index) order of lax.top_k (the
// lower index wins a tie), and then
//   K7 (sdt_pure_analog_stats): PureAnalog's [pred, exceedance_prob,
//      prediction_error] for best / sample / weight / mean analogs, with an
//      optional threshold (skdownscale_tpu/models/gard.py:70-109);
//   K8 (sdt_analog_regression_stats): the weighted-OLS sufficient
//      statistics over the selected analogs that exceed the threshold, in
//      the row order of knn_kernel.py:441-450, and, with a threshold, the
//      exceedance probability of an 8-step ridge-damped Newton logistic fit
//      on the selected analogs (ops/regression.py:logistic_fit with C = 1),
//      1 - sigmoid at the query (predict_proba[:, 0], gard.py:210), 1 where
//      every selected analog exceeds and 0 where none does.
// The caller passes features centred on the cell's training mean (and, for
// K8, the cell's mean of y), so distances are taken from centred features as
// in the JAX package.
//
// They replace pure_analog_stats and analog_regression_stats of
// skdownscale_tpu/ops/pallas/knn_kernel.py.  That kernel selects by 31 + 12
// bit-bisection passes of masked counts, because the TPU's vector unit has
// no per-lane gather; none of that carries over.  Here one warp owns one
// query and a block a tile of queries of one cell:
//   * distances: the direct form sum_j (q_j - t_j)^2 in feature order with
//     __fsub_rn / __fmul_rn / __fadd_rn, so nvcc forms no FMA and the plain
//     PyTorch version (kernels/knn.py), which evaluates the same expression
//     one elementwise operation at a time, gets the same bits and so the same
//     selected set.  The query's n distance patterns stay in the warp's
//     shared memory (14.6 KB at n = 3,650); where they do not fit, every
//     pass recomputes them from the training rows in global memory.
//   * selection: an MSB-first radix select on the non-negative 32-bit
//     patterns, 8-bit digits with a 256-bin histogram per warp in shared
//     memory (warp-aggregated atomics by __match_any_sync), 4 passes over
//     n; then the first (rank - #below) ties in index order by a ballot scan.
//     Best and sample analogs run a second select for their rank r.
//   * the k selected indices are compacted, in index order, into the front
//     of the warp's distance buffer by a ballot prefix count; the statistics
//     and K8's Newton steps read only those k members.  Sums are warp
//     reductions by xor shuffles, which leave every lane with the same bits,
//     so every lane solves the (f+1)x(f+1) Newton step itself (cofactors for
//     f <= 2, an unrolled Cholesky above, as _solve_spd) and no broadcast is
//     needed.  The standard deviation is two-pass over the members.
//
// What bounds it on the H100: at GARD's shape (2,048 cells, n = 3,650,
// m = 365, f = 2, k = 200) the compulsory bytes are about 105 MB (0.03 ms at
// 3.35 TB/s) and the distances about 1.4e10 float32 operations (0.2 ms at
// 67 TFLOP/s), so operations bound it.  This first design spends about six
// passes over n a query (distances, four histograms, the tie scan and the
// compaction), each a chain of shared-memory loads and atomics, so it runs
// far above that bound; cutting passes (compacting the candidates after the
// second digit, fusing the distance pass with the first histogram) is later
// work.
//
// The C entry points take plain pointers, sizes and the CUDA stream, launch
// on that stream without synchronising, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int HIST = 256;
constexpr int MAX_WARPS = 4;
constexpr int MAX_K = 4096;
enum Kind { BEST = 0, SAMPLE = 1, WEIGHT = 2, MEAN = 3 };

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

// index of (a, b), a <= b, in the row-major upper triangle of a P x P matrix
__host__ __device__ constexpr int tri(int a, int b, int P) { return a * (2 * P - a - 1) / 2 + b; }

template <int F>
__device__ __forceinline__ float sq_dist(const float* __restrict__ t, const float (&q)[F]) {
  float d = 0.0f;
#pragma unroll
  for (int c = 0; c < F; ++c) {
    const float diff = __fsub_rn(q[c], t[c]);
    const float sq = __fmul_rn(diff, diff);
    d = c == 0 ? sq : __fadd_rn(d, sq);
  }
  return d;
}

// A query's distances to the n training rows of its cell, as bit patterns
// (non-negative floats compare as their patterns do).
template <int F, bool SMEM>
struct Dist {
  const float* xc;  // the cell's centred training rows (n, F)
  const unsigned* buf;  // SMEM: the n patterns
  float q[F];
  __device__ __forceinline__ unsigned operator()(int j) const {
    if constexpr (SMEM) {
      return buf[j];
    } else {
      return __float_as_uint(sq_dist<F>(xc + (size_t)j * F, q));
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

struct Sel {
  unsigned tau;  // the pattern of the rank-r element
  int jstar;     // its training index: the last selected tie
};

// Rank-r (1-based) element in (pattern, index) order: a radix select on
// 8-bit digits, then a ballot scan for the (r - #below)-th tie.
template <class D>
__device__ Sel select_rank(const D& dist, unsigned* hist, int n, unsigned r, int lane) {
  unsigned prefix = 0u, mask = 0u, remaining = r;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = lane; b < HIST; b += 32) hist[b] = 0u;
    __syncwarp();
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      unsigned v = HIST;  // not a candidate
      if (j < n) {
        const unsigned b = dist(j);
        if ((b & mask) == prefix) v = (b >> shift) & 0xffu;
      }
      const unsigned peers = __match_any_sync(FULL, v);
      if (v != HIST && lane == __ffs(peers) - 1) atomicAdd(&hist[v], (unsigned)__popc(peers));
    }
    __syncwarp();
    // the digit whose bin holds the remaining-th candidate: each lane owns
    // 8 consecutive bins, a warp scan finds the owner lane
    unsigned c[8], s = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      c[i] = hist[lane * 8 + i];
      s += c[i];
    }
    unsigned incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    const unsigned excl = incl - s;
    const int owner = __ffs(__ballot_sync(FULL, excl < remaining && remaining <= incl)) - 1;
    unsigned digit = 0u, before = 0u;
    if (lane == owner) {
      unsigned acc = excl;
      bool found = false;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (!found && acc + c[i] >= remaining) {
          digit = (unsigned)(lane * 8 + i);
          before = acc;
          found = true;
        }
        acc += c[i];
      }
    }
    digit = __shfl_sync(FULL, digit, owner);
    before = __shfl_sync(FULL, before, owner);
    remaining -= before;
    prefix |= digit << shift;
    mask |= 0xffu << shift;
    __syncwarp();
  }
  // the remaining-th element (in index order) whose pattern is prefix
  unsigned seen = 0u;
  int jstar = -1;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    const bool tie = j < n && dist(j) == prefix;
    const unsigned bal = __ballot_sync(FULL, tie);
    const unsigned cnt = __popc(bal);
    if (seen + cnt >= remaining) {
      const unsigned need = remaining - seen;
      const unsigned upto = __popc(bal & ((2u << lane) - 1u));  // set bits at lanes <= lane
      jstar = j0 + __ffs(__ballot_sync(FULL, tie && upto == need)) - 1;
      break;
    }
    seen += cnt;
  }
  return {prefix, jstar};
}

// Writes the k selected training indices, ascending, to idx[0, k).  idx may
// alias the distance buffer: an index lands at or below its own position,
// which every lane of the chunk has read before the ballot.
template <class D>
__device__ void compact(const D& dist, int* idx, int n, int k, Sel s, int lane) {
  unsigned base = 0u;
  for (int j0 = 0; j0 < n && base < (unsigned)k; j0 += 32) {
    const int j = j0 + lane;
    bool sel = false;
    if (j < n) {
      const unsigned b = dist(j);
      sel = b < s.tau || (b == s.tau && j <= s.jstar);
    }
    const unsigned bal = __ballot_sync(FULL, sel);
    if (sel) idx[base + __popc(bal & ((1u << lane) - 1u))] = j;
    base += __popc(bal);
  }
  __syncwarp();
}

// Sets up the warp's query: its distance source, with the n patterns
// written to shared memory first when they fit there.
template <int F, bool SMEM>
__device__ Dist<F, SMEM> load_query(const float* xc_cell, const float* q_row, unsigned* buf, int n, int lane) {
  Dist<F, SMEM> dist;
  dist.xc = xc_cell;
  dist.buf = buf;
#pragma unroll
  for (int c = 0; c < F; ++c) dist.q[c] = q_row[c];
  if constexpr (SMEM) {
    for (int j = lane; j < n; j += 32) buf[j] = __float_as_uint(sq_dist<F>(xc_cell + (size_t)j * F, dist.q));
    __syncwarp();
  }
  return dist;
}

template <int F, bool SMEM>
__global__ void __launch_bounds__(32 * MAX_WARPS)
pure_analog_kernel(const float* __restrict__ xc, const float* __restrict__ y,
                   const float* __restrict__ xq, const int* __restrict__ rand,
                   float* __restrict__ out, int n, int m, int k, int kind,
                   int has_thresh, float thresh, int tiles, int buf_len) {
  extern __shared__ unsigned smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t cell = blockIdx.x / tiles;
  const int qi = (int)(blockIdx.x % tiles) * warps + warp;
  if (qi >= m) return;  // the whole warp: no block-wide barrier follows
  unsigned* hist = smem + (size_t)warp * (HIST + buf_len);
  unsigned* buf = hist + HIST;
  const int64_t q_at = cell * m + qi;
  const float* xc_cell = xc + cell * n * F;
  const float* y_cell = y + cell * n;
  const Dist<F, SMEM> dist = load_query<F, SMEM>(xc_cell, xq + q_at * F, buf, n, lane);

  const Sel sk = select_rank(dist, hist, n, (unsigned)k, lane);
  float pred = 0.0f;
  if (kind == BEST || kind == SAMPLE) {
    int r = kind == SAMPLE ? rand[q_at] + 1 : 1;
    r = r < 1 ? 1 : (r > k ? k : r);  // the JAX gather clamps its index
    const int jr = r == k ? sk.jstar : select_rank(dist, hist, n, (unsigned)r, lane).jstar;
    pred = y_cell[jr];
  }
  int* idx = reinterpret_cast<int*>(buf);
  compact(dist, idx, n, k, sk, lane);

  float sy = 0.0f, sw = 0.0f, swy = 0.0f;
  unsigned n_ex = 0u;
  for (int i = lane; i < k; i += 32) {
    const int j = idx[i];
    const float v = y_cell[j];
    sy = __fadd_rn(sy, v);
    n_ex += (!has_thresh || v > thresh) ? 1u : 0u;
    if (kind == WEIGHT) {
      const float d = sqrtf(sq_dist<F>(xc_cell + (size_t)j * F, dist.q));
      const float w = __fdiv_rn(1.0f, d == 0.0f ? 1e-20f : d);
      sw = __fadd_rn(sw, w);
      swy = __fadd_rn(swy, __fmul_rn(v, w));
    }
  }
  sy = warp_sum(sy);
  n_ex = warp_sum(n_ex);
  const float kf = (float)k;
  const float mean = __fdiv_rn(sy, kf);
  float ss = 0.0f;
  for (int i = lane; i < k; i += 32) {
    const float dv = __fsub_rn(y_cell[idx[i]], mean);
    ss = __fadd_rn(ss, __fmul_rn(dv, dv));
  }
  ss = warp_sum(ss);
  if (kind == WEIGHT) {
    sw = warp_sum(sw);
    swy = warp_sum(swy);
  }
  if (lane == 0) {
    const bool any_below = n_ex < (unsigned)k;  // only with a threshold
    if (kind == MEAN) pred = any_below ? 0.0f : mean;  // nan_to_num (gard.py:101-103)
    if (kind == WEIGHT) pred = any_below ? 0.0f : __fdiv_rn(swy, sw);
    float* o = out + q_at * 3;
    o[0] = pred;
    o[1] = has_thresh ? __fdiv_rn((float)n_ex, kf) : 1.0f;
    o[2] = any_below ? quiet_nan() : sqrtf(__fdiv_rn(ss, kf));
  }
}

// Solves the symmetric P x P system H d = g (upper triangle of H, row-major)
// for the Newton step: cofactors for P <= 3 (knn_kernel.py _solve2 /
// _solve3), an unrolled Cholesky above (_solve_spd); the ridge-damped
// logistic Hessian is SPD, so no pivoting.
template <int P>
__device__ __forceinline__ void newton_solve(const float (&H)[P * (P + 1) / 2], const float (&g)[P], float (&d)[P]) {
  if constexpr (P == 2) {
    const float h00 = H[0], h01 = H[1], h11 = H[2];
    const float det = h00 * h11 - h01 * h01;
    d[0] = (h11 * g[0] - h01 * g[1]) / det;
    d[1] = (h00 * g[1] - h01 * g[0]) / det;
  } else if constexpr (P == 3) {
    const float h00 = H[0], h01 = H[1], h02 = H[2], h11 = H[3], h12 = H[4], h22 = H[5];
    const float A = h11 * h22 - h12 * h12;
    const float B = -(h01 * h22 - h12 * h02);
    const float Cc = h01 * h12 - h11 * h02;
    const float det = h00 * A + h01 * B + h02 * Cc;
    const float i01 = -(h01 * h22 - h02 * h12), i02 = h01 * h12 - h02 * h11;
    const float i11 = h00 * h22 - h02 * h02, i12 = -(h00 * h12 - h02 * h01);
    const float i22 = h00 * h11 - h01 * h01;
    d[0] = (A * g[0] + i01 * g[1] + i02 * g[2]) / det;
    d[1] = (i01 * g[0] + i11 * g[1] + i12 * g[2]) / det;
    d[2] = (i02 * g[0] + i12 * g[1] + i22 * g[2]) / det;
  } else {
    float L[P][P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float s = H[tri(j, i, P)];
#pragma unroll
        for (int p = 0; p < j; ++p) s -= L[i][p] * L[j][p];
        L[i][j] = i == j ? sqrtf(s) : s / L[j][j];
      }
    }
    float z[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      float s = g[i];
#pragma unroll
      for (int p = 0; p < i; ++p) s -= L[i][p] * z[p];
      z[i] = s / L[i][i];
    }
#pragma unroll
    for (int i = P - 1; i >= 0; --i) {
      float s = z[i];
#pragma unroll
      for (int p = i + 1; p < P; ++p) s -= L[p][i] * d[p];
      d[i] = s / L[i][i];
    }
  }
}

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

template <int F, bool SMEM>
__global__ void __launch_bounds__(32 * MAX_WARPS)
analog_regression_kernel(const float* __restrict__ xc, const float* __restrict__ y,
                         const float* __restrict__ ybar, const float* __restrict__ xq,
                         float* __restrict__ out, int n, int m, int k, int has_thresh,
                         float thresh, int n_iter, int tiles, int buf_len) {
  constexpr int T = F * (F + 1) / 2;
  constexpr int R = 1 + F + T + 1 + F + 1;  // statistic rows
  constexpr int P = F + 1;                  // logistic parameters
  constexpr int HT = P * (P + 1) / 2;
  extern __shared__ unsigned smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t cell = blockIdx.x / tiles;
  const int qi = (int)(blockIdx.x % tiles) * warps + warp;
  if (qi >= m) return;
  unsigned* hist = smem + (size_t)warp * (HIST + buf_len);
  unsigned* buf = hist + HIST;
  const int64_t q_at = cell * m + qi;
  const float* xc_cell = xc + cell * n * F;
  const float* y_cell = y + cell * n;
  const Dist<F, SMEM> dist = load_query<F, SMEM>(xc_cell, xq + q_at * F, buf, n, lane);

  const Sel sk = select_rank(dist, hist, n, (unsigned)k, lane);
  int* idx = reinterpret_cast<int*>(buf);
  compact(dist, idx, n, k, sk, lane);

  // weighted-OLS sums over the selected analogs that exceed the threshold,
  // rows: sum w, sum w x_a, sum w x_a x_b (a <= b), sum w yc, sum w x_a yc,
  // sum w yc^2
  const float yb = ybar[cell];
  float s[R];
#pragma unroll
  for (int t = 0; t < R; ++t) s[t] = 0.0f;
  for (int i = lane; i < k; i += 32) {
    const int j = idx[i];
    const float v = y_cell[j];
    if (has_thresh && !(v > thresh)) continue;
    float x[F];
#pragma unroll
    for (int a = 0; a < F; ++a) x[a] = xc_cell[(size_t)j * F + a];
    const float vc = __fsub_rn(v, yb);
    s[0] += 1.0f;
#pragma unroll
    for (int a = 0; a < F; ++a) {
      s[1 + a] += x[a];
#pragma unroll
      for (int b = a; b < F; ++b) s[1 + F + tri(a, b, F)] += x[a] * x[b];
      s[2 + F + T + a] += x[a] * vc;
    }
    s[1 + F + T] += vc;
    s[R - 1] += vc * vc;
  }
#pragma unroll
  for (int t = 0; t < R; ++t) s[t] = warp_sum(s[t]);

  float prob = 1.0f;
  const int n_ex = (int)s[0];  // an exact count: k <= 4096
  if (has_thresh) {
    if (n_ex >= k) {
      prob = 1.0f;
    } else if (n_ex <= 0) {
      prob = 0.0f;
    } else {
      const float eps = 10.0f * FLT_EPSILON;
      float beta[P];
#pragma unroll
      for (int a = 0; a < P; ++a) beta[a] = 0.0f;
      for (int it = 0; it < n_iter; ++it) {
        float g[P], H[HT];
#pragma unroll
        for (int a = 0; a < P; ++a) g[a] = 0.0f;
#pragma unroll
        for (int t = 0; t < HT; ++t) H[t] = 0.0f;
        for (int i = lane; i < k; i += 32) {
          const int j = idx[i];
          float xb[P];
#pragma unroll
          for (int a = 0; a < F; ++a) xb[a] = xc_cell[(size_t)j * F + a];
          xb[F] = 1.0f;
          float z = 0.0f;
#pragma unroll
          for (int a = 0; a < F; ++a) z += xb[a] * beta[a];
          const float p = sigmoid(z + beta[F]);
          const float r = p - (y_cell[j] > thresh ? 1.0f : 0.0f);
          const float h = p * (1.0f - p);
#pragma unroll
          for (int a = 0; a < P; ++a) {
            g[a] += r * xb[a];
#pragma unroll
            for (int b = a; b < P; ++b) H[tri(a, b, P)] += h * xb[a] * xb[b];
          }
        }
#pragma unroll
        for (int a = 0; a < P; ++a) g[a] = warp_sum(g[a]) + (a < F ? beta[a] : 0.0f);
#pragma unroll
        for (int t = 0; t < HT; ++t) H[t] = warp_sum(H[t]);
        // ridge: +1 (C = 1 L2 penalty) on the coefficients, +10 eps everywhere
#pragma unroll
        for (int a = 0; a < P; ++a) H[tri(a, a, P)] += a < F ? 1.0f + eps : eps;
        float d[P];
        newton_solve<P>(H, g, d);
#pragma unroll
        for (int a = 0; a < P; ++a) beta[a] -= d[a];
      }
      float zq = 0.0f;
#pragma unroll
      for (int a = 0; a < F; ++a) zq += dist.q[a] * beta[a];
      prob = 1.0f - sigmoid(zq + beta[F]);
    }
  }
  if (lane == 0) {
    float* o = out + q_at * (R + 1);
#pragma unroll
    for (int t = 0; t < R; ++t) o[t] = s[t];
    o[R] = prob;
  }
}

// Launch geometry: a warp's shared memory is the histogram plus either the
// n distance patterns (when they fit) or the k selected indices; up to
// MAX_WARPS queries share a block.
struct Geometry {
  bool smem;
  int buf_len, warps, tiles;
  size_t bytes;
  int64_t blocks;
};

cudaError_t geometry(int C, int n, int m, int k, Geometry* g) {
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  g->smem = (size_t)(HIST + n) * 4 <= (size_t)max_smem;
  g->buf_len = g->smem ? n : k;
  const size_t per_warp = (size_t)(HIST + g->buf_len) * 4;
  if (per_warp > (size_t)max_smem) return cudaErrorInvalidValue;
  g->warps = MAX_WARPS;
  while (g->warps > 1 && g->warps * per_warp > (size_t)max_smem) --g->warps;
  g->tiles = (m + g->warps - 1) / g->warps;
  g->bytes = g->warps * per_warp;
  g->blocks = (int64_t)C * g->tiles;
  if (g->blocks > 0x7fffffff) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <class K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int F>
cudaError_t launch_pure(const Geometry& g, const float* xc, const float* y, const float* xq,
                        const int* rand, float* out, int n, int m, int k, int kind,
                        int has_thresh, float thresh, cudaStream_t stream) {
  auto kernel = g.smem ? pure_analog_kernel<F, true> : pure_analog_kernel<F, false>;
  const cudaError_t e = set_smem(kernel, g.bytes);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)g.blocks, 32 * g.warps, g.bytes, stream>>>(
      xc, y, xq, rand, out, n, m, k, kind, has_thresh, thresh, g.tiles, g.buf_len);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_regression(const Geometry& g, const float* xc, const float* y,
                              const float* ybar, const float* xq, float* out, int n, int m,
                              int k, int has_thresh, float thresh, int n_iter,
                              cudaStream_t stream) {
  auto kernel = g.smem ? analog_regression_kernel<F, true> : analog_regression_kernel<F, false>;
  const cudaError_t e = set_smem(kernel, g.bytes);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)g.blocks, 32 * g.warps, g.bytes, stream>>>(
      xc, y, ybar, xq, out, n, m, k, has_thresh, thresh, n_iter, g.tiles, g.buf_len);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xc (C, n, f) and xq (C, m, f): features centred on each cell's training
// mean; y (C, n); rand (C, m) int32 analog ranks - 1 for sample analogs;
// out (C, m, 3).  1 <= f <= 6, 1 <= k <= min(n, 4096), kind 0..3 (best,
// sample, weight, mean).
int sdt_pure_analog_stats(const float* xc, const float* y, const float* xq, const int* rand,
                          float* out, int C, int n, int m, int f, int k, int kind,
                          int has_thresh, float thresh, void* stream) {
  if (C <= 0 || n <= 0 || m <= 0 || k < 1 || k > n || k > MAX_K || kind < 0 || kind > 3) {
    return (int)cudaErrorInvalidValue;
  }
  Geometry g;
  cudaError_t e = geometry(C, n, m, k, &g);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (f) {
    case 1: return (int)launch_pure<1>(g, xc, y, xq, rand, out, n, m, k, kind, has_thresh, thresh, s);
    case 2: return (int)launch_pure<2>(g, xc, y, xq, rand, out, n, m, k, kind, has_thresh, thresh, s);
    case 3: return (int)launch_pure<3>(g, xc, y, xq, rand, out, n, m, k, kind, has_thresh, thresh, s);
    case 4: return (int)launch_pure<4>(g, xc, y, xq, rand, out, n, m, k, kind, has_thresh, thresh, s);
    case 5: return (int)launch_pure<5>(g, xc, y, xq, rand, out, n, m, k, kind, has_thresh, thresh, s);
    case 6: return (int)launch_pure<6>(g, xc, y, xq, rand, out, n, m, k, kind, has_thresh, thresh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// xc, xq as above; y (C, n); ybar (C,) each cell's mean of y; out (C, m,
// R + 1) with R = 1 + f + f(f+1)/2 + 1 + f + 1 statistic rows and then the
// exceedance probability.  1 <= f <= 5, 1 <= k <= min(n, 4096).
int sdt_analog_regression_stats(const float* xc, const float* y, const float* ybar,
                                const float* xq, float* out, int C, int n, int m, int f, int k,
                                int has_thresh, float thresh, int n_iter, void* stream) {
  if (C <= 0 || n <= 0 || m <= 0 || k < 1 || k > n || k > MAX_K || n_iter < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Geometry g;
  cudaError_t e = geometry(C, n, m, k, &g);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (f) {
    case 1: return (int)launch_regression<1>(g, xc, y, ybar, xq, out, n, m, k, has_thresh, thresh, n_iter, s);
    case 2: return (int)launch_regression<2>(g, xc, y, ybar, xq, out, n, m, k, has_thresh, thresh, n_iter, s);
    case 3: return (int)launch_regression<3>(g, xc, y, ybar, xq, out, n, m, k, has_thresh, thresh, n_iter, s);
    case 4: return (int)launch_regression<4>(g, xc, y, ybar, xq, out, n, m, k, has_thresh, thresh, n_iter, s);
    case 5: return (int)launch_regression<5>(g, xc, y, ybar, xq, out, n, m, k, has_thresh, thresh, n_iter, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* sdt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
