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
// no per-lane gather; none of that carries over.
//
// What bounds it on the H100: at GARD's shape (2,048 cells, n = 3,650,
// m = 365, f = 2, k = 200) the compulsory bytes are about 105 MB (0.03 ms at
// 3.35 TB/s) and the distances about 1.4e10 float32 operations (0.2 ms at
// 67 TFLOP/s), so operations bound it.  What it costs above that is the
// selection: every pass over a query's n distances is a chain of
// shared-memory loads, atomics and ballots, about 12-25 warp instructions a
// 32 rows, and the shared-memory pipe and its latency, not the FMA units,
// set its pace.  So the design counts passes over the record and keeps
// several chunks of them in flight.
//
// The design.  A block serves a tile of queries of one cell, a warp one
// query at a time.
//   * staging: the block copies the cell's centred training rows, feature
//     major, and y into shared memory once (43.8 KB at n = 3,650, f = 2);
//     every warp's passes, statistics and Newton steps read them there.  A
//     cell too long to stage is read from global memory (through L1/L2).
//   * distances: the direct form sum_j (q_j - t_j)^2 in feature order with
//     __fsub_rn / __fmul_rn / __fadd_rn, so nvcc forms no FMA and the plain
//     PyTorch version (kernels/knn.py), which evaluates the same expression
//     one elementwise operation at a time, gets the same bits and so the same
//     selected set.  They are recomputed from the staged rows in each pass
//     (3f - 1 operations a row) rather than kept: n patterns a warp would
//     cost 14.6 KB of shared memory a warp and so resident warps.
//   * pass 1 computes each distance and counts its first digit, the 11
//     bits below bit 31 (a distance is a non-negative float or the
//     canonical NaN 0x7fffffff, so bit 31 is 0), in a per-warp histogram of
//     16-bit counters (a staged cell has fewer than 65,536 rows; 32-bit ones
//     for a cell read from global memory) with one shared atomic a lane.
//     Each lane computes the patterns of ILP = 4 chunks of 32 rows before it
//     counts them, so their loads overlap.  Two warp scans (over 32 groups
//     of bins, then over the chosen group's bins) find the bin of the k-th
//     item.  At GARD's data an 11-bit digit leaves a median of 20 rows of
//     3,650 in that bin (p99 36).
//   * pass 2 (compaction) writes the rows of lower bins, the sure members,
//     ascending into the warp's member list by a ballot prefix count, and
//     puts the rows of the k-th bin as (pattern << 32 | index) keys on a
//     candidate list of at most CAP = 64 in the histogram's space.  Each
//     candidate's rank is the count of candidates below its key, so the
//     first k - below of them go to the member list in (distance, index)
//     order, with no further pass over n.
//   * the overflow route: when the k-th bin holds more than CAP rows
//     (duplicated rows, queries on training points, a constant feature),
//     further digit passes over n narrow it first (11 + 11 + 9 bits); once
//     every bit is fixed the bin's rows share one pattern, and the
//     compaction takes the first k - below of them in index order.  Every
//     route gives lax.top_k's set and order.
//   * best and sample analogs take their rank-r member from the member list
//     when r falls in the k-th bin, else by the same selection run over the
//     sure members only (at most k items), not over n.
//   * the statistics and K8's Newton steps read the k members' x and y from
//     the staged rows.  Sums are warp reductions by xor shuffles, which
//     leave every lane with the same bits, so every lane solves the
//     (f+1)x(f+1) Newton step itself (cofactors for f <= 2, an unrolled
//     Cholesky above, as _solve_spd) and no broadcast is needed.  The
//     standard deviation is two-pass over the members.
// tests/test_torch_knn_select.py models this selection in numpy, bitwise
// against the plain version's stable sort.  The launcher picks the warps a
// block (at most 16) that give the most resident warps an SM
// (cudaOccupancy...): at GARD's shape 14 warps and two blocks, 28 warps an
// SM, shared memory being the limit; sdt_knn_geometry reports them.
// The alternatives the design was chosen over on the card (a 10- or
// 12-bit digit, a list of 128, 32-bit counters, distances kept in shared
// memory, __match_any_sync aggregation, 1 or 2 chunks in flight, up to 32
// warps a block) and their times are in PERF.md.
//
// The C entry points take plain pointers, sizes and the CUDA stream, launch
// on that stream without synchronising, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BITS = 11;         // the first digit
constexpr int BINS = 1 << BITS;  // first-digit bins
constexpr int CAP = 64;          // candidates, two words each, in the counters' space
constexpr int SLOTS = CAP / 32;  // candidates a lane ranks
constexpr int MAX_WARPS = 16;
constexpr int ILP = 4;           // chunks of 32 rows a pass loads before it counts or compacts
constexpr int MAX_K = 4096;
static_assert(BITS >= 5 && BITS <= 16 && CAP % 32 == 0 && 4 * CAP <= BINS, "digit and list sizes");
enum Kind { BEST = 0, SAMPLE = 1, WEIGHT = 2, MEAN = 3 };

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

// index of (a, b), a <= b, in the row-major upper triangle of a P x P matrix
__host__ __device__ constexpr int tri(int a, int b, int P) { return a * (2 * P - a - 1) / 2 + b; }

__host__ __device__ constexpr size_t round4(size_t words) { return (words + 3) & ~size_t(3); }

// A cell's centred training rows and targets: staged in shared memory
// (features major, (F, n)) or in global memory as given ((n, F)).
template <int F, bool STAGED>
struct Rows {
  const float* x;
  const float* y;
  int n;
  __device__ __forceinline__ float feat(int j, int c) const {
    if constexpr (STAGED) {
      return x[c * n + j];
    } else {
      return x[(size_t)j * F + c];
    }
  }
  // the squared distance's bit pattern (non-negative floats compare as
  // their patterns do)
  __device__ __forceinline__ unsigned pattern(int j, const float (&q)[F]) const {
    float d = 0.0f;
#pragma unroll
    for (int c = 0; c < F; ++c) {
      const float diff = __fsub_rn(q[c], feat(j, c));
      const float sq = __fmul_rn(diff, diff);
      d = c == 0 ? sq : __fadd_rn(d, sq);
    }
    return __float_as_uint(d);
  }
};

// The block's cell: staged once by every thread of the block.
template <int F, bool STAGED>
__device__ Rows<F, STAGED> stage(const float* xg, const float* yg, int n, float* sm) {
  if constexpr (STAGED) {
    for (int e = threadIdx.x; e < n * F; e += blockDim.x) sm[(e % F) * n + e / F] = xg[e];
    for (int j = threadIdx.x; j < n; j += blockDim.x) sm[F * n + j] = yg[j];
    __syncthreads();
    return {sm, sm + F * n, n};
  } else {
    return {xg, yg, n};
  }
}

// The items a selection runs over, in ascending index order: every row of
// the cell, or the sure members of an earlier selection.
template <int F, bool STAGED>
struct AllRows {
  Rows<F, STAGED> rows;
  float q[F];
  __device__ __forceinline__ int index(int i) const { return i; }
  __device__ __forceinline__ unsigned pattern(int i) const { return rows.pattern(i, q); }
};

template <int F, bool STAGED>
struct Members {
  Rows<F, STAGED> rows;
  float q[F];
  const int* idx;
  __device__ __forceinline__ int index(int i) const { return idx[i]; }
  __device__ __forceinline__ unsigned pattern(int i) const { return rows.pattern(idx[i], q); }
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

// the sum of v over the lanes below this one
__device__ __forceinline__ unsigned warp_excl_scan(unsigned v, int lane) {
  unsigned incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  return incl - v;
}

struct Sel {
  int found;       // index of the r-th item
  unsigned below;  // items of the bins below its bin
};

// A warp's digit counters in shared memory: a word a bin, or with C16 two
// 16-bit counters a word (for staged cells, which hold fewer than 65,536
// rows).
template <bool C16>
struct Counters {
  unsigned* w;
  __host__ __device__ static constexpr int words(int bins) { return C16 ? (bins + 1) / 2 : bins; }
  __device__ __forceinline__ void add(unsigned bin, unsigned c) const {
    if constexpr (C16) {
      atomicAdd(&w[bin >> 1], c << ((bin & 1u) << 4));
    } else {
      atomicAdd(&w[bin], c);
    }
  }
  __device__ __forceinline__ unsigned get(int bin) const {
    if constexpr (C16) {
      return (w[bin >> 1] >> ((bin & 1) << 4)) & 0xffffu;
    } else {
      return w[bin];
    }
  }
  // the sum of the counters of bins [lo, lo + per)
  __device__ __forceinline__ unsigned sum(int lo, int per) const {
    unsigned s = 0u;
    const int wper = C16 ? per >> 1 : per;
    if (wper >= 4) {
      for (int t = 0; t < wper; t += 4) {
        const uint4 c = *reinterpret_cast<const uint4*>(w + (C16 ? lo >> 1 : lo) + t);
        if constexpr (C16) {
          s += (c.x & 0xffffu) + (c.x >> 16) + (c.y & 0xffffu) + (c.y >> 16) + (c.z & 0xffffu) + (c.z >> 16) +
               (c.w & 0xffffu) + (c.w >> 16);
        } else {
          s += c.x + c.y + c.z + c.w;
        }
      }
    } else {
      for (int t = 0; t < per; ++t) s += get(lo + t);
    }
    return s;
  }
};

// The r-th (1-based) of the N items of src in (pattern, index) order.  With
// EMIT, out[0, r) receives the indices of the r first items: those of the
// bins below the r-th item's bin ascending by index, then those of its bin
// in (pattern, index) order.  hist is the warp's counter words, which the
// candidate list reuses.
template <bool EMIT, bool C16, class Src>
__device__ Sel warp_select(const Src& src, int N, unsigned r, unsigned* hist, int* out, int lane) {
  const Counters<C16> ctr{hist};
  unsigned prefix = 0u, mask = 0u, remaining = r, below = 0u, count = 0u;
  int shift = 31;
  // digit passes: until the r-th item's bin holds at most CAP items or every
  // bit is fixed
  for (;;) {
    const int width = shift < BITS ? shift : BITS;
    shift -= width;
    const int bins = 1 << width;
    const unsigned dmask = (unsigned)bins - 1u;
    const int words = Counters<C16>::words(bins);
    for (int b = 4 * lane; b < words; b += 128) *reinterpret_cast<uint4*>(hist + b) = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
    // ILP chunks of 32 at a time: every pattern first, then the counters,
    // so the loads of one chunk do not wait on the atomics of the last
    for (int i0 = 0; i0 < N; i0 += 32 * ILP) {
      unsigned v[ILP];
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        const int i = i0 + 32 * u + lane;
        v[u] = FULL;  // not in the bin
        if (i < N) {
          const unsigned p = src.pattern(i);
          if ((p & mask) == prefix) v[u] = (p >> shift) & dmask;
        }
      }
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        if (v[u] != FULL) ctr.add(v[u], 1u);
      }
    }
    __syncwarp();
    // the bin that holds the remaining-th item: each lane sums `per`
    // consecutive bins and a warp scan finds the owner lane; then each lane
    // takes `sub` of the owner's bins and a second scan finds the bin
    const int per = bins >= 32 ? bins >> 5 : 1;
    const unsigned s = lane * per < bins ? ctr.sum(lane * per, per) : 0u;
    const unsigned excl = warp_excl_scan(s, lane);
    const int owner = __ffs(__ballot_sync(FULL, excl < remaining && remaining <= excl + s)) - 1;
    const unsigned base = __shfl_sync(FULL, excl, owner);
    const unsigned rem = remaining - base;
    const int sub = per >= 32 ? per >> 5 : 1;
    const int lo = owner * per + lane * sub;
    unsigned s2 = 0u;
    if (lane * sub < per) {
      for (int t = 0; t < sub; ++t) s2 += ctr.get(lo + t);
    }
    const unsigned excl2 = warp_excl_scan(s2, lane);
    const int owner2 = __ffs(__ballot_sync(FULL, excl2 < rem && rem <= excl2 + s2)) - 1;
    unsigned digit = 0u, before = 0u, cnt = 0u;
    if (lane == owner2) {
      unsigned acc = excl2;
      for (int t = 0; t < sub; ++t) {
        const unsigned c = ctr.get(lo + t);
        if (acc + c >= rem) {
          digit = (unsigned)(lo + t);
          before = base + acc;
          cnt = c;
          break;
        }
        acc += c;
      }
    }
    digit = __shfl_sync(FULL, digit, owner2);
    before = __shfl_sync(FULL, before, owner2);
    count = __shfl_sync(FULL, cnt, owner2);
    below += before;
    remaining -= before;
    prefix |= digit << shift;
    mask |= dmask << shift;
    __syncwarp();
    if (count <= (unsigned)CAP || shift == 0) break;
  }

  // compaction: lower bins to out, the r-th item's bin to the candidate
  // list (or, with every bit fixed and more than CAP items, taken in index
  // order: they share one pattern)
  const bool ties = count > (unsigned)CAP;
  unsigned long long* cand = reinterpret_cast<unsigned long long*>(hist);
  const unsigned lt = (1u << lane) - 1u;
  unsigned nb = 0u, nc = 0u;
  int found = -1;
  for (int i0 = 0; i0 < N; i0 += 32 * ILP) {
    if ((!EMIT || nb == below) && nc == count) break;
    unsigned p[ILP];
    int j[ILP];
    bool valid[ILP];
#pragma unroll
    for (int u = 0; u < ILP; ++u) {
      const int i = i0 + 32 * u + lane;
      valid[u] = i < N;
      p[u] = valid[u] ? src.pattern(i) : 0u;
      j[u] = valid[u] ? src.index(i) : 0;
    }
#pragma unroll
    for (int u = 0; u < ILP; ++u) {
      const bool low = valid[u] && p[u] < prefix;
      const bool in_bin = valid[u] && (p[u] & mask) == prefix;
      if constexpr (EMIT) {
        const unsigned bb = __ballot_sync(FULL, low);
        if (low) out[nb + __popc(bb & lt)] = j[u];
        nb += __popc(bb);
      }
      const unsigned bc = __ballot_sync(FULL, in_bin);
      if (in_bin) {
        const unsigned o = nc + __popc(bc & lt);  // ordinal in the bin, by index
        if (ties) {
          if (o < remaining) {
            if constexpr (EMIT) out[below + o] = j[u];
            if (o == remaining - 1u) found = j[u];
          }
        } else {
          cand[o] = ((unsigned long long)p[u] << 32) | (unsigned)j[u];
        }
      }
      nc += __popc(bc);
    }
  }
  __syncwarp();
  if (!ties) {
    // a candidate's rank: the candidates whose key is below its own
    const int used = ((int)count + 31) >> 5;
    unsigned long long mine[SLOTS];
    unsigned rho[SLOTS];
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int c = lane + 32 * t;
      mine[t] = t < used && c < (int)count ? cand[c] : ~0ull;
      rho[t] = 0u;
    }
#pragma unroll 4
    for (int c = 0; c < (int)count; ++c) {
      const unsigned long long o = cand[c];
#pragma unroll
      for (int t = 0; t < SLOTS; ++t) {
        if (t < used) rho[t] += o < mine[t] ? 1u : 0u;
      }
    }
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      if (lane + 32 * t < (int)count && rho[t] < remaining) {
        const int j = (int)(unsigned)mine[t];
        if constexpr (EMIT) out[below + rho[t]] = j;
        if (rho[t] == remaining - 1u) found = j;
      }
    }
    __syncwarp();
  }
  return {__reduce_max_sync(FULL, found), below};
}

// 16-bit counters: staged cells only (fewer than 65,536 rows)
template <bool STAGED>
constexpr bool COUNT16 = STAGED;

// Per-warp shared memory, in words: the counters (and candidate list) and
// the k member indices.
template <bool STAGED>
__host__ __device__ constexpr size_t counter_words() { return round4(Counters<COUNT16<STAGED>>::words(BINS)); }

template <bool STAGED>
__host__ __device__ constexpr size_t warp_words(int k) {
  return round4(counter_words<STAGED>() + (size_t)k);
}

template <int F>
__host__ __device__ constexpr size_t staged_words(int n) { return round4((size_t)n * (F + 1)); }

// The queries [q0, q1) of the block's tile; its warps take every warps-th.
struct Tile {
  int q0, q1;
};

__device__ __forceinline__ Tile tile_of(int m, int tiles) {
  const int per = (m + tiles - 1) / tiles;
  const int t = (int)(blockIdx.x % tiles);
  const int q0 = t * per;
  return {q0, q0 + per < m ? q0 + per : m};
}

template <int F, bool STAGED>
__global__ void __launch_bounds__(32 * MAX_WARPS)
pure_analog_kernel(const float* __restrict__ xc, const float* __restrict__ y,
                   const float* __restrict__ xq, const int* __restrict__ rand,
                   float* __restrict__ out, int n, int m, int k, int kind,
                   int has_thresh, float thresh, int tiles) {
  extern __shared__ __align__(16) unsigned smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t cell = blockIdx.x / tiles;
  const Tile tl = tile_of(m, tiles);
  const Rows<F, STAGED> rows = stage<F, STAGED>(xc + cell * n * F, y + cell * n, n, reinterpret_cast<float*>(smem));
  unsigned* hist = smem + (STAGED ? staged_words<F>(n) : 0) + (size_t)warp * warp_words<STAGED>(k);
  int* idx = reinterpret_cast<int*>(hist + counter_words<STAGED>());
  const float kf = (float)k;

  for (int qi = tl.q0 + warp; qi < tl.q1; qi += warps) {
    const int64_t q_at = cell * m + qi;
    AllRows<F, STAGED> src;
    src.rows = rows;
#pragma unroll
    for (int c = 0; c < F; ++c) src.q[c] = xq[q_at * F + c];
    const Sel sk = warp_select<true, COUNT16<STAGED>>(src, n, (unsigned)k, hist, idx, lane);
    float pred = 0.0f;
    if (kind == BEST || kind == SAMPLE) {
      int r = kind == SAMPLE ? rand[q_at] + 1 : 1;
      r = r < 1 ? 1 : (r > k ? k : r);  // the JAX gather clamps its index
      int jr;
      if ((unsigned)r > sk.below) {
        jr = idx[r - 1];
      } else {
        Members<F, STAGED> mem;
        mem.rows = rows;
        mem.idx = idx;
#pragma unroll
        for (int c = 0; c < F; ++c) mem.q[c] = src.q[c];
        jr = warp_select<false, COUNT16<STAGED>>(mem, (int)sk.below, (unsigned)r, hist, nullptr, lane).found;
      }
      pred = rows.y[jr];
    }

    float sy = 0.0f, sw = 0.0f, swy = 0.0f;
    unsigned n_ex = 0u;
    for (int i = lane; i < k; i += 32) {
      const int j = idx[i];
      const float v = rows.y[j];
      sy = __fadd_rn(sy, v);
      n_ex += (!has_thresh || v > thresh) ? 1u : 0u;
      if (kind == WEIGHT) {
        const float d = sqrtf(__uint_as_float(rows.pattern(j, src.q)));
        const float w = __fdiv_rn(1.0f, d == 0.0f ? 1e-20f : d);
        sw = __fadd_rn(sw, w);
        swy = __fadd_rn(swy, __fmul_rn(v, w));
      }
    }
    sy = warp_sum(sy);
    n_ex = warp_sum(n_ex);
    const float mean = __fdiv_rn(sy, kf);
    float ss = 0.0f;
    for (int i = lane; i < k; i += 32) {
      const float dv = __fsub_rn(rows.y[idx[i]], mean);
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
    __syncwarp();  // the next query overwrites idx and hist
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

template <int F, bool STAGED>
__global__ void __launch_bounds__(32 * MAX_WARPS)
analog_regression_kernel(const float* __restrict__ xc, const float* __restrict__ y,
                         const float* __restrict__ ybar, const float* __restrict__ xq,
                         float* __restrict__ out, int n, int m, int k, int has_thresh,
                         float thresh, int n_iter, int tiles) {
  constexpr int T = F * (F + 1) / 2;
  constexpr int R = 1 + F + T + 1 + F + 1;  // statistic rows
  constexpr int P = F + 1;                  // logistic parameters
  constexpr int HT = P * (P + 1) / 2;
  extern __shared__ __align__(16) unsigned smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t cell = blockIdx.x / tiles;
  const Tile tl = tile_of(m, tiles);
  const Rows<F, STAGED> rows = stage<F, STAGED>(xc + cell * n * F, y + cell * n, n, reinterpret_cast<float*>(smem));
  unsigned* hist = smem + (STAGED ? staged_words<F>(n) : 0) + (size_t)warp * warp_words<STAGED>(k);
  int* idx = reinterpret_cast<int*>(hist + counter_words<STAGED>());
  const float yb = ybar[cell];

  for (int qi = tl.q0 + warp; qi < tl.q1; qi += warps) {
    const int64_t q_at = cell * m + qi;
    AllRows<F, STAGED> src;
    src.rows = rows;
#pragma unroll
    for (int c = 0; c < F; ++c) src.q[c] = xq[q_at * F + c];
    warp_select<true, COUNT16<STAGED>>(src, n, (unsigned)k, hist, idx, lane);

    // weighted-OLS sums over the selected analogs that exceed the
    // threshold, rows: sum w, sum w x_a, sum w x_a x_b (a <= b), sum w yc,
    // sum w x_a yc, sum w yc^2
    float s[R];
#pragma unroll
    for (int t = 0; t < R; ++t) s[t] = 0.0f;
    for (int i = lane; i < k; i += 32) {
      const int j = idx[i];
      const float v = rows.y[j];
      if (has_thresh && !(v > thresh)) continue;
      float x[F];
#pragma unroll
      for (int a = 0; a < F; ++a) x[a] = rows.feat(j, a);
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
            for (int a = 0; a < F; ++a) xb[a] = rows.feat(j, a);
            xb[F] = 1.0f;
            float z = 0.0f;
#pragma unroll
            for (int a = 0; a < F; ++a) z += xb[a] * beta[a];
            const float p = sigmoid(z + beta[F]);
            const float r = p - (rows.y[j] > thresh ? 1.0f : 0.0f);
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
        for (int a = 0; a < F; ++a) zq += src.q[a] * beta[a];
        prob = 1.0f - sigmoid(zq + beta[F]);
      }
    }
    if (lane == 0) {
      float* o = out + q_at * (R + 1);
#pragma unroll
      for (int t = 0; t < R; ++t) o[t] = s[t];
      o[R] = prob;
    }
    __syncwarp();  // the next query overwrites idx and hist
  }
}

// Launch geometry: the cell staged when it fits beside one warp's words;
// the warps a block (at most MAX_WARPS and m) that give the most resident
// warps an SM; enough query tiles a cell to give every SM two waves of
// blocks.
struct Geometry {
  bool staged;
  int warps, tiles, blocks_per_sm;
  size_t bytes;
  int64_t blocks;
};

template <class Kern>
cudaError_t geometry(Kern staged_kernel, Kern global_kernel, size_t cell_words, int C, int m,
                     int k, Geometry* g, Kern* kernel) {
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const size_t cell = cell_words * 4;
  g->staged = cell + warp_words<true>(k) * 4 <= (size_t)max_smem;
  *kernel = g->staged ? staged_kernel : global_kernel;
  const size_t per_warp = (g->staged ? warp_words<true>(k) : warp_words<false>(k)) * 4;
  const size_t base = g->staged ? cell : 0;
  if (base + per_warp > (size_t)max_smem) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (e != cudaSuccess) return e;
  const int top = m < MAX_WARPS ? m : MAX_WARPS;
  g->warps = 0;
  int best = -1;
  for (int w = 1; w <= top; ++w) {
    const size_t bytes = base + w * per_warp;
    if (bytes > (size_t)max_smem) break;
    int nb = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, *kernel, 32 * w, bytes);
    if (e != cudaSuccess) return e;
    if (nb * w >= best && nb > 0) {  // ties: the larger block, which stages less often
      best = nb * w;
      g->warps = w;
      g->blocks_per_sm = nb;
    }
  }
  if (g->warps == 0) return cudaErrorInvalidValue;
  g->bytes = base + g->warps * per_warp;
  const int64_t want = 2LL * sms * g->blocks_per_sm;
  int64_t tiles = (want + C - 1) / C;
  const int64_t most = (m + g->warps - 1) / g->warps;
  tiles = tiles < 1 ? 1 : (tiles > most ? most : tiles);
  g->tiles = (int)tiles;
  g->blocks = (int64_t)C * g->tiles;
  if (g->blocks > 0x7fffffff) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int F>
cudaError_t launch_pure(const float* xc, const float* y, const float* xq, const int* rand, float* out,
                        int C, int n, int m, int k, int kind, int has_thresh, float thresh,
                        cudaStream_t stream, Geometry* g) {
  auto kernel = pure_analog_kernel<F, true>;
  const cudaError_t e = geometry(pure_analog_kernel<F, true>, pure_analog_kernel<F, false>,
                                 staged_words<F>(n), C, m, k, g, &kernel);
  if (e != cudaSuccess || out == nullptr) return e;
  kernel<<<(unsigned)g->blocks, 32 * g->warps, g->bytes, stream>>>(
      xc, y, xq, rand, out, n, m, k, kind, has_thresh, thresh, g->tiles);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_regression(const float* xc, const float* y, const float* ybar, const float* xq,
                              float* out, int C, int n, int m, int k, int has_thresh, float thresh,
                              int n_iter, cudaStream_t stream, Geometry* g) {
  auto kernel = analog_regression_kernel<F, true>;
  const cudaError_t e = geometry(analog_regression_kernel<F, true>, analog_regression_kernel<F, false>,
                                 staged_words<F>(n), C, m, k, g, &kernel);
  if (e != cudaSuccess || out == nullptr) return e;
  kernel<<<(unsigned)g->blocks, 32 * g->warps, g->bytes, stream>>>(
      xc, y, ybar, xq, out, n, m, k, has_thresh, thresh, n_iter, g->tiles);
  return cudaGetLastError();
}

cudaError_t pure(const float* xc, const float* y, const float* xq, const int* rand, float* out, int C,
                 int n, int m, int f, int k, int kind, int has_thresh, float thresh, cudaStream_t s,
                 Geometry* g) {
  if (C <= 0 || n <= 0 || m <= 0 || k < 1 || k > n || k > MAX_K || kind < 0 || kind > 3) {
    return cudaErrorInvalidValue;
  }
  switch (f) {
    case 1: return launch_pure<1>(xc, y, xq, rand, out, C, n, m, k, kind, has_thresh, thresh, s, g);
    case 2: return launch_pure<2>(xc, y, xq, rand, out, C, n, m, k, kind, has_thresh, thresh, s, g);
    case 3: return launch_pure<3>(xc, y, xq, rand, out, C, n, m, k, kind, has_thresh, thresh, s, g);
    case 4: return launch_pure<4>(xc, y, xq, rand, out, C, n, m, k, kind, has_thresh, thresh, s, g);
    case 5: return launch_pure<5>(xc, y, xq, rand, out, C, n, m, k, kind, has_thresh, thresh, s, g);
    case 6: return launch_pure<6>(xc, y, xq, rand, out, C, n, m, k, kind, has_thresh, thresh, s, g);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t regression(const float* xc, const float* y, const float* ybar, const float* xq, float* out,
                       int C, int n, int m, int f, int k, int has_thresh, float thresh, int n_iter,
                       cudaStream_t s, Geometry* g) {
  if (C <= 0 || n <= 0 || m <= 0 || k < 1 || k > n || k > MAX_K || n_iter < 0) {
    return cudaErrorInvalidValue;
  }
  switch (f) {
    case 1: return launch_regression<1>(xc, y, ybar, xq, out, C, n, m, k, has_thresh, thresh, n_iter, s, g);
    case 2: return launch_regression<2>(xc, y, ybar, xq, out, C, n, m, k, has_thresh, thresh, n_iter, s, g);
    case 3: return launch_regression<3>(xc, y, ybar, xq, out, C, n, m, k, has_thresh, thresh, n_iter, s, g);
    case 4: return launch_regression<4>(xc, y, ybar, xq, out, C, n, m, k, has_thresh, thresh, n_iter, s, g);
    case 5: return launch_regression<5>(xc, y, ybar, xq, out, C, n, m, k, has_thresh, thresh, n_iter, s, g);
    default: return cudaErrorInvalidValue;
  }
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
  Geometry g;
  return (int)pure(xc, y, xq, rand, out, C, n, m, f, k, kind, has_thresh, thresh, (cudaStream_t)stream, &g);
}

// xc, xq as above; y (C, n); ybar (C,) each cell's mean of y; out (C, m,
// R + 1) with R = 1 + f + f(f+1)/2 + 1 + f + 1 statistic rows and then the
// exceedance probability.  1 <= f <= 5, 1 <= k <= min(n, 4096).
int sdt_analog_regression_stats(const float* xc, const float* y, const float* ybar,
                                const float* xq, float* out, int C, int n, int m, int f, int k,
                                int has_thresh, float thresh, int n_iter, void* stream) {
  Geometry g;
  return (int)regression(xc, y, ybar, xq, out, C, n, m, f, k, has_thresh, thresh, n_iter,
                         (cudaStream_t)stream, &g);
}

// The launch geometry K7 (which = 0) or K8 (which = 1) would take at these
// sizes, launching nothing: res = [staged, warps a block, query tiles a
// cell, blocks an SM, shared bytes a block, resident warps an SM,
// first-digit bits, candidate list capacity].
int sdt_knn_geometry(int which, int C, int n, int m, int f, int k, int* res) {
  Geometry g;
  const cudaError_t e =
      which == 0 ? pure(nullptr, nullptr, nullptr, nullptr, nullptr, C, n, m, f, k, 0, 0, 0.0f, 0, &g)
                 : regression(nullptr, nullptr, nullptr, nullptr, nullptr, C, n, m, f, k, 0, 0.0f, 0, 0, &g);
  if (e != cudaSuccess) return (int)e;
  const int vals[8] = {g.staged ? 1 : 0, g.warps, g.tiles, g.blocks_per_sm, (int)g.bytes,
                       g.warps * g.blocks_per_sm, BITS, CAP};
  for (int i = 0; i < 8; ++i) res[i] = vals[i];
  return 0;
}

const char* sdt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
