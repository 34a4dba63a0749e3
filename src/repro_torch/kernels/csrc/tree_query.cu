// tree_query — the merge-tree range query of static RFS (the paper's
// Algorithm 2) over per-edge grouped time-major tables, float64, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/tree_query.py::tree_query_pallas
// (body _kernel). Same contract: pos [G, LVL, NPAD] (+inf padded),
// cum [G, LVL, NPAD, K4], r_lo/r_hi [G, Wh, Q] int32, pos_hi/pos_lo1/pos_lo2
// [G, Q], lo1_right [G, Q] int32, q_vec [G, Wh, Q, K4]; out [G, Wh, Q] with
//     out[g, w, q] = sum over the <= 2 buckets per level that the canonical
//                    decomposition of [r_lo, r_hi) emits (levels ascending,
//                    left bucket before right) of
//                    sum_k q_vec[g, w, q, k] * (pref(i_hi)[k] - pref(i_lo)[k]),
// k in order, where [i_lo, i_hi) is the part of the bucket's segment whose
// positions pass the atom's three bounds and pref(i) = cum[g, lev, i - 1]
// (0 when i is the segment start) — the association of the plain version
// (tree_query_ref), so the two differ only where the compiler contracts a
// multiply-add.
//
// Ranking a bound. The Pallas body turns each bucket search into a masked
// compare-count over the whole VMEM row, then a [TQ, NPAD] @ [NPAD, NB]
// matmul (the TPU has no cheap gather), and shares those counts across
// windows. Here each bound is ranked by a branch-free binary search of
// max(bit_length(NPAD), 1) trips over the bucket's segment
// pos[g, lev, seg_lo : seg_lo + 2^lev]. The two agree exactly: the RangeForest
// build sorts every bucket segment by position with its +inf padding at the
// end, so the predicate (v <= bound for right = true, v < bound for
// right = false) holds on a prefix of the segment and fails on the rest, and
// the search returns the length of that prefix — the compare-count. The
// searches use right = (true, lo1_right, false) for (pos_hi, pos_lo1,
// pos_lo2), as the compare masks of the Pallas body do.
//
// What bounds it on this card: bytes. Per (slot, half-window) it reads the
// K4-wide q_vec row (the largest input; three quarters of it are the zeros
// of the one-hot combo slot) and, per emitted bucket, two K4-wide prefix
// rows by computed index; the arithmetic is 3 flops per value read plus the
// integer searches. The rows of one edge are shared by all of its slots and
// windows, so after first touch they are L2 (and L1) hits.
//
// Mapping: one thread per (atom slot, half-window). A block holds TQ
// consecutive slots of one edge group (threadIdx.x, so the [.., w, q] stores
// coalesce) times up to WY half-windows (threadIdx.y; more loop in-thread).
// The thread walks the levels in order and keeps one scalar sum per bucket
// and one per lane: no register array sized by K4, which reaches 484 with
// the gaussian kernels. Its arithmetic does not depend on its window index:
// two half-windows with identical inputs give bitwise identical outputs.
// Ragged Q is masked here (q >= Q returns), no padded copies.
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 64;     // atom slots per block
constexpr int WY_MAX = 8;  // half-windows per block (more loop in-thread)

// Insertion point of val in row[lo:hi] (ascending): after equal values when
// `right`. Fixed trip count; a finished lane (lo == hi) keeps its state and
// reads row[0].
__device__ __forceinline__ int search(const double* __restrict__ row, int lo,
                                      int hi, double val, bool right,
                                      int steps) {
  for (int s = 0; s < steps; ++s) {
    const bool live = lo < hi;
    const int m = (lo + hi) >> 1;
    const double v = row[live ? m : 0];
    const bool go = live && (right ? v <= val : v < val);
    lo = go ? m + 1 : lo;
    hi = (go || !live) ? hi : m;
  }
  return lo;
}

// One emitted bucket: rank the three bounds in the segment, then the dot of
// the prefix-moment difference with the query row, k in order.
__device__ __forceinline__ double bucket(const double* __restrict__ row,
                                         const double* __restrict__ crow,
                                         int seg_lo, int lev, int NPAD,
                                         double ph, double pl1, bool l1r,
                                         double pl2,
                                         const double* __restrict__ qv, int K4,
                                         int steps) {
  const int seg_hi = min(seg_lo + (1 << lev), NPAD);
  int i_hi = search(row, seg_lo, seg_hi, ph, true, steps);
  const int i_l1 = search(row, seg_lo, seg_hi, pl1, l1r, steps);
  const int i_l2 = search(row, seg_lo, seg_hi, pl2, false, steps);
  const int i_lo = max(i_l1, i_l2);
  i_hi = max(i_hi, i_lo);
  const double* __restrict__ hi =
      i_hi > seg_lo ? crow + (long long)(i_hi - 1) * K4 : nullptr;
  const double* __restrict__ lo =
      i_lo > seg_lo ? crow + (long long)(i_lo - 1) * K4 : nullptr;
  double d = 0.0;
  for (int k = 0; k < K4; ++k) {
    const double a = hi ? hi[k] : 0.0;
    const double b = lo ? lo[k] : 0.0;
    d += qv[k] * (a - b);
  }
  return d;
}

__global__ void tree_query_f64_kernel(
    const double* __restrict__ pos, const double* __restrict__ cum,
    const int* __restrict__ r_lo, const int* __restrict__ r_hi,
    const double* __restrict__ pos_hi, const double* __restrict__ pos_lo1,
    const int* __restrict__ lo1_right, const double* __restrict__ pos_lo2,
    const double* __restrict__ q_vec, double* __restrict__ out, int LVL,
    int NPAD, int Q, int Wh, int K4, int q_tiles, int steps) {
  const int g = blockIdx.x / q_tiles;
  const int q = (blockIdx.x % q_tiles) * TQ + threadIdx.x;
  if (q >= Q) return;
  const long long gq = (long long)g * Q + q;
  const double ph = pos_hi[gq];
  const double pl1 = pos_lo1[gq];
  const double pl2 = pos_lo2[gq];
  const bool l1r = lo1_right[gq] != 0;
  const double* __restrict__ pos_g = pos + (long long)g * LVL * NPAD;
  const double* __restrict__ cum_g = cum + (long long)g * LVL * NPAD * K4;

  for (int w = threadIdx.y; w < Wh; w += blockDim.y) {
    const long long gwq = ((long long)g * Wh + w) * Q + q;
    const double* __restrict__ qv = q_vec + gwq * K4;
    int l = r_lo[gwq];
    int r = r_hi[gwq];
    double acc = 0.0;
    for (int lev = 0; lev < LVL; ++lev) {
      const double* __restrict__ row = pos_g + (long long)lev * NPAD;
      const double* __restrict__ crow = cum_g + (long long)lev * NPAD * K4;
      if (l < r && (l & 1)) {
        acc += bucket(row, crow, l << lev, lev, NPAD, ph, pl1, l1r, pl2, qv,
                      K4, steps);
        ++l;
      }
      if (l < r && (r & 1)) {
        acc += bucket(row, crow, (r - 1) << lev, lev, NPAD, ph, pl1, l1r, pl2,
                      qv, K4, steps);
        --r;
      }
      l >>= 1;
      r >>= 1;
    }
    out[gwq] = acc;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). All pointers are device pointers.
// Launches on `stream`, does not synchronise, allocates nothing; returns the
// cudaError_t of the launch (0 = ok), -1 for arguments the kernel does not
// take.
extern "C" int tree_query_f64(const double* pos, const double* cum,
                              const int* r_lo, const int* r_hi,
                              const double* pos_hi, const double* pos_lo1,
                              const int* lo1_right, const double* pos_lo2,
                              const double* q_vec, double* out, int G, int LVL,
                              int NPAD, int Q, int Wh, int K4, int device,
                              void* stream) {
  if (LVL < 0 || LVL > 31 || NPAD < 0 || K4 <= 0) return -1;
  if (LVL > 0 && NPAD <= 0) return -1;
  if (G <= 0 || Q <= 0 || Wh <= 0) return 0;  // empty output: nothing to do
  const long long q_tiles = (Q + TQ - 1) / TQ;
  if ((long long)G * q_tiles > 2147483647LL) return -1;
  int steps = 0;
  for (int n = NPAD; n; n >>= 1) ++steps;  // bit_length(NPAD)
  if (steps < 1) steps = 1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(TQ, Wh < WY_MAX ? Wh : WY_MAX);
  const dim3 grid((unsigned)(G * q_tiles));
  tree_query_f64_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      pos, cum, r_lo, r_hi, pos_hi, pos_lo1, lo1_right, pos_lo2, q_vec, out,
      LVL, NPAD, Q, Wh, K4, (int)q_tiles, steps);
  return (int)cudaGetLastError();
}
