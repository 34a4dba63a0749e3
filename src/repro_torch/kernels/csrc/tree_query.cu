// tree_query — the merge-tree range query of static RFS (the paper's
// Algorithm 2) over the time-major tables of the flat forest, float64, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/tree_query.py::tree_query_pallas
// (body _kernel). Inputs: the flat forest as it is, pos_flat [T] (+inf
// padded) and cum_flat [T, 4K], K = k_s·k_t; base [G] int64, the first row
// of each group's edge block (level lev of the edge is rows
// base + lev·NPAD + [0, NPAD), LVL = bit_length(NPAD) levels); per-edge rank
// intervals r_lo/r_hi [G, Wh] int32; per slot pos_hi/pos_lo1/pos_lo2 [G, Q],
// lo1_right and side [G, Q] int32, qs [G, Q, k_s] (padding slots zero); per
// half-window qt [Wh, k_t] and half [Wh] int32. Out [G, Q, Wh] with
//     out[g, q, w] = sum over the <= 2 buckets per level that the canonical
//                    decomposition of [r_lo, r_hi) emits (levels ascending,
//                    left bucket before right) of
//                    sum_{s, t} (qs[g, q, s]·qt[w, t]) ·
//                        (pref(i_hi)[c·K + s·k_t + t] − pref(i_lo)[...]),
// (s, t) in s-major order, c = side·2 + half[w], where [i_lo, i_hi) is the
// part of the bucket's segment whose positions pass the slot's three bounds
// and pref(i) = cum row (edge, lev, i − 1) (0 when i is the segment start).
// That is the reference's product with a one-hot q_vec [G, Wh, Q, 4K] whose
// other three combos are zeros: those only add ±0, so this agrees with the
// q_vec form bit for bit up to the sign of a zero. It is the association of
// the plain version (tree_query_ref); the two differ only where the
// compiler contracts a multiply-add.
//
// Ranking a bound. The Pallas body turns each bucket search into a masked
// compare-count over the whole VMEM row, then a matmul (the TPU has no cheap
// gather). Here each bound is ranked by a branch-free binary search over the
// bucket's segment pos[lev][seg_lo : seg_lo + 2^lev], lev + 1 trips (enough
// for a segment of 2^lev entries; a finished lane keeps its state, so this
// is the same insertion point as bit_length(NPAD) trips). The RangeForest
// build sorts every segment by position with its +inf padding at the end,
// so the predicate (v <= bound for right = true, v < bound for right =
// false) holds on a prefix of the segment, and the search returns the
// length of that prefix — the compare-count. The searches use right =
// (true, lo1_right, false) for (pos_hi, pos_lo1, pos_lo2).
//
// What bounds it on this card: bytes, and the latency of the dependent
// searches. It builds the K query values it needs from qs and qt instead of
// reading a 4K-wide query row (three quarters zeros), reads only the slot's
// combo columns of a prefix row, and reads the tables where the forest
// holds them, with no per-call copy.
//
// Mapping: one block per edge group g, holding all of its slots and
// half-windows. When the caller sets `staged` (ops.tree_staged: the edge's
// block, LVL·NPAD·(1 + 4K)·8 bytes, fits its budget), the block copies it
// into shared memory once (coalesced) and
// every search and prefix-row read hits shared memory; the staged prefix
// rows are padded to an odd stride of 4K + 1 values, so the lanes of a warp
// reading one column of different rows fall in different banks (at 4K = 16
// every row would start in the same bank). Otherwise the reads go through
// L1/L2. The per-half-window state (qt, half, the rank interval) is staged
// once; the slots' bounds, sides and qs are staged in chunks of `qc` slots
// and shared by the Wh half-windows of each slot. A thread takes the pairs
// idx = w·nq + q of a chunk, so the lanes of a warp share a half-window —
// its rank interval, hence the level loop and the buckets it emits, are the
// same on every lane, and a warp runs only the buckets its lanes need (a
// warp that mixed half-windows would run both sides of every level where
// any lane emits). The three searches of a bucket advance together.
// Results go to a [qc, Wh] tile in shared memory, written out as one
// contiguous, coalesced block of [G, Q, Wh]. A thread walks the levels in
// order with one scalar sum: no register array sized by K, which reaches
// 121 (4K = 484) with the gaussian kernels. Its arithmetic does not depend
// on its window index: two half-windows with identical inputs give bitwise
// identical outputs. All table offsets are 64-bit.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int QC_MAX = 128;           // slots per pass
constexpr int SMEM_CAP = 227 * 1024;  // dynamic shared memory a block may use

// One step of a branch-free binary search of val in row[lo:hi] (ascending):
// the insertion point, after equal values when `right`. A finished search
// (lo == hi) keeps its state and reads row[0].
__device__ __forceinline__ void search_step(const double* row, int& lo, int& hi, double val,
                                            bool right) {
  const bool live = lo < hi;
  const int m = (lo + hi) >> 1;
  const double v = row[live ? m : 0];
  const bool go = live && (right ? v <= val : v < val);
  lo = go ? m + 1 : lo;
  hi = (go || !live) ? hi : m;
}

// One emitted bucket: rank the three bounds in the segment (the three
// searches advance together, for instruction-level parallelism), then the
// dot of the prefix-moment difference over the combo's K columns with
// qs[s]·qt[t], (s, t) s-major. `crow` points at the combo's first column
// of the level's first prefix row; rows are `cs` values apart.
__device__ __forceinline__ double bucket(const double* row, const double* crow, int cs,
                                         int seg_lo, int lev, int NPAD, double ph, double pl1,
                                         bool l1r, double pl2, const double* qsr,
                                         const double* qtr, int ks, int kt) {
  const int seg_hi = min(seg_lo + (1 << lev), NPAD);
  int lo_h = seg_lo, hi_h = seg_hi, lo_1 = seg_lo, hi_1 = seg_hi, lo_2 = seg_lo, hi_2 = seg_hi;
  for (int step = 0; step <= lev; ++step) {
    search_step(row, lo_h, hi_h, ph, true);
    search_step(row, lo_1, hi_1, pl1, l1r);
    search_step(row, lo_2, hi_2, pl2, false);
  }
  const int i_lo = max(lo_1, lo_2);
  const int i_hi = max(lo_h, i_lo);
  const double* hi = i_hi > seg_lo ? crow + (long long)(i_hi - 1) * cs : nullptr;
  const double* lo = i_lo > seg_lo ? crow + (long long)(i_lo - 1) * cs : nullptr;
  double d = 0.0;
  for (int s = 0, k = 0; s < ks; ++s) {
    const double a_s = qsr[s];
    for (int t = 0; t < kt; ++t, ++k) {
      const double qv = a_s * qtr[t];
      const double a = hi ? hi[k] : 0.0;
      const double b = lo ? lo[k] : 0.0;
      d += qv * (a - b);
    }
  }
  return d;
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS) tree_query_f64_kernel(
    const double* __restrict__ pos_flat, const double* __restrict__ cum_flat,
    const long long* __restrict__ base, const int* __restrict__ r_lo,
    const int* __restrict__ r_hi, const double* __restrict__ pos_hi,
    const double* __restrict__ pos_lo1, const int* __restrict__ lo1_right,
    const double* __restrict__ pos_lo2, const double* __restrict__ qs,
    const double* __restrict__ qt, const int* __restrict__ side, const int* __restrict__ half,
    double* __restrict__ out, int NPAD, int LVL, int Q, int Wh, int ks, int kt, int qc) {
  extern __shared__ double smem[];
  const int g = blockIdx.x, tid = threadIdx.x;
  const int K4 = 4 * ks * kt;
  const int cs = STAGED ? K4 + 1 : K4;  // staged prefix rows are padded to an odd stride
  const long long rows = (long long)LVL * NPAD;
  const long long b0 = base[g];
  // shared layout (doubles first, then ints): [pos block, cum block when
  // STAGED] qt [Wh·kt], qs [qc·ks], bounds [3·qc], out [qc·Wh], then int
  // lo1_right|side<<1 [qc], half [Wh], r_lo [Wh], r_hi [Wh]
  double* s_tab = smem;
  double* s_qt = s_tab + (STAGED ? rows * (1 + cs) : 0);
  double* s_qs = s_qt + Wh * kt;
  double* s_ph = s_qs + qc * ks;
  double* s_pl1 = s_ph + qc;
  double* s_pl2 = s_pl1 + qc;
  double* s_out = s_pl2 + qc;
  int* s_flags = reinterpret_cast<int*>(s_out + qc * Wh);
  int* s_half = s_flags + qc;
  int* s_rlo = s_half + Wh;
  int* s_rhi = s_rlo + Wh;

  if (STAGED) {
    const double* __restrict__ pg = pos_flat + b0;
    const double* __restrict__ cg = cum_flat + b0 * K4;
    for (long long i = tid; i < rows; i += THREADS) s_tab[i] = pg[i];
    for (long long i = tid; i < rows * K4; i += THREADS)
      s_tab[rows + (i / K4) * cs + i % K4] = cg[i];
  }
  for (int i = tid; i < Wh * kt; i += THREADS) s_qt[i] = qt[i];
  for (int i = tid; i < Wh; i += THREADS) {
    s_half[i] = half[i];
    s_rlo[i] = r_lo[(long long)g * Wh + i];
    s_rhi[i] = r_hi[(long long)g * Wh + i];
  }
  const double* P = STAGED ? s_tab : pos_flat + b0;
  const double* C = STAGED ? s_tab + rows : cum_flat + b0 * K4;

  for (int q0 = 0; q0 < Q; q0 += qc) {
    const int nq = min(qc, Q - q0);
    __syncthreads();  // the previous chunk is consumed and written out
    const long long gq0 = (long long)g * Q + q0;
    for (int i = tid; i < nq; i += THREADS) {
      s_ph[i] = pos_hi[gq0 + i];
      s_pl1[i] = pos_lo1[gq0 + i];
      s_pl2[i] = pos_lo2[gq0 + i];
      s_flags[i] = (lo1_right[gq0 + i] != 0) | ((side[gq0 + i] & 1) << 1);
    }
    for (int i = tid; i < nq * ks; i += THREADS) s_qs[i] = qs[gq0 * ks + i];
    __syncthreads();
    // pairs idx = w·nq + q: the lanes of a warp share a half-window, hence
    // its rank interval and the sequence of buckets it emits
    for (int idx = tid; idx < nq * Wh; idx += THREADS) {
      const int w = idx / nq, q = idx - w * nq;
      const double ph = s_ph[q], pl1 = s_pl1[q], pl2 = s_pl2[q];
      if (ph < pl1 || ph < pl2) {
        // every position <= ph fails a lower bound: each bucket's interval
        // is empty and adds an exact zero (the padding slots of the grouped
        // layout, with bounds -inf / +inf, among them)
        s_out[q * Wh + w] = 0.0;
        continue;
      }
      const int flags = s_flags[q];
      const bool l1r = flags & 1;
      const int col0 = (((flags >> 1) << 1) + s_half[w]) * ks * kt;
      const double* qsr = s_qs + q * ks;
      const double* qtr = s_qt + w * kt;
      int l = s_rlo[w], r = s_rhi[w];
      double acc = 0.0;
      for (int lev = 0; lev < LVL; ++lev) {
        const double* row = P + (long long)lev * NPAD;
        const double* crow = C + (long long)lev * NPAD * cs + col0;
        if (l < r && (l & 1)) {
          acc += bucket(row, crow, cs, l << lev, lev, NPAD, ph, pl1, l1r, pl2, qsr, qtr, ks, kt);
          ++l;
        }
        if (l < r && (r & 1)) {
          acc += bucket(row, crow, cs, (r - 1) << lev, lev, NPAD, ph, pl1, l1r, pl2, qsr, qtr,
                        ks, kt);
          --r;
        }
        l >>= 1;
        r >>= 1;
      }
      s_out[q * Wh + w] = acc;
    }
    __syncthreads();
    // the chunk's [nq, Wh] block of out is contiguous: coalesced stores
    double* __restrict__ og = out + gq0 * Wh;
    for (int i = tid; i < nq * Wh; i += THREADS) og[i] = s_out[i];
  }
}

long long smem_bytes(long long table, int Wh, int ks, int kt, int qc) {
  return table + 8LL * (Wh * kt + (long long)qc * (ks + 3 + Wh)) + 4LL * (qc + 3LL * Wh);
}

template <bool STAGED>
int launch(const double* pos_flat, const double* cum_flat, const long long* base, const int* r_lo,
           const int* r_hi, const double* pos_hi, const double* pos_lo1, const int* lo1_right,
           const double* pos_lo2, const double* qs, const double* qt, const int* side,
           const int* half, double* out, int G, int NPAD, int LVL, int Q, int Wh, int ks, int kt,
           int qc, long long bytes, cudaStream_t stream) {
  auto kern = tree_query_f64_kernel<STAGED>;
  static long long attr_set = 48 * 1024;  // the default limit; raised once per instance
  if (bytes > attr_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = bytes;
  }
  kern<<<G, THREADS, (size_t)bytes, stream>>>(pos_flat, cum_flat, base, r_lo, r_hi, pos_hi,
                                              pos_lo1, lo1_right, pos_lo2, qs, qt, side, half,
                                              out, NPAD, LVL, Q, Wh, ks, kt, qc);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). All pointers are device pointers.
// The edge block is staged in shared memory when `staged` is nonzero (set
// by ops.tree_staged). Launches on `stream`, does not synchronise, allocates
// nothing; returns the cudaError_t of the launch (0 = ok), -1 for arguments
// the kernel does not take.
extern "C" int tree_query_f64(const double* pos_flat, const double* cum_flat,
                              const long long* base, const int* r_lo, const int* r_hi,
                              const double* pos_hi, const double* pos_lo1, const int* lo1_right,
                              const double* pos_lo2, const double* qs, const double* qt,
                              const int* side, const int* half, double* out, int G, int NPAD,
                              int Q, int Wh, int ks, int kt, int staged, int device,
                              void* stream) {
  if (NPAD < 0 || ks <= 0 || kt <= 0) return -1;
  int LVL = 0;
  for (int n = NPAD; n; n >>= 1) ++LVL;  // bit_length(NPAD)
  if (LVL > 31) return -1;
  if (G <= 0 || Q <= 0 || Wh <= 0) return 0;  // empty output: nothing to do
  const long long K4 = 4LL * ks * kt;
  const long long rows = (long long)LVL * NPAD;
  const long long table = staged ? rows * (2 + K4) * 8 : 0;  // staged with padded rows
  int qc = Q < QC_MAX ? Q : QC_MAX;
  while (qc > 1 && smem_bytes(table, Wh, ks, kt, qc) > SMEM_CAP) qc >>= 1;
  const long long bytes = smem_bytes(table, Wh, ks, kt, qc);
  if (bytes > SMEM_CAP) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  return staged ? launch<true>(pos_flat, cum_flat, base, r_lo, r_hi, pos_hi, pos_lo1, lo1_right,
                               pos_lo2, qs, qt, side, half, out, G, NPAD, LVL, Q, Wh, ks, kt, qc,
                               bytes, st)
                : launch<false>(pos_flat, cum_flat, base, r_lo, r_hi, pos_hi, pos_lo1, lo1_right,
                                pos_lo2, qs, qt, side, half, out, G, NPAD, LVL, Q, Wh, ks, kt, qc,
                                bytes, st);
}
