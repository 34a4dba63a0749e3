// fold_tables — the window-table fold of the packed RFS executors, for
// NVIDIA Hopper (sm_90a): every node's q_t-folded paired window values,
// written once into the [R*2, W, 2*ks] table the walk reads in place.
//
// Added by the port; it replaces no TPU kernel. The reference folds with
// jitted jnp that XLA fuses (repro.core.jax_engine, the packed executors'
// node-table fold); the port's plain version is fold_tables.py's
// fold_node_tables_ref (a chunked loop of PyTorch searches and gathers).
//
// Contract: `time [n_time]` and `cum [n_time, 4, K]` (K = ks*kt, float64) are
// the packed forest's time-sorted runs and their inclusive raw-Phi prefix
// moments; `starts [R]` (int64) the first row of every node's run,
// level-major: level l owns nodes lvl_ptr[l] .. lvl_ptr[l+1], runs of 2^l
// rows, searched in steps[l] trips. `t_lo/t_hi [2W]` and `qt [2W, kt]` are
// the paired half-window batch (entry 2w the left half of centre w, 2w+1 its
// right half). For every (node n, window w), with s = starts[n]:
//     i_lo  = s + #{v in run : v <  t_lo[2w]}       (branch-free search,
//     i_mid = s + #{v in run : v <= t_hi[2w]}        fixed trips; +inf pads
//     i_hi  = s + #{v in run : v <= t_hi[2w+1]}      search to the run end)
//     P(i, c) = cum[i-1, c, :] if i > s else 0
//     out[2n+side, w, j]      = sum_t (P(i_mid, 2side)   - P(i_lo,  2side))[j*kt+t]   * qt[2w, t]
//     out[2n+side, w, ks + j] = sum_t (P(i_hi, 2side+1) - P(i_mid, 2side+1))[j*kt+t] * qt[2w+1, t]
// with the sum taken t = 0 first, then each further t added in turn: one
// rounding per subtract, multiply and add (__dsub_rn, __dmul_rn, __dadd_rn:
// no contraction), the plain version's order, so the float64 table equals
// the plain version's bit for bit. A float32 or bfloat16 table rounds only on
// store, as torch's .to() rounds a double: to float32 (__double2float_rn),
// then to bfloat16 (__float2bfloat16_rn). Searches and prefix rows clamp
// their row into the table, as the plain version's gathers do.
//
// What bounds it on this card: latency, not bytes. At berkeley's W = 24
// (2.2 M nodes) it writes a 3.3 GB float64 table and reads ~0.55 GB of
// prefix rows: 1.17 ms at full bandwidth, against 3.1-3.3 ms measured
// (35-38 %). Its float32 and bfloat16 tables write a half and a quarter of
// those bytes and take 2.98 and 2.94 ms against 3.16 ms for float64 in the
// same process (NVIDIA H100 80GB HBM3, 700 W). The time goes to dependent
// loads: a (node, window) item makes up to 12 search trips, each a load of
// the time row that the trip before chose, and its prefix rows can be
// loaded only once its ranks are known. The design does three things about
// it. (1) One launch a fold: every level at once, the
// per-level run length and trip count read from the launch's level table,
// so the host enqueues one kernel where the plain version enqueued
// thousands of small ones, and no transient copy of the table exists.
// (2) A block owns a tile of whole nodes x a range of windows (all W when W
// fits): it first runs the three searches of each (node, window) item in
// one loop, so that their three chains of loads are in flight together,
// and keeps the ranks in shared memory; then its threads walk the tile's
// output in memory order, one (row, window) run of 2*ks values each, so
// neighbouring threads store neighbouring runs and the tile, contiguous in
// the table, is written whole. (3) The W windows of a node share its run:
// their searches and prefix rows are read by neighbouring threads of one
// block and hit in L1/L2, so device memory sees each prefix row about once.
// Where the table is float64, ks and kt are even and the tables 16-byte
// aligned (PAIRED; ks = kt = 2 under the triangular kernels every benchmark
// cell runs), prefix rows and q_t are read two values a load and the table
// written two values a store: 3.24 ms against 4.46 ms one value at a time,
// float64 at W = 24 on the berkeley replica. For the float32 and bfloat16
// tables pairing gained nothing measurable (2.97 and 2.93 ms paired against
// 2.98 and 2.94 ms one value at a time, timed in turns in one process), so
// they keep the one-value path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 256;       // (node, window) items a block searches
constexpr int MAX_LEVELS = 31;   // runs of up to 2^30 rows: a rank fits an int

struct Levels {
  long long ptr[MAX_LEVELS + 1];  // first node of each level, and R
  int steps[MAX_LEVELS];          // search trips of each level
  int n;                          // levels
};

__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(float* p, double v) { *p = __double2float_rn(v); }
__device__ __forceinline__ void store(__nv_bfloat16* p, double v) {
  *p = __float2bfloat16_rn(__double2float_rn(v));
}
// two neighbouring values in one store (p aligned to two values)
__device__ __forceinline__ void store2(double* p, double u, double v) {
  *reinterpret_cast<double2*>(p) = make_double2(u, v);
}
__device__ __forceinline__ double2 load2(const double* p) {
  return __ldg(reinterpret_cast<const double2*>(p));
}
// acc (+)= (a - b) * q, one rounding each, the plain version's order
__device__ __forceinline__ double fold(double acc, bool first, double a, double b, double q) {
  const double term = __dmul_rn(__dsub_rn(a, b), q);
  return first ? term : __dadd_rn(acc, term);
}

// PAIRED (float64 tables only): ks and kt even and the tables 16-byte
// aligned — the prefix rows and q_t are read two values a load and the table
// written two values a store
template <typename T, bool PAIRED>
__global__ void __launch_bounds__(THREADS)
fold_tables_kernel(const double* __restrict__ time, long long n_time,
                   const double* __restrict__ cum, const long long* __restrict__ starts,
                   long long R, const __grid_constant__ Levels lv,
                   const double* __restrict__ t_lo,
                   const double* __restrict__ t_hi, const double* __restrict__ qt,
                   T* __restrict__ out, int W, int wb, int nb, int ks, int kt) {
  __shared__ int s_rank[3][ITEMS];  // i - s of lo, mid, hi per (node, window) item
  __shared__ long long s_start[ITEMS];

  const long long n0 = (long long)blockIdx.x * nb;
  const int w0 = blockIdx.y * wb;
  const int nn = (int)min((long long)nb, R - n0);  // nodes of this tile
  const int nw = min(wb, W - w0);                  // windows of this tile
  const long long last = n_time - 1;

  // (1) the three searches of every (node, window) item of the tile
  for (int e = threadIdx.x; e < nn * nw; e += THREADS) {
    const int nl = e / nw;
    const int w = w0 + e - nl * nw;
    const long long n = n0 + nl;
    int lev = 0;
    while (n >= lv.ptr[lev + 1]) ++lev;  // empty levels are passed over
    const long long s = starts[n];
    const long long run = 1LL << lev;
    const double q0 = t_lo[2 * w], q1 = t_hi[2 * w], q2 = t_hi[2 * w + 1];
    long long lo0 = s, hi0 = s + run, lo1 = s, hi1 = s + run, lo2 = s, hi2 = s + run;
    for (int k = 0; k < lv.steps[lev]; ++k) {
      const long long m0 = (lo0 + hi0) >> 1, m1 = (lo1 + hi1) >> 1, m2 = (lo2 + hi2) >> 1;
      const double v0 = time[min(max(m0, 0LL), last)];
      const double v1 = time[min(max(m1, 0LL), last)];
      const double v2 = time[min(max(m2, 0LL), last)];
      if (lo0 < hi0) {
        if (v0 < q0) lo0 = m0 + 1; else hi0 = m0;
      }
      if (lo1 < hi1) {
        if (v1 <= q1) lo1 = m1 + 1; else hi1 = m1;
      }
      if (lo2 < hi2) {
        if (v2 <= q2) lo2 = m2 + 1; else hi2 = m2;
      }
    }
    s_rank[0][e] = (int)(lo0 - s);
    s_rank[1][e] = (int)(lo1 - s);
    s_rank[2][e] = (int)(lo2 - s);
    if (w == w0) s_start[nl] = s;
  }
  __syncthreads();

  // (2) the tile's output in memory order: one (row, window) run of C values
  // a thread; row 2*nl + side of node n0 + nl
  const int C = 2 * ks, K = ks * kt;
  for (int e = threadIdx.x; e < 2 * nn * nw; e += THREADS) {
    const int r = e / nw;
    const int wl = e - r * nw;
    const int nl = r >> 1, side = r & 1;
    const int it = nl * nw + wl;
    const int w = w0 + wl;
    const long long s = s_start[nl];
    const int r0 = s_rank[0][it], r1 = s_rank[1][it], r2 = s_rank[2][it];
    T* o = out + ((2 * (n0 + nl) + side) * W + w) * C;
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // left: P(mid) - P(lo); right: P(hi) - P(mid)
      const int a = half ? r2 : r1, b = half ? r1 : r0;
      const long long ra = min(max(s + a - 1, 0LL), last);
      const long long rb = min(max(s + b - 1, 0LL), last);
      const int combo = 2 * side + half;
      const double* pa = cum + (ra * 4 + combo) * K;
      const double* pb = cum + (rb * 4 + combo) * K;
      const double* q = qt + (2LL * w + half) * kt;
      if constexpr (PAIRED) {
        const double2 zero = make_double2(0.0, 0.0);
        for (int j = 0; j < ks; j += 2) {
          double acc0 = 0.0, acc1 = 0.0;
          for (int t = 0; t < kt; t += 2) {
            const double2 a0 = a > 0 ? load2(pa + j * kt + t) : zero;
            const double2 a1 = a > 0 ? load2(pa + (j + 1) * kt + t) : zero;
            const double2 b0 = b > 0 ? load2(pb + j * kt + t) : zero;
            const double2 b1 = b > 0 ? load2(pb + (j + 1) * kt + t) : zero;
            const double2 qq = load2(q + t);
            acc0 = fold(fold(acc0, t == 0, a0.x, b0.x, qq.x), false, a0.y, b0.y, qq.y);
            acc1 = fold(fold(acc1, t == 0, a1.x, b1.x, qq.x), false, a1.y, b1.y, qq.y);
          }
          store2(o + half * ks + j, acc0, acc1);
        }
      } else {
        for (int j = 0; j < ks; ++j) {
          double acc = 0.0;
          for (int t = 0; t < kt; ++t)
            acc = fold(acc, t == 0, a > 0 ? pa[j * kt + t] : 0.0, b > 0 ? pb[j * kt + t] : 0.0,
                       q[t]);
          store(o + half * ks + j, acc);
        }
      }
    }
  }
}

template <typename T>
int launch(const double* time, long long n_time, const double* cum, const long long* starts,
           long long R, const long long* lvl_ptr, const int* steps, int n_levels,
           const double* t_lo, const double* t_hi, const double* qt, T* out, int W, int ks,
           int kt, int device, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || R < 0 || W < 0 || ks < 1 || kt < 1 ||
      n_time < 1)
    return -1;
  Levels lv;
  lv.n = n_levels;
  lv.ptr[0] = lvl_ptr[0];
  if (lv.ptr[0] != 0) return -1;
  for (int l = 0; l < n_levels; ++l) {
    lv.ptr[l + 1] = lvl_ptr[l + 1];
    lv.steps[l] = steps[l];
    if (lv.ptr[l + 1] < lv.ptr[l] || steps[l] < 0) return -1;
  }
  if (lv.ptr[n_levels] != R) return -1;
  if (R == 0 || W == 0) return 0;  // nothing to fold
  const int wb = W < ITEMS ? W : ITEMS;  // windows of a tile
  const int nb = ITEMS / wb;             // nodes of a tile
  const long long gx = (R + nb - 1) / nb;
  const int gy = (W + wb - 1) / wb;
  if (gx > 2147483647LL || gy > 65535) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  if constexpr (std::is_same<T, double>::value) {
    if (ks % 2 == 0 && kt % 2 == 0 && reinterpret_cast<size_t>(cum) % 16 == 0 &&
        reinterpret_cast<size_t>(qt) % 16 == 0 && reinterpret_cast<size_t>(out) % 16 == 0) {
      fold_tables_kernel<T, true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          time, n_time, cum, starts, R, lv, t_lo, t_hi, qt, out, W, wb, nb, ks, kt);
      return (int)cudaGetLastError();
    }
  }
  fold_tables_kernel<T, false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      time, n_time, cum, starts, R, lv, t_lo, t_hi, qt, out, W, wb, nb, ks, kt);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes), one entry per fold dtype. All
// tensor pointers are device pointers; `lvl_ptr [n_levels + 1]` and
// `steps [n_levels]` are host arrays. Launches one kernel on `stream`, does
// not synchronise, allocates nothing; returns the cudaError_t of the launch
// (0 = ok), -1 for arguments the kernel does not take.
#define FOLD_ENTRY(NAME, T)                                                                    \
  extern "C" int NAME(const double* time, long long n_time, const double* cum,                \
                      const long long* starts, long long R, const long long* lvl_ptr,          \
                      const int* steps, int n_levels, const double* t_lo, const double* t_hi,  \
                      const double* qt, T* out, int W, int ks, int kt, int device,             \
                      void* stream) {                                                          \
    return launch<T>(time, n_time, cum, starts, R, lvl_ptr, steps, n_levels, t_lo, t_hi, qt,   \
                     out, W, ks, kt, device, stream);                                          \
  }

FOLD_ENTRY(fold_tables_f64, double)
FOLD_ENTRY(fold_tables_f32, float)
FOLD_ENTRY(fold_tables_bf16, __nv_bfloat16)
