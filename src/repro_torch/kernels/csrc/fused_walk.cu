// fused_walk — the packed-plan canonical climb + window contraction in one
// launch, for NVIDIA Hopper (sm_90a), reading the flat window table in place.
// The table is stored as T in {double, float, __nv_bfloat16} (the table
// codec's fold dtype: entries fused_walk_f64, fused_walk_f32,
// fused_walk_bf16); every loaded value is widened to double in registers,
// and the sums, the per-warp row in shared memory, qs and the output are
// double — float64 arithmetic on the stored values, for every T.
//
// Replaces the TPU kernels src/repro/kernels/fused_walk.py::fused_walk_pallas
// (body _fused_walk_kernel) and src/repro/kernels/dyn_query.py::
// dyn_node_walk_pallas (the same climb over the complete tree). Inputs:
// table [n_rows, wc] with wc = W*2*ks (a row is one (node, side): the q_t-
// folded [ks left | ks right] values of every window), lvl_base [>= nlev, E]
// int64 node base per (walk level, edge), edges [G] int64, r_lo/r_hi/side
// [G, Q] int32, qs [G, Q, ks]. Walk level lev of atom (g, q) reads row
//     (lvl_base[lev, edges[g]] + node) * 2 + side,
// clamped to the edge's block [e*blk_rows, e*blk_rows + blk_rows) when
// blk_rows > 0 (the grouped JAX contract: lvl_base[lev, g] = g*R2/2 +
// offs[lev], edges = arange(G), the reference's clamp), else to the table.
// Out, through the strides (so_g, so_q, so_w), so the flush gets [G, Q, W]
// and the JAX contract [G, W, Q]:
//     out[g, q, w] = sum_s qs[g, q, s] * (acc[w, s] + acc[w, ks + s]),
//     acc[w, :]    = sum over the <= 2 nodes per level emitted by the
//                    canonical climb of [r_lo, r_hi) of the row's window w,
// left emit before right emit, levels ascending, a level that emits nothing
// adding 0.0 — the association of the plain versions (fused_walk_ref,
// fused_walk_flat_ref), so they differ only where the compiler contracts a
// multiply-add.
//
// What bounds it on this card: bytes. Per atom the climb reads at most
// 2*nlev rows of wc*sizeof(T) bytes, all of one edge (the rows of an edge are shared
// by all of its atoms), plus ks*8 + 12 bytes of coefficients and rank state,
// and writes W*8 bytes; one add per loaded value. In the main path's packs
// most slots are padding (r_lo == r_hi), so the output and the rank state
// are most of the bytes. What held it back was instruction issue: a warp
// that ran the climb for one atom repeated every scalar instruction on 32
// lanes, so the climb now runs on one thread per atom.
//
// Mapping: one block per (edge group g, chunk of blockDim slots): a pack of
// few edges with many atoms each (large npad) still fills the card. Each
// thread reads one slot's rank interval and side (coalesced, issued before
// the lvl_base load so their latencies overlap); the block zero-fills the
// chunk's outputs (coalesced along the unit stride) and compacts the live
// slots (r_lo < r_hi; the others emit nothing and their output is 0) into a
// list in shared memory. Then the climb runs once per atom, on the thread
// of its slot: it computes the rows of all <= 2*nlev emits from (l, r)
// alone and writes them to shared memory (2*nlev + 1 ints apart, so the
// writes of neighbouring threads fall in different banks). After one
// barrier a warp owns one live atom at a time: it reads the atom's row
// indices as broadcasts and its lanes read each emitted row as one
// contiguous, coalesced segment, lane c holding column c (wc > 32: in passes
// of 32 columns); no address depends on loaded data, so the 2*LC loads of a
// step are in flight together (LC, a template parameter, covers the depths
// the paths give; deeper layouts loop). The accumulated row goes to the
// warp's slot in shared memory; lane w then contracts window w with qs
// (prefetched, lane s holding qs[s], taken by shuffle) in s order. That
// arithmetic does not depend on the window index: two windows with
// identical values give bitwise identical outputs. Carrying two atoms per
// warp (two independent load chains) was tried and dropped: it gained a
// little on the RFS packs and lost on the DRFS tree, whose unrolled form
// then needs twice the registers and loses occupancy.
//
// STAGED: the edge's block — level lev's npad >> lev nodes at lvl_base[lev,
// e], each level a contiguous segment of the table — is copied once into
// shared memory as T with cp.async (levels stacked, level lev at node offset
// 2*npad - 2*(npad >> lev)) while the chunk's slots are scanned, and
// every emitted row is then read from shared memory. It needs a power-of-two
// npad, nlev = bit_length(npad), ranks within [0, npad] and a 16-byte
// aligned table. A node (two rows of wc values of T) is a multiple of 16
// bytes for double and float (wc = W*2*ks is even) and of 8 bytes for
// bfloat16: where it is not a multiple of 16 (W*ks odd) the copy moves
// 8-byte pieces. A narrow T holds 2x (float) or 4x (bfloat16) the nodes in
// the same shared memory. Otherwise rows are read through L1/L2. Row
// indices are 32-bit (n_rows < 2^31), offsets 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 32;  // lvl_base rows a launch may walk
constexpr int MAX_THREADS = 256;
constexpr int SMEM_CAP = 227 * 1024;  // dynamic shared memory a block may use

struct WalkArgs {
  const void* table;  // [n_rows, wc] of T
  long long n_rows;
  const long long* lvl_base;
  long long n_edges;  // lvl_base's row stride
  const long long* edges;
  const int* r_lo;
  const int* r_hi;
  const int* side;
  const double* qs;
  double* out;
  long long so_g, so_q, so_w;
  int wc, Q, W, ks, nlev, npad, blk_rows;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ double widen(float x) { return static_cast<double>(x); }
__device__ __forceinline__ double widen(__nv_bfloat16 x) {
  return static_cast<double>(__bfloat162float(x));
}

// bytes of the staged edge block (2*npad - 1 nodes of two rows of wc values
// of T), rounded up to 16 so that the double rows after it stay aligned
__host__ __device__ __forceinline__ long long stage_bytes(int npad, int wc, int itemsize) {
  return (2LL * (2LL * npad - 1) * wc * itemsize + 15) / 16 * 16;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <typename T, int LC, bool STAGED>
__global__ void __launch_bounds__(MAX_THREADS) fused_walk_kernel(WalkArgs a) {
  // dynamic: [staged block (T) | per-warp rows (wc doubles) | rows of the live atoms' emits]
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long s_base[MAX_LEVELS];
  __shared__ int s_q[MAX_THREADS];
  __shared__ int s_wcount[MAX_THREADS / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int g = blockIdx.x;
  const int wc = a.wc, nlev = a.nlev;
  const int q0 = blockIdx.y * nthreads;
  const int nq = min(nthreads, a.Q - q0);
  const long long gq0 = (long long)g * a.Q + q0;
  int lo = 0, hi = 0, sd = 0;
  if (tid < nq) {  // issued first: their latency overlaps the lvl_base load
    lo = a.r_lo[gq0 + tid];
    hi = a.r_hi[gq0 + tid];
    sd = a.side[gq0 + tid];
  }
  const long long e = a.edges[g];
  if (tid < nlev) s_base[tid] = a.lvl_base[(long long)tid * a.n_edges + e];
  __syncthreads();

  const int npad = a.npad;
  const int staged_rows = STAGED ? 2 * (2 * npad - 1) : 0;
  const long long sbytes = STAGED ? stage_bytes(npad, wc, sizeof(T)) : 0;
  const T* table = static_cast<const T*>(a.table);
  double* srow = reinterpret_cast<double*>(smem + sbytes) + (long long)warp * wc;
  // row indices of each live atom's emits, 2*nlev + 1 ints apart (odd: the
  // writes of neighbouring threads fall in different banks)
  const int rs = 2 * nlev + 1;
  int* s_rows = reinterpret_cast<int*>(smem + sbytes + (long long)nwarps * wc * sizeof(double));
  if (STAGED) {  // copy the edge block in, level by level; waited for below
    const long long node_bytes = 2LL * wc * sizeof(T);
    for (int lev = 0; lev < nlev; ++lev) {
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(table + s_base[lev] * 2 * wc);
      unsigned char* dst = smem + (long long)(2 * npad - 2 * (npad >> lev)) * node_bytes;
      const long long nbytes = (long long)(npad >> lev) * node_bytes;
      if (node_bytes % 16 == 0) {
        for (long long i = 16LL * tid; i < nbytes; i += 16LL * nthreads)
          cp_async16(dst + i, src + i);
      } else {  // a bfloat16 node of 8 (mod 16) bytes
        for (long long i = 8LL * tid; i < nbytes; i += 8LL * nthreads) cp_async8(dst + i, src + i);
      }
    }
  }
  long long row_lo = 0, row_hi = a.n_rows - 1;
  if (a.blk_rows > 0) {
    row_lo = e * a.blk_rows;
    row_hi = row_lo + a.blk_rows - 1;
  }
  const T* __restrict__ src = STAGED ? reinterpret_cast<const T*>(smem) : table;
  double* __restrict__ out = a.out + g * a.so_g + q0 * a.so_q;

  // ---- scan: zero-fill the chunk's outputs, compact the live slots
  if (a.so_w == 1 && a.so_q == a.W) {  // [.., Q, W]: the chunk is contiguous
    for (int i = tid; i < nq * a.W; i += nthreads) out[i] = 0.0;
  } else {
    for (int w = 0; w < a.W; ++w)
      for (int qi = tid; qi < nq; qi += nthreads) out[qi * a.so_q + (long long)w * a.so_w] = 0.0;
  }
  const bool live = tid < nq && lo < hi;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) s_wcount[warp] = __popc(ballot);
  __syncthreads();
  int pos = __popc(ballot & ((1u << lane) - 1u)), nlive = 0;
  for (int j = 0; j < nwarps; ++j) {
    pos += j < warp ? s_wcount[j] : 0;
    nlive += s_wcount[j];
  }
  // ---- the climb, once per atom, by the thread of its slot: every emit's
  // row from (l, r) alone, before any row is loaded
  if (live) {
    s_q[pos] = tid;
    int* rows = s_rows + pos * rs;
    int l = lo, r = hi;
    for (int lev = 0; lev < nlev; ++lev) {
      const bool el = l < r && (l & 1);
      const bool er = l + el < r && (r & 1);
      const long long base = STAGED ? 2 * npad - 2 * (npad >> lev) : s_base[lev];
      long long il = (base + l) * 2 + sd, ir = (base + r - 1) * 2 + sd;
      if (STAGED) {
        il = min(max(il, 0LL), (long long)staged_rows - 1);
        ir = min(max(ir, 0LL), (long long)staged_rows - 1);
      } else {
        il = min(max(il, row_lo), row_hi);
        ir = min(max(ir, row_lo), row_hi);
      }
      rows[2 * lev] = el ? (int)il : -1;
      rows[2 * lev + 1] = er ? (int)ir : -1;
      l = (l + el) >> 1;
      r = (r - er) >> 1;
    }
  }
  if (STAGED) cp_async_wait_all();
  __syncthreads();  // the zero-fill lands before any live write; rows and list complete

  // ---- a warp per live atom: its rows read as coalesced segments
  const int ne = 2 * nlev;
  for (int k = warp; k < nlive; k += nwarps) {
    const int* rows = s_rows + k * rs;
    const int qi = s_q[k];
    const double* __restrict__ qv = a.qs + (gq0 + qi) * a.ks;
    const double q_lane = lane < a.ks ? qv[lane] : 0.0;  // taken by shuffle below
    for (int c0 = 0; c0 < wc; c0 += 32) {
      const int c = c0 + lane;
      double acc = 0.0;
      for (int i0 = 0; i0 < ne; i0 += 2 * LC) {
        double v[2 * LC];
#pragma unroll
        for (int i = 0; i < 2 * LC; ++i) {
          const int row = i0 + i < ne ? rows[i0 + i] : -1;
          v[i] = (row >= 0 && c < wc) ? widen(src[(long long)row * wc + c]) : 0.0;
        }
#pragma unroll
        for (int i = 0; i < 2 * LC; ++i) acc += v[i];
      }
      if (c < wc) srow[c] = acc;
    }
    __syncwarp();
    for (int w0 = 0; w0 < a.W; w0 += 32) {  // all lanes run the shuffles
      const int w = w0 + lane;
      const double* p = srow + min(w, a.W - 1) * 2 * a.ks;
      double t = 0.0;
      for (int s = 0; s < a.ks; ++s) {
        const double q = s < 32 ? __shfl_sync(0xffffffffu, q_lane, s) : qv[s];
        t = s ? t + q * (p[s] + p[a.ks + s]) : q * (p[0] + p[a.ks]);
      }
      if (w < a.W) out[qi * a.so_q + (long long)w * a.so_w] = t;
    }
    __syncwarp();  // the warp's row slot is reused by its next atom
  }
}

template <typename T, int LC, bool STAGED>
cudaError_t launch_form(const WalkArgs& a, dim3 grid, int threads, size_t smem,
                        cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(fused_walk_kernel<T, LC, STAGED>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  fused_walk_kernel<T, LC, STAGED><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int LC>
cudaError_t launch(const WalkArgs& a, dim3 grid, int threads, size_t smem, bool staged,
                   cudaStream_t stream) {
  return staged ? launch_form<T, LC, true>(a, grid, threads, smem, stream)
                : launch_form<T, LC, false>(a, grid, threads, smem, stream);
}

template <typename T>
int fused_walk(const T* table, long long n_rows, const long long* lvl_base, long long n_edges,
               const long long* edges, const int* r_lo, const int* r_hi, const int* side,
               const double* qs, double* out, long long so_g, long long so_q, long long so_w,
               int G, int Q, int W, int ks, int nlev, int npad, int blk_rows, int staged,
               int device, void* stream) {
  if (G <= 0 || Q <= 0 || W <= 0) return 0;  // empty output: nothing to do
  if (nlev < 0 || nlev > MAX_LEVELS || ks <= 0 || n_rows <= 0 || n_rows > 2147483647LL ||
      blk_rows < 0 || n_edges <= 0)
    return -1;
  const int wc = W * 2 * ks;
  if (staged && (npad <= 0 || (npad & (npad - 1)) || 32 - __builtin_clz(npad) != nlev ||
                 ((unsigned long long)table & 15)))
    return -1;
  const long long staged_bytes = staged ? stage_bytes(npad, wc, sizeof(T)) : 0;
  // per thread: a warp's row slot share and one atom's emit rows
  const long long per_thread = (long long)wc * 8 / 32 + (2LL * nlev + 1) * 4;
  int threads = MAX_THREADS;
  while (threads > 32 && staged_bytes + threads * per_thread + 8 > SMEM_CAP) threads -= 32;
  const long long smem = staged_bytes + (threads / 32) * (long long)wc * 8 +
                         (long long)threads * (2LL * nlev + 1) * 4;
  if (smem > SMEM_CAP) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  WalkArgs a{table, n_rows, lvl_base, n_edges, edges, r_lo, r_hi, side, qs, out,
             so_g, so_q, so_w, wc, Q, W, ks, nlev, npad, blk_rows};
  const long long chunks = (Q + threads - 1) / threads;
  if (G > 2147483647LL || chunks > 65535) return -1;
  const dim3 grid((unsigned)G, (unsigned)chunks);
  const cudaStream_t st = (cudaStream_t)stream;
  const bool stg = staged != 0;
  const size_t sm = (size_t)smem;
  if (nlev <= 3) return (int)launch<T, 3>(a, grid, threads, sm, stg, st);
  if (nlev <= 6) return (int)launch<T, 6>(a, grid, threads, sm, stg, st);
  if (nlev <= 9) return (int)launch<T, 9>(a, grid, threads, sm, stg, st);
  return (int)launch<T, 12>(a, grid, threads, sm, stg, st);
}

}  // namespace

// Plain C interface (loaded with ctypes), one entry per table type with the
// same arguments. All pointers are device pointers. Launches on `stream`,
// does not synchronise, allocates nothing; returns the cudaError_t of the
// launch (0 = ok), -1 for arguments the kernel does not take. `staged` asks
// for the shared-memory copy of the edge block (npad a power of two, nlev =
// bit_length(npad), a 16-byte aligned table); the threads per block shrink
// until the block's shared memory fits.
extern "C" int fused_walk_f64(const double* table, long long n_rows, const long long* lvl_base,
                              long long n_edges, const long long* edges, const int* r_lo,
                              const int* r_hi, const int* side, const double* qs, double* out,
                              long long so_g, long long so_q, long long so_w, int G, int Q,
                              int W, int ks, int nlev, int npad, int blk_rows, int staged,
                              int device, void* stream) {
  return fused_walk(table, n_rows, lvl_base, n_edges, edges, r_lo, r_hi, side, qs, out, so_g,
                    so_q, so_w, G, Q, W, ks, nlev, npad, blk_rows, staged, device, stream);
}

extern "C" int fused_walk_f32(const float* table, long long n_rows, const long long* lvl_base,
                              long long n_edges, const long long* edges, const int* r_lo,
                              const int* r_hi, const int* side, const double* qs, double* out,
                              long long so_g, long long so_q, long long so_w, int G, int Q,
                              int W, int ks, int nlev, int npad, int blk_rows, int staged,
                              int device, void* stream) {
  return fused_walk(table, n_rows, lvl_base, n_edges, edges, r_lo, r_hi, side, qs, out, so_g,
                    so_q, so_w, G, Q, W, ks, nlev, npad, blk_rows, staged, device, stream);
}

extern "C" int fused_walk_bf16(const __nv_bfloat16* table, long long n_rows,
                               const long long* lvl_base, long long n_edges,
                               const long long* edges, const int* r_lo,
                               const int* r_hi, const int* side, const double* qs, double* out,
                               long long so_g, long long so_q, long long so_w, int G, int Q,
                               int W, int ks, int nlev, int npad, int blk_rows, int staged,
                               int device, void* stream) {
  return fused_walk(table, n_rows, lvl_base, n_edges, edges, r_lo, r_hi, side, qs, out, so_g,
                    so_q, so_w, G, Q, W, ks, nlev, npad, blk_rows, staged, device, stream);
}
