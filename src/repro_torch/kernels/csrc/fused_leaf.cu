// fused_leaf — the quantized DRFS tree phase in one launch: leaf-prefix
// difference plus the q_s (x) q_t window contraction, for NVIDIA Hopper
// (sm_90a), reading the flat leaf-prefix table in place. The table is stored
// as T in {double, float} (the table codec's moment dtype: entries
// fused_leaf_f64, fused_leaf_f32; the bfloat16 preset stores its moments as
// float); both prefix values are widened to double before the difference,
// and all arithmetic, qs, qtl/qtr and the output are double.
//
// Replaces the TPU kernel src/repro/kernels/fused_walk.py::fused_leaf_pallas
// (body _fused_leaf_kernel), and under the kernel executor
// src/repro/kernels/dyn_query.py::dyn_leaf_query_pallas, whose materialised
// query vectors qv = q_s (x) q_t are this kernel's own, s-major
// (ops.dyn_leaf_query_flat counts those launches). Inputs: lcum [n_rows, W*2*K] leaf-prefix rows,
// R = (nleaf+1)*2 rows per edge (row = leaf*2 + side within the edge's
// block, each row packing [K left-half | K right-half] for every window),
// edges [G] int64, leaf_lo/leaf_hi/side [G, Q] int32, qs [G, Q, ks],
// qtl/qtr [W, kt] with K = ks*kt. Atom (g, q) reads the rows
//     edges[g]*R + clamp(leaf*2 + side, 0, R - 1)
// for leaf = leaf_hi and leaf_lo: torch_engine.dyn_window_tables' layout
// read where it lies; the grouped JAX contract is edges = arange(G) on
// [G*R, W*2*K]. Out, through the strides (so_g, so_q, so_w), so the flush
// gets [G, Q, W] and the JAX contract [G, W, Q]:
//     out[g, q, w] = sum_k (qs[s]*qtl[w, t]) * (hi[k] - lo[k])
//                  + sum_k (qs[s]*qtr[w, t]) * (hi[K + k] - lo[K + k]),
//     k = s*kt + t in order (s-major) — the association of the plain
//     versions (fused_leaf_ref, fused_leaf_flat_ref), so they differ only
//     where the compiler contracts a multiply-add.
//
// What bounds it on this card: bytes. Per atom it reads two rows of W*2*K
// values of T by computed index and writes W doubles; 4 flops per value read.
// The Pallas body selects the two rows with a [TQ, R] +-1 one-hot matrix
// times the whole edge block, because the TPU has a matrix unit and no
// cheap gather; here the two rows are simply loaded.
//
// Mapping: as csrc/fused_walk.cu. One block per (edge group g, chunk of
// blockDim slots): each thread reads one slot's leaf range and side
// (coalesced), the block zero-fills the chunk's outputs and compacts the
// slots whose two rows differ (the others difference a row with itself:
// exactly 0) into a list in shared memory. A warp carries two live atoms at
// a time — two independent load chains, the latency of a round trip to
// memory being what bounds a warp here (there is no climb, so the second
// atom costs few registers). Its lanes read the hi and the lo row
// of both atoms as contiguous, coalesced segments (lane c holds column c,
// in passes of 32 columns), all four loads in flight together, and put the
// differences in the warp's two slots in shared memory. Lane w then
// contracts window w with qs (prefetched, lane s holding qs[s], taken by
// shuffle) and the [W, kt] temporal vectors (read once per block into
// shared memory), s-major, one scalar sum per half: no register array sized
// by K, which reaches 121 with the gaussian kernel. Its arithmetic does not
// depend on its window index, so two windows with identical rows and
// temporal vectors give bitwise identical outputs. Offsets are 64-bit.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int SMEM_MAX = 227 * 1024;

struct LeafArgs {
  const void* lcum;  // [n_rows, W*2*K] of T
  long long n_rows;
  const long long* edges;
  const int* leaf_lo;
  const int* leaf_hi;
  const int* side;
  const double* qs;
  const double* qtl;
  const double* qtr;
  double* out;
  long long so_g, so_q, so_w;
  int R, Q, W, ks, kt;
};

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) fused_leaf_kernel(LeafArgs a) {
  extern __shared__ double smem[];  // [qtl (W*kt) | qtr (W*kt) | two rows per warp]
  __shared__ int s_q[MAX_THREADS], s_hi[MAX_THREADS], s_lo[MAX_THREADS];
  __shared__ int s_wcount[MAX_THREADS / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int g = blockIdx.x;
  const int K = a.ks * a.kt, wk = a.W * 2 * K;
  const T* __restrict__ lcum = static_cast<const T*>(a.lcum);
  const int nq_t = a.W * a.kt;
  double* sql = smem;
  double* sqr = smem + nq_t;
  double* srow = smem + 2 * nq_t + (long long)warp * wk;
  for (int i = tid; i < nq_t; i += nthreads) {
    sql[i] = a.qtl[i];
    sqr[i] = a.qtr[i];
  }
  const long long base = a.edges[g] * a.R;
  const int q0 = blockIdx.y * nthreads;
  const int nq = min(nthreads, a.Q - q0);
  const long long gq0 = (long long)g * a.Q + q0;
  double* __restrict__ out = a.out + g * a.so_g + q0 * a.so_q;

  // ---- scan: zero-fill the chunk's outputs, compact the live slots
  long long i_hi = 0, i_lo = 0;
  if (tid < nq) {
    const long long sd = a.side[gq0 + tid];
    i_hi = min(max(a.leaf_hi[gq0 + tid] * 2LL + sd, 0LL), (long long)a.R - 1);
    i_lo = min(max(a.leaf_lo[gq0 + tid] * 2LL + sd, 0LL), (long long)a.R - 1);
  }
  if (a.so_w == 1 && a.so_q == a.W) {  // [.., Q, W]: the chunk is contiguous
    for (int i = tid; i < nq * a.W; i += nthreads) out[i] = 0.0;
  } else {
    for (int w = 0; w < a.W; ++w)
      for (int qi = tid; qi < nq; qi += nthreads) out[qi * a.so_q + (long long)w * a.so_w] = 0.0;
  }
  const bool live = tid < nq && i_hi != i_lo;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) s_wcount[warp] = __popc(ballot);
  __syncthreads();
  int pos = __popc(ballot & ((1u << lane) - 1u)), nlive = 0;
  for (int j = 0; j < nwarps; ++j) {
    pos += j < warp ? s_wcount[j] : 0;
    nlive += s_wcount[j];
  }
  if (live) {
    s_q[pos] = tid;
    s_hi[pos] = (int)i_hi;
    s_lo[pos] = (int)i_lo;
  }
  __syncthreads();  // the zero-fill lands before any live write; the list is complete

  // ---- a warp per two live atoms (two independent load chains)
  for (int k = warp; k < nlive; k += 2 * nwarps) {
    const int kb = k + nwarps;
    const bool has_b = kb < nlive;
    const long long rha = min(base + s_hi[k], a.n_rows - 1);
    const long long rla = min(base + s_lo[k], a.n_rows - 1);
    const long long rhb = has_b ? min(base + s_hi[kb], a.n_rows - 1) : rha;
    const long long rlb = has_b ? min(base + s_lo[kb], a.n_rows - 1) : rla;
    const int qia = s_q[k], qib = has_b ? s_q[kb] : qia;
    const double* __restrict__ qva = a.qs + (gq0 + qia) * a.ks;
    const double* __restrict__ qvb = a.qs + (gq0 + qib) * a.ks;
    const double qla = lane < a.ks ? qva[lane] : 0.0;
    const double qlb = lane < a.ks ? qvb[lane] : 0.0;
    double* srow_b = srow + (long long)nwarps * wk;
    for (int c = lane; c < wk; c += 32) {
      const double ha = lcum[rha * wk + c], la = lcum[rla * wk + c];  // widened
      const double hb = lcum[rhb * wk + c], lb = lcum[rlb * wk + c];
      srow[c] = ha - la;
      srow_b[c] = hb - lb;
    }
    __syncwarp();
    for (int w0 = 0; w0 < a.W; w0 += 32) {  // all lanes run the shuffles
      const int w = w0 + lane;
      const int wm = min(w, a.W - 1);
      const double* da = srow + (long long)wm * 2 * K;
      const double* db = srow_b + (long long)wm * 2 * K;
      const double* ql = sql + wm * a.kt;
      const double* qr = sqr + wm * a.kt;
      double vla = 0.0, vra = 0.0, vlb = 0.0, vrb = 0.0;
      for (int s = 0; s < a.ks; ++s) {
        const double asa = s < 32 ? __shfl_sync(0xffffffffu, qla, s) : qva[s];
        const double asb = s < 32 ? __shfl_sync(0xffffffffu, qlb, s) : qvb[s];
        for (int t = 0; t < a.kt; ++t) {
          const int kk = s * a.kt + t;
          vla += (asa * ql[t]) * da[kk];
          vra += (asa * qr[t]) * da[K + kk];
          vlb += (asb * ql[t]) * db[kk];
          vrb += (asb * qr[t]) * db[K + kk];
        }
      }
      if (w < a.W) {
        out[qia * a.so_q + (long long)w * a.so_w] = vla + vra;
        if (has_b) out[qib * a.so_q + (long long)w * a.so_w] = vlb + vrb;
      }
    }
    __syncwarp();  // the warp's row slots are reused by its next atoms
  }
}

template <typename T>
int fused_leaf(const T* lcum, long long n_rows, const long long* edges, int R,
               const int* leaf_lo, const int* leaf_hi, const int* side, const double* qs,
               const double* qtl, const double* qtr, double* out, long long so_g, long long so_q,
               long long so_w, int G, int Q, int W, int ks, int kt, int device, void* stream) {
  if (G <= 0 || Q <= 0 || W <= 0) return 0;  // empty output: nothing to do
  if (R <= 0 || ks <= 0 || kt <= 0 || n_rows <= 0) return -1;
  const long long wk = (long long)W * 2 * ks * kt;
  const long long fixed = 2LL * W * kt * 8;
  int threads = MAX_THREADS;
  while (threads > 32 && fixed + 2 * (threads / 32) * wk * 8 > SMEM_MAX) threads -= 32;
  const long long smem = fixed + 2 * (threads / 32) * wk * 8;
  if (smem > SMEM_MAX) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_leaf_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long chunks = (Q + threads - 1) / threads;
  if (chunks > 65535) return -1;
  LeafArgs a{lcum, n_rows, edges, leaf_lo, leaf_hi, side, qs, qtl, qtr, out,
             so_g, so_q, so_w, (int)R, Q, W, ks, kt};
  const dim3 grid((unsigned)G, (unsigned)chunks);
  fused_leaf_kernel<T><<<grid, threads, (size_t)smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes), one entry per table type with the
// same arguments. All pointers are device pointers. Launches on `stream`,
// does not synchronise, allocates nothing; returns the cudaError_t of the
// launch (0 = ok), -1 for arguments the kernel does not take (the two
// [W, k_t] vectors and one warp's two rows must fit SMEM_MAX; the threads
// per block shrink until the block's shared memory fits).
extern "C" int fused_leaf_f64(const double* lcum, long long n_rows, const long long* edges,
                              int R, const int* leaf_lo, const int* leaf_hi, const int* side,
                              const double* qs, const double* qtl, const double* qtr,
                              double* out, long long so_g, long long so_q, long long so_w, int G,
                              int Q, int W, int ks, int kt, int device, void* stream) {
  return fused_leaf(lcum, n_rows, edges, R, leaf_lo, leaf_hi, side, qs, qtl, qtr, out, so_g, so_q,
                    so_w, G, Q, W, ks, kt, device, stream);
}

extern "C" int fused_leaf_f32(const float* lcum, long long n_rows, const long long* edges,
                              int R, const int* leaf_lo, const int* leaf_hi, const int* side,
                              const double* qs, const double* qtl, const double* qtr,
                              double* out, long long so_g, long long so_q, long long so_w, int G,
                              int Q, int W, int ks, int kt, int device, void* stream) {
  return fused_leaf(lcum, n_rows, edges, R, leaf_lo, leaf_hi, side, qs, qtl, qtr, out, so_g, so_q,
                    so_w, G, Q, W, ks, kt, device, stream);
}
