// dyn_leaf_query — the quantized DRFS tree phase over the leaf-prefix layout
// with materialised per-half query vectors, float64, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/dyn_query.py::dyn_leaf_query_pallas
// (body _leaf_kernel) under the reference's grouped contract, for the tests
// and chip_smoke.py's sweep of that contract (ops.dyn_leaf_query). The
// kernel executor's flush computes the same function on the flat leaf table
// in place through fused_leaf.cu (ops.dyn_leaf_query_flat), which builds the
// query vectors itself. Same contract: tab [G, R, W*2*K] per-edge leaf-prefix
// rows (R = (nleaf+1)*2, row = leaf*2 + side, each row packing
// [K left-half | K right-half] for every window), leaf_lo/leaf_hi/side
// [G, Q] int32, qv_l/qv_r [G, W, Q, K]; out [G, W, Q] with
//     out[g, w, q] = sum_k qv_l[g, w, q, k] * (hi[k] - lo[k])
//                  + sum_k qv_r[g, w, q, k] * (hi[K + k] - lo[K + k]),
// k in order, hi/lo the rows leaf_hi*2 + side and leaf_lo*2 + side of window
// w (clamped to the table, as in fused_leaf.cu) — the association of the
// plain version (dyn_leaf_query_ref), so the two differ only where the
// compiler contracts a multiply-add.
//
// What bounds it on this card: bytes. Per atom and window it reads two rows
// of 2*K doubles by computed index and the two K-wide query rows, and writes
// one double; 3 flops per value of a prefix row. The Pallas body selects the
// two rows with a [TQ, R] +-1 one-hot matrix times the whole edge table,
// because the TPU has a matrix unit and no cheap gather; here the two rows
// are simply loaded. The rows of one edge are shared by all of its atoms
// (L2 hits after first touch); the query rows are read once each.
//
// Mapping: one thread per (atom slot, window), as in fused_leaf.cu: a block
// holds TQ consecutive slots of one edge group (threadIdx.x, so the
// [.., w, q] stores coalesce) times up to WY windows (threadIdx.y; more
// windows loop in-thread). The thread streams over k with two scalar
// accumulators — no register array sized by K, which reaches 121 with the
// gaussian kernels. Its arithmetic does not depend on its window index, so
// two windows with identical rows and query vectors give bitwise identical
// outputs. Ragged Q is masked here (q >= Q returns).
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 64;     // atom slots per block
constexpr int WY_MAX = 8;  // windows per block (more loop in-thread)

__global__ void dyn_leaf_query_f64_kernel(
    const double* __restrict__ tab, const int* __restrict__ leaf_lo,
    const int* __restrict__ leaf_hi, const int* __restrict__ side,
    const double* __restrict__ qv_l, const double* __restrict__ qv_r,
    double* __restrict__ out, int R, int Q, int W, int K, int q_tiles) {
  const int g = blockIdx.x / q_tiles;
  const int q = (blockIdx.x % q_tiles) * TQ + threadIdx.x;
  if (q >= Q) return;
  const long long gq = (long long)g * Q + q;
  const long long wk = (long long)W * 2 * K;
  const int sd = side[gq];
  const int i_hi = min(max(leaf_hi[gq] * 2 + sd, 0), R - 1);
  const int i_lo = min(max(leaf_lo[gq] * 2 + sd, 0), R - 1);
  const double* __restrict__ block = tab + (long long)g * R * wk;

  for (int w = threadIdx.y; w < W; w += blockDim.y) {
    const double* __restrict__ hi = block + i_hi * wk + (long long)w * 2 * K;
    const double* __restrict__ lo = block + i_lo * wk + (long long)w * 2 * K;
    const long long gwq = ((long long)g * W + w) * Q + q;
    const double* __restrict__ ql = qv_l + gwq * K;
    const double* __restrict__ qr = qv_r + gwq * K;
    double vl = 0.0, vr = 0.0;
    for (int k = 0; k < K; ++k) {
      vl += ql[k] * (hi[k] - lo[k]);
      vr += qr[k] * (hi[K + k] - lo[K + k]);
    }
    out[gwq] = vl + vr;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). All pointers are device pointers.
// Launches on `stream`, does not synchronise, allocates nothing; returns the
// cudaError_t of the launch (0 = ok), -1 for arguments the kernel does not
// take.
extern "C" int dyn_leaf_query_f64(const double* tab, const int* leaf_lo,
                                  const int* leaf_hi, const int* side,
                                  const double* qv_l, const double* qv_r,
                                  double* out, int G, int R, int Q, int W,
                                  int K, int device, void* stream) {
  if (R <= 0 || K <= 0) return -1;
  if (G <= 0 || Q <= 0 || W <= 0) return 0;  // empty output: nothing to do
  const long long q_tiles = (Q + TQ - 1) / TQ;
  if ((long long)G * q_tiles > 2147483647LL) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(TQ, W < WY_MAX ? W : WY_MAX);
  const dim3 grid((unsigned)(G * q_tiles));
  dyn_leaf_query_f64_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      tab, leaf_lo, leaf_hi, side, qv_l, qv_r, out, R, Q, W, K, (int)q_tiles);
  return (int)cudaGetLastError();
}
