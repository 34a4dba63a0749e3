// fused_leaf — the quantized DRFS tree phase in one launch: leaf-prefix
// difference plus the q_s (x) q_t window contraction, float64, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_walk.py::fused_leaf_pallas
// (body _fused_leaf_kernel). Same contract: lcum [G, R, W*2*K] per-edge
// leaf-prefix rows (R = (nleaf+1)*2, row = leaf*2 + side, each row packing
// [K left-half | K right-half] for every window), leaf_lo/leaf_hi/side
// [G, Q] int32, qs [G, Q, ks], qtl/qtr [W, kt] with K = ks*kt; out
// [G, W, Q] with
//     out[g, w, q] = sum_k (qs[s]*qtl[w, t]) * (hi[k] - lo[k])
//                  + sum_k (qs[s]*qtr[w, t]) * (hi[K + k] - lo[K + k]),
//     k = s*kt + t in order (s-major), hi/lo the rows leaf_hi*2 + side and
//     leaf_lo*2 + side of window w — the association of the plain version
//     (fused_leaf_ref), so the two differ only where the compiler contracts
//     a multiply-add.
//
// What bounds it on this card: bytes. Per atom and window it reads two rows
// of 2*K doubles by computed index and writes one double; the arithmetic is
// 4 flops per value read. The Pallas body selects the two rows with a
// [TQ, R] +-1 one-hot matrix times the whole edge block, because the TPU has
// a matrix unit and no cheap gather; here the two rows are simply loaded.
// There is no f64 tensor-core path worth a one-hot, and the rows of one edge
// are shared by all of its atoms (L2 hits after first touch).
//
// Mapping: one thread per (atom, window), as in fused_walk.cu: a block holds
// TQ consecutive atoms of one edge group (threadIdx.x, so the [.., w, q]
// stores coalesce) times up to WY windows (threadIdx.y; more windows loop
// in-thread). The [W, kt] temporal vectors are read once per block into
// shared memory. The thread streams over k with two scalar accumulators —
// no register array sized by K, which reaches 121 with the gaussian kernel.
// Its arithmetic does not depend on its window index, so two windows with
// identical rows and temporal vectors give bitwise identical outputs.
// Ragged Q is masked here (q >= Q returns after the shared-memory fill).
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 64;     // atoms per block
constexpr int WY_MAX = 8;  // windows per block (more loop in-thread)
constexpr int SMEM_MAX = 48 * 1024;

__global__ void fused_leaf_f64_kernel(
    const double* __restrict__ lcum, const int* __restrict__ leaf_lo,
    const int* __restrict__ leaf_hi, const int* __restrict__ side,
    const double* __restrict__ qs, const double* __restrict__ qtl,
    const double* __restrict__ qtr, double* __restrict__ out, int R, int Q,
    int W, int ks, int kt, int q_tiles) {
  extern __shared__ double sq[];  // [qtl (W*kt) | qtr (W*kt)]
  const int nq = W * kt;
  const int nth = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < nq; i += nth) {
    sq[i] = qtl[i];
    sq[nq + i] = qtr[i];
  }
  __syncthreads();

  const int g = blockIdx.x / q_tiles;
  const int q = (blockIdx.x % q_tiles) * TQ + threadIdx.x;
  if (q >= Q) return;
  const long long gq = (long long)g * Q + q;
  const int K = ks * kt;
  const long long wk = (long long)W * 2 * K;
  const int sd = side[gq];
  const int i_hi = min(max(leaf_hi[gq] * 2 + sd, 0), R - 1);
  const int i_lo = min(max(leaf_lo[gq] * 2 + sd, 0), R - 1);
  const double* __restrict__ block = lcum + (long long)g * R * wk;
  const double* __restrict__ qv = qs + gq * ks;

  for (int w = threadIdx.y; w < W; w += blockDim.y) {
    const double* __restrict__ hi = block + i_hi * wk + (long long)w * 2 * K;
    const double* __restrict__ lo = block + i_lo * wk + (long long)w * 2 * K;
    const double* __restrict__ ql = sq + w * kt;
    const double* __restrict__ qr = sq + nq + w * kt;
    double vl = 0.0, vr = 0.0;
    for (int s = 0; s < ks; ++s) {
      const double a = qv[s];
      for (int t = 0; t < kt; ++t) {
        const int k = s * kt + t;
        vl += (a * ql[t]) * (hi[k] - lo[k]);
        vr += (a * qr[t]) * (hi[K + k] - lo[K + k]);
      }
    }
    out[((long long)g * W + w) * Q + q] = vl + vr;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). All pointers are device pointers.
// Launches on `stream`, does not synchronise, allocates nothing; returns the
// cudaError_t of the launch (0 = ok), -1 for arguments the kernel does not
// take (the two [W, kt] vectors must fit 48 KB of shared memory).
extern "C" int fused_leaf_f64(const double* lcum, const int* leaf_lo,
                              const int* leaf_hi, const int* side,
                              const double* qs, const double* qtl,
                              const double* qtr, double* out, int G, int R,
                              int Q, int W, int ks, int kt, int device,
                              void* stream) {
  if (R <= 0 || ks <= 0 || kt <= 0) return -1;
  if (G <= 0 || Q <= 0 || W <= 0) return 0;  // empty output: nothing to do
  const long long q_tiles = (Q + TQ - 1) / TQ;
  if ((long long)G * q_tiles > 2147483647LL) return -1;
  const long long smem = 2LL * W * kt * (long long)sizeof(double);
  if (smem > SMEM_MAX) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(TQ, W < WY_MAX ? W : WY_MAX);
  const dim3 grid((unsigned)(G * q_tiles));
  fused_leaf_f64_kernel<<<grid, block, (size_t)smem, (cudaStream_t)stream>>>(
      lcum, leaf_lo, leaf_hi, side, qs, qtl, qtr, out, R, Q, W, ks, kt,
      (int)q_tiles);
  return (int)cudaGetLastError();
}
