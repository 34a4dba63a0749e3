// segment_add — the fixed-order scatter of a flush's per-atom rows onto the
// [L, W] float64 heatmap, for NVIDIA Hopper (sm_90a).
//
// Added by the port; it has no TPU counterpart (the reference scatters with
// `heat.at[lixel].add(rows)` inside its jitted flush). Every flush of every
// executor ends here: the rows of one atom pack, one row per atom and one
// column per window, are added onto the heatmap rows of their lixels.
//
// Contract: a segment index built once per atom pack (segment_add.py): the
// pack's real rows stably sorted by lixel, `rows [M]` (int64, the source row
// of each, in that order), `seg_ptr [U+1]` (int64, the rows of unique lixel
// u are rows[seg_ptr[u] .. seg_ptr[u+1])) and `lixel [U]` (int64, unique).
// For every (u, w):
//     acc = heat[lixel[u], w];
//     for i in seg_ptr[u] .. seg_ptr[u+1]:  acc = acc + x(rows[i], w);
//     heat[lixel[u], w] = acc;
// with x(r, w) = src[r*ld + w*cs] or, for half-window rows (hs != 0), the
// fold src[r*ld + w*cs] + src[r*ld + w*cs + hs]: left half plus right half,
// one rounding, then the add. Each (u, w) is one thread that adds its rows
// in plan order, one rounding per add (__dadd_rn: no contraction, no
// reassociation), so a column's sums do not depend on how many columns the
// flush has, on which windows share it, or on the PyTorch release — and
// they equal a sequential scatter of the pack's rows in atom order. The
// lixels of one call are unique, so no two threads write one element: no
// atomics.
//
// What bounds it on this card: bytes. Per (row, window) one or two doubles
// read by computed index (a row's W columns are adjacent in the flush's
// [G*Q, W] output, so a warp's loads of one row coalesce), and one read and
// one write of the heatmap element per (lixel, window).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void segment_add_f64_kernel(double* __restrict__ heat, long long ldh,
                                       const double* __restrict__ src, long long ld,
                                       long long cs, long long hs,
                                       const long long* __restrict__ rows,
                                       const long long* __restrict__ seg_ptr,
                                       const long long* __restrict__ lixel, long long U,
                                       int W) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= U * W) return;
  const long long u = t / W;
  const long long w = t - u * W;
  double* __restrict__ h = heat + lixel[u] * ldh + w;
  double acc = *h;
  const long long end = seg_ptr[u + 1];
  for (long long i = seg_ptr[u]; i < end; ++i) {
    const double* __restrict__ p = src + rows[i] * ld + w * cs;
    double x = p[0];
    if (hs != 0) x = __dadd_rn(x, p[hs]);
    acc = __dadd_rn(acc, x);
  }
  *h = acc;
}

}  // namespace

// Plain C interface (loaded with ctypes). All pointers are device pointers;
// strides are in elements. Launches on `stream`, does not synchronise,
// allocates nothing; returns the cudaError_t of the launch (0 = ok), -1 for
// arguments the kernel does not take.
extern "C" int segment_add_f64(double* heat, long long ldh, const double* src,
                               long long ld, long long cs, long long hs,
                               const long long* rows, const long long* seg_ptr,
                               const long long* lixel, long long U, int W, int device,
                               void* stream) {
  if (U < 0 || W < 0) return -1;
  if (U == 0 || W == 0) return 0;  // nothing to add
  const long long blocks = (U * W + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  segment_add_f64_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      heat, ldh, src, ld, cs, hs, rows, seg_ptr, lixel, U, W);
  return (int)cudaGetLastError();
}
