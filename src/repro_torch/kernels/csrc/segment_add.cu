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
// u are rows[seg_ptr[u] .. seg_ptr[u+1])), `lixel [U]` (int64, unique),
// `blk_seg [B+1]` (int64, block b owns the whole segments
// blk_seg[b] .. blk_seg[b+1]) and `blk_row [B+1]` (int64, seg_ptr[blk_seg],
// so that a block finds its rows without waiting on a load). For every
// (u, w):
//     acc = heat[lixel[u], w];
//     for i in seg_ptr[u] .. seg_ptr[u+1]:  acc = acc + x(rows[i], w);
//     heat[lixel[u], w] = acc;
// with x(r, w) = src[r*ld + w*cs] or, for half-window rows (hs != 0), the
// fold src[r*ld + w*cs] + src[r*ld + w*cs + hs]: left half plus right half,
// one rounding, then the add. One rounding per add (__dadd_rn: no
// contraction, no reassociation), in plan order, so a column's sums do not
// depend on how many columns the flush has, on which windows share it, or on
// the PyTorch release — and they equal a sequential scatter of the pack's
// rows in atom order. The lixels of one call are unique, so no two threads
// write one element: no atomics.
//
// What bounds it on this card: the latency of the serial chains, not bytes.
// The order of the adds is the contract, so each (lixel, window) stays one
// serial chain as long as its segment; what is parallel is the loads that
// feed the chains. A block owns a run of whole segments of at most
// BLOCK_ROWS rows and BLOCK_SEGS segments (a longer segment gets a block of
// its own; the host groups them, once per pack). It walks its rows in tiles
// of BLOCK_ROWS rows × TILE_COLS source columns (TILE_COLS windows, or
// TILE_COLS / 2 half-window pairs): all its threads first load the tile's
// source-row offsets into shared memory, then copy every value of the tile
// into shared memory at once with 8-byte cp.async copies (no registers held
// per value, so five blocks fit on an SM), and after a barrier one thread per
// (segment, window) folds each staged pair and adds it in order into a
// register that lives across the tiles of a long segment. So a chain costs
// one or two shared loads and one f64 add per row instead of one global
// round trip, and a tile about two round trips whatever its rows. Wider
// flushes run the column tiles one after the other. One read and one write
// of each heat element, as before.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCK_ROWS = 512;                          // rows of a block (and of a tile)
constexpr int TILE_COLS = 8;                             // source columns of a tile
constexpr int BLOCK_SEGS = THREADS / TILE_COLS;          // segments of a block: a chain each
constexpr int STAGE = BLOCK_ROWS * TILE_COLS / THREADS;  // values a thread stages per tile

__device__ __forceinline__ void copy8(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}

__global__ void __launch_bounds__(THREADS, 5)
segment_add_f64_kernel(double* __restrict__ heat, long long ldh,
                       const double* __restrict__ src, long long ld, long long cs,
                       long long hs, const long long* __restrict__ rows,
                       const long long* __restrict__ seg_ptr,
                       const long long* __restrict__ lixel,
                       const long long* __restrict__ blk_seg,
                       const long long* __restrict__ blk_row, int W) {
  __shared__ long long s_off[BLOCK_ROWS];                      // rows[i] * ld of the tile
  __shared__ __align__(16) double s_val[BLOCK_ROWS * TILE_COLS];  // the tile's source values
  const int tid = threadIdx.x;
  const long long s0 = blk_seg[blockIdx.x];
  const int nseg = (int)(blk_seg[blockIdx.x + 1] - s0);
  const long long rb = blk_row[blockIdx.x];
  const long long re = blk_row[blockIdx.x + 1];
  const int halves = hs != 0 ? 2 : 1;  // staged source columns per window
  // The tile's layout follows the source's faster axis, so that neighbouring
  // threads copy neighbouring addresses: [row][col] for a row-major source,
  // [col][row] for a transposed one (the scans' vals.T).
  const bool rows_fast = ld < cs;
  for (int c0 = 0; c0 < W; c0 += TILE_COLS / halves) {
    const int wc = min(TILE_COLS / halves, W - c0);  // windows of this column tile
    const int nc = wc * halves;                       // its staged source columns
    const int sl = tid / wc;  // this thread's chain: segment s0 + sl, window c0 + w
    const int w = tid - sl * wc;
    const bool mine = sl < nseg;
    long long a = 0, b = 0;
    double* __restrict__ h = nullptr;
    double acc = 0.0;
    if (mine) {
      a = seg_ptr[s0 + sl];
      b = seg_ptr[s0 + sl + 1];
      h = heat + lixel[s0 + sl] * ldh + c0 + w;
      acc = *h;  // in flight while the tile is staged
    }
    const long long col = (long long)c0 * cs;
    for (long long r0 = rb; r0 < re; r0 += BLOCK_ROWS) {
      const int nr = (int)min((long long)BLOCK_ROWS, re - r0);
      for (int i = tid; i < nr; i += THREADS) s_off[i] = rows[r0 + i] * ld + col;
      __syncthreads();
      const int n = nr * nc;
#pragma unroll
      for (int k = 0; k < STAGE; ++k) {
        const int e = tid + k * THREADS;  // the tile index of (i, q) in its layout
        if (e < n) {
          int i, q;
          if (rows_fast) {
            q = e / nr;
            i = e - q * nr;
          } else {
            i = e / nc;
            q = e - i * nc;
          }
          const int j = halves == 2 ? q >> 1 : q;
          const long long half = halves == 2 ? (q & 1) * hs : 0;
          copy8(s_val + e, src + s_off[i] + j * cs + half);
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      if (mine) {
        const int lo = (int)(max(a, r0) - r0);
        const int hi = (int)(min(b, r0 + nr) - r0);
        // (i, q) sits at i * di + q * dq
        const int di = rows_fast ? 1 : nc;
        const int dq = rows_fast ? nr : 1;
        const double* __restrict__ v = s_val + lo * di + w * halves * dq;
        if (halves == 2) {
#pragma unroll 8
          for (int i = lo; i < hi; ++i, v += di) acc = __dadd_rn(acc, __dadd_rn(v[0], v[dq]));
        } else {
#pragma unroll 8
          for (int i = lo; i < hi; ++i, v += di) acc = __dadd_rn(acc, v[0]);
        }
      }
      __syncthreads();  // the next tile overwrites s_off and s_val
    }
    if (mine) *h = acc;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). All pointers are device pointers;
// strides are in elements. `block_rows` and `block_segs` are the limits the
// index's blocks were built with, checked against this source's. Launches
// `n_blocks` blocks on `stream`, does not synchronise, allocates nothing;
// returns the cudaError_t of the launch (0 = ok), -1 for arguments the
// kernel does not take.
extern "C" int segment_add_f64(double* heat, long long ldh, const double* src,
                               long long ld, long long cs, long long hs,
                               const long long* rows, const long long* seg_ptr,
                               const long long* lixel, const long long* blk_seg,
                               const long long* blk_row, long long n_blocks, int block_rows, int block_segs, int W,
                               int device, void* stream) {
  if (n_blocks < 0 || W < 0 || block_rows != BLOCK_ROWS || block_segs != BLOCK_SEGS) return -1;
  if (n_blocks == 0 || W == 0) return 0;  // nothing to add
  if (n_blocks > 2147483647LL) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  segment_add_f64_kernel<<<(unsigned)n_blocks, THREADS, 0, (cudaStream_t)stream>>>(
      heat, ldh, src, ld, cs, hs, rows, seg_ptr, lixel, blk_seg, blk_row, W);
  return (int)cudaGetLastError();
}
