// minplus — the (min, +) matrix product, float32 and float64, for NVIDIA
// Hopper (sm_90a):
//     out[i, j] = min_k a[i, k] + b[k, j]
// a [M, K], b [K, N], out [M, N], all row-major and contiguous.
//
// Replaces the TPU kernel src/repro/kernels/minplus.py::minplus_matmul_pallas
// (body _kernel): the relaxation step of batched multi-source Bellman-Ford
// (repro_torch.core.shortest_path.minplus_bellman_ford). The Pallas body pads
// a and b to tile multiples with +inf on the host and carries a resident
// min-accumulator tile across the sequential K grid axis; here the K loop
// runs inside one block and the ragged edges are bounds checks that load
// +inf into shared memory, so nothing is padded on the host.
//
// Exactness: every candidate is one rounding (a + b, never contracted — there
// is no multiply) and the minimum of a set is exact whatever the order, so
// the kernel equals its plain version (minplus_matmul_ref) bitwise. Inputs
// are distances: finite or +inf, no NaN and no -inf (fmin would drop a NaN
// that the plain version keeps).
//
// What bounds it on this card: operations. At berkeley size (M = N = K =
// 1 576) one product does 2·M·N·K = 7.8e9 adds and mins against 40 MB of
// inputs; the arithmetic intensity (about 200 operations per byte in f64)
// is far above the card's ridge point, so the time is the f64 add and min
// rate. The design keeps the ALUs fed from registers: a block computes a
// BM x BN = 64 x 64 output tile with 256 threads, each owning a TM x TN =
// 4 x 4 micro-tile of running minima in registers; per step of BK = 16 along
// K the block stages a 64 x 16 tile of a (transposed, so a thread reads its
// 4 rows as one broadcast per row) and a 16 x 64 tile of b in shared memory,
// and each thread does 16 adds + 16 mins per 8 shared-memory loads. A
// thread's micro-tile is strided by 16 in both directions (rows ty + 16·i,
// columns tx + 16·j), so the 16 threads of a half-warp read 16 consecutive
// b values (no bank conflict) and store 16 consecutive outputs.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ float pos_inf<float>() { return INFINITY; }
template <>
__device__ __forceinline__ double pos_inf<double>() { return (double)INFINITY; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
minplus_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
               int M, int N, int K) {
  __shared__ T As[BK][BM];  // As[k][m] = a[m0 + m, k0 + k]
  __shared__ T Bs[BK][BN];  // Bs[k][n] = b[k0 + k, n0 + n]
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // 0..15: column lane
  const int ty = tid / (BN / TN);  // 0..15: row lane
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const T inf = pos_inf<T>();

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = inf;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // stage a[m0:m0+64, k0:k0+16] transposed; 1 024 values, 4 per thread,
    // consecutive threads on consecutive k of one row
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int kk = idx % BK, mm = idx / BK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? a[(long long)gm * K + gk] : inf;
    }
    // stage b[k0:k0+16, n0:n0+64]; consecutive threads on consecutive n
#pragma unroll
    for (int r = 0; r < (BK * BN) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int nn = idx % BN, kk = idx / BN;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < K && gn < N) ? b[(long long)gk * N + gn] : inf;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmin(acc[i][j], av[i] + bv[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * (BM / TM);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * (BN / TN);
      if (gn < N) out[(long long)gm * N + gn] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const T* a, const T* b, T* out, int M, int N, int K, int device, void* stream) {
  if (M < 0 || N < 0 || K <= 0) return -1;
  if (M == 0 || N == 0) return 0;  // empty output: nothing to do
  const long long gy = (M + BM - 1) / BM, gx = (N + BN - 1) / BN;
  if (gy > 65535 || gx > 2147483647LL) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  minplus_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(a, b, out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers.
// Launches on `stream`, does not synchronise, allocates nothing; returns the
// cudaError_t of the launch (0 = ok), -1 for arguments the kernel does not
// take (K = 0 has no minimum; the wrapper fills +inf itself).
extern "C" int minplus_f32(const float* a, const float* b, float* out, int M, int N, int K,
                           int device, void* stream) {
  return launch<float>(a, b, out, M, N, K, device, stream);
}

extern "C" int minplus_f64(const double* a, const double* b, double* out, int M, int N, int K,
                           int device, void* stream) {
  return launch<double>(a, b, out, M, N, K, device, stream);
}
