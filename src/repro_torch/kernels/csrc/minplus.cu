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
// runs inside one block and the ragged edges are handled in the kernel, so
// nothing is padded on the host.
//
// Exactness: every candidate is one rounding (a + b, never contracted — there
// is no multiply) and the minimum of a set is exact whatever the order, so
// the kernel equals its plain version (minplus_matmul_ref) bitwise. Inputs
// are distances: finite or +inf, no NaN and no -inf.
//
// What bounds it on this card: operations. At berkeley size (M = N = K =
// 1 576) one product does M·N·K = 3.9e9 adds and as many minima against
// 40 MB of inputs, which both fit in the 50 MB L2. An f64 add or compare is
// one lane-operation of the f64 pipe, 64 per SM and clock; Hopper has no f64
// min instruction (no DMNMX), so a minimum is a compare (DSETP) and two
// 32-bit selects: four instructions a candidate, two of them on the f64 pipe.
// The design keeps that pipe fed:
//   * Registers decide the rest. A thread keeps TM x TN = 10 x 8 running
//     minima (160 of its registers in f64); a block of 64 threads computes a
//     BM x BN = 80 x 64 tile (rows ty + 8·i, columns tx·VW + 8·VW·j + v,
//     VW = 16 / sizeof(T)). Up to 255 registers a thread allow four blocks
//     (eight warps) on an SM, 528 on the card: the 20 x 25 = 500 tiles of the
//     berkeley product run as one wave (0.95). 8 x 8 minima would leave 625
//     64 x 64 tiles for 528 places, 1.18 waves; a fifth block on an SM puts
//     three warps on a scheduler and caps a thread at 168 registers, where
//     8 x 8 minima spill. minplus_occupancy reports the runtime's figure.
//   * Per step along K a thread loads 8 values of b (16-byte loads: a
//     quarter-warp's 8 threads on 128 contiguous bytes) and, row by row, one
//     value of a (a broadcast) with its 8 candidates; a is kept k-contiguous
//     as it lies in device memory, its rows padded by 16 bytes so that the
//     rows a warp reads fall on different banks.
//   * The tiles reach shared memory through a ring of STAGES = 2 buffers of
//     BK = 16 steps, filled by cp.async (16-byte .cg copies where K and N are
//     multiples of VW and both inputs are 16-byte aligned — the "vec" form —,
//     else one copy per element): the loads of one K step overlap the
//     arithmetic of the one before, with one barrier a step. The copies'
//     addresses are recomputed at every step (fresh_tid), not kept in
//     registers beside the minima.
// Ragged edges: cp.async would fill zeros, never +inf, and a zero stands
// for a false path, so nothing out of range is ever read as a value. A K
// step past K copies nothing and the inner loop stops at the valid depth;
// a row of a past M and a column of b past N are clamped to the last valid
// one (their outputs are computed and never stored).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TY = 8, TX = 8;  // threads down and across a block
constexpr int TM = 10;         // rows of minima a thread keeps, TY apart
constexpr int TN = 8;          // columns of minima a thread keeps
constexpr int BM = TY * TM;    // 80
constexpr int BN = TX * TN;    // 64
constexpr int BK = 16;         // depth of a K step
constexpr int STAGES = 2;      // buffers in the cp.async ring
constexpr int THREADS = TY * TX;  // 64
// blocks per SM the registers must allow: 4 is eight warps, two on each
// scheduler, so up to 255 registers a thread (5 or more puts three warps on
// a scheduler and caps a thread at 168)
constexpr int MIN_BLOCKS = 4;
// row stride of a's tile in shared memory: BK values and 16 bytes of padding
template <typename T>
constexpr int AS = BK + 16 / (int)sizeof(T);

template <typename T>
struct Vec;
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static void unpack(const double2& t, double* d) { d[0] = t.x; d[1] = t.y; }
};
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static void unpack(const float4& t, float* d) {
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
  }
};

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ float pos_inf<float>() { return INFINITY; }
template <>
__device__ __forceinline__ double pos_inf<double>() { return (double)INFINITY; }

// The thread's and block's indices read afresh where they are used: an asm
// volatile read cannot be hoisted, so the copies' addresses are recomputed at
// every step instead of being kept in registers beside the minima.
__device__ __forceinline__ int fresh_tid() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
}
__device__ __forceinline__ int fresh_ctaid_x() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  return v;
}
__device__ __forceinline__ int fresh_ctaid_y() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(v));
  return v;
}

// The running minimum. f64: a compare and two selects (DSETP, FSEL, FSEL);
// fmin's NaN handling adds a LOP3 and a move to those. f32: fminf is one
// FMNMX. The inputs hold no NaN, so both are the exact minimum.
__device__ __forceinline__ double min_of(double acc, double c) { return c < acc ? c : acc; }
__device__ __forceinline__ float min_of(float acc, float c) { return fminf(acc, c); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// one cp.async of BYTES bytes (16: .cg, through L2 only; 4 or 8: .ca)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(smem)),
                 "l"(gmem), "n"(BYTES));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage a[m0:m0+BM, k0:k0+BK] into As[BM][AS] and b[k0:k0+BK, n0:n0+BN] into
// Bs[BK][BN]. Copies of CE elements each: CE = VW in the vec form (K and N
// multiples of VW, so a copy is wholly in or out of range), else 1.
template <typename T, bool VEC>
__device__ __forceinline__ void load_tile(T* As, T* Bs, const T* __restrict__ a,
                                          const T* __restrict__ b, int M, int N, int K, int k0) {
  const int tid = fresh_tid();
  const int m0 = fresh_ctaid_y() * BM, n0 = fresh_ctaid_x() * BN;
  constexpr int CE = VEC ? Vec<T>::n : 1;
  constexpr int BYTES = CE * (int)sizeof(T);
  constexpr int NA = BM * BK / CE, NB = BK * BN / CE;  // copies of each tile
  static_assert(NB % THREADS == 0, "every thread issues the same number of copies of b");
#pragma unroll
  for (int r = 0; r < (NA + THREADS - 1) / THREADS; ++r) {
    const int c = tid + r * THREADS;
    const int row = c / (BK / CE), col = (c % (BK / CE)) * CE;
    const int gk = k0 + col;
    if ((NA % THREADS == 0 || c < NA) && gk < K) {  // past K: never read
      const int gm = min(m0 + row, M - 1);
      cp_async<BYTES>(As + row * AS<T> + col, a + (long long)gm * K + gk);
    }
  }
#pragma unroll
  for (int r = 0; r < NB / THREADS; ++r) {
    const int c = tid + r * THREADS;
    const int row = c / (BN / CE), col = (c % (BN / CE)) * CE;
    const int gk = k0 + row;
    if (gk < K) {
      const int gn = min(n0 + col, N - CE);
      cp_async<BYTES>(Bs + row * BN + col, b + (long long)gk * N + gn);
    }
  }
}

// One step along K: TN values of b (row kk at the thread's columns), then
// row by row one value of a (column kk) and its TN candidates into the
// running minima — TM·TN a step, with few values live beside the minima.
template <typename T>
__device__ __forceinline__ void step(const T* As, const T* Bs, int kk, int tx, int ty,
                                     T (&acc)[TM][TN]) {
  using V = typename Vec<T>::type;
  constexpr int VW = Vec<T>::n;
  T bv[TN];
#pragma unroll
  for (int j = 0; j < TN / VW; ++j)
    Vec<T>::unpack(*reinterpret_cast<const V*>(Bs + kk * BN + tx * VW + TX * VW * j),
                   bv + j * VW);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const T av = As[(ty + TY * i) * AS<T> + kk];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = min_of(acc[i][j], av + bv[j]);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
minplus_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out, int M,
               int N, int K) {
  __shared__ __align__(16) T As[STAGES][BM * AS<T>];  // As[s][m·AS + k] = a[m0 + m, k0 + k]
  __shared__ __align__(16) T Bs[STAGES][BK * BN];  // Bs[s][k·BN + n] = b[k0 + k, n0 + n]
  constexpr int VW = Vec<T>::n;
  const int tx = threadIdx.x % TX;  // column lane
  const int ty = threadIdx.x / TX;  // row lane
  const int nk = (K + BK - 1) / BK;

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = pos_inf<T>();

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_tile<T, VEC>(As[s], Bs[s], a, b, M, N, K, s * BK);
    cp_async_commit();  // one group per step, empty or not: the wait counts groups
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of step kt have landed
    __syncthreads();  // everyone's have, and everyone is done with step kt - 1
    const int nt = kt + STAGES - 1;  // refill the buffer step kt - 1 used
    if (nt < nk) load_tile<T, VEC>(As[nt % STAGES], Bs[nt % STAGES], a, b, M, N, K, nt * BK);
    cp_async_commit();
    const T* as = As[kt % STAGES];
    const T* bs = Bs[kt % STAGES];
    const int kv = min(BK, K - kt * BK);
    if (kv == BK) {
#pragma unroll 1
      for (int kk = 0; kk < BK; ++kk) step<T>(as, bs, kk, tx, ty, acc);
    } else {  // the last, partial step: only the valid depth
#pragma unroll 1
      for (int kk = 0; kk < kv; ++kk) step<T>(as, bs, kk, tx, ty, acc);
    }
  }
  cp_async_wait<0>();
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + TY * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * VW + TX * VW * (j / VW) + j % VW;
      if (gn < N) out[(long long)gm * N + gn] = acc[i][j];
    }
  }
}

template <typename T>
bool vec_ok(const T* a, const T* b, int N, int K) {
  constexpr int VW = Vec<T>::n;
  return K % VW == 0 && N % VW == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
}

template <typename T>
int launch(const T* a, const T* b, T* out, int M, int N, int K, int vec, int device,
           void* stream) {
  if (M < 0 || N < 0 || K <= 0) return -1;
  if (vec && !vec_ok(a, b, N, K)) return -1;  // the wrapper asked for a form the inputs refuse
  if (M == 0 || N == 0) return 0;  // empty output: nothing to do
  const long long gy = (M + BM - 1) / BM, gx = (N + BN - 1) / BN;
  if (gy > 65535 || gx > 2147483647LL) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  if (vec)
    minplus_kernel<T, true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(a, b, out, M, N, K);
  else
    minplus_kernel<T, false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(a, b, out, M, N, K);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int vec, int device, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0, sms = 0;
  err = vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, minplus_kernel<T, true>,
                                                            THREADS, 0)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, minplus_kernel<T, false>,
                                                            THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  info[0] = blocks;
  info[1] = sms;
  info[2] = BM;
  info[3] = BN;
  info[4] = BK;
  info[5] = THREADS;
  return 0;
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers.
// Launches on `stream`, does not synchronise, allocates nothing; returns the
// cudaError_t of the launch (0 = ok), -1 for arguments the kernel does not
// take (K = 0 has no minimum, the wrapper fills +inf itself; vec = 1 where K
// or N is not a multiple of 16 bytes' worth of elements or an input is not
// 16-byte aligned).
extern "C" int minplus_f32(const float* a, const float* b, float* out, int M, int N, int K,
                           int vec, int device, void* stream) {
  return launch<float>(a, b, out, M, N, K, vec, device, stream);
}

extern "C" int minplus_f64(const double* a, const double* b, double* out, int M, int N, int K,
                           int vec, int device, void* stream) {
  return launch<double>(a, b, out, M, N, K, vec, device, stream);
}

// The occupancy of one instantiation (itemsize 4 or 8, vec 0 or 1), as the
// runtime computes it: info[0] blocks per SM, info[1] SMs, info[2..5] the
// tile BM, BN, BK and the threads of a block. Returns a cudaError_t, -1 for
// an itemsize it does not serve.
extern "C" int minplus_occupancy(int itemsize, int vec, int device, int* info) {
  if (itemsize == 8) return occupancy<double>(vec, device, info);
  if (itemsize == 4) return occupancy<float>(vec, device, info);
  return -1;
}
