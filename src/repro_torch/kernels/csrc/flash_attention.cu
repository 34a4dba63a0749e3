// flash_attention — forward online-softmax attention for NVIDIA Hopper
// (sm_90a): a tensor-core kernel for bfloat16 inputs and a CUDA-core kernel
// for float32 inputs.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_pallas (body
// _kernel). Contract: q [B, H, S, D], k/v [B, Hkv, S, D] of one dtype,
// out [B, H, S, D] of that dtype,
//     out[b, h, i] = sum_j p_ij v[b, h // (H/Hkv), j] / sum_j p_ij,
// with p_ij the softmax weights of s_ij = (q_i . k_j) * scale over the keys
// j that are not masked (causal: j > i masked). Tensors are addressed
// through their (batch, head, sequence) strides with D contiguous, so the
// caller's [B, S, H, D] activations need no transposed copy. GQA is by
// index: the KV head is h // (H/Hkv), K and V are never repeated in memory.
// Heavy causal query tiles (late rows) are scheduled first, key tiles past
// a block's last row are never loaded, and only the tiles that cross the
// diagonal are masked element by element.
//
// ---- bfloat16: flash_bf16_kernel (wgmma, TMA, warp-specialised) ----------
// Arithmetic (the plain version is flash_attention_bf16_ref): keys in tiles
// of BK (128; 64 at D = 256), in order; s = q·kᵀ in float32 on the tensor
// cores; masked positions -inf; per row a running max m and sum l; with
// c = scale·log2(e) folded in, corr = 2^((m − m')·c) and p = 2^(s·c − m'·c)
// (one fused multiply-add), both by ex2.approx (~2 ulp); l = l·corr + Σ p
// sums p in float32 BEFORE it is rounded; p is rounded to bf16 and is the
// register A operand of o += p·v (float32 accumulation); out = o / l,
// rounded to bf16. Rounding p to v's dtype is the arithmetic of the JAX
// package's oracle repro.kernels.ref.flash_attention.
//
// What bounds it on this card: operations. At the LM path's shape (B 4,
// H 16, Hkv 2, S 2 048, D 128, causal) it moves 25 MB and does
// 4·B·H·S²·D/2 = 69 GFLOP, 0.070 ms at the 989 TFLOP/s bf16 tensor-core
// peak. The design puts every product on the tensor cores and keeps the
// copies off the critical path:
//   * one block = 128 query rows of one (b, h) (64 at D = 256, below):
//     two consumer warpgroups and one producer warp. One thread of the
//     producer warp starts TMA copies (cp.async.bulk.tensor, 4-d maps over
//     (D, S, heads, B) with the caller's strides) of the Q tile and of a
//     ring of STAGES = 2 K and V tiles, each completing on an mbarrier (K
//     and V of a stage on separate barriers, so S = QKᵀ starts while V is
//     in flight). Each consumer
//     warpgroup takes 64 rows: wgmma m64nBKk16 for S = QKᵀ (Q and K from
//     shared memory through descriptors, both K-major), the online softmax
//     on the accumulator fragment, P repacked in registers as the bf16 A
//     fragment (the m64nNk16 accumulator of 16 keys is exactly the A
//     fragment of one k16 step), and wgmma m64nDk16 with A from registers
//     and V [keys, D] from shared memory with the transpose bit (V's
//     contiguous axis is D, the product's N: no transposed copy). A consumer
//     warp releases a stage to the producer through an "empty" mbarrier
//     once its P·V is complete.
//   * TMA writes each tile as D/CW boxes of [rows, CW] with the swizzle
//     span SW = 2·CW = min(2·D, 128) bytes (CU_TENSOR_MAP_SWIZZLE_128B /
//     64B / 32B), and the wgmma descriptors use the matching layout type;
//     every box starts on a 1 024-byte boundary.
//   * D = 256: the 64 × 256 float32 output accumulator takes 128 registers
//     a thread. ptxas compiles the whole kernel under the launch bound's
//     register limit (168 with a producer warpgroup, 384 threads), and
//     setmaxnreg did not raise it (that build spilled and serialised its
//     wgmma), so D = 256 takes 64-row blocks: ONE consumer warpgroup
//     (160 threads, up to 255 registers) over 64-key tiles.
//   * Within a consumer, the products and the softmax run one after the
//     other; the two consumers overlap each other. Two schedules that
//     overlap more were slower on an H100 at the LM shape: the consumers
//     taking turns through named barriers, and S of the next tile launched
//     before P·V of this one with three stages (at BK = 128 ptxas spilled,
//     at BK = 64 the tiles are shorter). A third stage gained nothing.
// A TMA map needs the batch, head and sequence strides to be multiples of
// 16 bytes and the base 16-byte aligned; the wrapper checks and raises.
//
// ---- float32: flash_fwd_kernel (CUDA cores) -------------------------------
// The Pallas body's arithmetic: every product, sum and exponential is
// float32, p included; s_ij = -1e30 where causal and j > i (NEG_INF of the
// Pallas body); the output is rounded to the input dtype once, at the end.
// Bound: the same 69 GFLOP at the LM shape on the CUDA cores in float32
// (67 TFLOP/s peak).
//
// Mapping: one block per (b·h, tile of BQ = 64 query rows); heavy causal
// tiles (late rows) are scheduled first. A row is owned by TPR = D/32 threads
// (1 for D <= 32) that each keep DS = D/TPR of its q values and of its
// float32 accumulator in registers, in float4 pieces interleaved across the
// TPR threads so that their shared-memory reads fall in distinct banks. Per
// tile of BK keys the block stages K and V in shared memory as float32
// (converted once at staging; above 48 KB this needs the dynamic
// shared-memory attribute, set at first launch). Scores are taken CH = 16
// keys at a time: partial dot products over the thread's slice, summed over
// the TPR threads with an xor butterfly (every thread of the row ends with
// the same bits), then the running max m, sum l and accumulator are
// rescaled once per chunk. With causal, key tiles past the block's last row
// are never loaded and chunks past it are skipped; the diagonal is masked
// element by element. Rows past S compute on zeros and are not stored; keys
// past S are masked.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;  // query rows per block
constexpr int CH = 16;  // keys per online-softmax update

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <int D>
struct Shape {
  static constexpr int TPR = D >= 32 ? D / 32 : 1;  // threads per query row
  static constexpr int DS = D / TPR;                // values of a row per thread
  static constexpr int NF4 = DS / 4;                // float4 pieces per thread
  static constexpr int THREADS = BQ * TPR;
  static constexpr int BK = D > 128 ? 32 : 64;  // keys per staged tile
  static constexpr int SMEM = 2 * BK * D * (int)sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int H, int rep, int S, long long qsb, long long qsh,
                 long long qss, long long ksb, long long ksh, long long kss, long long vsb,
                 long long vsh, long long vss, long long osb, long long osh, long long oss,
                 float scale, int causal) {
  using SH = Shape<D>;
  constexpr int TPR = SH::TPR, NF4 = SH::NF4, BK = SH::BK, THREADS = SH::THREADS;
  extern __shared__ float4 smem4[];
  float4* Ks = smem4;             // [BK][D/4]
  float4* Vs = smem4 + BK * D / 4;  // [BK][D/4]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // late (heavy) tiles first
  const int tid = threadIdx.x;
  const int r = tid / TPR, t = tid % TPR;
  const int row = q0 + r;
  const bool live = row < S;

  const T* __restrict__ kb = k + b * ksb + hk * ksh;
  const T* __restrict__ vb = v + b * vsb + hk * vsh;
  // this thread's dims: 4·(t + TPR·u) + e for u < NF4, e < 4
  float4 qr[NF4], acc[NF4];
  {
    const T* __restrict__ qp = q + b * qsb + h * qsh + (long long)(live ? row : 0) * qss;
#pragma unroll
    for (int u = 0; u < NF4; ++u) {
      const int d = 4 * (t + TPR * u);
      qr[u] = live ? make_float4(to_f32(qp[d]), to_f32(qp[d + 1]), to_f32(qp[d + 2]),
                                 to_f32(qp[d + 3]))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  float m = NEG_INF, l = 0.f;
  const int kend = causal ? min(S, q0 + BQ) : S;  // keys [0, kend) reach this block

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    float* Kf = reinterpret_cast<float*>(Ks);
    float* Vf = reinterpret_cast<float*>(Vs);
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int j = idx / D, d = idx % D, key = k0 + j;
      const bool inside = key < S;
      Kf[idx] = inside ? to_f32(kb[(long long)key * kss + d]) : 0.f;
      Vf[idx] = inside ? to_f32(vb[(long long)key * vss + d]) : 0.f;
    }
    __syncthreads();
    for (int c0 = 0; c0 < BK && k0 + c0 < kend; c0 += CH) {
      float s[CH];
      float cmax = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const float4* kr = Ks + (c0 + jj) * (D / 4) + t;
        float dot = 0.f;
#pragma unroll
        for (int u = 0; u < NF4; ++u) {
          const float4 kv = kr[TPR * u];
          dot += qr[u].x * kv.x;
          dot += qr[u].y * kv.y;
          dot += qr[u].z * kv.z;
          dot += qr[u].w * kv.w;
        }
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off, TPR);
        const int key = k0 + c0 + jj;
        const bool ok = key < S && (!causal || key <= row);
        s[jj] = ok ? dot * scale : NEG_INF;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        s[jj] = expf(s[jj] - m_new);
        psum += s[jj];
      }
      l = l * corr + psum;
#pragma unroll
      for (int u = 0; u < NF4; ++u) {
        acc[u].x *= corr;
        acc[u].y *= corr;
        acc[u].z *= corr;
        acc[u].w *= corr;
      }
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const float4* vr = Vs + (c0 + jj) * (D / 4) + t;
        const float p = s[jj];
#pragma unroll
        for (int u = 0; u < NF4; ++u) {
          const float4 vv = vr[TPR * u];
          acc[u].x += p * vv.x;
          acc[u].y += p * vv.y;
          acc[u].z += p * vv.z;
          acc[u].w += p * vv.w;
        }
      }
      m = m_new;
    }
  }
  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
  T* __restrict__ op = out + b * osb + h * osh + (long long)row * oss;
#pragma unroll
  for (int u = 0; u < NF4; ++u) {
    const int d = 4 * (t + TPR * u);
    op[d] = from_f32<T>(acc[u].x / den);
    op[d + 1] = from_f32<T>(acc[u].y / den);
    op[d + 2] = from_f32<T>(acc[u].z / den);
    op[d + 3] = from_f32<T>(acc[u].w / den);
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int B, H, Hkv, S;
  const long long* st;  // 12 strides in elements: q, k, v, out × (batch, head, seq)
  float scale;
  int causal;
};

template <typename T, int D>
int launch_d(const Args& a, cudaStream_t stream) {
  using SH = Shape<D>;
  auto kern = flash_fwd_kernel<T, D>;
  if (SH::SMEM > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SH::SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const long long q_tiles = (a.S + BQ - 1) / BQ;
  const long long bh = (long long)a.B * a.H;
  if (q_tiles > 65535 || bh > 2147483647LL) return -1;
  const dim3 grid((unsigned)bh, (unsigned)q_tiles);
  const long long* s = a.st;
  kern<<<grid, SH::THREADS, SH::SMEM, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out, a.H, a.H / a.Hkv, a.S, s[0], s[1],
      s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int D, int device, void* stream) {
  if (a.B < 0 || a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv || a.S < 0) return -1;
  if (a.B == 0 || a.S == 0) return 0;  // empty output: nothing to do
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_d<T, 16>(a, st);
    case 32: return launch_d<T, 32>(a, st);
    case 64: return launch_d<T, 64>(a, st);
    case 128: return launch_d<T, 128>(a, st);
    case 256: return launch_d<T, 256>(a, st);
    default: return -1;
  }
}

// ============================================================ bf16: wgmma
template <int D>
struct TcShape {
  // consumer warpgroups of 64 query rows: two, and one at D = 256, where the
  // 64 × 256 f32 accumulator takes 128 registers a thread (see the header)
  static constexpr int NWG = D > 128 ? 1 : 2;
  static constexpr int BQ = 64 * NWG;              // query rows per block
  static constexpr int THREADS = 128 * NWG + 32;   // + one producer warp
  static constexpr int STAGES = 2;                 // K/V ring depth
  static constexpr int BK = D > 128 ? 64 : 128;    // keys per tile
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;  // swizzle span = box row bytes
  static constexpr int CW = SW / 2;                // columns per box
  static constexpr int NC = D / CW;                // boxes per tile
  static constexpr int LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;  // wgmma descriptor swizzle
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES;  // + alignment slack
};

template <int N>
struct Wgmma;
// wgmma.mma_async m64nNk16, f32 += bf16 · bf16. ss: A and B from shared
// memory (both K-major); rs: A from registers, B from shared memory with the
// transpose bit (MN-major). d holds the N/2 accumulator values of a thread.
template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void ss(float* d, uint64_t da, uint64_t db, int sd) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7 "
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(sd));
  }
  __device__ __forceinline__ static void rs(float* d, const uint32_t* a, uint64_t db,
                                            int sd) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7 "
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(sd));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void ss(float* d, uint64_t da, uint64_t db, int sd) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15 "
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(sd));
  }
  __device__ __forceinline__ static void rs(float* d, const uint32_t* a, uint64_t db,
                                            int sd) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15 "
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(sd));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void ss(float* d, uint64_t da, uint64_t db, int sd) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(sd));
  }
  __device__ __forceinline__ static void rs(float* d, const uint32_t* a, uint64_t db,
                                            int sd) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(sd));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void ss(float* d, uint64_t da, uint64_t db, int sd) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(sd));
  }
  __device__ __forceinline__ static void rs(float* d, const uint32_t* a, uint64_t db,
                                            int sd) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(sd));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void ss(float* d, uint64_t da, uint64_t db, int sd) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127 "
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(sd));
  }
  __device__ __forceinline__ static void rs(float* d, const uint32_t* a, uint64_t db,
                                            int sd) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127 "
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(sd));
  }
};
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout type.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo & 0x3FFF) << 16) |
         ((uint64_t)(sbo & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {  // at most N committed groups still pending
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (as cutlass::warpgroup_fence_operand).
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Waits until the phase of parity `parity` of the barrier has completed. A
// wait that never ends (a copy that never lands) traps after 2^26 polls, so
// a fault shows as a launch error, not as a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// 2^x by the special-function unit (ex2.approx.ftz: ~2 ulp, subnormal
// results flushed to zero; exp2f adds subnormal handling around it)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(TcShape<D>::THREADS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                  long long osb, long long osh, long long oss, int H, int rep, int S, float c,
                  int causal) {
  using SH = TcShape<D>;
  constexpr int BQ = SH::BQ, BK = SH::BK, SW = SH::SW, CW = SH::CW, NC = SH::NC;
  extern __shared__ unsigned char smem_raw[];
  constexpr int STAGES = SH::STAGES;
  __shared__ __align__(8) uint64_t bar_q, bar_k[STAGES], bar_v[STAGES], bar_e[STAGES];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = base;  // NC boxes of [BQ][SW]
  // stage st: K at sKV + st·2·KV_BYTES, V right after; NC boxes of [BK][SW] each
  unsigned char* sKV = base + SH::Q_BYTES;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // late (heavy) tiles first
  const int kend = causal ? min(S, q0 + BQ) : S;     // keys [0, kend) reach this block
  const int ntiles = (kend + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&bar_k[st], 1);
      mbar_init(&bar_v[st], 1);
      mbar_init(&bar_e[st], 4 * SH::NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * SH::NWG) {
    // ---------------------------------------------------- producer warp
    if (threadIdx.x == 128 * SH::NWG) {
      mbar_expect_tx(&bar_q, SH::Q_BYTES);
#pragma unroll
      for (int j = 0; j < NC; ++j) tma_load_4d(sQ + j * BQ * SW, &tq, &bar_q, j * CW, q0, h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % STAGES;
        if (t >= STAGES) mbar_wait(&bar_e[st], ((t / STAGES) - 1) & 1);
        unsigned char* sK = sKV + st * 2 * SH::KV_BYTES;
        unsigned char* sV = sK + SH::KV_BYTES;
        mbar_expect_tx(&bar_k[st], SH::KV_BYTES);
#pragma unroll
        for (int j = 0; j < NC; ++j)
          tma_load_4d(sK + j * BK * SW, &tk, &bar_k[st], j * CW, t * BK, hk, b);
        mbar_expect_tx(&bar_v[st], SH::KV_BYTES);
#pragma unroll
        for (int j = 0; j < NC; ++j)
          tma_load_4d(sV + j * BK * SW, &tv, &bar_v[st], j * CW, t * BK, hk, b);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    const int cw = threadIdx.x / 128;  // which 64 rows of the block
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int row0 = q0 + cw * 64 + warp * 16 + lane / 4;  // rows row0 and row0 + 8
    const int col = 2 * (lane % 4);  // first of the thread's two columns in each group of 8
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    mbar_wait(&bar_q, 0);
    const unsigned char* sQw = sQ + cw * 64 * SW;

    for (int t = 0; t < ntiles; ++t) {
      const int st = t % STAGES, ph = (t / STAGES) & 1;
      const unsigned char* sK = sKV + st * 2 * SH::KV_BYTES;
      const unsigned char* sV = sK + SH::KV_BYTES;
      const int k0 = t * BK;

      // S = Q Kᵀ over D in k16 steps (K-major: step kk is 32 bytes into its box)
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      mbar_wait(&bar_k[st], ph);
      fence_regs<BK / 2>(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int box = kk * 16 / CW, off = (kk * 16 % CW) * 2;
        const uint64_t da = make_desc(sQw + box * BQ * SW + off, 1, SW / 2, SH::LAYOUT);
        const uint64_t db = make_desc(sK + box * BK * SW + off, 1, SW / 2, SH::LAYOUT);
        Wgmma<BK>::ss(s, da, db, kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs<BK / 2>(s);

      // mask: keys past S, and (causal) keys past the row, on the tiles
      // that reach them
      if (k0 + BK > S || (causal && k0 + BK - 1 > q0 + cw * 64)) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * n + col + (e & 1);
            const int row = row0 + 8 * (e >> 1);
            if (key >= S || (causal && key > row)) s[4 * n + e] = -INFINITY;
          }
      }
      // online softmax on the accumulator fragment: value e of group n is
      // (row0 + 8·(e >> 1), k0 + 8n + col + (e & 1)); a row's values are
      // spread over the 4 lanes of a quad
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
          mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        corr[i] = ex2((m[i] - m_new) * c);
        const float msc = m_new * c;
        float ls = 0.f;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(fmaf(s[4 * n + 2 * i + e], c, -msc));
            s[4 * n + 2 * i + e] = p;
            ls += p;
          }
        l[i] = l[i] * corr[i] + ls;  // this thread's part of the row sum (quad-reduced at the end)
        m[i] = m_new;
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= corr[0];
        o[4 * n + 1] *= corr[0];
        o[4 * n + 2] *= corr[1];
        o[4 * n + 3] *= corr[1];
      }
      // P as the bf16 A fragment of the k16 steps of P·V: the accumulator of
      // keys 16kk..16kk+15 (groups 2kk, 2kk+1) is exactly that fragment
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P V: V [BK keys][D] is MN-major (D contiguous); step kk starts
      // 16 key rows down; LBO steps from one box of CW columns to the next
      mbar_wait(&bar_v[st], ph);
      fence_regs<D / 2>(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = make_desc(sV + kk * 16 * SW, BK * SW / 16, SW / 2, SH::LAYOUT);
        Wgmma<D>::rs(o, pa[kk], dv, 1);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs<D / 2>(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar_e[st]);  // this warp is done with the stage
    }

    // epilogue: full row sums, o / l, rounded to bf16; rows past S are not stored
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int row = row0 + 8 * i;
      if (row >= S) continue;
      __nv_bfloat16* op = out + b * osb + h * osh + (long long)row * oss + col;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * n) =
            __floats2bfloat162_rn(o[4 * n + 2 * i] / l[i], o[4 * n + 2 * i + 1] / l[i]);
      }
    }
  }
}

// cuTensorMapEncodeTiled lives in libcuda: its address is fetched through
// the runtime, so the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// 4-d map over (D, S, heads, B) of a bf16 tensor with element strides
// (sb, sh, ss) and D contiguous; boxes of [rows, cw] with the given swizzle.
// Returns 0 or -1 (strides the TMA does not take, or the encoder failed).
int make_map(CUtensorMap* map, const void* ptr, int D, int S, int heads, int B, long long sb,
             long long sh, long long ss, int rows, int cw, CUtensorMapSwizzle swz) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return -1;
  if ((reinterpret_cast<uintptr_t>(ptr) & 15) || (sb * 2) % 16 || (sh * 2) % 16 || (ss * 2) % 16)
    return -1;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(ss * 2), (cuuint64_t)(sh * 2), (cuuint64_t)(sb * 2)};
  const cuuint32_t box[4] = {(cuuint32_t)cw, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                   box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1;
}

template <int D>
int launch_tc(const Args& a, cudaStream_t stream) {
  using SH = TcShape<D>;
  const CUtensorMapSwizzle swz = SH::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : SH::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  const long long* s = a.st;
  CUtensorMap mq, mk, mv;
  if (make_map(&mq, a.q, D, a.S, a.H, a.B, s[0], s[1], s[2], SH::BQ, SH::CW, swz) ||
      make_map(&mk, a.k, D, a.S, a.Hkv, a.B, s[3], s[4], s[5], SH::BK, SH::CW, swz) ||
      make_map(&mv, a.v, D, a.S, a.Hkv, a.B, s[6], s[7], s[8], SH::BK, SH::CW, swz))
    return -1;
  auto kern = flash_bf16_kernel<D>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SH::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const long long q_tiles = (a.S + SH::BQ - 1) / SH::BQ;
  const long long bh = (long long)a.B * a.H;
  if (q_tiles > 65535 || bh > 2147483647LL) return -1;
  const dim3 grid((unsigned)bh, (unsigned)q_tiles);
  kern<<<grid, SH::THREADS, SH::SMEM, stream>>>(mq, mk, mv, (__nv_bfloat16*)a.out, s[9], s[10],
                                               s[11], a.H, a.H / a.Hkv, a.S, a.scale, a.causal);
  return (int)cudaGetLastError();
}

int launch_bf16(const Args& a, int D, int device, void* stream) {
  if (a.B < 0 || a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv || a.S < 0) return -1;
  if (a.B == 0 || a.S == 0) return 0;  // empty output: nothing to do
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_tc<16>(a, st);
    case 32: return launch_tc<32>(a, st);
    case 64: return launch_tc<64>(a, st);
    case 128: return launch_tc<128>(a, st);
    case 256: return launch_tc<256>(a, st);
    default: return -1;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers except
// `strides` (12 int64 on the host: q, k, v, out, each (batch, head, seq) in
// elements; D is contiguous). flash_attention_f32 takes `scale`,
// flash_attention_bf16 `scale_log2` = scale·log2(e). Launches on `stream`,
// does not synchronise, allocates nothing; returns the cudaError_t of the
// launch (0 = ok), -1 for arguments the kernel does not take (D not in
// {16, 32, 64, 128, 256}; for bf16 also q/k/v strides that are not
// multiples of 16 bytes, a base that is not 16-byte aligned, or no tensor-map
// encoder in libcuda).
extern "C" int flash_attention_f32(const float* q, const float* k, const float* v, float* out,
                                   int B, int H, int Hkv, int S, int D, const long long* strides,
                                   float scale, int causal, int device, void* stream) {
  return launch<float>(Args{q, k, v, out, B, H, Hkv, S, strides, scale, causal}, D, device,
                       stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, int B,
                                    int H, int Hkv, int S, int D, const long long* strides,
                                    float scale_log2, int causal, int device, void* stream) {
  return launch_bf16(Args{q, k, v, out, B, H, Hkv, S, strides, scale_log2, causal}, D, device,
                     stream);
}
