// flash_attention — forward online-softmax attention, float32 math, inputs
// and output float32 or bfloat16, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_pallas (body
// _kernel). Same contract: q [B, H, S, D], k/v [B, Hkv, S, D] of one dtype,
// out [B, H, S, D] of that dtype,
//     out[b, h, i] = sum_j p_ij v[b, h // (H/Hkv), j] / sum_j p_ij,
//     p_ij = exp(s_ij - max_j s_ij),  s_ij = (q_i . k_j) * scale,
// with s_ij = -1e30 where causal and j > i (NEG_INF of the Pallas body).
// Every product, sum and exponential is float32, p included (the reference's
// ref.flash_attention instead rounds p to v's dtype before p @ v); the
// output is rounded to the input dtype once, at the end.
//
// What bounds it on this card: operations. At the LM path's shape (B 4,
// H 16, Hkv 2, S 2 048, D 128, causal) the function moves 25 MB in bf16 and
// does 4·B·H·S²·D/2 = 69 GFLOP. This first kernel runs them on the CUDA
// cores in float32 (67 TFLOP/s peak, not the tensor cores' 989 bf16): the
// wgmma/TMA redesign is later work.
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
// element by element. GQA is by index: the KV head is h // (H/Hkv), K and V
// are never repeated in memory. Tensors are addressed through their
// (batch, head, sequence) strides, D contiguous, so the caller's
// [B, S, H, D] activations need no transposed copy. Rows past S compute on
// zeros and are not stored; keys past S are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;  // query rows per block
constexpr int CH = 16;  // keys per online-softmax update

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

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

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers except
// `strides` (12 int64 on the host: q, k, v, out, each (batch, head, seq) in
// elements; D is contiguous). Launches on `stream`, does not synchronise,
// allocates nothing; returns the cudaError_t of the launch (0 = ok), -1 for
// arguments the kernel does not take (D not in {16, 32, 64, 128, 256}).
extern "C" int flash_attention_f32(const float* q, const float* k, const float* v, float* out,
                                   int B, int H, int Hkv, int S, int D, const long long* strides,
                                   float scale, int causal, int device, void* stream) {
  return launch<float>(Args{q, k, v, out, B, H, Hkv, S, strides, scale, causal}, D, device,
                       stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, int B,
                                    int H, int Hkv, int S, int D, const long long* strides,
                                    float scale, int causal, int device, void* stream) {
  return launch<__nv_bfloat16>(Args{q, k, v, out, B, H, Hkv, S, strides, scale, causal}, D,
                               device, stream);
}
