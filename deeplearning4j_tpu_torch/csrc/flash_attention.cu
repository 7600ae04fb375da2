// Flash-attention forward (admission prefill), written by hand for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// deeplearning4j_tpu_torch/ops/flash_attention.py.
//
// Replaces: deeplearning4j_tpu/ops/pallas_attention.py, _flash_raw
// (kernel body _flash_kernel), reached through flash_attention and
// attention_auto.
//
// Function: q, k, v [N,T,H,D] (read in place through their strides — no
// head-folding transposes); causal or full softmax(q.k / sqrt(D)) v with
// f32 scores and an online softmax. Outputs O [N,T,H,D] in q's dtype and
// the per-row log-sum-exp lse [N,H,T] f32 (the residual a backward
// needs). Any T: q rows >= T and keys >= T are masked here, so every
// prefill bucket width (96, 192, ...) runs through the kernel — the TPU
// kernel needed T % 128 == 0 and the JAX package fell back to dense XLA
// below that.
//
// What bounds it on the H100: at the serving shapes (T <= 1024, D = 64)
// memory — q/k/v/o are read or written once, ~16.8 MB at T=1024, H=32 in
// bf16, against ~4.3 GFLOP causal — but only for a kernel that runs the
// products on the tensor cores. This first kernel does its products with
// f32 FMAs on the CUDA cores out of shared memory, so in practice the FMA
// and shared-memory rate bound it.
//
// What the design does:
//  * one CTA per (64-row q tile, n*h); the q tile stays in shared memory
//    (pre-scaled by 1/sqrt(D)) while 64-key K/V tiles stream through it,
//    up to the diagonal tile when causal. The TPU kernel kept a whole
//    row's K and V resident in VMEM; an SM has 227 KB, so here K/V are
//    tiled and nothing of the [T,T] scores reaches device memory.
//  * 256 threads as 16 x 16: thread (ty, tx) owns q rows 4ty..4ty+3,
//    key columns tx+16c and output columns tx+16c, so each k-step does
//    4x4 register-tiled FMAs and the row max / row sum reduce over 16
//    lanes of one warp with shuffles. K is stored transposed and every
//    shared row padded by one float so those reads are bank-conflict
//    free.
//  * m, l and the O accumulator are f32 in registers; O is divided by l
//    once at the end.
// Not done yet (later work): mma.sync / wgmma on bf16 tiles, TMA loads,
// double-buffered K/V.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_floats() {
  // Qs [64][D+1] + Kt [D][65] + Vs [64][D] + Ps [64][65]
  return static_cast<size_t>(kBlockQ) * (D + 1) +
         static_cast<size_t>(D) * (kBlockK + 1) +
         static_cast<size_t>(kBlockK) * D +
         static_cast<size_t>(kBlockQ) * (kBlockK + 1);
}

struct Strides {
  long long n, t, h;  // element strides; the D axis is contiguous
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int T_len, int H, Strides sq,
                     Strides sk, Strides sv, int causal, float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int OC = D / 16;            // output columns per thread
  constexpr int QP = D + 1;             // padded Qs row
  constexpr int KP = kBlockK + 1;       // padded Kt / Ps row
  extern __shared__ float smem[];
  float* Qs = smem;                     // [kBlockQ][QP]
  float* Kt = Qs + kBlockQ * QP;        // [D][KP]   (K transposed)
  float* Vs = Kt + D * KP;              // [kBlockK][D]
  float* Ps = Vs + kBlockK * D;         // [kBlockQ][KP]

  const int nh = blockIdx.x;
  const int n = nh / H;
  const int h = nh % H;
  const int qt = blockIdx.y;
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const T* qb = q + n * sq.n + h * sq.h;
  const T* kb = k + n * sk.n + h * sk.h;
  const T* vb = v + n * sv.n + h * sv.h;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const int t = q0 + r;
    Qs[r * QP + d] = t < T_len ? to_f32(qb[t * sq.t + d]) * scale : 0.f;
  }

  float m_i[4], l_i[4], acc[4][OC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[r][c] = 0.f;
  }

  const int n_kt_all = (T_len + kBlockK - 1) / kBlockK;
  const int n_kt = causal ? min(n_kt_all, qt + 1) : n_kt_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D;
      const int d = i % D;
      const int t = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (t < T_len) {
        kx = to_f32(kb[t * sk.t + d]);
        vx = to_f32(vb[t * sv.t + d]);
      }
      Kt[d * KP + r] = kx;
      Vs[r * D + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Qs[(ty * 4 + r) * QP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Kt[d * KP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], b[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty * 4 + r;
      float bmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        const bool vis = kj < T_len && (!causal || kj <= qi);
        if (!vis) s[r][c] = -INFINITY;
        bmax = fmaxf(bmax, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
      const float m_new = fmaxf(m_i[r], bmax);
      // a row that has seen no visible key yet keeps m = -inf; keep the
      // exp arguments finite (exp(-inf - -inf) would be nan)
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m_i[r] == -INFINITY ? 0.f : expf(m_i[r] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pr = s[r][c] == -INFINITY ? 0.f : expf(s[r][c] - m_safe);
        Ps[(ty * 4 + r) * KP + tx + 16 * c] = pr;
        rs += pr;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[r] = l_i[r] * corr + rs;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[r][c] *= corr;
      m_i[r] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float a[4], b[OC];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Ps[(ty * 4 + r) * KP + j];
#pragma unroll
      for (int c = 0; c < OC; ++c) b[c] = Vs[j * D + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }

  const long long on = static_cast<long long>(T_len) * H * D;
  const long long ot = static_cast<long long>(H) * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty * 4 + r;
    if (qi < T_len) {
      const float l_safe = fmaxf(l_i[r], 1e-30f);
      const float inv = 1.f / l_safe;
      T* orow = o + n * on + qi * ot + static_cast<long long>(h) * D;
#pragma unroll
      for (int c = 0; c < OC; ++c)
        orow[tx + 16 * c] = from_f32<T>(acc[r][c] * inv);
      if (tx == 0) {
        const float m_fin = m_i[r] == -INFINITY ? 0.f : m_i[r];
        lse[(static_cast<long long>(n) * H + h) * T_len + qi] =
            m_fin + logf(l_safe);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int N, int T_len, int H, Strides sq, Strides sk,
                   Strides sv, int causal, cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(N * H, (T_len + kBlockQ - 1) / kBlockQ);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      T_len, H, sq, sk, sv, causal, scale);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, void* lse, int N, int T_len, int H, Strides sq,
                     Strides sk, Strides sv, int causal, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, N, T_len, H, sq, sk, sv, causal, st);
    case 32: return launch<T, 32>(q, k, v, o, lse, N, T_len, H, sq, sk, sv, causal, st);
    case 64: return launch<T, 64>(q, k, v, o, lse, N, T_len, H, sq, sk, sv, causal, st);
    case 128: return launch<T, 128>(q, k, v, o, lse, N, T_len, H, sq, sk, sv, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. o must be a contiguous
// [N,T,H,D] buffer of q's dtype, lse a contiguous [N,H,T] float32 one.
// Returns the CUDA error of the launch (0 = success); an unsupported
// head size or dtype returns cudaErrorInvalidValue without launching.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int N,
    int T_len, int H, int D, long long q_sn, long long q_st, long long q_sh,
    long long k_sn, long long k_st, long long k_sh, long long v_sn,
    long long v_st, long long v_sh, int causal, int dtype, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N == 0 || T_len == 0) return 0;
  const Strides sq{q_sn, q_st, q_sh}, sk{k_sn, k_st, k_sh},
      sv{v_sn, v_st, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch_d<float>(D, q, k, v, o, lse, N, T_len, H, sq, sk, sv, causal, st);
  } else if (dtype == 1) {
    err = launch_d<__nv_bfloat16>(D, q, k, v, o, lse, N, T_len, H, sq, sk, sv, causal, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
