// Flash-attention forward with an additive key bias and a visibility
// offset (K5), written by hand for Hopper (sm_90a). Plain C interface,
// loaded with ctypes by deeplearning4j_tpu_torch/ops/flash_attention.py.
//
// Replaces: deeplearning4j_tpu/ops/pallas_attention.py, _flash_ext_raw
// (kernel body _flash_ext_kernel), reached through flash_attention_block
// (the ring's local block product) and flash_attention_masked (a key
// padding mask, from attention_auto).
//
// Function: q [N,Tq,H,D], k, v [N,Tk,H,D] (read in place through their
// strides), an optional additive key bias kb [N,Tk] f32 (0 keeps a key,
// -inf masks it; shared by the heads) and a host integer off. Key ki is
// visible to query qi iff qi + off >= ki: off = 0 is causal, off >= Tk
// shows every key, off <= -Tq hides every key (a ring step whose K/V
// shard lies wholly in the future). Scores s = q.k / sqrt(D) + kb, online
// softmax in f32. Outputs O [N,Tq,H,D] in q's dtype and lse [N,H,Tq] f32.
// A row with no visible key gives O = 0 and lse = -inf exactly (never a
// finite sentinel, never NaN): the ring combiner weighs each shard by
// exp(lse - max lse), and -inf weighs nothing. Any Tq and Tk: rows and
// keys past the ends are masked here (the TPU kernel needed both % 128).
//
// What bounds it on the H100: the products. At the ring's local shape
// (T=4096, H=8, D=64, causal) it is 17.2 GFLOP against 17 MB of q/k/v/o,
// ~1000 flops per byte, far past the ~295 at which bf16 tensor cores stop
// waiting on memory; so the bound is flops at 989 TFLOP/s. This first
// kernel does its products with f32 FMAs on the CUDA cores out of shared
// memory (K4's design), so in practice the FMA and shared-memory rate
// bound it.
//
// What the design does (K4's, plus two things):
//  * one CTA per (64-row q tile, n*h); 64-key K/V tiles stream through
//    shared memory; m, l and the O accumulator are f32 registers; 256
//    threads as 16 x 16, each owning 4 rows x 4 key columns of a score
//    tile and 4 rows x D/16 output columns.
//  * the tile's 64 key-bias values go to shared memory beside K and V.
//  * off is a host integer here (the TPU kernel traced it, so it swept
//    every key tile): each q tile stops at the last key tile any of its
//    rows can see, and a tile with no visible key at all writes O = 0 and
//    lse = -inf without reading K or V. Ring steps wholly in the future
//    cost one pass over the output.
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
  // Qs [64][D+1] + Kt [D][65] + Vs [64][D] + Ps [64][65] + Bs [64]
  return static_cast<size_t>(kBlockQ) * (D + 1) +
         static_cast<size_t>(D) * (kBlockK + 1) +
         static_cast<size_t>(kBlockK) * D +
         static_cast<size_t>(kBlockQ) * (kBlockK + 1) + kBlockK;
}

struct Strides {
  long long n, t, h;  // element strides; the D axis is contiguous
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_ext_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ kb,
                     T* __restrict__ o, float* __restrict__ lse, int Tq,
                     int Tk, int H, Strides sq, Strides sk, Strides sv,
                     int off, float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int OC = D / 16;            // output columns per thread
  constexpr int QP = D + 1;             // padded Qs row
  constexpr int KP = kBlockK + 1;       // padded Kt / Ps row
  extern __shared__ float smem[];
  float* Qs = smem;                     // [kBlockQ][QP]
  float* Kt = Qs + kBlockQ * QP;        // [D][KP]   (K transposed)
  float* Vs = Kt + D * KP;              // [kBlockK][D]
  float* Ps = Vs + kBlockK * D;         // [kBlockQ][KP]
  float* Bs = Ps + kBlockQ * KP;        // [kBlockK] key bias

  const int nh = blockIdx.x;
  const int n = nh / H;
  const int h = nh % H;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  // keys this q tile can see: ki <= q_last + off (off is clamped by the
  // caller to [-Tq, Tk], so the sum cannot overflow)
  const int q_last = min(q0 + kBlockQ, Tq) - 1;
  const int k_end = min(Tk, q_last + off + 1);  // exclusive; may be <= 0
  const int n_kt = k_end > 0 ? (k_end + kBlockK - 1) / kBlockK : 0;

  const T* qb = q + n * sq.n + h * sq.h;
  const T* kbase = k + n * sk.n + h * sk.h;
  const T* vbase = v + n * sv.n + h * sv.h;
  const float* bias = kb ? kb + static_cast<long long>(n) * Tk : nullptr;

  if (n_kt > 0) {
    for (int i = tid; i < kBlockQ * D; i += kThreads) {
      const int r = i / D;
      const int d = i % D;
      const int t = q0 + r;
      Qs[r * QP + d] = t < Tq ? to_f32(qb[t * sq.t + d]) * scale : 0.f;
    }
  }

  float m_i[4], l_i[4], acc[4][OC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[r][c] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D;
      const int d = i % D;
      const int t = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (t < Tk) {
        kx = to_f32(kbase[t * sk.t + d]);
        vx = to_f32(vbase[t * sv.t + d]);
      }
      Kt[d * KP + r] = kx;
      Vs[r * D + d] = vx;
    }
    if (tid < kBlockK) {
      const int t = k0 + tid;
      Bs[tid] = t < Tk ? (bias ? bias[t] : 0.f) : -INFINITY;
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
        const int col = tx + 16 * c;
        const int kj = k0 + col;
        // Bs is -inf past Tk; a -inf bias (a masked key) stays -inf
        const float sv_ = s[r][c] + Bs[col];
        s[r][c] = (qi + off >= kj) ? sv_ : -INFINITY;
        bmax = fmaxf(bmax, s[r][c]);
      }
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1)
        bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, sh));
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
      for (int sh = 8; sh > 0; sh >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, sh);
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

  const long long on = static_cast<long long>(Tq) * H * D;
  const long long ot = static_cast<long long>(H) * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty * 4 + r;
    if (qi < Tq) {
      // l = 0 exactly when no key was visible: O = 0, lse = -inf
      const float inv = l_i[r] > 0.f ? 1.f / l_i[r] : 0.f;
      T* orow = o + n * on + qi * ot + static_cast<long long>(h) * D;
#pragma unroll
      for (int c = 0; c < OC; ++c)
        orow[tx + 16 * c] = from_f32<T>(acc[r][c] * inv);
      if (tx == 0) {
        lse[(static_cast<long long>(n) * H + h) * Tq + qi] =
            l_i[r] > 0.f ? m_i[r] + logf(l_i[r]) : -INFINITY;
      }
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* kb;
  void* o;
  float* lse;
  int N, Tq, Tk, H, off;
  Strides sq, sk, sv;
};

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_ext_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.N * a.H, (a.Tq + kBlockQ - 1) / kBlockQ);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_ext_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.kb, static_cast<T*>(a.o), a.lse, a.Tq,
      a.Tk, a.H, a.sq, a.sk, a.sv, a.off, scale);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_d(int D, const Args& a, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(a, st);
    case 32: return launch<T, 32>(a, st);
    case 64: return launch<T, 64>(a, st);
    case 128: return launch<T, 128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. kb is a contiguous [N,Tk]
// float32 bias or null (no bias). o must be a contiguous [N,Tq,H,D]
// buffer of q's dtype, lse a contiguous [N,H,Tq] float32 one. off must
// lie in [-Tq, Tk] (the caller clamps it: the function does not change).
// Returns the CUDA error of the launch (0 = success); an unsupported head
// size or dtype returns cudaErrorInvalidValue without launching.
extern "C" int flash_attention_ext_fwd(
    const void* q, const void* k, const void* v, const void* kb, void* o,
    void* lse, int N, int Tq, int Tk, int H, int D, long long q_sn,
    long long q_st, long long q_sh, long long k_sn, long long k_st,
    long long k_sh, long long v_sn, long long v_st, long long v_sh, int off,
    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N == 0 || H == 0 || Tq == 0) return 0;
  if (off < -Tq || off > Tk) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, static_cast<const float*>(kb), o,
               static_cast<float*>(lse), N, Tq, Tk, H, off,
               Strides{q_sn, q_st, q_sh}, Strides{k_sn, k_st, k_sh},
               Strides{v_sn, v_st, v_sh}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch_d<float>(D, a, st);
  } else if (dtype == 1) {
    err = launch_d<__nv_bfloat16>(D, a, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
