// Paged-decode attention over a block arena, written by hand for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// deeplearning4j_tpu_torch/ops/paged_attention.py.
//
// Replaces: deeplearning4j_tpu/ops/pallas_paged.py, paged_attention
// (kernel body _paged_kernel).
//
// Function: one query per lane. q [S,H,D]; one layer's arena view
// ck/cv [NB+1, bt, H, D] (physical block 0 is trash); tables [S,m] int32
// maps a lane's logical block j to a physical block; pos [S] int32. Token
// t of lane s is visible iff t <= pos[s]. out [S,H,D] f32 =
// softmax(q.k / sqrt(D)) v over the visible tokens.
//
// What bounds it on the H100: memory. Each visible token's K and V row is
// read once (2*H*D*sizeof(kv) bytes) and used for 4*D flops per head, far
// below the ~295 flops/byte where the card stops being memory-bound.
//
// What the design does about it:
//  * it reads only the visible tokens: the CTA reads tables[s, j] and
//    pos[s] itself (the TPU kernel's scalar prefetch) and walks blocks
//    j <= pos/bt, stopping at pos — the TPU kernel sweeps all m table
//    slots under the mask; the function is the same, the bytes are not.
//    The trash block is therefore never read by an active lane, so its
//    content cannot reach an active lane's output, not even through a
//    zero weight.
//  * one warp owns one (lane, head): each of its 32 threads holds D/32
//    contiguous elements of q, k and v, so a token's K or V row is one
//    coalesced 2*D-byte (bf16) read across the warp.
//  * it walks a lane's table block by block: the next block's table entry
//    is read while the current block is processed, and 16 tokens (8 at
//    D=128) have their K and V rows read together, so a warp keeps
//    2*16 row reads in flight per memory round trip; their dots and
//    warp-shuffle reductions are independent too.
//  * the softmax is online (running max m, denominator l, accumulator in
//    f32 registers), so nothing of the window is written to memory.
// Not done yet (later work): split-K over long contexts, cp.async/TMA
// prefetch of the next chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kWarpsPerCta = 4;  // one warp per head, 4 heads per CTA

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// EPL contiguous elements starting at p (p is EPL-aligned).
template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[EPL]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && EPL % 2 == 0) {
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
    for (int e = 0; e < EPL / 2; ++e) {
      const float2 f = __bfloat1622float2(p2[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  } else if constexpr (std::is_same<T, float>::value && EPL % 2 == 0) {
    const float2* p2 = reinterpret_cast<const float2*>(p);
#pragma unroll
    for (int e = 0; e < EPL / 2; ++e) {
      const float2 f = p2[e];
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < EPL; ++e) out[e] = to_f32(p[e]);
  }
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
    paged_attention_kernel(const TQ* __restrict__ q,
                           const TKV* __restrict__ ck,
                           const TKV* __restrict__ cv,
                           const int* __restrict__ tables,
                           const int* __restrict__ pos,
                           float* __restrict__ out, int H, int bt, int m,
                           float scale) {
  constexpr int EPL = D >= 32 ? D / 32 : 1;  // elements per thread
  constexpr int CH = EPL >= 4 ? 8 : 16;      // tokens read together
  const int s = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.y * kWarpsPerCta + warp;
  if (h >= H) return;  // the whole warp leaves together
  const int d0 = lane * EPL;
  const bool owns = d0 < D;  // false only for D < 32
  const int n_tok = pos[s] + 1;
  const int* __restrict__ table = tables + static_cast<size_t>(s) * m;
  const size_t tok_stride = static_cast<size_t>(H) * D;
  const size_t blk_stride = static_cast<size_t>(bt) * tok_stride;
  const size_t head_off = static_cast<size_t>(h) * D + d0;

  float qr[EPL];
  if (owns) {
    load_row<TQ, EPL>(q + (static_cast<size_t>(s) * H + h) * D + d0, qr);
  } else {
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) qr[e] *= scale;

  float m_run = -INFINITY;
  float l_run = 0.f;
  float acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;

  const int last_blk = (n_tok - 1) / bt;
  int b_next = table[0];
  for (int j = 0; j <= last_blk; ++j) {
    const int b = b_next;
    if (j < last_blk) b_next = table[j + 1];  // in flight during block j
    const int n_in = min(bt, n_tok - j * bt);
    const TKV* __restrict__ kb = ck + b * blk_stride + head_off;
    const TKV* __restrict__ vb = cv + b * blk_stride + head_off;
    for (int c0 = 0; c0 < n_in; c0 += CH) {
      // start the chunk's K and V row reads together: one memory round
      // trip per chunk instead of one per token
      float kr[CH][EPL], vr[CH][EPL];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (owns && c0 + c < n_in) {
          load_row<TKV, EPL>(kb + (c0 + c) * tok_stride, kr[c]);
          load_row<TKV, EPL>(vb + (c0 + c) * tok_stride, vr[c]);
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) kr[c][e] = vr[c][e] = 0.f;
        }
      }
      float sc[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[e], kr[c][e], dot);
        sc[c] = dot;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int c = 0; c < CH; ++c)
          sc[c] += __shfl_xor_sync(0xffffffffu, sc[c], off);
      }
      float c_max = -INFINITY;
#pragma unroll
      for (int c = 0; c < CH; ++c)
        if (c0 + c < n_in) c_max = fmaxf(c_max, sc[c]);
      // c0 < n_in, so c_max and m_new are finite; the first chunk's
      // correction is exp(-inf) = 0
      const float m_new = fmaxf(m_run, c_max);
      const float corr = expf(m_run - m_new);
      l_run *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] *= corr;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (c0 + c < n_in) {
          const float pr = expf(sc[c] - m_new);
          l_run += pr;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[e] = fmaf(pr, vr[c][e], acc[e]);
        }
      }
      m_run = m_new;
    }
  }
  if (owns) {
    float* o = out + (static_cast<size_t>(s) * H + h) * D + d0;
    const float inv = 1.f / l_run;
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] = acc[e] * inv;
  }
}

template <typename TQ, typename TKV, int D>
void launch(const void* q, const void* ck, const void* cv, const void* tables,
            const void* pos, void* out, int S, int H, int bt, int m,
            cudaStream_t stream) {
  const dim3 grid(S, (H + kWarpsPerCta - 1) / kWarpsPerCta);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  paged_attention_kernel<TQ, TKV, D><<<grid, kWarpsPerCta * 32, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(ck),
      static_cast<const TKV*>(cv), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<float*>(out), H, bt, m, scale);
}

template <typename TQ, typename TKV>
cudaError_t launch_d(int D, const void* q, const void* ck, const void* cv,
                     const void* tables, const void* pos, void* out, int S,
                     int H, int bt, int m, cudaStream_t stream) {
  switch (D) {
    case 16: launch<TQ, TKV, 16>(q, ck, cv, tables, pos, out, S, H, bt, m, stream); break;
    case 32: launch<TQ, TKV, 32>(q, ck, cv, tables, pos, out, S, H, bt, m, stream); break;
    case 64: launch<TQ, TKV, 64>(q, ck, cv, tables, pos, out, S, H, bt, m, stream); break;
    case 128: launch<TQ, TKV, 128>(q, ck, cv, tables, pos, out, S, H, bt, m, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns the CUDA error of the
// launch (0 = success); an unsupported head size or dtype returns
// cudaErrorInvalidValue without launching.
extern "C" int paged_attention_fwd(const void* q, const void* ck,
                                   const void* cv, const void* tables,
                                   const void* pos, void* out, int S, int H,
                                   int D, int bt, int m, int q_dtype,
                                   int kv_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) {
    err = launch_d<float, float>(D, q, ck, cv, tables, pos, out, S, H, bt, m, st);
  } else if (q_dtype == 1 && kv_dtype == 1) {
    err = launch_d<__nv_bfloat16, __nv_bfloat16>(D, q, ck, cv, tables, pos, out, S, H, bt, m, st);
  } else if (q_dtype == 0 && kv_dtype == 1) {
    err = launch_d<float, __nv_bfloat16>(D, q, ck, cv, tables, pos, out, S, H, bt, m, st);
  } else if (q_dtype == 1 && kv_dtype == 0) {
    err = launch_d<__nv_bfloat16, float>(D, q, ck, cv, tables, pos, out, S, H, bt, m, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
