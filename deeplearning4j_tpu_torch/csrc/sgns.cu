// One skip-gram negative-sampling minibatch update, in place, written by
// hand for Hopper (sm_90a). Plain C interface, loaded with ctypes by
// deeplearning4j_tpu_torch/ops/sgns.py.
//
// Replaces: deeplearning4j_tpu/ops/pallas_sgns.py, sgns_fused_step (kernel
// body _sgns_kernel); the function is nlp/word2vec.py _neg_body.
//
// Function: syn0, syn1neg [V,D] f32; ctx [B] and tgt [B,K1] int64 rows;
// labels, live [B,K1] f32; alpha (a device scalar, or a value). Every read
// is at the stale values:
//   l1 = syn0[ctx[b]], s_k = syn1neg[tgt[b,k]], dot_k = l1 . s_k,
//   g_k = alpha * live_k * (dot_k > 6 ? lbl_k - 1
//                           : dot_k < -6 ? lbl_k : lbl_k - sigmoid(dot_k)),
//   neu1e = sum_k g_k s_k;
// then syn1neg[tgt[b,k]] += g_k * live_k / sqrt(max(n_t, 1)) * l1 and
// syn0[ctx[b]] += neu1e / sqrt(max(n_c, 1)) where the pair has a live
// entry, n_t (n_c) summing live (pairs with a live entry) over the batch's
// hits of that row.
//
// What bounds it on the H100: memory. Each distinct row that a live pair
// touches is read once and written once, 4*2*D*(distinct syn0 rows +
// distinct syn1neg rows) bytes plus the indices, labels and liveness, for
// ~6*B*K1*D flops. With no row repeated that is 4*(2*B*D + 2*B*K1*D)
// bytes (14.7 MB at B=2048, K1=6, D=128: 4.4 us at 3.35 TB/s); a batch of
// Zipf-distributed words repeats rows and needs fewer. At that size a
// launch's own latency is of the same order or larger.
//
// What the design does about it:
//  * one warp per pair, D across the lanes (lane l holds d = l + 32 e), so
//    every row is one coalesced read or a run of coalesced atomics; the dot
//    is a warp-shuffle reduction. D up to 512 (16 elements per lane).
//  * three launches on the caller's stream stand in for the TPU kernel's
//    two sequential loops. (1) gather: dots, coefficients g and neu1e at
//    the stale values, parked in scratch, with the live hits of each row
//    counted by float atomics into two [V] count buffers. (2) scatter: each
//    contribution, scaled by the counts, is added with float atomics into
//    a [V,D] delta buffer per table, not into the table, so a row's sum
//    starts from zero and rounds at the size of the update, not of the
//    row (adding ~190 hits straight onto a row of entries ~0.1 drifts
//    past the 1e-5-of-the-update bar in f32). (3) apply: one warp per
//    index; the first to take a row's count (atomicExch to 0) adds the
//    row's delta to the table once and zeroes it. So the count and delta buffers are zero
//    between calls and never swept, and no table is written before every
//    read of (1) and (2) is done, as _neg_body reads everything first.
//    The atomics' order varies, so two launches agree to rounding, not to
//    the bit.
//  * an entry with live 0, or a coefficient of 0, adds nothing, and a row
//    no live pair touches is never taken in (3): it keeps its bits.
//  * an index outside [0, V) traps (as PyTorch's device-side index checks
//    do): the launch fails instead of writing outside the tables.
// Not done yet (later work): one launch with a grid barrier, vector
// atomics (red.global.add.v4.f32), the K1 rows of a pair loaded together.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps (pairs or indices) per CTA
constexpr float kMaxExp = 6.0f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long checked_row(long long r, int V) {
  if (r < 0 || r >= V) __trap();
  return r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int EPL>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         int lane, int D, float (&out)[EPL]) {
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int d = lane + 32 * e;
    out[e] = d < D ? row[d] : 0.f;
  }
}

// (1) stale gathers, dots, g, neu1e; live hits counted per row
template <int EPL>
__global__ void __launch_bounds__(kWarps * 32)
sgns_gather_kernel(const float* __restrict__ syn0,
                   const float* __restrict__ syn1neg,
                   const long long* __restrict__ ctx,
                   const long long* __restrict__ tgt,
                   const float* __restrict__ labels,
                   const float* __restrict__ live,
                   const float* __restrict__ alpha_ptr, float alpha_val,
                   float* __restrict__ gbuf, float* __restrict__ neubuf,
                   float* __restrict__ tcount, float* __restrict__ ccount,
                   int B, int K1, int D, int V) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const float alpha = alpha_ptr != nullptr ? *alpha_ptr : alpha_val;
  const long long c = checked_row(ctx[b], V);
  float l1[EPL], neu[EPL];
  load_row<EPL>(syn0 + c * D, lane, D, l1);
#pragma unroll
  for (int e = 0; e < EPL; ++e) neu[e] = 0.f;
  bool any_live = false;
  for (int k = 0; k < K1; ++k) {
    const long long i = static_cast<long long>(b) * K1 + k;
    const long long t = checked_row(tgt[i], V);
    const float lv = live[i];
    const float lbl = labels[i];
    float s[EPL];
    load_row<EPL>(syn1neg + t * D, lane, D, s);
    float p = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) p = fmaf(l1[e], s[e], p);
    const float dot = warp_sum(p);
    const float f = 1.f / (1.f + expf(-dot));
    const float base =
        dot > kMaxExp ? lbl - 1.f : (dot < -kMaxExp ? lbl : lbl - f);
    const float g = base * alpha * lv;
#pragma unroll
    for (int e = 0; e < EPL; ++e) neu[e] = fmaf(g, s[e], neu[e]);
    if (lane == 0) {
      gbuf[i] = g;
      if (lv != 0.f) atomicAdd(tcount + t, lv);
    }
    any_live |= lv > 0.f;
  }
  float* nuo = neubuf + static_cast<long long>(b) * D;
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int d = lane + 32 * e;
    if (d < D) nuo[d] = neu[e];
  }
  if (lane == 0 && any_live) atomicAdd(ccount + c, 1.f);
}

// (2) scaled contributions into the delta buffers (tables still stale)
template <int EPL>
__global__ void __launch_bounds__(kWarps * 32)
sgns_scatter_kernel(const float* __restrict__ syn0,
                    const long long* __restrict__ ctx,
                    const long long* __restrict__ tgt,
                    const float* __restrict__ live,
                    const float* __restrict__ gbuf,
                    const float* __restrict__ neubuf,
                    const float* __restrict__ tcount,
                    const float* __restrict__ ccount,
                    float* __restrict__ delta0, float* __restrict__ delta1,
                    int B, int K1, int D) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const long long c = ctx[b];
  float l1[EPL];
  load_row<EPL>(syn0 + c * D, lane, D, l1);
  bool any_live = false;
  for (int k = 0; k < K1; ++k) {
    const long long i = static_cast<long long>(b) * K1 + k;
    const float lv = live[i];
    any_live |= lv > 0.f;
    if (lv == 0.f) continue;
    const long long t = tgt[i];
    const float coef = gbuf[i] * (lv / sqrtf(fmaxf(tcount[t], 1.f)));
    if (coef == 0.f) continue;
    float* r1 = delta1 + t * D;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) atomicAdd(r1 + d, coef * l1[e]);
    }
  }
  if (!any_live) return;
  const float cs = 1.f / sqrtf(fmaxf(ccount[c], 1.f));
  const float* nui = neubuf + static_cast<long long>(b) * D;
  float* r0 = delta0 + c * D;
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int d = lane + 32 * e;
    if (d < D) atomicAdd(r0 + d, cs * nui[d]);
  }
}

// (3) one warp per index (B*K1 targets, then B contexts): the first warp
// to take a row's count adds the row's delta to the table and zeroes both
template <int EPL>
__global__ void __launch_bounds__(kWarps * 32)
sgns_apply_kernel(float* __restrict__ syn0, float* __restrict__ syn1neg,
                  const long long* __restrict__ ctx,
                  const long long* __restrict__ tgt,
                  float* __restrict__ delta0, float* __restrict__ delta1,
                  float* __restrict__ tcount, float* __restrict__ ccount,
                  int B, int K1, int D) {
  const int lane = threadIdx.x & 31;
  const long long w =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long n1 = static_cast<long long>(B) * K1;
  if (w >= n1 + B) return;
  const bool is_tgt = w < n1;
  const long long r = is_tgt ? tgt[w] : ctx[w - n1];
  float* count = is_tgt ? tcount : ccount;
  float taken = 0.f;
  if (lane == 0) taken = atomicExch(count + r, 0.f);
  taken = __shfl_sync(kFull, taken, 0);
  if (taken == 0.f) return;
  float* row = (is_tgt ? syn1neg : syn0) + r * D;
  float* delta = (is_tgt ? delta1 : delta0) + r * D;
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int d = lane + 32 * e;
    if (d < D) {
      row[d] += delta[d];
      delta[d] = 0.f;
    }
  }
}

struct Args {
  float* syn0;
  float* syn1neg;
  const long long* ctx;
  const long long* tgt;
  const float* labels;
  const float* live;
  const float* alpha_ptr;
  float alpha_val;
  float* gbuf;
  float* neubuf;
  float* tcount;
  float* ccount;
  float* delta0;
  float* delta1;
  int B, K1, D, V;
};

template <int EPL>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const dim3 block(kWarps * 32);
  const dim3 grid((a.B + kWarps - 1) / kWarps);
  sgns_gather_kernel<EPL><<<grid, block, 0, st>>>(
      a.syn0, a.syn1neg, a.ctx, a.tgt, a.labels, a.live, a.alpha_ptr,
      a.alpha_val, a.gbuf, a.neubuf, a.tcount, a.ccount, a.B, a.K1, a.D,
      a.V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sgns_scatter_kernel<EPL><<<grid, block, 0, st>>>(
      a.syn0, a.ctx, a.tgt, a.live, a.gbuf, a.neubuf, a.tcount, a.ccount,
      a.delta0, a.delta1, a.B, a.K1, a.D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(a.B) * (a.K1 + 1);
  sgns_apply_kernel<EPL><<<static_cast<unsigned>((n + kWarps - 1) / kWarps),
                           block, 0, st>>>(
      a.syn0, a.syn1neg, a.ctx, a.tgt, a.delta0, a.delta1, a.tcount,
      a.ccount, a.B, a.K1, a.D);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launches (0 = success); D outside 1..512
// returns cudaErrorInvalidValue without launching. alpha_ptr, when not
// null, is read on the device instead of alpha_val. gbuf [B,K1] and
// neubuf [B,D] are scratch; tcount, ccount [V] and delta0, delta1 [V,D]
// must be zero on entry and are zero again when the launches end. V is
// the tables' row count, against which every index is checked.
extern "C" int sgns_step(void* syn0, void* syn1neg, const void* ctx,
                         const void* tgt, const void* labels,
                         const void* live, const void* alpha_ptr,
                         float alpha_val, void* gbuf, void* neubuf,
                         void* tcount, void* ccount, void* delta0,
                         void* delta1, int B, int K1, int D, int V,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || K1 == 0) return 0;
  const Args a{static_cast<float*>(syn0), static_cast<float*>(syn1neg),
               static_cast<const long long*>(ctx),
               static_cast<const long long*>(tgt),
               static_cast<const float*>(labels),
               static_cast<const float*>(live),
               static_cast<const float*>(alpha_ptr), alpha_val,
               static_cast<float*>(gbuf), static_cast<float*>(neubuf),
               static_cast<float*>(tcount), static_cast<float*>(ccount),
               static_cast<float*>(delta0), static_cast<float*>(delta1),
               B, K1, D, V};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 0) {
    err = cudaErrorInvalidValue;
  } else if (D <= 32) {
    err = launch<1>(a, st);
  } else if (D <= 64) {
    err = launch<2>(a, st);
  } else if (D <= 128) {
    err = launch<4>(a, st);
  } else if (D <= 256) {
    err = launch<8>(a, st);
  } else if (D <= 512) {
    err = launch<16>(a, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
