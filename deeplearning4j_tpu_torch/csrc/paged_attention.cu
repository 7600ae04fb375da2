// Paged-decode attention over a block arena (K6), written by hand for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// deeplearning4j_tpu_torch/ops/paged_attention.py.
//
// Replaces: deeplearning4j_tpu/ops/pallas_paged.py, paged_attention
// (kernel body _paged_kernel).
//
// Function: one query per lane. q [S,H,D]; one layer's arena view
// ck/cv [NB+1, bt, H, D] (physical block 0 is trash); tables [S,m] int32
// maps a lane's logical block j to a physical block; pos [S] int32. Token
// t < m*bt of lane s is visible iff t <= pos[s]. out [S,H,D] f32 =
// softmax(q.k / sqrt(D)) v over the visible tokens.
//
// What bounds it on the H100: memory. Each visible token's K and V row is
// read once (2*H*D*sizeof(kv) bytes) and used for 4*D flops per head, far
// below the ~295 flops/byte where the card stops being memory-bound. So
// the whole card has to keep bytes in flight until the last lane is done.
//
// What the design does about it (split-context "flash decoding"):
//  * the context is cut into splits of kSplitTokens tokens (whole blocks:
//    split_blocks = 256 / bt), a third grid axis sized from the table
//    width m, which the host knows: grid (lane, split, group of 4 heads).
//    A lane at the full 1024-token window is 4 splits of CTAs working at
//    once instead of one warp walking 1024 tokens while the card idles.
//    pos is read on the card only (no host sync): a CTA whose split lies
//    past its lane's pos writes an empty partial (m = -inf, l = 0) and
//    reads no K/V.
//  * wide loads: each thread reads 16 bytes of a row (8 bf16 or 4 f32);
//    D*sizeof(kv)/16 threads cover one row, so a warp reads several
//    tokens' rows of its head per load instruction, and issues up to
//    kRounds such loads of K and of V before it uses any (all addresses
//    come from the split's table entries, staged in shared memory once).
//    Each group of threads owning one token keeps its own online softmax
//    (max, sum, accumulator in f32 registers); the groups of a warp merge
//    by shuffles at the end of the split.
//  * a second small kernel merges a lane's partials in split order: the
//    same bits on every launch (no atomics). With one split (m*bt <= 256)
//    the first kernel writes the output itself and the second is not
//    launched.
//  * only visible tokens are read: the trash block is never read by an
//    active lane, so its content cannot reach an active lane's output,
//    not even through a zero weight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kWarps = 4;            // one warp per head, 4 heads per CTA
constexpr int kSplitTokens = 256;    // tokens per split (whole blocks)
constexpr int kMaxSplitBlocks = 256; // table entries a split stages
constexpr int kRounds = 8;           // row loads of K (and V) in flight
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU, subnormal results flushed to 0 (2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of a K or V row as 16 / sizeof(T) floats
template <typename T>
__device__ __forceinline__ void unpack(const uint4& w,
                                       float (&out)[16 / sizeof(T)]) {
  if constexpr (std::is_same<T, float>::value) {
    out[0] = __uint_as_float(w.x);
    out[1] = __uint_as_float(w.y);
    out[2] = __uint_as_float(w.z);
    out[3] = __uint_as_float(w.w);
  } else {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[e]));
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  }
}

// Grid (lane s, split, group of kWarps heads); warp w owns head
// kWarps * blockIdx.z + w. Tokens [t0, t1) of the lane: a warp reads
// them in rounds of G tokens, thread group `sub` (TPR threads, EPT
// elements each) owning token t0 + r*G + sub of round r.
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kWarps * 32)
    paged_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ ck,
                       const TKV* __restrict__ cv,
                       const int* __restrict__ tables,
                       const int* __restrict__ pos, float* __restrict__ out,
                       float* __restrict__ pm, float* __restrict__ pl,
                       float* __restrict__ po, int H, int bt, int m,
                       int split_blocks, float scale_log2) {
  constexpr int EPT = 16 / sizeof(TKV);  // elements a thread reads per row
  constexpr int TPR = D / EPT;           // threads per row
  constexpr int G = 32 / TPR;            // tokens per round of a warp
  static_assert(TPR >= 1 && TPR <= 32 && D % EPT == 0, "head size");
  __shared__ int tab[kMaxSplitBlocks];

  const int s = blockIdx.x;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.z * kWarps + warp;
  const int sub = lane / TPR;
  const int e0 = (lane % TPR) * EPT;

  const int n_tok = min(pos[s] + 1, m * bt);  // visible tokens of the lane
  const int j0 = split * split_blocks;         // first table slot
  const int t0 = j0 * bt;
  const int t1 = min(n_tok, min(m, j0 + split_blocks) * bt);
  const size_t part = (static_cast<size_t>(s) * n_split + split) * H + h;

  if (t0 >= t1) {  // the split lies past pos: an empty partial, no K/V
    if (h >= H) return;
    if (n_split == 1) {  // no visible token at all (pos < 0): 0 / 0
      for (int e = lane; e < D; e += 32)
        out[(static_cast<size_t>(s) * H + h) * D + e] = NAN;
      return;
    }
    if (lane == 0) {
      pm[part] = -INFINITY;
      pl[part] = 0.f;
    }
    for (int e = lane; e < D; e += 32) po[part * D + e] = 0.f;
    return;
  }
  const int n_blk = (t1 - 1) / bt - j0 + 1;
  for (int i = threadIdx.x; i < n_blk; i += kWarps * 32)
    tab[i] = tables[static_cast<size_t>(s) * m + j0 + i];
  __syncthreads();
  if (h >= H) return;  // the whole warp leaves together

  const size_t tok_stride = static_cast<size_t>(H) * D;
  const TKV* __restrict__ kh = ck + static_cast<size_t>(h) * D + e0;
  const TKV* __restrict__ vh = cv + static_cast<size_t>(h) * D + e0;

  float qr[EPT];
  const TQ* qp = q + (static_cast<size_t>(s) * H + h) * D + e0;
#pragma unroll
  for (int e = 0; e < EPT; ++e) qr[e] = to_f32(qp[e]) * scale_log2;

  float m_run = -INFINITY;  // log2 units
  float l_run = 0.f;
  float acc[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) acc[e] = 0.f;

  for (int tb = t0; tb < t1; tb += kRounds * G) {
    // every round's K and V row reads first: kRounds round trips in one
    uint4 kr[kRounds], vr[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int t = tb + r * G + sub;
      if (t < t1) {
        const int blk = tab[t / bt - j0];
        const size_t row = (static_cast<size_t>(blk) * bt + t % bt) *
                           tok_stride;
        kr[r] = __ldg(reinterpret_cast<const uint4*>(kh + row));
        vr[r] = __ldg(reinterpret_cast<const uint4*>(vh + row));
      } else {
        kr[r] = vr[r] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float sc[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      float kf[EPT];
      unpack<TKV>(kr[r], kf);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EPT; ++e) dot = fmaf(qr[e], kf[e], dot);
      sc[r] = dot;
    }
    // sum each token's dot over its TPR threads
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < kRounds; ++r)
        sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], off);
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (tb + r * G + sub >= t1) sc[r] = -INFINITY;
      mx = fmaxf(mx, sc[r]);
    }
    // a group that has seen no token yet keeps m = -inf: keep the exp2
    // arguments free of -inf - -inf
    const float m_new = fmaxf(m_run, mx);
    const float mu = m_new == -INFINITY ? 0.f : m_new;
    const float corr = ex2(m_run - mu);
    l_run *= corr;
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[e] *= corr;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const float p = ex2(sc[r] - mu);  // 0 past t1
      float vf[EPT];
      unpack<TKV>(vr[r], vf);
      l_run += p;
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
    }
    m_run = m_new;
  }

  // merge the warp's G token groups (lanes e apart by multiples of TPR
  // hold the same elements)
#pragma unroll
  for (int off = TPR; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m_run, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l_run, off);
    const float m_new = fmaxf(m_run, mo);
    const float mu = m_new == -INFINITY ? 0.f : m_new;
    const float a = ex2(m_run - mu);
    const float b = ex2(mo - mu);
    l_run = l_run * a + lo * b;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const float ao = __shfl_xor_sync(0xffffffffu, acc[e], off);
      acc[e] = acc[e] * a + ao * b;
    }
    m_run = m_new;
  }
  if (sub != 0) return;
  if (n_split == 1) {
    float* o = out + (static_cast<size_t>(s) * H + h) * D + e0;
    const float inv = 1.f / l_run;
#pragma unroll
    for (int e = 0; e < EPT; ++e) o[e] = acc[e] * inv;
    return;
  }
  float* o = po + part * D + e0;
#pragma unroll
  for (int e = 0; e < EPT; ++e) o[e] = acc[e];
  if (lane == 0) {
    pm[part] = m_run;
    pl[part] = l_run;
  }
}

// Grid (lane s, group of kWarps heads): warp w merges head h's partials
// in split order; lane i owns elements i, i + 32, ... of the row.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    paged_combine_kernel(const float* __restrict__ pm,
                         const float* __restrict__ pl,
                         const float* __restrict__ po,
                         float* __restrict__ out, int H, int n_split) {
  constexpr int EPL = D >= 32 ? D / 32 : 1;
  const int s = blockIdx.x;
  const int h = blockIdx.y * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (h >= H) return;
  const size_t base = static_cast<size_t>(s) * n_split * H + h;
  float mx = -INFINITY;
  for (int i = 0; i < n_split; ++i) mx = fmaxf(mx, pm[base + i * H]);
  const float mu = mx == -INFINITY ? 0.f : mx;
  float l = 0.f;
  float acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const size_t p = base + i * H;
    const float mi = pm[p];
    if (mi == -INFINITY) continue;  // an empty split
    const float w = ex2(mi - mu);
    l += w * pl[p];
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) acc[e] = fmaf(w, po[p * D + d], acc[e]);
    }
  }
  const float inv = 1.f / l;
  float* o = out + (static_cast<size_t>(s) * H + h) * D;
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int d = lane + 32 * e;
    if (d < D) o[d] = acc[e] * inv;
  }
}

struct Args {
  const void* q;
  const void* ck;
  const void* cv;
  const int* tables;
  const int* pos;
  float* out;
  float* pm;
  float* pl;
  float* po;
  int S, H, bt, m, split_blocks, n_split;
};

template <typename TQ, typename TKV, int D>
void launch(const Args& a, cudaStream_t stream) {
  const int hg = (a.H + kWarps - 1) / kWarps;
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  paged_split_kernel<TQ, TKV, D>
      <<<dim3(a.S, a.n_split, hg), kWarps * 32, 0, stream>>>(
          static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.ck),
          static_cast<const TKV*>(a.cv), a.tables, a.pos, a.out, a.pm, a.pl,
          a.po, a.H, a.bt, a.m, a.split_blocks, scale_log2);
  if (a.n_split > 1)
    paged_combine_kernel<D><<<dim3(a.S, hg), kWarps * 32, 0, stream>>>(
        a.pm, a.pl, a.po, a.out, a.H, a.n_split);
}

template <typename TQ, typename TKV>
cudaError_t launch_d(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 16: launch<TQ, TKV, 16>(a, stream); break;
    case 32: launch<TQ, TKV, 32>(a, stream); break;
    case 64: launch<TQ, TKV, 64>(a, stream); break;
    case 128: launch<TQ, TKV, 128>(a, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. ck and cv must be 16-byte
// aligned. split_blocks: table slots per split (1 .. 256); the grid has
// ceil(m / split_blocks) splits. With more than one split, pm and pl
// ([S, n_split, H] f32) and po ([S, n_split, H, D] f32) are the
// partials' workspace, allocated by the caller; with one they are not
// read and may be null. Returns the CUDA error of the launches (0 =
// success); an unsupported head size, dtype or split returns
// cudaErrorInvalidValue without launching.
extern "C" int paged_attention_fwd(const void* q, const void* ck,
                                   const void* cv, const void* tables,
                                   const void* pos, void* out, void* pm,
                                   void* pl, void* po, int S, int H, int D,
                                   int bt, int m, int split_blocks,
                                   int q_dtype, int kv_dtype, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S == 0 || H == 0) return 0;
  if (m < 1 || bt < 1 || split_blocks < 1 ||
      split_blocks > kMaxSplitBlocks ||
      (reinterpret_cast<uintptr_t>(ck) & 15) ||
      (reinterpret_cast<uintptr_t>(cv) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_split = (m + split_blocks - 1) / split_blocks;
  if (n_split > 1 && (pm == nullptr || pl == nullptr || po == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, ck, cv, static_cast<const int*>(tables),
               static_cast<const int*>(pos), static_cast<float*>(out),
               static_cast<float*>(pm), static_cast<float*>(pl),
               static_cast<float*>(po), S, H, bt, m, split_blocks, n_split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) {
    err = launch_d<float, float>(D, a, st);
  } else if (q_dtype == 1 && kv_dtype == 1) {
    err = launch_d<__nv_bfloat16, __nv_bfloat16>(D, a, st);
  } else if (q_dtype == 0 && kv_dtype == 1) {
    err = launch_d<float, __nv_bfloat16>(D, a, st);
  } else if (q_dtype == 1 && kv_dtype == 0) {
    err = launch_d<__nv_bfloat16, float>(D, a, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
