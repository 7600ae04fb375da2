// Flash-attention forward of K4 (csrc/flash_attention.cu) and K5
// (csrc/flash_attention_ext.cu), written by hand for Hopper (sm_90a).
// Included by K5's launcher only; K4's entry point calls K5's with no key
// bias and offset 0 (causal) or T (full), in the same library, so the two
// give the same bits on the same inputs.
//
// Replaces: deeplearning4j_tpu/ops/pallas_attention.py, _flash_raw (:117,
// kernel body _flash_kernel :59) and _flash_ext_raw (:289, kernel body
// _flash_ext_kernel :238).
//
// Function: q [N,Tq,H,D], k, v [N,Tk,H,D] read in place through their
// strides (the D axis contiguous), an optional additive key bias kb
// [N,Tk] f32 shared by the heads (0 keeps a key, -inf masks it) and a host
// integer off in [-Tq, Tk]: key ki is visible to query qi iff qi + off >=
// ki, and, with a window win > 0, qi + off - ki < win (a sliding window:
// each row sees its last win keys). Scores q.k / sqrt(D) + kb, online
// softmax in f32. Outputs O [N,Tq,H,D] in q's dtype and lse [N,H,Tq]
// f32. A row with no visible key gives O = 0 and lse = -inf exactly (the
// ring combiner weighs a block by exp(lse - max lse), so -inf must weigh
// nothing). Ragged Tq and Tk are masked here.
//
// What bounds it on the H100: at the ring's local shape (T=4096, H=8,
// D=64, causal) and the masked layer's (T=2048) the products, ~1000 flops
// per byte of q/k/v/o against the ~295 at which bf16 tensor cores stop
// waiting on memory, so flops at 989 TFLOP/s; at the serving prefill
// widths (T <= 1024) the bytes at 3.35 TB/s. Past the products, each
// score costs an exp2 on the SFU (16 per clock per SM against 4096 bf16
// tensor-core flops), so the softmax is as long as the two products. In
// f32 (the MHA layer's fit) the products at f32 accuracy: three TF32
// products each, 495 / 3 = 165 TFLOP/s.
//
// What the design does about it (tc:: below, one template for both
// types):
//  * tensor cores. bf16: S = Q.K^T and O += P.V are wgmma.mma_async
//    m64nNk16 (bf16 in, f32 accumulate); P is fed as the A operand of the
//    second product straight from the first product's accumulator
//    fragments, as a bf16 high part and the bf16 rounding of the rest
//    (two products: one bf16 P would carry 2^-9 relative error into O;
//    FLASH_P_SPLIT=0 builds the one-P variant). f32: 3xTF32 on
//    mma.sync m16n8k8 (every operand split in registers into a TF32 high
//    part and the TF32 rounding of the rest, three products summed in
//    f32: f32-accurate, while TF32 alone stays off in the port). mma.sync
//    takes both operands from registers, so V is read in place ([keys][D])
//    and P is the score fragment as it stands, its keys permuted inside
//    each slice of 8 (A column t is key 2t, column t + 4 key 2t + 1) and
//    V's B fragment read in the same order; wgmma's TF32 form reads B
//    K-major from shared memory only, so it would need V transposed there
//    beside the split halves (224 KB at D = 64 with two warpgroups in the
//    layout worked out for it, more than fits at D = 128). Scores
//    never reach shared memory; m, l and O stay in f32 registers. A CTA
//    holds one or two consumer warpgroups of 64 q rows each (128 rows
//    where Tq > 64); Q stays in shared memory for the whole sweep.
//  * asynchronous copies: 64-key K and V tiles arrive by cp.async.cg
//    16-byte copies (zero-filled past Tk) in a 2-stage ring: tile j+1 is
//    in flight while tile j is multiplied, with one barrier per tile.
//    bf16 tiles use the 128/64/32-byte swizzle that matches a row of D
//    bf16 (bank-conflict free for the copies and for wgmma); f32 tiles
//    pad each row to D + 4 floats (conflict free for the fragment reads).
//    A tensor whose base or strides are not 16-byte aligned is copied with
//    plain loads into the same ring instead (never refused).
//  * masking only where needed: tiles wholly visible to every row of a
//    warpgroup with no key bias skip the per-element test; only the
//    diagonal tile, the ragged end and biased tiles apply it. A key tile
//    the bias masks whole (a length mask's tail) is not multiplied. Each q tile
//    stops at its last visible key tile, a warpgroup skips the tiles none
//    of its rows can see, and a q tile with no visible key writes O = 0,
//    lse = -inf without loading K or V. q tiles are launched latest
//    (heaviest under a causal offset) first.
//  * a window is a template parameter: a launch with none compiles to the
//    code above, with no window test anywhere. With one, a q tile starts
//    at the first key tile its first row's window reaches, and only the
//    tiles the window cuts for some row of a warpgroup test each element,
//    so a sliding layer multiplies about T * (win + 64) pairs a head, not
//    T^2 / 2.
//  * the softmax works in log2 units (scores scaled by log2(e) / sqrt(D),
//    exp2), keeps per-thread partial row sums and reduces them once at
//    the end.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_tc.cuh"

// 1: P.V from P's bf16 high part and the bf16 rounding of the rest (two
// products per k-slice); 0: from one bf16 P (a variant build, timed
// against the split by chip_smoke.py)
#ifndef FLASH_P_SPLIT
#define FLASH_P_SPLIT 1
#endif

// internal linkage, as in flash_tc.cuh: the FLASH_P_SPLIT=0 variant
// library keeps its own kernels and once-per-device flags
namespace flash {
namespace {

struct Strides {
  long long n, t, h;  // element strides; the D axis is contiguous
};

// One launch. kb is a contiguous [N,Tk] f32 bias or null, o a contiguous
// [N,Tq,H,D] buffer of q's dtype, lse a contiguous [N,H,Tq] f32 one.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* kb;
  void* o;
  float* lse;
  int N, Tq, Tk, H, off;
  int win;  // 0: no window; else keys with qi + off - ki >= win are hidden
  Strides sq, sk, sv;
};

namespace tc {

constexpr int kBlockK = 64;  // keys per tile

template <typename T, int D>
constexpr uint32_t tile_bytes(int rows) {
  return std::is_same<T, float>::value ? TileF<D>::bytes(rows)
                                       : Tile<D>::bytes(rows);
}

// shared memory: Q [BQ rows], then kStages K tiles, then kStages V tiles:
// a ring with the next key tile in flight while one is multiplied (a
// deeper ring timed no faster on an H100). f32 at D = 128 with two
// warpgroups: 198 KB of the 227.
template <typename T, int D, int NWG>
struct Smem {
  static constexpr int kStages = 2;
  static constexpr int kBlockQ = 64 * NWG;
  static constexpr uint32_t kTile = tile_bytes<T, D>(kBlockK);
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = tile_bytes<T, D>(kBlockQ);
  static constexpr uint32_t kV = kK + kStages * kTile;
  static constexpr uint32_t kBytes = kV + kStages * kTile;
};

// One q tile of 64 * NWG rows of head (n, h): NWG consumer warpgroups of
// 64 rows each share the K/V ring. aligned: bit 0/1/2 when q/k/v may be
// copied 16 bytes at a time. T is the element type (bf16: wgmma; f32:
// 3xTF32 mma.sync); masking, the softmax and the ring are shared. WIN:
// p.win > 0 (a sliding window), else p.win is never read.
template <typename T, int D, int NWG, bool WIN>
__device__ __forceinline__ void attend(const Params& p, const int n,
                                       const int h, const int q0,
                                       const int aligned,
                                       const float scale_log2, uint8_t* gsm,
                                       const uint32_t ssm) {
  constexpr bool F32 = std::is_same<T, float>::value;
  using SM = Smem<T, D, NWG>;
  constexpr int S = SM::kStages;
  constexpr int BQ = SM::kBlockQ;
  constexpr int NT = NWG * 128;
  constexpr int RB = Tile<D>::kRowBytes;
  constexpr int NS = kBlockK / 2;   // score accumulators per thread
  constexpr int NO = D / 2;         // output accumulators per thread
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int t4 = lane & 3;

  // keys this q tile can see: ki <= q_last + off (off in [-Tq, Tk])
  const int q_last = min(q0 + BQ, p.Tq) - 1;
  const int k_end = min(p.Tk, q_last + p.off + 1);   // exclusive; may be <= 0
  const int n_kt = k_end > 0 ? (k_end + kBlockK - 1) / kBlockK : 0;
  // the first key tile the window of the tile's first row reaches
  const int kt0 = WIN ? max(0, q0 + p.off - p.win + 1) / kBlockK : 0;
  // this warpgroup's rows and the keys they can see
  const int q0w = q0 + 64 * wg;
  const int k_end_w =
      q0w < p.Tq ? min(p.Tk, min(q0w + 63, p.Tq - 1) + p.off + 1) : 0;
  // keys before k_beg_w are outside every row's window of the warpgroup;
  // from k_open_w on, inside every row's
  const int k_beg_w = WIN ? q0w + p.off - p.win + 1 : 0;
  const int k_open_w = WIN ? q0w + 64 + p.off - p.win : 0;
  const int row0 = q0w + warp * 16 + (lane >> 2);    // rows row0, row0 + 8

  const T* qb = static_cast<const T*>(p.q) + n * p.sq.n + h * p.sq.h;
  const T* kbase = static_cast<const T*>(p.k) + n * p.sk.n + h * p.sk.h;
  const T* vbase = static_cast<const T*>(p.v) + n * p.sv.n + h * p.sv.h;
  const float* bias = p.kb ? p.kb + static_cast<long long>(n) * p.Tk : nullptr;

  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  // K and V of key tile j into ring stage (j - kt0) % S (one commit group)
  auto load_kv = [&](int j) {
    const uint32_t st = (j - kt0) % S * SM::kTile;
    load_tile<D, kBlockK, NT>(gsm + SM::kK + st, ssm + SM::kK + st, kbase,
                              p.sk.t, j * kBlockK, p.Tk, aligned & 2, tid);
    load_tile<D, kBlockK, NT>(gsm + SM::kV + st, ssm + SM::kV + st, vbase,
                              p.sv.t, j * kBlockK, p.Tk, aligned & 4, tid);
  };
  if (n_kt > kt0) {
    load_tile<D, BQ, NT>(gsm + SM::kQ, ssm + SM::kQ, qb, p.sq.t, q0, p.Tq,
                         aligned & 1, tid);
#pragma unroll
    for (int j = 0; j < S - 1; ++j) {  // tiles kt0 .. kt0+S-2 in flight
      if (kt0 + j < n_kt) load_kv(kt0 + j);
      cp_async_commit();
    }
  }
  for (int kt = kt0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    const uint32_t stage = (kt - kt0) % S;
    // a key tile whose every key the bias masks adds nothing to any row
    // (every p is 0 and the rescale is by 2^0): its bias is read here,
    // under the barrier's wait, and the tile is skipped below (a length
    // mask leaves whole tiles masked)
    bool live = true;
    if (bias != nullptr) {
      const int ka = k0 + lane, kb = ka + 32;
      live = (ka < p.Tk && bias[ka] != -INFINITY) ||
             (kb < p.Tk && bias[kb] != -INFINITY);
    }
    // tile kt has landed for every thread (later ones may be in flight),
    // and every warpgroup is done with tile kt - 1, whose stage the next
    // copy reuses
    cp_async_wait<S - 2>();
    if constexpr (!F32) fence_proxy_async();
    __syncthreads();
    if (kt + S - 1 < n_kt) load_kv(kt + S - 1);
    cp_async_commit();
    if (k0 >= k_end_w) continue;  // no row of this warpgroup sees the tile
    if (WIN && k0 + kBlockK <= k_beg_w) continue;  // outside every window
    // every warp of the CTA reads the same keys, so the vote is the same
    // in the four warps of a warpgroup
    if (!__any_sync(0xffffffffu, live)) continue;

    // S = Q . K^T (64 rows x 64 keys per warpgroup)
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    if constexpr (F32) {
      const float* qw = reinterpret_cast<const float*>(gsm + SM::kQ) +
                        (64 * wg + 16 * warp) * TileF<D>::kLd;
      const float* ks = reinterpret_cast<const float*>(
          gsm + SM::kK + stage * SM::kTile);
      qk_3xtf32<D, kBlockK>(s, qw, ks, lane >> 2, t4);
    } else {
      const uint32_t ks = ssm + SM::kK + stage * SM::kTile;
      const uint32_t qs = ssm + SM::kQ + wg * 64 * RB;
      fence_regs<NS>(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t blk = kk * 32 / RB;  // column block of this k-slice
        const uint32_t in = kk * 32 % RB;
        Mma<kBlockK>::ss(s, desc(qs + blk * BQ * RB + in, 16, 8 * RB,
                                 Tile<D>::kLayout),
                         desc(ks + blk * kBlockK * RB + in, 16, 8 * RB,
                              Tile<D>::kLayout),
                         kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NS>(s);
    }

    // scores in log2 units; the per-element test only where some key of
    // the tile is hidden from some row of the warpgroup, or biased
    const bool open = bias == nullptr && k0 + kBlockK <= p.Tk &&
                      k0 + kBlockK - 1 <= q0w + p.off &&
                      (!WIN || k0 >= k_open_w);
    if (open) {
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] *= scale_log2;
    } else {
      float bb[NS / 2];  // the bias of this thread's 16 key columns
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kj = k0 + 8 * j + 2 * t4 + c;
          bb[2 * j + c] = bias && kj < p.Tk ? bias[kj] * kLog2e : 0.f;
        }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int kj = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int qi = row0 + 8 * ((i >> 1) & 1);
        s[i] = kj < p.Tk && qi + p.off >= kj &&
                       (!WIN || qi + p.off - kj < p.win)
                   ? fmaf(s[i], scale_log2, bb[2 * (i >> 2) + (i & 1)])
                   : -INFINITY;
      }
    }

    // online softmax on the fragments: a row lives in 4 lanes
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      mx[r] = fmaxf(mx[r], s[i]);
    }
    float mu[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row that has seen no visible key keeps m = -inf; keep the exp2
      // arguments free of -inf - -inf
      mu[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = ex2(m[r] - mu[r]);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = ex2(s[i] - mu[r]);
      rs[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];

    if constexpr (F32) {
      // O += P . V by 3xTF32, P split in registers
      const float* vs = reinterpret_cast<const float*>(
          gsm + SM::kV + stage * SM::kTile);
      pv_3xtf32<D, kBlockK>(o, s, vs, lane >> 2, t4);
    } else {
      // O += P . V with P in registers, in the A-fragment order (k-slice
      // kk holds score columns 16kk .. 16kk + 15). P is split into a bf16
      // high part and the bf16 rounding of the rest, two products per
      // slice: one bf16 P would carry 2^-9 relative error into O, a
      // rounding flip of O past the 2e-2 bar where |O| >= 4.
      const uint32_t vs = ssm + SM::kV + stage * SM::kTile;
      constexpr int NP = FLASH_P_SPLIT ? 2 : 1;  // parts of P
      uint32_t a[kBlockK / 16][NP][4];
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x0 = s[8 * kk + 2 * j], x1 = s[8 * kk + 2 * j + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          a[kk][0][j] = *reinterpret_cast<const uint32_t*>(&hi);
          if constexpr (NP == 2) {
            const float2 hf = __bfloat1622float2(hi);
            a[kk][NP - 1][j] = pack_bf16(x0 - hf.x, x1 - hf.y);
          }
        }
      fence_regs<NO>(o);
      fence_regs<kBlockK / 4 * NP>(&a[0][0][0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const uint64_t dv = desc(vs + kk * 16 * RB, kBlockK * RB, 8 * RB,
                                 Tile<D>::kLayout);
#pragma unroll
        for (int part = 0; part < NP; ++part)
          Mma<D>::rs_mn(o, a[kk][part], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NO>(o);
      fence_regs<kBlockK / 4 * NP>(&a[0][0][0]);
    }
  }

  // l = 0 exactly when no key was visible: O = 0, lse = -inf
  T* ob = static_cast<T*>(p.o);
  const long long ot = static_cast<long long>(p.H) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= p.Tq) continue;
    const float lr = l[r];
    const float inv = lr > 0.f ? 1.f / lr : 0.f;
    T* orow = ob + (static_cast<long long>(n) * p.Tq + qi) * ot +
              static_cast<long long>(h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x0 = o[4 * j + 2 * r] * inv, x1 = o[4 * j + 2 * r + 1] * inv;
      if constexpr (F32)
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * t4) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(x0, x1);
    }
    if (t4 == 0)
      p.lse[(static_cast<long long>(n) * p.H + h) * p.Tq + qi] =
          lr > 0.f ? (m[r] + log2f(lr)) * kLn2 : -INFINITY;
  }
}

// One CTA per (n*h, q tile); the latest q tiles (the heaviest under a
// causal offset) are launched first.
template <typename T, int D, int NWG, bool WIN>
__global__ void __launch_bounds__(NWG * 128, D <= 64 ? 2 : 1)
    flash_fwd_tc(const Params p, const int aligned, const float scale_log2) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  attend<T, D, NWG, WIN>(p, blockIdx.x / p.H, blockIdx.x % p.H,
                    (gridDim.y - 1 - blockIdx.y) * Smem<T, D, NWG>::kBlockQ,
                    aligned, scale_log2, smem_raw + pad, raw + pad);
}

// whether a tensor of T may be copied 16 bytes at a time
template <typename T>
int aligned16(const void* ptr, const Strides& s) {
  constexpr long long e = 16 / sizeof(T);  // elements in 16 bytes
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0 && s.n % e == 0 &&
         s.t % e == 0 && s.h % e == 0;
}

template <typename T, int D, int NWG, bool WIN>
cudaError_t launch(const Params& a, int device, cudaStream_t stream) {
  using SM = Smem<T, D, NWG>;
  const int bytes = static_cast<int>(SM::kBytes) + 1024;  // + alignment
  static bool done[64] = {};
  const cudaError_t err =
      set_smem(flash_fwd_tc<T, D, NWG, WIN>, bytes, device, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.N * a.H, (a.Tq + SM::kBlockQ - 1) / SM::kBlockQ);
  const int aligned = aligned16<T>(a.q, a.sq) |
                      aligned16<T>(a.k, a.sk) << 1 |
                      aligned16<T>(a.v, a.sv) << 2;
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  flash_fwd_tc<T, D, NWG, WIN><<<grid, NWG * 128, bytes, stream>>>(
      a, aligned, scale_log2);
  return cudaSuccess;
}

template <typename T, int D, bool WIN>
cudaError_t launch_win(const Params& a, int device, cudaStream_t stream) {
  // two consumer warpgroups (a 128-row q tile) where Tq has the rows
  return a.Tq > 64 ? launch<T, D, 2, WIN>(a, device, stream)
                   : launch<T, D, 1, WIN>(a, device, stream);
}

template <typename T, int D>
cudaError_t launch_rows(const Params& a, int device, cudaStream_t stream) {
  return a.win > 0 ? launch_win<T, D, true>(a, device, stream)
                   : launch_win<T, D, false>(a, device, stream);
}

template <typename T>
cudaError_t launch_d(const Params& a, int D, int device,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch_rows<T, 16>(a, device, stream);
    case 32: return launch_rows<T, 32>(a, device, stream);
    case 64: return launch_rows<T, 64>(a, device, stream);
    case 128: return launch_rows<T, 128>(a, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// dtype codes: 0 = float32, 1 = bfloat16. An unsupported head size or
// dtype returns cudaErrorInvalidValue without launching.
cudaError_t run(const Params& a, int D, int dtype, int device,
                cudaStream_t stream) {
  if (dtype == 0) return tc::launch_d<float>(a, D, device, stream);
  if (dtype == 1) return tc::launch_d<__nv_bfloat16>(a, D, device, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace flash
