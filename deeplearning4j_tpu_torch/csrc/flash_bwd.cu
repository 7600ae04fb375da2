// Flash-attention backward (K7), for Hopper (sm_90a). Plain C interface,
// loaded with ctypes by deeplearning4j_tpu_torch/ops/flash_attention.py
// (flash_bwd, the backward of FlashFn and FlashBlockFn on the card).
//
// Replaces: no Pallas kernel. The JAX package's flash backward is blocked
// XLA outside any kernel: deeplearning4j_tpu/ops/pallas_attention.py,
// _flash_bwd (:176, K4's backward) and _flash_ext_bwd (:335, K5's, with
// the lse cotangent). Its plain PyTorch version is flash_block_bwd in
// ops/flash_attention.py, the CPU path and the card's oracle.
//
// Function: q [N,Tq,H,D], k, v [N,Tk,H,D], o and dO [N,Tq,H,D] (all one
// dtype, contiguous), lse [N,H,Tq] f32 from the forward, an optional lse
// cotangent glse [N,H,Tq] f32, an optional additive key bias kb [N,Tk]
// f32 (0 keeps, -inf masks) and a host integer off in [-Tq, Tk] (key ki is
// visible to query qi iff qi + off >= ki). With s = q.k / sqrt(D) + kb:
//   Dvec = rowsum(dO * O) - glse,   P = exp(s - lse) (0 where hidden),
//   dV = P^T dO,   dS = P * (dO V^T - Dvec) / sqrt(D),
//   dQ = dS K,     dK = dS^T Q.
// A row with lse = -inf (no visible key) uses 0 in its place, so its P is
// 0, not NaN (every key of such a row is hidden). Math in f32; dQ, dK, dV
// in the inputs' dtype. K4's backward is this with no bias, no glse and
// offset 0 (causal) or T (full).
//
// What bounds it on the H100: the five products over the visible (query,
// key) pairs, 10 D flops a pair (the two recomputed ones make seven here),
// against ~5 D bytes per row of q/k/v/o/dO/dq/dk/dv: at the LM's training
// shape (T=1024, D=64, causal) ~1000 flops a byte, so the tensor cores
// (989 TFLOP/s bf16; 165 TFLOP/s for f32-accurate products, 3xTF32).
//
// What the design does (a simple, correct first version):
//  * no float atomics: two passes, each owning what it writes. The dQ
//    pass runs a CTA per (n*h, 64-row q tile), sweeps the visible key
//    tiles and also writes Dvec (and uses it); the dK/dV pass runs a CTA
//    per (n*h, 64-key tile), sweeps the q tiles that see any of its keys
//    and reads Dvec. P and dP are recomputed in both (seven products
//    instead of five). Every sum runs in a fixed order: two launches give
//    the same bits.
//  * tiles wholly hidden by the offset are skipped: a q tile stops at the
//    last key tile its last row sees, a key tile starts at the first q
//    tile whose last row sees its first key (about half the tiles of a
//    causal T=1024). Tiles the bias masks whole are multiplied (P = 0).
//  * products on the tensor cores with mma.sync, each warp owning 16 rows
//    of its CTA's 64: bf16 as m16n8k16 (bf16 operands, f32 accumulate; P
//    and dS are rounded to bf16 for their products, as in the forward's
//    one-P variant); f32 as 3xTF32 on m16n8k8 (each operand split into a
//    TF32 high part and the TF32 rounding of the rest, three products per
//    k8 step summed from zero and added on the CUDA cores), the port's
//    rule for f32-accurate products since K5's f32 kernel; TF32 alone
//    stays off. 3xTF32 over plain FMAs: the same code shape for both
//    dtypes, and the MHA fit's f32 layers run at tensor-core rates.
//  * operands come from shared memory (q, k, v, dO tiles in the input
//    dtype, rows padded by 16 bytes; P and dS in f32) through plain loads,
//    no ldmatrix, no cp.async pipeline, no wgmma: making it fast is later
//    work (ROADMAP, queue 2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 64;        // q rows of a dQ CTA, keys of a dK/dV CTA
constexpr int kWarps = 4;        // each warp owns 16 of those rows
constexpr int kThreads = 32 * kWarps;
constexpr int kPLd = kRows + 4;  // row stride (floats) of the P, dS tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;      // dO
  const float* lse;   // [N,H,Tq]
  const float* glse;  // [N,H,Tq] or null
  const float* kb;    // [N,Tk] or null
  void* dq;
  void* dk;
  void* dv;
  float* dvec;  // [N,H,Tq] workspace: rowsum(dO * O) - glse
  int N, Tq, Tk, H, off;
  float scale;  // 1 / sqrt(D)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// rows of D elements of T in shared memory, padded by 16 bytes
template <typename T, int D>
struct Tile {
  static constexpr int kLd = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int kBytes = kRows * kLd * static_cast<int>(sizeof(T));
};

// rows t0 .. t0 + kRows - 1 of head h of batch row n of a contiguous
// [N,T,H,D] tensor into a tile; rows past T are zero
template <typename T, int D>
__device__ void load_tile(T* s, const T* x, int n, int h, int t0, int T_len,
                          int H) {
  constexpr int kChunk = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int kPerRow = D / kChunk;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kChunk;
    const int t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T_len)
      val = *reinterpret_cast<const uint4*>(
          x + ((static_cast<long long>(n) * T_len + t) * H + h) * D + c);
    *reinterpret_cast<uint4*>(s + r * Tile<T, D>::kLd + c) = val;
  }
}

// ---------------------------------------------------------------------------
// warp products: c[j] += A (16 x K, row-major, k contiguous) times B
// (K x 8 NT); B's element (k, n) at b[n * ldb + k] (kNK: k contiguous) or
// b[k * ldb + n] (kKN). Fragments (g = lane / 4, t = lane % 4): C c0 (g,
// 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1) of each 16 x 8 block j.
// ---------------------------------------------------------------------------

enum Layout { kNK, kKN };

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
             << 16;
}
// elements k and k + 1 at p, as bf16x2 (k in the low half)
__device__ __forceinline__ uint32_t pair_bf16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pair_bf16(const float* p) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  return pack_bf16(f.x, f.y);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// m16n8k16 fragments: A a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
// a3 (g+8, 2t+8..); B b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8.., n = g)
template <int K, int NT, Layout LB, typename EA, typename EB>
__device__ __forceinline__ void mma_tile_bf16(float (&c)[NT][4], const EA* a,
                                              int lda, const EB* b, int ldb,
                                              int g, int t) {
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    const int ka = k0 + 2 * t;
    const uint32_t af[4] = {
        pair_bf16(a + g * lda + ka), pair_bf16(a + (g + 8) * lda + ka),
        pair_bf16(a + g * lda + ka + 8),
        pair_bf16(a + (g + 8) * lda + ka + 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + g;
      uint32_t bf[2];
      if constexpr (LB == kNK) {
        bf[0] = pair_bf16(b + n * ldb + ka);
        bf[1] = pair_bf16(b + n * ldb + ka + 8);
      } else {
        bf[0] = pack_bf16(to_f(b[ka * ldb + n]), to_f(b[(ka + 1) * ldb + n]));
        bf[1] = pack_bf16(to_f(b[(ka + 8) * ldb + n]),
                          to_f(b[(ka + 9) * ldb + n]));
      }
      mma_bf16(c[j], af, bf);
    }
  }
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(lo)
      : "f"(x - __uint_as_float(hi)));
}
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// m16n8k8 fragments: A a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8,
// t+4); B b0 (k = t, n = g), b1 (k = t+4, n = g). d += a.b as a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi from zero, added on the CUDA cores each k8 step
template <int K, int NT, Layout LB>
__device__ __forceinline__ void mma_tile_3xtf32(float (&c)[NT][4],
                                                const float* a, int lda,
                                                const float* b, int ldb,
                                                int g, int t) {
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    const int ka = k0 + t;
    uint32_t ah[4], al[4];
    split_tf32(a[g * lda + ka], ah[0], al[0]);
    split_tf32(a[(g + 8) * lda + ka], ah[1], al[1]);
    split_tf32(a[g * lda + ka + 4], ah[2], al[2]);
    split_tf32(a[(g + 8) * lda + ka + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + g;
      const float b0 = LB == kNK ? b[n * ldb + ka] : b[ka * ldb + n];
      const float b1 =
          LB == kNK ? b[n * ldb + ka + 4] : b[(ka + 4) * ldb + n];
      uint32_t bh[2], bl[2];
      split_tf32(b0, bh[0], bl[0]);
      split_tf32(b1, bh[1], bl[1]);
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(s, al, bh);
      mma_tf32(s, ah, bl);
      mma_tf32(s, ah, bh);
#pragma unroll
      for (int i = 0; i < 4; ++i) c[j][i] += s[i];
    }
  }
}

// bf16 inputs: m16n8k16; f32 inputs: 3xTF32 (every operand is f32 then)
template <typename T, int K, int NT, Layout LB, typename EA, typename EB>
__device__ __forceinline__ void mma_tile(float (&c)[NT][4], const EA* a,
                                         int lda, const EB* b, int ldb,
                                         int g, int t) {
  if constexpr (std::is_same<T, float>::value)
    mma_tile_3xtf32<K, NT, LB>(c, a, lda, b, ldb, g, t);
  else
    mma_tile_bf16<K, NT, LB>(c, a, lda, b, ldb, g, t);
}

// the warp's 16 x D accumulator to rows row0 + (g, g+8) of head h of a
// contiguous [N,T,H,D] tensor; rows past T are not written
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* x, const float (&c)[D / 8][4],
                                           int n, int h, int row0, int T_len,
                                           int H, int g, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= T_len) continue;
    T* dst = x + ((static_cast<long long>(n) * T_len + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x0 = c[j][2 * half], x1 = c[j][2 * half + 1];
      if constexpr (std::is_same<T, float>::value)
        *reinterpret_cast<float2*>(dst + 8 * j + 2 * t) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * t) =
            __floats2bfloat162_rn(x0, x1);
    }
  }
}

// ---------------------------------------------------------------------------
// the dQ pass: a CTA per (n*h, 64-row q tile); writes Dvec on the way
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DqSmem {
  static constexpr int kBytes =
      4 * Tile<T, D>::kBytes + (kRows * kPLd + 3 * kRows) * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const Params p) {
  constexpr int L = Tile<T, D>::kLd;
  extern __shared__ __align__(16) uint8_t smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sG = sQ + kRows * L;
  T* sK = sG + kRows * L;
  T* sV = sK + kRows * L;
  float* sS = reinterpret_cast<float*>(sV + kRows * L);  // this tile's dS
  float* sL = sS + kRows * kPLd;  // lse, 0 where -inf
  float* sD = sL + kRows;         // Dvec
  float* sB = sD + kRows;         // the key tile's bias
  const int n = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = 16 * warp;
  const T* q = static_cast<const T*>(p.q);
  const T* o = static_cast<const T*>(p.o);
  load_tile<T, D>(sQ, q, n, h, q0, p.Tq, p.H);
  load_tile<T, D>(sG, static_cast<const T*>(p.g), n, h, q0, p.Tq, p.H);
  __syncthreads();
  // Dvec and the lse of the warp's rows, each summed over D by its lanes
  for (int r = r0; r < r0 + 16; ++r) {
    const int qi = q0 + r;
    float acc = 0.f;
    if (qi < p.Tq) {
      const T* orow =
          o + ((static_cast<long long>(n) * p.Tq + qi) * p.H + h) * D;
      for (int d = lane; d < D; d += 32)
        acc += to_f(sG[r * L + d]) * to_f(orow[d]);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (lane == 0) {
      float dval = 0.f, lval = 0.f;
      if (qi < p.Tq) {
        const long long idx =
            (static_cast<long long>(n) * p.H + h) * p.Tq + qi;
        dval = acc - (p.glse != nullptr ? p.glse[idx] : 0.f);
        p.dvec[idx] = dval;
        const float l = p.lse[idx];
        lval = isfinite(l) ? l : 0.f;
      }
      sD[r] = dval;
      sL[r] = lval;
    }
  }
  // keys past the tile's last row's last visible key are hidden from all
  const int q_last = min(q0 + kRows, p.Tq) - 1;
  const int k_end = min(p.Tk, q_last + p.off + 1);
  float acc[D / 8][4] = {};
  for (int k0 = 0; k0 < k_end; k0 += kRows) {
    __syncthreads();  // the last tile's readers are done
    load_tile<T, D>(sK, static_cast<const T*>(p.k), n, h, k0, p.Tk, p.H);
    load_tile<T, D>(sV, static_cast<const T*>(p.v), n, h, k0, p.Tk, p.H);
    if (threadIdx.x < kRows) {
      const int ki = k0 + threadIdx.x;
      sB[threadIdx.x] = p.kb != nullptr && ki < p.Tk
                            ? p.kb[static_cast<long long>(n) * p.Tk + ki]
                            : 0.f;
    }
    __syncthreads();
    float s[8][4] = {}, dp[8][4] = {};
    mma_tile<T, D, 8, kNK>(s, sQ + r0 * L, L, sK, L, g, t);   // Q K^T
    mma_tile<T, D, 8, kNK>(dp, sG + r0 * L, L, sV, L, g, t);  // dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + g + 8 * (i >> 1), c = 8 * j + 2 * t + (i & 1);
        const int qi = q0 + r, ki = k0 + c;
        float pr = 0.f;
        if (qi < p.Tq && ki < p.Tk && qi + p.off >= ki)
          pr = expf(s[j][i] * p.scale + sB[c] - sL[r]);
        sS[r * kPLd + c] = pr * (dp[j][i] - sD[r]) * p.scale;
      }
    }
    __syncwarp();
    mma_tile<T, kRows, D / 8, kKN>(acc, sS + r0 * kPLd, kPLd, sK, L, g,
                                   t);  // dS K
  }
  store_rows<T, D>(static_cast<T*>(p.dq), acc, n, h, q0 + r0, p.Tq, p.H, g,
                   t);
}

// ---------------------------------------------------------------------------
// the dK/dV pass: a CTA per (n*h, 64-key tile); reads Dvec
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DkvSmem {
  static constexpr int kBytes =
      4 * Tile<T, D>::kBytes + (2 * kRows * kPLd + 3 * kRows) * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv(const Params p) {
  constexpr int L = Tile<T, D>::kLd;
  extern __shared__ __align__(16) uint8_t smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kRows * L;
  T* sQ = sV + kRows * L;
  T* sG = sQ + kRows * L;
  float* sP = reinterpret_cast<float*>(sG + kRows * L);  // P^T [key][q]
  float* sS = sP + kRows * kPLd;                          // dS^T
  float* sL = sS + kRows * kPLd;
  float* sD = sL + kRows;
  float* sB = sD + kRows;
  const int n = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int k0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = 16 * warp;
  load_tile<T, D>(sK, static_cast<const T*>(p.k), n, h, k0, p.Tk, p.H);
  load_tile<T, D>(sV, static_cast<const T*>(p.v), n, h, k0, p.Tk, p.H);
  if (threadIdx.x < kRows) {
    const int ki = k0 + threadIdx.x;
    sB[threadIdx.x] = p.kb != nullptr && ki < p.Tk
                          ? p.kb[static_cast<long long>(n) * p.Tk + ki]
                          : 0.f;
  }
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  // rows before q_begin see none of this tile's keys
  const int q_begin = max(0, k0 - p.off);
  for (int q0 = q_begin / kRows * kRows; q0 < p.Tq; q0 += kRows) {
    __syncthreads();  // the last tile's readers are done
    load_tile<T, D>(sQ, static_cast<const T*>(p.q), n, h, q0, p.Tq, p.H);
    load_tile<T, D>(sG, static_cast<const T*>(p.g), n, h, q0, p.Tq, p.H);
    if (threadIdx.x < kRows) {
      const int qi = q0 + threadIdx.x;
      float dval = 0.f, lval = 0.f;
      if (qi < p.Tq) {
        const long long idx =
            (static_cast<long long>(n) * p.H + h) * p.Tq + qi;
        dval = p.dvec[idx];
        const float l = p.lse[idx];
        lval = isfinite(l) ? l : 0.f;
      }
      sD[threadIdx.x] = dval;
      sL[threadIdx.x] = lval;
    }
    __syncthreads();
    float st[8][4] = {}, dpt[8][4] = {};
    mma_tile<T, D, 8, kNK>(st, sK + r0 * L, L, sQ, L, g, t);   // K Q^T
    mma_tile<T, D, 8, kNK>(dpt, sV + r0 * L, L, sG, L, g, t);  // V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + g + 8 * (i >> 1), c = 8 * j + 2 * t + (i & 1);
        const int ki = k0 + r, qi = q0 + c;
        float pr = 0.f;
        if (qi < p.Tq && ki < p.Tk && qi + p.off >= ki)
          pr = expf(st[j][i] * p.scale + sB[r] - sL[c]);
        sP[r * kPLd + c] = pr;
        sS[r * kPLd + c] = pr * (dpt[j][i] - sD[c]) * p.scale;
      }
    }
    __syncwarp();
    mma_tile<T, kRows, D / 8, kKN>(dv, sP + r0 * kPLd, kPLd, sG, L, g,
                                   t);  // P^T dO
    mma_tile<T, kRows, D / 8, kKN>(dk, sS + r0 * kPLd, kPLd, sQ, L, g,
                                   t);  // dS^T Q
  }
  store_rows<T, D>(static_cast<T*>(p.dk), dk, n, h, k0 + r0, p.Tk, p.H, g,
                   t);
  store_rows<T, D>(static_cast<T*>(p.dv), dv, n, h, k0 + r0, p.Tk, p.H, g,
                   t);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// raises a kernel's dynamic shared-memory limit once per device
template <typename K>
cudaError_t set_smem(K kernel, int bytes, int device, bool (&done)[64]) {
  const bool known = device >= 0 && device < 64;
  if (known && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && known) done[device] = true;
  return err;
}

template <typename T, int D>
cudaError_t launch(const Params& p, int device, cudaStream_t stream) {
  static bool done_dq[64] = {}, done_dkv[64] = {};
  cudaError_t err = set_smem(flash_bwd_dq<T, D>, DqSmem<T, D>::kBytes,
                             device, done_dq);
  if (err != cudaSuccess) return err;
  err = set_smem(flash_bwd_dkdv<T, D>, DkvSmem<T, D>::kBytes, device,
                 done_dkv);
  if (err != cudaSuccess) return err;
  // the dQ pass first: it writes Dvec, which the dK/dV pass reads
  if (p.Tq > 0) {
    flash_bwd_dq<T, D>
        <<<dim3(p.N * p.H, (p.Tq + kRows - 1) / kRows), kThreads,
           DqSmem<T, D>::kBytes, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (p.Tk == 0) return cudaSuccess;
  flash_bwd_dkdv<T, D>
      <<<dim3(p.N * p.H, (p.Tk + kRows - 1) / kRows), kThreads,
         DkvSmem<T, D>::kBytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int D, int device,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, device, stream);
    case 32: return launch<T, 32>(p, device, stream);
    case 64: return launch<T, 64>(p, device, stream);
    case 128: return launch<T, 128>(p, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. q, k, v, o, g contiguous in
// their [N,T,H,D] shapes and 16-byte aligned; dq, dk, dv contiguous
// buffers of their shapes in the same dtype; lse, glse (or null), dvec
// contiguous [N,H,Tq] f32; kb a contiguous [N,Tk] f32 bias or null; off in
// [-Tq, Tk] (the caller clamps it). Two launches, dQ then dK/dV, on
// `stream`. Returns the CUDA error of the launches (0 = success); an
// unsupported head size or dtype returns cudaErrorInvalidValue without
// launching.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, const void* lse, const void* glse, const void* kb,
    void* dq, void* dk, void* dv, void* dvec, int N, int Tq, int Tk, int H,
    int D, int off, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N == 0 || H == 0 || (Tq == 0 && Tk == 0)) return 0;
  if (off < -Tq || off > Tk) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, g,
           static_cast<const float*>(lse), static_cast<const float*>(glse),
           static_cast<const float*>(kb), dq, dk, dv,
           static_cast<float*>(dvec), N, Tq, Tk, H, off,
           1.0f / sqrtf(static_cast<float>(D))};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) err = launch_d<float>(p, D, device, s);
  else if (dtype == 1) err = launch_d<__nv_bfloat16>(p, D, device, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
