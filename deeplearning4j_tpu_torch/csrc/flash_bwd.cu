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
// dtype, contiguous, 16-byte aligned), lse [N,H,Tq] f32 from the forward,
// an optional lse cotangent glse [N,H,Tq] f32, an optional additive key
// bias kb [N,Tk] f32 (0 keeps, -inf masks) and a host integer off in
// [-Tq, Tk] (key ki is visible to query qi iff qi + off >= ki, and, with
// a window win > 0, qi + off - ki < win). With
// s = q.k / sqrt(D) + kb:
//   Dvec = rowsum(dO * O) - glse,   P = exp(s - lse) (0 where hidden),
//   dV = P^T dO,   dS = P * (dO V^T - Dvec) / sqrt(D),
//   dQ = dS K,     dK = dS^T Q.
// A row with lse = -inf (no visible key) uses 0 in its place, so its P is
// 0, not NaN (every key of such a row is hidden). Math in f32; dQ, dK, dV
// in the inputs' dtype. K4's backward is this with no bias, no glse and
// offset 0 (causal) or T (full).
//
// What bounds it on the H100: the five products over the visible (query,
// key) pairs, 10 D flops a pair (seven products here, P and dP being
// recomputed in both passes), against ~5 D bytes per row of
// q/k/v/o/dO/dq/dk/dv: at the LM's training shape (T=1024, D=64, causal)
// ~1000 flops a byte, so the tensor cores (989 TFLOP/s bf16; 165 TFLOP/s
// for f32-accurate products, 3xTF32).
//
// What the design does (the primitives are csrc/flash_tc.cuh's, shared
// with the forward):
//  * no float atomics: two passes, each owning what it writes. The dQ
//    pass runs a CTA per (n*h, q tile), sweeps the key tiles its rows can
//    see and also writes Dvec; the dK/dV pass runs a CTA per (n*h, key
//    tile), sweeps the q tiles that see any of its keys and reads Dvec.
//    Every sum runs in a fixed order: two launches give the same bits.
//  * a CTA of NT threads owns NT / 2 rows (128 where the sequence has
//    them, else 64; bf16 dK/dV always 64 keys, three CTAs an SM), kept in
//    shared memory with their second operand (Q and dO; K and V); the
//    other side streams through a 2-stage cp.async ring (16-byte copies,
//    zero past the end; lse, Dvec and the bias by 4-byte copies beside
//    them), so tile j + 1 is in flight while tile j is multiplied, one
//    barrier a tile.
//  * bf16: wgmma (bf16 in, f32 accumulate), a warpgroup per 64 rows,
//    tiles in the 128/64/32-byte swizzle the forward uses. S = Q K^T and
//    dP = dO V^T (dQ pass), S^T = K Q^T and dP^T = V dO^T (dK/dV pass)
//    are products of two K-major tiles (ss); P and dS are computed in the
//    accumulator registers and fed, rounded once to bf16, as the A operand
//    of dQ += dS K, dV += P^T dO and dK += dS^T Q, whose B (K, dO, Q as
//    stored, [rows][D]) is read MN-major (rs_mn). Nothing but the streamed
//    tiles passes through shared memory. S and dP are two commit groups,
//    so P is computed while dP is in flight, and dV's product is in
//    flight while dS^T is computed; each tile retires its products before
//    the next (left in flight across tiles, ptxas serialises every wgmma:
//    C7515).
//  * f32: 3xTF32 on mma.sync m16n8k8 (wgmma's TF32 form reads B only
//    K-major, and three of these B operands are MN-major), a warp per 16
//    rows, tiles padded to D + 4 floats, 32-row streamed tiles (registers:
//    the accumulators of two 16 x 32 score slices and of dQ or dK and dV).
//    The score accumulator, its keys (or queries) permuted inside each
//    slice of 8, is the A fragment of the next product, and that
//    product's B is read in the same order (the forward's P.V), so P and
//    dS never touch shared memory; each k8 step's three products are
//    summed from zero and added on the CUDA cores.
//  * only what adds something is multiplied: tiles the offset hides are
//    not visited (a q tile stops at the last key tile its last row sees,
//    a key tile starts at the first q tile that sees it; a warpgroup or
//    warp skips the tiles none of its rows sees); a key tile the bias masks
//    whole (a length mask's tail) is skipped in the dQ pass by a warp vote,
//    and in the dK/dV pass a CTA whose keys are all masked (or seen by no
//    row) writes zeros and returns without loading anything. Only the
//    diagonal tile and the ragged ends run the per-element test; the bias
//    is added everywhere (exp2(-inf) = 0). The heaviest tiles launch
//    first: the latest q tiles (dQ pass), the earliest key tiles (dK/dV).
//  * a window is a template parameter, as in the forward: with none the
//    passes compile to the code above. With one, a q tile starts at the
//    first key tile its first row's window reaches (dQ), a key tile stops
//    at the last q tile that sees its last key (dK/dV), and only tiles the
//    window cuts for some row of a group test each element.
//  * probabilities in log2 units (scores scaled by log2(e) / sqrt(D),
//    lse and the bias by log2(e)), exp2 on the SFU, as in the forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_tc.cuh"

namespace flash {
namespace {
namespace bwd {

using namespace tc;

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
  int win;           // 0: no window; else qi + off - ki >= win is hidden
  float scale;       // 1 / sqrt(D)
  float scale_log2;  // log2(e) / sqrt(D)
};

template <typename T, int D>
constexpr uint32_t tile_bytes(int rows) {
  return std::is_same<T, float>::value ? TileF<D>::bytes(rows)
                                       : Tile<D>::bytes(rows);
}

// A CTA of NT threads owns kRows = NT / 2 rows (q rows in the dQ pass,
// keys in the dK/dV pass), in groups of kGroup rows that multiply on their
// own (a warpgroup of 64 for bf16 wgmma, a warp of 16 for f32 mma.sync);
// the other side streams in tiles of kKB rows. Shared memory: the owned
// rows' two tiles (A: Q or K, B: dO or V), then the ring's X tiles (K or
// Q) and Y tiles (V or dO), then per stage 2 kKB floats (the keys' bias;
// the q rows' lse and Dvec), then 2 kRows floats (the dQ pass's own lse
// and Dvec). bf16 tiles start 1024-byte aligned (every tile size is a
// multiple of 1024). Bytes at NT = 256: bf16 D=64 67,584, D=128 133,120;
// f32 D=64 105,984, D=128 204,288 (of the 227 KB a block may use); bf16
// dK/dV at NT = 128: D=64 50,688, D=128 99,840; + 1024 for the alignment.
template <typename T, int D, int NT>
struct Shape {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kRows = NT / 2;
  static constexpr int kGroup = kF32 ? 16 : 64;
  static constexpr int kKB = kF32 ? 32 : 64;
  static constexpr int kStages = 2;
  static constexpr uint32_t kA = 0;
  static constexpr uint32_t kB = tile_bytes<T, D>(kRows);
  static constexpr uint32_t kTile = tile_bytes<T, D>(kKB);
  static constexpr uint32_t kX = 2 * tile_bytes<T, D>(kRows);
  static constexpr uint32_t kY = kX + kStages * kTile;
  static constexpr uint32_t kF = kY + kStages * kTile;
  static constexpr uint32_t kBytes =
      kF + (kStages * 2 * kKB + 2 * kRows) * 4;
};

// sum of the products of two 16-byte chunks of T
template <typename T>
__device__ __forceinline__ float dot16(const uint4 a, const uint4 b) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      acc = fmaf(__uint_as_float(wa[i]), __uint_as_float(wb[i]), acc);
    } else {
      const float2 fa = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&wa[i]));
      const float2 fb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&wb[i]));
      acc = fmaf(fa.x, fb.x, acc);
      acc = fmaf(fa.y, fb.y, acc);
    }
  }
  return acc;
}

// lse in log2 units, 0 where -inf (a row that sees no key)
__device__ __forceinline__ float lse_log2(float l) {
  return isfinite(l) ? l * kLog2e : 0.f;
}

// Dvec = rowsum(dO * O) - glse of rows q0 .. q0 + R - 1 of head (n, h)
// (0 past Tq) into sD and the workspace, their lse (lse_log2) into sL; C
// lanes per row, each a 16-byte chunk, summed by shuffles
template <typename T, int D, int R, int NT>
__device__ __forceinline__ void row_terms(const Params& p, const int n,
                                          const int h, const int q0,
                                          float* sL, float* sD) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  constexpr int C = D / E;  // 2 .. 32
  constexpr int NB = C / 2 < 4 ? C / 2 : 4;  // rows whose loads are batched
  const int c = threadIdx.x % C;
  const long long hd = static_cast<long long>(p.H) * D;
  // R * C / NT = C / 2 rows a lane group, the same count in every lane
#pragma unroll 1
  for (int b = 0; b < C / 2; b += NB) {
    uint4 gv[NB], ov[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int qi = q0 + threadIdx.x / C + (b + i) * (NT / C);
      gv[i] = ov[i] = make_uint4(0u, 0u, 0u, 0u);
      if (qi < p.Tq) {
        const long long at =
            (static_cast<long long>(n) * p.Tq + qi) * hd + h * D + c * E;
        gv[i] = *reinterpret_cast<const uint4*>(
            static_cast<const T*>(p.g) + at);
        ov[i] = *reinterpret_cast<const uint4*>(
            static_cast<const T*>(p.o) + at);
      }
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int r = threadIdx.x / C + (b + i) * (NT / C);
      const int qi = q0 + r;
      float acc = dot16<T>(gv[i], ov[i]);
#pragma unroll
      for (int s = C / 2; s > 0; s >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, s);
      if (c == 0) {
        float dval = 0.f, lval = 0.f;
        if (qi < p.Tq) {
          const long long idx =
              (static_cast<long long>(n) * p.H + h) * p.Tq + qi;
          dval = acc - (p.glse != nullptr ? p.glse[idx] : 0.f);
          p.dvec[idx] = dval;
          lval = lse_log2(p.lse[idx]);
        }
        sD[r] = dval;
        sL[r] = lval;
      }
    }
  }
}

// the thread's accumulator a[4j + 2r + c] (row row0 + 8r, column 8j + 2t4
// + c) to head h of batch row n of a contiguous [N,T,H,D] tensor; rows
// past T are not written
template <typename T, int D>
__device__ __forceinline__ void store_rows(void* x, const float* a,
                                           const int n, const int h,
                                           const int row0, const int T_len,
                                           const int H, const int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= T_len) continue;
    T* dst = static_cast<T*>(x) +
             ((static_cast<long long>(n) * T_len + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x0 = a[4 * j + 2 * r], x1 = a[4 * j + 2 * r + 1];
      if constexpr (std::is_same<T, float>::value)
        *reinterpret_cast<float2*>(dst + 8 * j + 2 * t4) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(x0, x1);
    }
  }
}

// zeros into rows t0 .. t0 + R - 1 (those below T) of head (n, h)
template <typename T, int D, int R, int NT>
__device__ __forceinline__ void zero_rows(void* x, const int n, const int h,
                                          const int t0, const int T_len,
                                          const int H) {
  constexpr int C = D * static_cast<int>(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < R * C; i += NT) {
    const int t = t0 + i / C;
    if (t >= T_len) continue;
    *reinterpret_cast<uint4*>(
        static_cast<T*>(x) +
        ((static_cast<long long>(n) * T_len + t) * H + h) * D +
        i % C * (16 / static_cast<int>(sizeof(T)))) = make_uint4(0, 0, 0, 0);
  }
}

// bf16: d (+)= rows of A (own tile of `rows` rows at a, the group's 64
// from row r0) times B^T (a streamed tile of 64 rows at b), both K-major
template <int D>
__device__ __forceinline__ void ss_tile(float* d, const uint32_t a,
                                        const int rows, const int r0,
                                        const uint32_t b) {
  constexpr int RB = Tile<D>::kRowBytes;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t blk = kk * 32 / RB;  // column block of this k-slice
    const uint32_t in = kk * 32 % RB;
    Mma<64>::ss(d,
                desc(a + blk * rows * RB + r0 * RB + in, 16, 8 * RB,
                     Tile<D>::kLayout),
                desc(b + blk * 64 * RB + in, 16, 8 * RB, Tile<D>::kLayout),
                kk > 0);
  }
}

// bf16: d += A (the 64 x 64 accumulator x, rounded once to bf16 as A
// fragments) times B (a streamed tile of 64 rows at b, [rows][D], read
// MN-major)
template <int D>
__device__ __forceinline__ void rs_tile(float* d, const uint32_t (&a)[4][4],
                                        const uint32_t b) {
  constexpr int RB = Tile<D>::kRowBytes;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Mma<D>::rs_mn(d, a[kk],
                  desc(b + kk * 16 * RB, 64 * RB, 8 * RB, Tile<D>::kLayout));
}

// the accumulator x[32] of a 64 x 64 wgmma as bf16 A fragments: k-slice
// kk holds columns 16kk .. 16kk + 15
__device__ __forceinline__ void to_frags(uint32_t (&a)[4][4], const float* x) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// CTAs an SM, by registers: bf16 dQ at D <= 64 within 128 a thread (two
// CTAs of 256); bf16 dK/dV at D <= 64 three CTAs of 128 within 168 (a
// few spilled bytes: 226 registers and two CTAs timed 13 % slower at the
// LM's layer on an H100, 128 and four spilled too much); the rest within
// 255 (f32 at 128 registers spilled and timed 6 % slower at case h)
template <typename T, int D, int NT, bool DKDV>
constexpr int min_blocks() {
  return std::is_same<T, float>::value || D > 64
             ? 256 / NT
             : (DKDV ? 3 : 65536 / (NT * 128));
}

// ---------------------------------------------------------------------------
// the dQ pass: a CTA per (n*h, q tile of NT / 2 rows); writes Dvec
// ---------------------------------------------------------------------------

template <typename T, int D, int NT, bool WIN>
__global__ void __launch_bounds__(NT, (min_blocks<T, D, NT, false>()))
    flash_bwd_dq(const Params p) {
  using SH = Shape<T, D, NT>;
  constexpr bool F32 = SH::kF32;
  constexpr int R = SH::kRows, G = SH::kGroup, KB = SH::kKB;
  constexpr int S = SH::kStages;
  constexpr int NS = KB / 2;  // score accumulators a thread
  constexpr int NO = D / 2;   // dQ accumulators a thread
  constexpr int L = TileF<D>::kLd;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* gsm = smem_raw + pad;
  const uint32_t ssm = raw + pad;
  float* sBias = reinterpret_cast<float*>(gsm + SH::kF);  // [S][KB]
  float* sL = sBias + 2 * S * KB;                          // [R]
  float* sD = sL + R;                                      // [R]

  const int n = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * R;  // latest first
  const int tid = threadIdx.x, lane = tid & 31, t4 = lane & 3;
  const int grp = tid / (2 * G);
  const int rw = 16 * (tid >> 5);  // the warp's first row in the tile
  const int row0 = q0 + rw + (lane >> 2);  // rows row0, row0 + 8
  const int q0g = q0 + grp * G;

  const long long hd = static_cast<long long>(p.H) * D;
  const long long at_q = static_cast<long long>(n) * p.Tq * hd + h * D;
  const long long at_k = static_cast<long long>(n) * p.Tk * hd + h * D;
  const T* qb = static_cast<const T*>(p.q) + at_q;
  const T* gb = static_cast<const T*>(p.g) + at_q;
  const T* kbase = static_cast<const T*>(p.k) + at_k;
  const T* vbase = static_cast<const T*>(p.v) + at_k;
  const float* bias =
      p.kb != nullptr ? p.kb + static_cast<long long>(n) * p.Tk : nullptr;

  // keys this tile's rows can see: ki <= q_last + off
  const int q_last = min(q0 + R, p.Tq) - 1;
  const int k_end = min(p.Tk, q_last + p.off + 1);
  const int n_kt = k_end > 0 ? (k_end + KB - 1) / KB : 0;
  const int k_end_g =
      q0g < p.Tq ? min(p.Tk, min(q0g + G - 1, p.Tq - 1) + p.off + 1) : 0;
  // the window: the first key tile the tile's first row reaches; keys
  // before k_beg_g are outside every row's window of the group, from
  // k_open_g on inside every row's
  const int kt0 = WIN ? max(0, q0 + p.off - p.win + 1) / KB : 0;
  const int k_beg_g = WIN ? q0g + p.off - p.win + 1 : 0;
  const int k_open_g = WIN ? q0g + G + p.off - p.win : 0;

  // K, V and the bias of key tile j into ring stage (j - kt0) % S
  auto load_kv = [&](int j) {
    const uint32_t ss = (j - kt0) % S;
    const uint32_t st = ss * SH::kTile;
    load_tile<D, KB, NT>(gsm + SH::kX + st, ssm + SH::kX + st, kbase, hd,
                         j * KB, p.Tk, true, tid);
    load_tile<D, KB, NT>(gsm + SH::kY + st, ssm + SH::kY + st, vbase, hd,
                         j * KB, p.Tk, true, tid);
    if (bias != nullptr && tid < KB) {
      const int ki = j * KB + tid;
      cp_async4(ssm + SH::kF + (ss * KB + tid) * 4,
                bias + (ki < p.Tk ? ki : 0), ki < p.Tk);
    }
  };
  if (n_kt > kt0) {
    load_tile<D, R, NT>(gsm + SH::kA, ssm + SH::kA, qb, hd, q0, p.Tq, true,
                        tid);
    load_tile<D, R, NT>(gsm + SH::kB, ssm + SH::kB, gb, hd, q0, p.Tq, true,
                        tid);
    load_kv(kt0);
  }
  cp_async_commit();
  row_terms<T, D, R, NT>(p, n, h, q0, sL, sD);
  __syncthreads();
  float lr[2], dr[2];  // lse (log2 units) and Dvec of rows row0, row0 + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lr[r] = sL[rw + (lane >> 2) + 8 * r];
    dr[r] = sD[rw + (lane >> 2) + 8 * r];
  }

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  for (int kt = kt0; kt < n_kt; ++kt) {
    const int k0 = kt * KB;
    const uint32_t stage = (kt - kt0) % S;
    // tile kt has landed for every thread, and every group is done with
    // tile kt - 1, whose stage the next copy fills
    cp_async_wait<0>();
    if constexpr (!F32) fence_proxy_async();
    __syncthreads();
    if (kt + 1 < n_kt) load_kv(kt + 1);
    cp_async_commit();
    if (k0 >= k_end_g) continue;  // no row of this group sees the tile
    if (WIN && k0 + KB <= k_beg_g) continue;  // outside every window
    const float* sb = sBias + stage * KB;
    if (bias != nullptr) {
      // a key tile the bias masks whole adds nothing; every warp reads
      // the same keys, so the vote agrees across a warpgroup
      bool live = false;
#pragma unroll
      for (int i = lane; i < KB; i += 32)
        live |= k0 + i < p.Tk && sb[i] != -INFINITY;
      if (!__any_sync(0xffffffffu, live)) continue;
    }
    const uint32_t xs = SH::kX + stage * SH::kTile;  // K
    const uint32_t ys = SH::kY + stage * SH::kTile;  // V

    // S = Q K^T and dP = dO V^T, the group's rows x KB keys
    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    if constexpr (F32) {
      const float* qw = reinterpret_cast<const float*>(gsm + SH::kA) + rw * L;
      const float* gw = reinterpret_cast<const float*>(gsm + SH::kB) + rw * L;
      qk_3xtf32<D, KB>(s, qw, reinterpret_cast<const float*>(gsm + xs),
                       lane >> 2, t4);
      qk_3xtf32<D, KB>(dp, gw, reinterpret_cast<const float*>(gsm + ys),
                       lane >> 2, t4);
    } else {
      // two groups: P is computed while dP is in flight
      fence_regs<NS>(s);
      fence_regs<NS>(dp);
      wgmma_fence();
      ss_tile<D>(s, ssm + SH::kA, R, grp * 64, ssm + xs);
      wgmma_commit();
      ss_tile<D>(dp, ssm + SH::kB, R, grp * 64, ssm + ys);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs<NS>(s);
    }

    // P, then dS, in the accumulators; the per-element test only where
    // some key of the tile is hidden from some row of the group or past Tk
    const bool open = k0 + KB <= p.Tk && k0 + KB - 1 <= q0g + p.off &&
                      (!WIN || k0 >= k_open_g);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
      float x = fmaf(s[i], p.scale_log2,
                     bias != nullptr ? fmaf(sb[c], kLog2e, -lr[r]) : -lr[r]);
      if (!open) {
        const int ki = k0 + c;
        const int qo = row0 + 8 * r + p.off;
        if (ki >= p.Tk || qo < ki || (WIN && qo - ki >= p.win))
          x = -INFINITY;
      }
      s[i] = ex2(x);
    }
    if constexpr (!F32) {
      wgmma_wait<0>();
      fence_regs<NS>(dp);
    }
#pragma unroll
    for (int i = 0; i < NS; ++i)
      s[i] *= (dp[i] - dr[(i >> 1) & 1]) * p.scale;  // dS

    // dQ += dS K
    if constexpr (F32) {
      pv_3xtf32<D, KB>(acc, s, reinterpret_cast<const float*>(gsm + xs),
                       lane >> 2, t4);
    } else {
      uint32_t a[4][4];
      to_frags(a, s);
      fence_regs<NO>(acc);
      fence_regs<16>(&a[0][0]);
      wgmma_fence();
      rs_tile<D>(acc, a, ssm + xs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NO>(acc);
      fence_regs<16>(&a[0][0]);
    }
  }
  store_rows<T, D>(p.dq, acc, n, h, row0, p.Tq, p.H, t4);
}

// ---------------------------------------------------------------------------
// the dK/dV pass: a CTA per (n*h, key tile of NT / 2 keys); reads Dvec
// ---------------------------------------------------------------------------

template <typename T, int D, int NT, bool WIN>
__global__ void __launch_bounds__(NT, (min_blocks<T, D, NT, true>()))
    flash_bwd_dkdv(const Params p) {
  using SH = Shape<T, D, NT>;
  constexpr bool F32 = SH::kF32;
  constexpr int R = SH::kRows, G = SH::kGroup, KB = SH::kKB;
  constexpr int S = SH::kStages;
  constexpr int NS = KB / 2;
  constexpr int NO = D / 2;
  constexpr int L = TileF<D>::kLd;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* gsm = smem_raw + pad;
  const uint32_t ssm = raw + pad;
  const float* sLq = reinterpret_cast<const float*>(gsm + SH::kF);  // [S][KB]
  const float* sDq = sLq + S * KB;                                  // [S][KB]

  const int n = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int k0 = blockIdx.y * R;  // earliest (heaviest when causal) first
  const int tid = threadIdx.x, lane = tid & 31, t4 = lane & 3;
  const int grp = tid / (2 * G);
  const int rw = 16 * (tid >> 5);
  const int key0 = k0 + rw + (lane >> 2);  // keys key0, key0 + 8
  const int k0g = k0 + grp * G;

  const long long hd = static_cast<long long>(p.H) * D;
  const long long nh = static_cast<long long>(n) * p.H + h;
  const long long at_q = static_cast<long long>(n) * p.Tq * hd + h * D;
  const long long at_k = static_cast<long long>(n) * p.Tk * hd + h * D;
  const T* qb = static_cast<const T*>(p.q) + at_q;
  const T* gb = static_cast<const T*>(p.g) + at_q;
  const T* kbase = static_cast<const T*>(p.k) + at_k;
  const T* vbase = static_cast<const T*>(p.v) + at_k;
  const float* bias =
      p.kb != nullptr ? p.kb + static_cast<long long>(n) * p.Tk : nullptr;

  // the bias of the thread's keys (log2 units), and whether any key of
  // the group is there and unmasked (every warp of a group reads the same
  // keys, so the vote agrees across a warpgroup)
  float bk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ki = key0 + 8 * r;
    bk[r] = bias != nullptr && ki < p.Tk ? bias[ki] * kLog2e : 0.f;
  }
  bool any = false;
#pragma unroll
  for (int i = lane; i < G; i += 32)
    any |= k0g + i < p.Tk && (bias == nullptr || bias[k0g + i] != -INFINITY);
  const bool live_g = __any_sync(0xffffffffu, any);
  // rows before q_begin see none of the CTA's keys
  const int q_begin = max(0, k0 - p.off);
  const int qt0 = q_begin / KB;
  // rows from q_end on see none of them through the window
  const int q_end =
      WIN ? min(p.Tq, min(k0 + R, p.Tk) - 1 - p.off + p.win) : p.Tq;
  const int n_qt = q_begin < q_end ? (q_end + KB - 1) / KB - qt0 : 0;
  // keys that every row misses or the bias masks: dK = dV = 0, nothing
  // loaded
  if (!__syncthreads_or(live_g && n_qt > 0)) {
    zero_rows<T, D, R, NT>(p.dk, n, h, k0, p.Tk, p.H);
    zero_rows<T, D, R, NT>(p.dv, n, h, k0, p.Tk, p.H);
    return;
  }

  // Q, dO, lse and Dvec of q tile qt0 + j into ring stage j % S
  auto load_q = [&](int j) {
    const int t0 = (qt0 + j) * KB;
    const uint32_t st = j % S * SH::kTile;
    load_tile<D, KB, NT>(gsm + SH::kX + st, ssm + SH::kX + st, qb, hd, t0,
                         p.Tq, true, tid);
    load_tile<D, KB, NT>(gsm + SH::kY + st, ssm + SH::kY + st, gb, hd, t0,
                         p.Tq, true, tid);
    if (tid < 2 * KB) {
      const int i = tid % KB, qi = t0 + i;
      const float* src = tid < KB ? p.lse : p.dvec;
      cp_async4(ssm + SH::kF + ((tid < KB ? 0 : S * KB) + j % S * KB + i) * 4,
                src + nh * p.Tq + (qi < p.Tq ? qi : 0), qi < p.Tq);
    }
  };
  load_tile<D, R, NT>(gsm + SH::kA, ssm + SH::kA, kbase, hd, k0, p.Tk, true,
                      tid);
  load_tile<D, R, NT>(gsm + SH::kB, ssm + SH::kB, vbase, hd, k0, p.Tk, true,
                      tid);
  load_q(0);
  cp_async_commit();

  float dk[NO], dv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;
  for (int j = 0; j < n_qt; ++j) {
    const int q0t = (qt0 + j) * KB;
    const uint32_t stage = j % S;
    cp_async_wait<0>();
    if constexpr (!F32) fence_proxy_async();
    __syncthreads();
    if (j + 1 < n_qt) load_q(j + 1);
    cp_async_commit();
    // a group whose keys are all masked, or that no row of the tile sees
    if (!live_g || q0t + KB - 1 + p.off < k0g) continue;
    // a group whose last key is outside the window of the tile's first row
    if (WIN && q0t + p.off - (k0g + G - 1) >= p.win) continue;
    const uint32_t xs = SH::kX + stage * SH::kTile;  // Q
    const uint32_t ys = SH::kY + stage * SH::kTile;  // dO
    const float* lq = sLq + stage * KB;
    const float* dq = sDq + stage * KB;

    // S^T = K Q^T and dP^T = V dO^T, the group's keys x KB q rows
    float st[NS], dpt[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) st[i] = dpt[i] = 0.f;
    if constexpr (F32) {
      qk_3xtf32<D, KB>(st,
                       reinterpret_cast<const float*>(gsm + SH::kA) + rw * L,
                       reinterpret_cast<const float*>(gsm + xs), lane >> 2,
                       t4);
    } else {
      // two groups: P^T is computed while dP^T is in flight
      fence_regs<NS>(st);
      fence_regs<NS>(dpt);
      wgmma_fence();
      ss_tile<D>(st, ssm + SH::kA, R, grp * 64, ssm + xs);
      wgmma_commit();
      ss_tile<D>(dpt, ssm + SH::kB, R, grp * 64, ssm + ys);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs<NS>(st);
    }

    // P^T in the accumulator; the per-element test only on the diagonal
    // and the ragged ends
    const bool open = k0g + G <= p.Tk && q0t + KB <= p.Tq &&
                      q0t + p.off >= k0g + G - 1 &&
                      (!WIN || q0t + KB - 1 + p.off - k0g < p.win);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
      float x = fmaf(st[i], p.scale_log2, bk[r] - lse_log2(lq[c]));
      if (!open) {
        const int ki = key0 + 8 * r, qi = q0t + c;
        if (ki >= p.Tk || qi >= p.Tq || qi + p.off < ki ||
            (WIN && qi + p.off - ki >= p.win))
          x = -INFINITY;
      }
      st[i] = ex2(x);
    }

    // dV += P^T dO (in flight while dS^T is computed), dS^T, dK += dS^T Q
    if constexpr (F32) {
      pv_3xtf32<D, KB>(dv, st, reinterpret_cast<const float*>(gsm + ys),
                       lane >> 2, t4);
      qk_3xtf32<D, KB>(dpt,
                       reinterpret_cast<const float*>(gsm + SH::kB) + rw * L,
                       reinterpret_cast<const float*>(gsm + ys), lane >> 2,
                       t4);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
        dpt[i] = st[i] * (dpt[i] - dq[c]) * p.scale;  // dS^T
      }
      pv_3xtf32<D, KB>(dk, dpt, reinterpret_cast<const float*>(gsm + xs),
                       lane >> 2, t4);
    } else {
      uint32_t pa[4][4], da[4][4];
      to_frags(pa, st);
      fence_regs<NO>(dv);
      fence_regs<16>(&pa[0][0]);
      wgmma_fence();
      rs_tile<D>(dv, pa, ssm + ys);
      wgmma_commit();
      wgmma_wait<1>();  // dP^T has landed; dV's product may be in flight
      fence_regs<NS>(dpt);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
        dpt[i] = st[i] * (dpt[i] - dq[c]) * p.scale;  // dS^T
      }
      to_frags(da, dpt);
      fence_regs<NO>(dk);
      fence_regs<16>(&da[0][0]);
      wgmma_fence();
      rs_tile<D>(dk, da, ssm + xs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NO>(dv);
      fence_regs<NO>(dk);
      fence_regs<16>(&pa[0][0]);
      fence_regs<16>(&da[0][0]);
    }
  }
  store_rows<T, D>(p.dk, dk, n, h, key0, p.Tk, p.H, t4);
  store_rows<T, D>(p.dv, dv, n, h, key0, p.Tk, p.H, t4);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// one pass at NT threads a CTA over `len` rows (q rows or keys)
template <typename T, int D, int NT, bool DKDV, bool WIN>
cudaError_t launch_pass(const Params& p, int len, int device,
                        cudaStream_t stream) {
  using SH = Shape<T, D, NT>;
  const int bytes = static_cast<int>(SH::kBytes) + 1024;  // + alignment
  void (*kernel)(const Params);
  if constexpr (DKDV) kernel = flash_bwd_dkdv<T, D, NT, WIN>;
  else kernel = flash_bwd_dq<T, D, NT, WIN>;
  static bool done[64] = {};
  cudaError_t err = set_smem(kernel, bytes, device, done);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.N * p.H, (len + SH::kRows - 1) / SH::kRows), NT, bytes,
           stream>>>(p);
  return cudaGetLastError();
}

// 128-row CTAs where the sequence has the rows, else 64; bf16 dK/dV
// always 64 keys a CTA (one warpgroup: three CTAs an SM fit where two
// warpgroups' 128 keys fit one)
template <typename T, int D, bool DKDV, bool WIN>
cudaError_t launch_rows(const Params& p, int len, int device,
                        cudaStream_t stream) {
  if constexpr (DKDV && !std::is_same<T, float>::value)
    return launch_pass<T, D, 128, DKDV, WIN>(p, len, device, stream);
  else
    return len > 64
               ? launch_pass<T, D, 256, DKDV, WIN>(p, len, device, stream)
               : launch_pass<T, D, 128, DKDV, WIN>(p, len, device, stream);
}

template <typename T, int D, bool WIN>
cudaError_t launch_win(const Params& p, int device, cudaStream_t stream) {
  // the dQ pass first: it writes Dvec, which the dK/dV pass reads
  if (p.Tq > 0) {
    const cudaError_t err =
        launch_rows<T, D, false, WIN>(p, p.Tq, device, stream);
    if (err != cudaSuccess) return err;
  }
  if (p.Tk == 0) return cudaSuccess;
  return launch_rows<T, D, true, WIN>(p, p.Tk, device, stream);
}

template <typename T, int D>
cudaError_t launch(const Params& p, int device, cudaStream_t stream) {
  return p.win > 0 ? launch_win<T, D, true>(p, device, stream)
                   : launch_win<T, D, false>(p, device, stream);
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

}  // namespace bwd
}  // namespace
}  // namespace flash

// dtype codes: 0 = float32, 1 = bfloat16. q, k, v, o, g contiguous in
// their [N,T,H,D] shapes and 16-byte aligned; dq, dk, dv contiguous
// buffers of their shapes in the same dtype; lse, glse (or null), dvec
// contiguous [N,H,Tq] f32; kb a contiguous [N,Tk] f32 bias or null; off in
// [-Tq, Tk] (the caller clamps it); win >= 0 (0: no window). Two
// launches, dQ then dK/dV, on `stream`. Returns the CUDA error of the
// launches (0 = success); an unsupported head size or dtype returns
// cudaErrorInvalidValue without launching.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, const void* lse, const void* glse, const void* kb,
    void* dq, void* dk, void* dv, void* dvec, int N, int Tq, int Tk, int H,
    int D, int off, int win, int dtype, int device, void* stream) {
  using flash::bwd::launch_d;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N == 0 || H == 0 || (Tq == 0 && Tk == 0)) return 0;
  if (off < -Tq || off > Tk || win < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash::bwd::Params p{q, k, v, o, g,
                       static_cast<const float*>(lse),
                       static_cast<const float*>(glse),
                       static_cast<const float*>(kb), dq, dk, dv,
                       static_cast<float*>(dvec), N, Tq, Tk, H, off, win,
                       scale, scale * flash::tc::kLog2e};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) err = launch_d<float>(p, D, device, s);
  else if (dtype == 1) err = launch_d<__nv_bfloat16>(p, D, device, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
