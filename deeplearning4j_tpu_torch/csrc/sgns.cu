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
// ~6*B*K1*D flops: ~12 MB, 3.7 us at 3.35 TB/s for the smoke's batch
// (V=71290, D=128, B=2048, K1=6: ~1,800 syn0 and ~10,100 syn1neg rows).
// At that size a launch's own latency is a sizeable share, so the design
// keeps to two launches and touches each row's bytes as few times as it
// can.
//
// What the design does about it. A "hit" is a target entry with live != 0
// (hit index b*K1 + k) or a context whose pair has a live entry (hit index
// B*K1 + b); H = B*(K1+1) hits at most.
//  * (1) gather, one warp per pair, D across the lanes (16-byte loads
//    where D % 4 == 0): the stale rows, the dots by shuffles, g and neu1e,
//    parked in scratch (l1 [B,D], neu1e [B,D], g*live [B*K1]), so (2)
//    reads nothing of a table but the rows it owns: no stale-read hazard
//    is left between the launches. Each hit joins its row: atomicCAS on
//    the table's [V] int head map (-1 between calls) names the row's owner,
//    the first hit to claim it; atomicAdd on the owner's count gives the
//    hit a slot among the owner's first kSlots. Integer atomics only.
//  * (2) owners, one warp per hit index; a hit with a count is its row's
//    owner. A row of at most kWarpHits hits: the owner warp ranks its
//    slots by hit index, which is the batch order of the TPU kernel's
//    sequential loop, sums the contributions from zero in that order
//    (g*live*l1 for syn1neg, neu1e for syn0; four hits' loads in flight
//    at a time, the row's own load beside them), scales the sum by
//    1/sqrt(n) and adds it to the row once. A row of one hit (most of a
//    batch at V=71290) needs no slot: its owner is its hit. A hotter row
//    (frequent centre words and negatives; every row at V=64): the hit
//    that takes its (kWarpHits+1)-th slot puts the owner on a hot list in
//    (1), and (2) deals the list round the grid, a whole CTA per row, so
//    hot rows spread over the card (their owners, the first hits to
//    claim them, sit in the first CTAs). The CTA ranks up to kSlots hits
//    from the owner's slots, or scans every hit's row in batch order,
//    4,096 a step (16 consecutive per thread, compacted in order by a
//    prefix over lanes and warps); one contiguous chunk per warp, the
//    eight partial sums added in a fixed tree. Whoever sums a row resets
//    its head and count, and the last CTA the hot list, so the maps are
//    clean between calls and never swept.
//  * no float atomics and no order that depends on scheduling: two
//    launches give the same bits. The sum still rounds at the size of the
//    update, not of the row (adding ~190 hits straight onto a row of
//    entries ~0.1 drifts past the 1e-5-of-the-update bar in f32), without
//    the [V,D] delta buffers an atomic design needs: the scratch is
//    O(B*D + V).
//  * an entry with live 0 is no hit and a row no live pair touches has no
//    owner: it keeps its bits.
//  * an index outside [0, V) traps (as PyTorch's device-side index checks
//    do): the launch fails instead of writing outside the tables.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps (pairs or hit indices) per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kSlots = 64;     // hits an owner keeps by slot (ops/sgns.SLOTS)
constexpr int kWarpHits = 16;  // rows of up to this many hits: owner warp
constexpr int kPer = 16;    // hit indices each thread tests per scan step
constexpr int kScanCap = kThreads * kPer;  // hit indices per scan step
constexpr int kOwnerBlocks = 4;  // owner CTAs per SM: at most 64 registers
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

// A row of D floats as a lane holds it: chunk c, element j is
// d = (c * 32 + lane) * VEC + j; VEC = 4 loads each chunk as 16 bytes
// (D % 4 == 0 and 16-byte aligned rows), VEC = 1 one float per chunk.
template <int CH, int VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         int lane, int D,
                                         float (&out)[CH * VEC]) {
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int d = (c * 32 + lane) * VEC;
    if constexpr (VEC == 4) {
      const float4 x = d < D ? *reinterpret_cast<const float4*>(row + d)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      out[4 * c] = x.x;
      out[4 * c + 1] = x.y;
      out[4 * c + 2] = x.z;
      out[4 * c + 3] = x.w;
    } else {
      out[c] = d < D ? row[d] : 0.f;
    }
  }
}

template <int CH, int VEC>
__device__ __forceinline__ void store_row(float* __restrict__ row, int lane,
                                          int D, const float (&v)[CH * VEC]) {
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int d = (c * 32 + lane) * VEC;
    if (d >= D) continue;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(row + d) =
          make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
    } else {
      row[d] = v[c];
    }
  }
}

// (1) stale gathers, dots, g, neu1e into scratch; every hit joins its row
template <int CH, int VEC>
__global__ void __launch_bounds__(kThreads)
sgns_gather_kernel(const float* __restrict__ syn0,
                   const float* __restrict__ syn1neg,
                   const long long* __restrict__ ctx,
                   const long long* __restrict__ tgt,
                   const float* __restrict__ labels,
                   const float* __restrict__ live,
                   const float* __restrict__ alpha_ptr, float alpha_val,
                   float* __restrict__ l1buf, float* __restrict__ neubuf,
                   float* __restrict__ wbuf, int* __restrict__ hrow,
                   int* __restrict__ head0, int* __restrict__ head1,
                   int* __restrict__ cnt, int* __restrict__ slots,
                   int* __restrict__ hot, int* __restrict__ hot_count, int B,
                   int K1, int D, int V) {
  constexpr int E = CH * VEC;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const float alpha = alpha_ptr != nullptr ? *alpha_ptr : alpha_val;
  const long long c = checked_row(ctx[b], V);
  float l1[E], neu[E];
  load_row<CH, VEC>(syn0 + c * D, lane, D, l1);
  store_row<CH, VEC>(l1buf + static_cast<long long>(b) * D, lane, D, l1);
#pragma unroll
  for (int e = 0; e < E; ++e) neu[e] = 0.f;
  const long long i0 = static_cast<long long>(b) * K1;
  float live_sum = 0.f;
  for (int k0 = 0; k0 < K1; k0 += 4) {
    // the next four target rows' loads in flight together
    float s[4][E];
    long long t[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      t[u] = 0;
      if (k0 + u < K1) {
        t[u] = checked_row(tgt[i0 + k0 + u], V);
        load_row<CH, VEC>(syn1neg + t[u] * D, lane, D, s[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (k0 + u >= K1) break;
      const long long i = i0 + k0 + u;
      const float lv = live[i];
      const float lbl = labels[i];
      float p = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) p = fmaf(l1[e], s[u][e], p);
      const float dot = warp_sum(p);
      const float f = 1.f / (1.f + expf(-dot));
      const float base =
          dot > kMaxExp ? lbl - 1.f : (dot < -kMaxExp ? lbl : lbl - f);
      const float g = base * alpha * lv;
#pragma unroll
      for (int e = 0; e < E; ++e) neu[e] = fmaf(g, s[u][e], neu[e]);
      if (lane == 0) {
        wbuf[i] = g * lv;
        hrow[i] = lv != 0.f ? static_cast<int>(t[u]) : -1;
      }
      live_sum += lv;
    }
  }
  store_row<CH, VEC>(neubuf + static_cast<long long>(b) * D, lane, D, neu);
  const bool ctx_live = live_sum > 0.f;  // live.sum(1) > 0, k in order
  const long long hc = static_cast<long long>(B) * K1 + b;
  if (lane == 0) hrow[hc] = ctx_live ? static_cast<int>(c) : -1;
  // the hits join their rows (last: the atomics' round trips would hold
  // up the row loads above); lane k target k, one more lane the context
  for (int k = lane; k <= K1; k += 32) {
    const bool is_tgt = k < K1;
    const long long h = is_tgt ? i0 + k : hc;
    if (is_tgt ? live[h] == 0.f : !ctx_live) continue;
    const int r = static_cast<int>(is_tgt ? tgt[h] : c);  // checked above
    int owner = atomicCAS((is_tgt ? head1 : head0) + r, -1,
                          static_cast<int>(h));
    if (owner < 0) owner = static_cast<int>(h);
    const int slot = atomicAdd(cnt + owner, 1);
    if (slot < kSlots) {
      slots[static_cast<long long>(owner) * kSlots + slot] =
          static_cast<int>(h);
    }
    // the hit that makes the row hot lists its owner, once per hot row
    if (slot == kWarpHits) hot[atomicAdd(hot_count, 1)] = owner;
  }
}

// The contributions of the hits pos[0..n) of one table, in that order,
// added from the lane's running sum: syn1neg hits g*live * l1[b], syn0
// hits neu1e[b]; nt sums live (1 for a syn0 hit) in the same order, four
// hits' loads in flight at a time (eight cost the owner kernel registers
// and half its occupancy).
template <int CH, int VEC>
__device__ __forceinline__ void accumulate(
    const int* pos, int n, bool is_tgt, int BK1, int K1, int D, int lane,
    const float* __restrict__ l1buf, const float* __restrict__ neubuf,
    const float* __restrict__ wbuf, const float* __restrict__ live,
    float (&acc)[CH * VEC], float& nt) {
  constexpr int E = CH * VEC;
  constexpr int U = 4;
  for (int s0 = 0; s0 < n; s0 += U) {
    float x[U][E], w[U], lv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      w[u] = lv[u] = 0.f;
      if (s0 + u < n) {
        const int p = pos[s0 + u];
        if (is_tgt) {
          w[u] = wbuf[p];
          lv[u] = live[p];
          load_row<CH, VEC>(l1buf + static_cast<long long>(p / K1) * D, lane,
                            D, x[u]);
        } else {
          w[u] = lv[u] = 1.f;
          load_row<CH, VEC>(neubuf + static_cast<long long>(p - BK1) * D,
                            lane, D, x[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u >= n) break;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(w[u], x[u][e], acc[e]);
      nt += lv[u];
    }
  }
}

// (2) one warp per hit index; the owner of a row adds its sum once
template <int CH, int VEC>
__global__ void __launch_bounds__(kThreads, kOwnerBlocks)
sgns_owner_kernel(float* __restrict__ syn0, float* __restrict__ syn1neg,
                  const float* __restrict__ live,
                  const float* __restrict__ l1buf,
                  const float* __restrict__ neubuf,
                  const float* __restrict__ wbuf,
                  const int* __restrict__ hrow, int* __restrict__ head0,
                  int* __restrict__ head1, int* __restrict__ cnt,
                  const int* __restrict__ slots,
                  const int* __restrict__ hot, int* __restrict__ hot_count,
                  int B, int K1, int D) {
  constexpr int E = CH * VEC;
  __shared__ int sorted[kWarps][kWarpHits];
  __shared__ int buf[kScanCap];
  __shared__ int wcount[kWarps];
  __shared__ float red[kWarps][E * 32];
  __shared__ float red_nt[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int BK1 = B * K1;
  const int H = BK1 + B;
  const int h = blockIdx.x * kWarps + warp;
  const int n = h < H ? cnt[h] : 0;
  const int r = h < H ? hrow[h] : -1;
  const int n_hot = hot_count[0];

  if (n > 0 && n <= kWarpHits) {  // a row of few hits: its owner warp
    const bool is_tgt = h < BK1;
    float* row = (is_tgt ? syn1neg : syn0) + static_cast<long long>(r) * D;
    float old[E], acc[E];
    load_row<CH, VEC>(row, lane, D, old);  // in flight with the hits' data
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    float nt = 0.f;
    if (n == 1) {  // the owner is the row's only hit
      sorted[warp][0] = h;
    } else {
      const int p = lane < n
          ? slots[static_cast<long long>(h) * kSlots + lane] : 0x7fffffff;
      int rank = 0;
      for (int k = 0; k < n; ++k) rank += __shfl_sync(kFull, p, k) < p;
      if (lane < n) sorted[warp][rank] = p;
    }
    __syncwarp();
    accumulate<CH, VEC>(sorted[warp], n, is_tgt, BK1, K1, D, lane, l1buf,
                        neubuf, wbuf, live, acc, nt);
    const float scale = 1.f / sqrtf(fmaxf(nt, 1.f));
#pragma unroll
    for (int e = 0; e < E; ++e) old[e] += scale * acc[e];
    store_row<CH, VEC>(row, lane, D, old);
    if (lane == 0) {
      (is_tgt ? head1 : head0)[r] = -1;
      cnt[h] = 0;
    }
  }

  // Rows of more than kWarpHits hits, each by a whole CTA: the hot list
  // (an owner per hot row, from (1)) dealt round the grid, so hot rows
  // spread over it (their owners, the first hits to claim them, sit in
  // the first CTAs). A hot row's head and its owner's count stay set until
  // its CTA resets them; the warps above touch only rows of at most
  // kWarpHits. Up to kSlots hits come from the owner's slots, more from
  // a scan of every hit's row.
  for (int job = blockIdx.x; job < n_hot; job += gridDim.x) {
    const int hj = hot[job];
    const int nj = cnt[hj];
    const bool is_tgt = hj < BK1;
    const int rj = hrow[hj];
    const int lo = is_tgt ? 0 : BK1;
    const int hi = is_tgt ? BK1 : H;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    float nt = 0.f;
    const bool slotted = nj <= kSlots;
    const int steps = slotted ? 1 : (hi - lo + kScanCap - 1) / kScanCap;
    for (int step = 0; step < steps; ++step) {
      int total;
      if (slotted) {  // the owner's slots, ranked by hit index
        const int p = threadIdx.x < nj
            ? slots[static_cast<long long>(hj) * kSlots + threadIdx.x] : 0;
        if (threadIdx.x < nj) buf[threadIdx.x] = p;
        __syncthreads();
        int rank = 0;
        for (int k = 0; k < nj; ++k) rank += buf[k] < p;
        __syncthreads();
        if (threadIdx.x < nj) buf[rank] = p;
        total = nj;
      } else {
        // thread t tests kPer consecutive hit indices: thread order is
        // batch order, and the prefix over lanes and warps keeps it
        const int jt = lo + step * kScanCap + threadIdx.x * kPer;
        unsigned mask = 0;
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          if (jt + q < hi && hrow[jt + q] == rj) mask |= 1u << q;
        }
        const int mine = __popc(mask);
        int incl = mine;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += y;
        }
        if (lane == 31) wcount[warp] = incl;
        __syncthreads();
        int at = incl - mine;
        total = 0;
        for (int w = 0; w < kWarps; ++w) {
          at += w < warp ? wcount[w] : 0;
          total += wcount[w];
        }
        for (int q = 0; q < kPer; ++q) {
          if (mask >> q & 1u) buf[at++] = jt + q;
        }
      }
      __syncthreads();
      // one contiguous chunk per warp, in batch order
      const int per = (total + kWarps - 1) / kWarps;
      const int first = min(total, warp * per);
      const int end = min(total, first + per);
      accumulate<CH, VEC>(buf + first, end - first, is_tgt, BK1, K1, D,
                          lane, l1buf, neubuf, wbuf, live, acc, nt);
      __syncthreads();
    }
    // the warps' partial sums in a fixed tree
#pragma unroll
    for (int c = 0; c < CH; ++c) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        red[warp][(c * 32 + lane) * VEC + q] = acc[c * VEC + q];
      }
    }
    if (lane == 0) red_nt[warp] = nt;
    __syncthreads();
    const float tn = ((red_nt[0] + red_nt[1]) + (red_nt[2] + red_nt[3])) +
                     ((red_nt[4] + red_nt[5]) + (red_nt[6] + red_nt[7]));
    const float scale = 1.f / sqrtf(fmaxf(tn, 1.f));
    float* row = (is_tgt ? syn1neg : syn0) + static_cast<long long>(rj) * D;
    for (int d = threadIdx.x; d < D; d += kThreads) {
      const float sum =
          ((red[0][d] + red[1][d]) + (red[2][d] + red[3][d])) +
          ((red[4][d] + red[5][d]) + (red[6][d] + red[7][d]));
      row[d] += scale * sum;
    }
    if (threadIdx.x == 0) {
      (is_tgt ? head1 : head0)[rj] = -1;
      cnt[hj] = 0;
    }
    __syncthreads();
  }
  // the last CTA to finish empties the hot list (every CTA has read its
  // length by then)
  __syncthreads();
  if (threadIdx.x == 0 && n_hot > 0) {
    __threadfence();
    if (atomicAdd(hot_count + 1, 1) == static_cast<int>(gridDim.x) - 1) {
      hot_count[0] = 0;
      hot_count[1] = 0;
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
  float* l1buf;
  float* neubuf;
  float* wbuf;
  int* hrow;
  int* head0;
  int* head1;
  int* cnt;
  int* slots;
  int* hot;
  int* hot_count;
  int B, K1, D, V;
};

template <int CH, int VEC>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const dim3 block(kThreads);
  sgns_gather_kernel<CH, VEC><<<(a.B + kWarps - 1) / kWarps, block, 0, st>>>(
      a.syn0, a.syn1neg, a.ctx, a.tgt, a.labels, a.live, a.alpha_ptr,
      a.alpha_val, a.l1buf, a.neubuf, a.wbuf, a.hrow, a.head0, a.head1,
      a.cnt, a.slots, a.hot, a.hot_count, a.B, a.K1, a.D, a.V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long hits = static_cast<long long>(a.B) * (a.K1 + 1);
  sgns_owner_kernel<CH, VEC><<<static_cast<unsigned>((hits + kWarps - 1) /
                                                     kWarps),
                               block, 0, st>>>(
      a.syn0, a.syn1neg, a.live, a.l1buf, a.neubuf, a.wbuf, a.hrow, a.head0,
      a.head1, a.cnt, a.slots, a.hot, a.hot_count, a.B, a.K1, a.D);
  return cudaGetLastError();
}

// loads both kernels of an instantiation (lazy module loading would load
// them at their first launch, which may come inside a graph capture)
template <int CH, int VEC>
cudaError_t load_kernels() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, sgns_gather_kernel<CH, VEC>);
  if (err != cudaSuccess) return err;
  return cudaFuncGetAttributes(&attr, sgns_owner_kernel<CH, VEC>);
}

}  // namespace

// Loads every kernel of the library on the device; returns the CUDA error.
extern "C" int sgns_prepare(int device) {
  cudaError_t err = cudaSetDevice(device);
  cudaError_t (*const loads[])() = {
      load_kernels<1, 4>, load_kernels<2, 4>, load_kernels<4, 4>,
      load_kernels<1, 1>, load_kernels<2, 1>, load_kernels<4, 1>,
      load_kernels<8, 1>, load_kernels<16, 1>};
  for (auto load : loads) {
    if (err == cudaSuccess) err = load();
  }
  return static_cast<int>(err);
}

// Returns the CUDA error of the launches (0 = success); D outside 1..512
// returns cudaErrorInvalidValue without launching. alpha_ptr, when not
// null, is read on the device instead of alpha_val. vec = 1 takes the
// 16-byte row loads (D % 4 == 0, tables 16-byte aligned). Scratch, with
// H = B*(K1+1): l1buf, neubuf [B*D] f32, wbuf [B*K1] f32, hrow [H] int,
// slots [H*64] int, hot [H/17 + 1] int; head0, head1 [V] int must be -1
// and cnt [H], hot_count [2] int 0 on entry, and are so again when the
// launches end. V is the tables' row
// count, against which every index is checked; V and H below 2^31.
extern "C" int sgns_step(void* syn0, void* syn1neg, const void* ctx,
                         const void* tgt, const void* labels,
                         const void* live, const void* alpha_ptr,
                         float alpha_val, void* l1buf, void* neubuf,
                         void* wbuf, void* hrow, void* head0, void* head1,
                         void* cnt, void* slots, void* hot, void* hot_count,
                         int B, int K1, int D, int V, int vec, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || K1 == 0) return 0;
  const Args a{static_cast<float*>(syn0), static_cast<float*>(syn1neg),
               static_cast<const long long*>(ctx),
               static_cast<const long long*>(tgt),
               static_cast<const float*>(labels),
               static_cast<const float*>(live),
               static_cast<const float*>(alpha_ptr), alpha_val,
               static_cast<float*>(l1buf), static_cast<float*>(neubuf),
               static_cast<float*>(wbuf), static_cast<int*>(hrow),
               static_cast<int*>(head0), static_cast<int*>(head1),
               static_cast<int*>(cnt), static_cast<int*>(slots),
               static_cast<int*>(hot), static_cast<int*>(hot_count),
               B, K1, D, V};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D > 512) {
    err = cudaErrorInvalidValue;
  } else if (vec) {
    err = D <= 128 ? launch<1, 4>(a, st)
          : D <= 256 ? launch<2, 4>(a, st) : launch<4, 4>(a, st);
  } else if (D <= 32) {
    err = launch<1, 1>(a, st);
  } else if (D <= 64) {
    err = launch<2, 1>(a, st);
  } else if (D <= 128) {
    err = launch<4, 1>(a, st);
  } else if (D <= 256) {
    err = launch<8, 1>(a, st);
  } else {
    err = launch<16, 1>(a, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
