// Reverse-time Graves peephole-LSTM backward scan, written by hand for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// deeplearning4j_tpu_torch/ops/lstm_scan.py (lstm_scan_bwd).
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py, _lstm_pallas_bwd_raw
// (kernel body _lstm_bwd_kernel), the backward half of lstm_pallas_scan.
//
// Function, gates [i, f, o, g] along the 4H axis, all f32. For t = T-1
// down to 0, with h_prev, c_prev = hs[t-1], cs[t-1] (h0, c0 at t = 0):
//   z = xproj[:, t] + h_prev U;  i, f, o, g and tanh(c) recomputed
//   dh  = dhs[:, t] + dh_carry
//   dzo = dh tanh(c) o (1 - o)
//   dc  = dh o (1 - tanh^2 c) + dc_carry + dzo p_o
//   dzi = dc g i (1 - i);  dzg = dc i (1 - g^2);  dzf = dc c_prev f (1 - f)
//   dxproj[:, t] = [dzi, dzf, dzo, dzg]
//   dh_carry = dz U^T;  dc_carry = dc f + dzi p_i + dzf p_f
// and dU = sum_t h_prev^T dz, dp = [sum dzi c_prev, sum dzf c_prev,
// sum dzo c] over rows and steps; dh0, dc0 are the carries after t = 0.
//
// What bounds it on the H100: the recurrence, as in the forward (K1).
// The work is 3 * 2*N*T*H*4H flops (the gate recompute, dz U^T and dU:
// 1.54 GFLOP at the char-RNN's training window N=32, T=50, H=200, 9.3 us
// at the 3xTF32 rate), but dh_carry of step t needs dz of every hidden
// unit of its row from step t+1, so the T steps of a row run one after the
// other and the time is T times the latency of one step.
//
// What the design does about it: only dz U^T stays on the sequential
// path, in four launches on the caller's stream:
//  1. lstm_bwd_gates: the gate pre-activations z = xproj + h_prev U of
//     every (row, step) at once, a tiled product over the whole card on
//     the tensor cores at f32 accuracy (3xTF32 on mma.sync; h_prev is hs
//     shifted by one step, h0 at t = 0), written into the dxproj buffer.
//     The recompute needs no carry, so it leaves the sweep.
//  2. lstm_bwd_sweep: one thread-block cluster per block of R batch rows
//     (the planner's, as K1's), C CTAs splitting the hidden units. Each
//     CTA keeps U[:, its units' gate columns] in shared memory (the first
//     k_smem rows where the slice does not fit; the rest from L2), reads z
//     (prefetched one step ahead), c and the cotangents of its (row, unit)
//     items, forms dz, overwrites z with it, and keeps dc_carry and its
//     dp sums in registers. dh_carry = dz U^T is reduce-scattered, not
//     gathered: each CTA multiplies its own dz columns by the same column
//     slice of U, giving a partial dh_carry for every unit of its rows,
//     and stores the partial for peer q's units straight into q's shared
//     memory (st.async into a double buffer [2][C][units][R], completing
//     on q's mbarrier for that buffer, csrc/lstm_cluster.cuh); each CTA
//     waits for its C*units*R*4 bytes, then each owner sums its C
//     partials in rank order. That moves H*R floats per CTA per step (a
//     gather of dz would move 4H*R) and needs no second slice of U.
//     Nothing on the sequential path goes through L2 but the prefetched
//     per-item loads.
//  3. lstm_bwd_du: dU = H_prev^T dZ as a tiled 3xTF32 product over the card,
//     the N*T rows split into du_splits ranges so that the tiles fill the
//     SMs, each range summed in row order into its own slice of a
//     workspace (or straight into dU with one range).
//  4. lstm_bwd_finish: dU as the sum of the ranges in range order, and dp
//     as the sum over rows, in row order, of the sweep's per-row sums.
// No float atomics anywhere: two launches give the same bits.

#include <algorithm>

#include "lstm_cluster.cuh"

namespace {

constexpr int kTile = 64;  // output tile of the two products
constexpr int kDepth = 16; // depth of one shared-memory stage

struct GemmParams {
  const float* xproj;
  long long sxn, sxt;  // element strides of xproj's N and T axes
  const float* u;      // [H, 4H]
  const float* h0;     // [N, H]
  const float* hs;     // [N, T, H]
  float* dxproj;       // [N, T, 4H]: z after the gates pass, dz after the sweep
  float* du;           // [H, 4H]
  float* ws;           // [du_splits][H, 4H] or null (one split)
  int N, T, H, chunk;  // chunk: rows of N*T per split (a multiple of kDepth)
};

struct SweepParams {
  float* dxproj;       // [N, T, 4H]
  const float* u;      // [H, 4H]
  const float* p;      // [3, H]
  const float* c0;     // [N, H]
  const float* cs;     // [T, N, H]
  const float* dhs;    // [N, T, H]
  const float* dhT;    // [N, H]
  const float* dcT;    // [N, H]
  float* dh0;          // [N, H]
  float* dc0;          // [N, H]
  float* dpp;          // [N, 3, H] each row's dp sums over its steps
  int N, T, H, units, k_smem, cluster;
};

struct FinishParams {
  float* du;
  const float* ws;
  const float* dpp;
  float* dp;
  int N, H, splits;
};

// ---------------------------------------------------------------------------
// The two products over the card, on the tensor cores at f32 accuracy:
// 3xTF32 on mma.sync m16n8k8, as csrc/flash_fwd.cuh's f32 path. Each
// operand x is split into hi = tf32(x) and lo = tf32(x - hi); a.b =
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, each k8 step's three products summed
// from zero and added to the f32 accumulator on the CUDA cores (the
// tensor cores' own accumulation is not f32's round-to-nearest). A CTA
// computes a 64 x 64 tile with 8 warps, each 16 rows x 32 columns (four
// n8 tiles); operands pass through shared memory 16 deep, in a ring of
// three stages filled by cp.async ahead of the products. Fragments (g =
// lane / 4, t = lane % 4): A a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3
// (g+8, t+4); B b0 (k=t, n=g), b1 (k=t+4, n=g); C c0 (g, 2t), c1 (g,
// 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
// ---------------------------------------------------------------------------

constexpr int kLd = kTile + 8;     // padded row of a 64-wide operand tile
constexpr int kLdA = kDepth + 4;   // padded row of the gates' [m][k] tile

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[j] += A.B over one 16-deep stage for this warp's 16 x 32 block:
// A(row, k) = as[row * SAM + k * SAK], B(k, n) = bs[k * kLd + n]
template <int SAM, int SAK>
__device__ __forceinline__ void stage_3xtf32(float (&acc)[4][4],
                                             const float* as,
                                             const float* bs, int wm, int wn,
                                             int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kDepth; kk += 8) {
    const int r0 = 16 * wm + g, k0 = kk + t;
    uint32_t ah[4], al[4];
    split_tf32(as[r0 * SAM + k0 * SAK], ah[0], al[0]);
    split_tf32(as[(r0 + 8) * SAM + k0 * SAK], ah[1], al[1]);
    split_tf32(as[r0 * SAM + (k0 + 4) * SAK], ah[2], al[2]);
    split_tf32(as[(r0 + 8) * SAM + (k0 + 4) * SAK], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 32 * wn + 8 * j + g;
      uint32_t bh[2], bl[2];
      split_tf32(bs[k0 * kLd + n], bh[0], bl[0]);
      split_tf32(bs[(k0 + 4) * kLd + n], bh[1], bl[1]);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(c, al, bh);
      mma_tf32(c, ah, bl);
      mma_tf32(c, ah, bh);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += c[i];
    }
  }
}

// out(row, col) for this warp's fragment (j, i) of the 64 x 64 tile
__device__ __forceinline__ int frag_row(int wm, int g, int i) {
  return 16 * wm + g + (i >= 2 ? 8 : 0);
}
__device__ __forceinline__ int frag_col(int wn, int t, int j, int i) {
  return 32 * wn + 8 * j + 2 * t + (i & 1);
}

constexpr int kStages = 3;  // cp.async ring of operand stages

// a 4- or 16-byte copy into shared memory, zeros where !ok (src unread)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_ring() {  // all but the newest stage
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// z[m, c] = xproj[m, c] + sum_k h_prev[m, k] U[k, c] for a 64 x 64 tile,
// k in order.
__global__ void __launch_bounds__(kThreads) lstm_bwd_gates(const GemmParams P) {
  __shared__ __align__(16) float as[kStages][kTile * kLdA];  // [m][k]
  __shared__ __align__(16) float bs[kStages][kDepth * kLd];  // [k][c]
  const int M = P.N * P.T, H = P.H, C4 = 4 * H;
  const int m0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2, g = lane / 4, t = lane % 4;
  // this thread's four A elements keep their rows for every stage; its
  // B float4 its row and column
  const float* arow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + (tid + i * kThreads) / kDepth;
    arow[i] = m >= M ? nullptr
              : m % P.T == 0 ? P.h0 + static_cast<size_t>(m / P.T) * H
                             : P.hs + static_cast<size_t>(m - 1) * H;
  }
  const int kb = tid / (kTile / 4), cb = (tid % (kTile / 4)) * 4;
  auto load_stage = [&](int stage) {
    const int k0 = stage * kDepth, buf = stage % kStages;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads, k = k0 + idx % kDepth;
      const bool ok = arow[i] != nullptr && k < H;
      cp_async4(&as[buf][(idx / kDepth) * kLdA + idx % kDepth],
                ok ? arow[i] + k : P.u, ok);
    }
    const bool ok = k0 + kb < H && c0 + cb < C4;
    cp_async16(&bs[buf][kb * kLd + cb],
               ok ? P.u + static_cast<size_t>(k0 + kb) * C4 + c0 + cb : P.u,
               ok);
  };
  const int stages = (H + kDepth - 1) / kDepth;
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < stages) load_stage(st);
    cp_commit();
  }
  float acc[4][4] = {};
  for (int st = 0; st < stages; ++st) {
    cp_wait_ring();   // stage st has landed (this thread's copies)
    __syncthreads();  // ... everyone's; and stage st-1's readers are done
    if (st + kStages - 1 < stages) load_stage(st + kStages - 1);
    cp_commit();
    stage_3xtf32<kLdA, 1>(acc, as[st % kStages], bs[st % kStages], wm, wn,
                          g, t);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + frag_row(wm, g, i), c = c0 + frag_col(wn, t, j, i);
      if (m < M && c < C4)
        P.dxproj[static_cast<size_t>(m) * C4 + c] =
            P.xproj[(m / P.T) * P.sxn + (m % P.T) * P.sxt + c] + acc[j][i];
    }
}

// Shared memory of one sweep CTA, in floats (each part a multiple of 4):
//   mbar u64 [2]                  the two buffers' mbarriers (16 bytes)
//   us  float4 [k_smem][u_ld(units)] U[j, the gate columns of a unit]
//   dzl float4 [units][R]         this CTA's dz of the step
//   rb  float [2][round4(C*units*R)] partial dh_carry from each rank q,
//                                 [q][unit][R]
size_t sweep_smem_bytes(int R, int cluster, int units, int k_smem) {
  return 4 * (4 + 4 * static_cast<size_t>(k_smem) * u_ld(units) +
              4 * static_cast<size_t>(units) * R +
              2 * round4(static_cast<size_t>(cluster) * units * R));
}

// What an owned (row, unit) item reads at step t, loaded a step ahead.
struct StepIn {
  float z[4], c_prev, c, dh;
};

__device__ __forceinline__ StepIn step_in(const SweepParams& P, int n,
                                          int unit, int t) {
  const int H = P.H;
  StepIn s;
  const float* z =
      P.dxproj + (static_cast<size_t>(n) * P.T + t) * 4 * H + unit;
#pragma unroll
  for (int g = 0; g < 4; ++g) s.z[g] = z[g * H];
  s.c_prev = t == 0 ? P.c0[static_cast<size_t>(n) * H + unit]
                    : P.cs[(static_cast<size_t>(t - 1) * P.N + n) * H + unit];
  s.c = P.cs[(static_cast<size_t>(t) * P.N + n) * H + unit];
  s.dh = P.dhs[(static_cast<size_t>(n) * P.T + t) * H + unit];
  return s;
}

// acc[r] += dz[r] . w for the R rows of one unit's dz (four gates); one
// accumulator per row keeps the registers low enough for two CTAs per SM
// (an accumulator per gate took 106 against 80 at R = 4 and cost time)
template <int R>
__device__ __forceinline__ void dot_rows(float (&acc)[R], float4 w,
                                         const float4* dz) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4 d = dz[r];
    float a = acc[r];
    a = fmaf(d.x, w.x, a);
    a = fmaf(d.y, w.y, a);
    a = fmaf(d.z, w.z, a);
    acc[r] = fmaf(d.w, w.w, a);
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    lstm_bwd_sweep(const SweepParams P) {
  extern __shared__ float4 smem4[];
  const int H = P.H, T = P.T, N = P.N, units = P.units, C = P.cluster;
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster_rank());
  const int row0 = static_cast<int>(cluster_index()) * R;
  const int nrows = min(R, N - row0);
  const int unit0 = rank * units;
  const int nunits = max(0, min(units, H - unit0));
  const int four_h = 4 * H;
  const size_t rbs = round4(static_cast<size_t>(C) * units * R);
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(smem4);
  float4* us = smem4 + 1;
  const int lu = u_ld(units);  // float4s per row of us
  float4* dzl = us + static_cast<size_t>(P.k_smem) * lu;
  float* rb = reinterpret_cast<float*>(dzl + static_cast<size_t>(units) * R);

  for (int idx = tid; idx < P.k_smem * lu; idx += kThreads) {
    const int j = idx / lu, uu = idx % lu;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (uu < nunits) {
      const float* col = P.u + static_cast<size_t>(j) * four_h + unit0 + uu;
      w = make_float4(col[0], col[H], col[2 * H], col[3 * H]);
    }
    us[idx] = w;
  }
  for (int idx = tid; idx < units * R; idx += kThreads)
    dzl[idx] = make_float4(0.f, 0.f, 0.f, 0.f);

  // owned (row, unit) items, unit fastest; their carries and dp sums stay
  // in registers, their next step's inputs are loaded one step ahead
  const int owned = nunits * nrows;
  float pp[kMaxOwned][3], dcc[kMaxOwned], dpa[kMaxOwned][3];
  float4 dz_out[kMaxOwned];
  StepIn in[kMaxOwned];
#pragma unroll
  for (int i = 0; i < kMaxOwned; ++i) {
    const int o = tid + i * kThreads;
    if (o < owned) {
      const int n = row0 + o / nunits, unit = unit0 + o % nunits;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        pp[i][g] = P.p[g * H + unit];
        dpa[i][g] = 0.f;
      }
      dcc[i] = P.dcT[static_cast<size_t>(n) * H + unit];
      in[i] = step_in(P, n, unit, T - 1);
    }
  }
  mbar_init(mbar);
  cluster_sync();

  // partials made at step s go to rb[s & 1] and complete mbar[s & 1]: its
  // ((T-1-s)/2)-th use
  const unsigned expect = 4u * C * nunits * R;
  for (int t = T - 1; t >= 0; --t) {
    const float* rin = rb + static_cast<size_t>((t + 1) & 1) * rbs;
    if (t < T - 1) {
      mbar_wait(mbar + ((t + 1) & 1), ((T - 2 - t) >> 1) & 1);
      __syncthreads();  // last step's readers of dzl are done
    }
#pragma unroll
    for (int i = 0; i < kMaxOwned; ++i) {
      const int o = tid + i * kThreads;
      if (o >= owned) continue;
      const int uu = o % nunits, r = o / nunits;
      const int n = row0 + r, unit = unit0 + uu;
      float dhc;
      if (t == T - 1) {
        dhc = P.dhT[static_cast<size_t>(n) * H + unit];
      } else {
        dhc = 0.f;
        for (int q = 0; q < C; ++q)  // rank order: same bits every launch
          dhc += rin[(static_cast<size_t>(q) * units + uu) * R + r];
      }
      const float c_prev = in[i].c_prev, c = in[i].c;
      const float pi = pp[i][0], pf = pp[i][1], po = pp[i][2];
      const float ig = sigmoidf_(in[i].z[0] + pi * c_prev);
      const float fg = sigmoidf_(in[i].z[1] + pf * c_prev);
      const float og = sigmoidf_(in[i].z[2] + po * c);
      const float gg = tanhf(in[i].z[3]);
      const float tc = tanhf(c);
      const float dh = in[i].dh + dhc;
      const float dzo = dh * tc * og * (1.f - og);
      const float dc = dh * og * (1.f - tc * tc) + dcc[i] + dzo * po;
      const float dzi = dc * gg * ig * (1.f - ig);
      const float dzg = dc * ig * (1.f - gg * gg);
      const float dzf = dc * c_prev * fg * (1.f - fg);
      dz_out[i] = make_float4(dzi, dzf, dzo, dzg);
      dzl[uu * R + r] = dz_out[i];
      dcc[i] = dc * fg + dzi * pi + dzf * pf;
      dpa[i][0] = fmaf(dzi, c_prev, dpa[i][0]);
      dpa[i][1] = fmaf(dzf, c_prev, dpa[i][1]);
      dpa[i][2] = fmaf(dzo, c, dpa[i][2]);
    }
    __syncthreads();
    // ---- partial dh_carry[r, j] = sum over this CTA's columns of
    // dz[r, col] U[j, col], for every unit j; sent to j's owner
    float* rout = rb + static_cast<size_t>(t & 1) * rbs;
    if (tid == 0) mbar_expect(mbar + (t & 1), expect);
    for (int j = tid; j < H; j += kThreads) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      if (j < P.k_smem) {
#pragma unroll 4
        for (int uu = 0; uu < nunits; ++uu)
          dot_rows<R>(acc, us[j * lu + uu], dzl + uu * R);
      } else {  // U's row j from L2, unrolled so the loads overlap
        const float* row = P.u + static_cast<size_t>(j) * four_h + unit0;
#pragma unroll 4
        for (int uu = 0; uu < nunits; ++uu)
          dot_rows<R>(acc,
                      make_float4(__ldg(row + uu), __ldg(row + H + uu),
                                  __ldg(row + 2 * H + uu),
                                  __ldg(row + 3 * H + uu)),
                      dzl + uu * R);
      }
      const int q = j / units, jj = j % units;
      float* dst = rout + (static_cast<size_t>(rank) * units + jj) * R;
      const unsigned qbar = peer_addr(mbar + (t & 1), q);
      if constexpr (R >= 4) {
#pragma unroll
        for (int r = 0; r < R; r += 4)
          st_async4(peer_addr(dst + r, q),
                    make_float4(acc[r], acc[r + 1], acc[r + 2], acc[r + 3]),
                    qbar);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r)
          st_async(peer_addr(dst + r, q), acc[r], qbar);
      }
    }
    // off the path: the step's dz to device memory, the next step's loads
#pragma unroll
    for (int i = 0; i < kMaxOwned; ++i) {
      const int o = tid + i * kThreads;
      if (o >= owned) continue;
      const int n = row0 + o / nunits, unit = unit0 + o % nunits;
      float* dx = P.dxproj + (static_cast<size_t>(n) * T + t) * four_h + unit;
      dx[0] = dz_out[i].x;
      dx[H] = dz_out[i].y;
      dx[2 * H] = dz_out[i].z;
      dx[3 * H] = dz_out[i].w;
      if (t > 0) in[i] = step_in(P, n, unit, t - 1);
    }
  }

  // dh0 from step 0's partials; dc0; each row's dp sums
  mbar_wait(mbar, ((T - 1) >> 1) & 1);
#pragma unroll
  for (int i = 0; i < kMaxOwned; ++i) {
    const int o = tid + i * kThreads;
    if (o >= owned) continue;
    const int uu = o % nunits, r = o / nunits;
    const int n = row0 + r, unit = unit0 + uu;
    float dhc = 0.f;
    for (int q = 0; q < C; ++q)
      dhc += rb[(static_cast<size_t>(q) * units + uu) * R + r];
    P.dh0[static_cast<size_t>(n) * H + unit] = dhc;
    P.dc0[static_cast<size_t>(n) * H + unit] = dcc[i];
#pragma unroll
    for (int g = 0; g < 3; ++g)
      P.dpp[(static_cast<size_t>(n) * 3 + g) * H + unit] = dpa[i][g];
  }
  cluster_sync();
}

// dU[k, c] = sum over the split's rows m of h_prev[m, k] dz[m, c] for a
// 64 x 64 tile, rows in order (A is h_prev read transposed).
__global__ void __launch_bounds__(kThreads) lstm_bwd_du(const GemmParams P) {
  __shared__ __align__(16) float as[kStages][kDepth * kLd];  // [m][k]
  __shared__ __align__(16) float bs[kStages][kDepth * kLd];  // [m][c]
  const int H = P.H, C4 = 4 * H;
  const int k0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int mb = blockIdx.z * P.chunk, me = min(P.N * P.T, mb + P.chunk);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2, g = lane / 4, t = lane % 4;
  // this thread's four A elements keep their column k; their rows m
  // advance by kDepth a stage, tracked as (n, t) without dividing
  const int ka = k0 + tid % kTile;
  int an[4], at[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = mb + (tid + i * kThreads) / kTile;
    an[i] = m / P.T;
    at[i] = m % P.T;
  }
  const int mbr = tid / (kTile / 4), cb = (tid % (kTile / 4)) * 4;
  auto load_stage = [&](int stage) {
    const int m0 = mb + stage * kDepth, buf = stage % kStages;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads;
      const bool ok = m0 + idx / kTile < me && ka < H;
      const float* src =
          at[i] == 0 ? P.h0 + static_cast<size_t>(an[i]) * H + ka
                     : P.hs + (static_cast<size_t>(an[i]) * P.T + at[i] - 1) *
                                  H + ka;
      cp_async4(&as[buf][(idx / kTile) * kLd + idx % kTile], ok ? src : P.hs,
                ok);
      for (at[i] += kDepth; at[i] >= P.T; at[i] -= P.T) ++an[i];
    }
    const int m = m0 + mbr;
    const bool ok = m < me && c0 + cb < C4;
    cp_async16(&bs[buf][mbr * kLd + cb],
               ok ? P.dxproj + static_cast<size_t>(m) * C4 + c0 + cb
                  : P.dxproj,
               ok);
  };
  const int stages = (me - mb + kDepth - 1) / kDepth;
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < stages) load_stage(st);
    cp_commit();
  }
  float acc[4][4] = {};
  for (int st = 0; st < stages; ++st) {
    cp_wait_ring();
    __syncthreads();
    if (st + kStages - 1 < stages) load_stage(st + kStages - 1);
    cp_commit();
    stage_3xtf32<1, kLd>(acc, as[st % kStages], bs[st % kStages], wm, wn, g,
                         t);
  }
  float* out = P.ws != nullptr
                   ? P.ws + static_cast<size_t>(blockIdx.z) * H * C4
                   : P.du;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + frag_row(wm, g, i), c = c0 + frag_col(wn, t, j, i);
      if (k < H && c < C4) out[static_cast<size_t>(k) * C4 + c] = acc[j][i];
    }
}

// dU from the splits' slices, in split order (when there is more than
// one), and dp from the rows' sums, in row order.
__global__ void __launch_bounds__(kThreads)
    lstm_bwd_finish(const FinishParams P) {
  const size_t n_du = P.splits > 1 ? static_cast<size_t>(P.H) * 4 * P.H : 0;
  const size_t total = n_du + 3 * static_cast<size_t>(P.H);
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * kThreads) {
    if (i < n_du) {
      float s = 0.f;
      for (int q = 0; q < P.splits; ++q) s += P.ws[q * n_du + i];
      P.du[i] = s;
    } else {
      const size_t gj = i - n_du;  // g * H + j
      const size_t g = gj / P.H, j = gj % P.H;
      float s = 0.f;
      for (int n = 0; n < P.N; ++n)
        s += P.dpp[(static_cast<size_t>(n) * 3 + g) * P.H + j];
      P.dp[gj] = s;
    }
  }
}

using Sweep = void (*)(const SweepParams);

Sweep sweep_kernel(int rows) {
  switch (rows) {
    case 1: return lstm_bwd_sweep<1>;
    case 2: return lstm_bwd_sweep<2>;
    case 4: return lstm_bwd_sweep<4>;
    case 8: return lstm_bwd_sweep<8>;
    case 16: return lstm_bwd_sweep<16>;
    default: return nullptr;
  }
}

}  // namespace

// How many clusters of this plan's sweep the card runs at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
extern "C" int lstm_scan_bwd_clusters(int rows, int cluster, int smem,
                                      int device) {
  if (cudaSetDevice(device) != cudaSuccess || sweep_kernel(rows) == nullptr)
    return -static_cast<int>(cudaErrorInvalidValue);
  SweepParams P = {};
  int capacity = 0;
  const int err = cluster_launch(sweep_kernel(rows), P, 1, cluster,
                                 static_cast<size_t>(smem), nullptr,
                                 &capacity);
  return err != 0 ? -err : capacity;
}

// Returns the CUDA error of the first failing launch (0 = success); a plan
// the kernels do not take returns cudaErrorInvalidValue without
// launching. The wrapper raises on any nonzero code. `ws` holds
// du_splits * H * 4H floats when du_splits > 1 (unused otherwise); `dpp`
// N * 3 * H floats.
extern "C" int lstm_scan_bwd(const void* xproj, long long sxn, long long sxt,
                             const void* u, const void* p, const void* h0,
                             const void* c0, const void* cs, const void* hs,
                             const void* dhs, const void* dhT,
                             const void* dcT, void* dxproj, void* du,
                             void* dp, void* dh0, void* dc0, void* ws,
                             void* dpp, int N, int T, int H, int rows,
                             int cluster, int units, int k_smem, int smem,
                             int du_splits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N <= 0 || T <= 0 || H <= 0 || sweep_kernel(rows) == nullptr ||
      (cluster != 8 && cluster != 16) || units <= 0 ||
      units * cluster < H || rows * units > kMaxOwned * kThreads ||
      k_smem < 0 || k_smem > H || du_splits < 1 ||
      sweep_smem_bytes(rows, cluster, units, k_smem) !=
          static_cast<size_t>(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = N * T;
  GemmParams G;
  G.xproj = static_cast<const float*>(xproj);
  G.sxn = sxn;
  G.sxt = sxt;
  G.u = static_cast<const float*>(u);
  G.h0 = static_cast<const float*>(h0);
  G.hs = static_cast<const float*>(hs);
  G.dxproj = static_cast<float*>(dxproj);
  G.du = static_cast<float*>(du);
  G.N = N;
  G.T = T;
  G.H = H;
  const int rows_per_split = (M + du_splits - 1) / du_splits;
  G.chunk = (rows_per_split + kDepth - 1) / kDepth * kDepth;
  const int splits = (M + G.chunk - 1) / G.chunk;  // ranges holding rows
  G.ws = splits > 1 ? static_cast<float*>(ws) : nullptr;
  const int col_tiles = (4 * H + kTile - 1) / kTile;
  lstm_bwd_gates<<<dim3(col_tiles, (M + kTile - 1) / kTile), kThreads, 0,
                   st>>>(G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  SweepParams S;
  S.dxproj = static_cast<float*>(dxproj);
  S.u = G.u;
  S.p = static_cast<const float*>(p);
  S.c0 = static_cast<const float*>(c0);
  S.cs = static_cast<const float*>(cs);
  S.dhs = static_cast<const float*>(dhs);
  S.dhT = static_cast<const float*>(dhT);
  S.dcT = static_cast<const float*>(dcT);
  S.dh0 = static_cast<float*>(dh0);
  S.dc0 = static_cast<float*>(dc0);
  S.dpp = static_cast<float*>(dpp);
  S.N = N;
  S.T = T;
  S.H = H;
  S.units = units;
  S.k_smem = k_smem;
  S.cluster = cluster;
  int rc = cluster_launch(sweep_kernel(rows), S, (N + rows - 1) / rows,
                          cluster, static_cast<size_t>(smem), st, nullptr);
  if (rc == 0) rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  lstm_bwd_du<<<dim3(col_tiles, (H + kTile - 1) / kTile, splits), kThreads,
                0, st>>>(G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  FinishParams F;
  F.du = G.du;
  F.ws = static_cast<const float*>(ws);
  F.dpp = S.dpp;
  F.dp = static_cast<float*>(dp);
  F.N = N;
  F.H = H;
  F.splits = splits;
  const size_t total = (F.splits > 1 ? static_cast<size_t>(H) * 4 * H : 0) +
                       3 * static_cast<size_t>(H);
  const int blocks =
      static_cast<int>(std::min<size_t>((total + kThreads - 1) / kThreads,
                                        1024));
  lstm_bwd_finish<<<blocks, kThreads, 0, st>>>(F);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
