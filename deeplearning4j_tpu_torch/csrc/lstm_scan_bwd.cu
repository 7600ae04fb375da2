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
// 1.54 GFLOP at the char-RNN's training window N=32, T=50, H=200, 23 us at
// 67 TFLOP/s f32), but dh_carry of step t needs dz of every hidden unit
// from step t+1, so the T steps run one after the other, each paying one
// grid-wide exchange.
//
// What the design does about it:
//  * The same persistent cooperative grid as K1: CTA j owns `upb` hidden
//    units, all four gate columns of each, and every CTA is resident (the
//    launch is refused, not shrunk, when the grid cannot be). It keeps two
//    slices of U in shared memory for the whole sweep: U[:, its columns]
//    for the gate recompute and U[its units' rows, :] for dh_carry.
//  * The gate recompute needs no exchange: h_prev of every step is in hs,
//    c_prev and c are in cs (K1's emit_cs output). The TPU wrapper's
//    shifted hprev/cprev copies are not built: step 0 reads h0 and c0.
//  * One exchange per step: each CTA writes dz of its units (a float4 of
//    the four gates per (unit, row)) to a double-buffered L2 buffer
//    [2][H][N] with __stcg, one grid barrier (an arrival counter that only
//    grows), then each CTA reduces dh_carry for its own units over all 4H
//    columns, reading the buffer with __ldcg. dc_carry never leaves its
//    unit (an owner-private scratch slice).
//  * dU and dp need no atomics and are off the sequential path: CTA j
//    owns dU[:, its columns] and dp[:, its units], and computes them after
//    the sweep from the dz columns it wrote itself (dxproj) and hs/cs, in
//    a fixed order. Two launches give the same bits.
// Not done yet (later work): tensor-core products, prefetching the next
// step's gate recompute before the barrier, clusters with U in
// distributed shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kKT = 64;   // k rows of h_prev per shared-memory tile
constexpr int kKT4 = 32;  // k rows of dz (float4) per shared-memory tile
constexpr int kNR = 64;   // batch rows per round
constexpr int kPT = 2;    // (row, unit) pairs per thread per round, at most
constexpr int kRows = 64; // (n, t) rows per tile of the dU pass
constexpr int kWarps = kThreads / 32;

struct Params {
  const float* xproj;
  long long sxn, sxt;  // element strides of xproj's N and T axes
  const float* u;      // [H, 4H]
  const float* p;      // [3, H]
  const float* h0;     // [N, H]
  const float* c0;     // [N, H]
  const float* cs;     // [T, N, H]
  const float* hs;     // [N, T, H]
  const float* dhs;    // [N, T, H]
  const float* dhT;    // [N, H]
  const float* dcT;    // [N, H]
  float* dxproj;       // [N, T, 4H]
  float* du;           // [H, 4H]
  float* dp;           // [3, H]
  float* dh0;          // [N, H]
  float* dc0;          // [N, H]
  float4* dzbuf;       // [2][H][N] exchange buffers
  float* dhc;          // [H][N] dh_carry, written after each exchange
  float* dcc;          // [H][N] dc_carry, owner-private
  unsigned int* counter;  // grid-barrier arrivals, zero at launch
  int N, T, H, upb, ks, nrp, nrp4;
};

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

// All CTAs are co-resident (cooperative launch), so spinning is safe.
// Arrivals only grow: barrier number b waits for nblocks * b of them.
__device__ __forceinline__ void grid_barrier(unsigned int* counter,
                                             unsigned int target) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(counter, 1u);
    volatile unsigned int* c = counter;
    while (*c < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__global__ void __launch_bounds__(kThreads)
    lstm_scan_bwd_kernel(const Params P) {
  extern __shared__ float4 smem4[];
  const int H = P.H, N = P.N, T = P.T, upb = P.upb, ks = P.ks;
  const int tid = threadIdx.x;
  const int unit0 = blockIdx.x * upb;
  float4* us = smem4;               // [H][upb] U[k, gate columns of unit]
  float4* ur = smem4 + H * upb;     // [H][upb] U[unit, gate columns of k]
  float4* tile4 = ur + H * upb;     // tile region, reused by every phase
  float* ht = reinterpret_cast<float*>(tile4);  // [kKT][nrp] h_prev

  for (int idx = tid; idx < H * upb; idx += kThreads) {
    const int k = idx / upb;
    const int unit = unit0 + idx % upb;
    float4 wc = make_float4(0.f, 0.f, 0.f, 0.f), wr = wc;
    if (unit < H) {
      const float* col = P.u + static_cast<size_t>(k) * 4 * H + unit;
      wc = make_float4(col[0], col[H], col[2 * H], col[3 * H]);
      const float* row = P.u + static_cast<size_t>(unit) * 4 * H + k;
      wr = make_float4(row[0], row[H], row[2 * H], row[3 * H]);
    }
    us[idx] = wc;
    ur[idx] = wr;
  }
  __syncthreads();

  const int s = tid % ks;  // this thread's share of a pair's k range
  const int slot = tid / ks;
  const int slots = kThreads / ks;
  const size_t hn = static_cast<size_t>(H) * N;
  const int four_h = 4 * H;

  for (int t = T - 1; t >= 0; --t) {
    float4* zout = P.dzbuf + static_cast<size_t>(t & 1) * hn;
    // ---- phase 1: recompute the gates, form dz, write it out ----------
    for (int n0 = 0; n0 < N; n0 += kNR) {
      const int nr = min(kNR, N - n0);
      const int npairs = nr * upb;
      float acc[kPT][4];
#pragma unroll
      for (int i = 0; i < kPT; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[i][g] = 0.f;
      for (int k0 = 0; k0 < H; k0 += kKT) {
        const int kt = min(kKT, H - k0);
        __syncthreads();  // the previous tile's readers are done
        for (int idx = tid; idx < kt * nr; idx += kThreads) {
          const int kk = idx % kt;  // k fastest: hs rows are contiguous
          const int nn = idx / kt;
          const int n = n0 + nn;
          ht[kk * P.nrp + nn] =
              t == 0 ? P.h0[static_cast<size_t>(n) * H + k0 + kk]
                     : P.hs[(static_cast<size_t>(n) * T + t - 1) * H + k0 +
                            kk];
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kPT; ++i) {
          const int pair = slot + i * slots;
          if (pair < npairs) {
            const int nl = pair / upb;
            const int uu = pair % upb;
            float a0 = acc[i][0], a1 = acc[i][1], a2 = acc[i][2],
                  a3 = acc[i][3];
            for (int kk = s; kk < kt; kk += ks) {
              const float hv = ht[kk * P.nrp + nl];
              const float4 w = us[(k0 + kk) * upb + uu];
              a0 = fmaf(hv, w.x, a0);
              a1 = fmaf(hv, w.y, a1);
              a2 = fmaf(hv, w.z, a2);
              a3 = fmaf(hv, w.w, a3);
            }
            acc[i][0] = a0;
            acc[i][1] = a1;
            acc[i][2] = a2;
            acc[i][3] = a3;
          }
        }
      }
      for (int off = ks >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < kPT; ++i)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            acc[i][g] += __shfl_xor_sync(0xffffffffu, acc[i][g], off);
      }
      if (s == 0) {
#pragma unroll
        for (int i = 0; i < kPT; ++i) {
          const int pair = slot + i * slots;
          if (pair >= npairs) continue;
          const int n = n0 + pair / upb;
          const int unit = unit0 + pair % upb;
          if (unit >= H) continue;
          const float* xp = P.xproj + n * P.sxn + t * P.sxt + unit;
          const size_t own = static_cast<size_t>(unit) * N + n;
          const size_t nh = static_cast<size_t>(n) * H + unit;
          const float c_prev =
              t == 0 ? P.c0[nh]
                     : P.cs[(static_cast<size_t>(t - 1) * N + n) * H + unit];
          const float c = P.cs[(static_cast<size_t>(t) * N + n) * H + unit];
          const float pi = P.p[unit], pf = P.p[H + unit],
                      po = P.p[2 * H + unit];
          const float ig = sigmoidf_(acc[i][0] + xp[0] + pi * c_prev);
          const float fg = sigmoidf_(acc[i][1] + xp[H] + pf * c_prev);
          const float og = sigmoidf_(acc[i][2] + xp[2 * H] + po * c);
          const float gg = tanhf(acc[i][3] + xp[3 * H]);
          const float tc = tanhf(c);
          const float dh =
              P.dhs[(static_cast<size_t>(n) * T + t) * H + unit] +
              (t == T - 1 ? P.dhT[nh] : P.dhc[own]);
          const float dc_in = t == T - 1 ? P.dcT[nh] : P.dcc[own];
          const float dzo = dh * tc * og * (1.f - og);
          const float dc = dh * og * (1.f - tc * tc) + dc_in + dzo * po;
          const float dzi = dc * gg * ig * (1.f - ig);
          const float dzg = dc * ig * (1.f - gg * gg);
          const float dzf = dc * c_prev * fg * (1.f - fg);
          float* dx = P.dxproj + (static_cast<size_t>(n) * T + t) * four_h +
                      unit;
          dx[0] = dzi;
          dx[H] = dzf;
          dx[2 * H] = dzo;
          dx[3 * H] = dzg;
          __stcg(zout + own, make_float4(dzi, dzf, dzo, dzg));
          const float dc_out = dc * fg + dzi * pi + dzf * pf;
          if (t == 0)
            P.dc0[nh] = dc_out;
          else
            P.dcc[own] = dc_out;
        }
      }
    }
    grid_barrier(P.counter, gridDim.x * static_cast<unsigned int>(T - t));
    // ---- phase 2: dh_carry of this CTA's units = dz U^T ---------------
    for (int n0 = 0; n0 < N; n0 += kNR) {
      const int nr = min(kNR, N - n0);
      const int npairs = nr * upb;
      float acc[kPT];
#pragma unroll
      for (int i = 0; i < kPT; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < H; k0 += kKT4) {
        const int kt = min(kKT4, H - k0);
        __syncthreads();
        for (int idx = tid; idx < kt * nr; idx += kThreads) {
          const int kk = idx / nr;  // n fastest: the buffer is [k][n]
          const int nn = idx % nr;
          tile4[kk * P.nrp4 + nn] =
              __ldcg(zout + static_cast<size_t>(k0 + kk) * N + n0 + nn);
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kPT; ++i) {
          const int pair = slot + i * slots;
          if (pair < npairs) {
            const int nl = pair / upb;
            const int uu = pair % upb;
            float a = acc[i];
            for (int kk = s; kk < kt; kk += ks)
              a = dot4(tile4[kk * P.nrp4 + nl], ur[(k0 + kk) * upb + uu], a);
            acc[i] = a;
          }
        }
      }
      for (int off = ks >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < kPT; ++i)
          acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
      }
      if (s == 0) {
#pragma unroll
        for (int i = 0; i < kPT; ++i) {
          const int pair = slot + i * slots;
          if (pair >= npairs) continue;
          const int n = n0 + pair / upb;
          const int unit = unit0 + pair % upb;
          if (unit >= H) continue;
          if (t == 0)
            P.dh0[static_cast<size_t>(n) * H + unit] = acc[i];
          else
            P.dhc[static_cast<size_t>(unit) * N + n] = acc[i];
        }
      }
    }
  }

  // ---- dU[:, this CTA's columns] = sum over rows of h_prev^T dz --------
  // Row r = n*T + t of the flattened [N*T] axis; its h_prev is row r-1 of
  // hs (h0[n] at t = 0). Each thread owns one (unit, k) item per pass and
  // sums its four gate columns over the rows in order.
  __syncthreads();  // this CTA's dxproj writes are visible to all its threads
  const int rows_total = N * T;
  float4* dzr = tile4;  // [kRows][upb]
  for (int base = 0; base < H * upb; base += kThreads) {
    const int item = base + tid;
    const int uu = item / H;
    const int k = item % H;
    const bool active = item < H * upb && unit0 + uu < H;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r0 = 0; r0 < rows_total; r0 += kRows) {
      const int rows = min(kRows, rows_total - r0);
      __syncthreads();
      for (int idx = tid; idx < rows * upb; idx += kThreads) {
        const int unit = unit0 + idx % upb;
        float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
        if (unit < H) {
          const float* dx = P.dxproj +
                            static_cast<size_t>(r0 + idx / upb) * four_h +
                            unit;
          d = make_float4(dx[0], dx[H], dx[2 * H], dx[3 * H]);
        }
        dzr[idx] = d;
      }
      __syncthreads();
      if (active) {
        int n = r0 / T, t = r0 % T;
        for (int rr = 0; rr < rows; ++rr) {
          const float hv =
              t == 0 ? P.h0[static_cast<size_t>(n) * H + k]
                     : P.hs[static_cast<size_t>(r0 + rr - 1) * H + k];
          const float4 d = dzr[rr * upb + uu];
          acc.x = fmaf(hv, d.x, acc.x);
          acc.y = fmaf(hv, d.y, acc.y);
          acc.z = fmaf(hv, d.z, acc.z);
          acc.w = fmaf(hv, d.w, acc.w);
          if (++t == T) {
            t = 0;
            ++n;
          }
        }
      }
    }
    if (active) {
      float* out = P.du + static_cast<size_t>(k) * four_h + unit0 + uu;
      out[0] = acc.x;
      out[H] = acc.y;
      out[2 * H] = acc.z;
      out[3 * H] = acc.w;
    }
  }

  // ---- dp[:, this CTA's units]: strided partial sums, then a fixed-order
  // warp and block reduction -----------------------------------------------
  float* red = reinterpret_cast<float*>(tile4);  // [3][kWarps]
  for (int uu = 0; uu < upb; ++uu) {
    const int unit = unit0 + uu;
    if (unit >= H) break;  // uniform across the block
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int r = tid; r < rows_total; r += kThreads) {
      const int n = r / T, t = r % T;
      const float* dx = P.dxproj + static_cast<size_t>(r) * four_h + unit;
      const float c_prev =
          t == 0 ? P.c0[static_cast<size_t>(n) * H + unit]
                 : P.cs[(static_cast<size_t>(t - 1) * N + n) * H + unit];
      const float c = P.cs[(static_cast<size_t>(t) * N + n) * H + unit];
      a0 = fmaf(dx[0], c_prev, a0);
      a1 = fmaf(dx[H], c_prev, a1);
      a2 = fmaf(dx[2 * H], c, a2);
    }
    for (int off = 16; off > 0; off >>= 1) {
      a0 += __shfl_xor_sync(0xffffffffu, a0, off);
      a1 += __shfl_xor_sync(0xffffffffu, a1, off);
      a2 += __shfl_xor_sync(0xffffffffu, a2, off);
    }
    __syncthreads();  // earlier readers of the tile region are done
    if (tid % 32 == 0) {
      red[tid / 32] = a0;
      red[kWarps + tid / 32] = a1;
      red[2 * kWarps + tid / 32] = a2;
    }
    __syncthreads();
    if (tid < 3) {
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += red[tid * kWarps + w];
      P.dp[tid * H + unit] = sum;
    }
  }
}

int pow2_floor(int x) {
  int p = 1;
  while (p * 2 <= x) p *= 2;
  return p;
}

}  // namespace

// Returns the CUDA error of the launch (0 = success). A grid that cannot be
// co-resident returns cudaErrorCooperativeLaunchTooLarge without launching;
// the wrapper raises on any nonzero code.
extern "C" int lstm_scan_bwd(const void* xproj, long long sxn, long long sxt,
                             const void* u, const void* p, const void* h0,
                             const void* c0, const void* cs, const void* hs,
                             const void* dhs, const void* dhT,
                             const void* dcT, void* dxproj, void* du,
                             void* dp, void* dh0, void* dc0, void* dzbuf,
                             void* dhc, void* dcc, void* counter, int N,
                             int T, int H, int upb, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N <= 0 || T <= 0 || H <= 0 || upb <= 0 || upb > 8 || (upb & (upb - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P;
  P.xproj = static_cast<const float*>(xproj);
  P.sxn = sxn;
  P.sxt = sxt;
  P.u = static_cast<const float*>(u);
  P.p = static_cast<const float*>(p);
  P.h0 = static_cast<const float*>(h0);
  P.c0 = static_cast<const float*>(c0);
  P.cs = static_cast<const float*>(cs);
  P.hs = static_cast<const float*>(hs);
  P.dhs = static_cast<const float*>(dhs);
  P.dhT = static_cast<const float*>(dhT);
  P.dcT = static_cast<const float*>(dcT);
  P.dxproj = static_cast<float*>(dxproj);
  P.du = static_cast<float*>(du);
  P.dp = static_cast<float*>(dp);
  P.dh0 = static_cast<float*>(dh0);
  P.dc0 = static_cast<float*>(dc0);
  P.dzbuf = static_cast<float4*>(dzbuf);
  P.dhc = static_cast<float*>(dhc);
  P.dcc = static_cast<float*>(dcc);
  P.counter = static_cast<unsigned int*>(counter);
  P.N = N;
  P.T = T;
  P.H = H;
  P.upb = upb;
  const int pairs = std::min(N, kNR) * upb;  // pairs in a full round
  P.ks = std::max(1, std::min(8, pow2_floor(std::max(1, kThreads / pairs))));
  P.nrp = kNR + 32 / P.ks;
  P.nrp4 = kNR + 8 / P.ks;
  const int grid = (H + upb - 1) / upb;
  const size_t tile = std::max({
      static_cast<size_t>(kKT) * P.nrp * sizeof(float),
      static_cast<size_t>(kKT4) * P.nrp4 * sizeof(float4),
      static_cast<size_t>(kRows) * upb * sizeof(float4)});
  const size_t smem = 2 * static_cast<size_t>(H) * upb * sizeof(float4) + tile;
  err = cudaFuncSetAttribute(lstm_scan_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lstm_scan_bwd_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long long>(per_sm) * sms < grid)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lstm_scan_bwd_kernel), dim3(grid),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
