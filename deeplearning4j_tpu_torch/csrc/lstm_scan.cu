// Fused Graves peephole-LSTM forward scan, written by hand for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// deeplearning4j_tpu_torch/ops/lstm_scan.py.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py, _lstm_pallas_fwd_raw
// (kernel body _make_lstm_kernel), reached through lstm_pallas_scan.
//
// Function, gates [i, f, o, g] along the 4H axis, all f32:
//   z_t = xproj[:, t] + h_{t-1} U                       [N, 4H]
//   i = sigmoid(z_i + p0 * c_{t-1})   f = sigmoid(z_f + p1 * c_{t-1})
//   g = tanh(z_g)                     c_t = f * c_{t-1} + i * g
//   o = sigmoid(z_o + p2 * c_t)       h_t = o * tanh(c_t)
// Outputs hs [N,T,H], h_T [N,H], c_T [N,H] and, with emit_cs, the cell
// sequence cs [T,N,H] that the backward kernel (K2) reads.
//
// What bounds it on the H100: the recurrence. Every step needs the whole
// h_{t-1} of every hidden unit, so the T steps run one after the other;
// across the card the work is 2*N*T*H*4H flops (operations bound 2.05
// GFLOP / 67 TFLOP/s = 30 us at the char-RNN's N=64, T=100, H=200), but
// each step also pays one grid-wide exchange of h, which sets a floor of
// T barrier latencies.
//
// What the design does about it:
//  * U (16*H^2 bytes: 640 KB at H=200) does not fit one SM's 227 KB of
//    shared memory, so the TPU design (U whole in VMEM) cannot carry over.
//    The grid is persistent and cooperative: CTA j owns `upb` hidden units
//    (all four gate columns of each) and keeps its U[:, those columns]
//    slice (H*upb*16 bytes) in shared memory for the whole sequence. upb
//    is the smallest power of two that fits the grid on the card's SMs
//    (upb=2 -> 100 CTAs at H=200), so every CTA is co-resident.
//  * The cell state of a unit depends only on that unit, so c never
//    leaves its owning CTA (a per-CTA slice of a scratch buffer, written
//    and read by the same thread). Only h is exchanged: each step writes
//    h_t to one of two global buffers (k-major [H][N], L2-resident) and
//    reads h_{t-1} from the other, then one grid barrier (an atomic
//    arrival counter) separates the steps. Double buffering makes the
//    next step's writes safe against this step's readers. h is read and
//    written with __ldcg/__stcg (L2 only): an L1 line of the buffer from
//    two steps back would be stale.
//  * The per-step product h_{t-1} U is done here with FMAs, no library
//    call: h_{t-1} streams through shared memory in [64 k][64 rows]
//    tiles, each (row, unit) pair accumulates its four gate dots from a
//    float4 of U, and `ks` threads split a pair's k range (summed with
//    warp shuffles) when the batch is too small to give every thread a
//    pair. The tile's row pitch is padded so those reads hit distinct
//    banks.
//  * xproj [N,T,4H] is read through its strides: no time-major copy (the
//    TPU kernel's swapaxes served its (8,128) tiling). h0 and c0 are read
//    directly at t = 0.
// Not done yet (later work): thread-block clusters with U in distributed
// shared memory and a cluster barrier in place of the grid barrier;
// TF32/bf16 tensor-core products.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kKT = 64;  // k rows of h per shared-memory tile
constexpr int kNR = 64;  // batch rows per round
constexpr int kPT = 2;   // (row, unit) pairs per thread per round, at most

struct Params {
  const float* xproj;
  long long sxn, sxt;  // element strides of xproj's N and T axes
  const float* u;      // [H, 4H]
  const float* p;      // [3, H]
  const float* h0;     // [N, H]
  const float* c0;     // [N, H]
  float* hbuf;         // [2][H][N] exchange buffers
  float* cbuf;         // [H][N] cell state, owner-private
  float* hs;           // [N, T, H]
  float* hT;           // [N, H]
  float* cT;           // [N, H]
  float* cs;           // [T, N, H] or null
  unsigned int* counter;  // grid-barrier arrivals, zero at launch
  int N, T, H, upb, ks, nrp;
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

__global__ void __launch_bounds__(kThreads)
    lstm_scan_kernel(const Params P) {
  extern __shared__ float4 smem4[];
  const int H = P.H, N = P.N, T = P.T, upb = P.upb, ks = P.ks;
  const int tid = threadIdx.x;
  const int unit0 = blockIdx.x * upb;
  float4* us = smem4;                                      // [H][upb]
  float* ht = reinterpret_cast<float*>(smem4 + H * upb);   // [kKT][nrp]

  // this CTA's slice of U: for unit u, the float4 of its i, f, o, g columns
  for (int idx = tid; idx < H * upb; idx += kThreads) {
    const int k = idx / upb;
    const int unit = unit0 + idx % upb;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (unit < H) {
      const float* row = P.u + static_cast<size_t>(k) * 4 * H + unit;
      w = make_float4(row[0], row[H], row[2 * H], row[3 * H]);
    }
    us[idx] = w;
  }
  __syncthreads();

  const int s = tid % ks;             // this thread's share of a pair's k
  const int slot = tid / ks;
  const int slots = kThreads / ks;
  const size_t hn = static_cast<size_t>(H) * N;

  for (int t = 0; t < T; ++t) {
    const float* hin = P.hbuf + static_cast<size_t>(t & 1) * hn;
    float* hout = P.hbuf + static_cast<size_t>((t + 1) & 1) * hn;
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
          const int kk = idx / nr;
          const int nn = idx % nr;
          ht[kk * P.nrp + nn] =
              t == 0 ? P.h0[static_cast<size_t>(n0 + nn) * H + k0 + kk]
                     : __ldcg(hin + static_cast<size_t>(k0 + kk) * N + n0 +
                              nn);
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
      // sum the ks partial dots of each pair (ks consecutive lanes)
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
          const float c_prev = t == 0 ? P.c0[nh] : P.cbuf[own];
          const float ig = sigmoidf_(acc[i][0] + xp[0] + P.p[unit] * c_prev);
          const float fg =
              sigmoidf_(acc[i][1] + xp[H] + P.p[H + unit] * c_prev);
          const float gg = tanhf(acc[i][3] + xp[3 * H]);
          const float c = fg * c_prev + ig * gg;
          const float og =
              sigmoidf_(acc[i][2] + xp[2 * H] + P.p[2 * H + unit] * c);
          const float h = og * tanhf(c);
          P.cbuf[own] = c;
          __stcg(hout + own, h);
          P.hs[(static_cast<size_t>(n) * T + t) * H + unit] = h;
          if (P.cs != nullptr)
            P.cs[(static_cast<size_t>(t) * N + n) * H + unit] = c;
          if (t == T - 1) {
            P.hT[nh] = h;
            P.cT[nh] = c;
          }
        }
      }
    }
    if (t + 1 < T) grid_barrier(P.counter, gridDim.x * (t + 1));
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
extern "C" int lstm_scan_fwd(const void* xproj, long long sxn, long long sxt,
                             const void* u, const void* p, const void* h0,
                             const void* c0, void* hbuf, void* cbuf, void* hs,
                             void* hT, void* cT, void* cs, void* counter,
                             int N, int T, int H, int upb, int device,
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
  P.hbuf = static_cast<float*>(hbuf);
  P.cbuf = static_cast<float*>(cbuf);
  P.hs = static_cast<float*>(hs);
  P.hT = static_cast<float*>(hT);
  P.cT = static_cast<float*>(cT);
  P.cs = static_cast<float*>(cs);
  P.counter = static_cast<unsigned int*>(counter);
  P.N = N;
  P.T = T;
  P.H = H;
  P.upb = upb;
  const int pairs = std::min(N, kNR) * upb;  // pairs in a full round
  P.ks = std::max(1, std::min(8, pow2_floor(std::max(1, kThreads / pairs))));
  P.nrp = kNR + 32 / P.ks;
  const int grid = (H + upb - 1) / upb;
  const size_t smem = static_cast<size_t>(H) * upb * sizeof(float4) +
                      static_cast<size_t>(kKT) * P.nrp * sizeof(float);
  err = cudaFuncSetAttribute(lstm_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      lstm_scan_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long long>(per_sm) * sms < grid)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lstm_scan_kernel), dim3(grid),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
