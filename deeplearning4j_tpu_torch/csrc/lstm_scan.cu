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
// What bounds it on the H100: the recurrence. Each step needs the whole
// h_{t-1} of its batch row, so the T steps of a row run one after the
// other. The work is 2*N*T*H*4H flops (2.05 GFLOP at the char-RNN's N=64,
// T=100, H=200: 12.4 us at the 3xTF32 rate), far below what the T
// dependent steps cost: the time is T times the latency of one step.
//
// What the design does about it (the latency of a step):
//  * Batch rows never depend on each other, only the hidden units of one
//    row do. The grid is one thread-block cluster per block of R batch
//    rows (R from the planner, ops/lstm_scan.py plan_scan: a power of two
//    up to 16 that puts every row block on the card at once; N=1 is one
//    cluster). The cluster's C CTAs (16, non-portable, where the card
//    schedules it, else 8) split the hidden units: CTA q owns `units`
//    consecutive units, all four gate columns of each. Clusters share
//    nothing: no cooperative launch, no grid-wide barrier.
//  * U stays in shared memory: each CTA keeps U[:, its columns] as one
//    float4 per (k, unit) (16*H*units bytes: 41.6 KB at H=200, C=16) for
//    the whole sequence. Where the slice does not fit (H=1000, H=512 with
//    16-row blocks) the planner keeps its first k_smem rows there and the
//    CTA reads the rest from L2 (__ldg) each step.
//  * h crosses between CTAs through distributed shared memory only: each
//    CTA holds the row block's whole h_{t-1} in a double-buffered tile
//    [2][H][R]; after the cell update it stores its units' h_t into the
//    other buffer of every CTA of the cluster (st.async, float4 where
//    R >= 4), each store completing its bytes on that buffer's mbarrier
//    in the receiver, which waits for H*R*4 bytes before its next step
//    (csrc/lstm_cluster.cuh). A CTA can only send h_{t+1} after it has
//    h_t from every peer, and each peer sent h_t after reading h_{t-1},
//    so a buffer is never overwritten while it is read. Nothing on the
//    sequential path goes through L2: hs (and cs) are written to device
//    memory off the path, the cell state stays in its owner's registers,
//    and the next step's xproj is loaded into registers one step ahead.
//  * The per-step product h_{t-1} U[:, own columns] is R*units*4*H FMAs
//    (42K at N=64 with 4-row blocks and C=16): each thread takes one unit
//    and every row of the block over an interleaved share of k (`ksplit`
//    threads per unit), one float4 of U against R values of h per k; the
//    shares are summed through shared memory in a fixed order, so two
//    launches give the same bits.
//  * xproj [N,T,4H] is read through its strides: no time-major copy.

#include "lstm_cluster.cuh"

namespace {

struct Params {
  const float* xproj;
  long long sxn, sxt;  // element strides of xproj's N and T axes
  const float* u;      // [H, 4H]
  const float* p;      // [3, H]
  const float* h0;     // [N, H]
  const float* c0;     // [N, H]
  float* hs;           // [N, T, H]
  float* hT;           // [N, H]
  float* cT;           // [N, H]
  float* cs;           // [T, N, H] or null
  int N, T, H, units, ksplit, k_smem, cluster;
};

// Shared memory of one CTA, in floats (each part a multiple of 4):
//   mbar u64 [2]                 the two buffers' mbarriers (16 bytes)
//   us  float4 [k_smem][u_ld(units)] U[k, the gate columns of a unit]
//   hb  float [2][round4(H*ldh)] h_{t-1} of the row block, [k][ldh]
//   red float4 [ksplit][R*units+1] the k shares of each (row, unit)
//   hst float [round4(units*R)]  this CTA's h_t, [unit][R]
// Padding against bank conflicts: a k row of hb holds R values and, from
// R = 8, four more (the k-share lanes read rows an odd number of float4s
// apart); each k share of red is one float4 longer than its R*units
// entries (the lanes of one unit write shares an odd number apart).
constexpr __host__ __device__ int h_ld(int R) { return R >= 8 ? R + 4 : R; }

size_t fwd_smem_bytes(int H, int R, int units, int ksplit, int k_smem) {
  return 4 * (4 + 4 * static_cast<size_t>(k_smem) * u_ld(units) +
              2 * round4(static_cast<size_t>(H) * h_ld(R)) +
              4 * static_cast<size_t>(ksplit) * (units * R + 1) +
              round4(static_cast<size_t>(units) * R));
}

// acc[r][g] += h[r] * w.g for the R rows of one k row of the h tile
template <int R>
__device__ __forceinline__ void fma_rows(float (&acc)[R][4], float4 w,
                                         const float* hk) {
  float hv[R];
  if constexpr (R >= 4) {
#pragma unroll
    for (int r = 0; r < R; r += 4) {
      const float4 h4 = *reinterpret_cast<const float4*>(hk + r);
      hv[r] = h4.x;
      hv[r + 1] = h4.y;
      hv[r + 2] = h4.z;
      hv[r + 3] = h4.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) hv[r] = hk[r];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r][0] = fmaf(hv[r], w.x, acc[r][0]);
    acc[r][1] = fmaf(hv[r], w.y, acc[r][1]);
    acc[r][2] = fmaf(hv[r], w.z, acc[r][2]);
    acc[r][3] = fmaf(hv[r], w.w, acc[r][3]);
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads) lstm_fwd_cluster(const Params P) {
  extern __shared__ float4 smem4[];
  const int H = P.H, T = P.T, units = P.units, ks = P.ksplit;
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster_rank());
  const int row0 = static_cast<int>(cluster_index()) * R;
  const int nrows = min(R, P.N - row0);
  const int unit0 = rank * units;
  const int nunits = max(0, min(units, H - unit0));
  constexpr int ldh = h_ld(R);
  const size_t hbs = round4(static_cast<size_t>(H) * ldh);
  const int rs = R * units + 1;  // float4s per k share of red
  const int lu = u_ld(units);     // float4s per k row of us
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(smem4);
  float4* us = smem4 + 1;
  float* hb = reinterpret_cast<float*>(us + static_cast<size_t>(P.k_smem) *
                                                lu);
  float4* red = reinterpret_cast<float4*>(hb + 2 * hbs);
  float* hst = reinterpret_cast<float*>(red + static_cast<size_t>(ks) * rs);

  for (int idx = tid; idx < P.k_smem * lu; idx += kThreads) {
    const int k = idx / lu, uu = idx % lu;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (uu < nunits) {
      const float* col = P.u + static_cast<size_t>(k) * 4 * H + unit0 + uu;
      w = make_float4(col[0], col[H], col[2 * H], col[3 * H]);
    }
    us[idx] = w;
  }
  for (int idx = tid; idx < H * ldh; idx += kThreads) {
    const int k = idx / ldh, r = idx % ldh;
    hb[idx] = r < nrows ? P.h0[static_cast<size_t>(row0 + r) * H + k] : 0.f;
  }
  for (int idx = tid; idx < units * R; idx += kThreads) hst[idx] = 0.f;

  // owned (row, unit) items: unit fastest, so hs writes are coalesced
  const int owned = nunits * nrows;
  float c[kMaxOwned], hv_out[kMaxOwned], xq[kMaxOwned][4], pp[kMaxOwned][3];
#pragma unroll
  for (int i = 0; i < kMaxOwned; ++i) {
    const int o = tid + i * kThreads;
    if (o < owned) {
      const int uu = o % nunits, r = o / nunits;
      const int n = row0 + r, unit = unit0 + uu;
      c[i] = P.c0[static_cast<size_t>(n) * H + unit];
#pragma unroll
      for (int g = 0; g < 3; ++g) pp[i][g] = P.p[g * H + unit];
      const float* xp = P.xproj + n * P.sxn + unit;
#pragma unroll
      for (int g = 0; g < 4; ++g) xq[i][g] = xp[g * H];
    }
  }
  // every CTA of the cluster has started (its shared memory exists),
  // set up its mbarriers and loaded its tiles before any peer stores
  mbar_init(mbar);
  cluster_sync();

  const int s = tid % ks, uu_item = tid / ks;
  const bool item = uu_item < nunits;
  const int unit_item = unit0 + uu_item;
  for (int t = 0; t < T; ++t) {
    // h_{t-1} from every CTA (the exchange of step t-1: the buffer's
    // ((t-1)/2)-th use)
    if (t > 0) mbar_wait(mbar + (t & 1), ((t - 1) >> 1) & 1);
    const float* hin = hb + static_cast<size_t>(t & 1) * hbs;
    // ---- k share of z[:, own columns] = h_{t-1} U for one unit, R rows
    if (item) {
      float acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
      // k in order: the rows of U in shared memory, then the rest from
      // L2 in a loop of its own, unrolled so its loads overlap
      int k = s;
#pragma unroll 4
      for (; k < P.k_smem; k += ks)
        fma_rows<R>(acc, us[k * lu + uu_item], hin + k * ldh);
#pragma unroll 4
      for (; k < H; k += ks) {
        const float* col = P.u + static_cast<size_t>(k) * 4 * H + unit_item;
        fma_rows<R>(acc,
                    make_float4(__ldg(col), __ldg(col + H),
                                __ldg(col + 2 * H), __ldg(col + 3 * H)),
                    hin + k * ldh);
      }
      float4* mine = red + static_cast<size_t>(s) * rs + uu_item;
#pragma unroll
      for (int r = 0; r < R; ++r)
        mine[r * units] =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    __syncthreads();
    // ---- cell update of the owned items
#pragma unroll
    for (int i = 0; i < kMaxOwned; ++i) {
      const int o = tid + i * kThreads;
      if (o >= owned) continue;
      const int uu = o % nunits, r = o / nunits;
      float z0 = xq[i][0], z1 = xq[i][1], z2 = xq[i][2], z3 = xq[i][3];
      for (int q = 0; q < ks; ++q) {  // fixed order: same bits every launch
        const float4 v = red[static_cast<size_t>(q) * rs + r * units + uu];
        z0 += v.x;
        z1 += v.y;
        z2 += v.z;
        z3 += v.w;
      }
      const float c_prev = c[i];
      const float ig = sigmoidf_(z0 + pp[i][0] * c_prev);
      const float fg = sigmoidf_(z1 + pp[i][1] * c_prev);
      const float gg = tanhf(z3);
      const float cn = fg * c_prev + ig * gg;
      const float og = sigmoidf_(z2 + pp[i][2] * cn);
      const float h = og * tanhf(cn);
      c[i] = cn;
      hv_out[i] = h;
      hst[uu * R + r] = h;
    }
    // ---- h_t of this CTA's units into every CTA's other buffer; this
    // CTA expects H*R*4 bytes there, from all of them
    if (t + 1 < T) {
      __syncthreads();
      if (tid == 0) mbar_expect(mbar + ((t + 1) & 1), 4 * H * R);
      broadcast_to_cluster<R, ldh>(
          hst, hb + static_cast<size_t>((t + 1) & 1) * hbs +
                   static_cast<size_t>(unit0) * ldh,
          nunits, P.cluster, mbar + ((t + 1) & 1));
    }
#pragma unroll
    for (int i = 0; i < kMaxOwned; ++i) {
      const int o = tid + i * kThreads;
      if (o >= owned) continue;
      const int n = row0 + o / nunits, unit = unit0 + o % nunits;
      P.hs[(static_cast<size_t>(n) * T + t) * H + unit] = hv_out[i];
      if (P.cs != nullptr)
        P.cs[(static_cast<size_t>(t) * P.N + n) * H + unit] = c[i];
      if (t == T - 1) {
        P.hT[static_cast<size_t>(n) * H + unit] = hv_out[i];
        P.cT[static_cast<size_t>(n) * H + unit] = c[i];
      } else {
        const float* xp = P.xproj + n * P.sxn + (t + 1) * P.sxt + unit;
#pragma unroll
        for (int g = 0; g < 4; ++g) xq[i][g] = xp[g * H];
      }
    }
  }
  cluster_sync();
}

using Kernel = void (*)(const Params);

Kernel fwd_kernel(int rows) {
  switch (rows) {
    case 1: return lstm_fwd_cluster<1>;
    case 2: return lstm_fwd_cluster<2>;
    case 4: return lstm_fwd_cluster<4>;
    case 8: return lstm_fwd_cluster<8>;
    case 16: return lstm_fwd_cluster<16>;
    default: return nullptr;
  }
}

// The plan's numbers, checked against what the kernel assumes; 0 if the
// plan is one the kernel takes.
int check_plan(int N, int H, int rows, int cluster, int units, int ksplit,
               int k_smem, int smem) {
  if (N <= 0 || H <= 0 || fwd_kernel(rows) == nullptr ||
      (cluster != 8 && cluster != 16) || units * cluster < H ||
      units <= 0 || ksplit <= 0 || units * ksplit > kThreads ||
      rows * units > kMaxOwned * kThreads || k_smem < 0 || k_smem > H ||
      fwd_smem_bytes(H, rows, units, ksplit, k_smem) !=
          static_cast<size_t>(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// How many clusters of this plan's kernel the card runs at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
extern "C" int lstm_scan_fwd_clusters(int rows, int cluster, int smem,
                                      int device) {
  if (cudaSetDevice(device) != cudaSuccess || fwd_kernel(rows) == nullptr)
    return -static_cast<int>(cudaErrorInvalidValue);
  Params P = {};
  int capacity = 0;
  const int err = cluster_launch(fwd_kernel(rows), P, 1, cluster,
                                 static_cast<size_t>(smem), nullptr,
                                 &capacity);
  return err != 0 ? -err : capacity;
}

// Returns the CUDA error of the launch (0 = success); a plan the kernel
// does not take returns cudaErrorInvalidValue without launching. The
// wrapper raises on any nonzero code.
extern "C" int lstm_scan_fwd(const void* xproj, long long sxn, long long sxt,
                             const void* u, const void* p, const void* h0,
                             const void* c0, void* hs, void* hT, void* cT,
                             void* cs, int N, int T, int H, int rows,
                             int cluster, int units, int ksplit, int k_smem,
                             int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int bad = check_plan(N, H, rows, cluster, units, ksplit, k_smem, smem);
  if (bad == 0 && T <= 0) bad = static_cast<int>(cudaErrorInvalidValue);
  if (bad != 0) return bad;
  Params P;
  P.xproj = static_cast<const float*>(xproj);
  P.sxn = sxn;
  P.sxt = sxt;
  P.u = static_cast<const float*>(u);
  P.p = static_cast<const float*>(p);
  P.h0 = static_cast<const float*>(h0);
  P.c0 = static_cast<const float*>(c0);
  P.hs = static_cast<float*>(hs);
  P.hT = static_cast<float*>(hT);
  P.cT = static_cast<float*>(cT);
  P.cs = static_cast<float*>(cs);
  P.N = N;
  P.T = T;
  P.H = H;
  P.units = units;
  P.ksplit = ksplit;
  P.k_smem = k_smem;
  P.cluster = cluster;
  const int rc = cluster_launch(fwd_kernel(rows), P, (N + rows - 1) / rows,
                                cluster, static_cast<size_t>(smem),
                                static_cast<cudaStream_t>(stream), nullptr);
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
