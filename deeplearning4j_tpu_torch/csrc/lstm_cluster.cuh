// Thread-block-cluster helpers shared by the peephole-LSTM scans (K1,
// csrc/lstm_scan.cu, and K2, csrc/lstm_scan_bwd.cu), for Hopper (sm_90a).
//
// A row block of the batch runs on one cluster of C CTAs (C = 8, or 16
// with the non-portable cluster size); the CTAs split the hidden units and
// exchange one small tile per step through distributed shared memory:
// each CTA stores its part straight into every receiving peer's double
// buffer with st.async, whose completion counts bytes on the receiver's
// mbarrier for that buffer; the receiver waits for the step's bytes on
// its own mbarrier. No cluster barrier on the sequential path: a
// barrier.cluster arrive with release semantics compiles to a GPU-wide
// MEMBAR, which waits for the thread's outstanding global stores. A
// buffer is rewritten only after its readers' next sends arrived, so the
// data dependence alone protects the double buffer. Clusters share
// nothing, so the grid needs no co-residency and no grid-wide barrier.
//
// The shared-memory layouts below are also computed by the planner in
// ops/lstm_scan.py (plan_scan); the launchers recompute the byte count
// from the plan's numbers and refuse a plan whose count differs.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per CTA, both kernels
constexpr int kMaxOwned = 2;   // (row, unit) items a thread owns, at most
// an exchange that has not arrived after this many clock cycles (~10 s)
// faults the launch instead of spinning for ever
constexpr long long kWaitLimit = 1LL << 34;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_index() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

// The address of the same shared-memory location in CTA `rank` of this
// cluster (a shared::cluster address).
__device__ __forceinline__ unsigned peer_addr(const void* local,
                                              unsigned rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(local));
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A store into a peer's shared memory (`addr` from peer_addr) that, when
// it lands, completes its 4 or 16 bytes on the peer's mbarrier `mbar`.
__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "f"(v), "r"(mbar)
      : "memory");
}

__device__ __forceinline__ void st_async4(unsigned addr, float4 v,
                                          unsigned mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(mbar)
      : "memory");
}

// The two mbarriers of a double buffer, each completing once per use:
// one local arrival (the receiver's expect_tx) and the step's bytes.
__device__ __forceinline__ void mbar_init(unsigned long long* mbar) {
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(mbar + b))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// The receiver announces the bytes of the buffer's next use (any time
// after its previous use completed; bytes that land first are counted).
__device__ __forceinline__ void mbar_expect(unsigned long long* mbar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(mbar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* mbar,
                                          unsigned parity) {
  const unsigned a = smem_addr(mbar);
  const long long t0 = clock64();
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > kWaitLimit) __trap();
  } while (!done);
}

// Every thread of every CTA of the cluster arrives, then waits: at the
// start (each CTA's mbarriers and tiles exist before a peer stores into
// them) and at the end (no CTA exits while a peer may store into it).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// Copy `rows_out` rows of R floats from this CTA's shared memory `src`
// ([rows_out][R]) to `dst_local` ([rows_out][LD], a local pointer into the
// same layout) in every CTA of the cluster, each store completing on that
// CTA's `mbar`; the work split over the block's threads, float4 stores
// where R >= 4 (both pointers 16-byte aligned).
template <int R, int LD>
__device__ __forceinline__ void broadcast_to_cluster(
    const float* src, float* dst_local, int rows_out, int cluster,
    unsigned long long* mbar) {
  constexpr int V = R >= 4 ? 4 : 1;  // floats per store
  const int per_peer = rows_out * (R / V);
  for (int it = threadIdx.x; it < per_peer * cluster; it += kThreads) {
    const int q = it / per_peer, i = it % per_peer;
    const int row = i / (R / V), col = (i % (R / V)) * V;
    const unsigned dst = peer_addr(dst_local + row * LD + col, q);
    if constexpr (V == 4)
      st_async4(dst, *reinterpret_cast<const float4*>(src + row * R + col),
                peer_addr(mbar, q));
    else
      st_async(dst, src[row * R + col], peer_addr(mbar, q));
  }
}

// float4s per k row of a CTA's slice of U: `units`, made odd so that
// lanes reading the same unit at consecutive k fall in distinct banks
__host__ __device__ inline int u_ld(int units) { return units | 1; }

__host__ __device__ inline size_t round4(size_t x) {
  return (x + 3) / 4 * 4;
}

// Launch `kernel` over `blocks` clusters of `cluster` CTAs (one row block
// each) with `smem` bytes of dynamic shared memory; with `capacity` set,
// only report how many such clusters the card runs at once. Returns the
// CUDA error of the launch (0 = success); the caller then checks
// cudaGetLastError.
template <typename Kernel, typename Params>
int cluster_launch(Kernel kernel, const Params& P, int blocks, int cluster,
                   size_t smem, cudaStream_t stream, int* capacity) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (capacity != nullptr) {
    *capacity = 0;
    err = cudaOccupancyMaxActiveClusters(capacity, kernel, &cfg);
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, P));
}

}  // namespace
