// f32 matrix product at f32 accuracy on Hopper's tensor cores (K8), for
// sm_90a. Plain C interface, loaded with ctypes by
// deeplearning4j_tpu_torch/ops/f32_gemm.py (f32_gemm, the products of the
// tied head's forward and backward on the card).
//
// Replaces: no Pallas kernel. The JAX package leaves the tied head's
// product, h @ embed.T, and its two backward products to XLA
// (deeplearning4j_tpu/models/transformer.py _head, bert.py mlm_logits).
// Its plain PyTorch version is f32_gemm_plain in ops/f32_gemm.py (a @ b).
//
// Function: C[M,N] = A[M,K] . B[K,N], all f32, by 3xTF32: every element x
// is split into hi = tf32(x) and lo = tf32(x - hi) (round to nearest), and
// a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the dropped a_lo.b_lo being
// ~2^-22 of a.b. A is read through two strides, one of them 1: K-major
// (the head's h, and G in dh = G . embed) or M-major (G^T in
// dembed = G^T . h). B comes packed by f32_gemm_pack (below).
//
// What bounds it on the H100: the products. The head's shapes (M = 16384
// rows, K or N = d of 768 or 1024, the third a vocabulary of 30,522 or
// 50,257) do 2·M·N·K flops against ~4·(MK + KN + MN) bytes, some hundreds
// of flops a byte, so the bound is the f32-accurate tensor-core rate:
// three TF32 products at 495 TFLOP/s, 165 TFLOP/s.
//
// What the design does:
//  * wgmma m64n128k8 (TF32 in, f32 accumulate), A from registers, B from
//    shared memory. TF32 wgmma reads its shared-memory operands K-major
//    only (no transpose, unlike bf16), so every operand reaches it K-major:
//    A is loaded into registers from any layout, and B is packed K-major.
//  * the pre-pass f32_gemm_pack reads B through its strides once, splits
//    it into hi and lo, and writes each 128 x 32 block of both, zero past
//    the ends, as the 128-byte-swizzled K-major tile wgmma reads (16 KB,
//    contiguous): a block lands in shared memory by one bulk copy (the
//    TMA's 1-D form) completing on the stage's mbarrier. It reads B once
//    and writes it twice (~0.2 ms for a 50,257 x 1024 embedding).
//  * A is the large operand (the logits' gradient G, 16384 x V) and is
//    read raw: two producer warps copy each 128 x 32 tile of it by 16-byte
//    cp.async (zero past M and K), completing on the same mbarrier, into
//    a padded tile that the consumers' fragment loads read without bank
//    conflicts: [128 m][36] for a K-major A, [32 k][136] for an M-major
//    one, whose contiguous axis (m) stays contiguous. A 16-byte copy wants
//    16-byte rows: a row of V = 50,257 or 30,522 floats is not (nor can a
//    TMA descriptor cover G as PyTorch stores it), so the wrapper copies
//    such an A into rows padded to 4 floats first; the tied head's
//    backward does so once for both of its products (G read and written
//    once, ~2 ms at the LM's shape, in K8's time). A first design copied
//    G as it lies by 4-byte cp.async, one element a lane: ~1.5x slower at
//    the head's shapes on an H100 80GB HBM3 (700 W), the copies setting
//    the pace.
//  * two consumer warpgroups of 64 rows each split their A fragments in
//    registers and issue a stage's 12 products (4 k8 steps x 3, small
//    terms first) into a stage accumulator from zero, then add it to the
//    tile's accumulator on the CUDA cores, rounding to nearest: the tensor
//    cores' own accumulation is not f32's, and one accumulator over all of
//    K drifts several times further from f64 than an f32 FMA loop does
//    (csrc/flash_tc.cuh, mma_3xtf32).
//  * a ring of 4 stages (51,200 bytes each) between the producer warps and
//    the consumers (full and empty mbarriers); persistent CTAs, one an SM,
//    walk the output tiles (128 x 128) in groups of 8 tile rows, so a
//    wave's A and B stay in L2, and the producer loads the next tile while
//    the consumers store this one.
//  * no float atomics: each output tile (or each k slice of it) is summed
//    by one CTA in a fixed order, so two launches give the same bits. Past
//    256 stages (8,192 of k) the product is cut into k slices (split-K,
//    chosen by the wrapper), each written to a workspace and summed in
//    slice order by a second launch: one f32 sequence over the 1,571
//    stages of dh = G . E (K = 50,257) drifted 2.4x further from f64 than
//    torch's f32 matmul at 3001 rows on an H100 80GB HBM3 (700 W), where
//    a sequence of at most 256 does not. The wrapper also slices a product
//    with fewer tiles than SMs, down to slices of 8 stages.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace k8 {
namespace {

using flash::set_smem;
using flash::tc::desc;
using flash::tc::fence_regs;
using flash::tc::split_tf32;
using flash::tc::wgmma_commit;
using flash::tc::wgmma_fence;
using flash::tc::wgmma_wait;

constexpr int BM = 128;              // output tile rows (A rows)
constexpr int BN = 128;              // output tile columns (B columns)
constexpr int BK = 32;               // k of a stage: one 128-byte row
constexpr int kStages = 4;
constexpr int kLda = BK + 4;         // floats a row of a K-major A tile
constexpr int kLdt = BM + 8;         // floats a k of an M-major A tile
constexpr int kBlock = BN * BK;      // floats of one packed B block
constexpr uint32_t kBBytes = kBlock * 4;             // 16,384
constexpr uint32_t kABytes = BM * kLda * 4;          // 18,432
constexpr uint32_t kStage = 2 * kBBytes + kABytes;   // 51,200
constexpr int kThreads = 320;        // two consumer warpgroups, 2 producers
constexpr int kGroup = 8;            // tile rows walked together
constexpr int kSmem = kStages * kStage + 2 * kStages * 8 + 1024;
// a stage that has not arrived after this many clock cycles (~10 s)
// faults the launch instead of spinning for ever
constexpr long long kWaitLimit = 1LL << 34;

struct Params {
  const float* a;
  const float* bhi;
  const float* blo;
  float* c;
  int m, n, k;
  long long a_sm, a_sk, ldc, c_slice;
  int tiles_m, tiles_n, tiles_k;
  int kts;      // k stages of a slice
  int slices;   // k slices (split-K), each its own output tile set
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// arrives on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > kWaitLimit) __trap();
  } while (!done);
}
// 16 bytes to shared `dst`: the first `bytes` (0 to 16) from global `src`,
// the rest zero
__device__ __forceinline__ void cp_async16n(uint32_t dst, const float* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
// `bytes` (a multiple of 16) from global `src` to shared `dst`, completing
// on `bar`'s transaction count
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// d[64] (+)= A[64x8] . B[8x128]: A (TF32) from registers, B K-major in
// shared memory; scale_d = 0 starts d from zero. A fragment of thread t of
// the warpgroup (g = lane / 4, c = lane % 4, rows of warp w from 16 w): a0
// (g, c), a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4); d as in
// flash_tc.cuh's Mma.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// work item `id` -> k slice, tile row, tile column and the slice's k
// stages [k_begin, k_end): slice by slice, and in groups of kGroup tile
// rows, rows fastest inside a group, so the CTAs of a wave share A rows
// and B columns
__device__ __forceinline__ void tile_of(int id, const Params& p, int& slice,
                                        int& tm, int& tn, int& k_begin,
                                        int& k_end) {
  const int per_slice = p.tiles_m * p.tiles_n;
  slice = id / per_slice;
  id -= slice * per_slice;
  k_begin = slice * p.kts;
  k_end = min(p.tiles_k, k_begin + p.kts);
  const int per_group = kGroup * p.tiles_n;
  const int first = id / per_group * kGroup;
  const int rows = min(kGroup, p.tiles_m - first);
  const int in = id % per_group;
  tm = first + in % rows;
  tn = in / rows;
}

// A producer warp (pw = 0 or 1): for each tile and k stage, waits for the
// stage to be free, bulk-copies the packed B hi and lo blocks (warp 0's
// lane 0) and copies its half of the raw A tile by 16-byte cp.async, the
// bytes past M or K zero-filled
template <bool KMAJOR>
__device__ __forceinline__ void produce(const Params& p, uint32_t base,
                                        uint32_t bars, int pw, int lane) {
  int stage = 0;
  uint32_t phase = 0;
  const int total = p.tiles_m * p.tiles_n * p.slices;
  const int q = 32 * pw + lane;  // 16-byte chunks q, q + 64, ..
  for (int id = blockIdx.x; id < total; id += gridDim.x) {
    int slice, tm, tn, k_begin, k_end;
    tile_of(id, p, slice, tm, tn, k_begin, k_end);
    const int m0 = tm * BM;
    const size_t bblk = static_cast<size_t>(tn) * p.tiles_k * kBlock;
    for (int kt = k_begin; kt < k_end; ++kt) {
      const uint32_t full = bars + 8 * stage;
      mbar_wait(bars + 8 * (kStages + stage), phase ^ 1);
      const uint32_t st = base + stage * kStage;
      if (pw == 0 && lane == 0) {
        mbar_expect_tx(full, 2 * kBBytes);
        const size_t off = bblk + static_cast<size_t>(kt) * kBlock;
        bulk_copy(st, p.bhi + off, kBBytes, full);
        bulk_copy(st + kBBytes, p.blo + off, kBBytes, full);
      }
      const uint32_t sa = st + 2 * kBBytes;
      const int k0 = kt * BK;
      if constexpr (KMAJOR) {
        // [128 m][36]: 8 chunks a row, a warp 4 rows of 128 bytes
        const int r = q / 8, c = q % 8;
        const int kb = 4 * (p.k - (k0 + 4 * c));  // bytes left in the row
        const int bytes = kb < 0 ? 0 : (kb > 16 ? 16 : kb);
        const int left = p.m - (m0 + r);          // rows left, by 8
        const float* src = p.a + (m0 + r) * p.a_sm + k0 + 4 * c;
        uint32_t dst = sa + r * kLda * 4 + 16 * c;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const bool ok = 8 * i < left && bytes > 0;
          cp_async16n(dst, ok ? src : p.a, ok ? bytes : 0);
          src += 8 * p.a_sm;
          dst += 8 * kLda * 4;
        }
      } else {
        // [32 k][136]: 32 chunks a k, a warp one k's 512 bytes
        const int r = q / 32, c = q % 32;
        const int mb = 4 * (p.m - (m0 + 4 * c));  // bytes left in the row
        const int bytes = mb < 0 ? 0 : (mb > 16 ? 16 : mb);
        const int left = p.k - (k0 + r);          // k left, by 2
        const float* src = p.a + (k0 + r) * p.a_sk + m0 + 4 * c;
        uint32_t dst = sa + r * kLdt * 4 + 16 * c;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const bool ok = 2 * i < left && bytes > 0;
          cp_async16n(dst, ok ? src : p.a, ok ? bytes : 0);
          src += 2 * p.a_sk;
          dst += 2 * kLdt * 4;
        }
      }
      mbar_arrive_cp_async(full);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  flash::tc::cp_async_wait<0>();
}

// A consumer warpgroup: 64 rows of each tile
template <bool KMAJOR>
__device__ __forceinline__ void consume(const Params& p, uint32_t base,
                                        const uint8_t* gbase, uint32_t bars,
                                        int cw, int warp, int lane) {
  const int g = lane / 4, c4 = lane % 4;
  const int row0 = 64 * cw + 16 * warp + g;  // tile row of a0 and d[0]
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  const int total = p.tiles_m * p.tiles_n * p.slices;
  for (int id = blockIdx.x; id < total; id += gridDim.x) {
    int slice, tm, tn, k_begin, k_end;
    tile_of(id, p, slice, tm, tn, k_begin, k_end);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = k_begin; kt < k_end; ++kt) {
      mbar_wait(bars + 8 * stage, phase);
      const uint32_t st = base + stage * kStage;
      const float* as = reinterpret_cast<const float*>(
          gbase + stage * kStage + 2 * kBBytes);
      // element (row, k) of the A tile, as the producer laid it out
      constexpr int kRow = KMAJOR ? kLda : 1, kCol = KMAJOR ? 1 : kLdt;
      as += row0 * kRow + c4 * kCol;
      uint32_t ah[16], al[16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* aj = as + 8 * j * kCol;
        split_tf32(aj[0], ah[4 * j], al[4 * j]);
        split_tf32(aj[8 * kRow], ah[4 * j + 1], al[4 * j + 1]);
        split_tf32(aj[4 * kCol], ah[4 * j + 2], al[4 * j + 2]);
        split_tf32(aj[8 * kRow + 4 * kCol], ah[4 * j + 3], al[4 * j + 3]);
      }
      fence_regs<64>(part);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // k8 step j: 32 bytes into each 128-byte swizzled row
        const uint64_t bh = desc(st + 32 * j, 16, 1024, 1);
        const uint64_t bl = desc(st + kBBytes + 32 * j, 16, 1024, 1);
        mma_tf32(part, al + 4 * j, bh, j > 0);
        mma_tf32(part, ah + 4 * j, bl, 1);
        mma_tf32(part, ah + 4 * j, bh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<64>(part);
      fence_regs<16>(ah);
      fence_regs<16>(al);
      if (lane == 0) mbar_arrive(bars + 8 * (kStages + stage));
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // acc[4j + 2r + c] is row row0 + 8r, column 8j + 2 c4 + c
    const int n0 = tn * BN + 2 * c4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int mm = tm * BM + row0 + 8 * r;
      if (mm >= p.m) continue;
      float* crow = p.c + slice * p.c_slice + mm * p.ldc;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int nn = n0 + 8 * j + c;
          if (nn < p.n) crow[nn] = acc[4 * j + 2 * r + c];
        }
      }
    }
  }
}

template <bool KMAJOR>
__global__ void __launch_bounds__(kThreads, 1)
    f32_gemm_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles: 1 KB
  const uint8_t* gbase = smem_raw + (base - raw);
  // full[s] at bars + 8 s, empty[s] at bars + 8 (kStages + s)
  const uint32_t bars = base + kStages * kStage;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 65);  // 64 producer lanes + the expect_tx
      mbar_init(bars + 8 * (kStages + s), 8);  // one lane a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp >= 8)
    produce<KMAJOR>(p, base, bars, warp - 8, lane);
  else
    consume<KMAJOR>(p, base, gbase, bars, warp / 4, warp % 4, lane);
}

// f32_gemm_pack: B (element (n, k) at b[n sn + k sk], sn or sk 1) -> hi
// and lo, [tiles_n][tiles_k] blocks of 128 x 32, each the swizzled tile
// (row r's 16-byte chunk c at chunk c ^ (r % 8)), zero past N and K
template <bool KMAJOR>
__global__ void __launch_bounds__(256)
    f32_gemm_pack_kernel(const float* __restrict__ b, float* __restrict__ hi,
                         float* __restrict__ lo, int n, int k, long long sn,
                         long long sk, int tiles_k) {
  __shared__ float tile[BN][BK + 1];
  const int tk = blockIdx.x, tn = blockIdx.y;
  const int n0 = tn * BN, k0 = tk * BK;
  const int tid = threadIdx.x;
  if constexpr (KMAJOR) {
    const int kk = tid % 32;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = tid / 32 + 8 * i;
      const int nn = n0 + r, kg = k0 + kk;
      tile[r][kk] = nn < n && kg < k ? b[nn * sn + kg] : 0.f;
    }
  } else {
    const int r = tid % BN;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int kk = tid / BN + 2 * i;
      const int nn = n0 + r, kg = k0 + kk;
      tile[r][kk] = nn < n && kg < k ? b[nn + kg * sk] : 0.f;
    }
  }
  __syncthreads();
  const size_t blk = (static_cast<size_t>(tn) * tiles_k + tk) * kBlock;
  float4* h4 = reinterpret_cast<float4*>(hi + blk);
  float4* l4 = reinterpret_cast<float4*>(lo + blk);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tid + 256 * i;  // 16-byte chunk of the block
    const int r = c / 8;
    const float* src = &tile[r][4 * ((c % 8) ^ (r % 8))];
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(src[e], h[e], l[e]);
    h4[c] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                        __uint_as_float(h[2]), __uint_as_float(h[3]));
    l4[c] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                        __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// C = the sum of a split-K product's slices, in slice order (w holds
// `slices` [M, N] partial products, contiguous)
__global__ void __launch_bounds__(256)
    f32_gemm_reduce_kernel(const float* __restrict__ w, float* __restrict__ c,
                           int slices, long long mn, int n, long long ldc) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < mn;
       i += static_cast<long long>(gridDim.x) * 256) {
    float sum = w[i];
    for (int s = 1; s < slices; ++s) sum += w[s * mn + i];
    c[i / n * ldc + i % n] = sum;
  }
}

int sm_count(int device) {
  static int count[64] = {};
  if (device >= 0 && device < 64 && count[device] > 0) return count[device];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  if (device >= 0 && device < 64) count[device] = n;
  return n;
}

template <bool KMAJOR>
cudaError_t launch(const Params& p, int device, cudaStream_t stream) {
  static bool done[64] = {};
  const cudaError_t err =
      set_smem(f32_gemm_kernel<KMAJOR>, kSmem, device, done);
  if (err != cudaSuccess) return err;
  const int tiles = p.tiles_m * p.tiles_n * p.slices;
  const int sms = sm_count(device);
  if (sms <= 0) return cudaErrorInvalidDevice;
  f32_gemm_kernel<KMAJOR>
      <<<tiles < sms ? tiles : sms, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace k8

// The packed B of f32_gemm: b with element (n, k) at b[n sn + k sk] (sn or
// sk is 1), n < N, k < K; hi and lo contiguous buffers of
// ceil(N / 128) * ceil(K / 32) * 4096 floats each (16-byte aligned). One
// launch on `stream`; returns its CUDA error (0 = success),
// cudaErrorInvalidValue without launching where neither stride is 1.
extern "C" int f32_gemm_pack(const void* b, void* hi, void* lo, int N, int K,
                             long long sn, long long sk, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N <= 0 || K <= 0) return 0;
  const dim3 grid((K + k8::BK - 1) / k8::BK, (N + k8::BN - 1) / k8::BN);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(b);
  float* h = static_cast<float*>(hi);
  float* l = static_cast<float*>(lo);
  if (sk == 1)
    k8::f32_gemm_pack_kernel<true><<<grid, 256, 0, s>>>(bf, h, l, N, K, sn,
                                                        sk, grid.x);
  else if (sn == 1)
    k8::f32_gemm_pack_kernel<false><<<grid, 256, 0, s>>>(bf, h, l, N, K, sn,
                                                         sk, grid.x);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// C[M,N] (row stride ldc) = A[M,K] . B[K,N], A with element (m, k) at
// a[m a_sm + k a_sk] (a_sk or a_sm is 1; a 16-byte aligned, the other
// stride a multiple of 4), B as f32_gemm_pack left it in hi and lo. K is
// cut into slices of kts stages of 32 (split-K) where kts is less than
// the ceil(K / 32) stages: each slice's product goes to its [M, N] of ws
// (ceil(ceil(K / 32) / kts) of them, contiguous), and a second launch sums
// them into C in slice order. Launches on `stream`; returns their CUDA
// error (0 = success), cudaErrorInvalidValue without launching where A is
// not so laid out or a split product has no ws.
extern "C" int f32_gemm(const void* a, const void* hi, const void* lo,
                        void* c, void* ws, int M, int N, int K,
                        long long a_sm, long long a_sk, long long ldc,
                        int kts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  const int tiles_k = (K + k8::BK - 1) / k8::BK;
  if (kts <= 0 || kts > tiles_k) kts = tiles_k;
  const int slices = (tiles_k + kts - 1) / kts;
  const long long lead = a_sk == 1 ? a_sm : a_sk;
  if (reinterpret_cast<uintptr_t>(a) % 16 != 0 || lead % 4 != 0 ||
      (slices > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long mn = static_cast<long long>(M) * N;
  k8::Params p{static_cast<const float*>(a), static_cast<const float*>(hi),
               static_cast<const float*>(lo),
               static_cast<float*>(slices > 1 ? ws : c), M, N, K, a_sm, a_sk,
               slices > 1 ? N : ldc, slices > 1 ? mn : 0,
               (M + k8::BM - 1) / k8::BM, (N + k8::BN - 1) / k8::BN, tiles_k,
               kts, slices};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_sk == 1) err = k8::launch<true>(p, device, s);
  else if (a_sm == 1) err = k8::launch<false>(p, device, s);
  else err = cudaErrorInvalidValue;
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  const long long blocks = (mn + 255) / 256;
  k8::f32_gemm_reduce_kernel<<<blocks < 4096 ? blocks : 4096, 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(c), slices, mn, N,
      ldc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
