// Primitives shared by the flash-attention kernels written for Hopper
// (sm_90a): the forward of K4/K5 (csrc/flash_fwd.cuh) and the backward,
// K7 (csrc/flash_bwd.cu). The swizzled bf16 tile layout that wgmma reads
// and its descriptor, the wgmma products (bf16 in, f32 accumulate), the
// cp.async tile loaders, and the f32 products at f32 accuracy (3xTF32 on
// mma.sync m16n8k8) with the score fragment fed back as an A operand.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Everything here has internal linkage (the unnamed namespace), so a
// variant build of a library loaded into the same process keeps its own
// kernels and its own once-per-device flags: with external linkage the
// dynamic linker merges template statics across libraries
// (STB_GNU_UNIQUE), and the second library's kernels would launch without
// their shared-memory limit raised.
namespace flash {
namespace {

// ---------------------------------------------------------------------------
// Raises a kernel's dynamic shared-memory limit once per device (the
// attribute call costs host time on every launch otherwise); `done` is
// the kernel's own flags, one per device.
template <typename K>
cudaError_t set_smem(K kernel, int bytes, int device, bool (&done)[64]) {
  const bool known = device >= 0 && device < 64;
  if (known && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && known) done[device] = true;
  return err;
}

// ---------------------------------------------------------------------------
// tensor cores: wgmma (bf16) or mma.sync 3xTF32 (f32), cp.async K/V ring
// ---------------------------------------------------------------------------

namespace tc {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A tile of `rows` rows of D bf16 in shared memory, as wgmma reads it: a
// row of D bf16 is split into column blocks of at most 128 bytes (two for
// D = 128), each block is `rows` rows of kRowBytes, and the 16-byte chunks
// of a row are swizzled by the address bits above them (Swizzle<B,4,3> of
// CUTLASS: 128-, 64- or 32-byte swizzle for D = 64/128, 32, 16).
template <int D>
struct Tile {
  static constexpr int kRowBytes = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kChunks = D / 8;              // 16-byte chunks a row
  static constexpr int kChunksPerBlock = kRowBytes / 16;
  // the wgmma descriptor's layout code: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr int kLayout =
      kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr __host__ __device__ uint32_t bytes(int rows) {
    return static_cast<uint32_t>(rows) * D * 2;
  }
  // byte offset of chunk c of row r (the tile starts 1024-byte aligned)
  static __device__ __forceinline__ uint32_t offset(int rows, int r, int c) {
    const uint32_t blk = c / kChunksPerBlock;
    const uint32_t lin = r * kRowBytes + (c % kChunksPerBlock) * 16;
    return blk * rows * kRowBytes +
           (lin ^ (((lin >> 7) & (kChunksPerBlock - 1)) << 4));
  }
};

// A tile of `rows` rows of D f32 in shared memory, as the mma.sync
// fragments read it: row-major, each row padded to D + 4 floats, so the
// 32 lanes' fragment reads of Q, K and V fall in 32 distinct banks.
template <int D>
struct TileF {
  static constexpr int kLd = D + 4;  // floats per row
  static constexpr __host__ __device__ uint32_t bytes(int rows) {
    return static_cast<uint32_t>(rows) * kLd * 4;
  }
};

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), layout (swizzle) code
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 zero-fills the 16 bytes (rows past the end)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// one f32 (4-byte aligned src); src-size 0 writes 0
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// orders this thread's generic-proxy writes to shared memory (cp.async,
// plain stores) before the async proxy's reads of them (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// waits until at most N of the warpgroup's committed wgmma groups are in
// flight (groups complete in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving register reads or writes across the
// asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x on the SFU, subnormal results flushed to 0 (2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma.mma_async m64nNk16, bf16 in, f32 accumulate. The accumulator
// fragment of thread t of the warpgroup: d[4j + 2r + c] is row
// 16 (t / 32) + (t % 32) / 4 + 8r, column 8j + 2 (t % 4) + c.
template <int N>
struct Mma;

template <>
struct Mma<16> {
  // d[8] += A[64x16] . B[16x16], A from registers, B MN-major in
  // shared memory
  static __device__ __forceinline__ void rs_mn(float* d, const uint32_t* a,
                                               uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<32> {
  // d[16] += A[64x16] . B[16x32], A from registers, B MN-major in
  // shared memory
  static __device__ __forceinline__ void rs_mn(float* d, const uint32_t* a,
                                               uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<64> {
  // d[32] (+)= A[64x16] . B[16x64], both K-major in shared memory
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // d[32] += A[64x16] . B[16x64], A from registers, B MN-major in
  // shared memory
  static __device__ __forceinline__ void rs_mn(float* d, const uint32_t* a,
                                               uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  // d[64] += A[64x16] . B[16x128], A from registers, B MN-major in
  // shared memory
  static __device__ __forceinline__ void rs_mn(float* d, const uint32_t* a,
                                               uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// Copies `rows` rows of a [*, D] bf16 tile (row t0 + r of a tensor with
// row stride st) into the swizzled layout: cp.async when the tensor is
// 16-byte aligned, plain loads otherwise; rows at or past t_end are zero.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint8_t* gsm, uint32_t ssm,
                                          const __nv_bfloat16* base,
                                          long long st, int t0, int t_end,
                                          bool async, int tid) {
  constexpr int C = Tile<D>::kChunks;
#pragma unroll
  for (int i = tid; i < ROWS * C; i += NT) {
    const int r = i / C;
    const int c = i % C;
    const int t = t0 + r;
    const bool ok = t < t_end;
    const __nv_bfloat16* src = ok ? base + t * st + c * 8 : base;
    const uint32_t off = Tile<D>::offset(ROWS, r, c);
    if (async) {
      cp_async16(ssm + off, src, ok);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (ok) {
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = static_cast<uint32_t>(s16[2 * e]) |
                 (static_cast<uint32_t>(s16[2 * e + 1]) << 16);
      }
      *reinterpret_cast<uint4*>(gsm + off) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The same for f32, into the padded row-major layout of TileF.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint8_t* gsm, uint32_t ssm,
                                          const float* base, long long st,
                                          int t0, int t_end, bool async,
                                          int tid) {
  constexpr int C = D / 4;  // 16-byte chunks a row
#pragma unroll
  for (int i = tid; i < ROWS * C; i += NT) {
    const int r = i / C;
    const int c = i % C;
    const int t = t0 + r;
    const bool ok = t < t_end;
    const float* src = ok ? base + t * st + c * 4 : base;
    const uint32_t off = (r * TileF<D>::kLd + c * 4) * 4;
    if (async) {
      cp_async16(ssm + off, src, ok);
    } else {
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok) w = make_float4(src[0], src[1], src[2], src[3]);
      *reinterpret_cast<float4*>(gsm + off) = w;
    }
  }
}

// ---------------------------------------------------------------------------
// f32 products at f32 accuracy: 3xTF32 on mma.sync m16n8k8. Each operand
// x is split into hi = tf32(x) and lo = tf32(x - hi) (round to nearest);
// a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with f32 accumulation, the
// dropped a_lo.b_lo being ~2^-22 relative, near f32's own rounding.
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A (16x8, row) a0
// (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); B (8x8, col) b0 (k=t,
// n=g), b1 (k=t+4, n=g); C c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3
// (g+8, 2t+1): per warp, the wgmma accumulator layout above.
// ---------------------------------------------------------------------------

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
// d += a.b by 3xTF32, the small products first. The three products
// accumulate from zero and their sum is added to d on the CUDA cores
// (rounded to nearest), once per k8 step: the tensor cores' own
// accumulation is not f32's round-to-nearest, and one accumulator over
// all of D and every key tile gave the masked MHA layer's O 6.2e-6 from
// the plain version on an H100 80GB HBM3 (700 W), against 1.4e-6 this way
// (chip_smoke.py, case h) and 1.0e-6 for f32 FMAs.
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ah,
                                           const uint32_t* al,
                                           const uint32_t* bh,
                                           const uint32_t* bl) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += c[i];
}

// s[4j + 2r + c] += Q.K^T at row g + 8r of this warp's 16 rows (qw), key
// 8j + 2t + c of the NK keys of the tile (ks)
template <int D, int NK>
__device__ __forceinline__ void qk_3xtf32(float* s, const float* qw,
                                          const float* ks, int g, int t) {
  constexpr int L = TileF<D>::kLd;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4];
    const float* qa = qw + g * L + 8 * kk + t;
    split_tf32(qa[0], ah[0], al[0]);
    split_tf32(qa[8 * L], ah[1], al[1]);
    split_tf32(qa[4], ah[2], al[2]);
    split_tf32(qa[8 * L + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
      uint32_t bh[2], bl[2];
      const float* kb = ks + (8 * j + g) * L + 8 * kk + t;
      split_tf32(kb[0], bh[0], bl[0]);
      split_tf32(kb[4], bh[1], bl[1]);
      mma_3xtf32(s + 4 * j, ah, al, bh, bl);
    }
  }
}

// o[4n + 2r + c] += P.V at row g + 8r, column 8n + 2t + c, with P the
// score fragment s as it stands: in key slice j, A column t is key
// 8j + 2t and column t + 4 is key 8j + 2t + 1 (a permutation of the
// slice's keys, which V's B fragment (vs, [keys][D]) reads the same way),
// over NK keys
template <int D, int NK>
__device__ __forceinline__ void pv_3xtf32(float* o, const float* s,
                                          const float* vs, int g, int t) {
  constexpr int L = TileF<D>::kLd;
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(s[4 * j], ah[0], al[0]);      // (g, key 2t)
    split_tf32(s[4 * j + 2], ah[1], al[1]);  // (g + 8, key 2t)
    split_tf32(s[4 * j + 1], ah[2], al[2]);  // (g, key 2t + 1)
    split_tf32(s[4 * j + 3], ah[3], al[3]);  // (g + 8, key 2t + 1)
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bh[2], bl[2];
      const float* vb = vs + (8 * j + 2 * t) * L + 8 * n + g;
      split_tf32(vb[0], bh[0], bl[0]);
      split_tf32(vb[L], bh[1], bl[1]);
      mma_3xtf32(o + 4 * n, ah, al, bh, bl);
    }
  }
}

}  // namespace tc
}  // namespace
}  // namespace flash
