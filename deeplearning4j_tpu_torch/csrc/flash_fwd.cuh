// Flash-attention forward of K4 (csrc/flash_attention.cu) and K5
// (csrc/flash_attention_ext.cu), written by hand for Hopper (sm_90a).
// Included by K5's launcher only; K4's entry point calls K5's with no key
// bias and offset 0 (causal) or T (full), in the same library, so the two
// give the same bits on the same inputs.
//
// Replaces: deeplearning4j_tpu/ops/pallas_attention.py, _flash_raw (:117,
// kernel body _flash_kernel :59) and _flash_ext_raw (:289, kernel body
// _flash_ext_kernel :238).
//
// Function: q [N,Tq,H,D], k, v [N,Tk,H,D] read in place through their
// strides (the D axis contiguous), an optional additive key bias kb
// [N,Tk] f32 shared by the heads (0 keeps a key, -inf masks it) and a host
// integer off in [-Tq, Tk]: key ki is visible to query qi iff qi + off >=
// ki. Scores q.k / sqrt(D) + kb, online softmax in f32. Outputs O
// [N,Tq,H,D] in q's dtype and lse [N,H,Tq] f32. A row with no visible key
// gives O = 0 and lse = -inf exactly (the ring combiner weighs a block by
// exp(lse - max lse), so -inf must weigh nothing). Ragged Tq and Tk are
// masked here.
//
// What bounds it on the H100: at the ring's local shape (T=4096, H=8,
// D=64, causal) and the masked layer's (T=2048) the products, ~1000 flops
// per byte of q/k/v/o against the ~295 at which bf16 tensor cores stop
// waiting on memory, so flops at 989 TFLOP/s; at the serving prefill
// widths (T <= 1024) the bytes at 3.35 TB/s. Past the products, each
// score costs an exp2 on the SFU (16 per clock per SM against 4096 bf16
// tensor-core flops), so the softmax is as long as the two products. In
// f32 (the MHA layer's fit) the products at f32 accuracy: three TF32
// products each, 495 / 3 = 165 TFLOP/s.
//
// What the design does about it (tc:: below, one template for both
// types):
//  * tensor cores. bf16: S = Q.K^T and O += P.V are wgmma.mma_async
//    m64nNk16 (bf16 in, f32 accumulate); P is fed as the A operand of the
//    second product straight from the first product's accumulator
//    fragments, as a bf16 high part and the bf16 rounding of the rest
//    (two products: one bf16 P would carry 2^-9 relative error into O;
//    FLASH_P_SPLIT=0 builds the one-P variant). f32: 3xTF32 on
//    mma.sync m16n8k8 (every operand split in registers into a TF32 high
//    part and the TF32 rounding of the rest, three products summed in
//    f32: f32-accurate, while TF32 alone stays off in the port). mma.sync
//    takes both operands from registers, so V is read in place ([keys][D])
//    and P is the score fragment as it stands, its keys permuted inside
//    each slice of 8 (A column t is key 2t, column t + 4 key 2t + 1) and
//    V's B fragment read in the same order; wgmma's TF32 form reads B
//    K-major from shared memory only, so it would need V transposed there
//    beside the split halves (224 KB at D = 64 with two warpgroups in the
//    layout worked out for it, more than fits at D = 128). Scores
//    never reach shared memory; m, l and O stay in f32 registers. A CTA
//    holds one or two consumer warpgroups of 64 q rows each (128 rows
//    where Tq > 64); Q stays in shared memory for the whole sweep.
//  * asynchronous copies: 64-key K and V tiles arrive by cp.async.cg
//    16-byte copies (zero-filled past Tk) in a 2-stage ring: tile j+1 is
//    in flight while tile j is multiplied, with one barrier per tile.
//    bf16 tiles use the 128/64/32-byte swizzle that matches a row of D
//    bf16 (bank-conflict free for the copies and for wgmma); f32 tiles
//    pad each row to D + 4 floats (conflict free for the fragment reads).
//    A tensor whose base or strides are not 16-byte aligned is copied with
//    plain loads into the same ring instead (never refused).
//  * masking only where needed: tiles wholly visible to every row of a
//    warpgroup with no key bias skip the per-element test; only the
//    diagonal tile, the ragged end and biased tiles apply it. A key tile
//    the bias masks whole (a length mask's tail) is not multiplied. Each q tile
//    stops at its last visible key tile, a warpgroup skips the tiles none
//    of its rows can see, and a q tile with no visible key writes O = 0,
//    lse = -inf without loading K or V. q tiles are launched latest
//    (heaviest under a causal offset) first.
//  * the softmax works in log2 units (scores scaled by log2(e) / sqrt(D),
//    exp2), keeps per-thread partial row sums and reduces them once at
//    the end.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// 1: P.V from P's bf16 high part and the bf16 rounding of the rest (two
// products per k-slice); 0: from one bf16 P (a variant build, timed
// against the split by chip_smoke.py)
#ifndef FLASH_P_SPLIT
#define FLASH_P_SPLIT 1
#endif

// Everything here has internal linkage (the unnamed namespace), so a
// variant build of the library (FLASH_P_SPLIT=0) loaded into the same
// process keeps its own kernels and its own once-per-device flags: with
// external linkage the dynamic linker merges template statics across
// libraries (STB_GNU_UNIQUE), and the second library's kernels would
// launch without their shared-memory limit raised.
namespace flash {
namespace {

struct Strides {
  long long n, t, h;  // element strides; the D axis is contiguous
};

// One launch. kb is a contiguous [N,Tk] f32 bias or null, o a contiguous
// [N,Tq,H,D] buffer of q's dtype, lse a contiguous [N,H,Tq] f32 one.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* kb;
  void* o;
  float* lse;
  int N, Tq, Tk, H, off;
  Strides sq, sk, sv;
};

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

constexpr int kBlockK = 64;  // keys per tile
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

template <typename T, int D>
constexpr uint32_t tile_bytes(int rows) {
  return std::is_same<T, float>::value ? TileF<D>::bytes(rows)
                                       : Tile<D>::bytes(rows);
}

// shared memory: Q [BQ rows], then kStages K tiles, then kStages V tiles:
// a ring with the next key tile in flight while one is multiplied (a
// deeper ring timed no faster on an H100). f32 at D = 128 with two
// warpgroups: 198 KB of the 227.
template <typename T, int D, int NWG>
struct Smem {
  static constexpr int kStages = 2;
  static constexpr int kBlockQ = 64 * NWG;
  static constexpr uint32_t kTile = tile_bytes<T, D>(kBlockK);
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = tile_bytes<T, D>(kBlockQ);
  static constexpr uint32_t kV = kK + kStages * kTile;
  static constexpr uint32_t kBytes = kV + kStages * kTile;
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
// 8j + 2t + c of the tile (ks)
template <int D>
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
    for (int j = 0; j < kBlockK / 8; ++j) {
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
// slice's keys, which V's B fragment (vs, [keys][D]) reads the same way)
template <int D>
__device__ __forceinline__ void pv_3xtf32(float* o, const float* s,
                                          const float* vs, int g, int t) {
  constexpr int L = TileF<D>::kLd;
#pragma unroll
  for (int j = 0; j < kBlockK / 8; ++j) {
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

// One q tile of 64 * NWG rows of head (n, h): NWG consumer warpgroups of
// 64 rows each share the K/V ring. aligned: bit 0/1/2 when q/k/v may be
// copied 16 bytes at a time. T is the element type (bf16: wgmma; f32:
// 3xTF32 mma.sync); masking, the softmax and the ring are shared.
template <typename T, int D, int NWG>
__device__ __forceinline__ void attend(const Params& p, const int n,
                                       const int h, const int q0,
                                       const int aligned,
                                       const float scale_log2, uint8_t* gsm,
                                       const uint32_t ssm) {
  constexpr bool F32 = std::is_same<T, float>::value;
  using SM = Smem<T, D, NWG>;
  constexpr int S = SM::kStages;
  constexpr int BQ = SM::kBlockQ;
  constexpr int NT = NWG * 128;
  constexpr int RB = Tile<D>::kRowBytes;
  constexpr int NS = kBlockK / 2;   // score accumulators per thread
  constexpr int NO = D / 2;         // output accumulators per thread
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int t4 = lane & 3;

  // keys this q tile can see: ki <= q_last + off (off in [-Tq, Tk])
  const int q_last = min(q0 + BQ, p.Tq) - 1;
  const int k_end = min(p.Tk, q_last + p.off + 1);   // exclusive; may be <= 0
  const int n_kt = k_end > 0 ? (k_end + kBlockK - 1) / kBlockK : 0;
  // this warpgroup's rows and the keys they can see
  const int q0w = q0 + 64 * wg;
  const int k_end_w =
      q0w < p.Tq ? min(p.Tk, min(q0w + 63, p.Tq - 1) + p.off + 1) : 0;
  const int row0 = q0w + warp * 16 + (lane >> 2);    // rows row0, row0 + 8

  const T* qb = static_cast<const T*>(p.q) + n * p.sq.n + h * p.sq.h;
  const T* kbase = static_cast<const T*>(p.k) + n * p.sk.n + h * p.sk.h;
  const T* vbase = static_cast<const T*>(p.v) + n * p.sv.n + h * p.sv.h;
  const float* bias = p.kb ? p.kb + static_cast<long long>(n) * p.Tk : nullptr;

  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  // K and V of key tile j into ring stage j % S (one commit group)
  auto load_kv = [&](int j) {
    const uint32_t st = j % S * SM::kTile;
    load_tile<D, kBlockK, NT>(gsm + SM::kK + st, ssm + SM::kK + st, kbase,
                              p.sk.t, j * kBlockK, p.Tk, aligned & 2, tid);
    load_tile<D, kBlockK, NT>(gsm + SM::kV + st, ssm + SM::kV + st, vbase,
                              p.sv.t, j * kBlockK, p.Tk, aligned & 4, tid);
  };
  if (n_kt > 0) {
    load_tile<D, BQ, NT>(gsm + SM::kQ, ssm + SM::kQ, qb, p.sq.t, q0, p.Tq,
                         aligned & 1, tid);
#pragma unroll
    for (int j = 0; j < S - 1; ++j) {  // tiles 0 .. S-2 in flight
      if (j < n_kt) load_kv(j);
      cp_async_commit();
    }
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    const uint32_t stage = kt % S;
    // a key tile whose every key the bias masks adds nothing to any row
    // (every p is 0 and the rescale is by 2^0): its bias is read here,
    // under the barrier's wait, and the tile is skipped below (a length
    // mask leaves whole tiles masked)
    bool live = true;
    if (bias != nullptr) {
      const int ka = k0 + lane, kb = ka + 32;
      live = (ka < p.Tk && bias[ka] != -INFINITY) ||
             (kb < p.Tk && bias[kb] != -INFINITY);
    }
    // tile kt has landed for every thread (later ones may be in flight),
    // and every warpgroup is done with tile kt - 1, whose stage the next
    // copy reuses
    cp_async_wait<S - 2>();
    if constexpr (!F32) fence_proxy_async();
    __syncthreads();
    if (kt + S - 1 < n_kt) load_kv(kt + S - 1);
    cp_async_commit();
    if (k0 >= k_end_w) continue;  // no row of this warpgroup sees the tile
    // every warp of the CTA reads the same keys, so the vote is the same
    // in the four warps of a warpgroup
    if (!__any_sync(0xffffffffu, live)) continue;

    // S = Q . K^T (64 rows x 64 keys per warpgroup)
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    if constexpr (F32) {
      const float* qw = reinterpret_cast<const float*>(gsm + SM::kQ) +
                        (64 * wg + 16 * warp) * TileF<D>::kLd;
      const float* ks = reinterpret_cast<const float*>(
          gsm + SM::kK + stage * SM::kTile);
      qk_3xtf32<D>(s, qw, ks, lane >> 2, t4);
    } else {
      const uint32_t ks = ssm + SM::kK + stage * SM::kTile;
      const uint32_t qs = ssm + SM::kQ + wg * 64 * RB;
      fence_regs<NS>(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t blk = kk * 32 / RB;  // column block of this k-slice
        const uint32_t in = kk * 32 % RB;
        Mma<kBlockK>::ss(s, desc(qs + blk * BQ * RB + in, 16, 8 * RB,
                                 Tile<D>::kLayout),
                         desc(ks + blk * kBlockK * RB + in, 16, 8 * RB,
                              Tile<D>::kLayout),
                         kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NS>(s);
    }

    // scores in log2 units; the per-element test only where some key of
    // the tile is hidden from some row of the warpgroup, or biased
    const bool open = bias == nullptr && k0 + kBlockK <= p.Tk &&
                      k0 + kBlockK - 1 <= q0w + p.off;
    if (open) {
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] *= scale_log2;
    } else {
      float bb[NS / 2];  // the bias of this thread's 16 key columns
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kj = k0 + 8 * j + 2 * t4 + c;
          bb[2 * j + c] = bias && kj < p.Tk ? bias[kj] * kLog2e : 0.f;
        }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int kj = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int qi = row0 + 8 * ((i >> 1) & 1);
        s[i] = kj < p.Tk && qi + p.off >= kj
                   ? fmaf(s[i], scale_log2, bb[2 * (i >> 2) + (i & 1)])
                   : -INFINITY;
      }
    }

    // online softmax on the fragments: a row lives in 4 lanes
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      mx[r] = fmaxf(mx[r], s[i]);
    }
    float mu[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row that has seen no visible key keeps m = -inf; keep the exp2
      // arguments free of -inf - -inf
      mu[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = ex2(m[r] - mu[r]);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = ex2(s[i] - mu[r]);
      rs[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];

    if constexpr (F32) {
      // O += P . V by 3xTF32, P split in registers
      const float* vs = reinterpret_cast<const float*>(
          gsm + SM::kV + stage * SM::kTile);
      pv_3xtf32<D>(o, s, vs, lane >> 2, t4);
    } else {
      // O += P . V with P in registers, in the A-fragment order (k-slice
      // kk holds score columns 16kk .. 16kk + 15). P is split into a bf16
      // high part and the bf16 rounding of the rest, two products per
      // slice: one bf16 P would carry 2^-9 relative error into O, a
      // rounding flip of O past the 2e-2 bar where |O| >= 4.
      const uint32_t vs = ssm + SM::kV + stage * SM::kTile;
      constexpr int NP = FLASH_P_SPLIT ? 2 : 1;  // parts of P
      uint32_t a[kBlockK / 16][NP][4];
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x0 = s[8 * kk + 2 * j], x1 = s[8 * kk + 2 * j + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          a[kk][0][j] = *reinterpret_cast<const uint32_t*>(&hi);
          if constexpr (NP == 2) {
            const float2 hf = __bfloat1622float2(hi);
            a[kk][NP - 1][j] = pack_bf16(x0 - hf.x, x1 - hf.y);
          }
        }
      fence_regs<NO>(o);
      fence_regs<kBlockK / 4 * NP>(&a[0][0][0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const uint64_t dv = desc(vs + kk * 16 * RB, kBlockK * RB, 8 * RB,
                                 Tile<D>::kLayout);
#pragma unroll
        for (int part = 0; part < NP; ++part)
          Mma<D>::rs_mn(o, a[kk][part], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NO>(o);
      fence_regs<kBlockK / 4 * NP>(&a[0][0][0]);
    }
  }

  // l = 0 exactly when no key was visible: O = 0, lse = -inf
  T* ob = static_cast<T*>(p.o);
  const long long ot = static_cast<long long>(p.H) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= p.Tq) continue;
    const float lr = l[r];
    const float inv = lr > 0.f ? 1.f / lr : 0.f;
    T* orow = ob + (static_cast<long long>(n) * p.Tq + qi) * ot +
              static_cast<long long>(h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x0 = o[4 * j + 2 * r] * inv, x1 = o[4 * j + 2 * r + 1] * inv;
      if constexpr (F32)
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * t4) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(x0, x1);
    }
    if (t4 == 0)
      p.lse[(static_cast<long long>(n) * p.H + h) * p.Tq + qi] =
          lr > 0.f ? (m[r] + log2f(lr)) * kLn2 : -INFINITY;
  }
}

// One CTA per (n*h, q tile); the latest q tiles (the heaviest under a
// causal offset) are launched first.
template <typename T, int D, int NWG>
__global__ void __launch_bounds__(NWG * 128, D <= 64 ? 2 : 1)
    flash_fwd_tc(const Params p, const int aligned, const float scale_log2) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  attend<T, D, NWG>(p, blockIdx.x / p.H, blockIdx.x % p.H,
                    (gridDim.y - 1 - blockIdx.y) * Smem<T, D, NWG>::kBlockQ,
                    aligned, scale_log2, smem_raw + pad, raw + pad);
}

// whether a tensor of T may be copied 16 bytes at a time
template <typename T>
int aligned16(const void* ptr, const Strides& s) {
  constexpr long long e = 16 / sizeof(T);  // elements in 16 bytes
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0 && s.n % e == 0 &&
         s.t % e == 0 && s.h % e == 0;
}

template <typename T, int D, int NWG>
cudaError_t launch(const Params& a, int device, cudaStream_t stream) {
  using SM = Smem<T, D, NWG>;
  const int bytes = static_cast<int>(SM::kBytes) + 1024;  // + alignment
  static bool done[64] = {};
  const cudaError_t err =
      set_smem(flash_fwd_tc<T, D, NWG>, bytes, device, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.N * a.H, (a.Tq + SM::kBlockQ - 1) / SM::kBlockQ);
  const int aligned = aligned16<T>(a.q, a.sq) |
                      aligned16<T>(a.k, a.sk) << 1 |
                      aligned16<T>(a.v, a.sv) << 2;
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  flash_fwd_tc<T, D, NWG><<<grid, NWG * 128, bytes, stream>>>(a, aligned,
                                                              scale_log2);
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_rows(const Params& a, int device, cudaStream_t stream) {
  // two consumer warpgroups (a 128-row q tile) where Tq has the rows
  return a.Tq > 64 ? launch<T, D, 2>(a, device, stream)
                   : launch<T, D, 1>(a, device, stream);
}

template <typename T>
cudaError_t launch_d(const Params& a, int D, int device,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch_rows<T, 16>(a, device, stream);
    case 32: return launch_rows<T, 32>(a, device, stream);
    case 64: return launch_rows<T, 64>(a, device, stream);
    case 128: return launch_rows<T, 128>(a, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// dtype codes: 0 = float32, 1 = bfloat16. An unsupported head size or
// dtype returns cudaErrorInvalidValue without launching.
cudaError_t run(const Params& a, int D, int dtype, int device,
                cudaStream_t stream) {
  if (dtype == 0) return tc::launch_d<float>(a, D, device, stream);
  if (dtype == 1) return tc::launch_d<__nv_bfloat16>(a, D, device, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace flash
