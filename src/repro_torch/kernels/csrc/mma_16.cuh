// 16-bit tensor-core helpers for the port's Hopper kernels
// (flash_attention_16.cu): bf16 / fp16 products on mma.sync m16n8k16 with
// fp32 accumulation, fragment loads by ldmatrix (.trans where a product
// needs the transpose) from swizzled 16-bit shared tiles, the conversions,
// and, for the forward, wgmma, TMA and mbarrier wrappers.  Widening and
// narrowing go through the conversion intrinsics only (__bfloat162float,
// __float2bfloat16_rn, __half2float, __float2half_rn).  The cp.async and
// warp helpers come from mma_tf32.cuh.
//
// mma.sync m16n8k16 (bf16 or f16) fragments (PTX ISA), lane = 4 g + t, two
// 16-bit values a register, the lower column in the low half:
//   A (16 x 16, [m][k]): a0 (g, 2t..2t+1)   a1 (g+8, 2t..)   a2 (g, 2t+8..)
//                        a3 (g+8, 2t+8..)
//   B (16 x 8,  [k][n]): b0 (2t..2t+1, g)   b1 (2t+8..2t+9, g)
//   C (16 x 8,  [m][n]): c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//
// Shared tiles are unpadded, row-major with W 16-bit columns (W a multiple
// of 32), in 16-byte chunks of 8 values; chunk j of row r is stored at
// j ^ (r & 7) when W is a multiple of 64 (8 chunks a row and more) and at
// j ^ ((r >> 1) & 3) otherwise (rows of 4, 12, ... chunks: the XOR stays in
// each run of 4).  Either way the 8 row addresses of one ldmatrix matrix
// fall in 8 distinct 16-byte bank groups, and chunks stay whole for
// cp.async.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

template <typename T>
struct H16;

template <>
struct H16<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 of_f(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ uint16_t bits(__nv_bfloat16 x) {
    return __bfloat16_as_ushort(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 of_bits(uint16_t u) {
    return __ushort_as_bfloat16(u);
  }
};

template <>
struct H16<__half> {
  static __device__ __forceinline__ float to_f(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half of_f(float x) {
    return __float2half_rn(x);
  }
  static __device__ __forceinline__ uint16_t bits(__half x) {
    return __half_as_ushort(x);
  }
  static __device__ __forceinline__ __half of_bits(uint16_t u) {
    return __ushort_as_half(u);
  }
};

// a and b rounded to T, a in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return (uint32_t)H16<T>::bits(H16<T>::of_f(a)) |
         ((uint32_t)H16<T>::bits(H16<T>::of_f(b)) << 16);
}

// element (r, c) of a swizzled row-major 16-bit tile with W columns
template <int W>
__device__ __forceinline__ int swz16(int r, int c) {
  const int x = (W % 64 == 0) ? (r & 7) : ((r >> 1) & 3);
  return r * W + ((((c >> 3) ^ x)) << 3) + (c & 7);
}

__device__ __forceinline__ void cp_async16v(void* dst, const void* src,
                                            int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(bytes));
}

// ldmatrix of 8 x 8 b16 matrices: lanes 8 i .. 8 i + 7 give the row
// addresses of matrix i; lane l receives row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1 of each (.trans: column l / 4, rows 2 (l % 4) and + 1)
__device__ __forceinline__ void ldsm16_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm16_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm16_x2_t(uint32_t (&r)[2], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// A fragment: rows m0.., columns k0.. of a swizzled [m][k] tile
template <int W, typename T>
__device__ __forceinline__ void load_a16(const T* s, int m0, int k0,
                                         uint32_t (&a)[4]) {
  const int l = threadIdx.x & 31;
  ldsm16_x4(a, s + swz16<W>(m0 + (l & 7) + 8 * ((l >> 3) & 1),
                            k0 + 8 * (l >> 4)));
}

// the B fragments of n tiles n0 and n0 + 8 from a swizzled [n][k] tile
template <int W, typename T>
__device__ __forceinline__ void load_b16_nk2(const T* s, int n0, int k0,
                                             uint32_t (&b)[2][2]) {
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  ldsm16_x4(r, s + swz16<W>(n0 + (l & 7) + 8 * (l >> 4),
                            k0 + 8 * ((l >> 3) & 1)));
  b[0][0] = r[0]; b[0][1] = r[1]; b[1][0] = r[2]; b[1][1] = r[3];
}

// B fragment of n tile n0 from a swizzled [k][n] tile (B is the tile)
template <int W, typename T>
__device__ __forceinline__ void load_b16_kn(const T* s, int k0, int n0,
                                            uint32_t (&b)[2]) {
  const int l = threadIdx.x & 31;
  ldsm16_x2_t(b, s + swz16<W>(k0 + (l & 7) + 8 * ((l >> 3) & 1), n0));
}

// the B fragments of n tiles n0 and n0 + 8 from a swizzled [k][n] tile
template <int W, typename T>
__device__ __forceinline__ void load_b16_kn2(const T* s, int k0, int n0,
                                             uint32_t (&b)[2][2]) {
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  ldsm16_x4_t(r, s + swz16<W>(k0 + (l & 7) + 8 * ((l >> 3) & 1),
                              n0 + 8 * (l >> 4)));
  b[0][0] = r[0]; b[0][1] = r[1]; b[1][0] = r[2]; b[1][1] = r[3];
}

// c += a b on the 16-bit tensor cores, fp32 accumulation
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  if constexpr (std::is_same<T, __half>::value)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace

#ifndef CUDA_EMU
// ------------------------------------------------ Hopper only: wgmma, TMA
//
// Not emulated on the CPU (tools/cuda_emu): the forward that uses them is
// checked on the card only.

namespace {

// wgmma shared-memory matrix descriptor for a 64-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units), layout
// type 2 (B64) in bits 62-63
__device__ __forceinline__ uint64_t wg_desc(uint32_t smem, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((smem & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)2 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

#define WGMMA_SS_N64(TY)                                               \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"      \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),   \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),   \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])   \
      : "l"(da), "l"(db), "r"(scale_d))

#define WGMMA_SS_N128(TY)                                               \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"      \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),   \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),   \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),   \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),   \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),   \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),   \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])   \
      : "l"(da), "l"(db), "r"(scale_d))

#define WGMMA_RS_N32(TY)                                               \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"      \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),   \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),   \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// d (m64 x N, fp32) += A (m64 x 16, K-major in shared memory) B (16 x N,
// K-major in shared memory); scale_d 0 overwrites d
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "m64n64k16 or m64n128k16");
  if constexpr (N == 64) {
    if constexpr (std::is_same<T, __half>::value) WGMMA_SS_N64("f16");
    else WGMMA_SS_N64("bf16");
  } else {
    if constexpr (std::is_same<T, __half>::value) WGMMA_SS_N128("f16");
    else WGMMA_SS_N128("bf16");
  }
}

// d (m64 x 32, fp32) += A (m64 x 16, in registers as mma.sync's A
// fragments, one 16-row slice a warp) B (16 x 32, N-major in shared memory)
template <typename T>
__device__ __forceinline__ void wgmma_rs32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (std::is_same<T, __half>::value) WGMMA_RS_N32("f16");
  else WGMMA_RS_N32("bf16");
}

// keeps the compiler from moving r between a wgmma that writes it and the
// wait for that wgmma (CUTLASS's warpgroup_fence_operand)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed; a
// wait of over 4 s (an arrival or a copy that never comes) traps, so a
// fault ends the kernel with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (!t0) t0 = now;
    else if (now - t0 > 4000000000ull) __trap();
  }
}

// TMA: one box of a 4-d tensor map at coordinates (c0 innermost .. c3) into
// shared memory, completing `bytes` on the barrier
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

}  // namespace
#endif  // CUDA_EMU
