// 16-bit tensor-core helpers for the port's Hopper kernels
// (flash_attention_16.cu): the bf16 / fp16 conversions, and the wgmma, TMA
// and mbarrier wrappers of its forward and backward kernels.  Widening and
// narrowing go through the conversion intrinsics only (__bfloat162float,
// __float2bfloat16_rn, __half2float, __float2half_rn).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

}  // namespace

#ifndef CUDA_EMU
// ------------------------------------------------ Hopper only: wgmma, TMA
//
// Not emulated on the CPU (tools/cuda_emu): the kernels that use them are
// checked on the card only.

namespace {

// wgmma shared-memory matrix descriptor for an operand swizzled in rows of
// SW bytes (64 or 128): start address, leading and stride byte offsets
// (16-byte units), layout type in bits 62-63 (2 B64, 1 B128)
template <int SW = 64>
__device__ __forceinline__ uint64_t wg_desc(uint32_t smem, uint32_t lbo,
                                            uint32_t sbo) {
  static_assert(SW == 64 || SW == 128, "64- or 128-byte swizzle");
  return (uint64_t)((smem & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) |
         ((uint64_t)(SW == 64 ? 2 : 1) << 62);
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

#define WGMMA_RS_N64(TY)                                               \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"      \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),   \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),   \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define WGMMA_RS_N128(TY)                                               \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"      \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"  \
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define WGMMA_RS_N96(TY)                                               \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n96k16.f32." TY "." TY " {"      \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47" \
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"  \
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define WGMMA_RS_N256(TY)                                               \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"      \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"  \
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),   \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),   \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),   \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),   \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),   \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),   \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),   \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),   \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),   \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),   \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),   \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),   \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),   \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),   \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),   \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),   \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])   \
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

// d (m64 x N, fp32) += A (m64 x 16, in registers as mma.sync's A
// fragments, one 16-row slice a warp) B (16 x N, N-major in shared memory,
// N / 32 atoms of 32 columns `lbo` bytes apart); N 32, 64, 96, 128 or 256,
// d the atoms' accumulators in a row
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  constexpr bool F16 = std::is_same<T, __half>::value;
  static_assert(N == 32 || N == 64 || N == 96 || N == 128 || N == 256,
                "m64nNk16, N 32, 64, 96, 128 or 256");
  if constexpr (N == 32) {
    if constexpr (F16) WGMMA_RS_N32("f16");
    else WGMMA_RS_N32("bf16");
  } else if constexpr (N == 64) {
    if constexpr (F16) WGMMA_RS_N64("f16");
    else WGMMA_RS_N64("bf16");
  } else if constexpr (N == 96) {
    if constexpr (F16) WGMMA_RS_N96("f16");
    else WGMMA_RS_N96("bf16");
  } else if constexpr (N == 128) {
    if constexpr (F16) WGMMA_RS_N128("f16");
    else WGMMA_RS_N128("bf16");
  } else {
    if constexpr (F16) WGMMA_RS_N256("f16");
    else WGMMA_RS_N256("bf16");
  }
}

// keeps the compiler from moving r between a wgmma that writes it and the
// wait for that wgmma (CUTLASS's warpgroup_fence_operand)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// named barrier `id` (1-15; 0 is __syncthreads): wait until `n` threads
// have reached it, counting this warp, or count this warp and go on
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// 2^x on the special-function unit (subnormal results flushed to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// the barrier's transaction count raised by `bytes`, without an arrival
__device__ __forceinline__ void mbar_expect_tx_only(uint64_t* bar,
                                                    uint32_t bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// an arrival on the barrier once this thread's cp.async copies so far have
// landed (counted in the barrier's expected arrivals)
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
          smem_u32(bar))
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
