// CPU stand-in for the CUDA features the port's tensor-core kernels use, so
// that their indexing, fragment layouts, copy groups and barriers can be
// checked with g++ on a machine without a GPU (tools/cuda_emu/run_flash.py,
// run_ssd.py, run_rglru.py).  One block runs at a time as NT std::threads; __syncthreads
// is a block barrier, warp shuffles, ldmatrix and mma.sync m16n8k8 (tf32,
// the low 13 bits of each operand ignored as the tensor cores do) exchange
// through per-warp buffers.  bf16 and fp16 are stored as their 16 bits; the
// conversion intrinsics round to nearest even.  Builds
// define CUDA_EMU, under which sources leave out what has no emulation
// (wgmma, TMA, mbarriers).  cp.async copies are held per thread in their
// commit groups and land only at the cp.async.wait_group that covers them,
// so a read of a tile before its wait sees the NaN the shared memory was
// filled with.  The products are accumulated exactly (in double), so this
// checks layouts and control flow, not the card's rounding or its speed.
#pragma once
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>
#include <algorithm>
#include <barrier>
#include <functional>
#include <thread>
#include <vector>
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) alignas(n)

struct uint3_ { unsigned x = 0, y = 0, z = 0; };
extern thread_local uint3_ threadIdx;
extern uint3_ blockIdx, blockDim, gridDim;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct int2 { int x, y; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline int2 make_int2(int a, int b) { return {a, b}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMultiProcessorCount = 16 };
constexpr int EMU_SMS = 3;  // few SMs, so a persistent grid walks many items
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = EMU_SMS; return 0; }
extern size_t emu_smem_limit;
template <typename K>
int cudaFuncSetAttribute(K, int, int bytes) {
  emu_smem_limit = bytes;
  return 0;
}
inline int cudaGetLastError() { return 0; }
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }

// bf16 and fp16 as their bits; widening is exact, narrowing rounds to
// nearest even (fp16 through the compiler's _Float16)
struct __nv_bfloat16 { uint16_t x; };
struct __half { uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 h) {
  return __uint_as_float((uint32_t)h.x << 16);
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)0x7fc0};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
inline float __half2float(__half h) {
  _Float16 v;
  memcpy(&v, &h.x, 2);
  return (float)v;
}
inline __half __float2half_rn(float f) {
  const _Float16 v = (_Float16)f;
  __half h;
  memcpy(&h.x, &v, 2);
  return h;
}
inline uint16_t __bfloat16_as_ushort(__nv_bfloat16 h) { return h.x; }
inline uint16_t __half_as_ushort(__half h) { return h.x; }
inline __nv_bfloat16 __ushort_as_bfloat16(uint16_t u) { return {u}; }
inline __half __ushort_as_half(uint16_t u) { return {u}; }

constexpr int EMU_WARPS = 32;
extern std::barrier<>* emu_block_bar;
extern std::barrier<>* emu_warp_bar[EMU_WARPS];
extern float emu_warp_f[EMU_WARPS][32][8];
extern const float* emu_warp_p[EMU_WARPS][32];
extern char* emu_dyn_smem;

inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp_bar[threadIdx.x >> 5]->arrive_and_wait();
}
// rounded fp32 operations (g++ builds with -ffp-contract=off, so no fused
// multiply-add forms behind them) and the read-only load
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
template <typename T>
inline T __ldg(const T* p) { return *p; }

// the value of lane src(l) of this warp (its own where src(l) is off the warp)
template <typename F>
inline float emu_shfl(float v, F src) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  emu_warp_f[w][l][0] = v;
  emu_warp_bar[w]->arrive_and_wait();
  const int s = src(l);
  const float r = emu_warp_f[w][s >= 0 && s < 32 ? s : l][0];
  emu_warp_bar[w]->arrive_and_wait();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int off) {
  return emu_shfl(v, [&](int l) { return l ^ off; });
}
inline float __shfl_sync(unsigned, float v, int src) {
  return emu_shfl(v, [&](int) { return src & 31; });
}
inline float __shfl_up_sync(unsigned, float v, int d) {
  return emu_shfl(v, [&](int l) { return l - d; });
}
inline float __shfl_down_sync(unsigned, float v, int d) {
  return emu_shfl(v, [&](int l) { return l + d; });
}

// cp.async: this thread's copies, in commit groups, land at the wait
struct EmuCopy { void* dst; const void* src; int size, bytes; };
extern thread_local std::vector<std::vector<EmuCopy>> emu_groups;
extern thread_local std::vector<EmuCopy> emu_open;
inline void emu_cp_async(void* dst, const void* src, int size, int bytes) {
  emu_open.push_back({dst, src, size, bytes});
}
inline void emu_cp_commit() {
  emu_groups.push_back(emu_open);
  emu_open.clear();
}
inline void emu_cp_wait(int pending) {
  while ((int)emu_groups.size() > pending) {
    for (const EmuCopy& c : emu_groups.front()) {
      memset(c.dst, 0, c.size);
      if (c.bytes) memcpy(c.dst, c.src, c.bytes);
    }
    emu_groups.erase(emu_groups.begin());
  }
}

// d = a b + c for one warp, fragments as the PTX ISA lays them out
inline void emu_mma(float (&c)[4], const uint32_t (&a)[4],
                    const uint32_t (&b)[2]) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  float* me = emu_warp_f[w][l];
  for (int i = 0; i < 4; ++i) me[i] = __uint_as_float(a[i] & 0xffffe000u);
  for (int i = 0; i < 2; ++i) me[4 + i] = __uint_as_float(b[i] & 0xffffe000u);
  emu_warp_bar[w]->arrive_and_wait();
  float A[16][8], B[8][8];
  for (int ln = 0; ln < 32; ++ln) {
    const int g = ln >> 2, t = ln & 3;
    const float* f = emu_warp_f[w][ln];
    A[g][t] = f[0]; A[g + 8][t] = f[1]; A[g][t + 4] = f[2]; A[g + 8][t + 4] = f[3];
    B[t][g] = f[4]; B[t + 4][g] = f[5];
  }
  emu_warp_bar[w]->arrive_and_wait();
  const int g = l >> 2, t = l & 3;
  const int rows[4] = {g, g, g + 8, g + 8};
  const int cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
  for (int e = 0; e < 4; ++e) {
    double s = 0;
    for (int kk = 0; kk < 8; ++kk) s += (double)A[rows[e]][kk] * B[kk][cols[e]];
    c[e] = (float)(c[e] + s);
  }
}

// ldmatrix .x1/.x2/.x4 of b16 8 x 8 matrices, read as 8 x 4 fp32
inline void emu_ldsm(uint32_t* r, int n, const float* p) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  emu_warp_p[w][l] = p;
  emu_warp_bar[w]->arrive_and_wait();
  for (int i = 0; i < n; ++i)
    memcpy(&r[i], emu_warp_p[w][8 * i + l / 4] + l % 4, 4);
  emu_warp_bar[w]->arrive_and_wait();
}

// runs body() once per thread of every block of `grid`; dynamic shared
// memory is filled with NaN before each block so reads of unwritten
// entries show up in the outputs
void emu_launch(dim3 grid, unsigned threads, size_t smem,
                std::function<void()> body);
