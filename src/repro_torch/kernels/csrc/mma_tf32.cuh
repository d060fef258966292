// Tensor-core and asynchronous-copy helpers shared by the port's Hopper
// kernels (flash_attention.cu, ssd_scan.cu; rglru_scan.cu takes only the
// cp.async ones): fp32 products on mma.sync m16n8k8 TF32 with the 3xTF32
// split, fragment loads from swizzled shared tiles, and cp.async.
// kernels/build.py hashes this header with each source that includes it,
// so an edit rebuilds every library.
//
// mma.sync m16n8k8 TF32 fragments (PTX ISA), lane = 4 g + t:
//   A (16 x 8, [m][k]): a0 (g, t)   a1 (g+8, t)    a2 (g, t+4)   a3 (g+8, t+4)
//   B (8 x 8,  [k][n]): b0 (t, g)   b1 (t+4, g)
//   C (16 x 8, [m][n]): c0 (g, 2t)  c1 (g, 2t+1)   c2 (g+8, 2t)  c3 (g+8, 2t+1)
//
// Shared tiles are unpadded, row-major with W columns (W a multiple of 32),
// column c of row r stored at c ^ (((r & 3) << 3) | (r & 4)): fragment loads
// that walk rows with the lane group (g) and those that walk columns with it
// both hit 32 distinct banks, and 16-byte chunks stay whole for cp.async and
// ldmatrix.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// element (r, c) of a swizzled row-major tile with W columns
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  return r * W + (c ^ (((r & 3) << 3) | (r & 4)));
}

// x = hi + lo to ~22 bits, both TF32: hi is x rounded to TF32 (half away
// from zero, as cvt.rna), lo = x - hi exactly; the tensor cores read the top
// 19 bits of a .tf32 operand, so lo's low 13 bits are cut there.  An integer
// add, a mask and a subtraction: cvt.rna.tf32 runs at the conversion units'
// rate and bounded the kernels when they split with it.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: small += a_lo b_hi + a_hi b_lo, big += a_hi b_hi (two chains
// where one accumulator would serialise three dependent mma; the caller adds
// them, or passes the same accumulator twice)
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(small, al, bh);
  mma_tf32(small, ah, bl);
  mma_tf32(big, ah, bh);
}

// ldmatrix of 8 x 8 b16 matrices = 8 x 4 fp32: lane l receives row l / 4,
// column l % 4 of each; lanes 8 i .. 8 i + 7 give the row addresses of
// matrix i (16-byte rows, which the swizzle keeps whole)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const float* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// A fragment: rows m0.., columns k0.. of a swizzled [m][k] tile
template <int W>
__device__ __forceinline__ void load_a(const float* s, int m0, int k0,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int l = threadIdx.x & 31, mat = l >> 3;
  uint32_t r[4];
  ldsm_x4(r, s + swz<W>(m0 + (l & 7) + 8 * (mat & 1), k0 + 4 * (mat >> 1)));
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), hi[i], lo[i]);
}

// A fragment of rows m0.., columns k0.. of the transpose of a swizzled
// [k][m] tile (A[m][k] = s[k][m]); 32-bit loads, as ldmatrix's transpose
// moves 16-bit halves
template <int W>
__device__ __forceinline__ void load_at(const float* s, int m0, int k0,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = lane_g(), t = lane_t();
  split(s[swz<W>(k0 + t, m0 + g)], hi[0], lo[0]);
  split(s[swz<W>(k0 + t, m0 + g + 8)], hi[1], lo[1]);
  split(s[swz<W>(k0 + t + 4, m0 + g)], hi[2], lo[2]);
  split(s[swz<W>(k0 + t + 4, m0 + g + 8)], hi[3], lo[3]);
}

// B fragment from a swizzled [n][k] tile (B is the tile transposed)
template <int W>
__device__ __forceinline__ void load_bt(const float* s, int n0, int k0,
                                        uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const int l = threadIdx.x & 31;
  uint32_t r[2];
  ldsm_x2(r, s + swz<W>(n0 + (l & 7), k0 + 4 * ((l >> 3) & 1)));
#pragma unroll
  for (int i = 0; i < 2; ++i) split(__uint_as_float(r[i]), hi[i], lo[i]);
}

// the B fragments of n tiles n0 and n0 + 8 from a swizzled [n][k] tile
template <int W>
__device__ __forceinline__ void load_bt2(const float* s, int n0, int k0,
                                         uint32_t (&hi)[2][2],
                                         uint32_t (&lo)[2][2]) {
  const int l = threadIdx.x & 31, mat = l >> 3;
  uint32_t r[4];
  ldsm_x4(r, s + swz<W>(n0 + (l & 7) + 8 * (mat >> 1), k0 + 4 * (mat & 1)));
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split(__uint_as_float(r[i]), hi[i >> 1][i & 1], lo[i >> 1][i & 1]);
}

// B fragment from a swizzled [k][n] tile
template <int W>
__device__ __forceinline__ void load_b(const float* s, int k0, int n0,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const int g = lane_g(), t = lane_t();
  split(s[swz<W>(k0 + t, n0 + g)], hi[0], lo[0]);
  split(s[swz<W>(k0 + t + 4, n0 + g)], hi[1], lo[1]);
}

// cp.async: `bytes` of 16 (or 4) from global, the rest of the chunk zeroed
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::);
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_wait_all() { cp_wait<0>(); }

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace
