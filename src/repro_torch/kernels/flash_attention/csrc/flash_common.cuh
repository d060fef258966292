// What the fp32 (flash_attention.cu) and 16-bit (flash_attention_16.cu)
// flash kernels share: the launch geometry, the masks of the reference
// (causal, sliding window, tanh softcap, queries right-aligned when S < T),
// the visible tile range a block walks, and the copies, zero rows and
// launch helpers of their 256-thread blocks.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "../../csrc/mma_tf32.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 256;  // threads per block (8 warps)
constexpr int kBadHeadDim = -1;
constexpr int kNoScratch = -2;

struct Geom {
  int B, S, T, H, Hkv;
  int causal, window;
  float softcap, sm_scale;
};

__device__ __forceinline__ int num_valid_rows(const int* nv, int B) {
  return nv ? *nv : B;
}

// Does any pair of (query rows [q_first, q_last], keys [k_first, k_last])
// survive the masks?  Positions are absolute key positions.
__device__ __forceinline__ bool tile_visible(int q_first, int q_last,
                                             int k_first, int k_last,
                                             const Geom& g) {
  if (g.causal && k_first > q_last) return false;
  if (g.window > 0 && k_last <= q_first - g.window) return false;
  return true;
}

__device__ __forceinline__ bool pair_visible(int qpos, int kpos,
                                             const Geom& g) {
  if (kpos >= g.T) return false;
  if (g.causal && kpos > qpos) return false;
  if (g.window > 0 && kpos <= qpos - g.window) return false;
  return true;
}

__device__ __forceinline__ float soft(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

// first and last of `n` tiles of `len` rows along one axis (the keys when
// ITER_KEYS, else the queries) that any visible pair reaches from the other
// axis' tile [other0, other0 + other_len); the visible tiles are contiguous
// (causal and window each cut one end)
template <bool ITER_KEYS>
__device__ __forceinline__ int2 visible_range(int n, int len, int other0,
                                              int other_len, const Geom& g) {
  const int shift = g.T - g.S;
  int lo = n, hi = -1;
  for (int i = 0; i < n; ++i) {
    const bool vis =
        ITER_KEYS ? tile_visible(other0 + shift, other0 + shift + other_len - 1,
                            i * len, i * len + len - 1, g)
             : tile_visible(i * len + shift, i * len + shift + len - 1,
                            other0, other0 + other_len - 1, g);
    if (vis) {
      lo = min(lo, i);
      hi = i;
    }
  }
  return make_int2(lo, hi);
}

// rows [row0, row0 + nrows) of head `head` of a (B, L, NH, D) fp32 tensor
// set to zero
template <int D>
__device__ __forceinline__ void zero_rows(float* __restrict__ dst, int b,
                                          int row0, int nrows, int L, int NH,
                                          int head) {
  for (int i = threadIdx.x; i < nrows * D; i += NT) {
    const int r = i / D, c = i % D, row = row0 + r;
    if (row < L) dst[((size_t)(b * L + row) * NH + head) * D + c] = 0.f;
  }
}

// R entries of a (B, H, S) row statistic (lse, delta) from row0; 0 past S
template <int R>
__device__ __forceinline__ void copy_rows(float* dst,
                                          const float* __restrict__ src,
                                          size_t at, int row0, int S) {
  for (int r = threadIdx.x; r < R; r += NT) {
    const bool in = row0 + r < S;
    cp_async4(dst + r, in ? src + at + row0 + r : src, in ? 4 : 0);
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
