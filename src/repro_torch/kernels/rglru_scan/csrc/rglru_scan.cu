// RG-LRU linear-recurrence kernels for Hopper (sm_90a), fp32, forward and
// backward, with a plain C interface (loaded with ctypes).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rglru_scan/kernel.py:
//   rglru_fwd <- rglru_linear_scan / _rglru_kernel
//   rglru_bwd <- its vector-Jacobian product, which the reference does not
//                have (its kernel path cannot be differentiated; it trains
//                through the plain associative scan)
//
// Semantics, per (batch b, column w), over t = 0..L-1:
//   h_t = a_t * h_{t-1} + bx_t,  h_{-1} = h0 (or 0);  hT = h_{L-1}
// and, for cotangents dh (of h) and dhT (of hT), with g_L = 0 and a_L = 0:
//   g_t = dh_t + [t == L-1] dhT + a_{t+1} g_{t+1}
//   da_t = g_t h_{t-1};  dbx_t = g_t;  dh0 = a_0 g_0.
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn, no
// fused multiply-add), in the order the plain PyTorch versions take, so the
// kernels and the plain versions agree to the bit.
//
// Layouts are the reference's: a, bx, h, dh, da, dbx (B,L,W); h0, hT, dhT,
// dh0 (B,W); contiguous fp32.  Any W.
//
// What bounds it on an H100: bytes.  The forward reads a and bx and writes
// h (3 B L W floats), the backward reads a, h, dh and writes da, dbx (5 B L
// W floats), one or two flops per float.  At the recurrentgemma-9b cell
// (B 2, L 2048, W 4096) that is 201 MB and 336 MB, 0.06 and 0.10 ms at
// 3.35 TB/s.
//
// Design.  The TPU kernel tiles W into 128-lane blocks and walks time with
// the carry in vector registers.  Here one thread owns one column w and
// walks its L steps with the carry in a register; consecutive threads own
// consecutive columns, so each step's loads and stores are coalesced 128-byte
// rows of a warp.  One warp per block spreads the warps over as many SMs as
// possible.  The grid is only B W threads (8192 at the cell, 256 warps: about
// two an SM), so each warp must keep many loads in flight to draw the
// memory's rate; the dependent chain itself (two rounded operations a step,
// ~8 cycles) needs ~10 us for 2048 steps, a tenth of the bytes bound.
//
// Both kernels feed the chain from a ring in shared memory, one per warp,
// of STAGES stages of STEPS steps of the warp's 32 columns of their inputs,
// filled by cp.async (issue_rows: 16-byte copies, 8 lanes a 128-byte row,
// when W % 4 == 0 and the inputs are 16-byte aligned; else each lane copies
// its own column).  While the chain runs over one stage, the next STAGES - 1
// are in flight; a wait and a __syncwarp open each stage, so its copies
// have landed for every lane and every lane is done with the slot the next
// copy refills.  Where ~25 KB an SM cover ~1 us of loaded latency at 3.35
// TB/s:
//
//   rglru_fwd: a and bx, walking time forwards, FWD_STAGES x FWD_STEPS
//   steps (2 x 32 floats a step): 3 x 16 = 48 steps, 12 KB, in flight a
//   warp, ~24 KB an SM (more stages in flight measured slower on the H100:
//   tools/kernel_variants.py, PERF.md).  Stage k holds steps [k FWD_STEPS, (k + 1)
//   FWD_STEPS); the last holds L % FWD_STEPS of them when L is no
//   multiple; h0 (or 0) is the carry at t = 0.
//
//   rglru_bwd: a, dh and h[t-1], walking time backwards, STAGES x STEPS
//   steps (3 x 32 floats a step): 3 x 16 = 48 steps, 18 KB, in flight a
//   warp.  Stage k holds steps [L - (k + 1) STEPS, L - k STEPS); the last
//   holds the first L % STEPS steps; h0 enters at t = 0 in place of h[-1].
//
// Blocks are one warp (BWD_WARPS 1), each with 16 KB (fwd) or 24 KB (bwd)
// of ring, so every SM can hold all the warps it is given.  The chain is
// unchanged from the plain version (same order, __fadd_rn, __fmul_rn, no
// FMA), so the kernels stay bit-equal to it; a chunked scan would change
// the order of the roundings.  Lanes past W copy and store nothing.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "../../csrc/mma_tf32.cuh"

namespace {

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// Copy S steps of Q (B,L,W) arrays into ring slot st: row u of array q
// holds row t0 + u - shift[q] of src[q] (h[t-1] in the backward has shift
// 1); rows outside [0, L) and columns past W are not copied.
template <int Q, int S>
__device__ __forceinline__ void issue_rows(float* st,
                                           const float* const (&src)[Q],
                                           const int (&shift)[Q], size_t base,
                                           int w0, int t0, int L, int W,
                                           bool vec) {
  const int lane = threadIdx.x & 31;
  if (vec) {
    for (int i = lane; i < Q * S * 8; i += 32) {
      const int q = i / (S * 8), u = i / 8 % S, c = 4 * (i % 8);
      const int row = t0 + u - shift[q];
      if (row >= 0 && row < L && w0 + c < W)
        cp_async16(st + (q * S + u) * 32 + c,
                   src[q] + base + (size_t)row * W + w0 + c, 16);
    }
  } else if (w0 + lane < W) {
    for (int i = 0; i < Q * S; ++i) {
      const int q = i / S, u = i % S, row = t0 + u - shift[q];
      if (row >= 0 && row < L)
        cp_async4(st + i * 32 + lane,
                  src[q] + base + (size_t)row * W + w0 + lane, 4);
    }
  }
}

constexpr int FWD_STEPS = 16;   // steps of one forward ring stage
constexpr int FWD_STAGES = 4;   // forward ring stages: FWD_STAGES - 1 in flight
constexpr int FWD_SLOT = 2 * FWD_STEPS * 32;  // floats a stage: a, bx

// Forward walk: the carry starts at h0 (or 0) and runs over the stages.
__global__ void __launch_bounds__(32)
rglru_fwd_kernel(const float* __restrict__ a, const float* __restrict__ bx,
                 const float* __restrict__ h0, float* __restrict__ h,
                 float* __restrict__ hT, int L, int W, int vec) {
  extern __shared__ __align__(16) float ring[];
  const int lane = threadIdx.x, w0 = blockIdx.x * 32, w = w0 + lane;
  const bool live = w < W;
  const int b = blockIdx.y;
  const size_t base = (size_t)b * L * W;
  const int stages = (L + FWD_STEPS - 1) / FWD_STEPS;
  const float* const src[2] = {a, bx};
  const int shift[2] = {0, 0};
#pragma unroll
  for (int k = 0; k < FWD_STAGES - 1; ++k) {
    if (k < stages)
      issue_rows<2, FWD_STEPS>(ring + k * FWD_SLOT, src, shift, base, w0,
                               k * FWD_STEPS, L, W, vec);
    cp_commit();
  }
  float carry = live && h0 != nullptr ? h0[(size_t)b * W + w] : 0.f;
  for (int k = 0; k < stages; ++k) {
    cp_wait<FWD_STAGES - 2>();  // stage k landed (the next ones in flight)
    __syncwarp();               // ... for every lane; all are done with k - 1
    const int next = k + FWD_STAGES - 1;
    if (next < stages)
      issue_rows<2, FWD_STEPS>(ring + next % FWD_STAGES * FWD_SLOT, src,
                               shift, base, w0, next * FWD_STEPS, L, W, vec);
    cp_commit();
    const float* st = ring + k % FWD_STAGES * FWD_SLOT;
    if (!live) continue;
#pragma unroll
    for (int u = 0; u < FWD_STEPS; ++u) {
      const int t = k * FWD_STEPS + u;
      if (t >= L) break;  // only in the last stage
      carry = __fadd_rn(__fmul_rn(st[u * 32 + lane], carry),
                        st[(FWD_STEPS + u) * 32 + lane]);
      h[base + (size_t)t * W + w] = carry;
    }
  }
  if (live) hT[(size_t)b * W + w] = carry;
}

constexpr int BWD_WARPS = 1;  // warps per block, each with its own ring
constexpr int STEPS = 16;     // steps of one ring stage
constexpr int STAGES = 4;     // ring stages: STAGES - 1 in flight
constexpr int RING = STAGES * 3 * STEPS * 32;  // floats a warp: a, dh, h[t-1]

// Reverse walk.  c carries a_{t+1} g_{t+1} (dhT at the start); h_{t-1} comes
// from the ring, h0 (or 0) at t = 0.
__global__ void __launch_bounds__(32 * BWD_WARPS)
rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                 const float* __restrict__ h0, const float* __restrict__ dh,
                 const float* __restrict__ dhT, float* __restrict__ da,
                 float* __restrict__ dbx, float* __restrict__ dh0, int L,
                 int W, int vec) {
  extern __shared__ __align__(16) float rings[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = (blockIdx.x * BWD_WARPS + warp) * 32, w = w0 + lane;
  if (w0 >= W) return;  // a whole warp past W (warps sync only themselves)
  float* ring = rings + warp * RING;
  const bool live = w < W;
  const int b = blockIdx.y;
  const size_t base = (size_t)b * L * W;
  const int stages = (L + STEPS - 1) / STEPS;
  const float* const src[3] = {a, dh, h};
  const int shift[3] = {0, 0, 1};
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < stages)
      issue_rows<3, STEPS>(ring + k * (RING / STAGES), src, shift, base, w0,
                           L - (k + 1) * STEPS, L, W, vec);
    cp_commit();
  }
  const float first = live && h0 != nullptr ? h0[(size_t)b * W + w] : 0.f;
  float c = live ? dhT[(size_t)b * W + w] : 0.f;
  for (int k = 0; k < stages; ++k) {
    cp_wait<STAGES - 2>();  // stage k landed (the next STAGES - 2 in flight)
    __syncwarp();           // ... for every lane; all are done with stage k - 1
    const int next = k + STAGES - 1;
    if (next < stages)
      issue_rows<3, STEPS>(ring + next % STAGES * (RING / STAGES), src, shift,
                           base, w0, L - (next + 1) * STEPS, L, W, vec);
    cp_commit();
    const float* st = ring + k % STAGES * (RING / STAGES);
    if (!live) continue;
#pragma unroll
    for (int u = STEPS - 1; u >= 0; --u) {
      const int t = L - (k + 1) * STEPS + u;
      if (t < 0) continue;  // only in the last stage
      const size_t i = base + (size_t)t * W + w;
      const float hp = t > 0 ? st[(2 * STEPS + u) * 32 + lane] : first;
      const float g = __fadd_rn(st[(STEPS + u) * 32 + lane], c);
      da[i] = __fmul_rn(g, hp);
      dbx[i] = g;
      c = __fmul_rn(st[u * 32 + lane], g);
    }
  }
  if (live && dh0 != nullptr) dh0[(size_t)b * W + w] = c;
}

}  // namespace

extern "C" {

// h0 may be null (zero initial state).  Returns cudaGetLastError() after the
// launch.
int rglru_fwd(const float* a, const float* bx, const float* h0, float* h,
              float* hT, int B, int L, int W, cudaStream_t stream) {
  const dim3 grid((W + 31) / 32, B);
  const size_t smem = FWD_STAGES * FWD_SLOT * sizeof(float);
  if (int e = (int)cudaFuncSetAttribute(
          rglru_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem))
    return e;
  const int vec = W % 4 == 0 && aligned16(a) && aligned16(bx);
  rglru_fwd_kernel<<<grid, 32, smem, stream>>>(a, bx, h0, h, hT, L, W, vec);
  return (int)cudaGetLastError();
}

// h0 and dh0 are both null or both set.
int rglru_bwd(const float* a, const float* h, const float* h0,
              const float* dh, const float* dhT, float* da, float* dbx,
              float* dh0, int B, int L, int W, cudaStream_t stream) {
  const dim3 grid((W + 32 * BWD_WARPS - 1) / (32 * BWD_WARPS), B);
  const size_t smem = BWD_WARPS * RING * sizeof(float);
  if (int e = (int)cudaFuncSetAttribute(
          rglru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem))
    return e;
  const int vec = W % 4 == 0 && aligned16(a) && aligned16(dh) && aligned16(h);
  rglru_bwd_kernel<<<grid, 32 * BWD_WARPS, smem, stream>>>(
      a, h, h0, dh, dhT, da, dbx, dh0, L, W, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
