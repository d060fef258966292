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
//   rglru_fwd: each thread loads UNROLL steps of a and bx into
//   registers, then runs the chain over them.
//
//   rglru_bwd: a ring in shared memory of STAGES stages of STEPS steps of the
//   warp's 32 columns of a, dh and h[t-1], filled by cp.async walking time
//   backwards (16-byte copies, 8 lanes a 128-byte row, when W % 4 == 0 and
//   the inputs are 16-byte aligned; else each lane copies its own column).
//   While the chain runs over one stage, the next STAGES - 1 are in flight:
//   3 x 16 = 48 steps, 18 KB a warp, ~36 KB an SM, where ~25 KB an SM cover
//   ~1 us of loaded latency at 3.35 TB/s.  Occupancy: a block is BWD_WARPS
//   warps (1), each with 24 KB of ring (4 x 16 x 3 x 32 floats), so every
//   SM can hold all the warps it is given.  The chain is unchanged (same order, __fadd_rn,
//   __fmul_rn, no FMA), so the kernel stays bit-equal to the plain version;
//   a chunked scan would change the order of the roundings.  h0 enters at
//   t = 0 in place of h[-1]; the last stage holds the first L % STEPS steps
//   when L is no multiple of STEPS; lanes past W copy and store nothing.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "../../csrc/mma_tf32.cuh"

namespace {

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

constexpr int NT = 32;      // threads per block: one warp
constexpr int UNROLL = 16;  // steps loaded ahead of the dependent chain

__global__ void __launch_bounds__(NT)
rglru_fwd_kernel(const float* __restrict__ a, const float* __restrict__ bx,
                 const float* __restrict__ h0, float* __restrict__ h,
                 float* __restrict__ hT, int L, int W) {
  const int w = blockIdx.x * NT + threadIdx.x;
  if (w >= W) return;
  const int b = blockIdx.y;
  const size_t col = (size_t)b * L * W + w;
  float carry = h0 != nullptr ? h0[(size_t)b * W + w] : 0.f;
  int t = 0;
  for (; t + UNROLL <= L; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t i = col + (size_t)(t + u) * W;
      av[u] = __ldg(a + i);
      bv[u] = __ldg(bx + i);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      carry = __fadd_rn(__fmul_rn(av[u], carry), bv[u]);
      h[col + (size_t)(t + u) * W] = carry;
    }
  }
  for (; t < L; ++t) {
    const size_t i = col + (size_t)t * W;
    carry = __fadd_rn(__fmul_rn(__ldg(a + i), carry), __ldg(bx + i));
    h[i] = carry;
  }
  hT[(size_t)b * W + w] = carry;
}

constexpr int BWD_WARPS = 1;  // warps per block, each with its own ring
constexpr int STEPS = 16;     // steps of one ring stage
constexpr int STAGES = 4;     // ring stages: STAGES - 1 in flight
constexpr int RING = STAGES * 3 * STEPS * 32;  // floats a warp: a, dh, h[t-1]

// Copy stage k of the reverse walk, steps [max(0, hi - STEPS), hi) with hi
// = L - k STEPS, into ring slot st: row u of array q (a, dh, h[t-1]) holds
// step t = hi - STEPS + u.  h[-1] (h0) is not copied.
__device__ __forceinline__ void issue_stage(float* st, const float* __restrict__ a,
                                            const float* __restrict__ dh,
                                            const float* __restrict__ h,
                                            size_t base, int w0, int hi, int W,
                                            bool vec) {
  const int lane = threadIdx.x & 31;
  const float* src[3] = {a, dh, h};
  if (vec) {
    for (int i = lane; i < 3 * STEPS * 8; i += 32) {
      const int q = i / (STEPS * 8), u = i / 8 % STEPS, col = w0 + 4 * (i % 8);
      const int t = hi - STEPS + u, row = q == 2 ? t - 1 : t;
      if (row >= 0 && col < W)
        cp_async16(st + (q * STEPS + u) * 32 + 4 * (i % 8),
                   src[q] + base + (size_t)row * W + col, 16);
    }
  } else if (w0 + lane < W) {
    for (int i = 0; i < 3 * STEPS; ++i) {
      const int q = i / STEPS, u = i % STEPS;
      const int t = hi - STEPS + u, row = q == 2 ? t - 1 : t;
      if (row >= 0)
        cp_async4(st + i * 32 + lane,
                  src[q] + base + (size_t)row * W + w0 + lane, 4);
    }
  }
}

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
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < stages)
      issue_stage(ring + k * (RING / STAGES), a, dh, h, base, w0, L - k * STEPS,
                  W, vec);
    cp_commit();
  }
  const float first = live && h0 != nullptr ? h0[(size_t)b * W + w] : 0.f;
  float c = live ? dhT[(size_t)b * W + w] : 0.f;
  for (int k = 0; k < stages; ++k) {
    cp_wait<STAGES - 2>();  // stage k landed (the next STAGES - 2 in flight)
    __syncwarp();           // ... for every lane; all are done with stage k - 1
    const int next = k + STAGES - 1;
    if (next < stages)
      issue_stage(ring + next % STAGES * (RING / STAGES), a, dh, h, base, w0,
                  L - next * STEPS, W, vec);
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
  const dim3 grid((W + NT - 1) / NT, B);
  rglru_fwd_kernel<<<grid, NT, 0, stream>>>(a, bx, h0, h, hT, L, W);
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
