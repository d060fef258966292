// The emulator's state and its launch loop (see cuda_runtime.h).
#include "cuda_runtime.h"

thread_local uint3_ threadIdx;
uint3_ blockIdx, blockDim, gridDim;
size_t emu_smem_limit = 48 * 1024;
std::barrier<>* emu_block_bar;
std::barrier<>* emu_warp_bar[EMU_WARPS];
float emu_warp_f[EMU_WARPS][32][8];
const float* emu_warp_p[EMU_WARPS][32];
char* emu_dyn_smem;
thread_local std::vector<std::vector<EmuCopy>> emu_groups;
thread_local std::vector<EmuCopy> emu_open;

void emu_launch(dim3 grid, unsigned threads, size_t smem,
                std::function<void()> body) {
  if (smem > 48 * 1024 && smem > emu_smem_limit) {
    fprintf(stderr, "launch of %zu B of shared memory above its limit\n", smem);
    abort();
  }
  if (smem > 232448 || threads % 32 || threads / 32 > EMU_WARPS) {
    fprintf(stderr, "launch refused: %zu B, %u threads\n", smem, threads);
    abort();
  }
  std::vector<char> buf(smem + 16);
  emu_dyn_smem = buf.data();
  std::barrier<> bar(threads);
  emu_block_bar = &bar;
  std::vector<std::barrier<>*> warps;
  for (unsigned w = 0; w < threads / 32; ++w)
    warps.push_back(emu_warp_bar[w] = new std::barrier<>(32));
  gridDim.x = grid.x; gridDim.y = grid.y; gridDim.z = grid.z;
  blockDim.x = threads;
  for (unsigned b = 0; b < grid.x * grid.y * grid.z; ++b) {
    blockIdx.x = b % grid.x;
    blockIdx.y = b / grid.x % grid.y;
    blockIdx.z = b / (grid.x * grid.y);
    std::fill(buf.begin(), buf.end(), (char)0xff);
    std::vector<std::thread> pool;
    for (unsigned i = 0; i < threads; ++i)
      pool.emplace_back([&, i] {
        threadIdx.x = i;
        body();
        emu_groups.clear();  // copies never waited for die with the block
        emu_open.clear();
      });
    for (auto& t : pool) t.join();
  }
  for (auto* w : warps) delete w;
}
