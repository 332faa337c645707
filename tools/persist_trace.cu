// The persist kernel (src/repro_torch/kernels/persist/csrc/persist.cu)
// with its phase marks defined: thread 0 of every CTA records the SM's
// clock (clock64) and the card's global timer at each mark, into a table
// that persist_trace_read copies out.  Marks, per level: 1 phase A done
// (this thread's run), 2 past the fold barrier, 3 gate and the ranks'
// totals done, 4 count and block scan done, 5 children written, 6 past
// the level's last barrier; 0 the start (past the set-up barrier) and 7
// the end (past the final barrier) in level slots 0 and 15.  Built and
// read by tools/persist_fps_variants.py --trace.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kTraceCtas = 2048;
__device__ long long g_clock[kTraceCtas * 16 * 8];
__device__ unsigned long long g_timer[kTraceCtas * 16 * 8];

__device__ __forceinline__ void persist_mark(int level, int k) {
  if (threadIdx.x != 0 || blockIdx.x >= kTraceCtas) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const int i = (blockIdx.x * 16 + level) * 8 + k;
  g_clock[i] = clock64();
  g_timer[i] = t;
}

#define PERSIST_MARK(level, k) persist_mark(level, k)
#include "../src/repro_torch/kernels/persist/csrc/persist.cu"

// Copies the first n entries of both tables (CTA-major, 16 level slots of
// 8 marks); returns the CUDA error, if any.
extern "C" int persist_trace_read(long long* clocks,
                                  unsigned long long* timers, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(clocks, g_clock, sizeof(long long) * n);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      cudaMemcpyFromSymbol(timers, g_timer, sizeof(unsigned long long) * n));
}

extern "C" int persist_trace_clear() {
  static long long zeros[kTraceCtas * 16 * 8];
  cudaError_t e = cudaMemcpyToSymbol(g_clock, zeros, sizeof(zeros));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaMemcpyToSymbol(g_timer, zeros, sizeof(zeros)));
}
