// Occupancy-grid ray march: MCL's ray cast (paper Fig. 19).  Each of R
// rays steps one cell at a time along its direction until it enters an
// occupied cell, leaves the grid or reaches max_range; a call marches
// n_steps steps, in place.
//
// Replaces no Pallas kernel: the reference's march is a jax.lax.fori_loop
// of repro/core/mcl.py::_march_step (mcl.py:93-99 for the dense cast,
// :119-123 for a chunk of the compacted one), which XLA compiles into one
// device loop per cast.  In eager PyTorch the same loop is ~15 tensor ops
// a step, ~1,800 launches for the 121 steps of Fig. 19's 6 m range; here
// a cast (dense) or a chunk of steps (compacted) is one launch, the
// granularity of the reference's compiled loop.
//
// One thread a ray, its state in registers; per step, in the reference's
// order and roundings (--fmad=false, and the intrinsics below spell each
// rounding out):
//   npos = pos + dirv * cell
//   ij   = (int) floorf((npos - origin) / cell)     IEEE division
//   occ  = grid[i, j] inside the grid, true outside
//   hit  = occ | (dist + cell >= max_range)
// A ray that has ended leaves its loop: the reference's masked steps
// change nothing for it (pos, dist and active keep their values), so the
// outputs are the same.  The grid (36 KB at Fig. 19's 192 x 192) is read
// through the read-only cache; it stays in L1 and L2.
//
// Bound on the H100: the bytes (the grid once, 30 B of ray state in and
// 13 B out a ray: ~0.2 MB at 4,608 rays) take ~0.06 us and the ~12
// operations a live ray-step less; the kernel is a chain of up to 121
// dependent steps a thread, each a divide and a load whose address
// depends on it, so its time is that chain's latency, not either bound.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    march_kernel(const uint8_t* __restrict__ occ, int H, int W, float ox,
                 float oy, float cell, float max_range,
                 float2* __restrict__ pos, const float2* __restrict__ dirv,
                 float* __restrict__ dist, uint8_t* __restrict__ active,
                 int R, int n_steps) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R || !active[r]) return;
  float2 p = pos[r];
  const float2 d = dirv[r];
  float t = dist[r];
  bool live = true;
  for (int s = 0; s < n_steps && live; ++s) {
    const float nx = __fadd_rn(p.x, __fmul_rn(d.x, cell));
    const float ny = __fadd_rn(p.y, __fmul_rn(d.y, cell));
    const int i =
        static_cast<int>(floorf(__fdiv_rn(__fsub_rn(nx, ox), cell)));
    const int j =
        static_cast<int>(floorf(__fdiv_rn(__fsub_rn(ny, oy), cell)));
    const bool inb = i >= 0 && i < H && j >= 0 && j < W;
    const bool blocked =
        !inb || __ldg(occ + static_cast<int64_t>(i) * W + j) != 0;
    const float nt = __fadd_rn(t, cell);
    live = !(blocked || nt >= max_range);
    p = make_float2(nx, ny);
    t = nt;
  }
  pos[r] = p;
  dist[r] = t;
  active[r] = live ? 1 : 0;
}

}  // namespace

// occ (H, W) uint8 (0 free, else occupied); pos, dirv (R, 2) fp32; dist
// (R,) fp32; active (R,) uint8; pos, dist and active are updated in place.
// Returns the launch error, if any (a failed call's error is also the
// runtime's last error, which cudaGetLastError returns and clears).
extern "C" int march_launch(const uint8_t* occ, int H, int W, float ox,
                            float oy, float cell, float max_range,
                            float* pos, const float* dirv, float* dist,
                            uint8_t* active, int R, int n_steps,
                            void* stream) {
  if (H < 1 || W < 1 || R < 0 || n_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R > 0 && n_steps > 0) {
    const int blocks = (R + kThreads - 1) / kThreads;
    march_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        occ, H, W, ox, oy, cell, max_range, reinterpret_cast<float2*>(pos),
        reinterpret_cast<const float2*>(dirv), dist, active, R, n_steps);
  }
  return static_cast<int>(cudaGetLastError());
}
