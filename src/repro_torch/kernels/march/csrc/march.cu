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
// Every step keeps the reference's order and roundings (--fmad=false, and
// the intrinsics below spell each rounding out):
//   npos = pos + dirv * cell
//   ij   = (int) floorf((npos - origin) / cell)     IEEE division
//   occ  = grid[i, j] inside the grid, true outside
//   hit  = occ | (dist + cell >= max_range)
// A ray's outputs are those of its first step that hits, with active = 0,
// or, if none does, of the call's last step, with active = 1; a ray
// inactive on entry is left as it is.
//
// Bound on the H100: the bytes (the grid once, 21 B of ray state in and
// 13 B out a ray: ~0.19 MB at Fig. 19's 4,608 rays and 192 x 192 grid)
// take ~0.06 us, the ~12 operations a live ray-step less.  The only true
// chain is a ray's running position and distance: one fp32 add each a
// step, ~121 adds (~0.25 us) for a whole cast.
//
// The first design ran one thread a ray through a serial loop: each step's
// exit test waited on two IEEE divides and on the grid load they address,
// and the next step began only after it (~500 cycles a step), on 36 CTAs
// of 128 threads (a quarter of the SMs), each warp held to its longest of
// 32 rays.  This design:
//   * spreads a ray over kLanes lanes of a warp, interleaved: lane l takes
//     steps l, l + kLanes, ... (kLanes x as many threads, so every SM has
//     work, and a warp waits on its longest of 32 / kLanes rays);
//   * marches in rounds of kLanes x kSteps steps.  Each lane runs the
//     ray's serial chain of adds itself (the same adds in the same order,
//     so the same bits), keeping its own steps' positions; then issues
//     those steps' divides and grid loads, which depend on nothing but
//     their own position; a ballot a step finds the ray's first hit, and
//     the lane that marched it writes the outputs.  The adds of the next
//     round do not wait on this round's loads, so the compiler overlaps
//     them: a round costs about one divide, one load and a ballot;
//   * stages a grid of up to kStageMax bytes in shared memory (cp.async,
//     overlapped with the rays' first adds); a larger grid, or one whose
//     storage is not 16-byte aligned, is read through L1 instead, by a
//     second instance of the same kernel;
//   * lets a ray inactive on entry cost no divide and no load, and a step
//     past n_steps or past the ray's first hit write nothing; a step
//     outside the grid loads nothing.
// tools/march_variants.py times this design against the first one and
// its variants (lanes x steps, grid in L1, as bytes or bits in shared
// memory, CTA sizes).  On an H100 SXM (700 W), at Fig. 19's dense cast
// (4,608 rays x 121 steps), 16 x 1 with the grid as bytes in shared
// memory took ~4.75 us against the first design's ~34.2 us; through L1
// ~5.4, as bits ~5.3, 8 x 2 ~5.8.  A 16-step chunk takes ~2.3-2.5 us,
// most of it the launch; past it a round of 16 steps costs ~0.3 us, set
// by the SMs' issue (each lane's kLanes adds of the three chains and the
// two IEEE divides a step) more than by any one latency.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 16;       // lanes a ray
constexpr int kSteps = 1;        // steps a lane a round
constexpr int kStageMax = 48 * 1024;   // bytes of grid staged in shared memory

struct Rays {
  float ox, oy, cell, max_range;
  float2* pos;
  const float2* dirv;
  float* dist;
  uint8_t* active;
  int R, n_steps;
};

// The grid read through L1 (the read-only path).
struct GlobalGrid {
  const uint8_t* occ;
  int H, W;
  __device__ __forceinline__ void begin(uint8_t*) const {}
  __device__ __forceinline__ void end() const {}
  __device__ __forceinline__ bool occupied(const uint8_t*, int i,
                                           int j) const {
    return __ldg(occ + static_cast<int64_t>(i) * W + j) != 0;
  }
};

// The grid copied into shared memory as bytes: 16-byte cp.async copies
// (occ 16-byte aligned), the tail by plain loads.
struct SharedGrid {
  const uint8_t* occ;
  int H, W;
  __device__ __forceinline__ void begin(uint8_t* s) const {
    const int n = H * W, n16 = n >> 4;
    for (int k = threadIdx.x; k < n16; k += blockDim.x) {
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(s + 16 * k));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(occ + 16 * k));
    }
    asm volatile("cp.async.commit_group;\n" ::);
    for (int k = 16 * n16 + threadIdx.x; k < n; k += blockDim.x)
      s[k] = occ[k];
  }
  __device__ __forceinline__ void end() const {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  __device__ __forceinline__ bool occupied(const uint8_t* s, int i,
                                           int j) const {
    return s[i * W + j] != 0;
  }
};

// A ray a kLanes-lane segment of a warp; blockDim.x a multiple of 32.
template <int L, int G, class Grid>
__global__ void __launch_bounds__(1024)
    march_kernel(const Grid grid, const Rays q) {
  extern __shared__ __align__(16) uint8_t staged[];
  grid.begin(staged);
  const int lane = threadIdx.x & 31, sub = lane % L;
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / L;
  bool live = r < q.R && q.active[r];
  float px = 0.f, py = 0.f, t = 0.f, cx = 0.f, cy = 0.f;
  if (live) {
    const float2 p = q.pos[r], d = q.dirv[r];
    px = p.x;
    py = p.y;
    t = q.dist[r];
    cx = __fmul_rn(d.x, q.cell);
    cy = __fmul_rn(d.y, q.cell);
  }
  // This lane's first step is step `sub`: its position after sub + 1 adds.
#pragma unroll
  for (int k = 0; k < L; ++k)
    if (k <= sub) {
      px = __fadd_rn(px, cx);
      py = __fadd_rn(py, cy);
      t = __fadd_rn(t, q.cell);
    }
  grid.end();
  const unsigned ray_lanes =
      L == 32 ? ~0u : ((1u << (L & 31)) - 1u) << (lane - sub);
  // `left`: the steps of this call that earlier rounds did not march.
  for (int left = q.n_steps; __any_sync(~0u, live); left -= L * G) {
    float X[G], Y[G], T[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      X[g] = px;
      Y[g] = py;
      T[g] = t;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        px = __fadd_rn(px, cx);
        py = __fadd_rn(py, cy);
        t = __fadd_rn(t, q.cell);
      }
    }
    bool ended = false;
    unsigned who = 0;
    float ex = 0.f, ey = 0.f, et = 0.f;   // the ray's first hit
    float lx = 0.f, ly = 0.f, lt = 0.f;   // this lane's last step marched
#pragma unroll
    for (int g = 0; g < G; ++g) {
      bool hit = false;
      if (live && g * L + sub < left) {
        const int i = static_cast<int>(
            floorf(__fdiv_rn(__fsub_rn(X[g], q.ox), q.cell)));
        const int j = static_cast<int>(
            floorf(__fdiv_rn(__fsub_rn(Y[g], q.oy), q.cell)));
        const bool inb = i >= 0 && i < grid.H && j >= 0 && j < grid.W;
        hit = !inb || T[g] >= q.max_range || grid.occupied(staged, i, j);
        lx = X[g];
        ly = Y[g];
        lt = T[g];
      }
      // step g * L + (lane in the ray) of the round: the lowest set lane
      // of the first g with any is the ray's first hit
      const unsigned b = __ballot_sync(~0u, hit) & ray_lanes;
      if (!ended && b) {
        ended = true;
        who = b;
        ex = X[g];
        ey = Y[g];
        et = T[g];
      }
    }
    if (!live) continue;
    if (ended) {
      if ((who & (0u - who)) == (1u << lane)) {
        q.pos[r] = make_float2(ex, ey);
        q.dist[r] = et;
        q.active[r] = 0;
      }
      live = false;
    } else if (left <= L * G) {
      // no hit in this call: the call's last step, on the lane that marched it
      if ((left - 1) % L == sub) {
        q.pos[r] = make_float2(lx, ly);
        q.dist[r] = lt;
      }
      live = false;
    }
  }
}

// The streaming multiprocessors of the current device (cached).
int sm_count() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!cached[dev]) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n > 0 ? n : 132;
  }
  return cached[dev];
}

// Launch instance <L, G, Grid> with `threads` a CTA, or (threads 0) about
// one CTA an SM: the rays' lanes over the SMs, in whole warps, 32 to 1,024.
template <int L, int G, class Grid>
void launch_march(const Grid& grid, const Rays& q, int threads,
                  size_t smem, cudaStream_t stream) {
  const int64_t lanes = static_cast<int64_t>(q.R) * L;
  if (threads <= 0) {
    const int64_t per_sm = (lanes + sm_count() - 1) / sm_count();
    threads = static_cast<int>(
        per_sm > 1024 ? 1024 : per_sm < 32 ? 32 : (per_sm + 31) / 32 * 32);
  }
  const int64_t blocks = (lanes + threads - 1) / threads;
  march_kernel<L, G, Grid><<<static_cast<unsigned>(blocks), threads, smem,
                             stream>>>(grid, q);
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
    const Rays q{ox, oy, cell, max_range, reinterpret_cast<float2*>(pos),
                 reinterpret_cast<const float2*>(dirv), dist, active, R,
                 n_steps};
    const auto st = static_cast<cudaStream_t>(stream);
    const int64_t cells = static_cast<int64_t>(H) * W;
    if (cells <= kStageMax && reinterpret_cast<uintptr_t>(occ) % 16 == 0)
      launch_march<kLanes, kSteps>(SharedGrid{occ, H, W}, q, 0,
                                   (cells + 15) / 16 * 16, st);
    else
      launch_march<kLanes, kSteps>(GlobalGrid{occ, H, W}, q, 0, 0, st);
  }
  return static_cast<int>(cudaGetLastError());
}
