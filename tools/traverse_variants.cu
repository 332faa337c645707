// Variants of the traverse kernel (src/repro_torch/kernels/traverse/csrc/
// traverse.cu), built and timed beside it by tools/traverse_variants.py.
// Each live lane's word is computed as the shipped kernel computes it
// (node_box.cuh, sact_tile.cuh, the same expressions), so every variant's
// words equal the shipped kernel's bit for bit; what differs is the grid,
// how a lane gets its query's OBB, and how the dead lanes are zeroed:
//   full_late     one thread a lane over the whole capacity; a lane reads
//                 n_live, then (if live) its inputs, then its OBB row (the
//                 kernel of the first CUDA port of traverse)
//   full_direct   the same grid, a lane's inputs loaded beside n_live
//   full_dedupe   the same grid; a warp loads each distinct query's 60-byte
//                 row once into shared memory (__match_any_sync), its lanes
//                 read it there; a warp with no live lane stores its zeros
//                 and ends
//   fixed_direct  a fixed grid of a few CTAs an SM: each CTA reads n_live
//                 once, strides its warps over the live prefix (each lane
//                 loads its own inputs and row), then zeroes [n_live,
//                 capacity) with 16-byte stores
//   fixed_dedupe  the fixed grid with the per-warp row loads of full_dedupe
//   fixed_spec    the shipped kernel's design at any CTAs an SM: the fixed
//                 grid, each thread loading its first lane's inputs beside
//                 n_live and storing its share of the zeros before it
//                 computes (the shipped kernel runs two CTAs an SM)
//   empty         no work, on the whole-capacity grid or on the fixed grid:
//                 what a launch of that grid costs before any work
// Built with the port's nvcc flags (--fmad=false, as the shipped kernel).
#include <cuda_runtime.h>
#include <stdint.h>

#include "../src/repro_torch/kernels/sact/csrc/node_box.cuh"
#include "../src/repro_torch/kernels/sact/csrc/sact_tile.cuh"

namespace {

constexpr int kThreads = 256;

struct Level {
  const float* obb;
  int m;
  const int* q_idx;
  const int* codes;
  const int* full;
  const int* n_live;
  float cell, lo0, lo1, lo2;
  int is_leaf, capacity;
  int* packed;
};

// The word of a live lane whose query's OBB row is o (traverse.cu's).
template <bool SP>
__device__ __forceinline__ int lane_word(const Level& L, const float* o,
                                         int code, int fl) {
  float node_c[3];
  node_centre((uint32_t)code, L.lo0, L.lo1, L.lo2, L.cell, node_c);
  const float node_h = L.cell * 0.5f;
  SactObb ob;
  sact_obb(o, &ob);
  const float t[3] = {ob.c[0] - node_c[0], ob.c[1] - node_c[1],
                      ob.c[2] - node_c[2]};
  const float ah[3] = {node_h, node_h, node_h};
  bool hit;
  const int exit_code = sact_tile<SP, SactMode::kStraight>(ob, t, ah, &hit);
  const bool is_term = fl != 0 || L.is_leaf != 0;
  return (hit ? 1 : 0) | (is_term ? 2 : 0) | (exit_code << 2);
}

// A lane's own OBB row (an index outside [0, m) gathers zeros).
template <bool SP>
__device__ __forceinline__ void direct(const Level& L, int lane, int q,
                                       int code, int fl) {
  float o[15];
  if (q >= 0 && q < L.m) {
    const float* row = L.obb + (int64_t)q * 15;
    for (int k = 0; k < 15; ++k) o[k] = __ldg(row + k);
  } else {
    for (int k = 0; k < 15; ++k) o[k] = 0.0f;
  }
  L.packed[lane] = lane_word<SP>(L, o, code, fl);
}

// The whole warp: each distinct query of its live lanes is loaded once into
// slot[leader], 32 floats a pass, then each live lane computes from its
// group's slot.  Dead lanes take query -1 (a row of zeros, never read).
template <bool SP>
__device__ __forceinline__ void dedupe(const Level& L, float (*slot)[15],
                                       int lane, bool live, int q, int code,
                                       int fl) {
  const int id = threadIdx.x & 31;
  const int qq = live ? q : -1;
  const unsigned grp = __match_any_sync(0xffffffffu, qq);
  const int leader = __ffs(grp) - 1;
  const unsigned leaders = __ballot_sync(0xffffffffu, leader == id);
  const int n_rows = 15 * __popc(leaders);
  for (int e0 = 0; e0 < n_rows; e0 += 32) {
    const int e = e0 + id, gi = e / 15, j = e - 15 * gi;
    unsigned mk = leaders;
    for (int x = 0; x < gi && mk != 0u; ++x) mk &= mk - 1u;
    const int ld = (__ffs(mk) - 1) & 31;
    const int qg = __shfl_sync(0xffffffffu, qq, ld);
    if (e < n_rows) {
      slot[ld][j] = (qg >= 0 && qg < L.m)
                        ? __ldg(L.obb + (int64_t)qg * 15 + j) : 0.0f;
    }
  }
  __syncwarp();
  if (live) L.packed[lane] = lane_word<SP>(L, slot[leader], code, fl);
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads) tv_empty() {}

template <bool SP>
__global__ void __launch_bounds__(kThreads) tv_full_dedupe(Level L) {
  __shared__ float rows[kThreads / 32][32][15];
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const bool in = lane < L.capacity;
  int q = -1, code = 0, fl = 0;
  if (in) {
    q = __ldg(L.q_idx + lane);
    code = __ldg(L.codes + lane);
    fl = __ldg(L.full + lane);
  }
  const int nl = *L.n_live;
  const bool live = in && lane < nl;
  if (in && !live) L.packed[lane] = 0;
  if (lane - (int)(threadIdx.x & 31) >= nl) return;  // the warp is dead
  dedupe<SP>(L, rows[threadIdx.x >> 5], lane, live, q, code, fl);
}

template <bool SP, bool DEDUPE>
__global__ void __launch_bounds__(kThreads) tv_fixed(Level L) {
  __shared__ float rows[DEDUPE ? kThreads / 32 : 1][32][15];
  __shared__ int nl_s;
  if (threadIdx.x == 0) nl_s = min(max(*L.n_live, 0), L.capacity);
  __syncthreads();
  const int nl = nl_s;
  const int stride = gridDim.x * kThreads;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  for (int w0 = t - (int)(threadIdx.x & 31); w0 < nl; w0 += stride) {
    const int lane = w0 + (threadIdx.x & 31);
    const bool live = lane < nl;
    int q = -1, code = 0, fl = 0;
    if (live) {
      q = __ldg(L.q_idx + lane);
      code = __ldg(L.codes + lane);
      fl = __ldg(L.full + lane);
    }
    if (DEDUPE) {
      dedupe<SP>(L, rows[threadIdx.x >> 5], lane, live, q, code, fl);
    } else if (live) {
      direct<SP>(L, lane, q, code, fl);
    }
  }
  // zeros on [nl, capacity): a head up to a multiple of 4 lanes, 16-byte
  // stores, a tail past the last multiple of 4
  const int a = min((nl + 3) & ~3, L.capacity), b = L.capacity & ~3;
  if (t < a - nl) L.packed[nl + t] = 0;
  int4* p4 = reinterpret_cast<int4*>(L.packed);
  for (int i = a / 4 + t; i < b / 4; i += stride) {
    p4[i] = make_int4(0, 0, 0, 0);
  }
  if (b >= a && t < L.capacity - b) L.packed[b + t] = 0;
}

template <bool SP>
__global__ void __launch_bounds__(kThreads) tv_spec(Level L) {
  const int stride = gridDim.x * kThreads;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  int q = 0, code = 0, fl = 0;
  if (t < L.capacity) {
    q = __ldg(L.q_idx + t);
    code = __ldg(L.codes + t);
    fl = __ldg(L.full + t);
  }
  const int nl = min(max(*L.n_live, 0), L.capacity);
  const int a = min((nl + 3) & ~3, L.capacity), b = L.capacity & ~3;
  if (t < a - nl) L.packed[nl + t] = 0;
  int4* p4 = reinterpret_cast<int4*>(L.packed);
  for (int i = a / 4 + t; i < b / 4; i += stride) {
    p4[i] = make_int4(0, 0, 0, 0);
  }
  if (b >= a && t < L.capacity - b) L.packed[b + t] = 0;
  for (int lane = t; lane < nl; lane += stride) {
    if (lane != t) {
      q = __ldg(L.q_idx + lane);
      code = __ldg(L.codes + lane);
      fl = __ldg(L.full + lane);
    }
    direct<SP>(L, lane, q, code, fl);
  }
}

template <bool SP>
__global__ void __launch_bounds__(kThreads) tv_lane(Level L) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= L.capacity) return;
  const int q = __ldg(L.q_idx + lane);
  const int code = __ldg(L.codes + lane);
  const int fl = __ldg(L.full + lane);
  if (lane >= *L.n_live) {
    L.packed[lane] = 0;
    return;
  }
  direct<SP>(L, lane, q, code, fl);
}

template <bool SP>
__global__ void __launch_bounds__(kThreads) tv_late(Level L) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= L.capacity) return;
  if (lane >= *L.n_live) {
    L.packed[lane] = 0;
    return;
  }
  direct<SP>(L, lane, L.q_idx[lane], L.codes[lane], L.full[lane]);
}

int g_sms = 0;

}  // namespace

// which: 0 empty on the whole-capacity grid, 1 full_dedupe, 2 fixed_direct,
// 3 fixed_dedupe, 4 empty on the fixed grid of ctas_per_sm CTAs an SM (at
// most the whole-capacity grid), 5 fixed_spec, 6 full_direct, 7 full_late.
// The arguments after ctas_per_sm are traverse_launch's; packed must be
// 16-byte aligned.  Returns the launch error, if any.
extern "C" int variant_launch(int which, int ctas_per_sm, const float* obb,
                              int m, const int* q_idx, const int* codes,
                              const int* full, const int* n_live, float cell,
                              float lo0, float lo1, float lo2, int is_leaf,
                              int capacity, int* packed, int use_spheres,
                              void* stream) {
  if (capacity <= 0) return 0;
  if (g_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int full_grid = (capacity + kThreads - 1) / kThreads;
  const int fixed_grid = min(full_grid, max(1, ctas_per_sm * g_sms));
  const Level L{obb, m, q_idx, codes, full, n_live, cell, lo0, lo1, lo2,
                is_leaf, capacity, packed};
  const bool sp = use_spheres != 0;
  switch (which) {
    case 0: tv_empty<<<full_grid, kThreads, 0, s>>>(); break;
    case 1:
      if (sp) tv_full_dedupe<true><<<full_grid, kThreads, 0, s>>>(L);
      else tv_full_dedupe<false><<<full_grid, kThreads, 0, s>>>(L);
      break;
    case 2:
      if (sp) tv_fixed<true, false><<<fixed_grid, kThreads, 0, s>>>(L);
      else tv_fixed<false, false><<<fixed_grid, kThreads, 0, s>>>(L);
      break;
    case 3:
      if (sp) tv_fixed<true, true><<<fixed_grid, kThreads, 0, s>>>(L);
      else tv_fixed<false, true><<<fixed_grid, kThreads, 0, s>>>(L);
      break;
    case 4: tv_empty<<<fixed_grid, kThreads, 0, s>>>(); break;
    case 5:
      if (sp) tv_spec<true><<<fixed_grid, kThreads, 0, s>>>(L);
      else tv_spec<false><<<fixed_grid, kThreads, 0, s>>>(L);
      break;
    case 6:
      if (sp) tv_lane<true><<<full_grid, kThreads, 0, s>>>(L);
      else tv_lane<false><<<full_grid, kThreads, 0, s>>>(L);
      break;
    case 7:
      if (sp) tv_late<true><<<full_grid, kThreads, 0, s>>>(L);
      else tv_late<false><<<full_grid, kThreads, 0, s>>>(L);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
