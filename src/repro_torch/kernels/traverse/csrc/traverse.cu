// Fused traversal-step test: one wavefront level, frontier lanes in,
// one packed verdict word per lane out.
//
// Replaces repro/kernels/traverse/kernel.py::traverse_kernel (built by
// make_traverse_call).  Per live frontier lane (lanes [0, n_live)):
//   1. gathers its query's OBB by q_idx from the packed (m, 15) table --
//      an indexed load where the TPU kernel used a one-hot matmul; an
//      index outside [0, m) gathers zeros, as the one-hot does;
//   2. builds the node's AABB from its Morton code (node_box.cuh);
//   3. runs the staged SACT straight through (sact_tile.cuh, the one body
//      of the dense and the persistent kernels too);
//   4. marks it terminal when the node is full or the level is the leaf
//      level, and writes collide | is_term << 1 | exit_code << 2.
// Lanes at or past n_live write 0.  n_live is read from device memory (the
// previous level's compaction count), so the host never waits for it.
// The TPU kernel also skips the edge stage for a tile whose lanes are all
// decided; here every lane runs every test (no lane waits on a chain of
// branches), which gives every lane the same word.
//
// Bound on the H100: bytes -- per live lane 4 B q_idx, 4 B code, 4 B
// full and the 4 B word, each OBB named once (60 B), and 4 B a dead lane,
// against ~40-200 fp32 operations a live lane by exit code.  A frontier
// is a live prefix of a fixed capacity (262,144 lanes at the widest cubby
// level, a quarter of them live), and the kernel is short: the launch of
// its grid and one chain of dependent loads a live lane are most of its
// time.  The design:
//   a fixed grid of two CTAs an SM (at most a thread a lane) strides over
//   the live prefix: an empty kernel of that grid takes 0.96 us on an
//   H100, one of a thread a lane over the whole capacity 1.43 us
//   each thread loads its first lane's q_idx, code and full flag beside
//   n_live (every lane below the capacity is in bounds), so it waits for
//   two loads from memory (its inputs, then its OBB row, whose 15 loads
//   are independent) before it computes, not three
//   then it stores its share of the zeros on [n_live, capacity), 16 bytes
//   a store, before it computes: nothing waits on them
//   (A warp that loads each query's row once through shared memory
//   (__match_any_sync) timed slower on every grid: neighbouring lanes'
//   rows already come from L1.  tools/traverse_variants.py times this
//   kernel beside those variants and the empty kernels.)
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../sact/csrc/node_box.cuh"
#include "../../sact/csrc/sact_tile.cuh"

namespace {

constexpr int kThreads = 256;

template <bool USE_SPHERES>
__global__ void __launch_bounds__(kThreads) traverse_kernel(
    const float* __restrict__ obb, int m, const int* __restrict__ q_idx,
    const int* __restrict__ codes, const int* __restrict__ full,
    const int* __restrict__ n_live, float cell, float lo0, float lo1,
    float lo2, int is_leaf, int capacity, int* __restrict__ packed) {
  const int stride = gridDim.x * kThreads;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  int q = 0, code = 0, fl = 0;
  if (t < capacity) {
    q = __ldg(q_idx + t);
    code = __ldg(codes + t);
    fl = __ldg(full + t);
  }
  const int nl = min(max(*n_live, 0), capacity);
  // zeros on [nl, capacity): a head up to a multiple of 4 lanes, 16-byte
  // stores, a tail past the last multiple of 4
  const int a = min((nl + 3) & ~3, capacity), b = capacity & ~3;
  if (t < a - nl) packed[nl + t] = 0;
  int4* p4 = reinterpret_cast<int4*>(packed);
  for (int i = a / 4 + t; i < b / 4; i += stride) {
    p4[i] = make_int4(0, 0, 0, 0);
  }
  if (b >= a && t < capacity - b) packed[b + t] = 0;
  for (int lane = t; lane < nl; lane += stride) {
    if (lane != t) {
      q = __ldg(q_idx + lane);
      code = __ldg(codes + lane);
      fl = __ldg(full + lane);
    }
    float o[15];
    if (q >= 0 && q < m) {
      const float* row = obb + (int64_t)q * 15;
      for (int k = 0; k < 15; ++k) o[k] = __ldg(row + k);
    } else {
      for (int k = 0; k < 15; ++k) o[k] = 0.0f;
    }
    float node_c[3];
    node_centre((uint32_t)code, lo0, lo1, lo2, cell, node_c);
    const float node_h = cell * 0.5f;
    SactObb ob;
    sact_obb(o, &ob);
    const float tv[3] = {ob.c[0] - node_c[0], ob.c[1] - node_c[1],
                         ob.c[2] - node_c[2]};
    const float ah[3] = {node_h, node_h, node_h};
    bool hit;
    const int exit_code =
        sact_tile<USE_SPHERES, SactMode::kStraight>(ob, tv, ah, &hit);
    const bool is_term = fl != 0 || is_leaf != 0;
    packed[lane] = (hit ? 1 : 0) | (is_term ? 2 : 0) | (exit_code << 2);
  }
}

}  // namespace

// obb (m, 15) f32; q_idx, codes, full, packed (capacity,) i32, packed
// 16-byte aligned; n_live (1,) i32 in device memory.  Returns the launch
// error, if any.
extern "C" int traverse_launch(const float* obb, int m, const int* q_idx,
                               const int* codes, const int* full,
                               const int* n_live, float cell, float lo0,
                               float lo1, float lo2, int is_leaf,
                               int capacity, int* packed, int use_spheres,
                               void* stream) {
  if (capacity <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(packed) % 16) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = min((capacity + kThreads - 1) / kThreads, 2 * sms);
  if (use_spheres) {
    traverse_kernel<true><<<grid, kThreads, 0, s>>>(
        obb, m, q_idx, codes, full, n_live, cell, lo0, lo1, lo2, is_leaf,
        capacity, packed);
  } else {
    traverse_kernel<false><<<grid, kThreads, 0, s>>>(
        obb, m, q_idx, codes, full, n_live, cell, lo0, lo1, lo2, is_leaf,
        capacity, packed);
  }
  return static_cast<int>(cudaGetLastError());
}
