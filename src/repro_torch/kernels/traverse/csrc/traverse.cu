// Fused traversal-step test: one wavefront level, frontier lanes in,
// one packed verdict word per lane out.
//
// Replaces repro/kernels/traverse/kernel.py::traverse_kernel (built by
// make_traverse_call).  One thread per frontier lane:
//   1. gathers its query's OBB by q_idx from the packed (m, 15) table --
//      an indexed load where the TPU kernel used a one-hot matmul; an
//      index outside [0, m) gathers zeros, as the one-hot does;
//   2. builds the node's AABB from its Morton code (node_box.cuh);
//   3. runs the staged SACT (sact_tile.cuh, shared with the dense and the
//      persistent kernels);
//   4. marks it terminal when the node is full or the level is the leaf
//      level, and writes collide | is_term << 1 | exit_code << 2.
// Lanes at or past n_live write 0 and load nothing; n_live is read from
// device memory (the previous level's compaction count), so the host
// never waits for it.  The TPU kernel also skips the edge stage for a
// tile whose lanes are all decided; here each thread returns at its own
// first decision, which gives every lane the same word.
//
// Bound on the H100: bytes -- per live lane 4 B q_idx, 4 B code, 4 B
// full, the 60 B OBB and the 4 B word, against ~40-200 fp32 operations
// by exit code.  The design reads each lane's inputs once, coalesced
// except the OBB gather (the table, at most 630 KB at paper scale, stays
// in L2), and launches one thread per lane so that the card is full at
// frontier widths of tens of thousands of lanes.
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
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= capacity) return;
  if (lane >= *n_live) {
    packed[lane] = 0;
    return;
  }
  const int q = q_idx[lane];
  float o[15];
  if (q >= 0 && q < m) {
    const float* row = obb + (int64_t)q * 15;
    for (int k = 0; k < 15; ++k) o[k] = row[k];
  } else {
    for (int k = 0; k < 15; ++k) o[k] = 0.0f;
  }
  float node_c[3];
  node_centre((uint32_t)codes[lane], lo0, lo1, lo2, cell, node_c);
  const float node_h = cell * 0.5f;
  SactPair p;
  for (int i = 0; i < 3; ++i) {
    p.t[i] = o[i] - node_c[i];
    p.oh[i] = o[3 + i];
    p.ah[i] = node_h;
    for (int j = 0; j < 3; ++j) {
      p.R[i][j] = o[6 + 3 * i + j];
      p.A[i][j] = fabsf(p.R[i][j]) + SACT_EPS;
    }
  }
  bool hit;
  const int exit_code = sact_tile<USE_SPHERES>(p, &hit);
  const bool is_term = full[lane] != 0 || is_leaf != 0;
  packed[lane] = (hit ? 1 : 0) | (is_term ? 2 : 0) | (exit_code << 2);
}

}  // namespace

// obb (m, 15) f32; q_idx, codes, full, packed (capacity,) i32; n_live (1,)
// i32 in device memory.  Returns the launch error, if any.
extern "C" int traverse_launch(const float* obb, int m, const int* q_idx,
                               const int* codes, const int* full,
                               const int* n_live, float cell, float lo0,
                               float lo1, float lo2, int is_leaf,
                               int capacity, int* packed, int use_spheres,
                               void* stream) {
  if (capacity <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (capacity + kThreads - 1) / kThreads;
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
