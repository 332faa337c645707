// Dense staged SACT over an OBB x AABB plane, one thread per pair.
//
// Replaces repro/kernels/sact/kernel.py::sact_kernel (built by
// make_sact_call): packed OBBs (M, 15) [centre, half, rot row-major] and
// packed AABBs (N, 6) [centre, half] -> collide (M, N) bool and exit code
// (M, N) int32.  The TPU kernel skips the edge stage for a whole tile once
// every lane is decided; here each thread returns at its own first
// separating axis, which gives every lane the same result.
//
// Bound on the H100: the plane's outputs (5 B per pair) against at most
// ~150 fp32 operations per pair, so large planes are write-bound; the
// inputs are read once per block row/column and stay in L1/L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sact_tile.cuh"

template <bool USE_SPHERES>
__global__ void sact_dense_kernel(const float* __restrict__ obb,
                                  const float* __restrict__ aabb,
                                  uint8_t* __restrict__ collide,
                                  int* __restrict__ exit_code, int M, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = blockIdx.y * blockDim.y + threadIdx.y;
  if (m >= M || n >= N) return;
  const float* o = obb + (int64_t)m * 15;
  const float* a = aabb + (int64_t)n * 6;
  SactPair p;
  for (int i = 0; i < 3; ++i) {
    p.t[i] = o[i] - a[i];
    p.oh[i] = o[3 + i];
    p.ah[i] = a[3 + i];
    for (int j = 0; j < 3; ++j) {
      p.R[i][j] = o[6 + 3 * i + j];
      p.A[i][j] = fabsf(p.R[i][j]) + SACT_EPS;
    }
  }
  bool hit;
  const int code = sact_tile<USE_SPHERES>(p, &hit);
  const int64_t k = (int64_t)m * N + n;
  collide[k] = hit ? 1 : 0;
  exit_code[k] = code;
}

extern "C" int sact_dense_launch(const float* obb, const float* aabb,
                                 uint8_t* collide, int* exit_code, int M,
                                 int N, int use_spheres, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((N + block.x - 1) / block.x, (M + block.y - 1) / block.y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_spheres) {
    sact_dense_kernel<true><<<grid, block, 0, s>>>(obb, aabb, collide,
                                                   exit_code, M, N);
  } else {
    sact_dense_kernel<false><<<grid, block, 0, s>>>(obb, aabb, collide,
                                                    exit_code, M, N);
  }
  return static_cast<int>(cudaGetLastError());
}
