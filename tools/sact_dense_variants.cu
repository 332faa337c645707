// The dense SACT kernel of the parent design, built and timed beside the
// shipped src/repro_torch/kernels/sact/csrc/sact_dense.cu by
// tools/ballquery_sact_variants.py: a (32, 8) block, one thread a pair,
// each thread loading its OBB row and AABB and running the SACT's tests
// as a chain of branches (each lane returns at its first deciding test),
// one byte and one word stored a pair.  The chain is a copy of the body
// the port's kernels shared before sact_tile.cuh became branch-free: the
// same expressions in the same order, so its outputs equal the shipped
// kernel's bit for bit.  Built with the port's nvcc flags (--fmad=false).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-6f;

struct ChainPair {
  float t[3], R[3][3], A[3][3], ah[3], oh[3];
};

template <bool USE_SPHERES>
__device__ __forceinline__ int chain_sact(const ChainPair& p, bool* collide) {
  if (USE_SPHERES) {
    float d2 = 0.0f;
    for (int i = 0; i < 3; ++i) {
      float d = fmaxf(fabsf(p.t[i]) - p.ah[i], 0.0f);
      d2 = d2 + d * d;
    }
    float r_out2 = p.oh[0] * p.oh[0] + p.oh[1] * p.oh[1] + p.oh[2] * p.oh[2];
    float r_in = fminf(fminf(p.oh[0], p.oh[1]), p.oh[2]);
    if (d2 > r_out2) { *collide = false; return 0; }
    if (d2 < r_in * r_in) { *collide = true; return 1; }
  }
  for (int i = 0; i < 3; ++i) {  // L = A_i
    float rb = p.oh[0] * p.A[i][0] + p.oh[1] * p.A[i][1] + p.oh[2] * p.A[i][2];
    if (fabsf(p.t[i]) > p.ah[i] + rb) { *collide = false; return 2 + i; }
  }
  for (int j = 0; j < 3; ++j) {  // L = B_j
    float lhs = fabsf(p.t[0] * p.R[0][j] + p.t[1] * p.R[1][j]
                      + p.t[2] * p.R[2][j]);
    float ra = p.ah[0] * p.A[0][j] + p.ah[1] * p.A[1][j] + p.ah[2] * p.A[2][j];
    if (lhs > ra + p.oh[j]) { *collide = false; return 5 + j; }
  }
  for (int i = 0; i < 3; ++i) {  // L = A_i x B_j
    const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
    for (int j = 0; j < 3; ++j) {
      const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
      float ra = p.ah[i1] * p.A[i2][j] + p.ah[i2] * p.A[i1][j];
      float rb = p.oh[j1] * p.A[i][j2] + p.oh[j2] * p.A[i][j1];
      float lhs = fabsf(p.t[i2] * p.R[i1][j] - p.t[i1] * p.R[i2][j]);
      if (lhs > ra + rb) { *collide = false; return 8 + 3 * i + j; }
    }
  }
  *collide = true;
  return 17;
}

template <bool USE_SPHERES>
__global__ void sact_dense_parent(const float* __restrict__ obb,
                                  const float* __restrict__ aabb,
                                  uint8_t* __restrict__ collide,
                                  int* __restrict__ exit_code, int M, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = blockIdx.y * blockDim.y + threadIdx.y;
  if (m >= M || n >= N) return;
  const float* o = obb + (int64_t)m * 15;
  const float* a = aabb + (int64_t)n * 6;
  ChainPair p;
  for (int i = 0; i < 3; ++i) {
    p.t[i] = o[i] - a[i];
    p.oh[i] = o[3 + i];
    p.ah[i] = a[3 + i];
    for (int j = 0; j < 3; ++j) {
      p.R[i][j] = o[6 + 3 * i + j];
      p.A[i][j] = fabsf(p.R[i][j]) + kEps;
    }
  }
  bool hit;
  const int code = chain_sact<USE_SPHERES>(p, &hit);
  const int64_t k = (int64_t)m * N + n;
  collide[k] = hit ? 1 : 0;
  exit_code[k] = code;
}

}  // namespace

// As sact_dense_launch (without the mode): M at most 65,535 x 8.
extern "C" int sact_dense_parent_launch(const float* obb, const float* aabb,
                                        uint8_t* collide, int* exit_code,
                                        int M, int N, int use_spheres,
                                        void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((N + block.x - 1) / block.x, (M + block.y - 1) / block.y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_spheres) {
    sact_dense_parent<true><<<grid, block, 0, s>>>(obb, aabb, collide,
                                                   exit_code, M, N);
  } else {
    sact_dense_parent<false><<<grid, block, 0, s>>>(obb, aabb, collide,
                                                    exit_code, M, N);
  }
  return static_cast<int>(cudaGetLastError());
}
