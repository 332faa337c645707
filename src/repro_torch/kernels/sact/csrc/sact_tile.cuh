// Staged OBB x AABB separating-axis test for one (OBB, AABB) pair.
//
// Replaces the per-lane body of repro/kernels/sact/kernel.py::sact_tile
// (the Pallas kernels evaluate it vectorised over a tile; here one thread
// evaluates one pair and returns at the first test that decides).  Shared
// by sact_dense.cu and the persistent megakernel, so every arm runs the
// same formulas in the same operation order as the plain PyTorch version
// (repro_torch/kernels/sact/ref.py::sact_tile).  Build with --fmad=false:
// a contracted a*b+c rounds once instead of twice and flips grazing pairs.
//
// Exit codes: 0 bounding-sphere miss, 1 inscribed-sphere hit, 2..7 box
// normal axes, 8..16 edge x edge axes, 17 no separating axis.
#pragma once

#define SACT_EPS 1e-6f

struct SactPair {
  float t[3];      // OBB centre minus AABB centre
  float R[3][3];   // OBB rotation, R[i][j] = component i of OBB axis j
  float A[3][3];   // |R| + eps
  float ah[3];     // AABB half extents
  float oh[3];     // OBB half extents
};

template <bool USE_SPHERES>
__device__ __forceinline__ int sact_tile(const SactPair& p, bool* collide) {
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

// Conditional-return axis tests of an exit code (core/sact.py
// axis_tests_from_exit): sphere exits run none, axis k costs k + 1.
__device__ __forceinline__ int axis_tests_from_exit(int code) {
  return code <= 1 ? 0 : min(code - 1, 15);
}
