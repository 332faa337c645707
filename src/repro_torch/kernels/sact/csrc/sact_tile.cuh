// Staged OBB x AABB separating-axis test: the one body of the port's SACT.
//
// Replaces the per-lane body of repro/kernels/sact/kernel.py::sact_tile
// (the Pallas kernels evaluate it vectorised over a tile).  sact_dense.cu,
// traverse.cu and persist.cu all call sact_tile below, so every arm runs
// the same formulas in the same operation order as the plain PyTorch
// version (repro_torch/kernels/sact/ref.py::sact_tile).  Build with
// --fmad=false: a contracted a*b+c rounds once instead of twice and flips
// grazing pairs.
//
// Exit codes: 0 bounding-sphere miss, 1 inscribed-sphere hit, 2..7 box
// normal axes, 8..16 edge x edge axes, 17 no separating axis.
//
// The 18 tests run in four stages, each branch-free: the spheres (bits 0
// and 1), the box's face axes A_i (bits 2..4), the OBB's face axes B_j
// (bits 5..7) and the nine edge axes (bits 8..16).  Each test sets its bit
// when it decides, and the exit code is the lowest bit set (__ffs), the
// first test that decides in stage order: every mode below gives the same
// bits.  The terms that depend on the OBB alone (|R| + eps, the sphere
// radii, the OBB's radius on each face and edge axis) are computed once
// per OBB by sact_obb, each with the expression of the per-pair code, so a
// kernel that tests one OBB against many boxes computes them once.
#pragma once

#define SACT_EPS 1e-6f

// An OBB and its own terms of the tests.
struct SactObb {
  float c[3];           // centre
  float oh[3];          // half extents
  float R[3][3];        // rotation, R[i][j] = component i of OBB axis j
  float A[3][3];        // |R| + eps
  float r_out2, r_in2;  // bounding and inscribed sphere radii, squared
  float rb_face[3];     // L = A_i: the OBB's radius
  float rb_edge[3][3];  // L = A_i x B_j: the OBB's radius
};

// The OBB of a packed row [centre (3), half (3), rotation row-major (9)].
__device__ __forceinline__ void sact_obb(const float* row, SactObb* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o->c[i] = row[i];
    o->oh[i] = row[3 + i];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      o->R[i][j] = row[6 + 3 * i + j];
      o->A[i][j] = fabsf(o->R[i][j]) + SACT_EPS;
    }
  }
  const float* oh = o->oh;
  o->r_out2 = oh[0] * oh[0] + oh[1] * oh[1] + oh[2] * oh[2];
  const float r_in = fminf(fminf(oh[0], oh[1]), oh[2]);
  o->r_in2 = r_in * r_in;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o->rb_face[i] = oh[0] * o->A[i][0] + oh[1] * o->A[i][1]
                    + oh[2] * o->A[i][2];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
      o->rb_edge[i][j] = oh[j1] * o->A[i][j2] + oh[j2] * o->A[i][j1];
    }
  }
}

// Stage 1, bits 0 and 1.  t = OBB centre minus box centre, ah = box half.
template <bool USE_SPHERES>
__device__ __forceinline__ unsigned sact_spheres(const SactObb& o,
                                                 const float t[3],
                                                 const float ah[3]) {
  if (!USE_SPHERES) return 0u;
  float d2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float d = fmaxf(fabsf(t[i]) - ah[i], 0.0f);
    d2 = d2 + d * d;
  }
  return (unsigned)(d2 > o.r_out2) | (unsigned)(d2 < o.r_in2) << 1;
}

// Stage 2, bits 2..4: L = A_i, the box's face axes (3 operations each).
__device__ __forceinline__ unsigned sact_box_faces(const SactObb& o,
                                                   const float t[3],
                                                   const float ah[3]) {
  unsigned decided = 0u;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    decided |= (unsigned)(fabsf(t[i]) > ah[i] + o.rb_face[i]) << (2 + i);
  }
  return decided;
}

// Stage 3, bits 5..7: L = B_j, the OBB's face axes.
__device__ __forceinline__ unsigned sact_obb_faces(const SactObb& o,
                                                   const float t[3],
                                                   const float ah[3]) {
  unsigned decided = 0u;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float lhs = fabsf(t[0] * o.R[0][j] + t[1] * o.R[1][j] + t[2] * o.R[2][j]);
    float ra = ah[0] * o.A[0][j] + ah[1] * o.A[1][j] + ah[2] * o.A[2][j];
    decided |= (unsigned)(lhs > ra + o.oh[j]) << (5 + j);
  }
  return decided;
}

// Stage 4, bits 8..16: L = A_i x B_j.
__device__ __forceinline__ unsigned sact_edges(const SactObb& o,
                                               const float t[3],
                                               const float ah[3]) {
  unsigned decided = 0u;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float ra = ah[i1] * o.A[i2][j] + ah[i2] * o.A[i1][j];
      float lhs = fabsf(t[i2] * o.R[i1][j] - t[i1] * o.R[i2][j]);
      decided |= (unsigned)(lhs > ra + o.rb_edge[i][j]) << (8 + 3 * i + j);
    }
  }
  return decided;
}

// The exit code of the decided bits, and the verdict.
__device__ __forceinline__ int sact_exit(unsigned decided, bool* collide) {
  const int code = decided ? __ffs(decided) - 1 : 17;
  *collide = code == 1 || code == 17;
  return code;
}

// How a kernel runs the stages; every mode gives the same bits.
//   kStraight  all four stages straight through: one lane's tests are
//              independent of one another, so none waits on another
//   kWarpVote  the OBB's faces, and then the edges, run only if a lane of
//              the warp is still undecided (__all_sync over the full warp:
//              every lane of the warp must call it together); the Pallas
//              kernel's tile-level skip of the edge stage, per warp, and
//              the same skip before the OBB's faces
enum class SactMode { kStraight, kWarpVote };

template <SactMode MODE>
__device__ __forceinline__ bool sact_more(unsigned decided) {
  return MODE == SactMode::kStraight || !__all_sync(0xffffffffu, decided);
}

template <bool USE_SPHERES, SactMode MODE>
__device__ __forceinline__ int sact_tile(const SactObb& o, const float t[3],
                                         const float ah[3], bool* collide) {
  unsigned decided = sact_spheres<USE_SPHERES>(o, t, ah)
                     | sact_box_faces(o, t, ah);
  if (sact_more<MODE>(decided)) {
    decided |= sact_obb_faces(o, t, ah);
    if (sact_more<MODE>(decided)) decided |= sact_edges(o, t, ah);
  }
  return sact_exit(decided, collide);
}

// Conditional-return axis tests of an exit code (core/sact.py
// axis_tests_from_exit): sphere exits run none, axis k costs k + 1.
__device__ __forceinline__ int axis_tests_from_exit(int code) {
  return code <= 1 ? 0 : min(code - 1, 15);
}
