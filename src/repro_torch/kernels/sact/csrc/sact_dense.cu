// Dense staged SACT over an OBB x AABB plane: a tiled, write-bound kernel.
//
// Replaces repro/kernels/sact/kernel.py::sact_kernel (built by
// make_sact_call): packed OBBs (M, 15) [centre, half, rot row-major] and
// packed AABBs (N, 6) [centre, half] -> collide (M, N) bool and exit code
// (M, N) int32.
//
// Bound on the H100: the plane's outputs, 5 B a pair, against ~50-130
// fp32 operations a pair by exit code.  A paper-scale plane (10,500 OBBs
// x 4,096 cells, 215 MB of outputs) is four times the 50 MB L2, so the
// kernel is bound by its stores to device memory, with the instructions
// it issues a pair close behind.  The design:
//   a CTA owns a tile of kBM OBBs x kBN AABBs; each thread keeps kV
//   consecutive AABBs in registers for the whole CTA, and the CTA stages
//   its OBBs' rows in shared memory once, with every term that depends on
//   the OBB alone (sact_obb: |R| + eps, the sphere radii, the OBB's radius
//   on each face and edge axis), which every lane then reads by broadcast;
//   the tests run through sact_tile.cuh's one body in stages; in the
//   shipped mode a warp runs the OBB's face axes, and then the edge axes,
//   for a box slot only if one of its lanes is still undecided (the Pallas
//   kernel's tile-level lax.cond before the edge stage, per warp, and the
//   same skip before the OBB's faces): on a paper-scale plane more than
//   99 % of the pairs are decided by the box's own face axes, three
//   operations each;
//   for each OBB row a thread stores its kV exit codes as one 16-byte
//   vector and its kV collide bytes as one word, with streaming stores
//   (st.global.cs): the plane overflows the L2 and is not read back here.
// Where rows start off a vector's alignment (N no multiple of kV), each
// warp passes its row through shared memory and stores it lane by lane
// (coalesced 4-byte and 1-byte stores).  The grid covers the AABB tiles in
// x and strides over the OBB tiles in y, so no M is refused.
// kBM, kBN, kV and kStream were chosen by timing; tools/
// ballquery_sact_variants.py builds copies of this file with other values.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sact_tile.cuh"

namespace {

constexpr int kBM = 16;          // OBBs a tile
constexpr int kBN = 512;         // AABBs a tile
constexpr int kV = 4;            // consecutive AABBs a thread
constexpr bool kStream = true;   // streaming stores
constexpr int kThreads = kBN / kV;

static_assert(kV == 2 || kV == 4 || kV == 8, "kV: 2, 4 or 8 boxes a thread");
static_assert(kThreads % 32 == 0 && kThreads <= 1024,
              "kBN / kV: whole warps, at most 1024 threads");

template <typename T>
__device__ __forceinline__ void put(T* p, T v) {
  if constexpr (kStream) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// kV exit codes and kV collide bytes of one row, at a kV-aligned position.
__device__ __forceinline__ void put_row(int* code_at, uint8_t* hit_at,
                                        const int* code, const bool* hit) {
  unsigned lo = 0u, hi = 0u;   // byte v in bits 8v..8v+7 of lo, then hi
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    const unsigned byte = (unsigned)hit[v] << (8 * (v & 3));
    if (v < 4) {
      lo |= byte;
    } else {
      hi |= byte;
    }
  }
  if constexpr (kV == 2) {
    put(reinterpret_cast<int2*>(code_at), make_int2(code[0], code[1]));
    put(reinterpret_cast<unsigned short*>(hit_at), (unsigned short)lo);
  } else {
#pragma unroll
    for (int h = 0; h < kV; h += 4) {
      put(reinterpret_cast<int4*>(code_at + h),
          make_int4(code[h], code[h + 1], code[h + 2], code[h + 3]));
    }
    if constexpr (kV == 4) {
      put(reinterpret_cast<unsigned*>(hit_at), lo);
    } else {
      put(reinterpret_cast<uint2*>(hit_at), make_uint2(lo, hi));
    }
  }
}

template <bool USE_SPHERES, SactMode MODE>
__global__ void __launch_bounds__(kThreads) sact_dense_kernel(
    const float* __restrict__ obb, const float* __restrict__ aabb,
    uint8_t* __restrict__ collide, int* __restrict__ exit_code, int M, int N,
    int vec) {
  __shared__ SactObb obb_s[kBM];
  // a warp's row of codes and bytes, when rows start off a vector's
  // alignment
  __shared__ int code_s[kThreads / 32][32 * kV];
  __shared__ uint8_t hit_s[kThreads / 32][32 * kV];
  const int n0 = blockIdx.x * kBN + threadIdx.x * kV;
  // this thread's boxes (past N: the last box again, never stored)
  float ac[kV][3], ah[kV][3];
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    const float* a = aabb + (int64_t)min(n0 + v, N - 1) * 6;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ac[v][i] = __ldg(a + i);
      ah[v][i] = __ldg(a + 3 + i);
    }
  }
  const int m_tiles = (M + kBM - 1) / kBM;
  for (int mt = blockIdx.y; mt < m_tiles; mt += gridDim.y) {
    const int m0 = mt * kBM, rows = min(kBM, M - m0);
    __syncthreads();   // every lane is done with the last tile's rows
    if (threadIdx.x < rows) {
      sact_obb(obb + (int64_t)(m0 + threadIdx.x) * 15, &obb_s[threadIdx.x]);
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const SactObb& o = obb_s[r];
      int code[kV];
      bool hit[kV];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const float t[3] = {o.c[0] - ac[v][0], o.c[1] - ac[v][1],
                            o.c[2] - ac[v][2]};
        code[v] = sact_tile<USE_SPHERES, MODE>(o, t, ah[v], &hit[v]);
      }
      const int64_t row = (int64_t)(m0 + r) * N;
      if (vec) {
        if (n0 < N) {   // N is a multiple of kV: the whole vector
          put_row(exit_code + row + n0, collide + row + n0, code, hit);
        }
      } else {
        // through shared memory, so that each store is lane-contiguous
        const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          code_s[w][kV * lane + v] = code[v];
          hit_s[w][kV * lane + v] = hit[v];
        }
        __syncwarp();
        const int e0 = n0 - kV * lane;   // the warp's first box
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          const int e = 32 * v + lane;
          if (e0 + e < N) {
            put(exit_code + row + e0 + e, code_s[w][e]);
            put(reinterpret_cast<char*>(collide + row + e0 + e),
                (char)hit_s[w][e]);
          }
        }
        __syncwarp();
      }
    }
  }
}

template <bool USE_SPHERES, SactMode MODE>
cudaError_t launch(const float* obb, const float* aabb, uint8_t* collide,
                   int* exit_code, int M, int N, cudaStream_t s) {
  const int vec = N % kV == 0
                  && reinterpret_cast<uintptr_t>(exit_code) % (4 * kV) == 0
                  && reinterpret_cast<uintptr_t>(collide) % kV == 0;
  const dim3 grid((N + kBN - 1) / kBN, min((M + kBM - 1) / kBM, 65535));
  sact_dense_kernel<USE_SPHERES, MODE><<<grid, kThreads, 0, s>>>(
      obb, aabb, collide, exit_code, M, N, vec);
  return cudaGetLastError();
}

}  // namespace

// obb (M, 15) f32, aabb (N, 6) f32; collide (M, N) u8, exit_code (M, N)
// i32.  mode 0 runs the SACT's stages straight through, 1 with the warp
// vote before the edge stage (sact_tile.cuh's SactMode).  Returns the
// launch error, if any.
extern "C" int sact_dense_launch(const float* obb, const float* aabb,
                                 uint8_t* collide, int* exit_code, int M,
                                 int N, int use_spheres, int mode,
                                 void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == 0) {
    err = use_spheres ? launch<true, SactMode::kStraight>(
                            obb, aabb, collide, exit_code, M, N, s)
                      : launch<false, SactMode::kStraight>(
                            obb, aabb, collide, exit_code, M, N, s);
  } else {
    err = use_spheres ? launch<true, SactMode::kWarpVote>(
                            obb, aabb, collide, exit_code, M, N, s)
                      : launch<false, SactMode::kWarpVote>(
                            obb, aabb, collide, exit_code, M, N, s);
  }
  return static_cast<int>(err);
}
