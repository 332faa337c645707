// Furthest point sampling: for each of B clouds of n points, m indices;
// index 0 is `first`, each next one the point whose squared distance to
// the chosen set is largest (the first such index on ties).
//
// Replaces repro/kernels/fps/kernel.py::fps_update_kernel (one FPS step:
// dist = min(dist, |x - p|^2) and a per-block max/argmax) together with
// the loop around it in repro/kernels/fps/ops.py::fps_pallas, which
// launches one grid per step and reduces the block maxima on the host
// side of the kernel.  Here one CTA owns one cloud and runs the whole
// m-step loop inside the kernel: B clouds are one launch of B CTAs, not
// m launches per cloud.
//
//   set-up   the cloud goes to shared memory as three float planes, with
//            dist (n floats) beside it: 16 B a point, so n is bounded by
//            the block's shared memory (the wrapper raises above it)
//   step     each thread updates its strided points' dist and keeps its
//            own best (value, index) -- ascending indices, so a strict >
//            keeps the first; then a warp argmax by shuffles and one warp
//            over the warps' results, comparing (value, -index), so the
//            first index wins every tie as jnp.argmax does
//
// Squared distances are summed (dx*dx + dy*dy) + dz*dz, the reference
// body's order; the build uses --fmad=false, so each product and sum
// rounds once, as in the plain PyTorch version.
//
// Bound on the H100: the work is m-1 dependent steps, each a pass over n
// points (about 10 fp32 operations a point) and a block-wide argmax with
// two barriers.  At the encoder's shapes (n <= 2048) the pass is a few
// hundred cycles and the serial chain of reductions, not bytes or
// operations, sets the time: the design keeps everything a step touches
// in shared memory and registers, and spends one block per cloud so that
// a batch fills the card in parallel.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;

__device__ __forceinline__ void keep_better(float& v, int& i, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, v, off);
    const int oi = __shfl_down_sync(kFull, i, off);
    keep_better(v, i, ov, oi);
  }
}

__global__ void fps_kernel(const float* __restrict__ points, int n, int m,
                           int first, int* __restrict__ out) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + n;
  float* zs = ys + n;
  float* dist = zs + n;
  float* warp_v = dist + n;
  int* warp_i = reinterpret_cast<int*>(warp_v + kMaxWarps);
  int* sel = warp_i + kMaxWarps;

  const float* p = points + (int64_t)blockIdx.x * n * 3;
  int* o = out + (int64_t)blockIdx.x * m;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    xs[i] = p[3 * i];
    ys[i] = p[3 * i + 1];
    zs[i] = p[3 * i + 2];
    dist[i] = INFINITY;
  }
  if (threadIdx.x == 0) {
    *sel = first;
    o[0] = first;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int it = 1; it < m; ++it) {
    const int s = *sel;  // written before the last barrier
    const float sx = xs[s], sy = ys[s], sz = zs[s];
    float bv = -INFINITY;
    int bi = INT32_MAX;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float dx = xs[i] - sx, dy = ys[i] - sy, dz = zs[i] - sz;
      float d2 = dx * dx;
      d2 = d2 + dy * dy;
      d2 = d2 + dz * dz;
      const float nd = fminf(dist[i], d2);
      dist[i] = nd;
      if (nd > bv) {
        bv = nd;
        bi = i;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? warp_v[lane] : -INFINITY;
      bi = lane < nwarps ? warp_i[lane] : INT32_MAX;
      warp_argmax(bv, bi);
      if (lane == 0) {
        *sel = bi;
        o[it] = bi;
      }
    }
    __syncthreads();  // sel is read, warp_v rewritten, by the next step
  }
}

// Shared memory for a cloud of n points: four float planes, the per-warp
// (value, index) slots and the chosen index.  kernels/fps/ops.py::
// smem_bytes mirrors it to reject a cloud that does not fit.
int fps_smem_bytes(int n) {
  return (4 * n + kMaxWarps) * 4 + (kMaxWarps + 1) * 4;
}

}  // namespace

// points (batch, n, 3) fp32; out (batch, m) int32.  threads: a multiple
// of 32, at most 1024.  Returns the launch error, if any.
extern "C" int fps_launch(const float* points, int batch, int n, int m,
                          int first, int threads, int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = fps_smem_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (batch > 0) {
    fps_kernel<<<batch, threads, smem, s>>>(points, n, m, first, out);
  }
  return static_cast<int>(cudaGetLastError());
}
