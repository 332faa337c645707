// Furthest point sampling: for each of B clouds of n points, m indices;
// index 0 is `first`, each next one the point whose squared distance to
// the chosen set is largest (the first such index on ties).
//
// Replaces repro/kernels/fps/kernel.py::fps_update_kernel (one FPS step:
// dist = min(dist, |x - p|^2) and a per-block max/argmax) together with
// the loop around it in repro/kernels/fps/ops.py::fps_pallas, which
// launches one grid per step and reduces the block maxima on the host
// side of the kernel.  Here one CTA owns one cloud and runs the whole
// m-step loop inside the kernel: B clouds are one launch of B CTAs.
//
//   set-up   thread `tid` of T holds points j * T + tid (j < P) in
//            registers: x, y, z and dist (+inf; -1 for a slot past n,
//            which fminf keeps at -1, so it never wins).  The cloud also
//            goes to shared memory as three float planes (12 B a point),
//            read once a step for the chosen point's coordinates.
//   step     each thread updates its P distances and keeps its best by the
//            distance's bits (a non-negative float orders like its int
//            bits; ascending j and a strict > keep the first index); the
//            warp takes __reduce_max_sync over the bits, then
//            __reduce_min_sync over the indices of the lanes that hold that
//            maximum, so the first index wins every tie as jnp.argmax does;
//            lane 0 writes (bits, index) to its warp's slot, the slots
//            double-buffered by the step's parity, and after the step's one
//            __syncthreads every warp reduces the slots itself the same
//            way and reads the winner's coordinates from the planes.
//
// A cloud of more than 8 points a thread (past 1,024 x 8 points, at the
// wrapper's thread counts) runs the instance of 16 points, where a thread
// of 1,024 has 64 registers and cannot hold four values of 16 points: it
// keeps the coordinates in the shared planes and only the distances in
// registers.
//
// Squared distances are summed (dx*dx + dy*dy) + dz*dz, the reference
// body's order; the build uses --fmad=false, so each product and sum
// rounds once, as in the plain PyTorch version.
//
// Bound on the H100: the work is m-1 dependent steps, each ~12 fp32 or
// integer operations a point and one block-wide argmax.  At the encoder's
// shapes (n <= 2048, one CTA an SM) a step is the SM's issue of those
// operations (n * 12 / 128 lanes ~ 190 cycles at n = 2048) plus the
// reductions' and the barrier's latency: a serial chain of m - 1 steps
// that neither the bytes (12 B a point, once) nor the card's peak rate
// come near.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlotBytes = 2 * 32 * 8;   // 2 parities x 32 warps x (bits, index)

// Shared memory for a cloud of n points: the slots, then three planes.
// kernels/fps/ops.py::smem_bytes mirrors it.
int fps_smem_bytes(int n) { return kSlotBytes + 12 * n; }

template <int P>
__global__ void __launch_bounds__(1024)
    fps_kernel(const float* __restrict__ points, int n, int m, int first,
               int* __restrict__ out) {
  // 16 points a thread: the coordinates stay in the shared planes
  constexpr bool XYZ_SHARED = P > 8;
  extern __shared__ int2 smem2[];
  int2* slots = smem2;   // [2][32]
  float* xs = reinterpret_cast<float*>(smem2 + 64);
  float* ys = xs + n;
  float* zs = ys + n;

  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const float* p = points + (int64_t)blockIdx.x * n * 3;
  int* o = out + (int64_t)blockIdx.x * m;
  float x[P], y[P], z[P], d[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = j * T + tid;
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    if (i < n) {
      px = p[3 * i];
      py = p[3 * i + 1];
      pz = p[3 * i + 2];
      xs[i] = px;
      ys[i] = py;
      zs[i] = pz;
    }
    x[j] = px;
    y[j] = py;
    z[j] = pz;
    d[j] = i < n ? INFINITY : -1.0f;
  }
  if (tid == 0) o[0] = first;
  __syncthreads();

  float sx = xs[first], sy = ys[first], sz = zs[first];
  for (int it = 1; it < m; ++it) {
    int bk = INT_MIN, bj = 0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float px = x[j], py = y[j], pz = z[j];
      if (XYZ_SHARED) {
        const int i = min(j * T + tid, n - 1);
        px = xs[i];
        py = ys[i];
        pz = zs[i];
      }
      const float dx = px - sx, dy = py - sy, dz = pz - sz;
      float d2 = dx * dx;
      d2 = d2 + dy * dy;
      d2 = d2 + dz * dz;
      d[j] = fminf(d[j], d2);
      const int k = __float_as_int(d[j]);
      if (k > bk) {
        bk = k;
        bj = j;
      }
    }
    const unsigned bi = (unsigned)(bj * T + tid);
    const int wk = __reduce_max_sync(kFull, bk);
    const unsigned wi = __reduce_min_sync(kFull, bk == wk ? bi : kFull);
    int2* slot = slots + (it & 1) * 32;
    if (lane == 0) slot[warp] = make_int2(wk, (int)wi);
    __syncthreads();   // the step's one barrier
    const int2 s = lane < nwarps ? slot[lane] : make_int2(INT_MIN, -1);
    const int gk = __reduce_max_sync(kFull, s.x);
    const unsigned w =
        __reduce_min_sync(kFull, s.x == gk ? (unsigned)s.y : kFull);
    if (tid == 0) o[it] = (int)w;
    sx = xs[w];
    sy = ys[w];
    sz = zs[w];
  }
}

template <int P>
int launch(const float* points, int batch, int n, int m, int first,
           int threads, int* out, cudaStream_t s) {
  // A failed call's error is also the runtime's last error, which
  // cudaGetLastError returns and clears, so that no later launch reports it.
  const int smem = fps_smem_bytes(n);
  if (batch > 0 &&
      (smem <= 48 * 1024 ||
       cudaFuncSetAttribute(fps_kernel<P>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            smem) == cudaSuccess)) {
    fps_kernel<P><<<batch, threads, smem, s>>>(points, n, m, first, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// points (batch, n, 3) fp32; out (batch, m) int32.  threads: a multiple
// of 32, at most 1024; the instance holds ceil(n / threads) points a
// thread, rounded up to 1, 2, 4, 8 or 16 (at most 16; the instance of 16
// keeps the coordinates in shared memory).  Returns the launch error, if
// any.
extern "C" int fps_launch(const float* points, int batch, int n, int m,
                          int first, int threads, int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = (n + threads - 1) / threads;
  if (per <= 1) return launch<1>(points, batch, n, m, first, threads, out, s);
  if (per <= 2) return launch<2>(points, batch, n, m, first, threads, out, s);
  if (per <= 4) return launch<4>(points, batch, n, m, first, threads, out, s);
  if (per <= 8) return launch<8>(points, batch, n, m, first, threads, out, s);
  if (per > 16) return static_cast<int>(cudaErrorInvalidValue);
  return launch<16>(points, batch, n, m, first, threads, out, s);
}
