// Selective scan of the hybrid (Hymba) layers' SSM branch: for each batch
// row b, inner channel e and state column j, from h0 (or zero),
//
//   h[t, e, j] = exp(dt[t] A[e, j]) h[t - 1, e, j] + (dt[t] x[t, e]) B[t, j]
//   y[t, e]    = sum_j h[t, e, j] C[t, j]
//
// and the final state h[S - 1] (B, di, n), all in fp32.
//
// Replaces no Pallas kernel: the reference runs this as an XLA loop,
// repro/models/ssm.py::ssm_scan's lax.scan over S (:47-73).  A PyTorch loop
// over S makes ~8 launches a step (a Hymba prefill of 32 layers over 10,000
// tokens: ~2.5 M launches), so the scan is one launch here.
//
// Design (simple and right first): one thread a state element (b, e, j),
// n = 16 lanes a channel, so two channels a warp and B di n threads in all
// (25,600 a batch row at Hymba's di 1,600).  The state lives in a register
// and the thread walks t in order.  Steps go in blocks of U: the block's
// dt, x, B and C are loaded first (they do not depend on h, so the loads
// of a block are in flight together), then every exp(dt A) and (dt x) B of
// the block, then the dependent chain h = decay h + u B, one multiply and
// one add a step; y's n-wide sum runs over the channel's lanes by
// shuffles, and lane 0 of the channel writes it.  Gate inputs are read in
// their dtype (fp32 or bf16) and widened in registers: the same values as
// the reference's cast to fp32 first.
//
// Order of operations: the plain version's (kernels/ssm_scan/ref.py), and
// the build's --fmad=false keeps decay * h + u * B two multiplies and an
// add, so the state agrees with it bit for bit where expf and torch.exp
// agree; y's sum runs in another order (a tree over the lanes) than the
// plain version's einsum, to kernels/ssm_scan/cases.py::TOL.
//
// Bound on the H100 at Hymba's prefill (B 8 x S 1,024, di 1,600, n 16, bf16
// gates): xi in (26 MB) and y out (52 MB fp32) at 3.35 TB/s, ~0.024 ms,
// against B S di n = 210 M state elements of one exponential and ~7 fp32
// operations each, ~0.025 ms at 67 TFLOP/s (chip_smoke.py::ssm_scan_bound).
// What holds the design back: the serial chain over S a thread, and at B 1
// only 800 warps on 132 SMs to cover the loads' latency.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads a CTA
constexpr int U = 16;     // steps a block: their loads are in flight together

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Args {
  const void* x;    // (B, S, di), strides (sxb, sxs, 1)
  const void* bm;   // (B, S, n), strides (sbb, sbs, 1)
  const void* cm;   // (B, S, n), strides (scb, scs, 1)
  const void* dt;   // (B, S), strides (sdb, sds)
  const float* A;   // (di, n) contiguous
  const float* h0;  // (B, di, n) contiguous, or null (zero)
  float* y;         // (B, S, di) contiguous
  float* hT;        // (B, di, n) contiguous
  int B, S, di;
  long long sxb, sxs, sbb, sbs, scb, scs, sdb, sds;
};

template <typename T, int N>
__global__ void __launch_bounds__(NT) ssm_scan_kernel(const Args a) {
  const long long rows = static_cast<long long>(a.B) * a.di;
  const long long gid =
      static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  const int j = threadIdx.x % N;
  const long long want = gid / N;
  const bool live = want < rows;
  // lanes past the last channel run the loop on the last channel's
  // inputs (the shuffles want every lane of the warp) and store nothing
  const long long row = live ? want : rows - 1;
  const int b = static_cast<int>(row / a.di), e = static_cast<int>(row % a.di);

  const T* __restrict__ xp = static_cast<const T*>(a.x) + b * a.sxb + e;
  const T* __restrict__ bp = static_cast<const T*>(a.bm) + b * a.sbb + j;
  const T* __restrict__ cp = static_cast<const T*>(a.cm) + b * a.scb + j;
  const T* __restrict__ dp = static_cast<const T*>(a.dt) + b * a.sdb;
  float* __restrict__ yp = a.y + static_cast<long long>(b) * a.S * a.di + e;
  const float Aej = __ldg(a.A + static_cast<long long>(e) * N + j);
  float h = a.h0 != nullptr ? __ldg(a.h0 + row * N + j) : 0.f;
  const bool writer = live && j == 0;

#pragma unroll 1
  for (int t0 = 0; t0 < a.S; t0 += U) {
    float dv[U], xv[U], bv[U], cv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u < a.S ? t0 + u : a.S - 1;
      dv[u] = to_f(dp[t * a.sds]);
      xv[u] = to_f(xp[t * a.sxs]);
      bv[u] = to_f(bp[t * a.sbs]);
      cv[u] = to_f(cp[t * a.scs]);
    }
    // exp(dt A) and (dt x) B ahead of the chain; dv, bv take them
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float decay = expf(dv[u] * Aej);
      bv[u] = (dv[u] * xv[u]) * bv[u];
      dv[u] = decay;
    }
    const int steps = a.S - t0 < U ? a.S - t0 : U;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < steps) {
        h = dv[u] * h + bv[u];
        float p = h * cv[u];
#pragma unroll
        for (int off = N / 2; off > 0; off >>= 1) {
          p += __shfl_xor_sync(0xffffffffu, p, off);
        }
        if (writer) yp[static_cast<long long>(t0 + u) * a.di] = p;
      }
    }
  }
  if (live) a.hT[row * N + j] = h;
}

template <typename T, int N>
int launch(const Args& a, cudaStream_t s) {
  const long long threads = static_cast<long long>(a.B) * a.di * N;
  const long long grid = (threads + NT - 1) / NT;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ssm_scan_kernel<T, N><<<static_cast<unsigned>(grid), NT, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_width(const Args& a, int n, cudaStream_t s) {
  switch (n) {
    case 8: return launch<T, 8>(a, s);
    case 16: return launch<T, 16>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (B, S, di), bm and cm (B, S, n), dt (B, S): one dtype, fp32 (bf16 == 0)
// or bf16, each at its strides with a unit stride on the last axis (dt at
// (sdb, sds)); A (di, n) fp32 contiguous; h0 (B, di, n) fp32 contiguous or
// null; y (B, S, di) and hT (B, di, n) fp32 contiguous.  n in {8, 16}.
// Returns the launch error, if any (cudaErrorInvalidValue for
// arguments out of range).
extern "C" int ssm_scan_launch(const void* x, const void* bm, const void* cm,
                               const void* dt, const float* A,
                               const float* h0, float* y, float* hT, int B,
                               int S, int di, int n, long long sxb,
                               long long sxs, long long sbb, long long sbs,
                               long long scb, long long scs, long long sdb,
                               long long sds, int bf16, void* stream) {
  if (B < 0 || S < 0 || di < 1 || (n != 8 && n != 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 0) {   // the state passes through
    const size_t bytes = sizeof(float) * static_cast<size_t>(B) * di * n;
    return static_cast<int>(
        h0 != nullptr
            ? cudaMemcpyAsync(hT, h0, bytes, cudaMemcpyDeviceToDevice, s)
            : cudaMemsetAsync(hT, 0, bytes, s));
  }
  const Args a{x,   bm,  cm,  dt,  A,   h0,  y,   hT,  B, S, di,
               sxb, sxs, sbb, sbs, scb, scs, sdb, sds};
  return bf16 ? by_width<__nv_bfloat16>(a, n, s) : by_width<float>(a, n, s);
}
