// RWKV-6 WKV recurrence: for each batch*head row, from a zero state,
//
//   o_t = r_t S_{t-1} + (r_t . (u (.) k_t)) v_t
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,      w_t = exp(logw_t)
//
// and the final state S_T (D x D, fp32).
//
// Replaces repro/kernels/wkv6/kernel.py::wkv6_kernel (grid (BH, T / L),
// the state in a VMEM scratch carried across the sequential chunk axis,
// each chunk of L steps as log-space cumulative decays, an (L, L) masked
// intra-chunk product and an (L, D) x (D, D) inter-chunk product on the
// MXU).  That form exists for the TPU's matrix unit and its scratch; here
// the recurrence runs step by step, in fp32:
//
//   one CTA per row, DT >= D threads; thread j keeps column j of S in
//   registers (S[:, j] evolves on its own: it needs w, k, r of the step
//   and v_j), so the D x D state never leaves the SM
//   the inputs stream through shared memory in chunks of C steps: each
//   thread loads its column of the next chunk into registers while the
//   block works on the current one (two barriers a chunk, none a step)
//   r, k, v are read in their own dtype (fp32 or bf16), logw in fp32; o
//   is written in r's dtype, the state in fp32
//   threads past D and steps past T are zeros that change nothing, and
//   nothing past T is read or written
//
// Rows are addressed by strides (unit stride on the last axis), so a
// (B, H, T, D) view of the model's (B, T, H, D) projections is read where
// it lies and o is written in the same layout.
//
// Summation: r.S and r.(u (.) k) are summed in four partial sums per
// thread, another order than the plain version's einsum: the two agree to
// a tolerance (kernels/wkv6/cases.py::TOL).  The state update is
// elementwise, w*S + k*v with two roundings (--fmad=false), as in the
// plain version.
//
// Bound on the H100: per row and step about 5 D^2 fp32 operations (r.S,
// and w*S + k*v) against 12 B of input and output per element (bf16
// r, k, v, o; fp32 logw): at D = 64 about 1,700 operations a byte, far
// above the card's fp32 ratio (67 TFLOP/s over 3.35 TB/s = 20), so the
// operations bound it.  This first design keeps the state in registers
// and spends no barrier per step; with one thread per column and a
// serial chain of D products per output, a 64-thread CTA per row leaves
// most of each SM idle at the model's 256 rows (later work: split a
// column's sum over several threads, tensor cores for the chunked form).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// In: the element type of r, k, v and o.  DT: threads (columns, D <= DT).
// C: steps a chunk.
template <typename In, int DT, int C>
__global__ void __launch_bounds__(DT)
    wkv6_kernel(const In* __restrict__ r, const In* __restrict__ k,
                const In* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u, int H, int T, int D, int64_t sb,
                int64_t sh, int64_t st, In* __restrict__ o,
                float* __restrict__ state) {
  __shared__ __align__(16) float r_s[C][DT];
  __shared__ __align__(16) float k_s[C][DT];
  __shared__ __align__(16) float w_s[C][DT];
  __shared__ __align__(16) float ruk_s[C][DT];
  __shared__ float v_s[C][DT];

  const int j = threadIdx.x;
  const int row = blockIdx.x;  // b * H + h
  const int64_t base = (int64_t)(row / H) * sb + (int64_t)(row % H) * sh;
  const bool live = j < D;
  const float uj = live ? u[(int64_t)row * D + j] : 0.f;

  float S[DT];
#pragma unroll
  for (int i = 0; i < DT; ++i) S[i] = 0.f;

  // this thread's column of the next chunk
  float nr[C], nk[C], nv[C], nl[C];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int s = 0; s < C; ++s) {
      const bool in = live && t0 + s < T;
      const int64_t off = base + (int64_t)(t0 + s) * st + j;
      nr[s] = in ? load_f(r + off) : 0.f;
      nk[s] = in ? load_f(k + off) : 0.f;
      nv[s] = in ? load_f(v + off) : 0.f;
      nl[s] = in ? logw[off] : 0.f;
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < T; t0 += C) {
#pragma unroll
    for (int s = 0; s < C; ++s) {
      r_s[s][j] = nr[s];
      k_s[s][j] = nk[s];
      v_s[s][j] = nv[s];
      w_s[s][j] = expf(nl[s]);
      const float ru = nr[s] * uj;
      ruk_s[s][j] = ru * nk[s];
    }
    __syncthreads();
    if (t0 + C < T) fetch(t0 + C);  // in flight while this chunk runs
    const int n = min(C, T - t0);
#pragma unroll 1
    for (int s = 0; s < n; ++s) {
      const float vj = v_s[s][j];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      float b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
#pragma unroll
      for (int i = 0; i < DT; i += 4) {
        const float4 rr = *reinterpret_cast<const float4*>(&r_s[s][i]);
        const float4 kk = *reinterpret_cast<const float4*>(&k_s[s][i]);
        const float4 ww = *reinterpret_cast<const float4*>(&w_s[s][i]);
        const float4 bb = *reinterpret_cast<const float4*>(&ruk_s[s][i]);
        a0 = a0 + rr.x * S[i];
        a1 = a1 + rr.y * S[i + 1];
        a2 = a2 + rr.z * S[i + 2];
        a3 = a3 + rr.w * S[i + 3];
        b0 = b0 + bb.x;
        b1 = b1 + bb.y;
        b2 = b2 + bb.z;
        b3 = b3 + bb.w;
        S[i] = ww.x * S[i] + kk.x * vj;
        S[i + 1] = ww.y * S[i + 1] + kk.y * vj;
        S[i + 2] = ww.z * S[i + 2] + kk.z * vj;
        S[i + 3] = ww.w * S[i + 3] + kk.w * vj;
      }
      const float bonus = (b0 + b1) + (b2 + b3);
      const float out = ((a0 + a1) + (a2 + a3)) + bonus * vj;
      if (live) store_f(o + base + (int64_t)(t0 + s) * st + j, out);
    }
    __syncthreads();  // the chunk's buffers are rewritten next
  }

  if (live) {
    float* dst = state + (int64_t)row * D * D + j;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      if (i < D) dst[(int64_t)i * D] = S[i];
    }
  }
}

template <typename In>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, int rows, int H, int T, int D, int64_t sb,
           int64_t sh, int64_t st, void* o, float* state,
           cudaStream_t s) {
  const In* r_ = static_cast<const In*>(r);
  const In* k_ = static_cast<const In*>(k);
  const In* v_ = static_cast<const In*>(v);
  In* o_ = static_cast<In*>(o);
  if (D <= 32) {
    wkv6_kernel<In, 32, 16><<<rows, 32, 0, s>>>(r_, k_, v_, logw, u, H, T, D,
                                                sb, sh, st, o_, state);
  } else if (D <= 64) {
    wkv6_kernel<In, 64, 16><<<rows, 64, 0, s>>>(r_, k_, v_, logw, u, H, T, D,
                                                sb, sh, st, o_, state);
  } else {
    wkv6_kernel<In, 128, 8><<<rows, 128, 0, s>>>(r_, k_, v_, logw, u, H, T,
                                                 D, sb, sh, st, o_, state);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, o: (B, H, T, D) in the element type (bf16 != 0: bf16, else
// fp32) at strides (sb, sh, st, 1), all four alike; logw: fp32 at the same
// strides; u: (B*H, D) fp32; state: (B*H, D, D) fp32.  1 <= D <= 128.
// Returns the launch error, if any (cudaErrorInvalidValue for a D out of
// range).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const float* logw, const float* u, int B, int H,
                           int T, int D, long long sb, long long sh,
                           long long st, int bf16, void* o, float* state,
                           void* stream) {
  if (D < 1 || D > 128 || B < 0 || H < 1 || T < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * H;
  if (rows == 0) return 0;
  return bf16 ? launch<__nv_bfloat16>(r, k, v, logw, u, rows, H, T, D, sb,
                                      sh, st, o, state, s)
              : launch<float>(r, k, v, logw, u, rows, H, T, D, sb, sh, st, o,
                              state, s);
}
