// RG-LRU linear scan h_t = a_t * h_{t-1} + b_t for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py::_rglru_kernel
// (wrapper `rglru_scan`, oracle repro/kernels/ref.py::rglru_ref): the inner
// loop of RecurrentGemma's RG-LRU once its gates are computed.  a, b:
// (B, S, W), both f32 or both bf16; h0: (B, W) f32; out: (B, S, W) in b's
// dtype.  The carry stays f32 from step to step (it is never rounded to
// bf16); only the stored h is cast, round-to-nearest-even.
//
// Bound: device-memory bytes (a and b read once, h written once; two
// operations per element).  The recurrence is sequential in time, so the
// parallelism is the B*W lanes: 8,192 at RecurrentGemma-9B's width, a few
// warps per SM, far too few to cover memory latency one step at a time.
//
// Design: one thread per (b, w) lane walks over S; neighbouring threads
// own neighbouring w, so each step's loads and stores are coalesced.  The
// loop is software-pipelined: the next kUnroll steps of a and b are loaded
// while the current kUnroll steps are computed, so 2 * kUnroll loads per
// thread are in flight.  Blocks of 64 threads spread the few lanes over
// all SMs.  A parallel-in-time scan is later work.
//
// Built with -fmad=false: h = a * h + b rounds the product and the sum
// separately, as the plain PyTorch version does, so the two are held
// bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

__device__ __forceinline__ float load(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
             const float* __restrict__ h0, T* __restrict__ out, int64_t S,
             int64_t W, int64_t lanes) {
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const int64_t bi = lane / W;
  const int64_t base = bi * S * W + (lane - bi * W);
  float h = h0[lane];  // h0 is (B, W): index bi * W + w == lane
  float an[kUnroll], bn[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (u < S) {
      an[u] = load(a, base + u * W);
      bn[u] = load(b, base + u * W);
    }
  }
  for (int64_t t = 0; t < S; t += kUnroll) {
    float ac[kUnroll], bc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ac[u] = an[u];
      bc[u] = bn[u];
    }
    const int64_t nt = t + kUnroll;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (nt + u < S) {
        an[u] = load(a, base + (nt + u) * W);
        bn[u] = load(b, base + (nt + u) * W);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t + u < S) {
        h = ac[u] * h + bc[u];
        store(out, base + (t + u) * W, h);
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* h0, void* out,
           int64_t B, int64_t S, int64_t W, cudaStream_t stream) {
  const int64_t lanes = B * W;
  const unsigned blocks = (unsigned)((lanes + kThreads - 1) / kThreads);
  rglru_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(h0), static_cast<T*>(out), S, W, lanes);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  a, b, out: (B, S, W)
// contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1); h0: (B, W) contiguous
// f32.  Launches on `stream` and returns cudaGetLastError() (0 on
// success); does not synchronize.
extern "C" int repro_rglru_scan(int bf16, const void* a, const void* b,
                                const void* h0, void* out, int64_t B,
                                int64_t S, int64_t W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, b, h0, out, B, S, W, st)
              : launch<float>(a, b, h0, out, B, S, W, st);
}
