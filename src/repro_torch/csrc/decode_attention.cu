// Flash-decoding for Hopper (sm_90a): one query token against a KV cache.
//
// Replaces the Pallas TPU kernel
// repro/kernels/decode_attention.py::_decode_kernel (wrapper
// `decode_attention`, oracle repro/kernels/ref.py::decode_ref).  q1:
// (BH, 1, Dh); k, v: (BH, S, Dh); contiguous, f32 or bf16; out (BH, 1, Dh)
// in q1's dtype.  Slots at or past `length` are masked; q is scaled in
// f32, the softmax runs online in f32 and its sum is floored at 1e-30, so
// length 0 gives zeros, as on the TPU.
//
// Bound: device-memory bytes.  Each cache row is read once for one dot and
// one axpy: at RecurrentGemma-9B's decode (BH = 2048, S = 2048, Dh = 256,
// bf16) that is 4.29 GB of K and V at full length, 1.28 ms at 3.35 TB/s,
// against ~2 FLOP per byte.  Rows past `length` change nothing, so the
// kernel never reads them.
//
// Design: one block of 4 warps per BH row (2,048 blocks fill the card; a
// split over the cache axis is for small BH and is later work).  Lane l
// owns Dh/32 contiguous columns, so a warp reads a cache row as one
// coalesced 16-byte (bf16) or 32-byte (f32) load per lane.  Warp w takes
// the groups of 8 consecutive slots starting at 8 (4 n + w); it issues the
// group's 8 K rows and 8 V rows before its shuffle reductions, so 16 rows
// per warp are in flight, then updates its own running max, sum and
// accumulator (the TPU kernel's block of kb slots, with kb = 8).  The 4
// warps' states are merged at the end through shared memory.  Built
// without -fmad=false (held to a tolerance).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 8;  // cache slots per warp step

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// four bf16 -> f32, exactly (a bf16 is the top half of its f32)
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q1, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int64_t S,
              int64_t length, float scale) {
  constexpr int EPL = DH / 32;  // columns per lane
  constexpr int NV = EPL / 4;   // float4 groups per lane
  __shared__ float w_m[kWarps], w_l[kWarps];
  __shared__ float w_acc[kWarps][DH];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t bh = blockIdx.x;
  const T* kb = k + bh * S * DH + lane * EPL;
  const T* vb = v + bh * S * DH + lane * EPL;

  float qr[EPL];
#pragma unroll
  for (int g = 0; g < NV; ++g) {
    const float4 x = load4(q1 + bh * DH + lane * EPL + 4 * g);
    qr[4 * g + 0] = x.x * scale;
    qr[4 * g + 1] = x.y * scale;
    qr[4 * g + 2] = x.z * scale;
    qr[4 * g + 3] = x.w * scale;
  }

  float m = kNegInf, l = 0.f, acc[EPL];
#pragma unroll
  for (int x = 0; x < EPL; ++x) acc[x] = 0.f;

  for (int64_t base = (int64_t)warp * kGroup; base < length;
       base += kWarps * kGroup) {
    float4 kr[kGroup][NV], vr[kGroup][NV];
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      const bool ok = base + s < length;
#pragma unroll
      for (int g = 0; g < NV; ++g) {
        kr[s][g] = ok ? load4(kb + (base + s) * DH + 4 * g)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        vr[s][g] = ok ? load4(vb + (base + s) * DH + 4 * g)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    float sc[kGroup];
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      float d = 0.f;
#pragma unroll
      for (int g = 0; g < NV; ++g)
        d += qr[4 * g] * kr[s][g].x + qr[4 * g + 1] * kr[s][g].y +
             qr[4 * g + 2] * kr[s][g].z + qr[4 * g + 3] * kr[s][g].w;
      sc[s] = d;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int s = 0; s < kGroup; ++s)
        sc[s] += __shfl_xor_sync(0xffffffffu, sc[s], off);
    float mx = kNegInf;
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      if (base + s >= length) sc[s] = kNegInf;
      mx = fmaxf(mx, sc[s]);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int x = 0; x < EPL; ++x) acc[x] *= corr;
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      const float p = base + s < length ? expf(sc[s] - m_new) : 0.f;
      psum += p;
#pragma unroll
      for (int g = 0; g < NV; ++g) {
        acc[4 * g + 0] += p * vr[s][g].x;
        acc[4 * g + 1] += p * vr[s][g].y;
        acc[4 * g + 2] += p * vr[s][g].z;
        acc[4 * g + 3] += p * vr[s][g].w;
      }
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (lane == 0) {
    w_m[warp] = m;
    w_l[warp] = l;
  }
#pragma unroll
  for (int x = 0; x < EPL; ++x) w_acc[warp][lane * EPL + x] = acc[x];
  __syncthreads();

  float M = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, w_m[w]);
  float L = 0.f, f[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    f[w] = expf(w_m[w] - M);
    L += w_l[w] * f[w];
  }
  const float inv_l = 1.0f / fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < DH; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += w_acc[w][d] * f[w];
    store1(out + bh * DH + d, o * inv_l);
  }
}

template <int DH, typename T>
int launch(const void* q1, const void* k, const void* v, void* out,
           int64_t BH, int64_t S, int64_t length, float scale,
           cudaStream_t stream) {
  decode_kernel<DH, T><<<(unsigned)BH, kThreads, 0, stream>>>(
      static_cast<const T*>(q1), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, length, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int64_t Dh, const void* q1, const void* k, const void* v,
             void* out, int64_t BH, int64_t S, int64_t length, float scale,
             cudaStream_t st) {
  switch (Dh) {
    case 128:
      return launch<128, T>(q1, k, v, out, BH, S, length, scale, st);
    case 256:
      return launch<256, T>(q1, k, v, out, BH, S, length, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  q1, out: (BH, 1, Dh); k, v:
// (BH, S, Dh); contiguous, 16-byte aligned, f32 (bf16 == 0) or bf16
// (bf16 == 1); Dh 128 or 256; 0 <= length <= S; scale = float32(Dh **
// -0.5).  Launches on `stream` and returns cudaGetLastError() (0 on
// success); does not synchronize.
extern "C" int repro_decode_attention(int bf16, const void* q1,
                                      const void* k, const void* v,
                                      void* out, int64_t BH, int64_t S,
                                      int64_t Dh, int64_t length,
                                      float scale, void* stream) {
  if (BH <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(Dh, q1, k, v, out, BH, S, length,
                                        scale, st)
              : dispatch<float>(Dh, q1, k, v, out, BH, S, length, scale, st);
}
