// Blockwise int8 absmax quantize / dequantize kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels repro/kernels/quant_blockwise.py::
// _quant_kernel and ::_dequant_kernel (wrappers `quantize`, `dequantize`),
// whose oracle is repro/kernels/ref.py::quant_ref / dequant_ref.  They
// compress the checkpoint store's f32 shards (repro_torch/ckpt/store.py).
//
// What they compute, per group of 128 consecutive floats (one row-group
// of the (N, D) layout, D % 128 == 0, so the flat array is a sequence of
// groups and group g owns scale g):
//   scale = max(max|x| * (1/127f), 1e-12f)      NaN-propagating maxima
//   q     = int8(clip(rint(x / scale), -127, 127)), NaN -> 0
//   out   = float(q) * scale
// This is what the reference computes bit for bit on the CPU: XLA turns
// the division by the constant 127 into a product with float32(1/127),
// while x / scale stays a true IEEE division.  A group holding a NaN gets
// a NaN scale and q = 0 everywhere (NaN / NaN); one holding +-inf an inf
// scale and q = 0 everywhere (inf / inf and x / inf).  fmaxf would drop a
// NaN, so the maxima are spelled out.  Built with -fmad=false and without
// fast math, so every product and quotient rounds as in the plain version.
//
// Bound: device-memory bytes.  Quantize reads 4 B and writes 1 B per
// element plus 4 B per 128; dequantize the reverse.  A few operations per
// element are far below the card's operations-per-byte balance point.
//
// Design: one warp per group.  Each lane loads one float4 (the warp reads
// the group's 512 contiguous bytes in one coalesced request), reduces its
// four |x| and then the warp's 32 partial maxima with shuffles, and stores
// its four int8 as one char4; lane 0 stores the scale.  Blocks of 8 warps
// stride over the groups.  TMA and larger tiles are left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxBlocks = 1 << 20;

// max(a, b) that returns NaN when either is NaN, like jnp.max/jnp.maximum.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ signed char quant_one(float x, float s) {
  float r = rintf(x / s);  // IEEE quotient, round half to even
  if (r != r) return 0;    // NaN -> 0, as XLA's float -> int8 convert
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<signed char>(r);
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, signed char* __restrict__ q,
                float* __restrict__ scales, int64_t n_groups) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  for (int64_t g = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       g < n_groups; g += stride) {
    const float4 v = reinterpret_cast<const float4*>(x + g * kGroup)[lane];
    float m = nan_max(nan_max(fabsf(v.x), fabsf(v.y)),
                      nan_max(fabsf(v.z), fabsf(v.w)));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float s = nan_max(m * (1.0f / 127.0f), 1e-12f);
    char4 out;
    out.x = quant_one(v.x, s);
    out.y = quant_one(v.y, s);
    out.z = quant_one(v.z, s);
    out.w = quant_one(v.w, s);
    reinterpret_cast<char4*>(q + g * kGroup)[lane] = out;
    if (lane == 0) scales[g] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const signed char* __restrict__ q,
                  const float* __restrict__ scales, float* __restrict__ out,
                  int64_t n_groups) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  for (int64_t g = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       g < n_groups; g += stride) {
    const char4 c = reinterpret_cast<const char4*>(q + g * kGroup)[lane];
    const float s = scales[g];
    float4 o;
    o.x = static_cast<float>(c.x) * s;
    o.y = static_cast<float>(c.y) * s;
    o.z = static_cast<float>(c.z) * s;
    o.w = static_cast<float>(c.w) * s;
    reinterpret_cast<float4*>(out + g * kGroup)[lane] = o;
  }
}

unsigned blocks_for(int64_t n_groups) {
  const int64_t b = (n_groups + kWarps - 1) / kWarps;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// Plain C entry points (bound with ctypes).  `x`/`out` are f32, `q` int8,
// each n_groups * 128 contiguous elements (x and out 16-byte aligned, q
// 4-byte aligned); `scales` n_groups f32.  Launch on `stream` and return
// cudaGetLastError() (0 on success); do not synchronize.
extern "C" int repro_quantize_blockwise(const void* x, void* q, void* scales,
                                        int64_t n_groups, void* stream) {
  if (n_groups <= 0) return 0;
  quantize_kernel<<<blocks_for(n_groups), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<signed char*>(q),
      static_cast<float*>(scales), n_groups);
  return (int)cudaGetLastError();
}

extern "C" int repro_dequantize_blockwise(const void* q, const void* scales,
                                          void* out, int64_t n_groups,
                                          void* stream) {
  if (n_groups <= 0) return 0;
  dequantize_kernel<<<blocks_for(n_groups), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), n_groups);
  return (int)cudaGetLastError();
}
