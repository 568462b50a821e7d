// Flash-decoding for Hopper (sm_90a): one query token against a KV cache.
//
// Replaces the Pallas TPU kernel
// repro/kernels/decode_attention.py::_decode_kernel (wrapper
// `decode_attention`, oracle repro/kernels/ref.py::decode_ref).  q1:
// (BH, 1, Dh); k, v: (BH, S, Dh); contiguous, f32 or bf16; out (BH, 1, Dh)
// in q1's dtype.  Slots at or past `length` are masked; q is scaled in
// f32, the softmax runs online in f32 and its sum is floored at 1e-30, so
// length 0 gives zeros, as on the TPU.  Where `lse` is not null it takes
// each row's log-sum-exp of the scaled scores, m + log(l) (-1e30 for a row
// with no slot), so that the outputs of disjoint slot ranges merge into
// the whole softmax (the cache split across ranks).
//
// Bound: device-memory bytes.  Each cache row is read once for one dot and
// one axpy: at RecurrentGemma-9B's decode (BH = 2048, S = 2048, Dh = 256,
// bf16) that is 4.29 GB of K and V at full length, 1.28 ms at 3.35 TB/s,
// against ~2 FLOP per byte, so the math stays on the CUDA cores in f32.
// Rows past `length` change nothing, so the kernel never reads them.
//
// Design: persistent blocks, one per SM, each walking the BH rows in a
// static stride, so no last wave leaves SMs idle.  For one row the K slots
// [base, base + n) are one contiguous span of n Dh elements, and so are the
// V slots: a stage of the ring in shared memory (48 KB: kSlots slots of K,
// then of V; 48 slots at Dh = 256 in bf16) is filled by two 1-D bulk copies
// (cp.async.bulk) that complete on the stage's mbarrier, with the bytes
// actually copied (a ragged last stage copies (length - base) Dh elements,
// a multiple of 16 bytes).  One lane of a producer warp keeps the 4-stage
// ring full across row boundaries, waiting on each stage's release before
// it refills it; so ~144 KB per SM are in flight, enough to keep the memory
// busy while the blocks with one row more than the others finish.  Eight
// consumer warps split each stage's slots, reading shared memory as
// 16-byte vectors (lane l owns Dh / 32 contiguous columns); each keeps its
// own running max, sum and accumulator (the TPU kernel's block of kb slots)
// and releases the stage (one arrival per warp).  The 8 warps' states are
// merged at the end of each row through shared memory.  Built without
// -fmad=false (held to a tolerance).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kWarps = 8;                   // consumer warps
constexpr int kThreads = 32 * (kWarps + 1);  // + the producer warp
constexpr int kStageBytes = 49152;          // K and V of one stage
constexpr int kStages = 4;

template <int DH, typename T>
struct Ring {
  static constexpr int kRowBytes = DH * (int)sizeof(T);
  static constexpr int kSlots = kStageBytes / (2 * kRowBytes);  // per stage
  static constexpr int kPerWarp = kSlots / kWarps;
  static constexpr int kEPL = DH / 32;  // columns per lane
};

// kEPL = Dh / 32 consecutive elements -> f32, exactly (a bf16 is the top
// half of its f32); one vector load of 4 * kEPL or 2 * kEPL bytes (8 to 16;
// 4 for bf16 at Dh = 64).
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&x)[N]) {
  static_assert(N == 2 || N % 4 == 0, "2 or a multiple of 4 f32 a lane");
  if constexpr (N == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    x[0] = u.x;
    x[1] = u.y;
  } else {
#pragma unroll
    for (int g = 0; g < N / 4; ++g) {
      const float4 u = reinterpret_cast<const float4*>(p)[g];
      x[4 * g] = u.x;
      x[4 * g + 1] = u.y;
      x[4 * g + 2] = u.z;
      x[4 * g + 3] = u.w;
    }
  }
}
template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&x)[N]) {
  static_assert(N == 2 || N == 4 || N == 8, "2, 4 or 8 bf16 a lane");
  uint32_t w[N / 2];
  if constexpr (N == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int g = 0; g < N / 2; ++g) {
    x[2 * g] = __uint_as_float(w[g] << 16);
    x[2 * g + 1] = __uint_as_float(w[g] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads, 1)
decode_kernel(const T* __restrict__ q1, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ lse, int64_t BH, int64_t S, int64_t length,
              float scale) {
  using R = Ring<DH, T>;
  constexpr int EPL = R::kEPL;
  extern __shared__ uint8_t ring_raw[];
  __shared__ uint64_t full[kStages], empty[kStages];
  __shared__ float w_m[kWarps], w_l[kWarps];
  __shared__ float w_acc[kWarps][DH];
  T* ring = reinterpret_cast<T*>(ring_raw);  // stage s: K slots, then V
  auto k_stage = [&](int s) { return ring + s * (kStageBytes / sizeof(T)); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t n_chunks = (length + R::kSlots - 1) / R::kSlots;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWarps) {  // the producer
    if (lane != 0) return;
    int64_t fill = 0;
    for (int64_t bh = blockIdx.x; bh < BH; bh += gridDim.x) {
      for (int64_t c = 0; c < n_chunks; ++c, ++fill) {
        const int s = (int)(fill % kStages);
        if (fill >= kStages)  // wait for the stage's previous use to end
          hopper::mbar_wait(&empty[s], (uint32_t)((fill / kStages - 1) & 1));
        const int64_t base = c * R::kSlots;
        const int64_t n = length - base < R::kSlots ? length - base
                                                     : R::kSlots;
        const uint32_t bytes = (uint32_t)(n * R::kRowBytes);
        T* dst = k_stage(s);
        hopper::mbar_expect_tx(&full[s], 2 * bytes);
        hopper::bulk_load(dst, k + (bh * S + base) * DH, bytes, &full[s]);
        hopper::bulk_load(dst + R::kSlots * DH, v + (bh * S + base) * DH,
                          bytes, &full[s]);
      }
    }
    return;
  }

  int64_t fill = 0;
  for (int64_t bh = blockIdx.x; bh < BH; bh += gridDim.x) {
    float qr[EPL];
    load_row(q1 + bh * DH + lane * EPL, qr);
#pragma unroll
    for (int x = 0; x < EPL; ++x) qr[x] *= scale;
    float m = kNegInf, l = 0.f, acc[EPL];
#pragma unroll
    for (int x = 0; x < EPL; ++x) acc[x] = 0.f;

    for (int64_t c = 0; c < n_chunks; ++c, ++fill) {
      const int s = (int)(fill % kStages);
      hopper::mbar_wait(&full[s], (uint32_t)((fill / kStages) & 1));
      const int64_t n = length - c * R::kSlots;  // valid slots (if < kSlots)
      const int first = warp * R::kPerWarp;      // this warp's slots
      const T* ks = k_stage(s) + first * DH + lane * EPL;
      const T* vs = ks + R::kSlots * DH;
      float sc[R::kPerWarp];
#pragma unroll
      for (int j = 0; j < R::kPerWarp; ++j) {
        float d = 0.f;
        if (first + j < n) {
          float kr[EPL];
          load_row(ks + j * DH, kr);
#pragma unroll
          for (int x = 0; x < EPL; ++x) d += qr[x] * kr[x];
        }
        sc[j] = d;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < R::kPerWarp; ++j)
          sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], off);
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < R::kPerWarp; ++j) {
        if (first + j >= n) sc[j] = kNegInf;
        mx = fmaxf(mx, sc[j]);
      }
      const float m_new = fmaxf(m, mx);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int x = 0; x < EPL; ++x) acc[x] *= corr;
#pragma unroll
      for (int j = 0; j < R::kPerWarp; ++j) {
        if (first + j < n) {  // slots past length: never read
          const float p = expf(sc[j] - m_new);
          float vr[EPL];
          load_row(vs + j * DH, vr);
          psum += p;
#pragma unroll
          for (int x = 0; x < EPL; ++x) acc[x] += p * vr[x];
        }
      }
      l = l * corr + psum;
      m = m_new;
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // merge the warps' states (named barrier 1: the consumer warps only)
    if (lane == 0) {
      w_m[warp] = m;
      w_l[warp] = l;
    }
#pragma unroll
    for (int x = 0; x < EPL; ++x) w_acc[warp][lane * EPL + x] = acc[x];
    asm volatile("bar.sync 1, %0;" ::"n"(32 * kWarps) : "memory");
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
    if (lse != nullptr && threadIdx.x == 0)  // L >= 1 once a slot is read
      lse[bh] = L > 0.f ? M + logf(L) : kNegInf;
    for (int d = threadIdx.x; d < DH; d += 32 * kWarps) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += w_acc[w][d] * f[w];
      store1(out + bh * DH + d, o * inv_l);
    }
    asm volatile("bar.sync 1, %0;" ::"n"(32 * kWarps) : "memory");
  }
}

template <int DH, typename T>
int launch(const void* q1, const void* k, const void* v, void* out,
           float* lse, int64_t BH, int64_t S, int64_t length, float scale,
           cudaStream_t stream) {
  const int bytes = kStages * kStageBytes;
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<DH, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  const unsigned grid = (unsigned)(BH < sms ? BH : sms);
  decode_kernel<DH, T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q1), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, BH, S, length,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int64_t Dh, const void* q1, const void* k, const void* v,
             void* out, float* lse, int64_t BH, int64_t S, int64_t length,
             float scale, cudaStream_t st) {
  switch (Dh) {
    case 64:
      return launch<64, T>(q1, k, v, out, lse, BH, S, length, scale, st);
    case 128:
      return launch<128, T>(q1, k, v, out, lse, BH, S, length, scale, st);
    case 256:
      return launch<256, T>(q1, k, v, out, lse, BH, S, length, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  q1, out: (BH, 1, Dh); k, v:
// (BH, S, Dh); contiguous, 16-byte aligned, f32 (bf16 == 0) or bf16
// (bf16 == 1); lse: null, or (BH,) f32 for each row's log-sum-exp; Dh 64,
// 128 or 256; 0 <= length <= S; scale = float32(Dh ** -0.5).  Launches on
// `stream` and returns cudaGetLastError() (0 on success); does not
// synchronize.
extern "C" int repro_decode_attention(int bf16, const void* q1,
                                      const void* k, const void* v,
                                      void* out, float* lse, int64_t BH,
                                      int64_t S, int64_t Dh, int64_t length,
                                      float scale, void* stream) {
  if (BH <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(Dh, q1, k, v, out, lse, BH, S,
                                        length, scale, st)
              : dispatch<float>(Dh, q1, k, v, out, lse, BH, S, length, scale,
                                st);
}
