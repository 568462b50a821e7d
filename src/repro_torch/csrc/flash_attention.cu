// Flash attention (online softmax) for Hopper (sm_90a), on CUDA cores.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::_flash_kernel (wrapper
// `flash_attention`, oracle repro/kernels/ref.py::attention_ref).  q, k, v:
// (BH, S, Dh) contiguous, f32 or bf16; out in q's dtype.  Masks: causal
// (j <= i), sliding (i - window < j <= i), chunked (j <= i, same chunk),
// bidirectional.  As on the TPU: q is scaled in f32 before the dot, a
// masked score is -1e30 and its weight exactly 0, the running max, sum and
// output accumulate in f32, and the sum is floored at 1e-30.
//
// Bound: at RecurrentGemma-9B's local attention (BH = 32, S = 4096,
// Dh = 256, window 2048, bf16) the two products inside the band are
// ~206 GFLOP against 268 MB of q, k, v and out: the tensor cores' rate
// bounds it (0.21 ms at 989 TFLOP/s).  This first kernel runs the products
// on the CUDA cores in f32 (67 TFLOP/s), so it is FP32-bound and far from
// that bound; wgmma with a TMA ring is later work.
//
// Design: one block of 256 threads per (bh, tile of 64 query rows), the
// heaviest causal tiles launched first.  The TPU's 256 x 256 tiles and its
// VMEM scratch do not fit an SM: the q tile (64 x Dh, scaled), the K and V
// tiles (64 keys x Dh) and the 64 x 64 score tile live in shared memory as
// f32 (211 KB at Dh = 256, so dynamic shared memory above 48 KB, set with
// cudaFuncSetAttribute), the running max, sum and rescale factor per row
// beside them, and the 64 x Dh output accumulator in registers (64 floats
// a thread at Dh = 256).  The block loops only over the KV tiles that its
// rows' masks can reach (the TPU kernel's `run` predicate, made exact), so
// a sliding window costs its band and not the whole row.  Per KV tile:
// scores (each thread a 4 x 4 block, float4 reads over Dh; rows padded by
// 4 floats to spread the banks), then per row the new max, the weights
// (masked to exactly 0 inside the tile, as at the tile's ragged end) and
// the sum, 4 threads a row with shuffles, then P.V into the accumulator
// after rescaling it.  Built without -fmad=false (held to a tolerance).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kPS = kBK + 1;  // score tile row stride

enum Mode { kCausal = 0, kSliding = 1, kChunked = 2, kBidir = 3 };

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
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  p[0] = __float2bfloat16_rn(v.x);
  p[1] = __float2bfloat16_rn(v.y);
  p[2] = __float2bfloat16_rn(v.z);
  p[3] = __float2bfloat16_rn(v.w);
}

__device__ __forceinline__ bool allowed(int mode, int64_t i, int64_t j,
                                        int64_t Skv, int window, int chunk) {
  if (j >= Skv) return false;
  switch (mode) {
    case kBidir: return true;
    case kCausal: return j <= i;
    case kSliding: return j <= i && j > i - window;
    default: return j <= i && (j / chunk) == (i / chunk);
  }
}

template <int DH>
constexpr int smem_floats() {
  return kBQ * (DH + 4) + kBK * (DH + 4) + kBK * DH + kBQ * kPS + 3 * kBQ;
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int64_t Sq,
             int64_t Skv, int mode, int window, int chunk, float scale) {
  constexpr int DHP = DH + 4;   // padded row stride of the q and k tiles
  constexpr int NE = DH / 64;   // float4 column groups a thread owns in P.V
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * DHP;
  float* Vs = Ks + kBK * DHP;
  float* Ps = Vs + kBK * DH;
  float* row_m = Ps + kBQ * kPS;
  float* row_l = row_m + kBQ;
  float* row_c = row_l + kBQ;

  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x;
  const int64_t n_qt = (Sq + kBQ - 1) / kBQ;
  const int64_t q0 = (n_qt - 1 - (int64_t)blockIdx.y) * kBQ;  // heavy first
  const T* qb = q + bh * Sq * DH;
  const T* kb = k + bh * Skv * DH;
  const T* vb = v + bh * Skv * DH;

  // the q tile, scaled in f32; rows past Sq are zeros
  for (int idx = tid * 4; idx < kBQ * DH; idx += kThreads * 4) {
    const int r = idx / DH, d = idx - r * DH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) {
      x = load4(qb + (q0 + r) * DH + d);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    store4(Qs + r * DHP + d, x);
  }
  if (tid < kBQ) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }

  // the keys any row of the tile may see
  const int64_t i_first = q0;
  const int64_t i_last = (q0 + kBQ < Sq ? q0 + kBQ : Sq) - 1;
  int64_t lo = 0, hi = Skv;
  if (mode != kBidir) {
    hi = i_last + 1 < Skv ? i_last + 1 : Skv;
    if (mode == kSliding) {
      const int64_t l = i_first - window + 1;
      lo = l > 0 ? l : 0;
    } else if (mode == kChunked) {
      lo = (i_first / chunk) * chunk;
    }
  }

  // S-phase and P.V-phase ownership: rows rg + 16 a, a = 0..3
  const int rg = tid >> 4, cg = tid & 15;
  float acc[4][NE][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < NE; ++e)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[a][e][x] = 0.f;

  for (int64_t j0 = lo; j0 < hi; j0 += kBK) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = tid * 4; idx < kBK * DH; idx += kThreads * 4) {
      const int r = idx / DH, d = idx - r * DH;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (j0 + r < Skv) {
        kx = load4(kb + (j0 + r) * DH + d);
        vx = load4(vb + (j0 + r) * DH + d);
      }
      store4(Ks + r * DHP + d, kx);
      store4(Vs + r * DH + d, vx);
    }
    __syncthreads();

    // scores: rows rg + 16 a, keys cg + 16 b
    {
      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) qv[a] = load4(Qs + (rg + 16 * a) * DHP + d);
#pragma unroll
        for (int b = 0; b < 4; ++b) kv[b] = load4(Ks + (cg + 16 * b) * DHP + d);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            s[a][b] += qv[a].x * kv[b].x + qv[a].y * kv[b].y +
                       qv[a].z * kv[b].z + qv[a].w * kv[b].w;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int r = rg + 16 * a, c = cg + 16 * b;
          Ps[r * kPS + c] = allowed(mode, q0 + r, j0 + c, Skv, window, chunk)
                                ? s[a][b] : kNegInf;
        }
    }
    __syncthreads();

    // online softmax: 4 threads a row, 16 keys each
    {
      const int r = tid >> 2, part = tid & 3;
      const int64_t i = q0 + r;
      float* pr = Ps + r * kPS + part * 16;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const bool ok = allowed(mode, i, j0 + part * 16 + c, Skv, window,
                                chunk);
        const float p = ok ? expf(pr[c] - m_new) : 0.f;
        pr[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
        row_c[r] = corr;
      }
    }
    __syncthreads();

    // rescale the accumulator, then add P.V: rows rg + 16 a, columns
    // 4 (cg + 16 e) .. + 3
    {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float corr = row_c[rg + 16 * a];
#pragma unroll
        for (int e = 0; e < NE; ++e)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[a][e][x] *= corr;
      }
#pragma unroll 2
      for (int j = 0; j < kBK; ++j) {
        float p[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) p[a] = Ps[(rg + 16 * a) * kPS + j];
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const float4 vv = load4(Vs + j * DH + 4 * (cg + 16 * e));
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc[a][e][0] += p[a] * vv.x;
            acc[a][e][1] += p[a] * vv.y;
            acc[a][e][2] += p[a] * vv.z;
            acc[a][e][3] += p[a] * vv.w;
          }
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = rg + 16 * a;
    if (q0 + r >= Sq) continue;
    const float inv_l = 1.0f / fmaxf(row_l[r], 1e-30f);
    T* orow = out + (bh * Sq + q0 + r) * DH;
#pragma unroll
    for (int e = 0; e < NE; ++e)
      store4(orow + 4 * (cg + 16 * e),
             make_float4(acc[a][e][0] * inv_l, acc[a][e][1] * inv_l,
                         acc[a][e][2] * inv_l, acc[a][e][3] * inv_l));
  }
}

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t BH, int64_t Sq, int64_t Skv, int mode, int window,
           int chunk, float scale, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DH, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)BH, (unsigned)((Sq + kBQ - 1) / kBQ));
  flash_kernel<DH, T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, mode, window,
      chunk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int64_t Dh, const void* q, const void* k, const void* v,
             void* out, int64_t BH, int64_t Sq, int64_t Skv, int mode,
             int window, int chunk, float scale, cudaStream_t st) {
  switch (Dh) {
    case 128:
      return launch<128, T>(q, k, v, out, BH, Sq, Skv, mode, window, chunk,
                            scale, st);
    case 256:
      return launch<256, T>(q, k, v, out, BH, Sq, Skv, mode, window, chunk,
                            scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  q, out: (BH, Sq, Dh); k, v:
// (BH, Skv, Dh); contiguous, 16-byte aligned, f32 (bf16 == 0) or bf16
// (bf16 == 1); Dh 128 or 256; mode 0 causal, 1 sliding, 2 chunked (chunk
// > 0), 3 bidir; scale = float32(Dh ** -0.5).  Launches on `stream` and
// returns a CUDA error code (0 on success); does not synchronize.
extern "C" int repro_flash_attention(int bf16, const void* q, const void* k,
                                     const void* v, void* out, int64_t BH,
                                     int64_t Sq, int64_t Skv, int64_t Dh,
                                     int mode, int window, int chunk,
                                     float scale, void* stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(Dh, q, k, v, out, BH, Sq, Skv, mode,
                                        window, chunk, scale, st)
              : dispatch<float>(Dh, q, k, v, out, BH, Sq, Skv, mode, window,
                                chunk, scale, st);
}
