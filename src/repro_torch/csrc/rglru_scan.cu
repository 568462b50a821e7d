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
// operations per element): 0.1202 ms at RecurrentGemma-9B's (2, 4096,
// 4096) f32 at 3.35 TB/s.  The recurrence is sequential in time, so the
// parallelism is the B*W lanes, 8,192 there.  Keeping 3.35 TB/s busy at a
// memory latency near 0.7 us needs about 2.5 MB in flight; one thread per
// lane with a few steps in registers keeps a fifth of that.
//
// Design (the ring route): a block is one warp that owns 32 neighbouring w
// lanes of one batch row (256 blocks at full width).  Its shared memory
// holds a ring of kStages stages, each kSteps time steps x 32 lanes of a
// and of b, written by TMA through 3-D tensor maps of (W, S, B) (a box of
// 32 lanes x kSteps steps; lanes past W and steps past S read as zeros).
// Lane 0 keeps kStages - 1 stages in flight while the warp computes the
// current one: 48 KB of f32 a block, 12 MB across the card.  Each lane
// runs the sequential h = a * h + b for its w and stores every step's h,
// the warp's 32 lanes side by side (coalesced).
//
// TMA needs every row's byte stride (W times the element size) to be a
// multiple of 16.  Other widths take the direct route: one thread per lane
// walks over S with the next kUnroll steps of a and b loaded while the
// current ones are computed.  The wrapper picks the route (`launch_plan`
// in kernels/rglru_scan.py).
//
// Built with -fmad=false: h = a * h + b rounds the product and the sum
// separately, as the plain PyTorch version does, so the two are held
// bitwise on both routes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// ring route: TMA into a shared-memory ring, one warp per 32 lanes
// ---------------------------------------------------------------------------

constexpr int kLanes = 32;   // w lanes per block (one warp)
constexpr int kSteps = 64;   // time steps per stage
constexpr int kStages = 4;

template <typename T>
struct Ring {
  static constexpr int kTile = kSteps * kLanes;            // elements
  static constexpr int kTileBytes = kTile * (int)sizeof(T);
  static constexpr int kStageBytes = 2 * kTileBytes;       // a, then b
  static constexpr int kSmemBytes = kStages * kStageBytes + 128;
};

template <typename T>
__device__ __forceinline__ void load_stage(T* stage, const CUtensorMap* am,
                                           const CUtensorMap* bm, int w0,
                                           int t0, int bi, uint64_t* bar) {
  hopper::mbar_expect_tx(bar, Ring<T>::kStageBytes);
  hopper::tma_load_3d(stage, am, w0, t0, bi, bar);
  hopper::tma_load_3d(stage + Ring<T>::kTile, bm, w0, t0, bi, bar);
}

template <typename T>
__global__ void __launch_bounds__(kLanes)
rglru_ring_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap,
                  const float* __restrict__ h0, T* __restrict__ out, int S,
                  int64_t W) {
  using R = Ring<T>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages];
  T* ring = reinterpret_cast<T*>(
      smem_raw + ((128 - (hopper::smem_u32(smem_raw) & 127)) & 127));

  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * kLanes, bi = blockIdx.y;
  const int n_tiles = (S + kSteps - 1) / kSteps;
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
    for (int s = 0; s < kStages && s < n_tiles; ++s)
      load_stage(ring + s * 2 * R::kTile, &amap, &bmap, w0, s * kSteps, bi,
                 &full[s]);
  }
  __syncwarp();

  const int64_t w = w0 + lane;
  const bool valid = w < W;
  float h = valid ? h0[bi * W + w] : 0.f;
  T* o = out + (int64_t)bi * S * W + w;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const T* as = ring + s * 2 * R::kTile;
    const T* bs = as + R::kTile;
    const int t0 = t * kSteps;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    if (valid) {
      if (t0 + kSteps <= S) {
#pragma unroll 16
        for (int u = 0; u < kSteps; ++u) {
          h = load(as, u * kLanes + lane) * h + load(bs, u * kLanes + lane);
          store(o, (int64_t)(t0 + u) * W, h);
        }
      } else {
        for (int u = 0; t0 + u < S; ++u) {
          h = load(as, u * kLanes + lane) * h + load(bs, u * kLanes + lane);
          store(o, (int64_t)(t0 + u) * W, h);
        }
      }
    }
    __syncwarp();  // every lane is done with the stage
    if (lane == 0 && t + kStages < n_tiles) {
      hopper::fence_proxy_async();
      load_stage(ring + s * 2 * R::kTile, &amap, &bmap, w0,
                 (t + kStages) * kSteps, bi, &full[s]);
    }
  }
}

// (B, S, W) as the 3-D map (W, S, B), boxes of kLanes x kSteps, no swizzle.
template <typename T>
bool make_map(CUtensorMap* map, const void* base, int64_t B, int64_t S,
              int64_t W) {
  return hopper::make_map_3d(map,
                             sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                             (int)sizeof(T), base, W, S, B, kLanes, kSteps,
                             CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename T>
int launch_ring(const void* a, const void* b, const void* h0, void* out,
                int64_t B, int64_t S, int64_t W, cudaStream_t stream) {
  if ((W * (int64_t)sizeof(T)) % 16 || (uintptr_t)a % 16 ||
      (uintptr_t)b % 16 || S > INT32_MAX || B > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap am, bm;
  if (!make_map<T>(&am, a, B, S, W) || !make_map<T>(&bm, b, B, S, W))
    return (int)cudaErrorInvalidValue;
  const int bytes = Ring<T>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      rglru_ring_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((W + kLanes - 1) / kLanes), (unsigned)B);
  rglru_ring_kernel<T><<<grid, kLanes, bytes, stream>>>(
      am, bm, static_cast<const float*>(h0), static_cast<T*>(out), (int)S,
      W);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// direct route: one thread per lane, kUnroll steps in registers
// ---------------------------------------------------------------------------

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_direct_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const float* __restrict__ h0, T* __restrict__ out,
                    int64_t S, int64_t W, int64_t lanes) {
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
int launch_direct(const void* a, const void* b, const void* h0, void* out,
                  int64_t B, int64_t S, int64_t W, cudaStream_t stream) {
  const int64_t lanes = B * W;
  const unsigned blocks = (unsigned)((lanes + kThreads - 1) / kThreads);
  rglru_direct_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(h0), static_cast<T*>(out), S, W, lanes);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int ring, const void* a, const void* b, const void* h0, void* out,
           int64_t B, int64_t S, int64_t W, cudaStream_t st) {
  return ring ? launch_ring<T>(a, b, h0, out, B, S, W, st)
              : launch_direct<T>(a, b, h0, out, B, S, W, st);
}

}  // namespace

// Plain C entry point (bound with ctypes).  a, b, out: (B, S, W)
// contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1); h0: (B, W) contiguous
// f32.  ring == 1 takes the ring route (a and b 16-byte aligned, W times
// the element size a multiple of 16, B <= 65535), ring == 0 the direct
// one.  Launches on `stream` and returns a CUDA error code (0 on success);
// does not synchronize.
extern "C" int repro_rglru_scan(int bf16, int ring, const void* a,
                                const void* b, const void* h0, void* out,
                                int64_t B, int64_t S, int64_t W,
                                void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(ring, a, b, h0, out, B, S, W, st)
              : launch<float>(ring, a, b, h0, out, B, S, W, st);
}
