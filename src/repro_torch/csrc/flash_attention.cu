// Flash attention (online softmax) for Hopper (sm_90a): two kernels, picked
// by the input dtype at the C entry point.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::_flash_kernel (wrapper
// `flash_attention`, oracle repro/kernels/ref.py::attention_ref).  q, k, v:
// (BH, S, Dh) contiguous, f32 or bf16; out in q's dtype.  Masks: causal
// (j <= i), sliding (i - window < j <= i), chunked (j <= i, same chunk),
// bidirectional.  As on the TPU: a masked score is -1e30 and its weight
// exactly 0, the running max, sum and output accumulate in f32, and the
// sum is floored at 1e-30.  Both kernels visit only the KV tiles that their
// rows' masks can reach (the TPU kernel's `run` predicate, made exact), so a
// sliding window costs its band and not the whole row.
//
// Bound: at RecurrentGemma-9B's local attention (BH = 32, S = 4096,
// Dh = 256, window 2048, bf16) the two products inside the band are
// ~206 GFLOP against 268 MB of q, k, v and out: the tensor cores' rate
// bounds it (0.21 ms at 989 TFLOP/s).
//
// bf16 (the model path): wgmma for both products, fed by TMA.  One block of
// two consumer warpgroups per (bh, tile of 128 query rows), heaviest causal
// tiles first; each warpgroup owns 64 rows (wgmma's M).  The Q tile and a
// ring of K/V stages (64 keys x Dh; 2 stages at Dh = 256, 4 at Dh = 128, 6
// at Dh = 64, whose 8 KB tiles leave room for more in flight) are bf16 in
// shared memory, written by TMA through 3-D tensor maps (Dh, S, BH) with
// the 128-byte swizzle: a 128-byte box is 64 columns wide, so a tile is
// Dh / 64 column slabs, and rows past S read as zeros.  Thread 0 starts the
// loads of tile t + stages once every warp has released tile t (an mbarrier
// per stage each way).  S = Q K^T runs as Dh / 16 wgmma m64n64k16 with both
// operands from shared memory (K-major), unscaled; the scores are scaled in
// f32 afterwards (by scale * log2(e), for exp2).  The online softmax runs on
// the accumulator fragments (row max and sum over the 4 lanes of a row by
// shuffles, weights in f32); only tiles at the band's edges or the ragged
// end take the mask.  P, rounded to bf16, is the register A operand of
// O += P V (4 wgmma m64n{Dh}k16, V read MN-major from shared memory through
// the transpose bit); the sum l is taken from the f32 weights.  The
// accumulator (Dh / 2 floats a thread) stays in registers throughout.
//
// f32: the CUDA-core kernel (TF32 cannot meet the f32
// tolerance): one block of 256 threads per (bh, tile of 64 query rows), q
// scaled in f32 before the dot; the q tile (scaled), the K and V tiles (64
// keys x Dh) and the 64 x 64 score tile live in shared memory as f32 (211 KB
// at Dh = 256, set with cudaFuncSetAttribute), the running max, sum and
// rescale factor per row beside them, and the 64 x Dh output accumulator in
// registers.  Per KV tile: scores (each thread a 4 x 4 block, float4 reads
// over Dh; rows padded by 4 floats to spread the banks), then per row the
// new max, the weights (masked to exactly 0 inside the tile, as at the
// tile's ragged end) and the sum, 4 threads a row with shuffles, then P.V
// into the accumulator after rescaling it.
//
// Built without -fmad=false (held to a tolerance).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1.0e30f;

enum Mode { kCausal = 0, kSliding = 1, kChunked = 2, kBidir = 3 };

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

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kPS = kBK + 1;  // score tile row stride

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
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
    case 64:
      return launch<64, T>(q, k, v, out, BH, Sq, Skv, mode, window, chunk,
                           scale, st);
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


// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kWThreads = 256;  // two consumer warpgroups
constexpr int kWBQ = 128;       // query rows per block, 64 per warpgroup
constexpr int kWBK = 64;        // keys per K/V tile
constexpr int kSlabCols = 64;   // bf16 columns of a 128-byte swizzled slab
constexpr int kSlabRow = 128;   // bytes of one slab row
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Tiles {
  static constexpr int kSlabs = DH / kSlabCols;
  static constexpr int kStages = DH == 256 ? 2 : DH == 128 ? 4 : 6;
  static constexpr int kQBytes = kWBQ * DH * 2;
  static constexpr int kTileBytes = kWBK * DH * 2;  // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  // + 1024 to align the swizzle atoms
  static constexpr int kSmemBytes = kQBytes + kStages * kStageBytes + 1024;
};

// Every (i, j) with i_lo <= i <= i_hi, j0 <= j <= j1 allowed: no mask needed.
__device__ __forceinline__ bool unmasked(int mode, int i_lo, int i_hi, int j0,
                                         int j1, int Skv, int window,
                                         int chunk) {
  if (j1 >= Skv) return false;
  switch (mode) {
    case kBidir: return true;
    case kCausal: return j1 <= i_lo;
    case kSliding: return j1 <= i_lo && j0 > i_hi - window;
    default: return j1 <= i_lo && j0 / chunk == i_hi / chunk;
  }
}

// The K and V tiles of keys j0 .. j0 + 63 of row bh into `stage`.
template <int DH>
__device__ __forceinline__ void load_kv(uint8_t* stage, const CUtensorMap* km,
                                        const CUtensorMap* vm, int j0, int bh,
                                        uint64_t* bar) {
  using C = Tiles<DH>;
  hopper::mbar_expect_tx(bar, C::kStageBytes);
#pragma unroll
  for (int s = 0; s < C::kSlabs; ++s) {
    hopper::tma_load_3d(stage + s * kWBK * kSlabRow, km, s * kSlabCols, j0, bh,
                        bar);
    hopper::tma_load_3d(stage + C::kTileBytes + s * kWBK * kSlabRow, vm,
                        s * kSlabCols, j0, bh, bar);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// One tile of the online softmax on the S accumulator `sc` of this thread
// (rows row0 and row0 + 8, keys jb + 8 (i / 4) + i % 2): scale, mask (edge
// tiles only), new row max, rescale of `o`, sum, and the bf16 A fragments of
// P in `pa` (k16 chunk c in pa[4c .. 4c + 3]).
template <int DH, bool MASK>
__device__ __forceinline__ void online_softmax(
    float (&sc)[32], float (&o)[DH / 2], uint32_t (&pa)[16], float (&m)[2],
    float (&l)[2], int row0, int jb, int mode, int Skv, int window,
    int chunk, float scale_log2) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    float x = sc[i] * scale_log2;
    if (MASK && !allowed(mode, row0 + 8 * h, jb + 8 * (i >> 2) + (i & 1), Skv,
                         window, chunk))
      x = kNegInf;
    sc[i] = x;
    mx[h] = fmaxf(mx[h], x);
  }
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    mx[h] = fmaxf(m[h], mx[h]);
    corr[h] = exp2f(m[h] - mx[h]);
    m[h] = mx[h];
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int h = (i >> 1) & 1;
    float p0 = exp2f(sc[i] - mx[h]), p1 = exp2f(sc[i + 1] - mx[h]);
    if (MASK) {  // exactly 0, also while a row has seen no key
      p0 = sc[i] == kNegInf ? 0.f : p0;
      p1 = sc[i + 1] == kNegInf ? 0.f : p1;
    }
    ps[h] += p0 + p1;
    pa[i >> 1] = pack_bf16(p0, p1);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ps[h];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] *= corr[(i >> 1) & 1];
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  hopper::wgmma_rs_m64n64k16(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  hopper::wgmma_rs_m64n128k16(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&o)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  hopper::wgmma_rs_m64n256k16(o, a, db);
}

template <int DH>
__global__ void __launch_bounds__(kWThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ out, int Sq, int Skv, int mode,
                   int window, int chunk, float scale_log2) {
  using C = Tiles<DH>;
  constexpr int ST = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t qbar, full[ST], empty[ST];
  uint8_t* Qs =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = Qs + C::kQBytes;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int n_qt = (Sq + kWBQ - 1) / kWBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kWBQ;  // heavy first

  // the keys any row of the block may see
  int lo = 0, hi = Skv;
  if (mode != kBidir) {
    hi = min(min(q0 + kWBQ, Sq), Skv);
    if (mode == kSliding) lo = max(q0 - window + 1, 0);
    else if (mode == kChunked) lo = (q0 / chunk) * chunk;
  }
  const int n_tiles = hi > lo ? (hi - lo + kWBK - 1) / kWBK : 0;

  if (tid == 0) {
    hopper::mbar_init(&qbar, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kWThreads / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(&qbar, C::kQBytes);
    for (int s = 0; s < C::kSlabs; ++s)
      hopper::tma_load_3d(Qs + s * kWBQ * kSlabRow, &qmap, s * kSlabCols, q0,
                          bh, &qbar);
    for (int t = 0; t < ST && t < n_tiles; ++t)
      load_kv<DH>(ring + t * C::kStageBytes, &kmap, &vmap, lo + t * kWBK, bh,
                  &full[t]);
  }

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int i_lo = q0 + 64 * wg, i_hi = min(i_lo + 63, Sq - 1);
  const int row0 = i_lo + 16 * warp + (lane >> 2);
  const uint8_t* Qw = Qs + 64 * wg * kSlabRow;  // the warpgroup's rows
  hopper::mbar_wait(&qbar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % ST;
    const uint32_t ph = (t / ST) & 1;
    uint8_t* Kt = ring + s * C::kStageBytes;
    const uint8_t* Vt = Kt + C::kTileBytes;
    const int j0 = lo + t * kWBK;
    __syncwarp();
    hopper::mbar_wait(&full[s], ph);

    // S = Q K^T over Dh / 16 steps of 16 columns (32 bytes of a slab row)
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int off = (kk & 3) * 32;  // within the slab kk / 4
      hopper::wgmma_ss_m64n64k16(
          sc, hopper::gmma_desc(Qw + (kk >> 2) * kWBQ * kSlabRow + off, 16,
                                1024),
          hopper::gmma_desc(Kt + (kk >> 2) * kWBK * kSlabRow + off, 16, 1024));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    uint32_t pa[16];
    const int jb = j0 + 2 * (lane & 3);
    if (unmasked(mode, i_lo, i_hi, j0, j0 + kWBK - 1, Skv, window, chunk))
      online_softmax<DH, false>(sc, o, pa, m, l, row0, jb, mode, Skv, window,
                                chunk, scale_log2);
    else
      online_softmax<DH, true>(sc, o, pa, m, l, row0, jb, mode, Skv, window,
                               chunk, scale_log2);

    // O += P V over 4 steps of 16 keys (16 rows of 128 bytes in each slab;
    // the slabs, 64 columns each, kWBK * 128 bytes apart)
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWBK / 16; ++kk)
      wgmma_pv<DH>(o, *reinterpret_cast<const uint32_t(*)[4]>(&pa[4 * kk]),
                   hopper::gmma_desc(Vt + kk * 16 * kSlabRow,
                                     kWBK * kSlabRow, 8 * kSlabRow));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::fence_regs(pa);

    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    if (tid == 0 && t + ST < n_tiles) {  // refill the stage
      hopper::mbar_wait(&empty[s], ph);
      load_kv<DH>(Kt, &kmap, &vmap, lo + (t + ST) * kWBK, bh, &full[s]);
    }
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.0f / fmaxf(l[h], 1e-30f);
  }
  __nv_bfloat16* ob = out + (int64_t)bh * Sq * DH;
#pragma unroll
  for (int i = 0; i < DH / 2; i += 2) {
    const int h = (i >> 1) & 1, row = row0 + 8 * h;
    if (row < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row * DH + 8 * (i >> 2) +
                                         2 * (lane & 3)) =
          __floats2bfloat162_rn(o[i] * inv[h], o[i + 1] * inv[h]);
  }
}

// (BH, S, Dh) bf16 as the 3-D map (Dh, S, BH), boxes of 64 columns x `rows`
// rows of one bh, 128-byte swizzle.
bool make_map(CUtensorMap* map, const void* base, int64_t BH, int64_t S,
              int64_t Dh, int rows) {
  return hopper::make_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base,
                             Dh, S, BH, kSlabCols, rows,
                             CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int64_t BH, int64_t Sq, int64_t Skv, int mode, int window,
                 int chunk, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, BH, Sq, DH, kWBQ) ||
      !make_map(&km, k, BH, Skv, DH, kWBK) ||
      !make_map(&vm, v, BH, Skv, DH, kWBK))
    return (int)cudaErrorInvalidValue;
  const int bytes = Tiles<DH>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)BH, (unsigned)((Sq + kWBQ - 1) / kWBQ));
  flash_wgmma_kernel<DH><<<grid, kWThreads, bytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), (int)Sq, (int)Skv, mode,
      window, chunk, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  q, out: (BH, Sq, Dh); k, v:
// (BH, Skv, Dh); contiguous, 16-byte aligned, f32 (bf16 == 0: the CUDA-core
// kernel) or bf16 (bf16 == 1: the wgmma kernel); Dh 64, 128 or 256; mode 0
// causal, 1 sliding, 2 chunked (chunk > 0), 3 bidir; scale = float32(Dh **
// -0.5).  Launches on `stream` and returns a CUDA error code (0 on success);
// does not synchronize.
extern "C" int repro_flash_attention(int bf16, const void* q, const void* k,
                                     const void* v, void* out, int64_t BH,
                                     int64_t Sq, int64_t Skv, int64_t Dh,
                                     int mode, int window, int chunk,
                                     float scale, void* stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return dispatch<float>(Dh, q, k, v, out, BH, Sq, Skv, mode, window,
                           chunk, scale, st);
  switch (Dh) {
    case 64:
      return launch_wgmma<64>(q, k, v, out, BH, Sq, Skv, mode, window, chunk,
                              scale, st);
    case 128:
      return launch_wgmma<128>(q, k, v, out, BH, Sq, Skv, mode, window, chunk,
                               scale, st);
    case 256:
      return launch_wgmma<256>(q, k, v, out, BH, Sq, Skv, mode, window, chunk,
                               scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
