// Chunkwise-parallel mLSTM (xLSTM's matrix memory) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/mlstm_scan.py::_mlstm_kernel
// (wrapper `mlstm_scan`, oracle the stepwise repro/kernels/ref.py::
// mlstm_ref).  q, k, v: (BH, S, Dh) f32 or bf16 (q, k pre-scaled); li, lf:
// (BH, S) log input and log forget gates, f32 or bf16; chunks of L rows,
// S % L == 0, L <= 256; out (BH, S, Dh) in q's dtype; all math in f32.
// Per chunk, with b = cumsum(lf) over the chunk, F = b[L-1] and the carried
// state (C0, n0, m0), zeros at the start:
//   m_t    = max(m0 + b_t, max_{j<=t} (b_t - b_j) + li_j)
//   S_tj   = (q_t . k_j) exp((b_t - b_j) + li_j - m_t)             j <= t
//   g_t    = exp(m0 + b_t - m_t)
//   h_t    = (g_t q_t C0 + sum_j S_tj v_j)
//            / max(|g_t q_t . n0 + sum_j S_tj|, exp(-m_t))
// and the state moves to the chunk's end: m' = max(m0 + F, max_j (F - b_j)
// + li_j), w_j = exp((F - b_j) + li_j - m'), C' = exp(m0 + F - m') C0 +
// sum_j w_j k_j^T v_j, n' likewise.
//
// Bound: operations.  At xLSTM-125M (BH = 32, S = 4096, Dh = 384, L = 256,
// f32) the function needs 98.3 GFLOP: the two intra-chunk products over the
// causal pairs only (25.9), q C0 and the state update only where C is used,
// not into the first chunk nor out of the last (72.5), against 805 MB of
// q, k, v and out: 1.47 ms at the FP32 rate of the CUDA cores, which these
// kernels use.  (The TPU kernel computes full L x L tiles and every chunk's
// products, 128.8 GFLOP.)
//
// Design.  The TPU kernel runs one sequential program per bh holding C
// (Dh x Dh) in VMEM.  At Dh = 384, C alone is 576 KB and the chunk's L x L
// matrix 256 KB: neither fits the 227 KB of shared memory a block may
// have.  So the work is split where its dependencies split:
//   1. gates (one thread per bh): b, and every chunk's m0, decay and state
//      weights w.  These depend on the gates only, never on C or n, so
//      every later block reads one copy and agrees on them exactly.
//   2. state (a block per (64 x 64 tile of C, bh), walking the chunks in
//      order): writes each chunk's starting C tile (and n, from the blocks
//      of the first column tile) into scratch the wrapper allocates (302 MB
//      at full width), then adds the chunk's sum_j w_j k_j^T v_j from
//      32-row tiles of k and v in shared memory.  1,152 blocks at full
//      width.
//   3. output (a block per (32 rows, chunk, bh)): every chunk at once.  The
//      block holds its q rows in shared memory, computes each row's m_t,
//      g_t and q.n0 (8 threads a row), the gated scores against the keys up
//      to its last row (32-key tiles of k), the normalizer, then the
//      32 x Dh output: g (q C0) from 32-row tiles of C0, plus S v from
//      32-row tiles of v, and divides.  Each row's m_t and n_t are computed
//      once, by the one block that owns the row, so every column of a row
//      sees the same stabilizer.
// This is the TPU kernel's arithmetic with the work reordered: no product
// is repeated.  Built without -fmad=false (held to a tolerance).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kThreads = 256;
constexpr int kMaxL = 256;
constexpr int kTile = 64;  // state-pass tile of C
constexpr int kJT = 32;    // rows of k, v per state-pass step
constexpr int kRT = 32;    // rows per output block
constexpr int kKT = 32;    // keys (or rows of C0, v) per output-pass step

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
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

// ---------------------------------------------------------------------------
// 1. gates
// ---------------------------------------------------------------------------

template <typename G>
__global__ void __launch_bounds__(32)
gates_kernel(const G* __restrict__ li, const G* __restrict__ lf,
             float* __restrict__ m_start, float* __restrict__ decay,
             float* __restrict__ b, float* __restrict__ w,
             float* __restrict__ li32, int64_t BH, int64_t S, int64_t L) {
  const int64_t bh = (int64_t)blockIdx.x * 32 + threadIdx.x;
  if (bh >= BH) return;
  const int64_t nc = S / L;
  float m0 = 0.f;
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t base = bh * S + c * L;
    float F = 0.f;
    for (int64_t j = 0; j < L; ++j) {
      F += load1(lf + base + j);
      b[base + j] = F;
    }
    float mx = kNegInf;
    for (int64_t j = 0; j < L; ++j) {
      const float lij = load1(li + base + j);
      li32[base + j] = lij;
      mx = fmaxf(mx, (F - b[base + j]) + lij);
    }
    const float m_next = fmaxf(m0 + F, mx);
    m_start[bh * nc + c] = m0;
    decay[bh * nc + c] = expf((m0 + F) - m_next);
    for (int64_t j = 0; j < L; ++j)
      w[base + j] = expf(((F - b[base + j]) + li32[base + j]) - m_next);
    m0 = m_next;
  }
}

// ---------------------------------------------------------------------------
// 2. state: C (and n) at every chunk start
// ---------------------------------------------------------------------------

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
state_kernel(const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ decay, const float* __restrict__ w,
             float* __restrict__ Cs, float* __restrict__ ns, int64_t S,
             int64_t L) {
  __shared__ float4 kw_s4[kJT * kTile / 4];
  __shared__ float4 v_s4[kJT * kTile / 4];
  float* kw_s = reinterpret_cast<float*>(kw_s4);
  float* v_s = reinterpret_cast<float*>(v_s4);

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * kTile, e0 = blockIdx.y * kTile;
  const int64_t bh = blockIdx.z;
  const int64_t nc = S / L;
  const bool with_n = blockIdx.y == 0;
  const int tr = tid >> 4, tc = tid & 15;  // C rows 4 tr.., columns 4 tc..

  float C[4][4], n = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int x = 0; x < 4; ++x) C[a][x] = 0.f;

  for (int64_t c = 0; c < nc; ++c) {
    float* Cc = Cs + ((bh * nc + c) * DH + d0) * DH + e0;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      store4(Cc + (4 * tr + a) * DH + 4 * tc,
             make_float4(C[a][0], C[a][1], C[a][2], C[a][3]));
    if (with_n && tid < kTile) ns[(bh * nc + c) * DH + d0 + tid] = n;

    float U[4][4], nu = 0.f;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int x = 0; x < 4; ++x) U[a][x] = 0.f;
    const int64_t row0 = bh * S + c * L;
    for (int64_t j0 = 0; j0 < L; j0 += kJT) {
      __syncthreads();
      for (int idx = tid * 4; idx < kJT * kTile; idx += kThreads * 4) {
        const int jj = idx / kTile, dd = idx - jj * kTile;
        float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
        if (j0 + jj < L) {
          const int64_t row = row0 + j0 + jj;
          const float wj = w[row];
          kx = load4(k + row * DH + d0 + dd);
          kx.x *= wj; kx.y *= wj; kx.z *= wj; kx.w *= wj;
          vx = load4(v + row * DH + e0 + dd);
        }
        store4(kw_s + idx, kx);
        store4(v_s + idx, vx);
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < kJT; ++jj) {
        const float4 kx = load4(kw_s + jj * kTile + 4 * tr);
        const float4 vx = load4(v_s + jj * kTile + 4 * tc);
        const float kk[4] = {kx.x, kx.y, kx.z, kx.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          U[a][0] += kk[a] * vx.x;
          U[a][1] += kk[a] * vx.y;
          U[a][2] += kk[a] * vx.z;
          U[a][3] += kk[a] * vx.w;
        }
      }
      if (with_n && tid < kTile)
        for (int jj = 0; jj < kJT; ++jj) nu += kw_s[jj * kTile + tid];
    }
    const float dc = decay[bh * nc + c];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int x = 0; x < 4; ++x) C[a][x] = dc * C[a][x] + U[a][x];
    n = dc * n + nu;
  }
}

// ---------------------------------------------------------------------------
// 3. output: every chunk at once
// ---------------------------------------------------------------------------

template <int DH>
constexpr int out_smem_floats() {
  return 2 * kRT * (DH + 4) + kRT * (kMaxL + 1) + 2 * kMaxL + 4 * kRT;
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
output_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ li32,
              const float* __restrict__ m_start,
              const float* __restrict__ b, const float* __restrict__ Cs,
              const float* __restrict__ ns, T* __restrict__ out, int64_t S,
              int64_t L) {
  constexpr int DHP = DH + 4;
  constexpr int SP = kMaxL + 1;
  constexpr int NE = DH / 128;  // float4 column groups a thread owns
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // kRT x DHP
  float* Ts = Qs + kRT * DHP;                   // staging, kKT x DHP
  float* Sc = Ts + kKT * DHP;                   // gated scores, kRT x SP
  float* bs = Sc + kRT * SP;                    // b of the chunk
  float* lis = bs + kMaxL;                      // li of the chunk
  float* r_m = lis + kMaxL;                     // m_t
  float* r_g = r_m + kRT;                       // g_t
  float* r_qn = r_g + kRT;                      // q_t . n0
  float* r_den = r_qn + kRT;                    // max(|n_t|, exp(-m_t))

  const int tid = threadIdx.x;
  const int64_t nc = S / L;
  const int64_t t0 = ((int64_t)gridDim.x - 1 - blockIdx.x) * kRT;  // heavy first
  const int64_t c = blockIdx.y, bh = blockIdx.z;
  const int64_t row0 = bh * S + c * L;          // first row of the chunk
  const float m0 = m_start[bh * nc + c];
  const float* C0 = Cs + (bh * nc + c) * (int64_t)DH * DH;
  const float* n0 = ns + (bh * nc + c) * (int64_t)DH;
  const int64_t t_end = t0 + kRT < L ? t0 + kRT : L;  // rows t0 .. t_end-1
  const int64_t kmax = t_end;                        // keys 0 .. kmax-1

  for (int j = tid; j < L; j += kThreads) {
    bs[j] = b[row0 + j];
    lis[j] = li32[row0 + j];
  }
  for (int idx = tid * 4; idx < kRT * DH; idx += kThreads * 4) {
    const int r = idx / DH, d = idx - r * DH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < t_end) x = load4(q + (row0 + t0 + r) * DH + d);
    store4(Qs + r * DHP + d, x);
  }
  __syncthreads();

  // per-row stabilizer, inter-chunk gate and q . n0: 8 threads a row
  {
    const int r = tid >> 3, part = tid & 7;
    const int64_t t = t0 + r;
    const bool valid = t < t_end;
    float mi = kNegInf, qn = 0.f;
    if (valid) {
      const float bt = bs[t];
      for (int64_t j = part; j <= t; j += 8)
        mi = fmaxf(mi, (bt - bs[j]) + lis[j]);
      for (int d = part; d < DH; d += 8) qn += Qs[r * DHP + d] * n0[d];
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      mi = fmaxf(mi, __shfl_xor_sync(0xffffffffu, mi, off));
      qn += __shfl_xor_sync(0xffffffffu, qn, off);
    }
    if (part == 0) {
      const float m_inter = valid ? m0 + bs[t] : 0.f;
      const float mt = fmaxf(fmaxf(m_inter, mi), kNegInf);
      r_m[r] = mt;
      r_g[r] = expf(m_inter - mt);
      r_qn[r] = qn;
    }
  }

  // gated scores against keys 0 .. kmax-1: row tid/8, keys tid%8 + 8 u
  for (int64_t j0 = 0; j0 < kmax; j0 += kKT) {
    __syncthreads();
    for (int idx = tid * 4; idx < kKT * DH; idx += kThreads * 4) {
      const int jj = idx / DH, d = idx - jj * DH;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j0 + jj < kmax) x = load4(k + (row0 + j0 + jj) * DH + d);
      store4(Ts + jj * DHP + d, x);
    }
    __syncthreads();
    const int r = tid >> 3, jb = tid & 7;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 qx = load4(Qs + r * DHP + d);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 kx = load4(Ts + (jb + 8 * u) * DHP + d);
        s[u] += qx.x * kx.x + qx.y * kx.y + qx.z * kx.z + qx.w * kx.w;
      }
    }
    const int64_t t = t0 + r;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t j = j0 + jb + 8 * u;
      float sc = 0.f;
      if (t < t_end && j <= t)
        sc = s[u] * expf(((bs[t] - bs[j]) + lis[j]) - r_m[r]);
      if (j < kMaxL) Sc[r * SP + j] = sc;
    }
  }
  __syncthreads();

  // normalizer: 8 threads a row
  {
    const int r = tid >> 3, part = tid & 7;
    float ssum = 0.f;
    for (int64_t j = part; j < kmax; j += 8) ssum += Sc[r * SP + j];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      ssum += __shfl_xor_sync(0xffffffffu, ssum, off);
    if (part == 0) {
      const float nt = r_g[r] * r_qn[r] + ssum;
      r_den[r] = fmaxf(fabsf(nt), expf(-r_m[r]));
    }
  }

  // output rows 4 warp .. + 3, columns 4 (lane + 32 e) .. + 3
  const int warp = tid >> 5, lane = tid & 31;
  float acc[4][NE][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < NE; ++e)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[a][e][x] = 0.f;

  if (c > 0) {  // C0 is zero in the first chunk
    for (int d0 = 0; d0 < DH; d0 += kKT) {
      __syncthreads();
      for (int idx = tid * 4; idx < kKT * DH; idx += kThreads * 4) {
        const int dd = idx / DH, e = idx - dd * DH;
        store4(Ts + dd * DHP + e, load4(C0 + (int64_t)(d0 + dd) * DH + e));
      }
      __syncthreads();
#pragma unroll 4
      for (int dd = 0; dd < kKT; ++dd) {
        float qa[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) qa[a] = Qs[(4 * warp + a) * DHP + d0 + dd];
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const float4 cx = load4(Ts + dd * DHP + 4 * (lane + 32 * e));
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc[a][e][0] += qa[a] * cx.x;
            acc[a][e][1] += qa[a] * cx.y;
            acc[a][e][2] += qa[a] * cx.z;
            acc[a][e][3] += qa[a] * cx.w;
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float g = r_g[4 * warp + a];
#pragma unroll
      for (int e = 0; e < NE; ++e)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[a][e][x] *= g;
    }
  }

  for (int64_t j0 = 0; j0 < kmax; j0 += kKT) {
    __syncthreads();
    for (int idx = tid * 4; idx < kKT * DH; idx += kThreads * 4) {
      const int jj = idx / DH, e = idx - jj * DH;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j0 + jj < kmax) x = load4(v + (row0 + j0 + jj) * DH + e);
      store4(Ts + jj * DHP + e, x);
    }
    __syncthreads();
    const int jn = kmax - j0 < kKT ? (int)(kmax - j0) : kKT;
    for (int jj = 0; jj < jn; ++jj) {
      float sa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sa[a] = Sc[(4 * warp + a) * SP + j0 + jj];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const float4 vx = load4(Ts + jj * DHP + 4 * (lane + 32 * e));
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a][e][0] += sa[a] * vx.x;
          acc[a][e][1] += sa[a] * vx.y;
          acc[a][e][2] += sa[a] * vx.z;
          acc[a][e][3] += sa[a] * vx.w;
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = 4 * warp + a;
    if (t0 + r >= t_end) continue;
    const float den = r_den[r];
    T* orow = out + (row0 + t0 + r) * DH;
#pragma unroll
    for (int e = 0; e < NE; ++e)
      store4(orow + 4 * (lane + 32 * e),
             make_float4(acc[a][e][0] / den, acc[a][e][1] / den,
                         acc[a][e][2] / den, acc[a][e][3] / den));
  }
}

template <int DH, typename T>
int launch(int gates_bf16, const void* q, const void* k, const void* v,
           const void* li, const void* lf, void* out, float* C, float* n,
           float* m, float* decay, float* b, float* w, float* li32,
           int64_t BH, int64_t S, int64_t L, cudaStream_t st) {
  const int64_t nc = S / L;
  const unsigned gblocks = (unsigned)((BH + 31) / 32);
  if (gates_bf16)
    gates_kernel<__nv_bfloat16><<<gblocks, 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(li),
        static_cast<const __nv_bfloat16*>(lf), m, decay, b, w, li32, BH, S,
        L);
  else
    gates_kernel<float><<<gblocks, 32, 0, st>>>(
        static_cast<const float*>(li), static_cast<const float*>(lf), m,
        decay, b, w, li32, BH, S, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  state_kernel<DH, T><<<dim3(DH / kTile, DH / kTile, (unsigned)BH), kThreads,
                        0, st>>>(static_cast<const T*>(k),
                                 static_cast<const T*>(v), decay, w, C, n, S,
                                 L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t bytes = sizeof(float) * out_smem_floats<DH>();
  err = cudaFuncSetAttribute(output_kernel<DH, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  output_kernel<DH, T><<<dim3((unsigned)((L + kRT - 1) / kRT), (unsigned)nc,
                              (unsigned)BH), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), li32, m, b, C, n, static_cast<T*>(out), S,
      L);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int64_t Dh, int gates_bf16, const void* q, const void* k,
             const void* v, const void* li, const void* lf, void* out,
             float* C, float* n, float* m, float* decay, float* b, float* w,
             float* li32, int64_t BH, int64_t S, int64_t L, cudaStream_t st) {
  switch (Dh) {
    case 128:
      return launch<128, T>(gates_bf16, q, k, v, li, lf, out, C, n, m, decay,
                            b, w, li32, BH, S, L, st);
    case 256:
      return launch<256, T>(gates_bf16, q, k, v, li, lf, out, C, n, m, decay,
                            b, w, li32, BH, S, L, st);
    case 384:
      return launch<384, T>(gates_bf16, q, k, v, li, lf, out, C, n, m, decay,
                            b, w, li32, BH, S, L, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  q, k, v, out: (BH, S, Dh)
// contiguous, 16-byte aligned, f32 (bf16 == 0) or bf16 (bf16 == 1), Dh
// 128, 256 or 384; li, lf: (BH, S) contiguous, f32 or bf16 (gates_bf16);
// S % L == 0, 0 < L <= 256.  Scratch, f32, from the caller: C
// (BH, S/L, Dh, Dh), n (BH, S/L, Dh), m and decay (BH, S/L), b, w and li32
// (BH, S).  Launches the three passes on `stream` and returns the first
// CUDA error code (0 on success); does not synchronize.
extern "C" int repro_mlstm_scan(int bf16, int gates_bf16, const void* q,
                                const void* k, const void* v, const void* li,
                                const void* lf, void* out, void* C, void* n,
                                void* m, void* decay, void* b, void* w,
                                void* li32, int64_t BH, int64_t S, int64_t Dh,
                                int64_t L, void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (L <= 0 || L > kMaxL || S % L) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* f[7] = {static_cast<float*>(C), static_cast<float*>(n),
                 static_cast<float*>(m), static_cast<float*>(decay),
                 static_cast<float*>(b), static_cast<float*>(w),
                 static_cast<float*>(li32)};
  return bf16 ? dispatch<__nv_bfloat16>(Dh, gates_bf16, q, k, v, li, lf, out,
                                        f[0], f[1], f[2], f[3], f[4], f[5],
                                        f[6], BH, S, L, st)
              : dispatch<float>(Dh, gates_bf16, q, k, v, li, lf, out, f[0],
                                f[1], f[2], f[3], f[4], f[5], f[6], BH, S, L,
                                st);
}
