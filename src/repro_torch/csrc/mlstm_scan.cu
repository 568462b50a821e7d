// Chunkwise-parallel mLSTM (xLSTM's matrix memory) for Hopper (sm_90a), its
// products on the tensor cores in 3xTF32.
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
// not into the first chunk nor out of the last (72.5), against 806 MB of
// q, k, v, gates and out.  In 3xTF32 each f32 product is three TF32
// products: 3 x 98.3 GFLOP at the tensor cores' 494.5 TFLOP/s dense TF32
// rate is 0.597 ms; the bytes take 0.241 ms at 3.35 TB/s.  (At the 67
// TFLOP/s of the FP32 CUDA cores the same work takes 1.468 ms.)
//
// Accuracy.  One TF32 product keeps 11 bits of each operand, about 1e-3
// relative: outside the f32 gate of 1e-4 + 1e-3 |y| at Dh 384, chunk 256.
// So every operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (round to nearest, ties away, as cvt.rna: two integer instructions
// each), and each product is hi.hi + hi.lo + lo.hi, accumulated in f32 per
// k8 step in that order (tests/test_torch_mlstm_numerics.py models it and
// shows one product missing the gate).
//
// Layouts.  wgmma takes TF32 operands from shared memory K-major only, with
// no transpose bit, and from registers only as A.  So every A operand comes
// from registers, split as it is read, and every B operand is written
// K-major into shared memory by the block's threads, hi and lo side by side,
// as slabs of 32 f32 columns (128-byte rows, the 128-byte swizzle, 1024-byte
// atoms; the split is made as they store, which a TMA copy cannot do):
//   q (rows x Dh) is the A operand of q k^T and q C0 as it lies, read from
//   a tile that TMA wrote with the 128-byte swizzle (a warp's fragment
//   reads then hit 32 banks);
//   k (keys x Dh) is K-major for q k^T as it lies;
//   the state pass writes each chunk's starting C as C^T (d contiguous), so
//   that it is the K-major B operand of q C0 as it lies;
//   v is copied transposed (keys contiguous) into shared memory, the B
//   operand of S v and of the state update.  Inside each group of 8 keys
//   the copy puts key 2p at position p and key 2p + 1 at position p + 4,
//   so that a thread's A fragment of a k8 step holds two neighbouring keys
//   of a row (a k8 step's keys are summed in any order).
//
// Passes, where the dependencies split:
//   1. gates (a block of 8 warps per bh, a warp per chunk): b by a serial
//      sum inside each lane's run of the chunk and a warp scan across the
//      lanes; each chunk's F and max_j (F - b_j) + li_j; then one thread
//      runs the chunk recurrence of m (m0 of every chunk, the decays); then
//      every w.  These depend on the gates only, never on C or n, so every
//      later block reads one copy and agrees on them exactly.
//   2. state (a warpgroup per (64 rows d of C, 128 columns e, bh), walking
//      the chunks in order): C's tile lives in the wgmma
//      accumulator.  At each chunk it is stored (as C^T) into the scratch
//      the wrapper allocates (302 MB at full width), n likewise (by the
//      blocks of the first column slice), then scaled by the decay, and the
//      chunk's sum_j w_j k_j^T v_j is added 32 keys at a time: A = (w k)^T
//      from registers (read from a w k tile in shared memory), B = v^T.
//   3. output, two kernels.  Both bring their tiles in through a two-stage
//      TMA ring, one step ahead of the tensor cores.
//      a. scores (a warpgroup per (64 rows, chunk, bh), heaviest row tiles
//         first): each row's m_t, then per tile of 64 keys up to its last
//         row S = q k^T over 32-column slabs, gated and masked in the
//         accumulator and stored as f32 into scratch (134 MB at full
//         width), so that they are computed once and not in every column
//         slice of a row tile.
//      b. output (a warpgroup per (64 rows, 128 columns, chunk, bh)):
//         h = g (q C0) over 32-column slabs of q and C0^T, q . n0 from the
//         same q fragments, then h += S v over 32-key slabs of the scores
//         (whose row sums are the normalizer's intra-chunk part) and of
//         v^T, and h / max(|n_t|, exp(-m_t)) stored through shared memory
//         in whole rows.
// This is the TPU kernel's arithmetic with the work reordered.  Built
// without -fmad=false (held to a tolerance).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kMaxL = 256;
constexpr int kMaxDH = 384;
constexpr int kWG = 128;       // threads of a warpgroup
constexpr int kGateWarps = 8;  // warps of a gates block
constexpr int kRows = 64;      // output rows (or rows d of C) per block
constexpr int kKeys = 64;      // keys per score tile
constexpr int kCols = 128;     // output columns (or columns e of C) per block
constexpr int kSlab = 32;      // f32 columns of a 128-byte swizzled row
constexpr int kKWS = 68;       // row stride (floats) of the state's k tile

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
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

// Float offset of element (row, col), col < 32, in a swizzled slab whose
// first row starts a 1024-byte atom: 16-byte chunk col / 4 of the row is
// stored at chunk (col / 4) ^ (row % 8), as TMA's 128-byte swizzle does.
__device__ __forceinline__ int swz(int row, int col) {
  return row * kSlab + ((((col >> 2) ^ (row & 7)) << 2) | (col & 3));
}

// Splits the four values of x and stores them, as one 16-byte chunk each,
// at (row, c4 .. c4 + 3) of the hi and lo slabs.
__device__ __forceinline__ void store_split4(float* hi, float* lo, int row,
                                             int c4, float4 x) {
  uint4 h, l;
  hopper::split_tf32(x.x, h.x, l.x);
  hopper::split_tf32(x.y, h.y, l.y);
  hopper::split_tf32(x.z, h.z, l.z);
  hopper::split_tf32(x.w, h.w, l.w);
  const int off = swz(row, c4);
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(lo + off) = l;
}

__device__ __forceinline__ void store_split1(float* hi, float* lo, int off,
                                             float x) {
  uint32_t h, l;
  hopper::split_tf32(x, h, l);
  reinterpret_cast<uint32_t*>(hi)[off] = h;
  reinterpret_cast<uint32_t*>(lo)[off] = l;
}

// Position of key jj (of a group of 32) in the v^T slab: inside each group
// of 8, key 2p at p and key 2p + 1 at p + 4.
__device__ __forceinline__ int key_pos(int jj) {
  return (jj & ~7) | ((jj & 1) << 2) | ((jj & 7) >> 1);
}

__device__ __forceinline__ uint64_t desc(const float* slab, int kk) {
  return hopper::gmma_desc(slab + kk * 8, 16, 1024);
}

// v[key jj][columns e4 .. e4 + 3], split into the hi and lo slabs of v^T
// (128 rows e x 32 keys, keys in key_pos order).
__device__ __forceinline__ void store_vt4(float* hi, float* lo, int jj,
                                          int e4, float4 x) {
  const int pos = key_pos(jj);
  store_split1(hi, lo, swz(e4 + 0, pos), x.x);
  store_split1(hi, lo, swz(e4 + 1, pos), x.y);
  store_split1(hi, lo, swz(e4 + 2, pos), x.z);
  store_split1(hi, lo, swz(e4 + 3, pos), x.w);
}

// v^T of keys j0 .. j0 + 31 (zeros from key jn on) and columns e0 ..
// e0 + 127 of the rows at `vrow` (row stride DH), from device memory.  A
// warp takes 8 keys x 16 columns: each key's 64 bytes are contiguous in
// device memory, and each store hits every bank at most twice.
template <int DH, typename T>
__device__ __forceinline__ void load_vt(float* hi, float* lo, const T* vrow,
                                        int j0, int jn, int e0, int tid) {
#pragma unroll 4
  for (int u = 0; u < kSlab * kCols / 4 / kWG; ++u) {
    const int idx = tid + u * kWG, lane = idx & 31, wi = idx >> 5;
    const int jj = (wi & 3) * 8 + (lane & 7);
    const int e4 = (wi >> 2) * 16 + (lane >> 3) * 4;
    store_vt4(hi, lo, jj, e4,
              j0 + jj < jn
                  ? load4(vrow + (int64_t)(j0 + jj) * DH + e0 + e4)
                  : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// ---------------------------------------------------------------------------
// 1. gates
// ---------------------------------------------------------------------------

// b, li32 and w are (BH, S); m is (BH, nc + 1) (m0 of every chunk, then the
// last chunk's m'); decay is (BH, nc).
template <typename G>
__global__ void __launch_bounds__(32 * kGateWarps)
gates_kernel(const G* __restrict__ li, const G* __restrict__ lf,
             float* __restrict__ m, float* __restrict__ decay,
             float* __restrict__ b, float* __restrict__ w,
             float* __restrict__ li32, int64_t S, int L) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t bh = blockIdx.x;
  const int nc = (int)(S / L);
  const int per = (L + 31) / 32;             // a lane's run of the chunk
  const int j_lo = min(lane * per, L), j_hi = min(j_lo + per, L);
  const int last = (L - 1) / per;            // the lane that holds b[L-1]
  float* mb = m + bh * (nc + 1);
  float* db = decay + bh * nc;

  for (int c = warp; c < nc; c += kGateWarps) {
    const int64_t base = bh * S + (int64_t)c * L;
    float run = 0.f;
    for (int j = j_lo; j < j_hi; ++j) {
      run += load1(lf + base + j);
      b[base + j] = run;
    }
    float incl = run;  // inclusive scan of the runs' totals over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl = y + incl;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    float F = 0.f;
    for (int j = j_lo; j < j_hi; ++j) {
      const float bj = excl + b[base + j];
      b[base + j] = bj;
      F = bj;
    }
    F = __shfl_sync(0xffffffffu, F, last);
    float mx = kNegInf;
    for (int j = j_lo; j < j_hi; ++j) {
      const float lij = load1(li + base + j);
      li32[base + j] = lij;
      mx = fmaxf(mx, (F - b[base + j]) + lij);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) {  // parked until the recurrence below
      db[c] = F;
      mb[c + 1] = mx;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m0 = 0.f;
    mb[0] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float F = db[c], m_next = fmaxf(m0 + F, mb[c + 1]);
      db[c] = expf((m0 + F) - m_next);
      mb[c + 1] = m_next;
      m0 = m_next;
    }
  }
  __syncthreads();
  for (int c = warp; c < nc; c += kGateWarps) {
    const int64_t base = bh * S + (int64_t)c * L;
    const float F = b[base + L - 1], m_next = mb[c + 1];
    for (int j = j_lo; j < j_hi; ++j)
      w[base + j] = expf(((F - b[base + j]) + li32[base + j]) - m_next);
  }
}

__device__ __forceinline__ float* align1024(uint8_t* p) {
  return reinterpret_cast<float*>(p + ((1024 - (hopper::smem_u32(p) & 1023))
                                       & 1023));
}

// acc (64 x 128) += A . B^T over one K slab of 32 (keys of v^T, or columns
// d of C0^T), A from registers (q_fragments, score_fragments, or the state
// pass's (w k)^T), B's hi and lo slabs in shared memory: three TF32
// products per k8 step.
__device__ __forceinline__ void wgmma_rs_slab(float (&acc)[64],
                                              const uint32_t (&a)[32],
                                              const float* Vhi,
                                              const float* Vlo) {
#pragma unroll
  for (int c8 = 0; c8 < 4; ++c8) {
    const uint32_t(&hi)[4] =
        *reinterpret_cast<const uint32_t(*)[4]>(&a[8 * c8]);
    const uint32_t(&lo)[4] =
        *reinterpret_cast<const uint32_t(*)[4]>(&a[8 * c8 + 4]);
    hopper::wgmma_tf32_rs_m64n128k8(acc, hi, desc(Vhi, c8));
    hopper::wgmma_tf32_rs_m64n128k8(acc, hi, desc(Vlo, c8));
    hopper::wgmma_tf32_rs_m64n128k8(acc, lo, desc(Vhi, c8));
  }
}

// ---------------------------------------------------------------------------
// 2. state: C (as C^T) and n at every chunk start
// ---------------------------------------------------------------------------

constexpr int kStateSmemBytes =
    (2 * kCols * kSlab + kSlab * kKWS + kWG) * 4 + 1024;

template <int DH, typename T>
__global__ void __launch_bounds__(kWG)
state_kernel(const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ decay, const float* __restrict__ w,
             float* __restrict__ Ct, float* __restrict__ ns, int64_t S,
             int L) {
  extern __shared__ uint8_t smem_raw[];
  float* Vhi = align1024(smem_raw);        // v^T: 128 columns e x 32 keys
  float* Vlo = Vhi + kCols * kSlab;
  float* KW = Vlo + kCols * kSlab;         // w k: 32 keys x 64 rows d
  float* red = KW + kSlab * kKWS;          // n's two halves

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int d0 = blockIdx.x * kRows, e0 = blockIdx.y * kCols;
  const int64_t bh = blockIdx.z;
  const int nc = (int)(S / L);
  const bool with_n = blockIdx.y == 0;
  const int dr = 16 * warp + g;            // accumulator rows dr, dr + 8

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // n of row d0 + tid % 64 over the keys of half tid / 64 of each 32:
  // the row's n is the sum of its two halves
  float n = 0.f;

  // C (as C^T) and n at the start of chunk c
  auto store_state = [&](int c) {
    float* Cc = Ct + ((bh * nc + c) * DH + e0) * (int64_t)DH + d0;
#pragma unroll
    for (int i = 0; i < 64; ++i)
      Cc[(8 * (i >> 2) + 2 * t4 + (i & 1)) * DH + dr + 8 * ((i >> 1) & 1)] =
          acc[i];
    if (with_n) {
      red[tid] = n;
      __syncthreads();
      if (tid < kRows) ns[(bh * nc + c) * DH + d0 + tid] = red[tid] +
                                                           red[tid + kRows];
    }
  };

  store_state(0);
  for (int c = 0; c + 1 < nc; ++c) {  // nothing reads the state further
    const float dc = decay[bh * nc + c];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= dc;
    n *= dc;
    const int64_t row0 = bh * S + (int64_t)c * L;
    for (int j0 = 0; j0 < L; j0 += kSlab) {
      __syncthreads();  // the previous keys' operands are consumed
      // keys j0 .. j0 + 31: w k (32 keys x 64 rows d) and v^T
#pragma unroll
      for (int u = 0; u < kSlab * kRows / 4 / kWG; ++u) {
        const int idx = tid + u * kWG, jj = idx >> 4, d4 = (idx & 15) * 4;
        float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j0 + jj < L) {
          const float wj = w[row0 + j0 + jj];
          y = load4(k + (row0 + j0 + jj) * DH + d0 + d4);
          y = make_float4(y.x * wj, y.y * wj, y.z * wj, y.w * wj);
        }
        *reinterpret_cast<float4*>(KW + jj * kKWS + d4) = y;
      }
      load_vt<DH>(Vhi, Vlo, v + row0 * DH, j0, L, e0, tid);
      hopper::fence_proxy_async();
      __syncthreads();
      if (with_n) {
        const float* col = KW + (tid >> 6) * (kSlab / 2) * kKWS + (tid & 63);
        float part = 0.f;
#pragma unroll
        for (int jj = 0; jj < kSlab / 2; ++jj) part += col[jj * kKWS];
        n += part;
      }

      // A = (w k)^T: rows dr, dr + 8; keys 2 t4 and 2 t4 + 1 of each group
      // of 8 (positions t4 and t4 + 4 of the v^T slab)
      uint32_t a[32];
#pragma unroll
      for (int c8 = 0; c8 < 4; ++c8) {
        const float* k0 = KW + (8 * c8 + 2 * t4) * kKWS + dr;
        const float* k1 = k0 + kKWS;
        hopper::split_tf32(k0[0], a[8 * c8 + 0], a[8 * c8 + 4]);
        hopper::split_tf32(k0[8], a[8 * c8 + 1], a[8 * c8 + 5]);
        hopper::split_tf32(k1[0], a[8 * c8 + 2], a[8 * c8 + 6]);
        hopper::split_tf32(k1[8], a[8 * c8 + 3], a[8 * c8 + 7]);
      }
      hopper::wgmma_fence();
      wgmma_rs_slab(acc, a, Vhi, Vlo);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(a);
    }
    store_state(c + 1);
  }
}

// ---------------------------------------------------------------------------
// 3. output: the gated scores, then h, every chunk at once
// ---------------------------------------------------------------------------

// Both kernels of the output pass bring their operands in through a ring of
// kRing stages that TMA fills one step ahead: thread 0 refills a stage once
// every thread has converted it.  A stage holds a 64 x 32 f32 tile (q, or
// the scores) and a tile of up to 128 x 32 f32 (C0^T, k, or v).
constexpr int kRing = 2;
constexpr int kRawA = kRows * kSlab * 4;
constexpr int kRawB = kCols * kSlab * 4;
constexpr int kStageBytes = kRawA + kRawB;
static_assert(kStageBytes % 1024 == 0, "the operand slabs follow the ring");

// Raw rows (ROWS x 32, row-major, as TMA wrote them) split into the hi and
// lo slabs; rows from `valid` on are zeros.
template <int ROWS, typename T>
__device__ __forceinline__ void convert_slab(float* hi, float* lo,
                                             const T* raw, int valid,
                                             int tid) {
#pragma unroll
  for (int u = 0; u < ROWS * 8 / kWG; ++u) {
    const int idx = tid + u * kWG, r = idx >> 3, c4 = (idx & 7) * 4;
    const float4 x = r < valid ? load4(raw + r * kSlab + c4)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    store_split4(hi, lo, r, c4, x);
  }
}

// Raw v (32 keys x 128 columns, row-major, as TMA wrote it) into the hi
// and lo slabs of v^T; keys from `valid` on are zeros.  A warp takes 4 keys
// x 32 columns, so that its reads hit every bank at most four times.
template <typename T>
__device__ __forceinline__ void convert_vt(float* hi, float* lo, const T* raw,
                                           int valid, int tid) {
#pragma unroll
  for (int u = 0; u < kSlab * kCols / 4 / kWG; ++u) {
    const int idx = tid + u * kWG, lane = idx & 31, wi = idx >> 5;
    const int jj = (wi & 7) * 4 + (lane & 3);
    const int e4 = (wi >> 3) * 32 + (lane >> 2) * 4;
    store_vt4(hi, lo, jj, e4,
              jj < valid ? load4(raw + jj * kCols + e4)
                         : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// An element of a raw 64 x 32 tile: with the 128-byte swizzle in f32, where
// it puts a warp's fragment reads in 32 banks; row-major in bf16.
__device__ __forceinline__ float raw_at(const float* raw, int r, int col) {
  return raw[swz(r, col)];
}
__device__ __forceinline__ float raw_at(const __nv_bfloat16* raw, int r,
                                        int col) {
  return __bfloat162float(raw[r * kSlab + col]);
}

// The register A fragments of a raw q slab (64 rows x 32 columns d) for its
// four k8 steps, hi in a[8 kk .. 8 kk + 3] and lo in a[8 kk + 4 .. 8 kk + 7]:
// rows ra and ra + 8, columns 8 kk + t4 and 8 kk + t4 + 4; rows from
// `valid` on are zeros.
template <typename T>
__device__ __forceinline__ void q_fragments(uint32_t (&a)[32], const T* raw,
                                            int ra, int valid, int t4) {
  const bool v0 = ra < valid, v1 = ra + 8 < valid;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c0 = 8 * kk + t4, c1 = c0 + 4;
    hopper::split_tf32(v0 ? raw_at(raw, ra, c0) : 0.f, a[8 * kk + 0],
                       a[8 * kk + 4]);
    hopper::split_tf32(v1 ? raw_at(raw, ra + 8, c0) : 0.f, a[8 * kk + 1],
                       a[8 * kk + 5]);
    hopper::split_tf32(v0 ? raw_at(raw, ra, c1) : 0.f, a[8 * kk + 2],
                       a[8 * kk + 6]);
    hopper::split_tf32(v1 ? raw_at(raw, ra + 8, c1) : 0.f, a[8 * kk + 3],
                       a[8 * kk + 7]);
  }
}

// The register A fragments of a raw slab of gated scores (64 rows x 32
// keys, f32, 128-byte swizzle) for S v: in k8 group c8, keys 8 c8 + 2 t4 and
// 8 c8 + 2 t4 + 1 at positions t4 and t4 + 4 (the order of key_pos); keys
// from `valid` on are zeros.  Their sums go into the rows' normalizers.
__device__ __forceinline__ void score_fragments(uint32_t (&a)[32],
                                                float (&rsum)[2],
                                                const float* raw, int ra,
                                                int t4, int valid) {
#pragma unroll
  for (int c8 = 0; c8 < 4; ++c8) {
    const int col = 8 * c8 + 2 * t4;
    float2 x0 = *reinterpret_cast<const float2*>(raw + swz(ra, col));
    float2 x1 = *reinterpret_cast<const float2*>(raw + swz(ra + 8, col));
    if (col >= valid) x0.x = x1.x = 0.f;
    if (col + 1 >= valid) x0.y = x1.y = 0.f;
    rsum[0] += x0.x + x0.y;
    rsum[1] += x1.x + x1.y;
    hopper::split_tf32(x0.x, a[8 * c8 + 0], a[8 * c8 + 4]);
    hopper::split_tf32(x1.x, a[8 * c8 + 1], a[8 * c8 + 5]);
    hopper::split_tf32(x0.y, a[8 * c8 + 2], a[8 * c8 + 6]);
    hopper::split_tf32(x1.y, a[8 * c8 + 3], a[8 * c8 + 7]);
  }
}

constexpr int kScoresSmemBytes =
    kRing * kStageBytes + (2 * kKeys * kSlab + 3 * kMaxL) * 4 + 1024;

// 3a. scores: a block per (64 rows, chunk, bh), heaviest row tiles first.
// Per key tile of 64 up to its last row, S = q k^T over 32-column slabs (q
// from registers, k from shared memory), gated and masked in the
// accumulator, written to Sg (the chunk's L x LP f32 matrix; rows of LP, L
// rounded up to 4); each row's m_t into mt.
template <int DH, typename T>
__global__ void __launch_bounds__(kWG)
scores_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const float* __restrict__ li32, const float* __restrict__ m,
              const float* __restrict__ b, float* __restrict__ Sg,
              float* __restrict__ mt, int S, int L, int LP) {
  constexpr int kNds = DH / kSlab;  // slabs of a key tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kRing];
  uint8_t* ring = reinterpret_cast<uint8_t*>(align1024(smem_raw));
  float* Khi = reinterpret_cast<float*>(ring + kRing * kStageBytes);
  float* Klo = Khi + kKeys * kSlab;
  float* bs = Klo + kKeys * kSlab;   // b of the chunk
  float* lis = bs + kMaxL;           // li of the chunk
  float* r_m = lis + kMaxL;          // m_t

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_rt = (L + kRows - 1) / kRows;
  const int t0 = (n_rt - 1 - (int)blockIdx.x) * kRows;  // heavy first
  const int c = blockIdx.y, bh = blockIdx.z;
  const int nc = S / L;
  const int cL = c * L;
  const int64_t row0 = (int64_t)bh * S + cL;
  const int t_end = min(t0 + kRows, L), kmax = t_end;
  const int n_steps = (kmax + kKeys - 1) / kKeys * kNds;

  auto issue = [&](int i) {  // step i: key tile i / kNds, slab i % kNds
    uint64_t* bar = &full[i % kRing];
    uint8_t* dst = ring + (i % kRing) * kStageBytes;
    const int ds = (i % kNds) * kSlab, j0 = (i / kNds) * kKeys;
    hopper::mbar_expect_tx(bar, 2 * kRows * kSlab * sizeof(T));
    hopper::tma_load_3d(dst, &qmap, ds, cL + t0, bh, bar);
    hopper::tma_load_3d(dst + kRawA, &kmap, ds, cL + j0, bh, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
    for (int i = 0; i < kRing && i < n_steps; ++i) issue(i);
  }
  for (int j = tid; j < L; j += kWG) {
    bs[j] = b[row0 + j];
    lis[j] = li32[row0 + j];
  }
  __syncthreads();
  {  // m_t: 2 threads a row
    const int r = tid >> 1, part = tid & 1, t = t0 + r;
    const bool valid = t < t_end;
    float mi = kNegInf;
    if (valid) {
      const float bt = bs[t];
#pragma unroll 4
      for (int j = part; j <= t; j += 2) mi = fmaxf(mi, (bt - bs[j]) + lis[j]);
    }
    mi = fmaxf(mi, __shfl_xor_sync(0xffffffffu, mi, 1));
    if (part == 0) {
      const float m_inter = valid ? m[(int64_t)bh * (nc + 1) + c] + bs[t]
                                  : 0.f;
      r_m[r] = fmaxf(fmaxf(m_inter, mi), kNegInf);
      if (valid) mt[row0 + t] = r_m[r];
    }
  }
  __syncthreads();

  const int ra = 16 * warp + g;  // accumulator rows ra, ra + 8
  float* Sc = Sg + ((int64_t)bh * nc + c) * L * LP;
  float sc[32];
  uint32_t a[32];
  for (int i = 0; i < n_steps; ++i) {
    const int stage = i % kRing, ds_i = i % kNds, j0 = (i / kNds) * kKeys;
    const uint8_t* raw = ring + stage * kStageBytes;
    hopper::mbar_wait(&full[stage], (i / kRing) & 1);
    q_fragments(a, reinterpret_cast<const T*>(raw), ra, t_end - t0, t4);
    convert_slab<kKeys, T>(Khi, Klo, reinterpret_cast<const T*>(raw + kRawA),
                           kmax - j0, tid);
    hopper::fence_proxy_async();
    __syncthreads();  // operands stored; the ring stage is read
    if (tid == 0 && i + kRing < n_steps) issue(i + kRing);
    if (ds_i == 0) {
#pragma unroll
      for (int i2 = 0; i2 < 32; ++i2) sc[i2] = 0.f;
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t(&hi)[4] =
          *reinterpret_cast<const uint32_t(*)[4]>(&a[8 * kk]);
      const uint32_t(&lo)[4] =
          *reinterpret_cast<const uint32_t(*)[4]>(&a[8 * kk + 4]);
      hopper::wgmma_tf32_rs_m64n64k8(sc, hi, desc(Khi, kk));
      hopper::wgmma_tf32_rs_m64n64k8(sc, hi, desc(Klo, kk));
      hopper::wgmma_tf32_rs_m64n64k8(sc, lo, desc(Khi, kk));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(a);
    if (ds_i == kNds - 1) {  // gate, mask and store the tile
#pragma unroll
      for (int i2 = 0; i2 < 32; i2 += 2) {
        const int row = ra + 8 * ((i2 >> 1) & 1), t = t0 + row;
        const int j = j0 + 8 * (i2 >> 2) + 2 * t4;
        float s0 = 0.f, s1 = 0.f;
        if (t < t_end && j <= t)
          s0 = sc[i2] * expf(((bs[t] - bs[j]) + lis[j]) - r_m[row]);
        if (t < t_end && j + 1 <= t)
          s1 = sc[i2 + 1] * expf(((bs[t] - bs[j + 1]) + lis[j + 1]) -
                                 r_m[row]);
        if (t < L && j < LP)
          *reinterpret_cast<float2*>(Sc + (int64_t)t * LP + j) =
              make_float2(s0, s1);
      }
    }
    __syncthreads();  // every warp is done with the operands
  }
}

constexpr int kOutSmemBytes =
    kRing * kStageBytes +
    (2 * kCols * kSlab + kMaxL + 2 * kRows + kMaxDH) * 4 + 1024;

// 3b. output: a block per (64 rows, 128 columns; heaviest row tiles first),
// chunk, bh.  h = g (q C0) over 32-column slabs of q (registers) and C0^T
// (shared memory), then h += S v over 32-key slabs of the scores
// (registers, read from Sg; their row sums are the normalizers' intra
// part) and of v^T (shared memory); q . n0 from the q fragments.
template <int DH, typename T>
__global__ void __launch_bounds__(kWG)
output_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap cmap,
              const __grid_constant__ CUtensorMap smap,
              const float* __restrict__ m, const float* __restrict__ b,
              const float* __restrict__ mt, const float* __restrict__ ns,
              T* __restrict__ out, int S, int L) {
  constexpr int kSlices = DH / kCols;
  constexpr int kNds = DH / kSlab;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kRing];
  uint8_t* ring = reinterpret_cast<uint8_t*>(align1024(smem_raw));
  float* Bhi = reinterpret_cast<float*>(ring + kRing * kStageBytes);
  float* Blo = Bhi + kCols * kSlab;  // C0^T (128 x 32) or v^T (128 x 32)
  float* bs = Blo + kCols * kSlab;   // b of the chunk
  float* r_m = bs + kMaxL;           // m_t
  float* r_g = r_m + kRows;          // g_t
  float* n0s = r_g + kRows;          // n0 of the chunk

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_rt = (L + kRows - 1) / kRows;
  const int t0 = (n_rt - 1 - (int)blockIdx.x / kSlices) * kRows;  // heavy first
  const int e0 = ((int)blockIdx.x % kSlices) * kCols;
  const int c = blockIdx.y, bh = blockIdx.z;
  const int nc = S / L;
  const int cL = c * L;
  const int plane = bh * nc + c;
  const int64_t row0 = (int64_t)bh * S + cL;
  const int t_end = min(t0 + kRows, L), kmax = t_end;
  const int n_qc = c > 0 ? kNds : 0;  // C0 = 0 in the first chunk
  const int n_steps = n_qc + (kmax + kSlab - 1) / kSlab;

  auto issue = [&](int i) {  // q C0 slab i, then S v slab i - n_qc
    uint64_t* bar = &full[i % kRing];
    uint8_t* dst = ring + (i % kRing) * kStageBytes;
    if (i < n_qc) {
      hopper::mbar_expect_tx(bar, kRows * kSlab * sizeof(T) + kRawB);
      hopper::tma_load_3d(dst, &qmap, i * kSlab, cL + t0, bh, bar);
      hopper::tma_load_3d(dst + kRawA, &cmap, i * kSlab, e0, plane, bar);
    } else {
      const int j0 = (i - n_qc) * kSlab;
      hopper::mbar_expect_tx(bar, kRawA + kSlab * kCols * sizeof(T));
      hopper::tma_load_3d(dst, &smap, j0, t0, plane, bar);
      hopper::tma_load_3d(dst + kRawA, &vmap, e0, cL + j0, bh, bar);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
    for (int i = 0; i < kRing && i < n_steps; ++i) issue(i);
  }
  for (int j = tid; j < L; j += kWG) bs[j] = b[row0 + j];
  for (int d = tid; d < DH; d += kWG) n0s[d] = ns[(int64_t)plane * DH + d];
  __syncthreads();
  if (tid < kRows) {  // m_t (from the scores kernel) and g_t
    const int t = t0 + tid;
    const bool valid = t < t_end;
    const float m_inter = valid ? m[(int64_t)bh * (nc + 1) + c] + bs[t] : 0.f;
    const float m_t = valid ? mt[row0 + t] : 0.f;
    r_m[tid] = m_t;
    r_g[tid] = expf(m_inter - m_t);
  }

  // q . n0 of rows ra and ra + 8 over this thread's columns (the q
  // fragments' columns), summed over the row's 4 lanes at the end
  float h[64], rsum[2] = {0.f, 0.f}, qn[2] = {0.f, 0.f};
  uint32_t a[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) h[i] = 0.f;
  const int ra = 16 * warp + g;  // accumulator rows ra, ra + 8

  for (int i = 0; i < n_steps; ++i) {
    const int stage = i % kRing;
    const uint8_t* raw = ring + stage * kStageBytes;
    hopper::mbar_wait(&full[stage], (i / kRing) & 1);
    if (i < n_qc) {
      const T* rq = reinterpret_cast<const T*>(raw);
      q_fragments(a, rq, ra, t_end - t0, t4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c0 = 8 * kk + t4, c1 = c0 + 4, ds = i * kSlab;
        const float n_0 = n0s[ds + c0], n_1 = n0s[ds + c1];
        qn[0] += raw_at(rq, ra, c0) * n_0 + raw_at(rq, ra, c1) * n_1;
        qn[1] += raw_at(rq, ra + 8, c0) * n_0 + raw_at(rq, ra + 8, c1) * n_1;
      }
      convert_slab<kCols, float>(Bhi, Blo,
                                 reinterpret_cast<const float*>(raw + kRawA),
                                 kCols, tid);
    } else {
      const int j0 = (i - n_qc) * kSlab;
      score_fragments(a, rsum, reinterpret_cast<const float*>(raw), ra, t4,
                      kmax - j0);
      convert_vt<T>(Bhi, Blo, reinterpret_cast<const T*>(raw + kRawA),
                    kmax - j0, tid);
    }
    hopper::fence_proxy_async();
    __syncthreads();  // operands stored; the ring stage is read
    if (tid == 0 && i + kRing < n_steps) issue(i + kRing);
    hopper::wgmma_fence();
    wgmma_rs_slab(h, a, Bhi, Blo);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(h);
    hopper::fence_regs(a);
    if (i == n_qc - 1) {  // h = g (q C0)
      const float g0 = r_g[ra], g1 = r_g[ra + 8];
#pragma unroll
      for (int i2 = 0; i2 < 64; ++i2) h[i2] *= ((i2 >> 1) & 1) ? g1 : g0;
    }
    __syncthreads();  // every warp is done with the operands
  }

  // normalizer over the 4 lanes of a row, then h / max(|n_t|, exp(-m_t))
  float den[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rsum[hh] += __shfl_xor_sync(0xffffffffu, rsum[hh], 1);
    rsum[hh] += __shfl_xor_sync(0xffffffffu, rsum[hh], 2);
    qn[hh] += __shfl_xor_sync(0xffffffffu, qn[hh], 1);
    qn[hh] += __shfl_xor_sync(0xffffffffu, qn[hh], 2);
    const int row = ra + 8 * hh;
    const float nt = r_g[row] * qn[hh] + rsum[hh];
    den[hh] = fmaxf(fabsf(nt), expf(-r_m[row]));
  }
  // through shared memory (the operand slabs; 16-byte chunk c of row r at
  // chunk c ^ (r % 8)), so that each warp stores whole 512-byte rows
  float* Hs = Bhi;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int hh = (i >> 1) & 1, row = ra + 8 * hh;
    const int col = 8 * (i >> 2) + 2 * t4;
    *reinterpret_cast<float2*>(
        Hs + row * kCols + ((((col >> 2) ^ (row & 7)) << 2) | (col & 3))) =
        make_float2(h[i] / den[hh], h[i + 1] / den[hh]);
  }
  __syncthreads();
#pragma unroll 4
  for (int idx = tid; idx < kRows * kCols / 4; idx += kWG) {
    const int row = idx >> 5, c16 = idx & 31;
    if (t0 + row < t_end)
      store4(out + (row0 + t0 + row) * DH + e0 + 4 * c16,
             *reinterpret_cast<const float4*>(
                 Hs + row * kCols + ((c16 ^ (row & 7)) << 2)));
  }
}

// The scratch of a call, f32, from the caller (see the C entry).
struct Scratch {
  float *C, *n, *m, *decay, *b, *w, *li32, *Sg, *mt;
};

template <int DH, typename T>
int launch(int gates_bf16, const void* q, const void* k, const void* v,
           const void* li, const void* lf, void* out, const Scratch& x,
           int64_t BH, int64_t S, int64_t L, int passes, cudaStream_t st) {
  const int64_t nc = S / L;
  const int64_t LP = (L + 3) / 4 * 4;
  if (BH > 65535 || nc > 65535 || S > INT32_MAX / 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (passes & 1) {
    if (gates_bf16)
      gates_kernel<__nv_bfloat16><<<(unsigned)BH, 32 * kGateWarps, 0, st>>>(
          static_cast<const __nv_bfloat16*>(li),
          static_cast<const __nv_bfloat16*>(lf), x.m, x.decay, x.b, x.w,
          x.li32, S, (int)L);
    else
      gates_kernel<float><<<(unsigned)BH, 32 * kGateWarps, 0, st>>>(
          static_cast<const float*>(li), static_cast<const float*>(lf), x.m,
          x.decay, x.b, x.w, x.li32, S, (int)L);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    err = cudaFuncSetAttribute(state_kernel<DH, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStateSmemBytes);
    if (err != cudaSuccess) return (int)err;
    state_kernel<DH, T><<<dim3(DH / kRows, DH / kCols, (unsigned)BH), kWG,
                          kStateSmemBytes, st>>>(
        static_cast<const T*>(k), static_cast<const T*>(v), x.decay, x.w,
        x.C, x.n, S, (int)L);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 4) {
    // q, k, v as (Dh, S, BH), C^T as (Dh, Dh, BH * nc) and the scores as
    // (LP, L, BH * nc), innermost first; q and the scores with the 128-byte
    // swizzle where they are f32
    const CUtensorMapDataType type = sizeof(T) == 4
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const int es = (int)sizeof(T);
    const CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
    const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
    const CUtensorMapSwizzle qsw = sizeof(T) == 4 ? sw : none;
    CUtensorMap qm, km, vm, cm, sm;
    if (!hopper::make_map_3d(&qm, type, es, q, DH, S, BH, kSlab, kRows, qsw) ||
        !hopper::make_map_3d(&km, type, es, k, DH, S, BH, kSlab, kKeys, none) ||
        !hopper::make_map_3d(&vm, type, es, v, DH, S, BH, kCols, kSlab, none) ||
        !hopper::make_map_3d(&cm, f32, 4, x.C, DH, DH, BH * nc, kSlab, kCols,
                             none) ||
        !hopper::make_map_3d(&sm, f32, 4, x.Sg, LP, L, BH * nc, kSlab, kRows,
                             sw))
      return (int)cudaErrorInvalidValue;
    const unsigned row_tiles = (unsigned)((L + kRows - 1) / kRows);
    err = cudaFuncSetAttribute(scores_kernel<DH, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kScoresSmemBytes);
    if (err != cudaSuccess) return (int)err;
    scores_kernel<DH, T><<<dim3(row_tiles, (unsigned)nc, (unsigned)BH), kWG,
                           kScoresSmemBytes, st>>>(
        qm, km, x.li32, x.m, x.b, x.Sg, x.mt, (int)S, (int)L, (int)LP);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(output_kernel<DH, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kOutSmemBytes);
    if (err != cudaSuccess) return (int)err;
    output_kernel<DH, T><<<dim3(row_tiles * (DH / kCols), (unsigned)nc,
                                (unsigned)BH), kWG, kOutSmemBytes, st>>>(
        qm, vm, cm, sm, x.m, x.b, x.mt, x.n, static_cast<T*>(out), (int)S,
        (int)L);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T>
int dispatch(int64_t Dh, int gates_bf16, const void* q, const void* k,
             const void* v, const void* li, const void* lf, void* out,
             const Scratch& x, int64_t BH, int64_t S, int64_t L, int passes,
             cudaStream_t st) {
  switch (Dh) {
    case 128:
      return launch<128, T>(gates_bf16, q, k, v, li, lf, out, x, BH, S, L,
                            passes, st);
    case 256:
      return launch<256, T>(gates_bf16, q, k, v, li, lf, out, x, BH, S, L,
                            passes, st);
    case 384:
      return launch<384, T>(gates_bf16, q, k, v, li, lf, out, x, BH, S, L,
                            passes, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  q, k, v, out: (BH, S, Dh)
// contiguous, 16-byte aligned, f32 (bf16 == 0) or bf16 (bf16 == 1), Dh
// 128, 256 or 384; li, lf: (BH, S) contiguous, f32 or bf16 (gates_bf16);
// S % L == 0, 0 < L <= 256, BH and S / L at most 65535.  Scratch, f32,
// 16-byte aligned, from the caller: C (BH, S/L, Dh, Dh), holding each
// chunk's starting C transposed; n (BH, S/L, Dh); m (BH, S/L + 1); decay
// (BH, S/L); b, w, li32 and mt (BH, S); Sg (BH, S/L, L, LP) with LP = L
// rounded up to a multiple of 4.  Launches the passes named in `passes` (1
// gates, 2 state, 4 output; 7 for the function, the others to time a pass
// alone on the scratch of an earlier call) on `stream` and returns the
// first CUDA error code (0 on success); does not synchronize.
extern "C" int repro_mlstm_scan(int bf16, int gates_bf16, const void* q,
                                const void* k, const void* v, const void* li,
                                const void* lf, void* out, void* C, void* n,
                                void* m, void* decay, void* b, void* w,
                                void* li32, void* Sg, void* mt, int64_t BH,
                                int64_t S, int64_t Dh, int64_t L, int passes,
                                void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (L <= 0 || L > kMaxL || S % L) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch x = {static_cast<float*>(C),     static_cast<float*>(n),
                     static_cast<float*>(m),     static_cast<float*>(decay),
                     static_cast<float*>(b),     static_cast<float*>(w),
                     static_cast<float*>(li32),  static_cast<float*>(Sg),
                     static_cast<float*>(mt)};
  return bf16 ? dispatch<__nv_bfloat16>(Dh, gates_bf16, q, k, v, li, lf, out,
                                        x, BH, S, L, passes, st)
              : dispatch<float>(Dh, gates_bf16, q, k, v, li, lf, out, x, BH,
                                S, L, passes, st);
}
