// Blockwise int8 absmax quantize / dequantize for Hopper (sm_90a), one
// launch over every leaf of a checkpoint.
//
// Replace the Pallas TPU kernels repro/kernels/quant_blockwise.py::
// _quant_kernel and ::_dequant_kernel (wrappers `quantize`, `dequantize`,
// and repro/kernels/ops.py::quantize_array / dequantize_array around them),
// whose oracle is repro/kernels/ref.py::quant_ref / dequant_ref.  They
// compress the checkpoint store's f32 leaves (repro_torch/ckpt/store.py).
//
// What they compute, per group of 128 consecutive floats of a leaf padded
// with zeros to a whole number of rows of D (D = 512 for leaves of 512
// elements or more, else 128), so group g owns scale g:
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
// The leaf table (device memory, one `Leaf` row of six int64 per leaf, the
// wrapper's (L, 6) int64 tensor):
//   f32    address of the leaf's f32 elements: quantize's input,
//          dequantize's output; 16-byte aligned
//   q      address of its int8 payload, (n + pad) bytes; 16-byte aligned
//   s      address of its f32 scales, (n + pad) / 128 of them
//   n      its element count, unpadded
//   d      its row width D (the payload's shape is ((n + pad) / D, D))
//   first  its first group in the launch: the exclusive prefix sum of the
//          leaves' group counts (n + pad) / 128, so non-decreasing
// `n_groups` is the sum of all group counts.
//
// Design: one launch for all leaves, so the card does not idle between
// small ones while the host prepares the next call.  Persistent blocks,
// two an SM at most (fewer when the occupancy allows fewer), each walk a
// contiguous range of the global groups: a binary search over `first`
// finds the leaf of the range's first group, and the walk then steps from
// leaf to leaf, cutting the range into spans of at most one ring slot's
// worth of groups of one leaf.  One lane of a producer warp keeps a 4-slot
// ring in shared memory filled with 1-D bulk copies (cp.async.bulk,
// completion counted on the slot's mbarrier), so 64 KB per block are in
// flight whatever the consumers do; 16 consumer warps take a slot's groups
// in turn and release the slot.  A bulk copy takes a multiple of 16 bytes
// from a 16-byte aligned address, so a leaf's last 0-3 elements are read
// with masked plain loads, and elements past n read as 0: the reference's
// zero padding, with no padded copy of the leaf.
//
// Quantize's arithmetic, not its bytes, limited it with one warp a group
// and one IEEE division an element (it ran no faster with plain loads than
// with the ring, and much faster with the division taken out).  So a
// half-warp takes a group (two float4s a lane, 4 shuffles), the scale's
// reciprocal is taken once a group and each element's quotient comes from
// it by one exact correction step (`quant_one`), each lane stores its eight
// int8 as two char4 and one lane the scale.  Dequantize: the slot holds int8
// (whole padded groups, so no tail), the scales are read by plain loads
// issued before the slot is waited for, and each lane writes four floats
// of a group straight into the leaf's unpadded output, masked past n.
// Outputs are stored with the streaming hint: nothing reads them back soon.
// The ring was kept over plain loads from the same walk and bodies, which
// took 5-6% longer on an H100 (PERF.md, slice 7).
//
// One leaf (the single-array wrappers) needs no table in device memory:
// its row travels by value in the launch's parameters and the kernel
// stages it in shared memory.  The grid's cap (SMs times blocks an SM) and
// the ring's shared-memory allowance are worked out once a device, so a
// one-leaf call costs a launch and no more.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int kGroup = 128;
constexpr int kConsumers = 16;  // consumer warps
constexpr int kThreads = 32 * (kConsumers + 1);  // + the producer warp
constexpr int kSlotBytes = 16384;
constexpr int kSlots = 4;
constexpr int kRingBytes = kSlots * kSlotBytes;
constexpr int kMaxBlocksPerSM = 2;
// groups a slot holds: f32 for quantize, int8 for dequantize
constexpr int kQuantGroups = kSlotBytes / (kGroup * 4);
constexpr int kDequantGroups = kSlotBytes / kGroup;
static_assert(kDequantGroups / kConsumers <= 32,
              "a consumer lane loads one scale of each of its warp's groups");

struct Leaf {
  int64_t f32, q, s, n, d, first;
};
static_assert(sizeof(Leaf) == 6 * sizeof(int64_t), "six int64 a row");

// max(a, b) that returns NaN when either is NaN, like jnp.max/jnp.maximum.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// rint(x / s) (round half to even) clipped to +-127 for a finite scale s
// and y = 1/s correctly rounded, without a division per element.  With q0 =
// x * y, the remainder x - s * q0 is exact in one fma and q0 + (x - s * q0)
// * y is the correctly rounded quotient x / s (Markstein's correction step)
// whenever nothing underflows, which holds for |x| >= 2^-102 since s >=
// 1e-12.  Below that |x / s| < 2^-62 and both round to 0.  Only rint of the
// quotient reaches q, so q is the IEEE quotient's, bit for bit.
__device__ __forceinline__ signed char quant_one(float x, float s, float y) {
  const float q0 = __fmul_rn(x, y);
  const float r = rintf(__fmaf_rn(__fmaf_rn(-s, q0, x), y, q0));
  return static_cast<signed char>(fminf(fmaxf(r, -127.0f), 127.0f));
}

// A run of `count` groups of leaf `leaf`, from global group `g`.
struct Span {
  int64_t leaf, g, count;
};

// The block's contiguous range of global groups, cut into spans of at most
// `cap` groups that never cross a leaf.  Every thread of the block walks
// it alike, so the producer and the consumers agree on every slot.
struct Walk {
  const Leaf* table;
  int64_t n_leaves, n_groups, g, end, leaf, leaf_end;

  __device__ Walk(const Leaf* t, int64_t L, int64_t total, int64_t lo,
                  int64_t hi)
      : table(t), n_leaves(L), n_groups(total), g(lo), end(hi) {
    int64_t a = 0, b = L - 1;  // the last leaf whose first group is <= lo
    while (a < b) {
      const int64_t mid = (a + b + 1) >> 1;
      if (t[mid].first <= lo) a = mid;
      else b = mid - 1;
    }
    leaf = a;
    leaf_end = end_of(a);
  }

  __device__ int64_t end_of(int64_t i) const {
    return i + 1 < n_leaves ? table[i + 1].first : n_groups;
  }

  __device__ bool next(int cap, Span& sp) {
    if (g >= end) return false;
    while (g >= leaf_end) leaf_end = end_of(++leaf);  // empty leaves too
    int64_t c = leaf_end - g;
    if (c > end - g) c = end - g;
    if (c > cap) c = cap;
    sp = {leaf, g, c};
    g += c;
    return true;
  }
};

__device__ __forceinline__ void block_range(int64_t total, int64_t& lo,
                                            int64_t& hi) {
  lo = total * blockIdx.x / gridDim.x;
  hi = total * (blockIdx.x + 1) / gridDim.x;
}

// Elements of a leaf's span that the bulk copy moves: those below n, cut
// to a multiple of 4 floats (16 bytes).
__device__ __forceinline__ int64_t copied_floats(const Leaf& lf, int64_t e0,
                                                 int64_t count) {
  int64_t v = lf.n - e0;
  if (v > count * kGroup) v = count * kGroup;
  return v > 0 ? (v & ~int64_t(3)) : 0;
}

// Four consecutive elements from element e of the leaf, zeros past n.
__device__ __forceinline__ float4 load_tail(const float* x, int64_t n,
                                            int64_t e) {
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = e + k < n ? x[e + k] : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// One group on a half-warp: lane h (0-15) holds elements 4h..4h+3 in `a`
// and 64 + 4h.. in `b`.  Returns the scale; `qa`, `qb` get the int8s.
__device__ __forceinline__ float quant_group(float4 a, float4 b, char4& qa,
                                            char4& qb) {
  const float ma = nan_max(nan_max(fabsf(a.x), fabsf(a.y)),
                           nan_max(fabsf(a.z), fabsf(a.w)));
  const float mb = nan_max(nan_max(fabsf(b.x), fabsf(b.y)),
                           nan_max(fabsf(b.z), fabsf(b.w)));
  float m = nan_max(ma, mb);
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)  // within the half-warp
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float sc = nan_max(m * (1.0f / 127.0f), 1e-12f);
  // a NaN or inf scale makes every quotient NaN or 0: q = 0
  qa = qb = make_char4(0, 0, 0, 0);
  if (isfinite(sc)) {
    const float y = __frcp_rn(sc);
    qa = make_char4(quant_one(a.x, sc, y), quant_one(a.y, sc, y),
                    quant_one(a.z, sc, y), quant_one(a.w, sc, y));
    qb = make_char4(quant_one(b.x, sc, y), quant_one(b.y, sc, y),
                    quant_one(b.z, sc, y), quant_one(b.w, sc, y));
  }
  return sc;
}

// Four floats at element e of a leaf's unpadded output, masked past n.
__device__ __forceinline__ void store_out(float* out, int64_t n, int64_t e,
                                          float4 o) {
  if (e + 4 <= n) {
    __stcs(reinterpret_cast<float4*>(out + e), o);
    return;
  }
  const float v[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (e + k < n) out[e + k] = v[k];
}

struct Ring {
  uint64_t full[kSlots], empty[kSlots];

  // also publishes what thread 0 wrote to shared memory before it
  __device__ void init() {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kSlots; ++s) {
        hopper::mbar_init(&full[s], 1);
        hopper::mbar_init(&empty[s], kConsumers);
      }
      hopper::mbar_fence_init();
    }
    __syncthreads();
  }

  // the producer: slot `fill % kSlots` gets `bytes` from `src` (or only an
  // arrival when there is nothing to copy), once its previous use ended
  __device__ void fill(int64_t i, uint8_t* base, const void* src,
                       uint32_t bytes) {
    const int s = (int)(i % kSlots);
    if (i >= kSlots)
      hopper::mbar_wait(&empty[s], (uint32_t)((i / kSlots - 1) & 1));
    if (bytes) {
      hopper::mbar_expect_tx(&full[s], bytes);
      hopper::bulk_load(base + s * kSlotBytes, src, bytes, &full[s]);
    } else {
      hopper::mbar_arrive(&full[s]);
    }
  }

  __device__ const uint8_t* wait(int64_t i, const uint8_t* base) {
    const int s = (int)(i % kSlots);
    hopper::mbar_wait(&full[s], (uint32_t)((i / kSlots) & 1));
    return base + s * kSlotBytes;
  }

  __device__ void release(int64_t i, int lane) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[(int)(i % kSlots)]);
  }
};

// `rows`: the leaf table, or null for the one leaf `one`.
__global__ void __launch_bounds__(kThreads)
quantize_leaves_kernel(const Leaf* __restrict__ rows, Leaf one,
                       int64_t n_leaves, int64_t n_groups) {
  extern __shared__ __align__(128) uint8_t ring_raw[];
  __shared__ Ring ring;
  __shared__ Leaf one_s;
  int64_t lo, hi;
  block_range(n_groups, lo, hi);
  if (lo >= hi) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) one_s = one;
  ring.init();
  const Leaf* table = rows ? rows : &one_s;
  Walk walk(table, n_leaves, n_groups, lo, hi);
  Span sp;

  if (warp == kConsumers) {  // the producer
    if (lane != 0) return;
    for (int64_t fill = 0; walk.next(kQuantGroups, sp); ++fill) {
      const Leaf& lf = table[sp.leaf];
      const int64_t e0 = (sp.g - lf.first) * kGroup;
      ring.fill(fill, ring_raw, reinterpret_cast<const float*>(lf.f32) + e0,
                (uint32_t)(copied_floats(lf, e0, sp.count) * 4));
    }
    return;
  }

  // two groups a warp at a time, one a half-warp
  const int h = lane & 15;
  for (int64_t fill = 0; walk.next(kQuantGroups, sp); ++fill) {
    const Leaf lf = table[sp.leaf];
    const float* x = reinterpret_cast<const float*>(lf.f32);
    const int64_t e0 = (sp.g - lf.first) * kGroup;
    const int64_t copied = e0 + copied_floats(lf, e0, sp.count);
    const float* slot =
        reinterpret_cast<const float*>(ring.wait(fill, ring_raw));
    // 4 elements from element e: from the slot where the bulk copy brought
    // them, else from the leaf's tail (masked, zeros past n)
    auto load4 = [&](int64_t e) {
      if (e < copied)
        return *reinterpret_cast<const float4*>(slot + (e - e0));
      return load_tail(x, lf.n, e);
    };
    for (int j = 2 * warp + (lane >> 4); j - (lane >> 4) < sp.count;
         j += 2 * kConsumers) {
      const bool live = j < sp.count;  // an odd count idles a half-warp
      const int64_t e = e0 + (int64_t)j * kGroup + h * 4;
      const float4 a = live ? load4(e) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 b = live ? load4(e + 64) : a;
      char4 qa, qb;
      const float sc = quant_group(a, b, qa, qb);
      if (live) {
        char4* qg = reinterpret_cast<char4*>(
            reinterpret_cast<signed char*>(lf.q) + (e - h * 4));
        __stcs(qg + h, qa);  // streamed: not read back
        __stcs(qg + 16 + h, qb);
        if (h == 0) __stcs(reinterpret_cast<float*>(lf.s) + e / kGroup, sc);
      }
    }
    ring.release(fill, lane);
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_leaves_kernel(const Leaf* __restrict__ rows, Leaf one,
                         int64_t n_leaves, int64_t n_groups) {
  extern __shared__ __align__(128) uint8_t ring_raw[];
  __shared__ Ring ring;
  __shared__ Leaf one_s;
  int64_t lo, hi;
  block_range(n_groups, lo, hi);
  if (lo >= hi) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) one_s = one;
  ring.init();
  const Leaf* table = rows ? rows : &one_s;
  Walk walk(table, n_leaves, n_groups, lo, hi);
  Span sp;

  if (warp == kConsumers) {  // the producer
    if (lane != 0) return;
    for (int64_t fill = 0; walk.next(kDequantGroups, sp); ++fill) {
      const Leaf& lf = table[sp.leaf];
      const int64_t e0 = (sp.g - lf.first) * kGroup;
      ring.fill(fill, ring_raw, reinterpret_cast<const signed char*>(lf.q) + e0,
                (uint32_t)(sp.count * kGroup));
    }
    return;
  }

  for (int64_t fill = 0; walk.next(kDequantGroups, sp); ++fill) {
    const Leaf lf = table[sp.leaf];
    const int64_t g0 = sp.g - lf.first;  // the span's first group in its leaf
    const float* scales = reinterpret_cast<const float*>(lf.s) + g0;
    // lane l holds the scale of the warp's l-th group of the span
    const int mine = warp + lane * kConsumers;
    const float my_scale = mine < sp.count ? scales[mine] : 0.0f;
    const signed char* slot =
        reinterpret_cast<const signed char*>(ring.wait(fill, ring_raw));
    float* out = reinterpret_cast<float*>(lf.f32);
    for (int j = warp, k = 0; j < sp.count; j += kConsumers, ++k) {
      const float sc = __shfl_sync(0xffffffffu, my_scale, k);
      const int64_t e = (g0 + j) * kGroup + lane * 4;
      const char4 c = reinterpret_cast<const char4*>(slot + j * kGroup)[lane];
      if (e < lf.n)
        store_out(out, lf.n, e,
                  make_float4(static_cast<float>(c.x) * sc,
                              static_cast<float>(c.y) * sc,
                              static_cast<float>(c.z) * sc,
                              static_cast<float>(c.w) * sc));
    }
    ring.release(fill, lane);
  }
}

using Kernel = void (*)(const Leaf*, Leaf, int64_t, int64_t);
constexpr int kMaxDevices = 64;
// each kernel's grid cap by device, 0 until it is known
std::atomic<int> quantize_cap[kMaxDevices], dequantize_cap[kMaxDevices];

// The most blocks a launch of `kernel` uses on the current device: its SMs
// times the blocks an SM holds with the ring (at most kMaxBlocksPerSM).
// The first call on a device also allows the ring's shared memory; later
// calls read the cap from `cache`.
cudaError_t grid_cap(Kernel kernel, std::atomic<int>* cache, int& cap) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kMaxDevices;
  if (cached && (cap = cache[device].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  int sms = 0, per_sm = 0;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           kRingBytes)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, kRingBytes)) != cudaSuccess)
    return err;
  if (per_sm > kMaxBlocksPerSM) per_sm = kMaxBlocksPerSM;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  cap = sms * per_sm;
  if (cached) cache[device].store(cap, std::memory_order_relaxed);
  return cudaSuccess;
}

int launch(Kernel kernel, std::atomic<int>* cache, const void* table,
           const int64_t* row, int64_t n_leaves, int64_t n_groups,
           int groups_per_slot, cudaStream_t stream) {
  if (n_leaves <= 0 || n_groups <= 0) return 0;
  Leaf one{};
  if (!table) {  // the one leaf `row`, passed by value
    if (n_leaves != 1 || !row) return (int)cudaErrorInvalidValue;
    memcpy(&one, row, sizeof one);
  }
  int cap = 0;
  const cudaError_t err = grid_cap(kernel, cache, cap);
  if (err != cudaSuccess) return (int)err;
  // at least one slot's worth of groups a block
  const int64_t want = (n_groups + groups_per_slot - 1) / groups_per_slot;
  const unsigned grid = (unsigned)(want < cap ? want : cap);
  kernel<<<grid, kThreads, kRingBytes, stream>>>(
      static_cast<const Leaf*>(table), one, n_leaves, n_groups);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  `table` is the device address
// of `n_leaves` Leaf rows (layout above) whose group counts sum to
// `n_groups`; or null, and then `row` is the host address of the one row
// (n_leaves = 1), copied into the launch's parameters.  Quantize reads each
// leaf's f32 and writes its payload and scales; dequantize reads the
// payload and scales and writes the leaf's n floats.  Launch on `stream`
// and return cudaGetLastError() (0 on success); do not synchronize.
extern "C" int repro_quantize_leaves(const void* table, const int64_t* row,
                                     int64_t n_leaves, int64_t n_groups,
                                     void* stream) {
  return launch(quantize_leaves_kernel, quantize_cap, table, row, n_leaves,
                n_groups, kQuantGroups, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_dequantize_leaves(const void* table, const int64_t* row,
                                       int64_t n_leaves, int64_t n_groups,
                                       void* stream) {
  return launch(dequantize_leaves_kernel, dequantize_cap, table, row,
                n_leaves, n_groups, kDequantGroups,
                static_cast<cudaStream_t>(stream));
}
