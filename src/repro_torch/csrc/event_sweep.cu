// Event-level Monte-Carlo sweep kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/event_sweep.py::_event_kernel
// (the reference's engine_kind="pallas"), whose oracle is the lax.scan
// kernel repro/sim/engine.py::_run_one_event.
//
// Work: one thread per (grid point, trial) lane.  Each thread loops once
// per FAILURE: between consecutive failures the trajectory is closed form
// (completed periods are an integer division of the gap against the
// period), so the loop runs n_fail + 1 times and then exits.  The
// reference's iterations after completion are identities, so this
// per-lane exit is exact.
//
// Arithmetic: kept term for term from _run_one_event (same expressions,
// same parenthesization, same select order), so the kernel is bitwise
// equal to the port's plain PyTorch version.  It must be compiled with
// -fmad=false and without --use_fast_math: a contracted multiply-add
// would round once where the plain version rounds twice, and would break
// the Neumaier two-sum of the compensated mode.
//
// Precision: templated on the compute type.  f64 is the oracle; f32 with
// `compensated` keeps every running sum (wall, committed, work, io, down)
// as a Neumaier pair, forms each branch's increment, selects it, then
// folds it in, and reads the remaining work from committed + c.
//
// Gap sources: the loop body is one template over where gap j comes from.
//
// * GapsFromMemory (repro_event_sweep): an explicit (B, N, F) schedule
//   read through its three strides.  While a lane is active its gap index
//   equals the loop index, so on a (B, F, N) layout (trial stride 1) the
//   active lanes of a warp read consecutive addresses at every step.  On
//   the H100 that layout is no faster than (B, N, F), where L1 keeps each
//   row's sector for the lane's next three reads: the loop is bound by
//   its f64 instructions (four divides, two floors) and by warps that run
//   as long as their longest lane, not by bytes (its byte bound is the
//   gaps a lane consumes plus 42 bytes of outputs).
// * GapsFromPhilox (repro_event_sweep_sampled): the lane draws gap j when
//   it needs it, so no schedule is stored.  Uniform j of lane (point i,
//   trial t) is Philox-4x32-10 of counter (j / 2, t, i's low word, i's
//   high word) under the seed's two 32-bit halves, words 0-1 for even j and 2-3 for odd j (one
//   Philox call serves two gaps; words 2-3 wait in registers), then
//   the process's inverse CDF in f64 (core/philox.py, core/failures.py
//   ::draw_gaps, term for term), cast to the compute type.  Bound: integer
//   and f64 instructions (Philox, log/exp, the update), not bytes: the
//   lane writes its 42 bytes of outputs and reads a few parameters.
//
// repro_event_draws writes the (B, F, N) gaps the sampled kernel draws,
// through the same GapsFromPhilox, so the sweep can be checked bitwise
// against the explicit kernel on the same schedule whatever the bits of
// log and exp.
//
// Capacity: a gap index >= F is inf ("no more failures") and flags the
// lane exhausted, in both sources, so a sampled run ends in the state of
// the explicit run on the same capacity.
//
// Launch: 2-D grid, x over trials in blocks of 128 threads (the ragged
// edge t >= N is masked), y over points (striding when B exceeds the
// 65535 limit of gridDim.y).  All offsets are 64-bit: B * N * F passes
// 2^31 at realistic sizes, and a trace index is taken modulo n in 64 bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// At least 4 blocks an SM (16 warps), so up to 128 registers a thread:
// with the block size alone, ptxas holds the f64 kernels near 64-72
// registers and spills a few bytes to the stack.
constexpr int kMinBlocks = 4;

template <typename real> struct Num;
template <> struct Num<float> {
  __device__ static float inf() { return __int_as_float(0x7f800000); }
  __device__ static float floor_(float x) { return floorf(x); }
  __device__ static float from_f64(double x) { return __double2float_rn(x); }
};
template <> struct Num<double> {
  __device__ static double inf() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
  __device__ static double floor_(double x) { return floor(x); }
  __device__ static double from_f64(double x) { return x; }
};

// max(x, 0) that propagates NaN, like jnp.maximum / torch.clamp_min.
template <typename real>
__device__ __forceinline__ real max0(real x) {
  return (x > real(0) || x != x) ? x : real(0);
}

// Finite test without relying on overloads: x - x is 0 for finite x and
// NaN for +-inf and NaN.
template <typename real>
__device__ __forceinline__ bool is_finite(real x) {
  return (x - x) == real(0);
}

// One Neumaier step (sim/precision.py::comp_add): exact two-sum of s + x,
// its rounding error accumulated into c.
template <typename real>
__device__ __forceinline__ void comp_add(real& s, real& c, real x) {
  const real s2 = s + x;
  const real bb = s2 - s;
  const real err = (s - (s2 - bb)) + (x - bb);
  s = s2;
  c = c + err;
}

// ---------------------------------------------------------------------------
// Counter-based uniforms (core/philox.py)
// ---------------------------------------------------------------------------

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // Weyl steps

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Two 32-bit words -> one f64 uniform in (0, 1) from 52 bits (exact).
__device__ __forceinline__ double unit(uint32_t a, uint32_t b) {
  const uint64_t x = ((uint64_t)(a >> 6) << 26) | (uint64_t)(b >> 6);
  return ((double)x + 0.5) * 2.220446049250313080847263336181640625e-16;
}

// ---------------------------------------------------------------------------
// ndtri: PyTorch's CUDA torch.special.ndtri (the Cephes algorithm, ATen's
// jiterator source), with the multiply-adds that its default
// contraction fuses written as fma, since this file builds with
// -fmad=false.
// ---------------------------------------------------------------------------

__constant__ double kP0[5] = {
    -5.99633501014107895267E1, 9.80010754185999661536E1,
    -5.66762857469070293439E1, 1.39312609387279679503E1,
    -1.23916583867381258016E0};
__constant__ double kQ0[9] = {
    1.00000000000000000000E0,  1.95448858338141759834E0,
    4.67627912898881538453E0,  8.63602421390890590575E1,
    -2.25462687854119370527E2, 2.00260212380060660359E2,
    -8.20372256168333339912E1, 1.59056225126211695515E1,
    -1.18331621121330003142E0};
__constant__ double kP1[9] = {
    4.05544892305962419923E0,   3.15251094599893866154E1,
    5.71628192246421288162E1,   4.40805073893200834700E1,
    1.46849561928858024014E1,   2.18663306850790267539E0,
    -1.40256079171354495875E-1, -3.50424626827848203418E-2,
    -8.57456785154685413611E-4};
__constant__ double kQ1[9] = {
    1.00000000000000000000E0,   1.57799883256466749731E1,
    4.53907635128879210584E1,   4.13172038254672030440E1,
    1.50425385692907503408E1,   2.50464946208309415979E0,
    -1.42182922854787788574E-1, -3.80806407691578277194E-2,
    -9.33259480895457427372E-4};
__constant__ double kP2[9] = {
    3.23774891776946035970E0,  6.91522889068984211695E0,
    3.93881025292474443415E0,  1.33303460815807542389E0,
    2.01485389549179081538E-1, 1.23716634817820021358E-2,
    3.01581553508235416007E-4, 2.65806974686737550832E-6,
    6.23974539184983293730E-9};
__constant__ double kQ2[9] = {
    1.00000000000000000000E0,  6.02427039364742014255E0,
    3.67983563856160859403E0,  1.37702099489081330271E0,
    2.16236993594496635890E-1, 1.34204006088543189037E-2,
    3.28014464682127739104E-4, 2.89247864745380683936E-6,
    6.79019408009981274425E-9};

template <int kLen>
__device__ __forceinline__ double polevl(double x, const double* A) {
  double r = 0.0;
#pragma unroll
  for (int i = 0; i < kLen; ++i) r = fma(r, x, A[i]);
  return r;
}

__device__ double ndtri(double y0) {
  const double zero = 0.0, one = 1.0;
  if (y0 == zero) return -Num<double>::inf();
  if (y0 == one) return Num<double>::inf();
  if (y0 < zero || y0 > one) return __longlong_as_double(0x7ff8000000000000LL);
  bool code = true;
  double y = y0;
  if (y > one - 0.13533528323661269189) {  // exp(-2)
    y = one - y;
    code = false;
  }
  if (y > 0.13533528323661269189) {
    y = y - 0.5;
    const double y2 = y * y;
    const double x = fma(y, y2 * polevl<5>(y2, kP0) / polevl<9>(y2, kQ0), y);
    return x * 2.50662827463100050242E0;  // sqrt(2 pi)
  }
  double x = sqrt(-2.0 * log(y));
  const double x0 = x - (log(x) / x);
  const double z = one / x;
  const double x1 = x < 8.0 ? z * polevl<9>(z, kP1) / polevl<9>(z, kQ1)
                            : z * polevl<9>(z, kP2) / polevl<9>(z, kQ2);
  x = x0 - x1;
  return code ? -x : x;
}

// ---------------------------------------------------------------------------
// Gap sources: gap(j) for j < F, called with j = 0, 1, 2, ... in order.
// ---------------------------------------------------------------------------

template <typename real>
struct GapsFromMemory {
  const real* base;  // the lane's gap 0
  int64_t stride;    // elements between its gaps j and j + 1
  __device__ __forceinline__ real gap(int64_t j) const {
    return base[j * stride];
  }
};

template <typename real>
struct MemorySchedule {
  const real* gaps;
  int64_t s_point, s_trial, s_gap;
  __device__ __forceinline__ GapsFromMemory<real> lane(int64_t p,
                                                       int64_t t) const {
    return {gaps + p * s_point + t * s_trial, s_gap};
  }
};

enum Kind { kExponential = 0, kWeibull = 1, kLogNormal = 2, kTrace = 3 };

template <int kKind>
struct GapsFromPhilox {
  uint32_t trial, point, point_hi, k0, k1;  // point, point_hi: its words
  double a, b;           // the point's spec values (core/failures.py)
  const double* trace;   // kTrace: the trace and its length
  int64_t n_trace, start;
  uint32_t odd_hi, odd_lo;  // words 2-3 of the last call: uniform 2p + 1

  __device__ __forceinline__ double uniform(int64_t j) {
    uint32_t hi, lo;
    if ((j & 1) == 0) {
      const uint4 w = philox4x32_10((uint32_t)(j >> 1), trial, point,
                                    point_hi, k0, k1);
      hi = w.x;
      lo = w.y;
      odd_hi = w.z;
      odd_lo = w.w;
    } else {
      hi = odd_hi;
      lo = odd_lo;
    }
    return unit(hi, lo);
  }

  __device__ __forceinline__ double draw(int64_t j) {
    if (kKind == kTrace) return trace[(start + j) % n_trace] * a;
    const double u = uniform(j);
    if (kKind == kExponential) return a * (-log(u));
    if (kKind == kWeibull) return a * exp(log(-log(u)) / b);
    return exp(a + b * ndtri(u));
  }

  template <typename real>
  __device__ __forceinline__ real gap(int64_t j) {
    return Num<real>::from_f64(draw(j));
  }
};

template <int kKind>
struct PhiloxSchedule {
  const double* a;
  const double* b;
  const double* trace;
  int64_t n_trace;
  const int64_t* points;  // global point index of each row
  int64_t trial0;         // global trial index of column 0
  uint32_t k0, k1;

  __device__ __forceinline__ GapsFromPhilox<kKind> lane(int64_t p,
                                                        int64_t t) const {
    GapsFromPhilox<kKind> s;
    const uint64_t point = (uint64_t)points[p];
    s.trial = (uint32_t)(trial0 + t);
    s.point = (uint32_t)point;
    s.point_hi = (uint32_t)(point >> 32);
    s.k0 = k0;
    s.k1 = k1;
    s.a = a[p];
    s.b = b[p];
    s.trace = trace;
    s.n_trace = n_trace;
    s.start = 0;
    s.odd_hi = s.odd_lo = 0u;
    if (kKind == kTrace) {
      const int64_t st = (int64_t)floor(s.uniform(0) * (double)n_trace);
      s.start = st < n_trace - 1 ? st : n_trace - 1;
    }
    return s;
  }
};

// Memory sources hand out `real` already; Philox sources convert.
template <typename real>
__device__ __forceinline__ real gap_of(GapsFromMemory<real>& s, int64_t j) {
  return s.gap(j);
}
template <typename real, int kKind>
__device__ __forceinline__ real gap_of(GapsFromPhilox<kKind>& s, int64_t j) {
  return s.template gap<real>(j);
}

// ---------------------------------------------------------------------------
// The event loop
// ---------------------------------------------------------------------------

template <typename real, bool kCompensated, typename Schedule>
__global__ void __launch_bounds__(kThreads, kMinBlocks) event_sweep_kernel(
    const real* __restrict__ T_p, const real* __restrict__ C_p,
    const real* __restrict__ R_p, const real* __restrict__ D_p,
    const real* __restrict__ O_p, const real* __restrict__ TB_p,
    const Schedule sched, int64_t B, int64_t N, int64_t F, int64_t n_steps,
    double* __restrict__ wall_out, double* __restrict__ work_out,
    double* __restrict__ io_out, double* __restrict__ down_out,
    int32_t* __restrict__ nfail_out, int32_t* __restrict__ nckpt_out,
    bool* __restrict__ trunc_out, bool* __restrict__ ginf_out) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= N) return;
  const real zero = real(0);
  const real one = real(1);
  const real eps = real(1e-12);  // sim/engine.py::_EPS

  for (int64_t p = blockIdx.y; p < B; p += gridDim.y) {
    const real T = T_p[p];
    const real C = C_p[p];
    const real R = R_p[p];
    const real D = D_p[p];
    const real omega = O_p[p];
    const real T_base = TB_p[p];
    const real Tc = T - C;                      // compute-segment length
    const real w = T - (one - omega) * C;       // work per full period
    const real omega_safe = omega > zero ? omega : one;

    const int64_t lane = p * N + t;
    auto src = sched.lane(p, t);

    real wall = zero, committed = zero, work = zero, io = zero, down = zero;
    real c_wall = zero, c_comm = zero, c_work = zero, c_io = zero,
         c_down = zero;
    int32_t n_fail = 0, n_ckpt = 0;
    bool used_inf = false, done = false;

    for (int64_t i = 0; i < n_steps; ++i) {
      // One gap per inter-failure stretch; past the schedule the gap is
      // inf ("no more failures") and the lane is flagged exhausted.
      const bool in_range = (int64_t)n_fail < F;
      const real g = in_range ? gap_of<real>(src, (int64_t)n_fail)
                              : Num<real>::inf();

      // ---- closed-form completion time from this segment start ----
      const real committed_true = kCompensated ? committed + c_comm
                                               : committed;
      const real rem = T_base - committed_true;
      const real j = max0(Num<real>::floor_((rem - eps) / w));
      const real r = rem - j * w;               // work in the last period
      const real rr = r - Tc;                   // its checkpoint share
      const real t_in = rr > zero ? Tc + rr / omega_safe : r;
      const real t_fin = j * T + t_in;
      const bool complete = t_fin < g;

      // ---- failure at s = g after the segment start ----
      const real s = is_finite(g) ? g : zero;
      real k = Num<real>::floor_(s / T);
      k = (k > zero && k * T >= s) ? k - one : k;
      const real u = s - k * T;                 // offset in failing period
      const real uc = u - Tc;                   // its checkpoint share

      if (!kCompensated) {
        if (complete) {
          wall = wall + t_fin;
          work = work + rem;
          io = io + j * C + max0(rr) / omega_safe;
        } else {
          wall = (wall + s) + D + R;
          committed = k >= one ? committed + (k - one) * w + Tc : committed;
          work = work + k * w + (uc > zero ? Tc + omega * uc : u);
          io = io + k * C + max0(uc) + R;
          down = down + D;
        }
      } else {
        const real inc_wall = complete ? t_fin : s + D + R;
        const real inc_comm =
            complete ? zero : (k >= one ? (k - one) * w + Tc : zero);
        const real inc_work =
            complete ? rem : k * w + (uc > zero ? Tc + omega * uc : u);
        const real inc_io = complete ? j * C + max0(rr) / omega_safe
                                     : k * C + max0(uc) + R;
        const real inc_down = complete ? zero : D;
        comp_add(wall, c_wall, inc_wall);
        comp_add(committed, c_comm, inc_comm);
        comp_add(work, c_work, inc_work);
        comp_add(io, c_io, inc_io);
        comp_add(down, c_down, inc_down);
      }
      n_fail = complete ? n_fail : n_fail + 1;
      n_ckpt = n_ckpt + (int32_t)(complete ? j : k);
      used_inf = used_inf || !in_range;
      if (complete) {
        done = true;
        break;
      }
    }
    if (kCompensated) {
      wall = wall + c_wall;
      work = work + c_work;
      io = io + c_io;
      down = down + c_down;
    }
    wall_out[lane] = (double)wall;
    work_out[lane] = (double)work;
    io_out[lane] = (double)io;
    down_out[lane] = (double)down;
    nfail_out[lane] = n_fail;
    nckpt_out[lane] = n_ckpt;
    trunc_out[lane] = !done;
    ginf_out[lane] = used_inf;
  }
}

// The gaps the sampled kernel draws, (B, F, N) f64: out[(p F + j) N + t].
// One thread per lane, one Philox call per pair of gaps.
template <int kKind>
__global__ void __launch_bounds__(kThreads, kMinBlocks) event_draws_kernel(
    const PhiloxSchedule<kKind> sched, int64_t B, int64_t N, int64_t F,
    double* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= N) return;
  for (int64_t p = blockIdx.y; p < B; p += gridDim.y) {
    auto src = sched.lane(p, t);
    double* row = out + p * F * N + t;
#pragma unroll 1
    for (int64_t j = 0; j < F; j += 2) {
      row[j * N] = src.draw(j);
      if (j + 1 < F) row[(j + 1) * N] = src.draw(j + 1);
    }
  }
}

struct Outputs {
  void *wall, *work, *io, *down, *n_fail, *n_ckpt, *truncated, *exhausted;
};

dim3 grid_of(int64_t B, int64_t N) {
  const int64_t gx = (N + kThreads - 1) / kThreads;
  const int64_t gy = B < 65535 ? B : 65535;
  return dim3((unsigned)gx, (unsigned)gy);
}

template <typename real, bool kCompensated, typename Schedule>
void launch(const void* const* params, const Schedule& sched, int64_t B,
            int64_t N, int64_t F, int64_t n_steps, const Outputs& o,
            cudaStream_t stream) {
  event_sweep_kernel<real, kCompensated, Schedule>
      <<<grid_of(B, N), kThreads, 0, stream>>>(
          static_cast<const real*>(params[0]),
          static_cast<const real*>(params[1]),
          static_cast<const real*>(params[2]),
          static_cast<const real*>(params[3]),
          static_cast<const real*>(params[4]),
          static_cast<const real*>(params[5]), sched, B, N, F, n_steps,
          static_cast<double*>(o.wall), static_cast<double*>(o.work),
          static_cast<double*>(o.io), static_cast<double*>(o.down),
          static_cast<int32_t*>(o.n_fail), static_cast<int32_t*>(o.n_ckpt),
          static_cast<bool*>(o.truncated), static_cast<bool*>(o.exhausted));
}

// Calls f.template operator()<real, kCompensated>() for the policy.
template <typename Fn>
void with_policy(int is_f64, int compensated, Fn&& f) {
  if (is_f64) {
    if (compensated) f.template run<double, true>();
    else f.template run<double, false>();
  } else {
    if (compensated) f.template run<float, true>();
    else f.template run<float, false>();
  }
}

struct ExplicitLaunch {
  const void* const* params;
  const void* gaps;
  int64_t s_point, s_trial, s_gap, B, N, F, n_steps;
  Outputs o;
  cudaStream_t stream;
  template <typename real, bool kCompensated>
  void run() const {
    const MemorySchedule<real> sched{static_cast<const real*>(gaps), s_point,
                                     s_trial, s_gap};
    launch<real, kCompensated>(params, sched, B, N, F, n_steps, o, stream);
  }
};

template <int kKind>
struct SampledLaunch {
  const void* const* params;
  PhiloxSchedule<kKind> sched;
  int64_t B, N, F, n_steps;
  Outputs o;
  cudaStream_t stream;
  template <typename real, bool kCompensated>
  void run() const {
    launch<real, kCompensated>(params, sched, B, N, F, n_steps, o, stream);
  }
};

template <int kKind>
PhiloxSchedule<kKind> philox_schedule(const void* a, const void* b,
                                      const void* trace, int64_t n_trace,
                                      const void* points, int64_t trial0,
                                      uint32_t k0, uint32_t k1) {
  return {static_cast<const double*>(a), static_cast<const double*>(b),
          static_cast<const double*>(trace), n_trace,
          static_cast<const int64_t*>(points), trial0, k0, k1};
}

bool too_many_blocks(int64_t N) {
  return (N + kThreads - 1) / kThreads > 2147483647LL;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`
// and returns cudaGetLastError() (0 on success, 9 for a grid too large,
// 10 for an unknown kind); none synchronizes.
//
// Parameter arrays are of the compute type (double if is_f64, else
// float), each (B,) contiguous; outputs are f64 x4, int32 x2, bool x2,
// each (B, N) contiguous.

// The explicit schedule: gaps of the compute type, gap j of lane (p, t)
// at gaps[p * s_point + t * s_trial + j * s_gap] (element strides).
extern "C" int repro_event_sweep(
    int is_f64, int compensated, const void* T, const void* C, const void* R,
    const void* D, const void* omega, const void* T_base, const void* gaps,
    int64_t s_point, int64_t s_trial, int64_t s_gap, int64_t B, int64_t N,
    int64_t F, int64_t n_steps, void* wall, void* work, void* io, void* down,
    void* n_fail, void* n_ckpt, void* truncated, void* exhausted,
    void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (too_many_blocks(N)) return 9;
  const void* params[6] = {T, C, R, D, omega, T_base};
  const ExplicitLaunch l{params, gaps, s_point, s_trial, s_gap, B, N, F,
                         n_steps,
                         {wall, work, io, down, n_fail, n_ckpt, truncated,
                          exhausted},
                         static_cast<cudaStream_t>(stream)};
  with_policy(is_f64, compensated, l);
  return (int)cudaGetLastError();
}

// Gaps drawn in the kernel: `kind` 0 exponential, 1 weibull, 2 lognormal,
// 3 trace (core/failures.py::GapSpec.KINDS); `a`, `b` the (B,) f64 spec
// values, `trace` the f64 trace of n_trace gaps (kind 3), `points` the
// (B,) int64 global point indices, `trial0` the global trial of column 0,
// (k0, k1) the Philox key (the seed's low and high 32 bits).
extern "C" int repro_event_sweep_sampled(
    int is_f64, int compensated, int kind, const void* T, const void* C,
    const void* R, const void* D, const void* omega, const void* T_base,
    const void* a, const void* b, const void* trace, int64_t n_trace,
    const void* points, int64_t trial0, uint32_t k0, uint32_t k1, int64_t B,
    int64_t N, int64_t F, int64_t n_steps, void* wall, void* work, void* io,
    void* down, void* n_fail, void* n_ckpt, void* truncated, void* exhausted,
    void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (too_many_blocks(N)) return 9;
  const void* params[6] = {T, C, R, D, omega, T_base};
  const Outputs o{wall, work, io, down, n_fail, n_ckpt, truncated, exhausted};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
#define REPRO_SAMPLED(K)                                                    \
  case K: {                                                                 \
    const SampledLaunch<K> l{                                               \
        params,                                                             \
        philox_schedule<K>(a, b, trace, n_trace, points, trial0, k0, k1),   \
        B, N, F, n_steps, o, s};                                            \
    with_policy(is_f64, compensated, l);                                    \
    break;                                                                  \
  }
    REPRO_SAMPLED(kExponential)
    REPRO_SAMPLED(kWeibull)
    REPRO_SAMPLED(kLogNormal)
    REPRO_SAMPLED(kTrace)
#undef REPRO_SAMPLED
    default:
      return 10;
  }
  return (int)cudaGetLastError();
}

// The draws of repro_event_sweep_sampled, written to `out`: (B, F, N) f64
// contiguous, gap j of lane (p, t) at out[(p * F + j) * N + t].
extern "C" int repro_event_draws(int kind, const void* a, const void* b,
                                 const void* trace, int64_t n_trace,
                                 const void* points, int64_t trial0,
                                 uint32_t k0, uint32_t k1, int64_t B,
                                 int64_t N, int64_t F, void* out,
                                 void* stream) {
  if (B <= 0 || N <= 0 || F <= 0) return 0;
  if (too_many_blocks(N)) return 9;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* o = static_cast<double*>(out);
  switch (kind) {
#define REPRO_DRAWS(K)                                                       \
  case K:                                                                    \
    event_draws_kernel<K><<<grid_of(B, N), kThreads, 0, s>>>(                \
        philox_schedule<K>(a, b, trace, n_trace, points, trial0, k0, k1), B, \
        N, F, o);                                                            \
    break;
    REPRO_DRAWS(kExponential)
    REPRO_DRAWS(kWeibull)
    REPRO_DRAWS(kLogNormal)
    REPRO_DRAWS(kTrace)
#undef REPRO_DRAWS
    default:
      return 10;
  }
  return (int)cudaGetLastError();
}
