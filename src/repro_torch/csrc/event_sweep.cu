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
// Bound: device-memory bytes.  Each lane reads the gaps it consumes,
// (n_fail + 1) * sizeof(real) (capped at F), and writes 42 bytes of
// outputs; it does a few tens of floating-point operations per gap, below
// the card's operations-per-byte balance point.  Each thread reads its own
// row of the (B, N, F) schedule, so a warp's loads are strided by F
// elements and use one element of each 32-byte sector per step (L1 keeps
// the rest for the next steps).  Transposing the schedule so that a warp
// reads consecutive lanes, or drawing the gaps inside the kernel with
// Philox, is left to a later change.
//
// Launch: 2-D grid, x over trials in blocks of 128 threads (the ragged
// edge t >= N is masked), y over points (striding when B exceeds the
// 65535 limit of gridDim.y).  All offsets are 64-bit: B * N * F passes
// 2^31 at realistic sizes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename real> struct Num;
template <> struct Num<float> {
  __device__ static float inf() { return __int_as_float(0x7f800000); }
  __device__ static float floor_(float x) { return floorf(x); }
};
template <> struct Num<double> {
  __device__ static double inf() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
  __device__ static double floor_(double x) { return floor(x); }
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

template <typename real, bool kCompensated>
__global__ void __launch_bounds__(kThreads) event_sweep_kernel(
    const real* __restrict__ T_p, const real* __restrict__ C_p,
    const real* __restrict__ R_p, const real* __restrict__ D_p,
    const real* __restrict__ O_p, const real* __restrict__ TB_p,
    const real* __restrict__ gaps, int64_t B, int64_t N, int64_t F,
    int64_t n_steps, double* __restrict__ wall_out,
    double* __restrict__ work_out, double* __restrict__ io_out,
    double* __restrict__ down_out, int32_t* __restrict__ nfail_out,
    int32_t* __restrict__ nckpt_out, bool* __restrict__ trunc_out,
    bool* __restrict__ ginf_out) {
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
    const real* row = gaps + lane * F;

    real wall = zero, committed = zero, work = zero, io = zero, down = zero;
    real c_wall = zero, c_comm = zero, c_work = zero, c_io = zero,
         c_down = zero;
    int32_t n_fail = 0, n_ckpt = 0;
    bool used_inf = false, done = false;

    for (int64_t i = 0; i < n_steps; ++i) {
      // One gap per inter-failure stretch; past the schedule the gap is
      // inf ("no more failures") and the lane is flagged exhausted.
      const bool in_range = (int64_t)n_fail < F;
      const real g = in_range ? row[n_fail] : Num<real>::inf();

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

template <typename real, bool kCompensated>
void launch(const void* T, const void* C, const void* R, const void* D,
            const void* omega, const void* T_base, const void* gaps,
            int64_t B, int64_t N, int64_t F, int64_t n_steps, void* wall,
            void* work, void* io, void* down, void* n_fail, void* n_ckpt,
            void* truncated, void* exhausted, cudaStream_t stream) {
  const int64_t gx = (N + kThreads - 1) / kThreads;
  const int64_t gy = B < 65535 ? B : 65535;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  event_sweep_kernel<real, kCompensated><<<grid, kThreads, 0, stream>>>(
      static_cast<const real*>(T), static_cast<const real*>(C),
      static_cast<const real*>(R), static_cast<const real*>(D),
      static_cast<const real*>(omega), static_cast<const real*>(T_base),
      static_cast<const real*>(gaps), B, N, F, n_steps,
      static_cast<double*>(wall), static_cast<double*>(work),
      static_cast<double*>(io), static_cast<double*>(down),
      static_cast<int32_t*>(n_fail), static_cast<int32_t*>(n_ckpt),
      static_cast<bool*>(truncated), static_cast<bool*>(exhausted));
}

}  // namespace

// Plain C entry point (bound with ctypes).  Parameter arrays and gaps are
// of the compute type (double if is_f64, else float); outputs are f64 x4,
// int32 x2, bool x2, each (B, N) contiguous.  Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronize.
extern "C" int repro_event_sweep(
    int is_f64, int compensated, const void* T, const void* C, const void* R,
    const void* D, const void* omega, const void* T_base, const void* gaps,
    int64_t B, int64_t N, int64_t F, int64_t n_steps, void* wall,
    void* work, void* io, void* down, void* n_fail, void* n_ckpt,
    void* truncated, void* exhausted, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if ((N + kThreads - 1) / kThreads > 2147483647LL) return 9;  // too many
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    if (compensated)
      launch<double, true>(T, C, R, D, omega, T_base, gaps, B, N, F, n_steps,
                           wall, work, io, down, n_fail, n_ckpt, truncated,
                           exhausted, s);
    else
      launch<double, false>(T, C, R, D, omega, T_base, gaps, B, N, F,
                            n_steps, wall, work, io, down, n_fail, n_ckpt,
                            truncated, exhausted, s);
  } else {
    if (compensated)
      launch<float, true>(T, C, R, D, omega, T_base, gaps, B, N, F, n_steps,
                          wall, work, io, down, n_fail, n_ckpt, truncated,
                          exhausted, s);
    else
      launch<float, false>(T, C, R, D, omega, T_base, gaps, B, N, F, n_steps,
                           wall, work, io, down, n_fail, n_ckpt, truncated,
                           exhausted, s);
  }
  return (int)cudaGetLastError();
}
