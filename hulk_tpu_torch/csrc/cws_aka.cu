// The histosketch flush's Aka, exact, for Hopper (sm_90a): for each sketch
// slot j and live bin i of a flush,
//
//   Aka[j][i] = c[j][bin_i] / (Exp(Log(esti_i) - b[j][bin_i]) * exp_r[j][bin_i])
//
// with Exp and Log Go's math.Exp and math.Log (fdlibm lineage), operation for
// operation: hulk_go_exp and hulk_go_log in native/hulkrt.cpp, the NumPy
// ports in hashes/fdlibm.py. The reference computes Aka so
// (src/histosketch/histosketch.go:129-155), and so do the exact host flush
// (hulkrt.cpp hulk_flush_exact, pass 2) and the plain PyTorch version,
// cws_aka_torch (hulk_tpu_torch/ops/cws_aka.py). hulk_tpu computes Aka with
// XLA's exp and log inside sharded_flush_step
// (hulk_tpu/parallel/mesh.py:196-315), within a few ULP of Go's; it has no
// Pallas kernel for it. This entry gives Go's bits, so the flush can run on
// the card and still write the reference's weights.
//
// Every operation is rounded once, to nearest: __dmul_rn, __dadd_rn,
// __dsub_rn, __ddiv_rn (and the library is built with --fmad=false), so no
// multiply and add fuse. Go's int() truncates (__double2int_rz). frexp is
// read from the bits (a subnormal scaled by 2^54 first, exactly). Ldexp(y, k)
// is two multiplies by powers of two built from bits, y * 2^h * 2^(k - h),
// h = k / 2: for Exp's k in [-1075, 1024] and y in [0.5, 2) the first
// product is normal and exact, so the second rounds once, as a correctly
// rounded Ldexp does, subnormal results included.
//
// Bound: bytes. Each (slot, live bin) reads c, b and exp_r at the bin (24 B)
// and writes Aka (8 B); each live bin reads its estimate and id (16 B). At
// 42 slots x 194,481 live bins that is 264 MB, 79 us at 3.35 TB/s. The
// arithmetic, about 60 FP64 instructions a (slot, bin) with Exp's two
// divides, is about a fifth of that at the card's FP64 rate. So a thread
// takes one live bin and kSlots slots: it computes Log once for its bin and
// reuses it for each of its slots, and the slot groups are a second grid
// dimension so that enough blocks are in flight to keep the loads coming.
// Neighbouring threads take neighbouring live bins, whose ids ascend, so the
// table reads of a warp fall in a few lines where the live bins are dense,
// and the writes of Aka are contiguous.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 8;  // slots a thread

// Go math/exp.go
constexpr double kLn2Hi = 6.93147180369123816490e-01;
constexpr double kLn2Lo = 1.90821492927058770002e-10;
constexpr double kLog2e = 1.44269504088896338700e+00;
constexpr double kOverflow = 7.09782712893383973096e+02;
constexpr double kUnderflow = -7.45133219101941108420e+02;
constexpr double kNearZero = 1.0 / (1 << 28);
constexpr double kP1 = 1.66666666666666657415e-01;
constexpr double kP2 = -2.77777777770155933842e-03;
constexpr double kP3 = 6.61375632143793436117e-05;
constexpr double kP4 = -1.65339022054652515390e-06;
constexpr double kP5 = 4.13813679705723846039e-08;
// Go math/log.go
constexpr double kL1 = 6.666666666666735130e-01;
constexpr double kL2 = 3.999999999940941908e-01;
constexpr double kL3 = 2.857142874366239149e-01;
constexpr double kL4 = 2.222219843214978396e-01;
constexpr double kL5 = 1.818357216161805012e-01;
constexpr double kL6 = 1.531383769920937332e-01;
constexpr double kL7 = 1.479819860511658591e-01;
constexpr double kSqrt2Over2 = 0.7071067811865476;

__device__ __forceinline__ double plus_inf() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// 2^e for e in [-1022, 1023], from its bits
__device__ __forceinline__ double pow2(int e) {
  return __longlong_as_double(static_cast<long long>(e + 1023) << 52);
}

// Go's Ldexp(y, k) for y in [0.5, 2) and k in [-1075, 1024], rounded once
__device__ __forceinline__ double ldexp_go(double y, int k) {
  const int h = k / 2;
  return __dmul_rn(__dmul_rn(y, pow2(h)), pow2(k - h));
}

__device__ double go_exp(double x) {
  if (isnan(x)) return x;
  if (isinf(x)) return x > 0 ? x : 0.0;
  if (x > kOverflow) return plus_inf();
  if (x < kUnderflow) return 0.0;
  if (-kNearZero < x && x < kNearZero) return __dadd_rn(1.0, x);
  const double kx = __dmul_rn(kLog2e, x);
  const int k = __double2int_rz(x < 0 ? __dsub_rn(kx, 0.5) : __dadd_rn(kx, 0.5));
  const double kd = static_cast<double>(k);
  const double hi = __dsub_rn(x, __dmul_rn(kd, kLn2Hi));
  const double lo = __dmul_rn(kd, kLn2Lo);
  // expmulti(hi, lo, k)
  const double r = __dsub_rn(hi, lo);
  const double t = __dmul_rn(r, r);
  double p = __dadd_rn(kP4, __dmul_rn(t, kP5));
  p = __dadd_rn(kP3, __dmul_rn(t, p));
  p = __dadd_rn(kP2, __dmul_rn(t, p));
  p = __dadd_rn(kP1, __dmul_rn(t, p));
  const double c = __dsub_rn(r, __dmul_rn(t, p));
  const double q = __ddiv_rn(__dmul_rn(r, c), __dsub_rn(2.0, c));
  const double y = __dsub_rn(1.0, __dsub_rn(__dsub_rn(lo, q), hi));
  return ldexp_go(y, k);
}

__device__ double go_log(double x) {
  if (isnan(x) || (isinf(x) && x > 0)) return x;
  if (x < 0) return __longlong_as_double(0x7ff8000000000000LL);
  if (x == 0) return -plus_inf();
  // frexp: x = f1 * 2^ki, f1 in [0.5, 1)
  int ki = 0;
  if (x < 2.2250738585072014e-308) {  // subnormal: scale into the normals
    x = __dmul_rn(x, 18014398509481984.0);  // 2^54
    ki = -54;
  }
  const long long bits = __double_as_longlong(x);
  ki += static_cast<int>((bits >> 52) & 0x7ff) - 1022;
  double f1 = __longlong_as_double((bits & ~(0x7ffLL << 52)) | (1022LL << 52));
  if (f1 < kSqrt2Over2) {
    f1 = __dmul_rn(f1, 2.0);
    --ki;
  }
  const double f = __dsub_rn(f1, 1.0);
  const double k = static_cast<double>(ki);
  const double s = __ddiv_rn(f, __dadd_rn(2.0, f));
  const double s2 = __dmul_rn(s, s);
  const double s4 = __dmul_rn(s2, s2);
  // t1 = s2 * (L1 + s4*(L3 + s4*(L5 + s4*L7))), t2 = s4 * (L2 + s4*(L4 + s4*L6))
  double u = __dadd_rn(kL5, __dmul_rn(s4, kL7));
  u = __dadd_rn(kL3, __dmul_rn(s4, u));
  u = __dadd_rn(kL1, __dmul_rn(s4, u));
  const double t1 = __dmul_rn(s2, u);
  double v = __dadd_rn(kL4, __dmul_rn(s4, kL6));
  v = __dadd_rn(kL2, __dmul_rn(s4, v));
  const double t2 = __dmul_rn(s4, v);
  const double R = __dadd_rn(t1, t2);
  const double hfsq = __dmul_rn(__dmul_rn(0.5, f), f);
  // k*Ln2Hi - ((hfsq - (s*(hfsq+R) + k*Ln2Lo)) - f)
  const double inner = __dadd_rn(__dmul_rn(s, __dadd_rn(hfsq, R)), __dmul_rn(k, kLn2Lo));
  return __dsub_rn(__dmul_rn(k, kLn2Hi), __dsub_rn(__dsub_rn(hfsq, inner), f));
}

// thread: live bin i = blockIdx.x * kThreads + threadIdx.x, slots
// [blockIdx.y * kSlots, + kSlots) below s
__global__ void __launch_bounds__(kThreads)
cws_aka_kernel(const double* __restrict__ esti, const int64_t* __restrict__ ids, long long n,
               const double* __restrict__ c, const double* __restrict__ b,
               const double* __restrict__ exp_r, int s, long long nbins,
               double* __restrict__ aka) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long bin = ids[i];
  const double lf = go_log(esti[i]);
  const int j0 = blockIdx.y * kSlots;
  const int j1 = j0 + kSlots < s ? j0 + kSlots : s;
  for (int j = j0; j < j1; ++j) {
    const long long t = j * nbins + bin;
    const double yka = go_exp(__dsub_rn(lf, b[t]));
    aka[j * n + i] = __ddiv_rn(c[t], __dmul_rn(yka, exp_r[t]));
  }
}

}  // namespace

// esti [n] f64 (each live bin's frequency estimate), ids [n] int64 (the live
// bin ids, each in [0, nbins)), c, b and exp_r [s, nbins] f64 (a stripe of
// the CWS tables), aka [s, n] f64, all contiguous on the current device.
// aka[j][i] = c[j][ids[i]] / (Exp(Log(esti[i]) - b[j][ids[i]]) *
// exp_r[j][ids[i]]), Go's Exp and Log. Launched on `stream`; returns the
// launch's error (0 with nothing to launch).
extern "C" int hulk_cws_aka(const void* esti, const void* ids, long long n, const void* c,
                            const void* b, const void* exp_r, int s, long long nbins,
                            void* aka, void* stream) {
  if (n <= 0 || s <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>((s + kSlots - 1) / kSlots));
  cws_aka_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(esti), static_cast<const int64_t*>(ids), n,
      static_cast<const double*>(c), static_cast<const double*>(b),
      static_cast<const double*>(exp_r), s, nbins, static_cast<double*>(aka));
  return static_cast<int>(cudaGetLastError());
}
