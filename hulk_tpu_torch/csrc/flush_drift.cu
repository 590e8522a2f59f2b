// The histosketch flush with concept drift, for Hopper (sm_90a): the CMS
// scan with decay, and each sketch slot's order-dependent selection.
//
// Replaces the drift branch of hulk_tpu/parallel/mesh.py:sharded_flush_step
// (:271-296), a lax.scan over every bin whose body, for a live bin (count
// f != 0), decays all depth x width CMS counters by dw, squashes a result
// below the smallest normal f64 to +0, adds f to the bin's counter in each
// row, takes the minimum of those depth counters as the bin's estimate,
// and then, in each slot, replaces the slot's bin and weight where the
// bin's Aka is below weight / dw. A bin with f = 0 changes nothing. hulk_tpu
// left the scan to XLA; it has no Pallas kernel. The plain PyTorch versions
// are cms_drift_scan_torch and drift_select_torch
// (hulk_tpu_torch/ops/flush_drift.py); Aka between the two entries is
// plain PyTorch, elementwise.
//
// The scan splits into two parts, each exact:
//   hulk_cms_drift_scan: every counter evolves on its own. At each live bin
//     it is multiplied by dw (rounded once, __dmul_rn; the library is built
//     with --fmad=false) and, if the bin hashes to it in its row, increased
//     by f (__dadd_rn). One thread a counter walks the live bins in order;
//     the one thread whose counter a bin hits in a row writes that row's
//     post-update value, and the wrapper takes the minimum over rows. The
//     reference squashes a decayed counter below the smallest normal f64 to
//     +0 at every step; here the squash waits for the end, and the output is
//     the same bits: a counter below the smallest normal only decays further
//     (staying below it) until a bin hits it, and then adds a count f >= 1,
//     beside which it rounds away (f + x = f for 0 <= x < 2^-1022). So the
//     post-update values, and the last state once squashed, are the JAX
//     scan's and the host flush's (which squashes by flushing subnormals to
//     zero, the same argument). The bound is the dependency chain: live bins
//     x (a multiply and an add: the add of +0 where the bin misses the
//     counter, so that no branch sits on the chain) in each thread, one
//     after another; the operations (about 2 FP64 a counter and bin) take
//     far less at the card's FP64 rate, and the bytes less still. The
//     block's rows of bins and the counts come through shared memory in
//     tiles of 256, the next one loading while this one is stepped, so no
//     load from device memory sits on the chain; a block is one warp.
//     Measured at 194,481 live bins (H100 80GB HBM3, 700 W; chip_smoke.py
//     phase 12): a multiply chain alone takes 4.2 ns a step; this kernel
//     12.7 ns, and 21.7 ns with blocks of two warps; with each thread
//     loading its row bins 16 at a time into registers instead of the
//     tiles, 24.1 ns; with the squash and a branch on the chain too,
//     34.0 ns; with a load on it as well, 57.6 ns.
//   hulk_drift_select: each slot is sequential over bins and independent of
//     every other slot. One warp a slot reads 32 of its Aka at a time
//     (coalesced, the next 128 loaded ahead), finds the first lane below the
//     current threshold by ballot, takes it and goes on from the next lane
//     with the new threshold weight / dw (a correctly rounded divide,
//     computed only when the weight changes: the reference's weights / dw
//     at every bin is that same value). The bound is the Aka read once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr double kTiny = 2.2250738585072014e-308;  // smallest normal f64
constexpr int kScanThreads = 32;  // a warp a block (half the time of two, measured)
constexpr int kSelectWarps = 1;  // one warp a block: the slots spread over SMs
constexpr unsigned kFull = 0xffffffffu;

// the scan's tiles: kTile live bins of the counts and of the (at most two)
// rows of the block's counters, staged in shared memory; each thread stages
// kRowLoads row bins and kCountLoads counts of the next tile
constexpr int kTile = 256;
constexpr int kRowLoads = 2 * kTile / kScanThreads;
constexpr int kCountLoads = kTile / kScanThreads;

// counter t = d * width + j of cms_in, decayed at each of the n live bins
// and increased where row_bins[d][i] == j, squashed below the smallest
// normal at the end; est_rows[d][i] = the counter of row d that bin i hits,
// after bin i's step. A step is c = c * dw + f, where f is the bin's count
// if the bin hits the counter and +0 otherwise (v + 0 = v for v >= 0): no
// branch and no load on the chain. The block's rows and the counts come in
// tiles through shared memory, the next tile loading into registers while
// this one is stepped.
__global__ void __launch_bounds__(kScanThreads)
cms_drift_scan_kernel(const double* __restrict__ freqs, const int64_t* __restrict__ row_bins,
                      long long n, const double* __restrict__ cms_in,
                      double* __restrict__ cms_out, int depth, int width, double dw,
                      double* __restrict__ est_rows) {
  __shared__ int64_t tile_rows[2][2][kTile];  // [buffer][row - d0][bin]
  __shared__ double tile_counts[2][kTile];
  const int t0 = blockIdx.x * kScanThreads;
  const int t = t0 + threadIdx.x;
  const int d0 = t0 / width;
  const bool active = t < depth * width;
  const int d = active ? t / width : d0;
  // an idle thread's j matches no bin (the bins are >= 0, the pad -1)
  const int64_t j = active ? t - static_cast<int64_t>(d) * width : -2;
  double* __restrict__ est = est_rows + static_cast<long long>(d) * n;
  double c = active ? cms_in[t] : 0.0;
  int64_t rows_next[kRowLoads];
  double counts_next[kCountLoads];
  // this thread's share of the tile at `base` (rows past depth and bins past
  // n read as -1, which no counter is, and count 0)
  auto fetch = [&](long long base) {
#pragma unroll
    for (int m = 0; m < kRowLoads; ++m) {
      const int r = m / (kTile / kScanThreads);
      const long long i = base + threadIdx.x + kScanThreads * (m % (kTile / kScanThreads));
      rows_next[m] = d0 + r < depth && i < n
          ? row_bins[static_cast<long long>(d0 + r) * n + i] : -1;
    }
#pragma unroll
    for (int m = 0; m < kCountLoads; ++m) {
      const long long i = base + threadIdx.x + kScanThreads * m;
      counts_next[m] = i < n ? freqs[i] : 0.0;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int m = 0; m < kRowLoads; ++m) {
      tile_rows[buf][m / (kTile / kScanThreads)]
               [threadIdx.x + kScanThreads * (m % (kTile / kScanThreads))] = rows_next[m];
    }
#pragma unroll
    for (int m = 0; m < kCountLoads; ++m) {
      tile_counts[buf][threadIdx.x + kScanThreads * m] = counts_next[m];
    }
  };
  fetch(0);
  stage(0);
  __syncthreads();
  int buf = 0;
  for (long long base = 0; base < n; base += kTile, buf ^= 1) {
    if (base + kTile < n) fetch(base + kTile);
    const int steps = n - base < kTile ? static_cast<int>(n - base) : kTile;
    const int64_t* __restrict__ rows = tile_rows[buf][d - d0];
    const double* __restrict__ counts = tile_counts[buf];
#pragma unroll 16
    for (int k = 0; k < steps; ++k) {
      const bool hit = rows[k] == j;
      const double v = __dadd_rn(__dmul_rn(c, dw), hit ? counts[k] : 0.0);
      if (hit) est[base + k] = v;
      c = v;
    }
    if (base + kTile < n) stage(buf ^ 1);
    __syncthreads();
  }
  if (active) cms_out[t] = c >= kTiny ? c : 0.0;
}

// one warp a slot: the slot's n Aka in bin order, the replace-if-below-
// weight/dw scan; pick is the index of the last bin taken (-1: none)
__global__ void __launch_bounds__(32 * kSelectWarps)
drift_select_kernel(const double* __restrict__ aka, const int64_t* __restrict__ bins,
                    long long n, int s, double dw, const int64_t* __restrict__ sketch_in,
                    const double* __restrict__ weights_in, int64_t* __restrict__ sketch_out,
                    double* __restrict__ weights_out) {
  const int slot = blockIdx.x * kSelectWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (slot >= s) return;
  const double* __restrict__ row = aka + static_cast<long long>(slot) * n;
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  double w = weights_in[slot];
  double cur = __ddiv_rn(w, dw);
  long long pick = -1;
  auto load = [&](long long i) { return i < n ? row[i] : inf; };
  // 4 chunks of 32 in flight: the next 128 Aka load while these are scanned
  double a[4], next[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) a[u] = load(32 * u + lane);
  for (long long base = 0; base < n; base += 128) {
#pragma unroll
    for (int u = 0; u < 4; ++u) next[u] = load(base + 128 + 32 * u + lane);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      // inf is never below cur (at most +inf), so lanes past n never win
      unsigned m = __ballot_sync(kFull, a[u] < cur);
      while (m) {
        const int l = __ffs(m) - 1;
        w = __shfl_sync(kFull, a[u], l);
        cur = __ddiv_rn(w, dw);
        pick = base + 32 * u + l;
        m = __ballot_sync(kFull, lane > l && a[u] < cur);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] = next[u];
  }
  if (lane == 0) {
    weights_out[slot] = w;
    sketch_out[slot] = pick >= 0 ? bins[pick] : sketch_in[slot];
  }
}

}  // namespace

// freqs [n] f64 (the live bins' counts, in bin order), row_bins [depth, n]
// int64 (each in [0, width)), cms_in and cms_out [depth, width] f64,
// est_rows [depth, n] f64, all contiguous on the current device; n >= 0,
// width >= 32, freqs integers >= 1 and cms_in 0 or normal.
// cms_out = cms_in after the n steps; est_rows[d][i] = bin i's counter in
// row d after its step. Launched on `stream`; returns the launch's error.
extern "C" int hulk_cms_drift_scan(const void* freqs, const void* row_bins, long long n,
                                   const void* cms_in, void* cms_out, int depth, int width,
                                   double dw, void* est_rows, void* stream) {
  const int counters = depth * width;
  if (counters <= 0) return 0;
  // a block's counters lie in at most two rows
  if (width < kScanThreads) return static_cast<int>(cudaErrorInvalidValue);
  cms_drift_scan_kernel<<<(counters + kScanThreads - 1) / kScanThreads, kScanThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(freqs), static_cast<const int64_t*>(row_bins), n,
      static_cast<const double*>(cms_in), static_cast<double*>(cms_out), depth, width, dw,
      static_cast<double*>(est_rows));
  return static_cast<int>(cudaGetLastError());
}

// aka [s, n] f64 (each slot's Aka of the n live bins, in bin order), bins
// [n] int64 (the live bin ids), sketch_in/sketch_out [s] int64,
// weights_in/weights_out [s] f64, all contiguous on the current device.
// For each slot, in bin order: where aka < weight / dw, the slot takes the
// bin and weight = aka. Launched on `stream`; returns the launch's error.
extern "C" int hulk_drift_select(const void* aka, const void* bins, long long n, int s,
                                 double dw, const void* sketch_in, const void* weights_in,
                                 void* sketch_out, void* weights_out, void* stream) {
  if (s <= 0) return 0;
  drift_select_kernel<<<(s + kSelectWarps - 1) / kSelectWarps, 32 * kSelectWarps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(aka), static_cast<const int64_t*>(bins), n, s, dw,
      static_cast<const int64_t*>(sketch_in), static_cast<const double*>(weights_in),
      static_cast<int64_t*>(sketch_out), static_cast<double*>(weights_out));
  return static_cast<int>(cudaGetLastError());
}
