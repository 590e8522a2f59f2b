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
//     by f (__dadd_rn). The reference squashes a decayed counter below the
//     smallest normal f64 to +0 at every step; here the squash waits for the
//     end, with the same bits: a counter below the smallest normal only
//     decays further (staying below it) until a bin hits it, and then adds a
//     count f >= 1, beside which it rounds away (f + x = f for 0 <= x <
//     2^-1022). So the post-update values, and the last state once squashed,
//     are the JAX scan's and the host flush's (which squashes by flushing
//     subnormals to zero, the same argument).
//     A warp holds 32 consecutive counters of one row (ceil(width / 32)
//     warps a row, the last one partial), so a bin hits at most one lane of
//     a warp: at width 2,000 one bin in 62.5. A second warp of the block
//     lists each tile of 512 live bins: each lane tests 16 of the row's bins,
//     a ballot and a popcount place the hits in a list in shared memory, in
//     bin order, the same list for every lane. The stepping warp walks the
//     lists: between two hits every lane runs bare multiplies c = c * dw,
//     the same count in every lane (a loop of 8, the remainder by its bits);
//     at a hit every lane steps c = c * dw + f, f the bin's count in the
//     lane it hits and +0 in the others (v + 0 = v for v >= 0: the bits of a
//     bare multiply), and the lane hit leaves the bin's estimate in the list
//     for the listing warp to write out. The wrapper takes the minimum over
//     rows. So each counter sees the reference's rounded operations in its
//     order; no run of multiplies is replaced by a power of dw, whose
//     roundings differ. The bound is that chain: n dependent multiplies in
//     each lane, and an add at each of its warp's hits (about n / 62.5 at
//     width 2,000). Measured at 194,481 live bins (H100 80GB HBM3, 700 W;
//     scripts/kernel_retime.py): the multiply chain alone 4.1 ns a step, a
//     multiply-add chain 8.2 ns, the parent design (one thread a counter,
//     the multiply-add at every bin) 12.7 ns, this one 6.3 ns (6.4 with
//     tiles of 256): about 0.14 us a hit above the multiply chain. In SASS
//     a hit's walk holds a loop branch every 8 multiplies, the remainder's
//     7 predicated multiplies and a convergence barrier around a loop the
//     compiler cannot prove uniform; computed entries into longer runs of
//     multiplies and loops of 16 or 32 were tried and were no faster.
//   hulk_drift_select: each slot is sequential over bins and independent of
//     every other slot. Two launches: the first takes the minimum of each
//     chunk of `chunk` Aka of each slot's row (a warp a chunk, reading Aka
//     once at the card's bandwidth; fmin, so a NaN, which `<` never takes,
//     never wins); the second gives a warp to each slot, which reads its
//     chunk minima 32 at a time and scans only the chunks whose minimum is
//     below its current threshold weight / dw when it reaches them, in bin
//     order. A skipped chunk holds no Aka below the threshold, and the
//     threshold changes only at a pick, so the skip is exact. A scanned
//     chunk, and each following chunk that qualifies, stream through one
//     pipeline of loads (8 groups of 32 Aka, the next 8 loading); in each
//     group a ballot finds the first lane below the threshold, which is
//     taken, and the scan goes on from the next lane with the new threshold
//     (a correctly rounded divide, computed only when the weight changes:
//     the reference's weights / dw at every bin is that same value). After
//     a pick at v the next needs an Aka below v / dw, so on the flush's Aka
//     a slot scans a few chunks; Aka strictly decreasing makes every bin a
//     pick and every chunk scanned, one stream as in the parent design. The
//     bound is the Aka read once.
//   Loads are clamped into their arrays, and the lanes past the end left out
//   where the values are used: a select of a loaded value holds the warp
//   until the load arrives, which cost a memory latency a tile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr double kTiny = 2.2250738585072014e-308;  // smallest normal f64
constexpr unsigned kAllLanes = 0xffffffffu;

// the scan: two warps a block, kTile live bins a tile, kPer a lane
constexpr int kTile = 512;
constexpr int kPer = kTile / 32;
constexpr int kUnroll = 8;  // bare multiplies a loop step between hits
constexpr int kBufs = 2;    // tiles listed ahead of the stepper
// the selection: pass 1 has 8 warps a block and kDepth loads a lane in
// flight; pass 2 keeps the next kDepth groups of 32 Aka loading
constexpr int kMinThreads = 256;
constexpr int kDepth = 8;

__device__ __forceinline__ double plus_inf() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// c multiplied by dw k times, each product rounded once; k is the same in
// every lane of the warp. A loop of 8 (not unrolled further, so that the
// code stays small), then 4, 2 and 1 by the bits of the remainder.
__device__ __forceinline__ double decay(double c, double dw, long long k) {
#pragma unroll 1
  for (; k >= kUnroll; k -= kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) c = __dmul_rn(c, dw);
  }
  if (k & 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) c = __dmul_rn(c, dw);
  }
  if (k & 2) {
    c = __dmul_rn(c, dw);
    c = __dmul_rn(c, dw);
  }
  if (k & 1) c = __dmul_rn(c, dw);
  return c;
}

// named barriers of the scan's two warps (0 is __syncthreads'): kBarFull + k
// when buffer k holds a tile's hits, kBarEmpty + k when they have been
// stepped. A barrier orders the shared-memory accesses before it against
// those after it in the other warp.
constexpr int kBarFull = 1;
constexpr int kBarEmpty = kBarFull + kBufs;

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}

// counter (d, j0 + lane) of cms_in, decayed at each of the n live bins and
// increased where row_bins[d][i] == j0 + lane, squashed below the smallest
// normal at the end; est_rows[d][i] = the counter of row d that bin i hits,
// after bin i's step. Block b holds row d = b / ceil(width / 32), counters
// j0 = 32 * (b mod ceil(width / 32)) on; lanes past width hold 0 and are
// never hit (every row bin is below width). Two warps: the second lists
// each tile's hits, in bin order, in a buffer in shared memory (the bin's
// place in the tile, the lane it hits, its count) and writes the estimates
// the first left there; the first walks the lists, the next entry loading
// while this one's multiplies run, so that its chain never waits on the
// listing. kBufs buffers, each passed on by a named barrier.
__global__ void __launch_bounds__(64)
cms_drift_scan_kernel(const double* __restrict__ freqs, const int64_t* __restrict__ row_bins,
                      long long n, const double* __restrict__ cms_in,
                      double* __restrict__ cms_out, int width, double dw,
                      double* __restrict__ est_rows) {
  __shared__ int hit_at[kBufs][kTile + 1];
  __shared__ int hit_lane[kBufs][kTile + 1];
  __shared__ double hit_count[kBufs][kTile + 1];
  __shared__ double hit_est[kBufs][kTile];
  __shared__ int hit_total[kBufs];
  const int warps_a_row = (width + 31) / 32;
  const int d = blockIdx.x / warps_a_row;
  const int j0 = (blockIdx.x - d * warps_a_row) * 32;
  const int lane = threadIdx.x & 31;
  const long long tiles = (n + kTile - 1) / kTile;
  if (threadIdx.x >= 32) {
    // the lister: tile t into buffer t mod kBufs, after writing out the
    // estimates of tile t - kBufs from it
    const int64_t* __restrict__ rows = row_bins + static_cast<long long>(d) * n;
    double* __restrict__ est = est_rows + static_cast<long long>(d) * n;
    const unsigned below = (1u << lane) - 1;  // the lanes before this one
    auto write_estimates = [&](long long t) {
      const int k = static_cast<int>(t % kBufs);
      bar_sync(kBarEmpty + k);
      for (int e = lane; e < hit_total[k]; e += 32) {
        est[t * kTile + hit_at[k][e]] = hit_est[k][e];
      }
      __syncwarp();
    };
    // lane's bins base + 32 m + lane of a tile; past n the last bin's, which
    // the ballot leaves out (a load whose value a select replaced would hold
    // the warp until it arrived)
    int64_t rb[kPer], rb_next[kPer];
    double f[kPer], f_next[kPer];
    auto fetch = [&](long long base, int64_t* r, double* fc) {
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const long long i = base + 32 * m + lane < n ? base + 32 * m + lane : n - 1;
        r[m] = rows[i];
        fc[m] = freqs[i];
      }
    };
    if (n > 0) fetch(0, rb, f);
    for (long long t = 0; t < tiles; ++t) {
      const long long base = t * kTile;
      const int k = static_cast<int>(t % kBufs);
      fetch(base + kTile, rb_next, f_next);
      if (t >= kBufs) write_estimates(t - kBufs);
      // a ballot a group of 32 bins, a place in the list by the hits before
      // this lane's
      int hits = 0;
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int64_t r = rb[m] - j0;
        const bool hit = r >= 0 && r < 32 && base + 32 * m + lane < n;
        const unsigned b = __ballot_sync(kAllLanes, hit);
        if (hit) {
          const int e = hits + __popc(b & below);
          hit_at[k][e] = 32 * m + lane;
          hit_lane[k][e] = static_cast<int>(r);
          hit_count[k][e] = f[m];
        }
        hits += __popc(b);
      }
      if (lane == 0) hit_total[k] = hits;
      __syncwarp();
      bar_arrive(kBarFull + k);
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        rb[m] = rb_next[m];
        f[m] = f_next[m];
      }
    }
    for (long long t = tiles > kBufs ? tiles - kBufs : 0; t < tiles; ++t) write_estimates(t);
    return;
  }
  // the stepper
  const bool active = j0 + lane < width;
  const long long ct = static_cast<long long>(d) * width + j0 + lane;
  double c = active ? cms_in[ct] : 0.0;
  long long pending = 0;  // the bins since the last hit, not yet stepped
  for (long long t = 0; t < tiles; ++t) {
    const int k = static_cast<int>(t % kBufs);
    bar_sync(kBarFull + k);
    const int hits = hit_total[k];
    int at = hit_at[k][0], to = hit_lane[k][0], last = -1;
    double fi = hit_count[k][0];
#pragma unroll 1
    for (int e = 0; e < hits; ++e) {
      const int i = at, hit = to;
      const double add = lane == hit ? fi : 0.0;
      at = hit_at[k][e + 1];
      to = hit_lane[k][e + 1];
      fi = hit_count[k][e + 1];
      c = decay(c, dw, pending + (i - last - 1));
      pending = 0;
      c = __dadd_rn(__dmul_rn(c, dw), add);
      if (lane == hit) hit_est[k][e] = c;
      last = i;
    }
    pending += (n - t * kTile < kTile ? n - t * kTile : kTile) - last - 1;
    __syncwarp();
    bar_arrive(kBarEmpty + k);
  }
  c = decay(c, dw, pending);
  if (active) cms_out[ct] = c >= kTiny ? c : 0.0;
}

// pass 1: warp w of the grid takes chunk q = w mod chunks of slot w / chunks,
// Aka [q * chunk, min((q + 1) * chunk, n)) of the slot's row, and writes
// their minimum to chunk_min[w] (fmin: NaN only where every Aka is NaN)
__global__ void __launch_bounds__(kMinThreads)
chunk_min_kernel(const double* __restrict__ aka, long long n, long long chunk,
                 long long chunks, long long warps, double* __restrict__ chunk_min) {
  const long long w = static_cast<long long>(blockIdx.x) * (kMinThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= warps) return;
  const long long slot = w / chunks;
  const double* __restrict__ row = aka + slot * n;
  const long long lo = (w - slot * chunks) * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  double m[kDepth];
#pragma unroll
  for (int u = 0; u < kDepth; ++u) m[u] = plus_inf();
  for (long long i = lo + lane; i < hi; i += 32 * kDepth) {
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const long long k = i + 32 * u;
      if (k < hi) m[u] = fmin(m[u], row[k]);
    }
  }
  double v = m[0];
#pragma unroll
  for (int u = 1; u < kDepth; ++u) v = fmin(v, m[u]);
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmin(v, __shfl_xor_sync(kAllLanes, v, o));
  if (lane == 0) chunk_min[w] = v;
}

// pass 2: one warp a slot (block), the replace-if-below-weight/dw scan over
// the chunks whose minimum is below the threshold; pick is the index of the
// last bin taken (-1: none). chunk is a multiple of 32. A run of chunks,
// each below the threshold when the run reaches it, streams through one
// pipeline of loads, so the worst case (every chunk scanned) reads Aka as
// one pass.
__global__ void __launch_bounds__(32)
drift_select_kernel(const double* __restrict__ aka, const int64_t* __restrict__ bins,
                    long long n, double dw, const int64_t* __restrict__ sketch_in,
                    const double* __restrict__ weights_in, int64_t* __restrict__ sketch_out,
                    double* __restrict__ weights_out, const double* __restrict__ chunk_min,
                    long long chunk, long long chunks) {
  const int slot = blockIdx.x;
  const int lane = threadIdx.x;
  const double* __restrict__ row = aka + static_cast<long long>(slot) * n;
  const double* __restrict__ mins = chunk_min + static_cast<long long>(slot) * chunks;
  double w = weights_in[slot];
  double cur = __ddiv_rn(w, dw);
  long long pick = -1;
  // loads are clamped into the row (past n a lane reads the last Aka, past
  // the last chunk the last minimum), so that no select waits on a load;
  // such lanes are left out where the values are used
  auto load = [&](long long i) { return row[i < n ? i : n - 1]; };
  auto min_at = [&](long long q) { return mins[q < chunks ? q : chunks - 1]; };
  // the first chunk from q on whose minimum is below cur (a NaN minimum
  // never is), 32 minima at a time, the next 32 loading
  auto next_chunk = [&](long long q) {
    if (q >= chunks) return chunks;
    double cm = min_at(q + lane);
    for (; q < chunks; q += 32) {
      const double cm_next = min_at(q + 32 + lane);
      const unsigned m = __ballot_sync(kAllLanes, q + lane < chunks && cm < cur);
      if (m) return q + __ffs(m) - 1;
      cm = cm_next;
    }
    return chunks;
  };
  // a run: from chunk q on, kDepth groups of 32 Aka at a time, the next
  // kDepth loading, on into each next chunk whose minimum is below cur when
  // the run reaches it
  double a[kDepth], next[kDepth];
  for (long long q = next_chunk(0); q < chunks; q = next_chunk(q)) {
    long long pos = q * chunk;  // the first bin of a[0]
    long long end = (q + 1) * chunk < n ? (q + 1) * chunk : n;
    double following = min_at(q + 1);
#pragma unroll
    for (int u = 0; u < kDepth; ++u) a[u] = load(pos + 32 * u + lane);
    bool going = true;
    while (going) {
#pragma unroll
      for (int u = 0; u < kDepth; ++u) next[u] = load(pos + 32 * (kDepth + u) + lane);
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        if (going) {
          const double v = pos + lane < n ? a[u] : plus_inf();  // +inf is never below cur
          unsigned m = __ballot_sync(kAllLanes, v < cur);
          while (m) {
            const int l = __ffs(m) - 1;
            w = __shfl_sync(kAllLanes, v, l);
            cur = __ddiv_rn(w, dw);
            pick = pos + l;
            m = __ballot_sync(kAllLanes, lane > l && v < cur);
          }
          pos += 32;
          if (pos >= end) {  // chunk q done: on into q + 1 only if it qualifies
            ++q;
            going = q < chunks && following < cur;
            end = (q + 1) * chunk < n ? (q + 1) * chunk : n;
            following = min_at(q + 1);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) a[u] = next[u];
    }
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
// freqs integers >= 1 and cms_in 0 or normal.
// cms_out = cms_in after the n steps; est_rows[d][i] = bin i's counter in
// row d after its step. Launched on `stream`; returns the launch's error.
extern "C" int hulk_cms_drift_scan(const void* freqs, const void* row_bins, long long n,
                                   const void* cms_in, void* cms_out, int depth, int width,
                                   double dw, void* est_rows, void* stream) {
  if (depth <= 0 || width <= 0) return 0;
  cms_drift_scan_kernel<<<depth * ((width + 31) / 32), 64, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(freqs), static_cast<const int64_t*>(row_bins), n,
      static_cast<const double*>(cms_in), static_cast<double*>(cms_out), width, dw,
      static_cast<double*>(est_rows));
  return static_cast<int>(cudaGetLastError());
}

// aka [s, n] f64 (each slot's Aka of the n live bins, in bin order), bins
// [n] int64 (the live bin ids), sketch_in/sketch_out [s] int64,
// weights_in/weights_out [s] f64, chunk_min [s, ceil(n / chunk)] f64
// (scratch), all contiguous on the current device; chunk a positive
// multiple of 32.
// For each slot, in bin order: where aka < weight / dw, the slot takes the
// bin and weight = aka. Two launches on `stream`; returns the first error.
extern "C" int hulk_drift_select(const void* aka, const void* bins, long long n, int s,
                                 double dw, const void* sketch_in, const void* weights_in,
                                 void* sketch_out, void* weights_out, void* chunk_min,
                                 long long chunk, void* stream) {
  if (s <= 0) return 0;
  if (chunk <= 0 || chunk % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const long long chunks = (n + chunk - 1) / chunk;
  const long long warps = s * chunks;
  if (warps > 0) {
    const long long blocks = (warps + kMinThreads / 32 - 1) / (kMinThreads / 32);
    chunk_min_kernel<<<static_cast<unsigned>(blocks), kMinThreads, 0, st>>>(
        static_cast<const double*>(aka), n, chunk, chunks, warps,
        static_cast<double*>(chunk_min));
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  drift_select_kernel<<<s, 32, 0, st>>>(
      static_cast<const double*>(aka), static_cast<const int64_t*>(bins), n, dw,
      static_cast<const int64_t*>(sketch_in), static_cast<const double*>(weights_in),
      static_cast<int64_t*>(sketch_out), static_cast<double*>(weights_out),
      static_cast<const double*>(chunk_min), chunk, chunks);
  return static_cast<int>(cudaGetLastError());
}
