// Go jump hash (dgryski/go-jump) for Hopper (sm_90a), alone and fused into
// the device step's binning.
//
// Replaces hulk_tpu/ops/jump_pallas.py:jump_hash_pallas (bodies _jump_kernel
// and _jump_block_body; padding wrapper jump_hash_tpu) and, fused with it,
// the binning around it in hulk_tpu/ops/device_step.py:bin_scatter_keys
// (dedup mask, value mask, scatter-add) and :bin_scatter_slice (sentinel
// mask, scatter-add). Go's loop
//   b = j; key = key * 2862933555777941757 + 1;
//   j = int64(float64(b+1) * (float64(1<<31) / float64((key>>33)+1)))
// while j < n, exactly, in IEEE f64 with fewer and cheaper operations:
//   * d = (key>>33)+1 <= 2^31 is built from its bits: the double 2^52 + d
//     (exponent 0x433, mantissa d) minus 2^52, with no conversion;
//   * RN(2^31/d) = 2^31 RN(1/d), a power-of-two scale, so the divide is the
//     correctly rounded reciprocal __drcp_rn times 2^31;
//   * for p = RN((b+1) q) >= 0 and integer n, trunc(p) < n exactly when
//     p < n, so the exit test reads p, and a lane that goes on takes
//     trunc(p) + 1 as RZ(p + 2^52) - (2^52 - 1) (p < n < 2^31), again with
//     no conversion; the bucket is converted once, at the end.
// The multiply rounds once to nearest (__dmul_rn; the library is built with
// --fmad=false). The TPU kernel emulated the two roundings in u32 integer
// math because the TPU's f64 divide is not correctly rounded; the card's
// reciprocal is. The plain PyTorch versions are jump_hash_torch
// (hulk_tpu_torch/hashes/jumphash.py), bin_scatter_keys_torch and
// bin_scatter_values_torch (hulk_tpu_torch/ops/device_step.py).
//
// Design: a grid-stride loop over the keys with at most 16 blocks of 256
// threads a SM. Each thread runs ONE loop over iterations: when its key's
// loop ends it takes its next key at once, so a batch larger than the grid
// keeps its warps full until the tail. At the production batch the cap
// gives one key a thread: on the H100, grids of 2 to 8 blocks a SM (each
// thread walking several keys, with or without loading its next key ahead)
// measured slower than this.
//   hulk_jump_hash writes every key's bucket (the function of
//     jump_hash_pallas);
//   hulk_bin_scatter_keys reads sorted (read_id << vbits | value) keys,
//     skips the sentinel and a key equal to the one before it without
//     entering the loop, hashes the value bits and atomically adds 1 to the
//     int32 histogram (integer atomics commute: the histogram is exact);
//   hulk_bin_scatter_values does the same for sorted u64 values, hashing all
//     64 bits (no read id above them; values reach bit 63 from k = 28). For
//     the two-sort step's values (k >= 23) equal neighbours come from
//     different reads and each one counts, so it skips only the sentinel.
//     With dedup (one long record's sorted run heads,
//     hulk_tpu_torch/ops/longread.py) it also skips a value equal to the one
//     before it, and, given a count, adds the number of values it binned to
//     that int64 counter on the card (a warp sum, a block sum, one atomic a
//     block), so the record's minimizer count needs no host read.
//
// Bound: 8 bytes read per key (plus 4 written per key, or the histogram read
// and written once), and ~ln(n) + 1 iterations of one f64 reciprocal-divide
// and one f64 multiply per live key. At the production batch (491,520 keys,
// n = 194,481) the bytes bound it; chip_smoke.py computes that bound, from
// the iterations these keys need, beside the measured time. At the values
// entry's shapes (some 40,000 values) both bounds are below a launch's own
// latency: each warp waits on its longest loop, and the launch on its
// slowest warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
constexpr u64 kSentinel = ~0ULL;
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 16;
constexpr double kTwo31 = 2147483648.0;
constexpr double kTwo52 = 4503599627370496.0;

// RN(2^31 / d) for an integer 1 <= d <= 2^31: d as a double from its bits
// (2^52 + d minus 2^52), its correctly rounded reciprocal, times 2^31
__device__ __forceinline__ double scaled_reciprocal(unsigned d) {
  const double df = __dsub_rn(__hiloint2double(0x43300000, static_cast<int>(d)), kTwo52);
  return __dmul_rn(__drcp_rn(df), kTwo31);
}

// what a launch does with its keys
enum Mode { kBuckets, kDedupKeys, kValues, kDedupValues };

// count += the block's sum of `mine`: a warp sum, then one atomic a block.
// Every thread of the block calls it.
__device__ __forceinline__ void add_block_count(unsigned long long* count, unsigned mine) {
  __shared__ unsigned warp_sum[kThreads / 32];
  const unsigned s = __reduce_add_sync(0xFFFFFFFFu, mine);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int j = 0; j < kThreads / 32; ++j) total += warp_sum[j];
    if (total) atomicAdd(count, total);
  }
}

template <Mode kMode>
__global__ void __launch_bounds__(kThreads)
jump_kernel(const u64* __restrict__ keys, long long N, int n, u64 vmask,
            int32_t* __restrict__ out, unsigned long long* __restrict__ count) {
  constexpr bool kDedup = kMode == kDedupKeys || kMode == kDedupValues;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long next = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const double dn = static_cast<double>(n);
  long long cur = -1;  // index of the key in flight, -1 for none
  u64 key = 0;
  double bp1 = 1.0;    // b + 1 of Go's loop
  unsigned binned = 0;
  for (;;) {
    if (cur < 0) {  // take the next live key
      for (; next < N; next += stride) {
        const u64 kk = keys[next];
        if (kMode != kBuckets && kk == kSentinel) continue;
        if (kDedup && next > 0 && keys[next - 1] == kk) continue;
        key = kMode == kDedupKeys ? (kk & vmask) : kk;
        cur = next;
        break;
      }
      if (cur < 0) break;
      next += stride;
      bp1 = 1.0;
    }
    key = key * 2862933555777941757ULL + 1ULL;
    const double q = scaled_reciprocal(static_cast<unsigned>(key >> 33) + 1u);
    const double p = __dmul_rn(bp1, q);
    if (p < dn) {
      bp1 = __dsub_rn(__dadd_rz(p, kTwo52), kTwo52 - 1.0);
    } else {
      const int b = __double2int_rz(bp1) - 1;
      if (kMode == kBuckets) {
        out[cur] = b;
      } else {
        atomicAdd(out + b, 1);
        ++binned;
      }
      cur = -1;
    }
  }
  if ((kMode == kValues || kMode == kDedupValues) && count != nullptr) {
    add_block_count(count, binned);
  }
}

int grid_for(long long N) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const long long need = (N + kThreads - 1) / kThreads;
  return static_cast<int>(need < sms * kBlocksPerSM ? need : sms * kBlocksPerSM);
}

}  // namespace

// keys [N] u64 and out [N] i32, contiguous on the current device;
// 1 <= n < 2^31 buckets; launched on `stream`. Returns the CUDA error of the
// launch.
extern "C" int hulk_jump_hash(const void* keys, long long N, long long n,
                              void* out, void* stream) {
  if (N <= 0) return 0;
  jump_kernel<kBuckets><<<grid_for(N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(keys), N, static_cast<int>(n), ~0ULL,
      static_cast<int32_t*>(out), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// skeys [N] u64 sorted (read_id << vbits | value, the all-ones sentinel
// last), hist [n] i32, both contiguous on the current device; 1 <= n < 2^31,
// 0 < vbits < 64. hist[jump(value, n)] += 1 for every live key that differs
// from the key before it. Launched on `stream`; returns the launch's error.
extern "C" int hulk_bin_scatter_keys(const void* skeys, long long N, int vbits,
                                     void* hist, long long n, void* stream) {
  if (N <= 0) return 0;
  jump_kernel<kDedupKeys><<<grid_for(N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(skeys), N, static_cast<int>(n),
      (1ULL << vbits) - 1ULL, static_cast<int32_t*>(hist), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// svals [N] u64 sorted (the all-ones sentinel last), hist [n] i32, both
// contiguous on the current device; 1 <= n < 2^31. hist[jump(v, n)] += 1
// for every value v that is not the sentinel, duplicates included, or with
// dedup != 0 only where v differs from the value before it. count: null, or
// an int64 [] on the same device that gains the number of values binned.
// Launched on `stream`; returns the launch's error.
extern "C" int hulk_bin_scatter_values(const void* svals, long long N, void* hist,
                                       long long n, int dedup, void* count, void* stream) {
  if (N <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto v = static_cast<const u64*>(svals);
  const auto h = static_cast<int32_t*>(hist);
  const auto c = static_cast<unsigned long long*>(count);
  if (dedup) {
    jump_kernel<kDedupValues><<<grid_for(N), kThreads, 0, s>>>(v, N, static_cast<int>(n),
                                                               ~0ULL, h, c);
  } else {
    jump_kernel<kValues><<<grid_for(N), kThreads, 0, s>>>(v, N, static_cast<int>(n), ~0ULL,
                                                          h, c);
  }
  return static_cast<int>(cudaGetLastError());
}
