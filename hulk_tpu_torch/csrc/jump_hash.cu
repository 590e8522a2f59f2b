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
// while j < n, exactly. With d = (key>>33)+1 <= 2^31 and x = (b+1) 2^31 / d,
// Go computes p = RN((b+1) RN(2^31/d)) and j = trunc(p); for p >= 0 and an
// integer n, trunc(p) < n exactly when p < n. The TPU kernel emulated the
// two roundings in u32 integer math because the TPU's f64 divide is not
// correctly rounded. The plain PyTorch versions are jump_hash_torch
// (hulk_tpu_torch/hashes/jumphash.py), bin_scatter_keys_torch and
// bin_scatter_values_torch (hulk_tpu_torch/ops/device_step.py).
//
// The loop (jump_step, shared by every entry) finds floor(p) without Go's
// correctly rounded divide on most iterations:
//   * d and j (= b, so that b + 1 = j + 1) as doubles (I2F, exact below
//     2^32), and s = d 2^-31 (exact);
//   * r0 = rcp.approx.ftz.f64(s), the reciprocal seed (MUFU.RCP64H), with
//     relative error e0: r0 = (1 + e0) / s;
//   * e = RN(1 - s r0) and t = RN(e + e e) (two FMAs), y0 = RN(j r0 + r0) =
//     RN((b+1) r0) and Y = RN(y0 + y0 t) (FMAs): since (1 + e0)(1 - e0 +
//     e0^2) = 1 + e0^3, Y = x (1 + g) with |g| <= |e0|^3 + 2.02 |e0| u + 2u
//     + u^2, where u = 2^-53 is the unit roundoff;
//   * Go's p = x (1 + h) with |h| <= 2u + u^2, so
//     |Y - p| <= x (|e0|^3 + 4u + 2.02 |e0| u + 2u^2).
// Proof of exactness. Assume |e0| <= 2^-16 for every d in [1, 2^31];
// chip_smoke.py phase 2 checks it over all 2^31 of them
// (hulk_jump_seed_error: the largest |1 - s r0| is 2^-19.94 on the H100).
// Then |Y - p| <= x 2^-47.6. Let z = RZ(Y + 2^38): for 0 <= Y < 2^38 its
// mantissa is floor(Y 2^14) = F 2^14 + c, F = floor(Y), 0 <= c < 2^14.
//   * The loop goes on while z < 2^38 + n, that is F < n; then F < 2^31
//     and F sits in mantissa bits 14..44 (a funnel shift reads it).
//   * If Y >= 2^31 (so z >= 2^38 + 2^31 > 2^38 + n, also for Y >= 2^38),
//     p >= Y (1 - 2^-47) > n: Go's loop ends too.
//   * Otherwise x < 2^31 (1 + 2^-46) and |Y - p| < 2^-16.5. If 1 <= c <=
//     2^14 - 2, Y lies in [F + 2^-14, F + 1 - 2^-14), so p lies in
//     (F, F + 1): floor(p) = F, and p < n iff F < n, exactly.
//   * If c is 0 or 2^14 - 1 (Y within 2^-14 of an integer, about one
//     iteration in 2^13; or, harmlessly, any Y >= 2^38 whose low bits read
//     so), the lane takes Go's own roundings: p = RN((b+1) RN(1/s)),
//     RN(1/s) = RN(2^31/d) being the correctly rounded reciprocal
//     __drcp_rn, and z = RZ(p + 2^38), read as above.
// The multiplies, adds and FMAs round as written (__dmul_rn, __dadd_rz,
// __fma_rn; the library is built with --fmad=false, so nothing else is
// fused), and the bucket is j, an integer the lane carries.
//
// What binds: the issue of instructions. The loop's first form took
// __drcp_rn on every iteration; its SASS hot path (scripts/jump_sass.py)
// is 33 instructions, 11 of them FP64, and a warp issues them for as many
// iterations as its longest lane needs: at the fused step's batch that
// accounts for its measured time above the launch, at one instruction a
// cycle a scheduler. This loop's hot path is 26 instructions: 7 FP64
// operations, 2 conversions to FP64, the seed and 16 others, with the exit
// test on z and the exact step out of the way.
//
// Design: one key a thread, a block of 256 threads for each 256 keys (a
// grid-stride loop guards past the grid's limit): a thread runs its key's
// loop to the end. The first form capped the grid at 16 blocks a SM and
// refilled a lane inside the loop as soon as its key ended; the refill
// costs a test and a branch every iteration, and on the H100 it measured
// slower at every entry's shape, as did caps of 4 and 16 blocks a SM at
// entry()'s 2,621,440 keys (PERF.md).
//   hulk_jump_hash writes every key's bucket (the function of
//     jump_hash_pallas);
//   hulk_bin_scatter_keys reads sorted (read_id << vbits | value) keys,
//     skips a key equal to the one before it without entering the loop,
//     hashes the value bits and atomically adds 1 to the int32 histogram
//     (integer atomics commute: the histogram is exact);
//   hulk_bin_scatter_values does the same for sorted u64 values, hashing all
//     64 bits (no read id above them; values reach bit 63 from k = 28). For
//     the two-sort step's values (k >= 23) equal neighbours come from
//     different reads and each one counts. With dedup (one long record's
//     sorted run heads, hulk_tpu_torch/ops/longread.py) it also skips a
//     value equal to the one before it. Given a count, it adds the number
//     of values it binned to that int64 counter on the card (a warp sum, a
//     block sum, one atomic a block), so neither the two-sort step nor a
//     long record needs a host read of its live count.
// The sorted entries take the whole buffer: the all-ones sentinel sorts
// last, so a thread stops at its first sentinel and a block whose first
// key is the sentinel returns at once.
//
// Bound: 8 bytes read per key (plus 4 written per key, or the histogram read
// and written once), and ~ln(n) + 1 iterations of one f64 divide and one
// f64 multiply per live key; chip_smoke.py computes that bound, from the
// iterations these keys need, beside the measured time. Each warp waits on
// its longest loop, and at the values entry's shapes (some 40,000 values)
// a launch's own latency binds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
constexpr u64 kSentinel = ~0ULL;
constexpr int kThreads = 256;
constexpr double kTwo31 = 2147483648.0;
constexpr double kTwo38 = 274877906944.0;
// fraction bits that z = RZ(Y + 2^38) keeps
constexpr unsigned kFracBits = 14;
constexpr unsigned kFracMask = (1u << kFracBits) - 1u;

// the reciprocal seed, MUFU.RCP64H
__device__ __forceinline__ double rcp_seed(double d) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(d));
  return r;
}

// One iteration of Go's loop for divisor d and b = j, both as doubles:
// z = RZ(p + 2^38) for Go's p = RN((b+1) RN(2^31/d)), as far as its floor
// and its test against n go (proof at the top of the file). `exact` counts
// the iterations that took Go's own roundings.
__device__ __forceinline__ double jump_step(double d, double j, unsigned& exact) {
  const double s = __dmul_rn(d, 1.0 / kTwo31);
  const double r0 = rcp_seed(s);
  const double e = __fma_rn(-s, r0, 1.0);
  const double t = __fma_rn(e, e, e);
  const double y0 = __fma_rn(j, r0, r0);
  double z = __dadd_rz(__fma_rn(y0, t, y0), kTwo38);
  if (((static_cast<unsigned>(__double2loint(z)) + 1u) & kFracMask) <= 1u) {
    z = __dadd_rz(__dmul_rn(__dadd_rn(j, 1.0), __drcp_rn(s)), kTwo38);
    ++exact;
  }
  return z;
}

// what a launch does with its keys
enum Mode { kBuckets, kDedupKeys, kValues, kDedupValues };

// count += the block's sum of `mine`: a warp sum, then one atomic a block.
// Every thread of the block calls it.
__device__ __forceinline__ void add_block_count(unsigned long long* count, unsigned mine) {
  __shared__ unsigned warp_sum[kThreads / 32];
  const unsigned s = __reduce_add_sync(0xFFFFFFFFu, mine);
  __syncthreads();  // a previous call's reads of warp_sum are done
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
    if (total) atomicAdd(count, total);
  }
}

// kCount: the counting form of the loop (hulk_jump_hash_steps), which adds
// the iterations and the exact steps to count[0] and count[1] and writes
// no bucket; never on a path, so the timed kernels carry no counter.
template <Mode kMode, bool kCount = false>
__global__ void __launch_bounds__(kThreads)
jump_kernel(const u64* __restrict__ keys, long long N, int n, u64 vmask,
            int32_t* __restrict__ out, unsigned long long* __restrict__ count) {
  constexpr bool kSorted = kMode != kBuckets;
  constexpr bool kDedup = kMode == kDedupKeys || kMode == kDedupValues;
  const long long first = blockIdx.x * static_cast<long long>(kThreads);
  // sorted keys: the sentinel comes last, so a block that starts on it has
  // no live key (every key it would take later lies further on)
  if (kSorted && keys[first] == kSentinel) return;
  const double zn = kTwo38 + static_cast<double>(n);  // z < zn iff floor(p) < n
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  unsigned binned = 0, exact = 0, iterations = 0;
  for (long long i = first + threadIdx.x; i < N; i += stride) {
    u64 key = keys[i];
    if (kSorted && key == kSentinel) break;  // and every key after it
    if (kDedup && i > 0 && keys[i - 1] == key) continue;
    if (kMode == kDedupKeys) key &= vmask;
    unsigned j = 0;  // Go's j, the next b
    for (;;) {
      key = key * 2862933555777941757ULL + 1ULL;
      const double z = jump_step(__uint2double_rn(static_cast<unsigned>(key >> 33) + 1u),
                                 __uint2double_rn(j), exact);
      if (kCount) ++iterations;
      if (!(z < zn)) break;
      j = __funnelshift_r(static_cast<unsigned>(__double2loint(z)),
                          static_cast<unsigned>(__double2hiint(z)), kFracBits);
    }
    if (kMode == kBuckets) {
      if (!kCount) out[i] = static_cast<int32_t>(j);
    } else {
      atomicAdd(out + j, 1);
      ++binned;
    }
  }
  if (kCount) {
    add_block_count(count, iterations);
    add_block_count(count + 1, exact);
  } else if ((kMode == kValues || kMode == kDedupValues) && count != nullptr) {
    add_block_count(count, binned);
  }
}

// the largest |RN(1 - s r0)| over every s = d 2^-31, d in [1, 2^31], as the
// bits of a positive double (which order as integers): the seed bound the
// loop's proof assumes
__global__ void __launch_bounds__(kThreads) seed_error_kernel(unsigned long long* maxbits) {
  u64 mine = 0;
  const u64 total = 1ULL << 31;
  for (u64 i = blockIdx.x * static_cast<u64>(kThreads) + threadIdx.x; i < total;
       i += static_cast<u64>(gridDim.x) * kThreads) {
    const double s = __dmul_rn(__uint2double_rn(static_cast<unsigned>(i + 1)), 1.0 / kTwo31);
    const u64 bits = static_cast<u64>(__double_as_longlong(fabs(__fma_rn(-s, rcp_seed(s), 1.0))));
    mine = bits > mine ? bits : mine;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const u64 other = __shfl_down_sync(0xFFFFFFFFu, mine, o);
    mine = other > mine ? other : mine;
  }
  if ((threadIdx.x & 31) == 0) atomicMax(maxbits, mine);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

// blocks for N keys: one a 256 keys (one key a thread), within the grid's
// limit
int grid_for(long long N) {
  const long long need = (N + kThreads - 1) / kThreads;
  return static_cast<int>(need < 0x7FFFFFFFLL ? need : 0x7FFFFFFFLL);
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

// The counting form of hulk_jump_hash: keys [N] u64 contiguous on the
// current device, 1 <= n < 2^31; steps: a u64 [2] on the same device that
// gains the loop's iterations and, of those, the ones that took the exact
// step. Writes no bucket. Launched on `stream`; returns the launch's error.
extern "C" int hulk_jump_hash_steps(const void* keys, long long N, long long n,
                                    void* steps, void* stream) {
  if (N <= 0) return 0;
  jump_kernel<kBuckets, true><<<grid_for(N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(keys), N, static_cast<int>(n), ~0ULL, nullptr,
      static_cast<unsigned long long*>(steps));
  return static_cast<int>(cudaGetLastError());
}

// maxbits: a u64 [] on the current device, set to 0 by the caller; gains
// the bits of the largest |1 - s r0| of the loop's reciprocal seed over all
// 2^31 divisors. Launched on `stream`; returns the launch's error.
extern "C" int hulk_jump_seed_error(void* maxbits, void* stream) {
  seed_error_kernel<<<sm_count() * 16, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(maxbits));
  return static_cast<int>(cudaGetLastError());
}
