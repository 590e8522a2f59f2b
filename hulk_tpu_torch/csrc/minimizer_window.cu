// Minimizer window scan for Hopper (sm_90a).
//
// Replaces hulk_tpu/ops/minimizer_pallas.py:minimizer_window_pallas (body
// _minimizer_kernel). For every position i of every read it computes the
// forward and reverse-complement k-mers ending at i (N shifted in as 4, the
// rc k-mer unmasked with its `>>2` tail from base i-k), the canonical k-mer
// (symmetric k-mers are invalid), x = hash64(canonical)<<8 | uint64(int32
// span) with span = min(i-w+2, k) sign-extended, and the minimum of x over
// the trailing w positions; it reports where the position is valid and
// i >= w-1. The plain PyTorch versions are minimizer_window_torch and
// minimizer_window_packed_torch (hulk_tpu_torch/ops/minimizer.py); they agree
// bit for bit on every output lane, reported or not.
//
// Three entries share one scan:
//   hulk_minimizer_window_packed reads the v2 transfer layout (2-bit codes
//     [R, L/4], position p in bits 2*(p%4) of byte p/4; N bitmask [R, L/8],
//     position p in bit 7-(p%8) of byte p/8), so the device step needs no
//     unpacking pass;
//   hulk_minimizer_window reads u8 codes [R, L] (0-3 bases, >= 4 an N).
//     With cont != 0 it scans the continuation blocks of long reads
//     (hulk_tpu_torch/ops/longread.py): each row overlaps the block before
//     by w+k-1 bases, so the span is k at every position and reporting
//     starts at local position w+k-1 (the `cont` form of
//     hulk_tpu/ops/minimizer.py:minimizer_window, which the Pallas kernel
//     lacks). `cont` is a kernel argument, uniform across the grid.
//   hulk_minimizer_record scans ONE record of u8 codes [L] (the long-read
//     path, hulk_tpu_torch/ops/longread.py) and writes only its run heads:
//     the window minima of the reported positions p whose minimum differs
//     from position p-1's, or where p-1 is not reported. Every distinct
//     reported value is a run head, and a run head is about 2/(w+1) of the
//     positions, so the launch writes a few bytes a position instead of the
//     9 of wmin and report. The heads go compacted into one u64 buffer, in
//     no order (downstream is a set), behind a u64 device counter: each
//     block counts its heads with a ballot and popc prefix and takes its
//     base with one atomicAdd. Each segment stages one more entry (E = P +
//     w) so that position p0-1's window, and with it the head test at p0, is
//     exact. The cont argument scans a chunk of a record past the launch
//     cap, as above. The plain version is record_run_heads_torch
//     (ops/minimizer.py); sorted, the two buffers agree bit for bit.
//
// Design. One block per (group of G reads, segment of P <= 256 positions),
// about 1024 entries a block. (One warp per read, each warp alone between
// __syncwarp calls, measured slower on the H100 at the production shape.)
//  1. Stage: the segment's bases, with the halo of the window (w-1) and of
//     the k-mer (k+1), go to shared memory as two little-endian bit rows:
//     2-bit codes (position p at bits 2p) and N flags spread to the same
//     pitch (bit 2p). Positions before the read are 0 (the reference's left
//     pad), positions past L are 0, and codes under an N are cleared.
//  2. Entries, one thread each, O(1) in k: the k+1 positions a=i-k..i are
//     one 64-bit field of each row (a funnel shift over two words). With G
//     the codes of i-k+1..i in packed order and N the flags of a..i,
//       rc  = (~G & mask) | N          (3^4 = 7 sets the low bit of the next
//                                       slot; the tail term is N's bit 0)
//       fwd = revpairs(G | N >> 4) >> (64 - 2k)   (4 << 2j sets the low bit
//                                       of the slot of the base before it)
//     then canonical, hash64 and span as in the reference.
//  3. Window minima, O(1) in w (van Herk / Gil-Werman): each thread takes a
//     block of w entries and writes its suffix minima and prefix minima; the
//     minimum of entries t..t+w-1 is min(suffix[t], prefix[t+w-1]).
//  4. Output: two positions a thread, 16-byte stores where aligned.
// Shared memory is about 17 (P + w) + 16 (P + w + k)/32 bytes a read
// whatever L is, so L has no cap: long-read blocks of L = 65,536 cut into
// 256 segments of P = 256 and take at most ~18 KB a block (w = 256). Native u64 arithmetic throughout (the TPU
// kernel needed u32 pairs).
//
// Bound: the packed entry reads 3/8 byte of input per position and writes
// 8 + 1 bytes of output; a rolling scan needs some 40 u64 operations per
// position (k-mer update, canonical pick, hash64, span, window minimum). At
// the production shape (R = 16384, L = 160) the operations bound it;
// chip_smoke.py computes the bound beside the measured time. The record
// entry reads 1 byte a position and writes 8 a run head, so the operations
// bound it at every length; a contig of 200 kb is a few microseconds of
// work, about a launch's own latency.
//
// Positions at or past a read's length are never trusted: an entry there is
// invalid before any code is read, and a valid entry reads positions <= i.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
constexpr u64 kU64Max = ~0ULL;
constexpr int kThreads = 256;
constexpr int kMaxSeg = 256;            // positions a segment at most
constexpr int kEntriesPerBlock = 1024;  // entries of a block's reads
static_assert(kMaxSeg <= kThreads, "the record scan takes one position a thread");

__device__ __forceinline__ u64 hash64(u64 key, u64 m) {
  key = (~key + (key << 21)) & m;
  key = key ^ (key >> 24);
  key = ((key + (key << 3)) + (key << 8)) & m;
  key = key ^ (key >> 14);
  key = ((key + (key << 2)) + (key << 4)) & m;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & m;
  return key;
}

// 64 bits of a little-endian bit row, starting at bit o
__device__ __forceinline__ u64 field(const u64* row, int o) {
  const int wi = o >> 6, sh = o & 63;
  const u64 lo = row[wi] >> sh;
  return sh ? lo | (row[wi + 1] << (64 - sh)) : lo;
}

// the 32 2-bit groups of v in reverse order
__device__ __forceinline__ u64 reverse_pairs(u64 v) {
  v = __brevll(v);
  return ((v >> 1) & 0x5555555555555555ULL) | ((v & 0x5555555555555555ULL) << 1);
}

// bit j of x to bit 2j
__device__ __forceinline__ u64 spread32(unsigned x) {
  u64 v = x;
  v = (v | (v << 16)) & 0x0000FFFF0000FFFFULL;
  v = (v | (v << 8)) & 0x00FF00FF00FF00FFULL;
  v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0FULL;
  v = (v | (v << 2)) & 0x3333333333333333ULL;
  return (v | (v << 1)) & 0x5555555555555555ULL;
}

// one byte of the N bitmask (position p%8 in bit 7-p%8) -> 16 bits, bit 2j
__device__ __forceinline__ uint16_t spread_mask_byte(unsigned m) {
  unsigned v = __brev(m) >> 24;
  v = (v | (v << 4)) & 0x0F0Fu;
  v = (v | (v << 2)) & 0x3333u;
  return static_cast<uint16_t>((v | (v << 1)) & 0x5555u);
}

// one 32-position word of the u8 staging, by a whole warp: lane j holds the
// code c of position 32*word + j (0 outside the read); lane 0 writes the
// word of 2-bit codes and the word of N flags
__device__ __forceinline__ void stage_u8_word(unsigned c, u64* cw, u64* nf) {
  const unsigned b0 = __ballot_sync(0xFFFFFFFFu, c < 4 && (c & 1));
  const unsigned b1 = __ballot_sync(0xFFFFFFFFu, c < 4 && (c & 2));
  const unsigned bn = __ballot_sync(0xFFFFFFFFu, c >= 4);
  if ((threadIdx.x & 31) == 0) {
    *cw = spread32(b0) | (spread32(b1) << 1);
    *nf = spread32(bn);
  }
}

// the entry of the position i whose bases a = i-k .. i start at bit o of the
// staged rows: x = hash64(canonical) << 8 | span, or false (x untouched) for
// a symmetric k-mer
__device__ __forceinline__ bool kmer_entry(const u64* cw, const u64* nf, int o, int k,
                                           u64 mask, u64 nlim, long long span, u64& x) {
  const u64 n = field(nf, o) & nlim;
  const u64 c = field(cw, o) & ~(n * 3);
  const u64 gk = (c >> 2) & mask;
  const u64 rc = (~gk & mask) | n;
  const u64 fwd = reverse_pairs(gk | (n >> 4)) >> (64 - 2 * k);
  if (fwd == rc) return false;
  const u64 canon = fwd < rc ? fwd : rc;
  x = (hash64(canon, mask) << 8) | static_cast<u64>(span);
  return true;
}

// van Herk / Gil-Werman over block b of w entries of a row of Ee: suffix
// minima into s, prefix minima into x in place
__device__ __forceinline__ void block_minima(u64* x, u64* s, int b, int w, int Ee) {
  const int e0 = b * w, e1 = min(e0 + w, Ee);
  u64 m = kU64Max;
  for (int e = e1 - 1; e >= e0; --e) {
    m = min(m, x[e]);
    s[e] = m;
  }
  m = kU64Max;
  for (int e = e0; e < e1; ++e) {
    m = min(m, x[e]);
    x[e] = m;
  }
}

// t / d for small t (t * d < 2^32) without a divide: umulhi(t, ceil(2^32/d))
struct FastDiv {
  unsigned d, m;
  __device__ explicit FastDiv(unsigned d_) : d(d_), m(d_ > 1 ? 0xFFFFFFFFu / d_ + 1u : 0u) {}
  __device__ unsigned operator()(unsigned t) const { return d > 1 ? __umulhi(t, m) : t; }
};

struct Tile {
  int G;      // reads a block
  int P;      // positions a segment
  int nseg;   // segments a read
  int E;      // entries a read: P + w - 1
  int nw;     // staged 64-bit words a read, each row
  size_t smem;
};

Tile make_tile(long long R, long long L, int k, int w) {
  Tile t;
  t.nseg = static_cast<int>((L + kMaxSeg - 1) / kMaxSeg);
  t.P = static_cast<int>((L + t.nseg - 1) / t.nseg);
  t.E = t.P + w - 1;
  // words from floor32(p0 - (w-1) - k - 1) to p0 + P - 1, plus one for the
  // funnel shift's second word
  t.nw = (t.P - 1 + (w - 1) + k + 1 + 31) / 32 + 2;
  long long G = kEntriesPerBlock / t.E;
  if (G < 1) G = 1;
  if (G > R) G = R;
  t.G = static_cast<int>(G);
  t.smem = static_cast<size_t>(t.G) * (16 * t.E + 16 * t.nw + t.E);
  return t;
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
minimizer_window_kernel(const uint8_t* __restrict__ codes,
                        const uint8_t* __restrict__ nmask,
                        const int32_t* __restrict__ lengths, long long R,
                        long long L, int k, int w, bool cont, Tile tile,
                        u64* __restrict__ wmin, bool* __restrict__ report) {
  extern __shared__ u64 smem[];
  const int G = tile.G, E = tile.E, nw = tile.nw;
  u64* xs = smem;                 // [G][E] entries, then prefix minima
  u64* suf = xs + G * E;          // [G][E] suffix minima
  u64* cw = suf + G * E;          // [G][nw] 2-bit codes, position p at bit 2p
  u64* nf = cw + G * nw;          // [G][nw] N flags, position p at bit 2p
  uint8_t* valid = reinterpret_cast<uint8_t*>(nf + G * nw);  // [G][E]

  const long long r0 = static_cast<long long>(blockIdx.x / tile.nseg) * G;
  const long long p0 = static_cast<long long>(blockIdx.x % tile.nseg) * tile.P;
  const int Pe = static_cast<int>(min(static_cast<long long>(tile.P), L - p0));
  const int Gact = static_cast<int>(min(static_cast<long long>(G), R - r0));
  if (Pe <= 0) return;
  const int Ee = Pe + w - 1;
  // staging base: a multiple of 32 at or below the first halo base - 1
  const long long sb = ((p0 - (w - 1) - k - 1) >> 5) << 5;

  // 1. stage
  if (kPacked) {
    const long long L4 = L / 4, L8 = L / 8;
    uint8_t* cb = reinterpret_cast<uint8_t*>(cw);
    uint16_t* nb = reinterpret_cast<uint16_t*>(nf);
    const FastDiv by_row(nw * 8);
    for (int t = threadIdx.x; t < G * nw * 8; t += kThreads) {
      const int g = by_row(t), j = t - g * nw * 8;
      const long long b = sb / 4 + j, r = r0 + g;
      cb[t] = (g < Gact && b >= 0 && b < L4) ? codes[r * L4 + b] : 0;
      if (j < nw * 4) {
        const long long m = sb / 8 + j;
        nb[g * nw * 4 + j] = (g < Gact && m >= 0 && m < L8)
                                 ? spread_mask_byte(nmask[r * L8 + m]) : 0;
      }
    }
  } else {
    const int lane = threadIdx.x & 31;
    for (int t = threadIdx.x >> 5; t < G * nw; t += kThreads / 32) {
      const int g = t / nw, wd = t - g * nw;
      const long long p = sb + 32LL * wd + lane;
      stage_u8_word((g < Gact && p >= 0 && p < L) ? codes[(r0 + g) * L + p] : 0u, cw + t,
                    nf + t);
    }
  }
  __syncthreads();

  // 2. entries
  const u64 mask = (1ULL << (2 * k)) - 1ULL;
  const u64 nlim = (1ULL << (2 * k + 1)) - 1ULL;  // N flags of a..i
  const FastDiv by_entry(E);
  for (int t = threadIdx.x; t < Gact * E; t += kThreads) {
    const int g = by_entry(t), e = t - g * E;
    const long long q = p0 - (w - 1) + e;
    u64 x = kU64Max;
    bool ok = false;
    if (e < Ee && q >= k - 1 && q < lengths[r0 + g]) {
      const long long span = cont ? k : min(q - (w - 2), static_cast<long long>(k));
      ok = kmer_entry(cw + g * nw, nf + g * nw, 2 * static_cast<int>(q - k - sb), k, mask,
                      nlim, span, x);
    }
    xs[t] = x;
    valid[t] = ok;
  }
  __syncthreads();

  // 3. suffix and prefix minima over blocks of w entries
  const int nb = (Ee + w - 1) / w;
  const FastDiv by_blocks(nb);
  for (int t = threadIdx.x; t < Gact * nb; t += kThreads) {
    const int g = by_blocks(t);
    block_minima(xs + g * E, suf + g * E, t - g * nb, w, Ee);
  }
  __syncthreads();

  // 4. outputs, two positions a thread: the window of entries t..t+w-1 is
  // min(suffix[t], prefix[t + w - 1])
  const long long first = cont ? w + k - 1 : w - 1;  // first reported position
  const int npair = (Pe + 1) / 2;
  const FastDiv by_pairs(npair);
  for (int t = threadIdx.x; t < Gact * npair; t += kThreads) {
    const int g = by_pairs(t), h = 2 * (t - g * npair);
    const u64* pre = xs + g * E + (w - 1);
    const u64* s = suf + g * E;
    const uint8_t* v = valid + g * E + (w - 1);
    const long long i = p0 + h;
    const long long o = (r0 + g) * L + i;
    const u64 m0 = min(s[h], pre[h]);
    const bool f0 = v[h] && i >= first;
    if (h + 1 < Pe) {
      const u64 m1 = min(s[h + 1], pre[h + 1]);
      const bool f1 = v[h + 1] && i + 1 >= first;
      if ((o & 1) == 0) {
        *reinterpret_cast<ulonglong2*>(wmin + o) = make_ulonglong2(m0, m1);
        *reinterpret_cast<uchar2*>(report + o) = make_uchar2(f0, f1);
      } else {
        wmin[o] = m0;
        wmin[o + 1] = m1;
        report[o] = f0;
        report[o + 1] = f1;
      }
    } else {
      wmin[o] = m0;
      report[o] = f0;
    }
  }
}

template <bool kPacked>
int launch(const void* codes, const void* nmask, const void* lengths,
           long long R, long long L, int k, int w, bool cont, void* wmin,
           void* report, void* stream) {
  if (R <= 0 || L <= 0) return 0;
  const Tile tile = make_tile(R, L, k, w);
  const long long blocks = (R + tile.G - 1) / tile.G * tile.nseg;
  minimizer_window_kernel<kPacked><<<static_cast<unsigned>(blocks), kThreads,
                                     tile.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const uint8_t*>(nmask),
      static_cast<const int32_t*>(lengths), R, L, k, w, cont, tile,
      static_cast<u64*>(wmin), static_cast<bool*>(report));
  return static_cast<int>(cudaGetLastError());
}

// One block per segment of P <= 256 positions of one record of L codes
// (positions in int: L <= kRecordCap). Entry e is position p0 - w + e, so
// position p0 + h has the window of entries h+1 .. h+w, h = -1 included.
__global__ void __launch_bounds__(kThreads)
minimizer_record_kernel(const uint8_t* __restrict__ codes, int L, int k, int w, bool cont,
                        int P, int nw, u64* __restrict__ heads,
                        unsigned long long* __restrict__ count) {
  extern __shared__ u64 smem[];
  __shared__ unsigned warp_base[kThreads / 32];
  __shared__ unsigned long long block_base;
  const int E = P + w;
  u64* xs = smem;         // [E] entries, then prefix minima
  u64* suf = xs + E;      // [E] suffix minima
  u64* cw = suf + E;      // [nw] 2-bit codes, position p at bit 2(p - sb)
  u64* nf = cw + nw;      // [nw] N flags, the same pitch
  uint8_t* valid = reinterpret_cast<uint8_t*>(nf + nw);  // [E]

  const int p0 = blockIdx.x * P;
  const int Pe = min(P, L - p0);
  const int Ee = Pe + w;
  const int q0 = p0 - w;
  // staging base: a multiple of 32 at or below entry 0's first base - 1
  const int sb = ((q0 - k - 1) >> 5) << 5;
  const int lane = threadIdx.x & 31;

  // 1. stage
  for (int t = threadIdx.x >> 5; t < nw; t += kThreads / 32) {
    const int p = sb + 32 * t + lane;
    stage_u8_word((p >= 0 && p < L) ? codes[p] : 0u, cw + t, nf + t);
  }
  __syncthreads();

  // 2. entries
  const u64 mask = (1ULL << (2 * k)) - 1ULL;
  const u64 nlim = (1ULL << (2 * k + 1)) - 1ULL;
  for (int e = threadIdx.x; e < Ee; e += kThreads) {
    const int q = q0 + e;
    u64 x = kU64Max;
    bool ok = false;
    if (q >= k - 1 && q < L) {
      const long long span = cont ? k : min(q - (w - 2), k);
      ok = kmer_entry(cw, nf, 2 * (q - k - sb), k, mask, nlim, span, x);
    }
    xs[e] = x;
    valid[e] = ok;
  }
  __syncthreads();

  // 3. suffix and prefix minima over blocks of w entries
  for (int b = threadIdx.x; b < (Ee + w - 1) / w; b += kThreads) {
    block_minima(xs, suf, b, w, Ee);
  }
  __syncthreads();

  // 4. run heads, one position a thread: reported, and not equal to a
  // reported position before it
  const int first = cont ? w + k - 1 : w - 1;  // first reported position
  const int h = threadIdx.x;
  bool head = false;
  u64 m = 0;
  if (h < Pe && valid[h + w] && p0 + h >= first) {
    m = min(suf[h + 1], xs[h + w]);
    head = !(valid[h + w - 1] && p0 + h - 1 >= first && min(suf[h], xs[h + w - 1]) == m);
  }
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, head);
  if (lane == 0) warp_base[threadIdx.x >> 5] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
    for (int j = 0; j < kThreads / 32; ++j) {
      const unsigned c = warp_base[j];
      warp_base[j] = total;
      total += c;
    }
    block_base = total ? atomicAdd(count, static_cast<unsigned long long>(total)) : 0ULL;
  }
  __syncthreads();
  if (head) {
    heads[block_base + warp_base[threadIdx.x >> 5] + __popc(ballot & ((1u << lane) - 1u))] = m;
  }
}

}  // namespace

// The most positions one hulk_minimizer_record launch scans: positions stay
// int arithmetic (a 64-bit add or compare is two 32-bit instructions on the
// card) with room for the halo. ops/longread.py:RECORD_CAP matches it.
constexpr long long kRecordCap = 1LL << 30;

// codes [L] u8 of one record (0-3 bases, >= 4 an N), contiguous on the
// current device, 0 < L <= 2^30; heads [>= count + run heads] u64 and count
// [] u64 on the same device. Appends the record's run heads to heads at
// count, in no order, and adds their number to count. cont != 0 scans a
// chunk after the first of a record cut at the cap (span k at every
// position, reports from local position w+k-1). Launched on `stream`;
// returns the launch's CUDA error.
extern "C" int hulk_minimizer_record(const void* codes, long long L, int k, int w, int cont,
                                     void* heads, void* count, void* stream) {
  if (L <= 0) return 0;
  if (L > kRecordCap) return static_cast<int>(cudaErrorInvalidValue);
  const int nseg = static_cast<int>((L + kMaxSeg - 1) / kMaxSeg);
  const int P = static_cast<int>((L + nseg - 1) / nseg);
  // words from floor32(p0 - w - k - 1) to p0 + P - 1, plus the funnel's
  const int nw = (P + w + k + 31) / 32 + 2;
  const size_t smem = static_cast<size_t>(17) * (P + w) + 16 * nw;
  minimizer_record_kernel<<<nseg, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<int>(L), k, w, cont != 0, P, nw,
      static_cast<u64*>(heads), static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

// codes [R, L] u8, lengths [R] i32, wmin [R, L] u64, report [R, L] bool, all
// contiguous on the current device; cont != 0 scans continuation blocks of
// long reads (span k at every position, reports from local position w+k-1).
// Launched on `stream`. Returns the CUDA error of the launch (0 when it was
// accepted).
extern "C" int hulk_minimizer_window(const void* codes, const void* lengths,
                                     long long R, long long L, int k, int w,
                                     int cont, void* wmin, void* report,
                                     void* stream) {
  return launch<false>(codes, nullptr, lengths, R, L, k, w, cont != 0, wmin, report,
                       stream);
}

// The v2 transfer layout: codes2 [R, L/4] u8, mask8 [R, L/8] u8, lengths [R]
// i32, L % 8 == 0; outputs as hulk_minimizer_window.
extern "C" int hulk_minimizer_window_packed(const void* codes2, const void* mask8,
                                            const void* lengths, long long R,
                                            long long L, int k, int w, void* wmin,
                                            void* report, void* stream) {
  if (L % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(codes2, mask8, lengths, R, L, k, w, false, wmin, report, stream);
}
