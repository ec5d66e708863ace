// Scavenger's lookup, fetch-planning and adaptive-tracker kernels for
// Hopper (sm_90a).
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/common.py).
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (0 = launched).
//
// Keys, filter words and bit indices arrive as 64-bit words holding u64
// bit patterns and are compared as unsigned.  Sorted runs may be empty;
// the kernels mask the ragged edge themselves, so no padding sentinel
// limits the key range.
//
// The Pallas kernels these replace (src/repro/kernels/) are brute-force
// O(Q*N) compare-reduces, one-hot word fetches and a bitonic network over
// u32 lanes, shaped by the TPU's lack of a per-lane gather.  Hopper
// gathers natively and has 64-bit integers, so each probe here is one
// thread per query running a binary search, over fences of the run staged
// in shared memory where the run is long enough to pay for them.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

typedef unsigned long long u64;
typedef long long i64;
typedef uint32_t u32;

namespace {

constexpr int kProbeThreads = 256;
constexpr int kCoalesceThreads = 1024;
constexpr int kCoalesceWarps = kCoalesceThreads / 32;
static_assert(kCoalesceWarps <= 32, "the radix scan reads one warp total "
                                    "a lane");
// pairs sorted inside one CTA's shared memory; the wrapper reads it
// through scav_smem_sort_cap()
constexpr i64 kSmemSortCap = 8192;
// keys a thread holds in registers during the one-CTA sort
constexpr int kCoalesceItems = (int)(kSmemSortCap / kCoalesceThreads);
static_assert(kSmemSortCap % kCoalesceThreads == 0, "whole items a thread");
// the radix digit (7 bits: the 1 GiB store's ~21-bit keys in three passes;
// 5-8 bits measured alike, PERF.md); the digit counts, one per (digit, warp)
// at d * kCountStride + w (one pad a digit, so a warp's counts of different
// digits fall in different banks); and the one-CTA sort's dynamic shared
// memory at the cap: the sorted column (8 B a pair) and the counts.  81 KB
// is above the 48 KB default, so the opt-in attribute is set once.
constexpr int kDigitBits = 7;
constexpr int kCountStride = kCoalesceWarps + 1;
constexpr int kCountBytes =
    (1 << kDigitBits) * kCountStride * (int)sizeof(u32);
constexpr int kCoalesceSmem = (int)(kSmemSortCap * sizeof(u64)) + kCountBytes;

// #{run < q} over an ascending run (searchsorted side='left').
__device__ __forceinline__ i64 lower_bound(const u64* __restrict__ run,
                                           i64 n, u64 q) {
  i64 lo = 0, hi = n;
  while (lo < hi) {
    i64 mid = (lo + hi) >> 1;
    if (run[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ i64 upper_bound(const u64* __restrict__ run,
                                           i64 n, u64 q) {
  i64 lo = 0, hi = n;
  while (lo < hi) {
    i64 mid = (lo + hi) >> 1;
    if (run[mid] <= q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// rank_probe: replaces rank_probe_pallas (lookup_probe/kernel.py:134), and
// lookup_probe: replaces lookup_probe_pallas (lookup_probe/kernel.py:102).
// rank = #{run < q} and found = run[rank] == q; lookup_probe adds may =
// AND over the query's k filter bits (bit b of the u64 word array is
// (w[b >> 6] >> (b & 63)) & 1, the same bit the reference reads through a
// little-endian u32 view).
//
// Each kernel has two forms: over one run (rank_probe's run form, the
// memtable probe; lookup_probe's table form) or over many in one launch
// (kLevel / kSegments: lookup_probe's level form, every L0 table or every
// file of one deeper level; rank_probe's segmented form, every vSST a
// multi_get or scan reads).  Each CTA of a many-run form takes one tile of
// one segment (ProbeTile: its file's run and filter, the first row and
// output slot, the count).  The level form reads its keys through a row
// index into the call's key column and computes its bit indices on the
// card as kraw[j, row] % nbits (u64) from the raw hash column that goes
// up once per lookup; the segmented form's keys arrive grouped, a tile's
// from its first row on.  The one-run forms pass their file by value,
// tiles implied by blockIdx, and the table form its bit indices given.
//
// Bound: latency.  A query's work is a chain of dependent loads; its bytes
// are a few sectors, so the bytes bound is far below one chain of L2 hits.
// The first port ran ~log2(N) dependent global loads a query (~10 for a
// memtable, ~14 for a level's file) and one launch a table or vSST.
// Design: each CTA stages every 2^shift-th key of its run (the fences, at
// most kMaxFences: ~3 KB at stride 32 for a 12k-key file) in shared
// memory; a thread searches the fences there, then only the window
// between two fences in global memory (shift loads).  lookup_probe's k
// filter-word gathers issue before the barrier, so they overlap the
// staging and the search.  A tile carries its file's descriptor, so a CTA
// reads its work in one round trip; the modulo by nbits is a multiply by
// the file's magic (FastMod), not a 64-bit division on the chain.  rank =
// #{run < q}: with f = #{fences < q}, rank is 0 when f = 0, else in
// ((f-1)*stride, f*stride].  rank_probe's run form searches a run of a
// few keys in device memory (rank_search_kernel): staging so short a run
// costs more than its search, and the staged kernel with a branch to that
// search took ~0.1 us more than this kernel at runs of 1 to 32 keys
// (PERF.md §6).

// rank_probe's run form over a run of a few keys: one thread a query, a
// binary search in device memory.
__global__ void rank_search_kernel(const u64* __restrict__ q, i64 nq,
                                   const u64* __restrict__ run, i64 n,
                                   bool* __restrict__ found,
                                   i64* __restrict__ rank) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const u64 key = q[i];
  const i64 r = lower_bound(run, n, key);
  rank[i] = r;
  found[i] = r < n && run[r] == key;
}

// x % d for a divisor fixed per call: Granlund and Montgomery's unsigned
// division by an invariant integer (PLDI 1994, fig. 4.1), l = ceil(log2 d),
// m = floor(2^(64+l) / d) - 2^64 + 1 (the host computes both).
struct FastMod {
  u64 d;
  u64 m;
  i64 l;
};

__device__ __forceinline__ u64 fast_mod(u64 x, const FastMod& f) {
  const u64 t = __umul64hi(x, f.m);
  const u64 q = (t + ((x - t) >> (f.l > 0 ? 1 : 0))) >> (f.l > 1 ? f.l - 1 : 0);
  return x - q * f.d;
}

struct ProbeTile {     // one CTA's queries: rows[row .. row + count) (or
  const u64* run;      // keys[row .. row + count)) into output slots
  i64 n;               // [out .. out + count) against the run and filter
  const u64* words;    // of one file (the filter's nbits and its FastMod
  FastMod bits;        // magic in bits; rank_probe's tiles hold no filter,
                       // words its run's values or null)
  i64 row;
  i64 out;
  i64 count;
};
constexpr int kTileWords = 9;
static_assert(sizeof(ProbeTile) == kTileWords * sizeof(i64),
              "plan tiles of kTileWords i64");

constexpr int kMaxFences = 2048;   // 16 KB of fence keys a CTA
constexpr int kPrefetchK = 8;      // filter words gathered before the search
// global loads a thread issues before it uses the first of them (a loop
// over a column would otherwise wait out one load's latency an element)
constexpr int kLoadBatch = 8;

// #{run < q} over n >= 0 ascending words in shared memory, in
// ceil(log2 n) steps whatever q is.  The window [base, base + len) holds
// the answer's last step: every word before base is < q, every word from
// base + len on is >= q; a step halves the window by one compare and a
// select.
__device__ __forceinline__ i64 lower_bound_fixed(const u64* run, i64 n,
                                                 u64 q) {
  if (n == 0) return 0;
  const u64* base = run;
  while (n > 1) {
    const i64 half = n >> 1;
    base = base[half] < q ? base + half : base;
    n -= half;
  }
  return (base - run) + (*base < q ? 1 : 0);
}

template <bool kLevel>
__device__ __forceinline__ u64 probe_bit(const u64* __restrict__ hashes,
                                         i64 nkeys, i64 k, i64 row,
                                         i64 slot, i64 j, const FastMod& m) {
  return kLevel ? fast_mod(hashes[j * nkeys + row], m)
                : hashes[slot * k + j];
}

template <bool kLevel>
__global__ void __launch_bounds__(1024)
lookup_probe_kernel(const u64* __restrict__ keys, i64 nkeys,
                    const u64* __restrict__ hashes, i64 k,
                    const i64* __restrict__ plan, i64 nrows, ProbeTile one,
                    int shift, bool* __restrict__ may,
                    bool* __restrict__ found, i64* __restrict__ rank) {
  __shared__ u64 fences[kMaxFences];
  ProbeTile t;
  if (kLevel) {
    t = reinterpret_cast<const ProbeTile*>(plan + nrows)[blockIdx.x];
  } else {
    t = one;
    t.row = t.out = (i64)blockIdx.x * blockDim.x;
    t.count = one.count - t.row < blockDim.x ? one.count - t.row
                                             : (i64)blockDim.x;
  }
  while (((t.n + (1ll << shift) - 1) >> shift) > kMaxFences) ++shift;
  const i64 stride = 1ll << shift;
  const i64 nf = (t.n + stride - 1) >> shift;
  for (i64 i = threadIdx.x; i < nf; i += blockDim.x)
    fences[i] = t.run[i << shift];

  const bool active = threadIdx.x < t.count;
  const i64 slot = t.out + threadIdx.x;
  i64 row = slot;
  u64 key = 0;
  u64 w[kPrefetchK];
  unsigned sh[kPrefetchK];
  if (active) {
    if (kLevel) row = plan[t.row + threadIdx.x];
    key = keys[row];
#pragma unroll
    for (int j = 0; j < kPrefetchK; ++j) {
      if (j < k) {
        const u64 b = probe_bit<kLevel>(hashes, nkeys, k, row, slot, j,
                                        t.bits);
        w[j] = t.words[b >> 6];
        sh[j] = (unsigned)(b & 63);
      }
    }
  }
  __syncthreads();
  if (!active) return;

  i64 lo = 0, hi = nf;            // lo = #{fences < key}
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    if (fences[mid] < key) lo = mid + 1; else hi = mid;
  }
  i64 r = 0;
  if (lo > 0) {
    const i64 a = ((lo - 1) << shift) + 1;
    const i64 b = (lo << shift) < t.n ? (lo << shift) : t.n;
    r = a + lower_bound(t.run + a, b - a, key);
  }
  bool all = true;
#pragma unroll
  for (int j = 0; j < kPrefetchK; ++j)
    if (j < k) all &= ((w[j] >> sh[j]) & 1ull) != 0;
  for (i64 j = kPrefetchK; j < k; ++j) {
    const u64 b = probe_bit<kLevel>(hashes, nkeys, k, row, slot, j, t.bits);
    all &= ((t.words[b >> 6] >> (b & 63)) & 1ull) != 0;
  }
  may[slot] = all;
  rank[slot] = r;
  found[slot] = r < t.n && t.run[r] == key;
}

// rank_probe's run and segmented forms: lookup_probe's staging and search
// without the filter, the fence loads issued before their stores, a
// fixed-step search of the fences, and found read from a fence where the
// rank lands on one.  The segmented form's tiles (kSegments) read keys
// [row, row + count), and with `val` set write the run's value at each
// key found (t.words: the values, one a run key), 0 elsewhere.  The
// fences live in dynamic shared memory sized by the launch (fence_bytes):
// a vSST's few hundred bytes in place of kMaxFences' 16 KB.
template <bool kSegments>
__global__ void __launch_bounds__(1024)
rank_probe_kernel(const u64* __restrict__ keys,
                  const ProbeTile* __restrict__ tiles, ProbeTile one,
                  int shift, bool* __restrict__ found,
                  i64* __restrict__ rank, i64* __restrict__ val) {
  extern __shared__ u64 fences[];
  ProbeTile t;
  if (kSegments) {
    t = tiles[blockIdx.x];
  } else {
    t = one;
    t.row = t.out = (i64)blockIdx.x * blockDim.x;
    t.count = one.count - t.row < blockDim.x ? one.count - t.row
                                             : (i64)blockDim.x;
  }
  const bool active = threadIdx.x < t.count;
  const u64 key = active ? keys[t.row + threadIdx.x] : 0ull;
  while (((t.n + (1ll << shift) - 1) >> shift) > kMaxFences) ++shift;
  const i64 nf = (t.n + (1ll << shift) - 1) >> shift;
  for (i64 j0 = threadIdx.x; j0 < nf; j0 += (i64)blockDim.x * kLoadBatch) {
    u64 v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {     // the loads, then the stores
      const i64 j = j0 + (i64)u * blockDim.x;
      if (j < nf) v[u] = t.run[j << shift];
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const i64 j = j0 + (i64)u * blockDim.x;
      if (j < nf) fences[j] = v[u];
    }
  }
  __syncthreads();
  if (!active) return;
  const i64 slot = t.out + threadIdx.x;
  const i64 f = lower_bound_fixed(fences, nf, key);     // #{fences < key}
  i64 r = 0;
  if (f > 0) {
    const i64 a = ((f - 1) << shift) + 1;
    const i64 b = (f << shift) < t.n ? (f << shift) : t.n;
    r = a + lower_bound(t.run + a, b - a, key);
  }
  // rank f << shift is fence f (run[r] >= key there, read in shared
  // memory); a rank inside the window was a window key
  const bool hit = r < t.n &&
                   (r == (f << shift) ? fences[f] : t.run[r]) == key;
  found[slot] = hit;
  rank[slot] = r;
  if (kSegments && val != nullptr)
    val[slot] = hit ? (i64)t.words[r] : 0;
}

// ---------------------------------------------------------------------------
// count_le: replaces count_le_pallas (lookup_probe/kernel.py:158).
// cnt = #{mins <= q} (searchsorted side='right') over a level's file mins.
// With `interval` set it writes interval_rank instead, the index of the
// file whose [min, max] covers q or -1: cnt - 1 when q <= maxs[cnt - 1],
// else -1.
//
// Bound: latency; a level holds at most a few hundred files, so the bytes
// (the queries, the bounds once, the outputs) take well under 0.1 us.
// The first port ran one thread per query through ~log2(N) + 1 dependent
// loads of the bounds in global memory (L1/L2 hits), most of its time at
// 10,942 queries.  Design (kCountLeSmemMinFiles <= N <= kCountLeSmemFiles,
// the main path): each
// CTA stages the level's mins (and maxs) into shared memory with one
// coalesced sweep, its queries' keys already in flight; each thread then
// runs a branch-free upper_bound of ceil(log2 N) fixed steps over shared
// memory (the same count on every lane, so no divergence) and reads
// maxs[c-1] there too.  A query's only global traffic is its key and its
// output.  Larger and smaller levels keep the global-memory search.  The
// interval
// check runs on the same thread, so the level file assignment is one
// launch and no follow-up elementwise passes.
constexpr i64 kCountLeSmemFiles = 2048;   // 32 KB of mins and maxs a CTA
// below this many files the global-memory search, a load or two a query,
// was faster than staging at 4 files and fewer (PERF.md §6)
constexpr i64 kCountLeSmemMinFiles = 8;

// #{run <= q} over n >= 0 ascending words in shared memory, in
// ceil(log2 n) steps whatever q is.  The window [base, base + len) holds
// the answer's last step: every word before base is <= q, every word from
// base + len on is > q; a step halves the window by one compare and a
// select.
__device__ __forceinline__ i64 upper_bound_fixed(const u64* run, i64 n,
                                                 u64 q) {
  if (n == 0) return 0;
  const u64* base = run;
  while (n > 1) {
    const i64 half = n >> 1;
    base = base[half] <= q ? base + half : base;
    n -= half;
  }
  return (base - run) + (*base <= q ? 1 : 0);
}

template <bool kShared>
__global__ void count_le_kernel(const u64* __restrict__ q, i64 nq,
                                const u64* __restrict__ mins, i64 n,
                                const u64* __restrict__ maxs, bool interval,
                                i64* __restrict__ cnt) {
  extern __shared__ u64 le_bounds[];   // mins [0, n), then maxs [n, 2n)
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  const u64 key = i < nq ? q[i] : 0ull;
  if (kShared) {
    for (i64 j0 = threadIdx.x; j0 < n;
         j0 += (i64)blockDim.x * kLoadBatch) {
      u64 lo[kLoadBatch], hi[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {   // the loads, then the stores
        const i64 j = j0 + (i64)u * blockDim.x;
        if (j < n) {
          lo[u] = mins[j];
          if (interval) hi[u] = maxs[j];
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const i64 j = j0 + (i64)u * blockDim.x;
        if (j < n) {
          le_bounds[j] = lo[u];
          if (interval) le_bounds[n + j] = hi[u];
        }
      }
    }
    __syncthreads();
  }
  if (i >= nq) return;
  i64 c = kShared ? upper_bound_fixed(le_bounds, n, key)
                  : upper_bound(mins, n, key);
  if (interval) {
    const u64* hi = kShared ? le_bounds + n : maxs;
    c = (c > 0 && key <= hi[c - 1]) ? c - 1 : -1;
  }
  cnt[i] = c;
}

// ---------------------------------------------------------------------------
// run_coalesce: replaces run_coalesce_pallas (src/repro/kernels/run_coalesce/
// kernel.py:47).  Sort the (file-rank, pos) pairs lexicographically, keep
// the first of each duplicate, and start a run at a file change, at a
// position gap > 1, and (window > 0) every `window` kept records since the
// run's start.
//
// Bound: latency and instruction issue in one SM.  M is one multi_get's
// fetch count (a few thousand pairs, 16 B each in and 18 B out), so the
// bytes bound is well under a microsecond, and so few keys are one CTA's
// work: the barriers are CTA barriers.  The TPU kernel ran a bitonic network (no
// per-lane scatter there), and the first port did too: log2(M) *
// (log2(M) + 1) / 2 barrier-separated stages over 64-bit keys, 78 at
// M = 4,096.  Radix and not bitonic: a radix pass costs four barriers and
// a fixed number of instructions a key whatever M is, so the time is
// passes x (barriers + a warp's share of the keys) instead of
// log2(M)^2 / 2 barrier rounds.
//
// Design (M <= kSmemSortCap, the main path): one CTA, an LSD radix sort of
// the pairs packed as rank << pos_bits | pos over only the bits in use.
// A block OR of the loaded pairs gives rank_bits and pos_bits; the key is a
// u32 when they sum to <= 32 (one multi_get's ranks index a few hundred
// vSSTs, its positions a vSST's records), else a u64.  The sort takes
// ceil(bits / kDigitBits) passes: 3 at the 1 GiB store's widths, 10 when
// all 64 bits are in use, none when every pair is (0, 0).  Each warp owns a
// contiguous range of 32-key chunks and holds its keys in registers
// (kCoalesceItems a thread).  A pass: the lanes of a chunk with equal
// digits found by one ballot a digit bit (__match_any_sync measured
// slower); per-warp digit counts, the lowest lane of each group adding it,
// and each key's rank among its warp's keys of that digit read back from
// the count before the add; one exclusive scan over (digit, warp); a
// scatter into the shared column at the scanned count + the rank; and the
// keys reread from there.  Keys are ranked in (warp, chunk, lane) order,
// which is index order, so each pass is stable and LSD is correct; equal
// keys are duplicate pairs, whose order reaches no output.  The last pass
// writes the pairs back as rank << 32 | pos, and mark_runs marks them in
// the same CTA, so the column makes one round trip to device memory.  No
// library sort: the counts, the scan and the scatter are all here.
//
// Longer columns (M > kSmemSortCap, off the main path) pad to a power of
// two with all-ones pairs (which sort after every real pair: ranks are
// < 2^32 - 1), sort in global memory by the bitonic network, one launch per
// stage, and a one-CTA pass marks them.

__device__ __forceinline__ u64 pack_pair(const i64* __restrict__ rank,
                                         const i64* __restrict__ pos,
                                         i64 m, i64 i) {
  return i < m ? ((u64)rank[i] << 32) | (u64)(unsigned)pos[i] : ~0ull;
}

__device__ __forceinline__ void compare_exchange(u64* s, i64 t, i64 j,
                                                 i64 k) {
  i64 i = 2 * t - (t & (j - 1));   // t-th index whose bit j is clear
  i64 l = i + j;
  u64 a = s[i], b = s[l];
  bool ascending = (i & k) == 0;
  if ((a > b) == ascending) { s[i] = b; s[l] = a; }
}

// Inclusive scan across the CTA (blockDim.x a multiple of 32, <= 1024) of
// a sum (kMax false) or a max of non-negative values (kMax true).
template <bool kMax>
__device__ i64 block_scan(i64 v, i64* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    i64 u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = kMax ? (u > v ? u : v) : v + u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    i64 w = lane < nwarps ? warp_tot[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      i64 u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = kMax ? (u > w ? u : w) : w + u;
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) {
    i64 p = warp_tot[warp - 1];
    v = kMax ? (p > v ? p : v) : v + p;
  }
  __syncthreads();
  return v;
}

// Dedup and run marks over the sorted column s[0, m), by the whole CTA in
// chunks of blockDim.x; the kept count and the last run start's kept
// count carry from chunk to chunk.
__device__ void mark_runs(const u64* s, i64 m, i64 window,
                          i64* __restrict__ rank_s, i64* __restrict__ pos_s,
                          bool* __restrict__ keep_out,
                          bool* __restrict__ start_out) {
  __shared__ i64 warp_tot[32];
  __shared__ i64 carry[2];
  i64 kept_carry = 0, base_carry = 0;
  for (i64 c = 0; c < m; c += blockDim.x) {
    const i64 i = c + threadIdx.x;
    bool keep = false, start = false;
    if (i < m) {
      u64 cur = s[i];
      unsigned r = (unsigned)(cur >> 32), p = (unsigned)cur;
      if (i == 0) {
        keep = start = true;
      } else {
        u64 prev = s[i - 1];
        unsigned pr = (unsigned)(prev >> 32), pp = (unsigned)prev;
        keep = r != pr || p != pp;
        start = keep && (r != pr || p - pp > 1u);
      }
      rank_s[i] = r;
      pos_s[i] = p;
    }
    if (window > 0) {   // uniform across the CTA
      i64 kept = kept_carry + block_scan<false>(keep ? 1 : 0, warp_tot);
      i64 base = block_scan<true>(start ? kept : 0, warp_tot);
      base = base > base_carry ? base : base_carry;
      if (keep && (kept - base) % window == 0) start = true;
      if (threadIdx.x == blockDim.x - 1) { carry[0] = kept; carry[1] = base; }
      __syncthreads();
      kept_carry = carry[0];
      base_carry = carry[1];
      __syncthreads();
    }
    if (i < m) {
      keep_out[i] = keep;
      start_out[i] = start;
    }
  }
}

// Inclusive sum across the warp's lanes.
__device__ __forceinline__ u32 warp_inclusive_sum(u32 v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const u32 u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// The scan of one radix pass: counts[d * kCountStride + w], warp w's count
// of digit d, becomes the number of keys before warp w's keys of digit d
// in the pass's output (keys of smaller digits, and of digit d in earlier
// warps): an exclusive scan in (digit, warp) order, the pad slots zero.
// Each thread sums a contiguous slice; the slices' offsets come from one
// shuffle scan a warp and the warp totals, in two barrier rounds.
__device__ void scan_digit_counts(u32* counts, u32* warp_tot) {
  constexpr int n = (1 << kDigitBits) * kCountStride;
  constexpr int per = (n + kCoalesceThreads - 1) / kCoalesceThreads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo = threadIdx.x * per;
  u32 v[per], sum = 0;
#pragma unroll
  for (int j = 0; j < per; ++j) {
    v[j] = lo + j < n ? counts[lo + j] : 0u;
    sum += v[j];
  }
  const u32 incl = warp_inclusive_sum(sum);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  u32 before = lane < warp ? warp_tot[lane] : 0u;   // the earlier warps
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    before += __shfl_xor_sync(0xffffffffu, before, o);
  u32 run = before + incl - sum;
#pragma unroll
  for (int j = 0; j < per; ++j) {
    if (lo + j < n) counts[lo + j] = run;
    run += v[j];
  }
  __syncthreads();
}

// The lanes of this warp whose digit d equals this lane's, among the lanes
// in `valid`: one ballot a digit bit.
__device__ __forceinline__ u32 digit_peers(u32 d, u32 valid) {
  u32 peers = valid;
#pragma unroll
  for (int b = 0; b < kDigitBits; ++b) {
    const u32 bit = (d >> b) & 1u;
    const u32 ones = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? ones : ~ones;
  }
  return peers;
}

// LSD radix sort of the CTA's pairs (r, p: this thread's items, chunk c of
// its warp's range at index first + 32 * c) as K keys r << pos_bits | p of
// `bits` bits; writes the sorted pairs to col[0, m) as rank << 32 | pos.
template <typename K>
__device__ void radix_sort_pairs(const u32 (&r)[kCoalesceItems],
                                 const u32 (&p)[kCoalesceItems], int m,
                                 int cpw, int pos_bits, int bits, u64* col,
                                 u32* counts, u32* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = warp * cpw * 32 + lane;
  const u32 lower = (1u << lane) - 1u;      // the lanes below this one
  const u64 pos_mask = (1ull << pos_bits) - 1ull;
  K key[kCoalesceItems];
#pragma unroll
  for (int c = 0; c < kCoalesceItems; ++c)
    key[c] = (K)(((u64)r[c] << pos_bits) | p[c]);
  const u32 dmask = (1u << kDigitBits) - 1u;
  const int passes = (bits + kDigitBits - 1) / kDigitBits;
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * kDigitBits;
    const bool last = pass == passes - 1;
#pragma unroll
    for (int d = lane; d <= (int)dmask; d += 32) {
      counts[d * kCountStride + warp] = 0;
      if (warp == 0) counts[d * kCountStride + kCoalesceWarps] = 0;   // pad
    }
    __syncwarp();
    // counts: each chunk's groups of equal digits (all chunks' ballots
    // first, so they overlap), then chunk by chunk the lowest lane of each
    // group adds the group to the warp's count of the digit, and the count
    // before the add, read back by its peers, gives each key its rank among
    // its warp's keys of that digit (__syncwarp orders one chunk's adds
    // before the next chunk's, which another lane may make)
    u32 rank[kCoalesceItems];               // the peers, then the ranks
#pragma unroll
    for (int c = 0; c < kCoalesceItems; ++c) {
      if (c >= cpw) break;                 // uniform across the warp
      const int left = m - (first - lane + 32 * c);   // keys from the chunk
      rank[c] = digit_peers((u32)(key[c] >> shift) & dmask,
                            left >= 32 ? 0xffffffffu
                                       : left > 0 ? (1u << left) - 1u : 0u);
    }
#pragma unroll
    for (int c = 0; c < kCoalesceItems; ++c) {
      if (c >= cpw) break;
      const bool ok = first + 32 * c < m;
      const u32 d = (u32)(key[c] >> shift) & dmask;
      const u32 peers = rank[c];
      const int leader = (__ffs(peers) - 1) & 31;
      u32 before = 0;
      if (ok && lane == leader)
        before = atomicAdd(&counts[d * kCountStride + warp], __popc(peers));
      rank[c] = __shfl_sync(0xffffffffu, before, leader) +
                __popc(peers & lower);
      __syncwarp();
    }
    __syncthreads();
    scan_digit_counts(counts, warp_tot);
#pragma unroll
    for (int c = 0; c < kCoalesceItems; ++c) {
      if (c >= cpw) break;
      if (first + 32 * c < m) {
        const u32 d = (u32)(key[c] >> shift) & dmask;
        const u32 at = counts[d * kCountStride + warp] + rank[c];
        if (last) {
          const u64 k = key[c];
          col[at] = ((k >> pos_bits) << 32) | (k & pos_mask);
        } else {
          ((K*)col)[at] = key[c];
        }
      }
    }
    __syncthreads();
    if (!last) {
#pragma unroll
      for (int c = 0; c < kCoalesceItems; ++c)
        if (c < cpw && first + 32 * c < m)
          key[c] = ((const K*)col)[first + 32 * c];
    }
  }
  if (passes == 0) {          // every pair is (0, 0): already in order
#pragma unroll
    for (int c = 0; c < kCoalesceItems; ++c)
      if (c < cpw && first + 32 * c < m) col[first + 32 * c] = 0;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kCoalesceThreads)
coalesce_radix_kernel(const i64* __restrict__ rank,
                      const i64* __restrict__ pos, int m, i64 window,
                      i64* __restrict__ rank_s, i64* __restrict__ pos_s,
                      bool* __restrict__ keep, bool* __restrict__ start) {
  extern __shared__ u64 col[];                    // m sorted pairs
  u32* counts = (u32*)(col + m);                  // digit counts
  __shared__ u32 used[2];                         // OR of ranks, positions
  __shared__ u32 warp_tot[kCoalesceWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // warp w owns chunks [w * cpw, (w + 1) * cpw) of 32 consecutive pairs
  const int cpw = (((m + 31) >> 5) + kCoalesceWarps - 1) / kCoalesceWarps;
  const int first = warp * cpw * 32 + lane;
  if (threadIdx.x == 0) used[0] = used[1] = 0;
  u32 r[kCoalesceItems], p[kCoalesceItems];
  u32 r_or = 0, p_or = 0;
#pragma unroll
  for (int c = 0; c < kCoalesceItems; ++c) {
    const int i = first + 32 * c;
    const bool ok = c < cpw && i < m;
    r[c] = ok ? (u32)rank[i] : 0u;
    p[c] = ok ? (u32)pos[i] : 0u;
    r_or |= r[c];
    p_or |= p[c];
  }
  r_or = __reduce_or_sync(0xffffffffu, r_or);
  p_or = __reduce_or_sync(0xffffffffu, p_or);
  __syncthreads();                                // used[] zeroed
  if (lane == 0) {
    atomicOr(&used[0], r_or);
    atomicOr(&used[1], p_or);
  }
  __syncthreads();
  const int pos_bits = 32 - __clz(used[1]);
  const int bits = pos_bits + 32 - __clz(used[0]);
  if (bits <= 32)
    radix_sort_pairs<u32>(r, p, m, cpw, pos_bits, bits, col, counts,
                          warp_tot);
  else
    radix_sort_pairs<u64>(r, p, m, cpw, pos_bits, bits, col, counts,
                          warp_tot);
  mark_runs(col, m, window, rank_s, pos_s, keep, start);
}

// Raise the one-CTA sort's dynamic shared memory limit once per device.
cudaError_t coalesce_smem_opt_in() {
  static std::atomic<u64> done{0};                // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const u64 bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(coalesce_radix_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kCoalesceSmem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

__global__ void pack_kernel(const i64* __restrict__ rank,
                            const i64* __restrict__ pos, i64 m, i64 mp,
                            u64* __restrict__ s) {
  i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < mp) s[t] = pack_pair(rank, pos, m, t);
}

__global__ void bitonic_stage_kernel(u64* s, i64 mp, i64 j, i64 k) {
  i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < mp / 2) compare_exchange(s, t, j, k);
}

__global__ void __launch_bounds__(kCoalesceThreads)
mark_kernel(const u64* __restrict__ s, i64 m, i64 window,
            i64* __restrict__ rank_s, i64* __restrict__ pos_s,
            bool* __restrict__ keep, bool* __restrict__ start) {
  mark_runs(s, m, window, rank_s, pos_s, keep, start);
}

// ---------------------------------------------------------------------------
// segment_sum: replaces segment_sum_pallas (src/repro/kernels/segment_reduce/
// kernel.py:47).  out[s] = #{i : ids[i] == s} for s in [0, n_slots); ids
// outside that range (the reference masks with -1) are ignored.
//
// This index form carries the lifetime histogram's adds; the sketch's adds
// take the key form, sketch_add, below.
//
// Bound: latency.  The adaptive tracker's largest add is ~1,000 ids into
// ~32K slots (8 KB in, 256 KB out): the bytes bound is under 0.1 us, so a
// launch's fixed cost sets the time.  The TPU kernel one-hot-compared
// every id against every slot tile (no vector scatter-add there).  The
// first port zeroed the int64 counts with a memset and then added each id
// with a 64-bit global atomic: two device operations a call, 2.26 us at
// the tracker's largest add.  Design: one launch, no memset and no global
// atomic, 1.41-1.45 us there (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6).
// CTA c owns the slots [c * kSegRange, (c + 1) * kSegRange) and counts
// them in shared memory (u32).  Each thread issues its first kLoadBatch
// id loads (the whole column is read by every CTA, from L2), zeroes its
// share of the counts while they are in flight, and after a barrier adds
// each id in the range with a shared-memory atomic; after a second
// barrier the CTA writes its range once as int64, zeros included, two
// counts a 16-byte store.  Integer adds commute, so the counts are exact
// whatever order the atomics land in.  Measured at the tracker's largest
// add: 512 slots a CTA (64 CTAs) at 256 threads beat 256 and 1,024 by
// 0.05-0.08 us, 4,096 by 0.6 and one CTA by 5.5+; the loads issued after
// the zeroing cost 0.08-0.10 us more, and 16-byte id loads 0.13-0.20 more.
//
// Every CTA reads the whole id column and every CTA costs a launch slot,
// so the one launch loses past kSegMaxIds ids or kSegMaxSlots slots to
// the first port's design, which the host then takes (the atomic form: a
// memset of the counts, then one 64-bit global atomic an id,
// segment_atomic_kernel; its work is P + n_slots whatever the shape).
// Measured over 1,018 to 2^20 ids into 1,024 to 2^25 slots (NVIDIA H100
// 80GB HBM3, 700 W; PERF.md §6):
// the one launch is faster at up to 4,096 ids into up to 131,072 slots
// (e.g. 2.03 against 2.29 us at 4,096 x 1,024, 1.69 against 2.37 at
// 1,018 x 131,072) and slower at 6,144 ids or 262,144 slots and past
// (2.57 against 2.28 at 6,144 x 1,024; 3.05 against 2.62 at 4,096 x
// 262,144; 236 against 57 at 2^20 x 1,024).
constexpr int kSegThreads = 256;
constexpr i64 kSegRange = 512;                   // slots a CTA
constexpr i64 kSegMaxIds = 4096;                 // ids of the one launch
constexpr i64 kSegMaxSlots = 256 * kSegRange;    // slots of the one launch

__global__ void __launch_bounds__(kSegThreads)
segment_sum_kernel(const i64* __restrict__ ids, i64 n, i64 n_slots,
                   u64* __restrict__ out) {
  __shared__ __align__(16) u32 cnt[kSegRange];
  const u64 s0 = (u64)blockIdx.x * (u64)kSegRange;
  const u64 len = (u64)n_slots - s0 < (u64)kSegRange ? (u64)n_slots - s0
                                                     : (u64)kSegRange;
  const i64 step = (i64)kSegThreads * kLoadBatch;
  i64 v[kLoadBatch];
  auto load = [&](i64 i0) {
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      const i64 i = i0 + (i64)b * kSegThreads;
      v[b] = i < n ? ids[i] : -1;
    }
  };
  i64 i0 = threadIdx.x;
  load(i0);                          // in flight while the counts zero
  for (u64 i = threadIdx.x; i < len; i += kSegThreads) cnt[i] = 0u;
  __syncthreads();
  while (true) {
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      const u64 r = (u64)v[b] - s0;  // ids outside the range wrap past len
      if (r < len) atomicAdd(&cnt[r], 1u);
    }
    i0 += step;
    if (i0 >= n) break;
    load(i0);
  }
  __syncthreads();
  // s0 is even (kSegRange is), so out + s0 keeps out's 16-byte alignment
  ulonglong2* o2 = reinterpret_cast<ulonglong2*>(out + s0);
  const uint2* c2 = reinterpret_cast<const uint2*>(cnt);
  for (u64 p = threadIdx.x; p < (len >> 1); p += kSegThreads) {
    const uint2 c = c2[p];
    o2[p] = make_ulonglong2(c.x, c.y);
  }
  if ((len & 1) && threadIdx.x == 0) out[s0 + len - 1] = cnt[len - 1];
}

// The atomic form: out zeroed before it, one id a thread.
__global__ void __launch_bounds__(kProbeThreads)
segment_atomic_kernel(const i64* __restrict__ ids, i64 n, i64 n_slots,
                      u64* __restrict__ out) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const u64 s = (u64)ids[i];
  if (s < (u64)n_slots) atomicAdd(&out[s], 1ull);
}

// ---------------------------------------------------------------------------
// gather_min64: replaces gather_min64_pallas (segment_reduce/kernel.py:93).
// out[q] = min over rows r of bits[r, col(q, r)], the count-min estimate
// of the adaptive sketch.  The float64 counters arrive as their 64-bit
// patterns and are compared as unsigned integers: that order is exactly
// the reference's lexicographic (hi, lo) u32 compare, for every pattern
// (for the sketch's non-negative doubles it is also the numeric order,
// and unlike fmin it never picks between +0 and -0).
//
// Two forms, one template.  The index form takes col = idx[q, r] (Q, D),
// and an index outside [0, w) fetches the pattern 0.  The key form
// (kKeys, the sketch's estimate) takes the key column and the D row seeds
// and hashes in registers, col = splitmix64(key ^ seed[r]) % w (u64,
// wrapping; core/engine/keys.py), so the host builds and uploads no
// (Q, D) index matrix: 8 bytes a query go up instead of 8 * D.
//
// Bound: latency.  Q queries x D (<= 4) independent gathers from a D x W
// table of at most a few hundred KB, L2-resident.  Design: one thread per
// query; up to kMinRows columns are computed first (the key form's modulo
// a multiply by w's FastMod magic, not a 64-bit division), then their
// gathers issue together and reduce in registers.
__device__ __forceinline__ u64 splitmix64(u64 x) {
  u64 z = x + 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

constexpr int kMinRows = 4;   // rows whose gathers issue together

template <bool kKeys>
__global__ void gather_min64_kernel(const u64* __restrict__ bits, i64 d,
                                    i64 w, const i64* __restrict__ idx,
                                    const u64* __restrict__ keys,
                                    const u64* __restrict__ seeds,
                                    FastMod wm, i64 nq,
                                    u64* __restrict__ out) {
  i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const u64 key = kKeys ? keys[i] : 0ull;
  u64 best = ~0ull;
  for (i64 r0 = 0; r0 < d; r0 += kMinRows) {
    u64 v[kMinRows];
#pragma unroll
    for (int c = 0; c < kMinRows; ++c) {     // columns, then the gathers
      const i64 r = r0 + c;
      if (r < d) {
        const i64 j = kKeys ? (i64)fast_mod(splitmix64(key ^ seeds[r]), wm)
                            : idx[i * d + r];
        v[c] = (j >= 0 && j < w) ? bits[r * w + j] : 0ull;
      }
    }
#pragma unroll
    for (int c = 0; c < kMinRows; ++c)
      if (r0 + c < d) best = v[c] < best ? v[c] : best;
  }
  out[i] = best;
}

// ---------------------------------------------------------------------------
// sketch_add: segment_sum's key form (segment_sum_pallas, segment_reduce/
// kernel.py:47, is what the reference's sketch adds reach).  Over a D x W
// float64 count-min table on the card, row r's slot
// splitmix64(key ^ seeds[r]) % W receives the number of keys that hash to
// it as ONE float64 add of that integer total per touched slot: the exact
// shape of the host's counts[r] += np.bincount(...), so the counters stay
// bit-identical to it (untouched slots would gain + 0.0, a no-op on the
// never-negative counters).  With `scaled` set, every counter is first
// multiplied by `scale`, the decay factor the host computed (one IEEE
// multiply, as its counts *= f).  __dmul_rn and __dadd_rn are never
// contracted into a fused multiply-add, which would round once where the
// host rounds twice.
//
// Bound: latency.  A batch of a few thousand keys into the store's 2 x 4,096
// table moves ~100 KB (the keys, the counters read and written once), well
// under a microsecond at HBM rate.  The first port hashed on the host,
// uploaded a D*Q index column, zeroed and counted an int64 table (a memset
// and a launch) and brought it back to add on the host, waiting for the
// card.  Design: the counters live on the card, the keys go up and nothing
// comes back.  The sketch owns a u32 scratch of D*W counts that starts and
// ends zero, so no memset runs.  Two launches, each one thread per (key,
// row) pair over the whole card: the first hashes (the modulo a FastMod
// multiply) and atomicAdds the pair's slot in the scratch, its row-0
// threads first multiplying the counters by the decay factor; the second
// re-hashes and takes atomicExch(slot, 0), so the one thread that finds a
// count adds it, once per slot.  Counting in one CTA's shared memory (then
// one sweep of the counters) and in a cluster's distributed shared memory
// were both slower at the store's shapes: the hash's 64-bit multiplies and
// the counter sweep on one SM, or a cluster's launch and barriers, cost
// more than a second launch (PERF.md §6).
// The scratch path: key i of row blockIdx.y.  kFlush false counts into the
// scratch (and, with n_scale > 0, the threads of row 0 first multiply
// counters [0, n_scale) by scale); true takes each count back out and adds
// it.
template <bool kFlush>
__global__ void sketch_scratch_kernel(double* __restrict__ counts, i64 w,
                                      FastMod wm,
                                      const u64* __restrict__ keys, i64 nq,
                                      const u64* __restrict__ seeds,
                                      u32* __restrict__ scratch, i64 n_scale,
                                      double scale) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (!kFlush && blockIdx.y == 0 && i < n_scale)
    counts[i] = __dmul_rn(counts[i], scale);
  if (i >= nq) return;
  const i64 r = blockIdx.y;
  const i64 s = r * w + (i64)fast_mod(splitmix64(keys[i] ^ seeds[r]), wm);
  if (!kFlush) {
    atomicAdd(&scratch[s], 1u);
    return;
  }
  const u32 c = atomicExch(&scratch[s], 0u);
  if (c) counts[s] = __dadd_rn(counts[s], (double)c);
}

__global__ void sketch_scale_kernel(double* __restrict__ counts, i64 n,
                                    double scale) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) counts[i] = __dmul_rn(counts[i], scale);
}

inline unsigned blocks_for(i64 n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// ===========================================================================
// The five kernels no store path routes to, reached through the kernel
// benchmark (repro_torch/bench/).  Keys, sequence numbers, vids, vfiles,
// sizes and filter words are u32, as in the reference (src/repro/kernels/),
// and arrive as the int32 bit view of those values.  No kernel pads:
// ragged edges are masked, so no sentinel value is reserved.

constexpr int kCopyThreads = 256;

// ---------------------------------------------------------------------------
// gc_lookup: replaces gc_lookup_pallas (src/repro/kernels/gc_lookup/
// kernel.py:53), with the contract of gc_lookup/ref.py: the first entry of
// the run equal to the query (searchsorted side='left') gives vid and
// vfile; a miss gives found false and zeros.
//
// Bound: the L1's throughput.  The TPU kernel compared every query with
// every key (no per-lane gather there).  The first port ran a lower_bound
// a thread: ~21 dependent loads a query at N 2^20.  65,536 queries are all
// resident at once, and each level's load is a warp instruction over ~32
// distinct lines; the time followed the load instructions issued, not the
// chain's length: rounds of 2 or 3 levels (3 or 7 loads issued together),
// a warp finishing its queries' last 5 levels from one coalesced load each,
// or L1::no_allocate loads below the shared levels were all slower (7.2 us
// for the first port, 8.8 to 12.3 for rounds; NVIDIA H100 80GB HBM3, 700 W,
// PERF.md §6).  Design: fewer load instructions a query.  Each CTA stages
// 2^kGcLogFences fences of the run in shared memory, and its queries
// resolve the top levels there; the levels under them read the run, and
// the last kGcLogWindow levels come from one sector: 6.30-6.34 us for
// 65,536 queries at N 2^20 (7.24-7.28 before), 2.79-2.80 for 1,024 at N
// 8,192 (3.55-3.56).  1,024 fences won at N 8,192 (2.64) and 512 fences
// with 512 threads a CTA at N 2^20 (6.25); 512 with 256 is within 7% and
// 2% of them in one configuration.
//
// The search: with 2^lg the largest power of two <= N, rank = #{run < q}
// lies in [0, 2^(lg+1)); the level of step 2^l tests run[r + 2^l - 1] < q
// (a position past the run reads 0xFFFFFFFF, which tests false as the end
// of the run does, so no key is reserved) and adds 2^l to r, after which
// rank lies in [r, r + 2^l).  The levels of steps >= 2^fs read fence m =
// run[((m + 1) << fs) - 1] at m = (r >> fs) + 2^(l - fs) - 1, fs chosen so
// that at most 2^kGcLogFences fences cover the run; then the 8 keys at
// [r, r + 8) (r a multiple of 8: one 32-byte sector, two 16-byte loads
// where the run is 16-byte aligned) give rank = r + #{those < q}, and the
// query is found where one of them equals it.
constexpr int kGcLogFences = 9;   // 512 fences, 2 KB of shared memory
constexpr int kGcLogWindow = 3;   // the finish's 8 keys
constexpr int kGcWindow = 1 << kGcLogWindow;

template <bool kVec>
__global__ void __launch_bounds__(kProbeThreads)
gc_lookup_kernel(const u32* __restrict__ q, i64 nq,
                 const u32* __restrict__ keys, const u32* __restrict__ vids,
                 const u32* __restrict__ vfiles, i64 n,
                 bool* __restrict__ found, u32* __restrict__ vid,
                 u32* __restrict__ vfile) {
  __shared__ u32 fence[1 << kGcLogFences];
  const i64 i = (i64)blockIdx.x * kProbeThreads + threadIdx.x;
  const u32 key = i < nq ? q[i] : 0u;     // issued before the staging
  int lg = n > 0 ? 63 - __clzll((long long)n) : -1;
  const int fs = lg + 1 - kGcLogFences > kGcLogWindow
                     ? lg + 1 - kGcLogFences : kGcLogWindow;
  const int nf = lg >= fs ? 2 << (lg - fs) : 0;
  for (int m = threadIdx.x; m < nf; m += kProbeThreads) {
    const i64 p = ((i64)(m + 1) << fs) - 1;
    fence[m] = p < n ? keys[p] : 0xFFFFFFFFu;
  }
  __syncthreads();
  if (i >= nq) return;
  u32 mi = 0;                                   // r >> fs
  for (; lg >= fs; --lg) {
    const u32 st = 1u << (lg - fs);
    if (fence[mi + st - 1] < key) mi += st;
  }
  i64 r = (i64)mi << fs;
  for (; lg >= kGcLogWindow; --lg) {
    const i64 p = r + ((i64)1 << lg) - 1;
    if ((p < n ? keys[p] : 0xFFFFFFFFu) < key) r += (i64)1 << lg;
  }
  u32 w[kGcWindow];
  if (kVec && r + kGcWindow <= n) {
#pragma unroll
    for (int v = 0; v < kGcWindow / 4; ++v) {
      const uint4 x = ((const uint4*)(keys + r))[v];
      w[4 * v] = x.x;
      w[4 * v + 1] = x.y;
      w[4 * v + 2] = x.z;
      w[4 * v + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kGcWindow; ++j)
      w[j] = r + j < n ? keys[r + j] : 0xFFFFFFFFu;
  }
  int c = 0;
  bool hit = false;
#pragma unroll
  for (int j = 0; j < kGcWindow; ++j) {
    c += w[j] < key;
    hit |= r + j < n && w[j] == key;
  }
  const i64 rank = r + c;
  found[i] = hit;
  vid[i] = hit ? vids[rank] : 0u;
  vfile[i] = hit ? vfiles[rank] : 0u;
}

// ---------------------------------------------------------------------------
// bloom_probe: replaces bloom_probe_pallas (src/repro/kernels/bloom/
// kernel.py:49).  h1 = mix32(q), h2 = mix32(q ^ MIX1) | 1; the query may
// be in the set when bit (h1 + j*h2) mod nbits is set for every j < k,
// h1 + j*h2 in wrapping u32 arithmetic (which u32 gives for free) before
// the modulo.
//
// Bound: L2 sectors.  Q queries x k independent 4-byte gathers from a
// filter of a few MB (L2-resident), each its own 32-byte sector: at the
// 1 GiB store's shape (65,536 queries, k 7, a 1.31 MB filter) 14.7 MB of
// L2 sector traffic against the 1.64 MB of bytes the bound counts.  The
// TPU kernel fetched each word by a one-hot multiply-reduce over the
// whole filter.  The first port ran one thread a query over a loop of k
// probes with a runtime `% nbits`: 4.89-4.96 us at that shape.  All k
// word loads of a query issued before the first test (a batch of 8) took
// 4.80-5.01 us: the time follows the sectors read (~3 TB/s of them), not
// the round trips.  Design: fewer sectors.  One thread a query tests its
// first two bits, then the rest in rounds of up to kBloomBatch only while
// every bit so far is set; a round's bit positions are computed first
// (the modulo a multiply by nbits' FastMod magic, not a division), its
// loads issued together, then its tests.  With the filter half full an
// absent key reads 2 + 5/4 sectors on average instead of 7.  Rounds that
// stop sooner (a first round of 1, then rounds of 1, 2 or 3) read fewer
// sectors and were 4-8% faster at 65,536 queries, but 6-35% slower at
// 1,024, where a round trip costs more than its sectors (8 CTAs); two
// queries a thread, loads from L2 only and CTAs of 32 to 512 threads lost
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6).
__device__ __forceinline__ u32 mix32(u32 x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

constexpr int kBloomThreads = 128;
constexpr int kBloomFirst = 2;      // words of the first round
constexpr int kBloomBatch = 8;      // words of each later round, at most

// Bits [j0, j0 + kN) of one query: every word load issued, then every
// test.  -> all of them set.
template <int kN>
__device__ __forceinline__ bool bloom_round(const u32* __restrict__ words,
                                            const FastMod& nb, u32 h1, u32 h2,
                                            i64 j0, i64 k) {
  u32 w[kN], sh[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if (j0 + j < k) {
      const u32 b = (u32)fast_mod(h1 + (u32)(j0 + j) * h2, nb);
      w[j] = words[b >> 5];
      sh[j] = b & 31u;
    }
  }
  bool all = true;
#pragma unroll
  for (int j = 0; j < kN; ++j)
    if (j0 + j < k) all &= ((w[j] >> sh[j]) & 1u) != 0;
  return all;
}

__global__ void __launch_bounds__(kBloomThreads)
bloom_probe_kernel(const u32* __restrict__ q, i64 nq,
                   const u32* __restrict__ words, FastMod nb, i64 k,
                   bool* __restrict__ out) {
  const i64 i = (i64)blockIdx.x * kBloomThreads + threadIdx.x;
  if (i >= nq) return;
  const u32 key = q[i];
  const u32 h1 = mix32(key), h2 = mix32(key ^ 0x85EBCA6Bu) | 1u;
  bool all = bloom_round<kBloomFirst>(words, nb, h1, h2, 0, k);
  for (i64 j0 = kBloomFirst; all && j0 < k; j0 += kBloomBatch)
    all = bloom_round<kBloomBatch>(words, nb, h1, h2, j0, k);
  out[i] = all;
}

// ---------------------------------------------------------------------------
// merge_dedup: replaces merge_dedup_pallas (src/repro/kernels/merge/
// kernel.py:49), with the contract of merge/ref.py: the rows of A then B
// in (key asc, seq desc) order, ties kept in input order (A first), and
// keep true where a row's key differs from the previous row's.
//
// Bound: bytes (12 B read and 13 B written a row: 25 MB, 7.8 us at
// 2 x 2^19).  The TPU kernel ran a bitonic merge network over power-of-two
// halves padded with key 0xFFFFFFFF.  The first port placed each row by a
// binary search of its co-rank in the other run (~19 dependent steps of
// two loads a row), scattered its three words to that position, and marked
// keep in a second launch that read the keys back: 4x its bound, the time
// in the search chains.  Design: a merge path in one launch.  The output
// is cut into tiles, one a CTA.  Two warps find where
// the tile's first row and the next tile's lie on the merge path (i rows
// of A and d - i of B before output row d), by a 32-way search: each lane
// tests one of 32 evenly spaced candidates, a ballot keeps the interval,
// so ~4 rounds of independent loads where a binary search makes 19
// dependent ones.  The CTA loads the tile's two input windows coalesced
// into shared memory, each thread merges kItems rows there from its
// own split of the tile (a binary search in shared memory), writing only
// each row's source index, and the CTA writes keys, seqs, vids and keep
// coalesced (kItems rows a thread, so a tile of kMergeThreads * kItems
// rows: the wrapper takes fewer for a short merge, to spread it over more
// SMs).  keep compares each row's key with the previous row's; the
// tile's first row with the row just before the tile, the later in merge
// order of A[i - 1] and B[d - i - 1].  No padding, no key reserved.  Rows
// are ordered by the packed u64 (key << 32 | ~seq), an A row before a B
// row that packs equal (the ties' input order): A[m] is among the first d
// rows iff A[m] <= B[d - m - 1].  Each run must already be in that order
// (the wrapper's precondition).
constexpr int kMergeThreads = 256;
constexpr int kMergeMaxItems = 8;              // rows a thread merges, at most
static_assert(kMergeThreads * kMergeMaxItems <= 65536,
              "source indices are u16");

__device__ __forceinline__ u64 merge_key(const u32* __restrict__ keys,
                                         const u32* __restrict__ seqs,
                                         i64 i) {
  return ((u64)keys[i] << 32) | (u64)(~seqs[i]);
}

__device__ __forceinline__ u64 smem_merge_key(const u32* keys,
                                              const u32* seqs, int i) {
  return ((u64)keys[i] << 32) | (u64)(~seqs[i]);
}

// #{A rows among the merge's first d rows}, by one warp (every lane gets
// it).  The predicate "A[m] is among them" holds for a prefix of m; the
// answer lies in [lo, hi], and a round probes 32 candidates spaced s
// apart, keeping the gap between the last true and the first false.
__device__ i64 merge_split(const u32* __restrict__ ak,
                           const u32* __restrict__ as, i64 na,
                           const u32* __restrict__ bk,
                           const u32* __restrict__ bs, i64 nb, i64 d) {
  i64 lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const i64 s = (hi - lo + 31) >> 5;
    const i64 m = lo + (lane + 1) * s - 1;
    const bool in = m < hi &&
                    merge_key(ak, as, m) <= merge_key(bk, bs, d - m - 1);
    const i64 c = __popc(__ballot_sync(0xffffffffu, in));
    const i64 first_out = lo + (c + 1) * s - 1;
    lo += c * s;
    if (first_out < hi) hi = first_out;
  }
  return lo;
}

template <int kItems>
__global__ void __launch_bounds__(kMergeThreads)
merge_path_kernel(const u32* __restrict__ ak, const u32* __restrict__ as,
                  const u32* __restrict__ av, i64 na,
                  const u32* __restrict__ bk, const u32* __restrict__ bs,
                  const u32* __restrict__ bv, i64 nb, u32* __restrict__ ok,
                  u32* __restrict__ os, u32* __restrict__ ov,
                  bool* __restrict__ keep) {
  constexpr int kTile = kMergeThreads * kItems;
  // the tile's A window at [0, la), its B window at [la, la + lb)
  __shared__ u32 sk[kTile], ss[kTile], sv[kTile];
  __shared__ uint16_t src[kTile];
  __shared__ i64 split[2];
  __shared__ u32 prev_key;
  const i64 n = na + nb;
  const i64 d0 = (i64)blockIdx.x * kTile;
  const i64 d1 = d0 + kTile < n ? d0 + kTile : n;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const i64 i = merge_split(ak, as, na, bk, bs, nb, warp ? d1 : d0);
    if ((threadIdx.x & 31) == 0) split[warp] = i;
  }
  __syncthreads();
  const i64 i0 = split[0], j0 = d0 - i0;
  const int la = (int)(split[1] - i0), cnt = (int)(d1 - d0);
  const int lb = cnt - la;
  if (threadIdx.x == 0 && d0 > 0) {    // the key of the row before the tile
    if (i0 == 0 || (j0 > 0 && merge_key(ak, as, i0 - 1) <=
                                  merge_key(bk, bs, j0 - 1)))
      prev_key = bk[j0 - 1];
    else
      prev_key = ak[i0 - 1];
  }
  {                                   // coalesced; the loads, then the stores
    u32 k[kItems], q[kItems], v[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int x = threadIdx.x + u * kMergeThreads;
      if (x < cnt) {
        const bool fromA = x < la;
        const i64 g = fromA ? i0 + x : j0 + (x - la);
        k[u] = fromA ? ak[g] : bk[g];
        q[u] = fromA ? as[g] : bs[g];
        v[u] = fromA ? av[g] : bv[g];
      }
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int x = threadIdx.x + u * kMergeThreads;
      if (x < cnt) {
        sk[x] = k[u];
        ss[x] = q[u];
        sv[x] = v[u];
      }
    }
  }
  __syncthreads();

  // this thread's kItems rows: its split of the tile, then the merge
  const int diag = min((int)threadIdx.x * kItems, cnt);
  const int end = min(diag + kItems, cnt);
  int lo = diag > lb ? diag - lb : 0, hi = diag < la ? diag : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (smem_merge_key(sk, ss, mid) <=
        smem_merge_key(sk, ss, la + diag - mid - 1)) lo = mid + 1;
    else hi = mid;
  }
  // A's next row ia < la and B's next row ib < cnt, each exhausted at its
  // end; a row's packed key is read when it becomes the next
  int ia = lo, ib = la + (diag - lo);
  u64 pa = ia < la ? smem_merge_key(sk, ss, ia) : 0;
  u64 pb = ib < cnt ? smem_merge_key(sk, ss, ib) : 0;
  for (int o = diag; o < end; ++o) {
    const bool takeA = ia < la && (ib >= cnt || pa <= pb);
    const int x = takeA ? ia : ib;
    src[o] = (uint16_t)x;
    const int next = x + 1;
    const u64 p = next < (takeA ? la : cnt) ? smem_merge_key(sk, ss, next)
                                            : 0;
    if (takeA) {
      ia = next;
      pa = p;
    } else {
      ib = next;
      pb = p;
    }
  }
  __syncthreads();

  for (int o = threadIdx.x; o < cnt; o += kMergeThreads) {
    const int x = src[o];
    const u32 key = sk[x];
    const i64 row = d0 + o;
    ok[row] = key;
    os[row] = ss[x];
    ov[row] = sv[x];
    keep[row] = row == 0 || key != (o == 0 ? prev_key : sk[src[o - 1]]);
  }
}

// ---------------------------------------------------------------------------
// hot_cold_partition: replaces hot_cold_partition_pallas (src/repro/
// kernels/partition/kernel.py:37), with the contract of partition/ref.py:
// a stable partition, hot records first, plus the hot count.
//
// Bound: bytes (13 B read and 12 B written a record: 25 MB, 7.83 us at
// N 2^20).  The TPU kernel bitonic-sorted (cold << log2 n | position) over
// a power-of-two padding.  The first port ran three launches (tile counts,
// one CTA scanning them, a scatter storing each record's three words
// straight to their place, a warp's stores two unaligned partial runs a
// column): 16.2-16.6 us at N 2^20 on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md §6 has the times since).  Design: two launches over tiles of
// kPartTile records.
// The first counts each tile's hot records, reading the mask 16 flags a
// thread.  In the second each CTA sums the tile counts itself (those
// before its tile give its hot offset, all of them n_hot), loads its
// tile's keys, vids and vsizes 16 bytes a thread into registers, compacts
// them stably in shared memory (hot first, each run in input order) and
// writes the hot run and the cold run coalesced, a warp over consecutive
// words.  The mask is read twice: 26 B a record against the bound's 25.
// The counts' read is quadratic: 4 * ntiles^2 bytes over the grid, from
// L2: 1 MB at N 2^20 (4% of the bytes moved), under 1% below N ~ 270,000
// and 15% at N 2^22.  Tiles of 2,048 records (24 KB of shared memory, four
// CTAs an SM) beat 4,096 to 16,384 (PERF.md §6).  kVec: the four operands
// are 16-byte aligned (the wrapper decides), else every load is scalar.

constexpr int kPartTile = 2048;      // records a tile (a CTA of the placement)
constexpr int kPartThreads = 512;    // threads a CTA of the placement
// the placement's CTAs an SM: 32 registers a thread, no spills; bounded
// to one CTA an SM the compiler took 64 and 7-8% more time at N 2^20, and
// to none 40, three CTAs an SM (PERF.md §6)
constexpr int kPartCtasPerSm = 2048 / kPartThreads;
constexpr int kPartCountThreads = kPartTile / 16;
constexpr int kPartItems = kPartTile / (4 * kPartThreads);
constexpr int kPartWarps = kPartThreads / 32;
// dynamic: the same arrays declared static took 11.2-11.4 us against
// 10.5-10.6 at N 2^20 (NVIDIA H100 80GB HBM3, 700 W, PERF.md §6); under the
// 48 KB that needs no opt-in
constexpr int kPartSmem = 3 * kPartTile * (int)sizeof(u32);
static_assert(kPartSmem <= 48 * 1024, "no opt-in needed");
static_assert(kPartItems >= 1 && kPartTile % (4 * kPartThreads) == 0,
              "whole items a thread");
static_assert(kPartCountThreads % 32 == 0 && kPartCountThreads <= 1024,
              "whole warps of 16 flags a thread");

// the top bit of each nonzero byte of w
__device__ __forceinline__ u32 nonzero_bytes(u32 w) {
  return (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
}

template <bool kVec>
__global__ void __launch_bounds__(kPartCountThreads)
partition_count_kernel(const bool* __restrict__ hot, i64 n,
                       u32* __restrict__ tile_hot) {
  __shared__ u32 warp_hot[kPartCountThreads / 32];
  const unsigned char* h = (const unsigned char*)hot;
  const i64 x = (i64)blockIdx.x * kPartTile + 16 * threadIdx.x;
  u32 c = 0;
  if (kVec && x + 16 <= n) {
    const uint4 v = *(const uint4*)(h + x);
    c = __popc(nonzero_bytes(v.x)) + __popc(nonzero_bytes(v.y)) +
        __popc(nonzero_bytes(v.z)) + __popc(nonzero_bytes(v.w));
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) c += x + j < n && h[x + j] != 0;
  }
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) warp_hot[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    u32 t = 0;
    for (int w = 0; w < kPartCountThreads / 32; ++w) t += warp_hot[w];
    tile_hot[blockIdx.x] = t;
  }
}

__device__ __forceinline__ i64 warp_sum64(i64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Record x of the tile (x = 4 * (u * kPartThreads + threadIdx.x) + j) is
// item u's j-th record of this thread; the tile's order is (u, warp, lane,
// j), so the hot records before it are the earlier (item, warp) pairs',
// then the earlier lanes' and its own earlier records'.
template <bool kVec>
__global__ void __launch_bounds__(kPartThreads, kPartCtasPerSm)
partition_place_kernel(const u32* __restrict__ keys,
                       const bool* __restrict__ hot,
                       const u32* __restrict__ vids,
                       const u32* __restrict__ vsizes, i64 n,
                       const u32* __restrict__ tile_hot, i64 ntiles,
                       i64* __restrict__ n_hot, u32* __restrict__ okeys,
                       u32* __restrict__ ovids, u32* __restrict__ ovsizes) {
  constexpr int kPairs = kPartItems * kPartWarps;
  constexpr int kPer = (kPairs + 31) / 32;
  extern __shared__ u32 part_smem[];   // the tile, compacted (kPartSmem)
  u32* sk = part_smem;
  u32* sv = sk + kPartTile;
  u32* ss = sv + kPartTile;
  __shared__ u32 pair_hot[kPairs];   // hot counts, then their offsets
  __shared__ i64 warp_off[2][kPartWarps];
  __shared__ i64 offs[3];            // the tile's hot offset, n_hot, hot count
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const i64 t0 = (i64)blockIdx.x * kPartTile;
  const int cnt = (int)(n - t0 < kPartTile ? n - t0 : kPartTile);
  const unsigned char* h = (const unsigned char*)hot + t0;

  // the records into registers, every load issued before any is used
  u32 k[kPartItems][4], v[kPartItems][4], z[kPartItems][4], f[kPartItems];
#pragma unroll
  for (int u = 0; u < kPartItems; ++u) {
    const int x = 4 * (u * kPartThreads + threadIdx.x);
    if (kVec && x + 4 <= cnt) {
      const uint4 a = *(const uint4*)(keys + t0 + x);
      const uint4 b = *(const uint4*)(vids + t0 + x);
      const uint4 c = *(const uint4*)(vsizes + t0 + x);
      k[u][0] = a.x; k[u][1] = a.y; k[u][2] = a.z; k[u][3] = a.w;
      v[u][0] = b.x; v[u][1] = b.y; v[u][2] = b.z; v[u][3] = b.w;
      z[u][0] = c.x; z[u][1] = c.y; z[u][2] = c.z; z[u][3] = c.w;
      f[u] = *(const u32*)(h + x);
    } else {
      f[u] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = x + j < cnt;
        k[u][j] = in ? keys[t0 + x + j] : 0u;
        v[u][j] = in ? vids[t0 + x + j] : 0u;
        z[u][j] = in ? vsizes[t0 + x + j] : 0u;
        f[u] |= (u32)(in && h[x + j] != 0) << (8 * j);
      }
    }
  }

  // the hot records before this tile, and in all
  i64 before = 0, total = 0;
  for (i64 j = threadIdx.x; j < ntiles; j += kPartThreads) {
    const u32 c = tile_hot[j];
    total += c;
    if (j < (i64)blockIdx.x) before += c;
  }
  before = warp_sum64(before);
  total = warp_sum64(total);
  if (lane == 0) {
    warp_off[0][warp] = before;
    warp_off[1][warp] = total;
  }

  // each record's hot rank in the tile
  u32 hb[kPartItems], incl[kPartItems];
#pragma unroll
  for (int u = 0; u < kPartItems; ++u) {
    hb[u] = nonzero_bytes(f[u]);
    incl[u] = warp_inclusive_sum(__popc(hb[u]));
    if (lane == 31) pair_hot[u * kPartWarps + warp] = incl[u];
  }
  __syncthreads();
  if (warp == 0) {
    u32 c[kPer], sum = 0;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int idx = lane * kPer + p;
      c[p] = idx < kPairs ? pair_hot[idx] : 0u;
      sum += c[p];
    }
    const u32 inc = warp_inclusive_sum(sum);
    u32 run = inc - sum;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int idx = lane * kPer + p;
      if (idx < kPairs) pair_hot[idx] = run;
      run += c[p];
    }
    const i64 b = warp_sum64(lane < kPartWarps ? warp_off[0][lane] : 0);
    const i64 t = warp_sum64(lane < kPartWarps ? warp_off[1][lane] : 0);
    if (lane == 31) {
      offs[0] = b;
      offs[1] = t;
      offs[2] = inc;
    }
  }
  __syncthreads();

  // stable compaction into shared memory: hot at [0, th), cold after
  const int th = (int)offs[2];
#pragma unroll
  for (int u = 0; u < kPartItems; ++u) {
    const int base = (int)(pair_hot[u * kPartWarps + warp] + incl[u]) -
                     __popc(hb[u]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = 4 * (u * kPartThreads + threadIdx.x) + j;
      if (x < cnt) {
        const int hp = base + __popc(hb[u] & ((1u << (8 * j)) - 1u));
        const int pos = (hb[u] >> (8 * j + 7)) & 1u ? hp : th + x - hp;
        sk[pos] = k[u][j];
        sv[pos] = v[u][j];
        ss[pos] = z[u][j];
      }
    }
  }
  __syncthreads();

  // the hot run to [hot_off, hot_off + th), the cold run after n_hot
  const i64 hot_off = offs[0], nh = offs[1];
  const i64 cold0 = nh + t0 - hot_off - th;
  for (int p = threadIdx.x; p < cnt; p += kPartThreads) {
    const i64 dst = p < th ? hot_off + p : cold0 + p;
    okeys[dst] = sk[p];
    ovids[dst] = sv[p];
    ovsizes[dst] = ss[p];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *n_hot = nh;
}

// ---------------------------------------------------------------------------
// page_gather: replaces page_gather_pallas (src/repro/kernels/paged_gather/
// kernel.py:30).  Output page (b, p) is a copy of pool page table[b, p];
// both are page_bytes contiguous bytes, so the kernel is dtype-blind.
//
// Bound: bytes (each gathered page read once, the output written once).
// The TPU kernel let scalar-prefetched indices drive its block index map;
// here one CTA per output page reads its own table entry and copies the
// page with 16-byte vector loads where the page size and the base
// addresses allow (the wrapper decides), else byte by byte.
template <typename V>
__global__ void __launch_bounds__(kCopyThreads)
page_gather_kernel(const int32_t* __restrict__ table,
                   const unsigned char* __restrict__ pages, i64 page_bytes,
                   unsigned char* __restrict__ out) {
  const i64 slot = blockIdx.x;
  const V* src = (const V*)(pages + (i64)table[slot] * page_bytes);
  V* dst = (V*)(out + slot * page_bytes);
  const i64 n = page_bytes / (i64)sizeof(V);
  for (i64 t = threadIdx.x; t < n; t += blockDim.x) dst[t] = src[t];
}

// One merge_dedup launch at kItems rows a thread.
template <int kItems>
cudaError_t merge_launch(const void* ak, const void* as, const void* av,
                         i64 na, const void* bk, const void* bs,
                         const void* bv, i64 nb, void* ok, void* os,
                         void* ov, void* keep, cudaStream_t stream) {
  merge_path_kernel<kItems><<<blocks_for(na + nb, kMergeThreads * kItems),
                              kMergeThreads, 0, stream>>>(
      (const u32*)ak, (const u32*)as, (const u32*)av, na, (const u32*)bk,
      (const u32*)bs, (const u32*)bv, nb, (u32*)ok, (u32*)os, (u32*)ov,
      (bool*)keep);
  return cudaGetLastError();
}

// The partition's two launches.
template <bool kVec>
cudaError_t partition_launch(const void* keys, const void* hot,
                             const void* vids, const void* vsizes, i64 n,
                             void* scratch, void* okeys, void* ovids,
                             void* ovsizes, void* n_hot, cudaStream_t st) {
  const i64 ntiles = (n + kPartTile - 1) / kPartTile;
  partition_count_kernel<kVec><<<(unsigned)ntiles, kPartCountThreads, 0,
                                 st>>>((const bool*)hot, n, (u32*)scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  partition_place_kernel<kVec><<<(unsigned)ntiles, kPartThreads, kPartSmem,
                                 st>>>(
      (const u32*)keys, (const bool*)hot, (const u32*)vids,
      (const u32*)vsizes, n, (const u32*)scratch, ntiles, (i64*)n_hot,
      (u32*)okeys, (u32*)ovids, (u32*)ovsizes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* scav_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Pairs run_coalesce sorts in shared memory; a longer column needs scratch.
i64 scav_smem_sort_cap() { return kSmemSortCap; }

// Wait for the work queued on `stream` (the results' copies to the host).
int scav_stream_sync(void* stream) {
  return (int)cudaStreamSynchronize((cudaStream_t)stream);
}

// The run form; shift: log2 of the fence stride (the kernel widens it for
// a run of more than kMaxFences fences), negative to search the run in
// device memory (rank_search_kernel); tile: threads a CTA (<= 1024).
// Shared memory of rank_probe_kernel's fences for runs of at most nmax
// keys at stride 2^shift (widened, as the kernel does, to kMaxFences).
static size_t fence_bytes(i64 nmax, i64 shift) {
  const i64 nf = (nmax + (1ll << shift) - 1) >> shift;
  return (size_t)(nf < kMaxFences ? nf : kMaxFences) * sizeof(u64);
}

int rank_probe(const void* q, i64 nq, const void* run, i64 n, void* found,
               void* rank, i64 shift, i64 tile, void* stream) {
  if (shift < 0) {
    rank_search_kernel<<<blocks_for(nq, (int)tile), (unsigned)tile, 0,
                         (cudaStream_t)stream>>>(
        (const u64*)q, nq, (const u64*)run, n, (bool*)found, (i64*)rank);
    return (int)cudaGetLastError();
  }
  ProbeTile one = {};
  one.run = (const u64*)run;
  one.n = n;
  one.count = nq;
  rank_probe_kernel<false><<<blocks_for(nq, (int)tile), (unsigned)tile,
                             fence_bytes(n, shift), (cudaStream_t)stream>>>(
      (const u64*)q, nullptr, one, (int)shift, (bool*)found, (i64*)rank,
      nullptr);
  return (int)cudaGetLastError();
}

// The segmented form.  tiles: ntiles ProbeTiles (kTileWords i64 each, no
// filter; words the run's values or null), on the card, each reading keys
// [row, row + count); nmax: the longest run; tile: threads a CTA
// (<= 1024); shift: log2 of the fence stride (>= 0, widened as for the
// run form); val: the values at the keys found, or null for none.
int rank_probe_segments(const void* keys, i64 nkeys, const void* tiles,
                        i64 ntiles, i64 nmax, i64 tile, i64 shift,
                        void* found, void* rank, void* val, void* stream) {
  const ProbeTile none = {};
  rank_probe_kernel<true><<<(unsigned)ntiles, (unsigned)tile,
                            fence_bytes(nmax, shift),
                            (cudaStream_t)stream>>>(
      (const u64*)keys, (const ProbeTile*)tiles, none, (int)shift,
      (bool*)found, (i64*)rank, (i64*)val);
  return (int)cudaGetLastError();
}

// The table form: one sorted run, bit_idx nq x k given; shift: log2 of the
// fence stride.
int lookup_probe(const void* q, i64 nq, const void* run, i64 n,
                 const void* bit_idx, i64 k, const void* words, void* may,
                 void* found, void* rank, i64 shift, void* stream) {
  ProbeTile one = {};
  one.run = (const u64*)run;
  one.n = n;
  one.words = (const u64*)words;
  one.count = nq;
  lookup_probe_kernel<false><<<blocks_for(nq, kProbeThreads), kProbeThreads,
                               0, (cudaStream_t)stream>>>(
      (const u64*)q, nq, (const u64*)bit_idx, k, nullptr, 0, one,
      (int)shift, (bool*)may, (bool*)found, (i64*)rank);
  return (int)cudaGetLastError();
}

// The level form.  plan: nrows row indices into keys, then ntiles
// ProbeTiles (kTileWords i64 each), on the card; kraw: k x nkeys raw
// hashes; tile: threads a CTA (>= every tile's count, <= 1024); shift:
// log2 of the fence stride.
int lookup_probe_level(const void* keys, i64 nkeys, const void* kraw, i64 k,
                       const void* plan, i64 nrows, i64 ntiles, i64 tile,
                       i64 shift, void* may, void* found, void* rank,
                       void* stream) {
  const ProbeTile none = {};
  lookup_probe_kernel<true><<<(unsigned)ntiles, (unsigned)tile, 0,
                              (cudaStream_t)stream>>>(
      (const u64*)keys, nkeys, (const u64*)kraw, k, (const i64*)plan, nrows,
      none, (int)shift, (bool*)may, (bool*)found, (i64*)rank);
  return (int)cudaGetLastError();
}

// i64 words a plan tile takes (the wrapper's layout check)
i64 scav_probe_tile_words() { return kTileWords; }

// interval != 0: write interval_rank over the n files' [mins, maxs] (maxs
// is read only then; an empty column may have a null pointer).
int count_le(const void* q, i64 nq, const void* mins, i64 n, const void* maxs,
             i64 interval, void* cnt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n >= kCountLeSmemMinFiles && n <= kCountLeSmemFiles) {
    const size_t smem = (size_t)n * sizeof(u64) * (interval ? 2 : 1);
    count_le_kernel<true><<<blocks_for(nq, kProbeThreads), kProbeThreads,
                            smem, st>>>(
        (const u64*)q, nq, (const u64*)mins, n, (const u64*)maxs,
        interval != 0, (i64*)cnt);
  } else {
    count_le_kernel<false><<<blocks_for(nq, kProbeThreads), kProbeThreads,
                             0, st>>>(
        (const u64*)q, nq, (const u64*)mins, n, (const u64*)maxs,
        interval != 0, (i64*)cnt);
  }
  return (int)cudaGetLastError();
}

// The most files whose bounds count_le stages in shared memory; a larger
// level searches them in global memory.
i64 scav_count_le_smem_files() { return kCountLeSmemFiles; }

// mp: the power of two >= max(m, 2); scratch: mp u64 of device memory when
// mp > kSmemSortCap, else unused.  m >= 1.
int run_coalesce(const void* rank, const void* pos, i64 m, i64 mp,
                 void* scratch, i64 window, void* rank_s, void* pos_s,
                 void* keep, void* start, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mp <= kSmemSortCap) {
    cudaError_t err = coalesce_smem_opt_in();
    if (err != cudaSuccess) return (int)err;
    const int smem = (int)(m * sizeof(u64)) + kCountBytes;
    coalesce_radix_kernel<<<1, kCoalesceThreads, smem, st>>>(
        (const i64*)rank, (const i64*)pos, (int)m, window, (i64*)rank_s,
        (i64*)pos_s, (bool*)keep, (bool*)start);
    return (int)cudaGetLastError();
  }
  u64* s = (u64*)scratch;
  pack_kernel<<<blocks_for(mp, kProbeThreads), kProbeThreads, 0, st>>>(
      (const i64*)rank, (const i64*)pos, m, mp, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (i64 k = 2; k <= mp; k <<= 1) {
    for (i64 j = k >> 1; j > 0; j >>= 1) {
      bitonic_stage_kernel<<<blocks_for(mp / 2, kProbeThreads), kProbeThreads,
                             0, st>>>(s, mp, j, k);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  mark_kernel<<<1, kCoalesceThreads, 0, st>>>(
      s, m, window, (i64*)rank_s, (i64*)pos_s, (bool*)keep, (bool*)start);
  return (int)cudaGetLastError();
}

// counts: d x w float64 (d, w >= 1); keys nq u64 patterns; seeds d;
// (wm, wl): w's FastMod magic; scaled != 0: multiply every counter by
// scale first; scratch: d * w zeroed u32 (left zero).
int sketch_add(void* counts, i64 d, i64 w, i64 wm, i64 wl, const void* keys,
               i64 nq, const void* seeds, i64 scaled, double scale,
               void* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const FastMod m = {(u64)w, (u64)wm, wl};
  const i64 n = d * w;
  double* c = (double*)counts;
  if (nq == 0 && !scaled) return 0;
  if (nq == 0) {
    sketch_scale_kernel<<<blocks_for(n, kProbeThreads), kProbeThreads, 0,
                          st>>>(c, n, scale);
    return (int)cudaGetLastError();
  }
  const i64 n_scale = scaled ? n : 0;   // the count launch scales first
  const dim3 count_grid(blocks_for(nq > n_scale ? nq : n_scale,
                                   kProbeThreads), (unsigned)d);
  sketch_scratch_kernel<false><<<count_grid, kProbeThreads, 0, st>>>(
      c, w, m, (const u64*)keys, nq, (const u64*)seeds, (u32*)scratch,
      n_scale, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(blocks_for(nq, kProbeThreads), (unsigned)d);
  sketch_scratch_kernel<true><<<grid, kProbeThreads, 0, st>>>(
      c, w, m, (const u64*)keys, nq, (const u64*)seeds, (u32*)scratch, 0,
      1.0);
  return (int)cudaGetLastError();
}

// n_slots >= 1 int64 counters, every one written: by one launch, or past
// kSegMaxIds ids or kSegMaxSlots slots (with any ids) by a memset and one
// launch of the atomic form.
int segment_sum(const void* ids, i64 n, i64 n_slots, void* out,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n > kSegMaxIds || (n > 0 && n_slots > kSegMaxSlots)) {
    cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n_slots * sizeof(u64),
                                      st);
    if (err != cudaSuccess) return (int)err;
    segment_atomic_kernel<<<blocks_for(n, kProbeThreads), kProbeThreads, 0,
                            st>>>((const i64*)ids, n, n_slots, (u64*)out);
    return (int)cudaGetLastError();
  }
  segment_sum_kernel<<<blocks_for(n_slots, (int)kSegRange), kSegThreads, 0,
                       st>>>((const i64*)ids, n, n_slots, (u64*)out);
  return (int)cudaGetLastError();
}

// bits: d x w row-major 64-bit patterns (d >= 1); idx: nq x d.
int gather_min64(const void* bits, i64 d, i64 w, const void* idx, i64 nq,
                 void* out, void* stream) {
  const FastMod none = {1, 1, 0};
  gather_min64_kernel<false><<<blocks_for(nq, kProbeThreads), kProbeThreads,
                               0, (cudaStream_t)stream>>>(
      (const u64*)bits, d, w, (const i64*)idx, nullptr, nullptr, none, nq,
      (u64*)out);
  return (int)cudaGetLastError();
}

// The key form: keys nq u64 patterns, seeds d, w >= 1 with its FastMod
// magic (wm, wl).
int sketch_estimate(const void* bits, i64 d, i64 w, i64 wm, i64 wl,
                    const void* keys, const void* seeds, i64 nq, void* out,
                    void* stream) {
  const FastMod m = {(u64)w, (u64)wm, wl};
  gather_min64_kernel<true><<<blocks_for(nq, kProbeThreads), kProbeThreads,
                              0, (cudaStream_t)stream>>>(
      (const u64*)bits, d, w, nullptr, (const u64*)keys, (const u64*)seeds,
      m, nq, (u64*)out);
  return (int)cudaGetLastError();
}

// vec16 != 0 when keys is 16-byte aligned.
int gc_lookup(const void* q, i64 nq, const void* keys, const void* vids,
              const void* vfiles, i64 n, void* found, void* vid, void* vfile,
              i64 vec16, void* stream) {
  const unsigned grid = blocks_for(nq, kProbeThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec16)
    gc_lookup_kernel<true><<<grid, kProbeThreads, 0, st>>>(
        (const u32*)q, nq, (const u32*)keys, (const u32*)vids,
        (const u32*)vfiles, n, (bool*)found, (u32*)vid, (u32*)vfile);
  else
    gc_lookup_kernel<false><<<grid, kProbeThreads, 0, st>>>(
        (const u32*)q, nq, (const u32*)keys, (const u32*)vids,
        (const u32*)vfiles, n, (bool*)found, (u32*)vid, (u32*)vfile);
  return (int)cudaGetLastError();
}

// nbits in [1, 2^32) with its FastMod magic (nbm, nbl); words holds at
// least ceil(nbits / 32) words.
int bloom_probe(const void* q, i64 nq, const void* words, i64 nbits,
                i64 nbm, i64 nbl, i64 k, void* out, void* stream) {
  const FastMod nb = {(u64)nbits, (u64)nbm, nbl};
  bloom_probe_kernel<<<blocks_for(nq, kBloomThreads), kBloomThreads, 0,
                       (cudaStream_t)stream>>>(
      (const u32*)q, nq, (const u32*)words, nb, k, (bool*)out);
  return (int)cudaGetLastError();
}

// Slots a CTA of the segment_sum index form at the tracker's size.
i64 scav_segment_range() { return kSegRange; }

// Threads a CTA of the merge (a tile is items of them a thread).
i64 scav_merge_threads() { return kMergeThreads; }

// na + nb >= 1; items: rows a thread merges, 1 or 8.  One launch:
// a CTA a tile of kMergeThreads * items output rows.
int merge_dedup(const void* ak, const void* as, const void* av, i64 na,
                const void* bk, const void* bs, const void* bv, i64 nb,
                void* ok, void* os, void* ov, void* keep, i64 items,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (items) {
    case 1: return (int)merge_launch<1>(ak, as, av, na, bk, bs, bv, nb, ok,
                                        os, ov, keep, st);
    case kMergeMaxItems:
      return (int)merge_launch<kMergeMaxItems>(ak, as, av, na, bk, bs, bv,
                                               nb, ok, os, ov, keep, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Records per tile of the partition; scratch holds one uint32 per tile.
i64 scav_partition_tile() { return kPartTile; }

// n >= 1; scratch: ceil(n / kPartTile) uint32; n_hot: one int64; vec16
// != 0 when keys, hot, vids and vsizes are 16-byte aligned.
int hot_cold_partition(const void* keys, const void* hot, const void* vids,
                       const void* vsizes, i64 n, void* scratch, void* okeys,
                       void* ovids, void* ovsizes, void* n_hot, i64 vec16,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(vec16 ? partition_launch<true>(keys, hot, vids, vsizes, n,
                                              scratch, okeys, ovids, ovsizes,
                                              n_hot, st)
                     : partition_launch<false>(keys, hot, vids, vsizes, n,
                                               scratch, okeys, ovids,
                                               ovsizes, n_hot, st));
}

// slots = B * P >= 1 output pages; table entries already checked to lie in
// [0, N) by the wrapper; vec16 != 0 when page_bytes and both base
// addresses are multiples of 16.
int page_gather(const void* table, i64 slots, const void* pages,
                i64 page_bytes, i64 vec16, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (vec16) {
    page_gather_kernel<uint4><<<(unsigned)slots, kCopyThreads, 0, st>>>(
        (const int32_t*)table, (const unsigned char*)pages, page_bytes,
        (unsigned char*)out);
  } else {
    page_gather_kernel<unsigned char><<<(unsigned)slots, kCopyThreads, 0,
                                        st>>>(
        (const int32_t*)table, (const unsigned char*)pages, page_bytes,
        (unsigned char*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
