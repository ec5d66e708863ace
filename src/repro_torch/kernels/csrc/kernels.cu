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
// thread per query running a binary search over the run in global memory.

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;
typedef long long i64;

namespace {

constexpr int kProbeThreads = 256;
constexpr int kCoalesceThreads = 1024;
// pairs sorted inside one CTA's shared memory (8 B each: 64 KB dynamic
// shared memory, above the 48 KB default, so the opt-in attribute is set);
// the wrapper reads it through scav_smem_sort_cap()
constexpr i64 kSmemSortCap = 8192;

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
// rank_probe: replaces rank_probe_pallas (src/repro/kernels/lookup_probe/
// kernel.py:134).  found = run[rank] == q, rank = #{run < q}.
//
// Bound: latency.  Each query is ~log2(N) dependent loads; the work moves
// only 8 B in and 9 B out per query, so the bytes bound is far below the
// time of one chain of dependent L2 hits.  Design: one thread per query so
// the chains of all queries overlap; the run (a few hundred KB at most per
// table) stays L2-resident across the queries that share its top levels.
__global__ void rank_probe_kernel(const u64* __restrict__ q, i64 nq,
                                  const u64* __restrict__ run, i64 n,
                                  bool* __restrict__ found,
                                  i64* __restrict__ rank) {
  i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  u64 key = q[i];
  i64 r = lower_bound(run, n, key);
  rank[i] = r;
  found[i] = r < n && run[r] == key;
}

// ---------------------------------------------------------------------------
// lookup_probe: replaces lookup_probe_pallas (lookup_probe/kernel.py:102).
// may = AND over the query's k filter bits (bit b of the u64 word array is
// (w[b >> 6] >> (b & 63)) & 1, the same bit the reference reads through a
// little-endian u32 view), plus rank_probe's found and rank.
//
// Bound: latency, as rank_probe, plus k independent word gathers per
// query that issue together ahead of the search.  Design: the bloom test
// and the search share one thread, so a query's filter words and run
// entries are fetched in one pass with no intermediate in memory.
__global__ void lookup_probe_kernel(const u64* __restrict__ q, i64 nq,
                                    const u64* __restrict__ run, i64 n,
                                    const u64* __restrict__ bit_idx, i64 k,
                                    const u64* __restrict__ words,
                                    bool* __restrict__ may,
                                    bool* __restrict__ found,
                                    i64* __restrict__ rank) {
  i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const u64* bits = bit_idx + i * k;
  bool all = true;
  for (i64 j = 0; j < k; ++j) {
    u64 b = bits[j];
    all &= ((words[b >> 6] >> (b & 63)) & 1ull) != 0;
  }
  may[i] = all;
  u64 key = q[i];
  i64 r = lower_bound(run, n, key);
  rank[i] = r;
  found[i] = r < n && run[r] == key;
}

// ---------------------------------------------------------------------------
// count_le: replaces count_le_pallas (lookup_probe/kernel.py:158).
// cnt = #{mins <= q} (searchsorted side='right') over a level's file mins.
// With `interval` set it writes interval_rank instead, the index of the
// file whose [min, max] covers q or -1: cnt - 1 when q <= maxs[cnt - 1],
// else -1.
//
// Bound: latency; a level holds at most a few hundred files, so each
// query's search is ~8 dependent loads of one L1/L2-resident line set.
// Design: one thread per query; the interval check runs on the same
// thread, so the level file assignment is one launch and no follow-up
// elementwise passes.
__global__ void count_le_kernel(const u64* __restrict__ q, i64 nq,
                                const u64* __restrict__ mins, i64 n,
                                const u64* __restrict__ maxs, bool interval,
                                i64* __restrict__ cnt) {
  i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  u64 key = q[i];
  i64 c = upper_bound(mins, n, key);
  if (interval) c = (c > 0 && key <= maxs[c - 1]) ? c - 1 : -1;
  cnt[i] = c;
}

// ---------------------------------------------------------------------------
// run_coalesce: replaces run_coalesce_pallas (run_coalesce/kernel.py:47).
// Sort the (file-rank, pos) pairs lexicographically, keep the first of
// each duplicate, and start a run at a file change, at a position gap > 1,
// and (window > 0) every `window` kept records since the run's start.
//
// Bound: latency and synchronisation.  M is one multi_get's fetch count
// (a few thousand pairs, 8 B each), so the bytes bound is well under a
// microsecond; the bitonic network's log2(M)*(log2(M)+1)/2 barrier-separated
// stages and the serial chunks of the scan set the time.  Design: each pair
// packs into one u64 (rank << 32 | pos), so the lexicographic order is the
// integer order and one compare-exchange moves both fields.  Up to
// kSmemSortCap pairs sort in one CTA's shared memory and the marks follow
// in the same CTA, so the column makes one round trip to device memory.
// Longer columns sort in global memory, one launch per network stage, and
// a one-CTA pass marks them.  Padding is all-ones, sorts after every real
// pair (ranks < 2^32 - 1), and is never written out.

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

__global__ void __launch_bounds__(kCoalesceThreads)
coalesce_smem_kernel(const i64* __restrict__ rank, const i64* __restrict__ pos,
                     i64 m, i64 mp, i64 window, i64* __restrict__ rank_s,
                     i64* __restrict__ pos_s, bool* __restrict__ keep,
                     bool* __restrict__ start) {
  extern __shared__ u64 s[];
  for (i64 t = threadIdx.x; t < mp; t += blockDim.x)
    s[t] = pack_pair(rank, pos, m, t);
  __syncthreads();
  for (i64 k = 2; k <= mp; k <<= 1) {
    for (i64 j = k >> 1; j > 0; j >>= 1) {
      for (i64 t = threadIdx.x; t < mp / 2; t += blockDim.x)
        compare_exchange(s, t, j, k);
      __syncthreads();
    }
  }
  mark_runs(s, m, window, rank_s, pos_s, keep, start);
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
// Bound: latency.  The adaptive tracker's batches are a few thousand ids
// into a few thousand to 32K slots (64-256 KB), so the bytes bound is
// well under a microsecond and one launch plus one memset set the time.
// The TPU kernel one-hot-compared every id against every slot tile (no
// vector scatter-add there); here each thread adds its id's one into the
// zeroed output with a 64-bit atomicAdd.  Integer adds commute, so the
// counts are exact whatever order the atomics land in.
__global__ void segment_sum_kernel(const i64* __restrict__ ids, i64 n,
                                   i64 n_slots, u64* __restrict__ out) {
  i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  i64 s = ids[i];
  if (s >= 0 && s < n_slots) atomicAdd(&out[s], 1ull);
}

// ---------------------------------------------------------------------------
// gather_min64: replaces gather_min64_pallas (segment_reduce/kernel.py:93).
// out[q] = min over rows r of bits[r, idx[q, r]], the count-min estimate
// of the adaptive sketch.  The float64 counters arrive as their 64-bit
// patterns and are compared as unsigned integers: that order is exactly
// the reference's lexicographic (hi, lo) u32 compare, for every pattern
// (for the sketch's non-negative doubles it is also the numeric order,
// and unlike fmin it never picks between +0 and -0).  An index outside
// [0, w) fetches the pattern 0.
//
// Bound: latency.  Q queries x D (<= 4) dependent-free gathers from a
// D x W table of at most a few hundred KB, L2-resident.  Design: one thread
// per query; the D gathers issue back to back and reduce in registers.
__global__ void gather_min64_kernel(const u64* __restrict__ bits, i64 d,
                                    i64 w, const i64* __restrict__ idx,
                                    i64 nq, u64* __restrict__ out) {
  i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const i64* row = idx + i * d;
  u64 best = ~0ull;
  for (i64 r = 0; r < d; ++r) {
    i64 j = row[r];
    u64 v = (j >= 0 && j < w) ? bits[r * w + j] : 0ull;
    best = v < best ? v : best;
  }
  out[i] = best;
}

inline unsigned blocks_for(i64 n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
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

int rank_probe(const void* q, i64 nq, const void* run, i64 n, void* found,
               void* rank, void* stream) {
  rank_probe_kernel<<<blocks_for(nq, kProbeThreads), kProbeThreads, 0,
                      (cudaStream_t)stream>>>(
      (const u64*)q, nq, (const u64*)run, n, (bool*)found, (i64*)rank);
  return (int)cudaGetLastError();
}

int lookup_probe(const void* q, i64 nq, const void* run, i64 n,
                 const void* bit_idx, i64 k, const void* words, void* may,
                 void* found, void* rank, void* stream) {
  lookup_probe_kernel<<<blocks_for(nq, kProbeThreads), kProbeThreads, 0,
                        (cudaStream_t)stream>>>(
      (const u64*)q, nq, (const u64*)run, n, (const u64*)bit_idx, k,
      (const u64*)words, (bool*)may, (bool*)found, (i64*)rank);
  return (int)cudaGetLastError();
}

// interval != 0: write interval_rank over the n files' [mins, maxs] (maxs
// is read only then; an empty column may have a null pointer).
int count_le(const void* q, i64 nq, const void* mins, i64 n, const void* maxs,
             i64 interval, void* cnt, void* stream) {
  count_le_kernel<<<blocks_for(nq, kProbeThreads), kProbeThreads, 0,
                    (cudaStream_t)stream>>>(
      (const u64*)q, nq, (const u64*)mins, n, (const u64*)maxs,
      interval != 0, (i64*)cnt);
  return (int)cudaGetLastError();
}

// mp: the power of two >= max(m, 2); scratch: mp u64 of device memory when
// mp > kSmemSortCap, else unused.
int run_coalesce(const void* rank, const void* pos, i64 m, i64 mp,
                 void* scratch, i64 window, void* rank_s, void* pos_s,
                 void* keep, void* start, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mp <= kSmemSortCap) {
    const int smem = (int)(mp * sizeof(u64));
    cudaError_t err = cudaFuncSetAttribute(
        coalesce_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(kSmemSortCap * sizeof(u64)));
    if (err != cudaSuccess) return (int)err;
    coalesce_smem_kernel<<<1, kCoalesceThreads, smem, st>>>(
        (const i64*)rank, (const i64*)pos, m, mp, window, (i64*)rank_s,
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

// out: n_slots int64 counters, zeroed here on the stream before the adds.
int segment_sum(const void* ids, i64 n, i64 n_slots, void* out,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n_slots * sizeof(u64),
                                    st);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaGetLastError();
  segment_sum_kernel<<<blocks_for(n, kProbeThreads), kProbeThreads, 0, st>>>(
      (const i64*)ids, n, n_slots, (u64*)out);
  return (int)cudaGetLastError();
}

// bits: d x w row-major 64-bit patterns (d >= 1); idx: nq x d.
int gather_min64(const void* bits, i64 d, i64 w, const void* idx, i64 nq,
                 void* out, void* stream) {
  gather_min64_kernel<<<blocks_for(nq, kProbeThreads), kProbeThreads, 0,
                        (cudaStream_t)stream>>>(
      (const u64*)bits, d, w, (const i64*)idx, nq, (u64*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
