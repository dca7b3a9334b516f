// SharedMatrix cell-table merge (LWW / FWW) for Hopper (sm_90a).
//
// Replaces two XLA programs of the JAX package:
// ``apply_cells_prefix_jit`` (fluidframework_tpu/ops/matrix_kernel.py:164;
// prefix mode: only table[0, L) takes part) and ``apply_cells_batch_jit``
// (:98; full mode: the whole table). The table is key-sorted with unique
// live keys and an EMPTY tail (key INT32_MAX); a batch of O sequenced
// set-cell ops (key, seq, value), EMPTY-padded, is merged into it: sort the
// batch by (key, seq), merge it with the table (prefix mode: on equal keys
// the table first; full mode: by (key, seq), the table first on a tie),
// keep the winner of each key run (LWW: the last; FWW: the first), EMPTY
// excluded, and write the first min(live, Lt) winners to table[0, Lt)
// with EMPTY / 0 / 0 after them (Lt = L or T). table[L, T) is untouched in
// prefix mode. count = min(live, T); overflow is set (sticky) when
// live > Lt.
//
// What bounds it. Bytes: the live cells read once before and written once
// after and the batch read once — config #3's last full merge (371,278
// live in, 412,288 out, O = 65,536) about 10.2 MB, ≈ 3.0 µs at 3.35 TB/s;
// the store's last prefix merge (L = 2^19, O = 4,096, about 410 K live)
// about 9.9 MB, ≈ 3.0 µs. At these sizes the launches and the serial
// latency of each step count as much as the bytes.
//
// What the design does (reading and rewriting the whole prefix [0, Lt),
// a merged copy of table and batch in device memory and 6 to 11 launches
// with a one-CTA scan cost 24-38× the bound).
// 1. The live extent only. The kernel reads ``count`` on the device: the
//    table's live cells are [0, E) with E = min(count, Lt), and past E the
//    table is EMPTY / 0 / 0 (every merge and every restore leaves it so).
//    Only [0, E) is read, and only [E_new, E) (E_new = min(live, Lt)) is
//    cleared afterwards; the EMPTY tail is neither read nor written.
// 2. The batch sort. O <= 4,096 (every store-route chunk): ``rank_sort``,
//    one launch of O / 32 CTAs of 32 warps; every CTA stages the whole
//    batch in shared memory ((key, seq) as one 64-bit key, and the value)
//    and each warp counts the elements before one of its own (value, then
//    index, only on a (key, seq) tie) and writes it at that rank: O^2
//    compares spread over the card, no rounds and no barrier but one. A
//    larger batch: ``sort_tiles`` (one CTA sorts 4,096 elements in shared
//    memory: 8 a thread in registers, then 9 rounds of merge-path merges)
//    and ``merge_pass`` (merge path, 2,048 outputs a CTA), one pass per
//    doubling from 4,096.
// 3. The merge. ``merge_table``: CTA t takes merged positions
//    [2048 t, 2048 (t+1)) of table[0, E) + sorted batch; one warp finds
//    each end by a 32-way merge-path search in device memory (3-4 probes
//    deep), the CTA stages its table and batch slices in shared memory,
//    merges them there, marks winners against the next merged element (one
//    halo element read past the slice; in FWW mode a CTA decides the
//    positions (start, end] so that it never needs the element before its
//    slice), compacts them with a block scan and takes its output offset
//    from a single-pass scan across CTAs (decoupled look-back). No merged
//    array goes to device memory.
// 4. The in-place hazard. A CTA writes its winners straight into the
//    table when they end before the next CTA's table slice (q + w <= the
//    table index where the next slice starts: every later CTA still to read
//    lies past it, and every earlier one has read its slice before it
//    published its count), or when it is the last CTA. Batches that update
//    existing cells (the store route's prefix merges) write almost every
//    CTA in place. A CTA whose winners would run into the next slice (net
//    new keys before its end) writes them to a scratch array at their final
//    offsets, and ``finish`` copies those CTAs' ranges back, clears
//    [E_new, E) and writes count and overflow.
// Launches: 3 for O <= 4,096 (sort, merge, finish), 3 + log2(O / 4,096)
// above. All on the caller's stream, no host synchronisation, capturable
// in a CUDA graph; the look-back's tile states are zeroed by the sort.
//
// C interface (ctypes): ``cell_merge_launch`` returns cudaGetLastError()
// after its last launch (0 on success), or a negative code for a refused
// shape or scratch; the scratch is a caller-allocated int32 buffer of at
// least ``cell_merge_scratch_words(Lt, O)`` words.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kEmpty = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSortThreads = 1024;
constexpr int kSortItems = 4;
constexpr int kSortTile = kSortThreads * kSortItems;   // 4,096
constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 8;
constexpr int kTile = kMergeThreads * kMergeItems;      // 2,048
constexpr int kDecide = 9;   // positions a thread decides (kTile + 1 fit)
constexpr int kRankThreads = 1024;
constexpr int kRankPerWarp = 1;
constexpr int kRankPerCta = kRankThreads / 32 * kRankPerWarp;   // 32
constexpr int kErrShape = -1;
constexpr int kErrScratch = -2;

constexpr int kSortSmem = 3 * kSortTile * 4;
constexpr int kPassSmem = 6 * kTile * 4;
constexpr int kMergeSmem = 6 * (kTile + 1) * 4;

__device__ __forceinline__ bool less3(int ak, int as, int av, int bk, int bs,
                                      int bv) {
  if (ak != bk) return ak < bk;
  if (as != bs) return as < bs;
  return av < bv;
}

// merge order of two batch runs: the earlier run first unless b < a
struct BatchOrder {
  __device__ bool operator()(int ak, int as, int av, int bk, int bs,
                             int bv) const {
    return !less3(bk, bs, bv, ak, as, av);
  }
};

// merge order between a table element a and a batch element b: a comes
// first iff a.key < b.key, or the keys are equal and (prefix mode, or the
// key is EMPTY, or a.seq <= b.seq)
struct TableOrder {
  bool full;
  __device__ bool operator()(int ak, int as, int, int bk, int bs,
                             int) const {
    if (ak != bk) return ak < bk;
    return !full || ak == kEmpty || as <= bs;
  }
};

// elements of A among the first d merged ones (A and B in shared memory)
template <class Order>
__device__ int merge_path(const int* ak, const int* as, const int* av,
                          int na, const int* bk, const int* bs,
                          const int* bv, int nb, int d, Order order) {
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    const int j = d - 1 - m;
    if (order(ak[m], as[m], av[m], bk[j], bs[j], bv[j])) lo = m + 1;
    else hi = m;
  }
  return lo;
}

// the same in device memory by one warp: 32 probes a step (every lane
// returns the answer)
template <class Order>
__device__ int warp_merge_path(const int* ak, const int* as, const int* av,
                               int na, const int* bk, const int* bs,
                               const int* bv, int nb, long long d,
                               Order order, int lane) {
  int lo = (int)max(0LL, d - nb);
  int hi = (int)min(d, (long long)na);
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int m = lo + lane * step;
    bool before = false;
    if (m < hi) {
      const int j = (int)(d - 1 - m);
      before = order(ak[m], as[m], av[m], bk[j], bs[j], bv[j]);
    }
    const int c = __popc(__ballot_sync(kFull, before));
    if (c == 0) break;
    const int nlo = lo + (c - 1) * step + 1;
    hi = min(hi, lo + c * step);
    lo = nlo;
  }
  return lo;
}

__device__ __forceinline__ void cswap(int& ak, int& as, int& av, int& bk,
                                      int& bs, int& bv) {
  if (less3(bk, bs, bv, ak, as, av)) {
    int t = ak; ak = bk; bk = t;
    t = as; as = bs; bs = t;
    t = av; av = bv; bv = t;
  }
}

// (1) each CTA sorts kSortTile elements of the batch by (key, seq, value);
// the CTAs also zero the merge's tile states and meta words
__global__ void __launch_bounds__(kSortThreads)
    sort_tiles(const int* __restrict__ ik, const int* __restrict__ is,
               const int* __restrict__ iv, int* __restrict__ ok,
               int* __restrict__ os, int* __restrict__ ov, int O,
               unsigned long long* __restrict__ clear, int n_clear) {
  extern __shared__ int sm[];
  int* sk = sm;
  int* ss = sk + kSortTile;
  int* sv = ss + kSortTile;
  const int tid = threadIdx.x;
  for (int i = blockIdx.x * kSortThreads + tid; i < n_clear;
       i += gridDim.x * kSortThreads)
    clear[i] = 0ull;
  const long long base = (long long)blockIdx.x * kSortTile;
  const int n = (int)min((long long)kSortTile, O - base);
  if (n <= 0) return;
  int k[kSortItems], s[kSortItems], v[kSortItems];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {   // every load in flight at once
    const int i = tid + r * kSortThreads;
    const bool in = i < n;
    k[r] = in ? ik[base + i] : INT_MAX;
    s[r] = in ? is[base + i] : INT_MAX;
    v[r] = in ? iv[base + i] : INT_MAX;
  }
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const int i = tid + r * kSortThreads;
    sk[i] = k[r]; ss[i] = s[r]; sv[i] = v[r];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    k[i] = sk[tid * kSortItems + i];
    s[i] = ss[tid * kSortItems + i];
    v[i] = sv[tid * kSortItems + i];
  }
#pragma unroll
  for (int r = 0; r < kSortItems; ++r)
#pragma unroll
    for (int i = r & 1; i + 1 < kSortItems; i += 2)
      cswap(k[i], s[i], v[i], k[i + 1], s[i + 1], v[i + 1]);
  const BatchOrder order;
  for (int w = kSortItems; w < kSortTile; w *= 2) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kSortItems; ++i) {
      sk[tid * kSortItems + i] = k[i];
      ss[tid * kSortItems + i] = s[i];
      sv[tid * kSortItems + i] = v[i];
    }
    __syncthreads();
    const int start = tid * kSortItems;
    const int pair = start & ~(2 * w - 1);
    const int d = start - pair;
    const int *ak = sk + pair, *as = ss + pair, *av = sv + pair;
    const int *bk = ak + w, *bs = as + w, *bv = av + w;
    int i = merge_path(ak, as, av, w, bk, bs, bv, w, d, order);
    int j = d - i;
#pragma unroll
    for (int x = 0; x < kSortItems; ++x) {
      const bool take_a =
          j >= w || (i < w && order(ak[i], as[i], av[i], bk[j], bs[j], bv[j]));
      if (take_a) {
        k[x] = ak[i]; s[x] = as[i]; v[x] = av[i]; ++i;
      } else {
        k[x] = bk[j]; s[x] = bs[j]; v[x] = bv[j]; ++j;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    sk[tid * kSortItems + i] = k[i];
    ss[tid * kSortItems + i] = s[i];
    sv[tid * kSortItems + i] = v[i];
  }
  __syncthreads();
  for (int i = tid; i < n; i += kSortThreads) {
    ok[base + i] = sk[i];
    os[base + i] = ss[i];
    ov[base + i] = sv[i];
  }
}

// (key, seq) as one signed 64-bit key in the same order
__device__ __forceinline__ long long composite(int k, int s) {
  return (static_cast<long long>(k) << 32) |
         static_cast<long long>(static_cast<unsigned>(s) ^ 0x80000000u);
}

// (1) a batch of O <= kSortTile by rank: every CTA stages the whole batch
// in shared memory, each warp ranks 4 elements (the lanes count the
// elements before each, (key, seq) as one 64-bit compare, value and then
// the index only on a tie) and writes each to its rank. O^2 compares
// spread over O / 32 CTAs, no rounds; the CTAs also zero the merge's tile
// states and meta words.
__global__ void __launch_bounds__(kRankThreads)
    rank_sort(const int* __restrict__ ik, const int* __restrict__ is,
              const int* __restrict__ iv, int* __restrict__ ok,
              int* __restrict__ os, int* __restrict__ ov, int O,
              unsigned long long* __restrict__ clear, int n_clear) {
  extern __shared__ long long sc[];
  int* sv = reinterpret_cast<int*>(sc + O);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = blockIdx.x * kRankThreads + tid; i < n_clear;
       i += gridDim.x * kRankThreads)
    clear[i] = 0ull;
  {   // every load in flight at once (O <= kSortTile)
    constexpr int kPer = kSortTile / kRankThreads;
    int rk[kPer], rs[kPer], rv[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = tid + r * kRankThreads;
      if (i < O) {
        rk[r] = ik[i]; rs[r] = is[i]; rv[r] = iv[i];
      }
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = tid + r * kRankThreads;
      if (i < O) {
        sc[i] = composite(rk[r], rs[r]);
        sv[i] = rv[r];
      }
    }
  }
  __syncthreads();
  const int e0 = blockIdx.x * kRankPerCta + warp * kRankPerWarp;
  long long c[kRankPerWarp];
  int v[kRankPerWarp], r[kRankPerWarp];
#pragma unroll
  for (int q = 0; q < kRankPerWarp; ++q) {
    const bool in = e0 + q < O;
    c[q] = in ? sc[e0 + q] : 0;
    v[q] = in ? sv[e0 + q] : 0;
    r[q] = 0;
  }
  for (int j = lane; j < O; j += 32) {
    const long long cj = sc[j];
#pragma unroll
    for (int q = 0; q < kRankPerWarp; ++q) {
      r[q] += cj < c[q];
      if (cj == c[q]) {
        const int vj = sv[j];
        r[q] += vj < v[q] || (vj == v[q] && j < e0 + q);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kRankPerWarp; ++q)
#pragma unroll
    for (int o = 16; o; o >>= 1) r[q] += __shfl_xor_sync(kFull, r[q], o);
#pragma unroll
  for (int q = 0; q < kRankPerWarp; ++q)
    if (lane == q && e0 + q < O) {
      ok[r[q]] = static_cast<int>(c[q] >> 32);
      os[r[q]] = static_cast<int>(static_cast<unsigned>(c[q]) ^ 0x80000000u);
      ov[r[q]] = v[q];
    }
}

// stage A[0, na) and B[0, nb) (device memory) in shared memory and merge
// them into m*[0, na + nb); every thread of the CTA takes part
template <class Order>
__device__ void tile_merge(const int* gak, const int* gas, const int* gav,
                           int na, const int* gbk, const int* gbs,
                           const int* gbv, int nb, int* sk, int* ss, int* sv,
                           int* mk, int* ms, int* mv, Order order) {
  // every load in flight at once (na + nb <= kTile): registers, then
  // shared memory
  const int n = na + nb;
  int rk[kMergeItems], rs[kMergeItems], rv[kMergeItems];
#pragma unroll
  for (int r = 0; r < kMergeItems; ++r) {
    const int i = threadIdx.x + r * kMergeThreads;
    if (i < na) {
      rk[r] = gak[i]; rs[r] = gas[i]; rv[r] = gav[i];
    } else if (i < n) {
      rk[r] = gbk[i - na]; rs[r] = gbs[i - na]; rv[r] = gbv[i - na];
    }
  }
#pragma unroll
  for (int r = 0; r < kMergeItems; ++r) {
    const int i = threadIdx.x + r * kMergeThreads;
    if (i < n) {
      sk[i] = rk[r]; ss[i] = rs[r]; sv[i] = rv[r];
    }
  }
  __syncthreads();
  const int d = threadIdx.x * kMergeItems;
  if (d < n) {
    const int *bk = sk + na, *bs = ss + na, *bv = sv + na;
    int i = merge_path(sk, ss, sv, na, bk, bs, bv, nb, d, order);
    int j = d - i;
    const int e = min(d + kMergeItems, n);
    for (int p = d; p < e; ++p) {
      const bool take_a =
          j >= nb ||
          (i < na && order(sk[i], ss[i], sv[i], bk[j], bs[j], bv[j]));
      if (take_a) {
        mk[p] = sk[i]; ms[p] = ss[i]; mv[p] = sv[i]; ++i;
      } else {
        mk[p] = bk[j]; ms[p] = bs[j]; mv[p] = bv[j]; ++j;
      }
    }
  }
  __syncthreads();
}

// (1b) one merge pass over the sorted batch: runs of w into runs of 2w
// (w a multiple of 2 kTile, so a CTA's outputs lie in one pair of runs)
__global__ void __launch_bounds__(kMergeThreads)
    merge_pass(const int* __restrict__ ik, const int* __restrict__ is,
               const int* __restrict__ iv, int* __restrict__ ok,
               int* __restrict__ os, int* __restrict__ ov, int O, int w) {
  extern __shared__ int sm[];
  __shared__ int part[2];
  int* sk = sm;
  int* ss = sk + kTile;
  int* sv = ss + kTile;
  int* mk = sv + kTile;
  int* ms = mk + kTile;
  int* mv = ms + kTile;
  const long long c0 = (long long)blockIdx.x * kTile;
  const long long pair = c0 / (2LL * w) * (2LL * w);
  const int na = (int)min((long long)w, O - pair);
  const int nb = (int)max(0LL, min((long long)w, O - pair - w));
  const int *ak = ik + pair, *as = is + pair, *av = iv + pair;
  const int *bk = ak + w, *bs = as + w, *bv = av + w;
  const int d0 = (int)(c0 - pair);
  const int d1 = min(d0 + kTile, na + nb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const BatchOrder order;
  if (warp < 2) {
    const int r = warp_merge_path(ak, as, av, na, bk, bs, bv, nb,
                                  warp ? d1 : d0, order, lane);
    if (lane == 0) part[warp] = r;
  }
  __syncthreads();
  const int a0 = part[0], a1 = part[1];
  const int b0 = d0 - a0, b1 = d1 - a1;
  tile_merge(ak + a0, as + a0, av + a0, a1 - a0, bk + b0, bs + b0, bv + b0,
             b1 - b0, sk, ss, sv, mk, ms, mv, order);
  for (int i = threadIdx.x; i < d1 - d0; i += kMergeThreads) {
    ok[c0 + i] = mk[i];
    os[c0 + i] = ms[i];
    ov[c0 + i] = mv[i];
  }
}

struct MergeArgs {
  int *tk, *ts, *tv;          // table planes (T,)
  int *count, *overflow;      // device scalars
  int T, Lt;
  const int *bk, *bs, *bv;    // the sorted batch (O,)
  int O, full, fww;
  int *xk, *xs, *xv;          // scratch output planes (Lt,)
  unsigned long long* state;  // per tile: look-back state
  int* meta;                  // E, live, active tiles
  int* rec;                   // per tile: output offset, winners (< 0:
                              // written to scratch)
};

// exclusive prefix of the tiles before t (warp 0 of CTA t; every lane gets
// it). State word: status << 32 | value, status 1 = the tile's aggregate,
// 2 = its inclusive prefix.
__device__ int look_back(unsigned long long* st, int t, int agg, int lane) {
  volatile unsigned long long* vs = st;
  if (lane == 0) {
    __threadfence();
    vs[t] = ((t == 0 ? 2ull : 1ull) << 32) | (unsigned)agg;
  }
  if (t == 0) return 0;
  int excl = 0;
  int base = t - 1;
  while (true) {
    const int j = base - lane;
    const unsigned long long v = j >= 0 ? vs[j] : (2ull << 32);
    const unsigned status = (unsigned)(v >> 32);
    if (__any_sync(kFull, status == 0)) continue;
    const unsigned pre = __ballot_sync(kFull, status == 2);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    int val = lane <= stop ? (int)(unsigned)(v & 0xffffffffull) : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) val += __shfl_xor_sync(kFull, val, o);
    excl += val;
    if (pre) break;
    base -= 32;
  }
  if (lane == 0) vs[t] = (2ull << 32) | (unsigned)(excl + agg);
  __threadfence();
  return excl;
}

// (2) merge table[0, E) with the sorted batch, one tile of kTile merged
// positions a CTA; winners compacted in place or into scratch
__global__ void __launch_bounds__(kMergeThreads)
    merge_table(const __grid_constant__ MergeArgs a) {
  extern __shared__ int sm[];
  __shared__ int part[2];
  __shared__ int halo_has;
  __shared__ int warp_tot[kMergeThreads / 32];
  __shared__ int s_excl;
  int* sk = sm;
  int* ss = sk + (kTile + 1);
  int* sv = ss + (kTile + 1);
  int* mk = sv + (kTile + 1);
  int* ms = mk + (kTile + 1);
  int* mv = ms + (kTile + 1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int E = min(max(*a.count, 0), a.Lt);
  const long long total = (long long)E + a.O;
  const int n_active = (int)((total + kTile - 1) / kTile);
  const int t = blockIdx.x;
  if (t >= n_active) return;
  if (t == 0 && tid == 0) {
    a.meta[0] = E;
    a.meta[2] = n_active;
  }
  const long long D0 = (long long)t * kTile;
  const long long D1 = min(D0 + kTile, total);
  const TableOrder order{a.full != 0};
  if (warp < 2) {
    const int r = warp_merge_path(a.tk, a.ts, a.tv, E, a.bk, a.bs, a.bv,
                                  a.O, warp ? D1 : D0, order, lane);
    if (lane == 0) part[warp] = r;
  }
  __syncthreads();
  const int a0 = part[0], a1 = part[1];
  const int b0 = (int)(D0 - a0), b1 = (int)(D1 - a1);
  const int n = (int)(D1 - D0);
  if (tid == 0) {   // the merged element at D1, if any: index n
    const bool ta = a1 < E, tb = b1 < a.O;
    int has = 0;
    if (ta && (!tb || order(a.tk[a1], a.ts[a1], 0, a.bk[b1], a.bs[b1], 0))) {
      mk[n] = a.tk[a1]; ms[n] = a.ts[a1]; mv[n] = a.tv[a1]; has = 1;
    } else if (tb) {
      mk[n] = a.bk[b1]; ms[n] = a.bs[b1]; mv[n] = a.bv[b1]; has = 1;
    }
    halo_has = has;
  }
  tile_merge(a.tk + a0, a.ts + a0, a.tv + a0, a1 - a0, a.bk + b0, a.bs + b0,
             a.bv + b0, b1 - b0, sk, ss, sv, mk, ms, mv, order);
  // LWW decides [0, n): a winner differs from the next key. FWW decides
  // (0, n] (and 0 in the first tile): a winner differs from the previous.
  const bool fww = a.fww != 0;
  const int has_next = halo_has;
  const int lo = (fww && t > 0) ? 1 : 0;
  const int hi = fww ? n + has_next : n;
  const int p0 = lo + tid * kDecide;
  unsigned mask = 0;
  int c = 0;
#pragma unroll
  for (int x = 0; x < kDecide; ++x) {
    const int p = p0 + x;
    if (p < hi) {
      const int k = mk[p];
      bool win = k != kEmpty;
      if (win) {
        if (fww) win = p == 0 || mk[p - 1] != k;
        else win = p + 1 >= n + has_next || mk[p + 1] != k;
      }
      if (win) {
        mask |= 1u << x;
        ++c;
      }
    }
  }
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int before = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < kMergeThreads / 32; ++w) {
    const int s = warp_tot[w];
    before += w < warp ? s : 0;
    agg += s;
  }
  int off = before + incl - c;
  // the slices are read: stage the tile's winners over them, in order
#pragma unroll
  for (int x = 0; x < kDecide; ++x)
    if (mask & (1u << x)) {
      sk[off] = mk[p0 + x];
      ss[off] = ms[p0 + x];
      sv[off] = mv[p0 + x];
      ++off;
    }
  if (warp == 0) {
    const int excl = look_back(a.state, t, agg, lane);
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  const int q = s_excl;
  const bool in_place = (long long)q + agg <= a1 || t == n_active - 1;
  if (tid == 0) {
    a.rec[2 * t] = q;
    a.rec[2 * t + 1] = in_place ? agg : (agg | INT_MIN);
    if (t == n_active - 1) a.meta[1] = q + agg;
  }
  int* dk = in_place ? a.tk : a.xk;
  int* ds = in_place ? a.ts : a.xs;
  int* dv = in_place ? a.tv : a.xv;
  for (int i = tid; i < agg; i += kMergeThreads) {
    const long long pos = (long long)q + i;
    if (pos < a.Lt) {
      dk[pos] = sk[i];
      ds[pos] = ss[i];
      dv[pos] = sv[i];
    }
  }
}

// (3) tiles written to scratch go back to the table; [E_new, E) gets
// EMPTY / 0 / 0; count and overflow
__global__ void __launch_bounds__(kMergeThreads)
    finish(const __grid_constant__ MergeArgs a) {
  const int t = blockIdx.x, tid = threadIdx.x;
  // one round trip: the meta words and this tile's record (stale, and
  // unused, past the active tiles)
  const int E = a.meta[0], live = a.meta[1], n_active = a.meta[2];
  const int q = a.rec[2 * t], wf = a.rec[2 * t + 1];
  if (t < n_active) {
    if (wf < 0) {
      const int end = (int)min((long long)q + (wf & INT_MAX),
                               (long long)a.Lt);
      int rk[kDecide], rs[kDecide], rv[kDecide];   // w <= kTile + 1
#pragma unroll
      for (int r = 0; r < kDecide; ++r) {
        const int p = q + tid + r * kMergeThreads;
        if (p < end) {
          rk[r] = a.xk[p]; rs[r] = a.xs[p]; rv[r] = a.xv[p];
        }
      }
#pragma unroll
      for (int r = 0; r < kDecide; ++r) {
        const int p = q + tid + r * kMergeThreads;
        if (p < end) {
          a.tk[p] = rk[r]; a.ts[p] = rs[r]; a.tv[p] = rv[r];
        }
      }
    }
  }
  const long long e_new = min(live, a.Lt);
  const long long lo = max((long long)t * kTile, e_new);
  const long long hi = min((long long)(t + 1) * kTile, (long long)E);
  for (long long p = lo + tid; p < hi; p += kMergeThreads) {
    a.tk[p] = kEmpty;
    a.ts[p] = 0;
    a.tv[p] = 0;
  }
  if (t == 0 && tid == 0) {
    *a.count = min(live, a.T);
    if (live > a.Lt) *a.overflow = 1;
  }
}

long long blocks_of(long long n, long long per) { return (n + per - 1) / per; }

constexpr int kMaxDevices = 64;

cudaError_t set_smem(const void* fn, int bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

extern "C" {

// merged-position tiles of one merge (merge_table's and finish's grid)
long long cell_merge_tiles(int Lt, int O) {
  return blocks_of((long long)Lt + O, kTile);
}

// int32 words of scratch one merge needs: the tile states (2 words each)
// and 4 meta words, 2 record words a tile, the sorted batch (twice when it
// takes merge passes) and the scratch output planes
long long cell_merge_scratch_words(int Lt, int O) {
  const long long tiles = cell_merge_tiles(Lt, O);
  return 4 * tiles + 4 + (O > kSortTile ? 6LL : 3LL) * O + 3LL * Lt;
}

// Merge a batch of O cells into table[0, Lt) (Lt = L in prefix mode, T in
// full mode) of a table of capacity T, in place. count / overflow: device
// int32 scalars.
int cell_merge_launch(int* tk, int* ts, int* tv, int* count, int* overflow,
                      int T, int Lt, const int* bk, const int* bs,
                      const int* bv, int O, int full, int fww, int* scratch,
                      long long scratch_words, void* stream_) {
  if (T < 1 || Lt < 1 || Lt > T || O < 0) return kErrShape;
  if (scratch_words < cell_merge_scratch_words(Lt, O)) return kErrScratch;
  // the shared-memory opt-in is per device (the caller makes the
  // tensors' device current): set once on each
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return (int)cudaGetLastError();
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    cudaError_t e = set_smem((const void*)sort_tiles, kSortSmem);
    if (e == cudaSuccess) e = set_smem((const void*)merge_pass, kPassSmem);
    if (e == cudaSuccess) e = set_smem((const void*)merge_table, kMergeSmem);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = true;
  }
  cudaStream_t stream = (cudaStream_t)stream_;
  const long long tiles = cell_merge_tiles(Lt, O);
  unsigned long long* state = (unsigned long long*)scratch;
  int* meta = scratch + 2 * tiles;
  int* rec = meta + 4;
  int* s0k = rec + 2 * tiles;
  int* s0s = s0k + O;
  int* s0v = s0s + O;
  int* s1k = s0v + O;   // only when O > kSortTile
  int* s1s = s1k + O;
  int* s1v = s1s + O;
  int* xk = (O > kSortTile ? s1v + O : s1k);
  int* xs = xk + Lt;
  int* xv = xs + Lt;

  // (1) sort the batch; zero the tile states and meta
  if (O <= kSortTile) {
    rank_sort<<<(int)max(1LL, blocks_of(O, kRankPerCta)), kRankThreads,
                12 * O, stream>>>(bk, bs, bv, s0k, s0s, s0v, O, state,
                                  (int)(tiles + 2));
  } else {
    sort_tiles<<<(int)blocks_of(O, kSortTile), kSortThreads, kSortSmem,
                 stream>>>(bk, bs, bv, s0k, s0s, s0v, O, state,
                           (int)(tiles + 2));
  }
  int *ak = s0k, *as = s0s, *av = s0v, *ck = s1k, *cs = s1s, *cv = s1v;
  for (long long w = kSortTile; w < O; w *= 2) {
    merge_pass<<<(int)blocks_of(O, kTile), kMergeThreads, kPassSmem,
                 stream>>>(ak, as, av, ck, cs, cv, O, (int)w);
    int* t;
    t = ak; ak = ck; ck = t;
    t = as; as = cs; cs = t;
    t = av; av = cv; cv = t;
  }
  // (2) merge, (3) finish
  MergeArgs a;
  a.tk = tk; a.ts = ts; a.tv = tv;
  a.count = count; a.overflow = overflow;
  a.T = T; a.Lt = Lt;
  a.bk = ak; a.bs = as; a.bv = av;
  a.O = O; a.full = full; a.fww = fww;
  a.xk = xk; a.xs = xs; a.xv = xv;
  a.state = state; a.meta = meta; a.rec = rec;
  merge_table<<<(int)tiles, kMergeThreads, kMergeSmem, stream>>>(a);
  finish<<<(int)tiles, kMergeThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

const char* cell_merge_error_string(int err) {
  if (err == kErrShape) return "refused shape: need 0 < Lt <= T and O >= 0";
  if (err == kErrScratch)
    return "scratch smaller than cell_merge_scratch_words(Lt, O)";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
