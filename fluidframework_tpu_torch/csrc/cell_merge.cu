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
// after (the EMPTY tail is EMPTY on both sides) and the batch read once —
// config #3's last full merge (371,278 live in, 412,288 out, O = 65,536)
// about 10.2 MB, ≈ 3.0 µs at 3.35 TB/s; the store's last prefix merge
// (L = 2^19, O = 4,096, about 410 K live) about 9.9 MB, ≈ 3.0 µs.
//
// What the design does. A simple design that is right, in a few launches
// on the caller's stream: (1) the batch is sorted by (key, seq, value) —
// value only makes the order total — by a bitonic sort of 2,048-element
// tiles in shared memory, then merge passes that double the run width
// (each element finds its place in the partner run by binary search)
// until one run remains; (2) every table element finds its merged position
// by a binary search in the sorted batch and every batch element by one in
// the table, and each writes itself to a scratch merged array; (3) winners
// are marked against the neighbouring merged element, counted per block of
// 1,024, the block counts scanned by one block (which also writes count
// and overflow), and each block writes its winners straight into the
// table; (4) the slots past the winners get EMPTY / 0 / 0. Reading and
// rewriting the whole prefix [0, Lt), not only the live cells, and the
// merged array in scratch make about 60 MB of traffic at config #3's full
// merge, about 6× the bound's bytes; the sort passes are small beside it
// at these O.
//
// C interface (ctypes): ``cell_merge_launch`` returns cudaGetLastError()
// after its last launch (0 on success); the scratch is a caller-allocated
// int32 buffer of ``cell_merge_scratch_words`` words.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kEmpty = INT_MAX;
constexpr int kTile = 2048;        // elements per bitonic tile
constexpr int kTileThreads = 1024;
constexpr int kBlock = 1024;       // merged positions per counting block
constexpr unsigned kFull = 0xffffffffu;

struct Cell {
  int key, seq, val;
};

__device__ __forceinline__ bool less3(const Cell& a, const Cell& b) {
  if (a.key != b.key) return a.key < b.key;
  if (a.seq != b.seq) return a.seq < b.seq;
  return a.val < b.val;
}

// (1a) bitonic sort of one tile of the batch in shared memory
__global__ void tile_sort(const int* __restrict__ ik, const int* __restrict__ is,
                          const int* __restrict__ iv, int* __restrict__ ok,
                          int* __restrict__ os, int* __restrict__ ov, int O) {
  __shared__ int sk[kTile], ss[kTile], sv[kTile];
  const int base = blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    const int g = base + i;
    const bool in = g < O;
    sk[i] = in ? ik[g] : INT_MAX;
    ss[i] = in ? is[g] : INT_MAX;
    sv[i] = in ? iv[g] : INT_MAX;
  }
  __syncthreads();
  for (int k = 2; k <= kTile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const Cell a = {sk[i], ss[i], sv[i]};
          const Cell b = {sk[p], ss[p], sv[p]};
          const bool up = (i & k) == 0;
          if (up ? less3(b, a) : less3(a, b)) {
            sk[i] = b.key; ss[i] = b.seq; sv[i] = b.val;
            sk[p] = a.key; ss[p] = a.seq; sv[p] = a.val;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    const int g = base + i;
    if (g < O) {
      ok[g] = sk[i];
      os[g] = ss[i];
      ov[g] = sv[i];
    }
  }
}

// number of elements of [lo, hi) before ``c`` (strictly less, or not
// greater when ``or_equal``), over a run sorted by less3
__device__ __forceinline__ int rank_in(const int* k, const int* s,
                                       const int* v, int lo, int hi,
                                       const Cell& c, bool or_equal) {
  int a = lo, b = hi;
  while (a < b) {
    const int m = (a + b) >> 1;
    const Cell x = {k[m], s[m], v[m]};
    const bool before = or_equal ? !less3(c, x) : less3(x, c);
    if (before) a = m + 1;
    else b = m;
  }
  return a - lo;
}

// (1b) one merge pass: runs of ``w`` sorted elements into runs of 2w
__global__ void merge_pass(const int* __restrict__ ik, const int* __restrict__ is,
                           const int* __restrict__ iv, int* __restrict__ ok,
                           int* __restrict__ os, int* __restrict__ ov, int O,
                           int w) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= O) return;
  const int s0 = int(e / (2LL * w)) * 2 * w;
  const int mid = min(s0 + w, O), end = min(s0 + 2 * w, O);
  const Cell c = {ik[e], is[e], iv[e]};
  int pos;
  if (e < mid)  // left run: after the right run's smaller elements
    pos = int(e) + rank_in(ik, is, iv, mid, end, c, false);
  else          // right run: after the left run's elements not greater
    pos = s0 + int(e) - mid + rank_in(ik, is, iv, s0, mid, c, true);
  ok[pos] = c.key;
  os[pos] = c.seq;
  ov[pos] = c.val;
}

// merge order between a table element a and a batch element b: a comes
// first iff a.key < b.key, or the keys are equal and (prefix mode, or the
// key is EMPTY, or a.seq <= b.seq)
__device__ __forceinline__ bool table_first(int ak, int as, int bk, int bs,
                                            bool full) {
  if (ak != bk) return ak < bk;
  return !full || ak == kEmpty || as <= bs;
}

// (2) every table and batch element writes itself at its merged position
__global__ void merge_table(const int* __restrict__ tk, const int* __restrict__ ts,
                            const int* __restrict__ tv, int Lt,
                            const int* __restrict__ bk, const int* __restrict__ bs,
                            const int* __restrict__ bv, int O,
                            int* __restrict__ mk, int* __restrict__ ms,
                            int* __restrict__ mv, int full) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)Lt + O) return;
  int k, s, v, pos;
  if (t < Lt) {
    k = tk[t]; s = ts[t]; v = tv[t];
    int a = 0, b = O;  // batch elements before this table element
    while (a < b) {
      const int m = (a + b) >> 1;
      if (!table_first(k, s, bk[m], bs[m], full)) a = m + 1;
      else b = m;
    }
    pos = int(t) + a;
  } else {
    const int j = int(t - Lt);
    k = bk[j]; s = bs[j]; v = bv[j];
    int a = 0, b = Lt;  // table elements before this batch element
    while (a < b) {
      const int m = (a + b) >> 1;
      if (table_first(tk[m], ts[m], k, s, full)) a = m + 1;
      else b = m;
    }
    pos = j + a;
  }
  mk[pos] = k;
  ms[pos] = s;
  mv[pos] = v;
}

__device__ __forceinline__ bool is_winner(const int* mk, long long p,
                                          long long N, bool fww) {
  const int k = mk[p];
  if (k == kEmpty) return false;
  if (fww) return p == 0 || mk[p - 1] != k;
  return p == N - 1 || mk[p + 1] != k;
}

// exclusive block scan of a 0/1 flag; returns the flag's rank and, in
// ``*total``, the block's sum (kBlock threads)
__device__ __forceinline__ int block_rank(bool flag, int* warp_sums,
                                          int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(kFull, flag);
  if (lane == 0) warp_sums[warp] = __popc(bal);
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < kBlock / 32; ++w) {
    const int c = warp_sums[w];
    before += w < warp ? c : 0;
    sum += c;
  }
  *total = sum;
  return before + __popc(bal & ((1u << lane) - 1u));
}

// (3a) winners per block of kBlock merged positions
__global__ void count_winners(const int* __restrict__ mk, long long N,
                              int fww, int* __restrict__ blk) {
  __shared__ int warp_sums[kBlock / 32];
  const long long p = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool win = p < N && is_winner(mk, p, N, fww);
  int total;
  block_rank(win, warp_sums, &total);
  if (threadIdx.x == 0) blk[blockIdx.x] = total;
}

// (3b) one block: exclusive scan of the block counts, live, count, overflow
__global__ void scan_blocks(int* __restrict__ blk, int nb,
                            int* __restrict__ live_out, int* __restrict__ count,
                            int* __restrict__ overflow, int Lt, int T) {
  __shared__ int warp_sums[kBlock / 32];
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int b0 = 0; b0 < nb; b0 += kBlock) {
    const int b = b0 + threadIdx.x;
    const int c = b < nb ? blk[b] : 0;
    // inclusive warp scan, then the warps' totals
    int x = c;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    int before = carry, sum = 0;
    for (int w = 0; w < kBlock / 32; ++w) {
      const int s = warp_sums[w];
      before += w < warp ? s : 0;
      sum += s;
    }
    if (b < nb) blk[b] = before + x - c;
    __syncthreads();  // every read of carry / warp_sums is done
    if (threadIdx.x == 0) carry += sum;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int live = carry;
    *live_out = live;
    *count = min(live, T);
    if (live > Lt) *overflow = 1;
  }
}

// (3c) every winner at its rank, straight into the table
__global__ void write_winners(const int* __restrict__ mk, const int* __restrict__ ms,
                              const int* __restrict__ mv, long long N, int fww,
                              const int* __restrict__ blk_off,
                              int* __restrict__ tk, int* __restrict__ ts,
                              int* __restrict__ tv, int Lt) {
  __shared__ int warp_sums[kBlock / 32];
  const long long p = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool win = p < N && is_winner(mk, p, N, fww);
  int total;
  const int q = blk_off[blockIdx.x] + block_rank(win, warp_sums, &total);
  if (win && q < Lt) {
    tk[q] = mk[p];
    ts[q] = ms[p];
    tv[q] = mv[p];
  }
}

// (4) EMPTY / 0 / 0 past the winners
__global__ void fill_tail(int* __restrict__ tk, int* __restrict__ ts,
                          int* __restrict__ tv, int Lt,
                          const int* __restrict__ live) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Lt || q < *live) return;
  tk[q] = kEmpty;
  ts[q] = 0;
  tv[q] = 0;
}

long long blocks_of(long long n, int per) { return (n + per - 1) / per; }

}  // namespace

extern "C" {

// int32 words of scratch one merge needs: two sort buffers for the batch,
// the merged array, the block counts and the live count
long long cell_merge_scratch_words(int Lt, int O) {
  const long long N = (long long)Lt + O;
  return 6LL * O + 3 * N + blocks_of(N, kBlock) + 1;
}

// Merge a batch of O cells into table[0, Lt) (Lt = L in prefix mode, T in
// full mode) of a table of capacity T, in place. count / overflow: device
// int32 scalars.
int cell_merge_launch(int* tk, int* ts, int* tv, int* count, int* overflow,
                      int T, int Lt, const int* bk, const int* bs,
                      const int* bv, int O, int full, int fww, int* scratch,
                      void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const long long N = (long long)Lt + O;
  int* s0k = scratch;
  int* s0s = s0k + O;
  int* s0v = s0s + O;
  int* s1k = s0v + O;
  int* s1s = s1k + O;
  int* s1v = s1s + O;
  int* mk = s1v + O;
  int* ms = mk + N;
  int* mv = ms + N;
  int* blk = mv + N;
  const int nb = (int)blocks_of(N, kBlock);
  int* live = blk + nb;

  // (1) sort the batch
  if (O > 0)
    tile_sort<<<(int)blocks_of(O, kTile), kTileThreads, 0, stream>>>(
        bk, bs, bv, s0k, s0s, s0v, O);
  int *ak = s0k, *as = s0s, *av = s0v, *ck = s1k, *cs = s1s, *cv = s1v;
  for (int w = kTile; w < O; w *= 2) {
    merge_pass<<<(int)blocks_of(O, 256), 256, 0, stream>>>(ak, as, av, ck, cs,
                                                           cv, O, w);
    int* t;
    t = ak; ak = ck; ck = t;
    t = as; as = cs; cs = t;
    t = av; av = cv; cv = t;
  }
  // (2) merged positions
  merge_table<<<(int)blocks_of(N, 256), 256, 0, stream>>>(
      tk, ts, tv, Lt, ak, as, av, O, mk, ms, mv, full);
  // (3) winners
  count_winners<<<nb, kBlock, 0, stream>>>(mk, N, fww, blk);
  scan_blocks<<<1, kBlock, 0, stream>>>(blk, nb, live, count, overflow, Lt,
                                        T);
  write_winners<<<nb, kBlock, 0, stream>>>(mk, ms, mv, N, fww, blk, tk, ts,
                                           tv, Lt);
  // (4) the tail
  if (Lt > 0)
    fill_tail<<<(int)blocks_of(Lt, 256), 256, 0, stream>>>(tk, ts, tv, Lt,
                                                           live);
  return (int)cudaGetLastError();
}

const char* cell_merge_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
