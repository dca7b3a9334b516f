// Fused batched merge-tree apply (+ zamboni) for NVIDIA Hopper (sm_90a).
//
// Replaces fluidframework_tpu/ops/pallas_string_kernel.py::
// apply_string_batch_pallas (pl.pallas_call at line 208; body _kernel
// :101-160, epilogue _compact :41-87). The Python wrapper and the plain
// PyTorch version it is held against live in ops/string_kernel.py and
// ops/merge_tree.py.
//
// Design: one CTA per document. The doc's 7 int32 state planes (plus K
// property planes in props mode) and its O x 7 op fields are loaded into
// dynamic shared memory once; every op of the batch is applied there in
// column order; the planes are written back once. Per op:
//   visibility mask -> block exclusive scan of visible lengths ->
//   min/sum reductions (containing slot j, boundary slot, prefix at j) ->
//   shift of the S-wide tail right by 1 or 2 through registers ->
//   split fix-ups and remove / annotate marking.
// With min_seq, a block exclusive scan of keep flags then a scatter drops
// tombstones removed at or below min_seq (stable), zeroing vacated slots
// (removed_seq = NOT_REMOVED) as the TPU epilogue does.
//
// Thread t owns the contiguous slots [t*IPT, t*IPT + IPT). Every thread
// keeps the doc's count and overflow in registers; they are updated from
// block-uniform reduction results, so they stay identical across threads.
// Sums and prefixes wrap like int32 (unsigned arithmetic), as the JAX
// reference does.
//
// Exposed over a plain C ABI (ctypes): string_apply_launch returns a
// cudaError_t (0 = launched) or a negative code for a refused shape.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kNotRemoved = 0x7fffffff;
constexpr int kNumPlanes = 7;
constexpr int kNumOps = 7;
constexpr int kInsert = 0;
constexpr int kRemove = 1;
constexpr int kAnnotate = 2;
constexpr int kPropBits = 20;
constexpr int kMaxThreads = 1024;

enum Plane { SEQ = 0, CLIENT, REMOVED, REMOVERS, LENGTH, HOP, HOFF };
enum OpField { F_KIND = 0, F_A0, F_A1, F_A2, F_SEQ, F_CLIENT, F_REF };

constexpr int kErrBadShape = -1;
constexpr int kErrSmem = -2;

struct Args {
  const int* op[kNumOps];   // (D, O) each
  int* plane[kNumPlanes];   // (D, S) each
  int* prop;                // (D, S, K) or null
  int* count;               // (D,)
  int* overflow;            // (D,)
  const int* min_seq;       // (D,) or null
  int D, S, O, K;
};

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

struct Smem {
  int* plane[kNumPlanes];  // S ints each
  int* prop;               // K planes of S ints: prop[k * S + i]
  int* ops;                // kNumOps x O
  int* scan;               // 32 warp partials
  int* red;                // 3 x 32 warp partials
};

// Exclusive block scan of one int per thread (wrapping add); *total gets
// the block sum. blockDim.x is a multiple of 32.
__device__ int block_excl_scan(int v, int* buf, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = wadd(x, y);
  }
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? buf[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w = wadd(w, y);
    }
    if (lane < nw) buf[lane] = w;
  }
  __syncthreads();
  *total = buf[nw - 1];
  const int base = warp > 0 ? buf[warp - 1] : 0;
  return wadd(base, wsub(x, v));
}

struct Red {
  int j;    // min index of a slot strictly containing the position
  int sum;  // wrapping sum of the prefix over those slots
  int b;    // min index of a boundary candidate
};

__device__ Red block_reduce(Red r, int* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    r.j = min(r.j, __shfl_xor_sync(0xffffffffu, r.j, d));
    r.sum = wadd(r.sum, __shfl_xor_sync(0xffffffffu, r.sum, d));
    r.b = min(r.b, __shfl_xor_sync(0xffffffffu, r.b, d));
  }
  if (lane == 0) {
    buf[warp] = r.j;
    buf[32 + warp] = r.sum;
    buf[64 + warp] = r.b;
  }
  __syncthreads();
  Red o{INT_MAX, 0, INT_MAX};
  for (int w = 0; w < nw; ++w) {
    o.j = min(o.j, buf[w]);
    o.sum = wadd(o.sum, buf[32 + w]);
    o.b = min(o.b, buf[64 + w]);
  }
  return o;
}

// Visibility and exclusive visible-length prefix of the thread's slots in
// perspective (ref, cl).
template <int IPT>
__device__ void visible_prefix(const Smem& sm, int S, int count, int ref,
                               int cl, bool (&vis)[IPT], int (&pre)[IPT]) {
  const int i0 = threadIdx.x * IPT;
  const unsigned c = static_cast<unsigned>(min(max(cl, 0), 31));
  int local = 0;
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int i = i0 + k;
    bool v = false;
    if (i < count) {
      const bool ins = sm.plane[SEQ][i] <= ref || sm.plane[CLIENT][i] == cl;
      const bool rem =
          sm.plane[REMOVED][i] <= ref ||
          (cl >= 0 &&
           ((static_cast<unsigned>(sm.plane[REMOVERS][i]) >> c) & 1u));
      v = ins && !rem;
    }
    vis[k] = v;
    pre[k] = local;
    if (v) local = wadd(local, sm.plane[LENGTH][i]);
  }
  int total;
  const int base = block_excl_scan(local, sm.scan, &total);
#pragma unroll
  for (int k = 0; k < IPT; ++k) pre[k] = wadd(pre[k], base);
}

// p[i] = old p[i - by] (a roll: i - by wraps mod S) for every slot
// i >= from; slots below `from` keep their values. Reads, barrier, writes.
template <int IPT>
__device__ void shift_tail(int* p, int S, int from, int by) {
  const int i0 = threadIdx.x * IPT;
  int v[IPT];
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int i = i0 + k;
    if (i < S && i >= from) v[k] = p[i - by >= 0 ? i - by : i - by + S];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int i = i0 + k;
    if (i < S && i >= from) p[i] = v[k];
  }
}

template <int IPT, bool PROPS>
__device__ void shift_all(const Smem& sm, int S, int K, int from, int by) {
#pragma unroll
  for (int q = 0; q < kNumPlanes; ++q) shift_tail<IPT>(sm.plane[q], S, from, by);
  if (PROPS) {
    for (int q = 0; q < K; ++q) shift_tail<IPT>(sm.prop + q * S, S, from, by);
  }
}

template <int IPT, bool PROPS>
__device__ void insert_one(const Smem& sm, int S, int K, int& count,
                           int& overflow, int pos, int len, int handle,
                           int seq, int cl, int ref) {
  bool vis[IPT];
  int pre[IPT];
  visible_prefix<IPT>(sm, S, count, ref, cl, vis, pre);
  const int i0 = threadIdx.x * IPT;
  Red r{S, 0, count};
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int i = i0 + k;
    if (i >= S) continue;
    const int end = wadd(pre[k], vis[k] ? sm.plane[LENGTH][i] : 0);
    if (vis[k] && pre[k] < pos && pos < end) {
      r.j = min(r.j, i);
      r.sum = wadd(r.sum, pre[k]);
    }
    if (i < count && pre[k] >= pos) r.b = min(r.b, i);
  }
  r = block_reduce(r, sm.red);
  const bool has_inside = r.j < S;
  const int shift = has_inside ? 2 : 1;
  if (count + shift > S) {  // leave the doc untouched, set the sticky flag
    overflow = 1;
    return;
  }
  const int j = r.j;
  const int off = wsub(pos, r.sum);
  const int new_slot = has_inside ? j + 1 : r.b;
  const int jlen = has_inside ? sm.plane[LENGTH][j] : 0;
  const int jhoff = has_inside ? sm.plane[HOFF][j] : 0;
  shift_all<IPT, PROPS>(sm, S, K, new_slot, shift);
  // every shift barrier is behind us: each thread fixes up its own slots
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int i = i0 + k;
    if (i >= S) continue;
    if (i == new_slot) {
      sm.plane[SEQ][i] = seq;
      sm.plane[CLIENT][i] = cl;
      sm.plane[REMOVED][i] = kNotRemoved;
      sm.plane[REMOVERS][i] = 0;
      sm.plane[LENGTH][i] = len;
      sm.plane[HOP][i] = handle;
      sm.plane[HOFF][i] = 0;
      if (PROPS) {
        for (int q = 0; q < K; ++q) sm.prop[q * S + i] = 0;
      }
    } else if (has_inside && i == j) {
      sm.plane[LENGTH][i] = off;
    } else if (has_inside && i == new_slot + 1) {
      sm.plane[LENGTH][i] = wsub(jlen, off);
      sm.plane[HOFF][i] = wadd(jhoff, off);
    }
  }
  count += shift;
}

// Split the visible segment strictly containing perspective position p.
template <int IPT, bool PROPS>
__device__ void split_at(const Smem& sm, int S, int K, int& count,
                         int& overflow, int p, int cl, int ref) {
  bool vis[IPT];
  int pre[IPT];
  visible_prefix<IPT>(sm, S, count, ref, cl, vis, pre);
  const int i0 = threadIdx.x * IPT;
  Red r{S, 0, INT_MAX};
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int i = i0 + k;
    if (i >= S || !vis[k]) continue;
    const int end = wadd(pre[k], sm.plane[LENGTH][i]);
    if (pre[k] < p && p < end) {
      r.j = min(r.j, i);
      r.sum = wadd(r.sum, pre[k]);
    }
  }
  r = block_reduce(r, sm.red);
  if (r.j >= S) return;           // nothing to split
  if (count + 1 > S) {            // split would overflow: flag, no change
    overflow = 1;
    return;
  }
  const int j = r.j;
  const int off = wsub(p, r.sum);
  const int jlen = sm.plane[LENGTH][j];
  const int jhoff = sm.plane[HOFF][j];
  shift_all<IPT, PROPS>(sm, S, K, j + 1, 1);
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int i = i0 + k;
    if (i == j) {
      sm.plane[LENGTH][i] = off;
    } else if (i == j + 1) {
      sm.plane[LENGTH][i] = wsub(jlen, off);
      sm.plane[HOFF][i] = wadd(jhoff, off);
    }
  }
  count += 1;
  __syncthreads();
}

// Remove or annotate: split at both perspective boundaries, then mark the
// visible segments strictly inside. A second split that overflows still
// leaves the first split in place and the marking runs on what results.
template <int IPT, bool PROPS>
__device__ void range_one(const Smem& sm, int S, int K, int& count,
                          int& overflow, int kind, int start, int end_pos,
                          int packed, int seq, int cl, int ref) {
  split_at<IPT, PROPS>(sm, S, K, count, overflow, start, cl, ref);
  split_at<IPT, PROPS>(sm, S, K, count, overflow, end_pos, cl, ref);
  bool vis[IPT];
  int pre[IPT];
  visible_prefix<IPT>(sm, S, count, ref, cl, vis, pre);
  const int i0 = threadIdx.x * IPT;
  const unsigned bit =
      cl >= 0 ? (1u << static_cast<unsigned>(min(cl, 31))) : 0u;
  const int key = packed >> kPropBits;  // arithmetic shift, as in JAX
  const int handle = packed & ((1 << kPropBits) - 1);
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int i = i0 + k;
    if (i >= S || !vis[k]) continue;
    const int len = sm.plane[LENGTH][i];
    if (!(pre[k] >= start && wadd(pre[k], len) <= end_pos && len > 0)) continue;
    if (kind == kRemove) {
      sm.plane[REMOVED][i] = min(sm.plane[REMOVED][i], seq);
      sm.plane[REMOVERS][i] =
          static_cast<int>(static_cast<unsigned>(sm.plane[REMOVERS][i]) | bit);
    } else if (PROPS && key >= 0 && key < K) {
      sm.prop[key * S + i] = handle;
    }
  }
}

// Stable drop of active slots with removed_seq <= ms; vacated slots are
// zeroed with removed_seq = NOT_REMOVED.
template <int IPT, bool PROPS>
__device__ void compact(const Smem& sm, int S, int K, int& count, int ms) {
  const int i0 = threadIdx.x * IPT;
  bool keep[IPT];
  int dst[IPT];
  int local = 0;
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int i = i0 + k;
    keep[k] = i < count && !(sm.plane[REMOVED][i] <= ms);
    dst[k] = local;
    local += keep[k] ? 1 : 0;
  }
  int kept;
  const int base = block_excl_scan(local, sm.scan, &kept);
  const int n_planes = kNumPlanes + (PROPS ? K : 0);
  for (int q = 0; q < n_planes; ++q) {
    int* p = q < kNumPlanes ? sm.plane[q] : sm.prop + (q - kNumPlanes) * S;
    const int fill = q == REMOVED ? kNotRemoved : 0;
    int v[IPT];
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      if (keep[k]) v[k] = p[i0 + k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const int i = i0 + k;
      if (keep[k]) p[base + dst[k]] = v[k];
      if (i < S && i >= kept) p[i] = fill;
    }
  }
  count = kept;
}

template <int IPT, bool PROPS, bool COMPACT>
__global__ void __launch_bounds__(kMaxThreads) string_apply_kernel(Args a) {
  extern __shared__ int smem[];
  const int d = blockIdx.x;
  const int S = a.S, O = a.O, K = PROPS ? a.K : 0;
  const int T = blockDim.x;
  Smem sm;
  int* cur = smem;
  for (int q = 0; q < kNumPlanes; ++q, cur += S) sm.plane[q] = cur;
  sm.prop = cur;
  cur += K * S;
  sm.ops = cur;
  cur += kNumOps * O;
  sm.scan = cur;
  sm.red = cur + 32;

  const size_t row = static_cast<size_t>(d) * S;
  for (int q = 0; q < kNumPlanes; ++q) {
    const int* g = a.plane[q] + row;
    for (int i = threadIdx.x; i < S; i += T) sm.plane[q][i] = g[i];
  }
  if (PROPS) {
    const int* g = a.prop + row * K;
    for (int x = threadIdx.x; x < S * K; x += T) sm.prop[(x % K) * S + x / K] = g[x];
  }
  const size_t orow = static_cast<size_t>(d) * O;
  for (int f = 0; f < kNumOps; ++f) {
    const int* g = a.op[f] + orow;
    for (int o = threadIdx.x; o < O; o += T) sm.ops[f * O + o] = g[o];
  }
  int count = a.count[d];
  int overflow = a.overflow[d];
  __syncthreads();

  for (int o = 0; o < O; ++o) {
    const int kind = sm.ops[F_KIND * O + o];
    const int a0 = sm.ops[F_A0 * O + o];
    const int a1 = sm.ops[F_A1 * O + o];
    const int a2 = sm.ops[F_A2 * O + o];
    const int seq = sm.ops[F_SEQ * O + o];
    const int cl = sm.ops[F_CLIENT * O + o];
    const int ref = sm.ops[F_REF * O + o];
    if (kind == kInsert) {
      insert_one<IPT, PROPS>(sm, S, K, count, overflow, a0, a1, a2, seq, cl,
                             ref);
    } else if (kind == kRemove || kind == kAnnotate) {
      range_one<IPT, PROPS>(sm, S, K, count, overflow, kind, a0, a1, a2, seq,
                            cl, ref);
    }
    __syncthreads();
  }
  if (COMPACT) {
    compact<IPT, PROPS>(sm, S, K, count, a.min_seq[d]);
    __syncthreads();
  }

  for (int q = 0; q < kNumPlanes; ++q) {
    int* g = a.plane[q] + row;
    for (int i = threadIdx.x; i < S; i += T) g[i] = sm.plane[q][i];
  }
  if (PROPS) {
    int* g = a.prop + row * K;
    for (int x = threadIdx.x; x < S * K; x += T) g[x] = sm.prop[(x % K) * S + x / K];
  }
  if (threadIdx.x == 0) {
    a.count[d] = count;
    a.overflow[d] = overflow;
  }
}

// Slots per thread and threads per block for a capacity S: the fewest
// slots per thread (1, 2, 4 or 8) that keep the block at <= 256 threads;
// beyond S = 2048, 8 slots per thread and up to 1024 threads.
bool pick_shape(int S, int* ipt, int* threads) {
  const int opts[4] = {1, 2, 4, 8};
  for (int n : opts) {
    const int t = ((S + n - 1) / n + 31) / 32 * 32;
    if (t <= 256 || n == 8) {
      *ipt = n;
      *threads = t < 32 ? 32 : t;
      return *threads <= kMaxThreads;
    }
  }
  return false;
}

long long smem_bytes(int S, int O, int K) {
  return 4LL * ((kNumPlanes + static_cast<long long>(K)) * S +
                static_cast<long long>(kNumOps) * O + 32 + 96);
}

template <int IPT, bool PROPS, bool COMPACT>
int launch(const Args& a, int threads, size_t smem, cudaStream_t stream) {
  auto kernel = string_apply_kernel<IPT, PROPS, COMPACT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<a.D, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int IPT>
int launch_ipt(const Args& a, int threads, size_t smem, cudaStream_t stream) {
  const bool props = a.K > 0, compact = a.min_seq != nullptr;
  if (props) {
    return compact ? launch<IPT, true, true>(a, threads, smem, stream)
                   : launch<IPT, true, false>(a, threads, smem, stream);
  }
  return compact ? launch<IPT, false, true>(a, threads, smem, stream)
                 : launch<IPT, false, false>(a, threads, smem, stream);
}

}  // namespace

extern "C" {

long long string_apply_smem_bytes(int D, int S, int O, int K) {
  (void)D;
  return smem_bytes(S, O, K);
}

const char* string_apply_error_string(int code) {
  if (code == kErrBadShape) return "unsupported shape (capacity too large)";
  if (code == kErrSmem) return "shared memory per doc exceeds the limit";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Apply a (D, O) op batch to the (D, S) state planes in place. K = 0 is the
// no-props specialisation (prop may be null); min_seq null skips zamboni.
int string_apply_launch(const int* kind, const int* a0, const int* a1,
                        const int* a2, const int* seq, const int* client,
                        const int* ref_seq, int* p_seq, int* p_client,
                        int* p_removed, int* p_removers, int* p_length,
                        int* p_hop, int* p_hoff, int* prop, int* count,
                        int* overflow, const int* min_seq, int D, int S, int O,
                        int K, void* stream) {
  Args a{{kind, a0, a1, a2, seq, client, ref_seq},
         {p_seq, p_client, p_removed, p_removers, p_length, p_hop, p_hoff},
         prop, count, overflow, min_seq, D, S, O, K};
  int ipt = 0, threads = 0;
  if (D <= 0 || S <= 0 || O < 0 || K < 0 || !pick_shape(S, &ipt, &threads)) {
    return kErrBadShape;
  }
  const long long smem = smem_bytes(S, O, K);
  if (smem > 232448) return kErrSmem;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ipt) {
    case 1: return launch_ipt<1>(a, threads, static_cast<size_t>(smem), st);
    case 2: return launch_ipt<2>(a, threads, static_cast<size_t>(smem), st);
    case 4: return launch_ipt<4>(a, threads, static_cast<size_t>(smem), st);
    default: return launch_ipt<8>(a, threads, static_cast<size_t>(smem), st);
  }
}

}  // extern "C"
