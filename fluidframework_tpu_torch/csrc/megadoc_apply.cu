// Mega-doc string apply (K7) for Hopper (sm_90a): one long document's
// slot axis split into n shards, one CTA a shard, the shards of a document
// one thread-block cluster.
//
// Replaces the JAX package's mega-doc apply: ``apply_megadoc_batch``
// (fluidframework_tpu/ops/megadoc_kernel.py:154; body ``_shard_step``
// :73, a ``shard_map`` + ``lax.scan`` over the op axis). There each shard
// lives on its own chip, and per op two all-gathers cross the mesh: the
// shards' perspective-visible totals (their exclusive prefix ``ex`` places
// the op in the shard) and each shard's (inside, candidate) owner flags.
// Here a cluster of n CTAs holds one document; each CTA keeps its shard's
// slot run (7 planes and K property planes, 4 B a slot each) in dynamic
// shared memory for the whole op loop, and the all-gathers are reads of
// the neighbours' exchange words through distributed shared memory
// (``cluster.map_shared_rank``) after a ``cluster.sync()``.
//
// Per op, in column order (NOOP pads are skipped by every CTA alike):
//   (a) a block scan of the perspective-visible lengths gives each slot's
//       local exclusive prefix and the shard's total, written to an
//       exchange word;
//   (b) cluster.sync(); the lanes of each warp read the n totals and sum
//       those of the lower ranks into ``ex``;
//   insert: (c) one block reduction gives the shard's (inside, candidate)
//       flags at the global position and its local insert site; they are
//       written to exchange words; (d) cluster.sync(); the n flags are read
//       and the owner picked: the first shard with a visible segment
//       strictly containing pos, else the first with an active slot at a
//       global prefix >= pos, else the last shard. Only the owner inserts
//       at pos - ex, shifting the whole S-wide tail right by 1 (boundary)
//       or 2 (split), or sets its sticky overflow flag when count would
//       pass S;
//   remove / annotate: every shard clips [start, end) - ex to
//       [0, local total] and, when the clipped range is not empty, splits
//       at both ends (each a tail shift by 1, or the overflow flag) and
//       marks the visible segments inside, as ``merge_tree._range_one``
//       does.
// The exchange words are double-buffered by the parity of the ops that
// exchanged, so the next op's writes never race a neighbour's reads and
// two cluster barriers per insert and one per remove / annotate suffice;
// the kernel begins with a cluster barrier (every CTA of the cluster runs
// before any remote read) and ends with one (no CTA exits while a
// neighbour can still read its shared memory). Sums and comparisons wrap
// like int32, as the merge-tree invariants say.
//
// What bounds it. Bytes would: the state planes read and written once
// and the op planes read once, 2·(7+K)·4·D·n·S + 7·4·D·O bytes (about
// 0.06 ms at D = 64, n = 8, S = 4,096, K = 4, O = 512 at 3.35 TB/s). But a
// document's ops are a serial chain, each resolving its position against
// the prefix the previous op left, so the kernel is bound by the latency
// of its per-op block scans, reductions, tail shifts and cluster barriers,
// and by how many clusters the card holds at once (a CTA takes ~180 KB of
// shared memory at S = 4,096, so one CTA an SM, and a cluster needs n
// free SMs of one GPC).
//
// What the design does about it: it is the simple design — slots in
// shared memory, kG contiguous slots a thread, block-wide scans with warp
// shuffles, one barrier pair per shifted plane. It computes what
// ``_shard_step`` computes. Making it fast is later work.
//
// Limits: S (slots a shard) <= kMaxS and the CTA's shared memory
// ((7 + K)·S + kScratchWords words) <= 227 KB; n <= 8 (portable), or 16
// where the card places a non-portable cluster of that size
// (``megadoc_apply_active_clusters``). The launch returns the error and
// never runs past them.
//
// C interface (ctypes): ``megadoc_apply_launch`` returns
// cudaGetLastError() after the launch (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kInsert = 0;
constexpr int kRemove = 1;
constexpr int kAnnotate = 2;
constexpr int kNotRemoved = 0x7fffffff;
constexpr int kPropHandleBits = 20;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxS = 8192;
constexpr int kPortableShards = 8;
constexpr int kMaxShards = 16;
constexpr int kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;

// plane order, in the argument list and in shared memory
enum { kSeq, kClient, kRemovedSeq, kRemovers, kLength, kHandleOp,
       kHandleOff, kPlanes };

// scratch words after the planes: scan warp sums [0, 40), reduction
// partials [40, 40 + 5·kMaxWarps), reduction results, exchange words
// (totals [2], flags [2][2]) and the shard's count / overflow
constexpr int kWsum = 0;
constexpr int kRed = 40;
constexpr int kRedOut = kRed + 5 * kMaxWarps;
constexpr int kXtot = kRedOut + 8;
constexpr int kXflag = kXtot + 2;
constexpr int kState = kXflag + 4;
constexpr int kScratchWords = 256;
static_assert(kState + 2 <= kScratchWords, "scratch layout");

struct Args {
  const int* op[7];       // kind a0 a1 a2 seq client ref_seq, (D, O)
  int* plane[kPlanes];    // (D, n·S)
  int* prop;              // (D, n·S, K)
  int* count;             // (D, n)
  int* overflow;          // (D, n)
  int O, S, K;
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// Perspective-visible lengths of this thread's kG slots, their local
// exclusive prefixes (block scan) and the shard's total; ``count`` is
// read after the opening barrier. Bit g of ``vis`` marks a visible slot.
template <int kG>
__device__ int scan_visible(int* const* pl, const int* st, int S, int rs,
                            int cl, int& count, unsigned& vis,
                            int (&plv)[kG], int (&pre)[kG], int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();  // earlier writes to the planes and the scratch land
  count = st[0];
  const int sh = cl < 0 ? 0 : (cl > 31 ? 31 : cl);
  vis = 0;
  unsigned run = 0;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const int i = tid * kG + g;
    int x = 0;
    if (i < S && i < count) {
      const bool ins = pl[kSeq][i] <= rs || pl[kClient][i] == cl;
      const bool rem = pl[kRemovedSeq][i] <= rs ||
                       (((pl[kRemovers][i] >> sh) & 1) != 0 && cl >= 0);
      if (ins && !rem) {
        vis |= 1u << g;
        x = pl[kLength][i];
      }
    }
    plv[g] = x;
    pre[g] = (int)run;
    run += (unsigned)x;
  }
  unsigned inc = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) wsum[warp] = (int)inc;
  __syncthreads();
  if (warp == 0) {
    const unsigned w = lane < nwarps ? (unsigned)wsum[lane] : 0u;
    unsigned v = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += y;
    }
    __syncwarp();
    if (lane < nwarps) wsum[lane] = (int)(v - w);
    if (lane == 31) wsum[32] = (int)v;
  }
  __syncthreads();
  const unsigned off = (unsigned)wsum[warp] + (inc - run);
#pragma unroll
  for (int g = 0; g < kG; ++g) pre[g] = (int)((unsigned)pre[g] + off);
  return wsum[32];
}

// Block reduction of four minima and one wrapping sum; every thread gets
// the results.
__device__ void block_reduce(int (&m)[4], unsigned& s, int* red,
                             int* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int q = 0; q < 4; ++q) m[q] = __reduce_min_sync(kFull, m[q]);
  s = __reduce_add_sync(kFull, s);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) red[q * kMaxWarps + warp] = m[q];
    red[4 * kMaxWarps + warp] = (int)s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = __reduce_min_sync(
          kFull, lane < nwarps ? red[q * kMaxWarps + lane] : 0x7fffffff);
      if (lane == 0) out[q] = v;
    }
    const unsigned v = __reduce_add_sync(
        kFull, lane < nwarps ? (unsigned)red[4 * kMaxWarps + lane] : 0u);
    if (lane == 0) out[4] = (int)v;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) m[q] = out[q];
  s = (unsigned)out[4];
}

// Slots i >= from of every plane (and property plane) take slot i - by;
// the last ``by`` slots drop off. Reads, a barrier, writes, a barrier.
template <int kG>
__device__ void shift_tail(int* const* pl, int* prop, int K, int S,
                           int from, int by) {
  const int tid = threadIdx.x;
  for (int p = 0; p < kPlanes + K; ++p) {
    int* x = p < kPlanes ? pl[p] : prop + (p - kPlanes) * S;
    int v[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int i = tid * kG + g;
      v[g] = (i < S && i >= from) ? x[i - by] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int i = tid * kG + g;
      if (i < S && i >= from) x[i] = v[g];
    }
    __syncthreads();
  }
}

// Split the visible segment strictly containing local position p (tail
// shift by 1), or set the overflow flag when count + 1 would pass S.
template <int kG>
__device__ void split_at(int* const* pl, int* prop, int* st, int K, int S,
                         int count, int p, unsigned vis,
                         const int (&plv)[kG], const int (&pre)[kG],
                         int* red, int* out) {
  const int tid = threadIdx.x;
  int m[4] = {S, S, S, S};
  unsigned psum = 0;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const int i = tid * kG + g;
    if (((vis >> g) & 1) && pre[g] < p && p < wadd(pre[g], plv[g])) {
      m[0] = min(m[0], i);
      psum += (unsigned)pre[g];
    }
  }
  block_reduce(m, psum, red, out);
  const int j = m[0];
  if (j >= S) return;
  if (count + 1 > S) {
    if (tid == 0) st[1] = 1;
    return;
  }
  const int off = wsub(p, (int)psum);
  shift_tail<kG>(pl, prop, K, S, j + 1, 1);
  if (tid == 0) {
    pl[kLength][j + 1] = wsub(pl[kLength][j + 1], off);
    pl[kHandleOff][j + 1] = wadd(pl[kHandleOff][j + 1], off);
    pl[kLength][j] = off;
    st[0] = count + 1;
  }
}

template <int kG>
__global__ void __launch_bounds__(kMaxThreads)
megadoc_apply_kernel(Args a) {
  extern __shared__ int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int d = blockIdx.x / n;
  const int S = a.S, K = a.K, O = a.O;
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;

  int* pl[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) pl[p] = smem + p * S;
  int* prop = smem + kPlanes * S;  // K planes of S, plane-major
  int* scr = prop + K * S;
  int* wsum = scr + kWsum;
  int* red = scr + kRed;
  int* out = scr + kRedOut;
  int* xtot = scr + kXtot;
  int* xflag = scr + kXflag;
  int* st = scr + kState;  // [0] count, [1] overflow

  const long long base = ((long long)d * n + r) * S;
#pragma unroll
  for (int p = 0; p < kPlanes; ++p)
    for (int i = tid; i < S; i += T) pl[p][i] = a.plane[p][base + i];
  for (int i = tid; i < S * K; i += T)
    prop[(i % K) * S + i / K] = a.prop[base * K + i];
  if (tid == 0) {
    st[0] = a.count[d * n + r];
    st[1] = a.overflow[d * n + r];
  }
  cluster.sync();  // every CTA of the cluster runs before a remote read

  int ph = 0;  // parity of the ops that exchanged
  const int* opk = a.op[0] + (long long)d * O;
  for (int o = 0; o < O; ++o) {
    const int kind = __ldg(opk + o);
    if (kind != kInsert && kind != kRemove && kind != kAnnotate) continue;
    const long long at = (long long)d * O + o;
    const int p0 = __ldg(a.op[1] + at), p1 = __ldg(a.op[2] + at);
    const int p2 = __ldg(a.op[3] + at), sq = __ldg(a.op[4] + at);
    const int cl = __ldg(a.op[5] + at), rs = __ldg(a.op[6] + at);

    int count;
    unsigned vis;
    int plv[kG], pre[kG];
    const int lv = scan_visible<kG>(pl, st, S, rs, cl, count, vis, plv,
                                    pre, wsum);
    // (a)-(b): the shards' totals → this shard's exclusive prefix
    if (tid == 0) xtot[ph] = lv;
    cluster.sync();
    int ex;
    {
      const unsigned v =
          lane < n ? (unsigned)*cluster.map_shared_rank(xtot + ph, lane)
                   : 0u;
      ex = (int)__reduce_add_sync(kFull, lane < r ? v : 0u);
    }

    if (kind == kInsert) {
      // (c): owner flags at the global position, local insert site
      const int pos = wsub(p0, ex);
      int m[4] = {S, S, S, S};
      unsigned psum = 0;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const int i = tid * kG + g;
        if (i >= S) continue;
        const bool v = (vis >> g) & 1;
        const int gp = wadd(ex, pre[g]);
        if (v && gp < p0 && p0 < wadd(gp, pl[kLength][i])) m[0] = min(m[0], i);
        if (i < count && gp >= p0) m[1] = min(m[1], i);
        if (v && pre[g] < pos && pos < wadd(pre[g], plv[g])) {
          m[2] = min(m[2], i);
          psum += (unsigned)pre[g];
        }
        if (i < count && pre[g] >= pos) m[3] = min(m[3], i);
      }
      block_reduce(m, psum, red, out);
      if (tid == 0) {
        xflag[2 * ph] = m[0] < S;
        xflag[2 * ph + 1] = m[1] < S;
      }
      // (d): the n flags → the owner
      cluster.sync();
      int fi = 0, fc = 0;
      if (lane < n) {
        const int* f = cluster.map_shared_rank(xflag + 2 * ph, lane);
        fi = f[0];
        fc = f[1];
      }
      const unsigned bi = __ballot_sync(kFull, fi != 0);
      const unsigned bc = __ballot_sync(kFull, fc != 0);
      const int owner = bi ? __ffs(bi) - 1 : (bc ? __ffs(bc) - 1 : n - 1);
      if (owner == r) {
        const bool has_inside = m[2] < S;
        const int j = m[2];
        const int off = wsub(pos, (int)psum);
        const int shift = has_inside ? 2 : 1;
        const int ns = has_inside ? j + 1 : (m[3] < S ? m[3] : count);
        if (count + shift > S) {
          if (tid == 0) st[1] = 1;
        } else {
          shift_tail<kG>(pl, prop, K, S, ns + 1, shift);
          if (tid == 0) {
            if (has_inside) {
              // the right piece (slot ns + 1) holds the containing slot
              pl[kLength][ns + 1] = wsub(pl[kLength][ns + 1], off);
              pl[kHandleOff][ns + 1] = wadd(pl[kHandleOff][ns + 1], off);
              pl[kLength][j] = off;
            }
            pl[kSeq][ns] = sq;
            pl[kClient][ns] = cl;
            pl[kRemovedSeq][ns] = kNotRemoved;
            pl[kRemovers][ns] = 0;
            pl[kLength][ns] = p1;
            pl[kHandleOp][ns] = p2;
            pl[kHandleOff][ns] = 0;
            for (int k = 0; k < K; ++k) prop[k * S + ns] = 0;
            st[0] = count + shift;
          }
        }
      }
    } else {
      // every shard splits and marks its clipped slice of the range
      const int l0 = min(max(wsub(p0, ex), 0), lv);
      const int l1 = min(max(wsub(p1, ex), 0), lv);
      if (l1 > l0) {
        split_at<kG>(pl, prop, st, K, S, count, l0, vis, plv, pre, red, out);
        scan_visible<kG>(pl, st, S, rs, cl, count, vis, plv, pre, wsum);
        split_at<kG>(pl, prop, st, K, S, count, l1, vis, plv, pre, red, out);
        scan_visible<kG>(pl, st, S, rs, cl, count, vis, plv, pre, wsum);
        const int bit = cl >= 0 ? (int)(1u << (cl > 31 ? 31 : cl)) : 0;
        const int key = p2 >> kPropHandleBits;
        const int handle = p2 & ((1 << kPropHandleBits) - 1);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const int i = tid * kG + g;
          if (!((vis >> g) & 1) || pre[g] < l0 ||
              wadd(pre[g], plv[g]) > l1 || pl[kLength][i] <= 0)
            continue;
          if (kind == kRemove) {
            pl[kRemovedSeq][i] = min(pl[kRemovedSeq][i], sq);
            pl[kRemovers][i] |= bit;
          } else if (key >= 0 && key < K) {
            prop[key * S + i] = handle;
          }
        }
      }
    }
    ph ^= 1;
  }

  __syncthreads();
#pragma unroll
  for (int p = 0; p < kPlanes; ++p)
    for (int i = tid; i < S; i += T) a.plane[p][base + i] = pl[p][i];
  for (int i = tid; i < S * K; i += T)
    a.prop[base * K + i] = prop[(i % K) * S + i / K];
  if (tid == 0) {
    a.count[d * n + r] = st[0];
    a.overflow[d * n + r] = st[1];
  }
  cluster.sync();  // no CTA exits while a neighbour may read its words
}

int threads_for(int S) {
  return S >= kMaxThreads ? kMaxThreads : ((S + 31) / 32) * 32;
}

long long smem_bytes(int S, int K) {
  return ((long long)(kPlanes + K) * S + kScratchWords) * sizeof(int);
}

typedef void (*KernelFn)(Args);

KernelFn kernel_for(int S) {
  const int g = (S + threads_for(S) - 1) / threads_for(S);
  if (g <= 1) return megadoc_apply_kernel<1>;
  if (g <= 2) return megadoc_apply_kernel<2>;
  if (g <= 4) return megadoc_apply_kernel<4>;
  if (g <= 8) return megadoc_apply_kernel<8>;
  return megadoc_apply_kernel<16>;
}

cudaError_t configure(KernelFn fn, int n, int S, int K) {
  if (S < 1 || S > kMaxS || K < 0 || n < 1 || n > kMaxShards ||
      smem_bytes(S, K) > kMaxSmem)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(S, K));
  if (e == cudaSuccess && n > kPortableShards)
    e = cudaFuncSetAttribute(fn,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) cudaGetLastError();  // the refusal is the result
  return e;
}

void fill_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int D,
                 int n, int S, int K, cudaStream_t stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(D * n, 1, 1);
  cfg.blockDim = dim3(threads_for(S), 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(S, K);
  cfg.stream = stream;
  attr = cudaLaunchAttribute{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

}  // namespace

extern "C" {

// Apply (D, O) int32 op planes to D mega-docs of n shards × S slots with K
// property planes, IN PLACE, on ``stream``.
int megadoc_apply_launch(const int* kind, const int* a0, const int* a1,
                         const int* a2, const int* seq, const int* client,
                         const int* ref_seq, int* seq_p, int* client_p,
                         int* removed_seq, int* removers, int* length,
                         int* handle_op, int* handle_off, int* prop_val,
                         int* count, int* overflow, int D, int n, int S,
                         int O, int K, void* stream) {
  Args a = {};
  const int* ops[7] = {kind, a0, a1, a2, seq, client, ref_seq};
  int* planes[kPlanes] = {seq_p,  client_p,  removed_seq, removers,
                          length, handle_op, handle_off};
  for (int i = 0; i < 7; ++i) a.op[i] = ops[i];
  for (int i = 0; i < kPlanes; ++i) a.plane[i] = planes[i];
  a.prop = prop_val;
  a.count = count;
  a.overflow = overflow;
  a.O = O;
  a.S = S;
  a.K = K;
  if (D <= 0 || O <= 0) return 0;
  const KernelFn fn = kernel_for(S);
  cudaError_t e = configure(fn, n, S, K);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fill_config(cfg, attr, D, n, S, K, (cudaStream_t)stream);
  e = cudaLaunchKernelEx(&cfg, fn, a);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// How many clusters of n CTAs at (S, K) the card runs at once (0: such a
// cluster cannot be placed); returns the CUDA error, 0 on success.
int megadoc_apply_active_clusters(int n, int S, int K, int* clusters) {
  *clusters = 0;
  const KernelFn fn = kernel_for(S);
  cudaError_t e = configure(fn, n, S, K);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fill_config(cfg, attr, 1, n, S, K, 0);
  e = cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

long long megadoc_apply_smem_bytes(int S, int K) { return smem_bytes(S, K); }

// The most slots a shard may hold with K property planes.
int megadoc_apply_max_slots(int K) {
  long long s = (kMaxSmem / (long long)sizeof(int) - kScratchWords) /
                (kPlanes + K);
  return (int)(s < kMaxS ? s : kMaxS);
}

int megadoc_apply_max_shards() { return kMaxShards; }

int megadoc_apply_portable_shards() { return kPortableShards; }

const char* megadoc_apply_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
