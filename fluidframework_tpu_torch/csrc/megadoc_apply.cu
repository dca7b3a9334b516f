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
// shared memory for the whole op loop, and an all-gather is each CTA
// storing its words into every neighbour's shared memory (distributed
// shared memory, ``st.async``) where the neighbour's mbarrier counts
// them.
//
// Slot layout. Warp w owns the contiguous chunk of 32·kG slots from
// cb = w·32·kG, and lane l holds the slots cb + 32·g + l (g < kG): for a
// fixed g the 32 lanes of a warp touch 32 consecutive words, so every
// shared-memory access of the op loop hits 32 distinct banks. Scans,
// reductions and marks are done by each slot's own lane; only the move
// pass reads slots of other lanes, between barriers.
//
// Per op, in column order (NOOP pads are skipped by every CTA alike):
//   (a) a block scan of the perspective-visible lengths over [0, count)
//       (row scans with ``__shfl_up_sync``, carried across rows, then the
//       warp totals through one barrier) gives each slot's local exclusive
//       prefix, the shard's total and three facts: count > 0, whether the
//       last active slot adds no visible length, and whether every
//       visible length and the total are small enough that no prefix of
//       the doc can wrap;
//   (b) the exchange of (total, facts); the lanes of each warp sum the
//       totals of the lower ranks into ``ex``;
//   insert: the owner is the first shard with a visible segment strictly
//       containing pos, else the first with an active slot at a global
//       prefix >= pos, else the last shard. Where every shard's facts say
//       no prefix wraps, the totals decide it: the shard whose open
//       interval (ex_s, ex_s + total_s) holds pos, else the first at or
//       past pos with an active slot or ending at pos with a last slot
//       that adds nothing, else the last; only the owner then runs its
//       block reduction (its local insert site). Otherwise every shard
//       reduces its (inside, candidate) flags at the global position and
//       a second exchange picks the owner from them, as ``_shard_step``
//       does. The owner inserts at pos - ex, or sets its sticky overflow
//       flag when count would pass S;
//   remove / annotate: every shard clips [start, end) - ex to
//       [0, local total]; when the clipped range is not empty, ONE block
//       reduction finds both split slots, and the splits, the marks of
//       whole slots and the marks of the split pieces are all applied in
//       one move pass, as ``merge_tree._range_one`` (split, split, mark)
//       does. A split changes lengths, not visibility, and a slot's pieces
//       sum to its length, so every slot keeps the prefix the first scan
//       gave it and the pieces' prefixes follow arithmetically.
//   The move pass: final slot t takes old slot t - δ(t), δ = 0, 1 or 2 by
//   position (a boundary insert moves [ns, count) by 1, a split insert
//   [j, count) by 2, a range op's two splits by 1 and then 2); only
//   [lo, count_new) is written. Marked whole slots are written in place
//   by their lanes first; then every thread of the CTA takes two of each
//   2·T moving slots, reads their sources in all planes into registers,
//   one barrier, writes them, one barrier; the lanes that own the new
//   segment and the split pieces write those last. The work spreads over
//   all warps, whichever chunk the edit falls in, and costs two barriers
//   (three for a range op that marks), not two a plane.
// Nothing past ``count`` is read or moved in the op loop: count only
// grows and every move starts at or below it, so the tail just slides
// right by Δ = count_end - count_start. At the end the dead tail
// [count_end, S) of shared memory is filled from the launch's input in
// device memory (still unwritten then): slot t takes input slot t - Δ,
// bit-identical to the plain version's rolled tail whatever it holds.
// Then one barrier and the write-back (of [0, count_end) alone when
// Δ = 0). Only the live extent [0, count_start) is loaded at the start.
//
// Synchronisation. An exchange stores two words as slot r of a buffer in
// every CTA of the cluster (one lane a destination, ``st.async``, the
// bytes counted on that CTA's mbarrier); one thread arms its CTA's
// mbarrier for the n·8 bytes and every thread waits on it for the phase
// in which they all landed. Buffers and mbarriers alternate by exchange,
// and a CTA cannot push into a buffer again before every CTA has pushed
// for the exchange between, which it does only after a block barrier that
// follows its reads (nor arm an mbarrier before its previous phase
// completed). Pushing through ``st.shared::cluster`` and a release
// arrive, or through split cluster barriers, measured slower on the card.
// The scan's warp totals are double-buffered by op parity, so a scan and
// a reduction take one block barrier each: per insert the owner passes 4
// block barriers
// and every other shard 1, with one exchange; a remove / annotate 2-5 and
// one exchange. The kernel begins with a cluster barrier (every CTA runs,
// its mbarriers set, before any push) and ends with one (no CTA exits
// while a neighbour may still write to it). Sums and comparisons wrap
// like int32. The marks of the split pieces assume what the merge tree
// keeps true in [0, count): at most one visible segment strictly contains
// a position (lengths >= 0, no prefix wraps).
//
// What bounds it. Bytes would: the state planes read and written once
// and the op planes read once, 2·(7+K)·4·D·n·S + 7·4·D·O bytes (about
// 0.06 ms at D = 64, n = 8, S = 4,096, K = 4, O = 512 at 3.35 TB/s). But a
// document's ops are a serial chain, each resolving its position against
// the prefix the previous op left, so the kernel is bound by the latency
// of its per-op scans, reductions, moves and barriers, and by how many
// clusters the card holds at once (a CTA takes ~180 KB of shared memory
// at S = 4,096, so one CTA an SM, and a cluster needs n free SMs of one
// GPC). The design above takes the bank conflicts, the S-wide tail moves
// and the per-plane barriers out of that chain, and spreads a move over
// the whole CTA (a move confined to the chunks it touches was measured
// to cost ~28 k cycles an edit at S = 4,096).
//
// Limits: S (slots a shard) <= kMaxS and the CTA's shared memory
// ((7 + K)·S + scratch words) <= 227 KB; n <= 8 (portable), or 16 where
// the card places a non-portable cluster of that size
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
constexpr int kMaxG = 16;
constexpr int kMaxS = 8192;
constexpr int kPortableShards = 8;
constexpr int kMaxShards = 16;
constexpr int kMaxSmem = 232448;
constexpr int kNone = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// plane order, in the argument list and in shared memory (the property
// planes follow: plane kPlanes + k is property k, every plane S words)
enum { kSeq, kClient, kRemovedSeq, kRemovers, kLength, kHandleOp,
       kHandleOff, kPlanes };

// scratch words after the planes (from an 8-byte aligned word): scan warp
// totals [2][kMaxWarps] (by op parity), reduction partials [8][kMaxWarps],
// the scan's per-warp length checks [kMaxWarps] and last-slot flag, the
// exchange buffers [2][kMaxShards][2] and their two mbarriers
constexpr int kWsum = 0;
constexpr int kRed = kWsum + 2 * kMaxWarps;
constexpr int kWflag = kRed + 8 * kMaxWarps;
constexpr int kTrail = kWflag + kMaxWarps;
constexpr int kXin = kTrail + 2;
constexpr int kMbar = kXin + 4 * kMaxShards;
constexpr int kScratchWords = kMbar + 4 + 1;   // + 1: the alignment
static_assert(kXin % 2 == 0 && kMbar % 2 == 0, "8-byte aligned words");
// a visible length below this, with at most kMaxS slots a shard, keeps a
// shard's visible total below 2^31
constexpr unsigned kSaneLength = 1u << 18;
// a shard's visible total below this keeps the doc's, over kMaxShards
// shards, below 2^31
constexpr unsigned kSaneTotal = 1u << 27;
// the move pass: final slots a thread per block, planes a register group
constexpr int kMoveSlots = 2;
constexpr int kGroup = 16;

struct Args {
  const int* op[7];       // kind a0 a1 a2 seq client ref_seq, (D, O)
  int* plane[kPlanes];    // (D, n·S)
  int* prop;              // (D, n·S, K)
  int* count;             // (D, n)
  int* overflow;          // (D, n)
  int O, S, K;
};

// What one op does to a shard's slots in the move pass. Final slot t in
// [a, cnt_new) takes old slot t - δ(t): δ = 1 below ``b``, 2 from ``b``
// (slots below ``a`` stay). Slot ``ns`` (>= 0) becomes a new segment;
// split piece q (final slot ft[q], -1 when unused) gets its length
// (flen[q], or the moved length less flen[q] where bit q of ``fsub`` is
// set) and its handle offset plus fhadd[q], and is marked where bit q of
// ``fmark`` is set. Whole slots are marked by their own lanes (the
// ``tgt`` bits).
struct Edit {
  int a, b, cnt_new, ns;
  int sq, cl, len, hop;          // the new segment
  int ft[4], flen[4], fhadd[4];
  unsigned fsub, fmark;
  int mkind, msq, mbit, mkey, mhandle;   // the mark (mkind < 0: none)
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The exchange. Each CTA stores its two words as slot r of the buffer in
// CTA q's shared memory (one lane per q) with ``st.async``, which counts
// the 8 bytes on q's mbarrier as they land; one thread of each CTA arms
// its own mbarrier for the n·8 bytes of the phase (one arrival), and
// every thread waits on it: when the phase completes, every CTA's words
// are here.
__device__ __forceinline__ void xpush(int* buf, unsigned long long* mbar,
                                      int r, int q, int w0, int w1) {
  unsigned a, m;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a) : "r"(saddr(buf + 2 * r)), "r"(q));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(m) : "r"(saddr(mbar)), "r"(q));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.s32 "
      "[%0], {%1, %2}, [%3];"
      :: "r"(a), "r"(w0), "r"(w1), "r"(m) : "memory");
}

__device__ __forceinline__ void xexpect(unsigned long long* mbar,
                                        int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(saddr(mbar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void xwait(unsigned long long* mbar,
                                      unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(saddr(mbar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void xinit(unsigned long long* mbar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(saddr(mbar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ bool marks_plane(const Edit& e, int p) {
  return (e.mkind == kRemove && (p == kRemovedSeq || p == kRemovers)) ||
         (e.mkind == kAnnotate && p == kPlanes + e.mkey);
}

__device__ __forceinline__ int mark(const Edit& e, int p, int v) {
  if (e.mkind == kRemove) {
    if (p == kRemovedSeq) return min(v, e.msq);
    if (p == kRemovers) return v | e.mbit;
  } else if (e.mkind == kAnnotate && p == kPlanes + e.mkey) {
    return e.mhandle;
  }
  return v;
}

__device__ __forceinline__ int fresh(const Edit& e, int p) {
  switch (p) {
    case kSeq: return e.sq;
    case kClient: return e.cl;
    case kRemovedSeq: return kNotRemoved;
    case kLength: return e.len;
    case kHandleOp: return e.hop;
    default: return 0;   // removers, handle offset, properties
  }
}

// Perspective-visible lengths of the lane's kG slots in [0, count), their
// local exclusive prefixes and the shard's total (one barrier; ``wsum``
// is this op's parity buffer). Bit g of ``vis`` marks a visible slot.
// ``chk`` gets, per warp, whether every visible length is below
// kSaneLength, and (at chk[kTrail - kWflag]) whether the last active
// slot adds no visible length.
template <int kG>
__device__ int scan_visible(const int* sm, int S, int count, int rs, int cl,
                            int cb, unsigned& vis, int (&plv)[kG],
                            int (&pre)[kG], int* wsum, int* chk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int sh = cl < 0 ? 0 : (cl > 31 ? 31 : cl);
  vis = 0;
  unsigned run = 0;
  if (cb < count) {   // warp-uniform: chunks past count skip their loads
    unsigned inc[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int i = cb + 32 * g + lane;
      int x = 0;
      if (i < count) {
        const bool ins = sm[kSeq * S + i] <= rs || sm[kClient * S + i] == cl;
        const bool rem = sm[kRemovedSeq * S + i] <= rs ||
                         (((sm[kRemovers * S + i] >> sh) & 1) != 0 && cl >= 0);
        if (ins && !rem) {
          vis |= 1u << g;
          x = sm[kLength * S + i];
        }
      }
      plv[g] = x;
      inc[g] = (unsigned)x;
      if (i == count - 1) chk[kTrail - kWflag] = x == 0;
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const unsigned y = __shfl_up_sync(kFull, inc[g], d);
        if (lane >= d) inc[g] += y;
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      pre[g] = (int)(run + inc[g] - (unsigned)plv[g]);
      run += __shfl_sync(kFull, inc[g], 31);
    }
  } else {
#pragma unroll
    for (int g = 0; g < kG; ++g) plv[g] = pre[g] = 0;
  }
  bool sane = true;
#pragma unroll
  for (int g = 0; g < kG; ++g) sane &= (unsigned)plv[g] < kSaneLength;
  sane = __all_sync(kFull, sane);
  if (lane == 0) {
    wsum[warp] = (int)run;
    chk[warp] = sane;
  }
  __syncthreads();
  const unsigned w = lane < nwarps ? (unsigned)wsum[lane] : 0u;
  const unsigned off = __reduce_add_sync(kFull, lane < warp ? w : 0u);
#pragma unroll
  for (int g = 0; g < kG; ++g) pre[g] = (int)((unsigned)pre[g] + off);
  return (int)__reduce_add_sync(kFull, w);
}

// Block reduction of the minima m[M0, M0 + NM) and the wrapping sums
// s[0, NS) (one barrier); every thread gets the results. The partials are
// read before the next op's scan barrier and written after it, so one
// buffer suffices.
template <int M0, int NM, int NS>
__device__ void block_reduce(int (&m)[4], unsigned (&s)[4], int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int q = M0; q < M0 + NM; ++q) m[q] = __reduce_min_sync(kFull, m[q]);
#pragma unroll
  for (int q = 0; q < NS; ++q) s[q] = __reduce_add_sync(kFull, s[q]);
  if (lane == 0) {
#pragma unroll
    for (int q = M0; q < M0 + NM; ++q) red[q * kMaxWarps + warp] = m[q];
#pragma unroll
    for (int q = 0; q < NS; ++q) red[(4 + q) * kMaxWarps + warp] = (int)s[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = M0; q < M0 + NM; ++q)
    m[q] = __reduce_min_sync(
        kFull, lane < nwarps ? red[q * kMaxWarps + lane] : kNone);
#pragma unroll
  for (int q = 0; q < NS; ++q)
    s[q] = __reduce_add_sync(
        kFull, lane < nwarps ? (unsigned)red[(4 + q) * kMaxWarps + lane] : 0u);
}

// The move pass of one edit over all P planes (see the header). (1) The
// marked whole slots are written in place by their own lanes. (2) When the
// edit moves slots, the final slots [a, cnt_new) are spread over every
// thread, top-down in blocks of kMoveSlots·T: each thread reads the
// sources (slot t - δ(t)) of its slots for up to kGroup planes into
// registers, one barrier, then writes them; a lower block reads only below
// where this one writes, and every write of a block follows every read of
// the blocks above it, so one barrier a block (and plane group) suffices.
// (3) After one more barrier the lanes that own the new segment's slot and
// the split pieces write them (patching them as they are stored by every
// thread measured slower on the card). ``shifts`` and ``e`` are
// block-uniform; the ``tgt`` bits are the lane's own.
template <int kG>
__device__ void move_pass(int* sm, int S, int P, int cb, unsigned tgt,
                          const Edit& e, bool shifts) {
  const int lane = threadIdx.x & 31, tid = threadIdx.x, T = blockDim.x;
  if (tgt) {
    for (int p = 0; p < P; ++p) {
      if (!marks_plane(e, p)) continue;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if ((tgt >> g) & 1) {
          const int i = cb + 32 * g + lane;
          sm[p * S + i] = mark(e, p, sm[p * S + i]);
        }
      }
    }
  }
  if (!shifts) return;
  if (e.mkind >= 0) __syncthreads();   // the marks land before the reads
  const int from = e.a;
  for (int p0 = 0; p0 < P; p0 += kGroup) {
    for (int hi = e.cnt_new; hi > from; hi -= kMoveSlots * T) {
      const int base = hi - kMoveSlots * T;
      int v[kMoveSlots][kGroup];
#pragma unroll
      for (int k = 0; k < kMoveSlots; ++k) {
        const int t = base + k * T + tid;
        if (t < from) continue;
        const int src = t - (t < e.b ? 1 : 2);
#pragma unroll
        for (int q = 0; q < kGroup; ++q)
          if (p0 + q < P) v[k][q] = sm[(p0 + q) * S + src];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kMoveSlots; ++k) {
        const int t = base + k * T + tid;
        if (t < from) continue;
#pragma unroll
        for (int q = 0; q < kGroup; ++q)
          if (p0 + q < P) sm[(p0 + q) * S + t] = v[k][q];
      }
    }
  }
  __syncthreads();
  // the new segment and the split pieces, by the lanes that own them
  const int lo = cb, hi = cb + 32 * kG;
  if (e.ns >= lo && e.ns < hi && (e.ns & 31) == lane) {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) sm[p * S + e.ns] = fresh(e, p);
    for (int p = kPlanes; p < P; ++p) sm[p * S + e.ns] = 0;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int t = e.ft[q];
    if (t < lo || t >= hi || (t & 31) != lane) continue;
    int f[kPlanes];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) f[p] = sm[p * S + t];
    f[kLength] = (e.fsub >> q) & 1 ? wsub(f[kLength], e.flen[q]) : e.flen[q];
    f[kHandleOff] = wadd(f[kHandleOff], e.fhadd[q]);
    const bool marked = (e.fmark >> q) & 1;
    if (marked) {
      f[kRemovedSeq] = mark(e, kRemovedSeq, f[kRemovedSeq]);
      f[kRemovers] = mark(e, kRemovers, f[kRemovers]);
    }
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) sm[p * S + t] = f[p];
    if (marked && e.mkind == kAnnotate)
      sm[(kPlanes + e.mkey) * S + t] = e.mhandle;
  }
}

// Split piece q at final slot t: its length (``len``, or the moved length
// less ``len`` when ``sub``), handle offset + hadd, and its mark.
__device__ __forceinline__ void set_piece(Edit& e, int q, int t, bool sub,
                                          int len, int hadd, bool marked) {
  e.ft[q] = t;
  e.flen[q] = len;
  e.fhadd[q] = hadd;
  if (sub) e.fsub |= 1u << q;
  if (marked) e.fmark |= 1u << q;
}

// Whether a visible piece at prefix ``pre`` of length ``len`` is marked by
// a range op over [l0, l1) (``merge_tree._range_one``'s target).
__device__ __forceinline__ bool covered(int pre, int len, int l0, int l1) {
  return pre >= l0 && wadd(pre, len) <= l1 && len > 0;
}

template <int kG>
__global__ void __launch_bounds__(kMaxThreads)
megadoc_apply_kernel(Args a) {
  extern __shared__ int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int d = blockIdx.x / n;
  const int S = a.S, K = a.K, O = a.O, P = kPlanes + K;
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int cb = (tid >> 5) * 32 * kG;

  int* sm = smem;                 // plane p at sm + p·S
  int* scr = smem + ((P * S + 1) & ~1);
  int* red = scr + kRed;
  int* xin = scr + kXin;
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(scr + kMbar);

  const long long base = ((long long)d * n + r) * S;
  const int count0 = a.count[d * n + r];
  int count = count0, ovf = a.overflow[d * n + r];
  const int live = min(max(count0, 0), S);
  // only the live extent is read in the op loop
#pragma unroll
  for (int p = 0; p < kPlanes; ++p)
    for (int i = tid; i < live; i += T) sm[p * S + i] = a.plane[p][base + i];
  for (int i = tid; i < live * K; i += T)
    sm[(kPlanes + i % K) * S + i / K] = a.prop[base * K + i];
  if (tid == 0) {
    xinit(mbar, 1);
    xinit(mbar + 1, 1);
  }
  cluster.sync();  // every CTA runs, its mbarriers set, before a push

  // exchange x (counted in ``xe``) uses buffer and mbarrier x & 1, and
  // waits for that mbarrier's phase x >> 1; every CTA exchanges alike
  int xe = 0;
  auto exchange = [&](int w0, int w1) -> const int* {
    int* buf = xin + (xe & 1) * 2 * kMaxShards;
    if (tid == 0) xexpect(mbar + (xe & 1), 8 * n);
    if (tid < n) xpush(buf, mbar + (xe & 1), r, tid, w0, w1);
    xwait(mbar + (xe & 1), (xe >> 1) & 1);
    ++xe;
    return buf;
  };
  int ph = 0;  // parity of the ops (scan warp totals)
  const int* opk = a.op[0] + (long long)d * O;
  for (int o = 0; o < O; ++o) {
    const int kind = __ldg(opk + o);
    if (kind != kInsert && kind != kRemove && kind != kAnnotate) continue;
    const long long at = (long long)d * O + o;
    const int p0 = __ldg(a.op[1] + at), p1 = __ldg(a.op[2] + at);
    const int p2 = __ldg(a.op[3] + at), sq = __ldg(a.op[4] + at);
    const int cl = __ldg(a.op[5] + at), rs = __ldg(a.op[6] + at);

    unsigned vis;
    int plv[kG], pre[kG];
    const int lv = scan_visible<kG>(sm, S, count, rs, cl, cb, vis, plv, pre,
                                    scr + kWsum + ph * kMaxWarps,
                                    scr + kWflag);
    // (a)-(b): the shards' totals and facts → this shard's exclusive
    // prefix. Facts: bit 0 count > 0, bit 1 the last active slot adds no
    // visible length, bit 2 every visible length below kSaneLength and the
    // total below kSaneTotal (so no prefix of the doc wraps).
    int facts = 0;
    if (tid < 32) {
      const bool sane = __all_sync(
          kFull, lane >= (T >> 5) || scr[kWflag + lane] != 0);
      facts = (count > 0 ? 1 : 0) | (count > 0 && scr[kTrail] ? 2 : 0) |
              (sane && (unsigned)lv < kSaneTotal ? 4 : 0);
    }
    const int* x = exchange(lv, facts);
    const unsigned tot = lane < n ? (unsigned)x[2 * lane] : 0u;
    const int fact = lane < n ? x[2 * lane + 1] : 0;
    const int ex = (int)__reduce_add_sync(kFull, lane < r ? tot : 0u);

    Edit e;
    e.ft[0] = e.ft[1] = e.ft[2] = e.ft[3] = -1;
    e.fsub = e.fmark = 0;
    e.ns = -1;
    e.mkind = -1;
    e.cnt_new = count;
    bool shifts = false;
    unsigned tgt = 0;
    if (kind == kInsert) {
      // The owner from the totals alone, where no visible length is
      // negative or too long and the doc's total fits int32 (so no prefix
      // wraps): the shard whose open interval (ex_s, ex_s + total_s)
      // holds pos owns the insert (no earlier shard has a segment
      // containing pos or an active slot at or past it, and it has one
      // of the two); else the first shard with an active slot at a global
      // prefix >= pos: a shard at or past pos with any active slot, or the
      // one ending at pos whose last active slot adds no visible length;
      // else the last shard. That is the plain version's rule. Otherwise
      // the flags are exchanged, as in ``_shard_step``.
      unsigned inc = tot;
#pragma unroll
      for (int dd = 1; dd < kMaxShards; dd <<= 1) {
        const unsigned y = __shfl_up_sync(kFull, inc, dd);
        if (lane >= dd) inc += y;
      }
      const int exs = (int)(inc - tot), end = (int)inc;
      int owner = -1;
      if (__all_sync(kFull, lane >= n || (fact & 4))) {
        const bool strict = lane < n && exs < p0 && p0 < end;
        const bool cand = lane < n && (exs >= p0 ? (fact & 1) != 0
                                                 : end == p0 &&
                                                       (fact & 2) != 0);
        const unsigned bs = __ballot_sync(kFull, strict);
        const unsigned bc = __ballot_sync(kFull, cand);
        owner = bs ? __ffs(bs) - 1 : (bc ? __ffs(bc) - 1 : n - 1);
      }
      // (c): owner flags at the global position, local insert site
      const int pos = wsub(p0, ex);
      int m[4] = {S, S, S, S};
      unsigned s[4] = {0u, 0u, 0u, 0u};
      if (owner < 0 || owner == r) {   // block-uniform
        if (cb < count) {
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            const int i = cb + 32 * g + lane;
            if (i >= count) continue;
            const bool v = (vis >> g) & 1;
            const int gp = wadd(ex, pre[g]);
            if (v && gp < p0 && p0 < wadd(gp, plv[g])) m[0] = min(m[0], i);
            if (gp >= p0) m[1] = min(m[1], i);
            if (v && pre[g] < pos && pos < wadd(pre[g], plv[g])) {
              m[2] = min(m[2], i);
              s[0] += (unsigned)pre[g];
            }
            if (pre[g] >= pos) m[3] = min(m[3], i);
          }
        }
        if (owner < 0)
          block_reduce<0, 4, 1>(m, s, red);
        else   // the owner alone: its local insert site
          block_reduce<2, 2, 1>(m, s, red);
      }
      if (owner < 0) {
        // (d): the n flags → the owner
        const int* f = exchange(m[0] < S, m[1] < S);
        const unsigned bi = __ballot_sync(kFull, lane < n && f[2 * lane]);
        const unsigned bc = __ballot_sync(kFull, lane < n && f[2 * lane + 1]);
        owner = bi ? __ffs(bi) - 1 : (bc ? __ffs(bc) - 1 : n - 1);
      }
      if (owner == r) {
        const bool has_inside = m[2] < S;
        const int j = m[2];
        const int off = wsub(pos, (int)s[0]);
        const int shift = has_inside ? 2 : 1;
        const int ns = has_inside ? j + 1 : (m[3] < S ? m[3] : count);
        if (count + shift > S) {
          ovf = 1;
        } else {
          shifts = true;
          e.cnt_new = count + shift;
          e.ns = ns;
          e.sq = sq;
          e.cl = cl;
          e.len = p1;
          e.hop = p2;
          if (has_inside) {
            // [j, count) moves by 2: the right piece (slot j + 2) holds
            // the containing slot, the left piece stays at j
            e.a = e.b = j + 2;
            set_piece(e, 0, j, false, off, 0, false);
            set_piece(e, 1, j + 2, true, off, off, false);
          } else {
            e.a = ns + 1;
            e.b = kNone;
          }
        }
      }
    } else {
      // every shard splits and marks its clipped slice of the range
      const int l0 = min(max(wsub(p0, ex), 0), lv);
      const int l1 = min(max(wsub(p1, ex), 0), lv);
      if (l1 > l0) {
        int m[4] = {S, S, S, S};
        unsigned s[4] = {0u, 0u, 0u, 0u};
        if (cb < count) {
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            if (!((vis >> g) & 1)) continue;
            const int i = cb + 32 * g + lane;
            const int end = wadd(pre[g], plv[g]);
            if (pre[g] < l0 && l0 < end) {
              m[0] = min(m[0], i);
              s[0] += (unsigned)pre[g];
              s[1] += (unsigned)plv[g];
            }
            if (pre[g] < l1 && l1 < end) {
              m[1] = min(m[1], i);
              s[2] += (unsigned)pre[g];
              s[3] += (unsigned)plv[g];
            }
            if (pre[g] >= l0 && end <= l1 && plv[g] > 0) tgt |= 1u << g;
          }
        }
        block_reduce<0, 2, 4>(m, s, red);
        const bool has0 = m[0] < S, has1 = m[1] < S;
        const bool do1 = has0 && count + 1 <= S;
        const int c1 = count + (do1 ? 1 : 0);
        const bool do2 = has1 && c1 + 1 <= S;
        if ((has0 && !do1) || (has1 && !do2)) ovf = 1;
        const int P0 = (int)s[0], L0 = (int)s[1];
        const int P1 = (int)s[2], L1 = (int)s[3];
        const int off0 = wsub(l0, P0);
        // both ends in one slot: the second split cuts the first's right
        // piece, whose prefix is P0 + off0
        const bool same = do1 && m[1] == m[0];
        const int off1 = wsub(l1, same ? wadd(P0, off0) : P1);
        e.cnt_new = c1 + (do2 ? 1 : 0);
        if (kind == kRemove) {
          e.mkind = kRemove;
          e.msq = sq;
          e.mbit = cl >= 0 ? (int)(1u << (cl > 31 ? 31 : cl)) : 0;
        } else {
          const int key = p2 >> kPropHandleBits;
          if (key >= 0 && key < K) {
            e.mkind = kAnnotate;
            e.mkey = key;
            e.mhandle = p2 & ((1 << kPropHandleBits) - 1);
          }
        }
        // pieces 0 and 1 (and 2 when both ends fall in one slot) come from
        // the first split, pieces 2 and 3 from the second
        if (do1) {
          const int j0 = m[0], q0 = wadd(P0, off0);
          e.a = j0 + 1;
          e.b = do2 ? m[1] + 2 : kNone;
          set_piece(e, 0, j0, false, off0, 0, covered(P0, off0, l0, l1));
          if (same && do2) {
            const int o2 = wadd(off0, off1);
            set_piece(e, 1, j0 + 1, false, off1, off0,
                      covered(q0, off1, l0, l1));
            set_piece(e, 2, j0 + 2, true, o2, o2,
                      covered(wadd(q0, off1), wsub(L0, o2), l0, l1));
          } else {
            set_piece(e, 1, j0 + 1, true, off0, off0,
                      covered(q0, wsub(L0, off0), l0, l1));
          }
        }
        if (do2 && !same) {
          const int t1 = m[1] + (do1 ? 1 : 0);
          if (!do1) {
            e.a = t1 + 1;
            e.b = kNone;
          }
          set_piece(e, 2, t1, false, off1, 0, covered(P1, off1, l0, l1));
          set_piece(e, 3, t1 + 1, true, off1, off1,
                    covered(wadd(P1, off1), wsub(L1, off1), l0, l1));
        }
        shifts = do1 || do2;
        if (e.mkind < 0) tgt = 0;
      }
    }
    move_pass<kG>(sm, S, P, cb, tgt, e, shifts);
    count = e.cnt_new;
    ph ^= 1;
  }

  // the tail: final slot t >= count takes input slot t - Δ
  const int delta = count - count0;
  if (delta > 0) {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
      for (int t = count + tid; t < S; t += T)
        sm[p * S + t] = a.plane[p][base + t - delta];
    for (int i = count * K + tid; i < S * K; i += T)
      sm[(kPlanes + i % K) * S + i / K] = a.prop[(base - delta) * K + i];
  }
  __syncthreads();
  const int hi = delta > 0 ? S : min(max(count, 0), S);
#pragma unroll
  for (int p = 0; p < kPlanes; ++p)
    for (int i = tid; i < hi; i += T) a.plane[p][base + i] = sm[p * S + i];
  for (int i = tid; i < hi * K; i += T)
    a.prop[base * K + i] = sm[(kPlanes + i % K) * S + i / K];
  if (tid == 0) {
    a.count[d * n + r] = count;
    a.overflow[d * n + r] = ovf;
  }
  cluster.sync();  // no CTA exits while a neighbour may read its words
}

// kG (slots a lane) and the threads of a CTA at S slots a shard: the
// fewest lanes of at most kMaxThreads, kG a power of two up to kMaxG, and
// only the warps whose chunk starts below S.
int slots_per_lane(int S) {
  int g = 1;
  while (g < kMaxG && kMaxThreads * g < S) g *= 2;
  return g;
}

int threads_for(int S) {
  const int chunk = 32 * slots_per_lane(S);
  return 32 * ((S + chunk - 1) / chunk);
}

long long smem_bytes(int S, int K) {
  return ((long long)(kPlanes + K) * S + kScratchWords) * sizeof(int);
}

typedef void (*KernelFn)(Args);

KernelFn kernel_for(int S) {
  switch (slots_per_lane(S)) {
    case 1: return megadoc_apply_kernel<1>;
    case 2: return megadoc_apply_kernel<2>;
    case 4: return megadoc_apply_kernel<4>;
    case 8: return megadoc_apply_kernel<8>;
    default: return megadoc_apply_kernel<16>;
  }
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
  int S = kMaxS;
  while (S > 0 && smem_bytes(S, K) > kMaxSmem) --S;
  return S;
}

// Slots a lane and threads a CTA at S slots a shard.
int megadoc_apply_slots_per_lane(int S) { return slots_per_lane(S); }

int megadoc_apply_threads(int S) { return threads_for(S); }

int megadoc_apply_max_shards() { return kMaxShards; }

int megadoc_apply_portable_shards() { return kPortableShards; }

const char* megadoc_apply_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
