// Fused batched merge-tree apply (+ zamboni) for NVIDIA Hopper (sm_90a).
//
// Replaces fluidframework_tpu/ops/pallas_string_kernel.py::
// apply_string_batch_pallas (pl.pallas_call at line 208; body _kernel
// :101-160, epilogue _compact :41-87). The Python wrapper and the plain
// PyTorch version it is held against live in ops/string_kernel.py and
// ops/merge_tree.py.
//
// What bounds it on this card. The function must read and write each state
// plane once and read the op planes once: a bytes bound near 0.09 ms at
// config #4 (D=10,240, S=512, O=64). But the O ops of a doc form a serial
// chain: every op resolves its position against the prefix of visible
// lengths that the previous op left. So the kernel is bound by the
// instructions it issues per op (and their latency along the chain), not by
// device memory. The design therefore spends instructions only on the live
// slots and keeps the per-op collectives to a few warp instructions.
//
// Layout. One CTA of W warps per doc. Warp w owns G groups of 32 slots;
// lane l of group g holds slot w*32*G + 32*g + l of every plane. A group is
// the unit of work: its 32 slots are one warp instruction, and a group
// wholly outside the live extent is skipped by a warp-uniform branch.
// - Register tier (S <= 2048: G = 1, 2, 4 or 8, at most 8 warps): the 7
//   state planes live in registers for the whole op loop; loaded from device
//   memory once, written back once. Every register index is a compile-time
//   constant (fully unrolled group loops; the dynamic tests are selects), so
//   nothing falls into local memory. Up to 8 property planes join them for
//   G <= 2 (S <= 512); for larger G, and for any G when K > 8 (such a doc
//   takes at least 4 groups), the property planes live in dynamic shared
//   memory, which keeps every instantiation free of spills and takes any K
//   that fits there. The op fields are staged in shared memory at launch.
// - Shared tier (2048 < S <= 8192: 8 warps, G = 16 or 32): the state planes
//   do not fit in registers and live in shared memory too.
// Shared memory is per-lane storage: a lane reads and writes only its own
// slots there (neighbours' values travel by shuffles and the handoff), so
// both tiers run the same algorithm and the load needs no barrier for it.
// Per op:
// - visibility + exclusive prefix of visible lengths: one warp scan per
//   live group (shuffles), carried across groups;
// - min containing slot, wrapping prefix sum, min boundary slot: one
//   redux.sync per field;
// - shift right by 1 or 2: per live group and plane, __shfl_up_sync by 1 or
//   2 plus __shfl_sync of the previous group's last lanes (descending
//   groups, so the previous group is still unshifted); a warp's lanes 0 (and
//   1) of group 0 take the previous warp's last slots from a handoff that
//   every warp publishes before the reduction's barrier;
// - a split moves the prefix and visibility arrays with the planes and sets
//   the right piece's prefix to pre[j] + off, exactly what a rescan would
//   give (every later slot keeps its prefix, only its index moves), so a
//   remove or annotate scans once for both splits and the marking pass.
// Barriers: one at load. In the op loop a CTA with one active warp needs
// none; otherwise each collective costs one, its cross-warp fold one redux
// per field: 2 per insert (scan, reduction) and 3 per remove or annotate
// (scan, one reduction per split); the shift needs none.
//
// Barrier hygiene. Every barrier goes through Kern::sync(), which flips the
// parity `par`. A scratch buffer is written only in the interval just
// before a barrier, at index par, and read only in the interval just after
// it, at index par ^ 1. The same index is written again at the earliest in
// the interval before the barrier after next, and every reader of the old
// contents has passed the barrier in between. So no barrier is needed after
// a read, and the op loop has no trailing barrier. The scratch is sized by
// K and lives in dynamic shared memory with everything else, so the 48 KB
// opt-in is decided on every byte the CTA uses.
//
// Live extent. At load each CTA computes hi = max(count, 1 + the last slot
// at which any plane it moves differs from its fill), the fills being
// StringState.create's (0, and NOT_REMOVED for removed_seq); each shift
// raises hi by its size, capped at S. Scans, reductions and marking touch
// the groups below count, shifts and the write-back those below hi; the
// warps wholly past hi + 2*O (each op shifts by at most 2) leave after the
// load, and the others synchronise on a named barrier of their own. This is
// exact under the full-plane roll contract: the slots at or past hi are
// fill, a fill tail shifted right stays fill, and the roll's wrapped slot
// (i < by) is always the new slot, which the insert overwrites. A state
// whose tail is not fill (the plain compaction's sorted tail) gets hi = S
// and runs the same code.
//
// Zamboni: a ballot-and-popc scan of the keep flags gives each kept slot
// its destination; each lane writes its kept slots straight to device
// memory and the fill over [kept, hi), zeroing the vacated slots
// (removed_seq = NOT_REMOVED) as the TPU epilogue does.
//
// Sums and prefixes wrap like int32 (unsigned arithmetic), as the JAX
// reference does. Exposed over a plain C ABI (ctypes): string_apply_launch
// returns a cudaError_t (0 = launched) or a negative code for a refused
// shape.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kNotRemoved = 0x7fffffff;
constexpr int kNumPlanes = 7;
constexpr int kNumOps = 7;
constexpr int kRegProps = 8;     // property planes a lane keeps in registers
constexpr int kInsert = 0;
constexpr int kRemove = 1;
constexpr int kAnnotate = 2;
constexpr int kPropBits = 20;
constexpr int kWarps = 8;        // warps per CTA, at most
constexpr int kRegMaxS = 2048;   // register tier up to here
constexpr int kMaxS = 8192;
constexpr unsigned kFull = 0xffffffffu;

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

// Collective scratch at the start of dynamic shared memory, double-buffered
// by barrier parity (see the header): red[2][kWarps][3], the per-warp
// partials ([0] alone for a scan), then hand[2][kWarps][P + 2][2], each
// warp's last ([0]) and second last ([1]) slot of P planes (7 + K, or the
// 15 register planes when the property planes are in registers) and of
// the prefix and visibility arrays.
__host__ __device__ constexpr int scratch_ints(int planes) {
  return 2 * kWarps * 3 + 2 * kWarps * (planes + 2) * 2;
}

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int fill_of(int q) {
  return q == REMOVED ? kNotRemoved : 0;
}

struct Red {
  int j;    // min index of a slot strictly containing the position
  int sum;  // wrapping sum of the prefix over those slots
  int b;    // min index of a boundary candidate
};

template <int G, bool SMEM, bool PROPS>
struct Kern {
  // planes below kRegPlanes live in registers, the others (up to
  // nq = 7 + K) in shared memory: all of them in the shared tier, the
  // property planes when G >= 4; for G <= 2 the host guarantees K <= 8
  static constexpr int kRegPlanes =
      SMEM ? 0 : kNumPlanes + (PROPS && G <= 2 ? kRegProps : 0);
  static constexpr bool kSmemPlanes = SMEM || (PROPS && G > 2);

  int* red;  // scratch: red[(par * kWarps + warp) * 3 + field]
  int* hand;  // scratch: see hand_of()
  int* sp;   // plane q, slot i at sp[(q - kRegPlanes) * S + i]
  int r[kRegPlanes > 0 ? kRegPlanes : 1][SMEM ? 1 : G];
  int pre[G];    // exclusive prefix of visible lengths
  unsigned vm;   // bit g: this lane's slot of group g is visible
  int lane, warp, nw, base, par;  // base: the warp's first slot
  int S, K, nq, count, overflow, hi;

  __device__ Kern(int* scratch, int* planes, int S_, int K_)
      : red(scratch), hand(scratch + 2 * kWarps * 3), sp(planes), vm(0),
        par(0), S(S_), K(K_), nq(kNumPlanes + K_) {
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    nw = blockDim.x >> 5;
    base = warp * 32 * G;
  }

  // Warp w's handoff at parity p: row q (a plane; hand_planes() the
  // prefix, hand_planes() + 1 the visibility) at [2 * q], last slot first.
  // A compile-time row count when every plane is in registers.
  __device__ __forceinline__ int hand_planes() const {
    return kSmemPlanes ? nq : kRegPlanes;
  }
  __device__ __forceinline__ int* hand_of(int p, int w) const {
    return hand + (p * kWarps + w) * (hand_planes() + 2) * 2;
  }
  __device__ __forceinline__ int& red_at(int p, int w, int f) const {
    return red[(p * kWarps + w) * 3 + f];
  }

  // f(q) for every plane of the doc: the register planes in an unrolled
  // loop (q a compile-time constant there), the shared-memory planes in a
  // rolled one.
  template <class F>
  __device__ __forceinline__ void each_plane(F&& f) {
#pragma unroll
    for (int q = 0; q < kRegPlanes; ++q) {
      if (on(q)) f(q);
    }
    if (kSmemPlanes) {
#pragma unroll 1
      for (int q = kRegPlanes; q < nq; ++q) {
        __builtin_assume(q >= kRegPlanes);  // at() never indexes r here
        f(q);
      }
    }
  }

  // Barrier over the CTA's active warps (see load()).
  __device__ __forceinline__ void sync() {
    asm volatile("bar.sync 1, %0;" ::"r"(nw * 32) : "memory");
    par ^= 1;
  }
  __device__ __forceinline__ bool on(int q) const {
    return q < kNumPlanes || (PROPS && q - kNumPlanes < K);
  }
  __device__ __forceinline__ int first(int g) const { return base + 32 * g; }
  __device__ __forceinline__ int slot(int g) const { return first(g) + lane; }
  __device__ __forceinline__ int& shared_at(int q, int g) {
    return sp[(q - kRegPlanes) * S + slot(g)];
  }
  __device__ __forceinline__ int& at(int q, int g) {
    if (q >= kRegPlanes) return shared_at(q, g);
    return r[q < kRegPlanes ? q : 0][SMEM ? 0 : g];
  }
  // at(), or the fill past S (shared memory holds no slot there)
  __device__ __forceinline__ int get(int q, int g) {
    if (q >= kRegPlanes && slot(g) >= S) return fill_of(q);
    return at(q, g);
  }
  __device__ __forceinline__ int vis(int g) const { return (vm >> g) & 1u; }

  __device__ __forceinline__ static int rsum(int v) {
    return static_cast<int>(
        __reduce_add_sync(kFull, static_cast<unsigned>(v)));
  }

  // Wrapping sum over the warps before this one (and over all) of one int
  // per warp; one barrier. A one-warp CTA skips it.
  __device__ int warps_before(int v, int* total) {
    if (nw == 1) {
      *total = v;
      return 0;
    }
    if (lane == 0) red_at(par, warp, 0) = v;
    sync();
    const int t = lane < nw ? red_at(par ^ 1, lane, 0) : 0;
    *total = rsum(t);
    return rsum(lane < warp ? t : 0);
  }

  // Block min j, wrapping sum, min b: one redux per field in each warp,
  // then (more than one warp) one barrier and one redux per field over the
  // warps' partials.
  __device__ Red reduce(Red q) {
    q.j = __reduce_min_sync(kFull, q.j);
    q.sum = rsum(q.sum);
    q.b = __reduce_min_sync(kFull, q.b);
    if (nw == 1) return q;
    if (lane == 0) {
      red_at(par, warp, 0) = q.j;
      red_at(par, warp, 1) = q.sum;
      red_at(par, warp, 2) = q.b;
    }
    sync();
    const int* p = &red_at(par ^ 1, lane < nw ? lane : 0, 0);
    const bool in = lane < nw;
    return Red{__reduce_min_sync(kFull, in ? p[0] : INT_MAX),
               rsum(in ? p[1] : 0),
               __reduce_min_sync(kFull, in ? p[2] : INT_MAX)};
  }

  // --------------------------------------------------------------- shift
  // Publish this warp's last two slots of everything the next shift moves;
  // called before the barrier that precedes the shift.
  template <bool PV>
  __device__ void publish_tail() {
    if (nw == 1 || base >= hi || lane < 30) return;
    int* h = hand_of(par, warp) + (lane == 31 ? 0 : 1);
    each_plane([&](int q) { h[2 * q] = get(q, G - 1); });
    if (PV) {
      h[2 * hand_planes()] = pre[G - 1];
      h[2 * (hand_planes() + 1)] = vis(G - 1);
    }
  }

  // The value slot i - by held (i = this lane's slot of group g): from
  // this group (lanes >= by), the previous group's last lanes, or for group
  // 0 the previous warp's handoff. Thread 0's wrapped values are the roll's
  // wrapped slot, which the insert overwrites.
  __device__ __forceinline__ int moved(int cur, int prev, const int* h,
                                       bool use_h, int by) const {
    const int up = __shfl_up_sync(kFull, cur, by);
    const int wr = __shfl_sync(kFull, prev, lane + 32 - by);
    if (lane >= by) return up;
    return use_h ? h[lane == by - 1 ? 0 : 1] : wr;
  }

  // Roll the tail right by `by` from slot `from`; PV: the prefix and
  // visibility arrays move too (splits, by = 1). Groups descend, so a
  // group's predecessor is still unshifted when it is read.
  template <bool PV>
  __device__ void shift(int from, int by) {
    const int nh = min(hi + by, S);
    const int* h = hand_of(par ^ 1, warp > 0 ? warp - 1 : 0);
#pragma unroll
    for (int g = G - 1; g >= 0; --g) {
      if (first(g) + 31 < from || first(g) >= nh) continue;  // uniform
      const int i = slot(g);
      const bool w = i >= from && i < nh;
      const bool use_h = g == 0 && warp > 0;
      // the shared-memory planes index no register by q: their loop stays
      // rolled, which keeps the largest shapes free of spills
      each_plane([&](int q) {
        const int v = moved(get(q, g), g > 0 ? get(q, g > 0 ? g - 1 : 0) : 0,
                            h + 2 * q, use_h, by);
        if (w) at(q, g) = v;
      });
      if (PV) {
        const int p = moved(pre[g], g > 0 ? pre[g > 0 ? g - 1 : 0] : 0,
                            h + 2 * hand_planes(), use_h, by);
        const int s = moved(vis(g), g > 0 ? vis(g > 0 ? g - 1 : 0) : 0,
                            h + 2 * (hand_planes() + 1), use_h, by);
        if (w) {
          pre[g] = p;
          vm = (vm & ~(1u << g)) | (static_cast<unsigned>(s) << g);
        }
      }
    }
    hi = nh;
  }

  // ----------------------------------------------------------------- ops
  // Visibility in perspective (ref, cl) and the exclusive visible-length
  // prefix of the lane's slots: one warp scan per live group.
  __device__ void scan_vis(int ref, int cl) {
    const unsigned c = static_cast<unsigned>(min(max(cl, 0), 31));
    const int lim = min(count, S);
    int carry = 0;
    vm = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      pre[g] = carry;
      if (first(g) >= lim) continue;  // uniform
      int x = 0;
      if (slot(g) < lim) {
        const bool ins = at(SEQ, g) <= ref || at(CLIENT, g) == cl;
        const bool rem =
            at(REMOVED, g) <= ref ||
            (cl >= 0 && ((static_cast<unsigned>(at(REMOVERS, g)) >> c) & 1u));
        if (ins && !rem) {
          vm |= 1u << g;
          x = at(LENGTH, g);
        }
      }
      int inc = x;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, inc, d);
        if (lane >= d) inc = wadd(inc, y);
      }
      pre[g] = wadd(carry, wsub(inc, x));
      carry = wadd(carry, __shfl_sync(kFull, inc, 31));
    }
    int total;
    const int before = warps_before(carry, &total);
#pragma unroll
    for (int g = 0; g < G; ++g) pre[g] = wadd(pre[g], before);
  }

  // Fold this lane's visible slots strictly containing position p into q.
  __device__ __forceinline__ void containing(int p, Red& q) {
    const int lim = min(count, S);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (first(g) >= lim) continue;
      if (vis(g) && pre[g] < p && p < wadd(pre[g], at(LENGTH, g))) {
        q.j = min(q.j, slot(g));
        q.sum = wadd(q.sum, pre[g]);
      }
    }
  }

  __device__ void insert(int pos, int len, int handle, int seq, int cl,
                         int ref) {
    scan_vis(ref, cl);
    Red q{S, 0, count};
    containing(pos, q);
    const int lim = min(count, S);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (first(g) < lim && slot(g) < lim && pre[g] >= pos) {
        q.b = min(q.b, slot(g));
      }
    }
    publish_tail<false>();
    q = reduce(q);
    const bool inside = q.j < S;
    const int by = inside ? 2 : 1;
    if (count + by > S) {  // leave the doc untouched, set the sticky flag
      overflow = 1;
      return;
    }
    const int j = q.j;
    const int off = wsub(pos, q.sum);
    const int ns = inside ? j + 1 : q.b;
    shift<false>(ns, by);
    // the split's right piece (ns + 1) now holds the old slot j
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (first(g) + 31 < (inside ? j : ns) || first(g) > ns + 1) continue;
      const int i = slot(g);
      if (i == ns) {
        at(SEQ, g) = seq;
        at(CLIENT, g) = cl;
        at(REMOVED, g) = kNotRemoved;
        at(REMOVERS, g) = 0;
        at(LENGTH, g) = len;
        at(HOP, g) = handle;
        at(HOFF, g) = 0;
        each_plane([&](int p) {
          if (p >= kNumPlanes) at(p, g) = 0;
        });
      } else if (inside && i == j) {
        at(LENGTH, g) = off;
      } else if (inside && i == ns + 1) {
        at(LENGTH, g) = wsub(at(LENGTH, g), off);
        at(HOFF, g) = wadd(at(HOFF, g), off);
      }
    }
    count += by;
  }

  // Split the visible segment strictly containing position p; the prefix
  // and visibility arrays stay those of the new state.
  __device__ void split_at(int p) {
    Red q{S, 0, INT_MAX};
    containing(p, q);
    publish_tail<true>();
    q = reduce(q);
    if (q.j >= S) return;         // nothing to split
    if (count + 1 > S) {          // split would overflow: flag, no change
      overflow = 1;
      return;
    }
    const int j = q.j;
    const int off = wsub(p, q.sum);
    shift<true>(j + 1, 1);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (first(g) + 31 < j || first(g) > j + 1) continue;
      const int i = slot(g);
      if (i == j) {
        at(LENGTH, g) = off;
      } else if (i == j + 1) {  // right piece: holds the old slot j
        at(LENGTH, g) = wsub(at(LENGTH, g), off);
        at(HOFF, g) = wadd(at(HOFF, g), off);
        pre[g] = wadd(pre[g], off);
      }
    }
    count += 1;
  }

  // Remove or annotate: split at both perspective boundaries, then mark
  // the visible segments strictly inside. A second split that overflows
  // still leaves the first split in place and the marking runs on what
  // results.
  __device__ void range(int kind, int start, int end_pos, int packed,
                        int seq, int cl, int ref) {
    scan_vis(ref, cl);
    split_at(start);
    split_at(end_pos);
    const int lim = min(count, S);
    const unsigned bit =
        cl >= 0 ? (1u << static_cast<unsigned>(min(cl, 31))) : 0u;
    const int key = packed >> kPropBits;  // arithmetic shift, as in JAX
    const int handle = packed & ((1 << kPropBits) - 1);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (first(g) >= lim || !vis(g)) continue;
      const int len = at(LENGTH, g);
      if (!(pre[g] >= start && wadd(pre[g], len) <= end_pos && len > 0)) {
        continue;
      }
      if (kind == kRemove) {
        at(REMOVED, g) = min(at(REMOVED, g), seq);
        at(REMOVERS, g) = static_cast<int>(
            static_cast<unsigned>(at(REMOVERS, g)) | bit);
      } else if (PROPS && kSmemPlanes) {
        if (key >= 0 && key < K) shared_at(kNumPlanes + key, g) = handle;
      } else if (PROPS) {  // register planes: a select per plane
#pragma unroll
        for (int p = 0; p < kRegPlanes - kNumPlanes; ++p) {
          if (p == key && p < K) at(kNumPlanes + p, g) = handle;
        }
      }
    }
  }

  // ------------------------------------------------------- load / store
  // Load the lane's slots of every plane (register slots past S hold the
  // fill), count and overflow; set hi and the active warps. One barrier.
  // Each op shifts by at most 2, so no slot at or past
  // hi + 2*O is touched in this launch: the warps wholly past it return
  // (their slots are fill and stay so) and the others synchronise on a
  // named barrier of their own.
  __device__ void load(const Args& a, size_t row, int d) {
    int last = 0;  // 1 + the last slot where a moved plane is not fill
    // the shared tier indexes no register here: its loops stay rolled
#pragma unroll(SMEM ? 1 : G)
    for (int g = 0; g < G; ++g) {
      const int i = slot(g);
      each_plane([&](int q) {
        const int x = i >= S ? fill_of(q)
                      : q < kNumPlanes ? a.plane[q][row + i]
                                       : a.prop[(row + i) * K + q - kNumPlanes];
        if (i < S || q < kRegPlanes) at(q, g) = x;
        if (x != fill_of(q)) last = max(last, i + 1);
      });
    }
    count = a.count[d];
    overflow = a.overflow[d];
    last = __reduce_max_sync(kFull, last);
    if (lane == 0) red_at(par, warp, 0) = last;
    __syncthreads();  // also publishes the op fields staged by the caller
    par ^= 1;
    last = __reduce_max_sync(kFull, lane < nw ? red_at(par ^ 1, lane, 0) : 0);
    hi = min(max(count, last), S);
    const int reach = min(S, hi + 2 * a.O);
    nw = min(nw, max(1, (reach + 32 * G - 1) / (32 * G)));
  }

  // Write slots [0, hi) back; slots past hi are fill and were not changed.
  __device__ void store(const Args& a, size_t row) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int i = slot(g);
      if (first(g) >= hi || i >= hi) continue;
      each_plane([&](int q) {
        if (q < kNumPlanes) a.plane[q][row + i] = at(q, g);
        else a.prop[(row + i) * K + (q - kNumPlanes)] = at(q, g);
      });
    }
  }

  // Stable drop of active slots with removed_seq <= ms, written straight
  // to device memory: kept slots to their destinations, fill over
  // [kept, hi).
  __device__ void compact_store(const Args& a, size_t row, int ms) {
    const int lim = min(count, S);
    const unsigned below = (1u << lane) - 1u;
    unsigned keep = 0;
    int carry = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (first(g) >= lim) continue;
      const bool k = slot(g) < lim && !(at(REMOVED, g) <= ms);
      carry += __popc(__ballot_sync(kFull, k));
      if (k) keep |= 1u << g;
    }
    int kept;
    int to = warps_before(carry, &kept);  // the warp's first destination
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (first(g) >= hi) continue;  // no kept slot, nothing to vacate
      const int i = slot(g);
      const bool kp = (keep >> g) & 1u, vacate = i >= kept && i < hi;
      const unsigned bal = __ballot_sync(kFull, kp);
      const int dst = to + __popc(bal & below);
      to += __popc(bal);
      if (!kp && !vacate) continue;
      each_plane([&](int q) {
        const int v = at(q, g);
        if (q < kNumPlanes) {
          if (kp) a.plane[q][row + dst] = v;
          if (vacate) a.plane[q][row + i] = fill_of(q);
        } else {
          const int p = q - kNumPlanes;
          if (kp) a.prop[(row + dst) * K + p] = v;
          if (vacate) a.prop[(row + i) * K + p] = 0;
        }
      });
    }
    count = kept;
  }
};

// Occupancy bounds: the op chain is latency-bound, so G <= 2 (S <= 512,
// config #4) keeps 4 CTAs an SM without props and 3 with (<= 64 and <= 85
// registers a thread); larger shapes may use up to 255 registers, whatever
// their working set needs.
template <int G, bool SMEM, bool PROPS>
constexpr int min_ctas() {
  return G <= 2 && !SMEM ? (PROPS ? 3 : 4) : 1;
}

template <int G, bool SMEM, bool PROPS, bool COMPACT>
__global__ void __launch_bounds__(kWarps * 32, min_ctas<G, SMEM, PROPS>())
    string_apply_kernel(Args a) {
  using K_ = Kern<G, SMEM, PROPS>;
  // dynamic shared memory: the collectives' scratch, the op fields
  // (register tier), then the planes kept there (see kRegPlanes)
  extern __shared__ int smem[];
  const int d = blockIdx.x;
  const int O = a.O;
  const int K = PROPS ? a.K : 0;
  const size_t orow = static_cast<size_t>(d) * O;
  int* ops = smem + scratch_ints(K_::kSmemPlanes ? kNumPlanes + K
                                                 : K_::kRegPlanes);
  if (!SMEM) {
    for (int f = 0; f < kNumOps; ++f) {
      for (int o = threadIdx.x; o < O; o += blockDim.x) {
        ops[f * O + o] = a.op[f][orow + o];
      }
    }
  }
  K_ kn(smem, SMEM ? ops : ops + kNumOps * O, a.S, K);
  const size_t row = static_cast<size_t>(d) * a.S;
  kn.load(a, row, d);
  if (kn.warp >= kn.nw) return;  // past the live extent for the whole batch

  for (int o = 0; o < O; ++o) {
    int op[kNumOps];  // shared tier: uniform loads from device memory
#pragma unroll
    for (int f = 0; f < kNumOps; ++f) {
      op[f] = SMEM ? a.op[f][orow + o] : ops[f * O + o];
    }
    const int kind = op[F_KIND];
    if (kind == kInsert) {
      kn.insert(op[F_A0], op[F_A1], op[F_A2], op[F_SEQ], op[F_CLIENT],
                op[F_REF]);
    } else if (kind == kRemove || kind == kAnnotate) {
      kn.range(kind, op[F_A0], op[F_A1], op[F_A2], op[F_SEQ], op[F_CLIENT],
               op[F_REF]);
    }
  }
  if (COMPACT) {
    kn.compact_store(a, row, a.min_seq[d]);
  } else {
    kn.store(a, row);
  }
  if (threadIdx.x == 0) {
    a.count[d] = kn.count;
    a.overflow[d] = kn.overflow;
  }
}

// Launch shape for capacity S and K property planes: groups of 32 slots
// per warp (G) and warps per CTA (one doc per CTA): the fewest groups (1,
// 2, 4, 8 in the register tier, 16 or 32 in the shared tier) that cover S
// with at most 8 warps, then as many warps as S needs. More than 8
// property planes take at least 4 groups, which keep them in shared memory.
bool pick_shape(int S, int K, int* groups, int* warps) {
  if (S <= 0 || S > kMaxS || K < 0) return false;
  int g = S > kRegMaxS ? 16 : (K > kRegProps ? 4 : 1);
  while (32 * g * kWarps < S) g <<= 1;
  *groups = g;
  *warps = (S + 32 * g - 1) / (32 * g);
  return true;
}

// Dynamic shared memory per CTA, which is all the kernel uses: the
// collectives' scratch, the op fields (register tier) and the planes kept
// there (see kRegPlanes).
long long dyn_smem_bytes(int S, int O, int K) {
  int g = 0, w = 0;
  if (S > kRegMaxS || !pick_shape(S, K, &g, &w)) {
    return 4LL * (scratch_ints(kNumPlanes + K) + (kNumPlanes + K) * S);
  }
  // property planes in shared memory from 4 groups, else all in registers
  // (the handoff then has rows for all 8 of them: Kern::hand_planes)
  const bool smem_props = K > 0 && g > 2;
  const int hand_planes =
      smem_props || K == 0 ? kNumPlanes + K : kNumPlanes + kRegProps;
  return 4LL * (scratch_ints(hand_planes) + (smem_props ? K * S : 0) +
                static_cast<long long>(kNumOps) * O);
}

template <int G, bool SMEM, bool PROPS, bool COMPACT>
int launch(const Args& a, int warps, size_t smem, cudaStream_t stream) {
  auto kernel = string_apply_kernel<G, SMEM, PROPS, COMPACT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<a.D, warps * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int G, bool SMEM, bool PROPS>
int launch_g(const Args& a, int warps, size_t smem, cudaStream_t stream) {
  return a.min_seq != nullptr
             ? launch<G, SMEM, PROPS, true>(a, warps, smem, stream)
             : launch<G, SMEM, PROPS, false>(a, warps, smem, stream);
}

template <bool PROPS>
int launch_shape(const Args& a, int groups, int warps, size_t smem,
                 cudaStream_t st) {
  if (a.S > kRegMaxS) {
    return groups == 16 ? launch_g<16, true, PROPS>(a, warps, smem, st)
                        : launch_g<32, true, PROPS>(a, warps, smem, st);
  }
  switch (groups) {
    case 1: return launch_g<1, false, PROPS>(a, warps, smem, st);
    case 2: return launch_g<2, false, PROPS>(a, warps, smem, st);
    case 4: return launch_g<4, false, PROPS>(a, warps, smem, st);
    default: return launch_g<8, false, PROPS>(a, warps, smem, st);
  }
}

}  // namespace

extern "C" {

long long string_apply_smem_bytes(int D, int S, int O, int K) {
  (void)D;
  return dyn_smem_bytes(S, O, K);
}

// Launch shape for capacity S and K property planes (0: no props): slots
// per lane (groups) and threads per CTA (one doc per CTA). Returns 0, or
// kErrBadShape when the kernel refuses the shape.
int string_apply_shape(int S, int K, int* slots_per_lane, int* threads) {
  int warps = 0;
  if (!pick_shape(S, K, slots_per_lane, &warps)) return kErrBadShape;
  *threads = warps * 32;
  return 0;
}

const char* string_apply_error_string(int code) {
  if (code == kErrBadShape) {
    return "unsupported shape (capacity outside 1..8192, no docs or a "
           "negative count)";
  }
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
  int groups = 0, warps = 0;
  if (D <= 0 || O < 0 || !pick_shape(S, K, &groups, &warps)) {
    return kErrBadShape;
  }
  const long long smem = dyn_smem_bytes(S, O, K);
  if (smem > 232448) return kErrSmem;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return K > 0 ? launch_shape<true>(a, groups, warps, smem, st)
               : launch_shape<false>(a, groups, warps, smem, st);
}

}  // extern "C"
