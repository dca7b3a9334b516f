// SharedMatrix permutation axes for NVIDIA Hopper (sm_90a): two kernels.
//
// Replaces two XLA programs of the JAX package's
// fluidframework_tpu/ops/axis_kernel.py:
// - K3 axis_apply (apply_axis_batch, :62): per axis row, a serial scan over
//   the op axis. STR_INSERT (a0 = pos, a1 = count, a2 = run handle) is
//   DROPPED when pos exceeds the visible length at its perspective (pos ==
//   total is kept); STR_REMOVE (a0 = start, a1 = end) splits at both ends
//   and marks what lies between; AXIS_RESOLVE (a0 = pos) emits (run,
//   handle_off + pos - pre) of the visible slot holding pos, or (-1, -1),
//   and mutates nothing. Every other kind leaves the row alone and emits
//   (-1, -1). All three candidates of an op see the state every earlier
//   op of its row left, never a later one.
// - K4 axis_resolve (resolve_axis_positions, :114): the same resolve for a
//   whole (D, O) window against the current state, each op at its own
//   (ref_seq, client); slots whose kind is not AXIS_RESOLVE emit (-1, -1).
// The plain PyTorch versions they are held against live in
// ops/axis_kernel.py (on ops/merge_tree.py's helpers, without props).
//
// What bounds them on this card. K3: a row's ops are a serial chain (each
// op resolves positions against the prefix the previous op left), so a row
// costs a few collectives per op and its latency is the chain's, on one
// warp of one SM when the rows are fewer than the SMs; bytes (the planes
// read and written once, each op's fields read once: 28 B an insert, 24 a
// remove, 16 a resolve, 4 a NOOP) would take microseconds.
// K4: the bytes are the op fields read once and the two outputs written
// once; the work is each resolve's search of its row.
//
// K3 layout. Every op field is staged in shared memory before the serial
// loop reads it, a chunk at a time (the next chunk's loads are in flight
// while the current one runs; the first chunk's before the row is sized),
// so the loop reads no device memory. A CTA of 256 threads takes R =
// min(8, ceil(D / SMs)) rows. Each warp first sizes its row: the live
// extent `hi` (max(count, 1 + the last slot that differs from
// StringState.create's fill)) and m, the inserts and removes of its
// window. A row with min(S, hi + 2m) <= W = min(S, 256) slots can never
// outgrow a warp's region within the window (an op adds at most two
// slots), so its warp runs it alone: the planes in a W-slot region of
// shared memory (W rounded up to 4 slots: 16-byte rows), every collective
// a warp primitive (shuffle scan, __reduce_*_sync, __ballot_sync) and
// __syncwarp, no CTA barrier. A run of consecutive ops that mutate nothing
// sees one state, so the warp answers it lane by lane when that is cheaper
// than one collective resolve after another (32 x the run's resolves >=
// count): lane l takes op j + l and walks the row alone, four slots a step
// (one 16-byte load a plane) with selects only, and the warp stops once
// every lane has found its slot. Rows that do not fit take the block path
// afterwards, one at a time, on the whole CTA and all of its shared memory
// (S <= kMaxS, 229,376 bytes of planes at 8,192 slots; a larger S is
// refused). Both paths share one row machine (AxisRow, on either
// collective): thread t owns the contiguous chunk [t*k, t*k + k) of the
// live slots [0, count), k = ceil(count / threads) <= 32, so every pass is
// bounded by the live extent and not by S. Per op: a visibility pass over
// the chunk (its visibility kept as a bitmask) and one scan of the chunk
// sums give each thread the exclusive visible prefix at its chunk; a
// second pass finds the candidates (containing slot, its prefix, the
// boundary slot) and one fold combines them. An insert or a split then
// rolls slots [from, hi + by) right by 1 or 2 in tiles of the thread
// count from the top: each tile reads its sources into registers, syncs,
// writes them (a lower tile's writes land only on slots whose readers
// passed that sync), and one sync closes the roll. The thread that writes
// the new slot or the split's right piece also writes the left piece's
// length: it is that slot's only reader. A remove finds the slots holding
// both ends in one scan (a split leaves every visible prefix as it was),
// splits them and marks what lies between after a second scan. Slots at
// or past hi are fill and a fill tail rolled right stays fill, and the
// roll's wrapped slot (i < by) is always the new slot, so rolling only
// [from, hi + by) and writing back only [0, hi) gives the plain version's
// full-plane roll bit for bit, slots past count included. Overflow is
// sticky: an insert or split that would pass S sets it and leaves the row.
//
// K4 layout. A grid of (axis row, tile of 1,024 ops); a thread holds 4 ops
// of its tile, loaded coalesced in one round trip, and writes their
// outputs coalesced. The CTA folds its resolves' ref_seq range [lo, hi]
// and stages its row once for all of them. A slot is settled when its
// visibility is the same at every one of those perspectives: invisible to
// all when removed_seq <= lo, visible to all when seq <= lo, removed_seq >
// hi and removers == 0 (visible() at the two extremes; exact for ref_seq
// = INT_MAX and reads at client -1). One block scan gives the inclusive
// prefix P of the settled-visible lengths, and the unsettled slots are
// listed in order with their planes and P. An op walks that list,
// adding each unsettled slot's length where it is visible at the op's own
// (ref_seq, client), and binary-searches P in the settled run that holds
// its position: log(count) plus the unsettled slots, not the walk. With
// more than kUnsettledMax unsettled slots the CTA stages all seven planes
// instead and each warp walks its lanes' ops one by one, 32 slots a step
// with a warp scan, stopping at the step whose ballot finds pos.
//
// Lengths are non-negative and a row's visible length stays below 2^31 in
// every state the engine makes, so at most one slot holds pos and the
// search, the walks' early stops and the plain version's sums over all
// holding slots agree. Sums and prefixes wrap like int32 (unsigned
// arithmetic), as the JAX reference's do. The remover bit test clamps the
// client index to [0, 31] and requires client >= 0 (reads use client -1).
// Plain C ABI (ctypes): the launch functions return a cudaError_t (0 =
// launched) or a negative code for a refused shape.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kNotRemoved = 0x7fffffff;
constexpr int kNumPlanes = 7;
constexpr int kNumFields = 7;
constexpr int kInsert = 0;
constexpr int kRemove = 1;
constexpr int kResolve = 13;
constexpr int kMaxS = 8192;
constexpr int kMaxWarps = 32;
constexpr int kThreads = 256;  // both kernels
constexpr int kWarps = kThreads / 32;
constexpr int kScratchInts = 2 * kMaxWarps * 4;
constexpr unsigned kFull = 0xffffffffu;
// K3
constexpr int kWarpSlots = 256;  // the warp path's region, in slots
constexpr int kWarpChunk = 32;   // ops staged at a time, warp path
constexpr int kBlockChunk = 64;  // ops staged at a time, block path
// K4
constexpr int kResolvePerThread = 4;
constexpr int kResolveTile = kThreads * kResolvePerThread;
constexpr int kUnsettledMax = 128;
constexpr int kEntryInts = 8;  // slot, seq, client, removed, removers, length, P
constexpr long long kMaxResolveOps = 65535LL * 64;  // O refused above this

constexpr int kErrBadShape = -1;
constexpr int kErrSmem = -2;

enum Plane { SEQ = 0, CLIENT, REMOVED, REMOVERS, LENGTH, HOP, HOFF };
enum OpField { F_KIND = 0, F_A0, F_A1, F_A2, F_SEQ, F_CLIENT, F_REF };

struct Args {
  const int* op[kNumFields];  // (D, O) each: kind, a0, a1, a2, seq, client, ref_seq
  int* plane[kNumPlanes];     // (D, S) each
  int* count;                 // (D,)
  int* overflow;              // (D,)
  int* out_run;               // (D, O)
  int* out_off;               // (D, O)
  int D, S, O;
};

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int fill_of(int q) {
  return q == REMOVED ? kNotRemoved : 0;
}

// Visibility of a slot with these planes in perspective (ref, cl).
__device__ __forceinline__ bool visible_at(int seq, int client, int removed,
                                           int removers, int ref, int cl) {
  const unsigned c = static_cast<unsigned>(min(max(cl, 0), 31));
  const bool ins = (seq <= ref) | (client == cl);
  const bool rem = (removed <= ref) |
                   ((cl >= 0) & ((static_cast<unsigned>(removers) >> c) & 1u));
  return ins & !rem;
}

// Slot i of a row whose plane q sits at p[q * stride + i]. The caller
// keeps i below count.
__device__ __forceinline__ bool visible(const int* p, int stride, int i,
                                        int ref, int cl) {
  return visible_at(p[SEQ * stride + i], p[CLIENT * stride + i],
                    p[REMOVED * stride + i], p[REMOVERS * stride + i], ref,
                    cl);
}

struct Fold {
  int v[4];
};

__device__ __forceinline__ int lane4(const int4& x, int t) {
  return t == 0 ? x.x : t == 1 ? x.y : t == 2 ? x.z : x.w;
}

// Exclusive wrapping prefix of v over the warp's lanes, and their total.
__device__ __forceinline__ int warp_scan(int v, int lane, int& total) {
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc = wadd(inc, y);
  }
  total = __shfl_sync(kFull, inc, 31);
  return wsub(inc, v);
}

// The CTA's collectives. Scratch is double-buffered by parity: a buffer is
// written just before a collective's barrier and read just after it, and
// written again only after the next collective's barrier, which every
// reader of the old contents has passed.
struct Block {
  int* red;  // [2][kMaxWarps][4]
  int tid, lane, warp, nw, nt, par;

  __device__ explicit Block(int* scratch) : red(scratch), par(0) {
    tid = threadIdx.x;
    lane = tid & 31;
    warp = tid >> 5;
    nt = blockDim.x;
    nw = nt >> 5;
  }

  __device__ void sync() const { __syncthreads(); }

  // This thread's chunk [lo, hi) of [0, n).
  __device__ void chunk(int n, int& lo, int& hi) const {
    const int k = (n + nt - 1) / nt;
    lo = min(tid * k, n);
    hi = min(lo + k, n);
  }

  // Exclusive wrapping prefixes of two values over the threads, and their
  // totals (one barrier).
  __device__ void scan2(int v0, int v1, int& ex0, int& ex1, int& t0,
                        int& t1) {
    int i0 = v0, i1 = v1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y0 = __shfl_up_sync(kFull, i0, d);
      const int y1 = __shfl_up_sync(kFull, i1, d);
      if (lane >= d) {
        i0 = wadd(i0, y0);
        i1 = wadd(i1, y1);
      }
    }
    int* buf = red + par * kMaxWarps * 4;
    if (lane == 31) {
      buf[warp * 4] = i0;
      buf[warp * 4 + 1] = i1;
    }
    __syncthreads();
    int b0 = 0, b1 = 0, s0 = 0, s1 = 0;
    for (int w = 0; w < nw; ++w) {
      const int c0 = buf[w * 4], c1 = buf[w * 4 + 1];
      if (w < warp) {
        b0 = wadd(b0, c0);
        b1 = wadd(b1, c1);
      }
      s0 = wadd(s0, c0);
      s1 = wadd(s1, c1);
    }
    par ^= 1;
    t0 = s0;
    t1 = s1;
    ex0 = wadd(b0, wsub(i0, v0));
    ex1 = wadd(b1, wsub(i1, v1));
  }

  // Exclusive wrapping prefix of v over the threads, and their total.
  __device__ int scan(int v, int& total) {
    int ex, ex1, t1;
    scan2(v, 0, ex, ex1, total, t1);
    return ex;
  }

  // Fold four ints over the CTA: bit f of kAdd set = wrapping sum, else
  // min.
  template <unsigned kAdd>
  __device__ Fold fold(Fold x) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      x.v[f] = ((kAdd >> f) & 1u)
                   ? static_cast<int>(__reduce_add_sync(
                         kFull, static_cast<unsigned>(x.v[f])))
                   : __reduce_min_sync(kFull, x.v[f]);
    }
    int* buf = red + par * kMaxWarps * 4;
    if (lane == 0) {
#pragma unroll
      for (int f = 0; f < 4; ++f) buf[warp * 4 + f] = x.v[f];
    }
    __syncthreads();
    Fold r;
#pragma unroll
    for (int f = 0; f < 4; ++f) r.v[f] = ((kAdd >> f) & 1u) ? 0 : INT_MAX;
    for (int w = 0; w < nw; ++w) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int c = buf[w * 4 + f];
        r.v[f] = ((kAdd >> f) & 1u) ? wadd(r.v[f], c) : min(r.v[f], c);
      }
    }
    par ^= 1;
    return r;
  }
};

// The same collectives on one warp: shuffles and __syncwarp only.
struct Warp {
  int tid, nt;

  __device__ Warp() : tid(threadIdx.x & 31), nt(32) {}

  __device__ void sync() const { __syncwarp(); }

  __device__ void chunk(int n, int& lo, int& hi) const {
    const int k = (n + 31) >> 5;
    lo = min(tid * k, n);
    hi = min(lo + k, n);
  }

  __device__ int scan(int v, int& total) { return warp_scan(v, tid, total); }

  template <unsigned kAdd>
  __device__ Fold fold(Fold x) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      x.v[f] = ((kAdd >> f) & 1u)
                   ? static_cast<int>(__reduce_add_sync(
                         kFull, static_cast<unsigned>(x.v[f])))
                   : __reduce_min_sync(kFull, x.v[f]);
    }
    return x;
  }
};

// One axis row in shared memory: plane q, slot i at p[q * stride + i]
// (stride >= every extent the row reaches). count, overflow and hi are
// held (uniformly) by every thread of the collective.
template <class C>
struct AxisRow {
  C& b;
  int* p;
  int stride, S, count, overflow, hi;

  __device__ int& at(int q, int i) { return p[q * stride + i]; }

  // Visible prefix at the start of this thread's chunk of [0, count), and
  // the row's visible length at (ref, cl); bit i - lo of vis: slot i is
  // visible (a chunk holds at most 32 slots: S <= 32 x threads).
  __device__ int scan_vis(int ref, int cl, int lo, int hi2, int& total,
                          unsigned& vis) {
    int sum = 0;
    vis = 0;
    for (int i = lo; i < hi2; ++i) {
      if (visible(p, stride, i, ref, cl)) {
        sum = wadd(sum, at(LENGTH, i));
        vis |= 1u << (i - lo);
      }
    }
    return b.scan(sum, total);
  }

  // Roll slots [from, min(hi + by, S)) right by `by`; the thread that
  // writes slot i first lets `edit(i, v)` change the moved values.
  template <class Edit>
  __device__ void roll(int from, int by, Edit edit) {
    const int nh = min(hi + by, S);
    for (int top = nh; top > from; top -= b.nt) {
      const int i = top - b.nt + b.tid;
      const bool act = i >= from;
      int v[kNumPlanes];
#pragma unroll
      for (int q = 0; q < kNumPlanes; ++q) {
        // i < by only for the new slot, which edit() overwrites
        v[q] = act && i - by >= 0 ? at(q, i - by) : 0;
      }
      b.sync();
      if (act) {
        edit(i, v);
#pragma unroll
        for (int q = 0; q < kNumPlanes; ++q) at(q, i) = v[q];
      }
    }
    b.sync();
    hi = nh;
  }

  __device__ void insert(int pos, int len, int handle, int seq, int cl,
                         int ref) {
    int lo, h2, total;
    unsigned vis;
    b.chunk(min(count, S), lo, h2);
    int pre = scan_vis(ref, cl, lo, h2, total, vis);
    if (pos > total) return;  // past the visible length: dropped
    // min containing slot, wrapping sum of its prefix, min boundary slot
    Fold x{{S, 0, count, 0}};
    for (int i = lo; i < h2; ++i) {
      const bool v = (vis >> (i - lo)) & 1u;
      const int e = wadd(pre, v ? at(LENGTH, i) : 0);
      if (v && pre < pos && pos < e) {
        x.v[0] = min(x.v[0], i);
        x.v[1] = wadd(x.v[1], pre);
      }
      if (pre >= pos) x.v[2] = min(x.v[2], i);
      pre = e;
    }
    x = b.template fold<0x2u>(x);
    const bool inside = x.v[0] < S;
    const int by = inside ? 2 : 1;
    if (count + by > S) {  // sticky overflow, the row untouched
      overflow = 1;
      return;
    }
    const int j = x.v[0];
    const int off = wsub(pos, x.v[1]);
    const int ns = inside ? j + 1 : x.v[2];
    roll(ns, by, [&](int i, int* v) {
      if (i == ns) {
        v[SEQ] = seq;
        v[CLIENT] = cl;
        v[REMOVED] = kNotRemoved;
        v[REMOVERS] = 0;
        v[LENGTH] = len;
        v[HOP] = handle;
        v[HOFF] = 0;
      } else if (inside && i == ns + 1) {  // right piece: the old slot j
        v[LENGTH] = wsub(v[LENGTH], off);
        v[HOFF] = wadd(v[HOFF], off);
        at(LENGTH, j) = off;
      }
    });
    count += by;
  }

  // Split slot j at offset off: [0, off) stays at j, the rest moves to j + 1.
  __device__ void split(int j, int off) {
    roll(j + 1, 1, [&](int i, int* v) {
      if (i == j + 1) {
        v[LENGTH] = wsub(v[LENGTH], off);
        v[HOFF] = wadd(v[HOFF], off);
        at(LENGTH, j) = off;
      }
    });
    count += 1;
  }

  // Remove [start, end): split the visible slots strictly containing start
  // and end (both found in one scan: a split leaves every visible prefix
  // as it was), then mark what lies between.
  __device__ void remove(int start, int end, int seq, int cl, int ref) {
    int lo, h2, total;
    unsigned vis;
    b.chunk(min(count, S), lo, h2);
    int pre = scan_vis(ref, cl, lo, h2, total, vis);
    Fold x{{S, 0, S, 0}};  // slot and prefix holding start, then end
    for (int i = lo; i < h2; ++i) {
      const bool v = (vis >> (i - lo)) & 1u;
      const int e = wadd(pre, v ? at(LENGTH, i) : 0);
      if (v && pre < start && start < e) {
        x.v[0] = min(x.v[0], i);
        x.v[1] = wadd(x.v[1], pre);
      }
      if (v && pre < end && end < e) {
        x.v[2] = min(x.v[2], i);
        x.v[3] = wadd(x.v[3], pre);
      }
      pre = e;
    }
    x = b.template fold<0xau>(x);
    int j2 = x.v[2], p2 = x.v[3];
    if (x.v[0] < S) {
      const int j = x.v[0];
      if (count + 1 > S) {
        overflow = 1;
      } else {
        split(j, wsub(start, x.v[1]));
        if (j2 == j) {  // end in the same slot: left or right piece, or none
          if (end > start) {
            j2 = j + 1;
            p2 = start;
          } else if (end == start) {
            j2 = S;
          }
        } else if (j2 < S && j2 > j) {
          j2 += 1;
        }
      }
    }
    if (j2 < S) {
      if (count + 1 > S)
        overflow = 1;
      else
        split(j2, wsub(end, p2));
    }
    mark(start, end, seq, cl, ref);
  }

  // Mark the visible slots inside [start, end) removed at seq by cl.
  __device__ void mark(int start, int end, int seq, int cl, int ref) {
    int lo, h2, total;
    unsigned vis;
    b.chunk(min(count, S), lo, h2);
    int pre = scan_vis(ref, cl, lo, h2, total, vis);
    const int bit =
        cl >= 0 ? static_cast<int>(1u << min(max(cl, 0), 31)) : 0;
    for (int i = lo; i < h2; ++i) {
      const bool v = (vis >> (i - lo)) & 1u;
      const int e = wadd(pre, v ? at(LENGTH, i) : 0);
      if (v && pre >= start && e <= end && at(LENGTH, i) > 0) {
        at(REMOVED, i) = min(at(REMOVED, i), seq);
        at(REMOVERS, i) |= bit;
      }
      pre = e;
    }
    b.sync();
  }

  // (run, offset) of the visible slot holding pos, or (-1, -1).
  __device__ void resolve(int pos, int ref, int cl, int& run, int& off) {
    int lo, h2, total;
    unsigned vis;
    b.chunk(min(count, S), lo, h2);
    int pre = scan_vis(ref, cl, lo, h2, total, vis);
    Fold x{{0, 0, 0, 0}};  // holding slots, sums of hop, hoff, prefix
    for (int i = lo; i < h2; ++i) {
      const bool v = (vis >> (i - lo)) & 1u;
      const int e = wadd(pre, v ? at(LENGTH, i) : 0);
      if (v && pre <= pos && pos < e) {
        x.v[0] += 1;
        x.v[1] = wadd(x.v[1], at(HOP, i));
        x.v[2] = wadd(x.v[2], at(HOFF, i));
        x.v[3] = wadd(x.v[3], pre);
      }
      pre = e;
    }
    x = b.template fold<0xfu>(x);
    run = x.v[0] ? x.v[1] : -1;
    off = x.v[0] ? wsub(wadd(x.v[2], pos), x.v[3]) : -1;
  }

  // Lane by lane, the whole warp: a lane with `mine` finds (run, offset)
  // at its own (pos, ref, cl) alone, walking the row four slots a step
  // with selects only (no branch that splits the lanes); the warp stops
  // once every lane has found its slot or passed the row. pos >= the
  // prefix at every slot a lane passes, so pos < the slot's end finds the
  // holder.
  __device__ void resolve_lanes(bool mine, int pos, int ref, int cl,
                                int& run, int& off) const {
    const int n = min(count, S);
    bool done = !mine || pos < 0;  // every prefix is >= 0
    int pre = 0, hit = -1;
    for (int i0 = 0; i0 < n; i0 += 4) {
      if (__all_sync(kFull, done)) break;
      // slots i0 .. i0 + 3 of a plane in one load (stride % 4 == 0)
      const int4 sq = *reinterpret_cast<const int4*>(p + SEQ * stride + i0);
      const int4 ct = *reinterpret_cast<const int4*>(p + CLIENT * stride + i0);
      const int4 rm = *reinterpret_cast<const int4*>(p + REMOVED * stride + i0);
      const int4 rv = *reinterpret_cast<const int4*>(p + REMOVERS * stride + i0);
      const int4 ln = *reinterpret_cast<const int4*>(p + LENGTH * stride + i0);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const bool v = (i0 + t < n) &
                       visible_at(lane4(sq, t), lane4(ct, t), lane4(rm, t),
                                  lane4(rv, t), ref, cl);
        const int e = wadd(pre, v ? lane4(ln, t) : 0);
        const bool h = !done & v & (pos < e);
        hit = h ? i0 + t : hit;
        done = done | h;
        pre = done ? pre : e;
      }
    }
    run = -1;
    off = -1;
    if (hit >= 0) {
      run = p[HOP * stride + hit];
      off = wsub(wadd(p[HOFF * stride + hit], pos), pre);
    }
  }
};

// A chunk of up to kLen ops of one row, staged in shared memory as
// s[f * kLen + j] (field f of op j). A thread's share of the loads is held
// in registers, so a chunk's loads are in flight while the one before it
// runs.
template <int kLen, int kPer>
struct OpChunk {
  int v[kPer];

  __device__ void load(const Args& a, long long base, int o0, int tid,
                       int nt) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int idx = tid + k * nt;
      const int f = idx / kLen, j = idx - f * kLen;
      v[k] = idx < kNumFields * kLen && o0 + j < a.O
                 ? a.op[f][base + o0 + j]
                 : 0;
    }
  }

  __device__ void store(int* s, int tid, int nt) const {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int idx = tid + k * nt;
      if (idx < kNumFields * kLen) s[idx] = v[k];
    }
  }
};

// Run row d's window of ops through r, staging kLen ops at a time in s;
// `next` holds the first chunk's loads (issued before the row's staging).
// kLanes: a run of ops that mutate nothing may be answered lane by lane
// (warp path).
template <int kLen, int kPer, bool kLanes, class C>
__device__ void run_ops(AxisRow<C>& r, const Args& a, int d, int* s,
                        OpChunk<kLen, kPer>& next) {
  const long long base = static_cast<long long>(d) * a.O;
  const int tid = r.b.tid, nt = r.b.nt;
  for (int o0 = 0; o0 < a.O; o0 += kLen) {
    r.b.sync();  // every reader of the previous chunk is done
    next.store(s, tid, nt);
    r.b.sync();
    if (o0 + kLen < a.O) next.load(a, base, o0 + kLen, tid, nt);
    const int len = min(kLen, a.O - o0);
    int j = 0;
    while (j < len) {
      const int kind = s[F_KIND * kLen + j];
      const int a0 = s[F_A0 * kLen + j];
      const int cl = s[F_CLIENT * kLen + j];
      const int ref = s[F_REF * kLen + j];
      const long long at = base + o0 + j;
      if (kLanes && kind != kInsert && kind != kRemove) {
        // the run of ops from j that mutate nothing (within the chunk, at
        // most 32): one state, so lane l may answer op j + l alone when
        // the walks cost less than the resolves' collectives
        const int k = j + tid;
        const int kk = k < len ? s[F_KIND * kLen + k] : kInsert;
        const unsigned stop = __ballot_sync(kFull, kk == kInsert || kk == kRemove);
        const int run_len = stop ? __ffs(stop) - 1 : 32;
        const int res = __popc(
            __ballot_sync(kFull, tid < run_len && kk == kResolve));
        if (res == 0 || 32 * res >= min(r.count, r.S)) {
          const bool mine = tid < run_len && kk == kResolve;
          int run, off;
          r.resolve_lanes(mine, mine ? s[F_A0 * kLen + k] : 0,
                          mine ? s[F_REF * kLen + k] : 0,
                          mine ? s[F_CLIENT * kLen + k] : 0, run, off);
          if (tid < run_len) {
            a.out_run[at + tid] = run;
            a.out_off[at + tid] = off;
          }
          r.b.sync();
          j += run_len;
          continue;
        }
      }
      int run = -1, off = -1;
      if (kind == kInsert) {
        r.insert(a0, s[F_A1 * kLen + j], s[F_A2 * kLen + j],
                 s[F_SEQ * kLen + j], cl, ref);
      } else if (kind == kRemove) {
        r.remove(a0, s[F_A1 * kLen + j], s[F_SEQ * kLen + j], cl, ref);
      } else if (kind == kResolve) {
        r.resolve(a0, ref, cl, run, off);
      }
      if (tid == 0) {
        a.out_run[at] = run;
        a.out_off[at] = off;
      }
      ++j;
    }
  }
}

// K3. Warp w of CTA c takes row c * rows + w on the warp path when it
// fits a region of W slots; the rows that do not fit run afterwards on
// the whole CTA (block path).
__global__ void __launch_bounds__(kThreads)
    axis_apply_kernel(Args a, int rows, int W) {
  extern __shared__ int smem[];
  __shared__ int red[kScratchInts];
  __shared__ int s_hi;
  __shared__ int s_fit[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = a.S;
  const int d0 = blockIdx.x * rows;

  // ---- warp path
  if (warp < rows && d0 + warp < a.D) {
    const int d = d0 + warp;
    const long long row = static_cast<long long>(d) * S;
    const long long ob = static_cast<long long>(d) * a.O;
    int* p = smem + warp * (kNumPlanes * W + kNumFields * kWarpChunk);
    OpChunk<kWarpChunk, kNumFields> first;  // in flight while the row sizes
    first.load(a, ob, 0, lane, 32);
    const int count = a.count[d];
    const int ovf = a.overflow[d];
    int m = 0;  // inserts and removes of the window
    for (int o = lane; o < a.O; o += 32) {
      const int k = a.op[F_KIND][ob + o];
      m += k == kInsert || k == kRemove;
    }
    m = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(m)));
    int my_hi = 0;
    if (count <= W || S <= W) {  // else hi > W: the block path's row
#pragma unroll 4
      for (int i = lane; i < S; i += 32) {
        bool nonfill = false;
#pragma unroll
        for (int q = 0; q < kNumPlanes; ++q) {
          const int v = a.plane[q][row + i];
          if (i < W) p[q * W + i] = v;
          nonfill |= v != fill_of(q);
        }
        if (nonfill) my_hi = i + 1;
      }
    } else {
      my_hi = S;
    }
    my_hi = __reduce_max_sync(kFull, my_hi);
    const int hi = min(max(my_hi, count), S);
    const bool fit =
        S <= W || (hi <= W && 2LL * m <= static_cast<long long>(W - hi));
    if (lane == 0) s_fit[warp] = fit;
    if (fit) {
      Warp w;
      AxisRow<Warp> r{w, p, W, S, count, ovf, hi};
      run_ops<kWarpChunk, kNumFields, true>(r, a, d, p + kNumPlanes * W,
                                            first);
      __syncwarp();
      for (int i = lane; i < r.hi; i += 32) {
#pragma unroll
        for (int q = 0; q < kNumPlanes; ++q)
          a.plane[q][row + i] = p[q * W + i];
      }
      if (lane == 0) {
        a.count[d] = r.count;
        a.overflow[d] = r.overflow;
      }
    }
  }
  __syncthreads();

  // ---- block path: the rows that did not fit, one at a time
  for (int w = 0; w < rows && d0 + w < a.D; ++w) {
    if (s_fit[w]) continue;  // uniform
    const int d = d0 + w;
    const long long row = static_cast<long long>(d) * S;
    Block b(red);
    int* p = smem;
    constexpr int kPer = (kNumFields * kBlockChunk + kThreads - 1) / kThreads;
    OpChunk<kBlockChunk, kPer> first;
    first.load(a, static_cast<long long>(d) * a.O, 0, tid, kThreads);
    if (tid == 0) s_hi = 0;
    __syncthreads();
    int my_hi = 0;
    for (int i = tid; i < S; i += kThreads) {
      bool nonfill = false;
#pragma unroll
      for (int q = 0; q < kNumPlanes; ++q) {
        const int v = a.plane[q][row + i];
        p[q * S + i] = v;
        nonfill |= v != fill_of(q);
      }
      if (nonfill) my_hi = i + 1;
    }
    my_hi = __reduce_max_sync(kFull, my_hi);
    if (lane == 0) atomicMax(&s_hi, my_hi);
    __syncthreads();
    const int count = a.count[d];
    AxisRow<Block> r{b, p, S, S, count, a.overflow[d],
                     min(max(s_hi, count), S)};
    run_ops<kBlockChunk, kPer, false>(r, a, d, p + kNumPlanes * S, first);
    __syncthreads();
    for (int i = tid; i < r.hi; i += kThreads) {
#pragma unroll
      for (int q = 0; q < kNumPlanes; ++q) a.plane[q][row + i] = p[q * S + i];
    }
    if (tid == 0) {
      a.count[d] = r.count;
      a.overflow[d] = r.overflow;
    }
    __syncthreads();  // the next row restages the shared memory
  }
}

// K4's search over one row: P (inclusive prefix of the settled-visible
// lengths), the run planes, and the unsettled slots' list.
struct Settled {
  const int* P;
  const int* hop;
  const int* hoff;
  const int* list;  // kEntryInts per unsettled slot, in slot order
  int n, nu;

  // (run, offset) at (pos, ref, cl), pos >= 0.
  __device__ void find(int pos, int ref, int cl, int& run, int& off) const {
    int carry = 0;  // the op's visible prefix before slot `from`
    int base = 0;   // P before slot `from`
    int from = 0, to = n;
    for (int u = 0; u < nu; ++u) {
      const int* e = list + u * kEntryInts;
      const int seg = wsub(e[6], base);  // settled run [from, e[0])
      if (wsub(pos, carry) < seg) {
        to = e[0];
        break;
      }
      carry = wadd(carry, seg);
      if (visible_at(e[1], e[2], e[3], e[4], ref, cl)) {
        if (wsub(pos, carry) < e[5]) {
          run = hop[e[0]];
          off = wsub(wadd(hoff[e[0]], pos), carry);
          return;
        }
        carry = wadd(carry, e[5]);
      }
      base = e[6];
      from = e[0] + 1;
    }
    if (to == n) {
      const int seg = wsub(n > 0 ? P[n - 1] : 0, base);
      if (from >= n || !(wsub(pos, carry) < seg)) return;  // past the end
    }
    // the first slot of [from, to) whose P passes the target holds pos
    const int target = wadd(wsub(pos, carry), base);
    int lo = from, hi = to - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (P[mid] > target)
        hi = mid;
      else
        lo = mid + 1;
    }
    const int pre = wadd(carry, wsub(lo > from ? P[lo - 1] : base, base));
    run = hop[lo];
    off = wsub(wadd(hoff[lo], pos), pre);
  }
};

// One warp walks op (pos, ref, cl) through the row staged at p (plane q,
// slot i at p[q * n + i]), 32 slots a step; every lane gets the result.
__device__ void walk_resolve(const int* p, int n, int lane, int pos, int ref,
                             int cl, int& run, int& off) {
  run = -1;
  off = -1;
  int carry = 0;
  for (int c = 0; c < n; c += 32) {
    const int i = c + lane;
    const bool v = i < n && visible(p, n, i, ref, cl);
    const int x = v ? p[LENGTH * n + i] : 0;
    int tot;
    const int pre = wadd(carry, warp_scan(x, lane, tot));
    const unsigned hit =
        __ballot_sync(kFull, v && pre <= pos && pos < wadd(pre, x));
    if (hit) {  // warp-uniform
      const int src = __ffs(hit) - 1;
      const int hop = i < n ? p[HOP * n + i] : 0;
      const int hoff = i < n ? p[HOFF * n + i] : 0;
      run = __shfl_sync(kFull, hop, src);
      off = wsub(wadd(__shfl_sync(kFull, hoff, src), pos),
                 __shfl_sync(kFull, pre, src));
      return;
    }
    carry = wadd(carry, tot);
  }
}

__global__ void __launch_bounds__(kThreads) axis_resolve_kernel(Args a) {
  extern __shared__ int smem[];
  __shared__ int red[kScratchInts];
  const int tid = threadIdx.x, lane = tid & 31;
  const int d = blockIdx.x;
  const int n = min(max(a.count[d], 0), a.S);
  const long long row = static_cast<long long>(d) * a.S;
  const long long ob = static_cast<long long>(d) * a.O;
  const int o0 = blockIdx.y * kResolveTile;
  Block b(red);

  // this thread's ops, and the first of its row slots, in one round trip
  int kind[kResolvePerThread], pos[kResolvePerThread], cl[kResolvePerThread],
      ref[kResolvePerThread];
#pragma unroll
  for (int j = 0; j < kResolvePerThread; ++j) {
    const int o = o0 + j * kThreads + tid;
    const bool in = o < a.O;
    kind[j] = in ? a.op[F_KIND][ob + o] : -1;
    pos[j] = in ? a.op[F_A0][ob + o] : 0;
    cl[j] = in ? a.op[F_CLIENT][ob + o] : 0;
    ref[j] = in ? a.op[F_REF][ob + o] : 0;
  }
  int sv[kNumPlanes];  // not gated on count: no second round trip
#pragma unroll
  for (int q = 0; q < kNumPlanes; ++q)
    sv[q] = tid < a.S ? a.plane[q][row + tid] : fill_of(q);
  int lo = INT_MAX, nhi = INT_MAX;  // min ref_seq, ~max ref_seq
#pragma unroll
  for (int j = 0; j < kResolvePerThread; ++j) {
    if (kind[j] == kResolve) {
      lo = min(lo, ref[j]);
      nhi = min(nhi, ~ref[j]);
    }
  }
  const Fold span = b.fold<0x0u>(Fold{{lo, nhi, 0, 0}});
  lo = span.v[0];
  const int hi = ~span.v[1];
  int run[kResolvePerThread], off[kResolvePerThread];
#pragma unroll
  for (int j = 0; j < kResolvePerThread; ++j) run[j] = off[j] = -1;

  if (lo <= hi) {  // the tile has resolves (CTA-uniform)
    int* P = smem;
    int* hop = P + n;
    int* hoff = hop + n;
    int* list = hoff + n;
    int carry = 0, nu = 0;
    for (int c = 0; c < n; c += kThreads) {
      const int i = c + tid;
      if (c > 0) {
#pragma unroll
        for (int q = 0; q < kNumPlanes; ++q)
          sv[q] = i < n ? a.plane[q][row + i] : fill_of(q);
      }
      const bool none = sv[REMOVED] <= lo;
      const bool all = sv[SEQ] <= lo && sv[REMOVED] > hi && sv[REMOVERS] == 0;
      const int len = i < n && all ? sv[LENGTH] : 0;
      const int open = i < n && !none && !all;
      int ex, ex_u, tot, tot_u;
      b.scan2(len, open, ex, ex_u, tot, tot_u);
      if (i < n) {
        const int pi = wadd(carry, wadd(ex, len));
        P[i] = pi;
        hop[i] = sv[HOP];
        hoff[i] = sv[HOFF];
        const int u = nu + ex_u;
        if (open && u < kUnsettledMax) {
          int* e = list + u * kEntryInts;
          e[0] = i;
          e[1] = sv[SEQ];
          e[2] = sv[CLIENT];
          e[3] = sv[REMOVED];
          e[4] = sv[REMOVERS];
          e[5] = sv[LENGTH];
          e[6] = pi;
        }
      }
      carry = wadd(carry, tot);
      nu += tot_u;
    }
    __syncthreads();
    if (nu <= kUnsettledMax) {
      const Settled st{P, hop, hoff, list, n, nu};
#pragma unroll
      for (int j = 0; j < kResolvePerThread; ++j) {
        if (kind[j] == kResolve && pos[j] >= 0)
          st.find(pos[j], ref[j], cl[j], run[j], off[j]);
      }
    } else {  // the walk: all seven planes staged, a warp per op
      int* p = smem;
      for (int i = tid; i < n; i += kThreads) {
#pragma unroll
        for (int q = 0; q < kNumPlanes; ++q)
          p[q * n + i] = a.plane[q][row + i];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kResolvePerThread; ++j) {
        for (int l = 0; l < 32; ++l) {
          if (__shfl_sync(kFull, kind[j], l) != kResolve) continue;
          int r, f;
          walk_resolve(p, n, lane, __shfl_sync(kFull, pos[j], l),
                       __shfl_sync(kFull, ref[j], l),
                       __shfl_sync(kFull, cl[j], l), r, f);
          if (lane == l) {
            run[j] = r;
            off[j] = f;
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kResolvePerThread; ++j) {
    const int o = o0 + j * kThreads + tid;
    if (o < a.O) {
      a.out_run[ob + o] = run[j];
      a.out_off[ob + o] = off[j];
    }
  }
}

// K3's launch for D rows at capacity S on a card of `sms` SMs: {rows a
// CTA, warp region slots W, dynamic shared memory bytes}. Rows spread over
// the SMs (at most D / SMs a CTA); the block path's region is needed only
// when a row can outgrow W (S > W).
void apply_shape(int D, int S, int sms, int out[3]) {
  const int W = S < kWarpSlots ? (S + 3) & ~3 : kWarpSlots;  // 16 B rows
  int rows = sms > 0 ? (D + sms - 1) / sms : kWarps;
  if (rows > kWarps) rows = kWarps;
  if (rows < 1) rows = 1;
  size_t ints = static_cast<size_t>(rows) *
                (kNumPlanes * W + kNumFields * kWarpChunk);
  if (S > W) {
    const size_t block =
        static_cast<size_t>(kNumPlanes) * S + kNumFields * kBlockChunk;
    if (block > ints) ints = block;
  }
  out[0] = rows;
  out[1] = W;
  out[2] = static_cast<int>(ints * sizeof(int));
}

size_t resolve_smem(int S) {
  const size_t walk = static_cast<size_t>(kNumPlanes) * S;
  const size_t search =
      static_cast<size_t>(3) * S + kUnsettledMax * kEntryInts;
  return (walk > search ? walk : search) * sizeof(int);
}

constexpr int kMaxDevices = 64;

// SMs of the current device (the caller makes the tensors' device
// current), read once per device
int sm_count() {
  static int sms_on[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    cudaGetLastError();
    return 0;
  }
  if (sms_on[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    sms_on[dev] = sms;
  }
  return sms_on[dev];
}

// Opt in to the dynamic shared memory a launch needs (above 48 KB).
template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) cudaGetLastError();  // the refusal is the result
  return e;
}

Args make_args(const int* const* op, int* const* plane, int* count,
               int* overflow, int* out_run, int* out_off, int D, int S,
               int O) {
  Args a;
  for (int f = 0; f < kNumFields; ++f) a.op[f] = op[f];
  for (int q = 0; q < kNumPlanes; ++q) a.plane[q] = plane[q];
  a.count = count;
  a.overflow = overflow;
  a.out_run = out_run;
  a.out_off = out_off;
  a.D = D;
  a.S = S;
  a.O = O;
  return a;
}

}  // namespace

extern "C" {

int axis_max_slots() { return kMaxS; }

// The K3 warp path's region (slots) and K4's largest unsettled list
// (above it, the walk): the tests build rows at both edges.
int axis_warp_slots() { return kWarpSlots; }
int axis_unsettled_max() { return kUnsettledMax; }

// K3: op planes kind, a0, a1, a2, seq, client, ref_seq (D, O); state planes
// seq, client, removed_seq, removers, length, handle_op, handle_off (D, S),
// count and overflow (D,), updated in place; out_run / out_off (D, O).
int axis_apply_launch(const int* kind, const int* a0, const int* a1,
                      const int* a2, const int* seq, const int* client,
                      const int* ref_seq, int* p_seq, int* p_client,
                      int* p_removed, int* p_removers, int* p_length,
                      int* p_hop, int* p_hoff, int* count, int* overflow,
                      int* out_run, int* out_off, int D, int S, int O,
                      void* stream) {
  if (D < 0 || O < 0 || S < 1 || S > kMaxS) return kErrBadShape;
  if (D == 0 || O == 0) return 0;
  const int* op[kNumFields] = {kind, a0, a1, a2, seq, client, ref_seq};
  int* plane[kNumPlanes] = {p_seq, p_client, p_removed, p_removers,
                            p_length, p_hop, p_hoff};
  const Args a = make_args(op, plane, count, overflow, out_run, out_off, D,
                           S, O);
  int shape[3];
  apply_shape(D, S, sm_count(), shape);
  const size_t smem = static_cast<size_t>(shape[2]);
  const cudaError_t e = allow_smem(axis_apply_kernel, smem);
  if (e != cudaSuccess) return kErrSmem;
  const int grid = (D + shape[0] - 1) / shape[0];
  axis_apply_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(a, shape[0],
                                                           shape[1]);
  return static_cast<int>(cudaGetLastError());
}

// K4: kind, pos, client, ref_seq (D, O); the state as above, read only;
// out_run / out_off (D, O).
int axis_resolve_launch(const int* kind, const int* pos, const int* client,
                        const int* ref_seq, const int* p_seq,
                        const int* p_client, const int* p_removed,
                        const int* p_removers, const int* p_length,
                        const int* p_hop, const int* p_hoff, const int* count,
                        int* out_run, int* out_off, int D, int S, int O,
                        void* stream) {
  if (D < 0 || O < 0 || S < 1 || S > kMaxS) return kErrBadShape;
  if (O > kMaxResolveOps) return kErrBadShape;
  if (D == 0 || O == 0) return 0;
  const int tiles = (O + kResolveTile - 1) / kResolveTile;
  const int* op[kNumFields] = {kind,    pos,     nullptr, nullptr,
                               nullptr, client,  ref_seq};
  int* plane[kNumPlanes] = {
      const_cast<int*>(p_seq),      const_cast<int*>(p_client),
      const_cast<int*>(p_removed),  const_cast<int*>(p_removers),
      const_cast<int*>(p_length),   const_cast<int*>(p_hop),
      const_cast<int*>(p_hoff)};
  const Args a = make_args(op, plane, const_cast<int*>(count), nullptr,
                           out_run, out_off, D, S, O);
  const size_t smem = resolve_smem(S);
  const cudaError_t e = allow_smem(axis_resolve_kernel, smem);
  if (e != cudaSuccess) return kErrSmem;
  axis_resolve_kernel<<<dim3(D, tiles), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* axis_error_string(int err) {
  if (err == kErrBadShape)
    return "refused shape: S must be in [1, 8192] and O at most 4,194,240";
  if (err == kErrSmem) return "refused dynamic shared memory opt-in";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
