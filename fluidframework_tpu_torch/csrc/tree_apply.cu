// SharedTree record scan for NVIDIA Hopper (sm_90a): two kernels.
//
// Replaces the XLA programs of the JAX package's
// fluidframework_tpu/ops/tree_kernel.py:
// - K5 tree_apply (apply_tree_batch, :321, through apply_tree_planes, :367,
//   and the scan half of apply_tree_wire, :379): per doc, a serial scan of
//   its (9, D, O) record column in order. Group flags (ok_ins / ok_txn,
//   reset to 1 at the start of every launch, as in every JAX apply call),
//   INSERT into the lowest free slot (a nested record also needs its
//   parent's created_seq == seq; an insert that would apply but finds no
//   free slot sets the sticky overflow flag and changes nothing), REMOVE
//   of the whole subtree (splice, then all eight planes of every subtree
//   slot cleared), MOVE unless the destination lies in the moved subtree
//   (splice out, then attach), last-writer-wins SET_VALUE. Solo kinds
//   (9-12) are their base kind (k - 4) without the flags; kind 13 resets
//   both flags and ANDs ok_txn with "node exists". Two modes: planes (plane
//   8 holds each record's seq) and wire (plane 8 holds each record's
//   first-of-op bit and the seq is base[d] + the running count of those
//   bits - 1, int32 wrapping, which fuses the JAX cumsum).
// - K6 tree_expand (the expansion half of apply_tree_wire, :379): each
//   wire record decodes kind = cols[r,0] & 0xF and meta = cols[r,0] >> 4,
//   gathers node / parent / after / field / value / type through the four
//   batch-local maps (an index past a map's end is clamped to its last
//   entry, XLA's gather), and lands kind, the six handles, meta & 1 and the
//   first-of-op bit (meta >> 1) & 1 in the (9, D, o) buffer at (row, pos);
//   every other cell of the buffer is 0, and a record with pos >= o or
//   row >= D is padding and is dropped. Each lane is read at the width it
//   was shipped (ids and values u16 or u32, pos u8 or u16: eight
//   instantiations); the host never widens the wire.
// The plain PyTorch versions they are held against live in
// ops/tree_kernel.py.
//
// What bounds them on this card. K5: a doc's records are a serial chain
// (each lookup reads what the previous record left). The bytes it must
// move are counted by record kind: each active doc's node_id plane, an
// insert's anchor / parent reads and the slots it writes, one value word
// a setValue, all eight planes only for a doc with a remove or a move, and
// the records: ≈ 9.4 MB at the serving wave (8,192 docs × 128 slots,
// TXN_BEGIN_EXISTS + INSERT + SET_VALUE a doc), ≈ 2.8 µs at 3.35 TB/s;
// staging all eight planes of every active doc in shared memory and
// writing them all back would move ≈ 67 MB (10.8× the bound), which is
// why most docs take the sparse path below. K6: bytes (the wire read
// once, the dense planes written once: ≈ 1.3 MB at the serving wave,
// 24,576 records into 8,192 docs × o = 4, ≈ 0.4 µs at 3.35 TB/s), so at the
// serving shapes a call is bound by its launches and its dependent rounds
// of loads, not by the bandwidth.
//
// K6 layout: one cooperative launch a call (cudaLaunchCooperativeKernel, a
// grid no larger than the CTAs that can be resident at once), which writes
// every cell of the buffer, so the caller allocates it uninitialised and
// pays no memset launch. The records are NOT sorted by row (a doc's
// records keep their arrival order in the flat wire), so no CTA owns a
// doc range it could zero and fill on its own. Instead each thread first
// loads its first record's lanes in one round of independent loads (row /
// pos checked after them) and its four map gathers in a second round,
// holding the nine values in registers; then it zeroes its share of the
// buffer with 16-byte stores (kZeroPerThread a thread at most, from which
// the grid is sized); the grid meets at cooperative_groups'
// this_grid().sync(), which orders every zero store before every record
// store; then each thread stores its record's nine words and handles the
// rest of its grid-stride records (R > the grid's threads) in the same
// order. The (row, pos) cells are unique on every path (positions_in_doc);
// where two records share a cell, which of them lands is unspecified, as
// with JAX's .at[].set, and their planes may mix. On the card the grid
// barrier is the largest cost after the launch itself: moving it before
// the record loads, or splitting its arrive from its wait, did not shorten
// a call, a barrier of our own on a global counter was slower than
// cooperative_groups', and larger CTAs or more of them were slower too.
//
// K5 layout. One warp per doc, up to 8 docs a CTA (fewer when the docs'
// shared-memory regions would pass half the shared memory, or when a small
// launch spreads its docs over the SMs). A pre-pass over the
// doc's record column finds whether it holds any non-NOOP record (else
// the doc is skipped: its state is neither read nor written) and whether
// it holds a REMOVE or MOVE (either form) and how many inserts, which picks
// the doc's path:
// - Sparse path (no remove / move, at most 4 inserts, N <= 1,024; the
//   serving waves' docs hold one insert with a live anchor): only the
//   node_id plane is read, into registers (N/32 rounded up to a power of
//   two a lane; lane l
//   owns the slots j = l (mod 32)), so exists / slot_of / the lowest free
//   slot are register compares and one warp reduction each. Every other
//   plane stays in device memory and is touched only where a record needs
//   it: a nested insert reads its parent's created_seq, an insert's anchor
//   its parent / field / next_sib, an insert without a live anchor scans
//   the parent / field / prev_sib planes for the field's head, a write
//   stores the words it changes (the new slot's eight, the neighbours'
//   next_sib / prev_sib, a setValue's value). Live ids are unique (an
//   insert requires the id to be absent), so the JAX masked-sum lookups
//   equal the one slot's value, or 0 when the id is absent. Lanes see each
//   other's stores after __syncwarp.
// - Full path (a remove or move, more than 4 inserts — each costs the
//   sparse path a device-memory round trip, and one without a live anchor
//   a scan of three planes — or N > 1,024): the doc's eight planes are
//   staged in shared memory (plus one scratch plane, below) and written
//   back whole, each warp in its own region (8 a CTA up to N = 403). N >
//   1,024 runs every active doc here, 1 to 4 warps a CTA as the shared
//   memory takes them.
// In the full path every lookup (exists, the masked-sum slot value, the
// field head, the lowest free slot) is a pass over the lane's own slots
// and one warp reduction (__reduce_add_sync wraps like int32; the JAX
// lookups are masked sums, so an absent id gives 0). Writes touch only the
// lane's own slots. In both paths the records of a chunk of 32 columns are
// loaded one per lane and broadcast with shuffles, and the overflow flag
// is stored only when it changes. Remove: the scratch plane gets each
// live slot's parent slot (the slot whose id is its parent, -1 for none)
// on the state before the record; after the splice each lane walks up from
// each of its slots and clears the slot when the walk reaches the removed
// node's slot. Live ids are unique, so the walk marks exactly the JAX
// fixpoint's set (a slot joins when its parent's id is marked); walks are
// bounded by N steps. Move: the cycle test walks up from the destination
// with warp lookups. Capacity: nine planes of 4 bytes a slot in one
// region, N <= tree_max_slots() = 6,456 at 232,448 bytes; the wrappers
// refuse more.
//
// Plain C ABI (ctypes): the launch functions return a cudaError_t (0 =
// launched) or a negative code for a refused shape.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRoot = 1;
constexpr int kPlanes = 8;
constexpr int kSmemPerSlot = (kPlanes + 1) * 4;  // + the parent-slot plane
constexpr int kMaxSmem = 232448;
constexpr int kMaxN = kMaxSmem / kSmemPerSlot;
constexpr int kMaxWarps = 4;       // full-path-only launches (N > 1,024)
constexpr int kWarps = 8;          // most docs a CTA with a sparse path
constexpr int kMaxRegSlots = 32;   // node ids a lane holds: N <= 1,024
constexpr int kRegionBudget = kMaxSmem / 2;
constexpr unsigned kSparseInserts = 4;   // most inserts a sparse-path doc has
constexpr int kExpandThreads = 256;
constexpr int kZeroPerThread = 4;  // most 16-byte zero stores a K6 thread
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
constexpr int kErrBadShape = -1;
constexpr int kErrSmem = -2;

// plane indices in shared memory (the order of TREE_PLANES), then scratch
enum { NODE = 0, PARENT, FIELD, VALUE, TYPE, PREV, NEXT, CSEQ, PSLOT };
// record kinds (TreeOpKind)
enum {
  kNoop = 0, kInsBegin, kInsGuardAbsent, kTxnBegin, kTxnGuardExists,
  kInsert, kRemove, kMove, kSetValue, kInsertSolo, kRemoveSolo, kMoveSolo,
  kSetSolo, kTxnBeginExists
};

struct ApplyArgs {
  int* plane[kPlanes];  // (D, N) each
  int* overflow;        // (D,)
  const int* rec;       // (9, D, O)
  const int* base;      // (D,) in wire mode, else null
  int D, N, O;
};

// One doc's planes in shared memory, seen by one lane.
struct Doc {
  int* s;
  int N;
  int lane;

  __device__ int& at(int p, int j) const { return s[p * N + j]; }

  __device__ bool exists(int nid) const {
    bool hit = false;
    if (nid != 0)
      for (int j = lane; j < N; j += 32) hit |= at(NODE, j) == nid;
    return __any_sync(kFull, hit);
  }

  // plane[slot_of(nid)] as the JAX masked sum (0 when absent)
  __device__ int slot_value(int nid, int p) const {
    unsigned acc = 0;
    for (int j = lane; j < N; j += 32)
      if (at(NODE, j) == nid) acc += static_cast<unsigned>(at(p, j));
    return static_cast<int>(__reduce_add_sync(kFull, acc));
  }

  __device__ int head_of(int parent, int field) const {
    unsigned acc = 0;
    for (int j = lane; j < N; j += 32) {
      const int id = at(NODE, j);
      if (id != 0 && at(PARENT, j) == parent && at(FIELD, j) == field &&
          at(PREV, j) == 0)
        acc += static_cast<unsigned>(id);
    }
    return static_cast<int>(__reduce_add_sync(kFull, acc));
  }

  // lowest free slot, N when the doc is full
  __device__ int min_free() const {
    unsigned best = static_cast<unsigned>(N);
    for (int j = lane; j < N; j += 32)
      if (at(NODE, j) == 0) {
        best = static_cast<unsigned>(j);
        break;
      }
    return static_cast<int>(__reduce_min_sync(kFull, best));
  }

  // the slot holding nid (INT_MAX when absent)
  __device__ int slot_of(int nid) const {
    unsigned best = INT_MAX;
    for (int j = lane; j < N; j += 32)
      if (at(NODE, j) == nid) {
        best = static_cast<unsigned>(j);
        break;
      }
    return static_cast<int>(__reduce_min_sync(kFull, best));
  }

  // unlink nid: neighbours bridge over it, its attachment planes reset
  __device__ void splice_out(int nid) const {
    const int prev = slot_value(nid, PREV);
    const int nxt = slot_value(nid, NEXT);
    for (int j = lane; j < N; j += 32) {
      const int id = at(NODE, j);
      int nn = at(NEXT, j), pp = at(PREV, j);
      if (prev != 0 && id == prev) nn = nxt;
      if (nxt != 0 && id == nxt) pp = prev;
      if (id == nid) {
        at(PARENT, j) = 0;
        at(FIELD, j) = 0;
        nn = 0;
        pp = 0;
      }
      at(NEXT, j) = nn;
      at(PREV, j) = pp;
    }
    __syncwarp();
  }

  // splice nid (already in a slot) after a live same-(parent, field)
  // anchor, else at the field's head
  __device__ void attach(int nid, int parent, int field, int after) const {
    const bool anchor_ok = after != 0 && exists(after) &&
                           slot_value(after, PARENT) == parent &&
                           slot_value(after, FIELD) == field;
    const int prev = anchor_ok ? after : 0;
    int nxt = anchor_ok ? slot_value(after, NEXT) : head_of(parent, field);
    if (nxt == nid) nxt = 0;  // self-link guard (fresh head)
    for (int j = lane; j < N; j += 32) {
      const int id = at(NODE, j);
      if (id == nid) {
        at(PARENT, j) = parent;
        at(FIELD, j) = field;
        at(PREV, j) = prev;
        at(NEXT, j) = nxt;
      }
      if (prev != 0 && id == prev) at(NEXT, j) = nid;
      if (nxt != 0 && id == nxt) at(PREV, j) = nid;
    }
    __syncwarp();
  }

  // returns true when the insert would apply but finds no free slot
  __device__ bool insert(int nd, int pa, int af, int fi, int va, int ty,
                         int seq, bool nested) const {
    if (nd == 0) return false;
    const bool parent_ok = pa == kRoot || exists(pa);
    if (!parent_ok || exists(nd)) return false;
    if (nested && slot_value(pa, CSEQ) != seq) return false;
    const int slot = min_free();
    if (slot >= N) return true;
    if ((slot & 31) == lane) {
      at(NODE, slot) = nd;
      at(VALUE, slot) = va;
      at(TYPE, slot) = ty;
      at(CSEQ, slot) = seq;
      at(PREV, slot) = 0;
      at(NEXT, slot) = 0;
      at(PARENT, slot) = 0;
      at(FIELD, slot) = 0;
    }
    __syncwarp();
    attach(nd, pa, fi, af);
    return false;
  }

  __device__ void remove(int nd) const {
    if (nd == kRoot || !exists(nd)) return;
    // each live slot's parent slot, on the state before the splice
    for (int i = lane; i < N; i += 32) {
      const int p = at(PARENT, i);
      int ps = -1;
      if (at(NODE, i) != 0 && p != 0)
        for (int j = 0; j < N; ++j)
          if (at(NODE, j) == p) {
            ps = j;
            break;
          }
      at(PSLOT, i) = ps;
    }
    const int t = slot_of(nd);
    __syncwarp();
    splice_out(nd);
    for (int i = lane; i < N; i += 32) {
      if (at(NODE, i) == 0) continue;
      int cur = i;
      bool marked = false;
      for (int step = 0; step <= N && cur >= 0; ++step) {
        if (cur == t) {
          marked = true;
          break;
        }
        cur = at(PSLOT, cur);
      }
      if (marked)
        for (int p = 0; p < kPlanes; ++p) at(p, i) = 0;
    }
    __syncwarp();
  }

  __device__ void move(int nd, int pa, int af, int fi) const {
    if (nd == kRoot || !exists(nd) || !exists(pa)) return;
    // is the destination inside nd's subtree (state before the move)?
    int cur = pa;
    for (int step = 0; step <= N; ++step) {
      if (cur == nd) return;  // a cycle: the move drops
      if (step > 0 && !exists(cur)) break;
      const int p = slot_value(cur, PARENT);
      if (p == 0) break;
      cur = p;
    }
    splice_out(nd);
    attach(nd, pa, fi, af);
  }

  __device__ void set_value(int nd, int va) const {
    if (!exists(nd)) return;
    for (int j = lane; j < N; j += 32)
      if (at(NODE, j) == nd) at(VALUE, j) = va;
    __syncwarp();
  }
  static constexpr bool kStructural = true;
};

// One doc seen by one lane on the sparse path: node ids in registers, the
// other planes in device memory (see the source note).
template <int SPL>
struct Sparse {
  static constexpr bool kStructural = false;
  const ApplyArgs* a;
  size_t off;  // d * N
  int N;
  int lane;
  int id[SPL > 0 ? SPL : 1];

  __device__ __forceinline__ int* pl(int p) const { return a->plane[p] + off; }
  __device__ __forceinline__ bool mine(int i) const { return lane + 32 * i < N; }

  __device__ __forceinline__ void load_ids() {
#pragma unroll
    for (int i = 0; i < SPL; ++i)
      id[i] = mine(i) ? pl(NODE)[lane + 32 * i] : 0;
  }

  __device__ __forceinline__ bool exists(int nid) const {
    bool hit = false;
    if (nid != 0)
#pragma unroll
      for (int i = 0; i < SPL; ++i) hit |= id[i] == nid;
    return __any_sync(kFull, hit);
  }

  // the lowest slot holding nid (INT_MAX when absent)
  __device__ __forceinline__ int slot_of(int nid) const {
    unsigned best = INT_MAX;
#pragma unroll
    for (int i = SPL - 1; i >= 0; --i)
      if (id[i] == nid && mine(i)) best = static_cast<unsigned>(lane + 32 * i);
    return static_cast<int>(__reduce_min_sync(kFull, best));
  }

  // plane p of a slot, 0 past the doc (the masked sum of an absent id)
  __device__ __forceinline__ int value_at(int slot, int p) const {
    return slot < N ? pl(p)[slot] : 0;
  }

  __device__ __forceinline__ int head_of(int parent, int field) const {
    unsigned acc = 0;
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const int j = lane + 32 * i;
      if (id[i] != 0 && mine(i)) {
        const int pa = pl(PARENT)[j], fi = pl(FIELD)[j], pv = pl(PREV)[j];
        if (pa == parent && fi == field && pv == 0)
          acc += static_cast<unsigned>(id[i]);
      }
    }
    return static_cast<int>(__reduce_add_sync(kFull, acc));
  }

  // lowest free slot, N when the doc is full
  __device__ __forceinline__ int min_free() const {
    unsigned best = static_cast<unsigned>(N);
#pragma unroll
    for (int i = SPL - 1; i >= 0; --i)
      if (id[i] == 0 && mine(i)) best = static_cast<unsigned>(lane + 32 * i);
    return static_cast<int>(__reduce_min_sync(kFull, best));
  }

  // splice nid (already in a slot) after the anchor when anchor_ok (the
  // anchor's next_sib read beforehand), else at the field's head
  __device__ __forceinline__ void attach(int nid, int parent, int field,
                                         int after, bool anchor_ok,
                                         int anchor_next) const {
    const int prev = anchor_ok ? after : 0;
    int nxt = anchor_ok ? anchor_next : head_of(parent, field);
    if (nxt == nid) nxt = 0;  // self-link guard (fresh head)
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      if (!mine(i)) continue;
      const int j = lane + 32 * i, x = id[i];
      if (x == nid) {
        pl(PARENT)[j] = parent;
        pl(FIELD)[j] = field;
        pl(PREV)[j] = prev;
        pl(NEXT)[j] = nxt;
      }
      if (prev != 0 && x == prev) pl(NEXT)[j] = nid;
      if (nxt != 0 && x == nxt) pl(PREV)[j] = nid;
    }
    __syncwarp();
  }

  // returns true when the insert would apply but finds no free slot. The
  // parent's created_seq and the anchor's parent / field / next_sib are
  // read in one round trip before the checks: the insert writes only a
  // free slot, and an anchor that is the new node itself fails either way
  // (absent before, parent 0 after), so they read as after the write.
  __device__ __forceinline__ bool insert(int nd, int pa, int af, int fi,
                                         int va, int ty, int seq,
                                         bool nested) {
    if (nd == 0) return false;
    const int s_pa = pa != 0 ? slot_of(pa) : INT_MAX;
    const int s_af = af != 0 ? slot_of(af) : INT_MAX;
    const int pcseq = nested ? value_at(s_pa, CSEQ) : seq;
    int an_pa = 0, an_fi = 0, an_next = 0;
    if (s_af < N) {
      an_pa = pl(PARENT)[s_af];
      an_fi = pl(FIELD)[s_af];
      an_next = pl(NEXT)[s_af];
    }
    const bool parent_ok = pa == kRoot || s_pa < N;
    if (!parent_ok || exists(nd)) return false;
    if (pcseq != seq) return false;
    const int slot = min_free();
    if (slot >= N) return true;
    if ((slot & 31) == lane) {
      pl(NODE)[slot] = nd;
      pl(VALUE)[slot] = va;
      pl(TYPE)[slot] = ty;
      pl(CSEQ)[slot] = seq;
      pl(PREV)[slot] = 0;
      pl(NEXT)[slot] = 0;
      pl(PARENT)[slot] = 0;
      pl(FIELD)[slot] = 0;
#pragma unroll
      for (int i = 0; i < SPL; ++i)
        if (lane + 32 * i == slot) id[i] = nd;
    }
    __syncwarp();
    attach(nd, pa, fi, af, s_af < N && an_pa == pa && an_fi == fi, an_next);
    return false;
  }

  __device__ __forceinline__ void set_value(int nd, int va) const {
    if (nd != 0)
#pragma unroll
      for (int i = 0; i < SPL; ++i)
        if (id[i] == nd && mine(i)) pl(VALUE)[lane + 32 * i] = va;
    __syncwarp();
  }

};

// The serial scan of doc d's record column; returns its overflow flag.
template <class DocT>
__device__ __forceinline__ int scan(DocT& doc, const ApplyArgs& a, int d,
                                    int lane, int ovf, const int (&f0)[9],
                                    unsigned base) {
  const int O = a.O;
  const size_t DO = static_cast<size_t>(a.D) * O;
  const int* rk = a.rec + static_cast<size_t>(d) * O;
  bool ok_ins = true, ok_txn = true;
  const bool wire = a.base != nullptr;
  unsigned run = 0;
  for (int o0 = 0; o0 < O; o0 += 32) {
    int f[9];
    const int mine = o0 + lane;
#pragma unroll
    for (int p = 0; p < 9; ++p)
      f[p] = o0 == 0 ? f0[p] : (mine < O ? rk[p * DO + mine] : 0);
    const int n = O - o0 < 32 ? O - o0 : 32;
    for (int r = 0; r < n; ++r) {
      const int k = __shfl_sync(kFull, f[0], r);
      const int q = __shfl_sync(kFull, f[8], r);
      int seq = q;
      if (wire) {
        run += static_cast<unsigned>(q);
        seq = static_cast<int>(base + run - 1u);
      }
      if (k == kNoop) continue;
      const int nd = __shfl_sync(kFull, f[1], r);
      const int pa = __shfl_sync(kFull, f[2], r);
      const int af = __shfl_sync(kFull, f[3], r);
      const int fi = __shfl_sync(kFull, f[4], r);
      const int va = __shfl_sync(kFull, f[5], r);
      const int ty = __shfl_sync(kFull, f[6], r);
      const int me = __shfl_sync(kFull, f[7], r);
      const bool solo = k >= kInsertSolo && k <= kSetSolo;
      const int b = solo ? k - 4 : k;
      const bool begin = b == kTxnBegin || b == kTxnBeginExists;
      if (b == kInsBegin || begin) ok_ins = true;
      if (begin) ok_txn = true;
      if (b == kInsGuardAbsent) ok_ins = ok_ins && !doc.exists(nd);
      if (b == kTxnGuardExists || b == kTxnBeginExists)
        ok_txn = ok_txn && doc.exists(nd);
      const bool ok = (ok_ins && ok_txn) || solo;
      if (!ok) continue;
      if (b == kInsert) {
        if (doc.insert(nd, pa, af, fi, va, ty, seq, (me & 1) != 0)) ovf = 1;
      } else if (b == kRemove) {
        if constexpr (DocT::kStructural) doc.remove(nd);
      } else if (b == kMove) {
        if constexpr (DocT::kStructural) doc.move(nd, pa, af, fi);
      } else if (b == kSetValue) {
        doc.set_value(nd, va);
      }
    }
  }
  return ovf;
}

// SPL: node ids a lane keeps for the sparse path (0: every active doc
// takes the full path)
template <int SPL>
__global__ void __launch_bounds__(kWarps * 32)
    tree_apply_kernel(const __grid_constant__ ApplyArgs a) {
  extern __shared__ int smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = blockIdx.x * warps + warp;
  if (d >= a.D) return;  // whole warps only: no block barrier below
  const int N = a.N, O = a.O;
  const size_t DO = static_cast<size_t>(a.D) * O;
  const int* rk = a.rec + static_cast<size_t>(d) * O;
  // one round trip: the first 32 records (all nine planes), the flag, the
  // wire base and, for the sparse path, the node ids
  int f0[9];
#pragma unroll
  for (int p = 0; p < 9; ++p) f0[p] = lane < O ? rk[p * DO + lane] : 0;
  const int ovf0 = a.overflow[d];
  const unsigned base =
      a.base != nullptr ? static_cast<unsigned>(a.base[d]) : 0u;
  [[maybe_unused]] Sparse<SPL> sparse{&a, static_cast<size_t>(d) * N, N,
                                      lane, {}};
  if constexpr (SPL > 0) sparse.load_ids();
  bool any = false, heavy = false;
  unsigned inserts = 0;
  for (int o = lane; o < O; o += 32) {
    const int k = o < 32 ? f0[0] : rk[o];
    any |= k != kNoop;
    heavy |= k == kRemove || k == kMove || k == kRemoveSolo || k == kMoveSolo;
    inserts += k == kInsert || k == kInsertSolo;
  }
  if (!__any_sync(kFull, any)) return;
  // the sparse path pays a device-memory round trip an insert (and a
  // three-plane scan for one without a live anchor): past a few inserts,
  // staging the doc once in shared memory is the faster path
  heavy = __any_sync(kFull, heavy) ||
          __reduce_add_sync(kFull, inserts) > kSparseInserts;
  int ovf;
  if constexpr (SPL > 0) {
    if (!heavy) {
      ovf = scan(sparse, a, d, lane, ovf0, f0, base);
      if (lane == 0 && ovf != ovf0) a.overflow[d] = ovf;
      return;
    }
  }
  Doc doc{smem + static_cast<size_t>(warp) * (kPlanes + 1) * N, N, lane};
  for (int j = lane; j < N; j += 32) {   // a slot's eight loads at once
    int r[kPlanes];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
      r[p] = a.plane[p][static_cast<size_t>(d) * N + j];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) doc.at(p, j) = r[p];
  }
  __syncwarp();
  ovf = scan(doc, a, d, lane, ovf0, f0, base);
  for (int p = 0; p < kPlanes; ++p) {
    int* g = a.plane[p] + static_cast<size_t>(d) * N;
    for (int j = lane; j < N; j += 32) g[j] = doc.at(p, j);
  }
  if (lane == 0 && ovf != ovf0) a.overflow[d] = ovf;
}

// launch shape of K5 at capacity N for D docs on a card of `sms` SMs:
// {slots per lane (0: staged path only), warps (docs) a CTA, dynamic
// shared memory bytes}. Every warp has its own staged-path region; with a
// sparse path the regions take at most half the shared memory (two CTAs an
// SM), and a small launch spreads its docs over the SMs.
void apply_shape(int N, int D, int sms, int out[3]) {
  int spl = 0;
  if (N <= 32 * kMaxRegSlots) {
    spl = 1;
    while (32 * spl < N) spl *= 2;
  }
  int warps = spl > 0 ? kRegionBudget / (kSmemPerSlot * N)
                      : kMaxSmem / (kSmemPerSlot * N);
  const int cap = spl > 0 ? kWarps : kMaxWarps;
  if (warps > cap) warps = cap;
  const int spread = sms > 0 ? (D + sms - 1) / sms : cap;
  if (warps > spread) warps = spread;
  if (warps < 1) warps = 1;
  out[0] = spl;
  out[1] = warps;
  out[2] = warps * kSmemPerSlot * N;
}

template <int SPL>
cudaError_t launch_apply(const ApplyArgs& a, int warps, size_t smem,
                         cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tree_apply_kernel<SPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (a.D + warps - 1) / warps;
  tree_apply_kernel<SPL><<<blocks, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

struct ExpandArgs {
  const uint8_t* cols;  // (R, 3)
  const void* ids;      // (R, 3) u16 or u32
  const void* vals;     // (R,) u16 or u32
  const uint16_t* row;  // (R,)
  const void* pos;      // (R,) u8 or u16
  const int* id_map;
  const int* f_map;
  const int* t_map;
  const int* v_map;
  int id_n, f_n, t_n, v_n;
  int* out;  // (9, D, o); every cell is written
  int R, D, o;
};

__device__ __forceinline__ int take(const int* map, int n, unsigned i) {
  return map[i < static_cast<unsigned>(n) ? i : static_cast<unsigned>(n - 1)];
}

// Record r's nine plane values and its cell (d * o + p); false for padding.
template <typename IdT, typename ValT, typename PosT>
__device__ __forceinline__ bool expand_record(const ExpandArgs& a, size_t r,
                                              int v[9], size_t* cell) {
  // one round: every lane of the record
  const unsigned p = static_cast<const PosT*>(a.pos)[r];
  const unsigned d = a.row[r];
  const uint8_t* c = a.cols + 3 * r;
  const unsigned c0 = c[0], c1 = c[1], c2 = c[2];
  const IdT* ids = static_cast<const IdT*>(a.ids) + 3 * r;
  const unsigned i0 = ids[0], i1 = ids[1], i2 = ids[2];
  const unsigned vi = static_cast<const ValT*>(a.vals)[r];
  if (p >= static_cast<unsigned>(a.o) || d >= static_cast<unsigned>(a.D))
    return false;
  // one round: the four maps' gathers
  v[1] = take(a.id_map, a.id_n, i0);
  v[2] = take(a.id_map, a.id_n, i1);
  v[3] = take(a.id_map, a.id_n, i2);
  v[4] = take(a.f_map, a.f_n, c1);
  v[5] = take(a.v_map, a.v_n, vi);
  v[6] = take(a.t_map, a.t_n, c2);
  v[0] = static_cast<int>(c0 & 0xF);
  v[7] = static_cast<int>((c0 >> 4) & 1);
  v[8] = static_cast<int>((c0 >> 5) & 1);
  *cell = static_cast<size_t>(d) * a.o + p;
  return true;
}

__device__ __forceinline__ void store_record(int* out, size_t plane,
                                             size_t cell, const int v[9]) {
#pragma unroll
  for (int q = 0; q < 9; ++q) out[q * plane + cell] = v[q];
}

template <typename IdT, typename ValT, typename PosT>
__global__ void __launch_bounds__(kExpandThreads)
    tree_expand_kernel(ExpandArgs a) {
  const size_t tid =
      static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t plane = static_cast<size_t>(a.D) * a.o;
  // this thread's first record, loaded and mapped before the zeroing
  int v[9];
  size_t cell = 0;
  const bool first = tid < static_cast<size_t>(a.R) &&
                     expand_record<IdT, ValT, PosT>(a, tid, v, &cell);
  // zero the whole buffer (16-byte stores when it is aligned)
  const size_t n = 9 * plane;
  size_t done = 0;
  if ((reinterpret_cast<uintptr_t>(a.out) & 15) == 0) {
    int4* out4 = reinterpret_cast<int4*>(a.out);
    const int4 z = make_int4(0, 0, 0, 0);
    for (size_t q = tid; q < n / 4; q += stride) out4[q] = z;
    done = n / 4 * 4;
  }
  for (size_t q = done + tid; q < n; q += stride) a.out[q] = 0;
  cooperative_groups::this_grid().sync();  // every zero before any record
  if (first) store_record(a.out, plane, cell, v);
  for (size_t r = tid + stride; r < static_cast<size_t>(a.R); r += stride)
    if (expand_record<IdT, ValT, PosT>(a, r, v, &cell))
      store_record(a.out, plane, cell, v);
}

template <typename IdT, typename ValT, typename PosT>
cudaError_t launch_expand(const ExpandArgs& a, cudaStream_t stream) {
  auto kernel = tree_expand_kernel<IdT, ValT, PosT>;
  // CTAs that can be resident at once, per device (computed once)
  static int resident_on[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident_on[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kExpandThreads, 0);
    if (e != cudaSuccess) return e;
    resident_on[dev] = sms * per_sm;
  }
  // enough threads for the records, and for the zeroing at kZeroPerThread
  // 16-byte stores a thread; no more CTAs than can be resident at once
  const long long zero16 = 9LL * a.D * a.o / 4;
  long long work = (zero16 + kZeroPerThread - 1) / kZeroPerThread;
  if (work < a.R) work = a.R;
  long long blocks = (work + kExpandThreads - 1) / kExpandThreads;
  if (blocks > resident_on[dev]) blocks = resident_on[dev];
  if (blocks < 1) blocks = 1;
  ExpandArgs args = a;
  void* params[] = {&args};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(static_cast<unsigned>(blocks)),
      dim3(kExpandThreads), params, 0, stream);
}

template <typename IdT, typename ValT>
cudaError_t launch_expand_pos(const ExpandArgs& a, int pos_bytes,
                              cudaStream_t stream) {
  return pos_bytes == 1 ? launch_expand<IdT, ValT, uint8_t>(a, stream)
                        : launch_expand<IdT, ValT, uint16_t>(a, stream);
}

template <typename IdT>
cudaError_t launch_expand_val(const ExpandArgs& a, int val_bytes,
                              int pos_bytes, cudaStream_t stream) {
  return val_bytes == 2
             ? launch_expand_pos<IdT, uint16_t>(a, pos_bytes, stream)
             : launch_expand_pos<IdT, uint32_t>(a, pos_bytes, stream);
}

}  // namespace

extern "C" {

int tree_max_slots() { return kMaxN; }

// K5: the eight state planes (D, N) and overflow (D,), updated in place;
// rec (9, D, O) in apply_tree_planes order; base (D,) selects wire mode
// (plane 8 = first-of-op bits), null selects planes mode (plane 8 = seq).
int tree_apply_launch(int* node_id, int* parent, int* field, int* value,
                      int* type_, int* prev_sib, int* next_sib,
                      int* created_seq, int* overflow, const int* rec,
                      const int* base, int D, int N, int O, void* stream) {
  if (D < 0 || O < 0 || N < 1 || N > kMaxN) return kErrBadShape;
  if (D == 0 || O == 0) return 0;
  ApplyArgs a;
  int* planes[kPlanes] = {node_id, parent,   field,    value,
                          type_,   prev_sib, next_sib, created_seq};
  for (int p = 0; p < kPlanes; ++p) a.plane[p] = planes[p];
  a.overflow = overflow;
  a.rec = rec;
  a.base = base;
  a.D = D;
  a.N = N;
  a.O = O;
  int shape[3];
  apply_shape(N, D, sm_count(), shape);
  const size_t smem = static_cast<size_t>(shape[2]);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (shape[0]) {
    case 1: e = launch_apply<1>(a, shape[1], smem, st); break;
    case 2: e = launch_apply<2>(a, shape[1], smem, st); break;
    case 4: e = launch_apply<4>(a, shape[1], smem, st); break;
    case 8: e = launch_apply<8>(a, shape[1], smem, st); break;
    case 16: e = launch_apply<16>(a, shape[1], smem, st); break;
    case 32: e = launch_apply<32>(a, shape[1], smem, st); break;
    default: e = launch_apply<0>(a, shape[1], smem, st); break;
  }
  if (e == cudaErrorInvalidValue && smem > 48 * 1024) {
    cudaGetLastError();
    return kErrSmem;
  }
  return static_cast<int>(e);
}

// K5's launch shape (see apply_shape): out[3]
void tree_apply_shape(int N, int D, int sms, int* out) {
  apply_shape(N, D, sms, out);
}

// K6: the wire (cols (R, 3) u8, ids (R, 3) and vals (R,) of id_bytes /
// val_bytes, row (R,) u16, pos (R,) of pos_bytes) and the four maps into
// out (9, D, o), every cell of which is written (0 where no record lands;
// R = 0 zeroes it), so the caller need not initialise it.
int tree_expand_launch(const void* cols, const void* ids, const void* vals,
                       const void* row, const void* pos, const int* id_map,
                       int id_n, const int* f_map, int f_n, const int* t_map,
                       int t_n, const int* v_map, int v_n, int* out, int R,
                       int D, int o, int id_bytes, int val_bytes,
                       int pos_bytes, void* stream) {
  if (R < 0 || D < 0 || o < 1 || id_n < 1 || f_n < 1 || t_n < 1 ||
      v_n < 1 || (id_bytes != 2 && id_bytes != 4) ||
      (val_bytes != 2 && val_bytes != 4) ||
      (pos_bytes != 1 && pos_bytes != 2))
    return kErrBadShape;
  if (D == 0) return 0;
  ExpandArgs a;
  a.cols = static_cast<const uint8_t*>(cols);
  a.ids = ids;
  a.vals = vals;
  a.row = static_cast<const uint16_t*>(row);
  a.pos = pos;
  a.id_map = id_map;
  a.f_map = f_map;
  a.t_map = t_map;
  a.v_map = v_map;
  a.id_n = id_n;
  a.f_n = f_n;
  a.t_n = t_n;
  a.v_n = v_n;
  a.out = out;
  a.R = R;
  a.D = D;
  a.o = o;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      id_bytes == 2 ? launch_expand_val<uint16_t>(a, val_bytes, pos_bytes, s)
                    : launch_expand_val<uint32_t>(a, val_bytes, pos_bytes, s);
  return static_cast<int>(e);
}

const char* tree_error_string(int err) {
  if (err == kErrBadShape)
    return "refused shape: N must be in [1, tree_max_slots()], the wire "
           "widths 2 or 4 bytes (ids, values) and 1 or 2 (pos), every map "
           "non-empty";
  if (err == kErrSmem) return "refused dynamic shared memory opt-in";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
