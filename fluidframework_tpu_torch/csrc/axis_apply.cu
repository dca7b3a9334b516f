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
// costs a few block collectives per op; bytes (the planes read and written
// once, each op's fields read once: 28 B an insert, 24 a remove, 16 a
// resolve, 4 a NOOP) would take microseconds. K4: each resolve walks the
// visible prefix up to its position, so the work is the slots below pos
// summed over the ops; the bytes are those op fields read once and the
// two outputs written once.
//
// K3 layout. One CTA per axis row. The row's seven planes sit in shared
// memory for the whole op loop (S <= kMaxS, 229,376 bytes at 8,192 slots;
// a larger S is refused). Thread t owns the contiguous chunk [t*k, t*k + k)
// of the row's live slots [0, count), k = ceil(count / threads), so every
// pass is bounded by the live extent and not by S. Per op: a visibility
// pass over the chunk and one block scan of the chunk sums (one barrier)
// give each thread the exclusive visible prefix at its chunk; a second
// pass over the chunk finds the candidates (containing slot, its prefix,
// the boundary slot) and one block fold combines them (one barrier). An
// insert or a split then rolls slots [from, hi + by) right by 1 or 2 in
// tiles of blockDim from the top: each tile reads its sources into
// registers, one barrier, writes them (a lower tile's writes land only on
// slots whose readers passed that barrier), and one barrier closes the
// roll. The thread that writes the new slot or the split's right piece
// also writes the left piece's length: it is that slot's only reader. A
// remove is two splits and a marking pass over the chunk (one barrier
// after it). `hi` is the live extent: max(count, 1 + the last slot that
// differs from StringState.create's fill), raised by every roll. Slots at
// or past hi are fill and a fill tail rolled right stays fill, and the
// roll's wrapped slot (i < by) is always the new slot, so rolling only
// [from, hi + by) and writing back only [0, hi) gives the plain version's
// full-plane roll bit for bit, slots past count included. Overflow is
// sticky: an insert or split that would pass S sets it and leaves the row.
//
// K4 layout. A grid of (axis row, tile of 64 ops). Each CTA stages its
// row's live slots [0, count) of the seven planes in shared memory once;
// one warp takes one op at a time: visibility at the op's own (ref_seq,
// client), 32 slots per step with a warp scan and a running carry, and it
// stops at the step whose ballot finds the visible slot holding pos. So
// the work scales with O over the whole grid (config #3's 1,024 x 1,024
// doc resolves 65,536 ops on each of 2 rows) and not only with D. Lengths
// are non-negative and a row's visible length stays below 2^31 in every
// state the engine makes, so at most one slot holds pos, and stopping at
// it gives the plain version's sums over all holding slots.
//
// Sums and prefixes wrap like int32 (unsigned arithmetic), as the JAX
// reference's do. The remover bit test clamps the client index to [0, 31]
// and requires client >= 0 (reads use client -1). Plain C ABI (ctypes):
// the launch functions return a cudaError_t (0 = launched) or a negative
// code for a refused shape.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kNotRemoved = 0x7fffffff;
constexpr int kNumPlanes = 7;
constexpr int kInsert = 0;
constexpr int kRemove = 1;
constexpr int kResolve = 13;
constexpr int kMaxS = 8192;
constexpr int kMaxWarps = 32;
constexpr int kApplyThreads = 256;
constexpr int kResolveWarps = 8;
constexpr int kResolveOpsPerWarp = 8;
constexpr int kResolveOpsPerCta = kResolveWarps * kResolveOpsPerWarp;
constexpr int kScratchInts = 2 * kMaxWarps * 4;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kErrBadShape = -1;
constexpr int kErrSmem = -2;

enum Plane { SEQ = 0, CLIENT, REMOVED, REMOVERS, LENGTH, HOP, HOFF };
enum OpField { F_KIND = 0, F_A0, F_A1, F_A2, F_SEQ, F_CLIENT, F_REF };

struct Args {
  const int* op[7];  // (D, O) each: kind, a0, a1, a2, seq, client, ref_seq
  int* plane[kNumPlanes];  // (D, S) each
  int* count;              // (D,)
  int* overflow;           // (D,)
  int* out_run;            // (D, O)
  int* out_off;            // (D, O)
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

// Slot i of a row whose plane q sits at p[q * stride + i]: visible in
// perspective (ref, cl)? The caller keeps i below count.
__device__ __forceinline__ bool visible(const int* p, int stride, int i,
                                        int ref, int cl) {
  const unsigned c = static_cast<unsigned>(min(max(cl, 0), 31));
  const bool ins = p[SEQ * stride + i] <= ref || p[CLIENT * stride + i] == cl;
  const bool rem =
      p[REMOVED * stride + i] <= ref ||
      (cl >= 0 && ((static_cast<unsigned>(p[REMOVERS * stride + i]) >> c) & 1u));
  return ins && !rem;
}

struct Fold {
  int v[4];
};

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

  // This thread's chunk [lo, hi) of [0, n).
  __device__ void chunk(int n, int& lo, int& hi) const {
    const int k = (n + nt - 1) / nt;
    lo = min(tid * k, n);
    hi = min(lo + k, n);
  }

  // Exclusive wrapping prefix of v over the threads, and their total.
  __device__ int scan(int v, int& total) {
    int inc = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc = wadd(inc, y);
    }
    int* buf = red + par * kMaxWarps * 4;
    if (lane == 31) buf[warp * 4] = inc;
    __syncthreads();
    int before = 0, tot = 0;
    for (int w = 0; w < nw; ++w) {
      const int c = buf[w * 4];
      if (w < warp) before = wadd(before, c);
      tot = wadd(tot, c);
    }
    par ^= 1;
    total = tot;
    return wadd(before, wsub(inc, v));
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

// One axis row in shared memory: plane q, slot i at p[q * S + i]. count,
// overflow and hi are held (uniformly) by every thread.
struct AxisRow {
  Block& b;
  int* p;
  int S, count, overflow, hi;

  __device__ int& at(int q, int i) { return p[q * S + i]; }

  // Visible prefix at the start of this thread's chunk of [0, count), and
  // the row's visible length at (ref, cl).
  __device__ int scan_vis(int ref, int cl, int lo, int hi2, int& total) {
    int sum = 0;
    for (int i = lo; i < hi2; ++i) {
      if (visible(p, S, i, ref, cl)) sum = wadd(sum, at(LENGTH, i));
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
      __syncthreads();
      if (act) {
        edit(i, v);
#pragma unroll
        for (int q = 0; q < kNumPlanes; ++q) at(q, i) = v[q];
      }
    }
    __syncthreads();
    hi = nh;
  }

  __device__ void insert(int pos, int len, int handle, int seq, int cl,
                         int ref) {
    int lo, h2, total;
    b.chunk(min(count, S), lo, h2);
    int pre = scan_vis(ref, cl, lo, h2, total);
    if (pos > total) return;  // past the visible length: dropped
    // min containing slot, wrapping sum of its prefix, min boundary slot
    Fold x{{S, 0, count, 0}};
    for (int i = lo; i < h2; ++i) {
      const bool v = visible(p, S, i, ref, cl);
      const int e = wadd(pre, v ? at(LENGTH, i) : 0);
      if (v && pre < pos && pos < e) {
        x.v[0] = min(x.v[0], i);
        x.v[1] = wadd(x.v[1], pre);
      }
      if (pre >= pos) x.v[2] = min(x.v[2], i);
      pre = e;
    }
    x = b.fold<0x2u>(x);
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

  // Split the visible slot strictly containing pos.
  __device__ void split_at(int pos, int ref, int cl) {
    int lo, h2, total;
    b.chunk(min(count, S), lo, h2);
    int pre = scan_vis(ref, cl, lo, h2, total);
    Fold x{{S, 0, 0, 0}};
    for (int i = lo; i < h2; ++i) {
      const bool v = visible(p, S, i, ref, cl);
      const int e = wadd(pre, v ? at(LENGTH, i) : 0);
      if (v && pre < pos && pos < e) {
        x.v[0] = min(x.v[0], i);
        x.v[1] = wadd(x.v[1], pre);
      }
      pre = e;
    }
    x = b.fold<0x2u>(x);
    if (x.v[0] >= S) return;  // nothing to split
    if (count + 1 > S) {
      overflow = 1;
      return;
    }
    const int j = x.v[0];
    const int off = wsub(pos, x.v[1]);
    roll(j + 1, 1, [&](int i, int* v) {
      if (i == j + 1) {
        v[LENGTH] = wsub(v[LENGTH], off);
        v[HOFF] = wadd(v[HOFF], off);
        at(LENGTH, j) = off;
      }
    });
    count += 1;
  }

  // Mark the visible slots inside [start, end) removed at seq by cl.
  __device__ void mark(int start, int end, int seq, int cl, int ref) {
    int lo, h2, total;
    b.chunk(min(count, S), lo, h2);
    int pre = scan_vis(ref, cl, lo, h2, total);
    const int bit =
        cl >= 0 ? static_cast<int>(1u << min(max(cl, 0), 31)) : 0;
    for (int i = lo; i < h2; ++i) {
      const bool v = visible(p, S, i, ref, cl);
      const int e = wadd(pre, v ? at(LENGTH, i) : 0);
      if (v && pre >= start && e <= end && at(LENGTH, i) > 0) {
        at(REMOVED, i) = min(at(REMOVED, i), seq);
        at(REMOVERS, i) |= bit;
      }
      pre = e;
    }
    __syncthreads();
  }

  // (run, offset) of the visible slot holding pos, or (-1, -1).
  __device__ void resolve(int pos, int ref, int cl, int& run, int& off) {
    int lo, h2, total;
    b.chunk(min(count, S), lo, h2);
    int pre = scan_vis(ref, cl, lo, h2, total);
    Fold x{{0, 0, 0, 0}};  // holding slots, sums of hop, hoff, prefix
    for (int i = lo; i < h2; ++i) {
      const bool v = visible(p, S, i, ref, cl);
      const int e = wadd(pre, v ? at(LENGTH, i) : 0);
      if (v && pre <= pos && pos < e) {
        x.v[0] += 1;
        x.v[1] = wadd(x.v[1], at(HOP, i));
        x.v[2] = wadd(x.v[2], at(HOFF, i));
        x.v[3] = wadd(x.v[3], pre);
      }
      pre = e;
    }
    x = b.fold<0xfu>(x);
    run = x.v[0] ? x.v[1] : -1;
    off = x.v[0] ? wsub(wadd(x.v[2], pos), x.v[3]) : -1;
  }
};

__global__ void __launch_bounds__(kApplyThreads)
    axis_apply_kernel(Args a) {
  extern __shared__ int smem[];
  __shared__ int s_hi;
  Block b(smem);
  int* p = smem + kScratchInts;
  const int d = blockIdx.x;
  const int S = a.S;
  const long long row = static_cast<long long>(d) * S;
  if (b.tid == 0) s_hi = 0;
  __syncthreads();
  int my_hi = 0;
  for (int i = b.tid; i < S; i += b.nt) {
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
  if (b.lane == 0) atomicMax(&s_hi, my_hi);
  __syncthreads();
  const int count = a.count[d];
  AxisRow r{b, p, S, count, a.overflow[d], min(max(s_hi, count), S)};

  for (int o = 0; o < a.O; ++o) {
    const long long at = static_cast<long long>(d) * a.O + o;
    const int kind = a.op[F_KIND][at];
    const int a0 = a.op[F_A0][at];
    const int cl = a.op[F_CLIENT][at];
    const int ref = a.op[F_REF][at];
    int run = -1, off = -1;
    if (kind == kInsert) {
      r.insert(a0, a.op[F_A1][at], a.op[F_A2][at], a.op[F_SEQ][at], cl, ref);
    } else if (kind == kRemove) {
      const int end = a.op[F_A1][at];
      r.split_at(a0, ref, cl);
      r.split_at(end, ref, cl);
      r.mark(a0, end, a.op[F_SEQ][at], cl, ref);
    } else if (kind == kResolve) {
      r.resolve(a0, ref, cl, run, off);
    }
    if (b.tid == 0) {
      a.out_run[at] = run;
      a.out_off[at] = off;
    }
  }
  // every roll and marking pass ended on a barrier: write back [0, hi)
  for (int i = b.tid; i < r.hi; i += b.nt) {
#pragma unroll
    for (int q = 0; q < kNumPlanes; ++q) a.plane[q][row + i] = p[q * S + i];
  }
  if (b.tid == 0) {
    a.count[d] = r.count;
    a.overflow[d] = r.overflow;
  }
}

__global__ void __launch_bounds__(kResolveWarps * 32)
    axis_resolve_kernel(Args a) {
  extern __shared__ int p[];  // plane q, slot i at p[q * n + i]
  const int d = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = min(max(a.count[d], 0), a.S);
  const long long row = static_cast<long long>(d) * a.S;
  for (int i = tid; i < n; i += blockDim.x) {
#pragma unroll
    for (int q = 0; q < kNumPlanes; ++q) p[q * n + i] = a.plane[q][row + i];
  }
  __syncthreads();
  for (int m = 0; m < kResolveOpsPerWarp; ++m) {
    const int o = blockIdx.y * kResolveOpsPerCta + m * kResolveWarps + warp;
    if (o >= a.O) break;  // warp-uniform
    const long long at = static_cast<long long>(d) * a.O + o;
    int run = -1, off = -1;
    if (a.op[F_KIND][at] == kResolve) {
      const int pos = a.op[F_A0][at];
      const int cl = a.op[F_CLIENT][at];
      const int ref = a.op[F_REF][at];
      int carry = 0;
      for (int c = 0; c < n; c += 32) {
        const int i = c + lane;
        const bool v = i < n && visible(p, n, i, ref, cl);
        const int x = v ? p[LENGTH * n + i] : 0;
        int inc = x;
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
          const int y = __shfl_up_sync(kFull, inc, s);
          if (lane >= s) inc = wadd(inc, y);
        }
        const int pre = wadd(carry, wsub(inc, x));
        const unsigned hit =
            __ballot_sync(kFull, v && pre <= pos && pos < wadd(pre, x));
        if (hit) {  // warp-uniform
          const int src = __ffs(hit) - 1;
          const int hop = i < n ? p[HOP * n + i] : 0;
          const int hoff = i < n ? p[HOFF * n + i] : 0;
          run = __shfl_sync(kFull, hop, src);
          off = wsub(wadd(__shfl_sync(kFull, hoff, src), pos),
                     __shfl_sync(kFull, pre, src));
          break;
        }
        carry = wadd(carry, __shfl_sync(kFull, inc, 31));
      }
    }
    if (lane == 0) {
      a.out_run[at] = run;
      a.out_off[at] = off;
    }
  }
}

size_t apply_smem(int S) {
  return static_cast<size_t>(kScratchInts + kNumPlanes * S) * sizeof(int);
}
size_t resolve_smem(int S) {
  return static_cast<size_t>(kNumPlanes * S) * sizeof(int);
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
  for (int f = 0; f < 7; ++f) a.op[f] = op[f];
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
  const int* op[7] = {kind, a0, a1, a2, seq, client, ref_seq};
  int* plane[kNumPlanes] = {p_seq, p_client, p_removed, p_removers,
                            p_length, p_hop, p_hoff};
  const Args a = make_args(op, plane, count, overflow, out_run, out_off, D,
                           S, O);
  const size_t smem = apply_smem(S);
  const cudaError_t e = allow_smem(axis_apply_kernel, smem);
  if (e != cudaSuccess) return kErrSmem;
  int threads = ((S + 31) / 32) * 32;
  if (threads > kApplyThreads) threads = kApplyThreads;
  axis_apply_kernel<<<D, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
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
  const int tiles = (O + kResolveOpsPerCta - 1) / kResolveOpsPerCta;
  if (tiles > 65535) return kErrBadShape;
  if (D == 0 || O == 0) return 0;
  const int* op[7] = {kind, pos, nullptr, nullptr, nullptr, client, ref_seq};
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
  axis_resolve_kernel<<<dim3(D, tiles), kResolveWarps * 32, smem,
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
