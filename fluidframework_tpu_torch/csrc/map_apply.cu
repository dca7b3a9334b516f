// Fused SharedMap batch apply (LWW with clear barriers) for Hopper (sm_90a).
//
// Replaces two XLA programs of the JAX package: ``apply_map_batch_jit``
// (fluidframework_tpu/ops/map_kernel.py:101, dense (D, O) op planes) and
// ``map_columnar_apply_jit`` (:131, with ``_map_unpack`` :145: one int32
// word buffer of kind u8 | key slot u8 | value u16 or i32 | per-row seq
// base i32 | row ids i32). For every (doc, key slot) the result depends only
// on the LAST set/delete of that slot after the doc's LAST clear, so a batch
// is a reduction over the op axis.
//
// What bounds it. Bytes: the ops read once and the three int32 state
// planes written once where the batch writes them (every slot of a row
// with a clear, each slot a set / delete touches); the state is never
// read. At config #2 (D = 1,024, K = 64, O = 64, nearly every row has a
// clear) that is 0.79 MB of state and 0.27 MB of packed wire, ≈ 0.32 µs at
// 3.35 TB/s, so at the serving shapes a launch is bound by its chain of
// dependent steps (device-memory round trips, barriers) and the launch
// itself, not by the card's bandwidth; dense at D = 10,240 is near the
// bytes bound.
//
// Warp path (K <= kWarpKeys = 256; every packed batch, since the wire's key
// slot is a u8, and config #2's dense batches). One warp a plane row, up to
// kRowWarps rows a CTA (fewer when the batch has fewer rows than SMs times
// that, so a small batch spreads over the SMs); no block barrier. A lane
// loads op j = 32c + lane of up to kGroup chunks of 32 at once, with the
// row id and the seq base, in one round of independent loads; the row id is
// checked after them. A group's clears are found first (__reduce_max_sync
// of each lane's last CLEAR): no op at or before the row's last clear can
// win, so a chunk that lies wholly before it is skipped. Per chunk, in
// order: packed mode rebuilds each seq as base + the inclusive count of
// non-NOOP slots (one __ballot_sync and __popc, the running carry in a
// register); each set / delete after the last clear raises its key's tag
// in the warp's shared-memory entry to 2j + is_set with a shared-memory
// atomicMax (the highest tag on a key is its last op), and after a
// __syncwarp the one lane whose tag survived writes the op's seq and value
// beside it (3 words a key slot). Chunks run in order, each ended by a
// __syncwarp, so a later op overwrites an earlier one, and each entry ends
// holding its key's last set / delete with everything the store needs: the
// winning op is never read again from device memory. Then the lanes stride
// over the K slots and write present / value / last_seq from the entries:
// a slot whose last op lies after the last clear takes it, a row with a
// clear zeroes every other slot, and an untouched slot of a row without a
// clear is not written. The loads are lane-per-op byte / u16 / i32 loads
// (one 32-byte sector a warp instruction for the byte lanes): the packed
// sections start at word offsets that depend on R * O, so 16-byte vector
// loads would need an alignment the wire does not promise. On the card,
// __match_any_sync (the lanes that share a key, the highest one writing)
// and 64-bit shared-memory atomics both ran slower than these 32-bit
// atomics. What is left at the serving shapes is mostly the launch and one
// round trip of loads and stores.
//
// Block path (dense batches with K > 256): one CTA a row; a 64-bit word per
// key slot in shared memory, folded with shared-memory atomicMax of
// ((j + 1) << 32 | seq_j) while the CTA streams the row's ops in tiles, a
// block max for the last clear, then a second read of the winning op's kind
// and value. Its shared memory grows with K, and past the 227 KB a block
// may use (about 29,000 key slots) the launch is refused.
//
// In both paths the state is written IN PLACE into state row rows[i] (row i
// in dense mode); the JAX program donates its input state, so overwriting
// it is the same contract. Rows absent from a scatter batch are never
// touched; keys outside [0, K) and kinds other than SET / DELETE / CLEAR are
// ignored (an unknown kind still takes a seq in packed mode: only NOOP
// slots consumed none).
//
// C interface (ctypes): every entry point returns cudaGetLastError() after
// its launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSet = 3;
constexpr int kDelete = 4;
constexpr int kClear = 5;
constexpr int kNoop = 12;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpKeys = 256;   // most key slots a warp-path row stages
constexpr int kRowWarps = 8;     // most rows (warps) a warp-path CTA
constexpr int kGroup = 4;        // 32-op chunks a lane loads in one round

struct Ops {
  // dense mode: (rows, O) int32 planes
  const int* kind;
  const int* a0;
  const int* a1;
  const int* seq;
  // packed mode: byte / u16 / i32 lanes inside the word buffer
  const uint8_t* pk_kind;
  const uint8_t* pk_a0;
  const uint16_t* pk_a1_16;
  const int* pk_a1_32;
  const int* pk_base;
  const int* pk_rows;
};

template <bool kPacked>
__device__ __forceinline__ int op_kind(const Ops& ops, long long at) {
  return kPacked ? int(ops.pk_kind[at]) : ops.kind[at];
}

template <bool kPacked>
__device__ __forceinline__ int op_a1(const Ops& ops, long long at) {
  if (!kPacked) return ops.a1[at];
  return ops.pk_a1_32 != nullptr ? ops.pk_a1_32[at] : int(ops.pk_a1_16[at]);
}

// The ops of kGroup chunks of 32 a lane holds: op g0 + 32c + lane.
struct Group {
  int kind[kGroup], key[kGroup], val[kGroup], seq[kGroup];
};

template <bool kPacked>
__device__ __forceinline__ void load_group(const Ops& ops, long long row_off,
                                           int g0, int O, int lane,
                                           Group& g) {
#pragma unroll
  for (int c = 0; c < kGroup; ++c) {
    const int j = g0 + 32 * c + lane;
    g.kind[c] = kNoop;
    g.key[c] = 0;
    g.val[c] = 0;
    g.seq[c] = 0;
    if (j < O) {
      const long long at = row_off + j;
      g.kind[c] = op_kind<kPacked>(ops, at);
      g.key[c] = kPacked ? int(ops.pk_a0[at]) : ops.a0[at];
      g.val[c] = op_a1<kPacked>(ops, at);
      if (!kPacked) g.seq[c] = ops.seq[at];
    }
  }
}

// Warp path: one warp a plane row (see the note at the top). Shared memory:
// per warp, K entries of (2j + is_set or -1, seq, value).
template <bool kPacked>
__global__ void __launch_bounds__(kRowWarps * 32)
    map_apply_warp_kernel(Ops ops, int* __restrict__ present,
                          int* __restrict__ value,
                          int* __restrict__ last_seq, int R, int D, int O,
                          int K) {
  extern __shared__ int stage[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * (blockDim.x >> 5) + warp;
  if (i >= R) return;  // uniform over the warp
  const long long row_off = (long long)i * O;
  // one round of independent loads: row id, seq base, the first ops
  const int r = kPacked ? ops.pk_rows[i] : i;
  const unsigned base = kPacked ? unsigned(ops.pk_base[i]) : 0u;
  Group g;
  load_group<kPacked>(ops, row_off, 0, O, lane, g);
  if (r < 0 || r >= D) return;  // uniform over the warp
  int* tag = stage + warp * 3 * K;
  int* e_seq = tag + K;
  int* e_val = e_seq + K;
  for (int k = lane; k < K; k += 32) tag[k] = -1;
  __syncwarp();

  int my_clear = -1;    // the lane's last clear so far
  int last_clear = -1;  // the row's last clear so far
  unsigned carry = 0;
  for (int g0 = 0;;) {
    // the group's clears first: no op at or before the last one can win
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
      const int j = g0 + 32 * c + lane;
      if (j < O && g.kind[c] == kClear) my_clear = j;  // j grows with c
    }
    last_clear = __reduce_max_sync(kFull, my_clear);
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
      const int j0 = g0 + 32 * c;
      if (j0 >= O) break;  // uniform over the warp
      const int j = j0 + lane;
      const int kd = g.kind[c];
      int s = g.seq[c];
      if (kPacked) {
        // seq_j = base + inclusive count of non-NOOP slots in [0, j]
        const unsigned bal = __ballot_sync(kFull, j < O && kd != kNoop);
        // lanes 0..lane: (2 << lane) - 1 wraps to all ones at lane 31
        s = int(base + carry + __popc(bal & ((2u << lane) - 1u)));
        carry += __popc(bal);
      }
      if (j0 + 31 <= last_clear) continue;  // the whole chunk is cleared
      const int key = g.key[c];
      const bool keyed = j < O && j > last_clear &&
                         (kd == kSet || kd == kDelete) && key >= 0 && key < K;
      // the highest (2j + is_set) on a key is its last op; only the lane
      // that holds it writes the op's seq and value beside it
      const int mine = 2 * j + (kd == kSet ? 1 : 0);
      if (keyed) atomicMax(&tag[key], mine);
      __syncwarp();
      if (keyed && tag[key] == mine) {
        e_seq[key] = s;
        e_val[key] = g.val[c];
      }
      __syncwarp();  // the next chunk's updates land after these
    }
    g0 += 32 * kGroup;
    if (g0 >= O) break;
    load_group<kPacked>(ops, row_off, g0, O, lane, g);
  }
  const bool had_clear = last_clear >= 0;
  const long long row = (long long)r * K;
  for (int k = lane; k < K; k += 32) {
    const int t = tag[k];
    if ((t >> 1) > last_clear) {  // t = -1: no set / delete on slot k
      const bool is_set = (t & 1) != 0;
      present[row + k] = is_set ? 1 : 0;
      if (is_set) value[row + k] = e_val[k];
      else if (had_clear) value[row + k] = 0;
      last_seq[row + k] = is_set ? e_seq[k] : 0;
    } else if (had_clear) {
      present[row + k] = 0;
      value[row + k] = 0;
      last_seq[row + k] = 0;
    }
  }
}

// Block path (K > kWarpKeys): one CTA a plane row.
template <bool kPacked>
__global__ void map_apply_block_kernel(Ops ops, int* __restrict__ present,
                                 int* __restrict__ value,
                                 int* __restrict__ last_seq, int D, int O,
                                 int K) {
  extern __shared__ unsigned long long last[];  // K words
  __shared__ int warp_total[32];
  __shared__ int s_clear;
  __shared__ int s_carry;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int i = blockIdx.x;
  const int r = kPacked ? ops.pk_rows[i] : i;
  if (r < 0 || r >= D) return;  // uniform over the CTA
  for (int k = tid; k < K; k += blockDim.x) last[k] = 0ull;
  if (tid == 0) {
    s_clear = -1;
    s_carry = 0;
  }
  __syncthreads();

  const long long row_off = (long long)i * O;
  const int base = kPacked ? ops.pk_base[i] : 0;
  int my_clear = -1;
  for (int t0 = 0; t0 < O; t0 += blockDim.x) {
    const int j = t0 + tid;
    const bool in = j < O;
    int kd = kNoop, key = 0, s = 0;
    if (in) {
      kd = op_kind<kPacked>(ops, row_off + j);
      key = kPacked ? int(ops.pk_a0[row_off + j]) : ops.a0[row_off + j];
      if (!kPacked) s = ops.seq[row_off + j];
    }
    if (kPacked) {
      // seq_j = base + inclusive count of non-NOOP slots in [0, j]
      const unsigned bal = __ballot_sync(kFull, in && kd != kNoop);
      if (lane == 0) warp_total[warp] = __popc(bal);
      __syncthreads();
      int before = s_carry, tile = 0;
      for (int w = 0; w < n_warps; ++w) {
        const int c = warp_total[w];
        before += w < warp ? c : 0;
        tile += c;
      }
      // lanes 0..lane: (2 << lane) - 1 wraps to all ones at lane 31
      s = base + before + __popc(bal & ((2u << lane) - 1u));
      __syncthreads();  // every read of s_carry / warp_total is done
      if (tid == 0) s_carry += tile;
    }
    if (in) {
      if (kd == kClear) {
        my_clear = j;  // j grows along the thread's loop
      } else if ((kd == kSet || kd == kDelete) && key >= 0 && key < K) {
        atomicMax(&last[key], ((unsigned long long)(j + 1) << 32) |
                                  (unsigned long long)(unsigned)s);
      }
    }
  }
  const int wmax = __reduce_max_sync(kFull, my_clear);
  if (lane == 0) atomicMax(&s_clear, wmax);
  __syncthreads();

  const int last_clear = s_clear;
  const bool had_clear = last_clear >= 0;
  for (int k = tid; k < K; k += blockDim.x) {
    const long long at = (long long)r * K + k;
    const unsigned long long w = last[k];
    const int j = int(w >> 32) - 1;  // -1: no set/delete on slot k
    if (j > last_clear) {
      const bool is_set = op_kind<kPacked>(ops, row_off + j) == kSet;
      present[at] = is_set ? 1 : 0;
      if (is_set) value[at] = op_a1<kPacked>(ops, row_off + j);
      else if (had_clear) value[at] = 0;
      last_seq[at] = is_set ? int(unsigned(w & 0xffffffffull)) : 0;
    } else if (had_clear) {
      present[at] = 0;
      value[at] = 0;
      last_seq[at] = 0;
    }
  }
}

int threads_for(int O, int K) {
  int want = O > K ? O : K;
  if (want > 256) want = 256;
  return want <= 32 ? 32 : ((want + 31) / 32) * 32;
}

// Rows (warps) a warp-path CTA takes for a batch of R rows on a card of
// `sms` SMs: kRowWarps, or fewer so that R rows cover the SMs.
int row_warps(int R, int sms) {
  int w = sms > 0 ? (R + sms - 1) / sms : kRowWarps;
  if (w > kRowWarps) w = kRowWarps;
  return w < 1 ? 1 : w;
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

template <bool kPacked>
cudaError_t launch(const Ops& ops, int n_rows, int* present, int* value,
                   int* last_seq, int D, int O, int K, cudaStream_t stream) {
  if (K <= kWarpKeys) {
    const int warps = row_warps(n_rows, sm_count());
    const size_t smem = (size_t)warps * 3 * K * sizeof(int);  // <= 24 KB
    map_apply_warp_kernel<kPacked>
        <<<(n_rows + warps - 1) / warps, warps * 32, smem, stream>>>(
            ops, present, value, last_seq, n_rows, D, O, K);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)K * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        map_apply_block_kernel<kPacked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // the refusal is this call's result
      return e;
    }
  }
  map_apply_block_kernel<kPacked><<<n_rows, threads_for(O, K), smem, stream>>>(
      ops, present, value, last_seq, D, O, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dense mode: kind/a0/a1/seq are (D, O) int32; state planes (D, K) int32.
int map_apply_dense(const int* kind, const int* a0, const int* a1,
                    const int* seq, int* present, int* value, int* last_seq,
                    int D, int O, int K, void* stream) {
  Ops ops = {};
  ops.kind = kind;
  ops.a0 = a0;
  ops.a1 = a1;
  ops.seq = seq;
  return launch<false>(ops, D, present, value, last_seq, D, O, K,
                       (cudaStream_t)stream);
}

// Packed mode: ``buf`` holds R*O kind bytes, R*O key-slot bytes, R*O
// values (u16, or i32 when ``wide``), R seq bases and R row ids, each
// section padded to whole int32 words; R rows of O ops onto a (D, K) state.
int map_apply_packed(const int* buf, int R, int O, int wide, int* present,
                     int* value, int* last_seq, int D, int K, void* stream) {
  const long long n = (long long)R * O;
  const long long w8 = (n + 3) / 4;
  const long long w_a1 = wide ? n : (n + 1) / 2;
  Ops ops = {};
  ops.pk_kind = reinterpret_cast<const uint8_t*>(buf);
  ops.pk_a0 = reinterpret_cast<const uint8_t*>(buf + w8);
  if (wide)
    ops.pk_a1_32 = buf + 2 * w8;
  else
    ops.pk_a1_16 = reinterpret_cast<const uint16_t*>(buf + 2 * w8);
  ops.pk_base = buf + 2 * w8 + w_a1;
  ops.pk_rows = ops.pk_base + R;
  return launch<true>(ops, R, present, value, last_seq, D, O, K,
                      (cudaStream_t)stream);
}

// The most key slots a row may have and still take the warp path.
int map_apply_warp_keys() { return kWarpKeys; }

const char* map_apply_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
