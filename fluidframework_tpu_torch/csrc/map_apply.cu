// Fused SharedMap batch apply (LWW with clear barriers) for Hopper (sm_90a).
//
// Replaces two XLA programs of the JAX package: ``apply_map_batch_jit``
// (fluidframework_tpu/ops/map_kernel.py:101, dense (D, O) op planes) and
// ``map_columnar_apply_jit`` (:128, with ``_map_unpack`` :145: one int32
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
// 3.35 TB/s, so one launch is bound by launch latency rather than by the
// card.
//
// What the design does. One CTA per plane row; nothing is staged but one
// 64-bit word per key slot in shared memory. The CTA streams its row's ops
// once in tiles of blockDim: a CLEAR raises the thread's clear index, a
// SET/DELETE on slot k folds ((j + 1) << 32 | seq_j) into slot k's word
// with a shared-memory atomicMax (the op index in the high half makes the
// max the LAST op and carries its seq along), so the work is O(O + K) and
// there is no limit on O. In packed mode the seqs are rebuilt on the fly:
// seq_j = base + the inclusive count of non-NOOP slots up to j (a ballot /
// popc block scan per tile with a running carry). A block max gives the
// last clear; then thread k (striding over K) decides slot k — touched iff
// its last op lies after the last clear — and writes present / value /
// last_seq IN PLACE into state row rows[i] (row i in dense mode). The JAX
// program donates its input state, so overwriting it is the same contract.
// Rows absent from a scatter batch have no CTA and are never touched; an
// untouched slot of a row without a clear is not written either.
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

template <bool kPacked>
__global__ void map_apply_kernel(Ops ops, int* __restrict__ present,
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

template <bool kPacked>
cudaError_t launch(const Ops& ops, int n_rows, int* present, int* value,
                   int* last_seq, int D, int O, int K, cudaStream_t stream) {
  const size_t smem = (size_t)K * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        map_apply_kernel<kPacked>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // the refusal is this call's result
      return e;
    }
  }
  map_apply_kernel<kPacked><<<n_rows, threads_for(O, K), smem, stream>>>(
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

const char* map_apply_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
