// Fused grammar mask + argmax over the vocabulary (Hopper, sm_90a), for the
// two mask layouts of the TPU kernels.
//
// Replaces: src/repro/kernels/masked_sample/kernel.py
//   masked_argmax_pallas_packed -> the PackedMask instantiations (packed
//   uint32 words), and masked_argmax_pallas -> the ByteMask ones (one
//   int8/bool byte a token).
//
// Computes, per row b:
//   masked[t] = (token t legal) ? float(logits[b, t]) : -1e30
//   idx[b] = lowest t with masked[t] == max(masked), val[b] = that max
// where token t is legal if bit (t % 32) of word (t / 32) is set (packed) or
// its mask byte is nonzero (bytes), so an all-illegal row gives idx 0, val
// -1e30, exactly like the reference.  The logits are float32, bfloat16 or
// float16, widened exactly to float32 in registers, as the TPU kernels'
// .astype(jnp.float32).  The two layouts of one mask give the same result
// bit for bit, and so do two calls on the same inputs.
//
// What bounds it: bytes.  Each row reads V logits (2 or 4 bytes) and V/32
// mask words (or V mask bytes) once and writes 8 bytes; there is one compare
// per token.  At B=4 and a real vocabulary (1e5 tokens) that is under 2 MB,
// which the card's memory rate would move in half a microsecond: what sets
// the time there is the launch and the latency of a few dependent memory
// round trips, so the design keeps that chain short.  At B=64 and 262144
// tokens (67 MB of float32) the bytes bound it.
//
// Design:
// - The vocabulary is split across blocks: grid (n_split, B), each block
//   walks split_len tokens of its row (a multiple of 32, so a split never
//   shares a mask word with another), chosen by ref.argmax_plan from the
//   shapes alone.
// - Loads wait on nothing.  A thread reads its logits unconditionally as
//   16-byte vectors (4 float32 or 8 bfloat16/float16) and its mask bits
//   separately (the one or two words that cover the vector's tokens, or its
//   mask bytes, four to a 32-bit load where the mask row allows), and
//   selects in registers; kUnroll = 2 vectors a thread are in flight at once
//   (1 measured within a few percent of 2, and 4 or 8 slower: a call has
//   enough blocks in flight).  A masked-out logit costs no extra bytes: its
//   line is fetched anyway.
//   Where a row's logits are not 16-byte aligned (an odd row stride, a view
//   that starts mid-row), scalar code in the same kernel takes the tokens up
//   to the first aligned one and the tail after the last whole vector.
// - Every combine orders (value, index) pairs totally -- the larger value
//   wins, equal values go to the lower index -- so the result does not
//   depend on the order in which threads, warps or blocks finish.  With
//   one split the block writes idx/val itself.  Otherwise each block writes
//   its pair to part[b * n_split + split], and the last block of the row to
//   arrive (one int32 counter a row, __threadfence() then atomicAdd) merges
//   the row's n_split pairs in a fixed order, writes idx/val and resets the
//   counter to 0 for the next launch on the stream.  One launch a call, no
//   memset, nothing read back to the host.
// - NaN: a NaN logit never wins a comparison, so it changes neither its own
//   split's pair beyond losing nor another split's or row's result.  A row
//   of only NaN legal logits gives idx INT_MAX, val -inf; the caller evicts
//   rows with non-finite logits before it reads their result.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kUnroll = 2;          // 16-byte logit vectors in flight a thread
constexpr bool kVectorLoads = true;  // false: every token by the scalar code

// Logit types: the storage bits of one logit and their exact widening.
struct F32 {
  using Bits = uint32_t;
  static __device__ __forceinline__ float widen(uint32_t x) { return __uint_as_float(x); }
};
struct BF16 {
  using Bits = unsigned short;
  static __device__ __forceinline__ float widen(unsigned short x) {
    return __uint_as_float(static_cast<uint32_t>(x) << 16);
  }
};
struct F16 {
  using Bits = unsigned short;
  static __device__ __forceinline__ float widen(unsigned short x) {
    return __half2float(__ushort_as_half(x));
  }
};

// Element j of a 16-byte vector of logits, widened.
template <typename L>
__device__ __forceinline__ float lane(const uint4& raw, int j) {
  constexpr int kPerWord = 4 / sizeof(typename L::Bits);
  const int w = j / kPerWord;
  const uint32_t word = w == 0 ? raw.x : w == 1 ? raw.y : w == 2 ? raw.z : raw.w;
  return L::widen(static_cast<typename L::Bits>(
      word >> (8 * sizeof(typename L::Bits) * (j % kPerWord))));
}

// Packed mask: token t of the row is bit (t % 32) of word (t / 32).
struct PackedMask {
  const uint32_t* words;
  long long ld;  // words a row
  const uint32_t* row;
  __device__ __forceinline__ void start(int b, int) { row = words + b * ld; }
  __device__ __forceinline__ bool legal(int t) const {
    return (__ldg(row + (t >> 5)) >> (t & 31)) & 1u;
  }
  // Bit j (j < N) = token t + j: the one word that covers the N tokens, or
  // the two they straddle where the logits' alignment puts t mid-word.
  template <int N>
  __device__ __forceinline__ uint32_t bits(int t) const {
    const uint32_t lo = __ldg(row + (t >> 5));
    const uint32_t hi = (t & 31) + N > 32 ? __ldg(row + (t >> 5) + 1) : lo;
    return __funnelshift_r(lo, hi, t & 31);
  }
};

// Byte mask: token t of the row is legal if its byte is nonzero.
struct ByteMask {
  const unsigned char* mask;
  long long ld;  // bytes a row
  const unsigned char* row;
  bool aligned;  // the vectors' mask bytes are 4-byte aligned in this row
  __device__ __forceinline__ void start(int b, int first_vector_token) {
    row = mask + b * ld;
    aligned = (reinterpret_cast<uintptr_t>(row + first_vector_token) & 3) == 0;
  }
  __device__ __forceinline__ bool legal(int t) const { return __ldg(row + t) != 0; }
  template <int N>
  __device__ __forceinline__ uint32_t bits(int t) const {
    uint32_t out = 0;
    if (aligned) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(row + t) + q);
#pragma unroll
        for (int j = 0; j < 4; ++j) out |= ((w >> (8 * j)) & 0xffu ? 1u : 0u) << (4 * q + j);
      }
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) out |= (__ldg(row + t + j) != 0 ? 1u : 0u) << j;
    }
    return out;
  }
};

__device__ __forceinline__ bool better(float v, int i, float best_v, int best_i) {
  return v > best_v || (v == best_v && i < best_i);
}

__device__ __forceinline__ void consider(float v, int i, float& best_v, int& best_i) {
  if (better(v, i, best_v, best_i)) {
    best_v = v;
    best_i = i;
  }
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    consider(ov, oi, v, i);
  }
}

// The block's best pair, valid in thread 0.  Every thread must call it.
__device__ __forceinline__ void block_best(float& v, int& i) {
  __shared__ float s_val[kThreads / 32];
  __shared__ int s_idx[kThreads / 32];
  const int lane_id = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_best(v, i);
  if (lane_id == 0) {
    s_val[warp] = v;
    s_idx[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane_id < kThreads / 32 ? s_val[lane_id] : -INFINITY;
    i = lane_id < kThreads / 32 ? s_idx[lane_id] : INT_MAX;
    warp_best(v, i);
  }
  __syncthreads();  // s_val / s_idx may be written again
}

template <typename L, typename M>
__global__ void __launch_bounds__(kThreads)
    masked_argmax_kernel(const typename L::Bits* __restrict__ logits, long long ld, M mask,
                         int v, int n_split, int split_len, int2* __restrict__ part,
                         int* __restrict__ counters, int* __restrict__ idx_out,
                         float* __restrict__ val_out) {
  using Bits = typename L::Bits;
  constexpr int N = 16 / sizeof(Bits);  // logits a 16-byte vector
  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const Bits* row = logits + b * ld;
  const int s0 = split * split_len;
  const int s1 = min(v, s0 + split_len);
  // [a0, a1) in vectors: a0 is the first token of the split whose logit is
  // 16-byte aligned
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(row) / sizeof(Bits)) % N);
  const int a0 = min(s1, s0 + (N - mis) % N);
  const int n_vec = kVectorLoads ? (s1 - a0) / N : 0;
  const int a1 = a0 + n_vec * N;
  mask.start(b, a0);

  float best_v = -INFINITY;
  int best_i = INT_MAX;
  for (int k0 = threadIdx.x; k0 < n_vec; k0 += kThreads * kUnroll) {
    uint4 raw[kUnroll];
    uint32_t m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kThreads;
      if (k < n_vec) {
        const int t = a0 + k * N;
        m[u] = mask.template bits<N>(t);
        raw[u] = __ldg(reinterpret_cast<const uint4*>(row + t));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kThreads;
      if (k < n_vec) {
        const int t = a0 + k * N;
#pragma unroll
        for (int j = 0; j < N; ++j)
          consider((m[u] >> j) & 1u ? lane<L>(raw[u], j) : kNeg, t + j, best_v, best_i);
      }
    }
  }
  // the scalar head [s0, a0) and tail [a1, s1) (the whole split where
  // kVectorLoads is false)
  const int n_head = a0 - s0;
  for (int k = threadIdx.x; k < n_head + (s1 - a1); k += kThreads) {
    const int t = k < n_head ? s0 + k : a1 + (k - n_head);
    const float x = L::widen(__ldg(row + t));
    consider(mask.legal(t) ? x : kNeg, t, best_v, best_i);
  }
  block_best(best_v, best_i);

  if (n_split == 1) {
    if (threadIdx.x == 0) {
      idx_out[b] = best_i;
      val_out[b] = best_v;
    }
    return;
  }
  __shared__ bool s_last;
  int2* row_part = part + static_cast<long long>(b) * n_split;
  if (threadIdx.x == 0) {
    row_part[split] = make_int2(__float_as_int(best_v), best_i);
    __threadfence();  // the pair is visible before the count says so
    s_last = atomicAdd(counters + b, 1) == n_split - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block of the row: every other pair has landed
  __threadfence();
  best_v = -INFINITY;
  best_i = INT_MAX;
  for (int k = threadIdx.x; k < n_split; k += kThreads) {
    const int2 p = __ldcg(row_part + k);  // from L2: written by other blocks
    consider(__int_as_float(p.x), p.y, best_v, best_i);
  }
  block_best(best_v, best_i);
  if (threadIdx.x == 0) {
    idx_out[b] = best_i;
    val_out[b] = best_v;
    counters[b] = 0;
  }
}

template <typename L, typename M>
int launch(const void* logits, long long ld, M mask, int b, int v, int n_split, int split_len,
           void* part, void* counters, void* idx, void* val, void* stream) {
  const dim3 grid(n_split, b);
  masked_argmax_kernel<L, M><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename L::Bits*>(logits), ld, mask, v, n_split, split_len,
      static_cast<int2*>(part), static_cast<int*>(counters), static_cast<int*>(idx),
      static_cast<float*>(val));
  return static_cast<int>(cudaGetLastError());
}

// One body, three logit types: dtype 0 float32, 1 bfloat16, 2 float16.
template <typename M>
int dispatch(int dtype, const void* logits, long long ld, M mask, int b, int v, int n_split,
             int split_len, void* part, void* counters, void* idx, void* val, void* stream) {
  if (b <= 0) return 0;
  if (n_split < 1 || split_len <= 0 || split_len % 32 != 0 ||
      static_cast<long long>(n_split) * split_len < v ||
      static_cast<long long>(n_split - 1) * split_len >= (v > 0 ? v : 1) ||
      (n_split > 1 && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch<F32>(logits, ld, mask, b, v, n_split, split_len, part, counters, idx, val,
                         stream);
    case 1:
      return launch<BF16>(logits, ld, mask, b, v, n_split, split_len, part, counters, idx, val,
                          stream);
    case 2:
      return launch<F16>(logits, ld, mask, b, v, n_split, split_len, part, counters, idx, val,
                         stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// logits: (b, ld)-strided rows of `dtype` of which the first v columns are
// read; words: (b, n_words) contiguous packed mask words (int32 storage, read
// as uint32); the plan: n_split blocks a row of split_len tokens (a multiple
// of 32); with n_split > 1, part holds b * n_split int2 pairs of scratch and
// counters b int32 counters that are zero before the launch and are left
// zero after it.  idx (b,) int32 and val (b,) float32 are written.  Returns
// the launch's cudaGetLastError() code.
extern "C" int repro_masked_argmax_packed(int dtype, const void* logits, long long ld,
                                          const void* words, int n_words, int b, int v,
                                          int n_split, int split_len, void* part,
                                          void* counters, void* idx, void* val, void* stream) {
  const PackedMask mask{static_cast<const uint32_t*>(words), n_words, nullptr};
  return dispatch(dtype, logits, ld, mask, b, v, n_split, split_len, part, counters, idx, val,
                  stream);
}

// logits and the plan as above; mask: (b, mld)-strided rows of one byte a
// token (bool, int8 or uint8 storage; nonzero = legal) of which the first v
// are read.
extern "C" int repro_masked_argmax_bytes(int dtype, const void* logits, long long ld,
                                         const void* mask, long long mld, int b, int v,
                                         int n_split, int split_len, void* part,
                                         void* counters, void* idx, void* val, void* stream) {
  const ByteMask m{static_cast<const unsigned char*>(mask), mld, nullptr, false};
  return dispatch(dtype, logits, ld, m, b, v, n_split, split_len, part, counters, idx, val,
                  stream);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
