// Fused grammar mask + argmax over the vocabulary (Hopper, sm_90a), for the
// two mask layouts of the TPU kernels.
//
// Replaces: src/repro/kernels/masked_sample/kernel.py
//   masked_argmax_pallas_packed -> _kernel_packed (packed uint32 words), and
//   masked_argmax_pallas -> _kernel (one int8/bool byte a token).
//
// Computes, per row b:
//   masked[t] = (token t legal) ? logits[b, t] : -1e30
//   idx[b] = lowest t with masked[t] == max(masked), val[b] = that max
// where token t is legal if bit (t % 32) of word (t / 32) is set (packed) or
// its mask byte is nonzero (bytes), so an all-illegal row gives idx 0, val
// -1e30, exactly like the reference.  The two layouts of one mask give the
// same result bit for bit.
//
// What bounds it: bytes.  Each row reads V float32 logits and V/32 mask words
// (or V mask bytes) once and writes 8 bytes; there is one compare per token.
// At the serving shapes (B <= 64 rows, V <= ~1e5) that is at most a few MB, so
// the card's memory rate bounds it at a microsecond or two and in practice the
// launch itself dominates.
//
// Design: one block per row walks the row with a block-wide stride, so that
// the 32 lanes of a warp read 32 consecutive logits (one 128-byte line) and
// all read the same mask word (a broadcast) or 32 consecutive mask bytes.
// The word is reinterpreted as uint32 and unpacked in-register; the masked
// logits never touch memory.
// The TPU walks the vocabulary tiles in order and keeps the first maximum;
// here threads and warps finish in no order, so every combine orders
// (value, index) pairs totally -- larger value wins, equal values go to the
// lower index -- which makes the result independent of the reduction order.
// NaN logits never win a comparison; such rows are evicted by the caller
// before their result is read, and the kernel still terminates normally.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ bool better(float v, int i, float best_v, int best_i) {
  return v > best_v || (v == best_v && i < best_i);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// The block's best (value, index) pair, written by thread 0 to row b.
__device__ __forceinline__ void block_best(float best_v, int best_i, int b,
                                           int* __restrict__ idx_out,
                                           float* __restrict__ val_out) {
  warp_best(best_v, best_i);
  __shared__ float s_val[kMaxThreads / 32];
  __shared__ int s_idx[kMaxThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_val[warp] = best_v;
    s_idx[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    best_v = lane < n_warps ? s_val[lane] : -INFINITY;
    best_i = lane < n_warps ? s_idx[lane] : INT_MAX;
    warp_best(best_v, best_i);
    if (lane == 0) {
      idx_out[b] = best_i;
      val_out[b] = best_v;
    }
  }
}

__global__ void masked_argmax_packed_kernel(const float* __restrict__ logits, long long ld,
                                            const uint32_t* __restrict__ words, int n_words,
                                            int v, int* __restrict__ idx_out,
                                            float* __restrict__ val_out) {
  const int b = blockIdx.x;
  const float* row = logits + (long long)b * ld;
  const uint32_t* wrow = words + (long long)b * n_words;
  float best_v = -INFINITY;
  int best_i = INT_MAX;
  for (int t = threadIdx.x; t < v; t += blockDim.x) {
    const uint32_t w = __ldg(wrow + (t >> 5));
    const float x = ((w >> (t & 31)) & 1u) ? __ldg(row + t) : kNeg;
    if (better(x, t, best_v, best_i)) {
      best_v = x;
      best_i = t;
    }
  }
  block_best(best_v, best_i, b, idx_out, val_out);
}

__global__ void masked_argmax_bytes_kernel(const float* __restrict__ logits, long long ld,
                                           const unsigned char* __restrict__ mask,
                                           long long mld, int v, int* __restrict__ idx_out,
                                           float* __restrict__ val_out) {
  const int b = blockIdx.x;
  const float* row = logits + (long long)b * ld;
  const unsigned char* mrow = mask + (long long)b * mld;
  float best_v = -INFINITY;
  int best_i = INT_MAX;
  for (int t = threadIdx.x; t < v; t += blockDim.x) {
    const float x = __ldg(mrow + t) != 0 ? __ldg(row + t) : kNeg;
    if (better(x, t, best_v, best_i)) {
      best_v = x;
      best_i = t;
    }
  }
  block_best(best_v, best_i, b, idx_out, val_out);
}

int threads_for(int v) {
  int threads = ((v + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  return threads;
}

}  // namespace

// logits: (b, ld)-strided float32 rows of which the first v columns are read;
// words: (b, n_words) contiguous packed mask words (int32 storage, read as
// uint32); idx (b,) int32 and val (b,) float32 are written.  Returns the
// launch's cudaGetLastError() code.
extern "C" int repro_masked_argmax_packed(const void* logits, long long ld, const void* words,
                                          int n_words, int b, int v, void* idx, void* val,
                                          void* stream) {
  if (b <= 0) return 0;
  masked_argmax_packed_kernel<<<b, threads_for(v), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), ld, static_cast<const uint32_t*>(words), n_words, v,
      static_cast<int*>(idx), static_cast<float*>(val));
  return static_cast<int>(cudaGetLastError());
}

// logits as above; mask: (b, mld)-strided rows of one byte a token (bool,
// int8 or uint8 storage; nonzero = legal) of which the first v are read.
extern "C" int repro_masked_argmax_bytes(const void* logits, long long ld, const void* mask,
                                         long long mld, int b, int v, void* idx, void* val,
                                         void* stream) {
  if (b <= 0) return 0;
  masked_argmax_bytes_kernel<<<b, threads_for(v), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), ld, static_cast<const unsigned char*>(mask), mld, v,
      static_cast<int*>(idx), static_cast<float*>(val));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
