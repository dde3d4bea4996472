// Ragged, paged GQA decode attention with an online softmax (Hopper, sm_90a).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py
//   decode_attention_pallas -> _kernel (the TPU kernel), without its split
//   score operand (q2, k2), which only absorbed MLA uses.
//
// Computes, for row b, KV group g and query row r = s * Qh + qh of the
// window (s < S, qh < Qh):
//   out[b, s, g, qh] = softmax_t(q . k_t * scale) @ v   over keys t < lengths[b] + s
// Rows that see no key give exactly 0.  Paged mode reads key t of row b from
// pool page max(block_tables[b, t / ps], 0) at offset t % ps; contiguous
// mode reads it from k[b, t] (page size = T, one page per row).
//
// What bounds it: bytes.  Per (row, group) it reads each visible key and value
// once (2 * D elements), and does 4 * D flops per key and query row -- about
// one flop per byte in bf16, far below the ~300 the card needs before the
// arithmetic, not the memory, is the limit.
//
// Design: one block of four warps per (b, g); the block loops over the row's
// keys up to its own frontier lengths[b] + S - 1, in chunks of 32 keys, the
// chunks dealt round-robin to the warps.  This loop stands in for the TPU's
// sequential T axis.  Within a chunk each lane scores one key against every
// query row (the queries sit in shared memory as float32), then the warp
// updates its own online softmax state (m, l, acc) for each query row; lane l
// holds accumulator elements [l * DPL, (l + 1) * DPL).  The warps' states are
// merged once at the end through shared memory.  No key at or past the
// frontier is ever read, so pages that other rows own -- or stale, even NaN,
// contents of this row's own pages -- never reach the accumulator.  The block
// loads its own block-table entries; entries <= 0 go to the trash page 0.
// Keys past the table's width are never visited (the frontier is capped at
// n_tiles * page_size), matching the TPU kernel's grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
  __device__ static void load_vec(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_float(float x) { return __float2bfloat16(x); }
  __device__ static void load_vec(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// RMAX bounds the S * Qh query rows a block holds in registers; DPL is the
// number of value elements each lane accumulates (Dv <= 32 * DPL).
template <typename T, int RMAX, int DPL>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const int* __restrict__ lengths,
                            const int* __restrict__ tables, T* __restrict__ out, int S, int G,
                            int Qh, int Dk, int Dv, int page_size, int n_tiles, float scale) {
  extern __shared__ float smem[];
  const int R = S * Qh;
  float* q_s = smem;                 // (R, Dk)
  float* m_s = q_s + R * Dk;         // (kWarps, R)
  float* l_s = m_s + kWarps * R;     // (kWarps, R)
  float* acc_s = l_s + kWarps * R;   // (kWarps, R, Dv)

  const int b = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // query rows of this (b, g): q[b, s, g, qh, :] for r = s * Qh + qh
  for (int e = threadIdx.x; e < R * Dk; e += kThreads) {
    const int r = e / Dk, d = e % Dk;
    const int s = r / Qh, qh = r % Qh;
    q_s[e] = Elem<T>::to_float(q[((((long long)b * S + s) * G + g) * Qh + qh) * Dk + d]);
  }
  __syncthreads();

  const int base = lengths[b];               // keys visible to window position 0
  long long frontier = (long long)base + S - 1;
  const long long cap = (long long)n_tiles * page_size;
  if (frontier > cap) frontier = cap;
  const int n_keys = frontier > 0 ? static_cast<int>(frontier) : 0;
  const int* tbl = tables == nullptr ? nullptr : tables + (long long)b * n_tiles;

  float m[RMAX], l[RMAX], acc[RMAX][DPL];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int c0 = warp * 32; c0 < n_keys; c0 += kWarps * 32) {
    const int t = c0 + lane;
    const bool have = t < n_keys;
    long long kv_row = 0;  // (pool row * page_size + offset) * G + g
    float sc[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) sc[r] = 0.f;
    if (have) {
      int page;
      if (tbl != nullptr) {
        page = tbl[t / page_size];
        page = page > 0 ? page : 0;
      } else {
        page = b;
      }
      kv_row = ((long long)page * page_size + t % page_size) * G + g;
      const T* krow = k + kv_row * Dk;
      for (int d = 0; d < Dk; d += Elem<T>::kVec) {
        float kf[Elem<T>::kVec];
        Elem<T>::load_vec(krow + d, kf);
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r < R) {
            const float* qr = q_s + r * Dk + d;
#pragma unroll
            for (int j = 0; j < Elem<T>::kVec; ++j) sc[r] += qr[j] * kf[j];
          }
        }
      }
    }
    // online softmax update, one query row at a time
    float p[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      p[r] = 0.f;
      if (r < R) {
        const bool valid = have && t < base + r / Qh;
        const float s_val = valid ? sc[r] * scale : kNeg;
        const float m_new = fmaxf(m[r], warp_max(s_val));
        // explicit re-mask: a row with no valid key in this chunk must not
        // count exp(0) = 1 per dead key into l
        p[r] = valid ? expf(s_val - m_new) : 0.f;
        const float corr = expf(m[r] - m_new);
        l[r] = l[r] * corr + warp_sum(p[r]);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
        m[r] = m_new;
      }
    }
    // acc += p @ v over the chunk's keys; lane l owns elements l*DPL..
    const int n_in = min(32, n_keys - c0);
    for (int j = 0; j < n_in; ++j) {
      const long long row_j = __shfl_sync(0xffffffffu, kv_row, j);
      const T* vrow = v + row_j * Dv;
      float vf[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane * DPL + i;
        vf[i] = d < Dv ? Elem<T>::to_float(vrow[d]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < R) {
          const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] += pj * vf[i];
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r < R) {
      if (lane == 0) {
        m_s[warp * R + r] = m[r];
        l_s[warp * R + r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane * DPL + i;
        if (d < Dv) acc_s[(warp * R + r) * Dv + d] = acc[r][i];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * Dv; e += kThreads) {
    const int r = e / Dv, d = e % Dv;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * R + r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w * R + r] - mx);
      den += l_s[w * R + r] * c;
      num += acc_s[(w * R + r) * Dv + d] * c;
    }
    const int s = r / Qh, qh = r % Qh;
    out[((((long long)b * S + s) * G + g) * Qh + qh) * Dv + d] =
        Elem<T>::from_float(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int RMAX>
cudaError_t launch_rows(const void* q, const void* k, const void* v, const int* lengths,
                        const int* tables, void* out, int B, int S, int G, int Qh, int Dk,
                        int Dv, int page_size, int n_tiles, float scale, cudaStream_t stream) {
  const int R = S * Qh;
  const size_t smem = sizeof(float) * ((size_t)R * Dk + 2 * kWarps * R + (size_t)kWarps * R * Dv);
  const dim3 grid(B * G);
  const int dpl = (Dv + 31) / 32;
#define REPRO_LAUNCH(DPL_)                                                                       \
  decode_attention_kernel<T, RMAX, DPL_><<<grid, kThreads, smem, stream>>>(                      \
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,     \
      tables, static_cast<T*>(out), S, G, Qh, Dk, Dv, page_size, n_tiles, scale)
  if (dpl <= 1) {
    REPRO_LAUNCH(1);
  } else if (dpl <= 2) {
    REPRO_LAUNCH(2);
  } else if (dpl <= 4) {
    REPRO_LAUNCH(4);
  } else {
    return cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   const int* tables, void* out, int B, int S, int G, int Qh, int Dk, int Dv,
                   int page_size, int n_tiles, float scale, cudaStream_t stream) {
  const int R = S * Qh;
  if (R <= 1)
    return launch_rows<T, 1>(q, k, v, lengths, tables, out, B, S, G, Qh, Dk, Dv, page_size,
                             n_tiles, scale, stream);
  if (R <= 4)
    return launch_rows<T, 4>(q, k, v, lengths, tables, out, B, S, G, Qh, Dk, Dv, page_size,
                             n_tiles, scale, stream);
  if (R <= 16)
    return launch_rows<T, 16>(q, k, v, lengths, tables, out, B, S, G, Qh, Dk, Dv, page_size,
                              n_tiles, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// q (B, S, G, Qh, Dk) and out (B, S, G, Qh, Dv) contiguous; lengths (B,) int32.
// Paged: k (n_pages, page_size, G, Dk), v likewise with Dv, tables (B, n_tiles)
// int32.  Contiguous: tables == NULL, k (B, T, G, Dk) with page_size = T and
// n_tiles = 1.  Returns the launch's cudaGetLastError() code.
extern "C" int repro_decode_attention(int dtype, const void* q, const void* k, const void* v,
                                      const void* lengths, const void* tables, void* out, int B,
                                      int S, int G, int Qh, int Dk, int Dv, int page_size,
                                      int n_tiles, float scale, void* stream) {
  if (B <= 0 || G <= 0 || S <= 0 || Qh <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const int* tbl = static_cast<const int*>(tables);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k, v, len, tbl, out, B, S, G, Qh, Dk, Dv, page_size, n_tiles, scale,
                        st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, len, tbl, out, B, S, G, Qh, Dk, Dv, page_size, n_tiles,
                                scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
