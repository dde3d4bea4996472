// Ragged, paged decode attention with an online softmax (Hopper, sm_90a).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py
//   decode_attention_pallas -> _kernel (the TPU kernel), in two entry points:
//   repro_decode_attention for the plain score (GQA), and
//   repro_decode_attention_split for the split score (q2, k2) of absorbed MLA.
//
// Plain score.  Computes, for row b, KV group g and query row r = s * Qh + qh
// of the window (s < S, qh < Qh):
//   out[b, s, g, qh] = softmax_t(q . k_t * scale) @ v   over keys t < lengths[b] + s
// Rows that see no key give exactly 0.  Paged mode reads key t of row b from
// pool page max(block_tables[b, t / ps], 0) at offset t % ps; contiguous
// mode reads it from k[b, t] (page size = T, one page per row).  Any S * Qh
// query rows, in tiles of 16; Dk and Dv multiples of 8 and at most 128,
// float32 or bfloat16.
//
// What bounds it: bytes.  Per (row, group) it reads each visible key and value
// once (2 * D elements a key), and does 4 * D flops per key and query row --
// about one flop per byte in bf16 at Qh = 1, far below the ~300 the card
// needs before the arithmetic, not the memory, is the limit.  So the design
// is about keeping enough bytes in flight to cover the memory's latency:
//
// - Keys split across blocks ("flash-decoding").  The grid is (B * G,
//   n_split, row tiles): block (b * G + g, j, i) takes keys [j * L, (j + 1) *
//   L) of row b, group g, for query rows [16 i, 16 i + 16) of the window.
//   The caller picks n_split and L from shapes alone (the batch, G and the
//   key capacity n_tiles * page_size: key_split_plan in
//   kernels/decode_attention/ref.py), never from the lengths, so a call reads
//   nothing back to the host.  A block whose range lies wholly past its row's
//   frontier lengths[b] + S - 1 exits at once and writes nothing.
// - K and V tiles of 64 keys staged in shared memory with cp.async, 16 bytes
//   a thread, coalesced, in two stages: tile i + 1 is in flight while tile i
//   is scored and accumulated.  A block loads its length, its query rows and
//   the table entries its range spans together, once, before it knows its
//   frontier.  Positions past the frontier are zero-filled (src-size 0), never
//   read, so pages that other rows own -- or stale, even NaN, contents of
//   this row's own pages -- never reach the accumulator.  Table entries <= 0
//   go to the trash page 0; the frontier is capped at n_tiles * page_size,
//   matching the TPU kernel's grid.
// - Within a block each warp scores 16 keys of a tile, two lanes a key (each
//   half of the dot product), and keeps its own online softmax state (m, l,
//   acc) for each query row; lane l holds accumulator elements
//   [l * DPL, (l + 1) * DPL).  The four warps' states merge once at the end.
// - Merging the splits: a row whose frontier lies in its first split is
//   written by that block directly.  Otherwise each live block writes its
//   partial state (m, l and the unnormalised acc) to scratch, and the last
//   block of (b, g, row tile) to arrive -- one atomic counter each -- merges
//   the live partials in split order, each rescaled by exp(m_j - m).  No
//   float atomics: equal inputs give bitwise-equal outputs.
//
// Split score (absorbed MLA).  The latent cache is both key and value:
//   out[b, s, g, qh] = softmax_t((q . k_t + q2 . k2_t) * scale) @ k_t
// with q (B, S, G, Qh, R), k the latent (R = kv_lora_rank, 512 at
// deepseek-v3), q2/k2 the rope term (D2 = 64) and the same frontier, paging,
// trash-page and empty-row rules as above.
//
// What bounds it: operations, then bytes.  Every key is scored against every
// query head (R + D2 products) and accumulated into it (R products): at 128
// heads, B = 4 and 1000 keys a row that is ~1.11 GFLOP for ~5.7 MB, ~195
// flops a byte -- near the card's bf16 tensor-core balance (~295) and ten
// times its float32 CUDA-core balance.  On the CUDA cores the arithmetic
// alone takes ~17 us; on the tensor cores ~1.1 us, under the ~1.7 us of the
// bytes.  So bfloat16 runs on the tensor cores (decode_attention_split_mma_
// kernel); float32 keeps a CUDA-core kernel (decode_attention_split_kernel),
// since bf16 products cannot keep float32's accuracy.
//
// bfloat16 design:
// - Grid (tile of 32 query rows of the S * Qh window, key split, b * G + g),
//   blocks of 16 warps, one block an SM: the two m16 tiles of a block share
//   every staged key, and the row tiles of one (split, b, g) are adjacent in
//   launch order, so the keys they share come from the L2.  The key split is
//   chosen on the host from shapes alone (split_score_plan in
//   kernels/decode_attention/ref.py) to fill the card's 132 SMs in one wave;
//   a split past its row's frontier exits at once.
// - Both products on the tensor cores: mma.sync m16n8k16, bf16 operands and
//   float32 accumulators.  The 8 warps of an m16 tile split the scores of a
//   32-key tile as 2 key halves x 4 quarters of the R + D2 deep product: a
//   warp keeps its quarter of the queries in registers as A fragments,
//   loaded once (36 registers at deepseek-v3's width), and reads B from the
//   staged keys by ldmatrix, two 8-key accumulators a k-step.  The quarters
//   meet in shared memory; each warp then owns two rows' online softmax
//   (base 2, the scale folded in; 16 lanes a row, two keys a lane) and
//   writes the tile's probabilities in bf16 and each row's rescale.  P @ V:
//   warp w of a tile owns latent columns [64 w, 64 w + 64) at R = 512 (eight
//   16 x 8 accumulators), A = P by ldmatrix, B by ldmatrix.trans from the
//   staged latent rows: the keys are the values, staged once.
// - Key tiles (latent and rope rows) are staged by cp.async in a ring of
//   four stages, three tiles in flight while one is multiplied.  Rows past the
//   frontier are zero-filled (src-size 0), never read.  A staged row is
//   padded by 16 bytes (1040 bytes a latent row, 144 a rope row), so the 8
//   rows of an ldmatrix fall in distinct banks; a depth that is not a
//   multiple of 16 is zero-padded in shared memory.  A block holds 176,000
//   bytes of shared memory at deepseek-v3's width.
// - Merging the splits: a row whose frontier lies in its first split is
//   written by that block; otherwise each live block writes its (acc, m, l)
//   to scratch, n_split * B * G * S * Qh * (R + 4) floats (1.06 MB a split at
//   B = 4, 128 heads and R = 512), and a second kernel
//   (decode_attention_split_combine_kernel), one block a query row, merges
//   them in split order.  A merge by the last block to arrive, as the plain
//   score does it, would make one block read 32 rows x (R + 4) floats of
//   every live split (~0.5 MB at 8 splits) while the card idles.  No float
//   atomics: equal inputs give bitwise-equal outputs.
// - What bounds it on the card: not the bytes.  The operands of mma.sync pass
//   through shared memory once a 16-row tile (ldmatrix), and the phases of a
//   key tile (scores, softmax, P @ V) are separated by block barriers, so
//   the tensor cores wait on both; wgmma (B read once for 64 rows, A from
//   shared memory) and TMA are the levers for a later change.
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

// -- plain score: keys split across blocks, tiles staged with cp.async -----------

constexpr int kTileKeys = 64;                   // keys a stage holds
constexpr int kWarpKeys = kTileKeys / kWarps;   // keys a warp scores, two lanes a key
constexpr int kMaxSplitPages = kThreads;        // table entries one split may span
constexpr int kRowTile = 16;                    // query rows a block holds

// 16-byte asynchronous copy to shared memory; src-size 0 zero-fills the
// destination and reads nothing from ``src``.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool read) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = read ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive elements as float32 (N in {1, 2, 4}; p aligned to N elements).
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x;
    out[1] = x.y;
  } else {
    out[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void load_floats(const __nv_bfloat16* p, float* out) {
  if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    out[0] = a.x;
    out[1] = a.y;
    out[2] = b.x;
    out[3] = b.y;
  } else if constexpr (N == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x;
    out[1] = a.y;
  } else {
    out[0] = __bfloat162float(p[0]);
  }
}

// Bytes of one staged key row: padded by 16 so that the eight lanes of a
// quarter warp, reading one 16-byte column of eight rows, hit distinct banks.
template <typename T>
__host__ __device__ inline int key_row_bytes(int Dk) {
  return Dk * static_cast<int>(sizeof(T)) + 16;
}

// Dynamic shared memory of one block: two stages of K and V tiles (reused
// for the warps' states at the end), the pool rows of two tiles' keys, the
// tile's query rows in float32, the split's table entries and one flag.  The
// stages always cover the warps' states: at 16 query rows those take
// 256 * (Dv + 2) bytes, the stages at least 256 * Dv + 4096.
template <typename T>
__host__ __device__ inline size_t plain_smem_bytes(int R, int Dk, int Dv) {
  return 2 * (size_t)kTileKeys * (key_row_bytes<T>(Dk) + Dv * sizeof(T)) +
         2 * kTileKeys * sizeof(long long) + sizeof(float) * (size_t)R * Dk +
         sizeof(int) * (kMaxSplitPages + 1);
}

// RMAX bounds the query rows of a block's tile (at most kRowTile), held in
// registers; DPL is the number of value elements each lane accumulates
// (Dv <= 32 * DPL).
template <typename T, int RMAX, int DPL>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const int* __restrict__ lengths,
                            const int* __restrict__ tables, T* __restrict__ out,
                            float* __restrict__ part, int* __restrict__ counters, int S, int G,
                            int Qh, int Dk, int Dv, int page_size, int n_tiles, int split_len,
                            float scale) {
  constexpr int kVec = Elem<T>::kVec;
  extern __shared__ __align__(16) unsigned char plain_smem[];
  const int n_rows = S * Qh;                                // query rows of the window
  const int r0 = blockIdx.z * kRowTile;                     // the tile's first
  const int R = min(kRowTile, n_rows - r0);                 // and its count
  const int k_row = key_row_bytes<T>(Dk);
  const int v_row = Dv * static_cast<int>(sizeof(T));
  unsigned char* k_st = plain_smem;                         // (2, kTileKeys) rows of k_row
  unsigned char* v_st = k_st + 2 * kTileKeys * k_row;       // (2, kTileKeys) rows of v_row
  long long* row_s = reinterpret_cast<long long*>(v_st + 2 * kTileKeys * v_row);
                                                            // (2, kTileKeys) pool rows
  float* q_s = reinterpret_cast<float*>(row_s + 2 * kTileKeys);  // (R, Dk)
  int* page_s = reinterpret_cast<int*>(q_s + R * Dk);       // (kMaxSplitPages,)
  int* last_s = page_s + kMaxSplitPages;
  // after the key loop the stages hold the warps' states
  float* m_s = reinterpret_cast<float*>(plain_smem);        // (kWarps, R)
  float* l_s = m_s + kWarps * R;                            // (kWarps, R)
  float* acc_s = l_s + kWarps * R;                          // (kWarps, R, Dv)

  const int bg = blockIdx.x;
  const int b = bg / G;
  const int g = bg % G;
  const int split = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long cap = (long long)n_tiles * page_size;
  const int lo = split * split_len;                         // the split's first key
  const int* tbl = tables == nullptr ? nullptr : tables + (long long)b * n_tiles;
  const int p0 = lo / page_size;                            // its first page (paged)

  // Issue every load the block needs before its frontier is known: the row's
  // length, the table entries the split spans and the query rows.
  const int base = lengths[b];                              // keys visible to window position 0
  int entry = 0;
  if (tbl != nullptr) {
    const int pi = p0 + threadIdx.x;   // page pi holds keys [pi * ps, (pi + 1) * ps)
    if (pi < n_tiles && (long long)pi * page_size < (long long)lo + split_len) entry = tbl[pi];
  }
  for (int e = threadIdx.x; e < R * Dk; e += kThreads) {
    const int r = e / Dk, d = e % Dk;
    const int s = (r0 + r) / Qh, qh = (r0 + r) % Qh;
    q_s[e] = Elem<T>::to_float(q[((((long long)b * S + s) * G + g) * Qh + qh) * Dk + d]);
  }
  long long frontier = (long long)base + S - 1;
  if (frontier > cap) frontier = cap;
  if (frontier < 0) frontier = 0;
  // splits that hold a visible key; split 0 also answers a row that sees none
  const int n_live = static_cast<int>((frontier + split_len - 1) / split_len);
  if (split > 0 && split >= n_live) return;
  page_s[threadIdx.x] = entry > 0 ? entry : 0;
  __syncthreads();
  const int hi = static_cast<int>(min((long long)lo + split_len, frontier));  // keys [lo, hi)
  const int n_steps = hi > lo ? (hi - lo + kTileKeys - 1) / kTileKeys : 0;

  // Pool rows of tile i's keys ((pool row * page_size + offset) * G + g),
  // -1 past the frontier; one thread a key, so one division a key.
  auto rows = [&](int i) {
    if (threadIdx.x < kTileKeys) {
      const int t = lo + i * kTileKeys + threadIdx.x;
      long long row = -1;
      if (t < hi) {
        row = tbl != nullptr
                  ? ((long long)page_s[t / page_size - p0] * page_size + t % page_size) * G + g
                  : ((long long)b * page_size + t) * G + g;
      }
      row_s[(i & 1) * kTileKeys + threadIdx.x] = row;
    }
  };
  // Each thread copies the same 16-byte chunk x of every (kThreads / chunks)-th
  // key of a tile; the pattern is fixed, only the rows change.
  const int kc = Dk / kVec;            // 16-byte chunks of a key row
  const int vc = Dv / kVec;            // and of a value row
  const int k_keys = kThreads / kc;    // keys one sweep of the block copies
  const int v_keys = kThreads / vc;
  const int kx = threadIdx.x % kc, kj = threadIdx.x / kc;
  const int vx = threadIdx.x % vc, vj = threadIdx.x / vc;
  auto issue = [&](int i) {
    const long long* rs = row_s + (i & 1) * kTileKeys;
    unsigned char* ks = k_st + (i & 1) * kTileKeys * k_row;
    unsigned char* vs = v_st + (i & 1) * kTileKeys * v_row;
    if (kj < k_keys) {
      for (int j = kj; j < kTileKeys; j += k_keys) {
        const long long row = rs[j];
        cp_async16(ks + j * k_row + kx * 16, k + (row < 0 ? 0 : row) * Dk + kx * kVec, row >= 0);
      }
    }
    if (vj < v_keys) {
      for (int j = vj; j < kTileKeys; j += v_keys) {
        const long long row = rs[j];
        cp_async16(vs + j * v_row + vx * 16, v + (row < 0 ? 0 : row) * Dv + vx * kVec, row >= 0);
      }
    }
  };

  float m[RMAX], l[RMAX], acc[RMAX][DPL];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  const int kk = lane & 15;      // the lane's key among the warp's 16
  const int side = lane >> 4;    // and its half of the dot product
  const int j0 = warp * kWarpKeys;
  const bool owns_v = lane * DPL < Dv;   // Dv % 8 == 0: all DPL elements or none

  rows(0);
  rows(1);
  __syncthreads();
  if (n_steps > 0) issue(0);
  cp_async_commit();
  for (int i = 0; i < n_steps; ++i) {
    if (i + 1 < n_steps) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();          // this thread's copies of tile i have landed
    __syncthreads();             // and everyone's
    if (i + 2 < n_steps) rows(i + 2);   // tile i's rows are spent
    const unsigned char* ks = k_st + (i & 1) * kTileKeys * k_row;
    const unsigned char* vs = v_st + (i & 1) * kTileKeys * v_row;
    const int t = lo + i * kTileKeys + j0 + kk;
    const bool have = t < hi;
    // half the dot products of key j0 + kk: 16-byte vectors side, side + 2, ...
    float sc[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) sc[r] = 0.f;
    const T* krow = reinterpret_cast<const T*>(ks + (j0 + kk) * k_row);
#pragma unroll 4
    for (int x = side; x < kc; x += 2) {
      float kf[kVec];
      Elem<T>::load_vec(krow + x * kVec, kf);
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < R) {
          const float* qr = q_s + r * Dk + x * kVec;
#pragma unroll
          for (int jj = 0; jj < kVec; ++jj) sc[r] += qr[jj] * kf[jj];
        }
      }
    }
    // online softmax update, one query row at a time; lanes kk and kk + 16
    // hold the same score, and only the lower half counts it into l
    float p[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      p[r] = 0.f;
      if (r < R) {
        const float full = sc[r] + __shfl_xor_sync(0xffffffffu, sc[r], 16);
        const bool valid = have && t < base + (r0 + r) / Qh;
        const float s_val = valid ? full * scale : kNeg;
        const float m_new = fmaxf(m[r], warp_max(s_val));
        // explicit re-mask: a row with no valid key in this tile must not
        // count exp(0) = 1 per dead key into l
        p[r] = valid ? expf(s_val - m_new) : 0.f;
        const float corr = expf(m[r] - m_new);
        l[r] = l[r] * corr + warp_sum(side == 0 ? p[r] : 0.f);
#pragma unroll
        for (int i2 = 0; i2 < DPL; ++i2) acc[r][i2] *= corr;
        m[r] = m_new;
      }
    }
    // acc += p @ v over the warp's 16 keys, read from the staged tile; keys
    // past the frontier have p = 0 and zero-filled rows, so they add 0
#pragma unroll
    for (int j = 0; j < kWarpKeys; ++j) {
      float vf[DPL];
      if (owns_v) {
        load_floats<DPL>(reinterpret_cast<const T*>(vs + (j0 + j) * v_row) + lane * DPL, vf);
      } else {
#pragma unroll
        for (int i2 = 0; i2 < DPL; ++i2) vf[i2] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < R) {
          const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
          for (int i2 = 0; i2 < DPL; ++i2) acc[r][i2] += pj * vf[i2];
        }
      }
    }
    __syncthreads();             // the next issue overwrites this stage
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the warps' states (the stages are free now)
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r < R) {
      if (lane == 0) {
        m_s[warp * R + r] = m[r];
        l_s[warp * R + r] = l[r];
      }
#pragma unroll
      for (int i2 = 0; i2 < DPL; ++i2) {
        const int d = lane * DPL + i2;
        if (d < Dv) acc_s[(warp * R + r) * Dv + d] = acc[r][i2];
      }
    }
  }
  __syncthreads();
  const bool direct = n_live <= 1;
  const int stride = Dv + 2;     // a partial row: acc[0, Dv), m, l
  const long long split_stride = (long long)gridDim.x * n_rows * stride;
  float* mine =
      direct ? nullptr : part + (((long long)split * gridDim.x + bg) * n_rows + r0) * stride;
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
    if (direct) {
      const int s = (r0 + r) / Qh, qh = (r0 + r) % Qh;
      out[((((long long)b * S + s) * G + g) * Qh + qh) * Dv + d] =
          Elem<T>::from_float(num / fmaxf(den, 1e-30f));
    } else {
      mine[r * stride + d] = num;
      if (d == 0) {
        mine[r * stride + Dv] = mx;
        mine[r * stride + Dv + 1] = den;
      }
    }
  }
  if (direct) return;

  // the last live block of (b, g, row tile) to arrive merges the partials in
  // split order
  int* counter = counters + (long long)bg * gridDim.z + blockIdx.z;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last_s = atomicAdd(counter, 1) == n_live - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  const float* first = part + ((long long)bg * n_rows + r0) * stride;
  for (int e = threadIdx.x; e < R * Dv; e += kThreads) {
    const int r = e / Dv, d = e % Dv;
    const float* pr = first + r * stride;
    float mx = kNeg;
    for (int j = 0; j < n_live; ++j) mx = fmaxf(mx, __ldcg(pr + j * split_stride + Dv));
    float den = 0.f, num = 0.f;
    for (int j = 0; j < n_live; ++j) {
      const float* pj = pr + j * split_stride;
      const float c = expf(__ldcg(pj + Dv) - mx);
      den += __ldcg(pj + Dv + 1) * c;
      num += __ldcg(pj + d) * c;
    }
    const int s = (r0 + r) / Qh, qh = (r0 + r) % Qh;
    out[((((long long)b * S + s) * G + g) * Qh + qh) * Dv + d] =
        Elem<T>::from_float(num / fmaxf(den, 1e-30f));
  }
  if (threadIdx.x == 0) *counter = 0;   // leave the counter as the caller gave it
}

template <typename T, int RMAX>
cudaError_t launch_rows(const void* q, const void* k, const void* v, const int* lengths,
                        const int* tables, void* out, float* part, int* counters, int B, int S,
                        int G, int Qh, int Dk, int Dv, int page_size, int n_tiles, int n_split,
                        int split_len, float scale, cudaStream_t stream) {
  const int R = min(kRowTile, S * Qh);
  const size_t smem = plain_smem_bytes<T>(R, Dk, Dv);
  const dim3 grid(B * G, n_split, (S * Qh + kRowTile - 1) / kRowTile);
  const int dpl = (Dv + 31) / 32;
#define REPRO_LAUNCH(DPL_)                                                                     \
  do {                                                                                         \
    auto kern = decode_attention_kernel<T, RMAX, DPL_>;                                        \
    if (smem > 48 * 1024) {                                                                    \
      const cudaError_t e =                                                                    \
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem); \
      if (e != cudaSuccess) return e;                                                          \
    }                                                                                          \
    kern<<<grid, kThreads, smem, stream>>>(                                                    \
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths, \
        tables, static_cast<T*>(out), part, counters, S, G, Qh, Dk, Dv, page_size, n_tiles,    \
        split_len, scale);                                                                     \
  } while (0)
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
                   const int* tables, void* out, float* part, int* counters, int B, int S, int G,
                   int Qh, int Dk, int Dv, int page_size, int n_tiles, int n_split, int split_len,
                   float scale, cudaStream_t stream) {
  const int R = min(kRowTile, S * Qh);
  const long long cap = (long long)n_tiles * page_size;
  if ((S * Qh + kRowTile - 1) / kRowTile > 65535 || Dk % 8 != 0 || Dv % 8 != 0 || Dk <= 0 || Dv <= 0 || Dk > 128 || Dv > 128 ||
      page_size <= 0 || n_tiles < 0 || n_split <= 0 || split_len <= 0 ||
      (long long)n_split * split_len < cap ||
      (n_split > 1 && (part == nullptr || counters == nullptr)) ||
      (tables != nullptr && (split_len - 1) / page_size + 2 > kMaxSplitPages))
    return cudaErrorInvalidValue;
  if (R <= 1)
    return launch_rows<T, 1>(q, k, v, lengths, tables, out, part, counters, B, S, G, Qh, Dk, Dv,
                             page_size, n_tiles, n_split, split_len, scale, stream);
  if (R <= 4)
    return launch_rows<T, 4>(q, k, v, lengths, tables, out, part, counters, B, S, G, Qh, Dk, Dv,
                             page_size, n_tiles, n_split, split_len, scale, stream);
  return launch_rows<T, kRowTile>(q, k, v, lengths, tables, out, part, counters, B, S, G, Qh,
                                  Dk, Dv, page_size, n_tiles, n_split, split_len, scale, stream);
}
// -- split score, float32, on the CUDA cores --------------------------------------
//
// Grid (b * G + g, tile of 8 query rows); one warp a query row, so each warp
// keeps one online softmax for the whole sequence and no merge is needed.  A
// lane owns a fixed slice of the latent dims (16-byte vectors i * 32 + lane)
// and of the rope dims (i * 32 + lane), and keeps its slice of q, q2 and of
// the R-wide accumulator in registers.  The block stages a chunk of 32 keys'
// latent and rope rows in shared memory for its 8 rows (zeros past the
// frontier), each warp forms the lane's partial dot products for all 32 keys,
// and a butterfly reduce-scatter leaves the full score of key j in lane j.

constexpr int kSplitWarps = 8;               // query rows a block, one a warp
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kChunk = 32;                   // keys staged a step, one a lane

// One butterfly step of the reduce-scatter: lanes with bit OFF set keep the
// upper half of their OFF-wide window, the others the lower half, and each
// adds its partner's copy of the half it keeps.
template <int OFF>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[kChunk], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? v[i] : v[i + OFF];
    const float keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// Returns, in lane j, the sum over the warp's lanes of their v[j].
__device__ __forceinline__ float reduce_scatter(float (&v)[kChunk], int lane) {
  reduce_scatter_step<16>(v, lane);
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
  return v[0];
}

// NV: 16-byte latent vectors a lane owns (R <= 32 * NV * kVec); NV2: rope
// dims a lane owns (D2 <= 32 * NV2).
template <typename T, int NV, int NV2>
__global__ void __launch_bounds__(kSplitThreads)
    decode_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ q2,
                                  const T* __restrict__ k, const T* __restrict__ k2,
                                  const int* __restrict__ lengths,
                                  const int* __restrict__ tables, T* __restrict__ out, int S,
                                  int G, int Qh, int R, int D2, int page_size, int n_tiles,
                                  float scale) {
  constexpr int kVec = Elem<T>::kVec;
  extern __shared__ __align__(16) unsigned char split_smem[];
  long long* row_s = reinterpret_cast<long long*>(split_smem);    // (kChunk,) pool rows
  T* lat_s = reinterpret_cast<T*>(row_s + kChunk);                // (kChunk, R)
  T* rope_s = lat_s + kChunk * R;                                 // (kChunk, D2)

  const int b = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.y * kSplitWarps + warp;  // query row s * Qh + qh
  const bool active = r < S * Qh;
  const int s = active ? r / Qh : 0;
  const int qh = active ? r % Qh : 0;
  const int r_vecs = R / kVec;                    // latent vectors a key
  const int d2_vecs = D2 / kVec;                  // rope vectors a key

  // this lane's slices of the query row, in float32
  const long long qrow = (((long long)b * S + s) * G + g) * Qh + qh;
  float qv[NV][kVec], q2v[NV2];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = i * 32 + lane;
    if (active && vi < r_vecs) {
      Elem<T>::load_vec(q + qrow * R + vi * kVec, qv[i]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) qv[i][j] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < NV2; ++i) {
    const int d = i * 32 + lane;
    q2v[i] = (active && d < D2) ? Elem<T>::to_float(q2[qrow * D2 + d]) : 0.f;
  }

  const int base = lengths[b];                 // keys visible to window position 0
  long long frontier = (long long)base + S - 1;
  const long long cap = (long long)n_tiles * page_size;
  if (frontier > cap) frontier = cap;
  const int n_keys = frontier > 0 ? static_cast<int>(frontier) : 0;
  const int row_keys = base + s;               // keys this query row sees
  const int* tbl = tables == nullptr ? nullptr : tables + (long long)b * n_tiles;

  float m = kNeg, l = 0.f, acc[NV][kVec];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < n_keys; c0 += kChunk) {
    // pool rows of the chunk's keys; -1 past the frontier
    if (threadIdx.x < kChunk) {
      const int t = c0 + threadIdx.x;
      long long row = -1;
      if (t < n_keys) {
        int page;
        if (tbl != nullptr) {
          page = tbl[t / page_size];
          page = page > 0 ? page : 0;
        } else {
          page = b;
        }
        row = ((long long)page * page_size + t % page_size) * G + g;
      }
      row_s[threadIdx.x] = row;
    }
    __syncthreads();
    // stage the chunk's latent and rope rows, zeros past the frontier
    for (int e = threadIdx.x; e < kChunk * (r_vecs + d2_vecs); e += kSplitThreads) {
      const bool lat = e < kChunk * r_vecs;
      const int e2 = lat ? e : e - kChunk * r_vecs;
      const int per = lat ? r_vecs : d2_vecs;
      const int j = e2 / per, c = e2 % per;
      const long long row = row_s[j];
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row >= 0) {
        const T* src = lat ? k + row * R : k2 + row * D2;
        val = *reinterpret_cast<const uint4*>(src + c * kVec);
      }
      T* dst = lat ? lat_s + j * R : rope_s + j * D2;
      *reinterpret_cast<uint4*>(dst + c * kVec) = val;
    }
    __syncthreads();
    if (active) {
      // the lane's partial scores of all the chunk's keys, then the full
      // score of key c0 + lane
      float part[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int vi = i * 32 + lane;
          if (vi < r_vecs) {
            float kf[kVec];
            Elem<T>::load_vec(lat_s + j * R + vi * kVec, kf);
#pragma unroll
            for (int x = 0; x < kVec; ++x) sum += qv[i][x] * kf[x];
          }
        }
#pragma unroll
        for (int i = 0; i < NV2; ++i) {
          const int d = i * 32 + lane;
          if (d < D2) sum += q2v[i] * Elem<T>::to_float(rope_s[j * D2 + d]);
        }
        part[j] = sum;
      }
      const float score = reduce_scatter(part, lane);
      const int t = c0 + lane;
      const bool valid = t < n_keys && t < row_keys;
      const float s_val = valid ? score * scale : kNeg;
      const float m_new = fmaxf(m, warp_max(s_val));
      // explicit re-mask, as in the plain kernel: dead keys add nothing to l
      const float p = valid ? expf(s_val - m_new) : 0.f;
      const float corr = expf(m - m_new);
      l = l * corr + warp_sum(p);
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int x = 0; x < kVec; ++x) acc[i][x] *= corr;
      m = m_new;
      // acc += p @ latent over the chunk's keys
      const int n_in = min(kChunk, n_keys - c0);
      for (int j = 0; j < n_in; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int vi = i * 32 + lane;
          if (vi < r_vecs) {
            float vf[kVec];
            Elem<T>::load_vec(lat_s + j * R + vi * kVec, vf);
#pragma unroll
            for (int x = 0; x < kVec; ++x) acc[i][x] += pj * vf[x];
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }

  if (!active) return;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = i * 32 + lane;
    if (vi < r_vecs) {
#pragma unroll
      for (int x = 0; x < kVec; ++x)
        out[qrow * R + vi * kVec + x] = Elem<T>::from_float(acc[i][x] / den);
    }
  }
}

template <typename T, int NV, int NV2>
cudaError_t launch_split_nv(const void* q, const void* q2, const void* k, const void* k2,
                            const int* lengths, const int* tables, void* out, int B, int S,
                            int G, int Qh, int R, int D2, int page_size, int n_tiles,
                            float scale, cudaStream_t stream) {
  const size_t smem = kChunk * sizeof(long long) + (size_t)kChunk * (R + D2) * sizeof(T);
  auto kern = decode_attention_split_kernel<T, NV, NV2>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B * G, (S * Qh + kSplitWarps - 1) / kSplitWarps);
  kern<<<grid, kSplitThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(q2), static_cast<const T*>(k),
      static_cast<const T*>(k2), lengths, tables, static_cast<T*>(out), S, G, Qh, R, D2,
      page_size, n_tiles, scale);
  return cudaGetLastError();
}

template <typename T, int NV>
cudaError_t launch_split_nv2(const void* q, const void* q2, const void* k, const void* k2,
                             const int* lengths, const int* tables, void* out, int B, int S,
                             int G, int Qh, int R, int D2, int page_size, int n_tiles,
                             float scale, cudaStream_t stream) {
  if (D2 <= 32)
    return launch_split_nv<T, NV, 1>(q, q2, k, k2, lengths, tables, out, B, S, G, Qh, R, D2,
                                     page_size, n_tiles, scale, stream);
  if (D2 <= 64)
    return launch_split_nv<T, NV, 2>(q, q2, k, k2, lengths, tables, out, B, S, G, Qh, R, D2,
                                     page_size, n_tiles, scale, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_split(const void* q, const void* q2, const void* k, const void* k2,
                         const int* lengths, const int* tables, void* out, int B, int S, int G,
                         int Qh, int R, int D2, int page_size, int n_tiles, float scale,
                         cudaStream_t stream) {
  if (R % 8 != 0 || D2 % 8 != 0 || R <= 0 || D2 <= 0) return cudaErrorInvalidValue;
  const int nv = (R / Elem<T>::kVec + 31) / 32;  // latent vectors a lane
  if (nv <= 1)
    return launch_split_nv2<T, 1>(q, q2, k, k2, lengths, tables, out, B, S, G, Qh, R, D2,
                                  page_size, n_tiles, scale, stream);
  if (nv <= 2)
    return launch_split_nv2<T, 2>(q, q2, k, k2, lengths, tables, out, B, S, G, Qh, R, D2,
                                  page_size, n_tiles, scale, stream);
  if (nv <= 4)
    return launch_split_nv2<T, 4>(q, q2, k, k2, lengths, tables, out, B, S, G, Qh, R, D2,
                                  page_size, n_tiles, scale, stream);
  return cudaErrorInvalidValue;
}


// -- split score, bfloat16, on the tensor cores ------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaTiles = 2;                  // m16 tiles of query rows a block
constexpr int kTileWarps = 8;                 // warps on one m16 tile
constexpr int kMmaWarps = kMmaTiles * kTileWarps;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaRows = 16 * kMmaTiles;      // query rows a block
constexpr int kStages = 4;                    // key tiles in the cp.async ring
constexpr int kMmaKeys = 32;                  // keys a stage holds
constexpr int kMmaSplitPages = kMmaThreads;   // table entries one split may span
constexpr int kMmaMaxSplit = 64;              // key splits a call may take
constexpr int kScoreStride = kMmaKeys + 4;    // floats a row of the score exchange
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMergeBatch = 8;                // splits' loads in flight in the second pass
constexpr int kCombineThreads = 128;          // threads a block of the second pass
constexpr int kMaxQuarter = 9;                // k-steps of a quarter of R + D2 <= 576
constexpr int kProbRow = kMmaKeys * 2 + 16;   // bytes a row of the staged probabilities

// Byte offsets of one block's dynamic shared memory.
struct MmaSmem {
  int rp, d2p;              // latent and rope depth, padded to 16
  int lat_row, rope_row;    // bytes of a staged row, padded by 16
  int lat, rope;            // (kStages, kMmaKeys) staged key rows
  int score;                // (kMmaTiles, 4 depth quarters, 16, kScoreStride) float32
  int prob;                 // (kMmaRows, kProbRow bytes) bf16 probabilities
  int corr;                 // (kMmaRows,) float32 rescale of a tile
  int ml;                   // (kMmaRows,) float2 (m, l) after the key loop
  int rows;                 // (kStages, kMmaKeys) pool rows
  int pages;                // (kMmaSplitPages,) table entries
  int total;
};

__host__ __device__ inline MmaSmem mma_smem_layout(int R, int D2) {
  MmaSmem L;
  L.rp = (R + 15) / 16 * 16;
  L.d2p = (D2 + 15) / 16 * 16;
  L.lat_row = L.rp * 2 + 16;
  L.rope_row = L.d2p * 2 + 16;
  int o = 0;
  L.lat = o;    o += kStages * kMmaKeys * L.lat_row;
  L.rope = o;   o += kStages * kMmaKeys * L.rope_row;
  L.score = o;  o += 4 * kMmaRows * kScoreStride * 4;
  L.prob = o;   o += kMmaRows * kProbRow;
  L.corr = o;   o += kMmaRows * 4;
  L.ml = o;     o += kMmaRows * 8;
  L.rows = o;   o += kStages * kMmaKeys * 8;
  L.pages = o;  o += kMmaSplitPages * 4;
  L.total = o;
  return L;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 accumulators.
__device__ __forceinline__ void mma_16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NT: 8-column accumulator tiles of the latent a warp owns (R <= 64 * NT).
template <int NT>
__global__ void __launch_bounds__(kMmaThreads, 1)
    decode_attention_split_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ q2,
                                      const bf16* __restrict__ k, const bf16* __restrict__ k2,
                                      const int* __restrict__ lengths,
                                      const int* __restrict__ tables, bf16* __restrict__ out,
                                      float* __restrict__ part, int S, int G, int Qh, int R,
                                      int D2, int page_size, int n_tiles, int split_len,
                                      float scale_log2) {
  extern __shared__ __align__(128) unsigned char mma_smem[];
  const float kNegInf = __int_as_float(0xff800000);
  const MmaSmem L = mma_smem_layout(R, D2);
  unsigned char* lat_st = mma_smem + L.lat;
  unsigned char* rope_st = mma_smem + L.rope;
  float* score_s = reinterpret_cast<float*>(mma_smem + L.score);
  unsigned char* prob_s = mma_smem + L.prob;
  float* corr_s = reinterpret_cast<float*>(mma_smem + L.corr);
  float2* ml_s = reinterpret_cast<float2*>(mma_smem + L.ml);
  long long* row_s = reinterpret_cast<long long*>(mma_smem + L.rows);
  int* page_s = reinterpret_cast<int*>(mma_smem + L.pages);

  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int bg = blockIdx.z;
  const int b = bg / G;
  const int g = bg % G;
  const int n_rows = S * Qh;                   // query rows of the window
  const int r0 = tile * kMmaRows;              // the tile's first
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long cap = (long long)n_tiles * page_size;
  const int lo = split * split_len;            // the split's first key
  const int* tbl = tables == nullptr ? nullptr : tables + (long long)b * n_tiles;
  const int p0 = lo / page_size;

  int entry = 0;
  if (tbl != nullptr) {
    const int pi = p0 + tid;   // page pi holds keys [pi * ps, (pi + 1) * ps)
    if (pi < n_tiles && (long long)pi * page_size < (long long)lo + split_len) entry = tbl[pi];
  }
  const int base = lengths[b];                 // keys visible to window position 0
  long long frontier = (long long)base + S - 1;
  if (frontier > cap) frontier = cap;
  if (frontier < 0) frontier = 0;
  // splits that hold a visible key; split 0 also answers a row that sees none
  const int n_live = static_cast<int>((frontier + split_len - 1) / split_len);
  if (split > 0 && split >= n_live) return;
  const int hi = static_cast<int>(min((long long)lo + split_len, frontier));  // keys [lo, hi)
  const int n_steps = hi > lo ? (hi - lo + kMmaKeys - 1) / kMmaKeys : 0;

  // The warp's m16 tile mt of the block's rows, and its place lw among the
  // tile's warps; the lane's place in the mma fragments: rows gr and gr + 8
  // of the m16 tile, columns 2 * qd, 2 * qd + 1 of each 8-wide tile.
  const int mt = warp / kTileWarps, lw = warp % kTileWarps;
  const int gr = lane >> 2, qd = lane & 3;
  const int ra = r0 + 16 * mt + gr, rb = ra + 8;
  const bool mt_live = r0 + 16 * mt < n_rows;  // a tile past the window skips its products
  // Scores: warp lw takes keys [16 (lw & 1), 16 (lw & 1) + 16) of a key tile
  // (two 8-key accumulators) over the quarter lw >> 1 of the k-steps (16
  // deep each).
  const int n_lat = L.rp / 16, n_k = n_lat + L.d2p / 16;
  const int k_q = (n_k + 3) / 4;               // k-steps a quarter, at most kMaxQuarter
  const int quarter = lw >> 1;
  const int k_beg = quarter * k_q, k_end = mt_live ? min(n_k, k_beg + k_q) : k_beg;
  const int key_w = (lw & 1) * 16;

  // The warp's A fragments of its quarter, straight from q / q2 into
  // registers, once: zeros past the window and in the depth padding.
  unsigned qa[kMaxQuarter][4];
  {
    const bf16* qrow_a = nullptr;
    const bf16* qrow_b = nullptr;
    const bf16* q2row_a = nullptr;
    const bf16* q2row_b = nullptr;
    if (ra < n_rows) {
      const long long r = (((long long)b * S + ra / Qh) * G + g) * Qh + ra % Qh;
      qrow_a = q + r * R;
      q2row_a = q2 + r * D2;
    }
    if (rb < n_rows) {
      const long long r = (((long long)b * S + rb / Qh) * G + g) * Qh + rb % Qh;
      qrow_b = q + r * R;
      q2row_b = q2 + r * D2;
    }
    auto pair = [](const bf16* row, int col, int width) -> unsigned {
      return row != nullptr && col < width ? *reinterpret_cast<const unsigned*>(row + col) : 0u;
    };
#pragma unroll
    for (int j = 0; j < kMaxQuarter; ++j) {
      const int kk = k_beg + j;
      const bool lat = kk < n_lat;
      const int c = (lat ? kk : kk - n_lat) * 16 + 2 * qd;
      const int w = kk < k_end ? (lat ? R : D2) : 0;
      qa[j][0] = pair(lat ? qrow_a : q2row_a, c, w);
      qa[j][1] = pair(lat ? qrow_b : q2row_b, c, w);
      qa[j][2] = pair(lat ? qrow_a : q2row_a, c + 8, w);
      qa[j][3] = pair(lat ? qrow_b : q2row_b, c + 8, w);
    }
  }

  page_s[tid] = entry > 0 ? entry : 0;
  // zero the depth padding of the key stages once: cp.async never writes it
  if (L.rp > R && tid < kStages * kMmaKeys)
    *reinterpret_cast<uint4*>(lat_st + tid * L.lat_row + R * 2) = make_uint4(0u, 0u, 0u, 0u);
  if (L.d2p > D2 && tid < kStages * kMmaKeys)
    *reinterpret_cast<uint4*>(rope_st + tid * L.rope_row + D2 * 2) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // Pool rows of tile i's keys ((page * page_size + offset) * G + g), -1 past
  // the frontier; one thread a key.
  auto rows = [&](int i) {
    if (tid < kMmaKeys) {
      const int t = lo + i * kMmaKeys + tid;
      long long row = -1;
      if (t < hi) {
        row = tbl != nullptr
                  ? ((long long)page_s[t / page_size - p0] * page_size + t % page_size) * G + g
                  : ((long long)b * page_size + t) * G + g;
      }
      row_s[(i % kStages) * kMmaKeys + tid] = row;
    }
  };
  // Each thread copies the same 16-byte chunk of every few keys' rows.
  const int lc = R / 8, rc = D2 / 8;           // 16-byte chunks of a key's rows
  const int l_keys = kMmaThreads / lc, r_keys = kMmaThreads / rc;
  const int lx = tid % lc, lj = tid / lc;
  const int rx = tid % rc, rj = tid / rc;
  auto issue = [&](int i) {
    const long long* rs = row_s + (i % kStages) * kMmaKeys;
    unsigned char* ls = lat_st + (i % kStages) * kMmaKeys * L.lat_row;
    unsigned char* ps = rope_st + (i % kStages) * kMmaKeys * L.rope_row;
    if (lj < l_keys) {
      for (int j = lj; j < kMmaKeys; j += l_keys) {
        const long long row = rs[j];
        cp_async16(ls + j * L.lat_row + lx * 16, k + (row < 0 ? 0 : row) * R + lx * 8, row >= 0);
      }
    }
    if (rj < r_keys) {
      for (int j = rj; j < kMmaKeys; j += r_keys) {
        const long long row = rs[j];
        cp_async16(ps + j * L.rope_row + rx * 16, k2 + (row < 0 ? 0 : row) * D2 + rx * 8,
                   row >= 0);
      }
    }
  };

  // ldmatrix row addresses of this lane, relative to a stage: B of the
  // scores (two 8-key tiles) key key_w + (lane & 7) + 8 (lane >> 4), column
  // half (lane >> 3) & 1; B of P @ V (.trans) key (lane & 7) + 8 ((lane >>
  // 3) & 1), column half lane >> 4; A of P @ V row lane & 15, column half
  // lane >> 4.
  const int kb_key = key_w + (lane & 7) + ((lane >> 4) << 3);
  const int kb_col = ((lane >> 3) & 1) * 16;
  const unsigned kb_lat = kb_key * L.lat_row + kb_col;
  const unsigned kb_rope = kb_key * L.rope_row + kb_col;
  const int vb_key = (lane & 7) + ((lane >> 3) & 1) * 8, vb_col = (lane >> 4) * 16;
  const unsigned pa_addr =
      smem_u32(prob_s + (16 * mt + (lane & 15)) * kProbRow + (lane >> 4) * 16);
  const int col_w = lw * NT * 8;               // the warp's first latent column
  // The softmax: warp w owns row 2 w + (lane >> 4) of the block, keys
  // 2 (lane & 15) + {0, 1} of each key tile; its 16 lanes keep the row's m
  // and l.
  const int o_row = 2 * warp + (lane >> 4);
  const int o_key = 2 * (lane & 15);
  const int o_lim = base + (r0 + o_row < n_rows ? (r0 + o_row) / Qh : 0);  // keys t < o_lim
  float m_o = kNeg, l_o = 0.f;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[n][x] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages; ++i) rows(i);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {   // kStages - 1 tiles in flight
    if (i < n_steps) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile i landed
    __syncthreads();             // everyone's; and everyone is done with tile i - 1
    if (i + kStages - 1 < n_steps) issue(i + kStages - 1);   // into tile i - 1's stage
    cp_async_commit();
    if (i + kStages < n_steps) rows(i + kStages);            // tile i's rows are spent
    const unsigned lat_b = smem_u32(lat_st + (i % kStages) * kMmaKeys * L.lat_row);
    const unsigned rope_b = smem_u32(rope_st + (i % kStages) * kMmaKeys * L.rope_row);

    // partial scores of the warp's 16 keys over its quarter of the depth
    float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kMaxQuarter; ++j) {
      const int kk = k_beg + j;
      if (kk < k_end) {
        unsigned bb[4];
        ldsm_x4(kk < n_lat ? lat_b + kb_lat + kk * 32 : rope_b + kb_rope + (kk - n_lat) * 32,
                bb);
        mma_16816(c0, qa[j], bb[0], bb[1]);
        mma_16816(c1, qa[j], bb[2], bb[3]);
      }
    }
    {
      float* sp = score_s + (mt * 4 + quarter) * 16 * kScoreStride + key_w + 2 * qd;
      *reinterpret_cast<float2*>(sp + gr * kScoreStride) = make_float2(c0[0], c0[1]);
      *reinterpret_cast<float2*>(sp + (gr + 8) * kScoreStride) = make_float2(c0[2], c0[3]);
      *reinterpret_cast<float2*>(sp + 8 + gr * kScoreStride) = make_float2(c1[0], c1[1]);
      *reinterpret_cast<float2*>(sp + 8 + (gr + 8) * kScoreStride) = make_float2(c1[2], c1[3]);
    }
    __syncthreads();

    // one online-softmax step of the warp's two rows: the quarters summed in
    // order, masked (-inf: exp2 of it is exactly 0 against a finite max)
    {
      const int t = lo + i * kMmaKeys + o_key;
      float sx = 0.f, sy = 0.f;
#pragma unroll
      for (int qt = 0; qt < 4; ++qt) {
        const float2 v = *reinterpret_cast<const float2*>(
            score_s + (((o_row >> 4) * 4 + qt) * 16 + (o_row & 15)) * kScoreStride + o_key);
        sx += v.x;
        sy += v.y;
      }
      const float x0 = (t < hi && t < o_lim) ? sx * scale_log2 : kNegInf;
      const float x1 = (t + 1 < hi && t + 1 < o_lim) ? sy * scale_log2 : kNegInf;
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m_o, mx);         // finite: m starts at kNeg
      const float corr = exp2f(m_o - mn);
      m_o = mn;
      const float p0 = exp2f(x0 - mn), p1 = exp2f(x1 - mn);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_o = l_o * corr + sum;
      *reinterpret_cast<__nv_bfloat162*>(prob_s + o_row * kProbRow + o_key * 2) =
          __floats2bfloat162_rn(p0, p1);
      if ((lane & 15) == 0) corr_s[o_row] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P @ latent over the warp's columns, two 8-column
    // tiles a load; P read back as the bf16 A operand of two 16-key k-steps
    const float corr_a = corr_s[16 * mt + gr], corr_b = corr_s[16 * mt + gr + 8];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr_a;
      acc[n][1] *= corr_a;
      acc[n][2] *= corr_b;
      acc[n][3] *= corr_b;
    }
    unsigned pa[2][4];
    ldsm_x4(pa_addr, pa[0]);
    ldsm_x4(pa_addr + 32, pa[1]);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      const int c = col_w + n * 8;
      if (mt_live && c < R) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          unsigned bv[4];
          ldsm_x4_trans(lat_b + (t * 16 + vb_key) * L.lat_row + c * 2 + vb_col, bv);
          mma_16816(acc[n], pa[t], bv[0], bv[1]);
          mma_16816(acc[n + 1], pa[t], bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if ((lane & 15) == 0) ml_s[o_row] = make_float2(m_o, l_o);
  __syncthreads();
  const float2 ml_a = ml_s[16 * mt + gr], ml_b = ml_s[16 * mt + gr + 8];

  auto out_row = [&](int r) {   // r < n_rows
    const int s = r / Qh, qh = r % Qh;
    return out + ((((long long)b * S + s) * G + g) * Qh + qh) * R;
  };
  if (n_live <= 1) {            // the row's keys lie in this split: the output
    const float inv_a = 1.f / fmaxf(ml_a.y, 1e-30f), inv_b = 1.f / fmaxf(ml_b.y, 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = col_w + n * 8 + 2 * qd;
      if (c < R) {
        if (ra < n_rows)
          *reinterpret_cast<__nv_bfloat162*>(out_row(ra) + c) =
              __floats2bfloat162_rn(acc[n][0] * inv_a, acc[n][1] * inv_a);
        if (rb < n_rows)
          *reinterpret_cast<__nv_bfloat162*>(out_row(rb) + c) =
              __floats2bfloat162_rn(acc[n][2] * inv_b, acc[n][3] * inv_b);
      }
    }
    return;
  }
  // else the partial state, for the second pass
  const int stride = R + 4;     // a partial row: acc[0, R), m, l, 2 floats of padding
  float* mine = part + (((long long)split * gridDim.z + bg) * n_rows) * stride;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = col_w + n * 8 + 2 * qd;
    if (c < R) {
      if (ra < n_rows)
        *reinterpret_cast<float2*>(mine + ra * stride + c) = make_float2(acc[n][0], acc[n][1]);
      if (rb < n_rows)
        *reinterpret_cast<float2*>(mine + rb * stride + c) = make_float2(acc[n][2], acc[n][3]);
    }
  }
  if (lw == 0 && qd == 0) {
    if (ra < n_rows) *reinterpret_cast<float2*>(mine + ra * stride + R) = ml_a;
    if (rb < n_rows) *reinterpret_cast<float2*>(mine + rb * stride + R) = ml_b;
  }
}

// The second pass when the keys are split: merges the splits' partial states
// of query row blockIdx.x of (b, g) = blockIdx.y, in split order, each
// rescaled by exp2(m_j - m) / l; four columns a thread.  Rows whose frontier
// lies in their first split were written by the first pass and are skipped.
__global__ void __launch_bounds__(kCombineThreads)
    decode_attention_split_combine_kernel(const float* __restrict__ part,
                                          const int* __restrict__ lengths,
                                          bf16* __restrict__ out, int S, int G, int Qh, int R,
                                          int page_size, int n_tiles, int split_len) {
  __shared__ float2 ml_s[kMmaMaxSplit];
  const int r = blockIdx.x;
  const int bg = blockIdx.y;
  const int b = bg / G, g = bg % G;
  const int n_rows = S * Qh;
  const long long cap = (long long)n_tiles * page_size;
  long long frontier = (long long)lengths[b] + S - 1;
  if (frontier > cap) frontier = cap;
  if (frontier < 0) frontier = 0;
  const int n_live = static_cast<int>((frontier + split_len - 1) / split_len);
  if (n_live <= 1) return;
  const int stride = R + 4;     // a partial row: acc[0, R), m, l, 2 floats of padding
  const long long split_stride = (long long)gridDim.y * n_rows * stride;
  const float* pr = part + ((long long)bg * n_rows + r) * stride;
  const int tid = threadIdx.x;
  if (tid < n_live) ml_s[tid] = *reinterpret_cast<const float2*>(pr + tid * split_stride + R);
  __syncthreads();
  float mx = kNeg;
  for (int j = 0; j < n_live; ++j) mx = fmaxf(mx, ml_s[j].x);
  float den = 0.f;
  for (int j = 0; j < n_live; ++j) den += ml_s[j].y * exp2f(ml_s[j].x - mx);
  const float inv = 1.f / fmaxf(den, 1e-30f);
  const int s = r / Qh, qh = r % Qh;
  bf16* o = out + ((((long long)b * S + s) * G + g) * Qh + qh) * R;
  for (int c = 4 * tid; c < R; c += 4 * kCombineThreads) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < n_live; j0 += kMergeBatch) {
      float4 v[kMergeBatch];   // every split's load in flight before any is used
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u)
        v[u] = j0 + u < n_live
                   ? *reinterpret_cast<const float4*>(pr + (j0 + u) * split_stride + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        if (j0 + u < n_live) {
          const float w = exp2f(ml_s[j0 + u].x - mx) * inv;
          sum.x += v[u].x * w;
          sum.y += v[u].y * w;
          sum.z += v[u].z * w;
          sum.w += v[u].w * w;
        }
      }
    }
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(o + c);
    o2[0] = __floats2bfloat162_rn(sum.x, sum.y);
    o2[1] = __floats2bfloat162_rn(sum.z, sum.w);
  }
}

template <int NT>
cudaError_t launch_split_mma_nt(const void* q, const void* q2, const void* k, const void* k2,
                                const int* lengths, const int* tables, void* out, float* part,
                                int B, int S, int G, int Qh, int R, int D2, int page_size,
                                int n_tiles, int n_split, int split_len, float scale,
                                cudaStream_t stream) {
  const int smem = mma_smem_layout(R, D2).total;
  auto kern = decode_attention_split_mma_kernel<NT>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S * Qh + kMmaRows - 1) / kMmaRows, n_split, B * G);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(q2), static_cast<const bf16*>(k),
      static_cast<const bf16*>(k2), lengths, tables, static_cast<bf16*>(out), part, S, G, Qh, R,
      D2, page_size, n_tiles, split_len, scale * kLog2e);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return e;
  decode_attention_split_combine_kernel<<<dim3(S * Qh, B * G), kCombineThreads, 0, stream>>>(
      part, lengths, static_cast<bf16*>(out), S, G, Qh, R, page_size, n_tiles, split_len);
  return cudaGetLastError();
}

cudaError_t launch_split_mma(const void* q, const void* q2, const void* k, const void* k2,
                             const int* lengths, const int* tables, void* out, float* part, int B,
                             int S, int G, int Qh, int R, int D2, int page_size, int n_tiles,
                             int n_split, int split_len, float scale, cudaStream_t stream) {
  const long long cap = (long long)n_tiles * page_size;
  if (R % 8 != 0 || D2 % 8 != 0 || R <= 0 || D2 <= 0 || R > 512 || D2 > 64 ||
      page_size <= 0 || n_tiles < 0 || n_split <= 0 || n_split > kMmaMaxSplit ||
      split_len <= 0 || (long long)n_split * split_len < cap ||
      (n_split > 1 && part == nullptr) ||
      (tables != nullptr && (split_len - 1) / page_size + 2 > kMmaSplitPages) ||
      (S * Qh + kMmaRows - 1) / kMmaRows > 65535 || B * G > 65535)
    return cudaErrorInvalidValue;
  const int tiles8 = (R + 7) / 8;                     // 8-column tiles of the latent
  const int per_warp = (tiles8 + kTileWarps - 1) / kTileWarps;
  if (per_warp <= 2)
    return launch_split_mma_nt<2>(q, q2, k, k2, lengths, tables, out, part, B, S, G, Qh, R, D2,
                                  page_size, n_tiles, n_split, split_len, scale, stream);
  if (per_warp <= 4)
    return launch_split_mma_nt<4>(q, q2, k, k2, lengths, tables, out, part, B, S, G, Qh, R, D2,
                                  page_size, n_tiles, n_split, split_len, scale, stream);
  return launch_split_mma_nt<8>(q, q2, k, k2, lengths, tables, out, part, B, S, G, Qh, R, D2,
                                page_size, n_tiles, n_split, split_len, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// q (B, S, G, Qh, Dk) and out (B, S, G, Qh, Dv) contiguous; lengths (B,) int32.
// Paged: k (n_pages, page_size, G, Dk), v likewise with Dv, tables (B, n_tiles)
// int32.  Contiguous: tables == NULL, k (B, T, G, Dk) with page_size = T and
// n_tiles = 1.  Keys split n_split ways, split_len each (n_split * split_len
// >= n_tiles * page_size; paged, one split spans at most 128 table entries).
// With n_split > 1, part is float32 scratch of n_split * B * G * S * Qh *
// (Dv + 2) and counters B * G * ceil(S * Qh / 16) int32 zeros, left zero
// again; with n_split == 1
// both may be NULL.  Returns the launch's cudaGetLastError() code.
extern "C" int repro_decode_attention(int dtype, const void* q, const void* k, const void* v,
                                      const void* lengths, const void* tables, void* out,
                                      void* part, void* counters, int B, int S, int G, int Qh,
                                      int Dk, int Dv, int page_size, int n_tiles, int n_split,
                                      int split_len, float scale, void* stream) {
  if (B <= 0 || G <= 0 || S <= 0 || Qh <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const int* tbl = static_cast<const int*>(tables);
  float* prt = static_cast<float*>(part);
  int* cnt = static_cast<int*>(counters);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k, v, len, tbl, out, prt, cnt, B, S, G, Qh, Dk, Dv, page_size, n_tiles,
                        n_split, split_len, scale, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, len, tbl, out, prt, cnt, B, S, G, Qh, Dk, Dv, page_size,
                                n_tiles, n_split, split_len, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory, in bytes, of one block of repro_decode_attention at
// these shapes (dtype as above; R = S * Qh query rows, of which a block holds
// a tile of at most 16).
extern "C" long long repro_decode_attention_smem(int dtype, int R, int Dk, int Dv) {
  R = R < kRowTile ? R : kRowTile;
  return static_cast<long long>(dtype == 0 ? plain_smem_bytes<float>(R, Dk, Dv)
                                           : plain_smem_bytes<__nv_bfloat16>(R, Dk, Dv));
}

// Split score of absorbed MLA; dtype as above, shared by q, q2, k, k2 and out:
// float32 runs on the CUDA cores, bfloat16 on the tensor cores.  q (B, S, G,
// Qh, R), q2 (B, S, G, Qh, D2) and out (B, S, G, Qh, R) contiguous; lengths
// (B,) int32.  Paged: k (n_pages, page_size, G, R) -- the latent, read as both
// key and value -- and k2 (n_pages, page_size, G, D2), tables (B, n_tiles)
// int32.  Contiguous: tables == NULL, k (B, T, G, R), k2 (B, T, G, D2) with
// page_size = T and n_tiles = 1.  R and D2 are multiples of 8, R <= 512, D2 <=
// 64.  bfloat16 splits the keys n_split ways (at most 64), split_len each
// (n_split * split_len >= n_tiles * page_size; paged, one split spans at most
// 512 table entries); with n_split > 1, part is float32 scratch of n_split * B
// * G * S * Qh * (R + 4), and a second kernel merges the splits.  float32
// takes no split: part, n_split and split_len are not read.  Returns the
// launches' cudaGetLastError() code.
extern "C" int repro_decode_attention_split(int dtype, const void* q, const void* q2,
                                            const void* k, const void* k2, const void* lengths,
                                            const void* tables, void* out, void* part, int B,
                                            int S, int G, int Qh, int R, int D2, int page_size,
                                            int n_tiles, int n_split, int split_len,
                                            float scale, void* stream) {
  if (B <= 0 || G <= 0 || S <= 0 || Qh <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const int* tbl = static_cast<const int*>(tables);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_split<float>(q, q2, k, k2, len, tbl, out, B, S, G, Qh, R, D2, page_size,
                              n_tiles, scale, st);
  } else if (dtype == 1) {
    err = launch_split_mma(q, q2, k, k2, len, tbl, out, static_cast<float*>(part), B, S, G, Qh,
                           R, D2, page_size, n_tiles, n_split, split_len, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory, in bytes, of one block of the bfloat16 split-score
// kernel at these widths.
extern "C" long long repro_decode_attention_split_smem(int R, int D2) {
  return mma_smem_layout(R, D2).total;
}
