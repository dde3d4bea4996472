// Mamba2 SSD scan, single group (Hopper, sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py
//   ssd_scan_pallas -> _kernel (the TPU kernel).
//
// Computes, for batch row b and head h, with a (D, N) state:
//   h_t = exp(ld[b,t,h]) * h_{t-1} + (dt[b,t,h] * x[b,t,h,:]) (x) B[b,t,:]
//   y[b,t,h,d] = sum_n h_t[d,n] * C[b,t,n]
// from h_{-1} = h0[b,h], and writes the last state to hT[b,h].  All float32.
// B and C are shared by the heads (one group).  S = 1 takes the decode path,
// S > 1 the chunked path; the host's plan (ssd_plan in kernels/ssd_scan/ref.py,
// from shapes alone) gives the slices of a head's D rows, and the entry
// chooses the chunk length from what a block's shared memory holds.
//
// Decode path (S = 1).  What bounds it: bytes.  At zamba2-1.2b's decode step
// (B=4, H=64, D=N=64) 4.2 MB of h0 come in and 4.2 MB of hT go out, about
// 2.5 us at the card's memory rate; the arithmetic is 4 D N flops a head.
// Design: a thread owns 4 consecutive columns of one (row, head, d) state row,
// one float4 of h0 read once and one of hT stored once, so a warp moves 512
// contiguous bytes an instruction.  The row's ceil(N / 4) lanes (a power of
// two) sum y[d] by a butterfly of shuffles in a fixed order.  Every load is
// issued before the arithmetic; no shared memory, no barrier.  Where N % 4 != 0
// or an operand is not 16-byte aligned a masked scalar path moves the columns.
//
// Chunked path (S > 1).  The TPU kernel's chunked form: per chunk of L steps,
// with cum_i the in-chunk cumulative log decay,
//   G   = C B^T                                          (L x L, depth N)
//   Y   = diag(exp(cum)) C h_prev^T + (G o M) (x dt)      M_ij = exp(cum_i - cum_j), j <= i
//   h   = exp(cum_L) h_prev + ((x dt) o exp(cum_L - cum))^T B
// What bounds it: in float32 on the CUDA cores, operations: the products are
// about 7 L D N flops a (head, chunk) against a few bytes a step, past the
// card's float32 ridge.  As three TF32 passes on the tensor cores they fall
// under the bytes at zamba2's width (about 2.4 against 3.7 us at a 300-step
// prompt), so the bound the card could reach is the bytes.  Done step by
// step, as this kernel's first version did, a step costs a dependent chain
// of an exp, the state update and a shuffle reduction (about 1 us a step at
// B=1).  On the tensor cores the
// products of one (head, slice, chunk) are small (64 rows by 32 columns at
// zamba2's width), so what holds the block is the latency of the chains that
// feed them: shared-memory loads, operand splits, mma.sync's own latency and
// the barriers between phases.  Design:
// - One block of 16 warps a (row, head, slice of the D rows); the slices
//   (d_split of them) fill the SMs at B=1.  The block walks the chunks in
//   order and keeps its (D/d_split x N) state in shared memory across them
//   (two buffers: the chunk reads one and writes the other), so chunks and
//   heads are read once from device memory.
// - The chunk's tiles (x over the slice, B, C, ld, dt) are staged by cp.async
//   into a ring of two stages: chunk c+1 loads while chunk c is computed.
//   Steps past S are zero-filled (ld = dt = 0 leave the state as it was), so
//   the last, ragged chunk needs no other case; so are columns past D or N.
//   A warp stages a row, its lanes along the row: no index division.
// - Each warp forms cum by a shuffle scan (its own copy, so no barrier), so
//   every exponent taken is <= 0: exp(cum_i - cum_j) for j <= i, exp(cum_i)
//   and exp(cum_L - cum_j).  expf, as the plain version's torch.exp.
// - The four products run on the tensor cores, mma.sync m16n8k8 in TF32.
//   TF32 keeps 10 mantissa bits, too few for the 1e-4 the kernel is held to,
//   so each operand is split a = hi + lo as it is loaded, both TF32 (rounded
//   to nearest, ties away: cvt.rna.tf32.f32's bits, by an integer add and
//   mask), and a product is hi*hi + hi*lo + lo*hi ("3xTF32"), summed in
//   float32: hi*hi in one accumulator, the two cross terms in another.  The
//   operands stay float32 in shared memory: split copies there would double
//   the bytes the fragments load, and the loads are the scarcer resource.
//   Row strides are padded so that a fragment's loads fall in distinct banks.
// - A warp's unit of work is a 16-row strip by two (C h_prev^T: four) 8-column
//   tiles; units are dealt round robin to the warps in two phases a chunk,
//   each about 8 mma k-steps deep: the products of C (G o M, causal strips
//   only, and C h_prev^T), barrier, then the rest of Y (stored straight to
//   global memory) beside the state update.
// - The order of every sum is fixed and there are no atomics: two calls give
//   equal bits.  Nothing is allocated beyond the outputs and nothing is read
//   back to the host.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kNG = 2;                 // 8-column tiles in a warp's unit
constexpr int kNS = 4;                 // the same, for the units of C h_prev^T
constexpr int kStages = 2;             // chunks in the cp.async ring
constexpr int kChunk = 64;             // steps a chunk, 32 where S <= 32 or 64 would not fit
constexpr int kChunkThreads = 512;     // threads a chunked block
constexpr int kDecodeThreads = 256;    // threads a decode block
constexpr int kMaxSmem = 232448;       // bytes a block may have on sm_90

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The least stride >= w congruent to r modulo 32 floats.
__host__ __device__ inline int pad_to(int w, int r) { return w + (((r - w) % 32) + 32) % 32; }

// Shared memory of a chunked block, in floats: a ring of two stages (x rows
// of the slice, B and C rows, ld, dt), the G o M tile, C h_prev^T (rows PX),
// two state buffers (the chunk reads one and writes the other) and each
// warp's scan.  Strides: x rows PX = 8 mod 32 (its fragments read 8 t + g
// apart), B and C rows PN, the G o M rows PW and the state rows PH = 4 mod 32
// (4 g + t apart), so that a fragment's 32 loads fall in distinct banks (B in
// the state update: 2-way).
struct Layout {
  int Dp, Np, PX, PN, PW, PH, warps;
  int stage;                   // x, B, C, ld, dt of one chunk
  int w_off, ys_off, h_off, scan_off, total;
};

__host__ __device__ inline Layout layout(int L, int ds, int n) {
  Layout o;
  o.Dp = round_up(ds, 16);
  o.Np = round_up(n, 8);
  o.PX = pad_to(o.Dp, 8);
  o.PN = pad_to(o.Np, 4);
  o.PW = pad_to(L, 4);
  o.PH = pad_to(o.Np, 4);
  o.warps = kChunkThreads / 32;
  o.stage = L * o.PX + 2 * L * o.PN + 2 * L;
  o.w_off = kStages * o.stage;
  o.ys_off = o.w_off + L * o.PW;
  o.h_off = o.ys_off + L * o.PX;
  o.scan_off = o.h_off + 2 * o.Dp * o.PH;
  o.total = o.scan_off + o.warps * 3 * L;
  return o;
}

// Asynchronous copies to shared memory; src-size 0 zero-fills the destination
// and reads nothing from `src`.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool read) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(read ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool read) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(read ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// v rounded to TF32 (10 mantissa bits) to nearest, ties away from zero: the
// bits of cvt.rna.tf32.f32, in two integer operations instead of its four.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo + O(2^-22 v), both TF32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d += a b: a 16 x 8 (row), b 8 x 8 (col), d 16 x 8, TF32 in, float32 sum.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's acc[q] += A[m0:m0+16, k0:k1] B[k0:k1, n0+8q:n0+8q+8] for q < nt, in
// 3xTF32: `big` takes hi*hi, `small` the two cross terms.  a(m, k) and b(k, n)
// read the float32 operands, split as they are loaded.  Fragments (m16n8k8,
// lane = 4 g + t): A (g|g+8, t|t+4), B (t|t+4, g), accumulator (g|g+8, 2t|2t+1).
template <int NG, class FA, class FB>
__device__ __forceinline__ void warp_gemm(float (&big)[NG][4], float (&small)[NG][4], FA a,
                                          FB b, int m0, int n0, int nt, int k0, int k1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = k0; k < k1; k += 8) {
    uint32_t ah[4], al[4];
    split_tf32(a(m0 + g, k + t), ah[0], al[0]);
    split_tf32(a(m0 + g + 8, k + t), ah[1], al[1]);
    split_tf32(a(m0 + g, k + t + 4), ah[2], al[2]);
    split_tf32(a(m0 + g + 8, k + t + 4), ah[3], al[3]);
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      if (q < nt) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(b(k + t, n0 + 8 * q + g), bh0, bl0);
        split_tf32(b(k + t + 4, n0 + 8 * q + g), bh1, bl1);
        mma_tf32(small[q], al, bh0, bh1);  // compensation: lo * hi
        mma_tf32(small[q], ah, bl0, bl1);  // compensation: hi * lo
        mma_tf32(big[q], ah, bh0, bh1);
      }
    }
  }
}

// Row and column, within a unit at (m0, n0), of accumulator element r of tile q.
__device__ __forceinline__ int acc_row(int m0, int r) {
  return m0 + ((threadIdx.x & 31) >> 2) + (r >> 1) * 8;
}
__device__ __forceinline__ int acc_col(int n0, int q, int r) {
  return n0 + 8 * q + 2 * (threadIdx.x & 3) + (r & 1);
}

// Block (row b, head, slice): the chunks of one head's D-slice in order.
// vec_x: x rows move in 16-byte pieces (D % 4 == 0, x aligned); vec_n: B and
// C rows do (N % 4 == 0, both aligned).
__global__ void __launch_bounds__(kChunkThreads)
    ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                     const float* __restrict__ cm, const float* __restrict__ ld,
                     const float* __restrict__ dt, const float* __restrict__ h0,
                     float* __restrict__ y, float* __restrict__ h_out, int S, int H, int D, int N,
                     int L, int ds, int slices, bool vec_x, bool vec_n) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay = layout(L, ds, N);
  const int slice = blockIdx.x % slices;
  const int bh = blockIdx.x / slices;
  const int b = bh / H, head = bh - b * H;
  const int d0 = slice * ds, wd = min(ds, D - d0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = lay.warps;
  const int nc = (S + L - 1) / L;
  const long long row0 = (long long)b * S;  // step 0 of batch row b
  const long long hbase = ((long long)bh * D + d0) * N;
  const int Dp = lay.Dp, Np = lay.Np, PX = lay.PX, PN = lay.PN, PW = lay.PW, PH = lay.PH;
  float* sW = smem + lay.w_off;
  float* sys = smem + lay.ys_off;  // diag(exp(cum)) C h_prev^T
  float* sh = smem + lay.h_off;  // two state buffers of Dp x PH
  // this warp's cum_i, exp(cum_i) and dt_j exp(cum_L - cum_j)
  float* my = smem + lay.scan_off + warp * 3 * L;

  for (int d = warp; d < Dp; d += warps)
    for (int n = lane; n < Np; n += 32)
      sh[d * PH + n] = (d < wd && n < N) ? h0[hbase + (long long)d * N + n] : 0.f;

  // Stage chunk c into ring slot c % 2, zeros past S, the slice and N: a warp
  // a row, its lanes along the row.  Always commit a group, empty past the end.
  auto issue = [&](int c) {
    if (c < nc) {
      float* sx = smem + (c & 1) * lay.stage;
      float* sb = sx + L * PX;
      float* sc = sb + L * PN;
      float* sld = sc + L * PN;
      float* sdt = sld + L;
      const int t0 = c * L, steps = min(L, S - t0);
      for (int j = warp; j < L; j += warps) {
        const bool step = j < steps;
        const long long xrow = ((row0 + t0 + j) * H + head) * D + d0;
        const long long nrow = (row0 + t0 + j) * N;
        if (vec_x) {
          const int dd = lane * 4;
          if (dd < Dp) {
            const bool in = step && dd < wd;
            cp_async16(sx + j * PX + dd, in ? x + xrow + dd : x, in);
          }
        } else {
          for (int dd = lane; dd < Dp; dd += 32) {
            const bool in = step && dd < wd;
            cp_async4(sx + j * PX + dd, in ? x + xrow + dd : x, in);
          }
        }
        if (vec_n) {
          const int nn = lane * 4;
          if (nn < Np) {
            const bool in = step && nn < N;
            cp_async16(sb + j * PN + nn, in ? bm + nrow + nn : bm, in);
            cp_async16(sc + j * PN + nn, in ? cm + nrow + nn : cm, in);
          }
        } else {
          for (int nn = lane; nn < Np; nn += 32) {
            const bool in = step && nn < N;
            cp_async4(sb + j * PN + nn, in ? bm + nrow + nn : bm, in);
            cp_async4(sc + j * PN + nn, in ? cm + nrow + nn : cm, in);
          }
        }
      }
      for (int j = threadIdx.x; j < L; j += kChunkThreads) {
        const bool in = j < steps;
        const long long src = in ? (row0 + t0 + j) * H + head : 0;
        cp_async4(sld + j, ld + src, in);
        cp_async4(sdt + j, dt + src, in);
      }
    }
    cp_async_commit();
  };

  const int strips = L / 16;
  const int ytiles = Dp / 8, ygroups = (ytiles + kNG - 1) / kNG;
  const int htiles = Np / 8, hgroups = (htiles + kNG - 1) / kNG;
  const int g_units = strips * (strips + 1) / 2, s_groups = (ytiles + kNS - 1) / kNS;
  const int s_units = strips * s_groups;
  const int y_units = strips * ygroups, h_units = (Dp / 16) * hgroups;
  issue(0);
  for (int c = 0; c < nc; ++c) {
    cp_async_wait_all();  // this thread's copies of chunk c have landed
    __syncthreads();      // everyone's have, and chunk c - 1 is consumed
    issue(c + 1);         // into the slot chunk c - 1 left
    const float* sx = smem + (c & 1) * lay.stage;
    const float* sb = sx + L * PX;
    const float* sc = sb + L * PN;
    const float* sld = sc + L * PN;
    const float* sdt = sld + L;
    const float* hp = sh + (c & 1) * Dp * PH;  // h_prev
    float* hn = sh + ((c + 1) & 1) * Dp * PH;  // h_new
    const int t0 = c * L, steps = min(L, S - t0);

    // In-chunk cumulative log decay, by a shuffle scan of 32 steps at a time.
    float eL;
    {
      float v[2] = {sld[lane], L > 32 ? sld[32 + lane] : 0.f};
      float carry = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (half * 32 < L) {
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const float u = __shfl_up_sync(0xffffffffu, v[half], o);
            if (lane >= o) v[half] += u;
          }
          v[half] += carry;
          carry = __shfl_sync(0xffffffffu, v[half], 31);
        }
      }
      const float cum_l = carry;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (half * 32 < L) {
          const int i = half * 32 + lane;
          my[i] = v[half];
          my[L + i] = expf(v[half]);
          my[2 * L + i] = sdt[i] * expf(cum_l - v[half]);
        }
      }
      eL = expf(cum_l);
      __syncwarp();
    }

    // Phase 1, the products of C: G o M (causal strips only: strip s needs
    // columns 0 .. 16 s + 15) and diag(exp(cum)) C h_prev^T, dealt together.
    for (int u = warp; u < g_units + s_units; u += warps) {
      if (u < g_units) {
        int s = 0, r = u;
        while (r > s) r -= ++s;
        const int m0 = 16 * s, n0 = 8 * kNG * r;
        float big[kNG][4] = {}, small[kNG][4] = {};
        warp_gemm(
            big, small, [&](int i, int k) { return sc[i * PN + k]; },
            [&](int k, int j) { return sb[j * PN + k]; }, m0, n0, kNG, 0, Np);
#pragma unroll
        for (int q = 0; q < kNG; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = acc_row(m0, e), j = acc_col(n0, q, e);
            sW[i * PW + j] = j <= i ? (big[q][e] + small[q][e]) * expf(my[i] - my[j]) : 0.f;
          }
      } else {
        const int v = u - g_units, s = v / s_groups, r = v - s * s_groups;
        const int m0 = 16 * s, n0 = 8 * kNS * r, nt = min(kNS, ytiles - kNS * r);
        float big[kNS][4] = {}, small[kNS][4] = {};
        warp_gemm(big, small, [&](int i, int k) { return sc[i * PN + k]; }, [&](int k, int d) { return hp[d * PH + k]; }, m0, n0, nt, 0, Np);
#pragma unroll
        for (int q = 0; q < kNS; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (q < nt)
              sys[acc_row(m0, e) * PX + acc_col(n0, q, e)] =
                  (big[q][e] + small[q][e]) * my[L + acc_row(m0, e)];
      }
    }
    __syncthreads();

    // Phase 2, the Y units and the state-update units, dealt together, so
    // that the two run side by side on different warps.
    for (int u = warp; u < y_units + h_units; u += warps) {
      if (u < y_units) {
        // Y = diag(exp(cum)) C h_prev^T + (G o M) (x dt), stored to y.
        const int s = u / ygroups, r = u - s * ygroups;
        const int m0 = 16 * s, n0 = 8 * kNG * r, nt = min(kNG, ytiles - kNG * r);
        float big[kNG][4], small[kNG][4];
#pragma unroll
        for (int q = 0; q < kNG; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            big[q][e] = q < nt ? sys[acc_row(m0, e) * PX + acc_col(n0, q, e)] : 0.f;
            small[q][e] = 0.f;
          }
        warp_gemm(
            big, small, [&](int i, int j) { return sW[i * PW + j]; },
            [&](int j, int d) { return sx[j * PX + d] * sdt[j]; }, m0, n0, nt, 0, m0 + 16);
#pragma unroll
        for (int q = 0; q < kNG; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = acc_row(m0, e), d = acc_col(n0, q, e);
            if (q < nt && i < steps && d < wd)
              y[((row0 + t0 + i) * H + head) * D + d0 + d] = big[q][e] + small[q][e];
          }
      } else {
        // h_new = exp(cum_L) h_prev + ((x dt) o exp(cum_L - cum))^T B.
        const int v = u - y_units, s = v / hgroups, r = v - s * hgroups;
        const int m0 = 16 * s, n0 = 8 * kNG * r, nt = min(kNG, htiles - kNG * r);
        float big[kNG][4], small[kNG][4];
#pragma unroll
        for (int q = 0; q < kNG; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            big[q][e] = q < nt ? hp[acc_row(m0, e) * PH + acc_col(n0, q, e)] * eL : 0.f;
            small[q][e] = 0.f;
          }
        warp_gemm(big, small, [&](int d, int j) { return sx[j * PX + d] * my[2 * L + j]; }, [&](int j, int n) { return sb[j * PN + n]; }, m0, n0, nt, 0, L);
#pragma unroll
        for (int q = 0; q < kNG; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (q < nt) hn[acc_row(m0, e) * PH + acc_col(n0, q, e)] = big[q][e] + small[q][e];
      }
    }
  }
  __syncthreads();
  const float* hl = sh + (nc & 1) * Dp * PH;
  for (int d = warp; d < wd; d += warps)
    for (int n = lane; n < N; n += 32) h_out[hbase + (long long)d * N + n] = hl[d * PH + n];
}

// The 4 columns n0.. of a row of n, zero past n or where `live` is false.
// VEC: n % 4 == 0 and p 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void load4(const float* p, float (&out)[4], bool live, int n0, int n) {
  if constexpr (VEC) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live && n0 < n) v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = (live && n0 + i < n) ? p[i] : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, const float (&v)[4], bool live, int n0, int n) {
  if constexpr (VEC) {
    if (live && n0 < n) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (live && n0 + i < n) p[i] = v[i];
  }
}

// S = 1: thread (row = (b, head, d), lane j) owns columns 4 j .. 4 j + 3.
template <bool VEC>
__global__ void __launch_bounds__(kDecodeThreads)
    ssd_decode_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                      const float* __restrict__ cm, const float* __restrict__ ld,
                      const float* __restrict__ dt, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_out, long long rows, int H,
                      int D, int N, int lanes_log2) {
  const int lanes = 1 << lanes_log2;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> lanes_log2) + (threadIdx.x >> lanes_log2);
  const int j = threadIdx.x & (lanes - 1);
  const bool live = row < rows;
  const long long bh = live ? row / D : 0;
  const long long b = bh / H;
  const int n0 = 4 * j;
  float h[4], bv[4], cv[4];
  load4<VEC>(h0 + row * N + n0, h, live, n0, N);
  load4<VEC>(bm + b * N + n0, bv, live, n0, N);
  load4<VEC>(cm + b * N + n0, cv, live, n0, N);
  const float xv = live ? x[row] : 0.f;
  const float ldv = live ? ld[bh] : 0.f;
  const float dtv = live ? dt[bh] : 0.f;
  const float decay = expf(ldv), dx = dtv * xv;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = fmaf(decay, h[i], dx * bv[i]);
    acc = fmaf(h[i], cv[i], acc);
  }
  for (int o = lanes >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (live && j == 0) y[row] = acc;
  store4<VEC>(h_out + row * N + n0, h, live, n0, N);
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

// Rows of D a block takes: ceil(D / d_split) rounded up to whole 8-row tiles.
int slice_rows(int D, int d_split) { return round_up((D + d_split - 1) / d_split, 8); }

size_t chunk_smem(int L, int ds, int n) { return sizeof(float) * (size_t)layout(L, ds, n).total; }

// Lets ssd_chunk_kernel take up to kMaxSmem on the current device, once a device.
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (done.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

}  // namespace

// x (B, S, H, D); bm, cm (B, S, N); ld, dt (B, S, H); h0 (B, H, D, N) ->
// y (B, S, H, D), h_out (B, H, D, N); all float32 and contiguous,
// 1 <= D, N <= 128.  S = 1 takes the decode path; otherwise the chunked path
// (at S = 0 it copies h0 to h_out), with the D rows of a head cut into
// d_split slices of slice_rows(D, d_split) (one block each).  The chunk is
// kChunk steps, 32 where S <= 32; where a block's shared memory would pass
// kMaxSmem the chunk drops to 32 first, then the slices double.  Returns the
// launch's cudaGetLastError() code, or cudaErrorInvalidValue for operands it
// does not take.
extern "C" int repro_ssd_scan(const void* x, const void* bm, const void* cm, const void* ld,
                              const void* dt, const void* h0, void* y, void* h_out, int B, int S,
                              int H, int D, int N, int d_split, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S < 0 || D <= 0 || D > 128 || N <= 0 || N > 128 || d_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p_x = static_cast<const float*>(x);
  const float* p_b = static_cast<const float*>(bm);
  const float* p_c = static_cast<const float*>(cm);
  const float* p_ld = static_cast<const float*>(ld);
  const float* p_dt = static_cast<const float*>(dt);
  const float* p_h0 = static_cast<const float*>(h0);
  float* p_y = static_cast<float*>(y);
  float* p_h = static_cast<float*>(h_out);
  if (S == 1) {
    int lanes_log2 = 0;
    while ((4 << lanes_log2) < N) ++lanes_log2;
    const long long rows = (long long)B * H * D;
    const int per_block = kDecodeThreads >> lanes_log2;
    const long long grid = (rows + per_block - 1) / per_block;
    const bool vec = N % 4 == 0 && aligned16(bm) && aligned16(cm) && aligned16(h0) &&
                     aligned16(h_out);
    auto kern = vec ? ssd_decode_kernel<true> : ssd_decode_kernel<false>;
    kern<<<(unsigned)grid, kDecodeThreads, 0, st>>>(p_x, p_b, p_c, p_ld, p_dt, p_h0, p_y, p_h,
                                                    rows, H, D, N, lanes_log2);
    return static_cast<int>(cudaGetLastError());
  }
  int chunk = S <= 32 ? 32 : kChunk;
  int ds = slice_rows(D, d_split);
  while (chunk_smem(chunk, ds, N) > (size_t)kMaxSmem) {
    if (chunk > 32) {
      chunk = 32;
    } else if (ds > 8) {
      d_split *= 2;
      ds = slice_rows(D, d_split);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int slices = (D + ds - 1) / ds;
  const size_t smem = chunk_smem(chunk, ds, N);
  const bool vec_x = D % 4 == 0 && aligned16(x);
  const bool vec_n = N % 4 == 0 && aligned16(bm) && aligned16(cm);
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_chunk_kernel<<<B * H * slices, kChunkThreads, smem, st>>>(
      p_x, p_b, p_c, p_ld, p_dt, p_h0, p_y, p_h, S, H, D, N, chunk, ds, slices, vec_x, vec_n);
  return static_cast<int>(cudaGetLastError());
}
