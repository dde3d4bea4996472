// Mamba1 selective scan (Hopper, sm_90a).
//
// Replaces: src/repro/kernels/mamba_scan/kernel.py
//   mamba_scan_pallas -> _kernel (the TPU kernel).
//
// Computes, for batch row b and channel c, with a state of N values:
//   h_t[n] = exp(dt[b,t,c] * A[c,n]) * h_{t-1}[n] + dt[b,t,c] * x[b,t,c] * B[b,t,n]
//   y[b,t,c] = sum_n h_t[n] * C[b,t,n]
// from h_{-1} = h0[b,c,:], and writes the last state to hT[b,c,:].  All float32.
//
// What bounds it: bytes.  Each launch reads dt, x, B, C, A and h0 once and
// writes y and hT once; per (row, channel, step) it does about 5 N flops and
// N exponentials.  At falcon-mamba-7b's decode step (B=4, S=1, d=8192, N=16)
// the states dominate: 2 MB of h0 in and 2 MB of hT out, about 1.4 us at the
// card's memory rate.  Over a long prompt the sequential dependence in t,
// not the bytes, sets the time: this simple kernel walks t one step at a time.
//
// Design: one thread per (batch row, channel) keeps its N state values and its
// N values of A in registers for the whole sequence, so the (B, S, d, N)
// discretized tensor never exists and A is read once a launch for each row.
// A block covers 128 channels of one row; blockIdx.x is the batch row, so the
// B blocks that share a tile of A are scheduled together and all but the first
// find it in L2.  The loop over t stands in for the TPU's sequential S grid
// axis; it does not copy the TPU's (block_d x block_s) VMEM tiling.  dt and x
// are read coalesced across channels; B_t and C_t (N floats each, the same for
// every channel of the row) are staged in shared memory for 32 steps at a time
// and read as broadcasts.  The exponential is expf (not __expf), so a step
// rounds like the plain version; fma contraction only removes roundings.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels a block
constexpr int kTile = 32;      // time steps of B and C staged at a time

template <int NMAX>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                      const float* __restrict__ bm, const float* __restrict__ cm,
                      const float* __restrict__ a, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_out, int S, int d, int n) {
  __shared__ float s_b[kTile * NMAX];
  __shared__ float s_c[kTile * NMAX];
  const int b = blockIdx.x;
  const int ch = blockIdx.y * kThreads + threadIdx.x;
  const bool live = ch < d;
  const long long state = ((long long)b * d + ch) * n;
  float h[NMAX];
  float av[NMAX];
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    h[i] = 0.f;
    av[i] = 0.f;
    if (live && i < n) {
      h[i] = h0[state + i];
      av[i] = a[(long long)ch * n + i];
    }
  }
  const long long row = (long long)b * S;
  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int steps = min(kTile, S - t0);
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < steps * n; i += kThreads) {
      s_b[i] = bm[(row + t0) * n + i];
      s_c[i] = cm[(row + t0) * n + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < steps; ++t) {
      const long long off = (row + t0 + t) * d + ch;
      const float dt_t = dt[off];
      const float dx = dt_t * x[off];
      const float* bt = s_b + t * n;
      const float* ct = s_c + t * n;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < NMAX; ++i) {
        if (i < n) {
          h[i] = expf(dt_t * av[i]) * h[i] + dx * bt[i];
          acc += h[i] * ct[i];
        }
      }
      y[off] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NMAX; ++i)
      if (i < n) h_out[state + i] = h[i];
  }
}

template <int NMAX>
cudaError_t launch(const float* dt, const float* x, const float* bm, const float* cm,
                   const float* a, const float* h0, float* y, float* h_out, int B, int S, int d,
                   int n, cudaStream_t stream) {
  const dim3 grid(B, (d + kThreads - 1) / kThreads);
  mamba_scan_kernel<NMAX><<<grid, kThreads, 0, stream>>>(dt, x, bm, cm, a, h0, y, h_out, S, d, n);
  return cudaGetLastError();
}

}  // namespace

// dt, x (B, S, d); bm, cm (B, S, n); a (d, n); h0 (B, d, n) -> y (B, S, d),
// h_out (B, d, n); all float32 and contiguous, 1 <= n <= 64.  Returns the
// launch's cudaGetLastError() code.
extern "C" int repro_mamba_scan(const void* dt, const void* x, const void* bm, const void* cm,
                                const void* a, const void* h0, void* y, void* h_out, int B, int S,
                                int d, int n, void* stream) {
  if (B <= 0 || d <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p_dt = static_cast<const float*>(dt);
  const float* p_x = static_cast<const float*>(x);
  const float* p_b = static_cast<const float*>(bm);
  const float* p_c = static_cast<const float*>(cm);
  const float* p_a = static_cast<const float*>(a);
  const float* p_h0 = static_cast<const float*>(h0);
  float* p_y = static_cast<float*>(y);
  float* p_h = static_cast<float*>(h_out);
  cudaError_t err;
  if (n <= 0 || n > 64) {
    err = cudaErrorInvalidValue;
  } else if (n <= 16) {
    err = launch<16>(p_dt, p_x, p_b, p_c, p_a, p_h0, p_y, p_h, B, S, d, n, st);
  } else if (n <= 32) {
    err = launch<32>(p_dt, p_x, p_b, p_c, p_a, p_h0, p_y, p_h, B, S, d, n, st);
  } else {
    err = launch<64>(p_dt, p_x, p_b, p_c, p_a, p_h0, p_y, p_h, B, S, d, n, st);
  }
  return static_cast<int>(err);
}
