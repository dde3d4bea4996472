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
// What bounds it on an H100.  Bytes: each launch reads dt, x, B, C, A and h0
// once and writes y and hT once.  At falcon-mamba-7b's decode step (B=4, S=1,
// d=8192, N=16) the states dominate (2 MB of h0 in, 2 MB of hT out); over a
// prompt dt, x and y do (S=2048: 201 MB).  Besides the bytes, the
// instructions: an expf and four other operations a (row, step, channel,
// state), about 15 instructions in the compiled loop, which over a prompt
// take longer than the bytes.  The recurrence is sequential in t, so a
// step's latency times S is a third limit when too few warps run.
//
// Design.  The TPU kernel keeps a (block_d, N) state tile in VMEM and walks
// the sequence tile by tile; here:
// - The state is split across lanes: a channel's N states go to L adjacent
//   lanes, kStates a lane (L a power of two; `scan_plan` in
//   kernels/mamba_scan/ref.py picks L, the channels a block and the time
//   tile from shapes alone).  A lane keeps its states and its values of A in
//   registers for the whole sequence, so the (B, S, d, N) discretized tensor
//   never exists.  When N % 4 == 0 and the state operands are 16-byte
//   aligned, h0, A and hT move as one vector a lane, coalesced across the
//   warp; otherwise a scalar path masks the states past N.  Lanes past
//   ceil(N / kStates) hold zeros and add nothing.
// - Over a prompt (tile > 1) the block's rows of dt and x (tile steps x its
//   channels) and the tile's B_t and C_t are staged in shared memory by
//   cp.async in a ring of kStages tiles, so the loads of the next tiles are
//   in flight while this one is computed and the loop over t reads only
//   registers and shared memory.
// - y over a prompt: the lanes walk the steps L at a time.  Each lane keeps
//   its partial sums of the L steps and the channel's L lanes reduce-scatter
//   them by __shfl_xor_sync (L - 1 shuffles), leaving lane j with the whole y
//   of step j of the group, which it stores straight to global memory: a
//   warp's store covers 32 / L channels at L steps, whole 32-byte sectors.
// - No branch inside the steps: every load of a step is unconditional (rows
//   past the tile's end are staged as zeros, and a step with dt = x = 0
//   leaves the states as they were) and the store of y is one predicated
//   instruction, so 2L steps make one basic block in which the compiler
//   interleaves the exponentials of many steps.
// - At S = 1 (tile == 1) nothing is staged: every lane reads its operands
//   straight from global memory once, the L lanes' sums meet by a butterfly
//   of __shfl_xor_sync, and the block uses no shared memory.  The butterfly
//   pairs the lanes in the order the reduce-scatter does, so a step's y has
//   the same bits on either path, and a call split in two and carried gives
//   one call's bits.
// - The exponential is expf(dt * A): the same function of the same float
//   product as the plain version's torch.exp, and the same bits (a card
//   test holds the factor to torch.exp bit for bit).  States whose decay is
//   near 1 carry the factor's rounding for thousands of steps, so it has to
//   round as the plain version's does.  Otherwise the kernel and the plain
//   version differ by fma contraction (which only removes roundings) and the
//   order of the sum over the states.
// - No float atomics: two calls give equal bits.  Nothing is allocated
//   beyond the two outputs and nothing is read back to the host, so a call
//   can be captured in a CUDA graph.
#include <cuda_runtime.h>

namespace {

constexpr int kStates = 4;        // states a lane holds
constexpr int kStages = 3;        // time tiles in the cp.async ring
constexpr int kMaxThreads = 256;  // threads a block at most

// A lane's kStates floats, moved as one vector.
struct __align__(sizeof(float) * kStates) LaneVec {
  float v[kStates];
};

// Floats of one ring stage: dt and x (tile rows of kMaxThreads / L, the most
// channels a block of L lanes a channel holds: a stride the compiler knows,
// so a step's shared-memory addresses are constant offsets), then B and C
// (tile rows of kStates * L: a row padded with zeros to the lanes' states).
__host__ __device__ inline int stage_floats(int lanes, int tile) {
  return 2 * tile * (kMaxThreads / lanes + kStates * lanes);
}

// Shared memory of a block: the ring of tiles.  None at tile 1.
size_t smem_bytes(int lanes, int tile) {
  if (tile <= 1) return 0;
  return sizeof(float) * (size_t)kStages * stage_floats(lanes, tile);
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The kStates values of a lane from p[0..]: states s0.. of a row of n, zero
// past n or where `live` is false.  VEC: n % 4 == 0 and p 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void load_lane(const float* p, float (&out)[kStates], bool live,
                                          int s0, int n) {
  if constexpr (VEC) {
    LaneVec v = {};
    if (live && s0 < n) v = *reinterpret_cast<const LaneVec*>(p);
#pragma unroll
    for (int i = 0; i < kStates; ++i) out[i] = v.v[i];
  } else {
#pragma unroll
    for (int i = 0; i < kStates; ++i) out[i] = (live && s0 + i < n) ? p[i] : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store_lane(float* p, const float (&val)[kStates], bool live,
                                           int s0, int n) {
  if constexpr (VEC) {
    if (live && s0 < n) {
      LaneVec v;
#pragma unroll
      for (int i = 0; i < kStates; ++i) v.v[i] = val[i];
      *reinterpret_cast<LaneVec*>(p) = v;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kStates; ++i)
      if (live && s0 + i < n) p[i] = val[i];
  }
}

// *ptr = v where p, as one predicated store: no branch splits the block of
// steps around it.
__device__ __forceinline__ void store_if(float* ptr, float v, bool p) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q st.global.f32 [%0], %1;\n}\n" ::"l"(ptr),
      "f"(v), "r"((int)p)
      : "memory");
}

// One step of a lane from dt, x and its values of B_t and C_t: updates its
// states h and returns its share of y_t, the sum over its states of h_t * C_t.
__device__ __forceinline__ float lane_step(float (&h)[kStates], const float (&av)[kStates],
                                           float dtv, float xv, const float (&bv)[kStates],
                                           const float (&cv)[kStates]) {
  const float dx = dtv * xv;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kStates; ++i) {
    h[i] = fmaf(expf(dtv * av[i]), h[i], dx * bv[i]);
    acc = fmaf(h[i], cv[i], acc);
  }
  return acc;
}

// The sum of v over the L lanes of a channel, the same bits on each (float
// addition commutes, so the butterfly's partners add alike).  Lanes pair
// first across the highest bit, as in reduce_scatter.
template <int L>
__device__ __forceinline__ float all_reduce(float v) {
#pragma unroll
  for (int o = L / 2; o >= 1; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// v[q] is a lane's share of step q's y; returns to lane j (of the channel's
// L) the sum over the L lanes of v[j].  Each round halves the steps a lane
// holds: it keeps the half that its bit o selects and adds its partner's
// share of that half.  L - 1 shuffles.
template <int L>
__device__ __forceinline__ float reduce_scatter(float (&v)[L], int j) {
#pragma unroll
  for (int o = L / 2; o >= 1; o /= 2) {
    const bool upper = (j & o) != 0;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float give = upper ? v[i] : v[i + o];
      const float keep = upper ? v[i + o] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, give, o);
    }
  }
  return v[0];
}

// Block (b, channel block): chans channels x L lanes.  VEC: n % 4 == 0 and the
// state operands (a, h0, h_out, bm, cm) 16-byte aligned.  rows16: d % 4 == 0
// and dt, x 16-byte aligned.
template <int L, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
    mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                      const float* __restrict__ bm, const float* __restrict__ cm,
                      const float* __restrict__ a, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_out, int S, int d, int n,
                      int chans, int tile, bool rows16) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int g = threadIdx.x / L;  // channel within the block
  const int j = threadIdx.x % L;  // lane within the channel
  const int c0 = blockIdx.y * chans;
  const int ch = c0 + g;
  const bool live = ch < d;
  const int s0 = j * kStates;  // the lane's first state
  const long long state = ((long long)b * d + ch) * n + s0;
  float h[kStates], av[kStates];
  load_lane<VEC>(h0 + state, h, live, s0, n);
  load_lane<VEC>(a + (long long)ch * n + s0, av, live, s0, n);

  const long long row = (long long)b * S;
  if (tile <= 1) {
    // S = 1: straight from global memory
    for (int t = 0; t < S; ++t) {
      const long long off = (row + t) * d + ch;
      float bv[kStates], cv[kStates];
      load_lane<VEC>(bm + (row + t) * n + s0, bv, true, s0, n);
      load_lane<VEC>(cm + (row + t) * n + s0, cv, true, s0, n);
      const float part = lane_step(h, av, live ? dt[off] : 0.f, live ? x[off] : 0.f, bv, cv);
      const float yv = all_reduce<L>(part);
      if (live && j == 0) y[off] = yv;
    }
    store_lane<VEC>(h_out + state, h, live, s0, n);
    return;
  }

  constexpr int kRow = kMaxThreads / L;  // a staged row of dt or x
  constexpr int kPad = kStates * L;      // a staged row of B or C
  const int stage = stage_floats(L, tile);
  const int n_tiles = (S + tile - 1) / tile;
  // Stage tile k into ring slot k % kStages: dt and x rows, and B and C rows
  // padded with zeros to kPad.  The rows past S up to the next multiple of
  // L (tile is one) are zeros: a step with dt = x = 0 and B = C = 0 leaves
  // the states as they were.  Always commit a group, empty past the last
  // tile, so the waits count tiles.
  auto issue = [&](int k) {
    if (k < n_tiles) {
      float* buf = smem + (k % kStages) * stage;
      const int t0 = k * tile, steps = min(tile, S - t0);
      const int rows = (steps + L - 1) / L * L;
      if (rows16) {
        const int per_row = chans / 4;
        for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
          const int t = i / per_row, cc = (i - t * per_row) * 4;
          const bool in = t < steps && c0 + cc < d;
          const long long src = in ? (row + t0 + t) * d + c0 + cc : 0;
          cp_async16(buf + t * kRow + cc, dt + src, in);
          cp_async16(buf + (tile + t) * kRow + cc, x + src, in);
        }
      } else {
        for (int i = threadIdx.x; i < rows * chans; i += blockDim.x) {
          const int t = i / chans, cc = i - t * chans;
          const bool in = t < steps && c0 + cc < d;
          const long long src = in ? (row + t0 + t) * d + c0 + cc : 0;
          cp_async4(buf + t * kRow + cc, dt + src, in);
          cp_async4(buf + (tile + t) * kRow + cc, x + src, in);
        }
      }
      float* sb = buf + 2 * tile * kRow;
      float* sc = sb + tile * kPad;
      if constexpr (VEC) {
        constexpr int per_row = kPad / 4;
        for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
          const int t = i / per_row, cc = (i - t * per_row) * 4;
          const bool in = t < steps && cc < n;
          const long long src = in ? (row + t0 + t) * n + cc : 0;
          cp_async16(sb + t * kPad + cc, bm + src, in);
          cp_async16(sc + t * kPad + cc, cm + src, in);
        }
      } else {
        for (int i = threadIdx.x; i < rows * kPad; i += blockDim.x) {
          const int t = i / kPad, cc = i - t * kPad;
          const bool in = t < steps && cc < n;
          const long long src = in ? (row + t0 + t) * n + cc : 0;
          cp_async4(sb + t * kPad + cc, bm + src, in);
          cp_async4(sc + t * kPad + cc, cm + src, in);
        }
      }
    }
    cp_async_commit();
  };

  for (int k = 0; k < kStages - 1; ++k) issue(k);
  for (int k = 0; k < n_tiles; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile k have landed
    __syncthreads();               // everyone's have, and tile k - 1 is consumed
    issue(k + kStages - 1);        // into the slot tile k - 1 left
    const float* buf = smem + (k % kStages) * stage;
    const float* sdt = buf + g;
    const float* sx = buf + tile * kRow + g;
    const float* sb = buf + 2 * tile * kRow + s0;
    const float* sc = sb + tile * kPad;
    const long long row0 = row + (long long)k * tile;
    const int steps = min(tile, S - k * tile);
    // L steps at a time, every load unconditional: one basic block whose
    // exponentials the compiler can interleave across the steps
#pragma unroll 2
    for (int u = 0; u < steps; u += L) {
      float acc[L];
#pragma unroll
      for (int q = 0; q < L; ++q) {
        const int t = u + q;
        const LaneVec b4 = *reinterpret_cast<const LaneVec*>(sb + t * kPad);
        const LaneVec c4 = *reinterpret_cast<const LaneVec*>(sc + t * kPad);
        acc[q] = lane_step(h, av, sdt[t * kRow], sx[t * kRow], b4.v, c4.v);
      }
      const float yv = reduce_scatter<L>(acc, j);
      store_if(y + (row0 + u + j) * d + ch, yv, live && u + j < steps);
    }
  }
  cp_async_wait<0>();
  store_lane<VEC>(h_out + state, h, live, s0, n);
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

template <int L>
cudaError_t launch(const float* dt, const float* x, const float* bm, const float* cm,
                   const float* a, const float* h0, float* y, float* h_out, int B, int S, int d,
                   int n, int chans, int tile, cudaStream_t stream) {
  const bool vec = n % 4 == 0 && aligned16(bm) && aligned16(cm) && aligned16(a) &&
                   aligned16(h0) && aligned16(h_out);
  const bool rows16 = d % 4 == 0 && aligned16(dt) && aligned16(x);
  const size_t smem = smem_bytes(L, tile);
  const dim3 grid(B, (d + chans - 1) / chans);
  auto kern = vec ? mamba_scan_kernel<L, true> : mamba_scan_kernel<L, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, chans * L, smem, stream>>>(dt, x, bm, cm, a, h0, y, h_out, S, d, n, chans, tile,
                                          rows16);
  return cudaGetLastError();
}

}  // namespace

// dt, x (B, S, d); bm, cm (B, S, n); a (d, n); h0 (B, d, n) -> y (B, S, d),
// h_out (B, d, n); all float32 and contiguous, 1 <= n <= 64.  The plan
// (ref.scan_plan): `lanes` a channel (a power of two, lanes * 4 >= n),
// `chans` channels a block (a multiple of 4; chans * lanes a multiple of 32,
// at most 256), `tile` steps staged at a time (1: nothing staged; else a
// multiple of lanes).  Returns the launch's cudaGetLastError() code, or
// cudaErrorInvalidValue for a plan it does not take.
extern "C" int repro_mamba_scan(const void* dt, const void* x, const void* bm, const void* cm,
                                const void* a, const void* h0, void* y, void* h_out, int B, int S,
                                int d, int n, int lanes, int chans, int tile, void* stream) {
  if (B <= 0 || d <= 0) return 0;
  const int threads = chans * lanes;
  if (n <= 0 || n > 64 || lanes * kStates < n || chans < 4 || chans % 4 != 0 ||
      threads % 32 != 0 || threads > kMaxThreads || tile < 1 ||
      (tile > 1 && tile % lanes != 0) || smem_bytes(lanes, tile) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
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
  switch (lanes) {
    case 1:
      err = launch<1>(p_dt, p_x, p_b, p_c, p_a, p_h0, p_y, p_h, B, S, d, n, chans, tile, st);
      break;
    case 2:
      err = launch<2>(p_dt, p_x, p_b, p_c, p_a, p_h0, p_y, p_h, B, S, d, n, chans, tile, st);
      break;
    case 4:
      err = launch<4>(p_dt, p_x, p_b, p_c, p_a, p_h0, p_y, p_h, B, S, d, n, chans, tile, st);
      break;
    case 8:
      err = launch<8>(p_dt, p_x, p_b, p_c, p_a, p_h0, p_y, p_h, B, S, d, n, chans, tile, st);
      break;
    case 16:
      err = launch<16>(p_dt, p_x, p_b, p_c, p_a, p_h0, p_y, p_h, B, S, d, n, chans, tile, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
