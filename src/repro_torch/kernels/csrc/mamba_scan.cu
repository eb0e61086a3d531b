// Mamba-1 selective-scan forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py::_mamba_kernel
// (launched by mamba_chunk_scan_b). For every batch row b and channel d it
// runs the recurrence over time, from the state h0[b, d, :]:
//   h_t[n] = exp(dt_t[d] * A[d, n]) * h_{t-1}[n] + dt_t[d] * x_t[d] * B_t[n],
//   y_t[d] = sum_n C_t[n] * h_t[n],
// and returns y (B, T, DI) and the final state h_T (B, DI, N), both float32.
// x may be float32 or bfloat16 and is cast on load, as the Pallas body casts
// it; everything else is float32.
//
// The TPU kernel walks a sequential grid axis of T/C chunks with a
// (d_block, N) state in VMEM and an associative scan inside each chunk. Here
// the chunk axis becomes a plain loop over time inside each thread: one
// thread per (b, d) keeps h[N] and A[d, :] in registers for the whole
// sequence. A step-by-step recurrence needs no chunk, so the kernel takes
// no chunk or d_block: a prime prompt length, which the reference runs at
// chunk 1, costs nothing extra.
//
// What bounds it on an H100. Each input is read once and each output written
// once: at B=4, T=2048, DI=16384, N=16 in float32 that is ~1.62 GB, 0.48 ms
// at 3.35 TB/s. Every (b, t, d, n) also needs one exponential, 2.1e9 of
// them; the special-function unit (MUFU) takes 16 a clock on each SM, so
// with all of them there the floor is ~0.51 ms at 1.98 GHz, above the byte
// bound. Instruction issue comes next: the design spends about 6 issued
// instructions per (t, d, n) where the first one spent about 15:
//   * A is pre-scaled by log2(e) once per thread, and 2^(dt*A2) comes from
//     ex2.approx (a few ulp; the argument is never positive, dt > 0, A < 0;
//     below -126 the result flushes to 0, where the exact one is < 2^-126);
//   * per (t, d, n): one multiply for the exponent, the exponential, dt*x*B
//     (dt*x once per (t, d)), one FMA into h, one FMA into y; B_t and C_t
//     are read from shared memory as float4 broadcasts, and the sum over N
//     runs as four partial sums and a tree;
//   * blocks of 128 channels of one batch row (coalesced along DI; a ragged
//     last block is masked), one thread per channel. Tiles of TILE_T steps
//     of dt, x, B and C are staged by cp.async in a ring of STAGES tiles:
//     tiles k + 1 to k + 3 land while tile k runs, with one barrier per tile.
//     At most 128 registers and 36,864 bytes of shared memory keep 4 blocks
//     resident on each SM, so B=4 at DI=16384 (512 blocks) runs in one wave;
//   * no atomics and a fixed order of operations, so a run repeats bit for
//     bit, and a bfloat16 x gives the same bits as the same x in float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int CHANNELS = 128;  // channels per block, one thread each
constexpr int TILE_T = 8;      // time steps per staged tile
constexpr int STAGES = 4;      // tiles in the ring: STAGES - 1 in flight
constexpr int MAX_N = 16;      // largest state size
// Resident blocks per SM the register budget keeps: 512 channels an SM, so
// B=4 at DI=16384 (65,536 channels on 132 SMs) runs in one wave. A 16-step
// tile, unrolled, spills at this budget.
constexpr int MIN_BLOCKS = 4;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// One staged tile; NP is N rounded up to a multiple of 4, and the padding
// columns of b and c hold zeros.
template <int NP, typename XT>
struct __align__(16) Tile {
  float dt[TILE_T][CHANNELS];
  XT x[TILE_T][CHANNELS];
  float b[TILE_T][NP];
  float c[TILE_T][NP];
};

template <int NP, typename XT>
__global__ void __launch_bounds__(CHANNELS, MIN_BLOCKS)
mamba_scan_fwd_kernel(const float* __restrict__ dt, const XT* __restrict__ x,
                      const float* __restrict__ bmat, const float* __restrict__ cmat,
                      const float* __restrict__ a, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_out, int t_len, int di,
                      int n, bool vec) {
  static_assert(NP % 4 == 0, "float4 reads of B and C");
  __shared__ Tile<NP, XT> ring[STAGES];

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * CHANNELS;
  const int d = d0 + tid;
  const size_t row0 = (size_t)blockIdx.y * t_len;  // index of (b, t = 0) in (B*T)
  const bool live = d < di;

  float a2[NP], h[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const bool on = live && j < n;
    a2[j] = on ? a[(size_t)d * n + j] * LOG2E : 0.f;  // padding: 2^0 * 0 + dtx * 0
    h[j] = on ? h0[((size_t)blockIdx.y * di + d) * n + j] : 0.f;
  }

  // Each thread's copy slots, the same in every tile. dt and x: 16-byte
  // pieces of a tile row, rows r, r + ROWS, ...; B and C: element (s, j).
  constexpr int DT_CH = CHANNELS * 4 / 16, DT_ROWS = CHANNELS / DT_CH;
  constexpr int XE = 16 / sizeof(XT), X_CH = CHANNELS / XE, X_ROWS = CHANNELS / X_CH;
  static_assert((STAGES & (STAGES - 1)) == 0, "a ring of a power of two");
  const int dt_r = tid / DT_CH, dt_c = tid % DT_CH * 4;
  const int x_r = tid / X_CH, x_c = tid % X_CH * XE;
  const int dt_bytes = max(0, min(16, (di - d0 - dt_c) * 4));  // 0 past DI: zero-filled
  const int x_bytes = max(0, min(16, (di - d0 - x_c) * (int)sizeof(XT)));
  const float* dt_src = dt + (row0 + dt_r) * di + d0 + dt_c;
  const XT* x_src = x + (row0 + x_r) * di + d0 + x_c;
  constexpr int BC_PASSES = (TILE_T * NP + CHANNELS - 1) / CHANNELS;
#pragma unroll
  for (int p = 0; p < BC_PASSES; ++p) {  // padding columns stay zero
    const int s = (tid + p * CHANNELS) / NP, j = (tid + p * CHANNELS) % NP;
    if (s < TILE_T && j >= n) {
#pragma unroll
      for (int st = 0; st < STAGES; ++st) ring[st].b[s][j] = ring[st].c[s][j] = 0.f;
    }
  }

  // Issue the copies of tile k into its slot of the ring (nothing past T).
  auto stage_tile = [&](int k) {
    const int t0 = k * TILE_T;
    if (t0 >= t_len) return;
    const int steps = min(TILE_T, t_len - t0);
    Tile<NP, XT>& tile = ring[k & (STAGES - 1)];
    if (vec) {  // rows start on 16 bytes: 16-byte copies
#pragma unroll
      for (int p = 0; p < (TILE_T + DT_ROWS - 1) / DT_ROWS; ++p) {
        const int s = dt_r + p * DT_ROWS;
        if (s < steps)
          ptx::cp_async_16(&tile.dt[s][dt_c],
                           dt_bytes ? dt_src + (size_t)(t0 + p * DT_ROWS) * di : dt, dt_bytes);
      }
#pragma unroll
      for (int p = 0; p < (TILE_T + X_ROWS - 1) / X_ROWS; ++p) {
        const int s = x_r + p * X_ROWS;
        if (s < steps)
          ptx::cp_async_16(&tile.x[s][x_c],
                           x_bytes ? x_src + (size_t)(t0 + p * X_ROWS) * di : x, x_bytes);
      }
    } else {  // any other DI or alignment: plain loads of the channel's column
      for (int s = 0; s < steps; ++s) {
        const size_t g = (row0 + t0 + s) * di + d;
        tile.dt[s][tid] = live ? dt[g] : 0.f;
        tile.x[s][tid] = live ? x[g] : XT(0.f);
      }
    }
#pragma unroll
    for (int p = 0; p < BC_PASSES; ++p) {
      const int s = (tid + p * CHANNELS) / NP, j = (tid + p * CHANNELS) % NP;
      if (j < n && s < steps) {
        const size_t g = (row0 + t0 + s) * n + j;
        ptx::cp_async_4(&tile.b[s][j], bmat + g, 4);
        ptx::cp_async_4(&tile.c[s][j], cmat + g, 4);
      }
    }
  };

  // One time step from the tile: the state update and y_t[d].
  auto step = [&](const Tile<NP, XT>& tile, int s) -> float {
    const float dtv = tile.dt[s][tid];
    const float dtx = dtv * to_float(tile.x[s][tid]);
    const float4* bv = reinterpret_cast<const float4*>(tile.b[s]);
    const float4* cv = reinterpret_cast<const float4*>(tile.c[s]);
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < NP / 4; ++q) {
      const float4 bq = bv[q], cq = cv[q];
      const float bb[4] = {bq.x, bq.y, bq.z, bq.w}, cc[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * q + r;
        const float da = ptx::ex2(dtv * a2[i]);
        h[i] = fmaf(da, h[i], dtx * bb[r]);
        part[r] = fmaf(cc[r], h[i], part[r]);
      }
    }
    return (part[0] + part[1]) + (part[2] + part[3]);
  };

  const int ntiles = (t_len + TILE_T - 1) / TILE_T;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    stage_tile(k);
    ptx::cp_async_commit();  // an empty group past T keeps the count
  }
  float* yp = y + row0 * di + d;
  for (int k = 0; k < ntiles; ++k) {
    ptx::cp_async_wait<STAGES - 2>();  // tile k has landed (this thread's copies)
    __syncthreads();  // everyone's copies of tile k, and everyone is done with tile k - 1
    stage_tile(k + STAGES - 1);  // into tile k - 1's slot
    ptx::cp_async_commit();

    const Tile<NP, XT>& tile = ring[k & (STAGES - 1)];
    const int steps = min(TILE_T, t_len - k * TILE_T);
    if (steps == TILE_T) {
#pragma unroll
      for (int s = 0; s < TILE_T; ++s) {
        const float v = step(tile, s);
        if (live) *yp = v;
        yp += di;
      }
    } else {
#pragma unroll 1
      for (int s = 0; s < steps; ++s) {
        const float v = step(tile, s);
        if (live) *yp = v;
        yp += di;
      }
    }
  }
  ptx::cp_async_wait<0>();  // no copy outlives the block

  if (live) {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (j < n) h_out[((size_t)blockIdx.y * di + d) * n + j] = h[j];
    }
  }
}

// The kernel's arguments; run<NP, XT>() launches the instantiation.
struct Launch {
  const float *dt;
  const void* x;
  const float *b, *c, *a, *h0;
  float *y, *h_out;
  int bsz, t, di, n;
  cudaStream_t stream;

  template <int NP, typename XT>
  cudaError_t run() const {
    const bool vec = reinterpret_cast<uintptr_t>(dt) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 && (size_t)di * 4 % 16 == 0 &&
                     (size_t)di * sizeof(XT) % 16 == 0;
    const dim3 grid((di + CHANNELS - 1) / CHANNELS, bsz);
    mamba_scan_fwd_kernel<NP, XT><<<grid, CHANNELS, 0, stream>>>(
        dt, static_cast<const XT*>(x), b, c, a, h0, y, h_out, t, di, n, vec);
    return cudaGetLastError();
  }
};

// Resident blocks per SM of an instantiation, from the occupancy calculator.
struct Occupancy {
  int* blocks;

  template <int NP, typename XT>
  cudaError_t run() const {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mamba_scan_fwd_kernel<NP, XT>,
                                                         CHANNELS, 0);
  }
};

// f.run<NP, XT>() for the instantiation that state size n and x's type take:
// NP is n rounded up to a multiple of 4.
template <typename F, int NP = 4>
cudaError_t dispatch(const F& f, int n, int x_bf16) {
  if constexpr (NP > MAX_N) {
    return cudaErrorInvalidValue;
  } else {
    if (n <= NP)
      return x_bf16 ? f.template run<NP, __nv_bfloat16>() : f.template run<NP, float>();
    return dispatch<F, NP + 4>(f, n, x_bf16);
  }
}

}  // namespace

// dt, y: (bsz, t, di) float32; x: (bsz, t, di) float32 (x_bf16 = 0) or
// bfloat16 (x_bf16 = 1); b, c: (bsz, t, n); a: (di, n); h0, h_out:
// (bsz, di, n); all float32 but x, contiguous, on one device. Needs
// 1 <= n <= 16 and 1 <= bsz <= 65535. Returns a cudaError_t (0 on success).
extern "C" int mamba_scan_fwd(const void* dt, const void* x, const void* b, const void* c,
                              const void* a, const void* h0, void* y, void* h_out, int bsz,
                              int t, int di, int n, int x_bf16, void* stream) {
  if (bsz < 1 || bsz > 65535 || t < 1 || di < 1 || n < 1 || n > MAX_N || (x_bf16 & ~1))
    return (int)cudaErrorInvalidValue;
  const Launch f{static_cast<const float*>(dt), x, static_cast<const float*>(b),
                 static_cast<const float*>(c), static_cast<const float*>(a),
                 static_cast<const float*>(h0), static_cast<float*>(y),
                 static_cast<float*>(h_out), bsz, t, di, n, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(f, n, x_bf16);
}

// Resident blocks per SM of the kernel that mamba_scan_fwd launches for a
// state size n and x's type (0 or 1, as x_bf16 there).
extern "C" int mamba_scan_occupancy(int n, int x_bf16, int* blocks) {
  if (n < 1 || n > MAX_N || (x_bf16 & ~1)) return (int)cudaErrorInvalidValue;
  return (int)dispatch(Occupancy{blocks}, n, x_bf16);
}
