// Mamba-1 selective-scan forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py::_mamba_kernel
// (launched by mamba_chunk_scan_b). For every batch row b and channel d it
// runs the recurrence over time, from the state h0[b, d, :]:
//   h_t[n] = exp(dt_t[d] * A[d, n]) * h_{t-1}[n] + dt_t[d] * x_t[d] * B_t[n],
//   y_t[d] = sum_n C_t[n] * h_t[n],
// and returns y (B, T, DI) and the final state h_T (B, DI, N), all float32.
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
// once: at B=4, T=2048, DI=16384, N=16 that is ~1.62 GB, 0.48 ms at 3.35 TB/s,
// against ~7 float32 operations per (b, t, d, n), ~1.5e10 in all, 0.22 ms at
// 67 TFLOP/s. So bytes bound it. But every (b, t, d, n) also needs one
// exponential, 2.1e9 of them, and an accurate expf costs about ten
// instructions, one on the special-function unit; instruction issue, not
// memory, is what limits this first design.
//
// Design (simple and right first):
//   * blocks of 128 threads take 128 consecutive channels of one batch row,
//     so the loads of dt and x and the stores of y are coalesced along DI;
//     a ragged last channel block is masked;
//   * per tile of 32 time steps each thread first issues all its loads of
//     dt and x into its own column of shared memory (64 loads in flight per
//     thread), and the block stages the tile's B_t and C_t rows (N floats
//     each, shared by every channel); then it runs the 32 steps;
//   * no atomics and a fixed order of operations, so a run repeats bit for
//     bit; accurate expf (the exponent dt*A is <= 0, nothing overflows).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // channels per block
constexpr int TILE_T = 32;    // time steps staged per pass
constexpr int MAX_N = 16;     // largest state size

template <int N>
__global__ void __launch_bounds__(THREADS)
mamba_scan_fwd_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                      const float* __restrict__ bmat, const float* __restrict__ cmat,
                      const float* __restrict__ a, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_out, int t_len, int di) {
  __shared__ float sdt[TILE_T][THREADS];
  __shared__ float sx[TILE_T][THREADS];
  __shared__ float sb[TILE_T][N];
  __shared__ float sc[TILE_T][N];

  const int tid = threadIdx.x;
  const int d = blockIdx.x * THREADS + tid;
  const size_t row0 = (size_t)blockIdx.y * t_len;  // index of (b, t = 0) in (B*T)
  const bool live = d < di;
  const size_t state = ((size_t)blockIdx.y * di + d) * N;

  float av[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = live ? a[(size_t)d * N + n] : 0.f;
    h[n] = live ? h0[state + n] : 0.f;
  }

  for (int t0 = 0; t0 < t_len; t0 += TILE_T) {
    const int steps = min(TILE_T, t_len - t0);
    // Stage the tile. The barrier that ends the previous tile orders these
    // writes after its reads.
    if (live) {
      for (int s = 0; s < steps; ++s) {
        const size_t g = (row0 + t0 + s) * di + d;
        sdt[s][tid] = dt[g];
        sx[s][tid] = x[g];
      }
    }
    for (int i = tid; i < steps * N; i += THREADS) {
      const int s = i / N, n = i - s * N;
      const size_t g = (row0 + t0 + s) * N + n;
      sb[s][n] = bmat[g];
      sc[s][n] = cmat[g];
    }
    __syncthreads();

    if (live) {
      for (int s = 0; s < steps; ++s) {
        const float dtv = sdt[s][tid];
        const float dtx = dtv * sx[s][tid];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = expf(dtv * av[n]) * h[n] + dtx * sb[s][n];
          acc += h[n] * sc[s][n];
        }
        y[(row0 + t0 + s) * di + d] = acc;
      }
    }
    __syncthreads();
  }

  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[state + n] = h[n];
  }
}

template <int N>
cudaError_t launch(const float* dt, const float* x, const float* b, const float* c,
                   const float* a, const float* h0, float* y, float* h_out, int bsz, int t,
                   int di, cudaStream_t stream) {
  const dim3 grid((di + THREADS - 1) / THREADS, bsz);
  mamba_scan_fwd_kernel<N><<<grid, THREADS, 0, stream>>>(dt, x, b, c, a, h0, y, h_out, t, di);
  return cudaGetLastError();
}

}  // namespace

// dt, x, y: (bsz, t, di); b, c: (bsz, t, n); a: (di, n); h0, h_out:
// (bsz, di, n); all float32, contiguous, on one device. Needs 1 <= n <= 16
// and 1 <= bsz <= 65535. Returns a cudaError_t (0 on success).
extern "C" int mamba_scan_fwd(const void* dt, const void* x, const void* b, const void* c,
                              const void* a, const void* h0, void* y, void* h_out, int bsz,
                              int t, int di, int n, void* stream) {
  if (bsz < 1 || bsz > 65535 || t < 1 || di < 1 || n < 1 || n > MAX_N)
    return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  const float* af = static_cast<const float*>(a);
  const float* h0f = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define MAMBA_CASE(NS) \
  case NS:             \
    return (int)launch<NS>(dtf, xf, bf, cf, af, h0f, yf, hf, bsz, t, di, s);
    MAMBA_CASE(1) MAMBA_CASE(2) MAMBA_CASE(3) MAMBA_CASE(4)
    MAMBA_CASE(5) MAMBA_CASE(6) MAMBA_CASE(7) MAMBA_CASE(8)
    MAMBA_CASE(9) MAMBA_CASE(10) MAMBA_CASE(11) MAMBA_CASE(12)
    MAMBA_CASE(13) MAMBA_CASE(14) MAMBA_CASE(15) MAMBA_CASE(16)
#undef MAMBA_CASE
  }
  return (int)cudaErrorInvalidValue;
}
