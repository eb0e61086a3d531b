// Flash attention forward for Hopper (sm_90a): GQA, causal, sliding window.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (launched by flash_attention_bhsd). It computes the same function:
//   o[i] = softmax(q[i] k[g]^T * D^-0.5, masked) v[g],  g = i / group,
// with the Pallas body's numerics: masked scores are -1e30 and their p is 0;
// the running max, the running denominator and the output accumulator are
// float32; the final divide clamps the denominator at 1e-30. Output has q's
// dtype (float32 or bfloat16).
//
// What bounds it on an H100. At serving shapes (S in the hundreds to
// thousands, D = 80) attention does ~2*S*D operations per byte of q/k/v/o,
// so the work, not the bytes, is the bound: causal prefill at B=4, S=2048,
// H=32, D=80 is ~8.6e10 operations against ~168 MB. The scores never go to
// device memory, which is what the TPU kernel's VMEM tiling bought as well.
//
// Design (simple and right first; tensor cores are for a later change):
//   * one block of 256 threads per (b*h, 64-row q tile); the TPU grid's
//     sequential kv dimension becomes a loop inside the block over 64-row
//     kv tiles staged in shared memory as float32;
//   * kv tiles that the causal or window mask hides entirely are skipped
//     (an exact shortcut: such a tile leaves m, l and acc unchanged);
//   * each thread owns 4 query rows x 4 score columns, and 4 rows x
//     ceil(D/16) output columns; a row's 16 threads sit in one half-warp and
//     reduce its max and sum with shuffles;
//   * scalar float32 FMAs from shared memory; row strides are odd (D | 1) so
//     the 16 rows a half-warp reads fall in 16 different banks;
//   * any S: the last q and kv tiles are zero-padded in shared memory and
//     masked, and rows past S are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int DMAX = 128;     // largest head dim
constexpr int TR = BQ / 16;   // query rows per thread
constexpr int TC = BK / 16;   // score columns per thread
constexpr int DC = DMAX / 16; // output columns per thread, at most
constexpr int PS = BK + 16;   // row stride of the probability tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a cast in torch or JAX
}

// Copy rows [row0, row0 + BK) of a (S, D) slab into shared memory as float32,
// zero past the last row.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int rows,
                                          int valid_rows, int d, int ds) {
  for (int i = threadIdx.x; i < rows * d; i += THREADS) {
    const int r = i / d;
    const int c = i - r * d;
    dst[r * ds + c] = r < valid_rows ? to_float(src[i]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int s, int d, int group, int causal, int window,
                 float scale) {
  extern __shared__ float smem[];
  const int ds = d | 1;  // odd row stride
  float* sq = smem;          // BQ x ds
  float* sk = sq + BQ * ds;  // BK x ds
  float* sv = sk + BK * ds;  // BK x ds
  float* sp = sv + BK * ds;  // BQ x PS

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x & 15;  // score / output column group
  const int ty = threadIdx.x >> 4;  // row group; its 16 threads share a half-warp
  const size_t kv_off = (size_t)(bh / group) * s * d;

  load_tile(sq, q + ((size_t)bh * s + q0) * d, BQ, min(BQ, s - q0), d, ds);

  float m[TR], l[TR], acc[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  // kv positions any row of this tile can see.
  const int k_hi = causal ? min(s, q0 + BQ) : s;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int nd = (d + 15) / 16;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    const int krows = min(BK, s - k0);
    load_tile(sk, k + kv_off + (size_t)k0 * d, BK, krows, d, ds);
    load_tile(sv, v + kv_off + (size_t)k0 * d, BK, krows, d, ds);
    __syncthreads();

    // scores = q k^T for this thread's 4 x 4 entries
    float sc[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qa[TR], kb[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) qa[i] = sq[(ty + 16 * i) * ds + c];
#pragma unroll
      for (int j = 0; j < TC; ++j) kb[j] = sk[(tx + 16 * j) * ds + c];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }

    // mask, then the online softmax update of each row
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
      bool ok[TC];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < s && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
        sc[i][j] = ok[j] ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        sp[r * PS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += p v
    for (int j = 0; j < krows; ++j) {
      float pa[TR], vb[DC];
#pragma unroll
      for (int i = 0; i < TR; ++i) pa[i] = sp[(ty + 16 * i) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        vb[c] = (c < nd && col < d) ? sv[j * ds + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pa[i], vb[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)bh * s + qp) * d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (c < nd && col < d) orow[col] = from_float<T>(acc[i][c] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int s, int d,
           int group, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = ((size_t)(BQ + 2 * BK) * (d | 1) + (size_t)BQ * PS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, d, group, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (bh, s, d); k, v: (bh / group, s, d); all contiguous on one device.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int bh, int s, int d, int group, int causal, int window,
                                   float scale, int dtype, void* stream) {
  if (d < 1 || d > DMAX || s < 1 || bh < 1 || group < 1 || bh % group != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, bh, s, d, group, causal, window, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, bh, s, d, group, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
