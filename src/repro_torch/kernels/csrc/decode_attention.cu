// Single-token attention against the KV cache (decode) for Hopper (sm_90a),
// reading the cache where it lies.
//
// Replaces no TPU kernel: the reference decodes with plain softmax attention
// (src/repro/models/attention.py::attn_decode, through gqa_scores_softmax_out),
// which XLA fuses on the TPU. On the card the same two einsums batch over
// (b, kv), two dims that cannot merge in the cache's (B, T, KV, D) layout, so
// torch copied each layer's whole K, then its whole V, into a permuted layout
// before two batched GEMVs, on every decode step and over every row of the
// cache. This kernel computes the same function:
//   out[b, h] = softmax_t(q[b, h] . k[b, t, h / G] * D^-0.5) v[b, t, h / G],
//   over the live rows t < n, n = min(pos + 1, T),
// which is attn_decode's mask for both of its caches: a contiguous cache's
// rows <= pos (every row once pos >= T) and a ring buffer's slots written so
// far. The cache is (B, T, KV, D) with strides of its own along B and T (a
// layer's view of the stacked cache); q and out are (B, H, D), H = KV * G.
//
// What bounds it on an H100: the bytes of the live K and V rows, read once,
// 2 * B * n * KV * D * itemsize, plus q and out. It does 4 * B * H * n * D
// operations, G / 2 per float32 byte, far below the card's ~20 operations a
// byte outside the tensor cores, so every product is a float32 FMA (no TF32,
// no tensor cores): the float32 bar holds, and nothing is gained by them.
//
// Design (flash-decoding):
//   * grid (splits, B * KV): a block takes one kv head of one sequence and a
//     range of rows; its G query heads share every K/V row it reads, so GQA
//     reads each row once. The grid depends on the shapes only (the wrapper
//     picks the splits from B * KV and T), never on pos, so a captured graph
//     replays it at any position; a block whose rows start at or past n exits
//     at once, so the work follows pos. pos is read from device memory.
//   * a row is read by LPR lanes with VPL 16-byte loads each, the lanes of a
//     row on neighbouring addresses, straight into registers (each row is used
//     once, so nothing is staged in shared memory); q waits in shared memory in
//     float32. LPR is fixed at compile time from D, G and the dtype so that the
//     G accumulators of a lane fit in registers. A lane group starts the loads
//     of ROWS = 2 rows before it uses the first: at B = 32, T = 768, H = KV =
//     32, D = 80 in float32 that reads 84-85% of the card's 3.35 TB/s against
//     78-79% with one row (and no better with four, which spills), measured
//     on an H100.
//   * each group of LPR lanes keeps, per query head, a running max, a running
//     denominator and a p.v accumulator in float32 (online softmax) over rows
//     strided by the number of groups in the block; a score is summed over the
//     group by shuffles. Every lane of a warp runs the same number of row steps
//     (rows past the range are loaded clamped and left out), so the shuffles
//     take the whole warp.
//   * at the end the groups merge, inside a warp by shuffles and across warps
//     through shared memory. With one split the block writes out in v's dtype;
//     otherwise it writes a partial (acc, then m and l) in float32, and a
//     combine kernel joins the live splits of each (b, h).
//   * partial mode serves a cache whose rows are sharded over cards: pos holds
//     this shard's live rows n (0 to T) in place of a position, every split
//     writes its partial (an empty one, m = -1e30 and l = 0, when it has no
//     live rows) and no combine runs; the caller joins the partials of every
//     shard (decode_attention.combine_partials).
//   * D and G are template parameters, one instance for each (head dim,
//     group) pair the port's configurations give (by_shape, below); the C
//     entry point refuses any other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ROWS = 2;  // rows a lane group loads at once

struct Params {
  const void* q;      // (B, H, D)
  const void* k;      // (B, T, KV, D), strides stride_b, stride_t, D, 1
  const void* v;      // as k
  const int64_t* pos; // (1,): the position of the token decoded
  void* out;          // (B, H, D)
  float* part;        // splits > 1 or partial: (B * H, splits, D + 2), the accumulators, m, l
  int t_rows, kv_heads, splits, rows_per_split, partial;
  long long stride_b, stride_t;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes of the cache as floats (bf16 is the upper half of a float32).
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The live rows: n = min(pos + 1, T), at least 1; in partial mode pos holds n, 0 to T.
__device__ __forceinline__ int live_rows(const Params& p) {
  const long long n = p.partial ? p.pos[0] : p.pos[0] + 1;
  const int least = p.partial ? 0 : 1;
  return n < least ? least : (n > p.t_rows ? p.t_rows : (int)n);
}

// Lanes per row: the largest power of two up to 8 that divides the row's
// 16-byte vectors, doubled (up to 32) while a lane's G accumulators exceed 64.
__host__ __device__ constexpr int lanes_per_row(int vectors, int group, int vec) {
  int lpr = 1;
  while (lpr < 8 && vectors % (2 * lpr) == 0) lpr *= 2;
  while (group * (vectors / lpr) * vec > 64 && lpr < 32 && vectors % (2 * lpr) == 0) lpr *= 2;
  return lpr;
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS) decode_attn_split_kernel(const Params p) {
  constexpr int VEC = 16 / sizeof(T);
  static_assert(D % VEC == 0, "a row is whole 16-byte vectors");
  constexpr int NV = D / VEC;
  constexpr int LPR = lanes_per_row(NV, G, VEC);
  constexpr int VPL = NV / LPR;
  constexpr int E = VPL * VEC;       // elements of a row a lane holds
  constexpr int RPW = 32 / LPR;      // rows a warp reads a step
  constexpr int GROUPS = THREADS / LPR;

  __shared__ __align__(16) float sq[G * D];
  __shared__ float red_m[WARPS][G], red_l[WARPS][G];
  __shared__ float red_acc[WARPS][G][D];

  const int split = blockIdx.x;
  const int b = blockIdx.y / p.kv_heads, kvh = blockIdx.y % p.kv_heads;
  const int heads = p.kv_heads * G;
  const size_t bh0 = (size_t)b * heads + (size_t)kvh * G;  // the block's first query head
  const int n = live_rows(p);
  const int start = split * p.rows_per_split;
  if (start >= n) {  // the whole block: no barrier is left waiting
    if (p.partial)   // an empty partial
      for (int i = threadIdx.x; i < G * (D + 2); i += THREADS)
        p.part[((bh0 + i / (D + 2)) * p.splits + split) * (D + 2) + i % (D + 2)] =
            i % (D + 2) == D ? NEG_INF : 0.f;
    return;
  }
  const int end = min(start + p.rows_per_split, n);
  const T* q = static_cast<const T*>(p.q) + bh0 * D;
  for (int i = threadIdx.x; i < G * D; i += THREADS) sq[i] = to_float(q[i]);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LPR;  // this lane's vectors of a row: sub, sub + LPR, ...
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const T* k = static_cast<const T*>(p.k) + (size_t)b * p.stride_b + (size_t)kvh * D;
  const T* v = static_cast<const T*>(p.v) + (size_t)b * p.stride_b + (size_t)kvh * D;
  for (int r0 = start + warp * RPW; r0 < end; r0 += ROWS * GROUPS) {
    float kf[ROWS][E], vf[ROWS][E];
    bool live[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {  // every load of the step in flight at once
      const int r = r0 + u * GROUPS + lane / LPR;
      live[u] = r < end;
      const size_t row = (size_t)(live[u] ? r : end - 1) * p.stride_t;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        load16(k + row + (sub + j * LPR) * VEC, kf[u] + j * VEC);
        load16(v + row + (sub + j * LPR) * VEC, vf[u] + j * VEC);
      }
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const float* qv = sq + g * D + (sub + j * LPR) * VEC;
#pragma unroll
          for (int c = 0; c < VEC; ++c) s = fmaf(qv[c], kf[u][j * VEC + c], s);
        }
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
        if (live[u]) {
          s *= p.scale;
          const float m_new = fmaxf(m[g], s);
          const float corr = expf(m[g] - m_new);
          const float pr = expf(s - m_new);
          l[g] = l[g] * corr + pr;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pr, vf[u][e], acc[g][e] * corr);
          m[g] = m_new;
        }
      }
    }
  }

  // Merge the groups of a warp: lanes LPR apart hold the same vectors.
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_o = __shfl_xor_sync(FULL, m[g], off);
      const float l_o = __shfl_xor_sync(FULL, l[g], off);
      const float m_new = fmaxf(m[g], m_o);
      const float a = expf(m[g] - m_new), a_o = expf(m_o - m_new);
      l[g] = l[g] * a + l_o * a_o;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] = acc[g][e] * a + __shfl_xor_sync(FULL, acc[g][e], off) * a_o;
      m[g] = m_new;
    }
  }
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        red_m[warp][g] = m[g];
        red_l[warp][g] = l[g];
      }
#pragma unroll
      for (int j = 0; j < VPL; ++j)
#pragma unroll
        for (int c = 0; c < VEC; ++c) red_acc[warp][g][(sub + j * LPR) * VEC + c] = acc[g][j * VEC + c];
    }
  }
  __syncthreads();

  // Merge the warps: one (query head, element) a thread.
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, red_m[w][g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float a = expf(red_m[w][g] - mm);
      ll = fmaf(red_l[w][g], a, ll);
      aa = fmaf(red_acc[w][g][d], a, aa);
    }
    const size_t bh = bh0 + g;
    if (p.splits == 1 && !p.partial) {
      store(static_cast<T*>(p.out) + bh * D + d, aa / ll);
    } else {
      float* slot = p.part + (bh * p.splits + split) * (D + 2);
      slot[d] = aa;
      if (d == 0) {
        slot[D] = mm;
        slot[D + 1] = ll;
      }
    }
  }
}

// Joins the live splits of one (b, h): out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M).
template <typename T>
__global__ void __launch_bounds__(THREADS) decode_attn_combine_kernel(const Params p, int d) {
  const size_t bh = blockIdx.x;
  const int n = live_rows(p);
  const int live = (n + p.rows_per_split - 1) / p.rows_per_split;
  const float* part = p.part + bh * p.splits * (d + 2);  // split s: acc at s * (d + 2), then m, l
  float mm = NEG_INF;
  for (int s = 0; s < live; ++s) mm = fmaxf(mm, part[s * (d + 2) + d]);
  float ll = 0.f;
  for (int s = 0; s < live; ++s)
    ll = fmaf(part[s * (d + 2) + d + 1], expf(part[s * (d + 2) + d] - mm), ll);
  for (int i = threadIdx.x; i < d; i += THREADS) {
    float aa = 0.f;
    for (int s = 0; s < live; ++s)
      aa = fmaf(part[s * (d + 2) + i], expf(part[s * (d + 2) + d] - mm), aa);
    store(static_cast<T*>(p.out) + bh * d + i, aa / ll);
  }
}

template <typename T, int D, int G>
int launch(const Params& p, int batch, cudaStream_t stream) {
  decode_attn_split_kernel<T, D, G><<<dim3(p.splits, batch * p.kv_heads), THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1 || p.partial) return (int)err;
  decode_attn_combine_kernel<T><<<batch * p.kv_heads * G, THREADS, 0, stream>>>(p, D);
  return (int)cudaGetLastError();
}

// The (head dim, group) pairs of the port's configurations, smoke and full;
// decode_attention.py reads its SHAPES from these lines.
template <typename T>
int by_shape(const Params& p, int batch, int d, int group, cudaStream_t stream) {
#define DECODE_SHAPE(DD, GG) \
  if (d == DD && group == GG) return launch<T, DD, GG>(p, batch, stream);
  DECODE_SHAPE(16, 1) DECODE_SHAPE(16, 2) DECODE_SHAPE(16, 3) DECODE_SHAPE(16, 5)
  DECODE_SHAPE(64, 1) DECODE_SHAPE(80, 1)
  DECODE_SHAPE(128, 4) DECODE_SHAPE(128, 5) DECODE_SHAPE(128, 8) DECODE_SHAPE(128, 12)
#undef DECODE_SHAPE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, out: (batch, kv * group, d), contiguous; k, v: (batch, t, kv, d) with
// element strides stride_b, stride_t, d, 1, 16-byte aligned; pos: one int64
// on the device, the position, or with partial = 1 the live rows. part:
// float32 (batch * kv * group, splits, d + 2) when splits > 1 (scratch) or
// partial = 1 (the result; out unused), else unused. dtype: 0 = float32,
// 1 = bfloat16, for q, k, v and out alike. Returns a cudaError_t (0 on success).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v, const void* pos,
                                    void* out, void* part, int batch, int t, int kv, int d,
                                    int group, long long stride_b, long long stride_t, int splits,
                                    float scale, int dtype, int partial, void* stream) {
  if (batch < 1 || t < 1 || kv < 1 || splits < 1 || splits > t || (long long)batch * kv > 65535 ||
      ((splits > 1 || partial) && part == nullptr) || (!partial && out == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, static_cast<const int64_t*>(pos), out, static_cast<float*>(part), t, kv,
           splits, (t + splits - 1) / splits, partial != 0, stride_b, stride_t, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_shape<float>(p, batch, d, group, st);
  if (dtype == 1) return by_shape<__nv_bfloat16>(p, batch, d, group, st);
  return (int)cudaErrorInvalidValue;
}
