// Flash attention forward for Hopper (sm_90a): GQA, causal, sliding window,
// and cross-attention (bidirectional, k/v of a length of their own).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (launched by flash_attention_bhsd). It computes the same function:
//   o[i] = softmax(q[i] k[g]^T * D^-0.5, masked) v[g],  g = i / group,
// over s_q query rows and s_kv kv rows; the Pallas body takes one length, and
// the reference's cross-attention (q over the text, k/v over the image patches
// or the encoder's frames) computes the same softmax in plain jnp. The causal
// mask and the window need s_q == s_kv (the wrapper refuses them otherwise).
// with the Pallas body's numerics: masked scores are -1e30 and their p is 0;
// the running max, the running denominator and the output accumulator are
// float32; the final divide clamps the denominator at 1e-30. Output has q's
// dtype (float32 or bfloat16).
//
// What bounds it on an H100. Causal attention does ~S/4 operations per byte
// of bf16 q/k/v/o at any D (80, 128, or 192 for MLA's q and k) against the
// card's ~295, so at S in the thousands the work, not the bytes, is the
// bound: causal prefill at B=4, S=2048, H=32, D=80 is ~8.6e10 operations
// against ~168 MB; at serving prompts of ~300 tokens the bytes are (MLA at
// B=4, H=128, D=192: 236 MB against 1.8e10 operations). The scores never go
// to device memory, which is what the TPU kernel's VMEM tiling bought.
//
// Two kernels, one per dtype, because the two dtypes have different bars:
//   * bfloat16 (the serving path) runs both products on the tensor cores:
//     mma.sync m16n8k16 bf16 with float32 accumulation. The Pallas body forms
//     p and p.v in float32; here p is rounded to bf16 before the p.v product,
//     as the model-level reference rounds probabilities to v's dtype
//     (src/repro/models/attention.py:71). The bf16 bar (3e-2) covers it. The
//     denominator sums the float32 p.
//   * float32 keeps the scalar kernel: TF32 keeps about three digits and
//     cannot meet the float32 bar (2e-5), so there is no tensor-core product
//     for it. It serves the float32 parity checks only.
//
// bfloat16 design (FlashAttention-2 style):
//   * one block of 4 warps per (b*h, 64-row q tile); each warp owns 16 query
//     rows; q tiles run longest-causal-row first;
//   * the head dim is padded to the next multiple of 16 with zeros in shared
//     memory (a template parameter, 16..192); rows are padded by 16 bytes so
//     the 8 rows an ldmatrix phase reads fall in 8 different bank groups;
//   * q, and 64-row k and v tiles, are staged in bf16 by 16-byte cp.async
//     copies at offsets fixed at compile time (rows whose length is not a
//     multiple of 16 bytes fall back to plain loads); k and v are
//     double-buffered, the next tile in flight while this one computes; one
//     barrier per kv tile;
//   * q, k and v fragments come by ldmatrix (.trans for v) from 32-bit
//     shared addresses, a per-lane base plus compile-time offsets; q is
//     re-read per k-step rather than held in registers, which keeps two
//     (D = 128, by shared memory) to four blocks on an SM, and one at
//     D = 192 (MLA: 128,000 bytes of tiles, 96 accumulator registers);
//   * the online softmax stays in registers: scores are scaled by
//     D^-0.5 * log2(e) so that p = 2^(s - m) by ex2.approx; row max by a
//     tree over the thread's columns and quad shuffles; each thread keeps a
//     partial denominator, summed over the quad at the end; p is packed to
//     bf16 in registers as the A operand of p.v; the output is acc times the
//     reciprocal of the clamped denominator (the Pallas body divides: the two
//     differ by about an ulp of float32, far below the bf16 rounding);
//   * kv tiles that the causal or window mask hides entirely are skipped,
//     and tiles that no mask touches skip the mask;
//   * any s_q and s_kv: rows past either are zero-filled by the copies; kv
//     rows past s_kv are masked, q rows past s_q not stored.
//
// float32 design (the port's first kernel): one block of 256 threads per
// 64-row q tile, scalar float32 FMAs from shared memory, each thread 4 query
// rows x 4 score columns and 4 rows x ceil(D/16) output columns (held in
// registers sized for D <= 128, or for D <= 192 in a second instance), odd
// row strides against bank conflicts, zero-padded ragged tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int DMAX = 192;  // largest head dim: MLA's qk_nope + qk_rope
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TBQ = 64;  // query rows per block: 16 per warp
constexpr int TBK = 64;  // kv rows per tile
constexpr int TWARPS = 4;
constexpr int TTHREADS = 32 * TWARPS;

using bf16 = __nv_bfloat16;

// The first ROWS rows of a (rows_left, d) bf16 slab, src at its first row,
// into a tile of row stride 16 * KD + 8 at shared address dst (sdst as a
// pointer), columns [0, d); rows from rows_left on are zero-filled. With vec
// (d % 8 == 0, 16-byte aligned rows), 16-byte cp.async copies (the caller
// commits them): a padded row holds 2 * KD pieces, so each thread takes
// ROWS * 2 * KD / 128 pieces at offsets known at compile time, addressed by
// 32-bit offsets from the tile's base. Otherwise plain loads.
template <int KD, int ROWS>
__device__ __forceinline__ void stage_tile(uint32_t dst, bf16* sdst, const bf16* __restrict__ src,
                                           int rows_left, int d, bool vec) {
  constexpr int LD = 16 * KD + 8;
  constexpr int PER_ROW = 2 * KD;
  if (vec) {
#pragma unroll
    for (int n = 0; n < ROWS * PER_ROW / TTHREADS; ++n) {
      const int i = threadIdx.x + n * TTHREADS;
      const int r = i / PER_ROW;
      const int c = (i % PER_ROW) * 8;
      if (c < d) {
        const bool ok = r < rows_left;
        ptx::cp_async_16(dst + (uint32_t)(r * LD + c) * 2, src + (ok ? r * d + c : 0), ok ? 16 : 0);
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * d; i += TTHREADS) {
      const int r = i / d;
      const int c = i - r * d;
      sdst[r * LD + c] = r < rows_left ? src[r * d + c] : __float2bfloat16(0.f);
    }
  }
}

template <int KD>  // the head dim padded to 16 * KD
__global__ void __launch_bounds__(TTHREADS)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int s_q, int s_kv, int d,
                      int group, int causal, int window, float scale_log2, int vec) {
  constexpr int DP = 16 * KD;
  constexpr int LD = DP + 8;  // row stride in elements: 16 bytes of padding
  constexpr int NT = DP / 8;  // output n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // TBQ x LD
  bf16* sk = sq + TBQ * LD;                      // 2 x TBK x LD
  bf16* sv = sk + 2 * TBK * LD;                  // 2 x TBK x LD

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TBQ;
  const bf16* qb = q + (size_t)bh * s_q * d;
  const size_t kv_off = (size_t)(bh / group) * s_kv * d;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;

  // Zero the padding columns [d, DP) of all five tiles (laid out back to back
  // with one stride); the copies never write them.
  if (d < DP) {
    const int pad = DP - d;
    for (int i = tid; i < (TBQ + 4 * TBK) * pad; i += TTHREADS) {
      const int r = i / pad;
      sq[r * LD + d + (i - r * pad)] = __float2bfloat16(0.f);
    }
  }

  // kv positions any row of this tile can see.
  const int k_hi = causal ? min(s_kv, q0 + TBQ) : s_kv;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt0 = k_lo / TBK;
  const int nkt = (k_hi - kt0 * TBK + TBK - 1) / TBK;

  const uint32_t sq_addr = ptx::smem_addr(sq);
  const uint32_t sk_addr = ptx::smem_addr(sk);
  const uint32_t sv_addr = ptx::smem_addr(sv);
  constexpr uint32_t TILE_BYTES = TBK * LD * sizeof(bf16);
  stage_tile<KD, TBQ>(sq_addr, sq, qb + (size_t)q0 * d, s_q - q0, d, vec);
  stage_tile<KD, TBK>(sk_addr, sk, kb + (size_t)kt0 * TBK * d, s_kv - kt0 * TBK, d, vec);
  stage_tile<KD, TBK>(sv_addr, sv, vb + (size_t)kt0 * TBK * d, s_kv - kt0 * TBK, d, vec);
  ptx::cp_async_commit();

  const int g = lane >> 2;  // this thread's rows: row_a and row_a + 8
  const int tq = lane & 3;  // and columns 2*tq, 2*tq + 1 of each n-tile
  const int row_a = q0 + warp * 16 + g;
  // Each lane's ldmatrix row address at k-step 0 of the first 16 rows of
  // each tile, in bytes; the steps add compile-time offsets.
  const uint32_t q_lane = sq_addr + ((warp * 16 + (lane & 15)) * LD + ((lane >> 4) << 3)) * 2;
  const uint32_t k_lane =
      sk_addr + (((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3)) * 2;
  const uint32_t v_lane =
      sv_addr + (((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + ((lane >> 4) << 3)) * 2;

  float m[2] = {NEG_INF, NEG_INF};  // running max, in units of log2
  float l[2] = {0.f, 0.f};          // this thread's part of the denominator
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < nkt; ++it) {
    const int buf = it & 1;
    const int k0 = (kt0 + it) * TBK;
    ptx::cp_async_wait<0>();
    __syncthreads();  // tile `it` has landed; every warp is done with tile it - 1
    if (it + 1 < nkt) {
      const size_t next = (size_t)(k0 + TBK) * d;
      stage_tile<KD, TBK>(sk_addr + (buf ^ 1) * TILE_BYTES, sk + (buf ^ 1) * TBK * LD, kb + next,
                          s_kv - k0 - TBK, d, vec);
      stage_tile<KD, TBK>(sv_addr + (buf ^ 1) * TILE_BYTES, sv + (buf ^ 1) * TBK * LD, vb + next,
                          s_kv - k0 - TBK, d, vec);
      ptx::cp_async_commit();
    }
    const uint32_t kb_lane = k_lane + buf * TILE_BYTES;
    const uint32_t vb_lane = v_lane + buf * TILE_BYTES;

    // scores: this warp's 16 rows x 64 kv columns, 8 n-tiles; the q fragment
    // of each k-step is re-read from shared memory (fewer registers, more
    // blocks per SM, than holding all of q)
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qf[4];
      ptx::ldmatrix_x4(qf, q_lane + kd * 32);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ptx::ldmatrix_x4(b, kb_lane + (jp * 16 * LD + kd * 16) * 2);
        ptx::mma_bf16_16816(sc[2 * jp], qf, b[0], b[1]);
        ptx::mma_bf16_16816(sc[2 * jp + 1], qf, b[2], b[3]);
      }
    }

    // scale, mask, online softmax
    const bool need_mask = k0 + TBK > s_kv || (causal && k0 + TBK - 1 > q0) ||
                           (window > 0 && k0 <= q0 + TBQ - 1 - window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale_log2;
        if (need_mask) {
          const int kp = k0 + j * 8 + tq * 2 + (e & 1);
          const int qp = row_a + (e >> 1) * 8;
          const bool ok = kp < s_kv && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
          x = ok ? x : NEG_INF;
        }
        sc[j][e] = x;
      }
    }
    // row max over this thread's 16 columns as a tree, then over the quad
    float mx[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float t4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        t4[j] = fmaxf(fmaxf(sc[2 * j][2 * i], sc[2 * j][2 * i + 1]),
                      fmaxf(sc[2 * j + 1][2 * i], sc[2 * j + 1][2 * i + 1]));
      mx[i] = fmaxf(fmaxf(fmaxf(t4[0], t4[1]), fmaxf(t4[2], t4[3])), m[i]);
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = ptx::ex2(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[j][e];
        const float p = x == NEG_INF ? 0.f : ptx::ex2(x - m[e >> 1]);
        sc[j][e] = p;
        l[e >> 1] += p;
      }
    }

    // acc += p v: p (rounded to bf16) is the A operand, 4 k-steps of 16 kv rows
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          ptx::pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          ptx::pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          ptx::pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          ptx::pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]),
      };
#pragma unroll
      for (int np = 0; np < KD; ++np) {
        uint32_t b[4];
        ptx::ldmatrix_x4_trans(b, vb_lane + (kk * 16 * LD + np * 16) * 2);
        ptx::mma_bf16_16816(acc[2 * np], pa, b[0], b[1]);
        ptx::mma_bf16_16816(acc[2 * np + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qp = row_a + i * 8;
    if (qp >= s_q) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);  // one division per row
    bf16* orow = o + ((size_t)bh * s_q + qp) * d;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + tq * 2;
      const float x0 = acc[n][2 * i] * inv;
      const float x1 = acc[n][2 * i + 1] * inv;
      if ((d & 1) == 0 && col + 1 < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < d) orow[col] = __float2bfloat16(x0);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int KD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int bh, int s_q, int s_kv,
                int d, int group, int causal, int window, float scale, int vec,
                cudaStream_t stream) {
  const size_t smem = (size_t)(TBQ + 4 * TBK) * (16 * KD + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<KD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_q + TBQ - 1) / TBQ, bh);
  flash_fwd_bf16_kernel<KD><<<grid, TTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), s_q, s_kv, d, group, causal, window, scale * LOG2E, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int TR = BQ / 16;   // query rows per thread
constexpr int TC = BK / 16;   // score columns per thread
constexpr int PS = BK + 16;   // row stride of the probability tile

// Copy rows [row0, row0 + BK) of a (S, D) slab into shared memory, zero past
// the last row.
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int rows,
                                          int valid_rows, int d, int ds) {
  for (int i = threadIdx.x; i < rows * d; i += THREADS) {
    const int r = i / d;
    const int c = i - r * d;
    dst[r * ds + c] = r < valid_rows ? src[i] : 0.f;
  }
}

template <int DC>  // output columns per thread: D <= 16 * DC
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int s_q, int s_kv, int d,
                     int group, int causal, int window, float scale) {
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
  const size_t kv_off = (size_t)(bh / group) * s_kv * d;

  load_tile(sq, q + ((size_t)bh * s_q + q0) * d, BQ, min(BQ, s_q - q0), d, ds);

  float m[TR], l[TR], acc[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  // kv positions any row of this tile can see.
  const int k_hi = causal ? min(s_kv, q0 + BQ) : s_kv;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int nd = (d + 15) / 16;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    const int krows = min(BK, s_kv - k0);
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
        ok[j] = kp < s_kv && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
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
    if (qp >= s_q) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + ((size_t)bh * s_q + qp) * d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (c < nd && col < d) orow[col] = acc[i][c] / denom;
    }
  }
}

template <int DC>
int launch_f32(const void* q, const void* k, const void* v, void* o, int bh, int s_q, int s_kv,
               int d, int group, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = ((size_t)(BQ + 2 * BK) * (d | 1) + (size_t)BQ * PS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<DC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_q + BQ - 1) / BQ, bh);
  flash_fwd_f32_kernel<DC><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), s_q, s_kv, d, group, causal, window, scale);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// q, o: (bh, s_q, d); k, v: (bh / group, s_kv, d); all contiguous on one device.
// causal and window need s_q == s_kv. dtype: 0 = float32 (scalar kernel),
// 1 = bfloat16 (tensor cores). Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int bh, int s_q, int s_kv, int d, int group, int causal,
                                   int window, float scale, int dtype, void* stream) {
  if (d < 1 || d > DMAX || s_q < 1 || s_kv < 1 || bh < 1 || group < 1 || bh % group != 0 ||
      ((causal || window > 0) && s_q != s_kv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (d <= 128)
      return launch_f32<8>(q, k, v, o, bh, s_q, s_kv, d, group, causal, window, scale, st);
    return launch_f32<12>(q, k, v, o, bh, s_q, s_kv, d, group, causal, window, scale, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
#define FLASH_BF16(KD) \
  launch_bf16<KD>(q, k, v, o, bh, s_q, s_kv, d, group, causal, window, scale, vec, st)
  switch ((d + 15) / 16) {
    case 1: return FLASH_BF16(1);
    case 2: return FLASH_BF16(2);
    case 3: return FLASH_BF16(3);
    case 4: return FLASH_BF16(4);
    case 5: return FLASH_BF16(5);
    case 6: return FLASH_BF16(6);
    case 7: return FLASH_BF16(7);
    case 8: return FLASH_BF16(8);
    case 9: return FLASH_BF16(9);
    case 10: return FLASH_BF16(10);
    case 11: return FLASH_BF16(11);
    default: return FLASH_BF16(12);
  }
#undef FLASH_BF16
}
