// RWKV-6 chunked WKV forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6.py::_wkv_kernel
// (launched by rwkv6_chunked_bh). For one (batch*head) row it computes
//   out_t = r_t (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T,
// chunk by chunk, with the Pallas body's log-space numerics (w_t = exp(logw_t)):
//   cum = cumsum(logw) within the chunk, cum_prev = cum - logw;
//   A[t,s] = sum_k r[t,k] k[s,k] exp(cum_prev[t,k] - cum[s,k])   for s < t
//            (every exponent is <= 0, so nothing can overflow);
//   A[t,t] = sum_k r[t,k] u[k] k[t,k]                               (the bonus);
//   out[t] = sum_{s<=t} A[t,s] v[s] + (r[t] * exp(cum_prev[t])) S;
//   S'     = diag(exp(cum[C-1])) S + sum_s (k[s] * exp(cum[C-1] - cum[s])) v[s]^T.
// Everything is float32; the final state is returned beside the output.
//
// What bounds it on an H100. Each input is read once and each output
// written once: at B=4, T=2048, H=64, K=V=64 that is ~680 MB (~0.20 ms at
// 3.35 TB/s) against ~1.3e10 float32 operations (~0.19 ms at 67 TFLOP/s
// without tensor cores), so bytes and operations bound it about equally.
// Neither is what limits this first design: the chunks of one row run in
// order, and each chunk waits on its loads and five block barriers.
//
// Design (simple and right first; pipelining the loads and tensor cores
// are for a later change):
//   * one block of 256 threads per (b*h) row; the TPU grid's sequential
//     chunk axis becomes a loop inside the block, with the K x V float32
//     state in shared memory for the whole sequence;
//   * per chunk, r, k, logw and v are staged in shared memory; one thread
//     per channel takes the prefix sums of logw;
//   * the pairwise decay exp(cum_prev[t,k] - cum[s,k]) is computed on the
//     fly inside the score sum, so the (C, C, K) ratio tensor (256 KB at
//     C=32, K=64, more than a block's 227 KB) never exists;
//   * rows of the (C, K) tiles have an odd stride (K | 1), so the 32
//     threads of a warp that read 32 different rows hit 32 banks;
//   * about 77 KB of dynamic shared memory at C=32, K=V=64: two blocks per
//     SM, and the 256 rows of the B=4, H=64 case fit in one wave.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DIM = 64;    // largest K and V
constexpr int MAX_CHUNK = 32;  // largest chunk

size_t smem_floats(int chunk, int dk, int dv) {
  const int ks = dk | 1;
  return (size_t)6 * chunk * ks + (size_t)chunk * dv + (size_t)chunk * chunk +
         (size_t)dk * dv + 2 * (size_t)dk;
}

__global__ void __launch_bounds__(THREADS)
wkv6_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ out, float* __restrict__ s_final, int t_len, int dk,
                int dv, int chunk) {
  extern __shared__ float smem[];
  const int ks = dk | 1;  // odd row stride of the (C, K) tiles
  float* sr = smem;               // r                       C x ks
  float* sk = sr + chunk * ks;    // k                       C x ks
  float* scp = sk + chunk * ks;   // logw, then cum_prev     C x ks
  float* scum = scp + chunk * ks; // cum                     C x ks
  float* srw = scum + chunk * ks; // r * exp(cum_prev)       C x ks
  float* skt = srw + chunk * ks;  // k * exp(cum_C - cum)    C x ks
  float* sv = skt + chunk * ks;   // v                       C x dv
  float* sa = sv + chunk * dv;    // scores A                C x C
  float* ss = sa + chunk * chunk; // state S                 dk x dv
  float* su = ss + dk * dv;       // u                       dk
  float* sdecay = su + dk;        // exp(cum_C)              dk

  const size_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* rb = r + row * t_len * dk;
  const float* kb = k + row * t_len * dk;
  const float* wb = logw + row * t_len * dk;
  const float* vb = v + row * t_len * dv;
  float* ob = out + row * t_len * dv;

  for (int i = tid; i < dk * dv; i += THREADS) ss[i] = s0[row * dk * dv + i];
  for (int i = tid; i < dk; i += THREADS) su[i] = u[row * dk + i];

  for (int t0 = 0; t0 < t_len; t0 += chunk) {
    // 1. Stage the chunk (the barrier that ends the previous chunk orders
    //    these writes after its reads).
    for (int i = tid; i < chunk * dk; i += THREADS) {
      const int t = i / dk, c = i - t * dk;
      const size_t g = (size_t)(t0 + t) * dk + c;
      sr[t * ks + c] = rb[g];
      sk[t * ks + c] = kb[g];
      scp[t * ks + c] = wb[g];
    }
    for (int i = tid; i < chunk * dv; i += THREADS) sv[i] = vb[(size_t)t0 * dv + i];
    __syncthreads();

    // 2. Prefix sums of logw, one thread per channel.
    for (int c = tid; c < dk; c += THREADS) {
      float run = 0.f;
      for (int t = 0; t < chunk; ++t) {
        const float lw = scp[t * ks + c];
        run += lw;
        scum[t * ks + c] = run;
        scp[t * ks + c] = run - lw;
      }
      sdecay[c] = expf(run);
    }
    __syncthreads();

    // 3. Scores with the bonus on the diagonal; r and k weighted for the
    //    cross-chunk output and the state update.
    for (int i = tid; i < chunk * chunk; i += THREADS) {
      const int t = i / chunk, s = i - t * chunk;
      const float* rt = sr + t * ks;
      float acc = 0.f;
      if (s < t) {
        const float* kr = sk + s * ks;
        const float* cpt = scp + t * ks;
        const float* cms = scum + s * ks;
        for (int c = 0; c < dk; ++c) acc += rt[c] * kr[c] * expf(cpt[c] - cms[c]);
      } else if (s == t) {
        const float* kt = sk + t * ks;
        for (int c = 0; c < dk; ++c) acc += rt[c] * su[c] * kt[c];
      }
      sa[i] = acc;
    }
    const float* cum_last = scum + (chunk - 1) * ks;
    for (int i = tid; i < chunk * dk; i += THREADS) {
      const int t = i / dk, c = i - t * dk;
      const int j = t * ks + c;
      srw[j] = sr[j] * expf(scp[j]);
      skt[j] = sk[j] * expf(cum_last[c] - scum[j]);
    }
    __syncthreads();

    // 4. Output: intra-chunk scores times v, plus the incoming state.
    for (int i = tid; i < chunk * dv; i += THREADS) {
      const int t = i / dv, j = i - t * dv;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc += sa[t * chunk + s] * sv[s * dv + j];
      const float* rwt = srw + t * ks;
      for (int c = 0; c < dk; ++c) acc += rwt[c] * ss[c * dv + j];
      ob[(size_t)(t0 + t) * dv + j] = acc;
    }
    __syncthreads();

    // 5. State update; each thread owns its elements of S.
    for (int i = tid; i < dk * dv; i += THREADS) {
      const int c = i / dv, j = i - c * dv;
      float acc = sdecay[c] * ss[i];
      for (int s = 0; s < chunk; ++s) acc += skt[s * ks + c] * sv[s * dv + j];
      ss[i] = acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < dk * dv; i += THREADS) s_final[row * dk * dv + i] = ss[i];
}

}  // namespace

// r, k, logw: (bh, t, dk); v, out: (bh, t, dv); u: (bh, dk); s0, s_final:
// (bh, dk, dv); all float32, contiguous, on one device. Needs dk, dv <= 64,
// 1 <= chunk <= 32 and t % chunk == 0. Returns a cudaError_t (0 on success).
extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v, const void* logw,
                             const void* u, const void* s0, void* out, void* s_final, int bh,
                             int t, int dk, int dv, int chunk, void* stream) {
  if (bh < 1 || t < 1 || dk < 1 || dk > MAX_DIM || dv < 1 || dv > MAX_DIM || chunk < 1 ||
      chunk > MAX_CHUNK || t % chunk != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(chunk, dk, dv) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(wkv6_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_fwd_kernel<<<bh, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(logw), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(out), static_cast<float*>(s_final), t,
      dk, dv, chunk);
  return (int)cudaGetLastError();
}
