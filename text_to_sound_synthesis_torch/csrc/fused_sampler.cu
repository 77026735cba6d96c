// Fused reverse-diffusion sampler step (K1) for Hopper, sm_90a.
//
// Replaces text_to_sound_synthesis_tpu/ops/fused_sampler.py::fused_p_sample
// (Pallas TPU kernel: _sampler_body / _kernel). The plain PyTorch twin is
// text_to_sound_synthesis_torch/ops/fused_sampler.py::p_sample_from_indices.
//
// Per row of the (rows = B*L, K-1) denoiser logits, in one pass:
//   1. log-softmax over the K-1 real classes; MASK column (index K-1) -> -70;
//      clip to [-70, 0];
//   2. optional top-r nucleus: 24-step bisection on a probability threshold
//      tau (keep p > tau, plus the argmax) -- no sort;
//   3. the mask-aware posterior q(x_{t-1} | x_t, x0) rebuilt from the token
//      index x_t and the 10 step coefficients (StepCoeffs order);
//   4. Gumbel-argmax -> next token; optionally the posterior log-probs.
//
// What bounds it on an H100: at the flagship shape (2120 rows x 256 classes)
// it reads ~1.1 MB of bf16 logits and writes 8.5 KB of tokens, well under a
// microsecond of HBM traffic at 3.35 TB/s, and a few hundred FLOPs per element.
// The kernel is bound by launch latency. The design's answer is one launch,
// one pass over the logits, nothing written but the tokens: the logits stay
// in registers (one warp per row, 8 classes per lane), every reduction is a
// warp shuffle, and no shared memory or second pass is used.
//
// Random numbers: counter-based Philox4x32-10. The key is (seed_base, step) as
// TWO separate words -- a single word seed_base + step would collide along
// the (step, block) diagonals when a caller passes base + step index (the TPU
// kernel's rule, fused_sampler.py:213-215). The uniform of column c of row
// `row` is word (c/32)%4 of Philox(counter = (row, c%32, (c/32)/4, 0)); it is
// u = (bits >> 8) * 2^-24, and g = -log(-log(u + 1e-30) + 1e-30).
// A caller may instead supply a (rows, K) f32 Gumbel tensor (tests, checks).
//
// Built without --use_fast_math: the -70 clamps and the log(1e-30)
// placeholders sit at the edge of the f32 range.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // rows (warps) per block
constexpr int kBisectIters = 24;
constexpr float kMinLogp = -70.0f;
constexpr float kLogEps = -69.07755278982137f;  // log(1e-30)
constexpr unsigned kFull = 0xffffffffu;

struct Coeffs {
  float log_at, log_bt, log_ct, log_cum_at, log_cum_bt, log_cum_ct,
        log_cum_at_prev, log_cum_bt_prev, log_cum_ct_prev, log_1_min_cum_ct_prev;
};

__device__ __forceinline__ float load_logit(const float* p) { return *p; }
__device__ __forceinline__ float load_logit(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Xor-butterfly sum: every lane combines the same operand pairs, and float
// addition is commutative, so all lanes end with bit-identical totals (the
// bisection's branch is therefore uniform across the warp).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Argmax with ties broken to the lowest index, as torch.argmax / jnp.argmax.
__device__ __forceinline__ void warp_argmax(float& v, int& idx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, idx, o);
    if (ov > v || (ov == v && oi < idx)) { v = ov; idx = oi; }
  }
}

__device__ __forceinline__ float log_add_exp(float a, float b) {
  const float m = fmaxf(a, b);
  const float ms = isfinite(m) ? m : 0.0f;
  return ms + logf(expf(a - ms) + expf(b - ms));
}

__device__ __forceinline__ float clip_logp(float v) {
  return fminf(fmaxf(v, kMinLogp), 0.0f);
}

// Philox4x32-10 (Salmon et al., SC'11), the Random123 constants.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float gumbel_from_bits(uint32_t bits) {
  const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
  return -logf(-logf(u + 1e-30f) + 1e-30f);
}

// NJ = classes held per lane (column c = j*32 + lane, j < NJ); NJ*32 >= K.
template <int NJ, typename T>
__global__ void __launch_bounds__(kWarps * 32)
fused_p_sample_kernel(const T* __restrict__ logits, const int* __restrict__ xt,
                      const float* __restrict__ coef, const float* __restrict__ gumbel,
                      int* __restrict__ out_tokens, float* __restrict__ out_post,
                      int rows, int km1, float r, uint32_t seed, uint32_t step) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform per warp: whole warps leave together
  const int K = km1 + 1;
  const Coeffs c = *reinterpret_cast<const Coeffs*>(coef);
  const T* lrow = logits + static_cast<size_t>(row) * km1;

  // 1. log-softmax over the real classes, MASK column -> -70, clip.
  float lp[NJ];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = j * 32 + lane;
    lp[j] = col < km1 ? load_logit(lrow + col) : -INFINITY;
    m = fmaxf(m, lp[j]);
  }
  m = warp_max(m);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (j * 32 + lane < km1) s += expf(lp[j] - m);
  const float lse = m + logf(warp_sum(s));
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = j * 32 + lane;
    lp[j] = col < km1 ? clip_logp(lp[j] - lse) : (col == km1 ? kMinLogp : -INFINITY);
  }

  // 2. top-r truncation by bisection on the probability threshold.
  if (r > 0.0f) {
    float p[NJ];
    float amax = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const bool valid = j * 32 + lane < km1;
      p[j] = valid ? expf(lp[j]) : 0.0f;
      if (valid) amax = fmaxf(amax, lp[j]);
    }
    amax = warp_max(amax);
    float lo = 0.0f, hi = 1.0f;
    for (int it = 0; it < kBisectIters; ++it) {
      const float mid = 0.5f * (lo + hi);
      float above = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) above += p[j] > mid ? p[j] : 0.0f;
      if (warp_sum(above) < r) hi = mid; else lo = mid;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j * 32 + lane < km1 && !(p[j] > hi || lp[j] == amax)) lp[j] = kMinLogp;
    }
  }

  // 3. mask-aware posterior from the token index.
  const int x = xt[row];
  const bool state_is_mask = x == km1;
  float q[NJ], qt1[NJ];
  float qm = -INFINITY;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = j * 32 + lane;
    if (col >= K) { q[j] = -INFINITY; qt1[j] = 0.0f; continue; }
    float log_qt, log_qt1;
    if (col < km1) {
      const float onehot = col == x ? 0.0f : kLogEps;
      log_qt = state_is_mask ? c.log_cum_ct : log_add_exp(onehot + c.log_cum_at, c.log_cum_bt);
      log_qt1 = state_is_mask ? c.log_ct : log_add_exp(onehot + c.log_at, c.log_bt);
    } else {
      log_qt = state_is_mask ? 0.0f : kLogEps;
      log_qt1 = log_qt;
    }
    q[j] = lp[j] - log_qt;
    qt1[j] = log_qt1;
    qm = fmaxf(qm, q[j]);
  }
  qm = warp_max(qm);
  float qs = 0.0f;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (j * 32 + lane < K) qs += expf(q[j] - qm);
  const float qlse = qm + logf(warp_sum(qs));

  // 4. Gumbel-argmax over the K classes.
  const uint2 key = make_uint2(seed, step);
  float best = -INFINITY;
  int best_idx = 0x7fffffff;
  uint4 bits = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = j * 32 + lane;
    if (gumbel == nullptr && (j & 3) == 0 && j * 32 < K)
      bits = philox4x32_10(make_uint4(static_cast<uint32_t>(row), static_cast<uint32_t>(lane),
                                      static_cast<uint32_t>(j >> 2), 0u), key);
    if (col >= K) continue;
    const float qn = q[j] - qlse;
    const float prev = col < km1 ? log_add_exp(qn + c.log_cum_at_prev, c.log_cum_bt_prev)
                                 : log_add_exp(qn + c.log_1_min_cum_ct_prev, c.log_cum_ct_prev);
    const float post = clip_logp(prev + qt1[j] + qlse);
    if (out_post != nullptr) out_post[static_cast<size_t>(row) * K + col] = post;
    float g;
    if (gumbel != nullptr) {
      g = gumbel[static_cast<size_t>(row) * K + col];
    } else {
      const uint32_t w = (j & 3) == 0 ? bits.x : (j & 3) == 1 ? bits.y : (j & 3) == 2 ? bits.z : bits.w;
      g = gumbel_from_bits(w);
    }
    const float score = post + g;
    if (score > best) { best = score; best_idx = col; }  // cols rise with j: keeps lowest on ties
  }
  warp_argmax(best, best_idx);
  if (lane == 0) out_tokens[row] = best_idx;
}

template <int NJ>
void launch(const void* logits, bool bf16, const int* xt, const float* coef,
            const float* gumbel, int* out_tokens, float* out_post, int rows, int km1,
            float r, uint32_t seed, uint32_t step, cudaStream_t stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps), block(kWarps * 32);
  if (bf16)
    fused_p_sample_kernel<NJ, __nv_bfloat16><<<grid, block, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(logits), xt, coef, gumbel, out_tokens, out_post,
        rows, km1, r, seed, step);
  else
    fused_p_sample_kernel<NJ, float><<<grid, block, 0, stream>>>(
        static_cast<const float*>(logits), xt, coef, gumbel, out_tokens, out_post,
        rows, km1, r, seed, step);
}

}  // namespace

// Largest K (classes incl. MASK) the kernel takes: 65 classes per lane.
extern "C" int t2s_fused_p_sample_max_classes() { return 65 * 32; }

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// logits (rows, km1) bf16 or f32; xt (rows,) int32; coef (10,) f32;
// gumbel (rows, km1+1) f32 or NULL; out_tokens (rows,) int32;
// out_post (rows, km1+1) f32 or NULL.
extern "C" int t2s_fused_p_sample(const void* logits, int logits_bf16, const void* xt,
                                  const void* coef, const void* gumbel, void* out_tokens,
                                  void* out_post, int rows, int km1, float r,
                                  unsigned int seed, unsigned int step, void* stream) {
  const int K = km1 + 1;
  const int* xt_i = static_cast<const int*>(xt);
  const float* coef_f = static_cast<const float*>(coef);
  const float* g = static_cast<const float*>(gumbel);
  int* out_t = static_cast<int*>(out_tokens);
  float* out_p = static_cast<float*>(out_post);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || km1 <= 0 || K > 65 * 32) return static_cast<int>(cudaErrorInvalidValue);
  if (K <= 9 * 32)
    launch<9>(logits, logits_bf16 != 0, xt_i, coef_f, g, out_t, out_p, rows, km1, r, seed, step, s);
  else if (K <= 17 * 32)
    launch<17>(logits, logits_bf16 != 0, xt_i, coef_f, g, out_t, out_p, rows, km1, r, seed, step, s);
  else if (K <= 33 * 32)
    launch<33>(logits, logits_bf16 != 0, xt_i, coef_f, g, out_t, out_p, rows, km1, r, seed, step, s);
  else
    launch<65>(logits, logits_bf16 != 0, xt_i, coef_f, g, out_t, out_p, rows, km1, r, seed, step, s);
  return static_cast<int>(cudaGetLastError());
}
