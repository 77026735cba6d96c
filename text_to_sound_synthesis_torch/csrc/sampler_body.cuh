// The per-row body of the fused reverse-diffusion sampler step, shared by
// K1 (fused_sampler.cu) and K2 (fused_head_sample.cu).
//
// One warp owns one row; lane `lane` holds classes c = 32*j + lane, j < NJ.
// Given the row's raw logits (c < km1; -inf elsewhere), it
//   1. takes the log-softmax over the K-1 real classes, sets the MASK column
//      (index K-1) to -70 and clips to [-70, 0];
//   2. optionally keeps the top-r nucleus: a 24-step bisection on a
//      probability threshold tau (keep p > tau, plus the argmax), no sort;
//   3. rebuilds the mask-aware posterior q(x_{t-1} | x_t, x0) from the token
//      index x_t and the 10 step coefficients (StepCoeffs order);
//   4. Gumbel-argmax -> the next token; optionally writes the posterior.
//
// Random numbers: Philox4x32-10 keyed on (seed_base, step) as two words, so
// base + step never collides along a (step, block) diagonal. The uniform of
// column c of `row` is word (c/32)%4 of Philox(counter = (row, c%32,
// (c/32)/4, 0)), u = (bits >> 8) * 2^-24, g = -log(-log(u + 1e-30) + 1e-30).
// A caller may supply a (rows, K) f32 Gumbel tensor in place of the draws.
//
// Needs IEEE logf/expf: compile without --use_fast_math (the -70 clamps and
// the log(1e-30) placeholders sit at the edge of the f32 range).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace t2s_sampler {

constexpr int kBisectIters = 24;
constexpr float kMinLogp = -70.0f;
constexpr float kLogEps = -69.07755278982137f;  // log(1e-30)
constexpr unsigned kFull = 0xffffffffu;

struct Coeffs {
  float log_at, log_bt, log_ct, log_cum_at, log_cum_bt, log_cum_ct,
        log_cum_at_prev, log_cum_bt_prev, log_cum_ct_prev, log_1_min_cum_ct_prev;
};

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

// a Philox key word: the host's value, or the int32 at ptr on the device
__device__ __forceinline__ uint32_t key_word(uint32_t host, const int* ptr) {
  return ptr != nullptr ? static_cast<uint32_t>(*ptr) : host;
}

__device__ __forceinline__ float gumbel_from_bits(uint32_t bits) {
  const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
  return -logf(-logf(u + 1e-30f) + 1e-30f);
}

// The top-r threshold of a row whose lane holds p[j] = p of class 32 j +
// lane (0 outside the real classes, c >= km1): the hi of the 24-step
// bisection of [0, 1] (mid = (lo + hi) / 2; f(mid) < r ? hi = mid : lo =
// mid), f(g) = warp_sum over lanes of (sum over j ascending of the p[j] >
// g). Every bound is a multiple of 2^-24, exact in f32, and hi - lo = 2 w
// with w = 2^-(round + 1), so mid = lo + w and hi = lo + w at the end; f is
// non-increasing in g, so hi is the least m 2^-24 (m >= 1) with f(m 2^-24)
// < r. A search of 2^k-ary rounds finds the same hi in 24 / k rounds, but
// each round takes 2^k - 1 warp sums, and at 16 warps an SM the sums'
// shuffles, not the rounds' latency, set the pace: the 8-ary search
// measured K1 18.5 against 14.8 us, K2 40.8 against 37.1 us on an H100
// (PERF.md). Adding p[j] only where p[j] > mid gives the same sums as adding
// 0 elsewhere; a chunk j past the real classes holds only zeros: it is
// skipped.
template <int NJ>
__device__ __forceinline__ float search_threshold(const float (&p)[NJ], float r, int km1) {
  float lo = 0.0f, w = 1.0f;
#pragma unroll 1
  for (int it = 0; it < kBisectIters; ++it) {
    w *= 0.5f;
    const float mid = lo + w;
    float above = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (32 * j < km1 && p[j] > mid) above += p[j];   // 32 j < km1: warp-uniform
    lo += warp_sum(above) < r ? 0.0f : w;
  }
  return lo + w;
}

// lp: the row's raw logits in, clobbered. x: the row's current token.
// Writes out_tokens[row] (lane 0) and, when out_post != nullptr, the row's
// K posterior log-probs.
template <int NJ>
__device__ __forceinline__ void sample_row(float (&lp)[NJ], int row, int lane, int x,
                                           const Coeffs& c, int km1, float r,
                                           uint32_t seed, uint32_t step,
                                           const float* __restrict__ gumbel,
                                           int* __restrict__ out_tokens,
                                           float* __restrict__ out_post) {
  const int K = km1 + 1;

  // 1. log-softmax over the real classes, MASK column -> -70, clip.
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < NJ; ++j) m = fmaxf(m, lp[j]);
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
    const float hi = search_threshold<NJ>(p, r, km1);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j * 32 + lane < km1 && !(p[j] > hi || lp[j] == amax)) lp[j] = kMinLogp;
    }
  }

  // 3. mask-aware posterior from the token index. A real class's log q(x_t |
  // .) terms are log_add_exp(onehot + a, b), onehot 0 at the token and
  // log(1e-30) elsewhere: two values a step, taken once here (the same floats
  // as taking them per class).
  const bool state_is_mask = x == km1;
  const float qt_hit = log_add_exp(0.0f + c.log_cum_at, c.log_cum_bt);
  const float qt_miss = log_add_exp(kLogEps + c.log_cum_at, c.log_cum_bt);
  const float qt1_hit = log_add_exp(0.0f + c.log_at, c.log_bt);
  const float qt1_miss = log_add_exp(kLogEps + c.log_at, c.log_bt);
  float q[NJ], qt1[NJ];
  float qm = -INFINITY;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = j * 32 + lane;
    if (col >= K) { q[j] = -INFINITY; qt1[j] = 0.0f; continue; }
    float log_qt, log_qt1;
    if (col < km1) {
      log_qt = state_is_mask ? c.log_cum_ct : (col == x ? qt_hit : qt_miss);
      log_qt1 = state_is_mask ? c.log_ct : (col == x ? qt1_hit : qt1_miss);
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

}  // namespace t2s_sampler
