// Fused reverse-diffusion sampler step (K1) for Hopper, sm_90a.
//
// Replaces text_to_sound_synthesis_tpu/ops/fused_sampler.py::fused_p_sample
// (Pallas TPU kernel: _sampler_body / _kernel). The plain PyTorch twin is
// text_to_sound_synthesis_torch/ops/fused_sampler.py::p_sample_from_indices.
//
// Per row of the (rows = B*L, K-1) denoiser logits, in one pass:
//   1. log-softmax over the K-1 real classes; MASK column (index K-1) -> -70;
//      clip to [-70, 0];
//   2. optional top-r nucleus: the probability threshold tau (keep p > tau,
//      plus the argmax) of the TPU kernel's 24-step bisection -- no sort;
//   3. the mask-aware posterior q(x_{t-1} | x_t, x0) rebuilt from the token
//      index x_t and the 10 step coefficients (StepCoeffs order);
//   4. Gumbel-argmax -> next token; optionally the posterior log-probs.
//
// What bounds it on an H100: at the flagship shape (2120 rows x 256 classes)
// it reads ~1.1 MB of bf16 logits and writes 8.5 KB of tokens, well under a
// microsecond of HBM traffic at 3.35 TB/s, and a few hundred FLOPs per element.
// What sets its pace is the rows' arithmetic: ~16 f32 operations and 8
// transcendentals per (row, class), 24 warp sums for the threshold, and six
// more warp reductions a row; at 16 rows (warps) an SM the schedulers and
// the shuffles stay busy, so fewer operations, not a shorter chain, make it
// faster (r = 0, no threshold: 9.3 us; r = 0.85: 14.7 us, PERF.md). The
// design: one launch, one pass over the logits, nothing written but the
// tokens; the logits stay in registers (one warp per row, 9 classes per
// lane), every reduction is a warp shuffle; a row's four log q(x_t | .)
// terms are taken once, not per class; 4-warp blocks spread the 2120 rows
// more evenly over the SMs than 265 blocks of 8 warps do (14.7 against 16.2
// us).
//
// The row body (steps 1-4) lives in sampler_body.cuh, shared with K2.
//
// Random numbers: counter-based Philox4x32-10. The key is (seed_base, step) as
// TWO separate words -- a single word seed_base + step would collide along
// the (step, block) diagonals when a caller passes base + step index (the TPU
// kernel's rule, fused_sampler.py:213-215). The uniform of column c of row
// `row` is word (c/32)%4 of Philox(counter = (row, c%32, (c/32)/4, 0)); it is
// u = (bits >> 8) * 2^-24, and g = -log(-log(u + 1e-30) + 1e-30).
// A caller may instead supply a (rows, K) f32 Gumbel tensor (tests, checks).
// seed_base and step come as host values or, as the TPU kernel's seed does,
// from device memory (one int32 each), so a CUDA graph can replay a step.
//
// Built without --use_fast_math: the -70 clamps and the log(1e-30)
// placeholders sit at the edge of the f32 range.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sampler_body.cuh"

namespace {

using namespace t2s_sampler;

constexpr int kWarps = 4;                 // rows (warps) per block

__device__ __forceinline__ float load_logit(const float* p) { return *p; }
__device__ __forceinline__ float load_logit(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// NJ = classes held per lane (column c = j*32 + lane, j < NJ); NJ*32 >= K.
template <int NJ, typename T>
__global__ void __launch_bounds__(kWarps * 32)
fused_p_sample_kernel(const T* __restrict__ logits, const int* __restrict__ xt,
                      const float* __restrict__ coef, const float* __restrict__ gumbel,
                      int* __restrict__ out_tokens, float* __restrict__ out_post,
                      int rows, int km1, float r, uint32_t seed, uint32_t step,
                      const int* __restrict__ seed_ptr, const int* __restrict__ step_ptr) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform per warp: whole warps leave together
  const Coeffs c = *reinterpret_cast<const Coeffs*>(coef);
  const T* lrow = logits + static_cast<size_t>(row) * km1;
  float lp[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = j * 32 + lane;
    lp[j] = col < km1 ? load_logit(lrow + col) : -INFINITY;
  }
  sample_row<NJ>(lp, row, lane, xt[row], c, km1, r, key_word(seed, seed_ptr),
                 key_word(step, step_ptr), gumbel, out_tokens, out_post);
}

template <int NJ>
void launch(const void* logits, bool bf16, const int* xt, const float* coef,
            const float* gumbel, int* out_tokens, float* out_post, int rows, int km1,
            float r, uint32_t seed, uint32_t step, const int* seed_ptr, const int* step_ptr,
            cudaStream_t stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps), block(kWarps * 32);
  if (bf16)
    fused_p_sample_kernel<NJ, __nv_bfloat16><<<grid, block, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(logits), xt, coef, gumbel, out_tokens, out_post,
        rows, km1, r, seed, step, seed_ptr, step_ptr);
  else
    fused_p_sample_kernel<NJ, float><<<grid, block, 0, stream>>>(
        static_cast<const float*>(logits), xt, coef, gumbel, out_tokens, out_post,
        rows, km1, r, seed, step, seed_ptr, step_ptr);
}

}  // namespace

// Largest K (classes incl. MASK) the kernel takes: 65 classes per lane.
extern "C" int t2s_fused_p_sample_max_classes() { return 65 * 32; }

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// logits (rows, km1) bf16 or f32; xt (rows,) int32; coef (10,) f32;
// gumbel (rows, km1+1) f32 or NULL; out_tokens (rows,) int32;
// out_post (rows, km1+1) f32 or NULL; seed_ptr / step_ptr one int32 on the
// device in place of seed / step, or NULL.
extern "C" int t2s_fused_p_sample(const void* logits, int logits_bf16, const void* xt,
                                  const void* coef, const void* gumbel, void* out_tokens,
                                  void* out_post, int rows, int km1, float r,
                                  unsigned int seed, unsigned int step, const void* seed_ptr,
                                  const void* step_ptr, void* stream) {
  const int K = km1 + 1;
  const int* xt_i = static_cast<const int*>(xt);
  const float* coef_f = static_cast<const float*>(coef);
  const float* g = static_cast<const float*>(gumbel);
  int* out_t = static_cast<int*>(out_tokens);
  float* out_p = static_cast<float*>(out_post);
  const int* sp = static_cast<const int*>(seed_ptr);
  const int* tp = static_cast<const int*>(step_ptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || km1 <= 0 || K > 65 * 32) return static_cast<int>(cudaErrorInvalidValue);
  if (K <= 9 * 32)
    launch<9>(logits, logits_bf16 != 0, xt_i, coef_f, g, out_t, out_p, rows, km1, r, seed, step,
               sp, tp, s);
  else if (K <= 17 * 32)
    launch<17>(logits, logits_bf16 != 0, xt_i, coef_f, g, out_t, out_p, rows, km1, r, seed, step,
               sp, tp, s);
  else if (K <= 33 * 32)
    launch<33>(logits, logits_bf16 != 0, xt_i, coef_f, g, out_t, out_p, rows, km1, r, seed, step,
               sp, tp, s);
  else
    launch<65>(logits, logits_bf16 != 0, xt_i, coef_f, g, out_t, out_p, rows, km1, r, seed, step,
               sp, tp, s);
  return static_cast<int>(cudaGetLastError());
}
