// Fused step tail of the int8 serving engine (K2) for Hopper, sm_90a:
// final LayerNorm -> logits head -> the sampler step, in one launch.
//
// Replaces text_to_sound_synthesis_tpu/ops/fused_sampler.py::fused_head_sample
// (Pallas TPU kernel _head_kernel). The plain PyTorch twin is
// text_to_sound_synthesis_torch/ops/fused_sampler.py::head_sample_reference.
//
// Per row of the backbone's (rows, D) bf16 output:
//   xn = LN(x) * gamma + beta (f32, eps 1e-6) -> bf16;
//   logits = xn . head_w (bf16 products, f32 sum) + head_b, kept in f32;
//   then sampler_body.cuh (the body K1 runs): log-softmax, MASK -> -70, top-r
//   bisection, posterior from the token index, Philox Gumbel-argmax keyed on
//   (seed_base, step) and counted on (row, class) exactly as K1 is.
// The (rows, K-1) logits never reach device memory.
//
// What bounds it on an H100: at the flagship shape (2120 rows, D 1024, 256
// classes) the head is 1.1 GFLOP and reads the 512 KB head weight; the rows
// read 4.3 MB. Run naively (one warp per row reading all of head_w) it would
// pull ~1 GB through L1/L2. The design: a block of 8 warps takes 16 rows, keeps
// their normalised bf16 rows in shared memory, and streams head_w through
// shared memory in chunks of 32 input features that all 16 rows reuse; each
// lane accumulates its classes (c = 32*j + lane) in registers, which is the
// layout the sampler body wants, so the logits go from the dot straight into
// the body with no shuffle. Products are f32 FMAs (the head is 1 % of a step's
// work, so the tensor cores are not needed here).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sampler_body.cuh"

namespace {

using namespace t2s_sampler;

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;   // rows per block
constexpr int kChunk = 32;                      // input features per head_w chunk
constexpr float kLnEps = 1e-6f;

template <int NJ>
__global__ void __launch_bounds__(kWarps * 32)
head_sample_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ xt,
                   const float* __restrict__ norm, const __nv_bfloat16* __restrict__ head_w,
                   const float* __restrict__ head_b, const float* __restrict__ coef,
                   const float* __restrict__ gumbel, int* __restrict__ out_tokens,
                   float* __restrict__ out_post, int rows, int D, int km1, float r,
                   uint32_t seed, uint32_t step) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xn = reinterpret_cast<__nv_bfloat16*>(smem);                 // [kRows][D]
  __nv_bfloat16* wc = xn + static_cast<size_t>(kRows) * D;                     // [kChunk][NJ*32]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;

  // 1. final LayerNorm of this warp's rows, rounded to bf16, into shared memory.
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int lr = warp * kRowsPerWarp + rr, row = row0 + lr;
    __nv_bfloat16* dst = xn + static_cast<size_t>(lr) * D;
    if (row >= rows) {
      for (int k = lane; k < D; k += 32) dst[k] = __float2bfloat16(0.0f);
      continue;
    }
    const __nv_bfloat16* src = x + static_cast<size_t>(row) * D;
    float s = 0.0f;
    for (int k = lane; k < D; k += 32) s += __bfloat162float(src[k]);
    const float mean = __fdiv_rn(warp_sum(s), static_cast<float>(D));
    float v = 0.0f;
    for (int k = lane; k < D; k += 32) {
      const float d = __fsub_rn(__bfloat162float(src[k]), mean);
      v = __fadd_rn(v, __fmul_rn(d, d));
    }
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(v), static_cast<float>(D)), kLnEps));
    for (int k = lane; k < D; k += 32) {
      const float h = __fmul_rn(__fsub_rn(__bfloat162float(src[k]), mean), rstd);
      dst[k] = __float2bfloat16(__fadd_rn(__fmul_rn(h, norm[k]), norm[D + k]));
    }
  }

  // 2. the head: acc[rr][j] = sum_k xn[rr][k] * head_w[k][32j + lane].
  float acc[kRowsPerWarp][NJ];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[rr][j] = 0.0f;
  const int wcols = NJ * 32;
  for (int k0 = 0; k0 < D; k0 += kChunk) {
    __syncthreads();  // previous chunk consumed (and, first time, xn written)
    for (int i = threadIdx.x; i < kChunk * wcols; i += kWarps * 32) {
      const int kk = i / wcols, col = i % wcols;
      wc[i] = col < km1 ? head_w[static_cast<size_t>(k0 + kk) * km1 + col]
                        : __float2bfloat16(0.0f);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kChunk; ++kk) {
      float xv[kRowsPerWarp];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        xv[rr] = __bfloat162float(xn[static_cast<size_t>(warp * kRowsPerWarp + rr) * D + k0 + kk]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float w = __bfloat162float(wc[kk * wcols + j * 32 + lane]);
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) acc[rr][j] = fmaf(xv[rr], w, acc[rr][j]);
      }
    }
  }

  // 3. the sampler body on each row's f32 logits.
  const Coeffs c = *reinterpret_cast<const Coeffs*>(coef);
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + warp * kRowsPerWarp + rr;
    if (row >= rows) break;  // uniform per warp
    float lp[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = j * 32 + lane;
      lp[j] = col < km1 ? __fadd_rn(acc[rr][j], head_b[col]) : -INFINITY;
    }
    sample_row<NJ>(lp, row, lane, xt[row], c, km1, r, seed, step, gumbel, out_tokens, out_post);
  }
}

template <int NJ>
int launch(const void* x, const void* xt, const void* norm, const void* head_w,
           const void* head_b, const void* coef, const void* gumbel, void* out_tokens,
           void* out_post, int rows, int D, int km1, float r, uint32_t seed, uint32_t step,
           cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(kRows) * D + kChunk * NJ * 32) * sizeof(__nv_bfloat16);
  cudaError_t e = cudaFuncSetAttribute(head_sample_kernel<NJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  head_sample_kernel<NJ><<<(rows + kRows - 1) / kRows, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(xt),
      static_cast<const float*>(norm), static_cast<const __nv_bfloat16*>(head_w),
      static_cast<const float*>(head_b), static_cast<const float*>(coef),
      static_cast<const float*>(gumbel), static_cast<int*>(out_tokens),
      static_cast<float*>(out_post), rows, D, km1, r, seed, step);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest K (classes incl. MASK) and D the kernel takes.
extern "C" int t2s_head_sample_max_classes() { return 17 * 32; }
extern "C" int t2s_head_sample_max_width() { return 4096; }

// Launches on `stream`; returns the CUDA error code (0 on success).
// x (rows, D) bf16; xt (rows,) int32; norm (2, D) f32 (gamma; beta);
// head_w (D, km1) bf16; head_b (km1,) f32; coef (10,) f32;
// gumbel (rows, km1+1) f32 or NULL; out_tokens (rows,) int32;
// out_post (rows, km1+1) f32 or NULL.
extern "C" int t2s_fused_head_sample(const void* x, const void* xt, const void* norm,
                                     const void* head_w, const void* head_b, const void* coef,
                                     const void* gumbel, void* out_tokens, void* out_post,
                                     int rows, int D, int km1, float r, unsigned int seed,
                                     unsigned int step, void* stream) {
  const int K = km1 + 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || km1 <= 0 || K > 17 * 32 || D <= 0 || D % kChunk != 0 || D > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K <= 9 * 32)
    return launch<9>(x, xt, norm, head_w, head_b, coef, gumbel, out_tokens, out_post, rows, D,
                     km1, r, seed, step, s);
  return launch<17>(x, xt, norm, head_w, head_b, coef, gumbel, out_tokens, out_post, rows, D,
                    km1, r, seed, step, s);
}
