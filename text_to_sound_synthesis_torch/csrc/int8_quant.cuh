// The quantize passes in front of the int8 GEMM's int8 A mode
// (int8_gemm_sm90.cuh): they write the int8 rows (and under a dynamic scale
// the row maxima) that the GEMM reads, so that the dots see the bytes and row
// scales the plain twins quantize to. Included by int8_block.cu (the engine's
// instantiations) and int8_probe.cu (the T2 / T3 probes'); the anonymous
// namespace gives each translation unit its own copies.
//   - quant_rows_kernel, rows up to kMaxPanelK wide held in registers: [LN or
//     AdaLN] -> quantize (K4, K5, K8, K6 at K <= 1024);
//   - quant_wide_kernel, rows of any width streamed twice at most, no norm:
//     quantize with the row's own max |h| (K6's fc2 at K = 4096), with given
//     per-(row, chunk) maxima (the MLP middle under dynamic scales: fc1's
//     epilogue gathers them; K3, K9, T2's fc2s), or a static scale; its input
//     bf16, f32, or T3's sum of three f32 planes.
// The arithmetic is the twins' (ops/quant.py::_quantize_rows,
// _quantize_static), as the Hopper panel builder computes it: s = max(amax,
// 1e-8) / 127 with div_rn, h / s as div_rn_by with s's refined reciprocal, h *
// inv for a static scale, then round_clip_q (rint, clip to +-127).
//
// What bounds them on the H100: bytes. The wide pass at the flagship's MLP
// middle (2120 x 4096 f32 in, int8 out) moves 43 MB, 13 us at 3.35 TB/s; the
// row pass at 2120 x 1024 bf16 moves 6.5 MB, 1.9 us.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "int8_gemm_sm90.cuh"

namespace {

// The row pass: x (M, K) bf16 or f32 [-> AdaLN or LN with mod (2, K)] -> q
// (M, K) int8, and under a dynamic scale each row's max |h| into amax (M,),
// from which the dot's int8 A mode takes the row scale as the panel did. The
// arithmetic is build_panel_swz's (int8_gemm_sm90.cuh), row by row: lane l
// holds k = 128 i + 4 l + e, its sums in that order and then the warp's
// butterfly, div_rn for the mean, the variance and the dynamic quantize, the
// static one a multiply. So the bytes and the scales are the ones the panel
// held. One warp per kQuantRows rows, their loads in flight together; NORM
// kNormAdaLN, kNormLN or kNormNone.
constexpr int kQuantRows = 2;

template <int NORM, bool A32>
__global__ void __launch_bounds__(256)
quant_rows_kernel(const void* __restrict__ x, const float* __restrict__ mod, int M, int K,
                  float inv_static, int is_static, int8_t* __restrict__ q,
                  float* __restrict__ amax_out) {
  constexpr int R = kQuantRows, kV = kMaxPanelK / 32;
  const int lane = threadIdx.x & 31, r0 = (blockIdx.x * 8 + (threadIdx.x >> 5)) * R;
  const int nkc = K / 128;
  const bool st = is_static != 0;
  float v[R][kV];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = r0 + j;
    const size_t row = static_cast<size_t>(r < M ? r : 0) * K;
#pragma unroll
    for (int i = 0; i < kMaxPanelK / 128; ++i) {
      float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < nkc && r < M) f = load4(x, row + 128 * i + 4 * lane, A32);
      v[j][4 * i] = f.x;
      v[j][4 * i + 1] = f.y;
      v[j][4 * i + 2] = f.z;
      v[j][4 * i + 3] = f.w;
    }
  }
  float mean[R], rstd[R], amax[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    mean[j] = 0.0f;
    rstd[j] = 1.0f;
    amax[j] = 0.0f;
  }
  if (NORM != kNormNone) {
    float sum[R];
#pragma unroll
    for (int j = 0; j < R; ++j) sum[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < kV; ++i)
      if (i / 4 < nkc)
#pragma unroll
        for (int j = 0; j < R; ++j) sum[j] = __fadd_rn(sum[j], v[j][i]);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      mean[j] = div_rn(warp_sum(sum[j]), static_cast<float>(K));
      sum[j] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kV; ++i)
      if (i / 4 < nkc)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float d = __fsub_rn(v[j][i], mean[j]);
          sum[j] = __fadd_rn(sum[j], __fmul_rn(d, d));
        }
#pragma unroll
    for (int j = 0; j < R; ++j)
      rstd[j] = rsqrtf(__fadd_rn(div_rn(warp_sum(sum[j]), static_cast<float>(K)), kLnEps));
  }
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    if (i / 4 < nkc) {
      const int k = 128 * (i / 4) + 4 * lane + (i % 4);
      const float m0v = NORM != kNormNone ? mod[k] : 0.0f;
      const float m1v = NORM != kNormNone ? mod[K + k] : 0.0f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        v[j][i] = prologue<NORM>(v[j][i], mean[j], rstd[j], m0v, m1v);
        amax[j] = fmaxf(amax[j], fabsf(v[j][i]));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = r0 + j;
    if (r >= M) continue;
    int8_t* dst = q + static_cast<size_t>(r) * K + 4 * lane;
    if (st) {
#pragma unroll
      for (int i = 0; i < kMaxPanelK / 128; ++i)
        if (i < nkc)
          *reinterpret_cast<uint32_t*>(dst + 128 * i) =
              pack4(quantize<true>(v[j][4 * i], 0.0f, inv_static, true),
                    quantize<true>(v[j][4 * i + 1], 0.0f, inv_static, true),
                    quantize<true>(v[j][4 * i + 2], 0.0f, inv_static, true),
                    quantize<true>(v[j][4 * i + 3], 0.0f, inv_static, true));
    } else {
      const float am = warp_max(amax[j]), s = row_scale<true>(am), y = rcp_refined(s);
      if (lane == 0) amax_out[r] = am;
      auto qv = [&](float h) { return round_clip_q(div_rn_by(h, s, y)); };   // quantize's h / s
#pragma unroll
      for (int i = 0; i < kMaxPanelK / 128; ++i)
        if (i < nkc)
          *reinterpret_cast<uint32_t*>(dst + 128 * i) =
              pack4(qv(v[j][4 * i]), qv(v[j][4 * i + 1]), qv(v[j][4 * i + 2]), qv(v[j][4 * i + 3]));
    }
  }
}

// The wide pass's inputs: a bf16 or f32 row, or T3's y = bf16((q + k) + v)
// from the three f32 planes of a (3, M, K) input
enum QuantIn { kInBf16 = 0, kInF32 = 1, kInSum3 = 2 };

// The wide pass: x (M, K) [-> the sum of three planes] -> q (M, K) int8, K a
// multiple of 4. kWideWarps warps a row, two rows a block: warp w's lane l at
// k = 128 (w + kWideWarps i) + 4 l + e, four loads a lane in flight, so that
// the MLP middle's 2120 rows fill the card's warps (one warp a row left it
// at 30 us, about twice its 13 us bound, on the H100). Under
// a static scale h * inv; with maxima amax_in (M, nch), each chunk of K / nch
// columns (a multiple of 4) with its own s = max(amax, 1e-8) / 127; without,
// the row's own max |h| from a first read of the row (the four warps'
// maxima met in shared memory; written to amax_out (M,)), then a second read
// quantizes. QBF (T2 mid_bf16): s and h / s rounded to bf16 before the
// rounding to an integer.
constexpr int kWideWarps = 4;

template <int IN, bool QBF>
__global__ void __launch_bounds__(256)
quant_wide_kernel(const void* __restrict__ x, int M, int K, int nch,
                  const float* __restrict__ amax_in, float inv_static, int is_static,
                  int8_t* __restrict__ q, float* __restrict__ amax_out) {
  __shared__ float part[8 / kWideWarps][kWideWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lr = warp / kWideWarps, w = warp % kWideWarps;
  const int r = blockIdx.x * (8 / kWideWarps) + lr;
  const bool in_row = r < M;
  const size_t row = static_cast<size_t>(in_row ? r : 0) * K;
  const int k0 = 128 * w + 4 * lane, dk = 128 * kWideWarps;
  auto in4 = [&](int k) {
    if (IN != kInSum3) return load4(x, row + k, IN == kInF32);
    const size_t plane = static_cast<size_t>(M) * K;   // ((q + k) + v) in f32, rounded to bf16
    const float4 a = load4(x, row + k, true), b = load4(x, plane + row + k, true),
                 c = load4(x, 2 * plane + row + k, true);
    return make_float4(bf16r(__fadd_rn(__fadd_rn(a.x, b.x), c.x)),
                       bf16r(__fadd_rn(__fadd_rn(a.y, b.y), c.y)),
                       bf16r(__fadd_rn(__fadd_rn(a.z, b.z), c.z)),
                       bf16r(__fadd_rn(__fadd_rn(a.w, b.w), c.w)));
  };
  auto scale_of = [&](float amax) {
    const float s = row_scale<true>(amax);
    return QBF ? bf16r(s) : s;
  };
  auto qv = [&](float h, float s, float y) {   // quantize's h / s
    const float t = div_rn_by(h, s, y);
    return round_clip_q(QBF ? bf16r(t) : t);
  };
  uint32_t* dst = reinterpret_cast<uint32_t*>(q + row);
  if (is_static) {
    if (in_row)
#pragma unroll 4
      for (int k = k0; k < K; k += dk) {
        const float4 f = in4(k);
        dst[k / 4] = pack4(quantize<true>(f.x, 0.0f, inv_static, true),
                           quantize<true>(f.y, 0.0f, inv_static, true),
                           quantize<true>(f.z, 0.0f, inv_static, true),
                           quantize<true>(f.w, 0.0f, inv_static, true));
      }
    return;
  }
  if (amax_in != nullptr) {
    const int cw = K / nch;
    if (in_row)
#pragma unroll 4
      for (int k = k0; k < K; k += dk) {
        const float4 f = in4(k);
        const float s = scale_of(amax_in[static_cast<size_t>(r) * nch + k / cw]), y = rcp_refined(s);
        dst[k / 4] = pack4(qv(f.x, s, y), qv(f.y, s, y), qv(f.z, s, y), qv(f.w, s, y));
      }
    return;
  }
  float m = 0.0f;
  if (in_row)
#pragma unroll 4
    for (int k = k0; k < K; k += dk) {
      const float4 f = in4(k);
      m = fmaxf(m, fmaxf(fmaxf(fabsf(f.x), fabsf(f.y)), fmaxf(fabsf(f.z), fabsf(f.w))));
    }
  m = warp_max(m);
  if (lane == 0) part[lr][w] = m;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kWideWarps; ++i) m = fmaxf(m, part[lr][i]);
  if (!in_row) return;
  if (w == 0 && lane == 0) amax_out[r] = m;
  const float s = scale_of(m), y = rcp_refined(s);
#pragma unroll 4
  for (int k = k0; k < K; k += dk) {
    const float4 f = in4(k);
    dst[k / 4] = pack4(qv(f.x, s, y), qv(f.y, s, y), qv(f.z, s, y), qv(f.w, s, y));
  }
}

// The row pass's launch; false where the arguments are not its (K a multiple
// of 128 up to kMaxPanelK, mod for a norm, amax under a dynamic scale).
bool quant_rows_ok(int norm, int M, int K, const void* mod, int is_static, const void* amax) {
  return !(M <= 0 || K <= 0 || K % 128 != 0 || K > kMaxPanelK ||
           (norm != kNormNone && mod == nullptr) || (!is_static && amax == nullptr));
}

template <int NORM, bool A32>
int launch_quant_rows(const void* x, const void* mod, int M, int K, float inv_static,
                      int is_static, void* q, void* amax, cudaStream_t s) {
  const int grid = (M + 8 * kQuantRows - 1) / (8 * kQuantRows);
  quant_rows_kernel<NORM, A32><<<grid, 256, 0, s>>>(x, static_cast<const float*>(mod), M, K,
                                                    inv_static, is_static,
                                                    static_cast<int8_t*>(q), static_cast<float*>(amax));
  return static_cast<int>(cudaGetLastError());
}

// The wide pass's launch; false where the arguments are not its: K a multiple
// of 4 in nch chunks of a multiple of 4; under a dynamic scale amax_in (the
// given maxima) or amax_out (the row's own).
bool quant_wide_ok(int M, int K, int nch, const void* amax_in, int is_static, const void* amax_out) {
  return !(M <= 0 || K <= 0 || K % 4 != 0 || nch < 1 || K % nch != 0 || (K / nch) % 4 != 0 ||
           (!is_static && amax_in == nullptr && amax_out == nullptr));
}

template <int IN, bool QBF>
int launch_quant_wide(const void* x, int M, int K, int nch, const void* amax_in, float inv_static,
                      int is_static, void* q, void* amax_out, cudaStream_t s) {
  constexpr int kRowsPerBlock = 8 / kWideWarps;
  quant_wide_kernel<IN, QBF><<<(M + kRowsPerBlock - 1) / kRowsPerBlock, 256, 0, s>>>(
      x, M, K, nch, static_cast<const float*>(amax_in), inv_static, is_static,
      static_cast<int8_t*>(q), static_cast<float*>(amax_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
