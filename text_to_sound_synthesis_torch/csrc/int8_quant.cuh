// The quantize passes in front of the int8 GEMM's int8 A mode
// (int8_gemm_sm90.cuh): they write the int8 rows (and under a dynamic scale
// the row maxima) that the GEMM reads, so that the dots see the bytes and row
// scales the plain twins quantize to. Included by int8_block.cu (the engine's
// instantiations) and int8_probe.cu (the T2 / T3 probes'); the anonymous
// namespace gives each translation unit its own copies.
//   - quant_rows_kernel, rows up to kMaxPanelK wide held in registers: [LN or
//     AdaLN] -> quantize (K4, K5, K8, K6 at K <= 1024);
//   - quant_wide_kernel, no norm, any width, as a map over 16-value units of
//     the array: a static scale, or given per-(row, chunk) maxima (the MLP
//     middle under dynamic scales: fc1's epilogue gathers them; K3, K9, T2's
//     fc2s); quant_wide_own_kernel, the row's own max |h| (K6's fc2 at K =
//     4096, T3), each row read once; their input bf16, f32, or T3's sum of
//     three f32 planes.
// The arithmetic is the twins' (ops/quant.py::_quantize_rows,
// _quantize_static): s = max(amax, 1e-8) / 127 with div_rn, round(h / s)
// with h / s correctly rounded (quant_div below), h * inv for a static
// scale, then round_clip_q (rint, clip to +-127).
//
// What bounds them on the H100: bytes. The wide pass at the flagship's MLP
// middle (2120 x 4096 f32 in, int8 out) moves 43 MB, 13 us at 3.35 TB/s; the
// row pass at 2120 x 1024 bf16 moves 6.5 MB, 1.9 us. The wide pass runs at
// that bound; the row pass is short enough that the latency of its loads and
// of its row reductions sets its pace, so its design keeps every row of the
// flagship resident at once: two warps a row, 16-byte loads issued at the
// start, one wave.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "int8_gemm_sm90.cuh"

namespace {

// round_clip_q(h / s), h / s correctly rounded, from t = h * y, y =
// rcp_refined(s) within an ulp of 1 / s: t is h / s (1 + d) with |d| <=
// 2^-23 + 2^-24 and the quotient h / s (1 + d') with |d'| <= 2^-24, so
// wherever |t| <= 128 the two lie within 2^-15 of each other, and wherever
// |t| > 128 both clip to +-127. Outside kQuantBand of a half-integer, t
// clipped rounds to the quotient's integer; inside it div_rn_by decides.
// About 2 kQuantBand of the values take that path (tests/
// test_torch_quant_rounding.py holds the rule against the twin's integer).
constexpr float kQuantBand = 0x1p-13f;

// the band's rare values: a call, so that the passes' unrolled loops keep one
// copy of div_rn_by's slow path (they issue no wgmma, which a call would
// serialize)
__device__ __noinline__ int quant_div_exact(float h, float s, float y) {
  return round_clip_q(div_rn_by(h, s, y));
}

__device__ __forceinline__ int quant_div(float h, float s, float y) {
  const float c = fminf(fmaxf(__fmul_rn(h, y), -127.0f), 127.0f);   // NaN -> -127
  const float u = __fadd_rn(c, 12582912.0f);                        // rint(c) + 1.5 * 2^23
  if (fabsf(__fsub_rn(c, __fsub_rn(u, 12582912.0f))) < 0.5f - kQuantBand)
    return __float_as_int(u) - 0x4B400000;
  return quant_div_exact(h, s, y);
}

// N consecutive values (N a multiple of 4) of a bf16 or f32 row as f32, at an
// element offset that keeps the loads aligned: bf16 as 16-byte loads where N
// allows, 8-byte ones at N 4.
template <bool F32, int N>
__device__ __forceinline__ void load_n(const void* p, size_t o, float (&v)[N]) {
  if constexpr (F32 || N % 8 != 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 f = load4(p, o + 4 * i, F32);
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 w = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p) + o + 8 * i);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&ws[j]);
        v[8 * i + 2 * j] = __low2float(b);
        v[8 * i + 2 * j + 1] = __high2float(b);
      }
    }
  }
}

// N int8 values to q + o: one 16-, 8- or 4-byte store. The words are braced,
// not make_uint4's: a second caller of that static inline function changed
// how the compiler built int8_probe.cu's bf16_dot_kernel, its only other user.
template <int N>
__device__ __forceinline__ void store_n(int8_t* q, size_t o, const int (&iv)[N]) {
  uint32_t w[N / 4];
#pragma unroll
  for (int i = 0; i < N / 4; ++i) w[i] = pack4(iv[4 * i], iv[4 * i + 1], iv[4 * i + 2], iv[4 * i + 3]);
  if constexpr (N == 16) *reinterpret_cast<uint4*>(q + o) = uint4{w[0], w[1], w[2], w[3]};
  else if constexpr (N == 8) *reinterpret_cast<uint2*>(q + o) = uint2{w[0], w[1]};
  else *reinterpret_cast<uint32_t*>(q + o) = w[0];
}

// The row pass: x (M, K) bf16 or f32 [-> AdaLN or LN with mod (2, K)] -> q
// (M, K) int8, and under a dynamic scale each row's max |h| into amax (M,),
// from which the dot's int8 A mode takes the row scale. NORM kNormAdaLN,
// kNormLN or kNormNone.
//
// kRowThreads (two warps) a row, kRowSlots rows a block: thread t holds k =
// 8 t + 512 j + e (j < 2, e < 8), two 16-byte loads of bf16 issued at the
// start, and stores two 8-byte words. At the flagship's 2120 rows that is
// 1060 blocks of four warps; __launch_bounds__ keeps a thread within 56
// registers so that nine blocks (36 warps) fit an SM, and the whole grid
// is one wave (8 or 9 blocks an SM, every row's loads in flight at once):
// no row waits for another to finish, and there are no next rows to fetch
// behind the statistics. The statistics keep the order of the kernel this
// one replaced and of the GEMM's LN panel (build_panel_swz): lane l sums
// x[128 c + 4 l + e] over c, then e, in order, then the warp's xor
// butterfly, div_rn for the mean and the variance, rstd by rsqrtf: the row,
// staged through shared memory as f32, summed by the row's first warp, which
// hands the two statistics to the second. So the int8 rows and maxima are
// those of that kernel bit for bit. Under a dynamic scale the row's max
// meets in shared memory, and the quantize is quant_div.
constexpr int kRowThreads = 64, kRowSlots = 2, kRowGroups = kMaxPanelK / (8 * kRowThreads);

template <int NORM, bool A32>
__global__ void __launch_bounds__(kRowThreads * kRowSlots, 9)
quant_rows_kernel(const void* __restrict__ x, const float* __restrict__ mod, int M, int K,
                  float inv_static, int is_static, int8_t* __restrict__ q,
                  float* __restrict__ amax_out) {
  constexpr bool kNorm = NORM != kNormNone;
  __shared__ __align__(16) float rows[kNorm ? kRowSlots : 1][kNorm ? kMaxPanelK : 4];
  __shared__ float2 stats[kRowSlots];                     // each row's mean and 1 / std
  __shared__ float part[kRowSlots][kRowThreads / 32];   // each warp's max |h|
  const int slot = threadIdx.x / kRowThreads, t = threadIdx.x % kRowThreads, w = t / 32;
  const int r = blockIdx.x * kRowSlots + slot;
  const bool in_row = r < M;
  const size_t row = static_cast<size_t>(in_row ? r : 0) * K;
  bool ok[kRowGroups];
  float v[kRowGroups][8];
#pragma unroll
  for (int j = 0; j < kRowGroups; ++j) {
    const int k = 8 * t + 8 * kRowThreads * j;
    ok[j] = in_row && k < K;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[j][e] = 0.0f;
    if (ok[j]) load_n<A32>(x, row + k, v[j]);
  }
  float mean = 0.0f, rstd = 1.0f;
  if constexpr (kNorm) {
    float* buf = rows[slot];
#pragma unroll
    for (int j = 0; j < kRowGroups; ++j)
      if (8 * t + 8 * kRowThreads * j < K) {
        float4* dst = reinterpret_cast<float4*>(buf + 8 * t + 8 * kRowThreads * j);
        dst[0] = make_float4(v[j][0], v[j][1], v[j][2], v[j][3]);
        dst[1] = make_float4(v[j][4], v[j][5], v[j][6], v[j][7]);
      }
    __syncthreads();
    if (w == 0) {   // the row's first warp takes the statistics, the second waits
      const int lane = t & 31, nkc = K / 128;
      auto piece = [&](int c) { return *reinterpret_cast<const float4*>(buf + 128 * c + 4 * lane); };
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < kMaxPanelK / 128; ++c)
        if (c < nkc) {
          const float4 f = piece(c);
          sum = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(sum, f.x), f.y), f.z), f.w);
        }
      mean = div_rn(warp_sum(sum), static_cast<float>(K));
      sum = 0.0f;
      auto sq = [&](float a) { const float d = __fsub_rn(a, mean); return __fmul_rn(d, d); };
#pragma unroll
      for (int c = 0; c < kMaxPanelK / 128; ++c)
        if (c < nkc) {
          const float4 f = piece(c);
          sum = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(sum, sq(f.x)), sq(f.y)), sq(f.z)), sq(f.w));
        }
      rstd = rsqrtf(__fadd_rn(div_rn(warp_sum(sum), static_cast<float>(K)), kLnEps));
      if (lane == 0) stats[slot] = make_float2(mean, rstd);
    }
    __syncthreads();
    mean = stats[slot].x;
    rstd = stats[slot].y;
  }
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kRowGroups; ++j) {
    if (!ok[j]) continue;
    if constexpr (kNorm) {
      const int k = 8 * t + 8 * kRowThreads * j;
      float m0[8], m1[8];
      load_n<true>(mod, k, m0);
      load_n<true>(mod, K + k, m1);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[j][e] = prologue<NORM>(v[j][e], mean, rstd, m0[e], m1[e]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[j][e]));
  }
  float s = 0.0f, y = 0.0f;
  if (!is_static) {
    amax = warp_max(amax);
    if ((t & 31) == 0) part[slot][w] = amax;
    __syncthreads();
    amax = fmaxf(part[slot][0], part[slot][1]);
    if (in_row && t == 0) amax_out[r] = amax;
    s = row_scale<true>(amax);
    y = rcp_refined(s);
  }
#pragma unroll
  for (int j = 0; j < kRowGroups; ++j) {
    if (!ok[j]) continue;
    int iv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      iv[e] = is_static ? round_clip_q(__fmul_rn(v[j][e], inv_static)) : quant_div(v[j][e], s, y);
    store_n(q, row + 8 * t + 8 * kRowThreads * j, iv);
  }
}

// The wide pass's inputs: a bf16 or f32 row, or T3's y = bf16((q + k) + v)
// from the three f32 planes of a (3, M, K) input
enum QuantIn { kInBf16 = 0, kInF32 = 1, kInSum3 = 2 };

// N consecutive values of the wide pass's input at element o (plane: M K)
template <int IN, int N>
__device__ __forceinline__ void wide_in(const void* x, size_t o, size_t plane, float (&v)[N]) {
  if constexpr (IN != kInSum3) {
    load_n<IN == kInF32>(x, o, v);
  } else {
    float a[N], b[N], c[N];
    load_n<true>(x, o, a);
    load_n<true>(x, plane + o, b);
    load_n<true>(x, 2 * plane + o, c);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = bf16r(__fadd_rn(__fadd_rn(a[i], b[i]), c[i]));
  }
}

// the wide pass's row scale from a max |h|; QBF (T2 mid_bf16): rounded to bf16
template <bool QBF>
__device__ __forceinline__ float wide_scale(float amax) {
  const float s = row_scale<true>(amax);
  return QBF ? bf16r(s) : s;
}

// N values quantized with the row scale s (y = rcp_refined(s)); QBF: h / s
// rounded to bf16 before the rounding to an integer
template <bool QBF, int N>
__device__ __forceinline__ void wide_quant(const float (&v)[N], float s, float y, int (&iv)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    iv[i] = QBF ? round_clip_q(bf16r(div_rn_by(v[i], s, y))) : quant_div(v[i], s, y);
}

constexpr int kWideThreads = 256;

// The wide pass under a static scale (h * inv) or with given maxima amax_in
// (M, nch), chunk c of the K / nch columns (a multiple of 4) quantized with
// its own s = max(amax, 1e-8) / 127: a map over the M K values in 16-value
// units (16-byte loads of bf16 or f32, one 16-byte store), the grid sized
// to the SMs and each thread walking units at the grid's stride. Where K and
// the chunk width are multiples of 16 a unit lies in one (row, chunk), whose
// scale and reciprocal it takes once; else each 4-value piece takes its own.
// The last M K mod 16 values go by 4.
template <int IN, bool QBF>
__global__ void __launch_bounds__(kWideThreads)
quant_wide_kernel(const void* __restrict__ x, int M, int K, int nch,
                  const float* __restrict__ amax_in, float inv_static, int is_static,
                  int8_t* __restrict__ q) {
  const size_t n = static_cast<size_t>(M) * K;
  const unsigned units = static_cast<unsigned>(n / 16), upr = static_cast<unsigned>(K / 16);
  const int cw = K / nch;
  const bool whole = K % 16 == 0 && cw % 16 == 0;
  // the 4 values from element f, with the scale of their (row, chunk)
  auto quant4 = [&](size_t f, const float (&v)[4], int (&iv)[4]) {
    if (is_static) {
#pragma unroll
      for (int i = 0; i < 4; ++i) iv[i] = round_clip_q(__fmul_rn(v[i], inv_static));
    } else {
      const size_t r = f / K;
      const float s = wide_scale<QBF>(amax_in[r * nch + (f - r * K) / cw]);
      wide_quant<QBF>(v, s, rcp_refined(s), iv);
    }
  };
  const unsigned stride = gridDim.x * kWideThreads;
  for (unsigned u = blockIdx.x * kWideThreads + threadIdx.x; u < units; u += stride) {
    const size_t f = 16 * static_cast<size_t>(u);
    float v[16];
    int iv[16];
    wide_in<IN>(x, f, n, v);
    if (is_static) {
#pragma unroll
      for (int i = 0; i < 16; ++i) iv[i] = round_clip_q(__fmul_rn(v[i], inv_static));
    } else if (whole) {
      const unsigned r = u / upr, c = 16 * (u - r * upr) / cw;
      const float s = wide_scale<QBF>(amax_in[static_cast<size_t>(r) * nch + c]);
      wide_quant<QBF>(v, s, rcp_refined(s), iv);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float v4[4] = {v[4 * p], v[4 * p + 1], v[4 * p + 2], v[4 * p + 3]};
        int i4[4];
        quant4(f + 4 * p, v4, i4);
#pragma unroll
        for (int i = 0; i < 4; ++i) iv[4 * p + i] = i4[i];
      }
    }
    store_n(q, f, iv);
  }
  if (blockIdx.x == 0 && threadIdx.x < (n % 16) / 4) {   // the tail, 4 values a thread
    const size_t f = 16 * static_cast<size_t>(units) + 4 * threadIdx.x;
    float v[4];
    int iv[4];
    wide_in<IN>(x, f, n, v);
    quant4(f, v, iv);
    store_n(q, f, iv);
  }
}

// The wide pass with the row's own max |h|, written to amax_out (M,): tpr
// threads a row (32 to 256, a power of two), kWideThreads / tpr rows a
// block, a block for each such group of rows (at K 4096, 2120 blocks of one
// row, six resident an SM, each SM's next block dispatched as one ends).
// Thread t holds the row's W-value unit t (W 16 where K is a multiple of 16,
// else 4) in registers from the read that finds the max to the quantize, so
// a row up to tpr W values wide (4096 at W 16) is read once; the units past
// tpr W are read again. The row's warps meet in shared memory.
template <int IN, bool QBF, int W>
__global__ void __launch_bounds__(kWideThreads)
quant_wide_own_kernel(const void* __restrict__ x, int M, int K, int tpr,
                      int8_t* __restrict__ q, float* __restrict__ amax_out) {
  __shared__ float part[kWideThreads / 32];
  const int lr = threadIdx.x / tpr, t = threadIdx.x % tpr, upr = K / W;
  const int r = blockIdx.x * (kWideThreads / tpr) + lr;
  const bool in_row = r < M, held = in_row && t < upr;
  const size_t row = static_cast<size_t>(in_row ? r : 0) * K, plane = static_cast<size_t>(M) * K;
  float v[W];
  float m = 0.0f;
  if (held) {
    wide_in<IN>(x, row + W * t, plane, v);
#pragma unroll
    for (int i = 0; i < W; ++i) m = fmaxf(m, fabsf(v[i]));
  }
  for (int u = t + tpr; in_row && u < upr; u += tpr) {
    float o[W];
    wide_in<IN>(x, row + W * u, plane, o);
#pragma unroll
    for (int i = 0; i < W; ++i) m = fmaxf(m, fabsf(o[i]));
  }
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x / 32] = m;
  __syncthreads();
  for (int i = 0; i < tpr / 32; ++i) m = fmaxf(m, part[lr * (tpr / 32) + i]);
  if (!in_row) return;
  if (t == 0) amax_out[r] = m;
  const float s = wide_scale<QBF>(m), y = rcp_refined(s);
  int iv[W];
  if (held) {
    wide_quant<QBF>(v, s, y, iv);
    store_n(q, row + W * t, iv);
  }
  for (int u = t + tpr; u < upr; u += tpr) {
    float o[W];
    wide_in<IN>(x, row + W * u, plane, o);
    wide_quant<QBF>(o, s, y, iv);
    store_n(q, row + W * u, iv);
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
  const int grid = (M + kRowSlots - 1) / kRowSlots;
  quant_rows_kernel<NORM, A32><<<grid, kRowThreads * kRowSlots, 0, s>>>(
      x, static_cast<const float*>(mod), M, K, inv_static, is_static, static_cast<int8_t*>(q),
      static_cast<float*>(amax));
  return static_cast<int>(cudaGetLastError());
}

// The wide pass's launch; false where the arguments are not its: K a multiple
// of 4 in nch chunks of a multiple of 4; under a dynamic scale amax_in (the
// given maxima) or amax_out (the row's own).
bool quant_wide_ok(int M, int K, int nch, const void* amax_in, int is_static, const void* amax_out) {
  return !(M <= 0 || K <= 0 || K % 4 != 0 || nch < 1 || K % nch != 0 || (K / nch) % 4 != 0 ||
           (!is_static && amax_in == nullptr && amax_out == nullptr));
}

// blocks of `threads` that fit an SM at once, times the SMs: a grid that
// walks its work at its own stride
template <typename Kernel>
int resident_grid(Kernel kernel, int threads) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return num_sms() * (per_sm > 0 ? per_sm : 1);
}

template <int IN, bool QBF, int W>
int launch_quant_wide_own(const void* x, int M, int K, void* q, void* amax_out, cudaStream_t s) {
  int tpr = 32;   // the least power of two of threads that holds the row's units, at most 256
  while (tpr < kWideThreads && tpr < K / W) tpr *= 2;
  const int rows = kWideThreads / tpr;
  quant_wide_own_kernel<IN, QBF, W><<<(M + rows - 1) / rows, kWideThreads, 0, s>>>(
      x, M, K, tpr, static_cast<int8_t*>(q), static_cast<float*>(amax_out));
  return static_cast<int>(cudaGetLastError());
}

template <int IN, bool QBF>
int launch_quant_wide(const void* x, int M, int K, int nch, const void* amax_in, float inv_static,
                      int is_static, void* q, void* amax_out, cudaStream_t s) {
  if (!is_static && amax_in == nullptr)
    return K % 16 == 0 ? launch_quant_wide_own<IN, QBF, 16>(x, M, K, q, amax_out, s)
                       : launch_quant_wide_own<IN, QBF, 4>(x, M, K, q, amax_out, s);
  static const int resident = resident_grid(quant_wide_kernel<IN, QBF>, kWideThreads);
  const size_t units = (static_cast<size_t>(M) * K + 15) / 16;
  const size_t blocks = (units + kWideThreads - 1) / kWideThreads;
  const int grid = static_cast<int>(blocks < static_cast<size_t>(resident) ? blocks : resident);
  quant_wide_kernel<IN, QBF><<<grid, kWideThreads, 0, s>>>(
      x, M, K, nch, static_cast<const float*>(amax_in), inv_static, is_static,
      static_cast<int8_t*>(q));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
