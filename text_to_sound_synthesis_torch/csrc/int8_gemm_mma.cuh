// The mma.sync int8 GEMM of the engine, `int8_gemm_kernel`, with its panel
// builder, epilogue arithmetic and launcher: the mainloop that K4-K6, K8,
// K9, the stream mode, T3 and the kEfAny cases run (int8_block.cu's header
// comment says how). Included by int8_block.cu (the engine's instantiations)
// and int8_probe.cu (the T2 / T3 probes'); the anonymous namespace gives each
// translation unit its own copies. K3, T1 and T2's moved launches run the
// Hopper mainloop of int8_gemm_sm90.cuh, which reuses this file's constants,
// GemmArgs and epilogue arithmetic.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

using namespace t2s_int8;

constexpr int kThreads = 256;
constexpr int BM = 64, BN = 128;   // output tile
constexpr int KS = 64;             // bytes of a weight row per pipeline stage
constexpr int kBStride = KS + 16;  // padded shared-memory row of a weight tile
constexpr int kMaxPanelK = 1024;   // panel rows live in registers while built

enum AMode { kPanel = 0, kStream = 1, kInt8 = 2 };
// kEpiStore: [GELU2] [+ residual] -> bf16 or f32 (and the row max |y| per N
// chunk when amax_out is set); kEpiGeluInt8: GELU2 quantized to int8;
// kEpiChunked: int32 sums flushed per K chunk into an f32 accumulator that
// starts at the residual, then + bias -> bf16 or f32; kEpiRaw (T1, the bare
// dot probe): the int32 sums stored as they are, or converted to f32.
// The T2 probe's fc1 epilogues with an int8 output: kEpiWrap8 (dots_only), the
// int32 sums wrapped to int8 (their low byte); kEpiClip8 (no_quant_mid), the
// dequant [GELU2] clipped to +-127 and truncated; kEpiShift8 (no_deq_mid),
// clip(sum >> 7, +-127). The last two also store the panel's row max |h| in
// amax_out: fc2 takes the input's row scale for the middle's.
enum Epi { kEpiStore = 0, kEpiGeluInt8 = 1, kEpiChunked = 2, kEpiRaw = 3, kEpiWrap8 = 4,
           kEpiClip8 = 5, kEpiShift8 = 6 };
// The T2 / T3 probes' panel inputs besides Norm's: kNormCast, x truncated to
// int8 as it is, no scale (dots_only); kNormLN1, LayerNorm with the variance
// as E[x^2] - E[x]^2 (ln_onepass); kNormSum3, q + k + v from the three f32
// planes of a (3, M, K) input, rounded once to bf16 (qkvp_dots_only's proj).
constexpr int kNormCast = 3, kNormLN1 = 4, kNormSum3 = 5;
// What an epilogue applies and which dtypes its operands have, as bits of a
// template parameter: the engines' combinations compile with their flags
// folded, as fast as a GEMM written for one of them (a run-time flag in the
// epilogue cost K3-K5 9-30 % on the H100). kEfAny reads the bits from
// GemmArgs::ef at run time, for K6's other combinations.
enum EpiFlags {
  kEfGelu = 1,     // GELU2 after the dequant (kEpiStore)
  kEfRes = 2,      // + residual
  kEfResF32 = 4,   // the residual is f32 (else bf16)
  kEfOutF32 = 8,   // the output is f32 (else bf16)
  kEfMax = 16,     // the row max |y| per N chunk into amax_out (kEpiStore)
  kEfAF32 = 32,    // panel / stream: a is f32 (else bf16)
  // the T2 probe's (compiled in only; kEfAny never reads them):
  kEfMidBf16 = 64,    // kEpiStore: dequant and GELU2 in bf16 steps, the row max floored at amax_floor
  kEfSigC = 128,      // with kEfMidBf16: the sigmoid as 1 / (1 + exp(-1.702 u)), bf16 steps
  kEfFastSig = 256,   // kEpiStore: the sigmoid as 0.5 + 0.5 z / (1 + |z|), z = 1.702 u
  kEfQBf16 = 512,     // stream mode: the row scale and a / s rounded to bf16 before rint
  kEfRawBf16 = 1024,  // kEpiRaw: the int32 sums rounded to bf16
};
constexpr int kEfAny = -1;
constexpr int kEfProbe = kEfMidBf16 | kEfSigC | kEfFastSig | kEfQBf16 | kEfRawBf16;

struct GemmArgs {
  const void* a;             // (M, K): panel and stream bf16 or f32, int8 mode int8
  int ef;                    // EpiFlags of this launch
  const float* mod;          // (2, K) f32 prologue rows
  const float* amax_in;      // stream, dynamic: (M, nch) row max |a| per K chunk
  float s_static, inv_static;
  int is_static;
  const int8_t* w[3];        // (N, K) int8 or (N, K/2) packed W4
  const float* scale[3];     // (N,)
  const float* bias[3];      // (N,)
  void* out[3];              // (M, N) bf16 or f32 (kEfOutF32); int8 for kEpiGeluInt8
  const void* residual;      // (M, N) bf16 or f32, or null
  float* amax_out;           // kEfMax: (M, nch) row max |y| per N chunk (zeroed);
                             // kEpiClip8, kEpiShift8: (M,) the panel's row max |h|
  float out_inv;             // kEpiGeluInt8: f32(1 / s) of the output's static scale
  int M, K, N;
  int nch;                   // chunks of K (stream and int8 modes) or of N (amax_out)
  int nt;                    // 128-wide output tiles per block (panel mode reuses its rows)
  float amax_floor;          // kEfMidBf16: the floor of the row max |y|
};

__device__ __forceinline__ float2 load2(const void* p, size_t o, bool f32) {
  if (f32) return *reinterpret_cast<const float2*>(static_cast<const float*>(p) + o);
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(static_cast<const __nv_bfloat16*>(p) + o);
  return make_float2(__low2float(v), __high2float(v));
}

__device__ __forceinline__ void store2(void* p, size_t o, float y0, float y1, bool f32) {
  if (f32)
    *reinterpret_cast<float2*>(static_cast<float*>(p) + o) = make_float2(y0, y1);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p) + o) = __floats2bfloat162_rn(y0, y1);
}

// four consecutive values of a bf16 or f32 row as f32 (offset a multiple of 4)
__device__ __forceinline__ float4 load4(const void* p, size_t o, bool f32) {
  if (f32) return *reinterpret_cast<const float4*>(static_cast<const float*>(p) + o);
  const uint2 w = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + o);
  const __nv_bfloat162 p0 = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
  const __nv_bfloat162 p1 = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
  return make_float4(__low2float(p0), __high2float(p0), __low2float(p1), __high2float(p1));
}

// The T2 probe's arithmetic, each step as its JAX source rounds it.
__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// float -> int8 as XLA's convert: truncated toward zero, saturated, NaN to 0
__device__ __forceinline__ int cast_s8(float v) {
  return v != v ? 0 : static_cast<int>(fminf(fmaxf(truncf(v), -128.0f), 127.0f));
}

// int8(clip(u, -127, 127)), jnp.clip keeping a NaN
__device__ __forceinline__ int clip_cast_s8(float u) {
  return u != u ? 0 : static_cast<int>(truncf(fminf(fmaxf(u, -127.0f), 127.0f)));
}

// mid_bf16's fc2 quantize: clip(rint(bf16(a / s)))
__device__ __forceinline__ int quantize_bf16(float a, float s) {
  return clip_q(rintf(bf16r(__fdiv_rn(a, s))));
}

// bf16(acc) * (bf16(s) * bf16(scale)) + bf16(bias), every product and sum in bf16
__device__ __forceinline__ float dequant_bf16(int acc, float s, float scale, float bias) {
  const float ss = bf16r(__fmul_rn(bf16r(s), bf16r(scale)));
  return bf16r(__fadd_rn(bf16r(__fmul_rn(bf16r(static_cast<float>(acc)), ss)), bf16r(bias)));
}

// GELU2 on a bf16 u in bf16 steps; 1.702 is 1.703125 in bf16 (this and
// gelu_fast divide with div_rn: only the Hopper mainloop instantiates them). SIGC: u * (1 /
// (1 + exp(-1.702 u))), each op rounded (mid_bf16c); else u * sigmoid(1.702 u),
// the sigmoid rounded once (mid_bf16, mid_bf16b)
template <bool SIGC>
__device__ __forceinline__ float gelu2_bf16(float u) {
  if (SIGC) {
    const float e = bf16r(expf(bf16r(__fmul_rn(-1.703125f, u))));
    return bf16r(__fmul_rn(u, bf16r(div_rn(1.0f, bf16r(__fadd_rn(1.0f, e))))));
  }
  const float v = bf16r(__fmul_rn(1.703125f, u));
  return bf16r(__fmul_rn(u, bf16r(div_rn(1.0f, __fadd_rn(1.0f, expf(-v))))));
}

// fast_sigmoid: u * (0.5 + 0.5 z / (1 + |z|)), z = 1.702 u, in f32
__device__ __forceinline__ float gelu_fast(float u) {
  const float z = __fmul_rn(1.702f, u);
  return __fmul_rn(u, __fadd_rn(0.5f, div_rn(__fmul_rn(0.5f, z), __fadd_rn(1.0f, fabsf(z)))));
}

// KEEP: the row max |h| of the panel's rows also goes to amax_out (blocks of
// the first column tile only)
template <int NORM, bool KEEP>
__device__ __forceinline__ void build_panel(const GemmArgs& g, bool a32, int8_t* As, int a_stride,
                                            float* srow, int m0, int warp, int lane) {
  constexpr bool kPlain = NORM == kNormNone || NORM == kNormCast || NORM == kNormSum3;
  const int K = g.K, nkc = K / 128;
  const bool st = g.is_static != 0;
  for (int rr = 0; rr < BM / 8; ++rr) {
    const int lr = warp * (BM / 8) + rr, r = m0 + lr;
    int8_t* dst = As + lr * a_stride;
    if (r >= g.M) {
      for (int k = lane * 4; k < K; k += 128) *reinterpret_cast<uint32_t*>(dst + k) = 0u;
      if (lane == 0) srow[lr] = 0.0f;
      continue;
    }
    // lane holds k = 128*i + 4*lane + e
    float v[kMaxPanelK / 32];
    const size_t row = static_cast<size_t>(r) * K;
#pragma unroll
    for (int i = 0; i < kMaxPanelK / 128; ++i) {
      if (i < nkc) {
        const float4 f = load4(g.a, row + 128 * i + 4 * lane, a32);
        v[4 * i] = f.x;
        v[4 * i + 1] = f.y;
        v[4 * i + 2] = f.z;
        v[4 * i + 3] = f.w;
        if (NORM == kNormSum3) {   // ((q + k) + v) in f32, rounded to bf16
          const size_t plane = static_cast<size_t>(g.M) * K;
          const float4 f1 = load4(g.a, plane + row + 128 * i + 4 * lane, a32);
          const float4 f2 = load4(g.a, 2 * plane + row + 128 * i + 4 * lane, a32);
          v[4 * i] = bf16r(__fadd_rn(__fadd_rn(f.x, f1.x), f2.x));
          v[4 * i + 1] = bf16r(__fadd_rn(__fadd_rn(f.y, f1.y), f2.y));
          v[4 * i + 2] = bf16r(__fadd_rn(__fadd_rn(f.z, f1.z), f2.z));
          v[4 * i + 3] = bf16r(__fadd_rn(__fadd_rn(f.w, f1.w), f2.w));
        }
      }
    }
    if (NORM == kNormCast) {
#pragma unroll
      for (int i = 0; i < kMaxPanelK / 128; ++i)
        if (i < nkc)
          *reinterpret_cast<uint32_t*>(dst + 128 * i + 4 * lane) =
              pack4(cast_s8(v[4 * i]), cast_s8(v[4 * i + 1]), cast_s8(v[4 * i + 2]),
                    cast_s8(v[4 * i + 3]));
      continue;
    }
    float mean = 0.0f, rstd = 1.0f;
    if (NORM == kNormLN1) {
      float s = 0.0f, q = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxPanelK / 32; ++i)
        if (i / 4 < nkc) {
          s = __fadd_rn(s, v[i]);
          q = __fadd_rn(q, __fmul_rn(v[i], v[i]));
        }
      mean = __fdiv_rn(warp_sum(s), static_cast<float>(K));
      const float var = __fsub_rn(__fdiv_rn(warp_sum(q), static_cast<float>(K)), __fmul_rn(mean, mean));
      rstd = rsqrtf(__fadd_rn(var, kLnEps));
    } else if (!kPlain) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxPanelK / 32; ++i)
        if (i / 4 < nkc) s = __fadd_rn(s, v[i]);
      mean = __fdiv_rn(warp_sum(s), static_cast<float>(K));
      float q = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxPanelK / 32; ++i)
        if (i / 4 < nkc) {
          const float d = __fsub_rn(v[i], mean);
          q = __fadd_rn(q, __fmul_rn(d, d));
        }
      rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), static_cast<float>(K)), kLnEps));
    }
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxPanelK / 32; ++i) {
      if (i / 4 < nkc) {
        const int k = 128 * (i / 4) + 4 * lane + (i % 4);
        const float m0v = kPlain ? 0.0f : g.mod[k];
        const float m1v = kPlain ? 0.0f : g.mod[K + k];
        v[i] = prologue<kPlain ? kNormNone : NORM>(v[i], mean, rstd, m0v, m1v);
        amax = fmaxf(amax, fabsf(v[i]));
      }
    }
    const float s = st ? g.s_static : row_scale(warp_max(amax));
    if (KEEP) {
      const float am = warp_max(amax);
      if (lane == 0 && blockIdx.x == 0 && blockIdx.z == 0) g.amax_out[r] = am;
    }
#pragma unroll
    for (int i = 0; i < kMaxPanelK / 128; ++i) {
      if (i < nkc) {
        *reinterpret_cast<uint32_t*>(dst + 128 * i + 4 * lane) =
            pack4(quantize(v[4 * i], s, g.inv_static, st), quantize(v[4 * i + 1], s, g.inv_static, st),
                  quantize(v[4 * i + 2], s, g.inv_static, st), quantize(v[4 * i + 3], s, g.inv_static, st));
      }
    }
    if (lane == 0) srow[lr] = s;
  }
}

// A stream-mode block holds ~25 KB of shared memory, so its registers set how
// many blocks share an SM: held to 80 (three blocks per SM) it ran 20-25 %
// faster on the H100 than at the 96-98 the compiler picks (two blocks).
template <int AMODE, int NORM, bool W4, int EPI, int EF>
__global__ void __launch_bounds__(kThreads, AMODE == kStream ? 3 : 1)
int8_gemm_kernel(const GemmArgs g) {
  const int ef = EF == kEfAny ? g.ef : EF;   // a constant unless EF is kEfAny
  const bool gelu = ef & kEfGelu, has_res = ef & kEfRes, res32 = ef & kEfResF32;
  const bool out32 = ef & kEfOutF32, a32 = ef & kEfAF32;
  const bool keep_max = EPI == kEpiStore && (ef & kEfMax);
  // the T2 probe's flags: compile-time only, false in every other instantiation
  constexpr bool kMidBf = EF != kEfAny && (EF & kEfMidBf16) != 0;
  constexpr bool kSigC = EF != kEfAny && (EF & kEfSigC) != 0;
  constexpr bool kFastSig = EF != kEfAny && (EF & kEfFastSig) != 0;
  constexpr bool kQBf = EF != kEfAny && (EF & kEfQBf16) != 0;
  constexpr bool kRawBf = EF != kEfAny && (EF & kEfRawBf16) != 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;      // 2 x 4 warps of 32 x 32
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.y * BM, z = blockIdx.z;
  const int M = g.M, K = g.K, N = g.N;
  const int Kb = W4 ? K / 2 : K;                // stored bytes per weight row
  constexpr int kSub = W4 ? 2 : 1;              // A chunks per step (k, k + K/2)
  const int a_cols = AMODE == kPanel ? K : kSub * KS;
  const int a_stride = a_cols + 16;
  const int a_stages = AMODE == kInt8 ? 2 : 1;
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + a_stages * BM * a_stride;
  float* srow = reinterpret_cast<float*>(Bs + 2 * BN * kBStride);
  const int8_t* __restrict__ W = g.w[z];
  const bool st = g.is_static != 0;
  const int nsteps = Kb / KS;
  const int nch = AMODE == kPanel ? 1 : g.nch;  // row scales per row (one per K chunk)
  const int chunk_steps = nsteps / nch;

  // one pipeline stage: the weight tile (and, in int8 mode, the A chunks)
  auto load_stage = [&](int n0, int step, int stage) {
    int8_t* dst = Bs + stage * BN * kBStride;
    for (int c = tid; c < BN * (KS / 16); c += kThreads) {
      const int n = c / (KS / 16), part = c % (KS / 16);
      cp_async16(dst + n * kBStride + part * 16,
                 W + static_cast<size_t>(n0 + n) * Kb + step * KS + part * 16);
    }
    if (AMODE == kInt8) {
      const int8_t* src = static_cast<const int8_t*>(g.a);
      int8_t* adst = As + stage * BM * a_stride;
      for (int c = tid; c < kSub * BM * (KS / 16); c += kThreads) {
        const int sub = c / (BM * (KS / 16)), rem = c % (BM * (KS / 16));
        const int lr = rem / (KS / 16), part = rem % (KS / 16), r = m0 + lr;
        int8_t* d = adst + lr * a_stride + sub * KS + part * 16;
        if (r < M)
          cp_async16(d, src + static_cast<size_t>(r) * K + (sub ? K / 2 : 0) + step * KS + part * 16);
        else
          *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };

  if (AMODE == kPanel) {
    build_panel<NORM, EPI == kEpiClip8 || EPI == kEpiShift8>(g, a32, As, a_stride, srow, m0, warp,
                                                              lane);
  } else {
    for (int i = tid; i < BM * nch; i += kThreads) {
      const int r = m0 + i / nch;
      srow[i] = st ? g.s_static
                   : (r < M ? row_scale(g.amax_in[static_cast<size_t>(m0) * nch + i]) : 1.0f);
      if (kQBf && !st) srow[i] = bf16r(srow[i]);
    }
  }
  __syncthreads();

  for (int tile = 0; tile < g.nt; ++tile) {
    const int n0 = (blockIdx.x * g.nt + tile) * BN;
    int acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    // kEpiChunked: the f32 accumulator, from the residual, and this warp's column scales
    float yacc[2][4][4], csc[4][2];
    if (EPI == kEpiChunked) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + tq * 2;
        csc[j][0] = g.scale[z][n];
        csc[j][1] = g.scale[z][n + 1];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = m0 + wm * 32 + i * 16 + gq + hf * 8;
            const float2 rv = r < M ? load2(g.residual, static_cast<size_t>(r) * N + n, res32)
                                    : make_float2(0.0f, 0.0f);
            yacc[i][j][2 * hf] = rv.x;
            yacc[i][j][2 * hf + 1] = rv.y;
          }
      }
    }

    load_stage(n0, 0, 0);
    for (int step = 0; step < nsteps; ++step) {
      if (step + 1 < nsteps) load_stage(n0, step + 1, (step + 1) & 1);
      if (AMODE == kStream) {
        // quantize this step's A chunk(s): k in [step*KS, +KS) (and + K/2 for W4)
        const int c_k = step / chunk_steps;
        for (int c = tid; c < kSub * BM * (KS / 4); c += kThreads) {
          const int sub = c / (BM * (KS / 4)), rem = c % (BM * (KS / 4));
          const int lr = rem / (KS / 4), part = rem % (KS / 4), r = m0 + lr;
          uint32_t word = 0u;
          if (r < M) {
            const float4 f = load4(g.a, static_cast<size_t>(r) * K + (sub ? K / 2 : 0) + step * KS + part * 4,
                                   a32);
            const float s = srow[lr * nch + c_k];
            if (kQBf)
              word = pack4(quantize_bf16(f.x, s), quantize_bf16(f.y, s), quantize_bf16(f.z, s),
                           quantize_bf16(f.w, s));
            else
              word = pack4(quantize(f.x, s, g.inv_static, st), quantize(f.y, s, g.inv_static, st),
                           quantize(f.z, s, g.inv_static, st), quantize(f.w, s, g.inv_static, st));
          }
          *reinterpret_cast<uint32_t*>(As + lr * a_stride + sub * KS + part * 4) = word;
        }
      }
      if (step + 1 < nsteps) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();

      const int8_t* Bst = Bs + (step & 1) * BN * kBStride;
      const int8_t* Ast = As + (AMODE == kInt8 ? (step & 1) * BM * a_stride : 0);
#pragma unroll
      for (int ks = 0; ks < KS / 32; ++ks) {
        uint32_t b[2][4][2];   // [half][n-tile][reg]; half 1 only for W4
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int8_t* bp = Bst + (wn * 32 + j * 8 + gq) * kBStride + ks * 32 + tq * 4;
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(bp);
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(bp + 16);
          if (W4) {
            unpack_w4(w0, b[0][j][0], b[1][j][0]);
            unpack_w4(w1, b[0][j][1], b[1][j][1]);
          } else {
            b[0][j][0] = w0;
            b[0][j][1] = w1;
          }
        }
#pragma unroll
        for (int half = 0; half < kSub; ++half) {
          const int ka = AMODE == kPanel ? (half ? K / 2 : 0) + step * KS + ks * 32
                                         : half * KS + ks * 32;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int8_t* ap = Ast + (wm * 32 + i * 16 + gq) * a_stride + ka + tq * 4;
            uint32_t a[4];
            a[0] = *reinterpret_cast<const uint32_t*>(ap);
            a[1] = *reinterpret_cast<const uint32_t*>(ap + 8 * a_stride);
            a[2] = *reinterpret_cast<const uint32_t*>(ap + 16);
            a[3] = *reinterpret_cast<const uint32_t*>(ap + 8 * a_stride + 16);
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a, b[half][j][0], b[half][j][1]);
          }
        }
      }
      __syncthreads();  // this stage's tiles consumed before they are refilled
      if (EPI == kEpiChunked && (step + 1) % chunk_steps == 0) {
        // end of K chunk c: y += acc * (s_c * scale), in the plain twin's order
        const int c_k = step / chunk_steps;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float s = srow[(wm * 32 + i * 16 + gq + hf * 8) * nch + c_k];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& y = yacc[i][j][2 * hf + e];
                y = __fadd_rn(y, __fmul_rn(static_cast<float>(acc[i][j][2 * hf + e]),
                                           __fmul_rn(s, csc[j][e])));
                acc[i][j][2 * hf + e] = 0;
              }
          }
      }
    }

    if (EPI == kEpiRaw) {
      // T1: no scale, no bias; out32 converts each exact int32 sum to f32 once
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = m0 + wm * 32 + i * 16 + gq + hf * 8;
            if (r >= M) continue;
            const size_t o = static_cast<size_t>(r) * N + n0 + wn * 32 + j * 8 + tq * 2;
            const int s0 = acc[i][j][2 * hf], s1 = acc[i][j][2 * hf + 1];
            if (kRawBf)
              store2(g.out[z], o, static_cast<float>(s0), static_cast<float>(s1), false);
            else if (out32)
              *reinterpret_cast<float2*>(static_cast<float*>(g.out[z]) + o) =
                  make_float2(static_cast<float>(s0), static_cast<float>(s1));
            else
              *reinterpret_cast<int2*>(static_cast<int*>(g.out[z]) + o) = make_int2(s0, s1);
          }
      continue;
    }
    if (EPI == kEpiWrap8 || EPI == kEpiShift8) {
      // T2 dots_only: the sums' low bytes; no_deq_mid: clip(sum >> 7, +-127)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = m0 + wm * 32 + i * 16 + gq + hf * 8;
            if (r >= M) continue;
            const size_t o = static_cast<size_t>(r) * N + n0 + wn * 32 + j * 8 + tq * 2;
            int q0 = acc[i][j][2 * hf], q1 = acc[i][j][2 * hf + 1];
            if (EPI == kEpiShift8) {
              q0 = min(max(q0 >> 7, -127), 127);
              q1 = min(max(q1 >> 7, -127), 127);
            }
            *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(g.out[z]) + o) =
                static_cast<uint16_t>((q0 & 0xFF) | ((q1 & 0xFF) << 8));
          }
      continue;
    }

    // epilogue
    const float* __restrict__ scale = g.scale[z];
    const float* __restrict__ bias = g.bias[z];
    const int chunk = keep_max ? n0 / (N / g.nch) : 0;   // a 128-wide tile lies in one N chunk
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float rmax[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + tq * 2;
        const float sc0 = scale[n], sc1 = scale[n + 1], b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int lr = wm * 32 + i * 16 + gq + hf * 8, r = m0 + lr;
          if (r >= M) continue;
          const size_t o = static_cast<size_t>(r) * N + n;
          float y0, y1;
          if (EPI == kEpiChunked) {
            y0 = __fadd_rn(yacc[i][j][2 * hf], b0);
            y1 = __fadd_rn(yacc[i][j][2 * hf + 1], b1);
          } else {
            const float s = srow[lr];
            if (kMidBf) {
              y0 = dequant_bf16(acc[i][j][2 * hf], s, sc0, b0);
              y1 = dequant_bf16(acc[i][j][2 * hf + 1], s, sc1, b1);
            } else {
              y0 = dequant(acc[i][j][2 * hf], s, sc0, b0);
              y1 = dequant(acc[i][j][2 * hf + 1], s, sc1, b1);
            }
          }
          if (EPI == kEpiGeluInt8) {
            const int q0 = quantize(gelu2(y0), 0.0f, g.out_inv, true);
            const int q1 = quantize(gelu2(y1), 0.0f, g.out_inv, true);
            *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(g.out[z]) + o) =
                static_cast<uint16_t>((q0 & 0xFF) | ((q1 & 0xFF) << 8));
            continue;
          }
          if (EPI == kEpiClip8) {   // T2 no_quant_mid
            const int q0 = clip_cast_s8(gelu ? gelu2(y0) : y0);
            const int q1 = clip_cast_s8(gelu ? gelu2(y1) : y1);
            *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(g.out[z]) + o) =
                static_cast<uint16_t>((q0 & 0xFF) | ((q1 & 0xFF) << 8));
            continue;
          }
          if (EPI == kEpiStore) {
            if (gelu) {
              if (kMidBf) {
                y0 = gelu2_bf16<kSigC>(y0);
                y1 = gelu2_bf16<kSigC>(y1);
              } else if (kFastSig) {
                y0 = gelu_fast(y0);
                y1 = gelu_fast(y1);
              } else {
                y0 = gelu2(y0);
                y1 = gelu2(y1);
              }
            }
            if (has_res) {
              const float2 rv = load2(g.residual, o, res32);
              y0 = __fadd_rn(y0, rv.x);
              y1 = __fadd_rn(y1, rv.y);
            }
            if (keep_max) rmax[hf] = fmaxf(rmax[hf], fmaxf(fabsf(y0), fabsf(y1)));
          }
          store2(g.out[z], o, y0, y1, out32);
        }
      }
      if (keep_max) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float v = rmax[hf];
          v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
          v = fmaxf(v, __shfl_xor_sync(kFull, v, 2));
          if (kMidBf) v = fmaxf(v, g.amax_floor);
          const int r = m0 + wm * 32 + i * 16 + gq + hf * 8;
          // |y| >= 0, so its bits order as ints do
          if (tq == 0 && r < M)
            atomicMax(reinterpret_cast<int*>(g.amax_out + static_cast<size_t>(r) * g.nch + chunk),
                      __float_as_int(v));
        }
      }
    }
  }
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <int AMODE, int NORM, bool W4, int EPI, int EF>
int launch_gemm(GemmArgs g, int n_w, cudaStream_t stream) {
  const int a_cols = AMODE == kPanel ? g.K : (W4 ? 2 * KS : KS);
  const int a_stages = AMODE == kInt8 ? 2 : 1;
  const size_t smem = static_cast<size_t>(a_stages) * BM * (a_cols + 16) + 2 * BN * kBStride +
                      BM * (AMODE == kPanel ? 1 : g.nch) * sizeof(float);
  // A panel block builds its rows once and sweeps nt output tiles with them:
  // the fewest tiles per block that still gives two blocks per SM.
  const int tiles = g.N / BN, row_blocks = (g.M + BM - 1) / BM;
  g.nt = 1;
  if (AMODE == kPanel) {
    while (g.nt < tiles && (n_w * (tiles / g.nt) * row_blocks > 2 * num_sms() ||
                            tiles % g.nt != 0))
      ++g.nt;
  }
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(int8_gemm_kernel<AMODE, NORM, W4, EPI, EF>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               200 * 1024);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  if (EPI == kEpiStore && (g.ef & kEfMax)) {
    const cudaError_t e = cudaMemsetAsync(g.amax_out, 0, sizeof(float) * g.M * g.nch, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(tiles / g.nt, row_blocks, n_w);
  int8_gemm_kernel<AMODE, NORM, W4, EPI, EF><<<grid, kThreads, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// GemmArgs from the arguments of t2s_int8_dense (int8_block.cu, int8_probe.cu:
// the same C signature, each with its own table of instantiations); false
// where they lie outside what either mainloop takes.
bool dense_args(GemmArgs& g, int amode, int norm, int w4, int epi, const void* a, int a_f32,
                const void* mod, const void* amax_in, float s_static, float inv_static,
                int is_static, int n_w, const void* const (&ws)[3], const void* const (&scs)[3],
                const void* const (&bs)[3], void* const (&os)[3], const void* residual, int res_f32,
                int gelu, int out_f32, void* amax_out, float out_inv, int nch, int M, int K, int N,
                int probe, float amax_floor) {
  g.a = a;
  g.ef = (gelu ? kEfGelu : 0) | (residual != nullptr ? kEfRes : 0) | (res_f32 ? kEfResF32 : 0) |
         (out_f32 ? kEfOutF32 : 0) | (amax_out != nullptr ? kEfMax : 0) | (a_f32 ? kEfAF32 : 0) |
         probe;
  g.mod = static_cast<const float*>(mod);
  g.amax_in = static_cast<const float*>(amax_in);
  g.s_static = s_static;
  g.inv_static = inv_static;
  g.is_static = is_static;
  for (int i = 0; i < 3; ++i) {
    g.w[i] = static_cast<const int8_t*>(ws[i]);
    g.scale[i] = static_cast<const float*>(scs[i]);
    g.bias[i] = static_cast<const float*>(bs[i]);
    g.out[i] = os[i];
  }
  g.residual = residual;
  g.amax_out = static_cast<float*>(amax_out);
  g.out_inv = out_inv;
  g.nch = nch;
  g.nt = 1;
  g.amax_floor = amax_floor;
  g.M = M;
  g.K = K;
  g.N = N;
  const int Kb = w4 ? K / 2 : K;
  return !(M <= 0 || n_w < 1 || n_w > 3 || N % BN != 0 || Kb % KS != 0 || nch < 1 ||
           (amode == kPanel && (K % 128 != 0 || K > kMaxPanelK || epi == kEpiChunked)) ||
           (amode != kPanel && (K % nch != 0 || (K / nch) % KS != 0 || (w4 && nch != 1))) ||
           (amax_out != nullptr && (N % nch != 0 || (N / nch) % BN != 0)) ||
           (epi == kEpiChunked && residual == nullptr) || (probe & ~kEfProbe) != 0 ||
           ((epi == kEpiClip8 || epi == kEpiShift8) && amax_out == nullptr));
}

}  // namespace
