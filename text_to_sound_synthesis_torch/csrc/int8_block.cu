// The int8 kernels of the serving engine (K3-K9) for Hopper, sm_90a.
//
// Replaces, from text_to_sound_synthesis_tpu/ops/:
//   int8_block.py::self_attn_block (K4), ::cross_attn_block (K5),
//   ::mlp_block (K3), ::attn_pair_block (K8), ::mlp_block_chunked and
//   ::mlp_block_streamed (K9): Pallas TPU kernels that each run one or two
//   sub-blocks of a denoiser layer with everything resident in VMEM;
//   quant.py::fused_quant_dense / fused_quant_dense_multi (K6): the
//   per-dense [LN/AdaLN] -> quantize -> int8 dots -> dequant [-> GELU2]
//   [-> + residual] kernel of the engine's impl="pallas_dense" path;
//   attention.py::fused_mha (K7): the bf16 MHA of that path.
// The plain PyTorch twins are the *_reference functions of
// text_to_sound_synthesis_torch/ops/{quant,attention,int8_block}.py; the
// wrappers there compose the launches below into the TPU kernels.
//
// What bounds them on an H100. Per layer at the flagship shape (M = 8*265 =
// 2120 rows, D 1024, 16 heads of 64, 4D MLP) the int8 dots are 62 GOP; at
// the card's 1979 int8 TOP/s that is 31 us, while the weights (7 MB in W4, 14
// in W8) stream in 2-4 us and the activations stay in the 50 MB L2. So the
// dots bound the block, then the attention (3 GFLOP of bf16 products per
// layer, f32 softmax).
// A v5e program keeps a whole row block, all four attention weights and the
// f32 scores of all heads in VMEM; 227 KB of shared memory cannot, and two
// things need a whole row before anything can be quantized: a dynamic row
// quantize needs the row's max |h| (1024 wide for the block inputs, 4096 wide
// for the MLP's middle), and the self-attention reads all 265 keys of a head.
// So each TPU kernel becomes two or three launches here:
//   K4: [AdaLN + quantize + q/k/v dots] -> [MHA, one block per (batch, head)]
//       -> [quantize + proj dot + residual]
//   K5: [AdaLN + quantize + q dot] -> [MHA against the condition K/V]
//       -> [quantize + proj dot + residual]
//   K3: [LN + quantize + fc1 dot + GELU2 -> int8 with the static s_mid]
//       -> [fc2 dot + residual]; with a dynamic middle the first launch
//       writes f32 and the row max |u| instead, and the second quantizes on
//       the fly.
//   K8: K4's three launches, then K5's, with x kept in f32 between the two
//       halves: the self proj writes f32 x + residual, the cross AdaLN panel
//       reads f32 rows, the cross proj adds the f32 residual and rounds once.
//   K9: K3 with the 4096 hidden columns in n chunks, each with its own
//       dynamic row scale: fc1 gathers the row max |u| per (row, chunk); fc2
//       flushes its int32 sums into an f32 accumulator at each chunk's end,
//       y = x, y += acc_c * (s_c * scale) for c = 0..n-1, then + bias.
//   K6: one GEMM launch; at K > 1024 (fc2 of the per-dense path, bf16 input)
//       a one-warp-per-row pre-pass finds each row's max |h| first, unless
//       the scale is static.
//   K7: the MHA launch alone.
// All dots are one templated GEMM, `int8_gemm_kernel`:
//   - a block owns a 64 x 128 output tile, 8 warps of 32 x 32, each a grid of
//     mma.sync.m16n8k32 s8 x s8 -> s32 products (exact integer sums);
//   - "panel" mode builds its A operand itself: each block normalises,
//     quantizes and keeps its 64 full rows (K <= 1024, bf16 or f32) as int8
//     in shared memory (row max |h| taken there, no second pass over HBM),
//     then sweeps as many 128-wide output tiles as still leaves two blocks
//     per SM, so the prologue is not redone for every tile;
//   - "int8" mode reads an int8 A through the same cp.async ring as the
//     weight (the MLP middle under a static scale);
//   - "stream" mode reads f32 or bf16 rows in K chunks and quantizes them on
//     the fly with row scales known beforehand, one per row and K chunk (the
//     MLP middle under dynamic scales: its row max is gathered by atomics in
//     the fc1 epilogue);
//   - the weight (N, K) K-contiguous, int8 or nibble-packed W4, streams
//     through a two-stage cp.async ring of 128 x 64-byte tiles; a W4 tile's
//     bytes hold k and k + K/2, so each packed word unpacks in registers into
//     the B fragments of two k windows and feeds two products;
//   - the epilogue dequantizes (acc * (s_row * scale_col) + bias, in that
//     order), then either [GELU2] [+ bf16 or f32 residual] -> bf16 or f32
//     (with the row max |y| per chunk when asked), or GELU2 quantized to
//     int8, or (chunked) the f32 accumulator + bias -> bf16.
// Shared-memory rows are padded by 16 bytes so fragment loads hit 32 banks.
// The attention keeps one head's K and V (bf16) in shared memory and runs
// Q K^T and P V on the tensor cores (mma.sync m16n8k16 bf16, f32 sums), 16
// queries per warp with all of their scores in registers: keys >= kv_valid
// at -inf, f32 softmax over all keys, p normalised then rounded to bf16, P V
// summed in f32, rounded to bf16 (see mha_kernel); or, with the softmax's
// divide folded into the output (T2S_SOFTMAX_FOLD_DIV), exp(s - max) rounded
// to bf16 and the f32 P V sums divided by the row sum before the rounding.
// K10, the int8 attention, is in mha_int8.cu.
// The rounding points are the twins': q/k/v, p, the attention output and
// every block output in bf16. No --use_fast_math.
// T1 (tools/bench_kernel_dot.py::make_pallas_dot, the bare dot probe) runs
// this GEMM in its int8 mode with a raw epilogue (two more instantiations;
// the others' code is unchanged), and its bf16 case a kernel of the same
// tiling on mma.sync bf16 (bf16_dot_kernel): t2s_tiled_dot. At the probe's
// fc1 shape (2176 x 1024 x 4096) bytes bound it: 42 MB (mostly the int32
// output) take 12.6 us at 3.35 TB/s, the 18.2 GOP of products 9.2 us at the
// int8 peak; the probe reads how far the shared mainloop is from either.

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
enum Epi { kEpiStore = 0, kEpiGeluInt8 = 1, kEpiChunked = 2, kEpiRaw = 3 };
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
};
constexpr int kEfAny = -1;

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
  float* amax_out;           // kEfMax: (M, nch) row max |y| per N chunk (zeroed)
  float out_inv;             // kEpiGeluInt8: f32(1 / s) of the output's static scale
  int M, K, N;
  int nch;                   // chunks of K (stream and int8 modes) or of N (amax_out)
  int nt;                    // 128-wide output tiles per block (panel mode reuses its rows)
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

template <int NORM>
__device__ __forceinline__ void build_panel(const GemmArgs& g, bool a32, int8_t* As, int a_stride,
                                            float* srow, int m0, int warp, int lane) {
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
      }
    }
    float mean = 0.0f, rstd = 1.0f;
    if (NORM != kNormNone) {
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
        const float m0v = NORM == kNormNone ? 0.0f : g.mod[k];
        const float m1v = NORM == kNormNone ? 0.0f : g.mod[K + k];
        v[i] = prologue<NORM>(v[i], mean, rstd, m0v, m1v);
        amax = fmaxf(amax, fabsf(v[i]));
      }
    }
    const float s = st ? g.s_static : row_scale(warp_max(amax));
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
    build_panel<NORM>(g, a32, As, a_stride, srow, m0, warp, lane);
  } else {
    for (int i = tid; i < BM * nch; i += kThreads) {
      const int r = m0 + i / nch;
      srow[i] = st ? g.s_static
                   : (r < M ? row_scale(g.amax_in[static_cast<size_t>(m0) * nch + i]) : 1.0f);
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
            if (out32)
              *reinterpret_cast<float2*>(static_cast<float*>(g.out[z]) + o) =
                  make_float2(static_cast<float>(s0), static_cast<float>(s1));
            else
              *reinterpret_cast<int2*>(static_cast<int*>(g.out[z]) + o) = make_int2(s0, s1);
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
            y0 = dequant(acc[i][j][2 * hf], s, sc0, b0);
            y1 = dequant(acc[i][j][2 * hf + 1], s, sc1, b1);
          }
          if (EPI == kEpiGeluInt8) {
            const int q0 = quantize(gelu2(y0), 0.0f, g.out_inv, true);
            const int q1 = quantize(gelu2(y1), 0.0f, g.out_inv, true);
            *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(g.out[z]) + o) =
                static_cast<uint16_t>((q0 & 0xFF) | ((q1 & 0xFF) << 8));
            continue;
          }
          if (EPI == kEpiStore) {
            if (gelu) {
              y0 = gelu2(y0);
              y1 = gelu2(y1);
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

// Row max |a| of a (M, K) bf16 matrix, one warp per row (the dynamic row
// scale of a dense whose input is too wide for a panel).
__global__ void __launch_bounds__(256) row_amax_kernel(const __nv_bfloat16* __restrict__ a, int M,
                                                       int K, float* __restrict__ amax) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const __nv_bfloat16* src = a + static_cast<size_t>(row) * K;
  float m = 0.0f;
  for (int k = lane * 8; k < K; k += 256) {
    const uint4 w = *reinterpret_cast<const uint4*>(src + k);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      m = fmaxf(m, fmaxf(fabsf(__low2float(p[e])), fabsf(__high2float(p[e]))));
  }
  m = warp_max(m);
  if (lane == 0) amax[row] = m;
}

// T1's bf16 case, out (M, N) f32 = a (M, K) bf16 . w (N, K) bf16: the int8
// mode's tiling with mma.sync m16n8k16 bf16 -> f32. A block owns a 64 x 128
// tile, 8 warps of 32 x 32; A and the weight stream through the same two-stage
// cp.async ring of 64-byte rows (32 bf16, two k16 slices), padded to
// kBStride; every fragment sits at the bytes of its s8 counterpart.
__global__ void __launch_bounds__(kThreads) bf16_dot_kernel(const __nv_bfloat16* __restrict__ a,
                                                            const __nv_bfloat16* __restrict__ w,
                                                            float* __restrict__ out, int M, int K,
                                                            int N) {
  __shared__ __align__(16) int8_t sm[2 * (BM + BN) * kBStride];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int gq = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const size_t Kb = 2 * static_cast<size_t>(K);    // bytes of a row
  const int nsteps = static_cast<int>(Kb / KS);
  const char* A = reinterpret_cast<const char*>(a);
  const char* W = reinterpret_cast<const char*>(w);

  auto load_stage = [&](int step, int stage) {
    int8_t* As = sm + stage * (BM + BN) * kBStride;
    int8_t* Bs = As + BM * kBStride;
    for (int c = tid; c < (BM + BN) * (KS / 16); c += kThreads) {
      const int row = c / (KS / 16), part = c % (KS / 16);
      if (row >= BM) {
        const int n = row - BM;
        cp_async16(Bs + n * kBStride + part * 16, W + (n0 + n) * Kb + step * KS + part * 16);
      } else if (m0 + row < M) {
        cp_async16(As + row * kBStride + part * 16, A + (m0 + row) * Kb + step * KS + part * 16);
      } else {
        *reinterpret_cast<uint4*>(As + row * kBStride + part * 16) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  load_stage(0, 0);
  for (int step = 0; step < nsteps; ++step) {
    if (step + 1 < nsteps) load_stage(step + 1, (step + 1) & 1);
    if (step + 1 < nsteps) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const int8_t* Ast = sm + (step & 1) * (BM + BN) * kBStride;
    const int8_t* Bst = Ast + BM * kBStride;
#pragma unroll
    for (int ks = 0; ks < KS / 32; ++ks) {
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* bp = Bst + (wn * 32 + j * 8 + gq) * kBStride + ks * 32 + tq * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(bp);
        b[j][1] = *reinterpret_cast<const uint32_t*>(bp + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* ap = Ast + (wm * 32 + i * 16 + gq) * kBStride + ks * 32 + tq * 4;
        uint32_t af[4];
        af[0] = *reinterpret_cast<const uint32_t*>(ap);
        af[1] = *reinterpret_cast<const uint32_t*>(ap + 8 * kBStride);
        af[2] = *reinterpret_cast<const uint32_t*>(ap + 16);
        af[3] = *reinterpret_cast<const uint32_t*>(ap + 8 * kBStride + 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af, b[j][0], b[j][1]);
      }
    }
    __syncthreads();  // this stage consumed before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = m0 + wm * 32 + i * 16 + gq + hf * 8;
        if (r < M)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * N + n0 + wn * 32 + j * 8 + tq * 2) =
              make_float2(acc[i][j][2 * hf], acc[i][j][2 * hf + 1]);
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

// ---------------------------------------------------------------------------
// multi-head attention over the flat (B*L, D) layout, one head per block
// ---------------------------------------------------------------------------

constexpr int kMhaWarps = 8;               // each warp takes 16 queries at a time

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One block per (batch b, head h): the head's K (keys x HD) and V transposed
// (HD x keys) are loaded once into shared memory, zero-padded to NKT*8 keys,
// and its warps take the queries 16 at a time. Scores S = Q K^T and P V run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 sums); the warp's whole 16 x NKT*8 score
// tile stays in registers, so the softmax is exact (max and sum over all keys
// first, then p = exp(s - max) / sum rounded to bf16), and the rounded p is
// the A operand of P V straight from the score registers. FOLD: p =
// exp(s - max) rounded to bf16, and the f32 output divided by the sum.
template <int HD, int NKT, bool FOLD>
__global__ void __launch_bounds__(kMhaWarps * 32)
mha_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int Lq,
           int Lkv, int D, int kv_valid, float sqrt_hd) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kKeys = NKT * 8;
  constexpr int kKRow = HD + 8;          // bf16; 16-byte rows, conflict-free fragments
  constexpr int kVRow = kKeys + 8;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);   // [kKeys][kKRow]
  __nv_bfloat16* Vt = Ks + kKeys * kKRow;                        // [HD][kVRow]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;

  for (int i = tid; i < kKeys * (HD / 8); i += kMhaWarps * 32) {
    const int j = i / (HD / 8), w = i % (HD / 8);   // key j, dims 8w .. 8w + 7
    uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
    if (j < Lkv) {
      const size_t src = (static_cast<size_t>(b) * Lkv + j) * D + h * HD + 8 * w;
      kw = *reinterpret_cast<const uint4*>(k + src);
      vw = *reinterpret_cast<const uint4*>(v + src);
    }
    *reinterpret_cast<uint4*>(Ks + j * kKRow + 8 * w) = kw;
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vw);
#pragma unroll
    for (int e = 0; e < 8; ++e) Vt[(8 * w + e) * kVRow + j] = ve[e];
  }
  __syncthreads();

  for (int q0 = warp * 16; q0 < Lq; q0 += kMhaWarps * 16) {
    // Q fragments for the warp's 16 rows (rows past Lq read row Lq - 1)
    const int r0 = min(q0 + gq, Lq - 1), r1 = min(q0 + gq + 8, Lq - 1);
    const __nv_bfloat16* q_r0 = q + (static_cast<size_t>(b) * Lq + r0) * D + h * HD;
    const __nv_bfloat16* q_r1 = q + (static_cast<size_t>(b) * Lq + r1) * D + h * HD;
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(q_r0 + kk * 16 + 2 * tq);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(q_r1 + kk * 16 + 2 * tq);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(q_r0 + kk * 16 + 8 + 2 * tq);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(q_r1 + kk * 16 + 8 + 2 * tq);
    }

    // S = Q K^T over all (padded) keys
    float s[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      const __nv_bfloat16* kr = Ks + (j * 8 + gq) * kKRow + 2 * tq;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_bf16(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(kr + kk * 16),
                 *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
    }

    // exact softmax per row: rows gq (regs 0, 1) and gq + 8 (regs 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * tq + (e & 1);
        s[j][e] = key < kv_valid ? __fdiv_rn(s[j][e], sqrt_hd) : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    }
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - mx[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
      sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
    }

    // O = P V, P = bf16(exp / sum) (FOLD: bf16(exp)) from the score registers
    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
    auto p_of = [&](float e, float sm) { return FOLD ? e : __fdiv_rn(e, sm); };
#pragma unroll
    for (int kk = 0; kk < NKT / 2; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(p_of(s[2 * kk][0], sum[0]), p_of(s[2 * kk][1], sum[0]));
      pa[1] = pack_bf16(p_of(s[2 * kk][2], sum[1]), p_of(s[2 * kk][3], sum[1]));
      pa[2] = pack_bf16(p_of(s[2 * kk + 1][0], sum[0]), p_of(s[2 * kk + 1][1], sum[0]));
      pa[3] = pack_bf16(p_of(s[2 * kk + 1][2], sum[1]), p_of(s[2 * kk + 1][3], sum[1]));
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const __nv_bfloat16* vr = Vt + (n * 8 + gq) * kVRow + kk * 16 + 2 * tq;
        mma_bf16(o[n], pa, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }

#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      if (FOLD) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = __fdiv_rn(o[n][e], sum[e >> 1]);
      }
      const int d = h * HD + n * 8 + 2 * tq;
      if (q0 + gq < Lq)
        *reinterpret_cast<__nv_bfloat162*>(out + (static_cast<size_t>(b) * Lq + q0 + gq) * D + d) =
            __floats2bfloat162_rn(o[n][0], o[n][1]);
      if (q0 + gq + 8 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(out + (static_cast<size_t>(b) * Lq + q0 + gq + 8) * D + d) =
            __floats2bfloat162_rn(o[n][2], o[n][3]);
    }
  }
}

template <int HD, int NKT, bool FOLD>
int launch_mha(const void* q, const void* k, const void* v, void* out, int batch, int Lq,
               int Lkv, int n_head, int kv_valid, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(NKT) * 8 * (HD + 8) + HD * (NKT * 8 + 8)) *
                      sizeof(__nv_bfloat16);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(mha_kernel<HD, NKT, FOLD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               200 * 1024);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid(1, n_head, batch);
  mha_kernel<HD, NKT, FOLD><<<grid, kMhaWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Lq, Lkv,
      n_head * HD, kv_valid, sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool FOLD>
int launch_mha_keys(const void* q, const void* k, const void* v, void* out, int batch, int Lq,
                    int Lkv, int n_head, int kv_valid, cudaStream_t stream) {
  if (Lkv <= 32)
    return launch_mha<HD, 4, FOLD>(q, k, v, out, batch, Lq, Lkv, n_head, kv_valid, stream);
  if (Lkv <= 80)
    return launch_mha<HD, 10, FOLD>(q, k, v, out, batch, Lq, Lkv, n_head, kv_valid, stream);
  if (Lkv <= 144)
    return launch_mha<HD, 18, FOLD>(q, k, v, out, batch, Lq, Lkv, n_head, kv_valid, stream);
  return launch_mha<HD, 34, FOLD>(q, k, v, out, batch, Lq, Lkv, n_head, kv_valid, stream);
}

}  // namespace

// Limits the wrappers check before they launch.
extern "C" int t2s_int8_limits(int which) {
  switch (which) {
    case 0: return kMaxPanelK;   // panel K
    case 1: return BN;           // N multiple
    case 2: return KS;           // stored K bytes multiple
    case 3: return 272;          // attention keys (score registers)
    default: return -1;
  }
}

// One quantized dense launch (see GemmArgs). amode: 0 panel (a = (M, K) bf16
// or f32, norm 0 none / 1 adaln / 2 ln with mod (2, K) f32), 1 stream (a =
// (M, K) f32 or bf16, row scales per K chunk from amax_in (M, nch) or static),
// 2 int8 (a = (M, K) int8 quantized with the static scale). epi: 0 [GELU2]
// [+ residual] -> bf16 or f32 (+ row max |y| per N chunk into amax_out (M,
// nch) when it is not NULL), 1 GELU2 quantized to int8 with out_inv, 2 the K
// dimension in nch chunks flushed into an f32 accumulator from the residual,
// + bias (stream or int8 mode, W8). Up to three weights share A; each writes
// its own out. Returns the CUDA error code.
extern "C" int t2s_int8_dense(int amode, int norm, int w4, int epi, const void* a, int a_f32,
                              const void* mod, const void* amax_in, float s_static,
                              float inv_static, int is_static, int n_w,
                              const void* w0, const void* sc0, const void* b0, void* o0,
                              const void* w1, const void* sc1, const void* b1, void* o1,
                              const void* w2, const void* sc2, const void* b2, void* o2,
                              const void* residual, int res_f32, int gelu, int out_f32,
                              void* amax_out, float out_inv, int nch, int M, int K, int N,
                              void* stream) {
  GemmArgs g;
  g.a = a;
  g.ef = (gelu ? kEfGelu : 0) | (residual != nullptr ? kEfRes : 0) | (res_f32 ? kEfResF32 : 0) |
         (out_f32 ? kEfOutF32 : 0) | (amax_out != nullptr ? kEfMax : 0) | (a_f32 ? kEfAF32 : 0);
  g.mod = static_cast<const float*>(mod);
  g.amax_in = static_cast<const float*>(amax_in);
  g.s_static = s_static;
  g.inv_static = inv_static;
  g.is_static = is_static;
  const void* ws[3] = {w0, w1, w2};
  const void* scs[3] = {sc0, sc1, sc2};
  const void* bs[3] = {b0, b1, b2};
  void* os[3] = {o0, o1, o2};
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
  g.M = M;
  g.K = K;
  g.N = N;
  const int Kb = w4 ? K / 2 : K;
  const bool bad =
      M <= 0 || n_w < 1 || n_w > 3 || N % BN != 0 || Kb % KS != 0 || nch < 1 ||
      (amode == kPanel && (K % 128 != 0 || K > kMaxPanelK || epi == kEpiChunked)) ||
      (amode != kPanel && (K % nch != 0 || (K / nch) % KS != 0 || (w4 && nch != 1))) ||
      (amax_out != nullptr && (N % nch != 0 || (N / nch) % BN != 0)) ||
      (epi == kEpiChunked && residual == nullptr);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define T2S_CASE(AM, NO, W4_, EP, EF)                                                      \
  if (amode == AM && norm == NO && (w4 != 0) == W4_ && epi == EP &&                        \
      ((EF) == kEfAny || g.ef == (EF)))                                                    \
    return launch_gemm<AM, NO, W4_, EP, (EF)>(g, n_w, s);
  // the engines' combinations, their flags compiled in
  T2S_CASE(kPanel, kNormAdaLN, false, kEpiStore, 0)                    // q/k/v, crossq
  T2S_CASE(kPanel, kNormAdaLN, true, kEpiStore, 0)
  T2S_CASE(kPanel, kNormAdaLN, false, kEpiStore, kEfAF32)              // K8: crossq from f32 x
  T2S_CASE(kPanel, kNormNone, false, kEpiStore, kEfRes)                // proj, crossproj
  T2S_CASE(kPanel, kNormNone, true, kEpiStore, kEfRes)
  T2S_CASE(kPanel, kNormNone, false, kEpiStore, kEfRes | kEfOutF32)    // K8: proj -> f32 x
  T2S_CASE(kPanel, kNormNone, false, kEpiStore, kEfRes | kEfResF32)    // K8: crossproj + f32 x
  T2S_CASE(kPanel, kNormLN, false, kEpiGeluInt8, 0)                    // K3 fc1, static
  T2S_CASE(kPanel, kNormLN, true, kEpiGeluInt8, 0)
  T2S_CASE(kPanel, kNormLN, false, kEpiStore, kEfGelu | kEfOutF32 | kEfMax)   // K3, K9 fc1
  T2S_CASE(kPanel, kNormLN, true, kEpiStore, kEfGelu | kEfOutF32 | kEfMax)
  T2S_CASE(kPanel, kNormLN, false, kEpiStore, kEfGelu)                 // K6 fc1
  T2S_CASE(kStream, kNormNone, false, kEpiStore, kEfRes | kEfAF32)     // K3 fc2, dynamic
  T2S_CASE(kStream, kNormNone, true, kEpiStore, kEfRes | kEfAF32)
  T2S_CASE(kStream, kNormNone, false, kEpiStore, kEfRes)               // K6 fc2
  T2S_CASE(kInt8, kNormNone, false, kEpiStore, kEfRes)                 // K3 fc2, static
  T2S_CASE(kInt8, kNormNone, true, kEpiStore, kEfRes)
  T2S_CASE(kStream, kNormNone, false, kEpiChunked, kEfRes | kEfAF32)   // K9 fc2, dynamic
  T2S_CASE(kInt8, kNormNone, false, kEpiChunked, kEfRes)               // K9 fc2, static
  // K6's other combinations (W8): the flags read at run time
  T2S_CASE(kPanel, kNormNone, false, kEpiStore, kEfAny)
  T2S_CASE(kPanel, kNormAdaLN, false, kEpiStore, kEfAny)
  T2S_CASE(kPanel, kNormLN, false, kEpiStore, kEfAny)
  T2S_CASE(kStream, kNormNone, false, kEpiStore, kEfAny)
#undef T2S_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Row max |a| of a (M, K) bf16 matrix into amax (M,) f32; K a multiple of 8.
extern "C" int t2s_int8_row_amax(const void* a, int M, int K, void* amax, void* stream) {
  if (M <= 0 || K <= 0 || K % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  row_amax_kernel<<<(M + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), M, K, static_cast<float*>(amax));
  return static_cast<int>(cudaGetLastError());
}

// T1, the bare tiled dot out (M, N) = a (M, K) . w (N, K)^T (weight
// K-contiguous): kind 0 int8 -> int32 and kind 1 int8 -> f32 through the
// engine's GEMM in its int8 A mode with the raw epilogue; kind 2 bf16 -> f32
// through bf16_dot_kernel. N a multiple of 128; K a multiple of 64 (int8) or
// 32 (bf16). Returns the CUDA error code.
extern "C" int t2s_tiled_dot(int kind, const void* a, const void* w, void* out, int M, int K,
                             int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || N <= 0 || N % BN != 0 || kind < 0 || kind > 2 ||
      (kind < 2 ? K % KS : (2 * K) % KS) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == 2) {
    const dim3 grid(N / BN, (M + BM - 1) / BM);
    bf16_dot_kernel<<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(a),
                                             static_cast<const __nv_bfloat16*>(w),
                                             static_cast<float*>(out), M, K, N);
    return static_cast<int>(cudaGetLastError());
  }
  GemmArgs g = {};
  g.a = a;
  g.ef = kind == 1 ? kEfOutF32 : 0;
  g.s_static = g.inv_static = 1.0f;   // the row scales are not read by the raw epilogue
  g.is_static = 1;
  g.w[0] = static_cast<const int8_t*>(w);
  g.out[0] = out;
  g.M = M;
  g.K = K;
  g.N = N;
  g.nch = 1;
  g.nt = 1;
  return kind == 1 ? launch_gemm<kInt8, kNormNone, false, kEpiRaw, kEfOutF32>(g, 1, s)
                   : launch_gemm<kInt8, kNormNone, false, kEpiRaw, 0>(g, 1, s);
}

// Multi-head attention: q (batch*Lq, H*hd), k/v (batch*Lkv, H*hd) bf16 ->
// out (batch*Lq, H*hd) bf16; keys >= kv_valid masked (0 < kv_valid <= Lkv).
// hd 32 or 64. fold_div: the softmax's divide folded into the output.
extern "C" int t2s_int8_mha(const void* q, const void* k, const void* v, void* out, int batch,
                            int Lq, int Lkv, int n_head, int hd, int kv_valid, int fold_div,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || Lq <= 0 || Lkv <= 0 || Lkv > 272 || kv_valid <= 0 || kv_valid > Lkv)
    return static_cast<int>(cudaErrorInvalidValue);
#define T2S_MHA(HD, FOLD) \
  if (hd == HD && (fold_div != 0) == FOLD) \
    return launch_mha_keys<HD, FOLD>(q, k, v, out, batch, Lq, Lkv, n_head, kv_valid, s);
  T2S_MHA(64, false)
  T2S_MHA(64, true)
  T2S_MHA(32, false)
  T2S_MHA(32, true)
#undef T2S_MHA
  return static_cast<int>(cudaErrorInvalidValue);
}
