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
// So each TPU kernel becomes several launches here:
//   K4: [AdaLN + quantize pass] -> [q/k/v dots, one launch] -> [MHA] ->
//       [quantize pass] -> [proj dot + residual]: five
//   K5: [AdaLN + quantize pass] -> [q dot] -> [MHA against the condition K/V]
//       -> [quantize pass] -> [proj dot + residual]: five
//   K3: [LN + quantize + fc1 dot + GELU2 -> int8 with the static s_mid]
//       -> [fc2 dot + residual]; with a dynamic middle the first launch
//       writes f32 and the row max |u| instead, and the second quantizes on
//       the fly.
//   K8: K4's five launches, then K5's, with x kept in f32 between the two
//       halves: the self proj writes f32 x + residual, the cross quantize
//       pass reads f32 rows, the cross proj adds the f32 residual and rounds
//       once.
//   K9: K3 with the 4096 hidden columns in n chunks, each with its own
//       dynamic row scale: fc1 gathers the row max |u| per (row, chunk); fc2
//       flushes its int32 sums into an f32 accumulator at each chunk's end,
//       y = x, y += acc_c * (s_c * scale) for c = 0..n-1, then + bias.
//   K6: one GEMM launch; at K > 1024 (fc2 of the per-dense path, bf16 input)
//       a one-warp-per-row pre-pass finds each row's max |h| first, unless
//       the scale is static.
//   K7: the MHA launch alone.
// All dots are one templated GEMM with two mainloops. K3's launches (fc1 on
// the LN panel, static and dynamic middle, and the static fc2 in the int8 A
// mode; K9's fc1 shares its instantiation) and K4's, K5's and K8's dots (all
// in the int8 A mode, behind the quantize pass) run the Hopper mainloop,
// `sm90::gemm_kernel` (int8_gemm_sm90.cuh: wgmma fed by a TMA ring, 128 x
// 128 tiles, a persistent panel grid, stream-K in the int8 mode). The others
// (K6, K9's fc2, the stream mode) run `int8_gemm_kernel` (int8_gemm_mma.cuh):
//   - a block owns a 64 x 128 output tile, 8 warps of 32 x 32, each a grid of
//     mma.sync.m16n8k32 s8 x s8 -> s32 products (exact integer sums);
//   - "panel" mode builds its A operand itself: each block normalises,
//     quantizes and keeps its 64 full rows (K <= 1024, bf16 or f32) as int8
//     in shared memory (row max |h| taken there, no second pass over HBM),
//     then sweeps as many 128-wide output tiles as still leaves two blocks
//     per SM, so the prologue is not redone for every tile;
//   - "int8" mode reads an int8 A through the same cp.async ring as the
//     weight (K9's chunked fc2 under a static scale);
//   - "stream" mode reads f32 or bf16 rows in K chunks and quantizes them on
//     the fly with row scales known beforehand, one per row and K chunk (the
//     MLP middle under dynamic scales: its row max is gathered by atomics in
//     the fc1 epilogue);
//   - the weight (N, K) K-contiguous, int8 or nibble-packed W4, streams
//     through a two-stage cp.async ring of 128 x 64-byte tiles; a W4 tile's
//     bytes hold k and k + K/2, so each packed word unpacks in registers into
//     the B fragments of two k windows and feeds two products;
//   - shared-memory rows are padded by 16 bytes so fragment loads hit 32 banks.
// Both epilogues dequantize (acc * (s_row * scale_col) + bias, in that
// order), then either [GELU2] [+ bf16 or f32 residual] -> bf16 or f32 (with
// the row max |y| per chunk when asked), or GELU2 quantized to int8, or
// (chunked, mma.sync only) the f32 accumulator + bias -> bf16.
// The quantize pass (quant_rows_kernel below) writes the int8 rows and,
// under dynamic scales, each row's max |h|, with the Hopper panel builder's
// arithmetic, so the dots see the bytes and row scales the panel held.
// The bf16 attention (mha_sm90.cuh) runs one warpgroup per 64 queries of a
// (head, batch), Q K^T and P V on wgmma (bf16, f32 sums), Q, K and V by TMA,
// all of a row's scores in registers: keys >= kv_valid at -inf, f32 softmax
// over all keys, p normalised then rounded to bf16, P V summed in f32,
// rounded to bf16; or, with the softmax's divide folded into the output
// (T2S_SOFTMAX_FOLD_DIV), exp(s - max) rounded to bf16 and the f32 P V sums
// divided by the row sum before the rounding. The served default at a head
// width of 64 is the TPU's pair-packed MHA (int8_block.py::_mha_pair_premasked
// / _mha_pair): one row max shared by heads 2g and 2g + 1, the divide after
// P V (mha_pair_kernel, int8_mha.cuh).
// K10, the int8 attention, is in mha_int8.cu; the T1-T3 probes' launches are
// in int8_probe.cu.
// The rounding points are the twins': q/k/v, p, the attention output and
// every block output in bf16. No --use_fast_math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "int8_gemm_mma.cuh"
#include "int8_gemm_sm90.cuh"
#include "int8_mha.cuh"
#include "mha_sm90.cuh"

namespace {

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

// The quantize pass of K4, K5 and K8: x (M, K) bf16 or f32 [-> AdaLN with
// mod (2, K)] -> q (M, K) int8, and under a dynamic scale each row's max |h|
// into amax (M,), from which the dot's int8 A mode takes the row scale as the
// panel did. The arithmetic is build_panel_swz's (int8_gemm_sm90.cuh), row by
// row: lane l holds k = 128 i + 4 l + e, its sums in that order and then the
// warp's butterfly, div_rn for the mean, the variance and the dynamic
// quantize, the static one a multiply. So the bytes and the scales are the
// ones the panel held. One warp per kQuantRows rows, their loads in flight
// together; NORM kNormAdaLN or kNormNone.
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
  if (NORM == kNormAdaLN) {
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
      const float m0v = NORM == kNormAdaLN ? mod[k] : 0.0f;
      const float m1v = NORM == kNormAdaLN ? mod[K + k] : 0.0f;
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

}  // namespace

// Limits the wrappers check before they launch, and (4) the bytes of the
// stream-K workspace that t2s_int8_dense's int8 A mode takes (zeroed once).
extern "C" int t2s_int8_limits(int which) {
  switch (which) {
    case 0: return kMaxPanelK;   // panel K
    case 1: return BN;           // N multiple
    case 2: return KS;           // stored K bytes multiple
    case 3: return 272;          // attention keys (score registers)
    case 4: return static_cast<int>(sm90::workspace_ints() * sizeof(int));
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
// its own out. ws: the stream-K workspace (t2s_int8_limits(4) bytes, zeroed
// once; the int8 A mode needs it). The T2 / T3 probes' configurations are
// int8_probe.cu's function of the same name. Returns the CUDA error code.
extern "C" int t2s_int8_dense(int amode, int norm, int w4, int epi, const void* a, int a_f32,
                              const void* mod, const void* amax_in, float s_static,
                              float inv_static, int is_static, int n_w,
                              const void* w0, const void* sc0, const void* b0, void* o0,
                              const void* w1, const void* sc1, const void* b1, void* o1,
                              const void* w2, const void* sc2, const void* b2, void* o2,
                              const void* residual, int res_f32, int gelu, int out_f32,
                              void* amax_out, float out_inv, int nch, int M, int K, int N,
                              int probe, float amax_floor, void* ws, void* stream) {
  GemmArgs g;
  if (!dense_args(g, amode, norm, w4, epi, a, a_f32, mod, amax_in, s_static, inv_static,
                  is_static, n_w, {w0, w1, w2}, {sc0, sc1, sc2}, {b0, b1, b2}, {o0, o1, o2},
                  residual, res_f32, gelu, out_f32, amax_out, out_inv, nch, M, K, N, probe,
                  amax_floor))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool match_w4 = w4 != 0;
  // kEfAny instantiations never read the probe flags, and this table has no
  // instantiation with them: a launch with them is refused
#define T2S_MATCH(AM, NO, W4_, EP, EF)                                                     \
  amode == AM && norm == NO && match_w4 == W4_ && epi == EP &&                             \
      ((EF) == kEfAny ? (g.ef & kEfProbe) == 0 : g.ef == (EF))
#define T2S_SM90(AM, NO, W4_, EP, EF) \
  if (T2S_MATCH(AM, NO, W4_, EP, EF)) return sm90::launch<AM, NO, W4_, EP, (EF)>(g, n_w, static_cast<int*>(ws), s);
#define T2S_CASE(AM, NO, W4_, EP, EF) \
  if (T2S_MATCH(AM, NO, W4_, EP, EF)) return launch_gemm<AM, NO, W4_, EP, (EF)>(g, n_w, s);
  // K3 on the Hopper mainloop (int8_gemm_sm90.cuh)
  T2S_SM90(kPanel, kNormLN, false, kEpiGeluInt8, 0)                    // K3 fc1, static
  T2S_SM90(kPanel, kNormLN, true, kEpiGeluInt8, 0)
  T2S_SM90(kPanel, kNormLN, false, kEpiStore, kEfGelu | kEfOutF32 | kEfMax)   // K3, K9 fc1
  T2S_SM90(kPanel, kNormLN, true, kEpiStore, kEfGelu | kEfOutF32 | kEfMax)
  T2S_SM90(kInt8, kNormNone, false, kEpiStore, kEfRes)    // K3 fc2, static; proj, crossproj
  T2S_SM90(kInt8, kNormNone, true, kEpiStore, kEfRes)
  // K4, K5 and K8 on it too, behind the quantize pass (t2s_int8_quant_rows)
  T2S_SM90(kInt8, kNormNone, false, kEpiStore, 0)                      // q/k/v, crossq
  T2S_SM90(kInt8, kNormNone, true, kEpiStore, 0)
  T2S_SM90(kInt8, kNormNone, false, kEpiStore, kEfRes | kEfOutF32)     // K8: proj -> f32 x
  T2S_SM90(kInt8, kNormNone, false, kEpiStore, kEfRes | kEfResF32)     // K8: crossproj + f32 x
  // the others on the mma.sync mainloop (int8_gemm_mma.cuh), their flags compiled in
  T2S_CASE(kPanel, kNormAdaLN, false, kEpiStore, 0)                    // K6 q/k/v
  T2S_CASE(kPanel, kNormNone, false, kEpiStore, kEfRes)                // K6 proj
  T2S_CASE(kPanel, kNormLN, false, kEpiStore, kEfGelu)                 // K6 fc1
  T2S_CASE(kStream, kNormNone, false, kEpiStore, kEfRes | kEfAF32)     // K3 fc2, dynamic
  T2S_CASE(kStream, kNormNone, true, kEpiStore, kEfRes | kEfAF32)
  T2S_CASE(kStream, kNormNone, false, kEpiStore, kEfRes)               // K6 fc2
  T2S_CASE(kStream, kNormNone, false, kEpiChunked, kEfRes | kEfAF32)   // K9 fc2, dynamic
  T2S_CASE(kInt8, kNormNone, false, kEpiChunked, kEfRes)               // K9 fc2, static
  // K6's other combinations (W8): the flags read at run time
  T2S_CASE(kPanel, kNormNone, false, kEpiStore, kEfAny)
  T2S_CASE(kPanel, kNormAdaLN, false, kEpiStore, kEfAny)
  T2S_CASE(kPanel, kNormLN, false, kEpiStore, kEfAny)
  T2S_CASE(kStream, kNormNone, false, kEpiStore, kEfAny)
#undef T2S_CASE
#undef T2S_SM90
#undef T2S_MATCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// Row max |a| of a (M, K) bf16 matrix into amax (M,) f32; K a multiple of 8.
extern "C" int t2s_int8_row_amax(const void* a, int M, int K, void* amax, void* stream) {
  if (M <= 0 || K <= 0 || K % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  row_amax_kernel<<<(M + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), M, K, static_cast<float*>(amax));
  return static_cast<int>(cudaGetLastError());
}

// The quantize pass of K4, K5 and K8 (quant_rows_kernel): x (M, K) bf16 or
// f32 (x_f32), norm 0 none or 1 AdaLN with mod (2, K) f32 -> q (M, K) int8;
// under a dynamic scale (is_static 0) each row's max |h| into amax (M,) f32,
// else h * inv_static. K a multiple of 128, at most t2s_int8_limits(0).
// Returns the CUDA error code.
extern "C" int t2s_int8_quant_rows(int norm, const void* x, int x_f32, const void* mod, int M,
                                   int K, float inv_static, int is_static, void* q, void* amax,
                                   void* stream) {
  if (M <= 0 || K <= 0 || K % 128 != 0 || K > kMaxPanelK ||
      (norm == kNormAdaLN && mod == nullptr) || (!is_static && amax == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (M + 8 * kQuantRows - 1) / (8 * kQuantRows);
  const auto launch = [&](auto kernel) {
    kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        x, static_cast<const float*>(mod), M, K, inv_static, is_static, static_cast<int8_t*>(q),
        static_cast<float*>(amax));
    return static_cast<int>(cudaGetLastError());
  };
  if (norm == kNormAdaLN)
    return x_f32 ? launch(quant_rows_kernel<kNormAdaLN, true>)
                 : launch(quant_rows_kernel<kNormAdaLN, false>);
  if (norm == kNormNone && !x_f32) return launch(quant_rows_kernel<kNormNone, false>);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Multi-head attention: q (batch*Lq, H*hd), k/v (batch*Lkv, H*hd) bf16 ->
// out (batch*Lq, H*hd) bf16; keys >= kv_valid masked (0 < kv_valid <= Lkv).
// hd 32 or 64. mode (MhaMode): 0 the softmax's divide before P V, 1 folded
// into the output (both the Hopper MHA, mha_sm90.cuh); hd 64 only: 2 the
// pair-packed MHA (n_head even). The T3 probe's modes 3-6 are int8_probe.cu's
// function of the same name.
extern "C" int t2s_int8_mha(const void* q, const void* k, const void* v, void* out, int batch,
                            int Lq, int Lkv, int n_head, int hd, int kv_valid, int mode,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!mha_args_ok(batch, Lq, Lkv, n_head, hd, kv_valid, mode))
    return static_cast<int>(cudaErrorInvalidValue);
#define T2S_MHA(HD, MODE) \
  if (hd == HD && mode == MODE) \
    return mha90::launch_keys<HD, MODE>(q, k, v, out, batch, Lq, Lkv, n_head, kv_valid, s);
  T2S_MHA(64, kMhaDiv)
  T2S_MHA(64, kMhaFold)
  T2S_MHA(32, kMhaDiv)
  T2S_MHA(32, kMhaFold)
#undef T2S_MHA
  if (hd == 64 && mode == kMhaPair)
    return launch_mha_pair_keys<kMhaPair>(q, k, v, out, batch, Lq, Lkv, n_head, kv_valid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
