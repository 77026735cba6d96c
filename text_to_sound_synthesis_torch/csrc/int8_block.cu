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
//       writes f32 and the row max |u| instead, and a wide quantize pass
//       between the two quantizes it: three.
//   K8: K4's five launches, then K5's, with x kept in f32 between the two
//       halves: the self proj writes f32 x + residual, the cross quantize
//       pass reads f32 rows, the cross proj adds the f32 residual and rounds
//       once.
//   K9: K3 with the 4096 hidden columns in n chunks, each with its own
//       dynamic row scale: fc1 gathers the row max |u| per (row, chunk), the
//       wide pass quantizes each chunk with its own scale, and fc2 flushes its
//       int32 sums into an f32 accumulator at each chunk's end, y = x, y +=
//       acc_c * (s_c * scale) for c = 0..n-1, then + bias: three launches
//       (two under a static scale).
//   K6: a quantize pass ([LN / AdaLN] at K <= 1024, the wide pass else),
//       then one dot launch that up to three weights share.
//   K7: the MHA launch alone.
// Every dot runs the Hopper mainloop, `sm90::gemm_kernel`
// (int8_gemm_sm90.cuh: wgmma fed by a TMA ring, 128 x 128 tiles): K3's fc1
// (K9's too) on its LN panel, everything else in the int8 A mode behind a
// quantize pass (int8_quant.cuh), stream-K but for K9's chunked fc2, which
// runs data-parallel so that its f32 flushes keep their order. The epilogues
// dequantize (acc * (s_row * scale_col) + bias, in that order), then either
// [GELU2] [+ bf16 or f32 residual] -> bf16 or f32 (with the row max |y| per
// chunk when asked), or GELU2 quantized to int8, or (chunked) the f32
// accumulator + bias -> bf16 or f32.
// The quantize passes write the int8 rows and, under dynamic scales, each
// row's max |h|, with the Hopper panel builder's arithmetic, so the dots see
// the bytes and row scales the panel held.
// The bf16 attention (mha_sm90.cuh) runs one warpgroup per 64 queries of a
// (head, batch), Q K^T and P V on wgmma (bf16, f32 sums), Q, K and V by TMA,
// all of a row's scores in registers: keys >= kv_valid at -inf, f32 softmax
// over all keys, p normalised then rounded to bf16, P V summed in f32,
// rounded to bf16; or, with the softmax's divide folded into the output
// (T2S_SOFTMAX_FOLD_DIV), exp(s - max) rounded to bf16 and the f32 P V sums
// divided by the row sum before the rounding. The served default at a head
// width of 64 is the TPU's pair-packed MHA (int8_block.py::_mha_pair_premasked
// / _mha_pair): one row max shared by heads 2g and 2g + 1, the divide after
// P V (mha_pair_kernel, mha_sm90.cuh: the same warpgroup tiles, B's scores
// taken twice).
// K10, the int8 attention, is in mha_int8.cu; the T1-T3 probes' launches are
// in int8_probe.cu.
// The rounding points are the twins': q/k/v, p, the attention output and
// every block output in bf16. No --use_fast_math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "int8_gemm_sm90.cuh"
#include "int8_quant.cuh"
#include "mha_sm90.cuh"

// Limits the wrappers check before they launch, and (4) the bytes of the
// stream-K workspace that t2s_int8_dense's int8 A mode takes (zeroed once).
extern "C" int t2s_int8_limits(int which) {
  switch (which) {
    case 0: return kMaxPanelK;   // panel and row-pass K
    case 1: return kNMultiple;   // N multiple
    case 2: return kKMultiple;   // stored K bytes multiple
    case 3: return 272;          // attention keys (score registers)
    case 4: return static_cast<int>(sm90::workspace_ints() * sizeof(int));
    default: return -1;
  }
}

// One quantized dense launch (see GemmArgs). amode: 0 panel (a = (M, K) bf16,
// norm 2 ln with mod (2, K) f32), 2 int8 (a = (M, K) int8 from a quantize
// pass; its row scales from amax_in (M, nch) or static). epi: 0 [GELU2] [+
// residual] -> bf16 or f32 (+ row max |y| per N chunk into amax_out (M, nch)
// when it is not NULL), 1 GELU2 quantized to int8 with out_inv, 2 the K
// dimension in nch chunks flushed into an f32 accumulator from the residual,
// + bias (int8 mode, W8). Up to three weights share A; each writes its own
// out. ws: the stream-K workspace (t2s_int8_limits(4) bytes, zeroed once).
// The T2 / T3 probes' configurations are int8_probe.cu's function of the same
// name. Returns the CUDA error code;
// a combination this table does not hold is refused before any launch.
extern "C" int t2s_int8_dense(int amode, int norm, int w4, int epi, const void* a,
                              const void* mod, const void* amax_in, float s_static,
                              float inv_static, int is_static, int n_w,
                              const void* w0, const void* sc0, const void* b0, void* o0,
                              const void* w1, const void* sc1, const void* b1, void* o1,
                              const void* w2, const void* sc2, const void* b2, void* o2,
                              const void* residual, int res_f32, int gelu, int out_f32,
                              void* amax_out, float out_inv, int nch, int M, int K, int N,
                              int probe, float amax_floor, void* ws, void* stream) {
  GemmArgs g;
  if (!dense_args(g, amode, w4, epi, a, mod, amax_in, s_static, inv_static,
                  is_static, n_w, {w0, w1, w2}, {sc0, sc1, sc2}, {b0, b1, b2}, {o0, o1, o2},
                  residual, res_f32, gelu, out_f32, amax_out, out_inv, nch, M, K, N, probe,
                  amax_floor))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool match_w4 = w4 != 0;
#define T2S_SM90(AM, NO, W4_, EP, EF)                                                  \
  if (amode == AM && norm == NO && match_w4 == W4_ && epi == EP && g.ef == (EF))       \
    return sm90::launch<AM, NO, W4_, EP, (EF)>(g, n_w, static_cast<int*>(ws), s);
  // K3's fc1 on the LN panel (K9's too)
  T2S_SM90(kPanel, kNormLN, false, kEpiGeluInt8, 0)                    // static
  T2S_SM90(kPanel, kNormLN, true, kEpiGeluInt8, 0)
  T2S_SM90(kPanel, kNormLN, false, kEpiStore, kEfGelu | kEfOutF32 | kEfMax)   // dynamic
  T2S_SM90(kPanel, kNormLN, true, kEpiStore, kEfGelu | kEfOutF32 | kEfMax)
  // the int8 A mode behind a quantize pass: K3's fc2, K4's, K5's and K8's
  // dots; K6's every (act, residual, out) combination, W8
  T2S_SM90(kInt8, kNormNone, false, kEpiStore, kEfRes)    // fc2, proj, crossproj
  T2S_SM90(kInt8, kNormNone, true, kEpiStore, kEfRes)
  T2S_SM90(kInt8, kNormNone, false, kEpiStore, 0)                      // q/k/v, crossq
  T2S_SM90(kInt8, kNormNone, true, kEpiStore, 0)
  T2S_SM90(kInt8, kNormNone, false, kEpiStore, kEfRes | kEfOutF32)     // K8: proj -> f32 x
  T2S_SM90(kInt8, kNormNone, false, kEpiStore, kEfRes | kEfResF32)     // K8: crossproj + f32 x
  T2S_SM90(kInt8, kNormNone, false, kEpiStore, kEfGelu)                // K6 fc1
  T2S_SM90(kInt8, kNormNone, false, kEpiStore, kEfOutF32)
  T2S_SM90(kInt8, kNormNone, false, kEpiStore, kEfGelu | kEfOutF32)
  T2S_SM90(kInt8, kNormNone, false, kEpiStore, kEfRes | kEfResF32 | kEfOutF32)
  T2S_SM90(kInt8, kNormNone, false, kEpiStore, kEfGelu | kEfRes)
  T2S_SM90(kInt8, kNormNone, false, kEpiStore, kEfGelu | kEfRes | kEfOutF32)
  T2S_SM90(kInt8, kNormNone, false, kEpiStore, kEfGelu | kEfRes | kEfResF32)
  T2S_SM90(kInt8, kNormNone, false, kEpiStore, kEfGelu | kEfRes | kEfResF32 | kEfOutF32)
  // K9's fc2: the chunked epilogue, data-parallel
  T2S_SM90(kInt8, kNormNone, false, kEpiChunked, kEfRes)
#undef T2S_SM90
  return static_cast<int>(cudaErrorInvalidValue);
}

// The row pass (quant_rows_kernel, int8_quant.cuh) of K4, K5, K8 and K6: x
// (M, K) bf16 or f32 (x_f32), norm 0 none, 1 AdaLN or 2 LN with mod (2, K)
// f32 -> q (M, K) int8; under a dynamic scale (is_static 0) each row's max
// |h| into amax (M,) f32, else h * inv_static. K a multiple of 128, at most
// t2s_int8_limits(0); f32 x with AdaLN only. Returns the CUDA error code.
extern "C" int t2s_int8_quant_rows(int norm, const void* x, int x_f32, const void* mod, int M,
                                   int K, float inv_static, int is_static, void* q, void* amax,
                                   void* stream) {
  if (!quant_rows_ok(norm, M, K, mod, is_static, amax)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define T2S_ROWS(NO, A32)                  \
  if (norm == NO && (x_f32 != 0) == A32) \
    return launch_quant_rows<NO, A32>(x, mod, M, K, inv_static, is_static, q, amax, s);
  T2S_ROWS(kNormAdaLN, false)
  T2S_ROWS(kNormAdaLN, true)   // K8's cross half
  T2S_ROWS(kNormNone, false)
  T2S_ROWS(kNormLN, false)     // K6 fc1
#undef T2S_ROWS
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wide pass (quant_wide_kernel, int8_quant.cuh): x (M, K) bf16 (in 0) or
// f32 (in 1) -> q (M, K) int8, K a multiple of 4: static (h * inv_static);
// dynamic with amax_in (M, nch) given (each of nch chunks with its own row
// scale); or dynamic with amax_in NULL (the row's own max |h|, into amax_out
// (M,)). qbf must be 0 here (int8_probe.cu's function of the same name takes
// the probes' inputs). Returns the CUDA error code.
extern "C" int t2s_int8_quant_wide(const void* x, int in, int M, int K, int nch,
                                   const void* amax_in, float inv_static, int is_static, int qbf,
                                   void* q, void* amax_out, void* stream) {
  if (!quant_wide_ok(M, K, nch, amax_in, is_static, amax_out) || qbf != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in == kInBf16)
    return launch_quant_wide<kInBf16, false>(x, M, K, nch, amax_in, inv_static, is_static, q,
                                             amax_out, s);
  if (in == kInF32)
    return launch_quant_wide<kInF32, false>(x, M, K, nch, amax_in, inv_static, is_static, q,
                                            amax_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Multi-head attention: q (batch*Lq, H*hd), k/v (batch*Lkv, H*hd) bf16 ->
// out (batch*Lq, H*hd) bf16; keys >= kv_valid masked (0 < kv_valid <= Lkv).
// hd 32 or 64. mode (MhaMode, all the Hopper MHA of mha_sm90.cuh): 0 the
// softmax's divide before P V, 1 folded into the output; hd 64 only: 2 the
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
  T2S_MHA(64, kMhaPair)
#undef T2S_MHA
  return static_cast<int>(cudaErrorInvalidValue);
}
