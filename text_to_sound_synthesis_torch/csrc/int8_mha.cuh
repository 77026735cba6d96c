// The pair-packed bf16 MHA of the engine (`mha_pair_kernel`, the served
// default of K4 and K5 at a head width of 64, and T3's pair_nofold) and its
// launcher, and the modes of the engine's MHAs. The other modes run the
// Hopper MHA of mha_sm90.cuh. Included by int8_block.cu (the engine's modes)
// and int8_probe.cu (T3's); see int8_block.cu's header comment.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

using namespace t2s_int8;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The MHA's modes: kMhaDiv the exact softmax over all keys (keys >= kv_valid
// at -inf), p = exp(s - max) / sum rounded to bf16, P V summed in f32;
// kMhaFold (T2S_SOFTMAX_FOLD_DIV) p = exp(s - max) rounded to bf16, and the
// f32 output divided by the sum; kMhaPair, kMhaPairNoFold the pair-packed MHA
// (mha_pair_kernel); and T3's (tools/bench_attn_ablate.py::make_variant):
// kMhaNoSoftmax p = bf16(s * 0.001) over every key, none masked; kMhaNoAv the
// head's output is p of its first HD keys, no P V; kMhaNoScores every score
// of a row is the row's q[0] (its first column), no Q K^T, unscaled, then the
// masked softmax. All but the pair modes run mha_sm90.cuh's kernel.
enum MhaMode { kMhaDiv = 0, kMhaFold = 1, kMhaPair = 2, kMhaPairNoFold = 3, kMhaNoSoftmax = 4,
               kMhaNoAv = 5, kMhaNoScores = 6 };

// The pair-packed MHA of the TPU engine (int8_block.py::_mha_pair_premasked,
// _mha_pair; its served default at a head width of 64): heads A = 2g and B =
// 2g + 1 share one row max, taken over both heads' masked scores; p =
// exp(s - max) in f32; each head's sum, B's as the pair's total minus A's
// (as JAX takes it); FOLD: p rounded to bf16 unnormalised, P V summed in f32
// and divided by the head's sum, rounded to bf16 (T3 pair_nofold: p divided
// by the sum before its rounding, no divide after). The masks the TPU folds
// into its K/V dequants (x1.0, x0.0) are exact, so here each head simply
// reads its own 64 columns.
// One block per (query slice, pair, batch element) holds both heads' K and
// V^T in shared memory; a warp takes 16 queries of both heads. Both heads'
// score tiles in registers would take 2 x NKT x 4 a thread (272 at 272
// keys), so the warp computes B's scores twice: first for their row max,
// then, after A's output, for B's own. kPairWarps warps a block: the 17
// tiles of 16 queries at 265 or 272 fill two slices, one tile a warp, and
// at batch 8 with 8 pairs the 128 blocks make one wave on 132 SMs.
constexpr int kPairWarps = 9;

template <int NKT, bool FOLD>
__global__ void __launch_bounds__(kPairWarps * 32)
mha_pair_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int Lq,
                int Lkv, int D, int kv_valid, float /* sqrt_hd: 8 */) {
  constexpr int HD = 64;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kKeys = NKT * 8;
  constexpr int kKRow = HD + 8;
  constexpr int kVRow = kKeys + 8;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);   // [2][kKeys][kKRow]
  __nv_bfloat16* Vt = Ks + 2 * kKeys * kKRow;                    // [2][HD][kVRow]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z, col0 = blockIdx.y * 2 * HD;         // head A's first column

  // lanes take consecutive keys, so the transposed V stores hit distinct banks
  for (int i = tid; i < kKeys * (2 * HD / 8); i += kPairWarps * 32) {
    const int j = i % kKeys, w = i / kKeys;                      // key j, columns col0 + 8w ..
    const int hh = w / (HD / 8), wd = w % (HD / 8);
    uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
    if (j < Lkv) {
      const size_t src = (static_cast<size_t>(b) * Lkv + j) * D + col0 + 8 * w;
      kw = *reinterpret_cast<const uint4*>(k + src);
      vw = *reinterpret_cast<const uint4*>(v + src);
    }
    *reinterpret_cast<uint4*>(Ks + (hh * kKeys + j) * kKRow + 8 * wd) = kw;
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vw);
#pragma unroll
    for (int e = 0; e < 8; ++e) Vt[(hh * HD + 8 * wd + e) * kVRow + j] = ve[e];
  }
  __syncthreads();

  for (int q0 = (blockIdx.x * kPairWarps + warp) * 16; q0 < Lq; q0 += gridDim.x * kPairWarps * 16) {
    const int r0 = min(q0 + gq, Lq - 1), r1 = min(q0 + gq + 8, Lq - 1);
    const __nv_bfloat16* q_r0 = q + (static_cast<size_t>(b) * Lq + r0) * D + col0;
    const __nv_bfloat16* q_r1 = q + (static_cast<size_t>(b) * Lq + r1) * D + col0;
    float s[NKT][4];

    // s = Q_hh K_hh^T / sqrt(hd), keys >= kv_valid at -inf; times 1/8, the
    // same value as the divide by sqrt(64)
    auto scores = [&](int hh) {
      uint32_t qa[HD / 16][4];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        qa[kk][0] = *reinterpret_cast<const uint32_t*>(q_r0 + hh * HD + kk * 16 + 2 * tq);
        qa[kk][1] = *reinterpret_cast<const uint32_t*>(q_r1 + hh * HD + kk * 16 + 2 * tq);
        qa[kk][2] = *reinterpret_cast<const uint32_t*>(q_r0 + hh * HD + kk * 16 + 8 + 2 * tq);
        qa[kk][3] = *reinterpret_cast<const uint32_t*>(q_r1 + hh * HD + kk * 16 + 8 + 2 * tq);
      }
      const __nv_bfloat16* Kh = Ks + hh * kKeys * kKRow;
#pragma unroll
      for (int j = 0; j < NKT; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
        const __nv_bfloat16* kr = Kh + (j * 8 + gq) * kKRow + 2 * tq;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          mma_bf16(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(kr + kk * 16),
                   *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * 8 + 2 * tq + (e & 1);
          s[j][e] = key < kv_valid ? __fmul_rn(s[j][e], 0.125f) : -INFINITY;
        }
      }
    };
    // the rows' max over s, folded into mx (rows gq: regs 0, 1; gq + 8: regs 2, 3)
    auto row_max = [&](float (&mx)[2]) {
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      }
    };
    // s = exp(s - mx); the rows' sums
    auto exp_sum = [&](const float (&mx)[2], float (&sm)[2]) {
      sm[0] = sm[1] = 0.0f;
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - mx[e >> 1]);
          sm[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sm[r] += __shfl_xor_sync(kFull, sm[r], 1);
        sm[r] += __shfl_xor_sync(kFull, sm[r], 2);
      }
    };
    // head hh's output from the exp registers and its sums
    auto pv_store = [&](int hh, const float (&sm)[2]) {
      float o[HD / 8][4];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
      auto p_of = [&](float e, float d) { return FOLD ? e : __fdiv_rn(e, d); };
      const __nv_bfloat16* Vh = Vt + hh * HD * kVRow;
#pragma unroll
      for (int kk = 0; kk < NKT / 2; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(p_of(s[2 * kk][0], sm[0]), p_of(s[2 * kk][1], sm[0]));
        pa[1] = pack_bf16(p_of(s[2 * kk][2], sm[1]), p_of(s[2 * kk][3], sm[1]));
        pa[2] = pack_bf16(p_of(s[2 * kk + 1][0], sm[0]), p_of(s[2 * kk + 1][1], sm[0]));
        pa[3] = pack_bf16(p_of(s[2 * kk + 1][2], sm[1]), p_of(s[2 * kk + 1][3], sm[1]));
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const __nv_bfloat16* vr = Vh + (n * 8 + gq) * kVRow + kk * 16 + 2 * tq;
          mma_bf16(o[n], pa, *reinterpret_cast<const uint32_t*>(vr),
                   *reinterpret_cast<const uint32_t*>(vr + 8));
        }
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        if (FOLD) {
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] = __fdiv_rn(o[n][e], sm[e >> 1]);
        }
        const int d = col0 + hh * HD + n * 8 + 2 * tq;
        if (q0 + gq < Lq)
          *reinterpret_cast<__nv_bfloat162*>(out + (static_cast<size_t>(b) * Lq + q0 + gq) * D + d) =
              __floats2bfloat162_rn(o[n][0], o[n][1]);
        if (q0 + gq + 8 < Lq)
          *reinterpret_cast<__nv_bfloat162*>(out + (static_cast<size_t>(b) * Lq + q0 + gq + 8) * D + d) =
              __floats2bfloat162_rn(o[n][2], o[n][3]);
      }
    };

    float mx[2] = {-INFINITY, -INFINITY}, sum_a[2], sum_b[2];
    scores(1);
    row_max(mx);
    scores(0);
    row_max(mx);
    exp_sum(mx, sum_a);
    pv_store(0, sum_a);
    scores(1);
    exp_sum(mx, sum_b);
#pragma unroll
    for (int r = 0; r < 2; ++r) sum_b[r] = __fsub_rn(__fadd_rn(sum_a[r], sum_b[r]), sum_a[r]);
    pv_store(1, sum_b);
  }
}

// The pair-packed MHA: MODE kMhaPair or kMhaPairNoFold, NKT key tiles of 8.
template <int NKT, int MODE>
int launch_mha_pair(const void* q, const void* k, const void* v, void* out, int batch, int Lq,
                    int Lkv, int n_head, int kv_valid, cudaStream_t stream) {
  constexpr int HD = 64;
  const size_t smem = 2 * (static_cast<size_t>(NKT) * 8 * (HD + 8) + HD * (NKT * 8 + 8)) *
                      sizeof(__nv_bfloat16);
  auto kernel = mha_pair_kernel<NKT, MODE == kMhaPair>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               200 * 1024);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  // as many query slices as leave each warp one tile of 16 queries
  const int slices = ((Lq + 15) / 16 + kPairWarps - 1) / kPairWarps;
  const dim3 grid(slices, n_head / 2, batch);
  kernel<<<grid, kPairWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Lq, Lkv,
      n_head * HD, kv_valid, 8.0f);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_mha_pair_keys(const void* q, const void* k, const void* v, void* out, int batch, int Lq,
                         int Lkv, int n_head, int kv_valid, cudaStream_t stream) {
  if (Lkv <= 32)
    return launch_mha_pair<4, MODE>(q, k, v, out, batch, Lq, Lkv, n_head, kv_valid, stream);
  if (Lkv <= 80)
    return launch_mha_pair<10, MODE>(q, k, v, out, batch, Lq, Lkv, n_head, kv_valid, stream);
  if (Lkv <= 144)
    return launch_mha_pair<18, MODE>(q, k, v, out, batch, Lq, Lkv, n_head, kv_valid, stream);
  return launch_mha_pair<34, MODE>(q, k, v, out, batch, Lq, Lkv, n_head, kv_valid, stream);
}

// What t2s_int8_mha (int8_block.cu, int8_probe.cu) takes, whatever its mode.
bool mha_args_ok(int batch, int Lq, int Lkv, int n_head, int hd, int kv_valid, int mode) {
  return !(batch <= 0 || Lq <= 0 || Lkv <= 0 || Lkv > 272 || kv_valid <= 0 || kv_valid > Lkv ||
           ((mode == kMhaPair || mode == kMhaPairNoFold) && n_head % 2 != 0) ||
           (mode == kMhaNoAv && Lkv < hd));
}

}  // namespace
