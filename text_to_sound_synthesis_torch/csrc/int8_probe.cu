// The probes' kernels: T1 (tools/bench_kernel_dot.py::make_pallas_dot, the
// bare dot), T2 (tools/bench_mlp_ablate.py, K3 with one stage out or changed)
// and T3 (tools/bench_attn_ablate.py, K4 likewise), for Hopper, sm_90a.
//
// Each is a compile-time configuration of the engine's templates (the
// headers int8_gemm_sm90.cuh, int8_quant.cuh and mha_sm90.cuh;
// see int8_block.cu's header comment), built here, apart from the engine, so
// that a request never waits for their build. The wrappers (ops/dot.py,
// ops/mlp_ablate.py, ops/attn_ablate.py) launch these for the probes'
// configurations and int8_block.cu's for the engine's own launches, which the
// probes share.
//   T1: its int8 cases run the Hopper mainloop in its int8 A mode with the raw
//       epilogue (the engine's fc2 mainloop), its bf16 case bf16_dot_kernel,
//       a mma.sync tiling on m16n8k16 bf16. At the probe's fc1 shape (2176
//       x 1024 x 4096) bytes bound it: 42 MB (mostly the int32 output) take
//       12.6 us at 3.35 TB/s, the 18.2 GOP of products 9.2 us at the int8 peak.
//   T2: fc1 on the Hopper mainloop's panel (panel inputs kNormCast, kNormLN1;
//       epilogues kEpiWrap8, kEpiClip8, kEpiShift8; the kEfProbe flags),
//       dots_only's fc2 on its int8 A mode; mid_bf16's fc2 a wide pass
//       rounding to bf16 (QBF) and the int8 A mode with the bf16 row scale
//       (kEfQBf16). Its other fc2s are K3's own launches.
//   T3: qkvp_dots_only's sum of the three f32 planes as a wide pass input
//       (kInSum3); its dots are K4's launches (the engine's AdaLN pass, then
//       its q/k/v dots writing f32, and its proj); the MHA modes pair_nofold,
//       no_softmax, no_av, no_scores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "int8_gemm_sm90.cuh"
#include "int8_quant.cuh"
#include "mha_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BM = 64, BN = 128;   // output tile
constexpr int KS = 64;             // bytes of a row per pipeline stage
constexpr int kBStride = KS + 16;  // padded shared-memory row

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

}  // namespace

// The T2 configurations of t2s_int8_dense (int8_block.cu): the same
// arguments, this table. Returns the CUDA error code.
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
  // T2 (K3's launches with one stage out or changed; where fc2 is not listed
  // it is K3's own, int8_block.cu's)
  T2S_SM90(kPanel, kNormCast, false, kEpiWrap8, 0)                                // dots_only
  T2S_SM90(kInt8, kNormNone, false, kEpiRaw, kEfRawBf16)
  T2S_SM90(kPanel, kNormNone, false, kEpiStore, kEfGelu | kEfOutF32 | kEfMax)    // no_prologue
  T2S_SM90(kPanel, kNormLN1, false, kEpiStore, kEfGelu | kEfOutF32 | kEfMax)     // ln_onepass
  T2S_SM90(kPanel, kNormLN, false, kEpiStore, kEfOutF32 | kEfMax)                // no_gelu
  T2S_SM90(kPanel, kNormLN, false, kEpiClip8, kEfGelu | kEfMax)                  // no_quant_mid
  T2S_SM90(kPanel, kNormLN, false, kEpiShift8, kEfMax)                           // no_deq_mid
  T2S_SM90(kPanel, kNormLN, false, kEpiStore, kEfGelu | kEfMax | kEfMidBf16)     // mid_bf16, b
  T2S_SM90(kInt8, kNormNone, false, kEpiStore, kEfRes | kEfQBf16)                // mid_bf16
  T2S_SM90(kPanel, kNormLN, false, kEpiStore, kEfGelu | kEfMax | kEfMidBf16 | kEfSigC)  // c
  T2S_SM90(kPanel, kNormLN, false, kEpiStore, kEfGelu | kEfOutF32 | kEfMax | kEfFastSig)
#undef T2S_SM90
  return static_cast<int>(cudaErrorInvalidValue);
}

// The probes' wide passes, with t2s_int8_quant_wide's arguments (int8_block.cu):
// in 2 (T3 qkvp_dots_only) sums the three f32 planes of a (3, M, K) x, in 0
// with qbf 1 (T2 mid_bf16) rounds the row scale and h / s to bf16. Returns
// the CUDA error code.
extern "C" int t2s_int8_quant_wide(const void* x, int in, int M, int K, int nch,
                                   const void* amax_in, float inv_static, int is_static, int qbf,
                                   void* q, void* amax_out, void* stream) {
  if (!quant_wide_ok(M, K, nch, amax_in, is_static, amax_out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in == kInSum3 && !qbf)
    return launch_quant_wide<kInSum3, false>(x, M, K, nch, amax_in, inv_static, is_static, q,
                                             amax_out, s);
  if (in == kInBf16 && qbf)
    return launch_quant_wide<kInBf16, true>(x, M, K, nch, amax_in, inv_static, is_static, q,
                                            amax_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// T1, the bare tiled dot out (M, N) = a (M, K) . w (N, K)^T (weight
// K-contiguous): kind 0 int8 -> int32 and kind 1 int8 -> f32 through the
// engine's Hopper GEMM in its int8 A mode with the raw epilogue (ws its
// stream-K workspace, as t2s_int8_dense's); kind 2 bf16 -> f32 through
// bf16_dot_kernel. N a multiple of 128; K a multiple of 64 (int8) or 32
// (bf16). Returns the CUDA error code.
extern "C" int t2s_tiled_dot(int kind, const void* a, const void* w, void* out, int M, int K,
                             int N, void* ws, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || N <= 0 || N % BN != 0 || kind < 0 || kind > 2 ||
      (kind < 2 ? K % kKMultiple : (2 * K) % KS) != 0)
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
  int* wsp = static_cast<int*>(ws);
  return kind == 1 ? sm90::launch<kInt8, kNormNone, false, kEpiRaw, kEfOutF32>(g, 1, wsp, s)
                   : sm90::launch<kInt8, kNormNone, false, kEpiRaw, 0>(g, 1, wsp, s);
}

// The T3 probe's MHAs, as t2s_int8_mha (int8_block.cu): hd 64; mode 3
// pair_nofold (n_head even), 4 no_softmax, 5 no_av (Lkv >= hd), 6 no_scores.
extern "C" int t2s_int8_mha(const void* q, const void* k, const void* v, void* out, int batch,
                            int Lq, int Lkv, int n_head, int hd, int kv_valid, int mode,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!mha_args_ok(batch, Lq, Lkv, n_head, hd, kv_valid, mode))
    return static_cast<int>(cudaErrorInvalidValue);
#define T2S_MHA(MODE) \
  if (hd == 64 && mode == MODE) \
    return mha90::launch_keys<64, MODE>(q, k, v, out, batch, Lq, Lkv, n_head, kv_valid, s);
  T2S_MHA(kMhaPairNoFold)
  T2S_MHA(kMhaNoSoftmax)
  T2S_MHA(kMhaNoAv)
  T2S_MHA(kMhaNoScores)
#undef T2S_MHA
  return static_cast<int>(cudaErrorInvalidValue);
}
