// K10, the int8 attention of the serving engine's blocks, for Hopper (sm_90a).
//
// Replaces text_to_sound_synthesis_tpu/ops/int8_block.py::_mha_inline_int8,
// the MHA that the TPU block kernels (self_attn_block, cross_attn_block,
// attn_pair_block) run under T2S_ATTN_INT8=1: Q K^T and P V as int8 dots with
// int32 sums. Its plain PyTorch twin is
// text_to_sound_synthesis_torch/ops/int8_block.py::mha_inline_int8_reference;
// the wrappers there launch the two kernels below for each MHA of a block.
//
// What it computes, per batch element (the twin step by step):
//   - q and k quantized per row over the whole width D, so one row scale
//     serves every head: s = max(max|row|, 1e-8) / 127, rint(x / s) clipped
//     to +-127 (rint is half to even, as torch.round and jnp.round);
//   - V quantized per column over the Lkv keys of its batch element, masked
//     keys included;
//   - scores: the exact int32 Q K^T times (s_q * s_k), times f32(1/sqrt(hd));
//     keys >= kv_valid at -inf; the exact f32 softmax over all keys;
//   - P quantized per (head, query) row; the exact int32 P V times
//     (s_p * s_v[column]); the f32 result rounded once to bf16.
// Every multiply and divide is an _rn intrinsic and there is no
// --use_fast_math, so the twin defines the result.
//
// Two launches:
//   1. the quantize pass: one warp per q or k row (row max, then the int8
//      row and its scale), and one block per (batch, 64 columns) of V (its
//      eight warps split the keys, the column maxima meet in shared memory);
//   2. the MHA, one block per (batch, head): the head's int8 K and V
//      (transposed) in shared memory, keys padded with zeros to a multiple of
//      32; each warp takes 16 queries at a time and keeps their whole score
//      tile in registers, so the softmax and P's row scale are exact. Q K^T
//      and P V run on mma.sync.m16n8k32 s8 x s8 -> s32. The accumulator of Q
//      K^T holds, per thread, keys 2t and 2t + 1 of each 8-key tile, while the
//      A fragment of P V takes four consecutive k slots per thread; instead of
//      moving P between threads, the k slots of each 32-key group are a
//      permutation of its keys (slot 4t + 2e + f <-> key 8e + 2t + f, and the
//      same in the upper 16), and V is stored in shared memory in that slot
//      order, so P packs straight from the score registers.
//
// What bounds it on an H100. At the flagship (8 x 265 queries, 16 heads of
// 64, 265 keys) Q K^T and P V are 2.3 GOP of int8 work together, about 1.2
// us at 1979 TOP/s; the bytes (bf16 q, k, v in, bf16 out: 17 MB; the int8
// copies and scales add 6.5 MB through L2) take about 5 us at 3.35 TB/s.
// Like the bf16 MHA it is held back by its schedule: 128 (batch, head)
// blocks on 132 SMs, each walking its 265 queries 16 per warp, plus a
// quantize pass that reads q, k and v once more. Making it fast is later
// work; this version is right first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

using namespace t2s_int8;

constexpr int kMaxKeys = 272;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVCols = 64;             // V columns per quantize block (two per lane)

struct QuantArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  int8_t* qq;
  int8_t* kq;
  int8_t* vq;
  float* sq;
  float* sk;
  float* sv;                           // (batch, D)
  int Mq, Mk, D, Lkv, row_blocks;
};

// One row of D bf16 values -> int8 with its dynamic row scale (one warp).
__device__ __forceinline__ void quant_row(const __nv_bfloat16* __restrict__ src,
                                          int8_t* __restrict__ dst, float* s_out, int D,
                                          int lane) {
  float m = 0.0f;
  for (int c = lane * 8; c < D; c += 256) {
    const uint4 w = *reinterpret_cast<const uint4*>(src + c);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      m = fmaxf(m, fmaxf(fabsf(__low2float(p[e])), fabsf(__high2float(p[e]))));
  }
  const float s = row_scale(warp_max(m));
  for (int c = lane * 8; c < D; c += 256) {
    const uint4 w = *reinterpret_cast<const uint4*>(src + c);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
    int qv[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qv[2 * e] = quantize(__low2float(p[e]), s, 0.0f, false);
      qv[2 * e + 1] = quantize(__high2float(p[e]), s, 0.0f, false);
    }
    *reinterpret_cast<uint2*>(dst + c) =
        make_uint2(pack4(qv[0], qv[1], qv[2], qv[3]), pack4(qv[4], qv[5], qv[6], qv[7]));
  }
  if (lane == 0) *s_out = s;
}

// Blocks [0, row_blocks): eight q or k rows each, one warp per row.
// Blocks [row_blocks, ...): V of one batch element, 64 columns each.
__global__ void __launch_bounds__(kThreads) quant_kernel(const QuantArgs g) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (static_cast<int>(blockIdx.x) < g.row_blocks) {
    const int r = blockIdx.x * kWarps + warp;
    if (r < g.Mq) {
      quant_row(g.q + static_cast<size_t>(r) * g.D, g.qq + static_cast<size_t>(r) * g.D,
                g.sq + r, g.D, lane);
    } else if (r < g.Mq + g.Mk) {
      const int rk = r - g.Mq;
      quant_row(g.k + static_cast<size_t>(rk) * g.D, g.kq + static_cast<size_t>(rk) * g.D,
                g.sk + rk, g.D, lane);
    }
    return;
  }
  __shared__ float red[kWarps][kVCols];
  __shared__ float scale[kVCols];
  const int groups = (g.D + kVCols - 1) / kVCols;
  const int i = blockIdx.x - g.row_blocks, b = i / groups;
  const int col = (i % groups) * kVCols + 2 * lane;   // D is a multiple of 32: col + 1 < D
  const bool live = col < g.D;
  const __nv_bfloat16* vb = g.v + static_cast<size_t>(b) * g.Lkv * g.D;
  float m0 = 0.0f, m1 = 0.0f;
  if (live) {
    for (int j = warp; j < g.Lkv; j += kWarps) {
      const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(vb + static_cast<size_t>(j) * g.D + col);
      m0 = fmaxf(m0, fabsf(__low2float(p)));
      m1 = fmaxf(m1, fabsf(__high2float(p)));
    }
  }
  red[warp][2 * lane] = m0;
  red[warp][2 * lane + 1] = m1;
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      m0 = fmaxf(m0, red[w][2 * lane]);
      m1 = fmaxf(m1, red[w][2 * lane + 1]);
    }
    scale[2 * lane] = row_scale(m0);
    scale[2 * lane + 1] = row_scale(m1);
    if (live) {
      g.sv[static_cast<size_t>(b) * g.D + col] = scale[2 * lane];
      g.sv[static_cast<size_t>(b) * g.D + col + 1] = scale[2 * lane + 1];
    }
  }
  __syncthreads();
  if (!live) return;
  const float s0 = scale[2 * lane], s1 = scale[2 * lane + 1];
  int8_t* qb = g.vq + static_cast<size_t>(b) * g.Lkv * g.D;
  for (int j = warp; j < g.Lkv; j += kWarps) {
    const size_t o = static_cast<size_t>(j) * g.D + col;
    const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(vb + o);
    const int q0 = quantize(__low2float(p), s0, 0.0f, false);
    const int q1 = quantize(__high2float(p), s1, 0.0f, false);
    *reinterpret_cast<uint16_t*>(qb + o) = static_cast<uint16_t>((q0 & 0xFF) | ((q1 & 0xFF) << 8));
  }
}

// The k slot of key jj (0..31) within its 32-key group (see the header).
__device__ __forceinline__ int key_slot(int jj) {
  const int half = jj >> 4, r = jj & 15, e = r >> 3, t = (r & 7) >> 1, f = r & 1;
  return half * 16 + 4 * t + 2 * e + f;
}

// One block per (batch b, head h); NKT key tiles of 8, a multiple of 4.
template <int HD, int NKT>
__global__ void __launch_bounds__(kThreads)
mha_int8_kernel(const int8_t* __restrict__ qq, const float* __restrict__ sq,
                const int8_t* __restrict__ kq, const float* __restrict__ sk,
                const int8_t* __restrict__ vq, const float* __restrict__ sv,
                __nv_bfloat16* __restrict__ out, int Lq, int Lkv, int D, int kv_valid,
                float scale) {
  static_assert(NKT % 4 == 0, "keys are padded to a multiple of 32");
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kKeys = NKT * 8;
  constexpr int kKRow = HD + 16;       // int8; 16-byte rows, conflict-free fragments
  constexpr int kVRow = kKeys + 16;
  int8_t* Ks = reinterpret_cast<int8_t*>(smem);                    // [kKeys][kKRow]
  int8_t* Vt = Ks + kKeys * kKRow;                                 // [HD][kVRow], slot order
  float* sks = reinterpret_cast<float*>(Vt + HD * kVRow);          // [kKeys]
  float* svs = sks + kKeys;                                        // [HD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;

  for (int i = tid; i < kKeys * (HD / 16); i += kThreads) {
    const int j = i / (HD / 16), w = i % (HD / 16);   // key j, dims 16w .. 16w + 15
    uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
    if (j < Lkv) {
      const size_t src = (static_cast<size_t>(b) * Lkv + j) * D + h * HD + 16 * w;
      kw = *reinterpret_cast<const uint4*>(kq + src);
      vw = *reinterpret_cast<const uint4*>(vq + src);
    }
    *reinterpret_cast<uint4*>(Ks + j * kKRow + 16 * w) = kw;
    const int slot = (j & ~31) + key_slot(j & 31);
    const int8_t* ve = reinterpret_cast<const int8_t*>(&vw);
#pragma unroll
    for (int e = 0; e < 16; ++e) Vt[(16 * w + e) * kVRow + slot] = ve[e];
  }
  for (int j = tid; j < kKeys; j += kThreads) sks[j] = j < Lkv ? sk[static_cast<size_t>(b) * Lkv + j] : 0.0f;
  for (int d = tid; d < HD; d += kThreads) svs[d] = sv[static_cast<size_t>(b) * D + h * HD + d];
  __syncthreads();

  for (int q0 = warp * 16; q0 < Lq; q0 += kWarps * 16) {
    // Q fragments and row scales for the warp's 16 rows (rows past Lq read row Lq - 1)
    const int r0 = min(q0 + gq, Lq - 1), r1 = min(q0 + gq + 8, Lq - 1);
    const int8_t* q_r0 = qq + (static_cast<size_t>(b) * Lq + r0) * D + h * HD;
    const int8_t* q_r1 = qq + (static_cast<size_t>(b) * Lq + r1) * D + h * HD;
    const float sqr[2] = {sq[static_cast<size_t>(b) * Lq + r0], sq[static_cast<size_t>(b) * Lq + r1]};
    uint32_t qa[HD / 32][4];
#pragma unroll
    for (int kk = 0; kk < HD / 32; ++kk) {
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(q_r0 + kk * 32 + 4 * tq);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(q_r1 + kk * 32 + 4 * tq);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(q_r0 + kk * 32 + 16 + 4 * tq);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(q_r1 + kk * 32 + 16 + 4 * tq);
    }

    // S = (Q K^T) * (s_q s_k) * scale over all (padded) keys; masked keys -inf
    float s[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      int acc[4] = {0, 0, 0, 0};
      const int8_t* kr = Ks + (j * 8 + gq) * kKRow + 4 * tq;
#pragma unroll
      for (int kk = 0; kk < HD / 32; ++kk)
        mma_s8(acc, qa[kk], *reinterpret_cast<const uint32_t*>(kr + kk * 32),
               *reinterpret_cast<const uint32_t*>(kr + kk * 32 + 16));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * tq + (e & 1);
        s[j][e] = key < kv_valid
                      ? __fmul_rn(__fmul_rn(static_cast<float>(acc[e]), __fmul_rn(sqr[e >> 1], sks[key])),
                                  scale)
                      : -INFINITY;
      }
    }

    // exact softmax per row: rows gq (regs 0, 1) and gq + 8 (regs 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(__fsub_rn(s[j][e], mx[e >> 1]));
        sum[e >> 1] = __fadd_rn(sum[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(kFull, sum[r], 1));
      sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(kFull, sum[r], 2));
    }
    // p = e / sum, and each row's max |p| for P's row scale
    float pmax[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __fdiv_rn(s[j][e], sum[e >> 1]);
        pmax[e >> 1] = fmaxf(pmax[e >> 1], s[j][e]);
      }
    float sp[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      pmax[r] = fmaxf(pmax[r], __shfl_xor_sync(kFull, pmax[r], 1));
      pmax[r] = fmaxf(pmax[r], __shfl_xor_sync(kFull, pmax[r], 2));
      sp[r] = row_scale(pmax[r]);
    }

    // O = Pq V: A packed from the score registers in slot order
    int o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0;
    auto qp = [&](int j, int e) { return quantize(s[j][e], sp[e >> 1], 0.0f, false); };
#pragma unroll
    for (int kk = 0; kk < NKT / 4; ++kk) {
      const int j0 = 4 * kk;
      uint32_t pa[4];
      pa[0] = pack4(qp(j0, 0), qp(j0, 1), qp(j0 + 1, 0), qp(j0 + 1, 1));
      pa[1] = pack4(qp(j0, 2), qp(j0, 3), qp(j0 + 1, 2), qp(j0 + 1, 3));
      pa[2] = pack4(qp(j0 + 2, 0), qp(j0 + 2, 1), qp(j0 + 3, 0), qp(j0 + 3, 1));
      pa[3] = pack4(qp(j0 + 2, 2), qp(j0 + 2, 3), qp(j0 + 3, 2), qp(j0 + 3, 3));
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const int8_t* vr = Vt + (n * 8 + gq) * kVRow + kk * 32 + 4 * tq;
        mma_s8(o[n], pa, *reinterpret_cast<const uint32_t*>(vr),
               *reinterpret_cast<const uint32_t*>(vr + 16));
      }
    }

#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int c = n * 8 + 2 * tq;
      const float sv0 = svs[c], sv1 = svs[c + 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + gq + 8 * r;
        if (row >= Lq) continue;
        const float y0 = __fmul_rn(static_cast<float>(o[n][2 * r]), __fmul_rn(sp[r], sv0));
        const float y1 = __fmul_rn(static_cast<float>(o[n][2 * r + 1]), __fmul_rn(sp[r], sv1));
        *reinterpret_cast<__nv_bfloat162*>(out + (static_cast<size_t>(b) * Lq + row) * D + h * HD + c) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
  }
}

template <int HD, int NKT>
int launch_mha_int8(const int8_t* qq, const float* sq, const int8_t* kq, const float* sk,
                    const int8_t* vq, const float* sv, __nv_bfloat16* out, int batch, int Lq,
                    int Lkv, int n_head, int kv_valid, cudaStream_t stream) {
  constexpr int kKeys = NKT * 8;
  const size_t smem = static_cast<size_t>(kKeys) * (HD + 16) + HD * (kKeys + 16) +
                      (kKeys + HD) * sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(mha_int8_kernel<HD, NKT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid(1, n_head, batch);
  mha_int8_kernel<HD, NKT><<<grid, kThreads, smem, stream>>>(
      qq, sq, kq, sk, vq, sv, out, Lq, Lkv, n_head * HD, kv_valid,
      static_cast<float>(1.0 / sqrt(static_cast<double>(HD))));
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_mha_int8_keys(const int8_t* qq, const float* sq, const int8_t* kq, const float* sk,
                         const int8_t* vq, const float* sv, __nv_bfloat16* out, int batch,
                         int Lq, int Lkv, int n_head, int kv_valid, cudaStream_t s) {
  if (Lkv <= 32)
    return launch_mha_int8<HD, 4>(qq, sq, kq, sk, vq, sv, out, batch, Lq, Lkv, n_head, kv_valid, s);
  if (Lkv <= 96)
    return launch_mha_int8<HD, 12>(qq, sq, kq, sk, vq, sv, out, batch, Lq, Lkv, n_head, kv_valid, s);
  if (Lkv <= 160)
    return launch_mha_int8<HD, 20>(qq, sq, kq, sk, vq, sv, out, batch, Lq, Lkv, n_head, kv_valid, s);
  return launch_mha_int8<HD, 36>(qq, sq, kq, sk, vq, sv, out, batch, Lq, Lkv, n_head, kv_valid, s);
}

}  // namespace

// The most keys the MHA takes (its score registers).
extern "C" int t2s_mha_int8_max_keys() { return kMaxKeys; }

// K10: q (batch*Lq, H*hd), k/v (batch*Lkv, H*hd) bf16 -> out (batch*Lq, H*hd)
// bf16; keys >= kv_valid masked (0 < kv_valid <= Lkv <= 272), hd 32 or 64.
// Scratch from the caller: qq (batch*Lq, D), kq and vq (batch*Lkv, D) int8;
// sq (batch*Lq), sk (batch*Lkv) and sv (batch, D) f32. Two launches on
// `stream`; returns the CUDA error code.
extern "C" int t2s_mha_int8(const void* q, const void* k, const void* v, void* out, void* qq,
                            void* kq, void* vq, void* sq, void* sk, void* sv, int batch, int Lq,
                            int Lkv, int n_head, int hd, int kv_valid, void* stream) {
  if (batch <= 0 || Lq <= 0 || Lkv <= 0 || Lkv > kMaxKeys || kv_valid <= 0 || kv_valid > Lkv ||
      n_head <= 0 || (hd != 32 && hd != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  QuantArgs g;
  g.q = static_cast<const __nv_bfloat16*>(q);
  g.k = static_cast<const __nv_bfloat16*>(k);
  g.v = static_cast<const __nv_bfloat16*>(v);
  g.qq = static_cast<int8_t*>(qq);
  g.kq = static_cast<int8_t*>(kq);
  g.vq = static_cast<int8_t*>(vq);
  g.sq = static_cast<float*>(sq);
  g.sk = static_cast<float*>(sk);
  g.sv = static_cast<float*>(sv);
  g.Mq = batch * Lq;
  g.Mk = batch * Lkv;
  g.D = n_head * hd;
  g.Lkv = Lkv;
  g.row_blocks = (g.Mq + g.Mk + kWarps - 1) / kWarps;
  const int blocks = g.row_blocks + batch * ((g.D + kVCols - 1) / kVCols);
  quant_kernel<<<blocks, kThreads, 0, s>>>(g);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int8_t* cqq = g.qq;
  const int8_t* ckq = g.kq;
  const int8_t* cvq = g.vq;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (hd == 64)
    return launch_mha_int8_keys<64>(cqq, g.sq, ckq, g.sk, cvq, g.sv, o, batch, Lq, Lkv, n_head,
                                    kv_valid, s);
  return launch_mha_int8_keys<32>(cqq, g.sq, ckq, g.sk, cvq, g.sv, o, batch, Lq, Lkv, n_head,
                                  kv_valid, s);
}
