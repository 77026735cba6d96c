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
// Every multiply and divide is an _rn intrinsic or a correctly rounded
// quotient, and there is no --use_fast_math, so the twin defines the result.
//
// What bounds it on an H100. At the flagship (8 x 265 queries, 16 heads of
// 64, 265 keys) Q K^T and P V are 2.3 GOP of int8 work together, about 1.2
// us at 1979 TOP/s; the bytes (bf16 q, k, v in, bf16 out: 17 MB; the int8
// copies and scales add 6.5 MB through L2) take about 5 us at 3.35 TB/s; the
// f32 softmax and P's quantize (an exp and two quotients per score) run
// beside them. The mma.sync kernel this replaces ran at 6 % of that bound:
// 128 (batch, head) blocks on 132 SMs, each walking its 265 queries 16 per
// warp, K and V filled by plain loads and V transposed one byte at a time.
// Two launches:
//   1. the quantize pass: one warp per q or k row (row max, then the int8
//      row and its scale); one block per (batch, 32 columns) of V (a thread
//      loads 16 bytes of each of up to five keys at once and keeps them, the
//      column maxima meet in shared memory), which writes V^T, (batch, D,
//      Lpad) int8: per column its keys innermost, zero-padded to the key
//      bucket Lpad (32, 96, 160 or 288) and permuted within each 32-key group
//      into the slot order below, through a shared tile, as whole rows. Each
//      rint(x / s) is rint(x * (1 / s)) unless that product lies near a .5
//      step (quant8);
//   2. the MHA, one warpgroup per 64 queries of a (head, batch): ceil(Lq / 64)
//      x heads x batch blocks, 640 at the flagship (three resident an SM, two
//      at 288 keys, where 144 score registers a thread would spill at three):
//      - Q, K and V^T arrive by TMA (3-D maps: a box never reaches into the
//        next batch element, and rows past L are zero-filled): Q and K rows
//        of hd bytes with the swizzle of that width (64 or 32 bytes), V^T in
//        boxes of 128 keys (128-byte swizzle). V^T lands where K was once S
//        is done, and flies while the softmax runs;
//      - S = Q K^T on wgmma.m64nNk32 s8 x s8 -> s32 from shared memory (N =
//        the bucket; 288 as two N = 144: int8 wgmma takes N = 8, 16, 24 and
//        the multiples of 16 to 256); the 64 x Lpad scores stay in registers
//        (144 a thread at 288 keys);
//      - the softmax on the accumulator fragment (a quad of lanes holds a
//        row): the int32 sums to f32 on the adder (exact below 2^22), times
//        s_q s_k, times the scale (at hd 64 1/8, folded exactly into s_k);
//        the max and the sum by two shuffles. The row's largest p is e / sum
//        at e = exp(0) = 1, so P's row scale is s_p = max(1 / sum, 1e-8) /
//        127 without a pass over p. Each score's rint(p / s_p), p = e / sum,
//        both quotients correctly rounded, is rint(e * (1/sum * 1/s_p))
//        unless that product lies within 2^-13 of a .5 step (its error is
//        below 2^-14), where the two quotients are taken from double
//        reciprocals (quotient): a few instructions, where div_rn's slow path
//        would be some thirty in each of the 144 places a thread inlines it,
//        behind one warp vote a k step of 16 scores (a branch in every score
//        split the straight-line code); no call, which would make ptxas
//        serialize every wgmma;
//      - O = P V on wgmma.m64n(hd)k32 s8 x s8 -> s32, P the register A
//        operand packed in place from the scores: the accumulator holds,
//        per thread, keys 2t and 2t + 1 of each 8-key tile, the A fragment
//        four consecutive k slots, so the slots of each 32-key group are a
//        permutation of its keys (slot 4t + 2e + f <-> key 8e + 2t + f, and
//        the same in the upper 16), the order V^T was written in. Int8 wgmma
//        has no transpose bit, so V^T is K-major in memory already;
//      - acc * (s_p * s_v[column]) rounded once to bf16, through the (then
//        free) Q tile, swizzled, out as 16-byte row pieces.
// Measured on the H100 (PERF.md): the softmax and P's quantize set the pace;
// the tensor-core work is a few percent of the time.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "int8_common.cuh"
#include "mha_sm90.cuh"

namespace {

using namespace t2s_int8;
using mha90::swz;
using mha90::tma_load3;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

constexpr int kMaxKeys = 272;
constexpr int kMaxPad = 288;
constexpr int kThreads = 256;          // the quantize pass
constexpr int kWarps = kThreads / 32;
constexpr int kVCols = 32;             // V columns per quantize block
constexpr int kQ = 64;                 // queries per MHA block (one warpgroup)

// The key bucket: Lkv (<= 272) padded to a multiple of 32 (P V's k step),
// one MHA instantiation per bucket
int key_bucket(int Lkv) { return Lkv <= 32 ? 32 : Lkv <= 96 ? 96 : Lkv <= 160 ? 160 : kMaxPad; }

// 1 / b in double, within an ulp: the SFU's approximation and two Newton steps
__device__ __forceinline__ double rcp_double(float b) {
  const double bd = b;
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(bd));
  y = fma(y, fma(-bd, y, 1.0), y);
  return fma(y, fma(-bd, y, 1.0), y);
}

// 1.5 * 2^23: a float below 2^22 in magnitude plus it rounds to an integer,
// half to even, as rint
constexpr float kRound = 12582912.0f;

// |n| < 2^22 to f32, exactly, on the adder (I2F runs at a quarter of its rate)
__device__ __forceinline__ float small_i2f(int n) {
  return __fsub_rn(__int_as_float(0x4B400000 + n), kRound);
}

// rint(q) clipped to +-127, where q lies within 2^-14 of a quotient Q
// correctly rounded to f32, |Q| <= 128; near: q lies within 2^-13 of a .5
// step, the only place where rint(q) and rint(Q) may differ
__device__ __forceinline__ int rint_near(float q, bool& near) {
  const float t = __fadd_rn(fminf(fmaxf(q, -127.0f), 127.0f), kRound);
  near = fabsf(__fsub_rn(q, __fsub_rn(t, kRound))) >= 0.5f - 0x1p-13f;
  return __float_as_int(t) - 0x4B400000;
}

// A quotient a / b of floats correctly rounded to f32, from 1 / b in double
// within an ulp: a quotient of two floats is never a float rounding midpoint
// and lies at least 2^-49 (relatively) from one, and the double product lies
// within 2^-51 of it, so it rounds to the same float. The cold path of the
// quantizes below: a few instructions, where div_rn's slow path would be some
// thirty in every place that inlines it (144 a thread in the MHA).
__device__ __forceinline__ float quotient(float a, double rb) {
  return __double2float_rn(static_cast<double>(a) * rb);
}

// The twin's dynamic quantize of eight values, rint(h / s) clipped to +-127
// with each quotient correctly rounded, for |h| <= 127 s (a row's or a
// column's values over their scale), given rs = rcp_refined(s): h * rs lies
// within 2^-15 of the quotient, so only near a .5 step (one value in some
// 4000) is the quotient taken in full, on a branch the warp takes together
// for all eight, which ptxas neither predicates into every value nor lets
// split the straight-line code of the eight.
__device__ __forceinline__ void quant8(const uint4& w, const float (&s)[8], const float (&rs)[8],
                                       int (&v)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
  float h[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    h[2 * e] = __low2float(p[e]);
    h[2 * e + 1] = __high2float(p[e]);
  }
  bool near[8], any = false;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    v[e] = rint_near(__fmul_rn(h[e], rs[e]), near[e]);
    any |= near[e];
  }
  if (__any_sync(__activemask(), any)) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (near[e]) v[e] = round_clip_q(quotient(h[e], rcp_double(s[e])));
  }
}

struct QuantArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  int8_t* qq;
  int8_t* kq;
  int8_t* vt;                          // (batch, D, Lpad), slot order
  float* sq;
  float* sk;
  float* sv;                           // (batch, D)
  int Mq, Mk, D, Lkv, Lpad, row_blocks;
};

// One row of D bf16 values -> int8 with its dynamic row scale (one warp).
__device__ __forceinline__ void quant_row(const __nv_bfloat16* __restrict__ src,
                                          int8_t* __restrict__ dst, float* s_out, int D,
                                          int lane) {
  float m = 0.0f;
#pragma unroll 4
  for (int c = lane * 8; c < D; c += 256) {
    const uint4 w = *reinterpret_cast<const uint4*>(src + c);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      m = fmaxf(m, fmaxf(fabsf(__low2float(p[e])), fabsf(__high2float(p[e]))));
  }
  const float s = row_scale<true>(warp_max(m)), rs = rcp_refined(s);
  const float s8[8] = {s, s, s, s, s, s, s, s}, rs8[8] = {rs, rs, rs, rs, rs, rs, rs, rs};
#pragma unroll 4
  for (int c = lane * 8; c < D; c += 256) {
    int qv[8];
    quant8(*reinterpret_cast<const uint4*>(src + c), s8, rs8, qv);
    *reinterpret_cast<uint2*>(dst + c) =
        make_uint2(pack4(qv[0], qv[1], qv[2], qv[3]), pack4(qv[4], qv[5], qv[6], qv[7]));
  }
  if (lane == 0) *s_out = s;
}

// The k slot of key jj (0..31) within its 32-key group (see the header).
__device__ __forceinline__ int key_slot(int jj) {
  const int half = jj >> 4, r = jj & 15, e = r >> 3, t = (r & 7) >> 1, f = r & 1;
  return half * 16 + 4 * t + 2 * e + f;
}

// Blocks [0, row_blocks): eight q or k rows each, one warp per row.
// Blocks [row_blocks, ...): V of one batch element, 64 columns each, into V^T.
__global__ void __launch_bounds__(kThreads) quant_kernel(const QuantArgs g) {
  if (static_cast<int>(blockIdx.x) < g.row_blocks) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
  // V: thread t holds the 16-byte piece t % 4 (8 columns) of keys t / 4 + 64 it,
  // every load of the block in flight at once and kept for the quantize
  constexpr int kGroups = kThreads / (kVCols / 8);        // key groups: 64
  constexpr int kIt = (kMaxPad + kGroups - 1) / kGroups;  // keys a thread: 5
  constexpr int kTileRow = kMaxPad + 4;   // bytes: 73 words, so the columns' stores spread over banks
  __shared__ float red[kGroups][kVCols + 1];
  __shared__ float scale[kVCols];
  __shared__ __align__(16) int8_t tile[kVCols][kTileRow];   // V^T of the block's columns
  const int groups = g.D / kVCols;
  const int i = blockIdx.x - g.row_blocks, b = i / groups, col0 = (i % groups) * kVCols;
  const int tid = threadIdx.x, c8 = tid % (kVCols / 8), kg = tid / (kVCols / 8);
  const __nv_bfloat16* vb = g.v + static_cast<size_t>(b) * g.Lkv * g.D + col0 + 8 * c8;
  uint4 w[kIt];
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int j = kg + kGroups * it;
    w[it] = j < g.Lkv ? *reinterpret_cast<const uint4*>(vb + static_cast<size_t>(j) * g.D)
                      : make_uint4(0u, 0u, 0u, 0u);
  }
  float m[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const __nv_bfloat162* pv = reinterpret_cast<const __nv_bfloat162*>(&w[it]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      m[2 * e] = fmaxf(m[2 * e], fabsf(__low2float(pv[e])));
      m[2 * e + 1] = fmaxf(m[2 * e + 1], fabsf(__high2float(pv[e])));
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[kg][8 * c8 + e] = m[e];
  __syncthreads();
  if (tid < kVCols) {
    float mm = red[0][tid];
#pragma unroll 8
    for (int r = 1; r < kGroups; ++r) mm = fmaxf(mm, red[r][tid]);
    scale[tid] = row_scale<true>(mm);
    g.sv[static_cast<size_t>(b) * g.D + col0 + tid] = scale[tid];
  }
  __syncthreads();
  float sc[8], rsc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    sc[e] = scale[8 * c8 + e];
    rsc[e] = rcp_refined(sc[e]);
  }
  const int slot0 = (kg & ~31) + key_slot(kg & 31);
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    if (kg + kGroups * it >= g.Lpad) break;   // keys past Lkv were loaded as zeros
    int qv[8];
    quant8(w[it], sc, rsc, qv);
    int8_t* col = &tile[8 * c8][kGroups * it + slot0];
#pragma unroll
    for (int e = 0; e < 8; ++e) col[e * kTileRow] = static_cast<int8_t>(qv[e]);
  }
  __syncthreads();
  // whole rows of V^T, four bytes a thread, consecutive threads along a row
  const int words = g.Lpad / 4;
  uint32_t* dst = reinterpret_cast<uint32_t*>(g.vt + (static_cast<size_t>(b) * g.D + col0) * g.Lpad);
  for (int x = tid; x < kVCols * words; x += kThreads)
    dst[x] = *reinterpret_cast<const uint32_t*>(&tile[x / words][4 * (x % words)]);
}

struct MhaArgs {
  CUtensorMap q, k;                // int8 (D, L, B), boxes (hd, rows, 1)
  CUtensorMap vt;                  // int8 (Lpad, D, B), boxes (128, hd, 1)
  const float* sq;                 // (batch * Lq)
  const float* sk;                 // (batch * Lkv)
  const float* sv;                 // (batch, D)
  __nv_bfloat16* out;
  int Lq, Lkv, D, kv_valid;
  float scale;                     // f32(1 / sqrt(hd))
};

// wgmma descriptor of a K-major int8 tile whose rows are `row` bytes (32,
// 64 or 128) with the swizzle of that width: start address, the 8-row
// stride, the swizzle mode (3: 32 bytes, 2: 64, 1: 128)
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int row) {
  const uint64_t mode = row == 128 ? 1 : row == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * row) >> 4) << 32) | (mode << 62);
}

template <int N>
__device__ __forceinline__ void fence_i(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x N, s32) += A (64 x 32, s8) . B (N x 32, s8)^T, both K-major in
// shared memory (S = Q K^T); the accumulator's layout is the bf16 wgmma's
// (mha_sm90.cuh: wgmma_ss).
template <int N>
__device__ __forceinline__ void wgmma_s8_ss(int (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
// D (64 x N, s32) += A (64 x 32, s8, registers: mma.sync.m16n8k32's A
// fragment per warp) . B (N x 32, s8, K-major in shared memory: P V with V^T)
template <int N>
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8_ss<32>(int (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8_ss<96>(int (&d)[48], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8_ss<144>(int (&d)[72], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8_ss<160>(int (&d)[80], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<32>(int (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<64>(int (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


// NK: the key bucket (32, 96, 160 or 288), at least Lkv. The shared memory:
// the Q tile (64 rows, then the output's staging), K and then V^T, the keys'
// and the columns' scales, two mbarriers.
template <int HD, int NK>
__global__ void __launch_bounds__(128, NK > 256 ? 2 : 3) mha_int8_sm90_kernel(const __grid_constant__ MhaArgs p) {
  static_assert(HD == 32 || HD == 64, "head width 32 or 64");
  static_assert(NK % 32 == 0, "keys are padded to a multiple of 32");
  constexpr int kHalves = NK > 256 ? 2 : 1;      // S on one wgmma width, or two
  constexpr int kN = NK / kHalves, kPer = kN / 2;
  constexpr int kVBoxes = (NK + 127) / 128;      // V^T boxes of 128 keys
  constexpr int kOut = 2 * HD;                   // bytes of an output row
  constexpr int kKV = NK * HD > kVBoxes * 128 * HD ? NK * HD : kVBoxes * 128 * HD;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sq = smem_u32(sm), skv = sq + kQ * kOut;   // V^T takes K's place
  float* sks = reinterpret_cast<float*>(sm + kQ * kOut + kKV);   // [NK]
  float* svs = sks + NK;                                         // [HD]
  const uint32_t bar_qk = smem_u32(svs + HD), bar_v = bar_qk + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kQ, h = blockIdx.y, b = blockIdx.z;

  if (tid == 0) {
    mbar_init(bar_qk, 1);
    mbar_init(bar_v, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_qk, (kQ + NK) * HD);
    tma_load3(sq, &p.q, h * HD, q0, b, bar_qk);
#pragma unroll
    for (int i = 0; i < kHalves; ++i) tma_load3(skv + i * kN * HD, &p.k, h * HD, i * kN, b, bar_qk);
  }
  // s_k, at hd 64 times 1/8 (exact): s = acc * (s_q * s_k / 8) is then the
  // twin's (acc * (s_q * s_k)) / 8, one multiply less a score
  constexpr float kSk = HD == 64 ? 0.125f : 1.0f;
  for (int j = tid; j < NK; j += 128)
    sks[j] = j < p.Lkv ? __fmul_rn(p.sk[static_cast<size_t>(b) * p.Lkv + j], kSk) : 0.0f;
  for (int d = tid; d < HD; d += 128) svs[d] = p.sv[static_cast<size_t>(b) * p.D + h * HD + d];
  // the row scales of rows gq and gq + 8 (rows past Lq read row Lq - 1)
  const int r0 = min(q0 + 16 * warp + gq, p.Lq - 1), r1 = min(q0 + 16 * warp + gq + 8, p.Lq - 1);
  const float sqr[2] = {p.sq[static_cast<size_t>(b) * p.Lq + r0], p.sq[static_cast<size_t>(b) * p.Lq + r1]};

  // S: element i of half c is row gq + 8 ((i % 4) / 2), key c kN + 8 (i / 4) + 2 tq + i % 2
  int acc[kHalves][kPer];
#pragma unroll
  for (int c = 0; c < kHalves; ++c)
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[c][i] = 0;
  mbar_wait(bar_qk, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 32; ++kk)
#pragma unroll
    for (int c = 0; c < kHalves; ++c)
      wgmma_s8_ss<kN>(acc[c], desc_k(sq + 32 * kk, HD), desc_k(skv + c * kN * HD + 32 * kk, HD), kk);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < kHalves; ++c) fence_i(acc[c]);
  __syncthreads();   // every warp's products are done with K and Q; the scales are in
  if (tid == 0) {
    mbar_expect_tx(bar_v, kVBoxes * 128 * HD);
#pragma unroll
    for (int i = 0; i < kVBoxes; ++i) tma_load3(skv + i * 128 * HD, &p.vt, 128 * i, h * HD, b, bar_v);
  }

  // s = acc * (s_q * s_k) * scale, keys >= kv_valid at -inf; the softmax of
  // rows gq (elements i % 4 < 2) and gq + 8
  float s[kHalves][kPer];
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < kHalves; ++c)
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int key = c * kN + 8 * (i / 4) + 2 * tq + (i & 1), r = (i >> 1) & 1;
      const float v = __fmul_rn(small_i2f(acc[c][i]), __fmul_rn(sqr[r], sks[key]));
      s[c][i] = key < p.kv_valid ? (HD == 64 ? v : __fmul_rn(v, p.scale)) : -INFINITY;
      mx[r] = fmaxf(mx[r], s[c][i]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < kHalves; ++c)
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      s[c][i] = expf(__fsub_rn(s[c][i], mx[(i >> 1) & 1]));
      sum[(i >> 1) & 1] = __fadd_rn(sum[(i >> 1) & 1], s[c][i]);
    }
  float sp[2], cq[2];
  double rsum[2], rsp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(kFull, sum[r], 1));
    sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(kFull, sum[r], 2));
    sp[r] = row_scale<true>(div_rn(1.0f, sum[r]));   // the row's largest p: e = 1 at its max
    cq[r] = __fmul_rn(rcp_refined(sum[r]), rcp_refined(sp[r]));
    rsum[r] = rcp_double(sum[r]);
    rsp[r] = rcp_double(sp[r]);
  }
  // P's A fragments in slot order, straight from the score registers: k step
  // t packs the 16 scores of the 8-key tiles 4t .. 4t + 3 (score u: element
  // u % 4 of tile 4t + u / 4), each rint(p / s_p), p = e / sum (module
  // header), 0 .. 127; one warp vote a k step for the exact path
  uint32_t pa[NK / 32][4];
#pragma unroll
  for (int t = 0; t < NK / 32; ++t) {
    int v[16];
    bool near[16], any = false;
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int j = 4 * t + u / 4, c = j / (kN / 8), i = 4 * (j % (kN / 8)) + u % 4;
      v[u] = rint_near(__fmul_rn(s[c][i], cq[(u >> 1) & 1]), near[u]);
      any |= near[u];
    }
    if (__any_sync(kFull, any)) {
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int j = 4 * t + u / 4, c = j / (kN / 8), i = 4 * (j % (kN / 8)) + u % 4, r = (u >> 1) & 1;
        if (near[u]) v[u] = round_clip_q(quotient(quotient(s[c][i], rsum[r]), rsp[r]));
      }
    }
    auto pack = [&](int a, int b, int c, int d) {   // 0 .. 127 each
      return static_cast<uint32_t>(v[a] | (v[b] << 8) | (v[c] << 16) | (v[d] << 24));
    };
    pa[t][0] = pack(0, 1, 4, 5);
    pa[t][1] = pack(2, 3, 6, 7);
    pa[t][2] = pack(8, 9, 12, 13);
    pa[t][3] = pack(10, 11, 14, 15);
  }

  int o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0;
  mbar_wait(bar_v, 0);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < NK / 32; ++t)
    wgmma_s8_rs<HD>(o, pa[t], desc_k(skv + (t / 4) * 128 * HD + 32 * (t % 4), 128), t);
  wgmma_commit();
  wgmma_wait<0>();
  fence_i(o);

  // acc * (s_p * s_v) through this warp's 16 rows of the Q tile, then
  // 16-byte pieces of whole rows
  unsigned char* stage = sm + 16 * warp * kOut;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = 8 * j + 2 * tq;
    const float sv0 = svs[c], sv1 = svs[c + 1];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float y0 = __fmul_rn(__int2float_rn(o[4 * j + 2 * hf]), __fmul_rn(sp[hf], sv0));
      const float y1 = __fmul_rn(__int2float_rn(o[4 * j + 2 * hf + 1]), __fmul_rn(sp[hf], sv1));
      *reinterpret_cast<__nv_bfloat162*>(stage + swz<HD>((gq + 8 * hf) * kOut + 2 * c)) =
          __floats2bfloat162_rn(y0, y1);
    }
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * kOut / 16 / 32; ++it) {
    const int ci = 32 * it + lane, r = ci / (kOut / 16), cc = ci % (kOut / 16);
    const int grow = q0 + 16 * warp + r;
    if (grow < p.Lq)
      *reinterpret_cast<uint4*>(p.out + (static_cast<size_t>(b) * p.Lq + grow) * p.D + h * HD + 8 * cc) =
          *reinterpret_cast<const uint4*>(stage + swz<HD>(r * kOut + 16 * cc));
  }
}

// (inner, rows, B) int8, row-major, in boxes of (box_inner, box_rows, 1) with
// the swizzle of box_inner bytes (32, 64 or 128); reads past the edges fill
// with zeros
bool encode_s8(CUtensorMap* map, const void* ptr, int inner, int rows, int B, int box_inner,
               int box_rows) {
  const sm90::EncodeTiled fn = sm90::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner),
                                 static_cast<cuuint64_t>(inner) * static_cast<cuuint64_t>(rows)};
  const cuuint32_t boxd[3] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_inner == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_inner == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                       : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims, strides, boxd,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int NK>
int launch_mha(const int8_t* qq, const float* sq, const int8_t* kq, const float* sk,
               const int8_t* vt, const float* sv, __nv_bfloat16* out, int batch, int Lq, int Lkv,
               int n_head, int kv_valid, cudaStream_t stream) {
  constexpr int kVBoxes = (NK + 127) / 128;
  constexpr int kKV = NK * HD > kVBoxes * 128 * HD ? NK * HD : kVBoxes * 128 * HD;
  constexpr int kBox = NK > 256 ? NK / 2 : NK;
  MhaArgs a;
  memset(&a, 0, sizeof(a));
  const int D = n_head * HD;
  if (!encode_s8(&a.q, qq, D, Lq, batch, HD, kQ) || !encode_s8(&a.k, kq, D, Lkv, batch, HD, kBox) ||
      !encode_s8(&a.vt, vt, NK, D, batch, 128, HD))
    return static_cast<int>(cudaErrorInvalidValue);
  a.sq = sq;
  a.sk = sk;
  a.sv = sv;
  a.out = out;
  a.Lq = Lq;
  a.Lkv = Lkv;
  a.D = D;
  a.kv_valid = kv_valid;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  const int smem = 1024 + kQ * 2 * HD + kKV + 4 * (NK + HD) + 16;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(mha_int8_sm90_kernel<HD, NK>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((Lq + kQ - 1) / kQ, n_head, batch);
  mha_int8_sm90_kernel<HD, NK><<<grid, 128, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_mha_keys(const int8_t* qq, const float* sq, const int8_t* kq, const float* sk,
                    const int8_t* vt, const float* sv, __nv_bfloat16* out, int batch, int Lq,
                    int Lkv, int n_head, int kv_valid, cudaStream_t s) {
  switch (key_bucket(Lkv)) {
    case 32: return launch_mha<HD, 32>(qq, sq, kq, sk, vt, sv, out, batch, Lq, Lkv, n_head, kv_valid, s);
    case 96: return launch_mha<HD, 96>(qq, sq, kq, sk, vt, sv, out, batch, Lq, Lkv, n_head, kv_valid, s);
    case 160: return launch_mha<HD, 160>(qq, sq, kq, sk, vt, sv, out, batch, Lq, Lkv, n_head, kv_valid, s);
    default: return launch_mha<HD, kMaxPad>(qq, sq, kq, sk, vt, sv, out, batch, Lq, Lkv, n_head, kv_valid, s);
  }
}

}  // namespace

// The most keys the MHA takes (its score registers).
extern "C" int t2s_mha_int8_max_keys() { return kMaxKeys; }

// K10: q (batch*Lq, H*hd), k/v (batch*Lkv, H*hd) bf16 -> out (batch*Lq, H*hd)
// bf16; keys >= kv_valid masked (0 < kv_valid <= Lkv <= 272), hd 32 or 64.
// Scratch from the caller: qq (batch*Lq, D), kq (batch*Lkv, D) and vt (batch,
// D, lpad) int8, lpad the key bucket of Lkv (32, 96, 160 or 288); sq
// (batch*Lq), sk (batch*Lkv) and sv (batch, D) f32. Two launches on
// `stream`; returns the CUDA error code.
extern "C" int t2s_mha_int8(const void* q, const void* k, const void* v, void* out, void* qq,
                            void* kq, void* vt, void* sq, void* sk, void* sv, int batch, int Lq,
                            int Lkv, int n_head, int hd, int kv_valid, int lpad, void* stream) {
  if (batch <= 0 || Lq <= 0 || Lkv <= 0 || Lkv > kMaxKeys || kv_valid <= 0 || kv_valid > Lkv ||
      n_head <= 0 || (hd != 32 && hd != 64) || lpad != key_bucket(Lkv))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  QuantArgs g;
  g.q = static_cast<const __nv_bfloat16*>(q);
  g.k = static_cast<const __nv_bfloat16*>(k);
  g.v = static_cast<const __nv_bfloat16*>(v);
  g.qq = static_cast<int8_t*>(qq);
  g.kq = static_cast<int8_t*>(kq);
  g.vt = static_cast<int8_t*>(vt);
  g.sq = static_cast<float*>(sq);
  g.sk = static_cast<float*>(sk);
  g.sv = static_cast<float*>(sv);
  g.Mq = batch * Lq;
  g.Mk = batch * Lkv;
  g.D = n_head * hd;
  g.Lkv = Lkv;
  g.Lpad = lpad;
  g.row_blocks = (g.Mq + g.Mk + kWarps - 1) / kWarps;
  const int blocks = g.row_blocks + batch * (g.D / kVCols);
  quant_kernel<<<blocks, kThreads, 0, s>>>(g);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (hd == 64)
    return launch_mha_keys<64>(g.qq, g.sq, g.kq, g.sk, g.vt, g.sv, o, batch, Lq, Lkv, n_head,
                               kv_valid, s);
  return launch_mha_keys<32>(g.qq, g.sq, g.kq, g.sk, g.vt, g.sv, o, batch, Lq, Lkv, n_head,
                             kv_valid, s);
}
