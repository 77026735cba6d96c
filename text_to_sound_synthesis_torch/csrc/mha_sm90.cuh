// The bf16 multi-head attention of the engine on Hopper, sm_90a: K7
// (attention.py::fused_mha) and the MHA inside K4, K5 and K8 under
// T2S_ATTN_MHA=base and T2S_SOFTMAX_FOLD_DIV; the pair-packed MHA of the
// served default (kMhaPair) and T3's pair_nofold (kMhaPairNoFold), as
// mha_pair_kernel below; and, as compile-time modes of the same kernel, the
// T3 probe's MHAs (tools/bench_attn_ablate.py), so that the probe ablates
// what the engine runs. K10, the int8 MHA, is mha_int8.cu, on the same
// helpers.
//
// Replaces text_to_sound_synthesis_tpu/ops/attention.py::fused_mha and the
// bf16 MHA of int8_block.py::_mha_inline: q (B*Lq, D), k/v (B*Lkv, D) bf16,
// per head h the columns h*hd .. h*hd + hd - 1; s = q k^T / sqrt(hd), keys >=
// kv_valid at -inf, an exact f32 softmax over all keys, p rounded to bf16, P V
// summed in f32 and rounded to bf16 (kMhaDiv), or p = bf16(exp(s - max))
// with the f32 output divided by the row sum (kMhaFold).
//
// What bounds it on the H100. At the flagship (8 x 265 queries, 16 heads of
// 64, 265 or 77 keys) the bytes (q, k, v, out: 17 MB at 265 keys) take 5 us at
// 3.35 TB/s and the products (2.9 GFLOP) 3 us at the bf16 peak; the f32
// softmax (exp and a divide per score) runs beside them. The mma.sync kernel
// it replaces ran at 12 x that bound: 128 blocks of 8 warps, three rounds of
// 16-query tiles each; V transposed into shared memory one element at a time
// with 8-way bank conflicts; __fdiv_rn's slow-path calls per score; 32-bit
// fragment loads and plain global loads of K and V. Here:
//   - one warpgroup (128 threads) per 64-query tile of one (head, batch):
//     ceil(Lq / 64) x heads x batch blocks, 640 at the flagship, three blocks
//     resident per SM (168 registers a thread; 44 KB of shared memory at
//     272 keys: V lands where K was once S is done, so K and V never take
//     shared memory together);
//   - Q, K and V arrive by TMA (cp.async.bulk.tensor, 3-D maps over (D, L,
//     B), so a box never reaches into the next batch element: rows past L are
//     zero-filled), 128-byte swizzle at hd 64 (64-byte at hd 32), completion
//     on two mbarriers; V's load is issued as S completes and flies while
//     the softmax runs. K and V stay keys-major as they are in memory;
//   - S = Q K^T on wgmma.m64nNk16 bf16 -> f32, both operands from shared
//     memory (N = the key bucket, 32, 80 or 144; 272 keys as two N = 136);
//     the 64 x keys scores stay in registers (136 a thread at 272 keys);
//   - the softmax on the accumulator fragment: a quad of lanes holds a row;
//     max and sum by two shuffles; the divide by sqrt(64) is the exact
//     multiply by 1/8, every other divide is div_rn (int8_common.cuh), which
//     makes no call: a call in a kernel that issues wgmma makes ptxas
//     serialize every wgmma (warning C7510);
//   - O = P V on wgmma.m64n(hd)k16 with P as the register A operand: the S
//     accumulator's fragment is the A fragment's layout, so P packs in place;
//     V is the B operand through the instruction's transpose bit (MN-major),
//     so nothing is transposed by hand;
//   - the output passes through the (then free) Q tile, swizzled, and leaves
//     as 16-byte row pieces.
// Probe modes (T3; hd 64): kMhaNoSoftmax p = bf16(s * 0.001) over every key,
// none masked; kMhaNoAv the head's output is its softmax p of its first hd
// keys, no P V (no V loaded); kMhaNoScores every score of a row is the row's
// q[0] (the first column of the whole row), unscaled, then the masked
// softmax and P V (no Q K^T, Q and K not loaded).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "int8_gemm_sm90.cuh"

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
// masked softmax. The engine's library (int8_block.cu) launches the first
// three, the probe library (int8_probe.cu) the rest.
enum MhaMode { kMhaDiv = 0, kMhaFold = 1, kMhaPair = 2, kMhaPairNoFold = 3, kMhaNoSoftmax = 4,
               kMhaNoAv = 5, kMhaNoScores = 6 };

// What t2s_int8_mha (int8_block.cu, int8_probe.cu) takes, whatever its mode.
bool mha_args_ok(int batch, int Lq, int Lkv, int n_head, int hd, int kv_valid, int mode) {
  return !(batch <= 0 || Lq <= 0 || Lkv <= 0 || Lkv > 272 || kv_valid <= 0 || kv_valid > Lkv ||
           ((mode == kMhaPair || mode == kMhaPairNoFold) && (n_head % 2 != 0 || hd != 64)) ||
           (mode == kMhaNoAv && Lkv < hd));
}

namespace mha90 {

using sm90::desc;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

constexpr int kQ = 64;   // queries per block (one warpgroup)

struct Params {
  CUtensorMap q, k, v;            // (D, L, B) bf16: boxes of (hd, rows, 1)
  const __nv_bfloat16* qp;        // kMhaNoScores: q's first columns
  __nv_bfloat16* out;
  int Lq, Lkv, D, kv_valid;
  float sqrt_hd;
};

// a 3-D box of the tensor map at (column, row, batch) into shared memory
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// keeps the compiler from reading accumulators before the wgmma wait
template <int N>
__device__ __forceinline__ void fence_f(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32) += A (64 x 16, bf16) . B (N x 16, bf16)^T, both K-major in
// shared memory (S = Q K^T). Thread t of the warpgroup holds, for j in
// 0..N/8-1, d[4j + 2hf + e] at row 16 (t / 32) + (t % 32) / 4 + 8 hf, column
// 8j + 2 (t % 4) + e: mma.sync.m16n8's per-warp layout repeated along N.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
// D (64 x N, f32) += A (64 x 16, bf16, registers: mma.sync.m16n8k16's A
// fragment per warp) . B (16 x N, bf16, MN-major in shared memory: P V with V
// keys-major, through the transpose bit)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<80>(float (&d)[40], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<136>(float (&d)[68], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67"
      "}, %68, %69, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<144>(float (&d)[72], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// A value whose bf16 rounding is that of div_rn(a, b) (the quotient
// correctly rounded to f32), given y = rcp_refined(b), for a >= 0 and b > 0
// finite: a * y lies within 4 f32 ulps of that quotient, and f32 bit patterns
// order as their values do, so the two round to the same bf16 unless a * y's
// low 16 bits lie within 8 of 0x8000, a bf16 rounding midpoint; there (one
// value in 4000) div_rn_slow, the quotient in double rounded once, settles
// it. The softmax's p = bf16(e / sum) thus costs a multiply and a compare,
// not a divide (div_rn_by's fast path, some 14 instructions, made K7 1.6x
// slower than with its divide folded into the output).
__device__ __forceinline__ float div_rn_for_bf16(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  if (__builtin_expect((__float_as_uint(q) & 0xFFFFu) - 0x7FF8u <= 16u, 0)) return div_rn_slow(a, b);
  return q;
}

// The 128-byte (hd 64) or 64-byte (hd 32) swizzle of a byte offset into a
// tile of HD-wide bf16 rows, as TMA writes it and wgmma reads it: the 16-byte
// chunk index XOR the row's bits above the swizzle's width.
template <int HD>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & (HD == 64 ? 7u : 3u)) << 4);
}

// NK: the key bucket (32, 80, 144 or 272), at least Lkv; MODE: MhaMode, not
// the pair modes. The shared memory: the Q tile (64 rows, then the output's
// staging), K and then V (NK rows), two mbarriers.
template <int HD, int NK, int MODE>
__global__ void __launch_bounds__(128, 3) mha_sm90_kernel(const __grid_constant__ Params p) {
  static_assert(HD == 32 || HD == 64, "head width 32 or 64");
  static_assert(MODE == kMhaDiv || MODE == kMhaFold || HD == 64, "the probe modes at hd 64");
  constexpr int kRow = 2 * HD;                   // bytes of a row
  constexpr int kSwz = HD == 64 ? 1 : 2;         // descriptor swizzle: 128 or 64 bytes
  constexpr int kHalves = NK > 256 ? 2 : 1;      // S on one wgmma width, or two
  constexpr int kN = NK / kHalves, kPer = kN / 2;
  constexpr bool kScores = MODE != kMhaNoScores, kAv = MODE != kMhaNoAv;
  constexpr bool kSoftmax = MODE != kMhaNoSoftmax;
  constexpr bool kDivP = MODE == kMhaDiv || MODE == kMhaNoAv || MODE == kMhaNoScores;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sq = smem_u32(sm), sk = sq + kQ * kRow, sv = sk;   // V takes K's place
  const uint32_t bar_qk = sk + NK * kRow, bar_v = bar_qk + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kQ, h = blockIdx.y, b = blockIdx.z;

  if (tid == 0) {
    mbar_init(bar_qk, 1);
    mbar_init(bar_v, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_v = [&] {
    if (kAv && tid == 0) {
      mbar_expect_tx(bar_v, NK * kRow);
#pragma unroll
      for (int i = 0; i < kHalves; ++i) tma_load3(sv + i * kN * kRow, &p.v, h * HD, i * kN, b, bar_v);
    }
  };
  if (kScores && tid == 0) {
    mbar_expect_tx(bar_qk, (kQ + NK) * kRow);
    tma_load3(sq, &p.q, h * HD, q0, b, bar_qk);
#pragma unroll
    for (int i = 0; i < kHalves; ++i) tma_load3(sk + i * kN * kRow, &p.k, h * HD, i * kN, b, bar_qk);
  }
  if (!kScores) load_v();

  // the scores: element i of half c is row gq + 8 ((i % 4) / 2), key c kN + 8 (i / 4) + 2 tq + i % 2
  float s[kHalves][kPer];
  if constexpr (kScores) {
#pragma unroll
    for (int c = 0; c < kHalves; ++c)
#pragma unroll
      for (int i = 0; i < kPer; ++i) s[c][i] = 0.0f;
    mbar_wait(bar_qk, 0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kHalves; ++c)
        wgmma_ss<kN>(s[c], desc(sq + 32 * kk, kSwz), desc(sk + c * kN * kRow + 32 * kk, kSwz), kk);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kHalves; ++c) fence_f(s[c]);
    __syncthreads();   // every warp's products are done with K: V may land there
    load_v();
  } else {
    const int r0 = min(q0 + 16 * warp + gq, p.Lq - 1), r1 = min(q0 + 16 * warp + gq + 8, p.Lq - 1);
    const float c0 = __bfloat162float(p.qp[(static_cast<size_t>(b) * p.Lq + r0) * p.D]);
    const float c1 = __bfloat162float(p.qp[(static_cast<size_t>(b) * p.Lq + r1) * p.D]);
#pragma unroll
    for (int c = 0; c < kHalves; ++c)
#pragma unroll
      for (int i = 0; i < kPer; ++i) s[c][i] = i % 4 < 2 ? c0 : c1;
  }

  // the softmax of rows gq (elements i % 4 < 2) and gq + 8
  const float rhd = HD == 64 ? 0.125f : rcp_refined(p.sqrt_hd);
  auto scaled = [&](float v) {   // s / sqrt(hd): exactly s / 8 at hd 64
    return HD == 64 ? __fmul_rn(v, 0.125f) : div_rn_by(v, p.sqrt_hd, rhd);
  };
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < kHalves; ++c)
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int key = c * kN + 8 * (i / 4) + 2 * tq + (i & 1);
      float v = s[c][i];
      if (MODE == kMhaNoSoftmax)
        v = __fmul_rn(scaled(v), 0.001f);
      else if (MODE == kMhaNoScores)
        v = key < p.kv_valid ? v : -INFINITY;
      else
        v = key < p.kv_valid ? scaled(v) : -INFINITY;
      s[c][i] = v;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], v);
    }
  float sum[2] = {0.0f, 0.0f};
  if constexpr (kSoftmax) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    }
#pragma unroll
    for (int c = 0; c < kHalves; ++c)
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        s[c][i] = expf(s[c][i] - mx[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += s[c][i];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
      sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
    }
  }
  const float rs0 = kSoftmax ? rcp_refined(sum[0]) : 1.0f, rs1 = kSoftmax ? rcp_refined(sum[1]) : 1.0f;
  // p of element i of half c before its bf16 rounding: exp / sum (kDivP),
  // else the value as it is
  auto pv = [&](int c, int i) {
    const float e = s[c][i];
    if (!kDivP) return e;
    return (i >> 1) & 1 ? div_rn_for_bf16(e, sum[1], rs1) : div_rn_for_bf16(e, sum[0], rs0);
  };
  // element e (0..3) of the global n8 block j
  auto pj = [&](int j, int e) { return pv(j / (kN / 8), 4 * (j % (kN / 8)) + e); };

  float o[HD / 2];
  if constexpr (kAv) {
    uint32_t pa[NK / 16][4];
#pragma unroll
    for (int t = 0; t < NK / 16; ++t) {
      pa[t][0] = pack_bf16(pj(2 * t, 0), pj(2 * t, 1));
      pa[t][1] = pack_bf16(pj(2 * t, 2), pj(2 * t, 3));
      pa[t][2] = pack_bf16(pj(2 * t + 1, 0), pj(2 * t + 1, 1));
      pa[t][3] = pack_bf16(pj(2 * t + 1, 2), pj(2 * t + 1, 3));
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
    mbar_wait(bar_v, 0);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < NK / 16; ++t) wgmma_rs<HD>(o, pa[t], desc(sv + t * 16 * kRow, kSwz), t);
    wgmma_commit();
    wgmma_wait<0>();
    fence_f(o);
    if (MODE == kMhaFold) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i)
        o[i] = (i >> 1) & 1 ? div_rn_by(o[i], sum[1], rs1) : div_rn_by(o[i], sum[0], rs0);
    }
  } else {
    // the output's columns are the first hd keys' p, in the same fragment layout
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = pj(i / 4, i % 4);
  }

  // the output through this warp's 16 rows of the Q tile (read by S, which is
  // done), then 16-byte pieces of whole rows
  unsigned char* stage = sm + 16 * warp * kRow;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<__nv_bfloat162*>(stage + swz<HD>((gq + 8 * hf) * kRow + 16 * j + 4 * tq)) =
          __floats2bfloat162_rn(o[4 * j + 2 * hf], o[4 * j + 2 * hf + 1]);
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * kRow / 16 / 32; ++it) {
    const int ci = 32 * it + lane, r = ci / (kRow / 16), cc = ci % (kRow / 16);
    const int grow = q0 + 16 * warp + r;
    if (grow < p.Lq)
      *reinterpret_cast<uint4*>(p.out + (static_cast<size_t>(b) * p.Lq + grow) * p.D + h * HD + 8 * cc) =
          *reinterpret_cast<const uint4*>(stage + swz<HD>(r * kRow + 16 * cc));
  }
}

// The pair-packed MHA of the TPU engine (int8_block.py::_mha_pair_premasked,
// _mha_pair; its served default at a head width of 64), MODE kMhaPair or
// kMhaPairNoFold: heads A = 2g and B = 2g + 1 share one row max, taken over
// both heads' masked scores; p = exp(s - max) in f32; each head's sum, B's
// as (sum_A + sum_B) - sum_A (JAX takes it from the pair's total); kMhaPair:
// p rounded to bf16 unnormalised, P V summed in f32 and divided by the
// head's sum, rounded to bf16; kMhaPairNoFold (T3 pair_nofold): p divided by
// the head's sum before its rounding, no divide after. The masks the TPU
// folds into its K/V dequants (x1.0, x0.0) are exact, so each head simply
// reads its own 64 columns.
// The kernel above's pieces, one warpgroup per (64 queries, pair g, batch
// element): ceil(Lq / 64) x heads / 2 x batch blocks. Both heads' score
// tiles would take 2 x 136 registers a thread at 272 keys, so B's scores are
// taken twice: first for their row max alone, then, after A's output, for
// B's own (the extra Q K^T is 0.6 GFLOP a call at the flagship). Shared
// memory: Q_A and Q_B (64 rows each, then the head's output staging), K_A and
// K_B (NK rows each); V_A lands where K_A was once S_A is done, V_B where K_B
// was once S_B is taken the second time. 87 KB at 272 keys: two blocks an SM.
template <int NK, int MODE>
__global__ void __launch_bounds__(128, 2) mha_pair_kernel(const __grid_constant__ Params p) {
  static_assert(MODE == kMhaPair || MODE == kMhaPairNoFold, "the pair modes");
  constexpr int HD = 64, kRow = 2 * HD, kSwz = 1;
  constexpr int kHalves = NK > 256 ? 2 : 1;
  constexpr int kN = NK / kHalves, kPer = kN / 2;
  constexpr bool kFold = MODE == kMhaPair;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sq_a = smem_u32(sm), sq_b = sq_a + kQ * kRow;
  const uint32_t sk_a = sq_b + kQ * kRow, sk_b = sk_a + NK * kRow;
  const uint32_t bar_qk = sk_b + NK * kRow, bar_va = bar_qk + 8, bar_vb = bar_qk + 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kQ, col_a = blockIdx.y * 2 * HD, b = blockIdx.z;

  if (tid == 0) {
    mbar_init(bar_qk, 1);
    mbar_init(bar_va, 1);
    mbar_init(bar_vb, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_qk, 2 * (kQ + NK) * kRow);
    tma_load3(sq_a, &p.q, col_a, q0, b, bar_qk);
    tma_load3(sq_b, &p.q, col_a + HD, q0, b, bar_qk);
#pragma unroll
    for (int i = 0; i < kHalves; ++i) {
      tma_load3(sk_a + i * kN * kRow, &p.k, col_a, i * kN, b, bar_qk);
      tma_load3(sk_b + i * kN * kRow, &p.k, col_a + HD, i * kN, b, bar_qk);
    }
  }
  // one head's V (columns col ..) where its K was, once every warp's
  // products are done with that K
  auto load_v = [&](uint32_t dst, int col, uint32_t bar) {
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(bar, NK * kRow);
#pragma unroll
      for (int i = 0; i < kHalves; ++i) tma_load3(dst + i * kN * kRow, &p.v, col, i * kN, b, bar);
    }
  };

  // one head's scores: element i of half c is row gq + 8 ((i % 4) / 2), key
  // c kN + 8 (i / 4) + 2 tq + i % 2; times 1/8, the same value as the divide
  // by sqrt(64); keys >= kv_valid at -inf
  float s[kHalves][kPer];
  auto scores = [&](uint32_t sq, uint32_t sk) {
#pragma unroll
    for (int c = 0; c < kHalves; ++c)
#pragma unroll
      for (int i = 0; i < kPer; ++i) s[c][i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kHalves; ++c)
        wgmma_ss<kN>(s[c], desc(sq + 32 * kk, kSwz), desc(sk + c * kN * kRow + 32 * kk, kSwz), kk);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kHalves; ++c) {
      fence_f(s[c]);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int key = c * kN + 8 * (i / 4) + 2 * tq + (i & 1);
        s[c][i] = key < p.kv_valid ? __fmul_rn(s[c][i], 0.125f) : -INFINITY;
      }
    }
  };
  // the rows' max over s, folded into mx (row gq: mx[0], gq + 8: mx[1])
  auto row_max = [&](float (&mx)[2]) {
#pragma unroll
    for (int c = 0; c < kHalves; ++c)
#pragma unroll
      for (int i = 0; i < kPer; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[c][i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    }
  };
  // s = exp(s - mx); the rows' sums
  auto exp_sum = [&](const float (&mx)[2], float (&sum)[2]) {
    sum[0] = sum[1] = 0.0f;
#pragma unroll
    for (int c = 0; c < kHalves; ++c)
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        s[c][i] = expf(s[c][i] - mx[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += s[c][i];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
      sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
    }
  };
  // one head's output from the exp registers and its sums: P V with the V at
  // sv (its barrier bar), through the head's Q tile at stage, into the
  // columns col ..
  auto pv_store = [&](uint32_t sv, uint32_t bar, unsigned char* stage, int col, const float (&sum)[2]) {
    const float rs0 = rcp_refined(sum[0]), rs1 = rcp_refined(sum[1]);
    auto pv = [&](int c, int i) {   // p before its bf16 rounding
      const float e = s[c][i];
      if (kFold) return e;
      return (i >> 1) & 1 ? div_rn_for_bf16(e, sum[1], rs1) : div_rn_for_bf16(e, sum[0], rs0);
    };
    auto pj = [&](int j, int e) { return pv(j / (kN / 8), 4 * (j % (kN / 8)) + e); };
    uint32_t pa[NK / 16][4];
#pragma unroll
    for (int t = 0; t < NK / 16; ++t) {
      pa[t][0] = pack_bf16(pj(2 * t, 0), pj(2 * t, 1));
      pa[t][1] = pack_bf16(pj(2 * t, 2), pj(2 * t, 3));
      pa[t][2] = pack_bf16(pj(2 * t + 1, 0), pj(2 * t + 1, 1));
      pa[t][3] = pack_bf16(pj(2 * t + 1, 2), pj(2 * t + 1, 3));
    }
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
    mbar_wait(bar, 0);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < NK / 16; ++t) wgmma_rs<HD>(o, pa[t], desc(sv + t * 16 * kRow, kSwz), t);
    wgmma_commit();
    wgmma_wait<0>();
    fence_f(o);
    if (kFold) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i)
        o[i] = (i >> 1) & 1 ? div_rn_by(o[i], sum[1], rs1) : div_rn_by(o[i], sum[0], rs0);
    }
    unsigned char* st = stage + 16 * warp * kRow;   // this warp's 16 rows
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<__nv_bfloat162*>(st + swz<HD>((gq + 8 * hf) * kRow + 16 * j + 4 * tq)) =
            __floats2bfloat162_rn(o[4 * j + 2 * hf], o[4 * j + 2 * hf + 1]);
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 16 * kRow / 16 / 32; ++it) {
      const int ci = 32 * it + lane, r = ci / (kRow / 16), cc = ci % (kRow / 16);
      const int grow = q0 + 16 * warp + r;
      if (grow < p.Lq)
        *reinterpret_cast<uint4*>(p.out + (static_cast<size_t>(b) * p.Lq + grow) * p.D + col + 8 * cc) =
            *reinterpret_cast<const uint4*>(st + swz<HD>(r * kRow + 16 * cc));
    }
  };

  // three passes over one copy of the code: B's scores for the row max
  // alone, then A's and B's, each with its softmax and output. Between a
  // request's GEMMs the kernel starts from a cold instruction cache, where
  // each inlined copy of the unrolled score code costs fetch time: with one
  // copy it runs there about as fast as back to back (tools/bench_mha,
  // PERF.md)
  float mx[2] = {-INFINITY, -INFINITY}, sum_a[2] = {0.0f, 0.0f};
  mbar_wait(bar_qk, 0);
#pragma unroll 1
  for (int pass = 0; pass < 3; ++pass) {
    const int hh = pass == 1 ? 0 : 1;   // head A or B
    const uint32_t sk = hh ? sk_b : sk_a, bar_v = hh ? bar_vb : bar_va;
    scores(hh ? sq_b : sq_a, sk);
    if (pass < 2) row_max(mx);
    if (pass == 0) continue;
    load_v(sk, col_a + hh * HD, bar_v);
    float sum[2];
    exp_sum(mx, sum);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (hh)
        sum[r] = __fsub_rn(__fadd_rn(sum_a[r], sum[r]), sum_a[r]);
      else
        sum_a[r] = sum[r];
    }
    pv_store(sk, bar_v, sm + hh * kQ * kRow, col_a + hh * HD, sum);
  }
}

// (D, L, B) bf16 with the row stride D, in boxes of (hd, rows, 1) with the
// swizzle of a row's width (128 or 64 bytes); reads past L fill with zeros
bool encode3(CUtensorMap* map, const void* ptr, int D, int L, int B, int hd, int rows) {
  const sm90::EncodeTiled fn = sm90::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {2ull * D, 2ull * D * L};
  const cuuint32_t boxd[3] = {static_cast<cuuint32_t>(hd), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, boxd,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            hd == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int NK, int MODE>
int launch(const void* q, const void* k, const void* v, void* out, int batch, int Lq, int Lkv,
           int n_head, int kv_valid, cudaStream_t stream) {
  if constexpr (MODE == kMhaNoAv && NK < HD) {   // no_av reads p of the first hd keys
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    constexpr bool kPair = MODE == kMhaPair || MODE == kMhaPairNoFold;
    constexpr int kBox = NK > 256 ? NK / 2 : NK;
    Params p;
    memset(&p, 0, sizeof(p));
    const int D = n_head * HD;
    if (!encode3(&p.q, q, D, Lq, batch, HD, kQ) || !encode3(&p.k, k, D, Lkv, batch, HD, kBox) ||
        !encode3(&p.v, v, D, Lkv, batch, HD, kBox))
      return static_cast<int>(cudaErrorInvalidValue);
    p.qp = static_cast<const __nv_bfloat16*>(q);
    p.out = static_cast<__nv_bfloat16*>(out);
    p.Lq = Lq;
    p.Lkv = Lkv;
    p.D = D;
    p.kv_valid = kv_valid;
    p.sqrt_hd = sqrtf(static_cast<float>(HD));
    // the pair kernel: two heads' Q and K tiles and three mbarriers
    const int smem = kPair ? 1024 + 2 * (kQ + NK) * 2 * HD + 32 : 1024 + (kQ + NK) * 2 * HD + 16;
    const auto kernel = [] {
      if constexpr (kPair)
        return mha_pair_kernel<NK, MODE>;
      else
        return mha_sm90_kernel<HD, NK, MODE>;
    }();
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      attr_set = true;
    }
    const dim3 grid((Lq + kQ - 1) / kQ, kPair ? n_head / 2 : n_head, batch);
    kernel<<<grid, 128, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
}

// the key bucket of Lkv (<= 272): one kernel per bucket, its scores all in registers
template <int HD, int MODE>
int launch_keys(const void* q, const void* k, const void* v, void* out, int batch, int Lq, int Lkv,
                int n_head, int kv_valid, cudaStream_t stream) {
  if (Lkv <= 32) return launch<HD, 32, MODE>(q, k, v, out, batch, Lq, Lkv, n_head, kv_valid, stream);
  if (Lkv <= 80) return launch<HD, 80, MODE>(q, k, v, out, batch, Lq, Lkv, n_head, kv_valid, stream);
  if (Lkv <= 144) return launch<HD, 144, MODE>(q, k, v, out, batch, Lq, Lkv, n_head, kv_valid, stream);
  return launch<HD, 272, MODE>(q, k, v, out, batch, Lq, Lkv, n_head, kv_valid, stream);
}

}  // namespace mha90
}  // namespace
