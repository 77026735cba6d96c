// The Hopper mainloop of the engine's int8 GEMM: wgmma fed by a TMA ring.
//
// It runs every launch that int8_block.cu's and int8_probe.cu's dispatch
// tables send to `sm90::launch`: K3's fc1 on the LN panel and its fc2 in the
// int8 A mode; K4's, K5's, K6's and K8's dots and K9's chunked fc2 in the int8
// A mode, each behind a quantize pass (int8_quant.cuh); T2's fc1
// configurations and its fc2s, T3's dots, and T1's int8 dots. The panel keeps
// the plain twins' arithmetic: exact int32 sums, the LayerNorm and quantize
// row by row with the _rn intrinsics, the epilogue's operations in the twins'
// order, so every launch is bit-equal to its plain twin wherever the f32
// statistics are.
//
// What bounds it on the H100. K3's two dots at the flagship (2120 rows, 1024
// -> 4096 -> 1024) are 17.8 GOP each: 9 us at the int8 peak (1979 TOP/s),
// while the weights (2-4 MB) and activations stay in the 50 MB L2. So the
// products bound it, and the retired mma.sync mainloop reached 6-13 % of that
// peak: 64 x 128 tiles of mma.sync.m16n8k32 from 32-bit shared-memory loads, a
// two-stage cp.async ring of 64-byte K slices, loads issued by the compute
// warps. Here:
//   - a 128 x 128 output tile per block, two consumer warpgroups of 64 rows,
//     each issuing wgmma.mma_async.m64n128k32 s8 x s8 -> s32 with both
//     operands read from shared memory through descriptors (int8 wgmma takes
//     both K-major: A (M, K) and the weight (N, K) already are);
//   - one producer warp keeps TMA loads (cp.async.bulk.tensor, 128-byte
//     swizzle, mbarrier completion) in flight through a ring of 4-6 stages,
//     each 128 k values deep; setmaxnreg moves its registers to the consumers;
//   - panel mode (fc1): the consumers build the block's 128 normalised,
//     quantized rows (K <= 1024: 128 KB) straight into the swizzled layout the
//     A descriptors read, then walk a contiguous run of the row block's output
//     tiles with them (a persistent grid of at most one block per SM: each row
//     block gets floor(SMs / row blocks) blocks), so the panel is built once
//     per block, not once per tile; the producer streams weight tiles meanwhile;
//   - int8 A mode (fc2, T1): A and the weight both arrive by TMA, rows past M
//     zero-filled by the tensor map (stores stay masked); the grid is
//     stream-K: min(SMs, tiles x steps) blocks each take an equal contiguous
//     run of (tile, k step) units, so fc2's 17 x 8 = 136 tiles spread over 132
//     SMs with no second wave of four tiles. A tile split between blocks: each
//     contributor stores its int32 partial sums to its own workspace slot and
//     adds its steps to the tile's counter; the one that completes the count
//     adds the others' slots (integer sums: any order gives the same bits) and
//     runs the epilogue. Slots need no zeroing; the finisher resets the counter.
//   - the chunked epilogue (K9's fc2): each K chunk's int32 sums are flushed
//     into an f32 accumulator at the chunk's last step, y += acc_c * (s_c *
//     scale), from the residual, in chunk order; f32 sums do not add in any
//     order, so these launches run data-parallel (whole tiles, a persistent
//     grid of min(SMs, tiles) blocks), no tile split.
// Measured on the H100 (PERF.md): a build without the products ran as
// long, so the tensor cores wait on the rest, and three things set the pace. The epilogue: the fragment's own 2- to 8-byte stores, 8 rows
// each, cost ~2000 transactions a tile, so the outputs (and a residual) pass
// through a 16-row slab of shared memory per warp and leave as 128-byte row
// pieces. The conversion unit (a quarter of the adder's rate): rintf and the
// float -> int conversion of every quantize become one add and one integer
// subtract (round_clip_q), and no division calls a slow path (div_rn). The
// loads: a stage is freed as soon as its products are done, one stage more
// in flight than freeing it a step later.
// W4 (nibble-packed, a byte holds k and k + K/2): wgmma reads B only from
// shared memory, so the packed tile (128 rows x 64 bytes, 64-byte swizzle)
// arrives by TMA and three producer warps unpack it into two int8 tiles, k and
// k + K/2, each byte to the same swizzled place (so no address arithmetic),
// fence the async proxy and signal the consumers; the A descriptors point at
// the matching k and k + K/2 (panel offsets, or two TMA boxes in int8 mode).
// QuantizedWeight.w_q keeps its bytes: no second copy of the weight. (The other
// way, the weight as A from registers and the activation as B, would turn the
// output tile and the per-token row max across warps.)
// Tensor maps are encoded on the host at every launch (cuTensorMapEncodeTiled,
// fetched through cudaGetDriverEntryPoint, so the build needs no -lcuda) and
// passed in a __grid_constant__ parameter. tools/bench_kernel_dot prints the
// host time of an eager call: 25-47 us for T1's int8 cases, which encode two
// maps, against 26-46 us for its bf16 case, which encodes none (PERF.md): the
// encoding is lost in the Python wrapper's spread, so no cache.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only: the encoder is fetched at run time)
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "int8_common.cuh"

namespace {

using namespace t2s_int8;

constexpr int kMaxPanelK = 1024;   // panel rows live in registers while built
constexpr int kNMultiple = 128;    // output widths: whole 128-wide tiles
constexpr int kKMultiple = 64;     // stored bytes of a weight row: whole TMA boxes of W4

enum AMode { kPanel = 0, kInt8 = 2 };
// kEpiStore: [GELU2] [+ residual] -> bf16 or f32 (and the row max |y| per N
// chunk when amax_out is set); kEpiGeluInt8: GELU2 quantized to int8;
// kEpiChunked: the K dimension in nch chunks, each chunk's int32 sums flushed
// with its own row scale into an f32 accumulator that starts at the residual,
// then + bias -> bf16 or f32; kEpiRaw (T1, the bare dot probe): the int32
// sums stored as they are, or converted to f32.
// The T2 probe's fc1 epilogues with an int8 output: kEpiWrap8 (dots_only), the
// int32 sums wrapped to int8 (their low byte); kEpiClip8 (no_quant_mid), the
// dequant [GELU2] clipped to +-127 and truncated; kEpiShift8 (no_deq_mid),
// clip(sum >> 7, +-127). The last two also store the panel's row max |h| in
// amax_out: fc2 takes the input's row scale for the middle's.
enum Epi { kEpiStore = 0, kEpiGeluInt8 = 1, kEpiChunked = 2, kEpiRaw = 3, kEpiWrap8 = 4,
           kEpiClip8 = 5, kEpiShift8 = 6 };
// The T2 probe's panel inputs besides Norm's: kNormCast, x truncated to int8
// as it is, no scale (dots_only); kNormLN1, LayerNorm with the variance as
// E[x^2] - E[x]^2 (ln_onepass).
constexpr int kNormCast = 3, kNormLN1 = 4;
// What an epilogue applies and which dtypes its operands have, as bits of a
// template parameter: every launch compiles with its flags folded, as fast as
// a GEMM written for one of them (a run-time flag in the epilogue cost K3-K5
// 9-30 % on the H100).
enum EpiFlags {
  kEfGelu = 1,     // GELU2 after the dequant (kEpiStore)
  kEfRes = 2,      // + residual
  kEfResF32 = 4,   // the residual is f32 (else bf16)
  kEfOutF32 = 8,   // the output is f32 (else bf16)
  kEfMax = 16,     // the row max |y| per N chunk into amax_out (kEpiStore)
  // the T2 probe's:
  kEfMidBf16 = 64,    // kEpiStore: dequant and GELU2 in bf16 steps, the row max floored at amax_floor
  kEfSigC = 128,      // with kEfMidBf16: the sigmoid as 1 / (1 + exp(-1.702 u)), bf16 steps
  kEfFastSig = 256,   // kEpiStore: the sigmoid as 0.5 + 0.5 z / (1 + |z|), z = 1.702 u
  kEfQBf16 = 512,     // int8 mode: the dynamic row scale rounded to bf16 (mid_bf16's fc2)
  kEfRawBf16 = 1024,  // kEpiRaw: the int32 sums rounded to bf16
};
constexpr int kEfProbe = kEfMidBf16 | kEfSigC | kEfFastSig | kEfQBf16 | kEfRawBf16;

struct GemmArgs {
  const void* a;             // (M, K): panel bf16, int8 mode int8
  int ef;                    // EpiFlags of this launch
  const float* mod;          // (2, K) f32 prologue rows
  const float* amax_in;      // int8 mode, dynamic: (M, nch) row max |a| per K chunk
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
  int nch;                   // chunks of K (kEpiChunked) or of N (amax_out)
  int nt;                    // unused (kept so that the kernels' parameter layout holds)
  float amax_floor;          // kEfMidBf16: the floor of the row max |y|
};

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

// GemmArgs from the arguments of t2s_int8_dense (int8_block.cu, int8_probe.cu:
// the same C signature, each with its own table of instantiations); false
// where they lie outside what the mainloop takes: amode 0 (panel, bf16 A, K a
// multiple of 128 up to kMaxPanelK) or 2 (int8 A).
bool dense_args(GemmArgs& g, int amode, int w4, int epi, const void* a, const void* mod, const void* amax_in, float s_static, float inv_static,
                int is_static, int n_w, const void* const (&ws)[3], const void* const (&scs)[3],
                const void* const (&bs)[3], void* const (&os)[3], const void* residual, int res_f32,
                int gelu, int out_f32, void* amax_out, float out_inv, int nch, int M, int K, int N,
                int probe, float amax_floor) {
  g.a = a;
  g.ef = (gelu ? kEfGelu : 0) | (residual != nullptr ? kEfRes : 0) | (res_f32 ? kEfResF32 : 0) |
         (out_f32 ? kEfOutF32 : 0) | (amax_out != nullptr ? kEfMax : 0) | probe;
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
  return !(M <= 0 || n_w < 1 || n_w > 3 || N % kNMultiple != 0 || Kb % kKMultiple != 0 ||
           nch < 1 || (amode != kPanel && amode != kInt8) ||
           (amode == kPanel && (K % 128 != 0 || K > kMaxPanelK || epi == kEpiChunked)) ||
           (amode == kInt8 && (K % nch != 0 || (w4 && nch != 1))) ||
           (amax_out != nullptr && (N % nch != 0 || (N / nch) % kNMultiple != 0)) ||
           (epi == kEpiChunked && (residual == nullptr || w4)) || (probe & ~kEfProbe) != 0 ||
           ((epi == kEpiClip8 || epi == kEpiShift8) && amax_out == nullptr) ||
           (amax_in == nullptr && !is_static && amode == kInt8 && epi != kEpiRaw));
}

namespace sm90 {

constexpr int kBM = 128, kBN = 128;     // output tile
constexpr int kThreads = 384;           // warpgroups 0 and 1 consume, warpgroup 2 produces
constexpr int kConsumerWarps = 8;
constexpr int kUnpackThreads = 96;      // W4: warps 9-11 unpack
constexpr int kPanelBlock = kBM * 128;  // one 128-byte K block of the panel, 16 KB
constexpr int kSlot = kBM * kBN;        // one tile's int32 partial sums (stream-K)
constexpr int kSlab = 16 * 128;         // a consumer warp's epilogue slab: 16 rows of 128 bytes

// Shared memory of a configuration: per stage the A tile(s) (int8 mode; W4:
// k and k + K/2, 64 bytes wide each) and the weight tile (W4: packed, 64
// bytes wide); W4 also a ring of unpacked weight tiles (k, k + K/2).
template <int AMODE, bool W4>
struct Ring {
  static constexpr int kA = AMODE == kInt8 ? kBM * 128 : 0;
  static constexpr int kB = W4 ? kBN * 64 : kBN * 128;
  static constexpr int kU = W4 ? kBN * 128 : 0;
  static constexpr int kStages = AMODE == kInt8 ? 6 : (W4 ? 4 : 5);
  static constexpr int kUStages = W4 ? 3 : 0;
  static constexpr int kTx = kA + kB;   // bytes TMA delivers per stage
  static constexpr int kRing = kStages * (kA + kB) + kUStages * kU;
  // after the panel: the ring, the epilogue slabs, the row scales, the barriers, the finisher flag
  static constexpr int kTail = kRing + kConsumerWarps * kSlab + kBM * 4 + 8 * 2 * (kStages + kUStages) + 16;
};

struct Params {
  CUtensorMap tb[3];   // the weights, (N, K) int8 or (N, K/2) packed W4 bytes
  CUtensorMap ta;      // int8 mode: A (M, K)
  GemmArgs g;
  int* ws;             // int8 mode: two partial-sum slots per block (kSlot ints each)
  int* cnt;            // int8 mode: one counter per block, zero between launches
  int n_w, ntn;        // weights; 128-wide tiles per weight
  int row_blocks;      // 128-row blocks
  int steps;           // k steps of 128 values per tile
  int bpr;             // panel mode: blocks per row block
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Spins inside one asm block, so the warp leaves it converged for the
// .sync.aligned wgmma instructions that follow.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// a 2-D box of the tensor map at (c0 = byte column, c1 = row) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// generic-proxy stores to shared memory, made visible to wgmma and TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the two consumer warpgroups only (the producer never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerWarps * 32) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile: start address, the
// 8-row stride (SBO, 1024 bytes at a 128-byte swizzle, 512 at 64) and the
// swizzle (1: 128 bytes, 2: 64 bytes); the leading offset is unused there
__device__ __forceinline__ uint64_t desc(uint32_t addr, int swz) {
  const uint32_t sbo = swz == 1 ? 1024 : 512;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (static_cast<uint64_t>(swz) << 62);
}

// D (64 x 128, s32) += A (64 x 32, s8) . B (128 x 32, s8)^T, both from shared
// memory; scale_d 0 starts the sums. Thread t of the warpgroup holds, for j in
// 0..15, d[4j + 2hf + e] at row 16 (t / 32) + (t % 32) / 4 + 8 hf, column
// 8j + 2 (t % 4) + e: mma.sync.m16n8's per-warp layout repeated along N.
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads across a wgmma wait
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The panel's rows, 128 of them, as int8 in the 128-byte-swizzled K blocks
// the A descriptors read: row lr's 16-byte chunk c of K block i at i *
// kPanelBlock + lr * 128 + 16 (c ^ (lr % 8)). Each of the 8 consumer warps
// builds 16 rows, four at a time: their loads in flight together and their
// sum chains interleaved (one row at a time left the warp waiting on one
// chain of dependent adds), the LN affine read once for all of them. Per row:
// lane l holds k = 128 i + 4 l + e, its sums in that order and then the warp's
// butterfly, div_rn for the mean, the variance and the dynamic quantize, the
// static one a multiply (divisions by div_rn: correctly rounded quotients
// without a call, see int8_common.cuh).
template <int NORM, bool KEEP>
__device__ __forceinline__ void build_panel_swz(const GemmArgs& g, bool a32, unsigned char* panel,
                                                float* srow, int m0, int cw, int lane,
                                                bool keep_here) {
  constexpr bool kPlain = NORM == kNormNone || NORM == kNormCast;
  constexpr int kRows = kBM / kConsumerWarps, R = 4, kV = kMaxPanelK / 32;
  const int K = g.K, nkc = K / 128;
  const bool st = g.is_static != 0;
  const int lo = (lane & 3) * 4;
  auto word = [&](int lr, int i) {
    return reinterpret_cast<uint32_t*>(panel + i * kPanelBlock + lr * 128 +
                                       ((((lane >> 2) ^ (lr & 7)) << 4) | lo));
  };
  for (int r0 = cw * kRows; r0 < (cw + 1) * kRows; r0 += R) {
    // lane holds k = 128*i + 4*lane + e of rows r0 .. r0 + R - 1 (rows past M: zero)
    float v[R][kV];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = m0 + r0 + j;
      const size_t row = static_cast<size_t>(r < g.M ? r : 0) * K;
#pragma unroll
      for (int i = 0; i < kMaxPanelK / 128; ++i) {
        float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i < nkc && r < g.M) f = load4(g.a, row + 128 * i + 4 * lane, a32);
        v[j][4 * i] = f.x;
        v[j][4 * i + 1] = f.y;
        v[j][4 * i + 2] = f.z;
        v[j][4 * i + 3] = f.w;
      }
    }
    float s[R];   // the row scales
    if (NORM == kNormCast) {
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int i = 0; i < kMaxPanelK / 128; ++i)
          if (i < nkc)
            *word(r0 + j, i) = pack4(cast_s8(v[j][4 * i]), cast_s8(v[j][4 * i + 1]),
                                     cast_s8(v[j][4 * i + 2]), cast_s8(v[j][4 * i + 3]));
      continue;
    }
    float mean[R], rstd[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      mean[j] = 0.0f;
      rstd[j] = 1.0f;
    }
    if (NORM == kNormLN1) {
      float sum[R], sq[R];
#pragma unroll
      for (int j = 0; j < R; ++j) sum[j] = sq[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < kV; ++i)
        if (i / 4 < nkc)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            sum[j] = __fadd_rn(sum[j], v[j][i]);
            sq[j] = __fadd_rn(sq[j], __fmul_rn(v[j][i], v[j][i]));
          }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        mean[j] = div_rn(warp_sum(sum[j]), static_cast<float>(K));
        const float var = __fsub_rn(div_rn(warp_sum(sq[j]), static_cast<float>(K)),
                                    __fmul_rn(mean[j], mean[j]));
        rstd[j] = rsqrtf(__fadd_rn(var, kLnEps));
      }
    } else if (!kPlain) {
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
    float amax[R];
#pragma unroll
    for (int j = 0; j < R; ++j) amax[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      if (i / 4 < nkc) {
        const int k = 128 * (i / 4) + 4 * lane + (i % 4);
        const float m0v = kPlain ? 0.0f : g.mod[k];
        const float m1v = kPlain ? 0.0f : g.mod[K + k];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          v[j][i] = prologue<kPlain ? kNormNone : NORM>(v[j][i], mean[j], rstd[j], m0v, m1v);
          amax[j] = fmaxf(amax[j], fabsf(v[j][i]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      s[j] = st ? g.s_static : row_scale<true>(warp_max(amax[j]));
      if (KEEP) {
        const float am = warp_max(amax[j]);
        if (lane == 0 && keep_here && m0 + r0 + j < g.M) g.amax_out[m0 + r0 + j] = am;
      }
    }
    // static and dynamic apart, so that no divide is computed where a multiply
    // is asked; the dynamic row's divides share its divisor's reciprocal
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool in = m0 + r0 + j < g.M;
      if (st) {
#pragma unroll
        for (int i = 0; i < kMaxPanelK / 128; ++i)
          if (i < nkc)
            *word(r0 + j, i) =
                in ? pack4(quantize<true>(v[j][4 * i], 0.0f, g.inv_static, true),
                           quantize<true>(v[j][4 * i + 1], 0.0f, g.inv_static, true),
                           quantize<true>(v[j][4 * i + 2], 0.0f, g.inv_static, true),
                           quantize<true>(v[j][4 * i + 3], 0.0f, g.inv_static, true))
                   : 0u;
      } else {
        const float y = rcp_refined(s[j]);
        auto q = [&](float h) { return round_clip_q(div_rn_by(h, s[j], y)); };   // quantize's h / s
#pragma unroll
        for (int i = 0; i < kMaxPanelK / 128; ++i)
          if (i < nkc)
            *word(r0 + j, i) = in ? pack4(q(v[j][4 * i]), q(v[j][4 * i + 1]), q(v[j][4 * i + 2]),
                                          q(v[j][4 * i + 3]))
                                  : 0u;
      }
      if (lane == 0) srow[r0 + j] = in ? s[j] : 0.0f;
    }
  }
}

// The epilogue on the wgmma fragment: dequant acc * (s_row * scale_col) +
// bias, [GELU2], [+ residual], per element in that order. row0 = this thread's first row
// in the tile (its second is row0 + 8); srow the panel's row scales (panel
// mode) or null (int8 mode: static, or from amax_in with one chunk). Its
// divisions are div_rn's (no call in a kernel that issues wgmma).
// Outputs pass through the warp's slab (16 rows of 128 bytes, 16-byte chunks
// swizzled by row so the fragment's writes spread over the banks) and leave
// as whole 128-byte row pieces, 16 bytes a lane: the fragment's own stores
// would be 2- to 8-byte pieces of 8 rows each, some 2048 transactions a
// tile. A residual comes in the same way. At 1, 2 or 4 bytes an output the
// slab holds 128, 64 or 32 columns: one, two or four passes.
template <int AMODE, int EPI, int EF>
__device__ __forceinline__ void epilogue(const GemmArgs& g, const int (&acc)[64], int m0, int n0,
                                         int z, const float* srow, unsigned char* slab, int row0,
                                         int lane) {
  constexpr bool gelu = (EF & kEfGelu) != 0, has_res = (EF & kEfRes) != 0;
  constexpr bool res32 = (EF & kEfResF32) != 0, out32 = (EF & kEfOutF32) != 0;
  constexpr bool keep_max = EPI == kEpiStore && (EF & kEfMax) != 0;
  constexpr bool kMidBf = (EF & kEfMidBf16) != 0, kSigC = (EF & kEfSigC) != 0;
  constexpr bool kFastSig = (EF & kEfFastSig) != 0, kRawBf = (EF & kEfRawBf16) != 0;
  constexpr bool kInt8Out = EPI == kEpiGeluInt8 || EPI == kEpiClip8 || EPI == kEpiWrap8 ||
                            EPI == kEpiShift8;
  constexpr int kOut = kInt8Out ? 1 : EPI == kEpiRaw ? (kRawBf ? 2 : 4) : (out32 ? 4 : 2);
  // a residual as wide as the output passes through the slab; K8's (bf16 x
  // with an f32 output, f32 x with a bf16 one) is read where it lies
  constexpr bool kResSlab = has_res && (res32 ? 4 : 2) == kOut;
  constexpr int kCols = 128 / kOut, kPasses = kBN / kCols;
  const int M = g.M, N = g.N, gq = lane >> 2, tq = lane & 3, wrow0 = row0 - gq;
  // (slab row, byte of the row): its 16-byte chunk swizzled by the row
  auto at = [&](int r, int byte) {
    return slab + r * 128 + ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15));
  };
  // the slab's rows to or from pass c's 128 bytes of the global rows (past M: none)
  auto rows = [&](const void* src, void* dst, int c) {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int r = 4 * it + (lane >> 3), seg = lane & 7, grow = m0 + wrow0 + r;
      if (grow >= M) continue;
      const size_t goff = (static_cast<size_t>(grow) * N + n0 + c * kCols) * kOut + 16 * seg;
      uint4* sp = reinterpret_cast<uint4*>(slab + r * 128 + ((seg ^ (r & 7)) << 4));
      if (dst == nullptr)
        *sp = *reinterpret_cast<const uint4*>(static_cast<const unsigned char*>(src) + goff);
      else
        *reinterpret_cast<uint4*>(static_cast<unsigned char*>(dst) + goff) = *sp;
    }
  };
  float srw[2] = {1.0f, 1.0f};
  if (!(EPI == kEpiRaw || EPI == kEpiWrap8 || EPI == kEpiShift8)) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int lr = row0 + 8 * hf, r = m0 + lr;
      srw[hf] = AMODE == kPanel
                    ? srow[lr]
                    : (g.is_static ? g.s_static : (r < M ? row_scale<true>(g.amax_in[r]) : 1.0f));
      if ((EF & kEfQBf16) != 0 && !g.is_static) srw[hf] = bf16r(srw[hf]);
    }
  }
  const float* __restrict__ scale = g.scale[z];
  const float* __restrict__ bias = g.bias[z];
  const int chunk = keep_max ? n0 / (N / g.nch) : 0;   // a 128-wide tile lies in one N chunk
  float rmax[2] = {0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < kPasses; ++c) {
    if (kResSlab) {
      rows(g.residual, nullptr, c);
      __syncwarp();
    }
#pragma unroll
    for (int jj = 0; jj < kCols / 8; ++jj) {
      const int j = c * (kCols / 8) + jj, n = n0 + 8 * j + 2 * tq, byte = (8 * jj + 2 * tq) * kOut;
      float sc0 = 0.0f, sc1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
      if (!(EPI == kEpiRaw || EPI == kEpiWrap8 || EPI == kEpiShift8)) {
        sc0 = scale[n];
        sc1 = scale[n + 1];
        b0 = bias[n];
        b1 = bias[n + 1];
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        unsigned char* p = at(gq + 8 * hf, byte);
        int q0 = acc[4 * j + 2 * hf], q1 = acc[4 * j + 2 * hf + 1];
        if (EPI == kEpiRaw) {   // T1: no scale, no bias; out32 converts each exact sum once
          if (kRawBf)
            *reinterpret_cast<__nv_bfloat162*>(p) =
                __floats2bfloat162_rn(static_cast<float>(q0), static_cast<float>(q1));
          else if (out32)
            *reinterpret_cast<float2*>(p) = make_float2(static_cast<float>(q0), static_cast<float>(q1));
          else
            *reinterpret_cast<int2*>(p) = make_int2(q0, q1);
          continue;
        }
        if (EPI == kEpiWrap8 || EPI == kEpiShift8) {   // T2 dots_only: the low bytes; no_deq_mid
          if (EPI == kEpiShift8) {                       // clip(sum >> 7, +-127)
            q0 = min(max(q0 >> 7, -127), 127);
            q1 = min(max(q1 >> 7, -127), 127);
          }
          *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>((q0 & 0xFF) | ((q1 & 0xFF) << 8));
          continue;
        }
        float y0, y1;
        if (kMidBf) {
          y0 = dequant_bf16(q0, srw[hf], sc0, b0);
          y1 = dequant_bf16(q1, srw[hf], sc1, b1);
        } else {
          y0 = dequant(q0, srw[hf], sc0, b0);
          y1 = dequant(q1, srw[hf], sc1, b1);
        }
        if (EPI == kEpiGeluInt8) {
          q0 = quantize<true>(gelu2<true>(y0), 0.0f, g.out_inv, true);
          q1 = quantize<true>(gelu2<true>(y1), 0.0f, g.out_inv, true);
          *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>((q0 & 0xFF) | ((q1 & 0xFF) << 8));
          continue;
        }
        if (EPI == kEpiClip8) {   // T2 no_quant_mid
          q0 = clip_cast_s8(gelu ? gelu2<true>(y0) : y0);
          q1 = clip_cast_s8(gelu ? gelu2<true>(y1) : y1);
          *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>((q0 & 0xFF) | ((q1 & 0xFF) << 8));
          continue;
        }
        if (gelu) {
          if (kMidBf) {
            y0 = gelu2_bf16<kSigC>(y0);
            y1 = gelu2_bf16<kSigC>(y1);
          } else if (kFastSig) {
            y0 = gelu_fast(y0);
            y1 = gelu_fast(y1);
          } else {
            y0 = gelu2<true>(y0);
            y1 = gelu2<true>(y1);
          }
        }
        if (has_res) {
          const int r = m0 + row0 + 8 * hf;
          const float2 rv = kResSlab ? load2(p, 0, res32)
                                     : (r < M ? load2(g.residual, static_cast<size_t>(r) * N + n, res32)
                                              : make_float2(0.0f, 0.0f));
          y0 = __fadd_rn(y0, rv.x);
          y1 = __fadd_rn(y1, rv.y);
        }
        if (keep_max) rmax[hf] = fmaxf(rmax[hf], fmaxf(fabsf(y0), fabsf(y1)));
        store2(p, 0, y0, y1, out32);
      }
    }
    __syncwarp();
    rows(nullptr, g.out[z], c);
    __syncwarp();
  }
  if (keep_max) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v = rmax[hf];
      v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
      v = fmaxf(v, __shfl_xor_sync(kFull, v, 2));
      if (kMidBf) v = fmaxf(v, g.amax_floor);
      const int r = m0 + row0 + 8 * hf;
      // |y| >= 0, so its bits order as ints do
      if (tq == 0 && r < M)
        atomicMax(reinterpret_cast<int*>(g.amax_out + static_cast<size_t>(r) * g.nch + chunk),
                  __float_as_int(v));
    }
  }
}

// K9's chunked fc2 (kEpiChunked) on the wgmma fragment, in its twin's order
// (ops/int8_block.py::mlp_chunked_reference): y starts at the residual
// (chunk_start); at each K chunk's last step y += float(acc_c) * (s_c *
// scale), s_c the static scale or max(amax_in[r, c], 1e-8) / 127
// (chunk_flush); then y + bias leaves through the warp's slab as epilogue's
// outputs do (epilogue_chunked). All inline: no call in a wgmma kernel.
template <int EF>
__device__ __forceinline__ void chunk_start(const GemmArgs& g, float (&y)[64], int m0, int n0,
                                            int row0, int tq) {
  constexpr bool res32 = (EF & kEfResF32) != 0;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = m0 + row0 + 8 * hf;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 rv = r < g.M ? load2(g.residual, static_cast<size_t>(r) * g.N + n0 + 8 * j + 2 * tq,
                                        res32)
                                : make_float2(0.0f, 0.0f);
      y[4 * j + 2 * hf] = rv.x;
      y[4 * j + 2 * hf + 1] = rv.y;
    }
  }
}

__device__ __forceinline__ void chunk_flush(const GemmArgs& g, const int (&acc)[64], float (&y)[64],
                                            int m0, int n0, int z, int c, int row0, int tq) {
  float s[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = m0 + row0 + 8 * hf;
    s[hf] = g.is_static ? g.s_static
                        : (r < g.M ? row_scale<true>(g.amax_in[static_cast<size_t>(r) * g.nch + c])
                                   : 1.0f);
  }
  const float* __restrict__ scale = g.scale[z];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + 8 * j + 2 * tq;
    const float sc[2] = {scale[n], scale[n + 1]};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = y[4 * j + 2 * hf + e];
        v = __fadd_rn(v, __fmul_rn(static_cast<float>(acc[4 * j + 2 * hf + e]),
                                   __fmul_rn(s[hf], sc[e])));
      }
  }
}

template <int EF>
__device__ __forceinline__ void epilogue_chunked(const GemmArgs& g, const float (&y)[64], int m0,
                                                 int n0, int z, unsigned char* slab, int row0,
                                                 int lane) {
  constexpr bool out32 = (EF & kEfOutF32) != 0;
  constexpr int kOut = out32 ? 4 : 2, kCols = 128 / kOut, kPasses = kBN / kCols;
  const int gq = lane >> 2, tq = lane & 3, wrow0 = row0 - gq;
  const float* __restrict__ bias = g.bias[z];
#pragma unroll
  for (int c = 0; c < kPasses; ++c) {
#pragma unroll
    for (int jj = 0; jj < kCols / 8; ++jj) {
      const int j = c * (kCols / 8) + jj, n = n0 + 8 * j + 2 * tq, byte = (8 * jj + 2 * tq) * kOut;
      const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = gq + 8 * hf;
        store2(slab + r * 128 + ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15)), 0,
               __fadd_rn(y[4 * j + 2 * hf], b0), __fadd_rn(y[4 * j + 2 * hf + 1], b1), out32);
      }
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 4; ++it) {   // the slab's 16 rows to pass c's 128 bytes of each
      const int r = 4 * it + (lane >> 3), seg = lane & 7, grow = m0 + wrow0 + r;
      if (grow >= g.M) continue;
      const size_t goff = (static_cast<size_t>(grow) * g.N + n0 + c * kCols) * kOut + 16 * seg;
      *reinterpret_cast<uint4*>(static_cast<unsigned char*>(g.out[z]) + goff) =
          *reinterpret_cast<const uint4*>(slab + r * 128 + ((seg ^ (r & 7)) << 4));
    }
    __syncwarp();
  }
}

// This block's work, in order, as f(tile, first k step, end k step). Panel
// mode: a contiguous run of its row block's tiles, whole. Int8 mode
// (stream-K): its equal share of the (tile, k step) units; WHOLE (the chunked
// epilogue): tiles blockIdx.x, + gridDim.x, ..., whole.
template <int AMODE, bool WHOLE, class F>
__device__ __forceinline__ void for_each_segment(const Params& p, F&& f) {
  const int per_row = p.n_w * p.ntn;
  if (WHOLE) {
    for (int t = blockIdx.x; t < p.row_blocks * per_row; t += gridDim.x) f(t, 0, p.steps);
  } else if (AMODE == kPanel) {
    const int rb = blockIdx.x / p.bpr, part = blockIdx.x % p.bpr;
    const int t1 = (part + 1) * per_row / p.bpr;
    for (int t = part * per_row / p.bpr; t < t1; ++t) f(rb * per_row + t, 0, p.steps);
  } else {   // 32-bit: the launcher holds units * gridDim.x below 2^32
    const unsigned units = static_cast<unsigned>(p.row_blocks * per_row * p.steps);
    unsigned u = blockIdx.x * units / gridDim.x;
    const unsigned end = (blockIdx.x + 1) * units / gridDim.x;
    while (u < end) {
      const int t = static_cast<int>(u / p.steps), k0 = static_cast<int>(u % p.steps);
      const int k1 = min(p.steps, k0 + static_cast<int>(end - u));
      f(t, k0, k1);
      u += k1 - k0;
    }
  }
}

// Stream-K: settle a tile this block computed only steps [k0, k1) of. Stores
// the partial sums to this block's slot, counts the steps; returns true in the
// block that completes the tile, with every contributor's sums added to acc.
__device__ __forceinline__ bool finish_split(const Params& p, int (&acc)[64], int t, int k0, int k1,
                                             int* flag, int ctid) {
  const unsigned units = static_cast<unsigned>(p.row_blocks * p.n_w * p.ntn * p.steps);
  const unsigned G = gridDim.x, tS = static_cast<unsigned>(t * p.steps);
  auto start = [&](unsigned b) { return b * units / G; };
  auto block_of = [&](unsigned u) { return static_cast<int>(((u + 1) * G - 1) / units); };
  const int bf = block_of(tS), bl = block_of(tS + p.steps - 1);
  // a block's segment of t is its last (slot 1) only where t began in an earlier block's range
  auto slot = [&](int c) {
    return reinterpret_cast<int4*>(p.ws + (2 * static_cast<size_t>(c) + (c == bf && start(c) < tS)) * kSlot);
  };
  int4* mine = slot(blockIdx.x);
#pragma unroll
  for (int v = 0; v < 16; ++v)
    mine[v * 256 + ctid] = make_int4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]);
  __threadfence();
  consumer_sync();
  if (ctid == 0) {
    const int add = k1 - k0, old = atomicAdd(p.cnt + bf, add);
    *flag = old + add == p.steps;
    if (*flag) atomicExch(p.cnt + bf, 0);
  }
  consumer_sync();
  if (!*flag) return false;
  __threadfence();
  for (int c = bf; c <= bl; ++c) {
    if (c == static_cast<int>(blockIdx.x)) continue;
    const int4* other = slot(c);
#pragma unroll
    for (int v = 0; v < 16; ++v) {
      const int4 w = __ldcg(other + v * 256 + ctid);
      acc[4 * v] += w.x;
      acc[4 * v + 1] += w.y;
      acc[4 * v + 2] += w.z;
      acc[4 * v + 3] += w.w;
    }
  }
  return true;
}

template <int AMODE, int NORM, bool W4, int EPI, int EF>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(const __grid_constant__ Params p) {
  using R = Ring<AMODE, W4>;
  constexpr int S = R::kStages, SU = R::kUStages;
  constexpr int SUd = SU ? SU : 1;   // W8 has no unpacked ring: a divisor that compiles
  constexpr bool kWhole = EPI == kEpiChunked;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = smem_u32(sm);
  const GemmArgs& g = p.g;
  const int panel_bytes = AMODE == kPanel ? g.K * 128 : 0;
  const uint32_t ring = base + panel_bytes;
  unsigned char* slabs = sm + panel_bytes + R::kRing;
  float* srow = reinterpret_cast<float*>(slabs + kConsumerWarps * kSlab);
  const uint32_t bars = smem_u32(srow + kBM);
  int* flag = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(srow) + kBM * 4 + 8 * 2 * (S + SU));
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  auto ufull = [&](int u) { return bars + 8 * (2 * S + u); };
  auto uempty = [&](int u) { return bars + 8 * (2 * S + SU + u); };
  auto stage_a = [&](int s) { return ring + s * (R::kA + R::kB); };
  auto stage_b = [&](int s) { return ring + s * (R::kA + R::kB) + R::kA; };
  auto unpacked = [&](int u) { return ring + S * (R::kA + R::kB) + u * R::kU; };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    for (int u = 0; u < SU; ++u) {
      mbar_init(ufull(u), kUnpackThreads);
      mbar_init(uempty(u), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  auto tile_of = [&](int t, int& m0, int& n0, int& z) {
    const int per_row = p.n_w * p.ntn, rem = t % per_row;
    m0 = t / per_row * kBM;
    z = rem / p.ntn;
    n0 = rem % p.ntn * kBN;
  };

  if (threadIdx.x >= kConsumerWarps * 32) {
    // ---- producer warpgroup: one TMA thread; for W4, three unpacking warps
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int pw = (threadIdx.x >> 5) - kConsumerWarps;
    if (pw == 0) {
      if (lane != 0) return;
      int it = 0;
      for_each_segment<AMODE, kWhole>(p, [&](int t, int k0, int k1) {
        int m0, n0, z;
        tile_of(t, m0, n0, z);
        for (int k = k0; k < k1; ++k, ++it) {
          const int s = it % S;
          mbar_wait(empty(s), ((it / S) & 1) ^ 1);
          mbar_expect_tx(full(s), R::kTx);
          tma_load(stage_b(s), &p.tb[z], W4 ? 64 * k : 128 * k, n0, full(s));
          if (AMODE == kInt8) {
            if (W4) {
              tma_load(stage_a(s), &p.ta, 64 * k, m0, full(s));
              tma_load(stage_a(s) + kBM * 64, &p.ta, g.K / 2 + 64 * k, m0, full(s));
            } else {
              tma_load(stage_a(s), &p.ta, 128 * k, m0, full(s));
            }
          }
        }
      });
    } else if (W4) {
      const int ut = threadIdx.x - (kConsumerWarps + 1) * 32;
      int it = 0;
      for_each_segment<AMODE, kWhole>(p, [&](int, int k0, int k1) {
        for (int k = k0; k < k1; ++k, ++it) {
          const int s = it % S, u = it % SUd;
          mbar_wait(full(s), (it / S) & 1);
          mbar_wait(uempty(u), ((it / SUd) & 1) ^ 1);
          const uint4* src = reinterpret_cast<const uint4*>(sm + (stage_b(s) - base));
          uint4* lo = reinterpret_cast<uint4*>(sm + (unpacked(u) - base));
          uint4* hi = lo + kBN * 64 / 16;
          for (int c = ut; c < kBN * 64 / 16; c += kUnpackThreads) {
            const uint4 w = src[c];
            uint4 l, h;
            unpack_w4(w.x, l.x, h.x);
            unpack_w4(w.y, l.y, h.y);
            unpack_w4(w.z, l.z, h.z);
            unpack_w4(w.w, l.w, h.w);
            lo[c] = l;
            hi[c] = h;
          }
          fence_async_smem();
          mbar_arrive(ufull(u));
        }
      });
    }
    return;
  }

  // ---- consumer warpgroups: rows 64 wg .. 64 wg + 63 of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int ctid = threadIdx.x, wg = ctid >> 7, cw = ctid >> 5;
  const int row0 = wg * 64 + (cw & 3) * 16 + (lane >> 2);
  const int K = g.K;
  int it = 0, built = -1;
  for_each_segment<AMODE, kWhole>(p, [&](int t, int k0, int k1) {
    int m0, n0, z;
    tile_of(t, m0, n0, z);
    if (AMODE == kPanel && m0 != built) {
      consumer_sync();   // the last tile's products are done with the old panel
      build_panel_swz<NORM, EPI == kEpiClip8 || EPI == kEpiShift8>(
          g, false, sm, srow, m0, cw, lane, blockIdx.x % p.bpr == 0);
      fence_async_smem();
      consumer_sync();
      built = m0;
    }
    int acc[64];
    float y[64];   // kWhole: the chunked epilogue's f32 accumulator
    const int cs = kWhole ? p.steps / g.nch : 1;   // k steps a chunk
    if (kWhole) chunk_start<EF>(g, y, m0, n0, row0, lane & 3);
    for (int k = k0; k < k1; ++k, ++it) {
      const int s = it % S, u = it % SUd;
      mbar_wait(full(s), (it / S) & 1);
      if (W4) mbar_wait(ufull(u), (it / SUd) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // a chunk's first step restarts the integer sums
        const int first = (kWhole ? k % cs == 0 : k == k0) && kk == 0 ? 0 : 1;
        if (!W4) {
          const uint32_t a = AMODE == kPanel ? base + k * kPanelBlock + wg * 64 * 128
                                             : stage_a(s) + wg * 64 * 128;
          wgmma_n128(acc, desc(a + 32 * kk, 1), desc(stage_b(s) + 32 * kk, 1), first);
        } else {
          // kk 0, 1: k = 64 k + 32 kk; kk 2, 3: the same + K/2
          const int hi = kk >> 1, off = 32 * (kk & 1);
          uint64_t da;
          if (AMODE == kPanel) {
            const int kpos = hi * (K / 2) + 64 * k + off;
            da = desc(base + (kpos >> 7) * kPanelBlock + wg * 64 * 128 + (kpos & 127), 1);
          } else {
            da = desc(stage_a(s) + hi * kBM * 64 + wg * 64 * 64 + off, 2);
          }
          wgmma_n128(acc, da, desc(unpacked(u) + hi * kBN * 64 + off, 2), first);
        }
      }
      wgmma_commit();
      // free the stage as soon as its products are done: the loads, not the
      // tensor cores, set the pace, and this keeps one more stage in flight
      // than freeing it a step later (the other warpgroup's products fill
      // the wait)
      wgmma_wait<0>();
      if (lane == 0) {
        mbar_arrive(empty(s));
        if (W4) mbar_arrive(uempty(u));
      }
      if (kWhole && (k + 1) % cs == 0) {   // a chunk's last step: flush it
        fence_acc(acc);
        chunk_flush(g, acc, y, m0, n0, z, k / cs, row0, lane & 3);
      }
    }
    if (kWhole) {
      epilogue_chunked<EF>(g, y, m0, n0, z, slabs + cw * kSlab, row0, lane);
      return;
    }
    fence_acc(acc);
    if (AMODE == kInt8 && (k0 != 0 || k1 != p.steps) && !finish_split(p, acc, t, k0, k1, flag, ctid))
      return;
    epilogue<AMODE, EPI, EF>(g, acc, m0, n0, z, srow, slabs + cw * kSlab, row0, lane);
  });
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, or null
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// (rows, cols) int8, row-major, in boxes of 128 rows x box bytes (128 or 64)
// with the swizzle of the same width; reads past the edges fill with zeros
bool encode(CUtensorMap* map, const void* ptr, int rows, int cols, int box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t boxd[2] = {static_cast<cuuint32_t>(box), 128};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, boxd, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            box == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ints of the stream-K workspace: two slots and a counter per SM
size_t workspace_ints() { return static_cast<size_t>(num_sms()) * (2 * kSlot + 1); }

// One launch on this mainloop (g as t2s_int8_dense fills it; ws the stream-K
// workspace, zeroed once, which the int8 mode needs). Returns the CUDA error
// code: cudaErrorInvalidValue where the shape is not this mainloop's, or a
// tensor map does not encode.
template <int AMODE, int NORM, bool W4, int EPI, int EF>
int launch(const GemmArgs& g, int n_w, int* ws, cudaStream_t stream) {
  using R = Ring<AMODE, W4>;
  static_assert(AMODE == kPanel || AMODE == kInt8, "a panel or an int8 A");
  static_assert(EPI != kEpiChunked || (AMODE == kInt8 && !W4), "the chunked epilogue: int8 A, W8");
  constexpr bool kWhole = EPI == kEpiChunked;
  // the chunked epilogue's chunks are whole k steps; any other int8 launch has one chunk
  if (AMODE == kInt8 && (ws == nullptr || (kWhole ? g.K % (128 * g.nch) != 0 : g.nch != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  memset(&p, 0, sizeof(p));
  p.g = g;
  p.n_w = n_w;
  p.ntn = g.N / kBN;
  p.row_blocks = (g.M + kBM - 1) / kBM;
  p.steps = (g.K + 127) / 128;
  const int Kb = W4 ? g.K / 2 : g.K, box = W4 ? 64 : 128;
  for (int z = 0; z < n_w; ++z)
    if (!encode(&p.tb[z], g.w[z], g.N, Kb, box)) return static_cast<int>(cudaErrorInvalidValue);
  if (AMODE == kInt8 && !encode(&p.ta, g.a, g.M, g.K, box)) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = num_sms(), per_row = n_w * p.ntn;
  long long grid;
  if (AMODE == kPanel) {
    p.bpr = sms / p.row_blocks < 1 ? 1 : (sms / p.row_blocks < per_row ? sms / p.row_blocks : per_row);
    grid = static_cast<long long>(p.row_blocks) * p.bpr;
  } else if (kWhole) {   // data-parallel: whole tiles, no split, so no workspace
    const long long tiles = static_cast<long long>(p.row_blocks) * per_row;
    grid = tiles < sms ? tiles : sms;
  } else {
    p.ws = ws;
    p.cnt = ws + static_cast<size_t>(sms) * 2 * kSlot;
    const long long units = static_cast<long long>(p.row_blocks) * per_row * p.steps;
    grid = units < sms ? units : sms;
    if (units * grid >= (1ll << 32)) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = (AMODE == kPanel ? g.K * 128 : 0) + R::kTail + 1024;
  static bool attr_set = false;
  if (!attr_set) {
    const int most = (AMODE == kPanel ? kMaxPanelK * 128 : 0) + R::kTail + 1024;
    const cudaError_t e = cudaFuncSetAttribute(gemm_kernel<AMODE, NORM, W4, EPI, EF>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  if (EPI == kEpiStore && (EF & kEfMax)) {
    const cudaError_t e = cudaMemsetAsync(g.amax_out, 0, sizeof(float) * g.M * g.nch, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gemm_kernel<AMODE, NORM, W4, EPI, EF><<<static_cast<int>(grid), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace
