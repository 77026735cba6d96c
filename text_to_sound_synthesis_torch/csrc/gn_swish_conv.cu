// K11: GroupNorm -> swish -> 3x3 conv (stride 1, zero pad 1), NHWC / HWIO,
// for Hopper, sm_90a.
//
// Replaces text_to_sound_synthesis_tpu/ops/fused_gn_conv.py::gn_swish_conv
// (its Pallas TPU kernel _conv_call / _kernel). The plain PyTorch twin is
// text_to_sound_synthesis_torch/ops/fused_gn_conv.py::gn_swish_conv_reference;
// the wrapper there (a torch.autograd.Function whose backward is the twin's
// VJP, as the TPU kernel's custom VJP is the XLA composition's) launches this.
//
// What it computes, in the twin's order: per (batch, group) the mean and
// mean square of x in f32, var = E[x^2] - E[x]^2 (fast variance), rstd =
// 1 / sqrt(var + 1e-6); scale = rstd * gamma, shift = beta - mean * scale per
// (batch, channel); a = x * scale + shift, a = a * sigmoid(a) in f32, rounded
// to bf16; y = conv3x3(a zero-padded, w bf16) summed in f32, + bias, one cast
// to bf16. Taps outside the image contribute 0 (the pad of the activated
// tensor), not swish(shift).
//
// What bounds it on an H100. At the largest decoder stage, (8, 80, 848, 128),
// the products are 1.6e11 bf16 FLOP = 162 us at 989 TFLOP/s, against 278 MB
// of bytes (x read, y written) = 83 us at 3.35 TB/s: operation-bound at every
// stage. Beside the products, every activation (an exp, a reciprocal and some
// ten f32 operations) runs on the CUDA cores. Two launches:
//   - statistics: blocks of (pixel chunk, image) read x once and write
//     per-(image, chunk, group) partial sums of x and x^2; the last of an
//     image's blocks to finish (an integer ticket an image, no float atomics)
//     sums them in a fixed order and writes the image's scale and shift per
//     channel, then resets the ticket. The wrapper picks the chunks
//     (ops/fused_gn_conv.py::stat_chunks);
//   - the conv, an implicit GEMM on bf16 wgmma: M = output pixels, N = Co,
//     K = 9 C, f32 sums in registers. A persistent grid of at most one block
//     per SM walks output tiles of BM = 128 or 256 pixels x 128 channels.
// The pixel tiles. The image is cut into column strips of Tw = pitch - 2
// columns; a strip's pixels are numbered q = r * pitch + c over the virtual
// rows r of all images stacked with one zero row between them (row h == H of
// each image), so a tile is BM consecutive q: the columns c >= Tw and the pad
// rows are junk outputs, not stored. The input that tap (dy, dx) of output q
// reads is entry q - q0 + dy * pitch + dx of the tile's halo window, the
// BM + 2 pitch + 2 input pixels from q0 - pitch on. The wrapper picks pitch
// and BM per shape (ops/fused_gn_conv.py::conv_plan) against the junk, the
// waves of tiles over the SMs and the activations a tile's window costs.
// The A operand. The halo window is held in shared memory in wgmma's
// no-swizzle K-major layout with the 8-row stride (SBO) set to 128 bytes: for
// each 8-channel slice all pixels lie 16 bytes apart, so any run of 64 pixels
// from any pixel on is a valid A tile, and a tap's shift is a descriptor
// start address offset of 16 (dy pitch + dx) bytes: one activated copy
// serves all nine taps. The slices lie LBO = 16 NEP bytes apart, NEP = 4 mod
// 8 entries, so 16-byte stores of 4 pixels x 8 slices fill both bank halves.
// A block warp-specialised over units (tile, 64-channel chunk), in one order:
//   - warpgroups 0 and 1 (MMA): rows 64 MI wg .. of the tile, MI m64 tiles
//     each (BM = 128 MI); per tap of a chunk, 4 x MI wgmma.m64n128k16 (A: the
//     halo window at the tap's offset, B: the tap's weight tile), one group
//     in flight, the previous tap's weight stage freed; after the ninth tap
//     the halo buffer is freed; after the last chunk, + bias, bf16 out;
//   - the transform warps (7 at MI 2, a block of 512 threads; 11 at MI 1,
//     640: ptxas gives each thread 64K / threads registers, and the MMA warps
//     hold 64 MI f32 sums): a ring of three halo buffers; a unit's x lands by
//     cp.async (16-byte pieces, 8 channels of a pixel) in its buffer while
//     the previous unit's is normalised, swished and rounded in place
//     (gn_swish8, two pieces at once), zeros outside the image and past C;
//     a tile's window pixels are tabled once for all its chunks;
//   - the last warp (producer): the weight as HWIO stores it, (3, 3, C, Co)
//     bf16, streams as (tap, 64 channels, 128 outputs) tiles through a
//     4-stage ring by TMA, 128-byte swizzle, mbarriers, and is read MN-major
//     through wgmma's transpose bit (no relayout); channels past C are
//     filled with zeros by the tensor map.
// Measured on the H100 (PERF.md): the transform sets the pace; alone it takes
// about as long as the products alone, and the two overlap only in part.
// A tile is computed by one block, in one fixed order (chunks, taps, k
// slices): the output does not depend on the plan or the grid, and does not
// change from run to run.
// Limits (checked here and by the wrapper): C a multiple of 32 and at most
// 2048, Co a multiple of 128, groups dividing C, H and B at most 65535.
// Every multiply and add that the twin does as a separate tensor op is an _rn
// intrinsic (no FMA contraction). No --use_fast_math.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "mha_sm90.cuh"

namespace {

// D (64 x 128, f32) += A (64 x 16, bf16, K-major) . B (16 x 128, bf16,
// MN-major: the weight as HWIO stores it, through the transpose bit), both in
// shared memory; the fragment as mha90::wgmma_ss's
namespace gnc {
__device__ __forceinline__ void wgmma_ss_tb128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}


using mha90::fence_f;
using t2s_int8::cp_async16;
using t2s_int8::cp_async_commit;
using t2s_int8::cp_async_wait;
using mha90::tma_load3;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

constexpr float kEps = 1e-6f;
constexpr int kMaxC = 2048;            // the statistics block holds 8 channels a thread
constexpr int kStatThreads = 256;
constexpr int kStatLoads = 8;         // 16-byte loads in flight a statistics thread

// the conv
constexpr int kMmaThreads = 256;       // 2 MMA warpgroups
// The block of MI m64 tiles a warpgroup: 2 MMA warpgroups, the transform
// warps, 1 producer warp. ptxas gives every thread of a block 64K / threads
// registers: at MI 2 (128 f32 sums a thread) 512 threads, 7 transform warps;
// at MI 1 (64 sums) 640 threads, 11 transform warps. setmaxnreg moves the
// registers the transform warps leave to the MMA warps (balanced).
template <int MI>
struct Block {
  static constexpr int kXfWarps = MI == 2 ? 7 : 11;
  static constexpr int kThreads = kMmaThreads + 32 * (kXfWarps + 1);
  static constexpr int kXfThreads = 32 * kXfWarps;
  static constexpr int kXfLanes = kXfThreads / 8;   // entries a pass: 8 slices each
};
constexpr int kBN = 128;               // output channels per tile
constexpr int kKC = 64;                // input channels per chunk: 8 slices of 16 bytes
constexpr int kHalos = 3;              // halo buffers: filled, activated, read by the products
constexpr int kWStages = 4;
constexpr int kWTile = kBN * kKC * 2;  // one (tap, chunk) weight tile, 16 KB: two
constexpr int kWHalf = kWTile / 2;     // 64-output halves of 64 channels x 128 bytes
constexpr int kRing = kWStages * kWTile;
constexpr int kSmemMax = 232448;       // the H100's dynamic shared memory per block
constexpr int kBars = 8 * (2 * kWStages + 2 * kHalos);
// halo entries a buffer may hold: kHalos buffers of 8 slices of 16 bytes
// each, and two tiles' window tables of 8 bytes an entry
constexpr int kMaxEntries = ((kSmemMax - 1024 - kRing - kBars) / (128 * kHalos + 16) - 4) / 8 * 8 + 4;

// entries of a halo buffer for `need` entries: 4 mod 8 (see the header)
__host__ __device__ constexpr int padded_entries(int need) { return (need + 3) / 8 * 8 + 4; }

// ---------------------------------------------------------------------------
// statistics and finalize

struct StatArgs {
  const __nv_bfloat16* x;   // (B, HW, C)
  const float* gamma;
  const float* beta;
  float* partial;           // (B, nchunk, 2, G)
  float* scale;             // (B, C)
  float* shift;             // (B, C)
  unsigned* tickets;        // (B,), zero between launches
  int HW, C, G, nchunk, chunk_pix;
};

// grid (nchunk, B): block (chunk, b) sums pixels [chunk * chunk_pix, ...) of
// image b; the last of image b's blocks to finish writes its scale and shift
__global__ void __launch_bounds__(kStatThreads) gn_stats_kernel(const StatArgs a) {
  __shared__ float red[2 * kStatThreads * 8];   // [moment][lane * C + channel]; then the finalize's sums
  __shared__ float stat[2][kMaxC];             // the finalize's mean and rstd per group
  __shared__ bool last;
  const int b = blockIdx.y, chunk = blockIdx.x, C = a.C, G = a.G;
  const int tpp = C / 8, lanes = kStatThreads / tpp;   // threads per pixel, pixel lanes
  const int t = threadIdx.x, cv = t % tpp, lane = t / tpp;
  const int p0 = chunk * a.chunk_pix, p1 = min(p0 + a.chunk_pix, a.HW);
  float* red_s = red;
  float* red_q = red + kStatThreads * 8;
  if (lane < lanes) {
    float s[8], q[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] = q[e] = 0.0f;
    const __nv_bfloat16* xb = a.x + static_cast<size_t>(b) * a.HW * C + cv * 8;
    for (int p = p0 + lane; p < p1; p += kStatLoads * lanes) {
      uint4 v[kStatLoads];
#pragma unroll
      for (int k = 0; k < kStatLoads; ++k) {
        const int pk = p + k * lanes;
        v[k] = pk < p1 ? __ldg(reinterpret_cast<const uint4*>(xb + static_cast<size_t>(pk) * C))
                       : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < kStatLoads; ++k) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[k]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          s[2 * e] += f.x;
          s[2 * e + 1] += f.y;
          q[2 * e] += f.x * f.x;
          q[2 * e + 1] += f.y * f.y;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red_s[lane * C + cv * 8 + e] = s[e];
      red_q[lane * C + cv * 8 + e] = q[e];
    }
  }
  __syncthreads();
  const int gs = C / G;
  float* part = a.partial + static_cast<size_t>(b) * a.nchunk * 2 * G;
  for (int i = t; i < 2 * G; i += kStatThreads) {
    const float* r = i < G ? red_s : red_q;
    const int g = i < G ? i : i - G;
    float acc = 0.0f;
    for (int c = g * gs; c < (g + 1) * gs; ++c)
      for (int l = 0; l < lanes; ++l) acc += r[l * C + c];
    part[static_cast<size_t>(chunk) * 2 * G + i] = acc;
  }
  // the last block of image b: all its partial sums are written
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(a.tickets + b, 1u) == static_cast<unsigned>(a.nchunk - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the 2 G sums over chunks: J threads a sum, thread j over chunks j, j + J,
  // ..., in order; then the J partial sums in order (the same on every run)
  const int J = 2 * G < kStatThreads ? kStatThreads / (2 * G) : 1;
  for (int i = t; i < 2 * G * J; i += kStatThreads) {
    const int m = i / J, j = i - m * J;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = j; k < a.nchunk; k += J) acc += __ldcg(part + static_cast<size_t>(k) * 2 * G + m);
    red[i] = acc;
  }
  __syncthreads();
  const float n = static_cast<float>(a.HW) * gs;
  for (int g = t; g < G; g += kStatThreads) {
    float s = 0.0f, q = 0.0f;
    for (int j = 0; j < J; ++j) {
      s += red[g * J + j];
      q += red[(G + g) * J + j];
    }
    const float mean = __fdiv_rn(s, n);
    const float var = __fsub_rn(__fdiv_rn(q, n), __fmul_rn(mean, mean));
    stat[0][g] = mean;
    stat[1][g] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, kEps)));
  }
  __syncthreads();
  // scale and shift per channel, as the twin's gn_affine
  for (int c = t; c < C; c += kStatThreads) {
    const float sc = __fmul_rn(stat[1][c / gs], a.gamma[c]);
    a.scale[static_cast<size_t>(b) * C + c] = sc;
    a.shift[static_cast<size_t>(b) * C + c] = __fsub_rn(a.beta[c], __fmul_rn(stat[0][c / gs], sc));
  }
  if (t == 0) a.tickets[b] = 0u;
}

// ---------------------------------------------------------------------------
// the conv

struct ConvArgs {
  CUtensorMap wmap;         // (C, 9, Co) bf16 in boxes of (64, 1, 128), 128-byte swizzle
  const __nv_bfloat16* x;   // (B, H, W, C)
  const float* scale;       // (B, C)
  const float* shift;       // (B, C)
  const float* bias;        // (Co,)
  __nv_bfloat16* y;         // (B, H, W, Co)
  int B, H, W, C, Co;
  int pitch, tw;            // a strip's pixel pitch and columns, tw = pitch - 2
  int mt, nt, tiles;        // pixel tiles a strip, 128-wide output tiles, all tiles
  int nchunks;              // 64-channel chunks of C
  int ne, nep;              // halo entries a tile, entries a buffer holds (4 mod 8)
};

// wgmma descriptor of a K-major tile in the no-swizzle layout: rows 16 bytes
// apart (8-row stride 128 bytes), the two 8-channel halves of a k16 slice lbo
// bytes apart
__device__ __forceinline__ uint64_t desc_rows(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// wgmma descriptor of a (tap, chunk) weight tile, MN-major with the 128-byte
// swizzle: two 64-output halves (LBO 8 KB apart), each 64 channel rows of
// 128 bytes (8-row groups, SBO, 1024 bytes apart); k16 step kk starts 16 rows on
__device__ __forceinline__ uint64_t desc_wt(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(kWHalf >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// The eight activations of each of N 16-byte pieces of x (8 channels of a
// pixel; the pieces of one image, their chains interleaved), to bf16: a = x *
// scale + shift, a * sigmoid(a) = a * (1 / (1 + exp(-a))) in f32, rounded.
// With y = rcp_refined(d) within an ulp of 1 / d, a * y lies within 4 f32
// ulps of a * rn(1 / d) (a subnormal product within one step), so the two
// round to the same bf16 unless a * y's low 16 bits lie within 16 of 0x8000,
// a bf16 rounding midpoint. There (one value in 2000), where 1 / d is
// subnormal and the SFU flushes it (a < -80 is kept out), or at a NaN, bit n
// of `exact` is set and the caller redoes piece n with EXACT (div_rn: no
// call, which would make ptxas serialize the kernel's wgmma), out of its
// loop, so that the loop's code stays small.
template <bool EXACT, int N>
__device__ __forceinline__ void gn_swish8(uint4 (&v)[N], const float (&sc)[8], const float (&sh)[8],
                                          unsigned& exact) {
  float a[N][8], t[N][8];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&v[n]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(hv[j]);
      a[n][2 * j] = __fadd_rn(__fmul_rn(f.x, sc[2 * j]), sh[2 * j]);
      a[n][2 * j + 1] = __fadd_rn(__fmul_rn(f.y, sc[2 * j + 1]), sh[2 * j + 1]);
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float d = __fadd_rn(1.0f, expf(-a[n][e]));
      if (EXACT) {
        t[n][e] = __fmul_rn(a[n][e], t2s_int8::div_rn(1.0f, d));
      } else {
        t[n][e] = __fmul_rn(a[n][e], t2s_int8::rcp_refined(d));
        exact |= static_cast<unsigned>(((__float_as_uint(t[n][e]) & 0xFFFFu) - 0x7FF0u <= 32u) |
                                       !(a[n][e] >= -80.0f)) << n;
      }
    }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&v[n]);
#pragma unroll
    for (int j = 0; j < 4; ++j) hv[j] = __floats2bfloat162_rn(t[n][2 * j], t[n][2 * j + 1]);
  }
}

// The input pixel of entry e of the halo window of the tile at q0 (in its
// strip from column col0): x's pixel index (b H + h) W + w, or kNoPixel for
// the zero ring (rows before the first image, the zero row after each image,
// columns outside the image, rows past the last image); and the image (for
// its scale and shift), 0 .. B - 1. A pixel index fits 32 bits for any x
// that fits a card: B H W >= 2^32 pixels of at least 32 channels is 256 GB.
constexpr unsigned kNoPixel = 0xFFFFFFFFu;
__device__ __forceinline__ uint2 window_pixel(const ConvArgs& g, long long q0, int col0, int e) {
  const long long pos = q0 - g.pitch + e;   // >= -pitch
  const long long row = pos < 0 ? -1 : pos / g.pitch;
  const int w = col0 + static_cast<int>(pos - row * g.pitch) - 1;
  const long long b = row < 0 ? 0 : row / (g.H + 1);
  const int h = static_cast<int>(row - b * (g.H + 1));
  const bool inside = row >= 0 && b < g.B && h < g.H && w >= 0 && w < g.W;
  return make_uint2(inside ? static_cast<unsigned>((b * g.H + h) * g.W + w) : kNoPixel,
                    static_cast<unsigned>(b < g.B ? b : g.B - 1));
}

// the transform warps only (the MMA and producer warps never join)
template <int N>
__device__ __forceinline__ void xf_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// scale and shift of image b at channels ch .. ch + 7
__device__ __forceinline__ void load_affine(const ConvArgs& g, int b, int ch, float (&sc)[8],
                                            float (&sh)[8]) {
  if (ch >= g.C) return;
  const float4* s4 = reinterpret_cast<const float4*>(g.scale + static_cast<size_t>(b) * g.C + ch);
  const float4* h4 = reinterpret_cast<const float4*>(g.shift + static_cast<size_t>(b) * g.C + ch);
  const float4 s0 = __ldg(s4), s1 = __ldg(s4 + 1), h0 = __ldg(h4), h1 = __ldg(h4 + 1);
  sc[0] = s0.x, sc[1] = s0.y, sc[2] = s0.z, sc[3] = s0.w;
  sc[4] = s1.x, sc[5] = s1.y, sc[6] = s1.z, sc[7] = s1.w;
  sh[0] = h0.x, sh[1] = h0.y, sh[2] = h0.z, sh[3] = h0.w;
  sh[4] = h1.x, sh[5] = h1.y, sh[6] = h1.z, sh[7] = h1.w;
}

// tile t: output tile (fastest), then pixel tile, then strip: its first
// output channel n0, its first pixel q0 in the strip, the strip's first column
template <int BM>
__device__ __forceinline__ void tile_of(const ConvArgs& g, int t, int& n0, long long& q0, int& col0) {
  const int r = t / g.nt;
  n0 = (t - r * g.nt) * kBN;
  const int strip = r / g.mt;
  q0 = static_cast<long long>(r - strip * g.mt) * BM;
  col0 = strip * g.tw;
}

template <int MI>
__global__ void __launch_bounds__(Block<MI>::kThreads, 1) gn_conv_kernel(const __grid_constant__ ConvArgs g) {
  constexpr int kThreads = Block<MI>::kThreads, kXfThreads = Block<MI>::kXfThreads;
  constexpr int kXfLanes = Block<MI>::kXfLanes;
  constexpr int BM = 128 * MI;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: the weight tiles start on that grid
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t ring = smem_u32(sm);
  const uint32_t lbo = 16u * g.nep;          // bytes between 8-channel slices
  const uint32_t hbytes = 8u * lbo;          // one halo buffer
  unsigned char* halo = sm + kRing;
  const uint32_t halo_u = ring + kRing;
  const uint32_t bars = halo_u + kHalos * hbytes;
  // two tiles' window tables, after the barriers
  uint2* ptab = reinterpret_cast<uint2*>(sm + kRing + kHalos * hbytes + kBars);
  auto wfull = [&](int s) { return bars + 8 * s; };
  auto wempty = [&](int s) { return bars + 8 * (kWStages + s); };
  auto hfull = [&](int b) { return bars + 8 * (2 * kWStages + b); };
  auto hempty = [&](int b) { return bars + 8 * (2 * kWStages + kHalos + b); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(wfull(s), 1);
      mbar_init(wempty(s), kMmaThreads / 32);
    }
    for (int b = 0; b < kHalos; ++b) {
      mbar_init(hfull(b), kXfThreads);
      mbar_init(hempty(b), kMmaThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x >= kMmaThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 80;\n");   // MI 2: 128 -> 80; MI 1: 96 -> 80
    if (warp == kThreads / 32 - 1) {
      // ---- producer: the weight tiles of every (tile, chunk, tap), in order
      if (lane != 0) return;
      int it = 0;
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        int n0, col0;
        long long q0;
        tile_of<BM>(g, t, n0, q0, col0);
        for (int c = 0; c < g.nchunks; ++c)
          for (int tap = 0; tap < 9; ++tap, ++it) {
            const int s = it % kWStages;
            mbar_wait(wempty(s), ((it / kWStages) & 1) ^ 1);
            mbar_expect_tx(wfull(s), kWTile);
            tma_load3(ring + s * kWTile, &g.wmap, n0, c * kKC, tap, wfull(s));
            tma_load3(ring + s * kWTile + kWHalf, &g.wmap, n0 + 64, c * kKC, tap, wfull(s));
          }
      }
      return;
    }
    // ---- transform: thread (entry lane ln, slice sl) owns entries ln, ln +
    // 28, ... of each window. A unit's raw x lands by cp.async in its halo
    // buffer while the thread activates the previous unit's in place. Each
    // tile's window pixels are tabled once, for all its chunks.
    const int tt = threadIdx.x - kMmaThreads, sl = tt & 7, ln = tt >> 3;
    // a unit's x pieces, 16 bytes each, into its buffer once the products
    // of the unit there before are done; at a tile's first chunk, its table
    auto fetch = [&](int u) {
      const int ti = u / g.nchunks, c = u - ti * g.nchunks;
      uint2* tab = ptab + (ti & 1) * kMaxEntries;
      if (c == 0) {
        int n0, col0;
        long long q0;
        tile_of<BM>(g, blockIdx.x + ti * gridDim.x, n0, q0, col0);
        xf_sync<kXfThreads>();   // the table's last readers (two tiles back) are done
        for (int e = tt; e < g.ne; e += kXfThreads) tab[e] = window_pixel(g, q0, col0, e);
        xf_sync<kXfThreads>();
      }
      const int b3 = u % kHalos, ch = c * kKC + sl * 8;
      mbar_wait(hempty(b3), ((u / kHalos) & 1) ^ 1);
      unsigned char* dst = halo + b3 * hbytes + sl * lbo;
      if (ch < g.C)
        for (int e = ln; e < g.ne; e += kXfLanes) {
          const unsigned pix = tab[e].x;
          if (pix != kNoPixel) cp_async16(dst + e * 16, g.x + static_cast<size_t>(pix) * g.C + ch);
        }
    };
    const int units =
        ((g.tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1) * g.nchunks;
    fetch(0);
    cp_async_commit();
    for (int u = 0; u < units; ++u) {
      const int ti = u / g.nchunks;
      const int ch = (u - ti * g.nchunks) * kKC + sl * 8;
      const uint2* tab = ptab + (ti & 1) * kMaxEntries;
      // this unit's first image's scale and shift, while the x lands
      int cur_b = static_cast<int>(tab[ln].y);
      float sc[8], sh[8];
      load_affine(g, cur_b, ch, sc, sh);
      if (u + 1 < units) fetch(u + 1);
      cp_async_commit();
      cp_async_wait<1>();   // all but the group just committed: this unit's x
      asm volatile("" ::: "memory");
      const int b3 = u % kHalos;
      unsigned char* dst = halo + b3 * hbytes + sl * lbo;
      unsigned redo = 0;   // the pieces (k-th of the thread's) that need the exact divide
      // two pieces a step: of one image (the rule), their math interleaved
      for (int e = ln, k = 0; e < g.ne; e += 2 * kXfLanes, k += 2) {
        const int e1 = e + kXfLanes;
        const uint2 p0 = tab[e], p1 = e1 < g.ne ? tab[e1] : make_uint2(kNoPixel, 0u);
        const bool v0 = ch < g.C && p0.x != kNoPixel, v1 = ch < g.C && p1.x != kNoPixel;
        uint4 r[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
        if (v0 && v1 && p0.y == p1.y) {
          if (static_cast<int>(p0.y) != cur_b) {
            cur_b = static_cast<int>(p0.y);
            load_affine(g, cur_b, ch, sc, sh);
          }
          r[0] = *reinterpret_cast<const uint4*>(dst + e * 16);
          r[1] = *reinterpret_cast<const uint4*>(dst + e1 * 16);
          unsigned ex = 0;
          gn_swish8<false>(r, sc, sh, ex);
          redo |= ex << k;
        } else {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const uint2 pn = n ? p1 : p0;
            if (!(n ? v1 : v0)) continue;
            if (static_cast<int>(pn.y) != cur_b) {
              cur_b = static_cast<int>(pn.y);
              load_affine(g, cur_b, ch, sc, sh);
            }
            uint4 one[1] = {*reinterpret_cast<const uint4*>(dst + (n ? e1 : e) * 16)};
            unsigned ex = 0;
            gn_swish8<false>(one, sc, sh, ex);
            redo |= ex << (k + n);
            r[n] = one[0];
          }
        }
        *reinterpret_cast<uint4*>(dst + e * 16) = r[0];
        if (e1 < g.ne) *reinterpret_cast<uint4*>(dst + e1 * 16) = r[1];
      }
      if (__builtin_expect(redo != 0, 0)) {   // x again, from global memory: the slot holds
        for (int e = ln, k = 0; e < g.ne; e += kXfLanes, ++k) {   // the activation now
          if (!((redo >> k) & 1u)) continue;
          const uint2 px = tab[e];
          load_affine(g, static_cast<int>(px.y), ch, sc, sh);
          uint4 one[1] = {__ldg(reinterpret_cast<const uint4*>(g.x + static_cast<size_t>(px.x) * g.C + ch))};
          unsigned unused = 0;
          gn_swish8<true>(one, sc, sh, unused);
          *reinterpret_cast<uint4*>(dst + e * 16) = one[0];
        }
      }
      sm90::fence_async_smem();   // the stores, visible to wgmma
      mbar_arrive(hfull(b3));
    }
    return;
  }

  // ---- MMA warpgroups: rows 64 MI wg .. 64 MI (wg + 1) - 1 of the tile
  if constexpr (MI == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 176;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 120;\n");
  const int wg = warp >> 2;
  const int p = g.pitch;
  float acc[MI][64];
  int u = 0, it = 0;
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    int n0, col0;
    long long q0;
    tile_of<BM>(g, t, n0, q0, col0);
    for (int c = 0; c < g.nchunks; ++c, ++u) {
      const int buf = u % kHalos;
      mbar_wait(hfull(buf), (u / kHalos) & 1);
      const uint32_t a0 = halo_u + buf * hbytes + 16u * (wg * 64 * MI);
      for (int tap = 0; tap < 9; ++tap, ++it) {
        const int s = it % kWStages;
        mbar_wait(wfull(s), (it / kWStages) & 1);
        const int dy = tap / 3, dx = tap - 3 * dy;
        const uint32_t at = a0 + 16u * (dy * p + dx);
        const uint32_t bt = ring + s * kWTile;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
            wgmma_ss_tb128(acc[mi], desc_rows(at + 64 * 16 * mi + 2 * kk * lbo, lbo),
                           desc_wt(bt + 16 * 128 * kk), (c | tap | kk) != 0);
        wgmma_commit();
        // one group in flight: the previous tap's products are done, its
        // weight stage is freed; the chunk's last tap waits for all, then
        // frees its stage and the halo buffer
        if (tap < 8) {
          wgmma_wait<1>();
          if (tap > 0 && lane == 0) mbar_arrive(wempty((it - 1) % kWStages));
        } else {
          wgmma_wait<0>();
          if (lane == 0) {
            mbar_arrive(wempty((it - 1) % kWStages));
            mbar_arrive(wempty(s));
          }
        }
      }
      if (lane == 0) mbar_arrive(hempty(buf));
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) fence_f(acc[mi]);
    // + bias, bf16, the rows that are pixels of the image
    const int r_in = (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const long long q = q0 + wg * 64 * MI + mi * 64 + r_in + 8 * hf;
        const long long row = q / p;
        const int col = static_cast<int>(q - row * p);
        const long long b = row / (g.H + 1);
        const int h = static_cast<int>(row - b * (g.H + 1));
        const int w = col0 + col;
        if (col >= g.tw || w >= g.W || h >= g.H || b >= g.B) continue;
        __nv_bfloat16* yrow = g.y + ((b * g.H + h) * g.W + w) * g.Co + n0 + 2 * (lane & 3);
        const float* brow = g.bias + n0 + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 bb = __ldg(reinterpret_cast<const float2*>(brow + 8 * j));
          *reinterpret_cast<__nv_bfloat162*>(yrow + 8 * j) =
              __floats2bfloat162_rn(__fadd_rn(acc[mi][4 * j + 2 * hf], bb.x),
                                    __fadd_rn(acc[mi][4 * j + 2 * hf + 1], bb.y));
        }
      }
  }
}

// (Co, C, 9) bf16: the weight as HWIO stores it, (3, 3, C, Co), in boxes of
// 64 outputs x 64 channels x 1 tap with the 128-byte swizzle; channels past C
// fill with zeros
bool encode_weight(CUtensorMap* map, const void* ptr, int C, int Co) {
  const sm90::EncodeTiled fn = sm90::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Co), static_cast<cuuint64_t>(C), 9};
  const cuuint64_t strides[2] = {2ull * Co, 2ull * Co * C};
  const cuuint32_t box[3] = {64, kKC, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MI>
int launch_conv(const ConvArgs& a, cudaStream_t s) {
  const int smem = 1024 + kRing + 128 * kHalos * a.nep + kBars + 16 * kMaxEntries;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(gn_conv_kernel<MI>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int grid = a.tiles < num_sms() ? a.tiles : num_sms();
  gn_conv_kernel<MI><<<grid, Block<MI>::kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gnc
}  // namespace

// Halo entries one conv buffer holds: the wrapper's plan keeps bm + 2 pitch +
// 2 within it.
extern "C" int t2s_gn_halo_entries() { return gnc::kMaxEntries; }

// The statistics launch alone: partial (B, nchunk, 2, groups) f32, scale_shift
// (2, B, C) f32, tickets B zeroed uint32 (left zeroed). Returns the CUDA
// error code.
extern "C" int t2s_gn_stats(const void* x, const void* gamma, const void* beta, void* partial,
                            void* scale_shift, void* tickets, int B, int H, int W, int C, int groups,
                            int nchunk, void* stream) {
  const long long HW = static_cast<long long>(H) * W;
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535 || H > 65535 || HW > (1ll << 31) - 1 || C <= 0 ||
      C % 32 != 0 || C > gnc::kMaxC || groups <= 0 || C % groups != 0 || nchunk <= 0 ||
      nchunk > HW || nchunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  gnc::StatArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.partial = static_cast<float*>(partial);
  a.scale = static_cast<float*>(scale_shift);
  a.shift = a.scale + static_cast<size_t>(B) * C;
  a.tickets = static_cast<unsigned*>(tickets);
  a.HW = static_cast<int>(HW);
  a.C = C;
  a.G = groups;
  a.chunk_pix = static_cast<int>((HW + nchunk - 1) / nchunk);
  a.nchunk = static_cast<int>((HW + a.chunk_pix - 1) / a.chunk_pix);
  if (a.nchunk != nchunk) return static_cast<int>(cudaErrorInvalidValue);   // no empty chunk
  gnc::gn_stats_kernel<<<dim3(nchunk, B), gnc::kStatThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The conv launch alone, from scale_shift: y (B, H, W, Co) bf16 for x (B, H,
// W, C) bf16, w (3, 3, C, Co) bf16, bias (Co,) f32, on the plan (pitch, bm).
extern "C" int t2s_gn_conv(const void* x, const void* w, const void* bias, const void* scale_shift,
                           void* y, int B, int H, int W, int C, int Co, int pitch, int bm,
                           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535 || H > 65535 || C <= 0 || C % 32 != 0 ||
      C > gnc::kMaxC || Co <= 0 || Co % gnc::kBN != 0 || (bm != 128 && bm != 256) || pitch < 3 ||
      bm + 2 * pitch + 2 > gnc::kMaxEntries || static_cast<long long>(B) * H * W >= gnc::kNoPixel)
    return static_cast<int>(cudaErrorInvalidValue);
  gnc::ConvArgs a;
  memset(&a, 0, sizeof(a));
  if (!gnc::encode_weight(&a.wmap, w, C, Co)) return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.scale = static_cast<const float*>(scale_shift);
  a.shift = a.scale + static_cast<size_t>(B) * C;
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.B = B;
  a.H = H;
  a.W = W;
  a.C = C;
  a.Co = Co;
  a.pitch = pitch;
  a.tw = pitch - 2;
  const long long strips = (W + a.tw - 1) / a.tw;
  const long long positions = static_cast<long long>(B) * (H + 1) * pitch;
  const long long mt = (positions + bm - 1) / bm;
  const long long tiles = strips * mt * (Co / gnc::kBN);
  if (tiles > (1ll << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  a.mt = static_cast<int>(mt);
  a.nt = Co / gnc::kBN;
  a.tiles = static_cast<int>(tiles);
  a.nchunks = (C + gnc::kKC - 1) / gnc::kKC;
  a.ne = bm + 2 * pitch + 2;
  a.nep = gnc::padded_entries(a.ne);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bm == 256 ? gnc::launch_conv<2>(a, s) : gnc::launch_conv<1>(a, s);
}
