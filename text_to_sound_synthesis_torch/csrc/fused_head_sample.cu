// Fused step tail of the int8 serving engine (K2) for Hopper, sm_90a:
// final LayerNorm -> logits head -> the sampler step, in one launch.
//
// Replaces text_to_sound_synthesis_tpu/ops/fused_sampler.py::fused_head_sample
// (Pallas TPU kernel _head_kernel). The plain PyTorch twin is
// text_to_sound_synthesis_torch/ops/fused_sampler.py::head_sample_reference.
//
// Per row of the backbone's (rows, D) bf16 output:
//   xn = LN(x) * gamma + beta (f32, eps 1e-6, two passes) -> bf16;
//   logits = xn . head_w (bf16 products, f32 sums) + head_b, kept in f32;
//   then sampler_body.cuh (the body K1 runs): log-softmax, MASK -> -70, the
//   top-r threshold, posterior from the token index, Philox Gumbel-argmax
//   keyed on (seed_base, step) and counted on (row, class) exactly as K1 is.
// At K - 1 <= 256 classes the logits never reach device memory.
//
// What bounds it on an H100: at the flagship shape (2120 rows, D 1024, 256
// classes) the bytes (x 4.3 MB, the head weight 0.5 MB) take 1.46 us at 3.35
// TB/s and the head's 1.1 GFLOP 1.1 us of bf16 tensor-core time. What sets
// the pace (37 us a call in a CUDA graph; PERF.md) is the sampler body, ~16
// f32 operations and 8 transcendentals per (row, class) and a chain of warp
// reductions per row, about half of
// each CTA's time; and the placement: 34 clusters of four fit one CTA an SM
// only about 30 at a time, so the rest share SMs, and their bodies, at half
// the SM each, end last. The design:
//   - a 64-row tile per cluster of four CTAs (34 clusters, 136 CTAs of 512
//     threads, 107 KB of shared memory at D 1024, at most 64 registers a
//     thread: two CTAs an SM, one wave). CTA c of a cluster owns the tile's
//     rows 16c ..16c+15, one a warp, and takes the D slice [c Ds, (c + 1)
//     Ds), Ds = D / 4 rounded up to 64: it reads a quarter of the weight;
//   - the LayerNorm: each warp reads its row whole, takes the f32
//     statistics in two passes in a fixed lane order, and stores the bf16
//     row's four slices (formed from 16-byte loads issued together) into
//     the four CTAs' A tiles (distributed shared memory), each at its
//     128-byte-swizzled place; gamma and beta arrive by one bulk copy (at D 4096 they do not
//     fit beside the tiles and are read from global memory);
//   - the weight arrives by TMA as it lies, (D, K - 1) row-major with a row
//     pitch of a multiple of 8 classes (a TMA stride is 16 bytes: a caller
//     pads an odd class count's weight, ops/fused_sampler.py), in boxes of
//     64 classes x 64 k (128-byte swizzle; rows past D and classes past K - 1
//     zero-filled), through a two-stage ring of 256-class blocks;
//   - the head on wgmma.m64n64k16 bf16 -> f32: A (K-major) and B (MN-major,
//     the instruction's transpose bit: no second copy of the weight) from
//     shared memory; warpgroup g takes classes 64g ..64g+63 of a pass, 32
//     accumulators a thread;
//   - the four partial tiles meet in the CTA that owns the rows: warp w of a
//     warpgroup holds rows 16 (w % 4) ..+15, which CTA w % 4 samples, so it
//     stores its fragment there (into the ring, free once the cluster's
//     products are done); the owner adds the four in rank order, + head_b;
//   - the body: warp w samples row w of the CTA's 16, K1's code and layout;
//   - K - 1 > 256: column passes of 256 classes; each pass's summed logits go
//     to an f32 (rows, K - 1) scratch the wrapper allocates, each row written
//     and read back by the same lane, then the body runs on them.
// Every division is div_rn (int8_common.cuh): __fdiv_rn's slow path is a
// call, and a call in a kernel that issues wgmma makes ptxas serialize every
// wgmma (warning C7510).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "int8_gemm_sm90.cuh"
#include "sampler_body.cuh"

namespace {
namespace hs {

using sm90::desc;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::tma_load;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

constexpr int kSplit = 4;                       // CTAs of a cluster: slices of D
constexpr int kRows = 64;                       // rows of a tile: one wgmma M
constexpr int kOwn = kRows / kSplit;            // rows a CTA samples, one a warp
constexpr int kThreads = 32 * kOwn;             // four warpgroups
constexpr int kN = 256;                         // classes of a column pass
constexpr int kKb = 64;                         // k of a block: one 128-byte bf16 row
constexpr int kPanel = kRows * 128;             // an A block (64 rows) or a B box (64 k): 8 KB
constexpr int kStage = (kN / 64) * kPanel;      // a stage of the weight ring: 32 KB
constexpr int kStages = 2;
constexpr int kLdr = kN + 8;                    // f32 pitch of a received row: v2 stores conflict-free
constexpr int kRecv = kSplit * kOwn * kLdr * 4; // the partial tiles of the CTA's rows
constexpr int kRegion = kRecv > kStages * kStage ? kRecv : kStages * kStage;
constexpr int kHeld = 4;                        // 16-byte chunks of its row a lane holds at once
constexpr int kMaxD = 4096;
constexpr int kAlignPad = 1024 - 16;            // the dynamic base, 16-byte aligned, up to 1024

struct Params {
  CUtensorMap wmap;      // head_w (D, K - 1) bf16: boxes of 64 classes x 64 k
  const __nv_bfloat16* x;
  const int* xt;
  const float* norm;     // (2, D): gamma; beta
  const float* head_b;
  const float* coef;
  const float* gumbel;
  int* out_tokens;
  float* out_post;
  float* logits;         // (rows, K - 1) f32 scratch when K - 1 > kN
  const int* seed_ptr;
  const int* step_ptr;
  int M, D, km1, nkb;    // nkb: 64-wide k blocks of a CTA's slice
  int staged;            // gamma and beta staged in shared memory (else read from norm)
  float r;
  uint32_t seed, step;
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster; orders shared memory stores
// (remote ones too) before the arrive with loads after the wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// generic-proxy stores to the cluster's shared memory, made visible to wgmma and TMA
__device__ __forceinline__ void fence_async_cluster() {
  asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
}

// the address of a shared memory location of this CTA in CTA `rank`'s
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster2(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}

__device__ __forceinline__ void st_cluster4(uint32_t addr, const uint4& v) {
  asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// bytes (a multiple of 16) from global memory into shared memory, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma descriptor of an MN-major B: a 64-class box of 128-byte rows, 128-byte
// swizzle; 8-k groups 1024 bytes apart (SBO; LBO, the next box, unused at N 64)
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(kPanel >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// D (64 x 64, f32) += A (64 x 16, bf16, K-major) . B (16 x 64, bf16,
// MN-major: the head weight's rows as they lie, through the transpose bit),
// both from shared memory; scale_d 0 starts the sums. Thread t of the
// warpgroup holds, for j in 0..7, d[4j + 2hf + e] at row 16 (t / 32) + (t %
// 32) / 4 + 8 hf, column 8j + 2 (t % 4) + e.
__device__ __forceinline__ void wgmma_n64_bt(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// keeps the compiler from reading accumulators before the wgmma wait
__device__ __forceinline__ void fence_f(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// eight bf16 of a 16-byte chunk as f32 (exact)
__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

template <int NJ>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads, NJ <= 9 ? 2 : 1)
head_sample_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const int nkb = p.nkb, km1 = p.km1, D = p.D, M = p.M;
  unsigned char* tile = sm;                                   // nkb blocks of [64 rows][128 bytes]
  unsigned char* region = sm + nkb * kPanel;                  // the weight ring, then the partial tiles
  const float* recv = reinterpret_cast<const float*>(region); // [kSplit][kOwn][kLdr]
  float* gb = reinterpret_cast<float*>(region + kRegion);     // staged: gamma; beta (2 x D)
  const float* norm = p.staged ? gb : p.norm;
  const uint32_t sa = smem_u32(tile), sr = smem_u32(region);
  const uint32_t bar_w = smem_u32(gb) + (p.staged ? 8 * D : 0);   // the ring's two, then gamma's
  const uint32_t bar_gb = bar_w + 8 * kStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const uint32_t rank = cluster_rank();
  const int m0 = (blockIdx.x / kSplit) * kRows;
  const int k0 = static_cast<int>(rank) * nkb * kKb;            // the slice's first column
  const int trow = static_cast<int>(rank) * kOwn + warp;         // this warp's tile row
  const int row = m0 + trow;
  const int npass = (km1 + kN - 1) / kN;

  // weight block kb of column pass `pass` into stage st
  auto load_w = [&](int pass, int kb, int st) {
    const uint32_t bar = bar_w + 8 * st;
    mbar_expect_tx(bar, kStage);
#pragma unroll
    for (int c = 0; c < kN / 64; ++c)
      tma_load(sr + st * kStage + c * kPanel, &p.wmap, pass * kN + 64 * c, k0 + kb * kKb, bar);
  };
  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(bar_w + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kb = 0; kb < kStages && kb < nkb; ++kb) load_w(0, kb, kb);
    if (p.staged) {
      mbar_expect_tx(bar_gb, 8 * D);
      bulk_load(smem_u32(gb), p.norm, 8 * D, bar_gb);
    }
  }
  __syncthreads();
  cluster_arrive();   // this CTA runs; the wait below, before the first remote store

  // 1. the LayerNorm of the warp's row, read whole. The f32 statistics, in
  // two passes, in a fixed order: lane l sums x[l + 32 i] in i order, then
  // the warp's xor butterfly. An ulp of a row's statistics can tip a bf16
  // rounding of its normalised values, so the order is the one K2 takes at
  // every tile layout (the same bf16 rows). The normalised row is then
  // formed from 16-byte chunks: lane l takes q = l + 32 s (columns 8q ..
  // 8q + 7), kHeld at a time, loaded together (all at D <= 1024, while the
  // statistics run); a row past M and chunks past D load as zeros.
  const int nq = D / 8;
  const bool whole = nq <= 32 * kHeld;
  uint4 xv[kHeld];
  auto load_group = [&](int q0) {
#pragma unroll
    for (int h = 0; h < kHeld; ++h) {
      const int q = q0 + lane + 32 * h;
      xv[h] = q < nq && row < M
                  ? __ldg(reinterpret_cast<const uint4*>(p.x + static_cast<size_t>(row) * D) + q)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  if (whole) load_group(0);
  const __nv_bfloat16* xl = p.x + static_cast<size_t>(row < M ? row : 0) * D + lane;
  float acc1 = 0.0f;
  if (row < M)
#pragma unroll 8
    for (int k = 0; k < D; k += 32) acc1 = __fadd_rn(acc1, __bfloat162float(xl[k]));
  const float mean = div_rn(t2s_sampler::warp_sum(acc1), static_cast<float>(D));
  acc1 = 0.0f;
  if (row < M)
#pragma unroll 8
    for (int k = 0; k < D; k += 32) {
      const float d = __fsub_rn(__bfloat162float(xl[k]), mean);
      acc1 = __fadd_rn(acc1, __fmul_rn(d, d));
    }
  const float rstd =
      rsqrtf(__fadd_rn(div_rn(t2s_sampler::warp_sum(acc1), static_cast<float>(D)), t2s_int8::kLnEps));
  cluster_wait();   // every CTA of the cluster runs: its shared memory takes remote stores
  if (p.staged) mbar_wait(bar_gb, 0);
  // the normalised bf16 row into the cluster's A tiles: columns [c Ds, (c +
  // 1) Ds) to CTA c, chunk 8q .. 8q + 7 at its k block's swizzled place (a
  // row past M as zeros)
  const int ds = nkb * kKb;
  for (int q0 = 0; q0 < nq; q0 += 32 * kHeld) {
    if (!whole) load_group(q0);
#pragma unroll
    for (int h = 0; h < kHeld; ++h) {
      const int q = q0 + lane + 32 * h;
      if (q >= nq) continue;
      const int col = 8 * q, cta = col / ds, kc = col - cta * ds;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (row < M) {
        float f[8];
        unpack8(xv[h], f);
        const float4* g4 = reinterpret_cast<const float4*>(norm + col);
        const float4* b4 = reinterpret_cast<const float4*>(norm + D + col);
        const float4 g0 = g4[0], g1 = g4[1], b0 = b4[0], b1 = b4[1];
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        uint32_t w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float y[2];
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int e = 2 * u + v;
            const float hn = __fmul_rn(__fsub_rn(f[e], mean), rstd);
            y[v] = __fadd_rn(__fmul_rn(hn, gv[e]), bv[e]);
          }
          w[u] = pack_bf16x2(y[0], y[1]);
        }
        out = make_uint4(w[0], w[1], w[2], w[3]);
      }
      st_cluster4(map_rank(sa, cta) + (kc >> 6) * kPanel + trow * 128 + ((((kc >> 3) & 7) ^ (trow & 7)) << 4),
                  out);
    }
  }
  if (k0 + ds > D)   // the slice's columns past D: zeros (the weight's rows there are zero-filled too)
    for (int idx = tid; idx < kRows * nkb * 8; idx += kThreads) {
      const int r = idx / (nkb * 8), q = idx % (nkb * 8);
      if (k0 + 8 * q >= D)
        *reinterpret_cast<uint4*>(tile + (q >> 3) * kPanel + r * 128 + (((q & 7) ^ (r & 7)) << 4)) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  fence_async_cluster();   // the A tiles, stored through the generic proxy, are read by wgmma
  cluster_sync();

  // 2. the head, a column pass at a time; the logit of local row lr, class
  // col of the pass (c = col % kN), once the cluster's partial tiles are in
  auto logit = [&](int lr, int c, int col) {
    const float* v = recv + lr * kLdr + c;
    const float s = __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[kOwn * kLdr]), v[2 * kOwn * kLdr]),
                              v[3 * kOwn * kLdr]);
    return __fadd_rn(s, p.head_b[col]);
  };
  const int g = lane >> 2, t = lane & 3;
  float acc[32];
  int unit = 0;   // weight blocks consumed: block u in stage u % kStages, parity (u / kStages) % 2
  for (int pass = 0; pass < npass; ++pass) {
    if (pass > 0 && tid == 0)
      for (int kb = 0; kb < kStages && kb < nkb; ++kb) load_w(pass, kb, (unit + kb) % kStages);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    for (int kb = 0; kb < nkb; ++kb) {
      const int u = unit + kb, st = u % kStages;
      mbar_wait(bar_w + 8 * st, (u / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKb / 16; ++kk)
        wgmma_n64_bt(acc, desc(sa + kb * kPanel + 32 * kk, 1),
                     desc_mn(sr + st * kStage + wg * kPanel + kk * 16 * 128), kb | kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_f(acc);
      __syncthreads();   // every warpgroup is done with the stage
      if (tid == 0 && kb + kStages < nkb) load_w(pass, kb + kStages, st);
    }
    unit += nkb;
    cluster_sync();   // the cluster's products are done: every ring takes partial tiles
    {
      // this warp's rows belong to CTA warp % 4: its partial sums go there, slot `rank`
      const uint32_t dst = map_rank(sr, warp & 3) + rank * kOwn * kLdr * 4;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          st_cluster2(dst + ((g + 8 * hf) * kLdr + 64 * wg + 8 * j + 2 * t) * 4, acc[4 * j + 2 * hf],
                      acc[4 * j + 2 * hf + 1]);
    }
    cluster_sync();   // this CTA's rows' partial tiles are in
    if (npass > 1) {
      // the pass's logits of the warp's row into the scratch (each read back
      // by the lane that wrote it)
      if (row < M)
#pragma unroll
        for (int jj = 0; jj < kN / 32; ++jj) {
          const int col = pass * kN + 32 * jj + lane;
          if (col < km1) p.logits[static_cast<size_t>(row) * km1 + col] = logit(warp, 32 * jj + lane, col);
        }
      if (pass + 1 < npass) {
        // every owner has read its partial tiles: the ring takes the next
        // pass's weight by TMA (the async proxy) where they were stored
        fence_async_cluster();
        cluster_sync();
      }
    }
  }

  // 3. the sampler body on the warp's row
  if (row < M) {   // uniform per warp
    const t2s_sampler::Coeffs cf = *reinterpret_cast<const t2s_sampler::Coeffs*>(p.coef);
    float lp[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = j * 32 + lane;
      lp[j] = col >= km1 ? -INFINITY
              : npass == 1 ? logit(warp, col, col)
                           : p.logits[static_cast<size_t>(row) * km1 + col];
    }
    t2s_sampler::sample_row<NJ>(lp, row, lane, p.xt[row], cf, km1, p.r,
                                t2s_sampler::key_word(p.seed, p.seed_ptr),
                                t2s_sampler::key_word(p.step, p.step_ptr), p.gumbel, p.out_tokens,
                                p.out_post);
  }
}

// (rows, cols) bf16, row-major with a pitch of ld elements, in boxes of 64
// columns x 64 rows with the 128-byte swizzle; reads past the edges fill
// with zeros
bool encode_bf16(CUtensorMap* map, const void* ptr, int rows, int cols, int ld) {
  const sm90::EncodeTiled fn = sm90::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {2ull * ld};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the dynamic shared memory of a launch: the A tile, the ring / partial
// tiles, gamma and beta when staged, three mbarriers, the alignment's room
int smem_bytes(int nkb, int D, bool staged) {
  return kAlignPad + nkb * kPanel + kRegion + (staged ? 8 * D : 0) + 8 * (kStages + 1);
}

int max_smem() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return n;
}

template <int NJ>
int launch(Params& p, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(head_sample_kernel<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem());
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  p.staged = smem_bytes(p.nkb, p.D, true) <= max_smem();
  const int tiles = (p.M + kRows - 1) / kRows;
  head_sample_kernel<NJ><<<tiles * kSplit, kThreads, smem_bytes(p.nkb, p.D, p.staged), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hs
}  // namespace

// Largest K (classes incl. MASK) and D the kernel takes; D must be a
// multiple of 32.
extern "C" int t2s_head_sample_max_classes() { return 65 * 32; }
extern "C" int t2s_head_sample_max_width() { return hs::kMaxD; }
// The classes above which the logits pass through the (rows, K - 1) scratch.
extern "C" int t2s_head_sample_pass_classes() { return hs::kN; }

// Launches on `stream`; returns the CUDA error code (0 on success).
// x (rows, D) bf16; xt (rows,) int32; norm (2, D) f32 (gamma; beta);
// head_w (D, km1) bf16, row pitch ldw elements (>= km1, a multiple of 8);
// head_b (km1,) f32; coef (10,) f32;
// gumbel (rows, km1+1) f32 or NULL; out_tokens (rows,) int32;
// out_post (rows, km1+1) f32 or NULL; logits (rows, km1) f32 scratch when
// km1 > t2s_head_sample_pass_classes(), else NULL; seed_ptr / step_ptr one
// int32 on the device in place of seed / step, or NULL.
extern "C" int t2s_fused_head_sample(const void* x, const void* xt, const void* norm,
                                     const void* head_w, int ldw, const void* head_b, const void* coef,
                                     const void* gumbel, void* out_tokens, void* out_post,
                                     void* logits, int rows, int D, int km1, float r,
                                     unsigned int seed, unsigned int step, const void* seed_ptr,
                                     const void* step_ptr, void* stream) {
  const int K = km1 + 1;
  if (rows <= 0 || km1 <= 0 || ldw < km1 || ldw % 8 != 0 || K > 65 * 32 || D <= 0 || D % 32 != 0 ||
      D > hs::kMaxD || (km1 > hs::kN) != (logits != nullptr) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(norm) |
       reinterpret_cast<uintptr_t>(head_w)) % 16 != 0)   // 16-byte loads, TMA, the bulk copy
    return static_cast<int>(cudaErrorInvalidValue);
  hs::Params p;
  memset(&p, 0, sizeof(p));
  if (!hs::encode_bf16(&p.wmap, head_w, D, km1, ldw)) return static_cast<int>(cudaErrorInvalidValue);
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.xt = static_cast<const int*>(xt);
  p.norm = static_cast<const float*>(norm);
  p.head_b = static_cast<const float*>(head_b);
  p.coef = static_cast<const float*>(coef);
  p.gumbel = static_cast<const float*>(gumbel);
  p.out_tokens = static_cast<int*>(out_tokens);
  p.out_post = static_cast<float*>(out_post);
  p.logits = static_cast<float*>(logits);
  p.seed_ptr = static_cast<const int*>(seed_ptr);
  p.step_ptr = static_cast<const int*>(step_ptr);
  p.M = rows;
  p.D = D;
  p.km1 = km1;
  p.nkb = (D + hs::kSplit * hs::kKb - 1) / (hs::kSplit * hs::kKb);
  p.r = r;
  p.seed = seed;
  p.step = step;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 9 * 32) return hs::launch<9>(p, s);
  if (K <= 17 * 32) return hs::launch<17>(p, s);
  if (K <= 33 * 32) return hs::launch<33>(p, s);
  return hs::launch<65>(p, s);
}
